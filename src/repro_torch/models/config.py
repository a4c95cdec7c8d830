"""Model configuration: the port's own copy of ``repro.models.config``.

One dataclass covers every family the JAX package knows, so that a config
can be written once and checked by the same ``reduced()`` rule on both sides.
The port runs ``family="dense"``, ``"moe"``, ``"ssm"`` and ``"vlm"``
(``models/lm.py``) and ``"encdec"`` (``models/encdec.py``); ``"hybrid"``
raises ``NotImplementedError`` where it is built (``models/lm.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    # lower with this many heads, the extras hard-masked to zero
    pad_heads_to: int | None = None

    # positional / norm flavor
    rope_theta: float = 10000.0
    use_mrope: bool = False              # qwen2-vl
    qk_norm: bool = False                # qwen3
    activation: str = "silu"             # "silu" | "gelu" | "squared_relu"
    glu: bool = True                     # gated FFN (SwiGLU); False -> plain
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2

    # hybrid (jamba): layers per super-block and which are attention / MoE
    hybrid_period: int = 8
    hybrid_attn_index: int = 3
    hybrid_moe_every: int = 2

    # encdec
    n_encoder_layers: int = 0

    # attention chunking of the plain (CPU) path; the CUDA kernels tile
    # themselves and only check that these divide the sequence
    attention_impl: str = "xla"
    q_chunk: int = 512
    kv_chunk: int = 1024

    # training-time behavior
    remat: bool = True
    microbatches: int = 1

    # inference
    max_cache_len: int = 32768
    # JAX-side performance levers; they change no result, so the port
    # accepts both settings and computes the same function under each
    onehot_cache_update: bool = False
    decode_unexpanded_gqa: bool = False
    dp_only: bool = False
    # score-pipeline dtype of the plain attention path (running max and
    # denominator stay fp32)
    softmax_dtype: str = "float32"
    remat_policy: str = "full"
    moe_dispatch: str = "scatter"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.family in ("moe", "hybrid") and not self.n_experts:
            raise ValueError(f"{self.name}: MoE family needs n_experts")
        if self.family in ("ssm", "hybrid") and not self.ssm_state:
            raise ValueError(f"{self.name}: SSM family needs ssm_state")

    # -- derived -----------------------------------------------------------
    @property
    def n_heads_eff(self) -> int:
        """Lowered head count (pad_heads_to when set)."""
        return self.pad_heads_to or self.n_heads

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attends(self) -> bool:
        return self.family != "ssm"

    def reduced(self, seq_hint: int = 128) -> "ModelConfig":
        """Tiny same-family config for CPU tests (same rule as the JAX
        package's, so both sides build the same reduced model)."""
        kv = max(1, min(self.n_kv_heads, 2))
        heads = max(kv * 2, 4)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4) if self.family != "hybrid"
                     else self.hybrid_period,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            pad_heads_to=None,
            q_chunk=max(seq_hint // 2, 16),
            kv_chunk=max(seq_hint // 2, 16),
            max_cache_len=seq_hint,
            microbatches=1,
        )
