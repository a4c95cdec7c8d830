"""Feed-forward sublayer: gated (SwiGLU) and plain (gelu, squared-ReLU)
MLPs.

Port of ``repro/models/ffn.py``. The matrix products stay plain
``torch.matmul`` (through ``common.matmul``), as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import torch

from .common import ACTIVATIONS, matmul, matmul_f32
from .config import ModelConfig
from .param import ArrayDecl

__all__ = ["mlp_decls", "mlp"]


def mlp_decls(cfg: ModelConfig, layers: int | None = None,
              d_ff: int | None = None) -> dict:
    M = cfg.d_model
    F = cfg.d_ff if d_ff is None else d_ff
    lead = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    decls = {
        "w_up": ArrayDecl(lead + (M, F), lax_ + ("embed", "mlp")),
        "w_down": ArrayDecl(lead + (F, M), lax_ + ("mlp", "embed")),
    }
    if cfg.glu:
        decls["w_gate"] = ArrayDecl(lead + (M, F), lax_ + ("embed", "mlp"))
    return decls


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
        shard=None) -> torch.Tensor:
    """Gated ``act(x W_gate) * (x W_up)`` or plain ``act(x W_up)``, then
    ``W_down``. An activation name outside ``ACTIVATIONS`` raises
    ``KeyError``, as the reference's lookup does.

    With ``shard`` (a ``sharding.layout.ShardLayout``) whose ``mlp`` is cut
    over the model axis, the params are this rank's columns of ``w_gate``
    and ``w_up`` and rows of ``w_down``, and the partial products are
    summed in fp32 over the model axis and rounded once; with ``mlp``
    replicated no collective runs. ``x`` enters the cut units through
    ``shard.enter``, whose backward (under grad) sums its gradient over
    the model axis."""
    act = ACTIVATIONS[cfg.activation]
    cut = shard is not None and shard.mlp.sharded
    if cut:
        x = shard.enter(x)
    up = matmul(x, params["w_up"])
    if cfg.glu:
        h = act(matmul(x, params["w_gate"])) * up
    else:
        h = act(up)
    if cut:
        return shard.reduce_sum(
            matmul_f32(h, params["w_down"]),
            torch.promote_types(h.dtype, params["w_down"].dtype))
    return matmul(h, params["w_down"])
