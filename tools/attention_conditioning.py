#!/usr/bin/env python3
"""Why ``chip_smoke.py``'s depth-2 model checks draw the attention weights
at their fan-in std, on the CPU.

    PYTHONPATH=src python3 tools/attention_conditioning.py   # repository root

The model check holds the card's path (the flash and decode kernels) to the
CPU's plain path (``blockwise_attention`` and ``decode_attention``, the JAX
package's model algorithm) within rel < 0.06 of the largest logit. The two
are different roundings of one function: the model's path rounds q / sqrt(D)
to bf16 before it takes the scores, as the reference model does; the
kernels, like the Pallas kernels and their ``ref.py``, scale the fp32
scores. Both are right, and they agree wherever the softmax is not
saturated.

The reference's initializer reads each weight's fan-in from shape[-2]: H
for wq, Hk for wk and wv, D for wo (``src/repro/models/param.py:35-40``).
On the embedding's normal(0.02) rows that makes layer 0's scores of std
~180 (tinyllama-1.1b) to ~440 (starcoder2-15b): the softmax is one-hot and
a 2^-9 rounding of q moves a score by a few units, enough to pick another
key. qwen3-14b's qk-norm bounds its scores. This script draws layer 0's
attention at full width for each dense arch, as the reference draws it and
at std 1/sqrt(fan-in), feeds 2 x 64 embedding rows through RMSNorm, the
projections and RoPE, and reports the scores' spread and how far the two
plain algorithms' outputs part (max |diff| / max |out|) on the same bf16
q, k, v. Prints one line per arch and draw and, last, all readings as one
JSON object.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_plain  # noqa: E402
from repro_torch.models.attention import (attention_decls,  # noqa: E402
                                          blockwise_attention)
from repro_torch.models.common import (apply_rope, matmul,  # noqa: E402
                                       rms_norm, rope_table)
from repro_torch.models.param import init_params  # noqa: E402

DENSE = ("tinyllama-1.1b", "starcoder2-15b", "nemotron-4-15b", "qwen3-14b")


def fan_in_std(attn: dict, d_model: int) -> dict:
    """The attention weights rescaled to std 1/sqrt(fan-in): d_model for
    wq, wk, wv; H * D for wo (``chip_smoke.py`` rescales them so)."""
    out = dict(attn)
    for n in ("wq", "wk", "wv"):                 # (..., M, heads, D)
        out[n] = (attn[n].float() * math.sqrt(attn[n].shape[-2]
                                              / d_model)).bfloat16()
    out["wo"] = (attn["wo"].float()                # (..., H, D, M)
                 / math.sqrt(attn["wo"].shape[-3])).bfloat16()
    return out


def layer0_qkv(cfg, attn, x):
    B, S, M = x.shape
    H, Hk, D = cfg.n_heads_eff, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, torch.ones(M, dtype=torch.bfloat16))
    q = matmul(h, attn["wq"].reshape(M, H * D)).view(B, S, H, D)
    k = matmul(h, attn["wk"].reshape(M, Hk * D)).view(B, S, Hk, D)
    v = matmul(h, attn["wv"].reshape(M, Hk * D)).view(B, S, Hk, D)
    if cfg.qk_norm:
        q, k = rms_norm(q, attn["q_norm"]), rms_norm(k, attn["k_norm"])
    cos, sin = rope_table(torch.arange(S), D, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def reading(arch: str, fan_in: bool, seed: int = 0) -> dict:
    cfg = get_config(arch)
    gen = torch.Generator().manual_seed(seed)
    attn = init_params(attention_decls(cfg), gen, "cpu")
    if fan_in:
        attn = fan_in_std(attn, cfg.d_model)
    # the embedding's rows of 2 x 64 tokens: normal(0.02), as drawn
    x = (torch.randn(2, 64, cfg.d_model, generator=gen) * 0.02).bfloat16()
    q, k, v = layer0_qkv(cfg, attn, x)
    G, D = q.shape[2] // k.shape[2], q.shape[-1]
    scores = torch.einsum(
        "bqhgd,bkhd->bhgqk", q.float().reshape(2, 64, k.shape[2], G, D),
        k.float()) / math.sqrt(D)
    model = blockwise_attention(q, k, v, causal=True, q_chunk=32,
                                kv_chunk=32).float()
    kernel_ref = flash_attention_plain(q, k, v, causal=True).float()
    return {"arch": arch, "draw": "fan-in std" if fan_in else "reference",
            "score_std": float(scores.std()),
            "score_max": float(scores.abs().max()),
            "rel": float((model - kernel_ref).abs().max()
                         / kernel_ref.abs().max())}


def main() -> int:
    out = []
    for arch in DENSE:
        for fan_in in (False, True):
            r = reading(arch, fan_in)
            out.append(r)
            print(f"{arch:16s} {r['draw']:10s} layer-0 scores std "
                  f"{r['score_std']:8.2f} max {r['score_max']:8.2f}; "
                  f"model algorithm vs the kernels' ref: rel "
                  f"{r['rel']:.4f}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
