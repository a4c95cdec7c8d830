"""Feed-forward sublayer: gated (SwiGLU) and plain (gelu, squared-ReLU)
MLPs.

Port of ``repro/models/ffn.py``. The matrix products stay plain
``torch.matmul`` (through ``common.matmul``), as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import torch

from .common import ACTIVATIONS, matmul
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


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated ``act(x W_gate) * (x W_up)`` or plain ``act(x W_up)``, then
    ``W_down``. An activation name outside ``ACTIVATIONS`` raises
    ``KeyError``, as the reference's lookup does."""
    act = ACTIVATIONS[cfg.activation]
    up = matmul(x, params["w_up"])
    if cfg.glu:
        h = act(matmul(x, params["w_gate"])) * up
    else:
        h = act(up)
    return matmul(h, params["w_down"])
