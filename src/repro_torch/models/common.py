"""Shared layer primitives: RMS norm, SiLU, softplus, rotary embeddings,
the cross-entropy loss and the per-layer remat wrapper.

Same conventions as the JAX package's ``models/common.py``: compute in the
activation dtype, normalise, rotate and take the loss in fp32. The rest of
that module (layer norm) comes with the slice that uses it.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint, noop_context_fn

__all__ = ["matmul", "rms_norm", "silu", "gelu", "squared_relu", "softplus",
           "ACTIVATIONS", "rope_table", "apply_rope", "apply_mrope",
           "cross_entropy_loss", "remat_layer"]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype of the two, as ``jnp.einsum`` promotes
    (bf16 activations against fp32 weights give fp32)."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    # the reference's sigmoid, op for op in x's dtype: 1 / (1 + exp(-x));
    # torch.sigmoid rounds once and differs from it by a bf16 ulp
    return x * (1 / (1 + torch.exp(-x)))


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a constant to the
    array's dtype before it multiplies (torch would keep it in fp32)."""
    return torch.tensor(value, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    # the reference's jax.nn.gelu(approximate=True), op for op in x's dtype
    # with its constants in that dtype; F.gelu(approximate="tanh") rounds
    # once and differs from it by a bf16 ulp
    c = _in_dtype(math.sqrt(2 / math.pi), x.dtype)
    a = _in_dtype(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * x ** 3))))


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """Primer / Nemotron-4 activation: relu(x)**2."""
    r = torch.relu(x)
    return r * r


def softplus(x: torch.Tensor) -> torch.Tensor:
    # as the reference computes it, logaddexp(x, 0); F.softplus switches to
    # x itself above its threshold (20) and rounds differently there
    return torch.logaddexp(x, torch.zeros_like(x))


ACTIVATIONS = {"silu": silu, "gelu": gelu, "squared_relu": squared_relu}


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions.

    positions: (...,) int  ->  cos, sin: (..., head_dim // 2) fp32.
    """
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (split-half convention).  x: (B, S, H, D);
    cos/sin: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 2:         # (S, D/2) -> broadcast over batch, heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                      # (B, S, D/2) -> broadcast over heads
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, head_dim: int,
                sections: tuple[int, int, int] | None = None,
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the head dim is split into (temporal, h, w)
    sections, each rotated by its own position stream.

    x: (B, S, H, D); positions_3d: (3, B, S) int.
    ``sections`` are in half-dim units and must sum to D // 2; the default
    is Qwen2-VL's 1:1.5:1.5 split, (16, 24, 24) at D = 128.
    """
    half = head_dim // 2
    if sections is None:
        t = half // 4
        w = (half - t) // 2
        sections = (t, half - t - w, w)
    if sum(sections) != half:
        raise ValueError(f"sections {sections} must sum to {half}")
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions_3d.device) / half
    freqs = 1.0 / (theta ** exponent)
    # angle[b, s, i] = pos[section of i, b, s] * freqs[i]: each stream
    # repeated over its section's columns, with no host-side index tensor
    pos = positions_3d.float()                                # (3, B, S)
    pos_sel = torch.cat([pos[j, ..., None].expand(*pos.shape[1:], n)
                         for j, n in enumerate(sections)], dim=-1)
    angles = pos_sel * freqs                                  # (B, S, half)
    return apply_rope(x, torch.cos(angles), torch.sin(angles))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token-level cross entropy in fp32. logits: (..., V); labels:
    (...) int; with ``mask`` (...), sum(nll * mask) / max(sum(mask), 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def remat_layer(body, context_fn=noop_context_fn):
    """``body`` run under ``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of a layer: with the default ``context_fn`` it saves
    only its inputs ("full"); a selective-checkpoint ``context_fn`` saves
    what its policy names."""
    def run(*args):
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)
    return run
