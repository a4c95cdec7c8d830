"""Public decode attention entry point (model-layout adapter).

Counterpart of ``repro/kernels/decode_attention/ops.py::decode_attention``.
A CUDA tensor goes to the CUDA kernel (or raises); a CPU tensor goes to the
plain version. ``block_k`` keeps the reference's signature and its
``ValueError`` on a cache length it does not divide; the CUDA kernel picks
its own tiles. Contract: 1 <= length <= L.

``decode_attention_partial`` is the same for one span of a cache cut on
its sequence axis (the split-K decode of a sharded model): (out, lse) in
fp32, with 0 <= length <= L.
"""

from __future__ import annotations

import torch

from .kernel import decode_attention_cuda
from .partial import decode_attention_partial_cuda
from .ref import decode_attention_partial_ref, decode_attention_ref

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_partial", "decode_attention_partial_plain"]


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length: torch.Tensor | int) -> torch.Tensor:
    """The plain version in model layout: q (B, 1, H, D); k, v
    (B, L, Hk, D). Folds GQA groups, runs the reference, unfolds."""
    B, _, H, D = q.shape
    Hk = k.shape[2]
    qg = q[:, 0].reshape(B, Hk, H // Hk, D)
    out = decode_attention_ref(qg, k.transpose(1, 2), v.transpose(1, 2),
                               length)
    return out.reshape(B, 1, H, D)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor | int, *,
                     block_k: int = 512) -> torch.Tensor:
    """Model layout: q (B, 1, H, D); k, v (B, L, Hk, D) -> (B, 1, H, D)."""
    if q.shape[1] != 1:
        raise ValueError("decode expects a single query token")
    L = k.shape[1]
    if L % min(block_k, L):
        raise ValueError(f"cache len {L} % block_k {block_k}")
    if q.is_cuda:
        if not isinstance(length, torch.Tensor):
            raise ValueError("on CUDA, length is an int32 tensor on the card")
        return decode_attention_cuda(q, k, v, length)
    if q.device.type != "cpu":
        raise ValueError(f"no decode attention for device {q.device}")
    return decode_attention_plain(q, k, v, length)


def decode_attention_partial_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, length: torch.Tensor | int
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The partial entry's plain version in model layout: q (B, 1, H, D);
    k, v (B, L, Hk, D) -> (out fp32 (B, 1, H, D), lse fp32 (B, H))."""
    B, _, H, D = q.shape
    Hk = k.shape[2]
    qg = q[:, 0].reshape(B, Hk, H // Hk, D)
    out, lse = decode_attention_partial_ref(qg, k.transpose(1, 2),
                                            v.transpose(1, 2), length)
    return out.reshape(B, 1, H, D), lse.reshape(B, H)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, length: torch.Tensor | int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Model layout: q (B, 1, H, D); k, v (B, L, Hk, D), one span of the
    cache; ``length`` its valid keys, 0 <= length <= L -> (out fp32
    (B, 1, H, D), lse fp32 (B, H)). A CUDA tensor goes to the kernel's
    partial entry (or raises), a CPU tensor to the plain version."""
    if q.shape[1] != 1:
        raise ValueError("decode expects a single query token")
    if q.is_cuda:
        if not isinstance(length, torch.Tensor):
            raise ValueError("on CUDA, length is an int32 tensor on the card")
        return decode_attention_partial_cuda(q, k, v, length)
    if q.device.type != "cpu":
        raise ValueError(f"no decode attention for device {q.device}")
    return decode_attention_partial_plain(q, k, v, length)
