"""Plain PyTorch version of the decode attention kernel."""

from __future__ import annotations

import math

import torch

__all__ = ["decode_attention_ref"]


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: torch.Tensor | int) -> torch.Tensor:
    """q: (B, Hk, G, D); k, v: (B, Hk, L, D); keys >= length masked.

    Holds for length >= 1; at length 0 it gives the mean of V where the
    kernel gives zeros (the model always writes before it attends)."""
    D = q.shape[-1]
    L = k.shape[2]
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) / math.sqrt(D)
    valid = torch.arange(L, device=q.device) < torch.as_tensor(
        length, device=q.device)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return out.to(q.dtype)
