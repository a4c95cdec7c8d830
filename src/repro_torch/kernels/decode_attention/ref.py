"""Plain PyTorch version of the decode attention kernel."""

from __future__ import annotations

import math

import torch

__all__ = ["decode_attention_ref", "decode_attention_partial_ref"]


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


def decode_attention_partial_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, length: torch.Tensor | int
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One span's share of a split-K decode. q: (B, Hk, G, D); k, v:
    (B, Hk, L, D), keys >= length masked, 0 <= length <= L. Returns (out
    fp32 (B, Hk, G, D), lse fp32 (B, Hk, G)): the softmax-weighted V over
    the valid keys and the log-sum-exp of their scores q.k / sqrt(D); at
    length 0, out = 0 and lse = -inf (the Pallas kernel's 0 output there).
    Spans merge as ``out = sum_r e^(lse_r - M) out_r / sum_r e^(lse_r - M)``
    with ``M = max_r lse_r``."""
    D = q.shape[-1]
    L = k.shape[2]
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) / math.sqrt(D)
    valid = torch.arange(L, device=q.device) < torch.as_tensor(
        length, device=q.device)
    s = torch.where(valid, s, torch.full_like(s, -math.inf))
    lse = torch.logsumexp(s, dim=-1)
    # masked keys give p = 0, and so does every key of an empty span
    p = torch.where(valid, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return out, lse
