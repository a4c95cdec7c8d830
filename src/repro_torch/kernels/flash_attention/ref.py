"""Plain PyTorch version of the flash attention kernel."""

from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref"]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, Hk, G, Sq, D); k, v: (B, Hk, Skv, D) — exact softmax in fp32."""
    Sq, D = q.shape[3], q.shape[4]
    Skv = k.shape[2]
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.to(q.dtype)
