"""Plain PyTorch versions of the flash attention kernel and of its gradient."""

from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "flash_attention_bwd_plain"]


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


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True):
    """The gradient of ``flash_attention_ref`` by autograd in fp32, in the
    model layout of the backward kernel: q, do (B, Sq, H, D); k, v
    (B, Skv, Hk, D) -> (dq, dk, dv) in the inputs' dtype."""
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        qg = qf.reshape(B, Sq, Hk, H // Hk, D).permute(0, 2, 3, 1, 4)
        out = flash_attention_ref(qg, kf.transpose(1, 2), vf.transpose(1, 2),
                                  causal=causal)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
        dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
