"""Public flash attention entry point (model-layout adapter).

Counterpart of ``repro/kernels/flash_attention/ops.py::flash_attention``.
A CUDA tensor goes to the CUDA kernel (or raises): when grad is enabled and
an input requires it, through an autograd Function whose backward is the
CUDA backward kernel; otherwise (serving) to the bare kernel. A CPU tensor
goes to the plain version, which autograd differentiates op by op.
``block_q`` / ``block_k`` keep the reference's signature and its
``ValueError`` on sizes they do not divide; the CUDA kernel picks its own
tiles.
"""

from __future__ import annotations

import torch

from .kernel import aligned_rows, flash_attention_cuda
from .kernel_bwd import flash_attention_bwd_cuda
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_plain"]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """The plain version in model layout: q (B, Sq, H, D); k, v
    (B, Skv, Hk, D). Folds GQA groups, runs the reference, unfolds."""
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    qg = q.reshape(B, Sq, Hk, H // Hk, D).permute(0, 2, 3, 1, 4)
    out = flash_attention_ref(qg, k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


class _FlashAttention(torch.autograd.Function):
    """The CUDA forward, and the CUDA backward as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        # the rows' log-sum-exp, 4 bytes a query row, saved for the backward
        # (under remat the recomputed forward writes it again)
        o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                      return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if not aligned_rows(do):
            # autograd may hand over a strided or offset view
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                              causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, Hk, D) -> (B, Sq, H, D)."""
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq % min(block_q, Sq) or Skv % min(block_k, Skv):
        raise ValueError("sequence not divisible by block size")
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return _FlashAttention.apply(q, k, v, causal)
        return flash_attention_cuda(q, k, v, causal=causal)
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for device {q.device}")
    return flash_attention_plain(q, k, v, causal=causal)
