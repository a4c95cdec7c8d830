"""Launcher of the decode kernel's partial entry
(``csrc/decode_attention.cu``: ``decode_attention_partial_*``).

One rank's share of the split-K decode of a model whose K/V cache is cut
on its sequence axis (``models/attention.py``): the same split and merge
kernels as ``decode_attention_cuda``, over this rank's span of the cache,
returning the span's normalised output in fp32 and its log-sum-exp, so that
the ranks' partials merge as the kernel's own splits do. A local length of
0 (a span the sequence has not reached) gives output 0 and lse -inf.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .kernel import check_args, scratch_floats, strided_args

__all__ = ["decode_attention_partial_cuda"]

# Kernel launches since the count was last set to 0 (read by chip_smoke.py).
launches = 0

_ENTRY = {torch.bfloat16: "decode_attention_partial_bf16",
          torch.float32: "decode_attention_partial_f32"}


def _entry(dtype: torch.dtype):
    fn = getattr(_build.library("decode_attention"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_attention_partial_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, length: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, 1, H, D); k, v: (B, L, Hk, D), a span of the cache; length:
    one int32 element, the span's valid keys, 0 <= length <= L (not
    checked: the host never reads it); all on one CUDA device ->
    (out fp32 (B, 1, H, D), lse fp32 (B, H)). out is softmax(s) @ v over
    the valid keys, lse = log(sum(exp(s))) of their scores s = q.k /
    sqrt(D); at length 0, out = 0 and lse = -inf."""
    global launches
    check_args(q, k, v, length, "decode_attention_partial_cuda")
    B, _, H, D = q.shape
    out = torch.empty((B, 1, H, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    n_scratch = scratch_floats(B, k.shape[2], H // k.shape[2], k.shape[1], D)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            out.data_ptr(), lse.data_ptr(), scratch.data_ptr(), n_scratch,
            *strided_args(q, k, v), stream)
    _build.check(code, "decode_attention_partial")
    launches += 1
    return out, lse
