"""Launcher of the CUDA flash attention backward (``csrc/flash_attention_bwd.cu``).

The gradient of ``flash_attention_cuda``: dq, dk and dv from q, k, v, the
forward's output o and the output gradient dO, in the model layout (q, o,
dO (B, Sq, H, D); k, v (B, Skv, Hk, D)), read through strides. The JAX
package has no backward kernel (it differentiates its attention under XLA);
the source's head note says how this one is tiled. Two launches, a dq pass
and a dk/dv pass, share fp32 scratch (the row log-sum-exp and delta) that
this wrapper allocates.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .kernel import _HEAD_DIMS, _MAX_GROUP, _check_layout

__all__ = ["flash_attention_bwd_cuda"]

# Calls that launched the kernel's two passes since the count was last set
# to 0 (read by chip_smoke.py).
launches = 0

_ENTRY = {torch.bfloat16: "flash_attention_bwd_bf16",
          torch.float32: "flash_attention_bwd_f32"}
_MAX_ROWS = 64 * 65535           # tiles of 64 rows on the grid's y axis


def _entry(dtype: torch.dtype):
    fn = getattr(_build.library("flash_attention_bwd"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True):
    """q, o, do: (B, Sq, H, D); k, v: (B, Skv, Hk, D), on one CUDA device,
    bf16 or fp32, all alike -> (dq, dk, dv) in q's dtype and shapes."""
    global launches
    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    tensors = (("q", q), ("k", k), ("v", v), ("o", o), ("do", do))
    if not all(t.is_cuda and t.device == q.device for _, t in tensors):
        raise ValueError("flash_attention_bwd_cuda takes CUDA tensors on "
                         "one device")
    if q.dtype not in _ENTRY or any(t.dtype != q.dtype for _, t in tensors):
        raise ValueError(f"dtypes {[str(t.dtype) for _, t in tensors]}: "
                         "the kernel takes bf16 or fp32, all alike")
    if (k.shape != (B, Skv, Hk, D) or v.shape != k.shape or H % Hk
            or o.shape != q.shape or do.shape != q.shape):
        raise ValueError(f"shapes {[tuple(t.shape) for _, t in tensors]}")
    if Sq < 1 or Skv < 1:
        raise ValueError(f"empty sequence: Sq {Sq}, Skv {Skv}")
    if D not in _HEAD_DIMS or H // Hk > _MAX_GROUP:
        raise ValueError(f"head_dim {D} (takes {_HEAD_DIMS}) or group "
                         f"{H // Hk} (takes <= {_MAX_GROUP}) not supported")
    if max(Sq * (H // Hk), Skv) > _MAX_ROWS:
        raise ValueError(f"Sq * group {Sq * (H // Hk)} or Skv {Skv} over "
                         f"{_MAX_ROWS} rows: more tiles than the grid holds")
    for name, t in tensors:
        _check_layout(name, t)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    lse = torch.empty((B * H * Sq,), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), B, Sq, Skv, H, Hk, D,
            ctypes.cast(strides, ctypes.c_void_p), int(causal), stream)
    _build.check(code, "flash_attention_bwd")
    launches += 1
    return dq, dk, dv
