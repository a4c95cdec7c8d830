"""Launcher of the CUDA decode attention kernel (``csrc/decode_attention.cu``).

The port of
``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``. It takes
the model layout directly (q (B, 1, H, D), k/v (B, L, Hk, D), e.g. one
layer's view of the stacked cache) and reads ``length`` on the device; the
source's head note says how it is tiled and what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["decode_attention_cuda"]

# Kernel launches since the count was last set to 0 (read by chip_smoke.py).
launches = 0

_ENTRY = {torch.bfloat16: "decode_attention_bf16",
          torch.float32: "decode_attention_f32"}
_MAX_GROUP = 16
_MAX_GROUP_X_D = 2048


def _entry(dtype: torch.dtype):
    fn = getattr(_build.library("decode_attention"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, D); k, v: (B, L, Hk, D); length: int32 tensor of one
    element, all on one CUDA device -> (B, 1, H, D) in q's dtype.
    Contract: 1 <= length <= L (not checked: the host never reads it)."""
    global launches
    B, Sq, H, D = q.shape
    L, Hk = k.shape[1], k.shape[2]
    if not all(t.is_cuda and t.device == q.device for t in (k, v, length)):
        raise ValueError("decode_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         "kernel takes bf16 or fp32, all alike")
    if length.dtype != torch.int32 or length.numel() != 1:
        raise ValueError("length must be one int32 element")
    if Sq != 1 or k.shape != (B, L, Hk, D) or v.shape != k.shape or H % Hk:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    G = H // Hk
    if D % 8 or G > _MAX_GROUP or G * D > _MAX_GROUP_X_D:
        raise ValueError(f"head_dim {D} (a multiple of 8) or group {G} "
                         f"(<= {_MAX_GROUP}, group*head_dim <= "
                         f"{_MAX_GROUP_X_D}) not supported")
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be contiguous and 16-byte "
                             f"aligned, got strides {t.stride()}")
    if q.stride(-1) != 1:
        raise ValueError(f"q: innermost stride must be 1, got {q.stride()}")
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            out.data_ptr(), B, H, Hk, L, D,
            q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            stream)
    _build.check(code, "decode_attention")
    launches += 1
    return out
