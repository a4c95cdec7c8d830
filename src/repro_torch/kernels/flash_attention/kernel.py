"""Launcher of the CUDA flash attention kernel (``csrc/flash_attention.cu``).

The port of ``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``.
It takes the model layout directly (q (B, Sq, H, D), k/v (B, Skv, Hk, D)) and
reads it through strides; the source's head note says how it is tiled and
what bounds it. In bf16 the kernel reads q, k and v with the TMA unit
through tensor maps built for each call, which need 16-byte aligned bases
and strides that are multiples of 16 bytes (8 elements); fp32 runs a
scalar kernel with the same checks.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["flash_attention_cuda"]

# Kernel launches since the count was last set to 0 (read by chip_smoke.py).
launches = 0

_ENTRY = {torch.bfloat16: "flash_attention_bf16",
          torch.float32: "flash_attention_f32"}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 16


def _entry(dtype: torch.dtype):
    fn = getattr(_build.library("flash_attention"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int,
                                                     ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def aligned_rows(t: torch.Tensor) -> bool:
    """Rows contiguous and 16-byte aligned, as the kernels read them."""
    return (t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check_layout(name: str, t: torch.Tensor) -> None:
    if not aligned_rows(t):
        raise ValueError(f"{name}: rows must be contiguous and 16-byte "
                         f"aligned, got strides {t.stride()}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Hk, D) on one CUDA device, bf16 or
    fp32 -> (B, Sq, H, D) in q's dtype."""
    global launches
    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         "kernel takes bf16 or fp32, all alike")
    if k.shape != (B, Skv, Hk, D) or v.shape != k.shape or H % Hk:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if Sq < 1 or Skv < 1:
        raise ValueError(f"empty sequence: Sq {Sq}, Skv {Skv}")
    if D not in _HEAD_DIMS or H // Hk > _MAX_GROUP:
        raise ValueError(f"head_dim {D} (takes {_HEAD_DIMS}) or group "
                         f"{H // Hk} (takes <= {_MAX_GROUP}) not supported")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, Hk, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(causal), stream)
    _build.check(code, "flash_attention")
    launches += 1
    return out
