"""Launcher of the CUDA decode attention kernel (``csrc/decode_attention.cu``).

The port of
``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``. It takes
the model layout directly (q (B, 1, H, D), k/v (B, L, Hk, D), e.g. one
layer's view of the stacked cache) and reads ``length`` on the device; the
source's head note says how it is tiled and what bounds it.

The key axis is split over blocks of ``keys_per_split()`` keys: each
writes an fp32 partial (m, l, acc) to scratch allocated here with
``torch.empty``, and a second kernel merges the partials. The number of
splits comes from the cache capacity L, never from ``length``, so the call
never waits on the card and can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

__all__ = ["decode_attention_cuda"]

# Kernel launches since the count was last set to 0 (read by chip_smoke.py).
launches = 0

_ENTRY = {torch.bfloat16: "decode_attention_bf16",
          torch.float32: "decode_attention_f32"}
_HEAD_DIMS = (16, 32, 64, 112, 128, 256)
_MAX_GROUP = 16
_MAX_GROUP_X_D = 2048


def _entry(dtype: torch.dtype):
    fn = getattr(_build.library("decode_attention"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@functools.cache
def keys_per_split() -> int:
    """Keys each block of the split kernel takes (``kSplit`` in the
    source)."""
    return _build.library("decode_attention").decode_attention_keys_per_split()


def scratch_floats(B: int, Hk: int, G: int, L: int, D: int) -> int:
    """fp32 values of the partials: (m, l) and acc[D] for each (b, hk,
    split, g)."""
    n_split = -(-L // keys_per_split())
    return B * Hk * n_split * G * (2 + D)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length: torch.Tensor, what: str) -> None:
    """Raise ``ValueError`` on inputs the kernel does not take."""
    B, Sq, H, D = q.shape
    L, Hk = k.shape[1], k.shape[2]
    if not all(t.is_cuda and t.device == q.device for t in (k, v, length)):
        raise ValueError(f"{what} takes CUDA tensors on one device")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         "kernel takes bf16 or fp32, all alike")
    if length.dtype != torch.int32 or length.numel() != 1:
        raise ValueError("length must be one int32 element")
    if Sq != 1 or k.shape != (B, L, Hk, D) or v.shape != k.shape or H % Hk:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    G = H // Hk
    if D not in _HEAD_DIMS or G > _MAX_GROUP or G * D > _MAX_GROUP_X_D:
        raise ValueError(f"head_dim {D} (takes {_HEAD_DIMS}) or group {G} "
                         f"(<= {_MAX_GROUP}, group*head_dim <= "
                         f"{_MAX_GROUP_X_D}) not supported")
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be contiguous and 16-byte "
                             f"aligned, got strides {t.stride()}")
    if q.stride(-1) != 1:
        raise ValueError(f"q: innermost stride must be 1, got {q.stride()}")


def strided_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """B, H, Hk, L, D and the strides, in the C entry points' order."""
    B, _, H, D = q.shape
    L, Hk = k.shape[1], k.shape[2]
    return (B, H, Hk, L, D, q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2))


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, D); k, v: (B, L, Hk, D); length: int32 tensor of one
    element, all on one CUDA device -> (B, 1, H, D) in q's dtype.
    Contract: 1 <= length <= L (not checked: the host never reads it)."""
    global launches
    check_args(q, k, v, length, "decode_attention_cuda")
    B, _, H, D = q.shape
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    n_scratch = scratch_floats(B, k.shape[2], H // k.shape[2], k.shape[1], D)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n_scratch,
            *strided_args(q, k, v), stream)
    _build.check(code, "decode_attention")
    launches += 1
    return out
