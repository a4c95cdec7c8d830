"""Launcher of the CUDA SSD chunked-scan kernel (``csrc/ssd.cu``).

The port of ``repro/kernels/ssd/kernel.py::ssd_pallas``, with the incoming
and final state that the model's scan carries. It takes the model layout
directly (x (B, S, H, P), dt (B, S, H), B/C (B, S, N)) and reads it through
strides; the source's head note says how it is tiled and what bounds it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["ssd_cuda", "smem_bytes"]

# Kernel launches since the count was last set to 0 (read by chip_smoke.py).
launches = 0

# (x/B/C dtype, dt dtype) -> C entry point
_ENTRY = {(torch.bfloat16, torch.float32): "ssd_bf16_dtf32",
          (torch.bfloat16, torch.bfloat16): "ssd_bf16_dtbf16",
          (torch.float32, torch.float32): "ssd_f32"}
_CHUNK = 64                      # the kernel's own chunk (kQ in ssd.cu)
_MAX_SMEM = 232448               # bytes of shared memory a block can have


def smem_bytes(P: int, N: int) -> int:
    """Shared memory of one block (ssd.cu's smem_floats, in bytes)."""
    Q = _CHUNK
    return 4 * (Q * P + Q * N + N * (Q + 4) + N * (P + 4) + Q * Q + 3 * Q)


def _entry(name: str):
    fn = getattr(_build.library("ssd"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 19 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_state(name: str, s: torch.Tensor, shape, device) -> None:
    if s.device != device or s.dtype != torch.float32 \
            or tuple(s.shape) != shape or s.stride(-1) != 1:
        raise ValueError(f"{name}: want fp32 {shape} on {device} with "
                         f"innermost stride 1, got {s.dtype} "
                         f"{tuple(s.shape)} on {s.device}, strides "
                         f"{s.stride()}")


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             state0: torch.Tensor | None = None,
             state_out: torch.Tensor | None = None):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,) fp32; Bm, Cm: (B, S, N);
    state0: (B, H, P, N) fp32 or None (zeros), all on one CUDA device.
    x, Bm and Cm are bf16 with dt fp32 or bf16, or all fp32.

    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32).
    The final state is written into ``state_out`` when given (it may be
    ``state0`` itself: an in-place update), else into a new tensor."""
    global launches
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (dt, A, Bm, Cm))):
        raise ValueError("ssd_cuda takes CUDA tensors on one device")
    key = (x.dtype, dt.dtype)
    if key not in _ENTRY or Bm.dtype != x.dtype or Cm.dtype != x.dtype \
            or A.dtype != torch.float32:
        raise ValueError(f"dtypes x {x.dtype}, dt {dt.dtype}, A {A.dtype}, "
                         f"B {Bm.dtype}, C {Cm.dtype}: the kernel takes "
                         "x/B/C bf16 with dt fp32 or bf16, or all fp32, and "
                         "A fp32")
    if dt.shape != (Bb, S, H) or A.shape != (H,) \
            or Bm.shape != (Bb, S, N) or Cm.shape != (Bb, S, N):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(Bm.shape)}, "
                         f"C {tuple(Cm.shape)}")
    if min(Bb, S, H) < 1 or P % 4 or N % 4 or smem_bytes(P, N) > _MAX_SMEM:
        raise ValueError(f"B={Bb}, S={S}, H={H}, P={P}, N={N}: the kernel "
                         "takes B, S, H >= 1, P and N multiples of 4, and "
                         f"{smem_bytes(P, N)} bytes of shared memory must "
                         f"fit in {_MAX_SMEM}")
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: innermost stride must be 1, got "
                             f"{t.stride()}")
    if A.stride(0) != 1:
        A = A.contiguous()
    if state0 is not None:
        _check_state("state0", state0, (Bb, H, P, N), dev)
    if state_out is None:
        state_out = torch.empty((Bb, H, P, N), dtype=torch.float32,
                                device=dev)
    _check_state("state_out", state_out, (Bb, H, P, N), dev)
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=dev)
    s_in = state0 if state0 is not None else state_out   # strides only
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry(_ENTRY[key])(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), state0.data_ptr() if state0 is not None else None,
            y.data_ptr(), state_out.data_ptr(),
            Bb, S, H, P, N,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            y.stride(0), y.stride(1), y.stride(2),
            s_in.stride(0), s_in.stride(1), s_in.stride(2),
            state_out.stride(0), state_out.stride(1), state_out.stride(2),
            stream)
    _build.check(code, "ssd")
    launches += 1
    return y, state_out
