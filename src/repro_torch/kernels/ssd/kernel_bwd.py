"""Launcher of the CUDA SSD backward (``csrc/ssd_bwd.cu``).

The gradient of ``ssd_cuda``: dx, ddt, dA, dB, dC and the incoming state's
gradient, from the forward's inputs, the cotangent dy of y, the final
state's cotangent (or none) and the fp32 states entering each of the
forward's chunks (``ssd_cuda(..., return_states=True)``), in the model
layout (x, dy (B, S, H, P); dt (B, S, H); B, C (B, S, N)), read through
strides. The JAX package has no kernel for it (it differentiates
``ssd_chunked`` under XLA); the source's head note gives the formulas and
the design. Two launches: one block per (b, h) walking the chunks in
reverse, which writes dx, ddt and fp32 partials of dB, dC (per head) and dA
(per (b, h)); and a pass that sums the partials in a fixed order. The walk
runs on the tensor cores (``mma.sync``, four warps) for bf16 at the sizes
:func:`tensor_cores` names (mamba2's heads), else as scalar fp32 FMA.
This wrapper allocates the outputs and the scratch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .kernel import CHUNK, _aligned16

__all__ = ["ssd_bwd_cuda", "tensor_cores"]

# Calls that launched the kernel's two passes since the count was last set
# to 0 (read by chip_smoke.py).
launches = 0

_TC_SIZES = ((64, 128),)         # (P, N) the tensor-core kernel is built for


def tensor_cores(dtype: torch.dtype, P: int, N: int) -> bool:
    """Whether ``ssd_bwd_cuda`` walks on the tensor cores at these sizes:
    bf16 at a (P, N) the source instantiates, mamba2-370m's P = 64, N =
    128."""
    return dtype == torch.bfloat16 and (P, N) in _TC_SIZES


def _entry():
    fn = _build.library("ssd_bwd").ssd_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 13 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ssd_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                 states: torch.Tensor, *,
                 dstate: torch.Tensor | None = None,
                 want_dstate0: bool = False):
    """x, dy: (B, S, H, P); dt: (B, S, H); A: (H,) fp32; Bm, Cm: (B, S, N);
    states: the forward's fp32 (B, H, ceil(S / 64), P, N); dstate: the
    final state's fp32 (B, H, P, N) cotangent or None (zeros); all on one
    CUDA device. x, Bm, Cm and dy are bf16 with dt fp32 or bf16, or all
    fp32.

    Returns (dx in x's dtype, ddt in dt's, dA fp32 (H,), dB, dC in x's
    dtype, dstate0 fp32 (B, H, P, N) or None unless ``want_dstate0``)."""
    global launches
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    dev = x.device
    tensors = (("x", x), ("dt", dt), ("A", A), ("B", Bm), ("C", Cm),
               ("dy", dy), ("states", states))
    if not (x.is_cuda and all(t.device == dev for _, t in tensors)
            and (dstate is None or dstate.device == dev)):
        raise ValueError("ssd_bwd_cuda takes CUDA tensors on one device")
    bf16 = x.dtype == torch.bfloat16
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or any(t.dtype != x.dtype for t in (Bm, Cm, dy)) \
            or dt.dtype not in ((torch.bfloat16, torch.float32) if bf16
                                else (torch.float32,)) \
            or A.dtype != torch.float32:
        raise ValueError(f"dtypes {[str(t.dtype) for _, t in tensors]}: the "
                         "kernel takes x/B/C/dy bf16 with dt fp32 or bf16, "
                         "or all fp32, and A fp32")
    nc = -(-S // CHUNK)
    if dt.shape != (Bb, S, H) or A.shape != (H,) or dy.shape != x.shape \
            or Bm.shape != (Bb, S, N) or Cm.shape != (Bb, S, N):
        raise ValueError(f"shapes {[tuple(t.shape) for _, t in tensors]}")
    tc = tensor_cores(x.dtype, P, N)
    # a state too wide for the scalar kernel's shared memory fails in the
    # C entry (setting the kernel's shared memory), raised by _build.check
    if S < 1 or P % 4 or N % 4:
        raise ValueError(f"S={S}, P={P}, N={N}: the kernel takes S >= 1, P "
                         f"and N multiples of 4")
    for name, t in (("x", x), ("B", Bm), ("C", Cm), ("dy", dy)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: innermost stride must be 1, got "
                             f"{t.stride()}")
    for name, t, shape in (("states", states, (Bb, H, nc, P, N)),
                           ("dstate", dstate, (Bb, H, P, N))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous fp32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}, strides "
                             f"{t.stride()}")
    if A.stride(0) != 1:
        A = A.contiguous()
    if tc:        # its 16-byte cp.async copies of x, dy, B and C
        x, dy, Bm, Cm = (_aligned16(t) for t in (x, dy, Bm, Cm))

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    dx = torch.empty((Bb, S, H, P), dtype=x.dtype, device=dev)
    dB = torch.empty((Bb, S, N), dtype=x.dtype, device=dev)
    dC = torch.empty((Bb, S, N), dtype=x.dtype, device=dev)
    ddt, dA = f32(Bb, S, H), f32(H)
    dstate0 = f32(Bb, H, P, N) if want_dstate0 else None
    dBp, dCp, dAp = f32(Bb, H, S, N), f32(Bb, H, S, N), f32(Bb, H)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(), states.data_ptr(),
            dstate.data_ptr() if dstate is not None else None,
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(),
            dstate0.data_ptr() if dstate0 is not None else None,
            dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), int(bf16),
            int(tc), int(dt.dtype == torch.bfloat16), Bb, S, H, P, N,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:2],
            *Cm.stride()[:2], *dy.stride()[:3], stream)
    _build.check(code, "ssd_bwd")
    launches += 1
    return dx, ddt.to(dt.dtype), dA, dB, dC, dstate0
