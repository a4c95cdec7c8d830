"""Launcher of the CUDA SSD chunked-scan kernel (``csrc/ssd.cu``).

The port of ``repro/kernels/ssd/kernel.py::ssd_pallas``, with the incoming
and final state that the model's scan carries. It takes the model layout
directly (x (B, S, H, P), dt (B, S, H), B/C (B, S, N)) and reads it through
strides; the source's head note says how it is tiled and what bounds it.

bf16 (x, B, C; dt bf16 or fp32) runs on the tensor cores: each warp owns 16
rows of the state, a block up to four warps of one (b, h). fp32 runs a
scalar IEEE kernel, one block per (b, h). :func:`plan` gives either launch's
geometry without a card. Under grad the forward may also write the fp32
state entering each chunk (``return_states``), which the backward kernel
(``kernel_bwd.py``) reads.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import _build

__all__ = ["ssd_cuda", "plan", "Plan"]

# Kernel launches since the count was last set to 0 (read by chip_smoke.py).
launches = 0

CHUNK = 64                       # the kernel's own chunk (kQ in ssd.cu)
_SLICE = 16                      # state rows a warp owns (kSlice)
_PAD = 8                         # bf16 row padding (kPad)
_BF16_N = (16, 32, 64, 128)      # state sizes the bf16 kernel is built for
_MAX_SMEM = 232448               # bytes of shared memory a block can have
_SM_SMEM = 233472                # ... an SM has (228 KB)
_SM_RESERVED = 1024              # ... the system keeps for each block
_SM_WARPS = 64                   # warps an SM can hold


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: ``warps`` warps a block on a ``grid`` of (b * h, state-row
    groups), each block with ``smem_bytes`` of shared memory, so at most
    ``blocks_per_sm`` blocks an SM (by shared memory and warps; registers
    are ptxas's to report). ``rows`` is the state rows a block owns."""
    kernel: str                  # "bf16" (tensor cores) or "f32" (scalar)
    warps: int
    rows: int
    grid: tuple[int, int]
    smem_bytes: int
    blocks_per_sm: int


def _bf16_smem(N: int, warps: int) -> int:
    """ssd.cu's bf16_smem_bytes."""
    Q = CHUNK
    return (2 * 4 * Q * 4 + 2 * 2 * Q * (N + _PAD) * 2 + Q * (Q + _PAD) * 2
            + 2 * Q * (_SLICE * warps + _PAD) * 2)


def _f32_smem(P: int, N: int) -> int:
    """ssd.cu's f32_smem_floats, in bytes."""
    Q = CHUNK
    return 4 * (Q * P + Q * N + N * (Q + 4) + N * (P + 4) + Q * Q + 3 * Q)


def plan(B: int, H: int, P: int, N: int, dtype: torch.dtype) -> Plan:
    """The launch of ``ssd_cuda`` for x of ``dtype`` and these sizes; raises
    ``ValueError`` for sizes the kernel does not take. A bf16 block has as
    many warps as P fills, up to 4, each owning 16 state rows; P past 64
    spreads a head over more blocks."""
    if min(B, H, P, N) < 1:
        raise ValueError(f"B={B}, H={H}, P={P}, N={N}: all must be >= 1")
    if dtype == torch.bfloat16:
        if N not in _BF16_N or P % 8:
            raise ValueError(
                f"P={P}, N={N}: the bf16 kernel holds a warp's 16 state rows "
                f"in registers, N/2 values a lane, and is built for N in "
                f"{_BF16_N}; it copies x in 16-byte pieces, so P % 8 == 0")
        warps = 4 if P >= 64 else 2 if P >= 32 else 1
        rows = _SLICE * warps
        smem = _bf16_smem(N, warps)
        return Plan("bf16", warps, rows, (B * H, -(-P // rows)), smem,
                    min(_SM_SMEM // (smem + _SM_RESERVED),
                        _SM_WARPS // warps))
    if dtype == torch.float32:
        smem = _f32_smem(P, N)
        if P % 4 or N % 4 or smem > _MAX_SMEM:
            raise ValueError(f"P={P}, N={N}: the fp32 kernel takes P and N "
                             f"multiples of 4, and {smem} bytes of shared "
                             f"memory must fit in {_MAX_SMEM}")
        return Plan("f32", 8, P, (B * H, 1), smem,
                    min(_SM_SMEM // (smem + _SM_RESERVED), _SM_WARPS // 8))
    raise ValueError(f"dtype {dtype}: the kernel takes bf16 or fp32")


def _entry(name: str):
    fn = getattr(_build.library("ssd"), name)
    if fn.argtypes is None:
        n_int = 7 if name == "ssd_bf16" else 5
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * n_int
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


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` when each row the bf16 kernel copies starts on 16 bytes (its
    16-byte ``cp.async`` loads), else a contiguous copy of it."""
    if t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *,
             state0: torch.Tensor | None = None,
             state_out: torch.Tensor | None = None,
             return_states: bool = False):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,) fp32; Bm, Cm: (B, S, N);
    state0: (B, H, P, N) fp32 or None (zeros), all on one CUDA device.
    x, Bm and Cm are bf16 with dt fp32 or bf16, or all fp32.

    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32).
    The final state is written into ``state_out`` when given (it may be
    ``state0`` itself: an in-place update), else into a new tensor. With
    ``return_states`` a third output holds the fp32 state entering each of
    the kernel's chunks of ``CHUNK`` positions, (B, H, ceil(S / CHUNK), P,
    N), as the backward kernel reads it; without it none is allocated."""
    global launches
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (dt, A, Bm, Cm))):
        raise ValueError("ssd_cuda takes CUDA tensors on one device")
    bf16 = x.dtype == torch.bfloat16
    if x.dtype not in (torch.bfloat16, torch.float32) \
            or Bm.dtype != x.dtype or Cm.dtype != x.dtype \
            or dt.dtype not in ((torch.bfloat16, torch.float32) if bf16
                                else (torch.float32,)) \
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
    if S < 1:
        raise ValueError(f"S={S}: the kernel takes S >= 1")
    geo = plan(Bb, H, P, N, x.dtype)
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: innermost stride must be 1, got "
                             f"{t.stride()}")
    if bf16:
        x, Bm, Cm = _aligned16(x), _aligned16(Bm), _aligned16(Cm)
    if A.stride(0) != 1:
        A = A.contiguous()
    if state0 is not None:
        _check_state("state0", state0, (Bb, H, P, N), dev)
    if state_out is None:
        state_out = torch.empty((Bb, H, P, N), dtype=torch.float32,
                                device=dev)
    _check_state("state_out", state_out, (Bb, H, P, N), dev)
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=dev)
    states = torch.empty((Bb, H, -(-S // CHUNK), P, N), dtype=torch.float32,
                         device=dev) if return_states else None
    s_in = state0 if state0 is not None else state_out   # strides only
    ints = (Bb, S, H, P, N) + ((int(dt.dtype == torch.bfloat16), geo.warps)
                               if bf16 else ())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry("ssd_bf16" if bf16 else "ssd_f32")(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), state0.data_ptr() if state0 is not None else None,
            y.data_ptr(), state_out.data_ptr(),
            states.data_ptr() if states is not None else None, *ints,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            y.stride(0), y.stride(1), y.stride(2),
            s_in.stride(0), s_in.stride(1), s_in.stride(2),
            state_out.stride(0), state_out.stride(1), state_out.stride(2),
            stream)
    _build.check(code, "ssd")
    launches += 1
    return (y, state_out, states) if return_states else (y, state_out)
