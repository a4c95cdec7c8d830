"""Launcher of the CUDA flash attention backward (``csrc/flash_attention_bwd.cu``).

The gradient of ``flash_attention_cuda``: dq, dk and dv from q, k, v, the
forward's output o, its rows' log-sum-exp (``return_lse=True``) and the
output gradient dO, in the model layout (q, o, dO (B, Sq, H, D); k, v
(B, Skv, Hk, D)), read through strides. The JAX package has no backward
kernel (it differentiates its attention under XLA); the source's head note
says how this one is tiled. Three launches: a dq pass, which also writes
delta = rowsum(dO o) to fp32 scratch; a dk/dv pass, whose blocks each take
64 keys and one range of the query rows that reach them and write fp32
partial sums; and a pass that sums each key tile's partials in a fixed
order. This wrapper allocates the scratch (:func:`split_plan` sizes the
partials).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .kernel import _MAX_GROUP, _check_layout

__all__ = ["flash_attention_bwd_cuda", "split_plan", "auto_split"]

# Calls that launched the kernel's three passes since the count was last
# set to 0 (read by chip_smoke.py).
launches = 0

_ENTRY = {torch.bfloat16: "flash_attention_bwd_bf16",
          torch.float32: "flash_attention_bwd_f32"}
# The backward's own head sizes: the forward also takes D = 112, which only
# kimi-k2-1t-a32b has and which it only serves (no card trains it alone).
_HEAD_DIMS = (16, 32, 64, 128)
TILE = 64                        # keys a dk/dv block; rows a range, a unit
_MAX_ROWS = TILE * 65535         # tiles of 64 rows on the grid's y axis
BLOCKS_PER_SM = 2                # the dk/dv grid auto_split aims for


def _entry(dtype: torch.dtype):
    fn = getattr(_build.library("flash_attention_bwd"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def split_plan(Sq: int, Skv: int, G: int, causal: bool,
               n_split: int) -> tuple[int, int]:
    """(span, ranges) of the dk/dv pass for one (b, hk): the folded query
    rows (``pos * G + g``) that reach key tile t (64 keys from 64 t: under
    the causal mask rows from 64 t G on, else all ``Sq * G``) are cut into
    ranges of ``span`` rows, a multiple of 64, the last one shorter; the
    first key tile, which the most rows reach, gets ``n_split`` of them
    (fewer when it has fewer 64-row tiles), later key tiles as many as
    their rows fill. ``ranges`` counts them over all key tiles: one block
    each (the source's ``ranges_of`` counts the same)."""
    if n_split < 1:
        raise ValueError(f"n_split {n_split} < 1")
    NR = Sq * G
    tiles = -(-NR // TILE)
    span = -(-tiles // min(n_split, tiles)) * TILE
    ranges = 0
    for t in range(-(-Skv // TILE)):
        lo = t * TILE * G if causal else 0
        if lo < NR:
            ranges += -(-(NR - lo) // span)
    return span, ranges


@functools.lru_cache(maxsize=256)
def auto_split(B: int, Hk: int, Sq: int, Skv: int, G: int, causal: bool,
               sms: int) -> int:
    """The smallest power of two ``n_split`` whose dk/dv grid holds
    ``BLOCKS_PER_SM`` blocks an SM, or the most the rows allow."""
    tiles = -(-Sq * G // TILE)
    n = 1
    while n < tiles and B * Hk * split_plan(Sq, Skv, G, causal, n)[1] \
            < BLOCKS_PER_SM * sms:
        n *= 2
    return n


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             n_split: int | None = None):
    """q, o, do: (B, Sq, H, D); k, v: (B, Skv, Hk, D), on one CUDA device,
    bf16 or fp32, all alike; lse: the forward's fp32 (B, Hk, Sq * H / Hk)
    (``flash_attention_cuda(..., return_lse=True)``) -> (dq, dk, dv) in q's
    dtype and shapes. ``n_split``: the row ranges of the first key tile in
    the dk/dv pass (:func:`split_plan`); None takes :func:`auto_split`'s."""
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
        raise ValueError(f"head_dim {D} (takes {_HEAD_DIMS}; 112 is "
                         f"ROADMAP B.6) or group {H // Hk} (takes <= "
                         f"{_MAX_GROUP}) not supported")
    G = H // Hk
    if max(Sq * G, Skv) > _MAX_ROWS:
        raise ValueError(f"Sq * group {Sq * G} or Skv {Skv} over "
                         f"{_MAX_ROWS} rows: more tiles than the grid holds")
    for name, t in tensors:
        _check_layout(name, t)
    if (lse.shape != (B, Hk, Sq * G) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse: want the forward's contiguous fp32 "
                         f"{(B, Hk, Sq * G)} on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if n_split is None:
        n_split = auto_split(B, Hk, Sq, Skv, G, bool(causal), _sms(q.device))
    span, ranges = split_plan(Sq, Skv, G, bool(causal), n_split)
    if ranges > 65535:
        raise ValueError(f"{ranges} row ranges: more than the grid holds; "
                         "take a smaller n_split")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = torch.empty((B * H * Sq,), dtype=torch.float32, device=q.device)
    part = torch.empty((2, B * Hk * ranges * TILE * D), dtype=torch.float32,
                       device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), B, Sq, Skv, H, Hk, D,
            ctypes.cast(strides, ctypes.c_void_p), int(causal), span, ranges,
            stream)
    _build.check(code, "flash_attention_bwd")
    launches += 1
    return dq, dk, dv
