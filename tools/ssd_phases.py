#!/usr/bin/env python3
"""What C B^T and the M step cost the bf16 SSD kernel, at each split of the
state's rows over blocks, on one NVIDIA card.

    python3 tools/ssd_phases.py        # from the repository root

The kernel (``src/repro_torch/csrc/ssd.cu``, ``ssd_bf16_kernel``) holds 16
state rows a warp and 1, 2 or 4 warps a block; ``ssd_cuda`` takes as many
as P fills (4 at P = 64). This script builds three copies of the source:

- ``full``: unchanged;
- ``no-CB``: step 1 without C B^T's fragment loads and products (the
  accumulators stay 0), so the least time a kernel could take that reads
  C B^T, computed once per (b, chunk), at no cost;
- ``no-M``: without step 1 at all (neither C B^T nor M's exponentials and
  stores).

Only ``full`` computes the scan: it is held against ``ssd_plain`` at every
split (y within 5x the bf16 tolerance relative, state within 1e-4). The
other two give wrong y on purpose and are only timed. Each copy runs through
its C entry point with 1, 2 and 4 warps a block at P = 64, N = 128, bf16,
dt fp32, random state0, at the serving shape (B=8, S=512, H=32) and at a
batch-1 8192-token prompt, timed with ``chip_smoke.py``'s timer (median of
CUDA-event times, L2 flushed before each call). Prints the card's line, one
line per case and, last, the times as one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import TOL, Timer, card_line, log  # noqa: E402

OUT = ROOT / "build" / "ssd_phases"

# Text of ssd.cu around step 1 (the M step): the accumulators' declaration,
# the C B^T loop after it, the epilogue after that, and step 2.
_ACC = "      float acc[kPairs][2][4] = {};\n"
_EPILOGUE = ("#pragma unroll\n      for (int k = 0; k < kPairs; ++k) {\n"
             "#pragma unroll\n        for (int sub = 0; sub < 2; ++sub) {")
_STEP2 = "    }\n\n    // 2. y^T"


def _cut(src: str, start: str, end: str) -> str:
    """``src`` without the text between the end of ``start`` and the
    beginning of ``end``, each found exactly once."""
    for anchor in (start, end):
        if src.count(anchor) != 1:
            raise RuntimeError(f"ssd.cu: {anchor!r} found "
                               f"{src.count(anchor)} times, want 1")
    a = src.index(start) + len(start)
    return src[:a] + src[src.index(end, a):]


def build() -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build
    src = (_build.CSRC / "ssd.cu").read_text()
    variants = {"full": src, "no-CB": _cut(src, _ACC, _EPILOGUE),
                "no-M": _cut(src, _ACC, _STEP2)}
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu:\n{out}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.ssd_bf16.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                                 + [ctypes.c_longlong] * 19
                                 + [ctypes.c_void_p])
        lib.ssd_bf16.restype = ctypes.c_int
        libs[name] = lib
    return libs


def run(torch, lib, warps, x, dt, A, Bm, Cm, state0):
    """One launch of ``lib``'s bf16 kernel with ``warps`` warps a block, as
    ``ssd_cuda`` makes it; returns (y, final state)."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    st = torch.empty_like(state0)
    code = lib.ssd_bf16(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), state0.data_ptr(), y.data_ptr(), st.data_ptr(),
        None, Bb, S, H, P, N, 0, warps, *x.stride()[:3], *dt.stride(),
        *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3],
        *state0.stride()[:3], *st.stride()[:3],
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"ssd_bf16 launch: CUDA error {code}")
    return y, st


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.ssd import ssd_plain
    log(card_line())
    libs = build()
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(14)
    F = torch.nn.functional
    P, N = 64, 128
    times = {}
    for label, B, S, H in (("serving", 8, 512, 32), ("long-b1", 1, 8192, 32)):
        def randn(*shape, dtype=torch.float32):
            return torch.randn(*shape, generator=gen,
                               device="cuda").to(dtype)
        x = randn(B, S, H, P, dtype=torch.bfloat16)
        dt = F.softplus(randn(B, S, H))
        A = -torch.exp(randn(H))
        Bm = randn(B, S, N, dtype=torch.bfloat16)
        Cm = randn(B, S, N, dtype=torch.bfloat16)
        state0 = randn(B, H, P, N)
        y_ref, st_ref = ssd_plain(x, dt, A, Bm, Cm, chunk=256, state0=state0)
        for warps in (4, 2, 1):
            y, st = run(torch, libs["full"], warps, x, dt, A, Bm, Cm, state0)
            torch.cuda.synchronize()
            err_y = float((y.float() - y_ref.float()).abs().max()
                          / y_ref.float().abs().max())
            err_s = float((st - st_ref).abs().max() / st_ref.abs().max())
            if not (err_y < 5 * TOL["bfloat16"] and err_s < 1e-4):
                raise AssertionError(f"{label}, {warps} warps: y rel {err_y},"
                                     f" state rel {err_s}")
            blocks = B * H * (P // (16 * warps))
            for name, lib in libs.items():
                ms = timer.ms(lambda: run(torch, lib, warps, x, dt, A, Bm, Cm,
                                          state0))
                times[f"{label} {16 * warps} rows {name}"] = ms
                log(f"[phases] {label} B={B} S={S} H={H}, {16 * warps} state "
                    f"rows a block ({blocks} blocks), {name}: {ms:.4f} ms"
                    + (f" (y rel {err_y:.3e}, state rel {err_s:.3e})"
                       if name == "full" else ""))
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
