#!/usr/bin/env python3
"""The SSD backward against another version of its source, in one run on
one NVIDIA card.

    python3 tools/ssd_bwd_ab.py OTHER.cu       # from the repository root

Builds ``src/repro_torch/csrc/ssd_bwd.cu`` ("this") and ``OTHER.cu``
("other": the same file of another commit, unpacked with ``git archive``;
built against this tree's headers, with the same C entry point) and times
each through ``ssd_bwd_cuda`` with ``chip_smoke.py``'s ``Timer`` (CUDA
events, L2 flushed), in rounds other, this, this, other, at the shapes
``chip_smoke.py::check_ssd_bwd`` times: the training shape (B=8, S=512,
H=32), a mamba2 rank's 16 heads of its sharded training
(``rank-train-h16``) and a batch-1 2048-token sequence (``long``), all at
P=64, N=128, bf16, dt fp32, zero state. Each version gets the scratch for
the dB and dC partials it leaves: as many as this tree's wrapper counts
where its library tells how many heads it sums on chip
(``ssd_bwd_cluster_size``), else one a head (the design before the heads'
sum on chip). Each version's gradients are held against the plain gradient
(||err|| / ||want||, the worst of dx, ddt, dA, dB, dC); "this" must meet
``chip_smoke.py``'s rule. Each version's launches are also profiled. Prints
the card's line, one line per shape and, last, each version's ms (the
median of its two rounds) as one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ and tools/ on the path)

OUT = ROOT / "build" / "ssd_bwd_ab"
# (label, B, S, H), at P = 64, N = 128
SHAPES = (("training", 8, 512, 32), ("rank-train-h16", 8, 512, 16),
          ("long", 1, 2048, 32))
ROUNDS = ("other", "this", "this", "other")
# the kernels of either version, as the profiler names them
LAUNCHES = ("ssd_bwd_wgmma_kernel", "ssd_bwd_tc_kernel", "ssd_bwd_reduce")


def build(other: Path) -> dict[str, ctypes.CDLL]:
    """Both sources compiled in parallel, one ``nvcc`` each."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"this": _build.CSRC / "ssd_bwd.cu", "other": other}
    procs = {}
    for name, src in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(src.read_text())
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    _build.build(["ssd", "ssd_bwd"])    # the forward and the wrapper's own
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}.cu:\n{out}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def main(argv=None) -> int:
    import torch
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1 or not Path(args[0]).is_file():
        print("usage: tools/ssd_bwd_ab.py OTHER.cu", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    from ssd_bwd_tolerance import grad_err
    from repro_torch.kernels.ssd import ssd_bwd_plain, ssd_cuda
    from repro_torch.kernels.ssd import kernel_bwd
    log = chip_smoke.log
    log(chip_smoke.card_line())
    libs = build(Path(args[0]))
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(33)
    orig_entry, orig_parts = kernel_bwd._entry, kernel_bwd.partial_heads
    entry = orig_entry()                             # its argtypes
    fns = {}
    for name, lib in libs.items():
        fn = lib.ssd_bwd
        fn.argtypes, fn.restype = entry.argtypes, entry.restype
        fns[name] = fn
    parts = {name: orig_parts if hasattr(lib, "ssd_bwd_cluster_size")
             else (lambda dtype, B, H, P, N, sms: H)
             for name, lib in libs.items()}

    def use(name):
        kernel_bwd._entry = lambda fn=fns[name]: fn
        kernel_bwd.partial_heads = parts[name]
    F = torch.nn.functional
    out = {}
    try:
        for label, B, S, H in SHAPES:
            def randn(*shape, dtype=torch.float32):
                return torch.randn(*shape, generator=gen,
                                   device="cuda").to(dtype)
            x, dy = (randn(B, S, H, 64, dtype=torch.bfloat16)
                     for _ in range(2))
            dt, A = F.softplus(randn(B, S, H)), -torch.exp(randn(H))
            Bm, Cm = (randn(B, S, 128, dtype=torch.bfloat16)
                      for _ in range(2))
            _, _, states = ssd_cuda(x, dt, A, Bm, Cm, return_states=True)
            want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=256)

            def call():
                return kernel_bwd.ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states)
            errs, times, passes = {}, {name: [] for name in fns}, {}
            for name in fns:
                use(name)
                errs[name] = max(grad_err(g, w)
                                 for g, w in zip(call()[:5], want[:5]))
                passes[name] = {n: t for n, t in chip_smoke.kernel_ms(
                    torch, timer, call, LAUNCHES).items() if t}
            for name in ROUNDS:
                use(name)
                times[name].append(timer.ms(call))
            ms = {name: statistics.median(t) for name, t in times.items()}
            out[label] = ms
            log(f"[ab] {label} B={B} S={S} H={H} P=64 N=128: this "
                f"{ms['this']:.4f} ms "
                f"({', '.join(f'{t:.4f}' for t in times['this'])}; "
                f"{chip_smoke.profiled(passes['this'])}), other "
                f"{ms['other']:.4f} ms "
                f"({', '.join(f'{t:.4f}' for t in times['other'])}; "
                f"{chip_smoke.profiled(passes['other'])}), this / other "
                f"{ms['this'] / ms['other']:.3f}; ||err||/||want|| this "
                f"{errs['this']:.3e}, other {errs['other']:.3e}")
            if not errs["this"] <= chip_smoke.BWD_TOL["bfloat16"]:
                raise AssertionError(f"{label}: this tree's backward "
                                     f"{errs['this']} over the rule")
    finally:
        kernel_bwd._entry, kernel_bwd.partial_heads = orig_entry, orig_parts
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
