#!/usr/bin/env python3
"""The flash backward against another version of its source, in one run on
one NVIDIA card.

    python3 tools/flash_bwd_ab.py OTHER.cu     # from the repository root

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` ("this") and
``OTHER.cu`` ("other": the same file of another commit, unpacked with
``git archive``; built against this tree's headers, with the same C entry
points) and times the backward alone of each with ``chip_smoke.py``'s
``Timer`` (CUDA events, L2 flushed), in rounds other, this, this, other, at
the training shape (B=8, S=512, H=32, Hk=4, D=64, causal), qwen3-moe's
G = 16 (H=64, D=128) and seamless-m4t's three training forms (G = 1,
D = 64: the encoder's 1024 x 1024 and the cross-attention's 512 queries
over 1024 keys, non-causal; the decoder's 512, causal). Each version's
gradients are reported against the plain gradient (||err|| / ||want||, the
worst of dq, dk, dv); "this" is held to ``chip_smoke.py``'s rule. Prints
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

OUT = ROOT / "build" / "flash_bwd_ab"
# (label, B, Sq, Skv, H, Hk, D, causal)
SHAPES = (("training", 8, 512, 512, 32, 4, 64, True),
          ("g16", 8, 512, 512, 64, 4, 128, True),
          ("seamless-encoder", 8, 1024, 1024, 16, 16, 64, False),
          ("seamless-cross", 8, 512, 1024, 16, 16, 64, False),
          ("seamless-decoder", 8, 512, 512, 16, 16, 64, True))
ROUNDS = ("other", "this", "this", "other")


def build(other: Path) -> dict[str, ctypes.CDLL]:
    """Both sources compiled in parallel, one ``nvcc`` each."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {"this": _build.CSRC / "flash_attention_bwd.cu",
               "other": other}
    procs = {}
    for name, src in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(src.read_text())
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(OUT / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
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
        print("usage: tools/flash_bwd_ab.py OTHER.cu", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    from flash_bwd_tolerance import grad_err
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_cuda)
    from repro_torch.kernels.flash_attention import kernel_bwd
    log = chip_smoke.log
    log(chip_smoke.card_line())
    libs = build(Path(args[0]))
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(24)
    orig = kernel_bwd._entry
    entry = orig(torch.bfloat16)                     # its argtypes
    fns = {}
    for name, lib in libs.items():
        fn = lib.flash_attention_bwd_bf16
        fn.argtypes, fn.restype = entry.argtypes, entry.restype
        fns[name] = fn
    out = {}
    try:
        for label, B, Sq, Skv, H, Hk, D, causal in SHAPES:
            q, do = (torch.randn(B, Sq, H, D, generator=gen, device="cuda")
                     .bfloat16() for _ in range(2))
            k, v = (torch.randn(B, Skv, Hk, D, generator=gen,
                                device="cuda").bfloat16() for _ in range(2))
            o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                          return_lse=True)
            want = flash_attention_bwd_plain(q, k, v, do, causal=causal)

            def call():
                return kernel_bwd.flash_attention_bwd_cuda(
                    q, k, v, o, do, lse, causal=causal)
            errs, times = {}, {name: [] for name in fns}
            for name, fn in fns.items():
                kernel_bwd._entry = lambda dtype, fn=fn: fn
                errs[name] = max(grad_err(g, w) for g, w in zip(call(), want))
            for name in ROUNDS:
                kernel_bwd._entry = lambda dtype, fn=fns[name]: fn
                times[name].append(timer.ms(call))
            ms = {name: statistics.median(t) for name, t in times.items()}
            out[label] = ms
            log(f"[ab] {label} B={B} Sq={Sq} Skv={Skv} H={H} Hk={Hk} D={D} "
                f"causal={causal}: this {ms['this']:.4f} ms "
                f"({', '.join(f'{t:.4f}' for t in times['this'])}), other "
                f"{ms['other']:.4f} ms "
                f"({', '.join(f'{t:.4f}' for t in times['other'])}), this / "
                f"other {ms['this'] / ms['other']:.3f}; ||err||/||want|| "
                f"this {errs['this']:.3e}, other {errs['other']:.3e}")
            if not errs["this"] <= chip_smoke.BWD_TOL["bfloat16"]:
                raise AssertionError(f"{label}: this tree's backward "
                                     f"{errs['this']} over the rule")
    finally:
        kernel_bwd._entry = orig
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
