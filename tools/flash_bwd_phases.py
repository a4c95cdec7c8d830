#!/usr/bin/env python3
"""Where the flash backward's passes spend their time, on one NVIDIA card.

    python3 tools/flash_bwd_phases.py        # from the repository root

Builds copies of ``src/repro_torch/csrc/flash_attention_bwd.cu`` with parts
of the dq pass (``bwd_dq_bf16``) or of the dk/dv pass (``bwd_dkdv_bf16``)
cut out, and times each pass of each copy with ``chip_smoke.py``'s
``kernel_ms`` (the profiler's device time a call, L2 flushed before each):

- ``full``: unchanged, and held to the plain gradient (the rule of
  ``chip_smoke.py``);
- ``dq-prologue``: the dq pass without its walk over the keys (Q, dO, o
  read, delta written, dq stored): what a block costs before its first
  tile;
- ``dq-no-dQ``: without the dQ += dS K and P K products (the S and dP
  products, their loads and the ring stay; the exponentials, now used only
  by the rows' sums, stay);
- ``dq-no-exp``: P = S in place of the exponential of S less lse;
- ``dkdv-no-acc``: the dk/dv pass without its dV and dK products (S^T and
  dP^T stay; the exponentials, now unused, go too);
- ``dkdv-no-exp``: P^T = S^T in place of the exponential.

The cut copies give wrong gradients on purpose and are only timed. Shapes:
the training shape (B=8, S=512, H=32, Hk=4, D=64, bf16, causal) and
B=1, S=2048, each with ``auto_split``'s n_split. Prints the card's line, one
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

import chip_smoke  # noqa: E402  (puts src/ and tools/ on the path)

OUT = ROOT / "build" / "flash_bwd_phases"

_DQ_LOOP = ("  for (int t = 0; t < n_tiles; ++t) {\n"
            "    const int kv0 = t * kRows;")
_DQ_PRODUCTS = ("    accumulate<D>(acc, da, k_s);\n"
                "    accumulate<D>(pk, pa, k_s);\n")
_DQ_EXP = ("ex2(fmaf(sc[4 * j + e], scale_log2,\n"
           "                                  -(a ? lseA : lseB)))")
_DKDV_PRODUCTS = ("    accumulate<D>(dv_acc, pa, do_s);\n"
                  "    accumulate<D>(dk_acc, da, q_s);\n")
_DKDV_EXP = ("ex2(fmaf(sc[4 * j + e], scale_log2,\n"
             "                                  -lse_s[col] * kLog2e))")


def _swap(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"flash_attention_bwd.cu: {old!r} found "
                           f"{src.count(old)} times, want 1")
    return src.replace(old, new)


def variants() -> dict[str, str]:
    """The source text of each copy."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    return {
        "full": src,
        "dq-prologue": _swap(src, _DQ_LOOP, _DQ_LOOP.replace(
            "t < n_tiles", "t < 0")),
        "dq-no-dQ": _swap(src, _DQ_PRODUCTS, ""),
        "dq-no-exp": _swap(src, _DQ_EXP, "sc[4 * j + e]"),
        "dkdv-no-acc": _swap(src, _DKDV_PRODUCTS, ""),
        "dkdv-no-exp": _swap(src, _DKDV_EXP, "sc[4 * j + e]")}


def build() -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants().items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_phases: no CUDA device", file=sys.stderr)
        return 1
    from flash_bwd_tolerance import grad_err
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_cuda)
    from repro_torch.kernels.flash_attention import kernel_bwd
    log = chip_smoke.log
    log(chip_smoke.card_line())
    libs = build()
    timer = chip_smoke.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(16)
    orig = kernel_bwd._entry
    entry = orig(torch.bfloat16)                     # its argtypes
    times = {}
    try:
        for label, B, S in (("training", 8, 512), ("long", 1, 2048)):
            H, Hk, D = 32, 4, 64
            q, do = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                     .bfloat16() for _ in range(2))
            k, v = (torch.randn(B, S, Hk, D, generator=gen, device="cuda")
                    .bfloat16() for _ in range(2))
            o, lse = flash_attention_cuda(q, k, v, return_lse=True)
            want = flash_attention_bwd_plain(q, k, v, do)
            for name, lib in libs.items():
                fn = lib.flash_attention_bwd_bf16
                fn.argtypes, fn.restype = entry.argtypes, entry.restype
                kernel_bwd._entry = lambda dtype, fn=fn: fn

                def call():
                    return kernel_bwd.flash_attention_bwd_cuda(
                        q, k, v, o, do, lse)
                note = ""
                if name == "full":
                    errs = [grad_err(g, w) for g, w in zip(call(), want)]
                    if not max(errs) <= chip_smoke.BWD_TOL["bfloat16"]:
                        raise AssertionError(f"{label} full: {errs}")
                    note = f" (||err||/||want|| {max(errs):.3e})"
                passes = chip_smoke.kernel_ms(torch, timer, call,
                                              chip_smoke.FLASH_BWD)
                times[f"{label} {name}"] = passes
                log(f"[phases] {label} B={B} S={S}, {name}: "
                    + ", ".join(f"{n} {t:.4f} ms" for n, t in passes.items())
                    + note)
    finally:
        kernel_bwd._entry = orig
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
