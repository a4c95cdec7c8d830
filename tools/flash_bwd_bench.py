#!/usr/bin/env python3
"""The flash-attention kernels alone on the card: ``chip_smoke.py``'s flash
forward check (with its log-sum-exp) and backward check, timings included,
without the script's other phases. Card only.

    python3 tools/flash_bwd_bench.py        # from the repository root

Builds ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``,
prints the card's name and power limit, then the lines of
``chip_smoke.check_flash`` and ``chip_smoke.check_flash_bwd``, then the
backward's time and its passes' at each ``n_split`` (the row ranges of the
dk/dv pass's first key tile) at the two timed shapes, beside the choice of
``auto_split``; exits nonzero if a check fails or there is no card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ and tools/ on the path)


def split_sweep(torch, timer, gen) -> None:
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel_bwd import (auto_split,
                                                                split_plan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, B, S, H, Hk, D in (("training", 8, 512, 32, 4, 64),
                                  ("long", 1, 2048, 32, 4, 64)):
        q, do = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(B, S, Hk, D, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, return_lse=True)
        G = H // Hk
        auto = auto_split(B, Hk, S, S, G, True, sms)
        for n in (1, 2, 4, 8, 16, 32):
            def call():
                return flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                n_split=n)
            ms = timer.ms(call)
            passes = chip_smoke.kernel_ms(torch, timer, call,
                                          chip_smoke.FLASH_BWD)
            span, ranges = split_plan(S, S, G, True, n)
            chip_smoke.log(
                f"[split] {label} B={B} S={S}: n_split {n}"
                f"{' (auto)' if n == auto else ''}: {ms:.4f} ms; "
                f"{', '.join(f'{k} {t:.4f}' for k, t in passes.items())} "
                f"ms; {B * Hk * ranges} dk/dv blocks of up to {span} rows")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_bench: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    log = chip_smoke.log
    log(f"[card] {chip_smoke.card_line()}")
    t0 = time.perf_counter()
    report = _build.build(["flash_attention", "flash_attention_bwd"])
    log(f"[build] {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = chip_smoke.Timer(torch)
    one = torch.zeros(1, device="cuda")
    log(f"[kernels] timer floor: {timer.ms(lambda: one.add_(0)):.4f} ms")
    gen = torch.Generator(device="cuda").manual_seed(0)
    chip_smoke.check_flash(torch, timer, gen)
    chip_smoke.check_flash_bwd(torch, timer, gen)
    split_sweep(torch, timer, gen)
    log(f"[card] {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
