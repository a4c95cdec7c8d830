#!/usr/bin/env python3
"""Does the MoE model check's own-routing rel follow the attention scale's
rounding? (card only)

    python3 tools/moe_check_scale.py [arch [depth]]   # repository root

Runs ``chip_smoke.py::model_check`` of ``arch`` (default kimi-k2-1t-a32b
at depth 1) twice: with the CPU's plain attention path as the port has it
(the scale 1/sqrt(D) rounded to q's dtype, as the reference model rounds
it) and with that path multiplying by the fp32 scale, as the kernels do.
Each run prints the own-routing rel, the (token, k) routing choices that
differ per layer, and rel with the CPU's routing fed to the card. At D =
112 the rounded scale is 0.25% larger than the fp32 one; if the routing
differences came from that, the second run would route alike.
"""

from __future__ import annotations

import gc
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import repro_torch.models.attention as attention  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("moe_check_scale: no CUDA device", file=sys.stderr)
        return 2
    arch = argv[0] if argv else chip_smoke.KIMI_ARCH
    depth = int(argv[1]) if len(argv) > 1 else chip_smoke.KIMI_CHECK_DEPTH
    chip_smoke.log(f"[card] {chip_smoke.card_line()}")
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    rounded = attention._scale
    for label, scale in (("rounded to q's dtype (the port)", rounded),
                         ("fp32 (as the kernels)",
                          lambda D, dtype: 1.0 / math.sqrt(D))):
        chip_smoke.log(f"[scale] the CPU path's attention scale {label}:")
        attention._scale = scale
        try:
            chip_smoke.model_check(torch, arch, depth=depth)
        except AssertionError as exc:
            chip_smoke.log(f"[scale] {exc}")
        finally:
            attention._scale = rounded
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
