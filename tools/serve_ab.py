#!/usr/bin/env python3
"""The unsharded serving paths of this tree against another tree's, in one
run on one NVIDIA card.

    python3 tools/serve_ab.py OTHER_TREE [--rounds 2]   # from the repo root

``OTHER_TREE`` is another commit unpacked with ``git archive`` (into a
directory that ``.gitignore`` lists, such as ``build/``). Each round runs,
in the order other, this, this, other, one fresh process in that tree that
calls its own ``chip_smoke.py``: ``serve_counted`` of tinyllama-1.1b and
mamba2-370m and ``cut_serve_check`` (qwen3-moe-235b-a22b at 12 layers),
batch 8, 512-token prompts, 32 new tokens. Each tree builds its kernels in
its first process. Prints the card's line, each process's ``[serve]`` lines
under its tree's label and, last, each arch's counted prefill s and decode
tok/s of each tree, every run, as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

RUN = ("import torch, chip_smoke as c; k = c.kernel_counters(); "
       "c.serve_counted(torch, k, 'tinyllama-1.1b', 22, 32000); "
       "c.serve_counted(torch, k, 'mamba2-370m', 48, 50280); "
       "c.cut_serve_check(torch, k)")
COUNTED = re.compile(r"^\[serve\] (\S+) batch=8 .*: prefill ([0-9.]+) s, "
                     r"decode [0-9.]+ s, ([0-9.]+) tok/s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    trees = {"other": args.other.resolve(), "this": ROOT}
    print(f"[card] {chip_smoke.card_line()}", flush=True)
    got: dict = {}
    for _ in range(args.rounds):
        for label in ("other", "this", "this", "other"):
            out = subprocess.run([sys.executable, "-c", RUN],
                                 cwd=trees[label], capture_output=True,
                                 text=True, check=True).stdout
            for line in out.splitlines():
                if not line.startswith("[serve]"):
                    continue
                print(f"[{label}] {line}", flush=True)
                m = COUNTED.match(line)
                if m:
                    arch, prefill, tok_s = m.groups()
                    got.setdefault(arch, {}).setdefault(label, []).append(
                        {"prefill_s": float(prefill),
                         "decode_tok_per_s": float(tok_s)})
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())
