#!/usr/bin/env python3
"""tinyllama-1.1b's train step under the port's DFlow engine against
``train_loop``, on the card, in alternating rounds. Card only.

    python3 tools/orchestrate_bench.py [--rounds 3]    # from the repo root

Full width and depth, batch 8 x 512 tokens, remat, 6 steps a run. Each round
runs ``train_loop``, then ``run_training`` under "dataflow", then under
"controlflow" (``chip_smoke.run_orchestrated``: the same set-up, step and
data), and prints each run's ms a step by the host clock between two
``cuda.synchronize``. Then the engine's own cost on the host: the same DAG
of 6 steps whose functions return at once, run 20 times under each
pattern. Ends with the medians; exits nonzero if there is no card or two
runs' losses differ.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ and tools/ on the path)

PATTERNS = ("dataflow", "controlflow")


def engine_ms(steps: int = 6, runs: int = 20) -> dict:
    """Median host ms a step of the training DAG with functions that return
    at once: the engine's threads, Gets and Puts, nothing else."""
    from repro_torch.runtime.orchestrator import (OrchestratorConfig,
                                                  run_training)
    out = {}
    for pattern in PATTERNS:
        cfg = OrchestratorConfig(n_steps=steps, pattern=pattern)
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            run_training(cfg, init_state=0, fetch=lambda i: i,
                         train=lambda s, b: (s + 1, {}))
            times.append((time.perf_counter() - t0) / steps * 1e3)
        out[pattern] = statistics.median(times)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("orchestrate_bench: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.launch import train as train_mod
    print(f"[card] {chip_smoke.card_line()}", flush=True)
    kw = dict(steps=6, batch=8, seq=512, seed=0)
    train_mod.train_loop(chip_smoke.ORCH_ARCH, log_every=0, device="cuda",
                         **{**kw, "steps": 2})                   # warm
    ms = {how: [] for how in ("train_loop", *PATTERNS)}
    losses = set()
    for r in range(args.rounds):
        for how in ms:
            if how == "train_loop":
                out = train_mod.train_loop(chip_smoke.ORCH_ARCH, log_every=0,
                                           device="cuda", **kw)
            else:
                out = chip_smoke.run_orchestrated(torch, train_mod, how, kw)
            ms[how].append(out["wall_s"] / kw["steps"] * 1e3)
            losses.add(tuple(out["losses"]))
            print(f"[bench] round {r} {how}: {ms[how][-1]:.1f} ms/step",
                  flush=True)
    for how, values in ms.items():
        print(f"[bench] {how}: median {statistics.median(values):.1f} "
              f"ms/step over {len(values)} runs "
              f"({', '.join(f'{v:.1f}' for v in values)})")
    for pattern, value in engine_ms().items():
        print(f"[bench] the engine alone, {pattern}: {value:.3f} ms a step "
              f"(median of 20 runs of 6 steps, functions that return at "
              f"once)")
    if len(losses) != 1:
        print(f"orchestrate_bench: runs' losses differ: {losses}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
