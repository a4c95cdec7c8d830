"""DPlan CLI — ``python -m repro_torch.plan``.

Builds the static :class:`~repro_torch.core.plan.WorkflowPlan` for workflow
documents and/or built-in workloads: critical path, per-function slack +
prewarm schedule, per-key eviction schedule, transfer-cost matrix, peak
resident bytes per node, and the DF016/DF017 stream-feasibility
diagnostics.

Usage::

    python -m repro_torch.plan examples/workflows/wordcount.yaml
    python -m repro_torch.plan --builtin all --nodes 4
    python -m repro_torch.plan --builtin Srv --format json

Exit status is 1 when any plan fails to build, fails its internal
self-check, or (with ``--strict``) carries warning-severity diagnostics —
so the command gates CI directly.

Copy of ``repro/plan.py`` for the PyTorch port, which imports nothing of
``repro``; its code is the reference's, line for line. One departure: every
name of the package it reaches, and the program name its usage prints, is
``repro_torch``'s where the reference's is ``repro``'s, so its output for
the same arguments is the reference's.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from typing import Callable

from repro_torch.core.dag import Workflow, parse_workflow
from repro_torch.core.plan import WorkflowPlan, build_plan

__all__ = ["main"]


def _load_builtin(name: str) -> Workflow:
    from repro_torch.core.workloads import BENCHMARKS

    return BENCHMARKS[name]()


def _load_file(path: str) -> Workflow:
    with open(path, "r", encoding="utf-8") as fh:
        return parse_workflow(fh.read())


def _print_plan(target: str, plan: WorkflowPlan) -> None:
    cp = plan.critical_path
    n_crit = sum(1 for f in plan.functions.values() if f.critical)
    print(f"{target}: workflow {plan.workflow!r} — "
          f"{len(plan.functions)} fn(s), critical path {cp:.3f}s "
          f"({n_crit} critical)")
    print("  prewarm schedule (boot_at, function, cold_start):")
    for fn, boot_at, cold in plan.prewarm_schedule:
        slack = plan.functions[fn].slack
        print(f"    t={boot_at:8.3f}  {fn:24s} cold={cold:.3f} "
              f"slack={slack:.3f}")
    order = plan.eviction_order()
    print(f"  eviction schedule ({len(order)} key(s), earliest-safe "
          "order):")
    for k in order:
        kp = plan.keys[k]
        print(f"    {k:24s} after {kp.reads} read(s) "
              f"[step {kp.last_step}] {kp.size} B")
    cross = [t for t in plan.transfers if t.local is False]
    print(f"  transfers: {len(plan.transfers)} edge(s), "
          f"{len(cross)} cross-node, {plan.cross_node_bytes:.0f} B cut, "
          f"{plan.predicted_pull_bytes()} B predicted pulls")
    if plan.peak_resident:
        peaks = ", ".join(f"{n}={b}" for n, b in
                          sorted(plan.peak_resident.items()))
        print(f"  peak resident bytes: {peaks}")
    for d in plan.diagnostics:
        print(f"  {d.format()}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.plan",
        description="DPlan static workflow planner (liveness/eviction, "
        "slack/prewarm, transfer costs)")
    ap.add_argument("paths", nargs="*", help="workflow.yaml files to plan")
    ap.add_argument("--builtin", action="append", default=[],
                    metavar="NAME",
                    help="plan a built-in workload (repeatable; 'all' "
                    "plans every BENCHMARKS entry)")
    ap.add_argument("--nodes", type=int, default=2, metavar="N",
                    help="partition onto N nodes for placement-aware "
                    "analyses (0 = placement-agnostic plan)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on warning-severity diagnostics "
                    "(DF016)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    targets: list[tuple[str, Callable[[], Workflow]]] = []
    builtins = args.builtin
    if "all" in builtins:
        from repro_torch.core.workloads import BENCHMARKS

        builtins = sorted(BENCHMARKS)
    for name in builtins:
        targets.append((f"builtin:{name}",
                        functools.partial(_load_builtin, name)))
    for path in args.paths:
        targets.append((path, functools.partial(_load_file, path)))
    if not targets:
        ap.error("nothing to plan: pass paths and/or --builtin")

    nodes = [f"node{i}" for i in range(args.nodes)] if args.nodes else None
    failed = 0
    docs = []
    for target, load in targets:
        try:
            plan = build_plan(load(), nodes=nodes)
        except Exception as exc:        # noqa: BLE001 - reported, gates CI
            failed += 1
            if args.format == "text":
                print(f"{target}: PLAN FAILED — "
                      f"{type(exc).__name__}: {exc}")
            else:
                docs.append({"target": target, "error": str(exc)})
            continue
        problems = plan.self_check()
        if problems:
            failed += 1
        if args.strict and any(d.severity in ("warning", "error")
                               for d in plan.diagnostics):
            failed += 1
        if args.format == "json":
            doc = plan.to_doc()
            doc["target"] = target
            doc["self_check"] = problems
            docs.append(doc)
        else:
            _print_plan(target, plan)
            for p in problems:
                print(f"  SELF-CHECK FAILED: {p}")
    if args.format == "json":
        json.dump(docs, sys.stdout, indent=2)
        print()
    else:
        print(f"# planned {len(targets)} workflow(s), {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
