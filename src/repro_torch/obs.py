"""DScope CLI — ``python -m repro_torch.obs``.

Works over the span files that ``--spans`` flags (serve_load,
dshard_routing) and :func:`repro_torch.core.obs.write_spans_jsonl` produce,
and over the standardized ``dflow-bench/v1`` documents every
``BENCH_*.json`` emitter now writes.

Subcommands::

    python -m repro_torch.obs summarize spans.jsonl          # span-tree stats
    python -m repro_torch.obs attribute spans.jsonl          # plan vs actual
    python -m repro_torch.obs perfetto  spans.jsonl -o t.json  # Chrome trace
    python -m repro_torch.obs diff BENCH_old.json BENCH_new.json  # regressions

``attribute`` needs the DPlan attribution document; ``write_spans_jsonl``
embeds it in the head line when the producer had a plan, or pass
``--plan plan.json`` explicitly.  ``diff`` exits 1 when any gated metric
regressed beyond its tolerance — it is the CI regression gate.

Copy of ``repro/obs.py`` for the PyTorch port, which imports nothing of
``repro``; its code is the reference's, line for line. One departure: every
name of the package it reaches, and the program name its usage prints, is
``repro_torch``'s where the reference's is ``repro``'s, so its output for
the same arguments is the reference's.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from collections import Counter, defaultdict

from repro_torch.core.obs import (Span, attribute, compare_docs, read_spans_jsonl,
                            to_chrome_trace)

__all__ = ["main"]


def _load(path: str) -> tuple[list[Span], dict]:
    try:
        return read_spans_jsonl(path)
    except (OSError, ValueError, KeyError) as exc:
        raise SystemExit(f"error: cannot read span file {path!r}: {exc}")


def _fmt_s(v: float) -> str:
    if not math.isfinite(v):
        return "-"
    return f"{v * 1e3:.2f}ms" if v < 1.0 else f"{v:.3f}s"


def _cmd_summarize(args) -> int:
    spans, meta = _load(args.spans)
    if not spans:
        print("no spans")
        return 0
    by_kind: dict[str, list[float]] = defaultdict(list)
    traces = Counter()
    for s in spans:
        by_kind[s.kind].append(s.duration)
        traces[s.trace] += 1
    print(f"{args.spans}: {len(spans)} span(s), {len(traces)} trace(s)")
    if meta.get("plan"):
        print(f"  plan: workflow {meta['plan'].get('workflow')!r} "
              f"critical_path {meta['plan'].get('critical_path')}")
    print(f"  {'kind':10s} {'n':>5s} {'mean':>9s} {'max':>9s}")
    for kind in sorted(by_kind):
        ds = [d for d in by_kind[kind] if math.isfinite(d)]
        mean = sum(ds) / len(ds) if ds else float("nan")
        mx = max(ds) if ds else float("nan")
        print(f"  {kind:10s} {len(by_kind[kind]):5d} "
              f"{_fmt_s(mean):>9s} {_fmt_s(mx):>9s}")
    if args.tree:
        _print_trees(spans, limit=args.tree)
    return 0


def _print_trees(spans: list[Span], limit: int) -> None:
    children: dict[str | None, list[Span]] = defaultdict(list)
    ids = {s.id for s in spans}
    for s in spans:
        parent = s.parent if s.parent in ids else None
        children[parent].append(s)
    roots = sorted(children[None], key=lambda s: s.seq)[:limit]

    def walk(s: Span, depth: int) -> None:
        print(f"  {'  ' * depth}{s.kind}:{s.name} "
              f"[{_fmt_s(s.duration)}]"
              + (f" {s.attrs}" if s.attrs else ""))
        for c in sorted(children[s.id], key=lambda c: c.seq):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)


def _cmd_attribute(args) -> int:
    spans, meta = _load(args.spans)
    plan_doc = meta.get("plan")
    if args.plan:
        with open(args.plan, "r", encoding="utf-8") as fh:
            plan_doc = json.load(fh)
    if not plan_doc:
        raise SystemExit("error: no plan attribution document — the span "
                         "file has no embedded plan; pass --plan FILE")
    report = attribute(spans, plan_doc)
    if args.format == "json":
        print(json.dumps(report, indent=2))
        return 0

    def mean(agg: dict) -> str:
        return _fmt_s(agg["mean"]) if agg.get("n") else "-"

    print(f"workflow {report['workflow']!r}: {report['requests']} "
          f"request(s), critical path {report['critical_path']:.3f}s")
    lat, cpd = report["latency"], report["cp_drift"]
    print(f"  latency   mean {mean(lat)}  max "
          f"{_fmt_s(lat['max']) if lat.get('n') else '-'}")
    print(f"  cp drift  mean {mean(cpd)}  "
          f"(actual latency minus planned critical path)")
    print(f"  {'function':24s} {'start drift':>12s} {'finish drift':>12s} "
          f"{'wait':>9s} {'cold%':>6s} {'prewarm lead':>13s}")
    for row in report["functions"]:
        cold = row.get("cold_rate")
        print(f"  {row['function']:24s} "
              f"{mean(row['start_drift']):>12s} "
              f"{mean(row['finish_drift']):>12s} "
              f"{mean(row['acquire_wait']):>9s} "
              f"{(f'{cold * 100:.0f}%' if cold is not None else '-'):>6s} "
              f"{mean(row['prewarm_lead']):>13s}")
    ev = report.get("eviction_lag")
    if ev and ev["n"]:
        print(f"  eviction lag: n={ev['n']} mean {_fmt_s(ev['mean'])} "
              f"max {_fmt_s(ev['max'])} (evict after last read)")
    return 0


def _cmd_perfetto(args) -> int:
    spans, _ = _load(args.spans)
    doc = to_chrome_trace(spans)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
        fh.write("\n")
    print(f"wrote {len(doc['traceEvents'])} trace event(s) to {args.out} "
          f"(open in ui.perfetto.dev or chrome://tracing)")
    return 0


def _cmd_diff(args) -> int:
    docs = []
    for path in (args.old, args.new):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                docs.append(json.load(fh))
        except (OSError, ValueError) as exc:
            raise SystemExit(f"error: cannot read bench doc {path!r}: {exc}")
    old, new = docs
    rows, failures = compare_docs(old, new,
                                  default_tolerance=args.tolerance)
    if not rows:
        print(f"no comparable metrics ({args.old} has no standardized "
              f"'metrics' list)")
        return 1 if failures else 0
    print(f"{'system':10s} {'metric':28s} {'old':>12s} {'new':>12s} "
          f"{'delta':>8s}  gate")
    for r in rows:
        gate = ("REGRESSED" if r["regressed"]
                else r["direction"] or "report-only")
        print(f"{r['system']:10s} {r['metric']:28s} {r['old']:12.4g} "
              f"{r['new']:12.4g} {r['rel']:+8.1%}  {gate}")
    for f in failures:
        print(f"REGRESSION: {f}", file=sys.stderr)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="DScope span/bench tooling")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="span counts + durations by kind")
    p.add_argument("spans", help="JSONL span file (write_spans_jsonl)")
    p.add_argument("--tree", type=int, default=0, metavar="N",
                   help="also print the first N request trees")
    p.set_defaults(fn=_cmd_summarize)

    p = sub.add_parser("attribute", help="plan-vs-actual drift report")
    p.add_argument("spans")
    p.add_argument("--plan", help="plan attribution JSON (defaults to the "
                   "document embedded in the span file head line)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.set_defaults(fn=_cmd_attribute)

    p = sub.add_parser("perfetto",
                       help="export Chrome trace_event JSON (Perfetto)")
    p.add_argument("spans")
    p.add_argument("-o", "--out", default="trace.json")
    p.set_defaults(fn=_cmd_perfetto)

    p = sub.add_parser("diff",
                       help="compare two dflow-bench/v1 docs; exit 1 on "
                       "gated regression")
    p.add_argument("old", help="committed baseline BENCH_*.json")
    p.add_argument("new", help="fresh BENCH_*.json")
    p.add_argument("--tolerance", type=float, default=0.10,
                   help="default relative tolerance for gated metrics "
                   "without an explicit one (default 0.10)")
    p.set_defaults(fn=_cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
