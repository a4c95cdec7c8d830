"""DScope — unified observability: metrics, span tracing, plan-vs-actual.

DFlow's headline claims are all *measurements* (99%-ile latency, bandwidth
utilization, cold-start latency), and real orchestrators are debugged with
trigger/event-level visibility (Triggerflow) and per-request breakdowns
(the empirical serverless-workflow study).  Before DScope this repo's
telemetry was scattered — :class:`~repro.core.serve.ContainerPool` kept its
own lifecycle counters, :class:`~repro.core.router.RoutingTable` /
``TieredTransport`` their hit/miss/``tier_bytes``/``hop_hist``,
:class:`~repro.core.dstore.LocalStore` its byte peaks — and
``ServeReport`` hand-aggregated a subset.  DScope is the single layer the
threaded engine, DServe, the simulator and the sharded store all report
through:

* :class:`MetricsRegistry` — thread-safe counters / gauges / histograms
  with label sets.  Subsystems register *collectors* (pull-style scrape
  callbacks, zero hot-path cost) via their ``register_metrics`` methods;
  hot-path latency histograms (per-Get, per-chunk) are pushed only when a
  registry is *attached* (``attach_metrics``, mirroring the DCheck
  ``attach_tracer`` zero-cost-when-off pattern).
* :class:`Tracer` / :class:`Span` — per-request span trees:
  request → function invocation → container acquire → per-Get/Put →
  per-chunk stream transfer → cross-shard hop.  Ordering comes from a
  logical clock (optionally shared with DCheck's
  :class:`~repro.core.check.TraceRecorder` so spans and invariant events
  interleave consistently); durations come from an injectable clock —
  wall clock in the threaded engine, ``env.now`` in the simulator.
* Exporters — JSON-lines (:func:`write_spans_jsonl` /
  :func:`read_spans_jsonl`, with the plan attribution doc embedded as a
  meta line so a span file is self-contained) and Chrome ``trace_event``
  JSON (:func:`to_chrome_trace`) that opens directly in Perfetto /
  ``chrome://tracing`` as a per-request flamegraph.
* Plan-vs-actual attribution (:func:`attribute`) — joins spans against
  DPlan's ``est``/``eft``/slack/``boot_at`` to report per-function
  critical-path drift, prewarm lead-time accuracy, and eviction-timing
  lag, turning the static plan into a live drift detector.
* The standardized ``BENCH_*.json`` schema (``dflow-bench/v1``):
  :func:`bench_metric` rows (system, metric, value, units, optional
  regression direction) + :func:`compare_docs`, the engine behind
  ``benchmarks/bench_compare.py``'s PR-over-PR regression gate.

CLI: ``python -m repro_torch.obs`` (summarize / attribute / perfetto / diff).

Copy of ``repro/core/obs.py`` for the PyTorch port, which imports nothing of
``repro``; its code is the reference's, line for line, with no departure
(the CLI line above names the port's CLI, and one comment, on
``DEFAULT_TOLERANCE``, is reworded).
"""

from __future__ import annotations

import json
import math
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "MetricsRegistry", "Span", "Tracer",
    "write_spans_jsonl", "read_spans_jsonl", "to_chrome_trace",
    "plan_attribution", "attribute",
    "BENCH_SCHEMA", "bench_metric", "bench_doc", "compare_docs",
]


# ----------------------------------------------------------------------
# MetricsRegistry: counters / gauges / histograms with label sets
# ----------------------------------------------------------------------

class _Counter:
    """Monotonic counter.  ``set`` exists for collectors that scrape a
    subsystem's own authoritative count into the registry."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _Gauge(_Counter):
    """Point-in-time value; ``add`` for up/down tracking."""

    __slots__ = ()

    def add(self, n: float) -> None:
        self.inc(n)


# Log2 bucket bounds from 1 µs to ~1000 s (histograms estimate tails from
# buckets only when the exact reservoir overflowed).
_BUCKETS = tuple(2.0 ** e for e in range(-20, 11))
_SAMPLE_CAP = 4096


class _Histogram:
    """Thread-safe histogram: count/sum/min/max + log2 buckets, plus an
    exact sample reservoir (first ``_SAMPLE_CAP`` observations) so
    percentiles are exact for typical benchmark-sized runs."""

    __slots__ = ("_lock", "count", "sum", "min", "max", "_buckets",
                 "_samples")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets = [0] * (len(_BUCKETS) + 1)
        self._samples: list[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            lo, hi = 0, len(_BUCKETS)
            while lo < hi:                    # first bucket bound >= v
                mid = (lo + hi) // 2
                if _BUCKETS[mid] < v:
                    lo = mid + 1
                else:
                    hi = mid
            self._buckets[lo] += 1
            if len(self._samples) < _SAMPLE_CAP:
                self._samples.append(v)

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self.count:
                return math.nan
            if len(self._samples) == self.count:
                v = sorted(self._samples)
                pos = (len(v) - 1) * q / 100.0
                lo = int(pos)
                hi = min(lo + 1, len(v) - 1)
                frac = pos - lo
                return v[lo] * (1 - frac) + v[hi] * frac
            # Reservoir overflowed: upper-bound estimate from buckets.
            target = self.count * q / 100.0
            seen = 0
            for i, n in enumerate(self._buckets):
                seen += n
                if seen >= target:
                    return _BUCKETS[min(i, len(_BUCKETS) - 1)]
            return self.max

    def snapshot(self) -> dict:
        with self._lock:
            if not self.count:
                return {"count": 0}
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "mean": self.sum / self.count,
            } | ({} if len(self._samples) != self.count else {})

    def summary(self) -> dict:
        s = self.snapshot()
        if s["count"]:
            s["p50"] = self.percentile(50.0)
            s["p99"] = self.percentile(99.0)
        return s


def _label_key(labels: Mapping[str, Any]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render(name: str, labels: tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Thread-safe metric registry with label sets and pull collectors.

    Direct instruments (``counter`` / ``gauge`` / ``histogram``) get-or-
    create a metric keyed by ``(name, labels)``; a name is bound to one
    instrument type.  ``register_collector(fn)`` adds a scrape callback
    run by :meth:`collect` — subsystems keep their own counters and the
    registry reads them on demand, so an idle registry costs nothing on
    the hot path.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, tuple], Any] = {}
        self._types: dict[str, type] = {}
        self._collectors: list[Callable[[], None]] = []

    def _get(self, cls: type, name: str, labels: Mapping[str, Any]):
        key = (name, _label_key(labels))
        with self._lock:
            bound = self._types.setdefault(name, cls)
            if bound is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{bound.__name__}, not {cls.__name__}")
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls()
            return m

    def counter(self, name: str, **labels: Any) -> _Counter:
        return self._get(_Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> _Gauge:
        return self._get(_Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> _Histogram:
        return self._get(_Histogram, name, labels)

    def register_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    # -- reads -------------------------------------------------------------
    def total(self, name: str) -> float:
        """Sum of a counter/gauge across all label sets (0.0 if absent)."""
        with self._lock:
            items = [(k, m) for k, m in self._metrics.items()
                     if k[0] == name]
        return sum(m.value for _, m in items
                   if isinstance(m, _Counter))

    def label_values(self, name: str, label: str) -> dict[str, float]:
        """``{label value: summed metric value}`` for one label name —
        e.g. ``label_values("dstore_peak_resident_bytes", "node")``."""
        with self._lock:
            items = [(dict(k[1]), m) for k, m in self._metrics.items()
                     if k[0] == name and isinstance(m, _Counter)]
        out: dict[str, float] = {}
        for labels, m in items:
            if label in labels:
                out[labels[label]] = out.get(labels[label], 0.0) + m.value
        return out

    def collect(self) -> dict:
        """Run every collector, then return :meth:`dump`."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()
        return self.dump()

    def dump(self) -> dict:
        """Point-in-time dump: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}`` with ``name{label=value,...}`` keys."""
        with self._lock:
            items = sorted(self._metrics.items())
        out: dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for (name, labels), m in items:
            key = _render(name, labels)
            if isinstance(m, _Histogram):
                out["histograms"][key] = m.summary()
            elif isinstance(m, _Gauge):
                out["gauges"][key] = m.value
            else:
                out["counters"][key] = m.value
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)


# ----------------------------------------------------------------------
# Tracer: per-request span trees
# ----------------------------------------------------------------------

@dataclass
class Span:
    """One timed operation in a request's tree.

    ``seq``/``end_seq`` order spans on the shared logical clock (ties in
    ``start`` are possible under a virtual clock); ``trace`` groups the
    spans of one workflow instance (the ``#``-namespaced instance id)."""

    id: int
    parent: int | None
    trace: str
    name: str
    kind: str         # request | invoke | acquire | get | put | chunk |
    #                   chunk_put | hop | evict
    start: float
    seq: int
    end: float = math.nan
    end_seq: int = 0
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_doc(self) -> dict:
        return {"id": self.id, "parent": self.parent, "trace": self.trace,
                "name": self.name, "kind": self.kind, "start": self.start,
                "end": self.end, "seq": self.seq, "end_seq": self.end_seq,
                "attrs": self.attrs}

    @classmethod
    def from_doc(cls, d: Mapping) -> "Span":
        return cls(id=d["id"], parent=d["parent"], trace=d["trace"],
                   name=d["name"], kind=d["kind"], start=d["start"],
                   seq=d["seq"], end=d["end"], end_seq=d.get("end_seq", 0),
                   attrs=dict(d.get("attrs") or {}))


_USE_CURRENT = object()


class Tracer:
    """Span factory with a thread-local active-span context.

    ``start`` defaults a new span's parent to the calling thread's active
    span, so data-plane spans created deep inside :class:`~repro.core.
    dstore.DStore` automatically nest under the function-invocation span
    the engine activated on that thread.  Cross-thread parenting (the
    stream prefetch pump) captures a parent explicitly and re-activates
    it with :meth:`activate`.

    ``clock`` is injectable: ``time.monotonic`` (default) in the threaded
    engine, ``lambda: env.now`` in the simulator (:meth:`set_clock`).
    ``recorder`` shares DCheck's :class:`~repro.core.check.TraceRecorder`
    logical clock so span ``seq`` values interleave consistently with
    invariant-trace events; without one the tracer counts on its own.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic, *,
                 recorder=None):
        self._clock = clock
        self._recorder = recorder
        self._lock = threading.Lock()
        self._seq = 0
        self._next_id = 0
        self._finished: list[Span] = []
        self._tls = threading.local()

    def set_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock

    def _tick(self) -> int:
        if self._recorder is not None:
            return self._recorder.tick()
        with self._lock:
            self._seq += 1
            return self._seq

    # -- span lifecycle ----------------------------------------------------
    def start(self, name: str, kind: str = "span", *,
              parent: Any = _USE_CURRENT, trace: str | None = None,
              **attrs: Any) -> Span:
        if parent is _USE_CURRENT:
            parent = self.current()
        with self._lock:
            self._next_id += 1
            sid = self._next_id
        if trace is None:
            trace = parent.trace if parent is not None else ""
        return Span(id=sid, parent=parent.id if parent else None,
                    trace=trace, name=name, kind=kind,
                    start=self._clock(), seq=self._tick(), attrs=attrs)

    def end(self, span: Span | None, **attrs: Any) -> None:
        """Close a span (idempotent; attrs merge in)."""
        if span is None or not math.isnan(span.end):
            return
        span.end = self._clock()
        span.end_seq = self._tick()
        if attrs:
            span.attrs.update(attrs)
        with self._lock:
            self._finished.append(span)

    def event(self, name: str, kind: str = "event", *,
              parent: Any = _USE_CURRENT, trace: str | None = None,
              **attrs: Any) -> Span:
        """Zero-duration span (e.g. an eviction instant)."""
        sp = self.start(name, kind, parent=parent, trace=trace, **attrs)
        sp.end = sp.start
        sp.end_seq = sp.seq
        with self._lock:
            self._finished.append(sp)
        return sp

    # -- thread-local context ----------------------------------------------
    def current(self) -> Span | None:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    @contextmanager
    def activate(self, span: Span | None):
        """Make ``span`` the calling thread's active span (no end)."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)
        try:
            yield span
        finally:
            stack.pop()

    @contextmanager
    def span(self, name: str, kind: str = "span", *,
             parent: Any = _USE_CURRENT, trace: str | None = None,
             **attrs: Any):
        """start + activate + end in one context manager."""
        sp = self.start(name, kind, parent=parent, trace=trace, **attrs)
        try:
            with self.activate(sp):
                yield sp
        finally:
            self.end(sp)

    def annotate(self, **attrs: Any) -> None:
        sp = self.current()
        if sp is not None:
            sp.attrs.update(attrs)

    # -- results -----------------------------------------------------------
    def finished(self) -> list[Span]:
        """Closed spans, ordered by logical start ``seq``.  Spans never
        ended (an in-flight request) are not exported."""
        with self._lock:
            return sorted(self._finished, key=lambda s: s.seq)

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._finished)


# ----------------------------------------------------------------------
# Exporters
# ----------------------------------------------------------------------

def write_spans_jsonl(spans: Iterable[Span], path: str, *,
                      plan: Mapping | None = None,
                      meta: Mapping | None = None) -> int:
    """One span per line; the first line is a meta record (schema tag,
    optional plan attribution doc) so the file is self-contained for
    :func:`attribute`.  Returns the span count written."""
    head = {"dscope": "spans/v1", "plan": dict(plan) if plan else None}
    if meta:
        head.update(meta)
    n = 0
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(head) + "\n")
        for sp in spans:
            fh.write(json.dumps(sp.to_doc()) + "\n")
            n += 1
    return n


def read_spans_jsonl(path: str) -> tuple[list[Span], dict]:
    """Inverse of :func:`write_spans_jsonl`: ``(spans, meta)``."""
    spans: list[Span] = []
    meta: dict = {}
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if "dscope" in doc and "id" not in doc:
                meta = doc
            else:
                spans.append(Span.from_doc(doc))
    return spans, meta


def to_chrome_trace(spans: Iterable[Span]) -> dict:
    """Chrome ``trace_event`` JSON (loads in Perfetto / chrome://tracing).

    pid = request (trace id); tid = the request's direct child subtree the
    span belongs to (each function invocation gets its own lane, so
    same-lane complete events nest by time containment into the expected
    request → invoke → get/put → chunk flamegraph).  Zero-duration spans
    (evictions) become instant events.
    """
    spans = list(spans)
    by_id = {s.id: s for s in spans}
    pids: dict[str, int] = {}
    lane_names: dict[tuple[int, int], str] = {}
    t0 = min((s.start for s in spans), default=0.0)

    def pid_of(trace: str) -> int:
        if trace not in pids:
            pids[trace] = len(pids) + 1
        return pids[trace]

    def lane_of(s: Span) -> int:
        # Walk up to the child-of-request ancestor; requests lane 0.
        cur = s
        while cur.parent is not None:
            parent = by_id.get(cur.parent)
            if parent is None or parent.kind == "request":
                return cur.id
            cur = parent
        return 0

    events: list[dict] = []
    for s in spans:
        pid = pid_of(s.trace or s.name)
        tid = lane_of(s)
        lane_names.setdefault((pid, tid), s.name if tid else "request")
        us = (s.start - t0) * 1e6
        dur = max((s.end - s.start) * 1e6, 0.0)
        args = {"kind": s.kind, "seq": s.seq} | s.attrs
        if dur <= 0.0 and s.kind not in ("request", "invoke"):
            events.append({"name": f"{s.kind}:{s.name}", "cat": s.kind,
                           "ph": "i", "s": "t", "ts": us, "pid": pid,
                           "tid": tid, "args": args})
        else:
            events.append({"name": f"{s.kind}:{s.name}", "cat": s.kind,
                           "ph": "X", "ts": us, "dur": max(dur, 0.01),
                           "pid": pid, "tid": tid, "args": args})
    for trace, pid in pids.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": trace}})
    for (pid, tid), name in lane_names.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ----------------------------------------------------------------------
# Plan-vs-actual attribution
# ----------------------------------------------------------------------

def plan_attribution(plan) -> dict:
    """Portable attribution doc from a :class:`~repro.core.plan.
    WorkflowPlan` (duck-typed) — what :func:`write_spans_jsonl` embeds."""
    return {
        "workflow": plan.workflow,
        "critical_path": plan.critical_path,
        "functions": {
            fp.function: {"est": fp.est, "eft": fp.eft, "slack": fp.slack,
                          "boot_at": fp.boot_at,
                          "cold_start": fp.cold_start}
            for fp in plan.functions.values()},
    }


def _strip_ns(name: str, trace: str) -> str:
    prefix = f"{trace}:"
    return name[len(prefix):] if name.startswith(prefix) else name


def attribute(spans: Iterable[Span], plan_doc: Mapping) -> dict:
    """Join per-request spans against a plan attribution doc.

    Per function (aggregated over requests): *start drift* (actual launch
    offset from request start minus the plan's ``est`` — positive = late),
    *finish drift* (vs ``eft``), *acquire wait* (time inside the container
    acquire span), cold/prewarm-hit rates and *prewarm lead* (how far
    ahead of the actual start the plan's ``boot_at`` fired).  Per request:
    latency vs the plan's critical path (*critical-path drift*).  Eviction
    timing: lag between a key's last Get return and its evict event —
    plan-driven eviction should hold this near zero.
    """
    fns: Mapping[str, Mapping] = plan_doc.get("functions", {})
    cp = float(plan_doc.get("critical_path", math.nan))
    by_trace: dict[str, list[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace, []).append(s)

    func_rows: dict[str, list[dict]] = {}
    request_rows: list[dict] = []
    evict_lags: list[float] = []
    for trace, ss in sorted(by_trace.items()):
        req = next((s for s in ss if s.kind == "request"), None)
        if req is None or math.isnan(req.end):
            continue
        t0 = req.start
        children: dict[int, list[Span]] = {}
        for s in ss:
            if s.parent is not None:
                children.setdefault(s.parent, []).append(s)
        # First invoke span per function (a straggler duplicate would add
        # a second; the first is the one the plan's timeline predicts).
        invokes: dict[str, Span] = {}
        for s in sorted(ss, key=lambda s: s.seq):
            if s.kind == "invoke" and s.name not in invokes:
                invokes[s.name] = s
        for fname, inv in invokes.items():
            fp = fns.get(fname)
            if fp is None:
                continue
            acq = next((c for c in children.get(inv.id, ())
                        if c.kind == "acquire"), None)
            actual_start = inv.start - t0
            actual_finish = inv.end - t0
            row = {
                "function": fname,
                "actual_start": actual_start,
                "actual_finish": actual_finish,
                "start_drift": actual_start - fp["est"],
                "finish_drift": actual_finish - fp["eft"],
                "slack": fp["slack"],
                "acquire_wait": (acq.duration if acq is not None
                                 else math.nan),
                "cold": bool(acq.attrs.get("cold")) if acq else None,
                "prewarm_lead": actual_start - fp["boot_at"],
            }
            func_rows.setdefault(fname, []).append(row)
        latency = req.end - t0
        request_rows.append({"trace": trace, "latency": latency,
                             "cp_drift": latency - cp})
        # Eviction lag: evict instant minus last Get return of the key.
        last_get: dict[str, float] = {}
        for s in ss:
            if s.kind in ("get", "chunk"):
                k = _strip_ns(s.name, trace)
                last_get[k] = max(last_get.get(k, -math.inf), s.end)
        for s in ss:
            if s.kind == "evict":
                k = _strip_ns(s.name, trace)
                if k in last_get:
                    evict_lags.append(s.end - last_get[k])

    def _agg(vals: list[float]) -> dict:
        vals = [v for v in vals if not math.isnan(v)]
        if not vals:
            return {"n": 0}
        return {"n": len(vals), "mean": sum(vals) / len(vals),
                "max": max(vals), "min": min(vals)}

    functions = []
    for fname in sorted(func_rows):
        rows = func_rows[fname]
        cold_known = [r["cold"] for r in rows if r["cold"] is not None]
        functions.append({
            "function": fname,
            "requests": len(rows),
            "start_drift": _agg([r["start_drift"] for r in rows]),
            "finish_drift": _agg([r["finish_drift"] for r in rows]),
            "acquire_wait": _agg([r["acquire_wait"] for r in rows]),
            "prewarm_lead": _agg([r["prewarm_lead"] for r in rows]),
            "slack": rows[0]["slack"],
            "cold_rate": (sum(cold_known) / len(cold_known)
                          if cold_known else None),
        })
    lat = sorted(r["latency"] for r in request_rows)
    return {
        "workflow": plan_doc.get("workflow", ""),
        "critical_path": cp,
        "requests": len(request_rows),
        "latency": _agg(lat),
        "cp_drift": _agg([r["cp_drift"] for r in request_rows]),
        "functions": functions,
        "eviction_lag": _agg(evict_lags),
        "per_request": request_rows,
    }


# ----------------------------------------------------------------------
# Standardized BENCH_*.json schema + comparison
# ----------------------------------------------------------------------

BENCH_SCHEMA = "dflow-bench/v1"

# Default regression tolerance: a gated metric may move 10% in its bad
# direction before compare_docs fails (a ">10% p99" gate).
DEFAULT_TOLERANCE = 0.10


def bench_metric(system: str, metric: str, value: float, units: str = "",
                 *, direction: str | None = None,
                 tolerance: float | None = None) -> dict:
    """One standardized metric row.  ``direction`` arms the regression
    gate: ``"lower"`` (lower is better) fails when a fresh value exceeds
    the committed one by more than ``tolerance`` (relative);``"higher"``
    fails on the symmetric drop.  ``None`` = report-only (e.g. noisy
    absolute wall-clock latencies on shared CI runners)."""
    if direction not in (None, "lower", "higher"):
        raise ValueError(f"direction must be lower/higher/None, "
                         f"got {direction!r}")
    row = {"system": system, "metric": metric, "value": value,
           "units": units, "direction": direction}
    if tolerance is not None:
        row["tolerance"] = float(tolerance)
    return row


def bench_doc(bench: str, config: Mapping, metrics: list[dict],
              **sections: Any) -> dict:
    """Assemble a ``dflow-bench/v1`` document: schema tag + config + the
    standardized metric list, with legacy readable sections appended."""
    return {"schema": BENCH_SCHEMA, "bench": bench,
            "config": dict(config), "metrics": list(metrics), **sections}


def compare_docs(old: Mapping, new: Mapping, *,
                 default_tolerance: float = DEFAULT_TOLERANCE
                 ) -> tuple[list[dict], list[str]]:
    """Diff two standardized bench docs; returns ``(rows, failures)``.

    Metrics match on ``(system, metric)``.  Gated metrics (direction set
    in the *old*/committed doc) fail when the new value regresses beyond
    the tolerance; ungated metrics are reported only.  A committed metric
    missing from the fresh doc is a failure (silent coverage loss)."""
    new_by_key = {(m["system"], m["metric"]): m
                  for m in new.get("metrics", ())}
    rows: list[dict] = []
    failures: list[str] = []
    for m in old.get("metrics", ()):
        key = (m["system"], m["metric"])
        fresh = new_by_key.get(key)
        if fresh is None:
            failures.append(f"{key[0]}/{key[1]}: missing from fresh run")
            continue
        ov, nv = float(m["value"]), float(fresh["value"])
        direction = m.get("direction")
        tol = float(m.get("tolerance", default_tolerance))
        delta = nv - ov
        rel = delta / abs(ov) if ov else math.inf if delta else 0.0
        regressed = False
        if direction == "lower":
            regressed = nv > ov * (1 + tol) if ov > 0 else nv > ov
        elif direction == "higher":
            regressed = nv < ov * (1 - tol) if ov > 0 else nv < ov
        rows.append({"system": key[0], "metric": key[1], "old": ov,
                     "new": nv, "delta": delta, "rel": rel,
                     "direction": direction, "gated": direction is not None,
                     "regressed": regressed, "units": m.get("units", "")})
        if regressed:
            failures.append(
                f"{key[0]}/{key[1]}: {ov:g} -> {nv:g} "
                f"({rel:+.1%}, direction={direction}, tol={tol:.0%})")
    return rows, failures
