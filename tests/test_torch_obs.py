"""The port's DScope (``repro_torch.core.obs``) held to the reference's
(``repro.core.obs``).

* The cases of tests/test_obs.py, unchanged but for the package they
  reach: each runs once on either package (``[repro]``, ``[repro_torch]``)
  through the namespace ``C`` (``tests/torch_cases.py``).
* Parity: ``attribute``, ``plan_attribution``, ``to_chrome_trace``, the
  JSONL round trip and ``compare_docs`` give equal results in both
  packages on the same spans, made by a ``Tracer`` on a scripted clock.
"""

import dataclasses
import importlib
import itertools
import json
import math
import random
import threading
import time
import types

import pytest
from strategies import external_inputs, oracle_run
from torch_cases import PACKAGES, bind, both, bound_elsewhere, module_pair

IMPORTS = {
    'core.dscheduler': ['DFlowEngine'],
    'core.dstore': ['DStore'],
    'core.obs': ['MetricsRegistry', 'Span', 'Tracer', 'attribute',
                 'bench_doc', 'bench_metric', 'compare_docs',
                 'plan_attribution', 'read_spans_jsonl', 'to_chrome_trace',
                 'write_spans_jsonl'],
    'core.serve': ['DServe', 'poisson_arrivals'],
    'core.workloads': ['serving_chain'],
    'core': ['make_workflow', 'run_open_loop'],
}

C = types.SimpleNamespace()     # the names of the package under test
package = bind(C, IMPORTS)


def test_the_cases_reach_the_package_under_test(package):
    assert not bound_elsewhere(package, C)


# ----------------------------------------------------------------------
# tests/test_obs.py
# ----------------------------------------------------------------------

N_SEEDS = 200


# ----------------------------------------------------------------------
# MetricsRegistry
# ----------------------------------------------------------------------

def test_registry_basics():
    reg = C.MetricsRegistry()
    reg.counter("hits", node="n0").inc()
    reg.counter("hits", node="n0").inc(2)
    reg.counter("hits", node="n1").inc()
    assert reg.counter("hits", node="n0").value == 3
    assert reg.total("hits") == 4
    assert reg.label_values("hits", "node") == {"n0": 3.0, "n1": 1.0}
    reg.gauge("depth").set(7)
    reg.gauge("depth").add(-2)
    assert reg.gauge("depth").value == 5
    h = reg.histogram("lat")
    for v in (0.1, 0.2, 0.3, 0.4):
        h.observe(v)
    s = h.summary()
    assert s["count"] == 4 and math.isclose(s["sum"], 1.0)
    assert s["min"] == 0.1 and s["max"] == 0.4
    # Exact (interpolated) percentiles while the reservoir is complete.
    assert math.isclose(h.percentile(50.0), 0.25, rel_tol=1e-9)
    assert math.isclose(h.percentile(100.0), 0.4, rel_tol=1e-9)


def test_registry_type_conflict():
    reg = C.MetricsRegistry()
    reg.counter("x", node="n0")
    with pytest.raises(ValueError):
        reg.gauge("x", node="n0")
    with pytest.raises(ValueError):
        reg.histogram("x", node="n1")


def test_registry_concurrent_exact():
    """8 threads x 1000 increments + observations: exact totals, no lost
    updates (the counters sit on every hot path)."""
    reg = C.MetricsRegistry()
    n_threads, per = 8, 1000

    def worker(i):
        c = reg.counter("ops", worker=str(i % 2))
        h = reg.histogram("lat")
        for _ in range(per):
            c.inc()
            h.observe(0.001)

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert reg.total("ops") == n_threads * per
    assert reg.histogram("lat").count == n_threads * per


def test_registry_collector():
    """Pull collectors run at collect() and land in the same dump."""
    reg = C.MetricsRegistry()
    src = {"v": 0}
    reg.register_collector(
        lambda: reg.gauge("pulled", node="n0").set(src["v"]))
    src["v"] = 42
    dump = reg.collect()
    assert dump["gauges"]["pulled{node=n0}"] == 42.0
    src["v"] = 43
    assert reg.collect()["gauges"]["pulled{node=n0}"] == 43.0


# ----------------------------------------------------------------------
# Tracer: span trees from real runs
# ----------------------------------------------------------------------

def _serve_traced(*, sharded=False, n=6, nodes=2):
    wf = C.serving_chain(stages=3, exec_time=0.01, cold_start=0.05,
                         payload=8192)
    spans, reg = C.Tracer(), C.MetricsRegistry()
    srv = C.DServe(wf, n_nodes=nodes, pattern="dataflow", keepalive=5.0,
                   metrics=reg, spans=spans, plan=True, sharded=sharded)
    rep = srv.run(C.poisson_arrivals(20.0, n, seed=3),
                  inputs={"request": b"req"})
    assert rep.failures == 0
    return rep, srv, spans.finished(), reg


def check_well_formed(spans):
    """Every span ended; every parent exists, shares the trace, and
    (for non-evict spans) contains the child's interval."""
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans), "duplicate span ids"
    for s in spans:
        assert not math.isnan(s.end), (s.kind, s.name)
        assert s.end >= s.start or s.kind == "evict"
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.trace == s.trace
            assert p.start - 1e-6 <= s.start and s.end <= p.end + 1e-6, (
                s.kind, s.name, p.kind, p.name)
            assert p.seq < s.seq, "parent must start before child"


def test_serve_span_tree_well_formed():
    rep, srv, spans, _ = _serve_traced()
    check_well_formed(spans)
    reqs = [s for s in spans if s.kind == "request"]
    assert len(reqs) == 6
    # Per-instance isolation: all spans of a trace belong to it, and
    # every instance got its own trace.
    assert len({r.trace for r in reqs}) == 6
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s.trace, []).append(s)
    for trace, ss in by_trace.items():
        for s in ss:
            if s.kind in ("get", "put", "chunk", "chunk_put", "evict"):
                assert s.name.startswith(trace + ":"), (trace, s.name)
    # Gets/acquires nest under invokes, invokes under the request.
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.kind in ("get", "acquire"):
            parent = by_id.get(s.parent)
            if parent is not None and s.kind == "acquire":
                assert parent.kind == "invoke"
        if s.kind == "invoke":
            assert by_id[s.parent].kind == "request"
    # Request durations match the report's latencies (separate clock
    # reads of the same interval, so a few ms of slack).
    lat = sorted(r.duration for r in reqs)
    assert all(math.isclose(a, b, abs_tol=5e-3)
               for a, b in zip(lat, sorted(rep.latencies)))


def test_sharded_hop_spans_nested_under_gets():
    _, srv, spans, reg = _serve_traced(sharded=True, nodes=3)
    check_well_formed(spans)
    by_id = {s.id: s for s in spans}
    hops = [s for s in spans if s.kind == "hop"]
    assert hops, "cross-shard pulls should emit hop spans"
    for h in hops:
        assert by_id[h.parent].kind in ("get", "chunk")
        assert h.attrs["tier"] in ("ipc", "mem", "net")
    # The registry's routed-get count covers at least the hop spans.
    reg.collect()
    routed = sum(v for k, v in
                 reg.label_values("routing_gets", "hops").items()
                 if int(k) >= 1)
    assert routed >= len(hops)


def test_zero_cost_when_detached():
    """No hooks attached: the store carries None hooks and works."""
    store = C.DStore(["node0"])
    assert store._spans is None and store._metrics is None
    store.put("node0", "k", b"v")
    assert bytes(store.get("node0", "k")) == b"v"


# ----------------------------------------------------------------------
# Exporters
# ----------------------------------------------------------------------

def test_jsonl_roundtrip(tmp_path):
    _, srv, spans, _ = _serve_traced(n=3)
    path = tmp_path / "spans.jsonl"
    plan_doc = C.plan_attribution(srv.plan)
    C.write_spans_jsonl(spans, str(path), plan=plan_doc,
                        meta={"bench": "test"})
    back, meta = C.read_spans_jsonl(str(path))
    assert meta["bench"] == "test"
    assert meta["plan"]["workflow"] == plan_doc["workflow"]
    assert len(back) == len(spans)
    for a, b in zip(sorted(spans, key=lambda s: s.seq),
                    sorted(back, key=lambda s: s.seq)):
        assert (a.id, a.parent, a.trace, a.name, a.kind) == \
               (b.id, b.parent, b.trace, b.name, b.kind)
        assert math.isclose(a.start, b.start) and math.isclose(a.end, b.end)
        assert a.attrs == b.attrs


def test_chrome_trace_shape():
    _, _, spans, _ = _serve_traced(n=3)
    doc = C.to_chrome_trace(spans)
    evs = doc["traceEvents"]
    assert evs
    complete = [e for e in evs if e["ph"] == "X"]
    instants = [e for e in evs if e["ph"] == "i"]
    metadata = [e for e in evs if e["ph"] == "M"]
    assert len(complete) + len(instants) + len(metadata) == len(evs)
    assert metadata, "process/thread name metadata expected"
    t0 = min(e["ts"] for e in complete)
    assert t0 >= 0, "timestamps must be t0-relative microseconds"
    for e in complete:
        assert e["dur"] >= 0
        assert e["pid"] and "tid" in e
    # One lane (tid) per function invocation within a request's pid.
    pids = {e["pid"] for e in complete}
    assert len(pids) == 3, "one pid per request trace"


# ----------------------------------------------------------------------
# Plan-vs-actual attribution (hand-built ground truth)
# ----------------------------------------------------------------------

def _mk(id_, parent, trace, name, kind, start, end, seq, **attrs):
    return C.Span(id=id_, parent=parent, trace=trace, name=name, kind=kind,
                  start=start, seq=seq, end=end, end_seq=seq + 100,
                  attrs=attrs)


def test_attribution_hand_built():
    """A request whose stage starts 50 ms later than planned, with a
    30 ms cold acquire, must show exactly those drifts."""
    plan_doc = {
        "workflow": "W", "critical_path": 0.200,
        "functions": {
            "a": {"est": 0.0, "eft": 0.100, "slack": 0.0,
                  "boot_at": -0.150, "cold_start": 0.15},
            "b": {"est": 0.100, "eft": 0.200, "slack": 0.0,
                  "boot_at": 0.050, "cold_start": 0.05},
        },
    }
    t = 1000.0  # arbitrary wall origin
    spans = [
        _mk(1, None, "W#0", "W#0", "request", t, t + 0.300, 1, ok=True),
        _mk(2, 1, "W#0", "a", "invoke", t + 0.000, t + 0.130, 2),
        _mk(3, 2, "W#0", "a", "acquire", t + 0.000, t + 0.030, 3,
            cold=True),
        _mk(4, 1, "W#0", "b", "invoke", t + 0.150, t + 0.300, 4),
        _mk(5, 4, "W#0", "b", "acquire", t + 0.150, t + 0.150, 5,
            cold=False),
        _mk(6, 4, "W#0", "W#0:k", "get", t + 0.150, t + 0.160, 6),
        _mk(7, None, "W#0", "W#0:k", "evict", t + 0.170, t + 0.170, 7),
    ]
    rep = C.attribute(spans, plan_doc)
    assert rep["requests"] == 1
    assert math.isclose(rep["latency"]["mean"], 0.300)
    assert math.isclose(rep["cp_drift"]["mean"], 0.100)
    rows = {r["function"]: r for r in rep["functions"]}
    assert math.isclose(rows["a"]["start_drift"]["mean"], 0.0,
                        abs_tol=1e-12)
    assert math.isclose(rows["a"]["finish_drift"]["mean"], 0.030)
    assert math.isclose(rows["a"]["acquire_wait"]["mean"], 0.030)
    assert rows["a"]["cold_rate"] == 1.0
    # b launched 50 ms late; prewarm fired 100 ms ahead of actual start.
    assert math.isclose(rows["b"]["start_drift"]["mean"], 0.050)
    assert math.isclose(rows["b"]["prewarm_lead"]["mean"], 0.100)
    assert rows["b"]["cold_rate"] == 0.0
    # Evict 10 ms after the key's last Get returned.
    assert rep["eviction_lag"]["n"] == 1
    assert math.isclose(rep["eviction_lag"]["mean"], 0.010)


def test_attribution_real_run_sane():
    rep, srv, spans, _ = _serve_traced()
    out = C.attribute(spans, C.plan_attribution(srv.plan))
    assert out["requests"] == 6
    assert {r["function"] for r in out["functions"]} == \
           set(srv.plan.functions)
    # Latency agg must reproduce the report's mean (separate clock
    # reads of the same interval, so a few ms of slack).
    assert math.isclose(out["latency"]["mean"],
                        sum(rep.latencies) / len(rep.latencies),
                        abs_tol=5e-3)


# ----------------------------------------------------------------------
# Registry dump == ServeReport (one source of truth)
# ----------------------------------------------------------------------

def test_registry_reproduces_serve_report():
    rep, srv, _, reg = _serve_traced()
    reg.collect()
    row = rep.row()
    assert int(reg.total("container_cold_starts")) >= row["cold_starts"]
    # The report counts the run's *delta*; this registry was created for
    # the run, so totals and deltas coincide.
    assert int(reg.total("container_cold_starts")) == row["cold_starts"]
    assert int(reg.total("container_prewarm_boots")) == row["prewarm_boots"]
    assert int(reg.total("container_warm_hits")) == row["warm_hits"]
    assert int(reg.total("container_prewarm_hits")) == row["prewarm_hits"]
    peaks = reg.label_values("dstore_peak_resident_bytes", "node")
    assert int(max(peaks.values())) == row["peak_resident_bytes"]
    assert rep.peak_resident_per_node == {
        n: int(v) for n, v in peaks.items()}
    # Serving aggregates published back into the registry.
    assert int(reg.total("serve_requests_total")) == row["n"]
    assert reg.histogram("serve_latency_seconds",
                         workflow=row["workflow"],
                         pattern=row["pattern"]).count == row["n"]


# ----------------------------------------------------------------------
# Simulator spans (virtual clock)
# ----------------------------------------------------------------------

def test_sim_spans_virtual_clock():
    tr = C.Tracer()
    res = C.run_open_loop("dflow", C.make_workflow("WC"), rate_per_min=20,
                          n_invocations=4, spans=tr)
    spans = tr.finished()
    check_well_formed(spans)
    reqs = sorted((s for s in spans if s.kind == "request"),
                  key=lambda s: s.seq)
    assert len(reqs) == 4
    # Durations are virtual seconds == the collected latencies.
    for s, lat in zip(reqs, res.latencies):
        assert math.isclose(s.duration, lat, rel_tol=1e-9), (s, lat)
    kinds = {s.kind for s in spans}
    assert {"request", "invoke", "acquire"} <= kinds


# ----------------------------------------------------------------------
# dflow-bench/v1 schema + regression gate
# ----------------------------------------------------------------------

def test_bench_metric_validation():
    with pytest.raises(ValueError):
        C.bench_metric("s", "m", 1.0, direction="sideways")
    row = C.bench_metric("s", "m", 1.0, "x", direction="lower",
                         tolerance=0.05)
    assert row["tolerance"] == 0.05
    doc = C.bench_doc("b", {"n": 1}, [row], extra={"k": 2})
    assert doc["schema"] == "dflow-bench/v1"
    assert doc["extra"] == {"k": 2}
    json.dumps(doc)  # must be JSON-serialisable


def test_compare_docs_gating():
    old = C.bench_doc("b", {}, [
        C.bench_metric("s", "p99", 1.0, "s", direction="lower"),
        C.bench_metric("s", "hits", 0.9, "", direction="higher"),
        C.bench_metric("s", "noise", 5.0, "s"),  # report-only
        C.bench_metric("s", "zero", 0, "", direction="lower"),
    ])
    # Within tolerance: pass.
    new = C.bench_doc("b", {}, [
        C.bench_metric("s", "p99", 1.09), C.bench_metric("s", "hits", 0.85),
        C.bench_metric("s", "noise", 50.0), C.bench_metric("s", "zero", 0),
    ])
    rows, failures = C.compare_docs(old, new)
    assert not failures
    assert [r["gated"] for r in rows] == [True, True, False, True]
    # Beyond tolerance in the bad direction: fail (both directions);
    # report-only metrics never gate; zero-valued gates fail on ANY rise.
    worse = C.bench_doc("b", {}, [
        C.bench_metric("s", "p99", 1.11), C.bench_metric("s", "hits", 0.80),
        C.bench_metric("s", "noise", 500.0), C.bench_metric("s", "zero", 1),
    ])
    rows, failures = C.compare_docs(old, worse)
    assert len(failures) == 3
    assert sum(r["regressed"] for r in rows) == 3
    # A committed metric missing from the fresh run is a failure.
    rows, failures = C.compare_docs(old, C.bench_doc("b", {}, []))
    assert len(failures) == 4


# ----------------------------------------------------------------------
# Differential corpus with observability attached
# ----------------------------------------------------------------------

def check_obs_enabled_differential(seed):
    """Full DScope instrumentation must never change engine results:
    byte-exact vs the oracle, and the recorded span tree is well-formed
    with every function's invoke span present exactly once."""
    oracle_wf = C.random_workflow(seed)
    ext = external_inputs(oracle_wf)
    expected = oracle_run(oracle_wf, ext)

    wf = C.random_workflow(seed)
    tr, reg = C.Tracer(), C.MetricsRegistry()
    engine = C.DFlowEngine(n_nodes=2, get_timeout=30.0, spans=tr)
    store = C.DStore(engine.nodes, engine.transport)
    store.attach_metrics(reg)
    rep = engine.start(wf, ext, store=store).wait()
    got = {k: bytes(v) for k, v in rep.outputs.items()}
    assert got == expected, f"seed {seed}"
    # wait() unblocks at the last mark_done; the executing thread's
    # invoke-span end (its finally block) can land a beat later.  Poll
    # until the snapshot is parent-complete.
    spans = tr.finished()
    for _ in range(500):
        ids = {s.id for s in spans}
        if all(s.parent is None or s.parent in ids for s in spans):
            break
        time.sleep(0.002)
        spans = tr.finished()
    check_well_formed(spans)
    invokes = [s.name for s in spans if s.kind == "invoke"
               and not s.attrs.get("duplicate")]
    assert sorted(invokes) == sorted(wf.functions), seed
    assert reg.histogram("dstore_get_seconds").count > 0


@pytest.mark.parametrize("seed", range(0, N_SEEDS, 16))
def test_obs_differential_quick(seed):
    check_obs_enabled_differential(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_obs_differential_200(seed):
    check_obs_enabled_differential(seed)


# ----------------------------------------------------------------------
# Parity with the reference: the same spans give the same results
# ----------------------------------------------------------------------

def _diamond_plan(pkg):
    """``plan_attribution`` of a diamond's DPlan, built by ``pkg``."""
    dag, plan, obs = (importlib.import_module(f"{pkg}.core.{m}")
                      for m in ("dag", "plan", "obs"))
    wf = dag.Workflow("D", [
        dag.FunctionSpec("a", inputs=("x",), outputs=("a.out",),
                         exec_time=0.05, cold_start=0.1),
        dag.FunctionSpec("b", inputs=("a.out",), outputs=("b.out",),
                         exec_time=0.1, cold_start=0.02),
        dag.FunctionSpec("c", inputs=("a.out",), outputs=("c.out",),
                         exec_time=0.02, cold_start=0.2),
        dag.FunctionSpec("d", inputs=("b.out", "c.out"), outputs=("y",),
                         exec_time=0.05, cold_start=0.05)])
    return obs.plan_attribution(plan.build_plan(wf, nodes=["n0", "n1"]))


def _scripted_spans(obs):
    """Spans of a ``Tracer`` on a scripted clock (12.5 ms a read): three
    requests of the diamond, each function an invoke span holding an
    acquire (cold in the first request), a get of each input and a put,
    an annotated span, an evict instant and a prewarm event."""
    ticks = itertools.count()
    tr = obs.Tracer(clock=lambda: next(ticks) * 0.0125)
    inputs = {"a": ("x",), "b": ("a.out",), "c": ("a.out",),
              "d": ("b.out", "c.out")}
    for r in range(3):
        trace = f"D#{r}"
        req = tr.start(trace, "request", parent=None, trace=trace,
                       workflow="D")
        with tr.activate(req):
            for f in ("a", "c", "b", "d"):
                with tr.span(f, "invoke", node=f"n{(r + ord(f)) % 2}"):
                    with tr.span(f, "acquire", node="n0") as acq:
                        tr.annotate(cold=r == 0)
                        acq.attrs["prewarm_at"] = acq.start - 0.1 * r
                    for k in inputs[f]:
                        with tr.span(f"{trace}:{k}", "get", node="n1"):
                            pass
                    with tr.span(f"{trace}:{f}.out", "put", bytes=64 * r):
                        tr.annotate(tier="mem")
            tr.event(f"{trace}:a.out", "evict", parent=None, trace=trace)
        tr.end(req, ok=True)
    return tr.finished()


def _docs(spans):
    return [s.to_doc() for s in spans]


@both
def test_scripted_spans_and_their_reports_equal_the_reference():
    ref, port = module_pair("core.obs")
    spans = {m: _scripted_spans(m) for m in (ref, port)}
    assert _docs(spans[ref]) == _docs(spans[port])
    assert _diamond_plan("repro") == _diamond_plan("repro_torch")
    plan_doc = _diamond_plan("repro")
    want = ref.attribute(spans[ref], plan_doc)
    assert want["requests"] == 3 and len(want["functions"]) == 4
    assert port.attribute(spans[port], plan_doc) == want
    assert port.attribute(spans[ref], plan_doc) == want
    assert port.to_chrome_trace(spans[port]) == \
        ref.to_chrome_trace(spans[ref])


@both
def test_simulator_spans_and_their_reports_equal_the_reference():
    """A virtual-clock run of the simulator records the same spans in
    both packages, and they attribute and export alike."""
    out = {}
    for pkg in PACKAGES:
        core = importlib.import_module(f"{pkg}.core")
        tr = core.Tracer()
        wf = core.make_workflow("Gen")
        res = core.run_open_loop("dflow", wf, rate_per_min=30,
                                 n_invocations=4, spans=tr,
                                 poisson_seed=5)
        spans = tr.finished()
        plan = importlib.import_module(f"{pkg}.core.plan").build_plan(
            wf, nodes=[f"node{i + 1}" for i in range(7)])
        doc = core.plan_attribution(plan)
        out[pkg] = (dataclasses.asdict(res), _docs(spans),
                    core.attribute(spans, doc), core.to_chrome_trace(spans))
    assert out["repro"][1], "the run recorded no spans"
    assert out["repro_torch"] == out["repro"]


@both
def test_jsonl_files_equal_the_reference(tmp_path):
    ref, port = module_pair("core.obs")
    plan_doc = _diamond_plan("repro")
    paths = {}
    for m, name in ((ref, "repro"), (port, "repro_torch")):
        paths[name] = tmp_path / f"{name}.jsonl"
        m.write_spans_jsonl(_scripted_spans(m), str(paths[name]),
                            plan=plan_doc, meta={"bench": "parity"})
    assert paths["repro"].read_bytes() == paths["repro_torch"].read_bytes()
    back = {name: port.read_spans_jsonl(str(p)) for name, p in paths.items()}
    ref_back = ref.read_spans_jsonl(str(paths["repro"]))
    assert _docs(back["repro"][0]) == _docs(ref_back[0])
    assert back["repro"][1] == back["repro_torch"][1] == ref_back[1]


def _random_bench(bench, seed, drift=0.0):
    rng = random.Random(seed)
    rows = []
    for i in range(24):
        direction = rng.choice(["lower", "higher", None])
        value = rng.choice([0, 0.5, 1.0, 3.25, 1e-3]) * (1 + drift * i % 3)
        rows.append(bench.bench_metric(
            f"s{i % 3}", f"m{i}", value, rng.choice(["s", "", "B/s"]),
            direction=direction,
            tolerance=rng.choice([None, 0.05, 0.2])))
    return bench.bench_doc("parity", {"seed": seed}, rows,
                           extra={"drift": drift})


@both
@pytest.mark.parametrize("seed", range(4))
def test_compare_docs_equals_the_reference(seed):
    ref, port = module_pair("core.obs")
    for drift in (0.0, 0.15, -0.3):
        old = _random_bench(ref, seed)
        new = _random_bench(ref, seed + 100, drift)
        assert _random_bench(port, seed) == old
        for tol in (0.10, 0.01):
            want = ref.compare_docs(old, new, default_tolerance=tol)
            assert port.compare_docs(old, new, default_tolerance=tol) == want
    assert want[1], "the regression gate should fire on some drift"


@both
def test_registry_dump_equals_the_reference():
    """The same scripted counters, gauges, histograms (past the reservoir)
    and collectors dump alike."""
    dumps = []
    for m in module_pair("core.obs"):
        rng = random.Random(11)
        reg = m.MetricsRegistry()
        reg.register_collector(
            lambda reg=reg: reg.gauge("pulled", node="n0").set(7))
        for i in range(3000):
            node = f"n{rng.randrange(3)}"
            reg.counter("ops", node=node).inc(rng.choice([1, 2, 0.5]))
            reg.gauge("depth", node=node).add(rng.uniform(-1, 1))
            reg.histogram("lat", node=node).observe(rng.expovariate(10.0))
        h = reg.histogram("lat", node="n0")
        dumps.append((reg.collect(), reg.dump(), len(reg),
                      [h.percentile(q) for q in (0, 50, 99, 100)],
                      reg.label_values("ops", "node"), reg.total("ops")))
    assert dumps[0] == dumps[1]
