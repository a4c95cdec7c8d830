"""The port's DPlan (``repro_torch.core.plan``) and the paper's workloads
(``repro_torch.core.workloads``) held to the reference's.

* The library cases of tests/test_plan.py, unchanged but for the package
  they reach: each runs once on either package (``[repro]``,
  ``[repro_torch]``) through the namespace ``C``
  (``tests/torch_cases.py``). Its CLI cases are in test_torch_cli.py.
* Parity: ``build_plan`` of every workflow of ``BENCHMARKS`` and of 60
  seeds of ``random_workflow``, placed and unplaced, field by field:
  eviction reads, prewarm schedule, critical path, per-node peaks, the
  whole ``to_doc()``.
"""

import dataclasses
import importlib
import json
import types

import pytest
import strategies
from conftest import given, settings, st                      # noqa: F401
from strategies import external_inputs, oracle_run
from torch_cases import (PACKAGES, bind, both, bound_elsewhere, module_pair,
                         port_workflow)

import repro.core.workloads as ref_workloads

IMPORTS = {
    'core.check': ['PlanConformance', 'TraceEvent', 'TraceRecorder'],
    'core.dag': ['FunctionSpec', 'Workflow'],
    'core.dscheduler': ['DFlowEngine'],
    'core.dstore': ['DStore'],
    'core.partition': ['cut_bytes', 'partition_workflow'],
    'core.plan': ['build_plan'],
    'core.workloads': ['BENCHMARKS', 'serving_chain'],
    'core.serve': ['DServe'],
}

C = types.SimpleNamespace()     # the names of the package under test
package = bind(C, IMPORTS)


def test_the_cases_reach_the_package_under_test(package):
    assert not bound_elsewhere(package, C)


# ----------------------------------------------------------------------
# tests/test_plan.py
# ----------------------------------------------------------------------

N_SEEDS = 200


# ----------------------------------------------------------------------
# Analytical properties over the fuzz corpus
# ----------------------------------------------------------------------

def check_plan_static(seed):
    wf = C.random_workflow(seed)
    nodes = ["node0", "node1"]
    placement = C.partition_workflow(wf, nodes)
    plan = C.build_plan(wf, placement)
    assert not plan.self_check(), plan.self_check()
    # (b) critical path: exactly the Workflow DP, not approximately.
    assert plan.critical_path == wf.critical_path_time()
    # Transfer matrix and cut model agree (shared key_bytes helper).
    assert plan.cross_node_bytes == C.cut_bytes(wf, placement)
    # Slack/prewarm sanity: nonneg slack, critical path nonempty, boot_at
    # is est minus cold_start clamped at zero.
    crit = [f for f in plan.functions.values() if f.critical]
    assert crit, "every DAG has a critical path"
    for fp in plan.functions.values():
        assert fp.slack >= 0.0
        assert fp.eft == fp.est + wf.functions[fp.function].exec_time
        assert fp.boot_at == max(0.0, fp.est - fp.cold_start)
    boots = [b for _, b, _ in plan.prewarm_schedule]
    assert boots == sorted(boots)
    # Liveness: evictable keys are consumed, non-streamed, non-sink, and
    # their read count is the number of distinct consumers.
    for k, kp in plan.keys.items():
        if kp.sink:
            assert not kp.consumers
        if k in plan.eviction_reads:
            assert plan.eviction_reads[k] == len(kp.consumers) > 0
    # The placement-agnostic plan agrees on everything non-placement.
    logical = C.build_plan(wf)
    assert logical.critical_path == plan.critical_path
    assert logical.eviction_reads == plan.eviction_reads


@pytest.mark.parametrize("seed", range(0, N_SEEDS, 8))
def test_plan_static_fuzzed(seed):
    check_plan_static(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_plan_static_200(seed):
    check_plan_static(seed)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**32 - 1))
def test_plan_static_hypothesis(seed):
    check_plan_static(seed)


def test_plan_builtins_clean():
    for name, mk in C.BENCHMARKS.items():
        wf = mk()
        placement = C.partition_workflow(wf, ["n0", "n1", "n2"])
        plan = C.build_plan(wf, placement)
        assert not plan.self_check(), name
        assert plan.critical_path == wf.critical_path_time(), name
        assert plan.cross_node_bytes == C.cut_bytes(wf, placement), name
        json.dumps(plan.to_doc())         # serializable end to end


def test_key_bytes_is_the_single_sizing_authority():
    wf = C.serving_chain(stages=3, payload=4096)
    for f in wf.functions.values():
        for k in f.outputs:
            assert wf.key_bytes(k) == f.size_of(k)
    assert wf.key_bytes("request") == wf.external_inputs["request"]
    # Stream-declared keys contribute their full byte count (chunking
    # changes granularity, not volume): matrix cell == key size.
    plan = C.build_plan(wf)
    for t in plan.transfers:
        assert t.bytes == wf.key_bytes(t.key)
        assert t.chunks * t.chunk_bytes >= t.bytes


# ----------------------------------------------------------------------
# Plan-driven engine runs, cross-validated against the recorded trace
# ----------------------------------------------------------------------

def check_plan_run_conforms(seed, *, stream_prob=0.15):
    oracle_wf = C.random_workflow(seed, stream_prob=stream_prob)
    ext = external_inputs(oracle_wf)
    expected = oracle_run(oracle_wf, ext)

    calls: dict[str, int] = {}
    wf = C.random_workflow(seed, stream_prob=stream_prob, calls=calls)
    engine = C.DFlowEngine(n_nodes=2, pattern="dataflow", get_timeout=30.0)
    placement = engine.gs.assign(wf)
    plan = C.build_plan(wf, placement)
    store = C.DStore(engine.nodes, engine.transport)
    rec = C.TraceRecorder()
    store.attach_tracer(rec)
    rep = engine.start(wf, ext, store=store, placement=placement,
                       plan=plan).wait()
    # (1) eviction never destroyed bytes anyone needed: byte-exact vs
    # the sequential oracle, every function exactly once.
    assert {k: bytes(v) for k, v in rep.outputs.items()} == expected, seed
    assert calls == {f: 1 for f in wf.functions}, (seed, calls)
    # (2) the trace conforms to the plan's static claims.
    events = rec.events()
    C.PlanConformance(plan).check_or_raise(events)
    # (3) refinement, key by key: exactly the planned number of reads was
    # observed, the last read precedes the eviction, and every planned
    # key actually was evicted (earliest-eviction, not never-eviction).
    last_read: dict[str, int] = {}
    reads: dict[str, int] = {}
    evict_clock: dict[str, int] = {}
    for ev in events:
        if ev.kind == "get_return":
            reads[ev.key] = reads.get(ev.key, 0) + 1
            last_read[ev.key] = ev.clock
        elif ev.kind == "evict":
            evict_clock.setdefault(ev.key, ev.clock)
    for k, n in plan.eviction_reads.items():
        assert reads.get(k, 0) == n, (seed, k)
        assert k in evict_clock, (seed, k)
        assert last_read[k] < evict_clock[k], (seed, k)
    # (4) post-run store state: planned keys reclaimed, sinks intact.
    left = set(store.directory.keys())
    assert not (left & set(plan.eviction_reads)), (seed, left)
    for k, kp in plan.keys.items():
        if kp.sink and not kp.streamed:
            assert k in left, (seed, k)


@pytest.mark.parametrize("seed", range(0, N_SEEDS, 8))
def test_plan_run_conforms_fuzzed(seed):
    check_plan_run_conforms(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_plan_run_conforms_200(seed):
    check_plan_run_conforms(seed)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**32 - 1))
def test_plan_run_conforms_hypothesis(seed):
    check_plan_run_conforms(seed)


def test_plan_rejects_straggler_and_failure_modes():
    wf = C.random_workflow(3)
    plan = C.build_plan(wf)
    engine = C.DFlowEngine(n_nodes=2, straggler_factor=50.0)
    with pytest.raises(ValueError, match="plan-driven"):
        engine.start(wf, external_inputs(wf), plan=plan)
    engine2 = C.DFlowEngine(n_nodes=2)
    with pytest.raises(ValueError, match="plan-driven"):
        engine2.start(wf, external_inputs(wf), plan=plan,
                      inject_failure="node0")


# ----------------------------------------------------------------------
# Plan-driven serving: bounded resident bytes + prewarm conformance
# ----------------------------------------------------------------------

def _serve(plan, tracer=None, n=6):
    wf = C.serving_chain(stages=4, exec_time=0.02, cold_start=0.08,
                         payload=16 * 1024)
    srv = C.DServe(wf, n_nodes=2, pattern="dataflow", keepalive=10.0,
                   max_per_node=16, plan=plan, tracer=tracer)
    arrivals = [i * 0.05 for i in range(n)]
    rep = srv.run(arrivals, inputs={"request": b"req"})
    assert rep.failures == 0, [s.error for s in rep.stats if not s.ok]
    return rep, srv


def test_serve_plan_bounds_resident_bytes():
    heur, _ = _serve(plan=False)
    planned, _ = _serve(plan=True)
    assert planned.peak_resident_bytes < heur.peak_resident_bytes, (
        planned.peak_resident_bytes, heur.peak_resident_bytes)
    for s in planned.stats:
        assert s.outputs, "plan-driven instances must still produce sinks"


def test_serve_plan_trace_conforms():
    rec = C.TraceRecorder()
    rep, srv = _serve(plan=True, tracer=rec, n=4)
    C.PlanConformance(srv.plan).check_or_raise(
        rec.events(), instances=[s.instance for s in rep.stats])
    kinds = {e.kind for e in rec.events()}
    # The container lifecycle actually landed in the trace.
    assert kinds & {"prewarm_boot", "warm_hit", "prewarm_hit",
                    "container_release"}, kinds


# ----------------------------------------------------------------------
# Conformance precision: contradicting traces must be flagged
# ----------------------------------------------------------------------

class _PlanStub:
    def __init__(self, reads):
        self.eviction_reads = reads


def _ev(clock, kind, key="", node="", **kw):
    return C.TraceEvent(clock, kind, key, node, **kw)


def test_conformance_flags_read_after_evict():
    trace = [
        _ev(1, "put", "k", "node0"),
        _ev(2, "get_return", "k", "node0"),
        _ev(3, "evict", "k"),
        _ev(4, "get_return", "k", "node1"),     # liveness undercounted
    ]
    out = C.PlanConformance(_PlanStub({"k": 1})).check(trace)
    assert any(v.invariant == "plan_eviction"
               and "after its planned eviction" in v.message for v in out)


def test_conformance_flags_undercounted_reads():
    trace = [
        _ev(1, "put", "k", "node0"),
        _ev(2, "get_return", "k", "node0"),
        _ev(3, "get_return", "k", "node1"),
    ]
    out = C.PlanConformance(_PlanStub({"k": 1})).check(trace)
    assert any(v.invariant == "plan_eviction"
               and "claims exactly 1" in v.message for v in out)


def test_conformance_early_evict_is_legal():
    # evict_instance mops up before every planned read happened (e.g. a
    # failed instance): not a conformance violation by itself.
    trace = [
        _ev(1, "put", "k", "node0"),
        _ev(2, "evict", "k"),
    ]
    assert C.PlanConformance(_PlanStub({"k": 2})).check(trace) == []


def test_conformance_flags_avoidable_cold_boot():
    trace = [
        _ev(1, "prewarm_boot", "Srv/f", "node0"),
        _ev(2, "cold_boot", "Srv/f", "node0"),   # idle container existed
    ]
    out = C.PlanConformance(_PlanStub({})).check(trace)
    assert any(v.invariant == "plan_prewarm" for v in out)


def test_conformance_consumed_prewarm_then_cold_is_legal():
    trace = [
        _ev(1, "prewarm_boot", "Srv/f", "node0"),
        _ev(2, "prewarm_hit", "Srv/f", "node0"),  # boot was consumed
        _ev(3, "cold_boot", "Srv/f", "node0"),    # genuinely unavoidable
        _ev(4, "cold_boot", "Srv/f", "node1"),    # other node: unaffected
    ]
    assert C.PlanConformance(_PlanStub({})).check(trace) == []


def test_conformance_namespaces_instances():
    trace = [
        _ev(1, "put", "Srv#0:k", "node0"),
        _ev(2, "evict", "Srv#0:k"),
        _ev(3, "get_return", "Srv#0:k", "node0"),
    ]
    pc = C.PlanConformance(_PlanStub({"k": 1}))
    assert pc.check(trace) == []                  # raw "" namespace: no hit
    out = pc.check(trace, instances=["Srv#0"])
    assert any(v.invariant == "plan_eviction" for v in out)


# ----------------------------------------------------------------------
# Stream-feasibility diagnostics (DF016 / DF017)
# ----------------------------------------------------------------------

def _consume(**kw):
    return {}


def test_df017_single_chunk_stream():
    wf = C.Workflow("W", [
        C.FunctionSpec(name="p", inputs=("x",), outputs=("s",),
                       stream_outputs=("s",), chunk_size=1 << 18,
                       output_sizes={"s": 100}),
        C.FunctionSpec(name="c", inputs=("s",), outputs=("y",),
                       stream_inputs=("s",)),
    ])
    plan = C.build_plan(wf)
    assert [d.code for d in plan.diagnostics] == ["DF017"]
    assert plan.diagnostics[0].severity == "info"


def test_df016_later_plain_output_blocks_overlap():
    wf = C.Workflow("W", [
        C.FunctionSpec(name="p", inputs=("x",), outputs=("s", "m"),
                       stream_outputs=("s",), chunk_size=256,
                       output_sizes={"s": 4096, "m": 256}),
        C.FunctionSpec(name="c", inputs=("m", "s"), outputs=("y",),
                       stream_inputs=("s",)),
    ])
    plan = C.build_plan(wf)
    codes = [d.code for d in plan.diagnostics]
    assert "DF016" in codes, codes


def test_df016_silent_when_plain_output_precedes_stream():
    wf = C.Workflow("W", [
        C.FunctionSpec(name="p", inputs=("x",), outputs=("m", "s"),
                       stream_outputs=("s",), chunk_size=256,
                       output_sizes={"s": 4096, "m": 256}),
        C.FunctionSpec(name="c", inputs=("m", "s"), outputs=("y",),
                       stream_inputs=("s",)),
    ])
    plan = C.build_plan(wf)
    assert "DF016" not in [d.code for d in plan.diagnostics]


def test_df016_diamond_through_sibling_consumer():
    wf = C.Workflow("W", [
        C.FunctionSpec(name="p", inputs=("x",), outputs=("s",),
                       stream_outputs=("s",), chunk_size=256,
                       output_sizes={"s": 4096}),
        C.FunctionSpec(name="c1", inputs=("s",), outputs=("m",)),
        C.FunctionSpec(name="c2", inputs=("s", "m"), outputs=("y",),
                       stream_inputs=("s",)),
    ])
    plan = C.build_plan(wf)
    diags = [d for d in plan.diagnostics if d.code == "DF016"]
    assert diags and diags[0].function == "c2"


def test_healthy_stream_chain_has_no_diagnostics():
    wf = C.Workflow("W", [
        C.FunctionSpec(name="p", inputs=("x",), outputs=("s",),
                       stream_outputs=("s",), chunk_size=256,
                       output_sizes={"s": 4096}),
        C.FunctionSpec(name="c", inputs=("s",), outputs=("y",),
                       stream_inputs=("s",)),
    ])
    assert C.build_plan(wf).diagnostics == ()


# ----------------------------------------------------------------------
# Parity with the reference: every field of the plan, every workload
# ----------------------------------------------------------------------

def _plan_facts(plan) -> dict:
    """Every field of a ``WorkflowPlan`` and everything derived from it."""
    return {"fields": dataclasses.asdict(plan),
            "eviction_reads": plan.eviction_reads,
            "eviction_order": plan.eviction_order(),
            "prewarm_schedule": plan.prewarm_schedule,
            "critical": sorted(f for f, fp in plan.functions.items()
                               if fp.critical),
            "boot_costs": {f: fp.boot_cost
                           for f, fp in plan.functions.items()},
            "cross_node_bytes": plan.cross_node_bytes,
            "pulls": (plan.predicted_pull_bytes(),
                      plan.predicted_pull_bytes(include_external=False)),
            "self_check": plan.self_check(),
            "doc": plan.to_doc()}


def _spec_facts(wf) -> list:
    return [(wf.name, tuple(wf.topo_order), dict(wf.external_inputs))] + [
        {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
         if f.name != "fn"} | {"bound": spec.fn is not None}
        for spec in wf.functions.values()]


def _plans(wfs: dict, nodes) -> dict:
    """Each package's plan of its own workflow: unplaced, on ``nodes``
    through ``build_plan``'s own partitioning, and under the package's
    ``partition_workflow`` placement."""
    out = {}
    for pkg, wf in wfs.items():
        plan, part = (importlib.import_module(f"{pkg}.core.{m}")
                      for m in ("plan", "partition"))
        out[pkg] = [_plan_facts(plan.build_plan(wf)),
                    _plan_facts(plan.build_plan(wf, nodes=nodes)),
                    _plan_facts(plan.build_plan(
                        wf, part.partition_workflow(wf, nodes)))]
    return out


@both
def test_the_workloads_equal_the_reference():
    ref, port = module_pair("core.workloads")
    assert list(port.BENCHMARKS) == list(ref.BENCHMARKS)
    for name in ref.BENCHMARKS:
        assert _spec_facts(port.make_workflow(name)) == \
            _spec_facts(ref.make_workflow(name)), name
    for kw in (dict(stages=3), dict(stages=5, exec_time=0.01,
                                    cold_start=0.2, payload=1 << 16)):
        assert _spec_facts(port.serving_chain(**kw)) == \
            _spec_facts(ref.serving_chain(**kw))
    assert _spec_facts(port.serving_fanout(workers=4)) == \
        _spec_facts(ref.serving_fanout(workers=4))


@both
@pytest.mark.parametrize("name", sorted(ref_workloads.BENCHMARKS))
@pytest.mark.parametrize("n_nodes", [2, 7])
def test_plan_of_each_benchmark_equals_the_reference(name, n_nodes):
    nodes = [f"node{i + 1}" for i in range(n_nodes)]
    plans = _plans({pkg: importlib.import_module(
        f"{pkg}.core.workloads").make_workflow(name) for pkg in PACKAGES},
        nodes)
    assert plans["repro_torch"] == plans["repro"]


@both
@pytest.mark.parametrize("seed", range(60))
def test_plan_of_random_workflows_equals_the_reference(seed):
    wf = strategies.random_workflow(seed, stream_prob=0.3)
    plans = _plans({"repro": wf, "repro_torch": port_workflow(wf)},
                   ["node0", "node1", "node2"])
    assert plans["repro_torch"] == plans["repro"]
