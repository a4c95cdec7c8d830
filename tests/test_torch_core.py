"""The port's copy of the DFlow engine (``repro_torch.core``) held to the
reference (``repro.core``).

* The engine cases of tests/test_dag.py, test_dstore.py, test_partition.py,
  test_router.py, test_check.py, test_engine.py and the engine and DStore
  parts of test_stream.py, unchanged but for the package they reach: each
  runs once on either package (``[repro]``, ``[repro_torch]``) through the
  namespace ``C``. Workflows that the reference's helpers build
  (``tests/strategies.py``, the paper's benchmarks) reach the port rebuilt
  as its own ``FunctionSpec``s, field by field; DPlan (not copied) is built
  by the reference and read duck-typed by either router.
* A differential run: both engines, under both invocation patterns and over
  a sharded store, on 60 seeds of ``random_workflow``, against
  ``oracle_run`` and each other.
* The port's one change to the data plane: the content digest of torch
  tensors (``repro_torch/core/check.py``), and ``_sizeof`` kept the
  reference's.
"""

import dataclasses
import importlib
import threading
import time
import types

import numpy as np
import pytest
import torch
from conftest import given, settings, st  # hypothesis or skip-shim
from strategies import external_inputs, oracle_run, random_workflow

import repro.core.dstore as ref_dstore
import repro_torch.core.dstore as port_dstore
from repro.core.check import content_digest as ref_content_digest
from repro.core.plan import build_plan
from repro.core.workloads import BENCHMARKS
from repro_torch.core import dag as port_dag
from repro_torch.core.check import content_digest as port_content_digest

PACKAGES = {"repro": "repro.core", "repro_torch": "repro_torch.core"}
MODULES = ("dag", "check", "stream", "dstore", "partition", "router", "lint",
           "dscheduler")

C = types.SimpleNamespace()     # the names of the package under test


def port_workflow(wf):
    """A reference ``Workflow`` rebuilt as the port's, each ``FunctionSpec``
    field by field."""
    return port_dag.Workflow(
        wf.name,
        [port_dag.FunctionSpec(**{f.name: getattr(spec, f.name)
                                  for f in dataclasses.fields(spec)})
         for spec in wf.functions.values()],
        external_inputs=dict(wf.external_inputs))


def _names(package: str) -> dict:
    names = {}
    for m in MODULES:
        mod = importlib.import_module(f"{package}.{m}")
        names.update((k, v) for k, v in vars(mod).items()
                     if not k.startswith("__"))
    names["workflow"] = (port_workflow if package.startswith("repro_torch")
                         else (lambda wf: wf))
    return names


@pytest.fixture(scope="module", params=list(PACKAGES), autouse=True)
def core(request):
    """Each test of the module runs on either package; a test that names
    both packages itself overrides this with ``@both``."""
    C.__dict__.update(_names(PACKAGES[request.param]))
    yield request.param
    C.__dict__.clear()


both = pytest.mark.parametrize("core", ["both"])


# ----------------------------------------------------------------------
# test_dag.py
# ----------------------------------------------------------------------

def test_parse_size():
    assert C.parse_size("8MB") == 8 << 20
    assert C.parse_size("2KB") == 2048
    assert C.parse_size("1.5GB") == int(1.5 * (1 << 30))
    assert C.parse_size(123) == 123
    with pytest.raises(ValueError):
        C.parse_size("eight megs")


def _diamond():
    return C.Workflow("d", [
        C.FunctionSpec("a", inputs=("x",), outputs=("a1", "a2")),
        C.FunctionSpec("b", inputs=("a1",), outputs=("b1",)),
        C.FunctionSpec("c", inputs=("a2",), outputs=("c1",)),
        C.FunctionSpec("d", inputs=("b1", "c1"), outputs=("y",)),
    ])


def test_dag_derivations():
    wf = _diamond()
    assert wf.entry_points == ("a",)
    assert wf.exit_points == ("d",)
    assert set(wf.successors["a"]) == {"b", "c"}
    assert set(wf.predecessors["d"]) == {"b", "c"}
    assert wf.topo_order.index("a") < wf.topo_order.index("d")
    assert wf.external_inputs == {"x": 1 << 20}


def test_cycle_detection():
    with pytest.raises(ValueError, match="cycle"):
        C.Workflow("bad", [
            C.FunctionSpec("a", inputs=("u",), outputs=("v",)),
            C.FunctionSpec("b", inputs=("v",), outputs=("u",)),
        ])


def test_duplicate_producer_rejected():
    with pytest.raises(ValueError, match="immutable"):
        C.Workflow("bad", [
            C.FunctionSpec("a", outputs=("k",)),
            C.FunctionSpec("b", outputs=("k",)),
        ])


def test_parse_workflow_foreach_and_glob():
    doc = {
        "name": "wc",
        "functions": {
            "split": {"inputs": ["corpus"], "outputs": ["shard.0", "shard.1"],
                      "exec_time": 0.5,
                      "output_sizes": {"shard.0": "8MB", "shard.1": "8MB"}},
            "count": {"foreach": 2, "inputs": ["shard.$i"],
                      "outputs": ["wc.$i"], "exec_time": 1.0},
            "merge": {"inputs": ["wc.*"], "outputs": ["result"]},
        },
    }
    wf = C.parse_workflow(doc)
    assert set(wf.functions) == {"split", "count.0", "count.1", "merge"}
    assert wf.functions["merge"].inputs == ("wc.0", "wc.1")
    assert wf.functions["split"].size_of("shard.0") == 8 << 20
    assert wf.entry_points == ("split",)


def test_parse_workflow_yaml_text():
    text = """
name: tiny
functions:
  a:
    inputs: [x]
    outputs: [y]
    exec_time: 0.1
  b:
    inputs: [y]
    outputs: [z]
"""
    wf = C.parse_workflow(text)
    assert wf.topo_order == ("a", "b")


def test_critical_path():
    wf = _diamond()
    wf2 = C.Workflow("d", [
        C.FunctionSpec("a", inputs=("x",), outputs=("a1", "a2"),
                       exec_time=1.0),
        C.FunctionSpec("b", inputs=("a1",), outputs=("b1",), exec_time=5.0),
        C.FunctionSpec("c", inputs=("a2",), outputs=("c1",), exec_time=1.0),
        C.FunctionSpec("d", inputs=("b1", "c1"), outputs=("y",),
                       exec_time=1.0),
    ])
    assert wf2.critical_path_time() == pytest.approx(7.0)
    assert wf2.total_exec_time() == pytest.approx(8.0)



# ----------------------------------------------------------------------
# test_dstore.py
# ----------------------------------------------------------------------

def test_put_get_local():
    ds = C.DStore(["n0", "n1"])
    ds.put("n0", "k", b"hello")
    assert ds.get("n0", "k") == b"hello"
    assert ds.transport.transfers == 0      # local hit: no network


def test_get_remote_receiver_driven():
    ds = C.DStore(["n0", "n1"])
    ds.put("n0", "k", b"payload")
    assert ds.get("n1", "k") == b"payload"
    assert ds.transport.transfers == 1
    # After the pull the consumer node holds a replica; next get is local.
    assert ds.get("n1", "k") == b"payload"
    assert ds.transport.transfers == 1


def test_auto_block_wake():
    """Get blocks until the producer publishes (paper §3.3.2)."""
    ds = C.DStore(["n0", "n1"])
    got = {}

    def consumer():
        got["v"] = ds.get("n1", "late")
    th = threading.Thread(target=consumer)
    th.start()
    time.sleep(0.05)
    assert "v" not in got                    # still blocked
    ds.put("n0", "late", 42)
    th.join(timeout=5)
    assert got["v"] == 42


def test_get_timeout():
    ds = C.DStore(["n0"])
    with pytest.raises(C.GetTimeout):
        ds.get("n0", "never", timeout=0.05)


def test_replica_least_access_frequency():
    """With replicas on two nodes, concurrent fetches spread across them."""
    ds = C.DStore(["n0", "n1", "n2", "n3"])
    ds.put("n0", "k", b"x" * 1000)
    ds.get("n1", "k")                         # replica now on n0 + n1
    # choose_replica alternates by in-flight count.
    first = ds.directory.choose_replica("k")
    second = ds.directory.choose_replica("k")
    assert {first, second} == {"n0", "n1"}
    ds.directory.release_replica("k", first)
    ds.directory.release_replica("k", second)


def test_immutability_first_writer_wins():
    ds = C.DStore(["n0"])
    ds.put("n0", "k", "first")
    ds.put("n0", "k", "first")                # identical co-write: no-op
    assert ds.get("n0", "k") == "first"


def test_immutability_divergent_cowrite_rejected():
    # A straggler re-execution must produce the same bytes; anything else
    # breaks the determinism premise first-writer-wins rests on — from
    # any node, same or different.
    ds = C.DStore(["n0", "n1"])
    ds.put("n0", "k", "first")
    with pytest.raises(C.ImmutabilityError):
        ds.put("n0", "k", "second")
    with pytest.raises(C.ImmutabilityError):
        ds.put("n1", "k", "second")
    assert ds.get("n1", "k") == "first"


def test_immutability_opaque_cowrite_tolerated():
    # Values with no reliable byte representation can't be compared;
    # the check stays conservative (first-writer-wins, no rejection).
    class Opaque:
        pass

    ds = C.DStore(["n0"])
    ds.put("n0", "k", Opaque())
    ds.put("n0", "k", Opaque())
    ds.get("n0", "k")


def test_fail_node_drops_replicas():
    ds = C.DStore(["n0", "n1"])
    ds.put("n0", "only_here", 1)
    ds.put("n0", "replicated", 2)
    ds.get("n1", "replicated")                # replica on n1
    lost = ds.fail_node("n0")
    assert lost == ["only_here"]              # replicated survives on n1
    assert ds.get("n1", "replicated") == 2


def test_transport_accounting():
    tr = C.Transport()
    ds = C.DStore(["n0", "n1"], tr)
    arr = np.zeros(1024, dtype=np.uint8)
    ds.put("n0", "arr", arr)
    ds.get("n1", "arr")
    assert tr.bytes_moved == 1024



# ----------------------------------------------------------------------
# test_partition.py
# ----------------------------------------------------------------------

def test_chain_collocates():
    """A pure chain should land entirely on one node (zero cut)."""
    fns = []
    prev = "x"
    for i in range(5):
        out = f"k{i}"
        fns.append(C.FunctionSpec(f"f{i}", inputs=(prev,), outputs=(out,),
                                exec_time=0.1,
                                output_sizes={out: 10 << 20}))
        prev = out
    wf = C.Workflow("chain", fns)
    pl = C.partition_workflow(wf, ["n1", "n2", "n3"])
    assert C.cut_bytes(wf, pl) == 0.0


def test_balance_cap_respected():
    """Load on any node should not exceed slack * total / n."""
    fns = [C.FunctionSpec(f"f{i}", inputs=(), outputs=(f"o{i}",),
                        exec_time=1.0) for i in range(12)]
    wf = C.Workflow("wide", fns)
    nodes = ["a", "b", "c"]
    pl = C.partition_workflow(wf, nodes, balance_slack=1.35)
    load = {n: 0.0 for n in nodes}
    for f, n in pl.items():
        load[n] += wf.functions[f].exec_time
    cap = 1.35 * 12 / 3
    assert all(v <= cap + 1e-9 for v in load.values())


def _random_layered_dag(draw):
    n_layers = draw(st.integers(2, 4))
    width = draw(st.integers(1, 4))
    fns = []
    prev_keys: list[str] = []
    for layer in range(n_layers):
        keys = []
        for j in range(width):
            name = f"f{layer}_{j}"
            out = f"k{layer}_{j}"
            if layer == 0:
                ins = ("src",)
            else:
                picks = draw(st.lists(
                    st.sampled_from(prev_keys), min_size=1,
                    max_size=min(3, len(prev_keys)), unique=True))
                ins = tuple(picks)
            sz = draw(st.integers(1, 32)) << 20
            fns.append(C.FunctionSpec(name, inputs=ins, outputs=(out,),
                                    exec_time=draw(st.floats(0.01, 2.0)),
                                    output_sizes={out: sz}))
            keys.append(out)
        prev_keys = keys
    return C.Workflow("rand", fns)


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_partition_properties_random_dags(data):
    wf = _random_layered_dag(data.draw)
    nodes = [f"n{i}" for i in range(data.draw(st.integers(1, 5)))]
    pl = C.partition_workflow(wf, nodes)
    # Every function placed, onto a known node.
    assert set(pl) == set(wf.functions)
    assert set(pl.values()) <= set(nodes)
    # Refinement never does worse than all-on-one-node for a single node.
    if len(nodes) == 1:
        assert C.cut_bytes(wf, pl) == 0.0


def test_benchmarks_cut_below_total():
    nodes = [f"node{i+1}" for i in range(7)]
    for name, gen in BENCHMARKS.items():
        wf = C.workflow(gen())
        pl = C.partition_workflow(wf, nodes)
        total = sum(wf.functions[p].size_of(k)
                    for f in wf.functions.values() for k in f.inputs
                    for p in [wf.producer.get(k)] if p and p != f.name)
        assert C.cut_bytes(wf, pl) < total, name



# ----------------------------------------------------------------------
# test_router.py
# ----------------------------------------------------------------------

NODES = ["n1", "n2", "n3"]


def test_static_routes_follow_placement():
    wf = C.workflow(random_workflow(11))
    placement = C.partition_workflow(wf, NODES)
    routes = C.static_routes(wf, placement, nodes=NODES)
    for f in wf.functions.values():
        for k in f.outputs:
            assert routes[k] == placement[f.name], k
    for k in wf.external_inputs:
        assert routes[k] == C.stage_node(wf, k, placement, NODES[0]), k


def test_routes_from_plan_agree_with_static():
    """DPlan's transfer matrix names the same homes the placement does —
    the plan is just the richer source (it also sizes per-node peaks)."""
    ref = random_workflow(23)
    wf = C.workflow(ref)
    placement = C.partition_workflow(wf, NODES)
    plan = build_plan(ref, placement)      # DPlan is duck-typed in both
    from_plan = C.routes_from_plan(plan)
    static = C.static_routes(wf, placement, nodes=NODES)
    for k, home in from_plan.items():
        assert static[k] == home, k


def test_register_instance_installs_prefixed_routes():
    ref = random_workflow(7)
    wf = C.workflow(ref)
    placement = C.partition_workflow(wf, NODES)
    store = C.ShardedDStore(NODES)
    store.register_instance("fuzz7#0:", wf, placement,
                            plan=build_plan(ref, placement))
    for f in wf.functions.values():
        for k in f.outputs:
            assert store.coordinator.route_of(
                "fuzz7#0:" + k) == placement[f.name]
    # Registration feeds the coordinator only — tables refresh lazily.
    assert all(len(t) == 0 for t in store.tables.values())


def test_presize_from_plan_takes_max_per_node():
    wf = random_workflow(7)
    plan = build_plan(wf, nodes=NODES)
    store = C.ShardedDStore(NODES)
    store.presize_from_plan(plan)
    for node, peak in plan.peak_resident.items():
        assert store.capacity_bytes[node] == int(peak)
    before = dict(store.capacity_bytes)
    store.presize_from_plan(build_plan(random_workflow(3), nodes=NODES))
    assert all(store.capacity_bytes[n] >= before[n] for n in NODES)


def test_stale_table_refresh_after_sync():
    coord = C.Coordinator(NODES)
    table = C.RoutingTable("n2")
    assert table.version < coord.version and table.lookup("k") is None
    assert table.misses == 1

    coord.install({"k": "n1"})
    v1 = coord.version
    coord.sync(table)
    assert table.version == v1 and table.refreshes == 1
    assert table.lookup("k") == "n1" and table.hits == 1

    coord.install({"k2": "n3"})          # table is stale again
    assert table.version < coord.version
    assert table.lookup("k2") is None    # stale: doesn't know k2 yet
    coord.sync(table)
    assert table.version == coord.version and table.refreshes == 2
    assert table.lookup("k2") == "n3"
    assert coord.syncs == 2


def test_chunk_keys_route_via_base_key():

    coord = C.Coordinator(NODES)
    coord.install({"s": "n3"})
    table = C.RoutingTable("n1")
    coord.sync(table)
    assert table.lookup(C.chunk_key("s", 4)) == "n3"
    assert coord.route_of(C.chunk_key("s", 0)) == "n3"


def test_table_miss_resolves_in_one_hop():
    """First Get on a never-synced table: miss → one coordinator sync →
    the *correct* home shard.  That's the legal refresh path and still
    counts as a 1-hop resolution."""
    store = C.ShardedDStore(NODES)
    rec = C.TraceRecorder()
    store.attach_tracer(rec)
    store.put("n1", "k", b"v" * 100)          # dynamic home: n1
    assert store.get("n2", "k", timeout=5.0) == b"v" * 100
    assert store.hop_hist[1] == 1 and store.hop_hist[2] == 0
    assert store.tier_gets[C.TIER_NET] == 1
    assert store.tables["n2"].refreshes == 1
    C.TraceChecker().check_or_raise(rec.events())
    route = [e for e in rec.events() if e.kind == "route"]
    assert len(route) == 1 and route[0].hops == 1 and route[0].src == "n1"


@pytest.mark.notracecheck
def test_misroute_costs_one_extra_hop_and_is_flagged():
    store = C.ShardedDStore(NODES)
    rec = C.TraceRecorder()
    store.attach_tracer(rec)
    store.put("n1", "k", b"payload")          # home: n1
    # Poison the consumer's table: stale route pointing at an ALIVE shard
    # that is not the key's home.
    store.tables["n3"].install({"k": "n2"}, version=999)

    assert store.get("n3", "k", timeout=5.0) == b"payload"

    # The fallback: one wasted shard contact (n2), then the authoritative
    # route — 2 hops total, recorded in the histogram and the trace.
    assert store.hop_hist[2] == 1 and store.hop_hist[1] == 0
    route = [e for e in rec.events() if e.kind == "route"]
    assert len(route) == 1 and route[0].hops == 2
    # And the trace checker flags it as a routing-invariant violation.
    violations = C.TraceChecker().check(rec.events())
    assert any(v.invariant == "routing" for v in violations), violations
    # The fallback also re-synced the table, so the NEXT consumer on n3
    # resolves correctly.
    assert store.tables["n3"].peek("k") == "n1"


def test_evict_instance_cannot_touch_other_shards_keys():
    wf = C.workflow(random_workflow(5))
    placement = C.partition_workflow(wf, NODES)
    store = C.ShardedDStore(NODES)
    for prefix in ("a#0:", "b#0:"):
        store.register_instance(prefix, wf, placement)
        for k, v in external_inputs(wf).items():
            home = C.stage_node(wf, k, placement, NODES[0])
            store.put(home, prefix + k, v)
        for f in wf.functions.values():
            for k in f.outputs:
                store.put(placement[f.name], prefix + k, b"out:" + k.encode())

    b_keys_before = sorted(k for k in store.directory.keys()
                           if k.startswith("b#0:"))
    b_shard_records = {n: sorted(k for k in sh.keys()
                                 if k.startswith("b#0:"))
                       for n, sh in store.shards.items()}
    store.evict_instance("a#0:")

    # a's keys are gone everywhere: shards, stores, coordinator routes.
    assert not any(k.startswith("a#0:") for k in store.directory.keys())
    assert all(not s.has("a#0:o0") for s in store.stores.values())
    assert store.coordinator.route_of("a#0:o0") is None
    # b's records are untouched on EVERY shard, and its bytes still serve.
    assert sorted(k for k in store.directory.keys()
                  if k.startswith("b#0:")) == b_keys_before
    for n, sh in store.shards.items():
        assert sorted(k for k in sh.keys()
                      if k.startswith("b#0:")) == b_shard_records[n], n
    assert store.get("n1", "b#0:o0", timeout=5.0) == b"out:o0"


def test_routes_survive_key_eviction():
    """Immutability makes a stale route harmless: after evict_key the
    route stays installed and a Get cleanly blocks (no stale bytes)."""
    store = C.ShardedDStore(NODES)
    store.put("n1", "k", b"v")
    store.evict_key("k")
    assert store.coordinator.route_of("k") == "n1"
    with pytest.raises(C.GetTimeout):
        store.get("n2", "k", timeout=0.15)


def test_tiered_transport_counters():
    t = C.TieredTransport()
    t.move(100, C.TIER_NET)
    t.move(50, C.TIER_MEM)
    t.move(25, C.TIER_IPC)
    # Base counters keep their single-store (cross-node) meaning.
    assert t.bytes_moved == 100 and t.transfers == 1
    assert t.tier_bytes == {C.TIER_IPC: 25, C.TIER_MEM: 50, C.TIER_NET: 100}
    assert t.tier_transfers == {C.TIER_IPC: 1, C.TIER_MEM: 1, C.TIER_NET: 1}


def test_sharded_store_prices_cross_node_get_as_net():
    t = C.TieredTransport()
    store = C.ShardedDStore(NODES, t)
    store.put("n1", "k", b"x" * 64)
    store.get("n2", "k", timeout=5.0)         # cross-node pull
    store.get("n1", "k", timeout=5.0)         # local hit at the home: ipc
    store.get("n2", "k", timeout=5.0)         # local replica hit: mem
    assert t.tier_bytes[C.TIER_NET] == 64 and t.bytes_moved == 64
    assert store.tier_gets == {C.TIER_IPC: 1, C.TIER_MEM: 1, C.TIER_NET: 1}
    assert store.hop_hist[0] == 2 and store.hop_hist[1] == 1


def test_plain_transport_only_pays_cross_node():
    """With a plain Transport the sharded store charges only net-tier
    pulls, keeping bytes_moved comparable to the single-store baseline."""
    wf = C.workflow(random_workflow(9))
    ext = external_inputs(wf)

    base_eng = C.DFlowEngine(n_nodes=2, get_timeout=30.0)
    base_rep = base_eng.run(C.workflow(random_workflow(9)), ext)

    shard_eng = C.DFlowEngine(n_nodes=2, get_timeout=30.0, sharded=True)
    shard_store = C.ShardedDStore(shard_eng.nodes, shard_eng.transport)
    shard_rep = shard_eng.start(wf, ext, store=shard_store).wait()

    assert {k: bytes(v) for k, v in shard_rep.outputs.items()} == \
           {k: bytes(v) for k, v in base_rep.outputs.items()}
    assert isinstance(shard_eng.transport, type(base_eng.transport))


def test_fail_node_migrates_surviving_records_and_rehomes():
    store = C.ShardedDStore(NODES)
    store.put("n1", "k", b"v" * 32)           # home n1, bytes on n1
    store.get("n2", "k", timeout=5.0)         # replica now also on n2
    store.put("n1", "solo", b"only-here")     # no surviving replica

    lost = store.fail_node("n1")
    assert lost == ["solo"]
    # k survived via its n2 replica: re-homed, still gettable, and the
    # resolution is still 1-hop (failure re-home is not a misroute).
    assert store.coordinator.route_of("k") == "n2"
    assert store.get("n3", "k", timeout=5.0) == b"v" * 32
    assert store.hop_hist[2] == 0
    assert not store.coordinator.is_failed("n1")   # node came back empty



# ----------------------------------------------------------------------
# test_check.py
# ----------------------------------------------------------------------

pytestmark = pytest.mark.notracecheck


def ev(clock, kind, key="", node="", **kw):
    return C.TraceEvent(clock, kind, key, node, **kw)


def violations(events, invariant=None):
    out = C.TraceChecker().check(events)
    if invariant is not None:
        out = [v for v in out if v.invariant == invariant]
    return out


D1 = ref_content_digest(b"one")


D2 = ref_content_digest(b"two")


def test_digest_stable_across_representations():
    assert C.content_digest(b"abc") == C.content_digest(bytearray(b"abc"))
    assert C.content_digest(b"abc") == C.content_digest(memoryview(b"abc"))
    assert C.content_digest(b"abc") != C.content_digest(b"abd")
    assert C.content_digest({"v": 7}) == C.content_digest({"v": 7})
    assert C.content_digest([1, "a"]) == C.content_digest([1, "a"])


def test_digest_opaque_is_none():
    class Opaque:
        pass

    assert C.content_digest(Opaque()) is None
    # A list containing an opaque element is opaque as a whole.
    assert C.content_digest([1, Opaque()]) is None


def test_digest_arrays():
    np = pytest.importorskip("numpy")
    a = np.arange(6, dtype=np.int32)
    assert C.content_digest(a) == C.content_digest(a.copy())
    assert C.content_digest(a) != C.content_digest(a.reshape(2, 3))
    assert C.content_digest(a) != C.content_digest(a.astype(np.int64))


def test_clean_trace_passes():
    trace = [
        ev(1, "put", "k", "n0", digest=D1),
        ev(2, "get_block", "k", "n1"),
        ev(3, "replica", "k", "n1", digest=D1),
        ev(4, "get_return", "k", "n1", digest=D1),
        ev(5, "evict", "k"),
    ]
    assert violations(trace) == []


def test_ordering_get_before_any_publish():
    trace = [
        ev(1, "get_block", "k", "n1"),
        ev(2, "get_return", "k", "n1", digest=D1),
        ev(3, "put", "k", "n0", digest=D1),
    ]
    (v,) = violations(trace)
    assert v.invariant == "ordering"


def test_ordering_stale_read_wrong_bytes():
    trace = [
        ev(1, "put", "k", "n0", digest=D1),
        ev(2, "get_block", "k", "n1"),
        ev(3, "get_return", "k", "n1", digest=D2),
    ]
    (v,) = violations(trace)
    assert v.invariant == "ordering" and "stale" in v.message


def test_immutability_divergent_writes():
    trace = [
        ev(1, "put", "k", "n0", digest=D1),
        ev(2, "put", "k", "n1", digest=D2),
    ]
    (v,) = violations(trace)
    assert v.invariant == "immutability"


def test_immutability_identical_cowrite_clean():
    trace = [
        ev(1, "put", "k", "n0", digest=D1),
        ev(2, "put", "k", "n1", digest=D1),
        ev(3, "put", "k", "n2", digest=None),   # opaque: no judgment
    ]
    assert violations(trace) == []


def test_eviction_with_inflight_reader():
    trace = [
        ev(1, "put", "k", "n0", digest=D1),
        ev(2, "get_block", "k", "n1"),
        ev(3, "evict", "k"),
        ev(4, "get_return", "k", "n1", digest=D1),
    ]
    vs = violations(trace, "eviction")
    assert len(vs) == 1 and "in flight" in vs[0].message


def test_eviction_after_reader_finished_clean():
    trace = [
        ev(1, "put", "k", "n0", digest=D1),
        ev(2, "get_block", "k", "n1"),
        ev(3, "get_return", "k", "n1", digest=D1),
        ev(4, "evict", "k"),
    ]
    assert violations(trace) == []


def test_chunk_sequence_missing_chunk():
    trace = [
        ev(1, "put_chunk", "s", "n0", idx=0, digest=D1),
        ev(2, "stream_close", "s", size=2),
    ]
    (v,) = violations(trace)
    assert v.invariant == "chunk_sequence" and "never published" in v.message


def test_chunk_sequence_chunk_beyond_close():
    trace = [
        ev(1, "put_chunk", "s", "n0", idx=0, digest=D1),
        ev(2, "put_chunk", "s", "n0", idx=1, digest=D1),
        ev(3, "put_chunk", "s", "n0", idx=5, digest=D1),
        ev(4, "stream_close", "s", size=2),
    ]
    vs = violations(trace, "chunk_sequence")
    assert len(vs) == 1 and "[5]" in str(vs[0].message)


def test_chunk_sequence_divergent_totals():
    trace = [
        ev(1, "put_chunk", "s", "n0", idx=0, digest=D1),
        ev(2, "stream_close", "s", size=1),
        ev(3, "stream_close", "s", size=3),
    ]
    vs = violations(trace, "chunk_sequence")
    assert len(vs) == 1 and "divergent totals" in vs[0].message


def test_chunk_sequence_divergent_cowrite():
    trace = [
        ev(1, "put_chunk", "s", "n0", idx=0, digest=D1),
        ev(2, "put_chunk", "s", "n1", idx=0, digest=D2),
        ev(3, "stream_close", "s", size=1),
    ]
    vs = violations(trace, "chunk_sequence")
    assert len(vs) == 1 and "divergent bytes" in vs[0].message


def test_chunk_sequence_leaked_stream():
    trace = [ev(1, "put_chunk", "s", "n0", idx=0, digest=D1)]
    vs = violations(trace, "chunk_sequence")
    assert len(vs) == 1 and "never" in vs[0].message


def test_key_reuse_after_evict_is_clean():
    # Serving restarts instance numbering per run(): after an eviction
    # the same key name legitimately carries different content.
    trace = [
        ev(1, "put", "k", "n0", digest=D1),
        ev(2, "evict", "k"),
        ev(3, "put", "k", "n0", digest=D2),
        ev(4, "get_block", "k", "n1"),
        ev(5, "replica", "k", "n1", digest=D2),
        ev(6, "get_return", "k", "n1", digest=D2),
    ]
    assert violations(trace) == []


def test_stream_reuse_after_evict_judged_per_generation():
    trace = [
        ev(1, "put_chunk", "s", "n0", idx=0, digest=D1),
        ev(2, "stream_close", "s", size=1),
        ev(3, "evict", "s"),
        ev(4, "put_chunk", "s", "n0", idx=0, digest=D2),
        ev(5, "stream_close", "s", size=2),    # generation 2 lies
    ]
    vs = violations(trace, "chunk_sequence")
    assert len(vs) == 1 and "never published" in vs[0].message


def test_aborted_stream_not_judged():
    trace = [
        ev(1, "put_chunk", "s", "n0", idx=0, digest=D1),
        ev(2, "stream_abort", "s", "n0"),
    ]
    assert violations(trace) == []


def traced_store(nodes, stress=None, transport=None):
    ds = C.DStore(nodes, transport)
    rec = C.TraceRecorder(stress=stress)
    ds.attach_tracer(rec)
    return ds, rec


@pytest.mark.notracecheck
def test_live_ordering_violation_backdoor_write():
    # Bytes smuggled into a LocalStore behind Put's back: the Get's
    # fast path returns them although no availability event exists.
    ds, rec = traced_store(["n0"])
    ds.stores["n0"].write("k", b"smuggled")
    assert ds.get("n0", "k") == b"smuggled"
    vs = violations(rec.events(), "ordering")
    assert len(vs) == 1


@pytest.mark.notracecheck
def test_live_eviction_violation_under_inflight_pull():
    # A slow remote pull is mid-flight when the instance is evicted:
    # exactly the reader-starvation hazard eviction safety forbids.
    ds, rec = traced_store(["n0", "n1"],
                           transport=C.Transport(bandwidth=4096.0))
    ds.put("n0", "i1:k", b"x" * 4096)          # ~1 s pull at 4 KB/s
    got = []
    t = threading.Thread(target=lambda: got.append(ds.get("n1", "i1:k")))
    t.start()
    time.sleep(0.3)                            # reader inside transport.move
    ds.evict_instance("i1:")
    t.join()
    vs = violations(rec.events(), "eviction")
    assert len(vs) == 1 and "i1:k" in vs[0].message


@pytest.mark.notracecheck
def test_live_chunk_sequence_violation_lying_close():
    # A producer that closes the stream directory at a total it never
    # published (the engine never does this; the directory trusts it).
    ds, rec = traced_store(["n0"])
    ds.streams.claim("s", "n0")
    ds.put_chunk("n0", "s", 0, b"c0")
    ds.streams.close("s", 3)
    vs = violations(rec.events(), "chunk_sequence")
    assert len(vs) == 1 and "never published" in vs[0].message


@pytest.mark.notracecheck
def test_live_immutability_enforced_and_traceable():
    # The directory rejects a divergent co-write outright; a trace that
    # somehow contains one (recorder events injected here) is convicted
    # by the same digest evidence.

    ds, rec = traced_store(["n0", "n1"])
    ds.put("n0", "k", b"one")
    with pytest.raises(C.ImmutabilityError):
        ds.put("n1", "k", b"two")
    rec.record("put", "k", "n1", digest=C.content_digest(b"two"))
    vs = violations(rec.events(), "immutability")
    assert len(vs) == 1


def _engine_run_traced(seed, stress):

    wf = C.workflow(random_workflow(seed))
    eng = C.DFlowEngine(n_nodes=3)
    ds = C.DStore(eng.nodes, eng.transport)
    rec = C.TraceRecorder(stress=stress)
    ds.attach_tracer(rec)
    rep = eng.start(wf, external_inputs(wf), store=ds).wait()
    assert rep.outputs == oracle_run(wf, external_inputs(wf))
    return rec


@pytest.mark.parametrize("seed", [3, 11, 42])
def test_engine_runs_trace_clean_under_stress(seed):
    rec = _engine_run_traced(seed, stress=seed)
    assert len(rec) > 0
    C.TraceChecker().check_or_raise(rec.events())


def test_recorder_thread_safety_and_clocks():
    rec = C.TraceRecorder()
    threads = [threading.Thread(
        target=lambda i=i: [rec.record("put", f"k{i}.{j}", "n0")
                            for j in range(50)]) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    events = rec.events()
    assert len(events) == 400
    assert sorted(e.clock for e in events) == list(range(1, 401))


def test_stress_mode_is_deterministically_seeded():
    a = C.TraceRecorder(stress=5)
    b = C.TraceRecorder(stress=5)
    for _ in range(20):
        a.record("put", "k", "n")
        b.record("put", "k", "n")
    assert a._stress == b._stress



# ----------------------------------------------------------------------
# test_engine.py
# ----------------------------------------------------------------------

def _sum_workflow():
    """x -> a: +1 ; a -> b: *2 ; a -> c: *3 ; (b,c) -> d: add."""
    return C.Workflow("sum", [
        C.FunctionSpec("a", inputs=("x",), outputs=("a_out",),
                     fn=lambda x: {"a_out": x + 1}, exec_time=0.01),
        C.FunctionSpec("b", inputs=("a_out",), outputs=("b_out",),
                     fn=lambda a_out: {"b_out": a_out * 2}, exec_time=0.01),
        C.FunctionSpec("c", inputs=("a_out",), outputs=("c_out",),
                     fn=lambda a_out: {"c_out": a_out * 3}, exec_time=0.01),
        C.FunctionSpec("d", inputs=("b_out", "c_out"), outputs=("y",),
                     fn=lambda b_out, c_out: {"y": b_out + c_out},
                     exec_time=0.01),
    ])


def test_frontier_policies():
    wf = _sum_workflow()
    assert C.dataflow_initial_frontier(wf) == ["a", "b", "c"]
    assert set(C.dataflow_next_frontier(wf, "a")) == {"d"}
    assert C.dataflow_next_frontier(wf, "d") == []


@pytest.mark.parametrize("pattern", ["dataflow", "controlflow"])
def test_engine_correct_result(pattern):
    eng = C.DFlowEngine(n_nodes=2, pattern=pattern)
    rep = eng.run(_sum_workflow(), {"x": 10})
    assert rep.outputs["y"] == (11 * 2) + (11 * 3)


def test_engine_numpy_payloads():
    def make(n):
        return {"m": np.eye(n)}

    def double(m):
        return {"d": m * 2}

    def trace(d):
        return {"t": float(np.trace(d))}
    wf = C.Workflow("np", [
        C.FunctionSpec("make", inputs=(), outputs=("m",), fn=lambda: make(4)),
        C.FunctionSpec("double", inputs=("m",), outputs=("d",), fn=double),
        C.FunctionSpec("trace", inputs=("d",), outputs=("t",), fn=trace),
    ])
    rep = C.DFlowEngine(n_nodes=3).run(wf)
    assert rep.outputs["t"] == 8.0


def test_dataflow_overlap_beats_controlflow():
    """With a slow producer and a slow network, dataflow invocation lets the
    consumer's *other* work overlap — wall-time should not regress and the
    result must match."""
    def slow_src():
        time.sleep(0.15)
        return {"s": np.ones(8)}

    def other():
        time.sleep(0.15)
        return {"o": np.ones(8) * 2}

    def join(s, o):
        return {"y": float((s + o).sum())}
    wf = C.Workflow("ovl", [
        C.FunctionSpec("src", inputs=(), outputs=("s",), fn=slow_src,
                     exec_time=0.15),
        C.FunctionSpec("oth", inputs=(), outputs=("o",), fn=other,
                     exec_time=0.15),
        C.FunctionSpec("join", inputs=("s", "o"), outputs=("y",), fn=join,
                     exec_time=0.01),
    ])
    rep_df = C.DFlowEngine(n_nodes=2, pattern="dataflow").run(wf)
    rep_cf = C.DFlowEngine(n_nodes=2, pattern="controlflow").run(wf)
    assert rep_df.outputs["y"] == rep_cf.outputs["y"] == 24.0


def test_engine_error_propagates():
    def boom():
        raise ValueError("kaput")
    wf = C.Workflow("err", [
        C.FunctionSpec("boom", inputs=(), outputs=("z",), fn=boom),
    ])
    with pytest.raises(RuntimeError, match="boom"):
        C.DFlowEngine(n_nodes=1).run(wf)


def test_straggler_duplicate_issue():
    """A function that sleeps far beyond its spec time gets duplicated on
    another node; first writer wins and the result stays correct."""
    calls = []

    def sometimes_slow():
        calls.append(threading_ident())
        if len(calls) == 1:
            time.sleep(1.0)      # straggler on first attempt
        return {"v": 7}

    def threading_ident():
        import threading
        return threading.get_ident()

    wf = C.Workflow("strag", [
        C.FunctionSpec("s", inputs=(), outputs=("v",), fn=sometimes_slow,
                     exec_time=0.02),
        C.FunctionSpec("use", inputs=("v",), outputs=("y",),
                     fn=lambda v: {"y": v * 2}, exec_time=0.01),
    ])
    eng = C.DFlowEngine(n_nodes=2, straggler_factor=3.0)
    rep = eng.run(wf)
    assert rep.outputs["y"] == 14
    assert len(calls) >= 2                   # duplicate actually issued


def test_incremental_fault_recovery():
    """Losing a node re-executes only the functions whose outputs died
    (beyond-paper: §3.3.5 would restart everything)."""
    runs = {"a": 0, "b": 0}

    def fa():
        runs["a"] += 1
        return {"ka": 5}

    def fb(ka):
        runs["b"] += 1
        return {"kb": ka + 1}
    wf = C.Workflow("ft", [
        C.FunctionSpec("a", inputs=(), outputs=("ka",), fn=fa, exec_time=0.01),
        C.FunctionSpec("b", inputs=("ka",), outputs=("kb",), fn=fb,
                     exec_time=0.01),
    ])
    eng = C.DFlowEngine(n_nodes=2)
    placement = eng.gs.assign(wf)
    rep = eng.run(wf, inject_failure=placement["a"])
    assert rep.outputs["kb"] == 6
    assert rep.reexecuted            # something was re-run
    assert runs["a"] >= 2 or runs["b"] >= 2



# ----------------------------------------------------------------------
# test_stream.py
# ----------------------------------------------------------------------

def test_put_get_stream_roundtrip():
    ds = C.DStore(["n0", "n1"])
    payload = bytes(range(256)) * 100           # 25600 B
    w = ds.put_stream("n0", "k", chunk_size=4096)
    w.write(payload)
    w.close()
    got = ds.get_stream("n1", "k", timeout=5).read_all()
    assert got == payload
    # chunk-granular receiver-driven pulls: one transfer per chunk
    assert ds.transport.transfers == 7          # ceil(25600 / 4096)
    # the monolithic twin serves plain Gets too
    assert ds.get("n1", "k", timeout=1) == payload


def test_get_stream_overlaps_in_progress_put_stream():
    """A consumer pulls chunk 0 while the producer is still emitting."""
    ds = C.DStore(["n0", "n1"])
    arrivals = []

    def consume():
        for chunk in ds.get_stream("n1", "s", timeout=10):
            arrivals.append((time.monotonic(), chunk))
    th = threading.Thread(target=consume)
    th.start()
    w = ds.put_stream("n0", "s", chunk_size=1024)
    for i in range(6):
        w.write(bytes([i]) * 1024)
        time.sleep(0.03)
    t_close = time.monotonic()
    w.close()
    th.join(10)
    chunks = [c for _, c in arrivals]
    assert chunks == [bytes([i]) * 1024 for i in range(6)]   # in order
    # first chunk observed well before the stream closed
    assert arrivals[0][0] < t_close


def test_stream_duplicate_writers_coalesce():
    """Duplicate producers (straggler re-issue; deterministic functions)
    co-write one stream: per-chunk publication is idempotent, the first
    closer seals it, and readers see exactly one copy of the payload."""
    ds = C.DStore(["n0", "n1"])
    w1 = ds.put_stream("n0", "k", chunk_size=8)
    w2 = ds.put_stream("n1", "k", chunk_size=8)
    payload = b"deadbeef" * 3
    w1.write(payload[:16])                   # original stalls after chunk 1
    w2.write(payload)                        # duplicate emits everything
    w2.close()
    assert ds.get_stream("n0", "k", timeout=2).read_all() == payload
    w1.write(payload[16:])                   # original wakes; no-ops
    w1.close()
    assert ds.get_stream("n1", "k", timeout=2).read_all() == payload


def test_engine_straggler_duplicate_completes_stalled_stream():
    """A streaming producer that stalls mid-emission gets a duplicate
    issued; the duplicate finishes the stream and the consumer completes
    instead of hanging until timeout."""
    calls = []

    def producer():
        calls.append(threading.get_ident())
        first = len(calls) == 1

        def gen():
            for i in range(4):
                if first and i == 1:
                    time.sleep(3.0)          # straggler stalls mid-stream
                yield bytes([i]) * 256
        return {"blob": gen()}

    wf = C.Workflow("strag", [
        C.FunctionSpec("prod", (), ("blob",), fn=producer, exec_time=0.02,
                     stream_outputs=("blob",), chunk_size=256),
        C.FunctionSpec("cons", ("blob",), ("digest",),
                     fn=lambda blob: {"digest": b"".join(blob)},
                     exec_time=0.01, stream_inputs=("blob",)),
    ])
    eng = C.DFlowEngine(n_nodes=2, straggler_factor=3.0, get_timeout=8.0)
    t0 = time.monotonic()
    rep = eng.run(wf)
    assert rep.outputs["digest"] == b"".join(bytes([i]) * 256
                                             for i in range(4))
    assert len(calls) >= 2                   # duplicate actually issued
    assert time.monotonic() - t0 < 3.0       # did not wait out the straggler


def test_get_stream_plain_fallback():
    """get_stream on a monolithically-Put key chunks the value locally."""
    ds = C.DStore(["n0"])
    ds.put("n0", "k", b"x" * 1000)
    assert ds.get_stream("n0", "k", timeout=2).read_all() == b"x" * 1000
    # non-bytes values arrive as a single-item stream
    ds.put("n0", "obj", {"a": 1})
    assert list(ds.get_stream("n0", "obj", timeout=2)) == [{"a": 1}]


def test_stream_node_failure_mid_stream_raises_clean_error():
    ds = C.DStore(["n0", "n1"])
    errors = []
    done = threading.Event()

    def consume():
        try:
            for _ in ds.get_stream("n1", "k", timeout=10):
                pass
        except C.StreamBroken as exc:
            errors.append(exc)
        done.set()
    th = threading.Thread(target=consume)
    th.start()
    w = ds.put_stream("n0", "k", chunk_size=16)
    w.write(b"a" * 48)                           # 3 chunks out, not closed
    time.sleep(0.05)
    ds.fail_node("n0")
    assert done.wait(5)
    assert errors and "before close" in str(errors[0])
    th.join(5)


def test_get_stream_timeout():
    ds = C.DStore(["n0"])
    with pytest.raises(C.GetTimeout):
        next(iter(ds.get_stream("n0", "never", timeout=0.05)))


def test_closed_stream_reclaimable_after_node_failure():
    """Losing a node after its stream closed must let a recovery rerun
    re-claim and re-publish the stream (regression: the stale claim used to
    silently discard the rerun's writes)."""
    ds = C.DStore(["n0", "n1"])
    w = ds.put_stream("n0", "k", chunk_size=8)
    w.write(b"payload!" * 4)
    w.close()
    lost = ds.fail_node("n0")
    assert "k" in lost                          # sole replica was on n0
    w2 = ds.put_stream("n1", "k", chunk_size=8)  # re-claim after eviction
    w2.write(b"payload!" * 4)
    w2.close()
    assert ds.get_stream("n1", "k", timeout=2).read_all() == b"payload!" * 4


def test_engine_recovers_stream_outputs_after_node_failure():
    """Incremental recovery re-runs a streaming producer whose node died
    after completion; the workflow still finishes with correct bytes."""
    runs = {"n": 0}

    def producer():
        runs["n"] += 1
        return {"blob": (bytes([i]) * 256 for i in range(4))}

    def consumer(blob):
        return {"digest": b"".join(blob)}

    wf = C.Workflow("rec", [
        C.FunctionSpec("prod", (), ("blob",), fn=producer, exec_time=0.01,
                     stream_outputs=("blob",), chunk_size=256),
        C.FunctionSpec("cons", ("blob",), ("digest",), fn=consumer,
                     exec_time=0.01, stream_inputs=("blob",)),
    ])
    eng = C.DFlowEngine(n_nodes=2, get_timeout=10.0)
    placement = eng.gs.assign(wf)
    rep = eng.run(wf, inject_failure=placement["prod"])
    assert rep.outputs["digest"] == b"".join(bytes([i]) * 256
                                             for i in range(4))


def test_concurrent_instances_mid_stream_failure_recovers_per_instance():
    """Serve-path fault handling: two namespaced instances stream through
    one shared DStore; the producer node dies *mid-stream*.  Incremental
    recovery re-runs only the lost producers (per instance), re-claims the
    aborted streams, and consumers retry instead of wedging — both
    instances finish with the exact bytes."""
    calls: dict[str, int] = {}
    lock = threading.Lock()

    def mk_producer(inst):
        def producer(seed):
            with lock:
                calls[inst] = calls.get(inst, 0) + 1

            def gen():
                for i in range(6):
                    time.sleep(0.02)          # still emitting when node dies
                    yield bytes(seed) * 128
            return {"blob": gen()}
        return producer

    def consumer(blob):
        return {"digest": b"".join(blob)}

    eng = C.DFlowEngine(n_nodes=2, get_timeout=10.0)
    store = C.DStore(eng.nodes, eng.transport)
    runs = []
    for i in range(2):
        wf = C.Workflow("mid", [
            C.FunctionSpec("prod", ("seed",), ("blob",),
                         fn=mk_producer(f"prod#{i}"), exec_time=0.12,
                         stream_outputs=("blob",), chunk_size=128),
            C.FunctionSpec("cons", ("blob",), ("digest",), fn=consumer,
                         exec_time=0.01, stream_inputs=("blob",)),
        ])
        runs.append(eng.start(wf, {"seed": b"%d" % i}, store=store,
                              instance=f"mid#{i}"))
    time.sleep(0.06)                          # both producers mid-emission
    prod_node = runs[0].placement["prod"]
    lost = store.fail_node(prod_node)
    for run in runs:
        run.recover(lost)
    for i, run in enumerate(runs):
        rep = run.wait()
        assert rep.outputs["digest"] == (b"%d" % i) * 6 * 128, i
    # each lost producer re-ran at least once; nothing ran wild
    assert all(1 <= calls[f"prod#{i}"] <= 3 for i in range(2)), calls


def _streaming_workflow(n_chunks=6, chunk=4096):
    def producer():
        def gen():
            for i in range(n_chunks):
                time.sleep(0.01)
                yield bytes([i]) * chunk
        return {"blob": gen()}

    def consumer(blob):
        return {"digest": b"".join(blob)}

    return C.Workflow("stream-wf", [
        C.FunctionSpec("prod", (), ("blob",), fn=producer, exec_time=0.06,
                     stream_outputs=("blob",), chunk_size=chunk,
                     output_sizes={"blob": n_chunks * chunk}),
        C.FunctionSpec("cons", ("blob",), ("digest",), fn=consumer,
                     exec_time=0.01, stream_inputs=("blob",)),
    ])


@pytest.mark.parametrize("pattern", ["dataflow", "controlflow"])
def test_engine_streaming_patterns_byte_identical(pattern):
    rep = C.DFlowEngine(n_nodes=2, pattern=pattern).run(_streaming_workflow())
    expected = b"".join(bytes([i]) * 4096 for i in range(6))
    assert rep.outputs["digest"] == expected


def test_engine_streaming_generator_error_propagates():
    def bad_producer():
        def gen():
            yield b"ok" * 100
            raise ValueError("mid-stream kaput")
        return {"blob": gen()}

    wf = C.Workflow("bad", [
        C.FunctionSpec("prod", (), ("blob",), fn=bad_producer,
                     stream_outputs=("blob",), chunk_size=64),
        C.FunctionSpec("cons", ("blob",), ("d",),
                     fn=lambda blob: {"d": b"".join(blob)},
                     stream_inputs=("blob",)),
    ])
    with pytest.raises(RuntimeError):
        C.DFlowEngine(n_nodes=2, get_timeout=5.0).run(wf)


def test_functionspec_stream_validation():
    with pytest.raises(ValueError, match="stream_inputs"):
        C.FunctionSpec("f", inputs=("a",), stream_inputs=("b",))
    with pytest.raises(ValueError, match="stream_outputs"):
        C.FunctionSpec("f", outputs=("x",), stream_outputs=("y",))


def test_parser_accepts_stream_fields():
    wf = C.parse_workflow({
        "name": "p",
        "functions": {
            "a": {"inputs": ["src"], "outputs": ["mid"],
                  "stream_outputs": ["mid"], "chunk_size": "64KB"},
            "b": {"inputs": ["mid"], "outputs": ["out"],
                  "stream_inputs": ["mid"]},
        },
    })
    assert wf.functions["a"].stream_outputs == ("mid",)
    assert wf.functions["a"].chunk_size == 64 * 1024
    assert wf.functions["b"].stream_inputs == ("mid",)


def test_real_engine_streaming_beats_monolithic_wall_time():
    """Acceptance: real-engine wall time improves with streaming when the
    producer emits incrementally and the consumer processes per chunk."""
    chunk, n = 64 * 1024, 10
    gap = 0.02

    def producer_stream():
        def gen():
            for i in range(n):
                time.sleep(gap)
                yield bytes([i]) * chunk
        return {"blob": gen()}

    def producer_mono():
        parts = []
        for i in range(n):
            time.sleep(gap)
            parts.append(bytes([i]) * chunk)
        return {"blob": b"".join(parts)}

    def consumer_stream(blob):
        total = 0
        for c in blob:
            time.sleep(gap / 2)
            total += len(c)
        return {"out": total}

    def consumer_mono(blob):
        time.sleep(gap / 2 * n)
        return {"out": len(blob)}

    def wall(prod, cons, streaming):
        extra = (dict(stream_outputs=("blob",), chunk_size=chunk)
                 if streaming else {})
        wf = C.Workflow("w", [
            C.FunctionSpec("p", (), ("blob",), fn=prod, exec_time=gap * n,
                         output_sizes={"blob": chunk * n}, **extra),
            C.FunctionSpec("c", ("blob",), ("out",), fn=cons,
                         exec_time=gap / 2 * n,
                         stream_inputs=("blob",) if streaming else ()),
        ])
        eng = C.DFlowEngine(n_nodes=2, transport=C.Transport(bandwidth=50e6))
        rep = eng.run(wf)
        assert rep.outputs["out"] == chunk * n
        return rep.wall_time

    wall(producer_stream, consumer_stream, True)        # warm-up (imports)
    t_stream = wall(producer_stream, consumer_stream, True)
    t_mono = wall(producer_mono, consumer_mono, False)
    assert t_stream < t_mono


def test_sharded_mid_stream_failure_heals_from_producing_shard():
    """Sharded replay of the PR 2 recovery harness: two namespaced
    instances stream through one shared ShardedDStore, the producer node
    dies mid-stream (StreamBroken), and per-instance recovery re-runs only
    the lost producers.  Healing touches the producing shard only — a
    bystander shard's records are byte-for-byte untouched (no
    directory-wide scan) — and every post-failure Get still resolves in
    at most one hop (a failure re-home is not a misroute)."""

    calls: dict[str, int] = {}
    lock = threading.Lock()

    def mk_producer(inst):
        def producer(seed):
            with lock:
                calls[inst] = calls.get(inst, 0) + 1

            def gen():
                for i in range(6):
                    time.sleep(0.02)          # still emitting when node dies
                    yield bytes(seed) * 128
            return {"blob": gen()}
        return producer

    def consumer(blob):
        return {"digest": b"".join(blob)}

    eng = C.DFlowEngine(n_nodes=3, get_timeout=10.0, sharded=True)
    store = C.ShardedDStore(eng.nodes, eng.transport)
    rec = C.TraceRecorder()
    store.attach_tracer(rec)
    runs = []
    for i in range(2):
        wf = C.Workflow("mid", [
            C.FunctionSpec("prod", ("seed",), ("blob",),
                         fn=mk_producer(f"prod#{i}"), exec_time=0.12,
                         stream_outputs=("blob",), chunk_size=128),
            C.FunctionSpec("cons", ("blob",), ("digest",), fn=consumer,
                         exec_time=0.01, stream_inputs=("blob",)),
        ])
        runs.append(eng.start(wf, {"seed": b"%d" % i}, store=store,
                              instance=f"mid#{i}"))
    prod_node = runs[0].placement["prod"]
    used = set(runs[0].placement.values()) | set(runs[1].placement.values())
    bystander = next(n for n in eng.nodes if n not in used)
    store.put(bystander, "sentinel", b"innocent")     # homed on bystander

    time.sleep(0.06)                          # both producers mid-emission
    lost = store.fail_node(prod_node)
    bys_keys = sorted(store.shards[bystander].keys())
    for run in runs:
        run.recover(lost)
    for i, run in enumerate(runs):
        rep = run.wait()
        assert rep.outputs["digest"] == (b"%d" % i) * 6 * 128, i
    assert all(1 <= calls[f"prod#{i}"] <= 3 for i in range(2)), calls

    # Healing never scanned/mutated the bystander shard: same records,
    # same replica locations, bytes still served from it.
    assert sorted(store.shards[bystander].keys()) == bys_keys
    meta = store.shards[bystander].peek("sentinel")
    assert meta is not None and set(meta.locations) == {bystander}
    assert store.get(prod_node, "sentinel", timeout=5.0) == b"innocent"

    # 1-hop invariant held across the failure: no directory bounce, and
    # the full trace (incl. routing events) is checker-clean.
    assert store.hop_hist.get(2, 0) == 0, dict(store.hop_hist)
    C.TraceChecker().check_or_raise(rec.events())


# ----------------------------------------------------------------------
# Both engines at once, and what the port changed
# ----------------------------------------------------------------------

def test_the_namespace_is_the_package_under_test(core):
    for name in ("FunctionSpec", "DStore", "ShardedDStore", "DFlowEngine",
                 "content_digest", "check_workflow", "StreamReader"):
        assert getattr(C, name).__module__.startswith(PACKAGES[core]), name
    spec = C.workflow(random_workflow(4)).functions["f0"]
    assert type(spec) is C.FunctionSpec


@both
@pytest.mark.parametrize("seed", range(60))
def test_both_engines_match_the_oracle_and_each_other(seed, core):
    """``random_workflow(seed)`` on the reference's engine and, rebuilt
    field by field, on the port's: both invocation patterns and a sharded
    store with its trace checked (as ``strategies.sharded_run`` runs it)
    give ``oracle_run``'s bytes."""
    ref_wf = random_workflow(seed)
    want = oracle_run(ref_wf, external_inputs(ref_wf))
    n_nodes = 1 + seed % 3
    got = {}
    for name, package in PACKAGES.items():
        ns = types.SimpleNamespace(**_names(package))
        wf = ns.workflow(ref_wf)
        ext = external_inputs(wf)
        for pattern in ("dataflow", "controlflow"):
            rep = ns.DFlowEngine(n_nodes=n_nodes, pattern=pattern,
                                 get_timeout=30.0).run(wf, ext)
            got[name, pattern] = rep.outputs
        eng = ns.DFlowEngine(n_nodes=n_nodes, get_timeout=30.0, sharded=True)
        store = ns.ShardedDStore(eng.nodes, eng.transport)
        rec = ns.TraceRecorder()
        store.attach_tracer(rec)
        got[name, "sharded"] = eng.start(wf, ext, store=store).wait().outputs
        ns.TraceChecker().check_or_raise(rec.events())
    for run, outputs in got.items():
        assert {k: bytes(v) for k, v in outputs.items()} == want, run


@both
def test_plain_values_digest_as_in_the_reference(core):
    values = [b"abc", "abc", 7, 1.5, None, [1, "a"], {"v": (1, 2)},
              np.arange(6, dtype=np.int32), {"a": np.ones((2, 3))}]
    for v in values:
        assert port_content_digest(v) == ref_content_digest(v), v


@both
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.bool])
def test_cpu_tensors_digest_by_dtype_shape_and_bytes(dtype, core):
    a = torch.arange(6).to(dtype).reshape(2, 3)
    d = port_content_digest(a)
    assert d is not None
    assert d == port_content_digest(a.clone())
    assert d == port_content_digest(a.t().contiguous().t())   # strides
    assert d != port_content_digest(a.reshape(3, 2))
    assert d != port_content_digest(a.reshape(6))
    if dtype is not torch.bool:
        b = a.clone()
        b[1, 2] = 0
        assert d != port_content_digest(b)
    other = torch.float16 if dtype is not torch.float16 else torch.float32
    assert d != port_content_digest(a.to(other))
    # the reference calls a tensor opaque: it has no tobytes
    assert ref_content_digest(a) is None


@both
def test_a_state_of_tensors_digests_leaf_by_leaf(core):
    """A train state (a tuple of dicts of CPU tensors) digests as a whole;
    one changed element of one leaf changes it."""
    state = ({"w": torch.ones(4, 4, dtype=torch.bfloat16)},
             {"m": torch.zeros(4, 4), "step": torch.tensor(3)})
    d = port_content_digest(state)
    assert d is not None and d == port_content_digest(
        tuple({k: v.clone() for k, v in leaf.items()} for leaf in state))
    state[0]["w"][0, 0] = 2
    assert port_content_digest(state) != d


@both
def test_a_tensor_off_the_cpu_is_opaque(core):
    """Not on the CPU (``meta`` stands in for the card here): opaque, so no
    byte is read, and so is any container holding one."""
    t = torch.empty(4, device="meta")
    assert port_content_digest(t) is None
    assert port_content_digest({"a": torch.ones(2), "b": t}) is None
    ds = port_dstore.DStore(["n0"])
    ds.put("n0", "k", t)
    ds.put("n0", "k", torch.empty(4, device="meta"))   # unverifiable: kept
    assert ds.get("n0", "k") is t


@both
def test_a_cpu_tensor_cowritten_with_other_bytes_raises(core):
    ds = port_dstore.DStore(["n0", "n1"])
    a = torch.arange(8, dtype=torch.bfloat16)
    ds.put("n0", "k", a)
    ds.put("n1", "k", a.clone())                  # same bytes: a replica
    b = a.clone()
    b[3] = -1
    for node in ("n0", "n1"):
        with pytest.raises(port_dstore.ImmutabilityError):
            ds.put(node, "k", b)
    with pytest.raises(port_dstore.ImmutabilityError):
        ds.put("n0", "k", a.float())            # other dtype, same values
    assert ds.get("n0", "k") is a and torch.equal(ds.get("n1", "k"), a)
    # the reference cannot tell: a tensor is opaque to its digest
    ref = ref_dstore.DStore(["n0"])
    ref.put("n0", "k", a)
    ref.put("n0", "k", b)


@both
def test_sizeof_is_the_reference_rule(core):
    class Opaque:
        pass

    for v in (np.zeros((3, 5), np.float32), np.arange(7, dtype=np.int8),
              b"abcd", bytearray(9), "text", 3, None, Opaque(),
              {"a": np.zeros(4)}, (np.zeros(2), np.zeros(3))):
        assert port_dstore._sizeof(v) == ref_dstore._sizeof(v), v
    # a bare tensor counts its bytes (metadata only: no data is read), a
    # container of tensors 64, as a container of arrays does
    assert port_dstore._sizeof(torch.zeros(10, dtype=torch.bfloat16)) == 20
    assert port_dstore._sizeof(torch.empty(3, 4, device="meta")) == 48
    assert port_dstore._sizeof({"w": torch.zeros(10)}) == 64
    assert port_dstore._sizeof((torch.zeros(10),)) == 64
