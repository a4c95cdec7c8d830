"""The port's simulator (``repro_torch.core.sim``, ``simcluster``,
``sim_dataplane``, ``sim_systems``) and experiment drivers
(``repro_torch.core.experiments``) held to the reference's.

* The cases of tests/test_sim_kernel.py and tests/test_sim_systems.py,
  unchanged but for the package they reach: each runs once on either
  package (``[repro]``, ``[repro_torch]``) through the namespace ``C``
  (``tests/torch_cases.py``).
* Parity: ``run_open_loop`` and ``cold_start_latency`` for every system of
  ``SYSTEMS`` on three of the paper's workloads; each ``ExperimentResult``
  equals the reference's exactly.
"""

import dataclasses
import importlib
import types

import pytest
from torch_cases import PACKAGES, bind, both, bound_elsewhere

import repro.core.sim_systems as ref_sim_systems

IMPORTS = {
    'core.sim': ['Env', 'Network', 'Resource', 'all_of'],
    'core': ['SYSTEMS', 'SimConfig', 'cold_start_latency', 'make_system',
             'make_workflow', 'run_closed_loop', 'run_open_loop'],
    'core.simcluster': ['Cluster'],
}

C = types.SimpleNamespace()     # the names of the package under test
package = bind(C, IMPORTS)


def test_the_cases_reach_the_package_under_test(package):
    assert not bound_elsewhere(package, C)


# ----------------------------------------------------------------------
# tests/test_sim_kernel.py
# ----------------------------------------------------------------------

def test_timeout_ordering():
    env = C.Env()
    seen = []

    def p(name, delay):
        yield env.timeout(delay)
        seen.append((name, env.now))
    env.process(p("b", 2.0))
    env.process(p("a", 1.0))
    env.run()
    assert seen == [("a", 1.0), ("b", 2.0)]


def test_process_return_value_and_all_of():
    env = C.Env()

    def inner(v):
        yield env.timeout(v)
        return v * 10

    def outer():
        vals = yield C.all_of(env, [env.process(inner(1)),
                                    env.process(inner(2))])
        return vals
    p = env.process(outer())
    env.run()
    assert p.value == [10, 20]
    assert env.now == 2.0


def test_resource_fifo_and_capacity():
    env = C.Env()
    order = []

    def worker(i):
        yield res.acquire()
        order.append(("start", i, env.now))
        yield env.timeout(1.0)
        res.release()
    res = C.Resource(env, capacity=2)
    for i in range(4):
        env.process(worker(i))
    env.run()
    starts = [t for (_, _, t) in order]
    assert starts == [0.0, 0.0, 1.0, 1.0]


def test_network_single_flow_rate():
    env = C.Env()
    net = C.Network(env, uplink={"a": 100.0, "b": 100.0},
                    downlink={"a": 100.0, "b": 100.0}, latency=0.0)
    done = net.transfer("a", "b", 200.0)
    env.run()
    assert done.triggered
    assert env.now == pytest.approx(2.0)   # 200 B at 100 B/s


def test_network_maxmin_sharing():
    """Two flows into one receiver share its downlink fairly."""
    env = C.Env()
    net = C.Network(env, uplink={"a": 100.0, "b": 100.0, "c": 100.0},
                    downlink={"a": 100.0, "b": 100.0, "c": 100.0}, latency=0.0)
    t = {}

    def run_flow(src, size, key):
        yield net.transfer(src, "c", size)
        t[key] = env.now
    env.process(run_flow("a", 100.0, "a"))
    env.process(run_flow("b", 100.0, "b"))
    env.run()
    # Both at 50 B/s until 2.0 — both finish at 2.0 (fair share).
    assert t["a"] == pytest.approx(2.0)
    assert t["b"] == pytest.approx(2.0)


def test_network_residual_speedup():
    """When one flow finishes, the survivor picks up the freed bandwidth."""
    env = C.Env()
    net = C.Network(env, uplink={"a": 100.0, "b": 100.0, "c": 100.0},
                    downlink={"a": 100.0, "b": 100.0, "c": 100.0}, latency=0.0)
    t = {}

    def run_flow(src, size, key):
        yield net.transfer(src, "c", size)
        t[key] = env.now
    env.process(run_flow("a", 50.0, "a"))    # finishes at 1.0 (50 @ 50 B/s)
    env.process(run_flow("b", 150.0, "b"))   # 50 @ 50 then 100 @ 100 -> 2.0
    env.run()
    assert t["a"] == pytest.approx(1.0)
    assert t["b"] == pytest.approx(2.0)


def test_network_distinct_receivers_full_rate():
    env = C.Env()
    net = C.Network(env,
                    uplink={"a": 100.0, "b": 100.0, "c": 100.0, "d": 100.0},
                    downlink={"a": 100.0, "b": 100.0, "c": 100.0, "d": 100.0},
                    latency=0.0)
    t = {}

    def run_flow(src, dst, key):
        yield net.transfer(src, dst, 100.0)
        t[key] = env.now
    env.process(run_flow("a", "c", "ac"))
    env.process(run_flow("b", "d", "bd"))
    env.run()
    assert t["ac"] == pytest.approx(1.0)     # no shared link => full rate
    assert t["bd"] == pytest.approx(1.0)


def test_network_busy_time_union():
    env = C.Env()
    net = C.Network(env, uplink={"a": 100.0, "b": 100.0},
                    downlink={"a": 100.0, "b": 100.0}, latency=0.0)

    def seq():
        yield net.transfer("a", "b", 100.0)      # busy [0,1]
        yield env.timeout(5.0)                    # idle  (1,6)
        yield net.transfer("a", "b", 200.0)      # busy [6,8]
    env.process(seq())
    env.run()
    assert net.busy_time == pytest.approx(3.0)


# ----------------------------------------------------------------------
# tests/test_sim_systems.py
# ----------------------------------------------------------------------

def test_all_systems_complete_simple_benchmark():
    wf = C.make_workflow("WC")
    for name in C.SYSTEMS:
        r = C.run_open_loop(name, wf, rate_per_min=6, n_invocations=3)
        assert len(r.latencies) == 3, name
        assert r.timeouts == 0, name
        assert r.p99 > 0


def test_dflow_beats_every_baseline_p99():
    """Paper Fig. 9: DFlow has the lowest 99%-ile latency everywhere.

    ``dflow-stream`` and ``dflow-shard`` are our beyond-paper extensions,
    not paper baselines — they are allowed (expected, even) to beat plain
    dflow."""
    for bench in ["WC", "Gen", "Soy"]:
        wf = C.make_workflow(bench)
        p99 = {s: C.run_open_loop(s, wf, rate_per_min=6, n_invocations=5).p99
               for s in C.SYSTEMS}
        for s in C.SYSTEMS:
            if s not in ("dflow", "dflow-stream", "dflow-shard"):
                assert p99["dflow"] <= p99[s] + 1e-6, (bench, s, p99)
                assert p99["dflow-stream"] <= p99[s] + 1e-6, (bench, s, p99)
                assert p99["dflow-shard"] <= p99[s] + 1e-6, (bench, s, p99)


def test_dflow_shard_p99_no_worse_than_dflow():
    """DShard's routed 1-hop + tiered transports must never cost latency
    vs the central-directory DStore (DShard's acceptance criterion)."""
    for bench in ["WC", "Gen", "Soy"]:
        wf = C.make_workflow(bench)
        shard = C.run_open_loop("dflow-shard", wf, rate_per_min=6,
                                n_invocations=5).p99
        plain = C.run_open_loop("dflow", wf, rate_per_min=6,
                                n_invocations=5).p99
        assert shard <= plain + 1e-6, (bench, shard, plain)


def test_only_cflow_cyc_times_out_fig9():
    """Paper Fig. 9 at 50 MB/s, 6/min: the only timeout bar is CFlow-Cyc."""
    wf = C.make_workflow("Cyc")
    assert C.run_open_loop("cflow", wf, rate_per_min=6,
                           n_invocations=5).timeouts > 0
    for s in ("faasflow", "faasflowredis", "knix", "dflow"):
        assert C.run_open_loop(s, wf, rate_per_min=6,
                               n_invocations=5).timeouts == 0, s


def test_dataflow_pattern_ablation_low_rate():
    """§5.5: at low rate FaaSFlow+DStore is within ~15% of DFlow (the gap is
    the invocation pattern only; both share the DStore data plane)."""
    wf = C.make_workflow("Gen")
    df = C.run_open_loop("dflow", wf, rate_per_min=5, n_invocations=5).p99
    fd = C.run_open_loop("faasflow+dstore", wf, rate_per_min=5,
                         n_invocations=5).p99
    assert fd >= df - 1e-9
    assert fd / df < 1.25


def test_dataflow_pattern_ablation_high_rate():
    """§5.5: at high request rates the dataflow pattern sustains load the
    controlflow pattern cannot (FaaSFlow times out, DFlow keeps going)."""
    wf = C.make_workflow("Gen")
    df = C.run_open_loop("dflow", wf, rate_per_min=40, n_invocations=10)
    ff = C.run_open_loop("faasflow", wf, rate_per_min=40, n_invocations=10)
    assert df.p99 < ff.p99
    assert df.timeouts <= ff.timeouts


def test_cold_start_ratios():
    """Paper §5.4: DFlow ≈5.6x better than CFlow, ≈1.1x vs FaaSFlow."""
    ratios_cf, ratios_ff = [], []
    for bench in ["Cyc", "Epi", "Gen", "Soy"]:
        wf = C.make_workflow(bench)
        d = C.cold_start_latency("dflow", wf)
        c = C.cold_start_latency("cflow", wf)
        f = C.cold_start_latency("faasflow", wf)
        assert d > 0
        ratios_cf.append(c / d)
        ratios_ff.append(f / d)
    avg_cf = sum(ratios_cf) / len(ratios_cf)
    avg_ff = sum(ratios_ff) / len(ratios_ff)
    assert 3.0 < avg_cf < 12.0      # paper: 5.6x
    assert 0.9 < avg_ff < 2.0       # paper: 1.1x


def test_colocation_interference_ranking():
    """§5.3: co-run degradation is large for CFlow, small for DFlow."""
    benches = [C.make_workflow(b) for b in ("WC", "FP")]

    def degradation(sysname):
        solo = [C.run_closed_loop(sysname, [wf], n_per_client=3)[0].mean
                for wf in benches]
        co = [r.mean for r in C.run_closed_loop(sysname, benches,
                                                n_per_client=3)]
        return sum(c / s for c, s in zip(co, solo)) / len(solo)
    d_dflow = degradation("dflow")
    d_cflow = degradation("cflow")
    assert d_dflow <= d_cflow + 0.05


def test_deterministic_repeatability():
    wf = C.make_workflow("FP")
    a = C.run_open_loop("dflow", wf, rate_per_min=6, n_invocations=4)
    b = C.run_open_loop("dflow", wf, rate_per_min=6, n_invocations=4)
    assert a.latencies == b.latencies
    assert a.internode_bytes == b.internode_bytes


def test_dflow_bandwidth_spreads_sources():
    """Receiver-driven replica selection should pull from >1 source node."""
    env = C.Env()
    cluster = C.Cluster(env, C.SimConfig())
    wf = C.make_workflow("Gen")
    sys_ = C.make_system("dflow", env, cluster, wf)
    sys_.invoke()
    env.run(until=120.0)
    sources = {e[0] for e in cluster.network.log}
    assert len(sources) >= 2


# ----------------------------------------------------------------------
# Parity with the reference: every system on three of the paper's
# workloads, result for result
# ----------------------------------------------------------------------

def _experiments(pkg, system, workload):
    core = importlib.import_module(f"{pkg}.core")
    wf = core.make_workflow(workload)
    fixed = core.run_open_loop(system, wf, rate_per_min=30,
                               n_invocations=8)
    poisson = core.run_open_loop(system, wf, rate_per_min=30,
                                 n_invocations=8, poisson_seed=1)
    cold = core.cold_start_latency(system, wf)
    return [dataclasses.asdict(fixed), fixed.row(),
            dataclasses.asdict(poisson), poisson.row(), cold]


@both
@pytest.mark.parametrize("system", ref_sim_systems.SYSTEMS)
@pytest.mark.parametrize("workload", ["WC", "Cyc", "Epi"])
def test_experiments_equal_the_reference(system, workload):
    want = _experiments("repro", system, workload)
    assert want[0]["latencies"], "the run completed no invocation"
    assert _experiments("repro_torch", system, workload) == want


@both
@pytest.mark.parametrize("system", ["cflow", "faasflow", "dflow"])
def test_closed_loop_equals_the_reference(system):
    got = {}
    for pkg in PACKAGES:
        core = importlib.import_module(f"{pkg}.core")
        got[pkg] = [dataclasses.asdict(r) for r in core.run_closed_loop(
            system, [core.make_workflow("WC"), core.make_workflow("Cyc")],
            n_per_client=3)]
    assert got["repro_torch"] == got["repro"]


@both
def test_the_systems_equal_the_reference():
    port = importlib.import_module("repro_torch.core.sim_systems")
    assert port.SYSTEMS == ref_sim_systems.SYSTEMS
