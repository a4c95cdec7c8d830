"""The port's DServe (``repro_torch.core.serve``) held to the reference's
(``repro.core.serve``).

* The cases of tests/test_serve.py, unchanged but for the package they
  reach: each runs once on either package (``[repro]``, ``[repro_torch]``)
  through the namespace ``C`` (``tests/torch_cases.py``).
* Parity: ``ContainerPool`` on a scripted timestamp sequence (leases,
  pools and lifecycle metrics), ``poisson_arrivals``, ``trace_arrivals``
  and ``percentile``.
"""

import dataclasses
import random
import threading
import time
import types

import pytest
from torch_cases import bind, both, bound_elsewhere, module_pair

IMPORTS = {
    'core.dag': ['FunctionSpec', 'Workflow'],
    'core.dscheduler': ['DFlowEngine'],
    'core.dstore': ['DStore'],
    'core.serve': ['ContainerPool', 'ContainerService', 'DServe',
                   'poisson_arrivals', 'trace_arrivals'],
    'core.workloads': ['serving_chain', 'serving_fanout'],
}

C = types.SimpleNamespace()     # the names of the package under test
package = bind(C, IMPORTS)


def test_the_cases_reach_the_package_under_test(package):
    assert not bound_elsewhere(package, C)


# ----------------------------------------------------------------------
# tests/test_serve.py
# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# ContainerPool — pure lifecycle model (shared with the simulator)
# ----------------------------------------------------------------------

def test_pool_cold_then_warm():
    p = C.ContainerPool("img", cold_start=0.5, keepalive=10.0)
    lease = p.acquire(now=0.0)
    assert (lease.delay, lease.cold) == (0.5, True) and p.cold_starts == 1
    p.release(lease, now=1.0)
    lease = p.acquire(now=2.0)
    assert (lease.delay, lease.cold) == (0.0, False)
    assert p.warm_hits == 1 and p.cold_starts == 1


def test_pool_prewarm_join():
    """An acquire during a prewarm boot joins it: pays only the residual
    boot time (the §3.2 overlap), counted as a prewarm hit."""
    p = C.ContainerPool("img", cold_start=1.0, keepalive=10.0)
    assert p.prewarm(now=0.0) == 1.0
    assert p.prewarm(now=0.1) == pytest.approx(0.9)   # no second boot
    assert p.prewarm_boots == 1
    lease = p.acquire(now=0.4)
    assert not lease.cold and lease.delay == pytest.approx(0.6)
    assert p.prewarm_hits == 1 and p.cold_starts == 0


def test_pool_keepalive_eviction_and_container_seconds():
    p = C.ContainerPool("img", cold_start=0.5, keepalive=2.0)
    lease = p.acquire(now=0.0)
    p.release(lease, now=1.0)
    assert p.idle_count(1.0) == 1
    assert p.sweep(now=2.9) == 0            # TTL not yet expired
    assert p.sweep(now=3.1) == 1            # idle since 1.0 + 2.0 < 3.1
    assert p.evictions == 1 and p.live() == 0
    # lifetime accounted 0.0 -> 3.0 (eviction instant = idle + keepalive)
    assert p.container_seconds(10.0) == pytest.approx(3.0)
    # next acquire is cold again
    assert p.acquire(now=5.0).cold


def test_pool_double_release_raises():
    p = C.ContainerPool("img")
    lease = p.acquire(now=0.0)
    p.release(lease, now=1.0)
    with pytest.raises(RuntimeError):
        p.release(lease, now=2.0)


def test_pool_shutdown_finalizes_seconds():
    p = C.ContainerPool("img", cold_start=0.1, keepalive=100.0)
    p.acquire(now=0.0)
    p.prewarm(now=0.0)
    assert p.shutdown(now=4.0) == pytest.approx(8.0)
    assert p.live() == 0


# ----------------------------------------------------------------------
# Arrival processes
# ----------------------------------------------------------------------

def test_poisson_arrivals_deterministic_and_calibrated():
    a = C.poisson_arrivals(10.0, 500, seed=42)
    b = C.poisson_arrivals(10.0, 500, seed=42)
    assert a == b and len(a) == 500
    assert a == sorted(a) and a[0] > 0
    mean_gap = a[-1] / len(a)
    assert 0.05 < mean_gap < 0.2              # mean 1/rate = 0.1 +/- slack
    assert C.poisson_arrivals(10.0, 50, seed=1) != C.poisson_arrivals(
        10.0, 50, seed=2)
    with pytest.raises(ValueError):
        C.poisson_arrivals(0.0, 5)


def test_trace_arrivals():
    assert C.trace_arrivals([0.3, 0.1, 0.2]) == [0.1, 0.2, 0.3]
    with pytest.raises(ValueError):
        C.trace_arrivals([-1.0])


# ----------------------------------------------------------------------
# Concurrent multi-instance serving
# ----------------------------------------------------------------------

def _echo_chain():
    """2-stage chain whose response encodes the request — distinct per
    instance, so cross-instance key collisions are detectable."""
    def s0(request):
        return {"mid": b"mid:" + request}

    def s1(mid):
        return {"response": b"resp:" + mid}
    return C.Workflow("echo", [
        C.FunctionSpec("s0", ("request",), ("mid",), fn=s0, exec_time=0.02,
                       cold_start=0.02),
        C.FunctionSpec("s1", ("mid",), ("response",), fn=s1, exec_time=0.02,
                       cold_start=0.02),
    ])


@pytest.mark.parametrize("pattern", ["dataflow", "controlflow"])
def test_concurrent_instances_no_collision(pattern):
    """The satellite bug: global DStore keys made concurrent instances of
    one workflow collide.  With per-instance namespacing every instance
    gets the response for *its own* request."""
    srv = C.DServe(_echo_chain(), n_nodes=2, pattern=pattern,
                   keepalive=10.0, max_per_node=8, get_timeout=10.0)
    n = 8
    rep = srv.run([0.0] * n, inputs=lambda i: {"request": b"r%d" % i})
    assert rep.failures == 0
    assert rep.max_concurrency >= 4
    for i, stat in enumerate(rep.stats):
        assert stat.outputs["response"] == b"resp:mid:r%d" % i, stat


def test_instance_eviction_bounds_store():
    srv = C.DServe(_echo_chain(), n_nodes=2, keepalive=10.0,
                   get_timeout=10.0)
    rep = srv.run(C.poisson_arrivals(50.0, 6, seed=5),
                  inputs=lambda i: {"request": b"r%d" % i})
    assert rep.failures == 0
    assert srv.store.directory.keys() == []       # all namespaces evicted
    for store in srv.store.stores.values():
        assert not store._data


def test_prewarm_cuts_request_path_cold_starts():
    """fig12 serving acceptance: request-path cold-start counts drop with
    the §3.2 prewarm trigger enabled."""
    counts = {}
    for prewarm in (True, False):
        wf = C.serving_chain(stages=4, exec_time=0.02, cold_start=0.08,
                             payload=4 * 1024)
        srv = C.DServe(wf, n_nodes=2, pattern="dataflow", prewarm=prewarm,
                       keepalive=10.0, get_timeout=10.0)
        rep = srv.run(C.poisson_arrivals(6.0, 6, seed=1),
                      inputs={"request": b"x"})
        assert rep.failures == 0
        counts[prewarm] = (rep.cold_starts, rep.prewarm_hits)
    assert counts[True][0] < counts[False][0]
    assert counts[True][1] > 0 and counts[False][1] == 0


def test_dataflow_beats_controlflow_p99_under_load():
    """serve_load acceptance in test form: at >=4 concurrent instances the
    dataflow pattern's p99 beats controlflow's."""
    p99 = {}
    for pattern in ("dataflow", "controlflow"):
        wf = C.serving_chain(stages=4, exec_time=0.03, cold_start=0.15,
                             payload=8 * 1024)
        srv = C.DServe(wf, n_nodes=2, pattern=pattern, keepalive=10.0,
                       max_per_node=16, get_timeout=10.0)
        rep = srv.run(C.poisson_arrivals(8.0, 10, seed=7),
                      inputs={"request": b"req"})
        assert rep.failures == 0
        assert rep.max_concurrency >= 4, rep.max_concurrency
        p99[pattern] = rep.p99
    assert p99["dataflow"] < p99["controlflow"], p99


def test_bounded_per_node_concurrency():
    """max_per_node caps how many functions *execute* simultaneously on a
    node (launched-but-blocked fetches don't hold slots, so no deadlock)."""
    running = {"now": 0, "peak": 0}
    lock = threading.Lock()

    def work(**kw):
        with lock:
            running["now"] += 1
            running["peak"] = max(running["peak"], running["now"])
        time.sleep(0.03)
        with lock:
            running["now"] -= 1
        return {next(iter(kw)).replace("in", "out"): b"v"}

    fns = [C.FunctionSpec(f"w{i}", (f"in{i}",), (f"out{i}",), fn=work,
                          exec_time=0.03, cold_start=0.0)
           for i in range(6)]
    wf = C.Workflow("fan", fns)
    srv = C.DServe(wf, n_nodes=1, pattern="dataflow", max_per_node=2,
                   keepalive=10.0, get_timeout=10.0)
    rep = srv.run([0.0], inputs={f"in{i}": b"x" for i in range(6)})
    assert rep.failures == 0
    assert running["peak"] <= 2


def test_fanout_workload_serves():
    srv = C.DServe(C.serving_fanout(workers=3, exec_time=0.01,
                                    cold_start=0.02),
                   n_nodes=2, keepalive=10.0, get_timeout=10.0)
    rep = srv.run([0.0, 0.05, 0.1], inputs={"request": b"q"})
    assert rep.failures == 0
    assert all(s.outputs["response"] for s in rep.stats)


# ----------------------------------------------------------------------
# Failure injection across concurrent instances
# ----------------------------------------------------------------------

def test_node_failure_recovers_only_lost_functions_per_instance():
    """Kill a node while 2 instances are mid-flight: every instance
    completes, and only the functions whose outputs actually died re-run
    (incremental, per instance) — survivors run exactly once."""
    calls: dict[str, int] = {}
    lock = threading.Lock()

    def mk(name, out_key, slow=False):
        def fn(**kw):
            with lock:
                calls[name] = calls.get(name, 0) + 1
            if slow:
                time.sleep(0.15)
            src = b"".join(bytes(v) for _, v in sorted(kw.items()))
            return {out_key: name.encode() + b"|" + src}
        return fn

    # a -> b -> c; placement puts the chain on one node, so failing the
    # OTHER node must lose nothing.
    wf = C.Workflow("ft", [
        C.FunctionSpec("a", ("x",), ("ka",), fn=mk("a", "ka"),
                       exec_time=0.01, cold_start=0.0),
        C.FunctionSpec("b", ("ka",), ("kb",), fn=mk("b", "kb", slow=True),
                       exec_time=0.15, cold_start=0.0),
        C.FunctionSpec("c", ("kb",), ("kc",), fn=mk("c", "kc"),
                       exec_time=0.01, cold_start=0.0),
    ])
    srv = C.DServe(wf, n_nodes=2, pattern="dataflow", keepalive=10.0,
                   get_timeout=10.0)
    used = set(srv.placement.values())
    dead = next(iter(used))
    expected = {"kc": b"c|b|a|x0"}, {"kc": b"c|b|a|x1"}
    # fail while b (slow) is mid-flight: a's output ka is lost, only a
    # re-runs; b's blocked/done state recovers through the re-publish.
    rep = srv.run([0.0, 0.02], inputs=lambda i: {"x": b"x%d" % i},
                  fail_node_at=(0.08, dead))
    assert rep.failures == 0, [s.error for s in rep.stats]
    for i, stat in enumerate(rep.stats):
        assert stat.outputs == expected[i]
    # c never started before the failure -> executed exactly once per inst.
    assert calls["c"] == 2
    # something was actually lost and re-run on at least one instance
    assert sum(s.reexecuted for s in rep.stats) >= 1 or calls["a"] > 2


def test_failure_on_unused_node_is_noop():
    srv = C.DServe(_echo_chain(), n_nodes=3, keepalive=10.0, get_timeout=10.0)
    unused = [n for n in srv.engine.nodes
              if n not in set(srv.placement.values())]
    if not unused:
        pytest.skip("partitioner used every node")
    rep = srv.run([0.0, 0.01], inputs=lambda i: {"request": b"r%d" % i},
                  fail_node_at=(0.03, unused[0]))
    assert rep.failures == 0
    assert all(s.reexecuted == 0 for s in rep.stats)


def test_manual_fail_node_between_instances():
    """fail_node() between arrivals: finished instances are unaffected
    (already evicted), in-flight ones recover."""
    srv = C.DServe(_echo_chain(), n_nodes=2, keepalive=10.0, get_timeout=10.0)
    r1 = srv.run([0.0], inputs={"request": b"one"})
    assert r1.failures == 0
    lost = srv.fail_node(srv.placement["s0"])
    assert lost == []                  # everything was already evicted
    r2 = srv.run([0.0], inputs={"request": b"two"})
    assert r2.failures == 0
    assert r2.stats[0].outputs["response"] == b"resp:mid:two"


# ----------------------------------------------------------------------
# Engine-level instance API (what DServe builds on)
# ----------------------------------------------------------------------

def test_instance_runs_share_store_without_collision():
    eng = C.DFlowEngine(n_nodes=2, get_timeout=10.0)
    store = C.DStore(eng.nodes, eng.transport)
    wf = _echo_chain()
    runs = [eng.start(wf, {"request": b"r%d" % i}, store=store,
                      instance=f"echo#{i}") for i in range(4)]
    for i, run in enumerate(runs):
        rep = run.wait()
        assert rep.outputs["response"] == b"resp:mid:r%d" % i
    # namespaced keys really are distinct records
    keys = store.directory.keys()
    assert len([k for k in keys if k.endswith(":response")]) == 4
    runs[0].evict()
    assert not any(k.startswith("echo#0:") for k in store.directory.keys())


def test_container_service_metrics_aggregate():
    svc = C.ContainerService(["node0"], keepalive=10.0, max_per_node=4)
    lease = svc.acquire("node0", "img", cold_start=0.0)
    assert lease.cold is True
    svc.release("node0", "img", lease)
    lease = svc.acquire("node0", "img", cold_start=0.0)
    assert lease.cold is False
    svc.release("node0", "img", lease)
    svc.prewarm("node0", "img2", cold_start=0.0)
    assert svc.cold_starts == 1
    assert svc.warm_hits == 1
    assert svc.prewarm_boots == 1
    assert svc.container_seconds() >= 0.0


# ----------------------------------------------------------------------
# Parity with the reference: the container lifecycle and the arrivals
# ----------------------------------------------------------------------

def _pool_script(serve, seed: int) -> list:
    """A seeded script of acquires, warm acquires, releases, prewarms,
    autoscaler targets and sweeps on one ``ContainerPool``, with what each
    returned and the pool's state and metrics after it."""
    rng = random.Random(seed)
    pool = serve.ContainerPool(f"img{seed}",
                               cold_start=rng.choice([0.0, 0.05, 0.5]),
                               keepalive=rng.choice([0.2, 1.0, 5.0]))
    now, leases, out = 0.0, [], []
    for _ in range(300):
        now += rng.choice([0.0, 0.01, 0.1, 0.3, 1.5])
        op = rng.choice(["acquire", "warm", "release", "release",
                         "prewarm", "target", "sweep"])
        got = None
        if op in ("acquire", "warm"):
            lease = (pool.acquire(now) if op == "acquire"
                     else pool.try_acquire_warm(now))
            if lease is not None:
                leases.append(lease)
                got = (lease.delay, lease.cold)
        elif op == "release" and leases:
            pool.release(leases.pop(rng.randrange(len(leases))), now)
        elif op == "prewarm":
            got = pool.prewarm(now)
        elif op == "target":
            got = pool.set_target(rng.choice([None, 0, 1, 2, 4]), now)
        elif op == "sweep":
            got = pool.sweep(now)
        out.append((op, got, pool.idle_count(now), pool.available(now),
                    pool.live(), pool.container_seconds(now), pool.boots,
                    pool.cold_starts, pool.prewarm_boots, pool.warm_hits,
                    pool.prewarm_hits, pool.evictions, pool.target,
                    [dataclasses.astuple(c) for c in pool._containers]))
    for lease in leases:
        out.append((dataclasses.astuple(lease.container), lease.delay,
                    lease.cold, lease.released))
    out.append(("shutdown", pool.shutdown(now + 1.0)))
    return out


@both
@pytest.mark.parametrize("seed", range(6))
def test_container_pool_script_equals_the_reference(seed):
    ref, port = module_pair("core.serve")
    want = _pool_script(ref, seed)
    assert any(step[0] == "target" for step in want[:-1])
    assert _pool_script(port, seed) == want


@both
@pytest.mark.parametrize("seed", range(4))
def test_arrivals_and_percentiles_equal_the_reference(seed):
    ref, port = module_pair("core.serve")
    for rate in (0.5, 20.0, 400.0):
        want = ref.poisson_arrivals(rate, 200, seed=seed)
        assert port.poisson_arrivals(rate, 200, seed=seed) == want
        shuffled = list(want)
        random.Random(seed).shuffle(shuffled)
        assert port.trace_arrivals(shuffled) == \
            ref.trace_arrivals(shuffled) == want
        for q in (0.0, 50.0, 95.0, 99.0, 100.0):
            assert port.percentile(want, q) == ref.percentile(want, q)
