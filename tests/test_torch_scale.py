"""The port's DScale (``repro_torch.core.scale``) held to the reference's
(``repro.core.scale``).

* The cases of tests/test_scale.py, unchanged but for the package they
  reach: each runs once on either package (``[repro]``, ``[repro_torch]``)
  through the namespace ``C`` (``tests/torch_cases.py``).
* Parity: the arrival generators are list-equal, and ``allocate_prewarms``,
  ``PrewarmBudget``, ``RateEstimator`` and ``PoolAutoscaler`` decide alike
  on a scripted metric sequence.
"""

import dataclasses
import importlib
import itertools
import math
import random
import threading
import time
import types

import pytest
from torch_cases import bind, both, bound_elsewhere, module_pair

import repro.core.workloads as ref_workloads

IMPORTS = {
    'core.dag': ['FunctionSpec', 'Workflow'],
    'core.dscheduler': ['DFlowEngine'],
    'core.obs': ['MetricsRegistry', 'Tracer'],
    'core.plan': ['build_plan'],
    'core.scale': ['AutoscalerConfig', 'PoolAutoscaler', 'PoolSpec',
                   'PrewarmBudget', 'RateEstimator', 'allocate_prewarms',
                   'bursty_arrivals', 'diurnal_arrivals'],
    'core.serve': ['ContainerPool', 'ContainerService', 'DServe',
                   'percentile', 'trace_arrivals'],
    'core.sim': ['Env'],
    'core.simcluster': ['Cluster', 'SimConfig'],
    'core.sim_systems': ['make_system'],
    'core.workloads': ['make_workflow'],
}

C = types.SimpleNamespace()     # the names of the package under test
package = bind(C, IMPORTS)


def test_the_cases_reach_the_package_under_test(package):
    assert not bound_elsewhere(package, C)


# ----------------------------------------------------------------------
# tests/test_scale.py
# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# Lease-token accounting — the headline bugfix
# ----------------------------------------------------------------------

def test_release_flips_the_leased_container_not_first_busy():
    """The bug: release() un-busied the FIRST busy container in the pool,
    not the one the caller leased.  With one warm lease outstanding and a
    cold boot released mid-boot, first-busy release marked the *warm
    leased* container idle (wrong container, wrong idle_since) — the next
    warm acquire stole it out from under its holder.  The lease token
    pins the identity: these asserts fail under the pre-fix semantics."""
    p = C.ContainerPool("img", cold_start=1.0, keepalive=2.0)
    a = p.acquire(now=0.0)                 # c0: cold boot, ready at 1.0
    p.release(a, now=1.0)                  # c0 idle since 1.0
    w = p.try_acquire_warm(1.5)            # leases ready c0 (warm hit)
    assert w is not None and w.delay == 0.0 and not w.cold
    b = p.acquire(now=1.5)                 # c1: cold boot, ready at 2.5
    assert b.cold and b.container is not w.container
    p.release(b, now=2.0)                  # released before boot completes
    # c1 (still booting) must be the idle one; c0 stays leased to w.
    # Pre-fix: c0 (first busy) was flipped -> idle_count == 1, and the
    # warm acquire below would have returned c0 with delay 0.0.
    assert p.idle_count(2.0) == 0
    assert p.available(2.0) == 1
    x = p.try_acquire_warm(2.0)
    assert x is not None
    assert x.delay == pytest.approx(0.5)   # joins c1's residual boot
    assert x.container is b.container
    # w's lease is still intact and releasable.
    p.release(w, now=2.2)
    p.release(x, now=3.0)


def test_release_of_retired_container_is_tolerated():
    p = C.ContainerPool("img", cold_start=0.1, keepalive=10.0)
    lease = p.acquire(now=0.0)
    p.shutdown(now=1.0)
    p.release(lease, now=2.0)              # no raise: retired under lease
    assert lease.released
    with pytest.raises(RuntimeError):      # double release still caught
        p.release(lease, now=3.0)


def test_service_release_after_node_failure_is_noop():
    svc = C.ContainerService(["node0"], keepalive=10.0, cold_start=0.0)
    lease = svc.acquire("node0", "img", cold_start=0.0)
    svc.fail_node("node0")
    svc.release("node0", "img", lease)     # tolerated, not an error
    assert lease.released


# ----------------------------------------------------------------------
# Input validation satellites
# ----------------------------------------------------------------------

def test_trace_arrivals_rejects_nonfinite():
    for bad in (float("nan"), float("inf"), float("-inf")):
        with pytest.raises(ValueError):
            C.trace_arrivals([0.1, bad, 0.2])
    assert C.trace_arrivals([0.3, 0.0, 0.2]) == [0.0, 0.2, 0.3]


def test_percentile_validates_q():
    vals = [1.0, 2.0, 3.0, 4.0]
    assert C.percentile(vals, 0.0) == 1.0        # edges are legal
    assert C.percentile(vals, 100.0) == 4.0
    for q in (-1.0, 100.1, 1000.0, float("nan")):
        with pytest.raises(ValueError):
            C.percentile(vals, q)
    assert math.isnan(C.percentile([], 50.0))


# ----------------------------------------------------------------------
# Arrival generators
# ----------------------------------------------------------------------

def test_diurnal_arrivals_deterministic_and_shaped():
    a = C.diurnal_arrivals(400, base_rate=2.0, peak_rate=20.0, period=10.0,
                           seed=7)
    assert a == C.diurnal_arrivals(400, base_rate=2.0, peak_rate=20.0,
                                   period=10.0, seed=7)
    assert a == sorted(a) and len(a) == 400
    # Density near the peak (mid-period) beats density near the trough.
    def count(lo, hi):
        return sum(1 for t in a if lo <= (t % 10.0) < hi)
    assert count(4.0, 6.0) > count(0.0, 1.0) + count(9.0, 10.0)
    with pytest.raises(ValueError):
        C.diurnal_arrivals(10, base_rate=0.0, peak_rate=5.0)
    with pytest.raises(ValueError):
        C.diurnal_arrivals(10, base_rate=5.0, peak_rate=1.0)


def test_bursty_arrivals_deterministic_and_shaped():
    a = C.bursty_arrivals(400, base_rate=1.0, burst_rate=30.0,
                          burst_every=10.0, burst_len=2.0, seed=3)
    assert a == C.bursty_arrivals(400, base_rate=1.0, burst_rate=30.0,
                                  burst_every=10.0, burst_len=2.0, seed=3)
    assert a == sorted(a)
    in_burst = sum(1 for t in a if (t % 10.0) < 2.0)
    # Bursts occupy 20% of the time but carry the vast majority of load.
    assert in_burst > 0.7 * len(a)
    with pytest.raises(ValueError):
        C.bursty_arrivals(10, base_rate=1.0, burst_rate=5.0,
                          burst_every=1.0, burst_len=2.0)


# ----------------------------------------------------------------------
# PrewarmBudget
# ----------------------------------------------------------------------

def test_budget_grant_deny_settle_refund():
    b = C.PrewarmBudget(1.0)
    g1 = b.request("f1", 0.6, now=0.0)
    assert g1 is not None and b.available(0.0) == pytest.approx(0.4)
    assert b.request("f2", 0.6, now=0.0) is None      # over budget
    assert b.denied == 1
    assert b.settle(g1) is True and g1.fired
    b.refund(g1)                                      # boot was a no-op
    assert b.available(0.0) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        C.PrewarmBudget(-1.0)


def test_budget_cancel_closes_the_timer_race():
    """cancel() both refunds AND revokes, so a timer racing the
    cancellation sees settle() fail and never boots on refunded tokens."""
    b = C.PrewarmBudget(1.0)
    g = b.request("f", 0.5, now=0.0)
    b.cancel(g)
    assert b.available(0.0) == pytest.approx(1.0)
    assert b.settle(g) is False                       # the race is closed
    b.cancel(g)                                       # idempotent
    assert b.available(0.0) == pytest.approx(1.0)


def test_budget_refill_is_lazy_and_capped():
    b = C.PrewarmBudget(2.0, refill_per_s=1.0)
    assert b.request("f", 2.0, now=0.0) is not None
    assert b.available(0.5) == pytest.approx(0.5)
    assert b.available(100.0) == pytest.approx(2.0)   # capped at capacity


def test_budget_reclaim_revokes_highest_slack_first():
    b = C.PrewarmBudget(3.0)
    critical = b.request("crit", 1.0, slack=0.0, now=0.0)
    mid = b.request("mid", 1.0, slack=2.0, now=0.0)
    loose = b.request("loose", 1.0, slack=5.0, now=0.0)
    revoked = b.reclaim(1.5, now=0.0)
    assert [g.function for g in revoked] == ["loose", "mid"]
    assert loose.revoked and mid.revoked and not critical.revoked
    assert b.settle(critical) is True
    assert b.settle(mid) is False


# ----------------------------------------------------------------------
# allocate_prewarms — budget spent along DPlan slack
# ----------------------------------------------------------------------

def _diamond():
    """a -> {b (slow, critical), c (fast, slacky)} -> d."""
    return C.Workflow("dia", [
        C.FunctionSpec("a", ("x",), ("ka",), exec_time=1.0, cold_start=0.5),
        C.FunctionSpec("b", ("ka",), ("kb",), exec_time=5.0, cold_start=0.5),
        C.FunctionSpec("c", ("ka",), ("kc",), exec_time=1.0, cold_start=0.5),
        C.FunctionSpec("d", ("kb", "kc"), ("kd",), exec_time=1.0,
                       cold_start=0.5),
    ])


def test_allocate_prewarms_drops_highest_slack_first():
    plan = C.build_plan(_diamond(), nodes=["node0"])
    assert plan.functions["c"].slack > 0          # the droppable boot
    assert plan.functions["b"].slack == 0
    # Budget covers b and d's boot_cost (0.5 each) but not also c's.
    budget = C.PrewarmBudget(1.0)
    rows = C.allocate_prewarms(plan, budget, now=0.0)
    granted = {f for f, _, _, g in rows if g is not None}
    assert "b" in granted and "d" in granted      # critical path survives
    assert "c" not in granted                     # highest slack dropped
    assert budget.denied >= 1
    # Rows come back in boot order for the timer-arming loop.
    boots = [b for _, b, _, _ in rows]
    assert boots == sorted(boots)
    # No budget: every scheduled boot passes through with grant=None.
    free = C.allocate_prewarms(C.build_plan(_diamond(), nodes=["node0"]), None)
    assert len(free) == len(plan.prewarm_schedule)
    assert all(g is None for *_, g in free)


# ----------------------------------------------------------------------
# Prewarm timer lifecycle (dscheduler satellites)
# ----------------------------------------------------------------------

def test_prewarm_and_set_target_noop_after_shutdown_and_node_failure():
    svc = C.ContainerService(["node0", "node1"], keepalive=10.0)
    assert svc.prewarm("node0", "img", cold_start=0.1) is True
    assert svc.prewarm("node0", "img", cold_start=0.1) is False  # joinable
    svc.fail_node("node0")
    assert svc.prewarm("node0", "img", cold_start=0.1) is False
    assert svc.set_target("node0", "img", 3) == (0, 0)
    assert svc.prewarm("node1", "img", cold_start=0.1) is True
    svc.shutdown()
    assert svc.prewarm("node1", "img", cold_start=0.1) is False
    assert svc.set_target("node1", "img", 3) == (0, 0)
    assert svc.container_seconds() >= 0.0


def _slow_chain():
    def mk(out):
        def fn(**kw):
            time.sleep(0.05)
            return {out: b"v"}
        return fn
    return C.Workflow("tk", [
        C.FunctionSpec("a", ("x",), ("ka",), fn=mk("ka"), exec_time=0.05,
                       cold_start=0.0),
        C.FunctionSpec("b", ("ka",), ("kb",), fn=mk("kb"), exec_time=0.05,
                       cold_start=0.04),
    ])


def test_evict_cancels_pending_prewarm_timers_and_refunds_grants():
    """Killing an instance with armed prewarm timers: the timers must not
    fire containers.prewarm afterwards, and their budget grants must be
    refunded (satellite: timer lifecycle)."""
    wf = _slow_chain()
    svc = C.ContainerService([f"node{i}" for i in range(2)], keepalive=10.0)
    eng = C.DFlowEngine(n_nodes=2, containers=svc, prewarm=True,
                        get_timeout=5.0)
    placement = eng.gs.assign(wf)
    plan = C.build_plan(wf, placement)
    # b's slack-timed boot is armed on a threading.Timer (boot_at > 0).
    assert dict((f, fp.boot_at) for f, fp in plan.functions.items())["b"] > 0
    budget = C.PrewarmBudget(10.0)
    run = eng.start(wf, {"x": b"v"}, placement=placement, plan=plan,
                    budget=budget)
    run.evict()                       # kill before b's timer fires
    time.sleep(0.15)                  # well past boot_at
    b_pools = [p for (n, img), p in svc._pools.items() if img == "tk/b"]
    assert sum(p.prewarm_boots for p in b_pools) == 0
    assert all(g.fired or g.revoked for g in run._grants)
    # Every unfired grant's container-seconds went back to the bucket.
    spent = sum(g.cost for g in run._grants if g.fired and not g.refunded)
    assert budget.available(0.0) == pytest.approx(10.0 - spent)


def test_zero_budget_drops_priced_boots_but_not_free_ones():
    """b's slack-timed boot costs 0.04 container-seconds (it idles ahead
    of est); a's boots exactly at its est (cost 0) and stays granted even
    at zero budget — the p99-per-container-second pricing in action."""
    wf = _slow_chain()
    for cap, expect_b_boot in ((10.0, True), (0.0, False)):
        svc = C.ContainerService([f"node{i}" for i in range(2)],
                                 keepalive=10.0)
        eng = C.DFlowEngine(n_nodes=2, containers=svc, prewarm=True,
                            get_timeout=5.0)
        placement = eng.gs.assign(wf)
        plan = C.build_plan(wf, placement)
        assert plan.functions["b"].boot_cost > 0
        assert plan.functions["a"].boot_cost == 0
        run = eng.start(wf, {"x": b"v"}, placement=placement, plan=plan,
                        budget=C.PrewarmBudget(cap))
        rep = run.wait()
        assert rep.outputs["kb"] == b"v"
        b_boots = sum(p.prewarm_boots
                      for (n, img), p in svc._pools.items()
                      if img == "tk/b")
        assert (b_boots > 0) is expect_b_boot, (cap, b_boots)


# ----------------------------------------------------------------------
# Pool conservation (property-style)
# ----------------------------------------------------------------------

def test_pool_conservation_random_interleaving_virtual_clock():
    """Under any interleaving of acquire/release/prewarm/sweep/set_target,
    every booted container is either live or evicted (never lost, never
    double-counted) and container-seconds stay consistent and monotone."""
    rng = random.Random(1234)
    p = C.ContainerPool("img", cold_start=0.3, keepalive=2.0)
    leases = []
    now, prev_secs = 0.0, 0.0
    for _ in range(500):
        now += rng.random() * 0.5
        op = rng.randrange(6)
        if op == 0:
            leases.append(p.acquire(now))
        elif op == 1 and leases:
            p.release(leases.pop(rng.randrange(len(leases))), now)
        elif op == 2:
            p.sweep(now)
        elif op == 3:
            p.prewarm(now)
        elif op == 4:
            p.set_target(rng.randrange(4), now)
        else:
            p.set_target(None, now)
        assert p.live() + p.evictions == p.boots
        assert p.boots == p.cold_starts + p.prewarm_boots
        secs = p.container_seconds(now)
        assert secs >= prev_secs - 1e-9
        prev_secs = secs
        assert len([c for c in p._containers if c.busy]) == len(leases)
    total = p.shutdown(now)
    for lease in leases:
        p.release(lease, now)          # tolerated: retired under lease
    assert p.live() == 0
    assert p.container_seconds(now + 100.0) == pytest.approx(total)


def test_pool_conservation_threaded_interleaving():
    svc = C.ContainerService(["node0"], keepalive=0.2, max_per_node=8,
                             cold_start=0.01)
    stop = threading.Event()
    errors: list[BaseException] = []

    def worker(seed: int) -> None:
        rng = random.Random(seed)
        try:
            while not stop.is_set():
                lease = svc.acquire("node0", "img", cold_start=0.01)
                time.sleep(rng.random() * 0.01)
                svc.release("node0", "img", lease)
        except BaseException as exc:   # noqa: BLE001 - surfaced below
            errors.append(exc)

    def scaler() -> None:
        rng = random.Random(99)
        try:
            while not stop.is_set():
                svc.set_target("node0", "img", rng.randrange(5),
                               cold_start=0.01)
                time.sleep(0.004)
        except BaseException as exc:   # noqa: BLE001 - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    threads.append(threading.Thread(target=scaler))
    for t in threads:
        t.start()
    time.sleep(0.4)
    stop.set()
    for t in threads:
        t.join(5.0)
    assert not errors, errors
    p = svc.pool("node0", "img", 0.01)
    assert p.live() + p.evictions == p.boots       # quiescent conservation
    total = svc.shutdown()
    assert math.isfinite(total) and total >= 0.0
    assert p.live() == 0


# ----------------------------------------------------------------------
# RateEstimator + PoolAutoscaler
# ----------------------------------------------------------------------

def test_rate_estimator_windows_and_damps_short_history():
    r = C.RateEstimator(window=1.0)
    assert r.rate() == 0.0
    r.observe(0.0, 0.0)
    r.observe(0.05, 5.0)
    # Two samples 50 ms apart are not evidence of a 100/s sustained rate:
    # a short span still divides by the full window.
    assert r.rate() == pytest.approx(5.0)
    r.observe(1.0, 20.0)
    assert r.rate() == pytest.approx(20.0)
    r.observe(2.0, 20.0)
    assert r.rate() == pytest.approx(0.0, abs=1e-9)
    with pytest.raises(ValueError):
        C.RateEstimator(window=0.0)


def _scaler(reg, tr, **cfg_kw):
    calls = []
    cfg = C.AutoscalerConfig(**{"window": 1.0, "headroom": 1.0,
                                "max_pool": 8, "scale_down_delay": 1.0,
                                **cfg_kw})
    spec = C.PoolSpec(node="node0", image="wf/f", service_time=0.5)
    sc = C.PoolAutoscaler(
        reg, [spec], cfg=cfg, spans=tr,
        apply=lambda n, i, t, c: calls.append((n, i, t)))
    return sc, calls


def test_autoscaler_scales_up_on_rate_spike():
    reg, tr = C.MetricsRegistry(), C.Tracer()
    sc, calls = _scaler(reg, tr)
    arrivals = reg.counter("serve_arrivals_total")
    sc.step(0.0)
    arrivals.inc(10)                       # 10 arrivals over 1 s
    decisions = sc.step(1.0)
    assert len(decisions) == 1
    d = decisions[0]
    assert d.target == 5 and d.previous is None and d.reason == "rate"
    assert d.rate == pytest.approx(10.0)
    assert sc.target("node0", "wf/f") == 5
    assert calls == [("node0", "wf/f", 5)]
    # Published twice: registry events AND tracer span instants.
    assert reg.counter("autoscale_decisions_total", node="node0",
                       image="wf/f", direction="up").value == 1
    assert reg.gauge("pool_target", node="node0", image="wf/f").value == 5
    evs = [s for s in tr.finished() if s.kind == "scale"]
    assert len(evs) == 1 and evs[0].trace == "autoscaler"
    assert evs[0].attrs["target"] == 5 and evs[0].attrs["direction"] == "up"
    assert reg.total("autoscale_steps_total") == 2


def test_autoscaler_scales_down_after_hysteresis():
    reg, tr = C.MetricsRegistry(), C.Tracer()
    sc, calls = _scaler(reg, tr, scale_down_delay=1.0)
    arrivals = reg.counter("serve_arrivals_total")
    sc.step(0.0)
    arrivals.inc(10)
    sc.step(1.0)                            # up to 5
    sc.step(2.0)                            # rate 0, but within the delay
    assert sc.target("node0", "wf/f") == 5  # hysteresis holds
    sc.step(3.5)                            # sustained idle -> shrink
    assert sc.target("node0", "wf/f") == 0
    assert calls[-1] == ("node0", "wf/f", 0)
    assert sc.decisions[-1].reason == "idle"
    assert reg.counter("autoscale_decisions_total", node="node0",
                       image="wf/f", direction="down").value == 1
    downs = [s for s in tr.finished()
             if s.kind == "scale" and s.attrs["direction"] == "down"]
    assert len(downs) == 1 and downs[0].attrs["previous"] == 5


def test_autoscaler_mem_pressure_blocks_scale_up():
    reg, tr = C.MetricsRegistry(), C.Tracer()
    sc, calls = _scaler(reg, tr)
    arrivals = reg.counter("serve_arrivals_total")
    sc.step(0.0)
    arrivals.inc(2)
    sc.step(1.0)
    assert sc.target("node0", "wf/f") == 1
    # DShard gauges report the node memory-bound: scale-up must hold.
    reg.gauge("capacity_bytes", node="node0").set(100.0)
    reg.gauge("dstore_resident_bytes", node="node0").set(95.0)
    arrivals.inc(40)
    sc.step(2.0)
    assert sc.target("node0", "wf/f") == 1            # held
    assert reg.counter("autoscale_mem_holds_total", node="node0",
                       image="wf/f").value == 1
    # Pressure clears -> the pending scale-up goes through.
    reg.gauge("dstore_resident_bytes", node="node0").set(10.0)
    arrivals.inc(40)
    sc.step(3.0)
    assert sc.target("node0", "wf/f") > 1


def test_autoscaler_slo_bump():
    reg, tr = C.MetricsRegistry(), C.Tracer()
    sc, _ = _scaler(reg, tr, slo_p99=0.2)
    reg.histogram("serve_latency_seconds").observe(1.0)   # p99 over SLO
    arrivals = reg.counter("serve_arrivals_total")
    sc.step(0.0)
    arrivals.inc(10)
    sc.step(1.0)
    assert sc.target("node0", "wf/f") == 6    # 5 from rate + 1 SLO bump


def test_set_target_boots_up_and_reclaims_idle_early():
    p = C.ContainerPool("img", cold_start=0.5, keepalive=100.0)
    booted, evicted = p.set_target(3, now=0.0)
    assert (booted, evicted) == (3, 0)
    assert p.live() == 3 and p.prewarm_boots == 3
    assert p.idle_count(1.0) == 3               # boots completed
    # Scale down: idle containers beyond target are reclaimed ahead of
    # their (100 s) TTL — the container-seconds win.
    booted, evicted = p.set_target(1, now=2.0)
    assert (booted, evicted) == (0, 2)
    assert p.live() == 1 and p.evictions == 2
    assert p.container_seconds(2.0) == pytest.approx(3 * 2.0)


def test_target_floor_outranks_keepalive_ttl():
    # The autoscaler's target pins the pool from both sides: a lull
    # longer than the TTL must not drain a pool the control loop
    # believes is provisioned (apply only fires on target *changes*).
    p = C.ContainerPool("img", cold_start=0.5, keepalive=1.0)
    p.set_target(2, now=0.0)
    assert p.sweep(10.0) == 0                   # far past TTL: pinned
    assert p.live() == 2 and p.evictions == 0
    lease = p.try_acquire_warm(10.0)            # pinned-warm is reusable
    assert lease is not None and lease.delay == 0.0
    p.release(lease, now=10.1)
    # Dropping the target releases the pin: TTL reclaim resumes.
    p.set_target(1, now=10.2)
    assert p.live() == 1
    p.target = None
    assert p.sweep(20.0) == 1
    assert p.live() == 0


# ----------------------------------------------------------------------
# Simulator wiring (virtual clock)
# ----------------------------------------------------------------------

def test_sim_pool_set_target_respects_capacity_accounting():
    env = C.Env()
    cluster = C.Cluster(env, C.SimConfig(cold_start=0.5, keepalive=100.0))
    node = cluster.nodes["node1"]
    pool = node.pool("img")
    pool.set_target(3)
    assert pool.model.live() == 3
    assert node.container_cap.in_use == 3
    env.run(until=1.0)
    assert pool.warm == 3
    pool.set_target(1)
    assert pool.model.live() == 1
    assert node.container_cap.in_use == 1       # capacity handed back


def test_sim_lease_release_pins_container():
    env = C.Env()
    cluster = C.Cluster(env, C.SimConfig(cold_start=0.5, keepalive=100.0))
    pool = cluster.nodes["node1"].pool("img")
    got = []
    pool.acquire().add_waiter(got.append)
    env.run(until=1.0)
    (lease,) = got
    assert lease.cold and lease.delay == pytest.approx(0.5)
    lease.release()
    assert pool.warm == 1


def test_sim_zero_budget_blocks_speculative_prewarm():
    """faasflow's decentralized prewarm (the free heuristic) must pay the
    DScale budget in the simulator too: a zero bucket means no
    speculative boots, and the run still completes (cold boots on
    demand)."""
    wf = C.make_workflow("WC")
    boots = {}
    for cap in (None, 0.0):
        env = C.Env()
        cluster = C.Cluster(env, C.SimConfig())
        budget = None if cap is None else C.PrewarmBudget(cap)
        sys_ = C.make_system("faasflow", env, cluster, wf, budget=budget)
        sys_.invoke()
        env.run(until=120.0)
        assert len(sys_.results) == 1, cap
        boots[cap] = sum(p.model.prewarm_boots
                         for n in cluster.nodes.values()
                         for p in n._pools.values())
    assert boots[None] > 0
    assert boots[0.0] == 0


# ----------------------------------------------------------------------
# DServe admission control (bounded concurrency + shedding)
# ----------------------------------------------------------------------

def _echo_chain(work: float = 0.03):
    def s0(request):
        time.sleep(work)
        return {"mid": b"mid:" + request}

    def s1(mid):
        time.sleep(work)
        return {"response": b"resp:" + mid}
    return C.Workflow("echo", [
        C.FunctionSpec("s0", ("request",), ("mid",), fn=s0, exec_time=work,
                       cold_start=0.0),
        C.FunctionSpec("s1", ("mid",), ("response",), fn=s1, exec_time=work,
                       cold_start=0.0),
    ])


def test_admission_bounds_inflight_and_queues_overflow():
    srv = C.DServe(_echo_chain(), n_nodes=2, max_inflight=2,
                   keepalive=10.0, get_timeout=10.0)
    rep = srv.run([0.0] * 6, inputs=lambda i: {"request": b"r%d" % i})
    assert rep.failures == 0 and rep.shed == 0
    assert rep.max_concurrency <= 2
    assert rep.queued == 4                     # 2 ran, 4 waited
    assert rep.queue_wait_p95 > 0.0
    # Queued instances still produce correct, per-instance responses.
    for i, stat in enumerate(rep.stats):
        assert stat.outputs["response"] == b"resp:mid:r%d" % i
    # Registry carries the same counters the report was derived from.
    assert srv.metrics.total("serve_queued_total") == 4


def test_admission_sheds_when_queue_full():
    srv = C.DServe(_echo_chain(), n_nodes=2, max_inflight=1, queue_depth=1,
                   keepalive=10.0, get_timeout=10.0)
    rep = srv.run([0.0] * 4, inputs=lambda i: {"request": b"r%d" % i})
    assert rep.shed >= 1 and rep.queued >= 1
    assert rep.shed == sum(1 for s in rep.stats if s.shed)
    # Shed requests are backpressure, not failures.
    assert rep.failures == 0
    assert sum(1 for s in rep.stats if s.ok) == 4 - rep.shed
    for s in rep.stats:
        if s.shed:
            assert "shed" in s.error
    assert srv.metrics.total("serve_shed_total") == rep.shed


def test_admission_validation():
    with pytest.raises(ValueError):
        C.DServe(_echo_chain(), max_inflight=0)
    with pytest.raises(ValueError):
        C.DServe(_echo_chain(), queue_depth=-1)


def test_dserve_autoscale_end_to_end_publishes_decisions():
    """DServe(autoscale=...) closes the loop for real: registry arrival
    rates drive set_target on the live ContainerService, and every
    decision shows up as registry events and tracer span instants."""
    tr = C.Tracer()
    cfg = C.AutoscalerConfig(interval=0.02, window=0.4, headroom=1.5,
                             max_pool=8, scale_down_delay=30.0)
    srv = C.DServe(_echo_chain(), n_nodes=2, autoscale=cfg, spans=tr,
                   keepalive=10.0, get_timeout=10.0)
    assert srv.autoscaler is not None
    arrivals = [i * 0.025 for i in range(16)]
    rep = srv.run(arrivals, inputs=lambda i: {"request": b"r%d" % i})
    assert rep.failures == 0
    assert srv.autoscaler.decisions, "no scaling decisions taken"
    assert srv.metrics.total("autoscale_decisions_total") >= 1
    assert srv.metrics.total("autoscale_steps_total") >= 1
    scale_events = [s for s in tr.finished() if s.kind == "scale"]
    assert scale_events and all(s.trace == "autoscaler"
                                for s in scale_events)
    # The autoscaler's targets actually reached the pools.
    assert any(p.target is not None
               for p in srv.containers._pools.values())


# ----------------------------------------------------------------------
# Parity with the reference: arrivals, prewarm budgets, the autoscaler
# ----------------------------------------------------------------------

@both
@pytest.mark.parametrize("seed", range(5))
def test_arrival_processes_equal_the_reference(seed):
    ref, port = module_pair("core.scale")
    for kw in (dict(base_rate=2.0, peak_rate=20.0, period=10.0),
               dict(base_rate=0.5, peak_rate=0.5, period=3.0),
               dict(base_rate=1.0, peak_rate=300.0)):
        want = ref.diurnal_arrivals(300, seed=seed, **kw)
        assert port.diurnal_arrivals(300, seed=seed, **kw) == want
    for kw in (dict(base_rate=1.0, burst_rate=30.0, burst_every=10.0,
                    burst_len=2.0),
               dict(base_rate=5.0, burst_rate=5.0, burst_every=1.0,
                    burst_len=0.25)):
        want = ref.bursty_arrivals(300, seed=seed, **kw)
        assert port.bursty_arrivals(300, seed=seed, **kw) == want


def _grants(schedule):
    return [(f, boot_at, cold, None if g is None else dataclasses.asdict(g))
            for f, boot_at, cold, g in schedule]


def _budget_state(budget, now):
    return (budget.available(now), budget.granted, budget.denied,
            budget.revoked, budget.spent_s,
            [dataclasses.asdict(g) for g in budget._pending])


def _allocate(pkg, name, capacity):
    """``allocate_prewarms`` of one benchmark's DPlan under a budget, then
    a settle, a cancel, a refund and a reclaim, each with the state after
    it."""
    wl, plan_mod, scale = (importlib.import_module(f"{pkg}.core.{m}")
                           for m in ("workloads", "plan", "scale"))
    plan = plan_mod.build_plan(wl.BENCHMARKS[name](),
                               nodes=["node0", "node1"])
    budget = scale.PrewarmBudget(capacity, refill_per_s=0.25)
    schedule = scale.allocate_prewarms(plan, budget, now=1.0)
    out = [_grants(schedule), _budget_state(budget, 1.5),
           _grants(scale.allocate_prewarms(plan, None))]
    grants = [g for *_, g in schedule]
    if grants:
        out.append(budget.settle(grants[0]))
        budget.refund(grants[0])
        budget.cancel(grants[-1])
        out.append(_budget_state(budget, 2.0))
    out.append([dataclasses.asdict(g) for g in budget.reclaim(0.1, 3.0)])
    out.append(_budget_state(budget, 3.0))
    return out


@both
@pytest.mark.parametrize("name", sorted(ref_workloads.BENCHMARKS))
def test_allocate_prewarms_equals_the_reference(name):
    for capacity in (0.0, 0.05, 0.5, 50.0):
        assert _allocate("repro_torch", name, capacity) == \
            _allocate("repro", name, capacity), capacity


def _autoscale_script(pkg, seed):
    """A seeded sequence of arrivals, latencies and memory gauges read by
    a ``PoolAutoscaler`` over three pools, stepped every 0.25 s: its
    decisions, what it applied, the registry and the tracer's events."""
    obs, scale = (importlib.import_module(f"{pkg}.core.{m}")
                  for m in ("obs", "scale"))
    rng = random.Random(seed)
    reg = obs.MetricsRegistry()
    ticks = itertools.count()
    tr = obs.Tracer(clock=lambda: next(ticks) * 0.001)
    applied = []
    pools = [scale.PoolSpec("node0", "wf/a", service_time=0.2),
             scale.PoolSpec("node0", "wf/b", service_time=0.5,
                            cold_start=1.0),
             scale.PoolSpec("node1", "wf/c", service_time=0.05)]
    cfg = scale.AutoscalerConfig(window=1.0, headroom=1.5, min_pool=0,
                                 max_pool=12, scale_down_delay=0.75,
                                 slo_p99=0.3, mem_pressure=0.8)
    sc = scale.PoolAutoscaler(reg, pools, cfg=cfg, spans=tr,
                              apply=lambda *a: applied.append(a))
    arrivals = reg.counter("serve_arrivals_total")
    lat = reg.histogram("serve_latency_seconds")
    out = []
    for i in range(120):
        now = 0.25 * i
        burst = (i // 20) % 2 == 0
        arrivals.inc(rng.randint(0, 12 if burst else 2))
        for _ in range(rng.randint(0, 4)):
            lat.observe(rng.expovariate(4.0 if burst else 10.0))
        reg.gauge("capacity_bytes", node="node0").set(1000.0)
        reg.gauge("dstore_resident_bytes", node="node0").set(
            rng.choice([100.0, 500.0, 900.0]))
        reg.counter("tier_bytes", tier=rng.choice(["ipc", "net"])).inc(64)
        out.append([dataclasses.astuple(d) for d in sc.step(now)])
    out.append([dataclasses.astuple(d) for d in sc.decisions])
    out.append([sc.target(p.node, p.image) for p in pools])
    return out, applied, reg.dump(), [s.to_doc() for s in tr.finished()]


@both
@pytest.mark.parametrize("seed", range(4))
def test_autoscaler_decisions_equal_the_reference(seed):
    want = _autoscale_script("repro", seed)
    assert want[1], "the script should make the autoscaler act"
    assert {d[-1] for step in want[0][:-2] for d in step} >= {"rate", "idle"}
    assert _autoscale_script("repro_torch", seed) == want


@both
def test_rate_estimator_equals_the_reference():
    rng = random.Random(0)
    est = [m.RateEstimator(window=0.7) for m in module_pair("core.scale")]
    total = 0.0
    for i in range(400):
        total += rng.choice([0, 1, 5])
        now = 0.05 * i + rng.random() * 0.01
        rates = []
        for e in est:
            e.observe(now, total)
            rates.append(e.rate())
        assert rates[0] == rates[1]
