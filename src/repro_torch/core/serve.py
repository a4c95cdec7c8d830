"""DServe — concurrent multi-instance serving with explicit container pools.

The paper's headline wins are tail latency under load and a 5.6x cold-start
reduction (§5.4), but a single-instance engine cannot exhibit either: both
require many workflow instances in flight sharing one cluster's containers
and one DStore.  This module adds the serving substrate:

* :class:`ContainerPool` — an explicit, clock-agnostic container lifecycle
  model for one (node, function-image) pair: cold boot, warm reuse,
  keep-alive TTL eviction, and *dataflow-triggered prewarm* (paper §3.2: a
  function's container starts booting when its **precursor launches**, not
  when its inputs arrive, so boot time overlaps precursor execution).  The
  model is pure state + timestamps — every method takes ``now`` and returns
  delays — so the *same* lifecycle (and the same metrics: cold starts,
  warm/prewarm hits, evictions, container-seconds) backs both the threaded
  engine (wall clock) and the discrete-event simulator (virtual clock, via
  :class:`repro.core.simcluster._ContainerPool`).
* :class:`ContainerService` — thread-safe wall-clock adapter used by
  :class:`~repro.core.dscheduler.DFlowEngine`: per-(node, image) pools plus
  a bounded per-node execution-slot semaphore (per-node concurrency cap).
* :func:`poisson_arrivals` / :func:`trace_arrivals` — open-loop arrival
  processes (deterministic LCG exponential gaps; no global RNG).
* :class:`DServe` — the serving layer: drives N concurrent workflow
  instances through one shared engine + DStore with per-instance key
  namespacing (``"<wf>#<i>:<key>"``), instance-scoped eviction on
  completion, optional node-failure injection with per-instance incremental
  recovery, and a :class:`ServeReport` aggregating p50/p95/p99 latency,
  cold-start counts, and container-seconds.

Copy of ``repro/core/serve.py`` for the PyTorch port, which imports nothing
of ``repro``; its code is the reference's, line for line, with no departure.
Its lazy imports (``.dscheduler``, ``.dstore``, ``.router``, ``.lint``,
``.plan`` and ``.scale``) are relative, so they reach the port's modules.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Sequence

from .obs import MetricsRegistry

__all__ = [
    "ContainerPool", "ContainerService", "DServe", "Lease", "ServeReport",
    "InstanceStat", "percentile", "poisson_arrivals", "trace_arrivals",
]

# The metrics a ServeReport is built from; DServe.run snapshots their
# registry totals before/after so the report covers one run even though
# the service (and its warm containers) outlives runs.
_SERVE_BASE_METRICS = (
    "container_cold_starts", "container_prewarm_boots",
    "container_warm_hits", "container_prewarm_hits",
    "container_evictions", "container_seconds",
    "serve_queued_total", "serve_shed_total",
)


# ----------------------------------------------------------------------
# Container lifecycle model (pure; shared by engine and simulator)
# ----------------------------------------------------------------------

@dataclass
class _Container:
    boot_at: float                   # when the boot started
    ready_at: float                  # when the boot completes (<= now: ready)
    busy: bool                       # leased to a running function
    idle_since: float                # last release time (TTL anchor)


@dataclass
class Lease:
    """Handle for one leased container.

    ``release(lease, now)`` must return the *same* container the acquire
    marked busy — with mixed warm hits and prewarm hits a first-busy
    release can mark a still-booting container idle with the wrong
    ``idle_since``, skewing MRU reuse, TTL eviction, and
    container-seconds.  The token pins the container identity.
    """

    container: _Container
    delay: float                     # boot delay the caller must wait out
    cold: bool                       # paid a full request-path cold boot
    released: bool = False


class ContainerPool:
    """Lifecycle of containers for one (node, function-image) pair.

    Clock-agnostic: callers supply ``now`` (wall clock in the threaded
    engine, ``env.now`` in the simulator) and receive *delays*.  Metrics:

    * ``cold_starts``    — boots paid on the request path (a function had to
      start a container and wait out the full ``cold_start``).
    * ``prewarm_boots``  — boots started ahead of need (off the request
      path); ``boots = cold_starts + prewarm_boots``.
    * ``warm_hits``      — acquires served instantly by an idle container.
    * ``prewarm_hits``   — acquires that joined a container still booting
      (they wait only the residual boot time — the §3.2 overlap).
    * ``evictions`` / ``container_seconds`` — keep-alive TTL reclaim and the
      aggregate container occupancy (the cost axis of a serving system).
    """

    def __init__(self, image: str = "", *, cold_start: float = 0.5,
                 keepalive: float = 600.0):
        if cold_start < 0 or keepalive <= 0:
            raise ValueError("cold_start must be >= 0 and keepalive > 0")
        self.image = image
        self.cold_start = float(cold_start)
        self.keepalive = float(keepalive)
        self._containers: list[_Container] = []
        self.cold_starts = 0
        self.prewarm_boots = 0
        self.warm_hits = 0
        self.prewarm_hits = 0
        self.evictions = 0
        self._finalized_seconds = 0.0
        # DScale autoscaler target: None = TTL-only (classic keep-alive).
        # When set it pins the pool from both sides: sweep() reclaims
        # idle containers beyond it *before* their TTL expires (the
        # container-seconds win) but never TTL-evicts below it, and
        # set_target() boots up to it ahead of demand.
        self.target: int | None = None

    # -- derived state -----------------------------------------------------
    @property
    def boots(self) -> int:
        return self.cold_starts + self.prewarm_boots

    def idle_count(self, now: float) -> int:
        """Containers ready and idle at ``now`` (classic "warm count")."""
        return sum(1 for c in self._containers
                   if not c.busy and c.ready_at <= now)

    def available(self, now: float) -> int:
        """Idle containers including ones still booting (joinable)."""
        del now
        return sum(1 for c in self._containers if not c.busy)

    def live(self) -> int:
        return len(self._containers)

    def container_seconds(self, now: float) -> float:
        """Aggregate occupancy: evicted containers' lifetimes plus the age
        of every container still alive at ``now``."""
        return self._finalized_seconds + sum(
            max(now, c.boot_at) - c.boot_at for c in self._containers)

    # -- lifecycle ---------------------------------------------------------
    def sweep(self, now: float, *, enforce_target: bool = True) -> int:
        """Evict idle containers whose keep-alive TTL expired, then — when
        an autoscaler :attr:`target` is set — reclaim idle containers
        beyond the target immediately (LRU first, busy never).  The
        target is a two-sided pin: TTL expiry never shrinks the pool
        below it either (the autoscaler's floor outranks keep-alive, or
        a lull longer than the TTL would silently drain a pool the
        control loop believes is provisioned).  Returns how many were
        evicted (the simulator releases capacity per eviction)."""
        evicted = 0
        floor = self.target if self.target is not None else 0
        expired = sorted(
            (c for c in self._containers
             if not c.busy
             and max(c.idle_since, c.ready_at) + self.keepalive <= now),
            key=lambda c: c.idle_since)
        for c in expired:
            if len(self._containers) <= floor:
                break
            expires = max(c.idle_since, c.ready_at) + self.keepalive
            self._containers.remove(c)
            self._finalized_seconds += expires - c.boot_at
            self.evictions += 1
            evicted += 1
        if enforce_target and self.target is not None:
            idle = sorted((c for c in self._containers if not c.busy),
                          key=lambda c: c.idle_since)
            for c in idle:
                if len(self._containers) <= self.target:
                    break
                self._containers.remove(c)
                self._finalized_seconds += max(now, c.boot_at) - c.boot_at
                self.evictions += 1
                evicted += 1
        return evicted

    def try_acquire_warm(self, now: float) -> Lease | None:
        """Lease an existing container: delay 0.0 for a ready idle one,
        the residual boot delay for one still booting, None if a cold boot
        is required.  Marks the chosen container busy and returns the
        :class:`Lease` token identifying it (pass it back to
        :meth:`release`)."""
        # TTL-expired containers must not be reused, but an over-target
        # pool still prefers serving the request in hand over evicting —
        # it shrinks on the next release/set_target sweep instead.
        self.sweep(now, enforce_target=False)
        ready = [c for c in self._containers
                 if not c.busy and c.ready_at <= now]
        if ready:
            # MRU reuse keeps the rest of the fleet evictable by TTL.
            c = max(ready, key=lambda c: c.idle_since)
            c.busy = True
            self.warm_hits += 1
            return Lease(container=c, delay=0.0, cold=False)
        booting = [c for c in self._containers if not c.busy]
        if booting:
            c = min(booting, key=lambda c: c.ready_at)
            c.busy = True
            self.prewarm_hits += 1
            return Lease(container=c, delay=c.ready_at - now, cold=False)
        return None

    def acquire(self, now: float) -> Lease:
        """Lease a container; the returned token carries the delay until
        it is ready and whether a request-path cold boot was paid."""
        lease = self.try_acquire_warm(now)
        if lease is not None:
            return lease
        c = _Container(boot_at=now, ready_at=now + self.cold_start,
                       busy=True, idle_since=now)
        self._containers.append(c)
        self.cold_starts += 1
        return Lease(container=c, delay=self.cold_start, cold=True)

    def release(self, lease: Lease, now: float) -> None:
        """Return the leased container to the idle (warm) set.  Tolerates
        the container having been retired underneath the lease (pool
        shutdown / node failure) — its seconds were finalized then."""
        if lease.released:
            raise RuntimeError(
                f"pool {self.image!r}: lease released twice")
        lease.released = True
        c = lease.container
        if c not in self._containers:
            return                     # retired by shutdown()/node failure
        if not c.busy:
            raise RuntimeError(f"pool {self.image!r}: lease not busy")
        c.busy = False
        c.idle_since = max(now, c.ready_at)
        self.sweep(now)

    def set_target(self, target: int | None, now: float) -> tuple[int, int]:
        """Autoscaler hook: pin the pool's live-container target.  Boots
        up to the target immediately (counted as prewarm boots — they are
        proactive boots ahead of demand) and reclaims idle containers
        beyond it ahead of their TTL.  Returns ``(booted, evicted)``."""
        self.target = None if target is None else max(0, int(target))
        booted = 0
        while self.target is not None and self.live() < self.target:
            self._containers.append(
                _Container(boot_at=now, ready_at=now + self.cold_start,
                           busy=False, idle_since=now + self.cold_start))
            self.prewarm_boots += 1
            booted += 1
        evicted = self.sweep(now)
        return booted, evicted

    def prewarm(self, now: float) -> float:
        """Start booting one container ahead of need (paper §3.2 prewarm
        trigger: called when the function's *precursor launches*).  No-op if
        an idle or booting container already exists.  Returns the delay
        until an idle container will be ready."""
        self.sweep(now, enforce_target=False)
        idle = [c for c in self._containers if not c.busy]
        if idle:
            return max(0.0, min(c.ready_at for c in idle) - now)
        self._containers.append(
            _Container(boot_at=now, ready_at=now + self.cold_start,
                       busy=False, idle_since=now + self.cold_start))
        self.prewarm_boots += 1
        return self.cold_start

    def shutdown(self, now: float) -> float:
        """Retire every container; returns total container-seconds."""
        for c in self._containers:
            self._finalized_seconds += max(now, c.boot_at) - c.boot_at
        self._containers = []
        return self._finalized_seconds


# ----------------------------------------------------------------------
# Threaded adapter (wall clock) used by DFlowEngine / DServe
# ----------------------------------------------------------------------

class ContainerService:
    """Wall-clock container service: per-(node, image) pools + per-node
    bounded execution slots.

    ``acquire`` blocks the calling function thread for the boot delay (cold
    or residual prewarm); booting needs no background thread because
    readiness is purely a timestamp in the shared lifecycle model.
    ``slot(node)`` bounds how many functions *execute* concurrently per
    node (the cores cap); container acquisition is deliberately outside the
    slot so launched-but-blocked dataflow functions cannot deadlock the
    executing ones.
    """

    def __init__(self, nodes: Sequence[str], *, keepalive: float = 600.0,
                 max_per_node: int = 8, cold_start: float | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.nodes = list(nodes)
        self.keepalive = float(keepalive)
        self.cold_start_override = cold_start
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._pools: dict[tuple[str, str], ContainerPool] = {}
        self._slots = {n: threading.Semaphore(int(max_per_node))
                       for n in self.nodes}
        # Lifecycle guards for DScale: prewarms (including ones armed on
        # threading.Timers by the scheduler) must become no-ops once the
        # service shut down or the node died.
        self.closed = False
        self._failed_nodes: set[str] = set()
        # DCheck hook: container lifecycle events land in the same trace
        # as data-plane events, so PlanConformance can judge whether a
        # cold boot was avoidable (an unleased container existed).
        self._tracer = None

    def attach_tracer(self, tracer) -> None:
        self._tracer = tracer

    def register_metrics(self, registry) -> None:
        """DScope pull collector: per-(node, image) lifecycle counters
        scraped at ``registry.collect()`` time — zero hot-path cost."""
        def _scrape() -> None:
            with self._lock:
                now = self._clock()
                rows = [(node, image, p.cold_starts, p.prewarm_boots,
                         p.warm_hits, p.prewarm_hits, p.evictions,
                         p.container_seconds(now), p.live())
                        for (node, image), p in self._pools.items()]
            for (node, image, cold, boots, warm, pwh, ev, secs,
                 live) in rows:
                labels = dict(node=node, image=image)
                registry.counter("container_cold_starts",
                                 **labels).set(cold)
                registry.counter("container_prewarm_boots",
                                 **labels).set(boots)
                registry.counter("container_warm_hits", **labels).set(warm)
                registry.counter("container_prewarm_hits",
                                 **labels).set(pwh)
                registry.counter("container_evictions", **labels).set(ev)
                registry.gauge("container_seconds", **labels).set(secs)
                registry.gauge("containers_live", **labels).set(live)
        registry.register_collector(_scrape)

    def _pool_events(self, p: ContainerPool, pre: tuple[int, int, int, int],
                     node: str, image: str, *, cold: bool | None = None,
                     released: bool = False) -> None:
        # Called with self._lock held, right after a pool transition;
        # translates counter deltas into trace events (key = image).
        tr = self._tracer
        warm0, pw0, ev0, pb0 = pre
        if released:
            tr.record("container_release", image, node)
        for _ in range(p.evictions - ev0):
            tr.record("container_evict", image, node)
        for _ in range(p.prewarm_boots - pb0):
            tr.record("prewarm_boot", image, node)
        if cold is True:
            tr.record("cold_boot", image, node)
        elif cold is False:
            if p.warm_hits > warm0:
                tr.record("warm_hit", image, node)
            elif p.prewarm_hits > pw0:
                tr.record("prewarm_hit", image, node)

    def pool(self, node: str, image: str,
             cold_start: float = 0.5) -> ContainerPool:
        if self.cold_start_override is not None:
            cold_start = self.cold_start_override
        p = self._pools.get((node, image))
        if p is None:
            p = self._pools[(node, image)] = ContainerPool(
                image, cold_start=cold_start, keepalive=self.keepalive)
        return p

    def acquire(self, node: str, image: str,
                cold_start: float = 0.5) -> Lease:
        """Lease a container, sleeping out its boot delay; the returned
        :class:`Lease` records whether a full cold start was paid and must
        be handed back to :meth:`release`."""
        with self._lock:
            p = self.pool(node, image, cold_start)
            pre = (p.warm_hits, p.prewarm_hits, p.evictions, p.prewarm_boots)
            lease = p.acquire(self._clock())
            if self._tracer is not None:
                self._pool_events(p, pre, node, image, cold=lease.cold)
        if lease.delay > 0:
            self._sleep(lease.delay)
        return lease

    def release(self, node: str, image: str, lease: Lease) -> None:
        with self._lock:
            p = self._pools.get((node, image))
            if p is None:
                # Node failed / service shut down underneath the lease;
                # its container-seconds were finalized then.
                lease.released = True
                return
            pre = (p.warm_hits, p.prewarm_hits, p.evictions, p.prewarm_boots)
            p.release(lease, self._clock())
            if self._tracer is not None:
                self._pool_events(p, pre, node, image, released=True)

    def prewarm(self, node: str, image: str,
                cold_start: float = 0.5) -> bool:
        """Dataflow-triggered prewarm (§3.2): begin booting the function's
        container the moment its precursor launches.  Returns immediately
        — readiness is a timestamp, not a thread — with whether a boot
        actually started (False: an idle/booting container already
        existed, or the service/node is gone, so a prewarm budget should
        be refunded)."""
        with self._lock:
            if self.closed or node in self._failed_nodes:
                return False
            p = self.pool(node, image, cold_start)
            pre = (p.warm_hits, p.prewarm_hits, p.evictions, p.prewarm_boots)
            p.prewarm(self._clock())
            booted = p.prewarm_boots > pre[3]
            if self._tracer is not None:
                self._pool_events(p, pre, node, image)
        return booted

    def set_target(self, node: str, image: str, target: int | None,
                   cold_start: float = 0.5) -> tuple[int, int]:
        """DScale autoscaler hook: pin one pool's live-container target
        (boot up to it, reclaim idle beyond it ahead of TTL)."""
        with self._lock:
            if self.closed or node in self._failed_nodes:
                return (0, 0)
            p = self.pool(node, image, cold_start)
            pre = (p.warm_hits, p.prewarm_hits, p.evictions, p.prewarm_boots)
            out = p.set_target(target, self._clock())
            if self._tracer is not None:
                self._pool_events(p, pre, node, image)
        return out

    def fail_node(self, node: str) -> None:
        """Node death: retire the node's pools (finalizing their
        container-seconds); later prewarms/scale decisions for it no-op
        and in-flight releases become tolerated no-ops."""
        with self._lock:
            self._failed_nodes.add(node)
            now = self._clock()
            for (n, image), p in list(self._pools.items()):
                if n == node:
                    p.shutdown(now)

    def shutdown(self) -> float:
        """Retire every pool; returns total container-seconds.  Armed
        prewarm timers that fire afterwards are no-ops."""
        with self._lock:
            self.closed = True
            now = self._clock()
            return sum(p.shutdown(now) for p in self._pools.values())

    @contextmanager
    def slot(self, node: str):
        """Bounded per-node execution slot (acquired only for fn runtime)."""
        self._slots[node].acquire()
        try:
            yield
        finally:
            self._slots[node].release()

    # -- aggregate metrics -------------------------------------------------
    def _total(self, attr: str) -> int:
        with self._lock:
            return sum(getattr(p, attr) for p in self._pools.values())

    @property
    def cold_starts(self) -> int:
        return self._total("cold_starts")

    @property
    def prewarm_boots(self) -> int:
        return self._total("prewarm_boots")

    @property
    def warm_hits(self) -> int:
        return self._total("warm_hits")

    @property
    def prewarm_hits(self) -> int:
        return self._total("prewarm_hits")

    @property
    def evictions(self) -> int:
        return self._total("evictions")

    def container_seconds(self) -> float:
        with self._lock:
            now = self._clock()
            return sum(p.container_seconds(now)
                       for p in self._pools.values())


# ----------------------------------------------------------------------
# Open-loop arrival processes
# ----------------------------------------------------------------------

def poisson_arrivals(rate_per_s: float, n: int,
                     seed: int = 0) -> list[float]:
    """Deterministic Poisson process: ``n`` arrival times (seconds from
    t=0) with exponential inter-arrival gaps of mean ``1/rate`` drawn from
    a seeded LCG (no global RNG — every experiment is reproducible)."""
    if rate_per_s <= 0:
        raise ValueError("rate_per_s must be positive")
    s = (seed * 2654435761 + 0x9E3779B9) & 0xFFFFFFFF
    t, out = 0.0, []
    for _ in range(n):
        s = (1103515245 * s + 12345) & 0x7FFFFFFF
        u = (s + 1) / (0x7FFFFFFF + 2)          # u in (0, 1)
        t += -math.log(u) / rate_per_s
        out.append(t)
    return out


def trace_arrivals(times: Iterable[float]) -> list[float]:
    """Trace-driven arrivals: validate + sort a recorded timestamp list.

    NaN/inf are rejected, not just negatives: NaN sorts unpredictably
    (it silently corrupts the schedule ordering) and inf wedges the
    open-loop arrival sleep forever.
    """
    out = []
    for t in times:
        f = float(t)
        if not math.isfinite(f):
            raise ValueError(f"trace timestamps must be finite, got {f!r}")
        if f < 0:
            raise ValueError("trace timestamps must be >= 0")
        out.append(f)
    out.sort()
    return out


# ----------------------------------------------------------------------
# Serving layer
# ----------------------------------------------------------------------

@dataclass
class InstanceStat:
    instance: str
    arrival: float                   # seconds from serve start
    latency: float = math.nan        # end-to-end (admission -> all done)
    ok: bool = False
    error: str = ""
    reexecuted: int = 0
    outputs: dict = field(default_factory=dict)   # sink outputs (response)
    queue_wait: float = 0.0          # admission-queue wait (DScale)
    shed: bool = False               # rejected: queue full (backpressure)


def percentile(values: list[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0,100]).  The project's one
    implementation — ``repro.core.experiments`` re-exports it."""
    if not 0.0 <= q <= 100.0:       # also rejects NaN (comparison False)
        raise ValueError(f"percentile q must be in [0, 100], got {q!r}")
    if not values:
        return math.nan
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    frac = pos - lo
    return v[lo] * (1 - frac) + v[hi] * frac


@dataclass
class ServeReport:
    """Aggregate of one open-loop serving run (consumed by
    ``benchmarks/serve_load.py`` and ``benchmarks/fig12_coldstart.py``)."""

    workflow: str
    pattern: str
    stats: list[InstanceStat] = field(default_factory=list)
    wall_time: float = 0.0
    max_concurrency: int = 0
    cold_starts: int = 0             # request-path cold boots
    prewarm_boots: int = 0
    warm_hits: int = 0
    prewarm_hits: int = 0
    evictions: int = 0
    container_seconds: float = 0.0
    # Max over per-node DStore high-water marks: a node provisions for its
    # OWN peak, and under DShard the stores really are per-node shards —
    # summing them (the old definition) overstated the capacity a node
    # needs and was incomparable to DPlan's per-node peak_resident.
    peak_resident_bytes: int = 0
    peak_resident_per_node: dict = field(default_factory=dict)
    # DScale admission control (derived from registry deltas like the
    # container counters above).
    queued: int = 0                  # requests that waited in admission
    shed: int = 0                    # requests rejected (queue full)

    @property
    def latencies(self) -> list[float]:
        return [s.latency for s in self.stats if s.ok]

    @property
    def failures(self) -> int:
        return sum(1 for s in self.stats if not s.ok and not s.shed)

    @property
    def queue_waits(self) -> list[float]:
        return [s.queue_wait for s in self.stats if s.queue_wait > 0]

    @property
    def queue_wait_p95(self) -> float:
        return percentile(self.queue_waits, 95.0) if self.queue_waits \
            else 0.0

    @property
    def p50(self) -> float:
        return percentile(self.latencies, 50.0)

    @property
    def p95(self) -> float:
        return percentile(self.latencies, 95.0)

    @property
    def p99(self) -> float:
        return percentile(self.latencies, 99.0)

    def row(self) -> dict:
        return {
            "workflow": self.workflow, "pattern": self.pattern,
            "n": len(self.stats), "failures": self.failures,
            "p50_s": round(self.p50, 4), "p95_s": round(self.p95, 4),
            "p99_s": round(self.p99, 4),
            "max_concurrency": self.max_concurrency,
            "cold_starts": self.cold_starts,
            "prewarm_boots": self.prewarm_boots,
            "warm_hits": self.warm_hits,
            "prewarm_hits": self.prewarm_hits,
            "container_seconds": round(self.container_seconds, 3),
            "peak_resident_bytes": self.peak_resident_bytes,
            "queued": self.queued, "shed": self.shed,
            "queue_wait_p95_s": round(self.queue_wait_p95, 4),
        }


class DServe:
    """Open-loop serving of one workflow: N concurrent instances through a
    shared :class:`~repro.core.dscheduler.DFlowEngine`, one shared DStore
    (per-instance key namespacing), and one :class:`ContainerService`.

    ``prewarm`` toggles the §3.2 dataflow-triggered prewarm of successor
    containers at precursor launch.  It is strictly a dataflow-pattern
    mechanism — the engine ignores it under ``pattern="controlflow"``,
    whose baseline semantics boot a container only when a function becomes
    ready (the §5.5 ablation).

    ``plan`` switches instances to DPlan-driven execution: ``True`` builds
    a :func:`repro.core.plan.build_plan` from this serve's placement; a
    prebuilt :class:`~repro.core.plan.WorkflowPlan` is used as-is.  Keys
    are then evicted the moment their statically-last read returns
    (instead of at instance completion) and container boots follow the
    slack schedule instead of the precursor-launch heuristic.

    ``sharded`` serves over a :class:`~repro.core.router.ShardedDStore`
    (DShard): per-node directory shards, local routing tables and 1-hop
    transfers — byte-identical results, no central metadata hotspot.

    DScope (obs.py): every DServe owns a :class:`MetricsRegistry` wired
    with pull collectors (containers, store, routing) — ``ServeReport``
    is built from it, and ``self.metrics.collect()`` dumps every counter
    from one source.  Passing your own ``metrics`` registry additionally
    enables the push-side hot-path histograms (per-Get / per-chunk
    latency); passing a ``spans`` :class:`~repro.core.obs.Tracer` records
    per-request span trees (request → invoke → acquire → Get/Put → chunk
    → hop).  Both default to off-path: a plain DServe pays nothing.
    """

    def __init__(self, wf, *, n_nodes: int = 2, pattern: str = "dataflow",
                 prewarm: bool | None = None, keepalive: float = 600.0,
                 max_per_node: int = 8, cold_start: float | None = None,
                 transport=None, get_timeout: float = 30.0,
                 evict_on_complete: bool = True, tracer=None,
                 lint: bool = True, plan=None, sharded: bool = False,
                 metrics=None, spans=None, max_inflight: int | None = None,
                 queue_depth: int | None = None, autoscale=None,
                 prewarm_budget=None):
        from .dscheduler import DFlowEngine
        from .dstore import DStore
        from .router import ShardedDStore

        if lint:
            # Lint once at serve-construction time (the request path
            # builds InstanceRuns directly and must stay lean).
            from .lint import check_workflow

            check_workflow(wf, require_fns=True)
        self.wf = wf
        self.pattern = pattern
        if prewarm is None:
            prewarm = pattern == "dataflow"
        self.containers = ContainerService(
            [f"node{i}" for i in range(n_nodes)], keepalive=keepalive,
            max_per_node=max_per_node, cold_start=cold_start)
        self.engine = DFlowEngine(n_nodes=n_nodes, pattern=pattern,
                                  transport=transport,
                                  get_timeout=get_timeout,
                                  containers=self.containers,
                                  prewarm=prewarm)
        self.sharded = sharded
        store_cls = ShardedDStore if sharded else DStore
        self.store = store_cls(self.engine.nodes, self.engine.transport)
        if tracer is not None:
            self.store.attach_tracer(tracer)
            self.containers.attach_tracer(tracer)
        # DScope wiring: pull collectors always (they cost nothing until
        # collect()); the hot-path push hooks only when the caller brought
        # a registry of their own.
        self.spans = spans
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.containers.register_metrics(self.metrics)
        if metrics is not None:
            self.store.attach_metrics(self.metrics)
        else:
            self.store.register_metrics(self.metrics)
        if spans is not None:
            self.store.attach_spans(spans)
        self.placement = self.engine.gs.assign(wf)
        if plan is True:
            from .plan import build_plan

            plan = build_plan(wf, self.placement)
        self.plan = plan if plan is not False else None
        self.evict_on_complete = evict_on_complete
        self._lock = threading.Lock()
        self._active: dict[str, Any] = {}      # instance -> InstanceRun
        self.max_concurrency = 0
        # -- DScale (scale.py) ------------------------------------------
        # Admission control: at most max_inflight instances run at once;
        # excess arrivals wait in a bounded FIFO (queue_depth; None =
        # unbounded) and overflow is shed.  None/None = classic unbounded
        # admission (behavior unchanged).
        if max_inflight is not None and max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if queue_depth is not None and queue_depth < 0:
            raise ValueError("queue_depth must be >= 0")
        self.max_inflight = max_inflight
        self.queue_depth = queue_depth
        from .scale import (AutoscalerConfig, PoolAutoscaler, PoolSpec,
                            PrewarmBudget)

        if isinstance(prewarm_budget, (int, float)):
            prewarm_budget = PrewarmBudget(float(prewarm_budget))
        self.prewarm_budget = prewarm_budget
        self.autoscaler = None
        if autoscale:
            cfg = autoscale if isinstance(autoscale, AutoscalerConfig) \
                else AutoscalerConfig()
            specs = [PoolSpec(node=self.placement[f],
                              image=f"{wf.name}/{f}",
                              service_time=fn.exec_time,
                              cold_start=fn.cold_start)
                     for f, fn in wf.functions.items()]
            self.autoscaler = PoolAutoscaler(
                self.metrics, specs, cfg=cfg, spans=self.spans,
                apply=self.containers.set_target,
                arrivals_labels=dict(workflow=wf.name, pattern=pattern))

    # ------------------------------------------------------------------
    def fail_node(self, node: str) -> list[str]:
        """Kill a node: every active instance incrementally recovers the
        functions whose outputs it lost (its own namespace only)."""
        lost = self.store.fail_node(node)
        with self._lock:
            active = list(self._active.values())
        for run in active:
            run.recover(lost)
        return lost

    # ------------------------------------------------------------------
    def run(self, arrivals: Sequence[float],
            inputs: Mapping[str, Any] | Callable[[int], Mapping[str, Any]]
            | None = None, *,
            fail_node_at: tuple[float, str] | None = None) -> ServeReport:
        """Drive one open-loop run: instance ``i`` starts at
        ``arrivals[i]`` seconds (wall clock) after the run begins.

        ``inputs`` may be a static mapping (shared by every instance) or a
        callable ``i -> mapping`` for per-instance payloads.
        ``fail_node_at=(t, node)`` kills ``node`` ``t`` seconds into the
        run (per-instance incremental recovery keeps instances alive).
        """
        arrivals = sorted(float(a) for a in arrivals)
        report = ServeReport(workflow=self.wf.name, pattern=self.pattern)
        stats = [InstanceStat(instance=f"{self.wf.name}#{i}", arrival=a)
                 for i, a in enumerate(arrivals)]
        report.stats = stats
        # Snapshot the registry so the report covers THIS run only (the
        # service — and its warm containers — outlives runs).  One source:
        # the same collectors back the registry dump and this report.
        reg = self.metrics
        reg.collect()
        base = {name: reg.total(name) for name in _SERVE_BASE_METRICS}
        self.max_concurrency = 0             # per-run high-water mark
        self.store.reset_peak()              # per-run resident high-water
        t0 = time.monotonic()
        threads: list[threading.Thread] = []

        killer = None
        if fail_node_at is not None:
            t_fail, node = fail_node_at

            def kill():
                delay = t_fail - (time.monotonic() - t0)
                if delay > 0:
                    time.sleep(delay)
                self.fail_node(node)
            killer = threading.Thread(target=kill, daemon=True,
                                      name="dserve-failure")
            killer.start()

        labels = dict(workflow=self.wf.name, pattern=self.pattern)
        # Admission state (DScale): bounded concurrency + FIFO overflow
        # queue.  All transitions happen under self._lock; `outstanding`
        # counts stats not yet resolved (finished or shed) so the waiter
        # below survives launches that happen from finish threads.
        from collections import deque
        admission_queue: deque = deque()
        inflight = [0]
        outstanding = [len(stats)]
        all_done = threading.Event()
        if not stats:
            all_done.set()

        def resolve_one() -> None:
            with self._lock:
                outstanding[0] -= 1
                if outstanding[0] <= 0:
                    all_done.set()

        def finish(stat: InstanceStat, run) -> None:
            try:
                rep = run.wait()
                stat.latency = rep.wall_time + stat.queue_wait
                stat.reexecuted = len(rep.reexecuted)
                stat.outputs = rep.outputs
                stat.ok = True
            except BaseException as exc:        # noqa: BLE001 - recorded
                stat.error = f"{type(exc).__name__}: {exc}"
            finally:
                with self._lock:
                    self._active.pop(stat.instance, None)
                if self.evict_on_complete:
                    self.store.evict_instance(f"{stat.instance}:")
                resolve_one()
                self._admit_next(admission_queue, inflight, launch, reg,
                                 labels)

        from .dscheduler import InstanceRun

        def launch(i: int, stat: InstanceStat) -> None:
            payload = inputs(i) if callable(inputs) else inputs
            run = InstanceRun(self.engine, self.wf, payload,
                              store=self.store, instance=stat.instance,
                              placement=self.placement, plan=self.plan,
                              spans=self.spans,
                              budget=self.prewarm_budget)
            # Register BEFORE starting: a node failure racing the start
            # must already see this instance to hand it its lost keys.
            with self._lock:
                self._active[stat.instance] = run
                self.max_concurrency = max(self.max_concurrency,
                                           len(self._active))
            run.start()
            th = threading.Thread(target=finish, args=(stat, run),
                                  daemon=True,
                                  name=f"dserve-{stat.instance}")
            th.start()
            threads.append(th)

        scaler_stop = self._start_autoscaler(t0)
        try:
            for i, stat in enumerate(stats):
                delay = stat.arrival - (time.monotonic() - t0)
                if delay > 0:
                    time.sleep(delay)
                reg.counter("serve_arrivals_total", **labels).inc()
                with self._lock:
                    if self.max_inflight is None \
                            or inflight[0] < self.max_inflight:
                        inflight[0] += 1
                        admit = "run"
                    elif self.queue_depth is None \
                            or len(admission_queue) < self.queue_depth:
                        admission_queue.append(
                            (i, stat, time.monotonic()))
                        admit = "queue"
                    else:
                        admit = "shed"
                if admit == "run":
                    launch(i, stat)
                elif admit == "queue":
                    reg.counter("serve_queued_total", **labels).inc()
                else:
                    stat.shed = True
                    stat.error = "shed: admission queue full"
                    reg.counter("serve_shed_total", **labels).inc()
                    resolve_one()

            all_done.wait(self.engine.get_timeout * 2)
            for th in list(threads):
                th.join(self.engine.get_timeout * 2)
        finally:
            if scaler_stop is not None:
                scaler_stop.set()
        if killer is not None:
            killer.join(1.0)
        report.wall_time = time.monotonic() - t0
        report.max_concurrency = self.max_concurrency
        reg.collect()

        def _delta(name: str) -> float:
            return reg.total(name) - base[name]

        report.cold_starts = int(_delta("container_cold_starts"))
        report.prewarm_boots = int(_delta("container_prewarm_boots"))
        report.warm_hits = int(_delta("container_warm_hits"))
        report.prewarm_hits = int(_delta("container_prewarm_hits"))
        report.evictions = int(_delta("container_evictions"))
        report.container_seconds = _delta("container_seconds")
        report.queued = int(_delta("serve_queued_total"))
        report.shed = int(_delta("serve_shed_total"))
        per_node = {n: int(v) for n, v in reg.label_values(
            "dstore_peak_resident_bytes", "node").items()}
        report.peak_resident_per_node = per_node
        report.peak_resident_bytes = max(per_node.values(), default=0)
        self._publish_run_metrics(report)
        return report

    # ------------------------------------------------------------------
    def _admit_next(self, queue, inflight, launch, reg, labels) -> None:
        """A finished instance hands its admission slot to the oldest
        queued arrival (FIFO); with an empty queue the slot is freed."""
        with self._lock:
            if not queue:
                inflight[0] -= 1
                return
            i, stat, enq = queue.popleft()
        wait = time.monotonic() - enq
        stat.queue_wait = wait
        reg.histogram("serve_queue_wait_seconds", **labels).observe(wait)
        launch(i, stat)

    def _start_autoscaler(self, t0: float):
        """Run the DScale control loop for the duration of one run: every
        ``cfg.interval`` seconds the autoscaler reads registry rates and
        re-targets the container pools.  Returns the stop event (None when
        autoscaling is off)."""
        del t0  # the autoscaler shares the service's monotonic clock
        if self.autoscaler is None:
            return None
        stop = threading.Event()
        interval = self.autoscaler.cfg.interval

        def loop() -> None:
            while not stop.wait(interval):
                self.autoscaler.step(time.monotonic())

        threading.Thread(target=loop, daemon=True,
                         name="dscale-autoscaler").start()
        return stop

    def _publish_run_metrics(self, report: ServeReport) -> None:
        """Run-level serving metrics into the registry (latency histogram,
        request/failure totals, concurrency) so autoscaling and bench
        emitters can read rates and tails from the same source."""
        reg = self.metrics
        labels = dict(workflow=report.workflow, pattern=report.pattern)
        h = reg.histogram("serve_latency_seconds", **labels)
        for lat in report.latencies:
            h.observe(lat)
        reg.counter("serve_requests_total", **labels).inc(len(report.stats))
        reg.counter("serve_failures_total", **labels).inc(report.failures)
        reg.gauge("serve_max_concurrency",
                  **labels).set(report.max_concurrency)
        if report.latencies:
            reg.gauge("serve_p50_seconds", **labels).set(report.p50)
            reg.gauge("serve_p95_seconds", **labels).set(report.p95)
            reg.gauge("serve_p99_seconds", **labels).set(report.p99)
