"""DScale — autoscaling, admission control, and SLO-aware prewarm budgets.

DServe gave the serving layer explicit container pools, but left
three resource decisions unmade: pool capacity never moves, admission is
unbounded, and §3.2 prewarm is free.  DScale closes the loop:

* :class:`PoolAutoscaler` — an arrival-rate-estimating control loop over
  :class:`~repro.core.obs.MetricsRegistry` *rates* (arrival counters,
  ``serve_latency_seconds`` percentiles, ``containers_live``, DShard's
  per-node ``capacity_bytes`` / ``dstore_resident_bytes`` and per-tier
  ``tier_bytes``) — never private subsystem counters.  Each ``step(now)``
  derives a Little's-law target per (node, image) pool
  (``ceil(rate × service_time × headroom)``), applies it through a
  callback (:meth:`~repro.core.serve.ContainerService.set_target` in the
  threaded engine, the sim pool adapter under a virtual clock), and
  publishes every decision back as registry events
  (``autoscale_decisions_total`` / ``pool_target``) *and* tracer span
  instants (``kind="scale"``).  Clock-agnostic like ``ContainerPool``:
  callers supply ``now``.
* :class:`PrewarmBudget` — a token bucket of *container-seconds* that
  prices §3.2 prewarm instead of leaving it free.
  :func:`allocate_prewarms` spends it along DPlan's slack ranking:
  ``FunctionPlan.boot_at`` already prices each boot
  (``boot_cost = est − boot_at``), and slack ranks which boots are
  droppable — critical-path (slack 0) boots are granted first, so a
  tightening budget drops the highest-slack prewarms and the
  lowest-slack ones last (optimizing p99 per container-second).
* :func:`diurnal_arrivals` / :func:`bursty_arrivals` — deterministic
  inhomogeneous-Poisson arrival generators (Lewis thinning over the same
  seeded LCG as :func:`~repro.core.serve.poisson_arrivals`) for the
  trace shapes Triggerflow-style orchestration must survive.

Admission control itself (bounded FIFO queue + shedding) lives in
:class:`~repro.core.serve.DServe` (``max_inflight`` / ``queue_depth``);
this module supplies the policy objects it composes with.

Copy of ``repro/core/scale.py`` for the PyTorch port, which imports nothing
of ``repro``; its code is the reference's, line for line, with no departure
(the first sentence of this docstring is reworded).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Mapping, Sequence

__all__ = [
    "AutoscalerConfig", "PoolAutoscaler", "PoolSpec", "ScaleDecision",
    "RateEstimator", "PrewarmBudget", "PrewarmGrant", "allocate_prewarms",
    "diurnal_arrivals", "bursty_arrivals",
]


# ----------------------------------------------------------------------
# Arrival generators (deterministic; no global RNG)
# ----------------------------------------------------------------------

def _lcg(seed: int) -> Iterator[float]:
    """The project's seeded LCG as a (0, 1) uniform stream — same
    constants as :func:`~repro.core.serve.poisson_arrivals`."""
    s = (seed * 2654435761 + 0x9E3779B9) & 0xFFFFFFFF
    while True:
        s = (1103515245 * s + 12345) & 0x7FFFFFFF
        yield (s + 1) / (0x7FFFFFFF + 2)


def _thinned_arrivals(n: int, rate_fn: Callable[[float], float],
                      rate_max: float, seed: int) -> list[float]:
    """Lewis thinning: candidate arrivals at ``rate_max``, accepted with
    probability ``rate_fn(t) / rate_max`` — an exact inhomogeneous
    Poisson process, deterministic per seed."""
    u = _lcg(seed)
    t, out = 0.0, []
    while len(out) < n:
        t += -math.log(next(u)) / rate_max
        if next(u) * rate_max <= rate_fn(t):
            out.append(t)
    return out


def diurnal_arrivals(n: int, *, base_rate: float, peak_rate: float,
                     period: float = 60.0, seed: int = 0) -> list[float]:
    """Diurnal (sinusoidal) arrivals: the rate swings from ``base_rate``
    (t=0 is the trough) up to ``peak_rate`` and back once per ``period``
    seconds — a compressed day/night load curve."""
    if base_rate <= 0 or peak_rate < base_rate or period <= 0:
        raise ValueError("need 0 < base_rate <= peak_rate and period > 0")

    def rate(t: float) -> float:
        swing = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / period))
        return base_rate + (peak_rate - base_rate) * swing

    return _thinned_arrivals(n, rate, peak_rate, seed)


def bursty_arrivals(n: int, *, base_rate: float, burst_rate: float,
                    burst_every: float, burst_len: float,
                    seed: int = 0) -> list[float]:
    """Bursty arrivals: ``burst_rate`` for the first ``burst_len`` seconds
    of every ``burst_every``-second cycle (bursts start at t=0), trickling
    at ``base_rate`` in between — the on/off trace shape that punishes
    fixed pools (idle burn) and pure keep-alive (cold re-boots)."""
    if base_rate <= 0 or burst_rate < base_rate:
        raise ValueError("need 0 < base_rate <= burst_rate")
    if not 0 < burst_len < burst_every:
        raise ValueError("need 0 < burst_len < burst_every")

    def rate(t: float) -> float:
        return burst_rate if (t % burst_every) < burst_len else base_rate

    return _thinned_arrivals(n, rate, burst_rate, seed)


# ----------------------------------------------------------------------
# Prewarm budget (container-seconds, allocated by DPlan slack)
# ----------------------------------------------------------------------

@dataclass
class PrewarmGrant:
    """One admitted prewarm: ``cost`` container-seconds were debited for
    booting ``function`` ahead of need.  ``settle`` at fire time (a
    revoked grant must not boot), ``cancel`` refunds an unfired grant."""

    function: str
    cost: float
    slack: float
    fired: bool = False
    revoked: bool = False
    refunded: bool = False


class PrewarmBudget:
    """Token bucket of prewarm container-seconds (clock-agnostic).

    Prewarm is free in the §3.2 heuristic; a real cluster pays for every
    second a container idles ahead of its function.  The bucket starts at
    ``capacity_s`` and refills at ``refill_per_s`` (0 = one-shot budget);
    time is whatever clock the caller runs on (wall or virtual) —
    ``available``/``request`` take ``now`` and refill lazily.

    Grants are revocable until they fire: :meth:`reclaim` revokes pending
    grants **highest slack first** (slack ranks droppability — DPlan's
    critical-path boots go last), and a scheduler arming prewarm timers
    must :meth:`settle` each grant at fire time and skip the boot when it
    returns False.
    """

    def __init__(self, capacity_s: float, *, refill_per_s: float = 0.0):
        if capacity_s < 0 or refill_per_s < 0:
            raise ValueError("capacity_s and refill_per_s must be >= 0")
        self.capacity = float(capacity_s)
        self.refill_per_s = float(refill_per_s)
        self._tokens = float(capacity_s)
        self._last: float | None = None
        self._pending: list[PrewarmGrant] = []
        self._lock = threading.Lock()
        self.granted = 0
        self.denied = 0
        self.revoked = 0
        self.spent_s = 0.0

    def _refill(self, now: float) -> None:
        if self._last is not None and now > self._last \
                and self.refill_per_s > 0:
            self._tokens = min(self.capacity, self._tokens +
                               (now - self._last) * self.refill_per_s)
        self._last = now if self._last is None else max(self._last, now)

    def available(self, now: float) -> float:
        with self._lock:
            self._refill(now)
            return self._tokens

    def request(self, function: str, cost: float, *, slack: float = 0.0,
                now: float = 0.0) -> PrewarmGrant | None:
        """Debit ``cost`` container-seconds for one prewarm; None = the
        budget is exhausted and the boot must be dropped."""
        cost = max(0.0, float(cost))
        with self._lock:
            self._refill(now)
            if cost > self._tokens + 1e-12:
                self.denied += 1
                return None
            self._tokens -= cost
            self.spent_s += cost
            grant = PrewarmGrant(function=function, cost=cost, slack=slack)
            self._pending.append(grant)
            self.granted += 1
            return grant

    def settle(self, grant: PrewarmGrant) -> bool:
        """Consume the grant at fire time; False = it was revoked (the
        timer must not boot)."""
        with self._lock:
            if grant in self._pending:
                self._pending.remove(grant)
            if grant.revoked:
                return False
            grant.fired = True
            return True

    def cancel(self, grant: PrewarmGrant) -> None:
        """Refund an unfired grant (instance finished / was evicted
        before its timer fired).  Also revokes it, so a timer racing the
        cancellation sees ``settle`` fail and never boots."""
        with self._lock:
            if grant.fired or grant.revoked or grant.refunded:
                return
            grant.refunded = True
            grant.revoked = True
            if grant in self._pending:
                self._pending.remove(grant)
            self._tokens = min(self.capacity, self._tokens + grant.cost)
            self.spent_s -= grant.cost

    def refund(self, grant: PrewarmGrant) -> None:
        """Refund a settled grant whose boot turned out to be a no-op
        (an idle/booting container already existed)."""
        with self._lock:
            if grant.refunded:
                return
            grant.refunded = True
            self._tokens = min(self.capacity, self._tokens + grant.cost)
            self.spent_s -= grant.cost

    def reclaim(self, seconds: float, now: float) -> list[PrewarmGrant]:
        """Revoke pending (unfired) grants until at least ``seconds``
        container-seconds are recovered — highest slack first, so
        critical-path boots survive the squeeze."""
        out: list[PrewarmGrant] = []
        with self._lock:
            self._refill(now)
            reclaimed = 0.0
            for grant in sorted(self._pending, key=lambda g: -g.slack):
                if reclaimed >= seconds:
                    break
                grant.revoked = True
                self._pending.remove(grant)
                self._tokens = min(self.capacity,
                                   self._tokens + grant.cost)
                self.spent_s -= grant.cost
                reclaimed += grant.cost
                self.revoked += 1
                out.append(grant)
        return out


def allocate_prewarms(plan, budget: PrewarmBudget | None,
                      now: float = 0.0) -> list[tuple]:
    """Spend a prewarm budget along DPlan's slack ranking.

    Grants are requested **lowest slack first** (critical-path boots are
    the ones a p99-per-container-second optimizer can least afford to
    drop), each priced at :attr:`~repro.core.plan.FunctionPlan.boot_cost`
    — the container-seconds the boot spends ahead of the function's
    earliest start.  Denied entries are dropped; the survivors come back
    in boot order as ``(function, boot_at, cold_start, grant)`` rows
    (``grant`` is None when no budget applies).
    """
    entries = sorted(
        plan.prewarm_schedule,
        key=lambda e: (plan.functions[e[0]].slack, e[1], e[0]))
    out = []
    for fname, boot_at, cold in entries:
        fp = plan.functions[fname]
        if budget is None:
            out.append((fname, boot_at, cold, None))
            continue
        grant = budget.request(fname, fp.boot_cost, slack=fp.slack,
                               now=now)
        if grant is not None:
            out.append((fname, boot_at, cold, grant))
    out.sort(key=lambda e: (e[1], e[0]))
    return out


# ----------------------------------------------------------------------
# Arrival-rate estimation + pool autoscaler
# ----------------------------------------------------------------------

class RateEstimator:
    """Windowed rate from samples of a monotonic counter: ``observe(now,
    total)`` then ``rate()`` = counter delta / time span over the last
    ``window`` seconds.  Clock-agnostic and cheap (a short deque)."""

    def __init__(self, window: float = 1.0):
        if window <= 0:
            raise ValueError("window must be > 0")
        self.window = float(window)
        self._samples: list[tuple[float, float]] = []

    def observe(self, now: float, total: float) -> None:
        self._samples.append((now, total))
        cutoff = now - self.window
        # Keep one sample at/just before the cutoff so the span covers
        # the full window once enough history exists.
        while len(self._samples) > 2 and self._samples[1][0] <= cutoff:
            self._samples.pop(0)

    def rate(self) -> float:
        if len(self._samples) < 2:
            return 0.0
        (t0, c0), (t1, c1) = self._samples[0], self._samples[-1]
        span = t1 - t0
        if span <= 0:
            return 0.0
        # A short history still divides by the full window: two samples
        # 50 ms apart do not evidence a 20x sustained rate.
        return max(0.0, c1 - c0) / max(span, self.window)


@dataclass(frozen=True)
class PoolSpec:
    """One scalable pool: the (node, image) identity plus what the
    autoscaler needs to size it (mean service time, boot cost)."""

    node: str
    image: str
    service_time: float
    cold_start: float = 0.5


@dataclass(frozen=True)
class AutoscalerConfig:
    interval: float = 0.1            # control-loop period (threaded mode)
    window: float = 1.0              # rate-estimation window (seconds)
    headroom: float = 1.5            # target = ceil(rate*service*headroom)
    min_pool: int = 0
    max_pool: int = 64
    scale_down_delay: float = 0.5    # sustain low demand before shrinking
    slo_p99: float | None = None     # latency SLO: p99 above it bumps +1
    mem_pressure: float = 0.9        # resident/capacity gate for scale-up


@dataclass(frozen=True)
class ScaleDecision:
    at: float
    node: str
    image: str
    previous: int | None
    target: int
    rate: float
    reason: str


class PoolAutoscaler:
    """Arrival-rate-estimating autoscaler over registry rates.

    Sensors (all read from the :class:`~repro.core.obs.MetricsRegistry`;
    the autoscaler owns no private counters):

    * ``serve_arrivals_total``  — workload demand (rate estimation).
    * ``serve_latency_seconds`` — p99 vs the optional SLO (pressure bump).
    * ``containers_live``       — published per (node, image) by the pool
      collector; decisions are diffed against it for observability.
    * ``capacity_bytes`` / ``dstore_resident_bytes`` (DShard, per node) —
      a memory-bound node (utilization > ``mem_pressure``) refuses
      scale-up: more containers would worsen the pressure.
    * ``tier_bytes`` (DShard, per tier) — the network-bound share is
      attached to each decision so operators can tell *why* a node
      saturated.

    Actuation goes through ``apply(node, image, target, cold_start)``
    (``ContainerService.set_target`` threaded, the sim adapter under a
    virtual clock), and every decision is published twice: registry
    events (``autoscale_decisions_total{direction=...}`` counters +
    ``pool_target`` gauges) and tracer span instants (``kind="scale"``).
    """

    def __init__(self, registry, pools: Sequence[PoolSpec], *,
                 cfg: AutoscalerConfig | None = None,
                 apply: Callable[..., Any] | None = None,
                 spans=None,
                 arrivals_metric: str = "serve_arrivals_total",
                 arrivals_labels: Mapping[str, Any] | None = None):
        self.registry = registry
        self.pools = list(pools)
        self.cfg = cfg or AutoscalerConfig()
        self.apply = apply
        self.spans = spans
        self.arrivals_metric = arrivals_metric
        self.arrivals_labels = dict(arrivals_labels or {})
        self._rate = RateEstimator(self.cfg.window)
        self._targets: dict[tuple[str, str], int] = {}
        self._low_since: dict[tuple[str, str], float] = {}
        self.decisions: list[ScaleDecision] = []
        self._lock = threading.Lock()

    # -- sensors -----------------------------------------------------------
    def _arrivals_total(self) -> float:
        reg = self.registry
        if self.arrivals_labels:
            return reg.counter(self.arrivals_metric,
                               **self.arrivals_labels).value
        return reg.total(self.arrivals_metric)

    def _p99(self) -> float:
        h = self.registry.histogram("serve_latency_seconds",
                                    **self.arrivals_labels)
        return h.percentile(99.0) if h.count else math.nan

    def _node_mem_utilization(self) -> dict[str, float]:
        reg = self.registry
        cap = reg.label_values("capacity_bytes", "node")
        res = reg.label_values("dstore_resident_bytes", "node")
        return {n: res.get(n, 0.0) / c for n, c in cap.items() if c > 0}

    def _net_share(self) -> float:
        tiers = self.registry.label_values("tier_bytes", "tier")
        total = sum(tiers.values())
        return tiers.get("net", 0.0) / total if total > 0 else 0.0

    # -- control loop ------------------------------------------------------
    def step(self, now: float) -> list[ScaleDecision]:
        """One control iteration at ``now`` (clock-agnostic): refresh the
        pull collectors, estimate the arrival rate, and re-target every
        pool.  Returns the decisions taken this step."""
        cfg = self.cfg
        with self._lock:
            self.registry.collect()
            self._rate.observe(now, self._arrivals_total())
            rate = self._rate.rate()
            p99 = self._p99()
            slo_bump = 1 if (cfg.slo_p99 is not None
                             and not math.isnan(p99)
                             and p99 > cfg.slo_p99) else 0
            mem_util = self._node_mem_utilization()
            net_share = self._net_share()
            out: list[ScaleDecision] = []
            for spec in self.pools:
                key = (spec.node, spec.image)
                desired = 0
                if rate > 0:
                    desired = math.ceil(
                        rate * max(spec.service_time, 0.0) * cfg.headroom
                        - 1e-9) + slo_bump
                desired = max(cfg.min_pool, min(cfg.max_pool, desired))
                current = self._targets.get(key)
                reason = "rate"
                if current is not None and desired > current \
                        and mem_util.get(spec.node, 0.0) > cfg.mem_pressure:
                    # Memory-bound node: adding containers would deepen
                    # the pressure; hold (a held pool produces no decision,
                    # so the hold itself is published as a counter).
                    self.registry.counter(
                        "autoscale_mem_holds_total", node=spec.node,
                        image=spec.image).inc()
                    desired = current
                if current is not None and desired < current:
                    # Hysteresis: only shrink after sustained low demand.
                    since = self._low_since.setdefault(key, now)
                    if now - since < cfg.scale_down_delay:
                        continue
                    reason = "idle"
                else:
                    self._low_since.pop(key, None)
                if desired == current:
                    continue
                if current is None and desired == 0:
                    # No rate evidence yet: pinning a fresh pool to zero
                    # would evict idles before any demand was seen.
                    continue
                self._low_since.pop(key, None)
                self._targets[key] = desired
                if self.apply is not None:
                    self.apply(spec.node, spec.image, desired,
                               spec.cold_start)
                d = ScaleDecision(at=now, node=spec.node, image=spec.image,
                                  previous=current, target=desired,
                                  rate=rate, reason=reason)
                out.append(d)
                self.decisions.append(d)
                self._publish(d, net_share)
            self.registry.counter("autoscale_steps_total").inc()
        return out

    def _publish(self, d: ScaleDecision, net_share: float) -> None:
        reg = self.registry
        direction = "up" if d.previous is None or d.target > d.previous \
            else "down"
        reg.counter("autoscale_decisions_total", node=d.node,
                    image=d.image, direction=direction).inc()
        reg.gauge("pool_target", node=d.node, image=d.image).set(d.target)
        live = reg.gauge("containers_live", node=d.node,
                         image=d.image).value
        if self.spans is not None:
            self.spans.event(
                d.image, kind="scale", parent=None, trace="autoscaler",
                node=d.node, direction=direction, target=d.target,
                previous=d.previous, rate=round(d.rate, 3),
                reason=d.reason, containers_live=live,
                net_share=round(net_share, 3))

    def target(self, node: str, image: str) -> int | None:
        with self._lock:
            return self._targets.get((node, image))
