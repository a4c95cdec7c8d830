"""Experiment drivers reproducing the paper's evaluation methodology (§5).

* :func:`run_open_loop`  — Poisson-less deterministic open loop at a fixed
  invocation rate (the paper's throughput axis); p99 with the 60 s timeout
  clamp ("if one benchmark is timeout, we record its 99%-ile latency as 60s").
* :func:`run_closed_loop` — one in-flight invocation per client (the paper's
  co-location study, §5.3).
* :func:`cold_start_latency` — first-run minus second-run end-to-end latency
  (§5.4's definition).
* bandwidth utilisation = aggregate inter-node bytes moved / makespan —
  the achieved cluster-wide transfer rate the paper's §5.2 discussion uses.

Copy of ``repro/core/experiments.py`` for the PyTorch port, which imports
nothing of ``repro``; its code is the reference's, line for line, with no
departure.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .dag import Workflow
# percentile is re-exported here (public API); one implementation, shared
# with the serving layer (serve.py cannot import this module — it would
# close an import cycle via sim_systems).
from .serve import percentile, poisson_arrivals
from .sim import Env, all_of
from .sim_systems import SimSystem, make_system
from .simcluster import Cluster, SimConfig

__all__ = ["ExperimentResult", "run_open_loop", "run_closed_loop",
           "cold_start_latency", "percentile"]




@dataclass
class ExperimentResult:
    system: str
    workflow: str
    latencies: list[float] = field(default_factory=list)
    timeouts: int = 0
    makespan: float = 0.0
    internode_bytes: float = 0.0
    network_busy_time: float = 0.0
    cold_starts: int = 0

    @property
    def p99(self) -> float:
        return percentile(self.latencies, 99.0)

    @property
    def p50(self) -> float:
        return percentile(self.latencies, 50.0)

    @property
    def mean(self) -> float:
        return sum(self.latencies) / max(len(self.latencies), 1)

    @property
    def bandwidth_utilization(self) -> float:
        """Achieved aggregate transfer rate while the network is in use
        (B/s): application bytes / union-of-busy-intervals.  This is the
        paper's bandwidth-utilisation notion — how much of the cluster's
        aggregate capacity the data plane can actually exploit."""
        return self.internode_bytes / max(self.network_busy_time, 1e-9)

    def row(self) -> dict:
        return {
            "system": self.system, "workflow": self.workflow,
            "p50_s": round(self.p50, 3), "p99_s": round(self.p99, 3),
            "mean_s": round(self.mean, 3), "timeouts": self.timeouts,
            "bw_util_MBps": round(self.bandwidth_utilization / (1 << 20), 2),
            "cold_starts": self.cold_starts,
        }


def _collect(sys_: SimSystem, cluster: Cluster, cfg: SimConfig,
             makespan: float) -> ExperimentResult:
    res = ExperimentResult(system=sys_.name, workflow=sys_.wf.name)
    for inst in sys_.results:
        lat = inst.latency
        if not math.isfinite(lat) or lat > cfg.timeout:
            res.timeouts += 1
            lat = cfg.timeout
        res.latencies.append(lat)
    res.makespan = makespan
    res.internode_bytes = cluster.internode_bytes()
    res.network_busy_time = cluster.network.busy_time
    res.cold_starts = cluster.cold_starts()
    return res


def run_open_loop(system: str, wf: Workflow, *, rate_per_min: float,
                  n_invocations: int = 30,
                  cfg: SimConfig | None = None,
                  warm: bool = True,
                  poisson_seed: int | None = None,
                  spans=None) -> ExperimentResult:
    """Fire ``n_invocations`` at fixed inter-arrival 60/rate seconds, or —
    with ``poisson_seed`` — at deterministic Poisson arrivals of the same
    mean rate (the serving layer's open-loop arrival process).

    ``spans``: a DScope :class:`~repro.core.obs.Tracer` — rebound to the
    virtual clock — records request/invoke/acquire spans with ``env.now``
    durations (the warm throwaway's spans are cleared)."""
    cfg = cfg or SimConfig()
    env = Env()
    if spans is not None:
        spans.set_clock(lambda: env.now)
    cluster = Cluster(env, cfg)
    sys_ = make_system(system, env, cluster, wf, spans=spans)
    gap = 60.0 / rate_per_min
    if poisson_seed is None:
        gaps = [gap] * n_invocations
    else:
        arr = poisson_arrivals(rate_per_min / 60.0, n_invocations,
                               seed=poisson_seed)
        gaps = [b - a for a, b in zip([0.0] + arr[:-1], arr)]

    if warm:
        # One throwaway invocation to populate warm containers, as the
        # paper's steady-state latency experiments do.
        sys_.invoke()
        env.run(until=cfg.timeout + 5.0)
        sys_.results.clear()
        cluster.network.log.clear()
        cluster.network.busy_time = 0.0
        if spans is not None:
            spans.clear()

    def driver():
        for g in gaps:
            sys_.invoke()
            yield env.timeout(g)
    start = env.now
    env.process(driver())
    # Horizon from the ACTUAL last arrival (Poisson gap sums can exceed
    # gap*n by several sigma; a fixed-gap horizon would cut the tail off
    # and silently clamp its latencies to the timeout).
    horizon = start + sum(gaps) + cfg.timeout * 3
    env.run(until=horizon)
    return _collect(sys_, cluster, cfg, makespan=env.now - start)


def run_closed_loop(system: str, workflows: list[Workflow], *,
                    n_per_client: int = 8,
                    cfg: SimConfig | None = None) -> list[ExperimentResult]:
    """One client per workflow, next request only after the previous
    completes (paper §5.3 co-run when len(workflows)>1, solo otherwise)."""
    cfg = cfg or SimConfig()
    env = Env()
    cluster = Cluster(env, cfg)
    systems = [make_system(system, env, cluster, wf) for wf in workflows]

    def client(sys_: SimSystem):
        for _ in range(n_per_client):
            r = sys_.invoke()
            yield r.done
    procs = [env.process(client(s)) for s in systems]
    env.run(until=(cfg.timeout * n_per_client * 4))
    makespan = env.now
    return [_collect(s, cluster, cfg, makespan) for s in systems]


def cold_start_latency(system: str, wf: Workflow,
                       cfg: SimConfig | None = None) -> float:
    """First-run latency minus second-run latency (paper §5.4)."""
    cfg = cfg or SimConfig()
    env = Env()
    cluster = Cluster(env, cfg)
    sys_ = make_system(system, env, cluster, wf)
    r1 = sys_.invoke()
    env.run(until=cfg.timeout * 3)
    first = r1.latency
    r2 = sys_.invoke()
    env.run(until=env.now + cfg.timeout * 3)
    second = r2.latency
    return first - second
