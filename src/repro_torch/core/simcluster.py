"""Simulated FaaS cluster: nodes, cores, container pools, messaging.

Models the paper's testbed (§5.1): 8 × ecs.g7.2xlarge (8 vCPU, 32 GB),
functions run in 1-core/256 MB containers, link bandwidth shaped with
wondershaper to 25–100 MB/s.  All constants live in :class:`SimConfig` so
experiments can sweep them; defaults are calibrated to the paper's setup.

Copy of ``repro/core/simcluster.py`` for the PyTorch port, which imports
nothing of ``repro``; its code is the reference's, line for line, with no
departure.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .serve import ContainerPool
from .sim import Env, Event, Network, Resource

__all__ = ["SimConfig", "Node", "Cluster", "MASTER"]

MASTER = "master"


@dataclass(frozen=True)
class SimConfig:
    """All knobs of the simulated cluster + data planes (SI units: s, B)."""

    n_workers: int = 7                    # + 1 master = paper's 8 nodes
    cores_per_node: int = 8               # ecs.g7.2xlarge vCPUs
    bandwidth: float = 50e6               # per-node link, B/s (wondershaper)
    msg_latency: float = 0.5e-3           # LAN RTT for control messages
    meta_write: float = 150e-6            # paper §3.3.1: ~150 us
    meta_query: float = 150e-6            # directory lookup service time
    local_bw: float = 1.5e9               # container<->local-store memcpy/gRPC
    local_op: float = 0.3e-3              # per-op local store overhead
    # Central-store per-op overheads (request handling, (de)serialisation).
    couch_op: float = 15e-3               # CouchDB HTTP + disk commit
    couch_bw_eff: float = 0.6             # CouchDB effective wire efficiency
    redis_op: float = 1.0e-3              # Redis RESP overhead
    redis_bw_eff: float = 0.95
    stream_chunk: float = 1e6             # DStream chunk size (B)
    cold_start: float = 0.8               # container cold boot (docker run)
    keepalive: float = 600.0              # warm-container TTL (paper: 600 s)
    knix_process_start: float = 0.02      # KNIX in-container process fork
    max_containers: int = 96              # 32GB / 256MB, with headroom
    timeout: float = 60.0                 # experiment timeout (paper: 60 s)
    # DShard transport tiers (router.py / ShardedDStorePlane): routed Gets
    # resolve against a node-local table and hand bytes over the cheapest
    # applicable tier instead of the uniform local_op/local_bw gRPC path.
    route_lookup: float = 2e-6            # local routing-table lookup
    ipc_latency: float = 5e-6             # same-container handoff (ipc tier)
    mem_op: float = 60e-6                 # same-node memoryview op (mem tier)
    mem_bw: float = 8e9                   # same-node shared-memory bandwidth

    def worker_names(self) -> list[str]:
        return [f"node{i + 1}" for i in range(self.n_workers)]

    def all_names(self) -> list[str]:
        return [MASTER] + self.worker_names()


class _SimLease:
    """Virtual-clock lease handle: delivered as the ``acquire`` event's
    value, so a sim process writes ``lease = yield pool.acquire()`` and
    later ``lease.release()`` — returning the *specific* leased container
    (the simulator twin of :class:`repro.core.serve.Lease`)."""

    __slots__ = ("_pool", "lease")

    def __init__(self, pool: "_ContainerPool", lease):
        self._pool = pool
        self.lease = lease

    @property
    def cold(self) -> bool:
        return self.lease.cold

    @property
    def delay(self) -> float:
        return self.lease.delay

    def release(self) -> None:
        p = self._pool
        p.model.release(self.lease, p.env.now)
        p._reconcile_cap()


class _ContainerPool:
    """Container pool for one (node, function-image) pair — a virtual-clock
    adapter over the shared lifecycle model
    (:class:`repro.core.serve.ContainerPool`), so the simulator and the
    threaded serving layer share one implementation of cold boot, warm
    reuse, keep-alive TTL eviction, prewarm, and the derived metrics.

    ``acquire`` returns an event that triggers — after the startup delay:
    0 for a warm hit, the residual boot time when joining a container that
    is already booting (a prewarm in flight), ``cold_start`` otherwise —
    with a :class:`_SimLease` pinning *which* container was leased (the
    same lease-token discipline as the threaded engine; releasing "some
    busy container" corrupts idle_since/TTL accounting).  Booted
    containers hold one slot of the node's container capacity until TTL
    eviction reclaims it.
    """

    def __init__(self, env: Env, cold_start: float, cap: Resource,
                 keepalive: float = 600.0):
        self.env = env
        self.cap = cap
        self.model = ContainerPool(cold_start=cold_start,
                                   keepalive=keepalive)
        self._cap_released = 0

    # -- back-compat metrics/state ---------------------------------------
    @property
    def cold_starts(self) -> int:
        """Total container boots (request-path + prewarm), the paper's
        cold-start count metric."""
        return self.model.boots

    @property
    def warm(self) -> int:
        """Idle containers ready right now."""
        return self.model.idle_count(self.env.now)

    @property
    def available(self) -> int:
        """Idle containers including ones still booting (joinable)."""
        return self.model.available(self.env.now)

    def _reconcile_cap(self) -> None:
        """Release node capacity for containers the model TTL-evicted."""
        while self._cap_released < self.model.evictions:
            self._cap_released += 1
            self.cap.release()

    # -- lifecycle --------------------------------------------------------
    def acquire(self):
        lease = self.model.try_acquire_warm(self.env.now)
        self._reconcile_cap()
        if lease is not None:
            return self.env.timeout(lease.delay, _SimLease(self, lease))
        done = self.env.event()

        def boot(_):
            boots_before = self.model.boots
            lease = self.model.acquire(self.env.now)
            if self.model.boots == boots_before:
                # A container became idle while we were queued on capacity:
                # no new boot happened, so hand the slot straight back
                # (otherwise the node's effective capacity leaks away).
                self.cap.release()
            self._reconcile_cap()
            self.env._at(self.env.now + lease.delay, done.trigger,
                         _SimLease(self, lease))
        self.cap.acquire().add_waiter(boot)
        return done

    def set_target(self, target: int | None) -> tuple[int, int]:
        """DScale autoscaler hook (virtual clock): pin the pool's live
        target, booting up to it within the node's container capacity and
        releasing capacity for early-reclaimed idles."""
        if target is not None:
            # Scale-up boots consume node capacity like any other boot;
            # clamp to what the capacity Resource can grant right now.
            room = self.cap.capacity - self.cap.in_use
            target_now = min(int(target), self.model.live() + max(0, room))
            booted, _ = self.model.set_target(target_now, self.env.now)
            self.model.target = int(target)
            for _ in range(booted):
                self.cap.acquire()
        else:
            self.model.set_target(None, self.env.now)
        self._reconcile_cap()
        return (0, 0)

    def prewarm(self) -> Event:
        """Boot one container ahead of need; triggers when one is ready.
        No-op (beyond waiting) if an idle or booting container exists."""
        done = self.env.event()
        if self.model.available(self.env.now) > 0:
            d = self.model.prewarm(self.env.now)     # joins existing boot
            self._reconcile_cap()
            self.env._at(self.env.now + d, done.trigger, None)
            return done

        def boot(_):
            boots_before = self.model.boots
            d = self.model.prewarm(self.env.now)
            if self.model.boots == boots_before:
                self.cap.release()          # idle appeared while queued
            self._reconcile_cap()
            self.env._at(self.env.now + d, done.trigger, None)
        self.cap.acquire().add_waiter(boot)
        return done


class Node:
    def __init__(self, env: Env, name: str, cfg: SimConfig):
        self.env = env
        self.name = name
        self.cfg = cfg
        self.cores = Resource(env, cfg.cores_per_node)
        self.container_cap = Resource(env, cfg.max_containers)
        self._pools: dict[str, _ContainerPool] = {}

    def pool(self, image: str, cold_start: float | None = None) -> _ContainerPool:
        p = self._pools.get(image)
        if p is None:
            p = _ContainerPool(
                self.env,
                self.cfg.cold_start if cold_start is None else cold_start,
                self.container_cap, keepalive=self.cfg.keepalive)
            self._pools[image] = p
        return p

    @property
    def total_cold_starts(self) -> int:
        return sum(p.cold_starts for p in self._pools.values())


class Cluster:
    """Nodes + fluid network + control-message helper."""

    def __init__(self, env: Env, cfg: SimConfig):
        self.env = env
        self.cfg = cfg
        names = cfg.all_names()
        self.nodes = {n: Node(env, n, cfg) for n in names}
        bw = {n: cfg.bandwidth for n in names}
        self.network = Network(env, uplink=dict(bw), downlink=dict(bw),
                               latency=cfg.msg_latency)

    def workers(self) -> list[str]:
        return self.cfg.worker_names()

    def message(self, src: str, dst: str) -> Event:
        """Small control message (invocation / completion notify)."""
        if src == dst:
            return self.env.timeout(0.0)
        return self.env.timeout(self.cfg.msg_latency)

    def local_copy(self, size: float) -> Event:
        """Container <-> local store copy (gRPC over loopback / memcpy)."""
        return self.env.timeout(self.cfg.local_op + size / self.cfg.local_bw)

    # -- metrics ---------------------------------------------------------
    def internode_bytes(self) -> float:
        return sum(entry[2] for entry in self.network.log)

    def cold_starts(self) -> int:
        return sum(n.total_cold_starts for n in self.nodes.values())
