"""Simulated data planes: DStore and the baseline stores (paper §3.3, §5).

Every plane implements the same three-call protocol, namespaced per workflow
instance so concurrent invocations never collide (DStore data is immutable —
"updated data must be stored with a new unique identifier", §3.3):

* ``seed(node, key, size)``      — stage an external workflow input.
* ``put(node, key, size, consumers)``  — producer stores one output.
  Returns an Event for *producer-side completion* (when the producer's
  container may be released).
* ``get(node, key)``             — consumer obtains the bytes into its
  container on ``node``.  Returns an Event triggered when the copy is done.

Planes:

* :class:`DStorePlane`   — the paper's DStore: per-node local stores, a
  metadata-only data directory service with **auto blocking/waking-up**,
  **receiver-driven** node-to-node transfers, and **least-access-frequency
  replica selection**.  ``put`` is local (the producer frees its container
  immediately, §3.4) and the metadata publish is asynchronous.
* :class:`CentralPlane`  — CFlow: every byte goes through a store on the
  master (CouchDB by default) — both puts and gets traverse the master's
  links, which is exactly the contention bottleneck the paper measures.
* :class:`HybridPlane`   — FaaSFlow / FaaSFlowRedis / KNIX: local Redis for
  intra-node exchange + a central store (CouchDB or Redis) on the master for
  inter-node exchange.
* :class:`ShardedDStorePlane` — DStore + **DShard** (beyond-paper,
  router.py): per-node directory shards + local routing tables — Gets
  resolve 1-hop at the producing node's shard, and same-container (ipc) /
  same-node (mem) / cross-node (net) transport tiers are priced
  distinctly.
* :class:`StreamingDStorePlane` — DStore + **DStream** (beyond-paper):
  producers publish fixed-size chunks *while executing* and consumers pull
  chunk-by-chunk, so inter-node transfer overlaps output production.
  Extra protocol: ``put_stream(..., produce_time)`` / ``get_stream``.

Copy of ``repro/core/sim_dataplane.py`` for the PyTorch port, which imports
nothing of ``repro``; its code is the reference's, line for line, with no
departure.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable

from .router import TIER_IPC, TIER_MEM, TIER_NET
from .sim import Env, Event, all_of
from .simcluster import MASTER, Cluster, SimConfig

__all__ = ["DStorePlane", "ShardedDStorePlane", "StreamingDStorePlane",
           "CentralPlane", "HybridPlane", "DataMeta"]


@dataclass
class DataMeta:
    """Directory-service record (paper §3.3.1)."""

    key: str
    size: float
    locations: dict[str, int] = field(default_factory=dict)  # node -> access freq

    def best_location(self) -> str:
        # Receiver-driven replica choice: lowest access frequency (§3.3.1).
        return min(self.locations.items(), key=lambda kv: (kv[1], kv[0]))[0]


def _strip_sim_ns(key: str) -> str:
    """Simulator key "<wf>#<i>:<key>" -> raw workflow key."""
    return key.split(":", 1)[1] if ":" in key else key


class DStorePlane:
    """The paper's DStore over the simulated cluster."""

    name = "dstore"

    def __init__(self, env: Env, cluster: Cluster):
        self.env = env
        self.cluster = cluster
        self.cfg = cluster.cfg
        self.meta: dict[str, DataMeta] = {}
        self._waiters: dict[str, list[Event]] = {}
        self.local: dict[str, set[str]] = {n: set() for n in cluster.nodes}
        self.sizes: dict[str, float] = {}   # producer-side truth (local hits
        # may race the async 150us metadata publish; the local store knows
        # its own object sizes without consulting the directory)
        self.fetched_bytes = 0.0
        # DPlan transfer pricing: when a WorkflowPlan is attached, every
        # put/seed prices its key from the static transfer matrix instead
        # of the dynamic caller-supplied size.  ``key_of`` maps simulator
        # keys ("<wf>#<i>:<key>") back to plan keys.
        self.plan = None
        self.key_of = _strip_sim_ns
        self.plan_priced = 0            # puts priced from the plan matrix

    def _planned_size(self, key: str, size: float) -> float:
        if self.plan is None:
            return size
        ps = self.plan.key_size(self.key_of(key))
        if ps is None:
            return size
        self.plan_priced += 1
        return float(ps)

    # -- helpers ---------------------------------------------------------
    def _publish(self, key: str, size: float, node: str) -> None:
        """Async metadata write (≈150 us) then wake blocked consumers."""
        def write(_):
            m = self.meta.get(key)
            if m is None:
                m = self.meta[key] = DataMeta(key, size)
            m.locations.setdefault(node, 0)
            for ev in self._waiters.pop(key, []):
                ev.trigger(m)
        self.env._at(self.env.now + self.cfg.meta_write, write)

    def seed(self, node: str, key: str, size: float) -> None:
        size = self._planned_size(key, size)
        self.local[node].add(key)
        self.sizes[key] = size
        m = self.meta.setdefault(key, DataMeta(key, size))
        m.locations.setdefault(node, 0)

    # -- producer ----------------------------------------------------------
    def put(self, node: str, key: str, size: float,
            consumers: Iterable[str] = (),
            ref_node: str | None = None) -> Event:
        done = self.env.event()
        size = self._planned_size(key, size)
        self.sizes[key] = size

        def copied(_):
            self.local[node].add(key)
            self._publish(key, size, node)   # async: does not block producer
            done.trigger(None)
        self.cluster.local_copy(size).add_waiter(copied)
        return done

    # -- consumer ----------------------------------------------------------
    def get(self, node: str, key: str) -> Event:
        return self.env.process(self._get(node, key))

    def _get(self, node: str, key: str):
        cfg = self.cfg
        # 1. local-store hit: just copy into the container (paper step 5B/6C).
        if key in self.local[node]:
            size = self.sizes[key]
            yield self.cluster.local_copy(size)
            return size
        # 2. query directory service on the master (round trip + service).
        yield self.env.timeout(cfg.msg_latency + cfg.meta_query)
        m = self.meta.get(key)
        if m is None:
            # 3. auto-block until the producer publishes (paper §3.3.2).
            ev = self.env.event()
            self._waiters.setdefault(key, []).append(ev)
            m = yield ev
        if key not in self.local[node]:
            # 4. receiver-driven pull from least-loaded replica (§3.3.4).
            src = m.best_location()
            m.locations[src] += 1
            yield self.cluster.network.transfer(src, node, m.size,
                                                tag=f"dstore:{key}")
            m.locations[src] -= 1
            self.fetched_bytes += m.size
            self.local[node].add(key)
            m.locations.setdefault(node, 0)   # new replica registered
        # 5. local store -> container copy.
        yield self.cluster.local_copy(m.size)
        return m.size


class ShardedDStorePlane(DStorePlane):
    """DStore + DShard (router.py): per-node directory shards behind local
    routing tables, with the three transport tiers priced distinctly.

    Differences from the base plane, mirroring the threaded
    :class:`~repro.core.router.ShardedDStore`:

    * a Get that misses locally pays a node-local ``route_lookup`` (no
      master round trip) and contacts the key's home shard directly —
      one one-way message + the shard's directory service time (1 hop);
      only an *unrouted* key falls back to the master directory bounce
      (2 hops, counted in ``hop_hist``);
    * local hits are tiered: a key homed on the consumer's own node (its
      trigger payload or own output) is an ``ipc`` handoff; a local
      replica of a remotely-homed key is a ``mem`` memoryview handoff
      (``mem_op`` + size/``mem_bw``) — both cheaper than the base plane's
      uniform gRPC ``local_op``/``local_bw`` copy;
    * the final store→container copy after a network pull also rides the
      ``mem`` tier (the pull landed the bytes in this node's shard).

    Routes are installed by ``SimSystem`` from the same
    :func:`~repro.core.router.static_routes` the threaded store uses.
    """

    name = "dstore-shard"

    def __init__(self, env: Env, cluster: Cluster):
        super().__init__(env, cluster)
        self.routes: dict[str, str] = {}       # raw key -> home node
        self.seeded: dict[str, str] = {}       # sim key -> staging node
        self.hop_hist: dict[int, int] = {0: 0, 1: 0, 2: 0}
        self.tier_gets = {TIER_IPC: 0, TIER_MEM: 0, TIER_NET: 0}
        self.tier_bytes = {TIER_IPC: 0.0, TIER_MEM: 0.0, TIER_NET: 0.0}

    def install_routes(self, routes: dict[str, str]) -> None:
        self.routes.update(routes)

    def route_of(self, key: str) -> str | None:
        return self.routes.get(self.key_of(key))

    def seed(self, node: str, key: str, size: float) -> None:
        super().seed(node, key, size)
        self.seeded.setdefault(key, node)

    def put(self, node: str, key: str, size: float,
            consumers: Iterable[str] = (),
            ref_node: str | None = None) -> Event:
        # Dynamic registration: un-routed keys home on their writer.
        self.routes.setdefault(self.key_of(key), node)
        return super().put(node, key, size, consumers, ref_node)

    def _tiered(self, tier: str, size: float) -> None:
        self.tier_gets[tier] += 1
        self.tier_bytes[tier] += size

    def _get(self, node: str, key: str):
        cfg = self.cfg
        if key in self.local[node]:
            size = self.sizes[key]
            if self.seeded.get(key) == node or self.route_of(key) == node:
                # Same-container: the payload is already inside (ipc).
                yield self.env.timeout(cfg.ipc_latency)
                self._tiered(TIER_IPC, size)
            else:
                # Same-node replica: memoryview handoff, no gRPC copy.
                yield self.env.timeout(cfg.mem_op + size / cfg.mem_bw)
                self._tiered(TIER_MEM, size)
            self.hop_hist[0] += 1
            return size
        # Node-local routing table (no master round trip).
        yield self.env.timeout(cfg.route_lookup)
        home = self.route_of(key)
        if home is None:
            # Unrouted key: master directory bounce — 2 hops, the exact
            # resolution the trace checker flags on the threaded path.
            yield self.env.timeout(cfg.msg_latency + cfg.meta_query)
            hops = 2
        else:
            # Direct request to the home shard: one-way message (none if
            # the home is this node) + its directory service time.
            extra = 0.0 if home == node else cfg.msg_latency / 2
            yield self.env.timeout(extra + cfg.meta_query)
            hops = 1
        m = self.meta.get(key)
        if m is None:
            ev = self.env.event()
            self._waiters.setdefault(key, []).append(ev)
            m = yield ev
        if key not in self.local[node]:
            src = m.best_location()
            m.locations[src] += 1
            yield self.cluster.network.transfer(src, node, m.size,
                                                tag=f"dshard:{key}")
            m.locations[src] -= 1
            self.fetched_bytes += m.size
            self.local[node].add(key)
            m.locations.setdefault(node, 0)
            self._tiered(TIER_NET, m.size)
        else:
            self._tiered(TIER_MEM, m.size)
        self.hop_hist[hops] = self.hop_hist.get(hops, 0) + 1
        # Shard store -> container over the mem tier (bytes are node-local
        # now; no gRPC re-serialisation).
        yield self.env.timeout(cfg.mem_op + m.size / cfg.mem_bw)
        return m.size


@dataclass
class _SimStream:
    """Stream-directory record: per-chunk metadata lives in per-chunk
    :class:`DataMeta` entries; this holds the stream-level shape."""

    key: str
    size: float
    n_chunks: int
    chunk: float                     # uniform chunk size (= size / n_chunks)


class StreamingDStorePlane(DStorePlane):
    """DStore + DStream: chunked pipelined exchange (beyond-paper).

    ``put_stream`` is called when the producer *starts* executing: it
    registers the stream in the directory (waking consumers blocked on the
    stream announcement) and then publishes fixed-size chunks paced
    uniformly across the producer's execution time — each chunk gets its
    own :class:`DataMeta` record via the normal async publish, so the
    §3.3.2 auto blocking/waking and §3.3.1/§3.3.4 receiver-driven
    least-access-frequency pulls all apply per chunk.  ``get_stream``
    pulls chunk *i* while chunk *i+1* is still being produced, which is
    where the tail-latency and bandwidth-utilisation headroom over
    monolithic DFlow comes from.
    """

    name = "dstore-stream"

    def __init__(self, env: Env, cluster: Cluster,
                 chunk_size: float | None = None):
        super().__init__(env, cluster)
        self.chunk_size = (cluster.cfg.stream_chunk if chunk_size is None
                           else float(chunk_size))
        self.stream_meta: dict[str, _SimStream] = {}
        self._stream_waiters: dict[str, list[Event]] = {}

    @staticmethod
    def _chunk_key(key: str, i: int) -> str:
        return f"{key}\x1ec{i}"

    # -- producer ----------------------------------------------------------
    def put_stream(self, node: str, key: str, size: float,
                   consumers: Iterable[str] = (),
                   ref_node: str | None = None,
                   produce_time: float = 0.0) -> Event:
        """Announce the stream now; emit chunks across ``produce_time``.
        The returned event is producer-side completion (last chunk copied
        into the local store)."""
        size = self._planned_size(key, size)
        n = max(1, math.ceil(size / self.chunk_size))
        sm = _SimStream(key, size, n, size / n)
        self.sizes[key] = size
        self.stream_meta[key] = sm
        for ev in self._stream_waiters.pop(key, []):
            ev.trigger(sm)
        return self.env.process(self._produce(node, key, sm, produce_time))

    def _produce(self, node: str, key: str, sm: _SimStream,
                 produce_time: float):
        pace = produce_time / sm.n_chunks
        for i in range(sm.n_chunks):
            if pace:
                yield self.env.timeout(pace)
            # container -> local store copy, then async per-chunk publish.
            yield self.cluster.local_copy(sm.chunk)
            ck = self._chunk_key(key, i)
            self.sizes[ck] = sm.chunk
            self._publish(ck, sm.chunk, node)
        self.local[node].add(key)        # whole value now locally resident

    # -- consumer ----------------------------------------------------------
    def get_stream(self, node: str, key: str) -> Event:
        return self.env.process(self._get_stream(node, key))

    def _get_stream(self, node: str, key: str):
        cfg = self.cfg
        if key in self.local[node]:
            size = self.sizes[key]
            yield self.cluster.local_copy(size)
            return size
        yield self.env.timeout(cfg.msg_latency + cfg.meta_query)
        sm = self.stream_meta.get(key)
        if sm is None and (key in self.meta or key in self.sizes):
            # Seeded external input / monolithic Put: plain DStore path.
            size = yield self.env.process(self._get(node, key))
            return size
        if sm is None:
            # Auto-block until the producer announces the stream.
            ev = self.env.event()
            self._stream_waiters.setdefault(key, []).append(ev)
            sm = yield ev
        got = 0.0
        for i in range(sm.n_chunks):
            ck = self._chunk_key(key, i)
            m = self.meta.get(ck)
            if m is None:
                # Auto-block per chunk (§3.3.2 at chunk granularity).
                ev = self.env.event()
                self._waiters.setdefault(ck, []).append(ev)
                m = yield ev
            if node not in m.locations:
                # Receiver-driven chunk pull, least-access-frequency replica.
                src = m.best_location()
                m.locations[src] += 1
                yield self.cluster.network.transfer(src, node, m.size,
                                                    tag=f"dstream:{key}:{i}")
                m.locations[src] -= 1
                self.fetched_bytes += m.size
                m.locations.setdefault(node, 0)
            got += m.size
        self.local[node].add(key)
        yield self.cluster.local_copy(got)   # local store -> container
        return got


class CentralPlane:
    """All data through one store on the master node (CFlow's CouchDB)."""

    def __init__(self, env: Env, cluster: Cluster,
                 op_overhead: float | None = None,
                 bw_eff: float | None = None, name: str = "couch",
                 hub: str = MASTER):
        cfg = cluster.cfg
        self.env = env
        self.cluster = cluster
        self.cfg = cfg
        self.op = cfg.couch_op if op_overhead is None else op_overhead
        self.bw_eff = cfg.couch_bw_eff if bw_eff is None else bw_eff
        self.name = name
        self.hub = hub
        self.sizes: dict[str, float] = {}
        self.seeded: set[str] = set()

    def seed(self, node: str, key: str, size: float) -> None:
        # External inputs arrive with the trigger payload — no store hop.
        self.sizes[key] = size
        self.seeded.add(key)

    def put(self, node: str, key: str, size: float,
            consumers: Iterable[str] = (),
            ref_node: str | None = None) -> Event:
        self.sizes[key] = size
        return self.env.process(self._put(node, key, size))

    def _put(self, node: str, key: str, size: float):
        yield self.env.timeout(self.op)
        yield self.cluster.network.transfer(node, self.hub, size / self.bw_eff,
                                            tag=f"{self.name}:put:{key}")

    def get(self, node: str, key: str) -> Event:
        return self.env.process(self._get(node, key))

    def _get(self, node: str, key: str):
        size = self.sizes[key]
        if key in self.seeded:
            yield self.cluster.local_copy(size)
            return size
        yield self.env.timeout(self.op)
        yield self.cluster.network.transfer(self.hub, node, size / self.bw_eff,
                                            tag=f"{self.name}:get:{key}")
        yield self.cluster.local_copy(size)
        return size


class HybridPlane:
    """Local Redis per node + central store for inter-node (FaaSFlow family).

    ``central='couch'`` → FaaSFlow;  ``central='redis'`` → FaaSFlowRedis/KNIX.
    The producer uploads to the central store *only* when at least one
    consumer lives on another node (FaaSFlow's GS decides storage type per
    function; our partitioner gives the plane the consumer placement).
    """

    def __init__(self, env: Env, cluster: Cluster, central: str = "couch",
                 hub: str = MASTER, db_exclusive: bool = False):
        cfg = cluster.cfg
        self.env = env
        self.cluster = cluster
        self.cfg = cfg
        self.hub = hub
        # KNIX semantics: a DB-type output is written ONLY to the remote
        # Redis ("KNIX will utilize the remote Redis to store the function's
        # output", §5) — consumers then fetch it over the network even if
        # they run on the producer's node.
        self.db_exclusive = db_exclusive
        self.name = f"hybrid-{central}"
        if central == "couch":
            self.op, self.bw_eff = cfg.couch_op, cfg.couch_bw_eff
        elif central == "redis":
            self.op, self.bw_eff = cfg.redis_op, cfg.redis_bw_eff
        else:
            raise ValueError(central)
        self.sizes: dict[str, float] = {}
        self.local: dict[str, set[str]] = {n: set() for n in cluster.nodes}

    def seed(self, node: str, key: str, size: float) -> None:
        self.sizes[key] = size
        self.local[node].add(key)

    def put(self, node: str, key: str, size: float,
            consumers: Iterable[str] = (),
            ref_node: str | None = None) -> Event:
        # Storage-type decision (MEM vs DB) is made against the GS's
        # reference placement: ``ref_node`` is the producer's reference
        # node, ``consumers`` the consumers' reference nodes.
        self.sizes[key] = size
        base = ref_node if ref_node is not None else node
        remote = any(c != base for c in consumers)
        return self.env.process(self._put(node, key, size, remote))

    def _put(self, node: str, key: str, size: float, remote: bool):
        if remote and self.db_exclusive:
            # DB storage type: output lives only in the hub Redis.
            yield self.env.timeout(self.op)
            yield self.cluster.network.transfer(
                node, self.hub, size / self.bw_eff, tag=f"{self.name}:put:{key}")
            return
        yield self.cluster.local_copy(size)          # local redis write
        self.local[node].add(key)
        if remote:                                   # upload for remote readers
            yield self.env.timeout(self.op)
            yield self.cluster.network.transfer(
                node, self.hub, size / self.bw_eff, tag=f"{self.name}:put:{key}")

    def get(self, node: str, key: str) -> Event:
        return self.env.process(self._get(node, key))

    def _get(self, node: str, key: str):
        size = self.sizes[key]
        if key in self.local[node]:
            yield self.cluster.local_copy(size)
            return size
        yield self.env.timeout(self.op)
        yield self.cluster.network.transfer(self.hub, node, size / self.bw_eff,
                                            tag=f"{self.name}:get:{key}")
        yield self.cluster.local_copy(size)
        return size
