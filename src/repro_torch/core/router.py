"""DShard — sharded multi-node DStore with local routing tables.

The single-process :class:`~repro.core.dstore.DStore` keeps ONE directory
for the whole cluster: every Get that misses locally consults that central
directory and then pulls — effectively a 2-hop exchange (consumer →
directory → producer), and at serving scale the directory is the metadata
hotspot.  DShard restructures the data plane the way iRoute does (local
routing controllers + a coordinator syncing routing tables):

* **one directory shard per node** — a key's metadata lives on the shard of
  its *home* node, which is the node the GS partitioner placed its producer
  on (externals: where the input is staged, ``partition.stage_node``);
* **a per-node routing table** (:class:`RoutingTable`) — consumers resolve
  key → home locally, no central lookup on the hot path;
* **a lightweight coordinator** (:class:`Coordinator`) — the authority the
  tables sync from.  Instance registration installs the static routes
  derived from placement (or, better, from DPlan's transfer matrix);
  dynamic writes of unplanned keys register their home lazily.

The result is the universal **1-hop transfer**: a consumer's Get contacts
exactly one shard — the producing node's — and pulls from a replica it
names.  A 2-hop resolution can only happen through a *stale* table
(misroute: the contacted shard is alive but not the home); it is counted,
recorded in the trace (``hops=2``) and flagged by the trace checker's
``routing`` invariant.

Transport tiers (priced distinctly by :class:`TieredTransport` and the
simulator's ``ShardedDStorePlane``):

* ``ipc``  — same-container handoff: the key's home *is* the consumer's
  node and the bytes are already local (e.g. the trigger payload);
* ``mem``  — same-node memoryview: bytes local from an earlier pull, or
  pulled from a replica on the consumer's own node;
* ``net``  — cross-node network pull (the only tier that pays bandwidth).

:class:`ShardedDStore` subclasses ``DStore`` so the engine, DStream, DPlan
eviction and DCheck tracing all run unchanged on top of it — the 200-seed
differential corpus is byte-exact against the single-store baseline.

Copy of ``repro/core/router.py`` for the PyTorch port, which imports nothing
of ``repro``; its code is the reference's, line for line, with no departure.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Iterable, Mapping

from .dstore import (DStore, DataDirectoryService, GetTimeout,
                     ImmutabilityError, Transport, _sizeof, _trace_of)
from .check import content_digest
from .partition import stage_node
from .stream import base_key, chunk_key

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .dag import Workflow
    from .plan import WorkflowPlan

__all__ = ["ShardedDStore", "RoutingTable", "Coordinator", "TieredTransport",
           "static_routes", "routes_from_plan",
           "TIER_IPC", "TIER_MEM", "TIER_NET"]

# Transport tiers, cheapest first.
TIER_IPC = "ipc"    # same-container: key homed here and bytes already local
TIER_MEM = "mem"    # same-node memoryview: local bytes, remote home
TIER_NET = "net"    # cross-node network pull

# A Get blocked at a home shard re-checks the coordinator's authoritative
# route at this period, so a failure re-home (or a stale-table fix) moves
# the consumer to the new home instead of wedging on a dead shard's CV.
_ROUTE_POLL = 0.05

_MISSING = object()


class TieredTransport(Transport):
    """Transport that prices the three DShard tiers distinctly.

    The base-class counters (``bytes_moved``/``transfers``) keep their
    single-store meaning — cross-node traffic only — so reports stay
    comparable; per-tier traffic lands in ``tier_bytes``/``tier_transfers``.
    """

    def __init__(self, bandwidth: float | None = None, latency: float = 0.0,
                 *, mem_bandwidth: float | None = None,
                 mem_latency: float = 0.0):
        super().__init__(bandwidth, latency)
        self.mem_bandwidth = mem_bandwidth
        self.mem_latency = mem_latency
        self.tier_bytes = {TIER_IPC: 0, TIER_MEM: 0, TIER_NET: 0}
        self.tier_transfers = {TIER_IPC: 0, TIER_MEM: 0, TIER_NET: 0}

    def move(self, size: int, tier: str = TIER_NET) -> None:
        if tier == TIER_NET:
            super().move(size)
        elif tier == TIER_MEM:
            if self.mem_latency:
                time.sleep(self.mem_latency)
            if self.mem_bandwidth:
                time.sleep(size / self.mem_bandwidth)
        with self._lock:
            self.tier_bytes[tier] += size
            self.tier_transfers[tier] += 1


class RoutingTable:
    """One node's local key → home-shard map (synced from the coordinator).

    Chunk keys route through their stream's base key, so a single installed
    route covers a whole stream.  ``lookup`` counts hits/misses; ``peek``
    is the non-counting variant used for tier classification on local hits.
    """

    def __init__(self, node: str):
        self.node = node
        self._lock = threading.Lock()
        self._routes: dict[str, str] = {}
        self.version = -1
        self.hits = 0
        self.misses = 0
        self.refreshes = 0

    def install(self, routes: Mapping[str, str], version: int) -> None:
        with self._lock:
            self._routes = dict(routes)
            self.version = version
            self.refreshes += 1

    def lookup(self, key: str) -> str | None:
        with self._lock:
            home = self._routes.get(key)
            if home is None:
                b = base_key(key)
                if b != key:
                    home = self._routes.get(b)
            if home is None:
                self.misses += 1
            else:
                self.hits += 1
            return home

    def peek(self, key: str) -> str | None:
        with self._lock:
            home = self._routes.get(key)
            if home is None:
                home = self._routes.get(base_key(key))
            return home

    def __len__(self) -> int:
        with self._lock:
            return len(self._routes)


class Coordinator:
    """Routing authority the per-node tables sync from.

    Holds the versioned key → home map plus the failed-node set.  Route
    changes (install / re-home) bump the version and wake ``wait_route``
    blockers — consumers of a key no plan knows about yet block *here*, not
    on a guessed shard, so even dynamically-registered keys resolve 1-hop.
    """

    def __init__(self, nodes: Iterable[str]):
        self.nodes = list(nodes)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._routes: dict[str, str] = {}
        self._version = 0
        self._failed: set[str] = set()
        self.syncs = 0

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def install(self, routes: Mapping[str, str]) -> None:
        with self._cv:
            self._routes.update(routes)
            self._version += 1
            self._cv.notify_all()

    def remove_prefix(self, prefix: str) -> None:
        with self._cv:
            stale = [k for k in self._routes if k.startswith(prefix)]
            for k in stale:
                del self._routes[k]
            if stale:
                self._version += 1

    def route_of(self, key: str) -> str | None:
        with self._lock:
            home = self._routes.get(key)
            if home is None:
                home = self._routes.get(base_key(key))
            return home

    def rehome(self, key: str, node: str) -> None:
        with self._cv:
            self._routes[key] = node
            self._version += 1
            self._cv.notify_all()

    def sync(self, table: RoutingTable) -> None:
        """Refresh one node's table (the lightweight coordinator sync)."""
        with self._lock:
            snapshot = dict(self._routes)
            version = self._version
            self.syncs += 1
        table.install(snapshot, version)

    def mark_failed(self, node: str) -> None:
        with self._cv:
            self._failed.add(node)
            self._version += 1
            self._cv.notify_all()

    def mark_alive(self, node: str) -> None:
        with self._lock:
            self._failed.discard(node)

    def is_failed(self, node: str) -> bool:
        with self._lock:
            return node in self._failed

    def wait_route(self, key: str, deadline: float | None) -> str:
        """Block until ``key`` has a home (a Put registered it)."""
        with self._cv:
            while True:
                home = self._routes.get(key)
                if home is None:
                    home = self._routes.get(base_key(key))
                if home is not None:
                    return home
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise GetTimeout(f"Get({key!r}) timed out")
                self._cv.wait(remaining)


def static_routes(wf: "Workflow", placement: Mapping[str, str],
                  nodes: list[str] | None = None) -> dict[str, str]:
    """Raw-key routing table from the GS partitioner's placement: a
    function's outputs are homed on its node; external inputs where they
    are staged (first consumer's node — the same authority the engine and
    DPlan use, so the table matches what the runtime actually does)."""
    routes: dict[str, str] = {}
    default = nodes[0] if nodes else next(iter(placement.values()), None)
    for f in wf.functions.values():
        for k in f.outputs:
            routes[k] = placement[f.name]
    for k in wf.external_inputs:
        home = stage_node(wf, k, placement, default)
        if home is not None:
            routes[k] = home
    return routes


def routes_from_plan(plan: "WorkflowPlan") -> dict[str, str]:
    """Raw-key routes from DPlan's IR — the preferred source: the plan's
    transfer matrix already names every key's producing node (externals:
    the ``src`` of their staged transfer)."""
    routes: dict[str, str] = {}
    placement = plan.placement or {}
    for k, kp in plan.keys.items():
        if kp.producer is not None and kp.producer in placement:
            routes[k] = placement[kp.producer]
    for t in plan.transfers:
        if t.producer is None and t.src:
            routes[t.key] = t.src
    return routes


class _ShardView:
    """Read-only aggregate facade over the per-node shards, bound to
    ``ShardedDStore.directory`` so diagnostics written against the
    single-store API (``directory.keys()`` / ``directory.peek()``) keep
    working.  Mutations go through the store's overridden methods."""

    def __init__(self, owner: "ShardedDStore"):
        self._owner = owner

    def keys(self) -> list[str]:
        out: list[str] = []
        for shard in self._owner.shards.values():
            out.extend(shard.keys())
        return sorted(set(out))

    def peek(self, key: str):
        shard = self._owner.shard_of(key)
        if shard is not None:
            m = shard.peek(key)
            if m is not None:
                return m
        for shard in self._owner.shards.values():
            m = shard.peek(key)
            if m is not None:
                return m
        return None


class ShardedDStore(DStore):
    """Per-node directory shards + local routing tables (drop-in DStore).

    Gets resolve against the consumer node's :class:`RoutingTable` and
    contact exactly the home shard; hop counts and transport tiers are
    tracked per store (``hop_hist`` / ``tier_gets``) and emitted as
    ``route`` trace events carrying ``src``/``tier``/``hops`` for the
    checker's 1-hop routing invariant.
    """

    def __init__(self, nodes: list[str], transport: Transport | None = None,
                 *, coordinator: Coordinator | None = None):
        # Base init wires streams/stores/transport and — under the test
        # harness — auto-attaches the DCheck tracer (conftest patches
        # DStore.__init__, which this super() call resolves to).
        super().__init__(nodes, transport)
        self.node_list = list(nodes)
        self.shards: dict[str, DataDirectoryService] = {
            n: DataDirectoryService() for n in nodes}
        self.tables: dict[str, RoutingTable] = {
            n: RoutingTable(n) for n in nodes}
        self.coordinator = coordinator or Coordinator(nodes)
        # The base class's single directory is replaced by a read-only
        # union view; every method that mutated it is overridden below.
        self.directory = _ShardView(self)
        # DPlan-advisory per-node capacity (presize_from_plan).
        self.capacity_bytes: dict[str, int] = {n: 0 for n in nodes}
        self._stats_lock = threading.Lock()
        self.hop_hist: dict[int, int] = {0: 0, 1: 0, 2: 0}
        self.tier_gets = {TIER_IPC: 0, TIER_MEM: 0, TIER_NET: 0}

    # -- routing-table plumbing -------------------------------------------
    def shard_of(self, key: str) -> DataDirectoryService | None:
        home = self.coordinator.route_of(key)
        return self.shards.get(home) if home is not None else None

    def register_instance(self, prefix: str, wf: "Workflow",
                          placement: Mapping[str, str], *,
                          plan: "WorkflowPlan | None" = None) -> None:
        """Install one instance's static routes with the coordinator (the
        engine calls this before staging inputs).  Tables are NOT eagerly
        pushed — each node picks the routes up on its first sync, which is
        the stale-table refresh path working as designed."""
        routes = static_routes(wf, placement, nodes=self.node_list)
        if plan is not None and plan.placement:
            routes.update(routes_from_plan(plan))
            self.presize_from_plan(plan)
        self.coordinator.install({prefix + k: n for k, n in routes.items()})

    def register_metrics(self, registry) -> None:
        """Base collectors (resident/peak/transport) plus the sharded
        routing counters: hop histogram, per-tier Get counts and traffic,
        routing-table hit/miss/refresh and coordinator syncs."""
        super().register_metrics(registry)

        def _scrape() -> None:
            with self._stats_lock:
                hops = dict(self.hop_hist)
                tiers = dict(self.tier_gets)
            for h, n in hops.items():
                registry.counter("routing_gets", hops=h).set(n)
            for tier, n in tiers.items():
                registry.counter("tier_gets", tier=tier).set(n)
            t = self.transport
            if isinstance(t, TieredTransport):
                for tier, n in t.tier_bytes.items():
                    registry.counter("tier_bytes", tier=tier).set(n)
                for tier, n in t.tier_transfers.items():
                    registry.counter("tier_transfers", tier=tier).set(n)
            for node, tb in self.tables.items():
                registry.counter("routing_table_hits",
                                 node=node).set(tb.hits)
                registry.counter("routing_table_misses",
                                 node=node).set(tb.misses)
                registry.counter("routing_table_refreshes",
                                 node=node).set(tb.refreshes)
            registry.counter("coordinator_syncs").set(
                self.coordinator.syncs)
            # Per-node byte budgets (presized from DPlan's peak_resident):
            # DScale's autoscaler reads these against resident bytes to
            # hold scale-up on memory-bound nodes.
            for node, cap in self.capacity_bytes.items():
                registry.gauge("capacity_bytes", node=node).set(cap)
        registry.register_collector(_scrape)

    def presize_from_plan(self, plan: "WorkflowPlan") -> None:
        """Advisory per-node capacity from DPlan's peak-resident
        prediction (max over instances sharing the store)."""
        for node, peak in plan.peak_resident.items():
            if node in self.capacity_bytes:
                self.capacity_bytes[node] = max(
                    self.capacity_bytes[node], int(peak))

    def _home_for_put(self, node: str, key: str) -> str:
        home = self.coordinator.route_of(key)
        if home is None:
            # Unplanned key: the writer's node becomes its home (dynamic
            # registration; wakes wait_route blockers).
            self.coordinator.rehome(base_key(key), node)
            return node
        if home != node and self.coordinator.is_failed(home):
            # The home shard's node died: recovery re-homes the key to the
            # writer so the re-published record is reachable.
            self.coordinator.rehome(base_key(key), node)
            return node
        return home

    # -- Table 1 core API, sharded ----------------------------------------
    # _put/_put_chunk/_get are the inner methods: the base class's public
    # put/put_chunk/get wrappers add the DScope span/metric hooks once, so
    # sharded stores are instrumented identically to the single store.
    def _put(self, node: str, key: str, value) -> None:
        home = self._home_for_put(node, key)
        shard = self.shards[home]
        store = self.stores[node]
        digest = content_digest(value)
        tracer = self._tracer
        with self._write_lock:
            meta = shard.peek(key)
            if meta is not None:
                if (digest is not None and meta.digest is not None
                        and meta.digest != digest):
                    raise ImmutabilityError(
                        f"put({key!r}) from {node!r} diverges from the "
                        f"first writer's content: DStore data is immutable")
                if store.has(key):
                    return          # duplicate write: first-writer-wins
            if tracer is not None:
                tracer.record("put", key, node, size=_sizeof(value),
                              digest=digest, src=home)
            store.write(key, value)
            shard.publish(key, _sizeof(value), node, digest=digest)
            self._note_peak()
        self.streams.notify_plain(key)

    def _put_chunk(self, node: str, key: str, idx: int,
                   chunk: bytes) -> None:
        home = self._home_for_put(node, key)
        ck = chunk_key(key, idx)
        digest = content_digest(chunk)
        with self._write_lock:
            if self._tracer is not None:
                self._tracer.record("put_chunk", key, node, idx=idx,
                                    size=len(chunk), digest=digest, src=home)
                self._tracer.record("put", ck, node, size=len(chunk),
                                    digest=digest, src=home)
            self.stores[node].write(ck, chunk)
            self.shards[home].publish(ck, len(chunk), node, digest=digest)
            self._note_peak()
        self.streams.publish_chunk(key, idx, len(chunk))

    def _get(self, node: str, key: str, timeout: float | None = None):
        store = self.stores[node]
        table = self.tables[node]
        deadline = None if timeout is None else time.monotonic() + timeout
        wrong = 0       # alive-but-wrong shard contacts (stale table)
        home: str | None = None
        while True:
            if store.has(key):
                self._note_local_hit(node, key)
                return store.read(key)
            if home is None:
                home = table.lookup(key)
                if home is None:
                    # Table miss → one coordinator sync (the refresh path;
                    # a *legal* resolution, still 1 hop to the data).
                    self.coordinator.sync(table)
                    home = table.lookup(key)
            if home is None:
                # Key not registered anywhere yet: block at the
                # coordinator until a Put dynamically homes it.
                home = self.coordinator.wait_route(key, deadline)
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GetTimeout(f"Get({key!r}) timed out")
            wait_s = _ROUTE_POLL if remaining is None \
                else min(_ROUTE_POLL, remaining)
            try:
                meta = self.shards[home].wait(key, wait_s)
            except GetTimeout:
                # Still blocked at `home`: re-check the authoritative
                # route — it moves on failure re-home or if our table was
                # stale all along.
                auth = self.coordinator.route_of(key)
                if auth is not None and auth != home:
                    if not self.coordinator.is_failed(home):
                        wrong += 1      # genuine misroute: extra shard hop
                    self.coordinator.sync(table)
                    home = auth
                continue
            value = self._pull(node, key, meta, home, hops=1 + wrong)
            if value is not _MISSING:
                return value

    def _note_local_hit(self, node: str, key: str) -> None:
        # ipc: the key is homed here (trigger payload / own output);
        # mem: local replica of a remotely-homed key (earlier pull).  The
        # coordinator fallback is stats-only classification, not routing —
        # a never-synced table would otherwise misfile ipc hits as mem.
        home = self.tables[node].peek(key)
        if home is None:
            home = self.coordinator.route_of(key)
        tier = TIER_IPC if home == node else TIER_MEM
        with self._stats_lock:
            self.hop_hist[0] = self.hop_hist.get(0, 0) + 1
            self.tier_gets[tier] += 1

    def _pull(self, node: str, key: str, meta, home: str, *, hops: int):
        shard = self.shards[home]
        store = self.stores[node]
        try:
            src = shard.choose_replica(key)
        except KeyError:
            return _MISSING            # record vanished while unlocked
        try:
            value = self.stores[src].read(key)
        except KeyError:
            shard.release_replica(key, src)
            shard.drop_replica(key, src)    # phantom replica
            return _MISSING
        tier = TIER_MEM if src == node else TIER_NET
        spans = self._spans
        sp = spans.start(key, "hop", src=home, tier=tier, hops=hops,
                         size=meta.size) if spans is not None else None
        try:
            self._move(meta.size, tier)     # receiver-driven pull
        finally:
            if sp is not None:
                spans.end(sp)
            shard.release_replica(key, src)
        with self._write_lock:
            if self._tracer is not None:
                self._tracer.record("replica", key, node, size=meta.size,
                                    digest=meta.digest, src=home)
                self._tracer.record("route", key, node, size=meta.size,
                                    src=home, tier=tier, hops=hops)
            store.write(key, value)
            shard.publish(key, meta.size, node, digest=meta.digest)
            self._note_peak()
        with self._stats_lock:
            self.hop_hist[hops] = self.hop_hist.get(hops, 0) + 1
            self.tier_gets[tier] += 1
        return value

    def _move(self, size: int, tier: str) -> None:
        if isinstance(self.transport, TieredTransport):
            self.transport.move(size, tier)
        elif tier == TIER_NET:
            # Plain transport keeps its single-store meaning: cross-node
            # traffic only (same-node pulls are memoryview handoffs).
            self.transport.move(size)

    # -- eviction, sharded -------------------------------------------------
    def evict_key(self, key: str) -> None:
        with self._write_lock:
            existed = any(sh.peek(key) is not None
                          for sh in self.shards.values())
            if self._tracer is not None and existed:
                self._tracer.record("evict", key)
            for store in self.stores.values():
                store.drop_key(key)
            for shard in self.shards.values():
                shard.drop([key])
        if existed and self._spans is not None:
            self._spans.event(key, "evict", parent=None,
                              trace=_trace_of(key))
        # Routes are left installed: keys are immutable, so a stale route
        # for an evicted key can only lead to a clean block, never stale
        # bytes.

    def evict_instance(self, prefix: str) -> None:
        swept: list[str] = []
        with self._write_lock:
            if self._tracer is not None or self._spans is not None:
                for shard in self.shards.values():
                    for k in shard.keys():
                        if k.startswith(prefix):
                            if self._tracer is not None:
                                self._tracer.record("evict", k)
                            swept.append(k)
            for store in self.stores.values():
                store.drop_prefix(prefix)
            for shard in self.shards.values():
                shard.drop_prefix(prefix)
        self.streams.evict_prefix(prefix)
        if self._spans is not None:
            for k in swept:
                self._spans.event(k, "evict", parent=None,
                                  trace=_trace_of(k))
        self.coordinator.remove_prefix(prefix)
        if self._plan_reads:
            with self._plan_lock:
                for k in [k for k in self._plan_reads
                          if k.startswith(prefix)]:
                    del self._plan_reads[k]

    # -- fault handling, sharded -------------------------------------------
    def fail_node(self, node: str) -> list[str]:
        """Node loss under sharding: the node's bytes AND its directory
        shard die together.  Shard records with replicas surviving on
        other nodes migrate to a survivor's shard (the coordinator
        re-homes them — bounded work, no directory-wide scan); the rest
        are lost and must be recomputed."""
        self.streams.fail_owner(node)
        with self._write_lock:
            tracer = self._tracer
            if tracer is not None:
                tracer.record("fail_node", node=node)
            self.stores[node].drop_all()
            self.coordinator.mark_failed(node)
            lost: list[str] = []
            # Replicas hosted on the dead node vanish from every *other*
            # shard (each shard walks only its own records).
            for n, shard in self.shards.items():
                if n != node:
                    lost.extend(shard.drop_node(node))
            # Migrate the dead shard's surviving records.
            dead = self.shards[node]
            for k in dead.keys():
                m = dead.peek(k)
                if m is None:
                    continue
                survivors = sorted(
                    n for n in m.locations
                    if n != node and self.stores[n].has(k))
                if not survivors:
                    lost.append(k)
                    continue
                new_home = survivors[0]
                for n in survivors:
                    if tracer is not None:
                        tracer.record("publish", k, n, size=m.size,
                                      digest=m.digest, src=new_home)
                    self.shards[new_home].publish(k, m.size, n,
                                                  digest=m.digest)
                self.coordinator.rehome(k, new_home)
            # Fresh shard object: the node itself comes back (recovery may
            # re-place functions on it) with an empty directory.
            self.shards[node] = DataDirectoryService()
            self.coordinator.mark_alive(node)
            lost = sorted(set(lost))
            if tracer is not None:
                for k in lost:
                    tracer.record("drop", k, node)
            return lost
