"""DStore — the paper's distributed in-memory KV store (real, threaded).

This is the executable twin of the simulator's :class:`DStorePlane`: the same
design (§3.3) implemented with real threads so the orchestrator can run
actual Python/JAX callables as DFlow workflows:

* **data directory service** (:class:`DataDirectoryService`) — metadata only:
  key → (size, replica locations, per-replica access frequency).  Writing a
  metadata record wakes every consumer blocked on that key (the *auto
  blocking / waking-up* mechanism, §3.3.2).
* **local store** per node (:class:`LocalStore`) — the bytes.
* **Get/Put** core API (Table 1): ``Get`` blocks until the key's metadata
  exists, then pulls the value — locally when the replica is co-resident,
  otherwise *receiver-driven* from the least-access-frequency replica
  (§3.3.1, §3.3.4), registering the new replica in the directory afterwards.
* Data is **immutable**: a key can only be put once ("the updated version
  must be stored ... with a new, unique identifier", §3.3) — which is also
  what makes duplicate/straggler re-execution safe (first-writer-wins).

A pluggable :class:`Transport` lets tests emulate a slow network (bytes/s)
so the out-of-order overlap is observable in wall-clock time.

Copy of ``repro/core/dstore.py`` for the PyTorch port, which imports nothing
of ``repro``; its code is the reference's, line for line. Two of its rules
meet torch tensors, and both stay the reference's on purpose:

* ``_sizeof``: a bare tensor counts its ``nbytes`` (read from its metadata,
  so a CUDA tensor is sized with no sync), any container of tensors 64
  bytes, as a container of arrays does in the reference. With a bandwidth
  set, :class:`Transport`'s delays are therefore the reference's.
* Put digests its value with ``check.content_digest``: CPU tensors by their
  bytes, a CUDA tensor opaque (``None``, no sync), for the reason given in
  ``check.py``.

A Get hands out the very object that was Put (a replica is a second
reference, never a copy), so a consumer that writes into a tensor it got
writes into every other consumer's view of the datum. The port's
``runtime/orchestrator.py`` orders its in-place train steps with that in
mind.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

__all__ = ["DataDirectoryService", "LocalStore", "DStore", "Transport",
           "GetTimeout", "ImmutabilityError"]


class GetTimeout(TimeoutError):
    """Raised when Get blocks longer than the configured timeout."""


class ImmutabilityError(ValueError):
    """A key was co-written with divergent content.

    First-writer-wins duplicate safety (§3.3) presumes deterministic
    functions: a straggler re-execution must produce the *same bytes* as
    the original, otherwise which copy a consumer sees depends on replica
    choice.  The directory records a content digest at first publish and
    rejects any later publish whose digest disagrees."""


# stream.py lazily imports GetTimeout, so this import must come after it.
from .check import TraceRecorder, content_digest  # noqa: E402
from .stream import (DEFAULT_CHUNK, StreamDirectory, StreamReader,  # noqa: E402
                     StreamWriter, chunk_key, is_chunk_key)


# Imported at module load, not inside _sizeof: a lazy import there put a
# ~100 ms one-time cost on the first Put of the process — which under
# DServe lands squarely on the first request's critical path.
try:
    import numpy as _np
except Exception:  # pragma: no cover - numpy is optional for sizing
    _np = None


def _sizeof(value: Any) -> int:
    try:
        if hasattr(value, "nbytes"):
            return int(value.nbytes)
        if isinstance(value, (bytes, bytearray)):
            return len(value)
        if _np is not None and isinstance(value, _np.ndarray):
            return int(value.nbytes)
    except Exception:  # pragma: no cover - best effort sizing
        pass
    return 64  # opaque object: metadata-only size


# nullcontext is reentrant and stateless, so one shared instance serves
# every un-instrumented Get.
_NULL_CTX = nullcontext()


def _trace_of(key: str) -> str:
    """Instance id from a ``#``-namespaced key (``wf#0:out`` → ``wf#0``),
    used to tag spans emitted outside any request context (evictions)."""
    head, sep, _ = key.partition(":")
    return head if sep and "#" in head else ""


@dataclass
class _Meta:
    key: str
    size: int
    locations: dict[str, int] = field(default_factory=dict)
    digest: str | None = None     # content digest of first publish (None =
    #                               opaque value, equality unverifiable)


class DataDirectoryService:
    """Thread-safe metadata directory with blocking lookups."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._meta: dict[str, _Meta] = {}

    def publish(self, key: str, size: int, node: str,
                digest: str | None = None) -> None:
        with self._cv:
            m = self._meta.get(key)
            if m is None:
                m = self._meta[key] = _Meta(key, size, digest=digest)
            elif digest is not None:
                if m.digest is None:
                    m.digest = digest       # first verifiable publish wins
                elif m.digest != digest:
                    raise ImmutabilityError(
                        f"key {key!r} co-written with divergent content "
                        f"(existing digest {m.digest[:12]}…, new "
                        f"{digest[:12]}…): DStore data is immutable")
            m.locations.setdefault(node, 0)
            self._cv.notify_all()          # wake blocked Gets (§3.3.2)

    def wait(self, key: str, timeout: float | None = None) -> _Meta:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while key not in self._meta:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise GetTimeout(f"Get({key!r}) timed out")
                self._cv.wait(remaining)
            return self._meta[key]

    def peek(self, key: str) -> _Meta | None:
        with self._lock:
            return self._meta.get(key)

    def choose_replica(self, key: str) -> str:
        """Least-access-frequency replica; increments its counter."""
        with self._lock:
            m = self._meta[key]
            node = min(m.locations.items(), key=lambda kv: (kv[1], kv[0]))[0]
            m.locations[node] += 1
            return node

    def release_replica(self, key: str, node: str) -> None:
        with self._lock:
            m = self._meta.get(key)
            if m and node in m.locations and m.locations[node] > 0:
                m.locations[node] -= 1

    def drop_replica(self, key: str, node: str) -> None:
        """Remove one phantom replica (registered by a Put that raced a node
        failure); deletes the record when no replica remains, so consumers
        block again until a recovery re-execution re-publishes."""
        with self._cv:
            m = self._meta.get(key)
            if m is None:
                return
            m.locations.pop(node, None)
            if not m.locations:
                del self._meta[key]

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._meta)

    def drop(self, keys: list[str]) -> None:
        """Fault handling (§3.3.5): delete metadata of a failed workflow."""
        with self._cv:
            for k in keys:
                self._meta.pop(k, None)

    def drop_prefix(self, prefix: str) -> list[str]:
        """Instance-scoped eviction: delete every record whose key starts
        with ``prefix`` (a completed instance's namespace); returns them."""
        with self._cv:
            dropped = [k for k in self._meta if k.startswith(prefix)]
            for k in dropped:
                del self._meta[k]
        return dropped

    def drop_node(self, node: str) -> list[str]:
        """Remove every replica hosted on a failed node; returns keys that
        lost their last replica (those must be recomputed)."""
        lost: list[str] = []
        with self._cv:
            for k, m in list(self._meta.items()):
                m.locations.pop(node, None)
                if not m.locations:
                    del self._meta[k]
                    lost.append(k)
        return lost


class LocalStore:
    """Per-node in-memory object store (byte-accounted: the DPlan peak-
    resident metric and eviction benchmarks read ``resident_bytes``)."""

    def __init__(self, node: str):
        self.node = node
        self._lock = threading.Lock()
        self._data: dict[str, Any] = {}
        self._bytes = 0
        self._peak = 0

    def write(self, key: str, value: Any) -> None:
        with self._lock:
            if key in self._data:
                self._bytes -= _sizeof(self._data[key])
            self._data[key] = value
            self._bytes += _sizeof(value)
            if self._bytes > self._peak:
                self._peak = self._bytes

    def read(self, key: str) -> Any:
        with self._lock:
            return self._data[key]

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def drop_all(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0

    def drop_prefix(self, prefix: str) -> None:
        with self._lock:
            for k in [k for k in self._data if k.startswith(prefix)]:
                self._bytes -= _sizeof(self._data.pop(k))

    def drop_key(self, key: str) -> None:
        with self._lock:
            if key in self._data:
                self._bytes -= _sizeof(self._data.pop(key))

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def peak_bytes(self) -> int:
        """High-water mark of this node's resident bytes — the per-node
        figure DPlan's ``peak_resident`` prediction is comparable to."""
        with self._lock:
            return self._peak

    def reset_peak(self) -> None:
        with self._lock:
            self._peak = self._bytes


class Transport:
    """Inter-node copy model: optional bandwidth (B/s) + per-op latency."""

    def __init__(self, bandwidth: float | None = None, latency: float = 0.0):
        self.bandwidth = bandwidth
        self.latency = latency
        self._lock = threading.Lock()
        self.bytes_moved = 0
        self.transfers = 0

    def move(self, size: int) -> None:
        if self.latency:
            time.sleep(self.latency)
        if self.bandwidth:
            time.sleep(size / self.bandwidth)
        with self._lock:
            self.bytes_moved += size
            self.transfers += 1


class DStore:
    """Cluster-wide store: one directory + one LocalStore per node."""

    def __init__(self, nodes: list[str],
                 transport: Transport | None = None):
        self.directory = DataDirectoryService()
        self.streams = StreamDirectory()
        self.stores = {n: LocalStore(n) for n in nodes}
        self.transport = transport or Transport()
        # Serialises writes against fail_node: without it a Put interleaving
        # with a failure (write → store wiped → publish) would register a
        # replica whose bytes are gone, invisible to recovery.
        self._write_lock = threading.Lock()
        # DCheck hook (see check.py): None = recording off, zero cost.
        self._tracer: TraceRecorder | None = None
        # DScope hooks (see obs.py), same zero-cost-when-off pattern:
        # _spans is a Tracer producing per-request span trees, _metrics a
        # MetricsRegistry receiving hot-path latency observations.
        self._spans = None
        self._metrics = None
        # DPlan eviction hints: key -> Gets remaining before the key is
        # provably dead (installed per instance by set_plan_reads).  Own
        # lock so the countdown never nests inside _write_lock.
        self._plan_lock = threading.Lock()
        self._plan_reads: dict[str, int] = {}
        self._peak_bytes = 0

    def attach_tracer(self, tracer: TraceRecorder | None) -> None:
        """Attach (or detach, with None) a :class:`TraceRecorder`.  Every
        data-plane action is recorded from then on; stream-level events
        (close/abort) are recorded by the shared StreamDirectory."""
        self._tracer = tracer
        self.streams.tracer = tracer

    def attach_spans(self, spans) -> None:
        """Attach (or detach, with None) a DScope span
        :class:`~repro.core.obs.Tracer`.  Every Get/Put/chunk/evict from
        then on emits a span parented under the calling thread's active
        span (the function-invocation span the engine activated)."""
        self._spans = spans

    def attach_metrics(self, registry) -> None:
        """Attach a :class:`~repro.core.obs.MetricsRegistry` for hot-path
        latency histograms (per-Get/Put) *and* register the pull
        collectors.  Passing None detaches the push hooks."""
        self._metrics = registry
        if registry is not None:
            self.register_metrics(registry)

    def register_metrics(self, registry) -> None:
        """Register pull-style collectors only (no hot-path cost): per-node
        resident/peak bytes and transport traffic, scraped at
        ``registry.collect()`` time."""
        def _scrape() -> None:
            for node, s in self.stores.items():
                registry.gauge("dstore_resident_bytes",
                               node=node).set(s.resident_bytes)
                registry.gauge("dstore_peak_resident_bytes",
                               node=node).set(s.peak_bytes)
            registry.counter("transport_bytes_moved").set(
                self.transport.bytes_moved)
            registry.counter("transport_transfers").set(
                self.transport.transfers)
        registry.register_collector(_scrape)

    # -- Table 1 core API ------------------------------------------------
    def put(self, node: str, key: str, value: Any) -> None:
        """Create data with the given key (immutable; §3.3).

        Duplicate (straggler) co-writes are safe only because functions are
        deterministic — the directory verifies it: a co-write whose content
        digest diverges from the first publish raises
        :class:`ImmutabilityError` instead of silently registering a second
        replica with different bytes.
        """
        spans = self._spans
        if spans is None:
            return self._put(node, key, value)
        sp = spans.start(key, "put", node=node, size=_sizeof(value))
        try:
            return self._put(node, key, value)
        finally:
            spans.end(sp)

    def _put(self, node: str, key: str, value: Any) -> None:
        store = self.stores[node]
        digest = content_digest(value)
        tracer = self._tracer
        with self._write_lock:
            meta = self.directory.peek(key)
            if meta is not None:
                if (digest is not None and meta.digest is not None
                        and meta.digest != digest):
                    raise ImmutabilityError(
                        f"put({key!r}) from {node!r} diverges from the "
                        f"first writer's content: DStore data is immutable")
                if store.has(key):
                    return              # duplicate write: first-writer-wins
            # Recorded before the bytes land so the trace's availability
            # event precedes any Get that could observe them.
            if tracer is not None:
                tracer.record("put", key, node, size=_sizeof(value),
                              digest=digest)
            store.write(key, value)
            # Metadata publish is what wakes consumers; in the real system it
            # is asynchronous w.r.t. the producer container, here just cheap.
            self.directory.publish(key, _sizeof(value), node, digest=digest)
            self._note_peak()
        self.streams.notify_plain(key)   # wake get_stream fallbacks

    def get(self, node: str, key: str,
            timeout: float | None = None) -> Any:
        """Blocking Get (Table 1): may wait for the producer (§3.3.2).

        A replica whose bytes are gone (its Put raced a node failure, so the
        directory record points at a wiped store) is dropped and the wait
        restarts — recovery re-publishes the key and wakes us again.
        """
        spans = self._spans
        metrics = self._metrics
        if spans is None and metrics is None:
            return self._get_recorded(node, key, timeout)
        t0 = time.monotonic()
        sp = None
        if spans is not None:
            sp = spans.start(key, "chunk" if is_chunk_key(key) else "get",
                             node=node)
        try:
            # Activated so cross-shard hop spans nest under this Get.
            with spans.activate(sp) if spans is not None else _NULL_CTX:
                value = self._get_recorded(node, key, timeout)
        except BaseException:
            if sp is not None:
                spans.end(sp, error=True)
            raise
        if sp is not None:
            spans.end(sp, size=_sizeof(value))
        if metrics is not None:
            metrics.histogram("dstore_get_seconds").observe(
                time.monotonic() - t0)
        return value

    def _get_recorded(self, node: str, key: str,
                      timeout: float | None = None) -> Any:
        tracer = self._tracer
        if tracer is None:
            value = self._get(node, key, timeout)
        else:
            tracer.record("get_block", key, node)
            try:
                value = self._get(node, key, timeout)
            except BaseException:
                tracer.record("get_fail", key, node)
                raise
            tracer.record("get_return", key, node,
                          digest=content_digest(value))
        # The plan countdown runs after get_return is recorded: the trace
        # shows this read completing before any eviction it triggers.
        if self._plan_reads:
            self._plan_note_read(key)
        return value

    def _get(self, node: str, key: str,
             timeout: float | None = None) -> Any:
        store = self.stores[node]
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if store.has(key):
                return store.read(key)
            remaining = None
            if deadline is not None:
                remaining = max(deadline - time.monotonic(), 0.0)
            meta = self.directory.wait(key, remaining)
            if store.has(key):
                return store.read(key)
            try:
                src = self.directory.choose_replica(key)
            except KeyError:
                continue               # record vanished while unlocked
            try:
                value = self.stores[src].read(key)
            except KeyError:
                self.directory.release_replica(key, src)
                self.directory.drop_replica(key, src)  # phantom replica
                continue
            try:
                self.transport.move(meta.size)     # receiver-driven pull
            finally:
                self.directory.release_replica(key, src)
            # Same write→publish atomicity vs fail_node as put(): without
            # the lock a failure of `node` here would leave a phantom
            # replica that masks the data loss from recovery.
            with self._write_lock:
                if self._tracer is not None:
                    self._tracer.record("replica", key, node,
                                        size=meta.size, digest=meta.digest)
                store.write(key, value)
                self.directory.publish(key, meta.size, node,  # new replica
                                       digest=meta.digest)
                self._note_peak()
            return value

    # -- DStream chunked API (beyond-paper; see stream.py) -----------------
    def put_stream(self, node: str, key: str, *,
                   chunk_size: int = DEFAULT_CHUNK) -> StreamWriter:
        """Open a chunked writer for ``key``; chunks publish as they fill
        and wake blocked readers per chunk (§3.3.2 at chunk granularity)."""
        return StreamWriter(self, node, key, chunk_size)

    def get_stream(self, node: str, key: str,
                   timeout: float | None = None,
                   prefetch: bool = True) -> StreamReader:
        """Blocking chunk iterator over ``key``: yields chunk 0 while the
        producer may still be emitting chunk N.  Falls back to chunking a
        monolithically-Put value."""
        return StreamReader(self, node, key, timeout, prefetch)

    def put_chunk(self, node: str, key: str, idx: int, chunk: bytes) -> None:
        """One stream chunk: bytes in the local store, a directory record
        of its own (so remote pulls are chunk-granular and receiver-driven),
        and a stream-directory publish that wakes blocked readers."""
        spans = self._spans
        if spans is None:
            return self._put_chunk(node, key, idx, chunk)
        sp = spans.start(chunk_key(key, idx), "chunk_put", node=node,
                         size=len(chunk))
        try:
            return self._put_chunk(node, key, idx, chunk)
        finally:
            spans.end(sp)

    def _put_chunk(self, node: str, key: str, idx: int,
                   chunk: bytes) -> None:
        ck = chunk_key(key, idx)
        digest = content_digest(chunk)
        with self._write_lock:
            if self._tracer is not None:
                self._tracer.record("put_chunk", key, node, idx=idx,
                                    size=len(chunk), digest=digest)
                self._tracer.record("put", ck, node, size=len(chunk),
                                    digest=digest)
            self.stores[node].write(ck, chunk)
            self.directory.publish(ck, len(chunk), node, digest=digest)
            self._note_peak()
        self.streams.publish_chunk(key, idx, len(chunk))

    # -- DPlan eviction hints (see plan.py) --------------------------------
    def set_plan_reads(self, prefix: str, reads: "Mapping[str, int]") -> None:
        """Install the plan's eviction schedule for one instance: each raw
        key's statically-known read count, namespaced under ``prefix``.
        The countdown in :meth:`get` evicts a key the moment its last
        planned read returns."""
        with self._plan_lock:
            for k, n in reads.items():
                if n > 0:
                    self._plan_reads[prefix + k] = n

    def _plan_note_read(self, key: str) -> None:
        evict = False
        with self._plan_lock:
            n = self._plan_reads.get(key)
            if n is None:
                return
            if n <= 1:
                del self._plan_reads[key]
                evict = True
            else:
                self._plan_reads[key] = n - 1
        if evict:
            self.evict_key(key)

    def evict_key(self, key: str) -> None:
        """Single-key eviction: reclaim the bytes on every node plus the
        directory record.  Safe exactly when no future Get of the key can
        exist — which is what the plan's liveness analysis proves."""
        with self._write_lock:
            existed = self.directory.peek(key) is not None
            if self._tracer is not None and existed:
                self._tracer.record("evict", key)
            for store in self.stores.values():
                store.drop_key(key)
            self.directory.drop([key])
        if existed and self._spans is not None:
            self._spans.event(key, "evict", parent=None,
                              trace=_trace_of(key))

    def resident_bytes(self) -> int:
        """Bytes currently held across all node-local stores."""
        return sum(s.resident_bytes for s in self.stores.values())

    @property
    def peak_resident_bytes(self) -> int:
        """Cluster-wide peak of summed resident bytes (historic metric)."""
        return self._peak_bytes

    def peak_resident_per_node(self) -> dict[str, int]:
        """Per-node high-water marks — what capacity planning actually
        needs (a node provisions for ITS peak, not the cluster sum), and
        the measured twin of ``WorkflowPlan.peak_resident``."""
        return {n: s.peak_bytes for n, s in self.stores.items()}

    def reset_peak(self) -> None:
        self._peak_bytes = self.resident_bytes()
        for s in self.stores.values():
            s.reset_peak()

    def _note_peak(self) -> None:
        # Called with _write_lock held, right after bytes land.
        cur = self.resident_bytes()
        if cur > self._peak_bytes:
            self._peak_bytes = cur

    def evict_instance(self, prefix: str) -> None:
        """Instance-scoped eviction (serving): when a workflow instance
        completes, reclaim every key in its namespace — bytes in all local
        stores, directory records, and stream records (chunk keys share the
        instance prefix, so they are swept by the same pass).  Bounded
        memory under sustained multi-instance serving."""
        swept: list[str] = []
        with self._write_lock:
            if self._tracer is not None or self._spans is not None:
                # Recorded before the bytes are reclaimed: an in-flight
                # reader recorded earlier is a real use-after-evict hazard.
                for k in self.directory.keys():
                    if k.startswith(prefix):
                        if self._tracer is not None:
                            self._tracer.record("evict", k)
                        swept.append(k)
            for store in self.stores.values():
                store.drop_prefix(prefix)
            self.directory.drop_prefix(prefix)
        self.streams.evict_prefix(prefix)
        if self._spans is not None:
            for k in swept:
                self._spans.event(k, "evict", parent=None,
                                  trace=_trace_of(k))
        if self._plan_reads:
            with self._plan_lock:
                for k in [k for k in self._plan_reads
                          if k.startswith(prefix)]:
                    del self._plan_reads[k]

    # -- fault handling ----------------------------------------------------
    def fail_node(self, node: str) -> list[str]:
        """Simulate a node loss; returns data keys that must be recomputed."""
        # Open streams abort (blocked readers get a clean error); closed
        # streams are evicted so a recovery rerun can re-claim them.
        self.streams.fail_owner(node)
        with self._write_lock:
            if self._tracer is not None:
                self._tracer.record("fail_node", node=node)
            self.stores[node].drop_all()
            lost = self.directory.drop_node(node)
            if self._tracer is not None:
                for k in lost:
                    self._tracer.record("drop", k, node)
            return lost
