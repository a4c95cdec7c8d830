"""DStream — chunked, pipelined data exchange over the DStore (beyond-paper).

The paper's Get/Put (Table 1) moves every datum as one monolithic blob: a
consumer's fetch cannot even *begin* until the producer's entire output is
written, so the §3.3.2 auto blocking/waking overlap stops at the data layer.
DStream extends the fine-grained optimizations of §3.3 to *chunk*
granularity:

* ``put_stream(node, key)`` returns a :class:`StreamWriter` that publishes
  fixed-size chunks.  Every chunk gets its own directory record (the
  producer's local store holds the bytes; the :class:`StreamDirectory`
  holds per-chunk metadata) and every publish wakes blocked consumers —
  §3.3.2's auto blocking/waking-up applied per chunk.
* ``get_stream(node, key)`` returns a :class:`StreamReader`, a blocking
  iterator: the consumer pulls chunk 0 — receiver-driven, exactly like a
  monolithic Get (§3.3.1/§3.3.4) but per chunk — while the producer is
  still emitting chunk N.  A background prefetcher keeps pulls overlapped
  with the consumer's own processing.
* Duplicate producers (straggler re-issue) **co-write** the stream: chunk
  publication is idempotent per index (first writer of chunk *i* wins, the
  same immutability argument as monolithic first-writer-wins, which already
  presumes deterministic functions), so a duplicate can finish a stream
  that its stalled original never closes and consumers are never wedged.
* On ``close`` the writer also materialises the monolithic value under the
  plain key, so non-streaming consumers (and the engine's sink collection)
  keep working; a reader on a key that was only ever Put monolithically
  falls back to chunking that value locally.
* Fault handling: when a node dies mid-stream (``DStore.fail_node``),
  every stream it owned and had not closed is *aborted*; blocked readers
  raise :class:`StreamBroken` instead of hanging until timeout.

Copy of ``repro/core/stream.py`` for the PyTorch port, which imports
nothing of ``repro``; its code is the reference's, line for line.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator

__all__ = ["StreamBroken", "StreamDirectory", "StreamWriter", "StreamReader",
           "chunk_key", "base_key", "chunk_count", "is_chunk_key",
           "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 1 << 18          # 256 KiB
_PREFETCH_DEPTH = 32             # reader-side bounded chunk queue


_CHUNK_SEP = "::chunk."


def chunk_key(key: str, i: int) -> str:
    """Directory key of one chunk of a stream (immutable, like any key)."""
    return f"{key}{_CHUNK_SEP}{i}"


def base_key(key: str) -> str:
    """Inverse of :func:`chunk_key`: chunk key -> stream key (identity for
    plain keys).  Recovery uses this to map lost *chunk* records back to
    the producer function that must re-run, and DShard's routing tables
    use it so one installed route (the stream key's home) covers every
    chunk of the stream — chunk keys are never routed individually."""
    return key.split(_CHUNK_SEP, 1)[0]


def is_chunk_key(key: str) -> bool:
    """True when ``key`` names one chunk of a stream (router/diagnostics
    helper; avoids leaking the separator constant)."""
    return _CHUNK_SEP in key


def chunk_count(size: int, chunk_size: int = DEFAULT_CHUNK) -> int:
    """Chunks a ``size``-byte stream splits into (at least 1: empty
    streams still emit a terminating chunk record)."""
    if chunk_size <= 0:
        return 1
    return max(1, -(-int(size) // int(chunk_size)))


class StreamBroken(RuntimeError):
    """The producer of a stream failed before closing it."""


@dataclass
class _StreamMeta:
    key: str
    owners: set[str]                          # producing node(s); duplicates
    chunks: dict[int, int] = field(default_factory=dict)   # idx -> size
    total: int | None = None                  # chunk count, set on close
    aborted: bool = False


class StreamDirectory:
    """Directory-service extension holding per-stream/per-chunk metadata.

    Thread-safe; a single condition variable backs every blocking wait (the
    same auto blocking/waking design as :class:`DataDirectoryService`, at
    chunk granularity).  Chunk *bytes* live in the per-node LocalStores
    under :func:`chunk_key` names and move via the normal receiver-driven
    pull path.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._streams: dict[str, _StreamMeta] = {}
        self._plain: set[str] = set()         # keys Put monolithically
        # DCheck hook (see check.py): set via DStore.attach_tracer.  Chunk
        # publishes are recorded by DStore.put_chunk; the directory records
        # the stream-lifecycle events (close/abort) it alone decides.
        self.tracer = None

    # -- producer ----------------------------------------------------------
    def claim(self, key: str, node: str) -> None:
        """Register ``node`` as a producer of the stream.  A duplicate
        (straggler re-issue) becomes a co-writer — chunk publication is
        idempotent per index, safe under the engine's deterministic-function
        premise — so a stalled original cannot wedge consumers.  An aborted
        stream is reset (recovery re-executes the producer)."""
        with self._cv:
            m = self._streams.get(key)
            if m is None or m.aborted:
                self._streams[key] = _StreamMeta(key, {node})
            else:
                m.owners.add(node)
            self._cv.notify_all()

    def publish_chunk(self, key: str, idx: int, size: int) -> None:
        """First writer of chunk ``idx`` wins; later publishes are no-ops."""
        with self._cv:
            self._streams[key].chunks.setdefault(idx, int(size))
            self._cv.notify_all()

    def close(self, key: str, total: int) -> None:
        """Seal the stream at ``total`` chunks (first closer wins)."""
        with self._cv:
            if self.tracer is not None:
                # Every close attempt is recorded (not just the winning
                # one) so divergent co-closer totals are checkable.
                self.tracer.record("stream_close", key, size=total)
            m = self._streams[key]
            if m.total is None:
                m.total = total
            self._cv.notify_all()

    def abort(self, key: str, node: str | None = None) -> None:
        """Producer failure.  With ``node``, only that co-writer withdraws;
        the stream aborts (waking blocked readers with a clean error) when
        no producer remains and it was never closed."""
        with self._cv:
            m = self._streams.get(key)
            if m is None or m.total is not None:
                return
            if node is not None:
                m.owners.discard(node)
                if m.owners:
                    self._cv.notify_all()
                    return
            m.aborted = True
            if self.tracer is not None:
                self.tracer.record("stream_abort", key, node or "")
            self._cv.notify_all()

    def notify_plain(self, key: str) -> None:
        """A monolithic Put happened; wakes ``get_stream`` fallbacks."""
        with self._cv:
            self._plain.add(key)
            self._cv.notify_all()

    def evict_prefix(self, prefix: str) -> None:
        """Instance-scoped eviction: forget every stream (and plain-key
        marker) in a completed instance's namespace.  Chunk *bytes* live in
        the LocalStores and are reclaimed by the caller
        (:meth:`DStore.evict_instance`)."""
        with self._cv:
            for k in [k for k in self._streams if k.startswith(prefix)]:
                del self._streams[k]
            self._plain -= {k for k in self._plain if k.startswith(prefix)}

    def fail_owner(self, node: str) -> None:
        """Fault handling for a dead node.  Streams it co-wrote lose that
        producer; when the last producer of an unclosed stream dies it
        aborts (blocked readers raise :class:`StreamBroken`), and closed
        streams whose last producer died are evicted so a recovery
        re-execution can re-claim and re-publish them."""
        with self._cv:
            for k, m in list(self._streams.items()):
                if node not in m.owners:
                    continue
                m.owners.discard(node)
                if m.owners:
                    continue            # a co-writer is still alive
                if m.total is None:
                    m.aborted = True
                    if self.tracer is not None:
                        self.tracer.record("stream_abort", k, node)
                else:
                    del self._streams[k]
            self._cv.notify_all()

    # -- consumer ----------------------------------------------------------
    def _deadline(self, timeout: float | None) -> float | None:
        return None if timeout is None else time.monotonic() + timeout

    def _remaining(self, deadline: float | None, key: str) -> float | None:
        if deadline is None:
            return None
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            from .dstore import GetTimeout
            raise GetTimeout(f"get_stream({key!r}) timed out")
        return remaining

    def wait_mode(self, key: str, timeout: float | None = None) -> str:
        """Block until ``key`` is either a claimed stream ('stream') or a
        monolithically-Put value ('plain'); streams win ties."""
        deadline = self._deadline(timeout)
        with self._cv:
            while True:
                if key in self._streams:
                    return "stream"
                if key in self._plain:
                    return "plain"
                self._cv.wait(self._remaining(deadline, key))

    def wait_chunk(self, key: str, idx: int,
                   timeout: float | None = None) -> int | None:
        """Block until chunk ``idx`` is published (returns its size) or the
        stream closed below ``idx`` (returns None = end of stream)."""
        deadline = self._deadline(timeout)
        with self._cv:
            while True:
                m = self._streams.get(key)
                if m is not None:
                    if m.aborted:
                        raise StreamBroken(
                            f"stream {key!r}: producer failed before close")
                    if idx in m.chunks:
                        return m.chunks[idx]
                    if m.total is not None and idx >= m.total:
                        return None
                self._cv.wait(self._remaining(deadline, key))


class StreamWriter:
    """Chunked producer handle returned by :meth:`DStore.put_stream`.

    ``write`` buffers bytes and publishes fixed-size chunks as the buffer
    fills; ``close`` flushes the tail chunk, seals the stream, and
    materialises the monolithic value under the plain key.  Usable as a
    context manager.  A duplicate producer (straggler re-issue) co-writes:
    its chunk publishes are idempotent no-ops wherever the original already
    published, and whoever finishes first seals the stream.
    """

    def __init__(self, store: Any, node: str, key: str,
                 chunk_size: int = DEFAULT_CHUNK):
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        self._store = store
        self.node = node
        self.key = key
        self.chunk_size = int(chunk_size)
        self._buf = bytearray()
        self._count = 0
        self._closed = False
        store.streams.claim(key, node)

    def write(self, data: bytes | bytearray | memoryview) -> None:
        if self._closed:
            raise ValueError(f"write to closed stream {self.key!r}")
        self._buf += bytes(data)
        while len(self._buf) >= self.chunk_size:
            self._emit(bytes(self._buf[:self.chunk_size]))
            del self._buf[:self.chunk_size]

    def _emit(self, chunk: bytes) -> None:
        # Chunk bytes live in the local store only (no second copy here);
        # close() re-reads them to build the monolithic twin.
        self._store.put_chunk(self.node, self.key, self._count, chunk)
        self._count += 1

    def abort(self) -> None:
        """This producer failed; the stream breaks when no co-writer
        remains (readers then raise :class:`StreamBroken`)."""
        self._closed = True
        self._store.streams.abort(self.key, self.node)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._buf:
            self._emit(bytes(self._buf))
            self._buf = bytearray()
        self._store.streams.close(self.key, self._count)
        # Monolithic twin for non-streaming Gets / sink collection, built
        # from the chunks already resident in the local store.  If the node
        # was failed mid-stream (chunks wiped under us), surface it as
        # StreamBroken: the engine's retry re-runs the producer, which
        # rewrites every chunk idempotently and closes cleanly.
        local = self._store.stores[self.node]
        try:
            whole = b"".join(local.read(chunk_key(self.key, i))
                             for i in range(self._count))
        except KeyError:
            raise StreamBroken(
                f"stream {self.key!r}: local chunks lost before close "
                f"(node failed mid-stream)") from None
        self._store.put(self.node, self.key, whole)

    def __enter__(self) -> "StreamWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class StreamReader:
    """Blocking chunk iterator returned by :meth:`DStore.get_stream`.

    A background prefetcher pulls chunks (receiver-driven, registering the
    consumer-side replica per chunk) as soon as the producer publishes them,
    bounded to ``_PREFETCH_DEPTH`` chunks of look-ahead, so network pulls
    overlap both the producer's emission and the consumer's processing.
    Falls back to locally chunking a monolithic value when the key was only
    ever Put whole.
    """

    def __init__(self, store: Any, node: str, key: str,
                 timeout: float | None = None, prefetch: bool = True):
        self._store = store
        self.node = node
        self.key = key
        self.timeout = timeout
        self._prefetch = prefetch
        self._queue: queue.Queue | None = None
        self._plain_iter: Iterator[bytes] | None = None
        self._idx = 0
        self._started = False

    # -- iteration ---------------------------------------------------------
    def __iter__(self) -> "StreamReader":
        return self

    def __next__(self) -> Any:
        if not self._started:
            self._start()
        if self._plain_iter is not None:
            return next(self._plain_iter)
        if self._queue is not None:
            item = self._queue.get()
            if item is _EOS:
                self._queue.put(_EOS)        # keep subsequent next() clean
                raise StopIteration
            if isinstance(item, BaseException):
                self._queue.put(item)
                raise item
            return item
        return self._next_sync()

    def read_all(self) -> bytes:
        """Drain the stream and return the concatenated bytes."""
        return b"".join(self)

    # -- internals ---------------------------------------------------------
    def _start(self) -> None:
        self._started = True
        # DScope: the prefetch pump runs on its own thread, so the span
        # context active *here* (the consumer's invocation span) is
        # captured explicitly and re-activated inside the pump — the
        # per-chunk Get spans it emits then parent correctly.
        spans = getattr(self._store, "_spans", None)
        self._span_parent = spans.current() if spans is not None else None
        mode = self._store.streams.wait_mode(self.key, self.timeout)
        if mode == "plain":
            value = self._store.get(self.node, self.key, timeout=self.timeout)
            self._plain_iter = iter(_chunked(value))
            return
        if self._prefetch:
            self._queue = queue.Queue(maxsize=_PREFETCH_DEPTH)
            th = threading.Thread(target=self._pump, daemon=True,
                                  name=f"dstream-pull-{self.key}")
            th.start()

    def _observe_chunk(self, elapsed: float) -> None:
        metrics = getattr(self._store, "_metrics", None)
        if metrics is not None:
            metrics.histogram("stream_chunk_seconds").observe(elapsed)

    def _pump(self) -> None:
        assert self._queue is not None
        spans = getattr(self._store, "_spans", None)
        ctx = spans.activate(self._span_parent) if spans is not None \
            else nullcontext()
        i = 0
        try:
            with ctx:
                while True:
                    t0 = time.monotonic()
                    size = self._store.streams.wait_chunk(self.key, i,
                                                          self.timeout)
                    if size is None:
                        self._queue.put(_EOS)
                        return
                    data = self._store.get(self.node,
                                           chunk_key(self.key, i),
                                           timeout=self.timeout)
                    self._observe_chunk(time.monotonic() - t0)
                    self._queue.put(data)
                    i += 1
        except BaseException as exc:          # noqa: BLE001 - hand to reader
            self._queue.put(exc)

    def _next_sync(self) -> Any:
        t0 = time.monotonic()
        size = self._store.streams.wait_chunk(self.key, self._idx,
                                              self.timeout)
        if size is None:
            raise StopIteration
        data = self._store.get(self.node, chunk_key(self.key, self._idx),
                               timeout=self.timeout)
        self._observe_chunk(time.monotonic() - t0)
        self._idx += 1
        return data


class _EOSType:
    __slots__ = ()

    def __repr__(self) -> str:               # pragma: no cover - debug aid
        return "<end-of-stream>"


_EOS = _EOSType()


def _chunked(value: Any, chunk: int = DEFAULT_CHUNK) -> Iterable[Any]:
    """Monolithic-fallback chunking: bytes split at ``chunk``; anything
    else is delivered as a single-item stream."""
    if isinstance(value, (bytes, bytearray, memoryview)):
        b = bytes(value)
        return (b[i:i + chunk] for i in range(0, len(b), chunk))
    return (value,)
