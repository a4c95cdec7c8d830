"""DCheck dynamic half — dataflow trace recording + invariant checking.

The §3.3 design note that "data in DStore is immutable" is carrying far
more weight than one sentence suggests: it is what makes duplicate
(straggler) re-execution safe, what lets a Get trust *any* replica, and
what allows instance-scoped eviction to reclaim keys without a reader
census.  This module makes those load-bearing invariants checkable:

* :class:`TraceRecorder` — a thread-safe event log with a global logical
  clock.  :class:`~repro.core.dstore.DStore` and
  :class:`~repro.core.stream.StreamDirectory` carry a *zero-cost-when-off*
  hook (``if self._tracer is not None``): attaching a recorder turns every
  put / metadata publish / get / chunk publish / evict / node failure into
  a :class:`TraceEvent`.  Events carry a content digest where the value is
  digestable, so equality claims are checkable offline.
* **Stress mode** — the recorder optionally injects tiny seeded random
  sleeps at instrumentation points (``stress=<seed>``), perturbing thread
  interleavings exactly where the data plane's ordering decisions are
  made, so a test run actually explores schedules instead of re-observing
  the same lucky one.
* :class:`TraceChecker` — offline replay of a recorded trace verifying
  four invariant classes:

  - **ordering** ("happens-before"): no ``get_return`` yields a value
    that was never made available (put / replica / publish) earlier in
    the trace, and the returned bytes match a published digest;
  - **immutability** (single producer): every write of one key carries
    one content digest — divergent co-writes are flagged;
  - **eviction safety**: no ``evict`` of a key while a reader is
    in-flight (``get_block`` without a matching return/fail);
  - **chunk sequence**: a closed stream's chunk indices are exactly
    ``0..total-1``, closes agree on ``total``, and duplicate chunk
    publishes are byte-identical;
  - **routing** (DShard, see router.py): every routed Get resolves in
    exactly one hop (``route`` events with ``hops != 1`` — a stale-table
    misroute or directory bounce — are hard failures), and it resolves at
    the key's producing shard (the home announced by the put/publish
    events' ``src``).

Recording points sit *before* the mutation they describe (inside the same
lock that orders the mutation), so trace order is a faithful linearization:
bytes can never be observed by a reader before the event that announces
them was recorded.

Copy of ``repro/core/check.py`` for the PyTorch port, which imports nothing
of ``repro``. One change: :func:`content_digest` knows torch tensors. The
reference digests an array through its ``tobytes``, which a torch tensor
lacks, so a verbatim copy would call every tensor opaque. Here a CPU tensor
is digested as its dtype, shape and raw bytes (bf16 and every other dtype
read as bytes), so a co-write of divergent CPU tensors raises
:class:`~repro_torch.core.dstore.ImmutabilityError` as a numpy array does.
A tensor on the card is **opaque** (``None``): its bytes would have to come
to the host, which waits for every kernel queued before it, on every Put,
and would serialize the overlap the engine exists for. A workflow whose
values live on the card therefore gets no divergence check from DStore;
the port's ``run_training`` refuses straggler duplicates for that reason.
"""

from __future__ import annotations

import hashlib
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterable

__all__ = ["TraceEvent", "TraceRecorder", "Violation", "TraceChecker",
           "PlanConformance", "content_digest"]


def content_digest(value: Any) -> str | None:
    """Stable hex digest of a value's content, or None when the value is
    opaque (no reliable byte representation — e.g. objects whose repr
    embeds a memory address, which would make identical re-executions
    look divergent)."""
    h = hashlib.blake2b(digest_size=16)
    if _feed(h, value):
        return h.hexdigest()
    return None


def _feed(h, value: Any) -> bool:
    if isinstance(value, (bytes, bytearray, memoryview)):
        h.update(b"b")
        h.update(bytes(value))
        return True
    if isinstance(value, str):
        h.update(b"s")
        h.update(value.encode())
        return True
    if value is None or isinstance(value, (bool, int, float)):
        h.update(repr(value).encode())
        return True
    if isinstance(value, (tuple, list)):
        h.update(b"l%d" % len(value))
        return all(_feed(h, v) for v in value)
    if isinstance(value, dict):
        h.update(b"d%d" % len(value))
        try:
            items = sorted(value.items())
        except TypeError:
            return False
        return all(_feed(h, k) and _feed(h, v) for k, v in items)
    torch = sys.modules.get("torch")    # no tensor exists before its import
    if torch is not None and isinstance(value, torch.Tensor):
        return _feed_tensor(h, torch, value)
    tobytes = getattr(value, "tobytes", None)   # numpy/jax arrays
    if tobytes is not None:
        try:
            h.update(b"a")
            h.update(repr(getattr(value, "dtype", "")).encode())
            h.update(repr(getattr(value, "shape", "")).encode())
            h.update(tobytes())
            return True
        except Exception:       # pragma: no cover - exotic array types
            return False
    return False


def _feed_tensor(h, torch, t) -> bool:
    """A CPU tensor's dtype, shape and bytes; any other tensor is opaque
    (reading a CUDA tensor's bytes would synchronize the card)."""
    if t.device.type != "cpu" or t.layout != torch.strided:
        return False
    try:
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    except RuntimeError:    # pragma: no cover - quantized and other exotics
        return False
    h.update(b"t")
    h.update(repr(t.dtype).encode())
    h.update(repr(tuple(t.shape)).encode())
    h.update(raw.numpy().tobytes())
    return True


@dataclass(frozen=True)
class TraceEvent:
    """One recorded data-plane action, ordered by a global logical clock."""

    clock: int
    kind: str         # put | publish | replica | get_block | get_return |
    #                   get_fail | put_chunk | stream_close | stream_abort |
    #                   evict | drop | fail_node
    key: str = ""
    node: str = ""
    idx: int | None = None           # chunk index (put_chunk)
    size: int = 0
    digest: str | None = None        # content digest; None = opaque value
    src: str = ""                    # DShard: key's home shard (put/route)
    tier: str = ""                   # DShard transport tier (route events)
    hops: int = 0                    # DShard: shard contacts for one Get

    def __str__(self) -> str:        # pragma: no cover - debugging aid
        extra = f"[{self.idx}]" if self.idx is not None else ""
        return (f"@{self.clock} {self.kind} {self.key}{extra} "
                f"({self.node})")


class TraceRecorder:
    """Append-only, thread-safe event log with optional schedule stress.

    ``stress`` seeds an LCG that injects a 0–1 ms sleep at roughly one in
    three instrumentation points.  The sleeps land *inside* the data
    plane's critical sections and wait loops — exactly where a different
    thread interleaving changes which replica a Get sees or whether a
    publish beats a block — so repeated runs with different seeds explore
    genuinely different schedules.
    """

    def __init__(self, *, stress: int | None = None,
                 stress_max_s: float = 0.001):
        self._lock = threading.Lock()
        self._events: list[TraceEvent] = []
        self._clock = 0
        self._stress = None if stress is None else (
            (stress * 2654435761 + 0x9E3779B9) & 0xFFFFFFFF)
        self._stress_max = float(stress_max_s)

    def record(self, kind: str, key: str = "", node: str = "", *,
               idx: int | None = None, size: int = 0,
               digest: str | None = None, src: str = "",
               tier: str = "", hops: int = 0) -> TraceEvent:
        delay = 0.0
        with self._lock:
            self._clock += 1
            ev = TraceEvent(self._clock, kind, key, node,
                            idx=idx, size=size, digest=digest,
                            src=src, tier=tier, hops=hops)
            self._events.append(ev)
            if self._stress is not None:
                self._stress = (1103515245 * self._stress + 12345) \
                    & 0x7FFFFFFF
                u = self._stress / 0x7FFFFFFF
                if u < 0.34:
                    delay = u * 3.0 * self._stress_max
        if delay:
            time.sleep(delay)
        return ev

    def tick(self) -> int:
        """Advance and return the logical clock without recording an
        event — lets DScope spans share this ordering domain so span
        ``seq`` values interleave consistently with trace events."""
        with self._lock:
            self._clock += 1
            return self._clock

    def events(self) -> list[TraceEvent]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


@dataclass(frozen=True)
class Violation:
    """One invariant breach found by :class:`TraceChecker`."""

    invariant: str       # ordering | immutability | eviction |
    #                      chunk_sequence | routing
    message: str
    events: tuple[TraceEvent, ...] = ()

    def __str__(self) -> str:
        return f"[{self.invariant}] {self.message}"


# Events that make a key's value observable to readers.
_AVAILABILITY = ("put", "replica", "publish")


@dataclass
class _KeyState:
    digests: set[str] = field(default_factory=set)   # non-opaque writes
    available: bool = False
    opaque_writes: int = 0
    in_flight: dict[str, int] = field(default_factory=dict)  # node -> gets
    first_write: TraceEvent | None = None
    home: str = ""       # DShard: producing shard (from put/publish src)


class TraceChecker:
    """Offline replay of a recorded trace against the DFlow invariants.

    ``check`` returns every violation found (empty list = trace is
    consistent).  The checker is conservative about opaque values (digest
    None): it never claims divergence it cannot prove.
    """

    def check(self, events: Iterable[TraceEvent]) -> list[Violation]:
        out: list[Violation] = []
        keys: dict[str, _KeyState] = {}
        # stream key -> {idx: (digest, event)}; closes: key -> totals
        chunks: dict[str, dict[int, tuple[str | None, TraceEvent]]] = {}
        closes: dict[str, list[TraceEvent]] = {}
        aborted: set[str] = set()

        def st(key: str) -> _KeyState:
            return keys.setdefault(key, _KeyState())

        def judge_stream(key: str) -> None:
            """Coverage/total checks for one completed stream generation."""
            close_evs = closes[key]
            totals = {e.size for e in close_evs}
            if len(totals) > 1:
                out.append(Violation(
                    "chunk_sequence",
                    f"stream {key!r} closed with divergent totals "
                    f"{sorted(totals)}", tuple(close_evs)))
                return
            total = totals.pop()
            idxs = set(chunks.get(key, ()))
            beyond = {i for i in idxs if i >= total}
            missing = set(range(total)) - idxs
            if beyond:
                out.append(Violation(
                    "chunk_sequence",
                    f"stream {key!r} published chunk(s) {sorted(beyond)} "
                    f"at/after its close total {total}",
                    tuple(chunks[key][i][1] for i in sorted(beyond))))
            if missing:
                out.append(Violation(
                    "chunk_sequence",
                    f"stream {key!r} closed at total {total} but "
                    f"chunk(s) {sorted(missing)} were never published",
                    tuple(close_evs)))

        for ev in sorted(events, key=lambda e: e.clock):
            s = st(ev.key) if ev.key else None
            if ev.kind in _AVAILABILITY:
                s.available = True
                if ev.src:
                    s.home = ev.src      # last announced home shard wins
                if s.first_write is None:
                    s.first_write = ev
                if ev.digest is None:
                    s.opaque_writes += 1
                else:
                    s.digests.add(ev.digest)
                    # -- immutability: all writes of one key agree.
                    if len(s.digests) > 1:
                        out.append(Violation(
                            "immutability",
                            f"key {ev.key!r} written with divergent "
                            f"content ({len(s.digests)} distinct "
                            f"digests); first write {s.first_write}",
                            (s.first_write, ev)))
            elif ev.kind == "get_block":
                s.in_flight[ev.node] = s.in_flight.get(ev.node, 0) + 1
            elif ev.kind in ("get_return", "get_fail"):
                n = s.in_flight.get(ev.node, 0)
                if n > 0:
                    s.in_flight[ev.node] = n - 1
                if ev.kind == "get_return":
                    # -- ordering: the value must have been made
                    # available earlier in the trace, with matching
                    # content where both sides are digestable.
                    if not s.available:
                        out.append(Violation(
                            "ordering",
                            f"Get({ev.key!r}) on {ev.node!r} returned at "
                            f"clock {ev.clock} but no put/publish of "
                            "that key precedes it", (ev,)))
                    elif (ev.digest is not None and s.digests
                          and ev.digest not in s.digests):
                        out.append(Violation(
                            "ordering",
                            f"Get({ev.key!r}) returned bytes that match "
                            "no published content for that key "
                            "(stale or torn read)", (ev,)))
            elif ev.kind == "route":
                # -- routing (DShard): a routed Get contacts exactly one
                # shard — the key's statically-known producing shard.
                if ev.hops != 1:
                    out.append(Violation(
                        "routing",
                        f"Get({ev.key!r}) on {ev.node!r} resolved in "
                        f"{ev.hops} hop(s) (stale-table misroute or "
                        "directory bounce); DShard requires exactly 1",
                        (ev,)))
                if ev.src and s.home and ev.src != s.home:
                    out.append(Violation(
                        "routing",
                        f"Get({ev.key!r}) resolved at shard {ev.src!r} "
                        f"but the key's producing shard is {s.home!r}",
                        (ev,)))
            elif ev.kind == "put_chunk":
                rec = chunks.setdefault(ev.key, {})
                prev = rec.get(ev.idx)
                if prev is None:
                    rec[ev.idx] = (ev.digest, ev)
                else:
                    pd, pev = prev
                    # -- chunk co-writes must be byte-identical.
                    if pd is not None and ev.digest is not None \
                            and pd != ev.digest:
                        out.append(Violation(
                            "chunk_sequence",
                            f"stream {ev.key!r} chunk {ev.idx} co-written "
                            "with divergent bytes", (pev, ev)))
            elif ev.kind == "stream_close":
                closes.setdefault(ev.key, []).append(ev)
            elif ev.kind == "stream_abort":
                aborted.add(ev.key)
            elif ev.kind == "evict":
                # -- eviction safety: no reclaim under an in-flight read.
                readers = sum(s.in_flight.values())
                if readers:
                    out.append(Violation(
                        "eviction",
                        f"key {ev.key!r} evicted at clock {ev.clock} "
                        f"with {readers} reader(s) still in flight",
                        (ev,)))
                # Eviction ends the key's lifetime: a later instance may
                # legitimately reuse the name (serving restarts instance
                # numbering per run), so judge any completed stream
                # generation now and reset the key's state.
                if ev.key in closes:
                    judge_stream(ev.key)
                chunks.pop(ev.key, None)
                closes.pop(ev.key, None)
                aborted.discard(ev.key)
                keys[ev.key] = _KeyState()
            elif ev.kind in ("drop", "fail_node"):
                # Fault path: replicas vanish; recovery re-publishes.
                if s is not None:
                    s.available = False

        # -- chunk-sequence closure checks (end of trace).
        for key in closes:
            judge_stream(key)
        # Streams with chunks but neither close nor abort leaked.
        for key in chunks:
            if key not in closes and key not in aborted:
                out.append(Violation(
                    "chunk_sequence",
                    f"stream {key!r} published chunks but was never "
                    "closed or aborted", ()))
        return out

    def check_or_raise(self, events: Iterable[TraceEvent]) -> None:
        violations = self.check(events)
        if violations:
            lines = "\n  ".join(str(v) for v in violations)
            raise AssertionError(
                f"trace violates {len(violations)} dataflow "
                f"invariant(s):\n  {lines}")


# Container-lifecycle events (recorded by serve.ContainerService, key =
# image) that change the count of unleased — bootable-into — containers.
_CONTAINER_DELTA = {"prewarm_boot": 1, "container_release": 1,
                    "warm_hit": -1, "prewarm_hit": -1, "container_evict": -1}


class PlanConformance:
    """Replay a recorded trace against a static :class:`~repro.core.plan.
    WorkflowPlan` (duck-typed: anything with ``eviction_reads``) and flag
    dynamic events that contradict a static claim.

    * ``plan_eviction`` — a read (Get or replica pull) of a planned key
      after its evict event, or more ``get_return``\\ s of a key than the
      plan's statically-derived read count: either means the liveness
      analysis under-counted consumers, so the "provably-safe" eviction
      was not safe.  An evict *before* the count is reached is legal —
      instance-scoped eviction mops up at completion.
    * ``plan_prewarm`` — a cold boot paid while an unleased container of
      the same (node, image) existed in the trace: the boot the prewarm
      schedule issued was available, so the request path should not have
      paid a cold start.

    ``instances`` lists the key-namespace instances the plan was applied
    to (``""`` = un-namespaced single run); container events are global.
    """

    def __init__(self, plan):
        self.plan = plan

    def check(self, events: Iterable[TraceEvent], *,
              instances: Iterable[str] = ("",)) -> list[Violation]:
        planned: dict[str, int] = {}
        for inst in instances:
            prefix = f"{inst}:" if inst else ""
            for k, n in self.plan.eviction_reads.items():
                planned[prefix + k] = n
        out: list[Violation] = []
        seen: dict[str, int] = {}
        evicted: dict[str, TraceEvent] = {}
        unleased: dict[tuple[str, str], int] = {}
        for ev in sorted(events, key=lambda e: e.clock):
            if ev.kind in ("get_block", "get_return", "replica"):
                if ev.key not in planned:
                    continue
                first_evict = evicted.get(ev.key)
                if first_evict is not None:
                    out.append(Violation(
                        "plan_eviction",
                        f"key {ev.key!r} observed by {ev.kind} at clock "
                        f"{ev.clock} after its planned eviction at clock "
                        f"{first_evict.clock} — the liveness analysis "
                        "missed a consumer", (first_evict, ev)))
                if ev.kind == "get_return":
                    seen[ev.key] = seen.get(ev.key, 0) + 1
                    if seen[ev.key] > planned[ev.key]:
                        out.append(Violation(
                            "plan_eviction",
                            f"key {ev.key!r} returned {seen[ev.key]} "
                            f"Gets but the plan claims exactly "
                            f"{planned[ev.key]} reads", (ev,)))
            elif ev.kind == "evict":
                if ev.key in planned:
                    evicted.setdefault(ev.key, ev)
            elif ev.kind == "cold_boot":
                n = unleased.get((ev.node, ev.key), 0)
                if n > 0:
                    out.append(Violation(
                        "plan_prewarm",
                        f"cold boot of {ev.key!r} on {ev.node!r} at clock "
                        f"{ev.clock} while {n} unleased container(s) "
                        "existed — the prewarm schedule had hidden this "
                        "boot and the request path paid it anyway", (ev,)))
            elif ev.kind in _CONTAINER_DELTA:
                kk = (ev.node, ev.key)
                unleased[kk] = max(
                    0, unleased.get(kk, 0) + _CONTAINER_DELTA[ev.kind])
        return out

    def check_or_raise(self, events: Iterable[TraceEvent], *,
                       instances: Iterable[str] = ("",)) -> None:
        violations = self.check(events, instances=instances)
        if violations:
            lines = "\n  ".join(str(v) for v in violations)
            raise AssertionError(
                f"trace contradicts the plan in {len(violations)} "
                f"place(s):\n  {lines}")
