"""Deterministic discrete-event simulation kernel.

A minimal SimPy-like engine: processes are Python generators that ``yield``
:class:`Event` objects and are resumed when the event triggers.  Determinism
is total — the event heap is ordered by (time, sequence) and no wall-clock or
RNG state is consulted — so every paper-figure experiment is exactly
reproducible.

Also provides the two resource models the cluster simulation needs:

* :class:`Resource` — counted semaphore (CPU cores, container slots).
* :class:`Network`  — node-uplink/downlink constrained flows with **max-min
  fair sharing**, the standard fluid model for TCP-like bandwidth division.
  This is what lets the simulator reproduce DFlow's receiver-driven
  bandwidth-utilisation results: when CFlow funnels every transfer through
  the master node, the master's links saturate and per-flow rates collapse;
  DFlow's node-to-node pulls spread across all links.

Copy of ``repro/core/sim.py`` for the PyTorch port, which imports nothing of
``repro``; its code is the reference's, line for line, with no departure.
"""

from __future__ import annotations

import heapq
import math
from typing import Any, Callable, Generator, Iterable

__all__ = ["Env", "Event", "Process", "Resource", "Network", "all_of"]


class Event:
    """One-shot event; processes wait on it, ``trigger`` resumes them."""

    __slots__ = ("env", "triggered", "value", "_waiters")

    def __init__(self, env: "Env"):
        self.env = env
        self.triggered = False
        self.value: Any = None
        self._waiters: list[Callable[[Any], None]] = []

    def trigger(self, value: Any = None) -> None:
        if self.triggered:
            raise RuntimeError("event triggered twice")
        self.triggered = True
        self.value = value
        waiters, self._waiters = self._waiters, []
        for cb in waiters:
            self.env._immediate(cb, value)

    def add_waiter(self, cb: Callable[[Any], None]) -> None:
        if self.triggered:
            self.env._immediate(cb, self.value)
        else:
            self._waiters.append(cb)


class Process(Event):
    """A running generator; is itself an Event that triggers on return."""

    __slots__ = ("gen",)

    def __init__(self, env: "Env", gen: Generator):
        super().__init__(env)
        self.gen = gen
        env._immediate(self._step, None)

    def _step(self, value: Any) -> None:
        try:
            ev = self.gen.send(value)
        except StopIteration as stop:
            self.trigger(stop.value)
            return
        if not isinstance(ev, Event):
            raise TypeError(f"process yielded non-Event {ev!r}")
        ev.add_waiter(self._step)


class Env:
    """Event loop with a virtual clock."""

    def __init__(self) -> None:
        self.now = 0.0
        self._heap: list[tuple[float, int, Callable, Any]] = []
        self._seq = 0

    # -- scheduling -----------------------------------------------------
    def _at(self, t: float, cb: Callable, value: Any = None) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, cb, value))

    def _immediate(self, cb: Callable, value: Any = None) -> None:
        self._at(self.now, cb, value)

    def timeout(self, delay: float, value: Any = None) -> Event:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        ev = Event(self)
        self._at(self.now + delay, ev.trigger, value)
        return ev

    def event(self) -> Event:
        return Event(self)

    def process(self, gen: Generator) -> Process:
        return Process(self, gen)

    # -- run ------------------------------------------------------------
    def run(self, until: float | None = None) -> None:
        while self._heap:
            t, _, cb, value = self._heap[0]
            if until is not None and t > until:
                self.now = until
                return
            heapq.heappop(self._heap)
            self.now = t
            cb(value)
        if until is not None:
            self.now = until


def all_of(env: Env, events: Iterable[Event]) -> Event:
    """Event that triggers when every input event has triggered."""
    events = list(events)
    done = env.event()
    remaining = len(events)
    if remaining == 0:
        env._immediate(done.trigger, [])
        return done
    values: list[Any] = [None] * remaining

    def mk(i: int):
        def cb(v: Any) -> None:
            nonlocal remaining
            values[i] = v
            remaining -= 1
            if remaining == 0:
                done.trigger(values)
        return cb

    for i, ev in enumerate(events):
        ev.add_waiter(mk(i))
    return done


class Resource:
    """Counted resource (e.g. CPU cores).  FIFO grant order."""

    def __init__(self, env: Env, capacity: int):
        self.env = env
        self.capacity = capacity
        self.in_use = 0
        self._queue: list[Event] = []

    def acquire(self) -> Event:
        ev = self.env.event()
        if self.in_use < self.capacity:
            self.in_use += 1
            self.env._immediate(ev.trigger, None)
        else:
            self._queue.append(ev)
        return ev

    def release(self) -> None:
        if self._queue:
            ev = self._queue.pop(0)
            self.env._immediate(ev.trigger, None)
        else:
            self.in_use -= 1
            if self.in_use < 0:
                raise RuntimeError("release without acquire")

    @property
    def queued(self) -> int:
        return len(self._queue)


class _Flow:
    __slots__ = ("src", "dst", "size", "remaining", "rate", "done", "tag")

    def __init__(self, src: str, dst: str, size: float, done: Event, tag: str):
        self.src = src
        self.dst = dst
        self.size = float(size)
        self.remaining = float(size)
        self.rate = 0.0
        self.done = done
        self.tag = tag


class Network:
    """Max-min fair fluid network over per-node uplink/downlink capacities.

    ``transfer(src, dst, size)`` returns an Event triggered when the last
    byte arrives.  All concurrent flows continuously share bandwidth under
    max-min fairness (waterfilling over the 2·N link capacities); rates are
    re-solved whenever a flow starts or finishes.  A transfer log
    ``(src, dst, bytes, t_start, t_end, tag)`` feeds the bandwidth-
    utilisation metric (paper Fig. 9/10 discussion).
    """

    def __init__(self, env: Env, uplink: dict[str, float],
                 downlink: dict[str, float], latency: float = 0.0005):
        self.env = env
        self.uplink = dict(uplink)
        self.downlink = dict(downlink)
        self.latency = latency
        self._flows: list[_Flow] = []
        self._last_update = 0.0
        self._timer_version = 0
        self.log: list[tuple[str, str, float, float, float, str]] = []
        self._starts: dict[int, float] = {}
        # Union of intervals with >=1 active flow: the denominator of the
        # achieved-bandwidth metric (bytes moved / time spent moving them).
        self.busy_time = 0.0
        self._busy_since: float | None = None

    # -- public ----------------------------------------------------------
    def transfer(self, src: str, dst: str, size: float, tag: str = "") -> Event:
        done = self.env.event()
        if src == dst or size <= 0:
            self.env._immediate(done.trigger, None)
            return done
        flow = _Flow(src, dst, size, done, tag)
        # Wire latency before the flow joins the fluid model.
        def start(_):
            self._advance()
            if not self._flows:
                self._busy_since = self.env.now
            self._flows.append(flow)
            self._starts[id(flow)] = self.env.now
            self._resolve()
        self.env._at(self.env.now + self.latency, start)
        return done

    def active_bytes_per_sec(self) -> float:
        return sum(f.rate for f in self._flows)

    # -- fluid model -------------------------------------------------------
    def _advance(self) -> None:
        """Account progress of all flows since the last rate change."""
        dt = self.env.now - self._last_update
        if dt > 0:
            for f in self._flows:
                f.remaining -= f.rate * dt
        self._last_update = self.env.now

    def _resolve(self) -> None:
        """Recompute max-min fair rates and reschedule next completion."""
        flows = self._flows
        if not flows:
            self._timer_version += 1
            return
        # Waterfilling: resources are ("up", node) and ("down", node).
        cap: dict[tuple[str, str], float] = {}
        members: dict[tuple[str, str], list[_Flow]] = {}
        for f in flows:
            up, down = ("up", f.src), ("down", f.dst)
            cap.setdefault(up, self.uplink.get(f.src, math.inf))
            cap.setdefault(down, self.downlink.get(f.dst, math.inf))
            members.setdefault(up, []).append(f)
            members.setdefault(down, []).append(f)
        fixed: dict[int, float] = {}
        live = {r for r in cap}
        while len(fixed) < len(flows) and live:
            best_r, best_share = None, math.inf
            for r in live:
                unfixed = [f for f in members[r] if id(f) not in fixed]
                if not unfixed:
                    continue
                share = cap[r] / len(unfixed)
                if share < best_share:
                    best_share, best_r = share, r
            if best_r is None:
                break
            for f in members[best_r]:
                if id(f) not in fixed:
                    fixed[id(f)] = best_share
                    for r2 in (("up", f.src), ("down", f.dst)):
                        if r2 != best_r:
                            cap[r2] -= best_share
            live.discard(best_r)
        for f in flows:
            f.rate = fixed.get(id(f), math.inf)
        # Next completion.
        self._timer_version += 1
        version = self._timer_version
        t_next = min((f.remaining / f.rate if f.rate > 0 else math.inf)
                     for f in flows)
        if math.isinf(t_next):
            raise RuntimeError("flow with zero rate and no completion")
        target = self.env.now + max(t_next, 0.0)
        if target <= self.env.now:          # guarantee clock progress
            target = math.nextafter(self.env.now, math.inf)
        self.env._at(target, lambda _: self._on_timer(version))

    def _on_timer(self, version: int) -> None:
        if version != self._timer_version:
            return  # stale timer; rates changed since
        self._advance()
        still: list[_Flow] = []
        for f in self._flows:
            # Completion tolerance must scale with the rate: a sub-byte
            # remainder whose drain time is below the float64 ULP of `now`
            # would otherwise stall the clock (resolve→timer at +0 forever).
            eps = 1e-6 + f.rate * 1e-9
            if f.remaining <= eps:
                t0 = self._starts.pop(id(f))
                self.log.append((f.src, f.dst, f.size, t0, self.env.now, f.tag))
                f.done.trigger(None)
            else:
                still.append(f)
        self._flows = still
        if not still and self._busy_since is not None:
            self.busy_time += self.env.now - self._busy_since
            self._busy_since = None
        self._resolve()
