"""DScheduler — real (threaded) two-tier scheduler executing callables.

The executable twin of the simulator's scheduling logic (§3.2):

* :class:`GlobalScheduler` — partitions the workflow onto nodes (same
  locality-first GS as the simulator / FaaSFlow) and pushes metadata
  (entry points, successor lists, placements) to the local schedulers.
* :class:`InstanceRun` — one in-flight workflow instance implementing
  paper Algorithm 1 (dataflow) or the FaaSFlow-style baseline
  (controlflow).  Each launched function runs in its own thread,
  immediately calls ``Get`` for every input (fine-grained retrieval: one
  blocking fetch per input), executes when the data arrives, and ``Put``s
  its outputs, which wakes downstream blocked fetches.  Execution is
  therefore out-of-order and overlap-rich.
* :class:`DFlowEngine` — facade: ``run()`` executes one instance on a
  private DStore (the classic single-shot path); ``start()`` returns the
  :class:`InstanceRun` so a serving layer (:class:`repro.core.serve.DServe`)
  can drive many concurrent instances over a *shared* DStore with
  per-instance key namespacing and a shared container service.

Serving integration (paper §3.2 cold-start optimization): when the engine
carries a container service, every function acquires a container before
fetching inputs, and — under the dataflow pattern with ``prewarm`` — the
containers of a function's successors start booting the moment the
function *launches* (precursor launch, not input arrival), so boot time
overlaps precursor execution instead of sitting on the critical path.

Beyond-paper (documented in DESIGN.md §7): duplicate-issue straggler
mitigation (first-writer-wins is safe because DStore data is immutable) and
incremental fault recovery (only functions whose outputs were lost re-run;
the paper's §3.3.5 restarts the whole workflow).

Copy of ``repro/core/dscheduler.py`` for the PyTorch port, which imports
nothing of ``repro``. One change: a DScale prewarm ``budget`` raises
:class:`NotImplementedError` when an instance is built with one, since
``scale.py`` is not copied (ROADMAP A.15); the reference imports it lazily
where a budget is first used. ``plan``, ``containers`` and ``spans`` stay
duck-typed, as in the reference, so DPlan, DServe's container service and
DScope objects of a later copy plug in unchanged.
"""

from __future__ import annotations

import math
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Mapping

from .dag import FunctionSpec, Workflow
from .dstore import DStore, Transport
from .partition import partition_workflow, stage_node
from .router import ShardedDStore
from .stream import StreamBroken, base_key

__all__ = ["GlobalScheduler", "DFlowEngine", "InstanceRun", "RunReport",
           "dataflow_initial_frontier", "dataflow_next_frontier"]


def dataflow_initial_frontier(wf: Workflow) -> list[str]:
    """Algorithm 1 lines 1-7: entry points + their direct successors."""
    out: list[str] = []
    for e in wf.entry_points:
        out.append(e)
        out.extend(wf.successors[e])
    return list(dict.fromkeys(out))


def dataflow_next_frontier(wf: Workflow, finished: str) -> list[str]:
    """Algorithm 1 lines 8-15: successors of the finished fn's successors."""
    out: list[str] = []
    for s in wf.successors[finished]:
        out.extend(wf.successors[s])
    return list(dict.fromkeys(out))


@dataclass
class RunReport:
    outputs: dict[str, Any]
    wall_time: float
    per_function: dict[str, float] = field(default_factory=dict)
    transfers: int = 0
    bytes_moved: int = 0
    reexecuted: list[str] = field(default_factory=list)
    duplicates_won: list[str] = field(default_factory=list)
    cold_starts: int = 0            # request-path cold boots this instance


class GlobalScheduler:
    """Partition + metadata push (paper §3.2)."""

    def __init__(self, nodes: list[str]):
        self.nodes = list(nodes)

    def assign(self, wf: Workflow) -> dict[str, str]:
        return partition_workflow(wf, self.nodes)


class _InstanceState:
    def __init__(self, wf: Workflow):
        self.lock = threading.Lock()
        self.launched: set[str] = set()
        self.completed: dict[str, float] = {}
        self.failed: dict[str, BaseException] = {}
        self.all_done = threading.Event()
        self.wf = wf

    def mark_done(self, fname: str, t: float) -> None:
        with self.lock:
            self.completed[fname] = t
            if len(self.completed) == len(self.wf.functions):
                self.all_done.set()

    def mark_failed(self, fname: str, exc: BaseException) -> None:
        with self.lock:
            self.failed[fname] = exc
            self.all_done.set()


class InstanceRun:
    """One workflow instance in flight.

    Namespacing: when ``instance`` is set, every DStore key (external
    inputs, function outputs, stream chunks) is stored as
    ``"<instance>:<key>"`` so concurrent instances sharing one DStore never
    collide — the real-path twin of the simulator's ``key(inst, k)``.
    """

    def __init__(self, engine: "DFlowEngine", wf: Workflow,
                 inputs: Mapping[str, Any] | None, *,
                 store: DStore | None = None, instance: str | None = None,
                 placement: dict[str, str] | None = None,
                 inject_failure: str | None = None,
                 plan=None, spans=None, budget=None):
        self.engine = engine
        self.wf = wf
        self.inputs = dict(inputs or {})
        if store is not None:
            self.store = store
        elif engine.sharded:
            self.store = ShardedDStore(engine.nodes, engine.transport)
        else:
            self.store = DStore(engine.nodes, engine.transport)
        self.instance = instance
        self._ns = f"{instance}:" if instance else ""
        self.placement = dict(placement) if placement is not None \
            else engine.gs.assign(wf)
        # DPlan (plan.py WorkflowPlan): static eviction read-counts are
        # installed in the store and container boots follow the slack
        # schedule instead of the fire-at-precursor-launch heuristic.
        # Incompatible with duplicate execution (stragglers) and failure
        # recovery: their extra Gets would drain read counts early and
        # evict keys a re-execution still needs.
        if plan is not None and (inject_failure or engine.straggler_factor):
            raise ValueError("plan-driven eviction cannot be combined with "
                             "straggler duplicates or failure injection")
        self.plan = plan
        # DScope span tracer (obs.py), zero-cost when None.  A shared
        # store is instrumented by the first instance that carries one.
        self.spans = spans if spans is not None else engine.spans
        self._span = None
        self._invoke_spans: list[Any] = []
        if self.spans is not None and \
                getattr(self.store, "_spans", None) is None:
            self.store.attach_spans(self.spans)
        self._prewarm_timers: list[threading.Timer] = []
        # DScale prewarm budget (scale.py PrewarmBudget): when present,
        # every prewarm — slack-scheduled or heuristic — must be granted
        # container-seconds first, and unfired grants are refunded when
        # the instance completes or is evicted.
        if budget is not None:
            # The budget paths below are the reference's; they run once
            # scale.py is copied.
            raise NotImplementedError(
                "a DScale prewarm budget needs repro/core/scale.py, which "
                "the PyTorch port has not copied yet (ROADMAP A.15)")
        self._budget = budget
        self._grants: list[Any] = []
        self._prewarms_cancelled = False
        self.state = _InstanceState(wf)
        self.report = RunReport(outputs={}, wall_time=0.0)
        self._inject_failure = inject_failure
        self._failure_armed = threading.Event()
        if inject_failure:
            self._failure_armed.set()
        self._started = False
        self.t0 = 0.0

    # -- key namespacing ---------------------------------------------------
    def ns(self, key: str) -> str:
        return self._ns + key

    def strip_ns(self, key: str) -> str | None:
        """Namespaced key -> raw key, or None if it belongs elsewhere."""
        if not self._ns:
            return key
        if key.startswith(self._ns):
            return key[len(self._ns):]
        return None

    def image(self, fname: str) -> str:
        return f"{self.wf.name}/{fname}"

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "InstanceRun":
        if self._started:
            raise RuntimeError("instance already started")
        self._started = True
        self.t0 = time.monotonic()
        wf, placement, store = self.wf, self.placement, self.store
        # Sharded stores learn this instance's static routes (from the
        # placement, refined by the plan's transfer matrix) before any
        # staging Put so those Puts land on their planned home shards.
        register = getattr(store, "register_instance", None)
        if register is not None:
            register(self._ns, wf, placement, plan=self.plan)
        if self.spans is not None:
            trace = self.instance or wf.name
            self._span = self.spans.start(trace, "request", parent=None,
                                          trace=trace, workflow=wf.name)
        # Staging Puts run under the request span so their spans nest.
        with self.spans.activate(self._span) if self.spans is not None \
                else nullcontext():
            for k, v in self.inputs.items():
                # Stage external inputs on the node of each first consumer.
                node = stage_node(wf, k, placement, self.engine.nodes[0])
                store.put(node, self.ns(k), v)
        if self.plan is not None:
            store.set_plan_reads(self._ns, self.plan.eviction_reads)
            self._arm_prewarm()
        if self.engine.pattern == "dataflow":
            for fname in dataflow_initial_frontier(wf):
                self._launch(fname)
        else:
            for fname in wf.entry_points:
                self._launch(fname)
        return self

    def _arm_prewarm(self) -> None:
        """Boot containers per the plan's slack schedule (§3.2 refined):
        each function's container starts booting at ``est - cold_start``
        so it turns warm exactly when the frontier can reach the function
        — instead of the moment any precursor launches.

        Under a DScale budget the schedule is first filtered through
        :func:`repro.core.scale.allocate_prewarms` (slack-ranked grants:
        critical boots admitted first, highest-slack dropped when the
        budget tightens), and each timer fires through
        :meth:`_fire_prewarm` so revoked/cancelled boots never happen.
        """
        engine = self.engine
        if engine.containers is None or not engine.prewarm:
            return
        if self._budget is not None:
            from .scale import allocate_prewarms

            schedule = allocate_prewarms(self.plan, self._budget,
                                         now=self._budget_now())
            self._grants.extend(g for *_, g in schedule if g is not None)
        else:
            schedule = [(f, b, c, None)
                        for f, b, c in self.plan.prewarm_schedule]
        for fname, boot_at, cold, grant in schedule:
            node, image = self.placement[fname], self.image(fname)
            if boot_at <= 0.0:
                self._fire_prewarm(node, image, cold, grant)
            else:
                t = threading.Timer(boot_at, self._fire_prewarm,
                                    args=(node, image, cold, grant))
                t.daemon = True
                t.start()
                self._prewarm_timers.append(t)

    def _budget_now(self) -> float:
        return time.monotonic()

    def _fire_prewarm(self, node: str, image: str, cold: float,
                      grant=None) -> None:
        """Timer-safe prewarm: every guard a late-firing timer needs.
        No boot happens after the instance cancelled its prewarms, after
        the container service shut down or lost the node (the service
        itself rechecks under its lock), or after the budget revoked the
        grant; a granted boot that turns out to be a no-op is refunded."""
        if self._prewarms_cancelled:
            if grant is not None:
                self._budget.cancel(grant)
            return
        if grant is not None and not self._budget.settle(grant):
            return                      # revoked while the timer was armed
        booted = self.engine.containers.prewarm(node, image, cold)
        if grant is not None and not booted:
            self._budget.refund(grant)

    def _cancel_prewarms(self) -> None:
        """Cancel pending prewarm timers on every exit path (completion,
        failure, eviction) and refund their unfired budget grants."""
        self._prewarms_cancelled = True
        for t in self._prewarm_timers:
            t.cancel()
        if self._budget is not None:
            for g in self._grants:
                if not g.fired:
                    self._budget.cancel(g)

    def wait(self, timeout: float | None = None) -> RunReport:
        """Block until the instance completes; returns the report."""
        if self.spans is None:
            return self._wait_inner(timeout)
        try:
            # Sink-collection Gets below run under the request span; the
            # span closes once the instance's outcome is known.
            with self.spans.activate(self._span):
                report = self._wait_inner(timeout)
        except BaseException as exc:
            self._drain_invoke_spans()
            self.spans.end(self._span, error=type(exc).__name__)
            raise
        self._drain_invoke_spans()
        self.spans.end(self._span, ok=True)
        return report

    def _drain_invoke_spans(self, timeout: float = 2.0) -> None:
        """Worker threads close their invoke spans in a ``finally`` that can
        run just *after* the last ``mark_done`` unblocks :meth:`wait`; hold
        the request span open until they land so it contains its children
        (bounded — a failed instance may leave threads blocked on Gets)."""
        deadline = time.monotonic() + timeout
        with self.state.lock:
            pending = list(self._invoke_spans)
        for sp in pending:
            while math.isnan(sp.end) and time.monotonic() < deadline:
                time.sleep(0.0005)

    def _wait_inner(self, timeout: float | None = None) -> RunReport:
        state, wf = self.state, self.wf
        state.all_done.wait(timeout=timeout if timeout is not None
                            else self.engine.get_timeout * 2)
        self._cancel_prewarms()
        if state.failed:
            fname, exc = next(iter(state.failed.items()))
            raise RuntimeError(f"function {fname!r} failed") from exc
        if not state.all_done.is_set():
            raise TimeoutError("workflow did not complete")
        report = self.report
        report.wall_time = time.monotonic() - self.t0
        report.per_function = dict(state.completed)
        report.transfers = self.engine.transport.transfers
        report.bytes_moved = self.engine.transport.bytes_moved
        # Gather every *sink* datum (produced but never consumed) — exit
        # functions' outputs plus by-products like metrics/final state.
        consumed = {k for f in wf.functions.values() for k in f.inputs}
        for f in wf.functions.values():
            for k in f.outputs:
                if k not in consumed or f.name in wf.exit_points:
                    report.outputs[k] = self.store.get(
                        self.engine.nodes[0], self.ns(k),
                        timeout=self.engine.get_timeout)
        return report

    def evict(self) -> None:
        """Instance-scoped eviction: free every key this instance stored
        (bounded memory under sustained serving)."""
        self._cancel_prewarms()
        if self._ns:
            self.store.evict_instance(self._ns)

    # -- launch / execute --------------------------------------------------
    def _launch(self, fname: str) -> None:
        state, wf, engine = self.state, self.wf, self.engine
        with state.lock:
            if fname in state.launched:
                return
            state.launched.add(fname)
        node = self.placement[fname]
        th = threading.Thread(target=self._execute, args=(fname, node),
                              daemon=True,
                              name=f"dflow-{self.instance or wf.name}-{fname}")
        th.start()
        # Dataflow-triggered prewarm (§3.2): this function's launch is its
        # successors' precursor-launch signal — their containers start
        # booting now, overlapping with this function's own execution.
        # Strictly a dataflow-pattern mechanism: the controlflow baseline
        # (§5.5 ablation) must boot only when a function becomes ready.
        # A static plan supersedes this heuristic (slack-timed boots are
        # armed once at start()).
        if (engine.containers is not None and engine.prewarm
                and engine.pattern == "dataflow" and self.plan is None):
            for s in wf.successors[fname]:
                self._prewarm_successor(s)
        if engine.straggler_factor and wf.functions[fname].exec_time:
            budget = engine.straggler_factor * wf.functions[fname].exec_time

            def watchdog():
                th.join(budget)
                with state.lock:
                    done = fname in state.completed
                if not done and not state.failed:
                    alt = next(n for n in engine.nodes if n != node)
                    threading.Thread(
                        target=self._execute, args=(fname, alt),
                        kwargs={"duplicate": True}, daemon=True).start()
            threading.Thread(target=watchdog, daemon=True).start()

    def _prewarm_successor(self, s: str) -> None:
        """Heuristic (§3.2, no plan) successor prewarm.  With a DScale
        budget the boot is charged ``cold_start`` container-seconds at
        slack 0 (a heuristic has no slack estimate); denial drops the
        boot, and a no-op prewarm (idle container already there) refunds
        the grant."""
        wf = self.wf
        node, image = self.placement[s], self.image(s)
        cold = wf.functions[s].cold_start
        if self._budget is None:
            self.engine.containers.prewarm(node, image, cold)
            return
        grant = self._budget.request(s, cold, slack=0.0,
                                     now=self._budget_now())
        if grant is None or not self._budget.settle(grant):
            return
        booted = self.engine.containers.prewarm(node, image, cold)
        if not booted:
            self._budget.refund(grant)

    def _execute(self, fname: str, node: str, *,
                 duplicate: bool = False) -> None:
        spans = self.spans
        if spans is None:
            return self._execute_inner(fname, node, duplicate=duplicate)
        # Function threads don't inherit thread-local context: the invoke
        # span is parented on the request span explicitly, then activated
        # so this thread's Gets/Puts (and stream pumps) nest under it.
        sp = spans.start(fname, "invoke", parent=self._span, node=node,
                         duplicate=duplicate)
        if not duplicate:
            with self.state.lock:
                self._invoke_spans.append(sp)
        try:
            with spans.activate(sp):
                return self._execute_inner(fname, node, duplicate=duplicate)
        finally:
            spans.end(sp)

    def _acquire(self, node: str, fname: str, cold_start: float):
        """Container acquire, span-wrapped (the ``cold`` attribute is what
        plan-vs-actual attribution reads for prewarm accuracy).  Returns
        the :class:`~repro.core.serve.Lease` token that must be handed
        back on release — the token pins *which* container this function
        holds."""
        containers, spans = self.engine.containers, self.spans
        if spans is None:
            return containers.acquire(node, self.image(fname), cold_start)
        sp = spans.start(fname, "acquire", node=node)
        try:
            lease = containers.acquire(node, self.image(fname), cold_start)
        except BaseException:
            spans.end(sp, error=True)
            raise
        spans.end(sp, cold=lease.cold)
        return lease

    def _execute_inner(self, fname: str, node: str, *,
                       duplicate: bool = False) -> None:
        state, wf, engine = self.state, self.wf, self.engine
        f = wf.functions[fname]
        containers = engine.containers
        lease = None
        plan_mode = self.plan is not None
        try:
            if containers is not None and not plan_mode:
                # Container acquire happens at launch time — before the
                # input fetches below block — so a cold boot overlaps the
                # precursor's execution under the dataflow pattern.
                lease = self._acquire(node, fname, f.cold_start)
                if lease.cold:
                    with state.lock:
                        self.report.cold_starts += 1
            # A StreamBroken during fetch/execute/emit means an upstream
            # producer's node died mid-stream; recovery re-runs it and
            # re-claims the stream, so the consumer retries (bounded)
            # instead of failing the whole instance.
            for attempt in range(3):
                try:
                    kwargs = self._fetch_inputs(node, f)
                    if containers is not None and lease is None:
                        # Plan mode: acquire only once inputs are in hand,
                        # so the container is not leased during the input
                        # wait and the slack-timed prewarm (armed at
                        # start()) has it booted by now.
                        lease = self._acquire(node, fname, f.cold_start)
                        if lease.cold:
                            with state.lock:
                                self.report.cold_starts += 1
                    if containers is not None:
                        with containers.slot(node):
                            result = f.fn(**kwargs) if f.fn else {}
                    else:
                        result = f.fn(**kwargs) if f.fn else {}
                    if not isinstance(result, Mapping):
                        raise TypeError(
                            f"{fname} must return a mapping of outputs")
                    missing = set(f.outputs) - set(result)
                    if missing:
                        raise KeyError(f"{fname} missing outputs {missing}")
                    with state.lock:
                        first = fname not in state.completed
                    self._emit_outputs(node, f, result)
                    break
                except StreamBroken:
                    if attempt == 2:
                        raise
                    time.sleep(0.05)
            if duplicate and first:
                self.report.duplicates_won.append(fname)
            if not first:
                return
            state.mark_done(fname, time.monotonic() - self.t0)
            # -- optional fault injection: node dies after its first
            # completion; lost outputs trigger incremental re-execution.
            if self._inject_failure == node and self._failure_armed.is_set():
                self._failure_armed.clear()
                lost = self.store.fail_node(node)
                self.recover(lost)
            self._on_complete(fname)
        except BaseException as exc:   # noqa: BLE001 - report upward
            state.mark_failed(fname, exc)
        finally:
            if lease is not None:
                containers.release(node, self.image(fname), lease)

    def _on_complete(self, fname: str) -> None:
        state, wf = self.state, self.wf
        if self.engine.pattern == "dataflow":
            for t in dataflow_next_frontier(wf, fname):
                self._launch(t)
        else:
            for s in wf.successors[fname]:
                with state.lock:
                    ready = all(p in state.completed
                                for p in wf.predecessors[s])
                if ready:
                    self._launch(s)

    # -- input fetch / output publication ----------------------------------
    def _fetch_inputs(self, node: str, f: FunctionSpec) -> dict[str, Any]:
        """One blocking fetch per input (fine-grained retrieval).  Streaming
        inputs arrive as blocking chunk iterators instead: the callable
        starts consuming chunk 0 while its precursor is still emitting
        chunk N (DStream pipelining)."""
        store, timeout = self.store, self.engine.get_timeout
        return {
            k: (store.get_stream(node, self.ns(k), timeout=timeout)
                if k in f.stream_inputs
                else store.get(node, self.ns(k), timeout=timeout))
            for k in f.inputs}

    def _emit_outputs(self, node: str, f: FunctionSpec,
                      result: Mapping[str, Any]) -> None:
        """Publish outputs: plain Put, or chunked ``put_stream`` for keys in
        ``f.stream_outputs`` (bytes or any iterable of byte chunks).
        Draining a generator here is what overlaps production with
        downstream pulls; a generator that raises aborts the stream so
        blocked consumers fail fast instead of hanging until timeout."""
        store = self.store
        for k in f.outputs:
            if k not in f.stream_outputs:
                store.put(node, self.ns(k), result[k])
                continue
            value = result[k]
            writer = store.put_stream(node, self.ns(k),
                                      chunk_size=f.chunk_size)
            try:
                if isinstance(value, (bytes, bytearray, memoryview)):
                    writer.write(value)
                else:
                    for chunk in value:
                        writer.write(chunk)
            except BaseException:
                writer.abort()
                raise
            writer.close()

    # -- beyond-paper incremental recovery --------------------------------
    def recover(self, lost_keys: list[str]) -> None:
        """Re-execute only producers of lost keys *belonging to this
        instance* (paper §3.3.5 restarts the whole workflow; we re-run the
        minimal affected subgraph).  ``lost_keys`` are namespaced store
        keys, e.g. straight from :meth:`DStore.fail_node` — a serving layer
        hands the same list to every active instance and each recovers its
        own slice."""
        wf, state = self.wf, self.state
        mine = [raw for k in lost_keys
                if (raw := self.strip_ns(k)) is not None]
        # External inputs have no producer to re-run — re-stage them from
        # the retained trigger payload (losing the staging node used to
        # wedge every consumer until Get timed out).
        for k in mine:
            if k in self.inputs and k not in wf.producer:
                node = stage_node(wf, k, self.placement,
                                  self.engine.nodes[0])
                self.store.put(node, self.ns(k), self.inputs[k])
        # Chunk records of an in-flight stream map back to the stream key,
        # whose producer must re-run (it re-claims the aborted stream and
        # republishes idempotently).
        lost_fns = {wf.producer[b] for k in mine
                    if (b := base_key(k)) in wf.producer}
        if not lost_fns:
            return
        survivors = list(self.engine.nodes)
        relaunch: list[str] = []
        with state.lock:
            for fname in sorted(lost_fns):
                state.completed.pop(fname, None)
                state.launched.discard(fname)
        for fname in sorted(lost_fns):
            # move to a surviving node (round-robin by hash for determinism)
            self.placement[fname] = survivors[hash(fname) % len(survivors)]
            self.report.reexecuted.append(fname)
            relaunch.append(fname)
        for fname in relaunch:
            self._launch(fname)


class DFlowEngine:
    """Execute Workflows of real callables with dataflow invocation.

    ``pattern`` ∈ {"dataflow", "controlflow"} — the §5.5 ablation in real
    (threaded) form.  ``transport`` may carry a bandwidth to make network
    time observable.  ``straggler_factor`` (beyond-paper): when a launched
    function has run longer than factor × its spec exec_time, a duplicate
    is issued on another node; DStore immutability makes the race benign.
    ``containers`` (serving): a :class:`repro.core.serve.ContainerService`
    providing explicit container lifecycle (cold boot / keep-alive /
    prewarm) and bounded per-node execution slots; ``prewarm`` enables the
    §3.2 dataflow-triggered prewarm of successor containers at launch.
    ``sharded`` (DShard, router.py): instances get a
    :class:`~repro.core.router.ShardedDStore` — per-node directory shards
    with local routing tables and 1-hop transfers — instead of the
    single-directory :class:`DStore`; results are byte-identical.
    """

    def __init__(self, n_nodes: int = 2, *, pattern: str = "dataflow",
                 transport: Transport | None = None,
                 get_timeout: float = 120.0,
                 straggler_factor: float | None = None,
                 containers=None, prewarm: bool = True,
                 lint: bool = True, sharded: bool = False,
                 spans=None):
        if pattern not in ("dataflow", "controlflow"):
            raise ValueError(pattern)
        self.nodes = [f"node{i}" for i in range(n_nodes)]
        self.gs = GlobalScheduler(self.nodes)
        self.pattern = pattern
        self.transport = transport or Transport()
        self.get_timeout = get_timeout
        self.straggler_factor = straggler_factor
        self.containers = containers
        self.prewarm = prewarm
        self.lint = lint
        self.sharded = sharded
        # DScope span tracer (obs.py): every instance launched through
        # this engine inherits it unless it brings its own.
        self.spans = spans

    # ------------------------------------------------------------------
    def start(self, wf: Workflow, inputs: Mapping[str, Any] | None = None,
              *, store: DStore | None = None, instance: str | None = None,
              placement: dict[str, str] | None = None,
              inject_failure: str | None = None,
              plan=None, spans=None, budget=None) -> InstanceRun:
        """Launch one instance and return its handle (non-blocking) —
        the entry point serving layers use to run many instances
        concurrently over a shared ``store``."""
        if self.lint:
            # Pre-flight gate (DCheck): an error-severity diagnostic —
            # e.g. an unbound fn that produces outputs — would otherwise
            # surface mid-run as a GetTimeout on some downstream input,
            # minutes away from its actual cause.
            from .lint import check_workflow

            check_workflow(wf, require_fns=True)
        return InstanceRun(self, wf, inputs, store=store, instance=instance,
                           placement=placement,
                           inject_failure=inject_failure, plan=plan,
                           spans=spans, budget=budget).start()

    def run(self, wf: Workflow, inputs: Mapping[str, Any] | None = None,
            *, inject_failure: str | None = None,
            plan=None) -> RunReport:
        """Execute one workflow instance; returns exit-function outputs.

        ``inject_failure``: name of a node that "crashes" right after the
        first function on it completes — exercises incremental recovery.
        ``plan``: a :class:`repro.core.plan.WorkflowPlan` switches the
        instance to plan-driven eviction + slack-timed prewarm.
        """
        return self.start(wf, inputs, inject_failure=inject_failure,
                          plan=plan).wait()
