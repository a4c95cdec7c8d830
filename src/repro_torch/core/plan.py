"""DPlan — static dataflow planner over the workflow DAG.

Everything the runtime decides heuristically today — when a key may be
reclaimed, when a container must start booting, which edges cross nodes
and what that costs — is statically derivable from the DAG plus a
placement, the same way iRoute derives routing tables and FaaSFlow's GS
derives partitions.  :func:`build_plan` computes a :class:`WorkflowPlan`
IR with four analyses:

* **liveness / eviction** — per key, the producer, the consumer set and
  the topological interval in which the key can be live.  A key is safe
  to evict only once *every* consumer's Get has returned: get order
  inside one consumer is arbitrary (``_fetch_inputs`` issues fetches
  sequentially in input order), so even a consumer that is a DAG
  ancestor of another consumer gives no happens-before between their
  Gets of the *same* key.  The provably-safe earliest-eviction schedule
  is therefore a per-key read countdown (``eviction_reads``): the
  runtime evicts the moment the statically-last read returns.  Keys on
  stream edges (chunked twins, iterator reads that never issue a plain
  Get) and sink keys (collected by ``wait()``) are excluded and left to
  instance-scoped eviction.
* **critical path / slack / prewarm** — the classic earliest/latest
  start DP over ``exec_time`` (identical recurrence to
  :meth:`Workflow.critical_path_time`, so the two agree exactly).  Each
  function's container should start booting at ``est - cold_start``
  (clamped at 0): exactly slack-ahead of its earliest frontier-ready
  time, replacing the fire-at-precursor-launch heuristic which boots
  everything as early as the +2 frontier reaches it.
* **transfer-cost matrix** — bytes per producer→consumer edge via the
  one shared sizing helper (:meth:`Workflow.key_bytes`, also used by
  ``partition._edge_bytes``, so ``cross_node_bytes == cut_bytes`` by
  construction), chunk counts for streamed edges, local/cross
  classification under the placement, plus a deduplicated
  per-(key, node) pull prediction (a second consumer on a node reuses
  the replica — the matrix is the upper bound, the dedup the lower) and
  a peak-resident-bytes-per-node prediction under the canonical
  topological schedule with earliest eviction.
* **stream-overlap feasibility** — DF016/DF017 diagnostics (registered
  in :mod:`repro.core.lint`'s CODES) for declared streams that can
  never actually pipeline.

The plan is machine-checked, not trusted: :class:`repro.core.check.
PlanConformance` replays recorded traces against it and flags any
dynamic event that contradicts a static claim.

Copy of ``repro/core/plan.py`` for the PyTorch port, which imports nothing
of ``repro``; its code is the reference's, line for line, with no departure.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping

from .dag import Workflow
from .lint import Diagnostic
from .partition import stage_node
from .stream import chunk_count

__all__ = ["KeyPlan", "FunctionPlan", "TransferPlan", "WorkflowPlan",
           "build_plan"]


@dataclass(frozen=True)
class KeyPlan:
    """Liveness facts for one data key."""

    key: str
    size: int
    producer: str | None             # None = external workflow input
    consumers: tuple[str, ...]       # functions with this key in inputs
    first_step: int                  # topo index where the key appears
    last_step: int                   # topo index of its last consumer
    sink: bool                       # collected by wait(); never plan-evict
    streamed: bool                   # chunked twin / iterator reads exist
    reads: int                       # plain Gets before eviction is safe

    @property
    def evictable(self) -> bool:
        return not self.sink and not self.streamed and self.reads > 0


@dataclass(frozen=True)
class FunctionPlan:
    """Critical-path facts + prewarm timing for one function."""

    function: str
    node: str | None
    est: float                       # earliest start (exec_time DP)
    eft: float                       # earliest finish = est + exec_time
    lst: float                       # latest start w/o stretching the CP
    slack: float                     # lst - est (0 on the critical path)
    cold_start: float
    boot_at: float                   # max(0, est - cold_start)

    @property
    def critical(self) -> bool:
        return self.slack <= 1e-12

    @property
    def boot_cost(self) -> float:
        """Container-seconds a slack-timed prewarm spends ahead of the
        function's earliest start (``est - boot_at`` = ``min(cold_start,
        est)``) — the price DScale's :class:`~repro.core.scale.
        PrewarmBudget` debits per boot."""
        return max(0.0, self.est - self.boot_at)


@dataclass(frozen=True)
class TransferPlan:
    """One matrix cell: bytes along a producer→consumer edge."""

    producer: str | None             # None = external input staging
    consumer: str
    key: str
    bytes: int
    chunks: int                      # 1 for monolithic edges
    chunk_bytes: int                 # bytes per chunk (last may be short)
    src: str | None                  # producing / staging node
    dst: str | None                  # consuming node
    local: bool | None               # None when no placement was given


@dataclass
class WorkflowPlan:
    """The static plan IR for one workflow (+ optional placement)."""

    workflow: str
    critical_path: float
    keys: dict[str, KeyPlan]
    functions: dict[str, FunctionPlan]
    transfers: tuple[TransferPlan, ...]
    placement: dict[str, str] | None = None
    peak_resident: dict[str, int] = field(default_factory=dict)
    diagnostics: tuple[Diagnostic, ...] = ()

    # -- eviction ---------------------------------------------------------
    @property
    def eviction_reads(self) -> dict[str, int]:
        """key -> number of plain Gets after which eviction is safe."""
        return {k: kp.reads for k, kp in self.keys.items() if kp.evictable}

    def eviction_order(self) -> list[str]:
        """Evictable keys by earliest safe eviction step (topo index)."""
        ev = [(kp.last_step, k) for k, kp in self.keys.items()
              if kp.evictable]
        return [k for _, k in sorted(ev)]

    # -- prewarm ----------------------------------------------------------
    @property
    def prewarm_schedule(self) -> tuple[tuple[str, float, float], ...]:
        """(function, boot_at, cold_start) sorted by boot time."""
        return tuple(sorted(
            ((fp.function, fp.boot_at, fp.cold_start)
             for fp in self.functions.values()),
            key=lambda e: (e[1], e[0])))

    # -- transfer matrix --------------------------------------------------
    def key_size(self, key: str) -> int | None:
        kp = self.keys.get(key)
        return None if kp is None else kp.size

    @property
    def cross_node_bytes(self) -> float:
        """Per-edge cross-node bytes between functions — by construction
        equal to ``partition.cut_bytes`` under the same placement."""
        return float(sum(t.bytes for t in self.transfers
                         if t.local is False and t.producer is not None))

    def predicted_pull_bytes(self, *, include_external: bool = True) -> int:
        """Deduplicated cross-node pull prediction: one receiver-driven
        transfer per (key, consumer node) — a second consumer on the same
        node hits the replica registered by the first."""
        pulled: set[tuple[str, str]] = set()
        total = 0
        for t in self.transfers:
            if t.local is not False:
                continue
            if t.producer is None and not include_external:
                continue
            if (t.key, t.dst) in pulled:
                continue
            pulled.add((t.key, t.dst))
            total += t.bytes
        return total

    # -- consistency ------------------------------------------------------
    def self_check(self) -> list[str]:
        """Internal invariants every well-formed plan satisfies; used by
        the CLI and CI so builtin/example plans are machine-checked even
        when no executable trace exists."""
        problems: list[str] = []
        for fp in self.functions.values():
            if fp.slack < -1e-9:
                problems.append(f"{fp.function}: negative slack {fp.slack}")
            if fp.eft - 1e-9 > self.critical_path:
                problems.append(
                    f"{fp.function}: eft {fp.eft} beyond critical path")
            if fp.boot_at - 1e-9 > max(fp.est, 0.0):
                problems.append(
                    f"{fp.function}: boot_at {fp.boot_at} after est {fp.est}")
        for k, kp in self.keys.items():
            if kp.reads != len(set(kp.consumers)):
                problems.append(f"{k}: reads != distinct consumers")
            if kp.sink and kp.evictable:
                problems.append(f"{k}: sink marked evictable")
            if kp.last_step < kp.first_step and kp.consumers:
                problems.append(f"{k}: last step precedes first")
        for t in self.transfers:
            if t.bytes < 0 or t.chunks < 1:
                problems.append(f"{t.key}: malformed transfer cell")
        return problems

    # -- serialization ----------------------------------------------------
    def to_doc(self) -> dict[str, Any]:
        return {
            "workflow": self.workflow,
            "critical_path_s": self.critical_path,
            "placement": self.placement,
            "functions": [vars(fp) | {"critical": fp.critical}
                          for fp in self.functions.values()],
            "keys": [vars(kp) | {"evictable": kp.evictable}
                     for kp in self.keys.values()],
            "transfers": [vars(t) for t in self.transfers],
            "eviction_order": self.eviction_order(),
            "prewarm_schedule": [
                {"function": f, "boot_at": b, "cold_start": c}
                for f, b, c in self.prewarm_schedule],
            "cross_node_bytes": self.cross_node_bytes,
            "predicted_pull_bytes": self.predicted_pull_bytes(),
            "peak_resident_bytes": self.peak_resident,
            "diagnostics": [vars(d) for d in self.diagnostics],
        }


# ----------------------------------------------------------------------
# Builder
# ----------------------------------------------------------------------

def _liveness(wf: Workflow, step: Mapping[str, int]) -> dict[str, KeyPlan]:
    consumers: dict[str, list[str]] = {}
    for f in wf.functions.values():
        for k in set(f.inputs):
            consumers.setdefault(k, []).append(f.name)
    streamed: set[str] = set()
    for f in wf.functions.values():
        streamed.update(f.stream_outputs)
        streamed.update(f.stream_inputs)

    out: dict[str, KeyPlan] = {}
    n_steps = len(wf.topo_order)
    for key in (*wf.producer, *wf.external_inputs):
        prod = wf.producer.get(key)
        cons = tuple(sorted(consumers.get(key, ()),
                            key=lambda c: step[c]))
        first = step[prod] if prod is not None else -1
        last = max((step[c] for c in cons), default=n_steps - 1)
        sink = not cons
        out[key] = KeyPlan(
            key=key, size=wf.key_bytes(key), producer=prod,
            consumers=cons, first_step=first,
            last_step=last if not sink else n_steps - 1,
            sink=sink, streamed=key in streamed,
            reads=len(cons))
    return out


def _schedule(wf: Workflow,
              placement: Mapping[str, str] | None
              ) -> tuple[dict[str, FunctionPlan], float]:
    # Earliest start/finish: the exact recurrence of
    # Workflow.critical_path_time(), so equality is bit-for-bit.
    eft: dict[str, float] = {}
    est: dict[str, float] = {}
    for n in wf.topo_order:
        base = max((eft[p] for p in wf.predecessors[n]), default=0.0)
        est[n] = base
        eft[n] = base + wf.functions[n].exec_time
    cp = max(eft.values()) if eft else 0.0
    # Latest start: backward pass pinned to the critical-path makespan.
    lst: dict[str, float] = {}
    for n in reversed(wf.topo_order):
        lft = min((lst[s] for s in wf.successors[n]), default=cp)
        lst[n] = lft - wf.functions[n].exec_time
    out: dict[str, FunctionPlan] = {}
    for n in wf.topo_order:
        f = wf.functions[n]
        out[n] = FunctionPlan(
            function=n,
            node=None if placement is None else placement[n],
            est=est[n], eft=eft[n], lst=lst[n],
            slack=max(0.0, lst[n] - est[n]),
            cold_start=f.cold_start,
            boot_at=max(0.0, est[n] - f.cold_start))
    return out, cp


def _transfers(wf: Workflow, keys: Mapping[str, KeyPlan],
               placement: Mapping[str, str] | None
               ) -> tuple[TransferPlan, ...]:
    # External inputs are staged on the node of each key's *first*
    # consumer (partition.stage_node — the same authority InstanceRun and
    # DShard's routing tables use); other consumers pull.
    staged: dict[str, str] = {}
    if placement is not None:
        for k in wf.external_inputs:
            n = stage_node(wf, k, placement)
            if n is not None:
                staged[k] = n
    out: list[TransferPlan] = []
    for f in wf.functions.values():
        for k in sorted(set(f.inputs)):
            kp = keys[k]
            prod = kp.producer
            if prod == f.name:
                continue                       # dropped edge (DF003 lints)
            size = kp.size
            chunk = wf.functions[prod].chunk_size if prod is not None \
                else f.chunk_size
            chunks = chunk_count(size, chunk) if kp.streamed else 1
            src = dst = local = None
            if placement is not None:
                src = placement[prod] if prod is not None \
                    else staged.get(k)
                dst = placement[f.name]
                local = src == dst
            out.append(TransferPlan(
                producer=prod, consumer=f.name, key=k, bytes=size,
                chunks=chunks,
                chunk_bytes=min(size, chunk) if kp.streamed else size,
                src=src, dst=dst, local=local))
    out.sort(key=lambda t: (t.consumer, t.key))
    return tuple(out)


def _peak_resident(wf: Workflow, keys: Mapping[str, KeyPlan],
                   placement: Mapping[str, str] | None) -> dict[str, int]:
    """Peak resident bytes per node under the canonical topological
    schedule with earliest eviction.  A prediction, not a bound: a
    concurrent schedule can reorder steps, but the canonical walk is
    what the eviction schedule itself is derived from, so it is the
    number plan-driven serving converges to per instance."""
    node_of = (lambda fn: placement[fn]) if placement is not None \
        else (lambda fn: "cluster")
    step = {fn: i for i, fn in enumerate(wf.topo_order)}
    # (step, node, delta) events; externals land before step 0.
    events: list[tuple[int, str, int]] = []
    for k, kp in keys.items():
        holders: set[str] = set()
        if kp.producer is not None:
            home = node_of(kp.producer)
            events.append((kp.first_step, home, kp.size))
            holders.add(home)
        elif kp.consumers:
            home = node_of(kp.consumers[0])
            events.append((-1, home, kp.size))
            holders.add(home)
        for c in kp.consumers:
            n = node_of(c)
            if n not in holders:               # replica pulled at read time
                events.append((step[c], n, kp.size))
                holders.add(n)
        if kp.evictable:
            for n in holders:
                events.append((kp.last_step, n, -kp.size))
    # Within a step, additions land before eviction releases: the last
    # reader's Get returns (bytes resident) before the evict fires.
    events.sort(key=lambda e: (e[0], e[2] < 0))
    resident: dict[str, int] = {}
    peak: dict[str, int] = {}
    for _, node, delta in events:
        resident[node] = resident.get(node, 0) + delta
        peak[node] = max(peak.get(node, 0), resident[node])
    return peak


def _stream_diagnostics(wf: Workflow,
                        keys: Mapping[str, KeyPlan]) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for f in wf.functions.values():
        for k in f.stream_outputs:
            # DF017 — a stream that fits one chunk degenerates to a
            # monolithic put: nothing to overlap.
            if chunk_count(wf.key_bytes(k), f.chunk_size) <= 1:
                out.append(Diagnostic(
                    "DF017", f"stream {k!r} of {f.name!r} fits a single "
                    f"chunk ({wf.key_bytes(k)} B <= chunk_size "
                    f"{f.chunk_size}); the pipeline degenerates to a "
                    "monolithic transfer", function=f.name, key=k,
                    hint="shrink chunk_size or drop the stream "
                    "declaration"))
        for k in f.stream_inputs:
            p = wf.producer.get(k)
            if p is None or p == f.name:
                continue                       # DF005 territory (lint)
            prod = wf.functions[p]
            if k not in prod.stream_outputs:
                continue
            # DF016a — the consumer also waits on a *later-emitted* plain
            # output of the same producer: _emit_outputs publishes in
            # outputs order after draining earlier stream generators, so
            # that Get returns only once the stream is fully produced.
            for k2 in f.inputs:
                if (k2 in prod.outputs and k2 not in prod.stream_outputs
                        and k2 not in f.stream_inputs
                        and prod.outputs.index(k2) > prod.outputs.index(k)):
                    out.append(Diagnostic(
                        "DF016", f"{f.name!r} streams {k!r} from {p!r} "
                        f"but also waits for {k2!r}, which {p!r} emits "
                        f"only after draining the stream — the edge can "
                        "never pipeline", function=f.name, key=k,
                        hint=f"reorder {p!r}.outputs so {k2!r} precedes "
                        f"{k!r}, or stream {k2!r} too"))
            # DF016b — the consumer waits on an output of another
            # consumer of the same stream: that producer finishes only
            # after the stream closes, so the overlap window is empty.
            for k2 in f.inputs:
                p2 = wf.producer.get(k2)
                if (p2 is not None and p2 != p and p2 != f.name
                        and k in wf.functions[p2].inputs
                        and k2 not in f.stream_inputs):
                    out.append(Diagnostic(
                        "DF016", f"{f.name!r} streams {k!r} but also "
                        f"waits for {k2!r} from {p2!r}, itself a "
                        f"consumer of {k!r} — {k2!r} exists only after "
                        "the stream closed, so the edge can never "
                        "pipeline", function=f.name, key=k,
                        hint=f"drop the stream declaration on {k!r} or "
                        f"restructure the diamond through {p2!r}"))
    return out


def build_plan(wf: Workflow,
               placement: Mapping[str, str] | None = None, *,
               nodes: list[str] | None = None) -> WorkflowPlan:
    """Compute the :class:`WorkflowPlan` for ``wf``.

    ``placement`` maps function -> node (e.g. from
    :func:`~repro.core.partition.partition_workflow`).  When omitted but
    ``nodes`` is given, the partitioner runs here; with neither, the plan
    is placement-agnostic (transfer locality and per-node peaks unknown).
    """
    if placement is None and nodes:
        from .partition import partition_workflow

        placement = partition_workflow(wf, nodes)
    if placement is not None:
        missing = set(wf.functions) - set(placement)
        if missing:
            raise ValueError(f"placement misses functions {sorted(missing)}")
        placement = dict(placement)
    step = {fn: i for i, fn in enumerate(wf.topo_order)}
    keys = _liveness(wf, step)
    functions, cp = _schedule(wf, placement)
    transfers = _transfers(wf, keys, placement)
    peak = _peak_resident(wf, keys, placement)
    diags = _stream_diagnostics(wf, keys)
    plan = WorkflowPlan(
        workflow=wf.name, critical_path=cp, keys=keys,
        functions=functions, transfers=transfers, placement=placement,
        peak_resident=peak, diagnostics=tuple(diags))
    assert math.isclose(cp, wf.critical_path_time(), rel_tol=0.0,
                        abs_tol=0.0) or cp == wf.critical_path_time()
    return plan
