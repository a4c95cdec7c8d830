"""Simulated serverless workflow systems (paper §2.2, §3, §5).

Implemented systems — all share the same GS placement (FaaSFlow's GS, as in
the paper's evaluation) so the differences isolate (a) the invocation
pattern and (b) the data plane:

================  ==========================  ============================
system            invocation pattern          data plane
================  ==========================  ============================
``cflow``         controlflow, centralized    CentralPlane (CouchDB@master)
``faasflow``      controlflow, decentralized  HybridPlane (local Redis + CouchDB)
``faasflowredis`` controlflow, decentralized  HybridPlane (local Redis + Redis)
``knix``          controlflow, decentralized  HybridPlane (Redis) + 1-container
                                              sandbox per node (process pool)
``faasflow+dstore`` controlflow, decentralized DStorePlane   (paper §5.5)
``dflow``         **dataflow (Algorithm 1)**  DStorePlane
``dflow-stream``  **dataflow (Algorithm 1)**  StreamingDStorePlane (DStream:
                                              chunked pipelined exchange)
``dflow-shard``   **dataflow (Algorithm 1)**  ShardedDStorePlane (DShard:
                                              per-node shards, local routing
                                              tables, 1-hop + tiered
                                              transports)
================  ==========================  ============================

The dataflow local scheduler implements the paper's Algorithm 1 exactly:
on a workflow trigger every DLS launches its *entry points and their direct
successors*; whenever any function completes, each DLS launches the
*successors of that function's successors* (the +2 frontier).  A launched
function acquires its container immediately (cold start overlaps precursor
execution) and spawns one fine-grained fetch per input, each of which may
auto-block inside the DStore directory until the producer publishes.

Copy of ``repro/core/sim_systems.py`` for the PyTorch port, which imports
nothing of ``repro``; its code is the reference's, line for line, with no
departure.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from .dag import Workflow
from .partition import partition_workflow
from .sim import Env, Event, all_of
from .sim_dataplane import (CentralPlane, DStorePlane, HybridPlane,
                            ShardedDStorePlane, StreamingDStorePlane)
from .simcluster import MASTER, Cluster, SimConfig

__all__ = ["make_system", "SimSystem", "InstanceResult", "SYSTEMS"]

SYSTEMS = ("cflow", "faasflow", "faasflowredis", "knix",
           "faasflow+dstore", "dflow", "dflow-stream", "dflow-shard")


@dataclass
class InstanceResult:
    inst: int
    arrival: float
    finish: float = float("inf")
    done: Event | None = None
    cancelled: bool = False
    completed: dict[str, float] = field(default_factory=dict)
    span: object = None              # DScope request span (obs.py), or None

    @property
    def latency(self) -> float:
        return self.finish - self.arrival


class SimSystem:
    """One deployed workflow on one simulated cluster."""

    def __init__(self, env: Env, cluster: Cluster, wf: Workflow, *,
                 pattern: str, plane, prewarm: bool, sandbox: bool,
                 central_sched: bool, name: str,
                 single_node: str | None = None, streaming: bool = False,
                 spans=None, budget=None):
        self.env = env
        # DScale prewarm budget (scale.py PrewarmBudget) on the virtual
        # clock: every speculative container boot must be granted
        # container-seconds first; denied boots are dropped (the §3.2
        # heuristic is free only when no budget is installed).
        self.budget = budget
        # DScope span tracer (obs.py) on the VIRTUAL clock — the driver
        # (run_open_loop) rebinds tracer.clock to env.now.  Spans use
        # explicit parents, never thread-local context: simulated
        # coroutines interleave on one thread, so an implicit "current
        # span" would attribute one instance's ops to another.
        self.spans = spans
        self.cluster = cluster
        self.cfg = cluster.cfg
        self.wf = wf
        self.pattern = pattern              # "controlflow" | "dataflow"
        self.plane = plane
        self.prewarm = prewarm
        self.sandbox = sandbox              # KNIX: process-in-container
        self.central_sched = central_sched  # CFlow: master drives invocation
        self.streaming = streaming          # DStream chunked exchange
        self.name = name
        if single_node is not None:
            # KNIX deployment (paper §5.1): the whole workflow runs on one
            # node; the "remote" Redis lives on another worker.  Storage
            # types (MEM vs DB) are still decided by FaaSFlow's GS over the
            # full worker set (§5: "We employ the GS from FaaSFlow to
            # determine the storage type for each function").
            self.placement = {fn: single_node for fn in wf.functions}
            self.storage_ref = partition_workflow(wf, cluster.workers())
        else:
            self.placement = partition_workflow(wf, cluster.workers())
            self.storage_ref = self.placement
        self._counter = itertools.count()
        self.results: list[InstanceResult] = []
        self._sandbox_booted: dict[str, Event] = {}  # node -> boot done
        # DPlan: DStore-backed planes price transfers from the static
        # matrix (plan.key_size) instead of trusting per-call sizes — the
        # two agree by construction (one sizing helper, Workflow.key_bytes),
        # so this pins the simulator to the analyzer's cost model.
        if isinstance(plane, DStorePlane):
            from .plan import build_plan

            plane.plan = build_plan(wf, self.placement)
        if isinstance(plane, ShardedDStorePlane):
            # DShard: the plane's routing table comes from the same
            # static_routes the threaded ShardedDStore installs (raw keys;
            # the plane's key_of strips the instance namespace).
            from .router import static_routes

            plane.install_routes(
                static_routes(wf, self.placement, cluster.workers()))

    # ------------------------------------------------------------------
    def image(self, fname: str) -> str:
        if self.sandbox:
            return f"sandbox:{self.wf.name}"
        return f"{self.wf.name}/{fname}"

    def consumers_of(self, key: str) -> list[str]:
        """Consumer placements per the storage-type reference partition."""
        out = []
        for f in self.wf.functions.values():
            if key in f.inputs:
                out.append(self.storage_ref[f.name])
        return out

    def key(self, inst: int, k: str) -> str:
        return f"{self.wf.name}#{inst}:{k}"

    # ------------------------------------------------------------------
    def invoke(self) -> InstanceResult:
        inst = next(self._counter)
        res = InstanceResult(inst=inst, arrival=self.env.now,
                             done=self.env.event())
        self.results.append(res)
        if self.spans is not None:
            trace = f"{self.wf.name}#{inst}"
            res.span = self.spans.start(trace, "request", parent=None,
                                        trace=trace, workflow=self.wf.name,
                                        system=self.name)
        # Stage external inputs in the local stores of their first consumers
        # (the trigger payload arrives with the invocation).
        for k, sz in self.wf.external_inputs.items():
            for f in self.wf.functions.values():
                if k in f.inputs:
                    self.plane.seed(self.placement[f.name],
                                    self.key(inst, k), sz)
        # Paper's 60 s experiment timeout: a timed-out invocation stops
        # generating new work (its latency is clamped to the timeout by the
        # metric collector, exactly as the paper records it).
        def expire(_):
            if not res.done.triggered:
                res.cancelled = True
                if self.spans is not None:
                    self.spans.end(res.span, cancelled=True)
                res.done.trigger(res)
        self.env._at(self.env.now + self.cfg.timeout + 1e-6, expire)
        if self.pattern == "dataflow":
            self.env.process(self._invoke_dataflow(res))
        elif self.central_sched:
            self.env.process(self._invoke_central(res))
        else:
            self.env.process(self._invoke_decentralized(res))
        return res

    # -- shared function body -------------------------------------------
    def _acquire_container(self, node: str, fname: str):
        """yields startup delay handling sandbox (KNIX) vs per-fn container.

        Pool-backed: the per-(node, image) pool delegates to the shared
        container lifecycle model (:class:`repro.core.serve.ContainerPool`
        via :class:`repro.core.simcluster._ContainerPool`) — warm reuse,
        joining an in-flight prewarm boot, keep-alive TTL eviction, and the
        cold-start metrics all come from the same code the threaded
        serving layer uses."""
        n = self.cluster.nodes[node]
        if self.sandbox:
            boot = self._sandbox_booted.get(node)
            if boot is None:
                pool = n.pool(self.image(fname))
                boot = self._sandbox_booted[node] = pool.prewarm()
            yield boot                       # first caller pays cold boot
            yield self.env.timeout(self.cfg.knix_process_start)
            return None
        pool = n.pool(self.image(fname))
        lease = yield pool.acquire()
        return lease

    def _run_function(self, res: InstanceResult, fname: str,
                      on_complete) -> None:
        if res.cancelled:
            return
        self.env.process(self._function_body(res, fname, on_complete))

    def _function_body(self, res: InstanceResult, fname: str, on_complete):
        f = self.wf.functions[fname]
        node = self.placement[fname]
        n = self.cluster.nodes[node]
        sp = None
        if self.spans is not None and res.span is not None:
            sp = self.spans.start(fname, "invoke", parent=res.span,
                                  node=node)
            acq = self.spans.start(fname, "acquire", parent=sp, node=node)
        lease = yield self.env.process(self._acquire_container(node, fname))
        if sp is not None:
            self.spans.end(acq)
        if res.cancelled:
            if lease is not None:
                lease.release()
            if sp is not None:
                self.spans.end(sp, cancelled=True)
            return
        # Fetch every input (parallel / fine-grained; DStore gets may block).
        # DStream: chunk-granular gets pull chunk i while the producer is
        # still emitting chunk i+1, so transfer overlaps production.
        if self.streaming:
            gets = [self.plane.get_stream(node, self.key(res.inst, k))
                    for k in f.inputs]
        else:
            gets = [self.plane.get(node, self.key(res.inst, k))
                    for k in f.inputs]
        if gets:
            yield all_of(self.env, gets)
        # Execute on one core.
        yield n.cores.acquire()
        if res.cancelled:
            n.cores.release()
            if lease is not None:
                lease.release()
            if sp is not None:
                self.spans.end(sp, cancelled=True)
            return
        if self.streaming:
            # Announce outputs now; chunks publish paced across execution.
            puts = [self.plane.put_stream(node, self.key(res.inst, k),
                                          f.size_of(k),
                                          consumers=self.consumers_of(k),
                                          ref_node=self.storage_ref[fname],
                                          produce_time=f.exec_time)
                    for k in f.outputs]
            yield self.env.timeout(f.exec_time)
            n.cores.release()
        else:
            yield self.env.timeout(f.exec_time)
            n.cores.release()
            # Store outputs.
            puts = [self.plane.put(node, self.key(res.inst, k), f.size_of(k),
                                   consumers=self.consumers_of(k),
                                   ref_node=self.storage_ref[fname])
                    for k in f.outputs]
        if puts:
            yield all_of(self.env, puts)
        if lease is not None:
            lease.release()
        res.completed[fname] = self.env.now
        if sp is not None:
            self.spans.end(sp)
        on_complete(fname)

    def _finish_if_done(self, res: InstanceResult) -> None:
        if len(res.completed) == len(self.wf.functions):
            # exit-function completion notification to the master.
            def fin(_):
                if not res.done.triggered:
                    res.finish = self.env.now
                    if self.spans is not None:
                        self.spans.end(res.span, ok=True)
                    res.done.trigger(res)
            self.cluster.message("worker", MASTER).add_waiter(fin)

    # -- controlflow, centralized (CFlow) --------------------------------
    def _invoke_central(self, res: InstanceResult):
        wf = self.wf
        pending = {fn: len(wf.predecessors[fn]) for fn in wf.functions}
        launched: set[str] = set()

        def master_on_complete(fname: str):
            # completion message worker -> master, then master invokes
            # newly-ready successors (master -> worker messages).
            def at_master(_):
                self._finish_if_done(res)
                for s in wf.successors[fname]:
                    pending[s] -= 1
                    if pending[s] == 0 and s not in launched:
                        launched.add(s)
                        dst = self.placement[s]

                        def mk(sname):
                            return lambda _: self._run_function(
                                res, sname, master_on_complete)
                        self.cluster.message(MASTER, dst).add_waiter(mk(s))
            self.cluster.message(self.placement[fname],
                                 MASTER).add_waiter(at_master)

        for e in wf.entry_points:
            launched.add(e)
            dst = self.placement[e]

            def mk(ename):
                return lambda _: self._run_function(
                    res, ename, master_on_complete)
            self.cluster.message(MASTER, dst).add_waiter(mk(e))
        return
        yield  # pragma: no cover  (generator form for env.process)

    # -- controlflow, decentralized (FaaSFlow family) ---------------------
    def _invoke_decentralized(self, res: InstanceResult):
        wf = self.wf
        pending = {fn: len(wf.predecessors[fn]) for fn in wf.functions}
        launched: set[str] = set()
        aware: set[str] = set()   # nodes that have heard of this instance

        def node_aware(node: str):
            """First contact with a node: its local scheduler learns of the
            instance and prewarms its sub-DAG's containers.  Non-entry nodes
            only become aware when the first cross-node message arrives —
            unlike DFlow's t=0 broadcast (this is the cold-start gap the
            paper measures in §5.4)."""
            if node in aware:
                return
            aware.add(node)
            if self.prewarm and not self.sandbox:
                for fn2 in wf.functions:
                    if self.placement[fn2] != node:
                        continue
                    pool = self.cluster.nodes[node].pool(self.image(fn2))
                    if pool.available == 0:   # nothing idle NOR booting
                        # DScale: a budget prices the speculative boot at
                        # cold_start container-seconds (virtual clock);
                        # denial drops it — the request path then pays
                        # the cold start instead.
                        if self.budget is not None:
                            grant = self.budget.request(
                                fn2, self.cfg.cold_start, slack=0.0,
                                now=self.env.now)
                            if grant is None \
                                    or not self.budget.settle(grant):
                                continue
                        pool.prewarm()

        def local_on_complete(fname: str):
            self._finish_if_done(res)
            for s in wf.successors[fname]:
                dst = self.placement[s]

                def mk(sname, dnode):
                    def arrived(_):
                        node_aware(dnode)
                        pending[sname] -= 1
                        if pending[sname] == 0 and sname not in launched:
                            launched.add(sname)
                            self._run_function(res, sname, local_on_complete)
                    return arrived
                # notify the scheduler of the successor's node (free if local)
                self.cluster.message(self.placement[fname], dst).add_waiter(
                    mk(s, dst))

        # The trigger reaches only the nodes hosting entry functions.
        entry_nodes = sorted({self.placement[e] for e in wf.entry_points})
        for nd in entry_nodes:
            def mk_node(node):
                def arrived(_):
                    node_aware(node)
                    for e in wf.entry_points:
                        if self.placement[e] == node and e not in launched:
                            launched.add(e)
                            self._run_function(res, e, local_on_complete)
                return arrived
            self.cluster.message(MASTER, nd).add_waiter(mk_node(nd))
        return
        yield  # pragma: no cover

    # -- dataflow (DFlow, Algorithm 1) ------------------------------------
    def _invoke_dataflow(self, res: InstanceResult):
        wf = self.wf
        launched: set[str] = set()

        def launch(fname: str):
            if fname in launched:
                return
            launched.add(fname)
            self._run_function(res, fname, on_complete)

        def on_complete(fname: str):
            self._finish_if_done(res)
            # Algorithm 1 lines 8-15: launch successors-of-successors of the
            # finished function, notifying the DLS of each hosting node.
            targets: dict[str, list[str]] = {}
            for s in wf.successors[fname]:
                for t in wf.successors[s]:
                    if t not in launched:
                        targets.setdefault(self.placement[t], []).append(t)
            src = self.placement[fname]
            for dst, fns in sorted(targets.items()):
                def mk(fns2):
                    return lambda _: [launch(t) for t in fns2]
                self.cluster.message(src, dst).add_waiter(mk(fns))

        # Trigger broadcast: each DLS launches its local share of the
        # initial frontier = entry points + their direct successors
        # (Algorithm 1 lines 1-7).
        frontier: list[str] = []
        for e in wf.entry_points:
            frontier.append(e)
            frontier.extend(wf.successors[e])
        by_node: dict[str, list[str]] = {}
        for fn in dict.fromkeys(frontier):          # dedup, keep order
            by_node.setdefault(self.placement[fn], []).append(fn)
        for nd, fns in sorted(by_node.items()):
            def mk_node(fns2):
                return lambda _: [launch(fn) for fn in fns2]
            self.cluster.message(MASTER, nd).add_waiter(mk_node(fns))
        return
        yield  # pragma: no cover


# ----------------------------------------------------------------------
def make_system(name: str, env: Env, cluster: Cluster,
                wf: Workflow, *, spans=None, budget=None) -> SimSystem:
    """Factory mapping paper system names to configurations.

    ``budget`` (a :class:`repro.core.scale.PrewarmBudget`) prices every
    speculative container boot in container-seconds; None keeps the
    classic free-prewarm behavior."""
    system = _make_system(name, env, cluster, wf, spans=spans)
    system.budget = budget
    return system


def _make_system(name: str, env: Env, cluster: Cluster,
                 wf: Workflow, *, spans=None) -> SimSystem:
    if name == "cflow":
        return SimSystem(env, cluster, wf, pattern="controlflow",
                         plane=CentralPlane(env, cluster), prewarm=False,
                         sandbox=False, central_sched=True, name=name, spans=spans)
    if name == "faasflow":
        return SimSystem(env, cluster, wf, pattern="controlflow",
                         plane=HybridPlane(env, cluster, central="couch"),
                         prewarm=True, sandbox=False, central_sched=False,
                         name=name, spans=spans)
    if name == "faasflowredis":
        return SimSystem(env, cluster, wf, pattern="controlflow",
                         plane=HybridPlane(env, cluster, central="redis"),
                         prewarm=True, sandbox=False, central_sched=False,
                         name=name, spans=spans)
    if name == "knix":
        # Paper §5.1: "we deploy the remote Redis on Node 1 and install KNIX
        # on Node 2" — single-worker sandbox, hub Redis on another worker.
        return SimSystem(env, cluster, wf, pattern="controlflow",
                         plane=HybridPlane(env, cluster, central="redis",
                                           hub="node1", db_exclusive=True),
                         prewarm=False, sandbox=True, central_sched=False,
                         name=name, single_node="node2", spans=spans)
    if name == "faasflow+dstore":
        return SimSystem(env, cluster, wf, pattern="controlflow",
                         plane=DStorePlane(env, cluster), prewarm=True,
                         sandbox=False, central_sched=False, name=name,
                         spans=spans)
    if name == "dflow":
        return SimSystem(env, cluster, wf, pattern="dataflow",
                         plane=DStorePlane(env, cluster), prewarm=False,
                         sandbox=False, central_sched=False, name=name,
                         spans=spans)
    if name == "dflow-stream":
        # DFlow + DStream: Algorithm 1 invocation with chunked pipelined
        # data exchange (transfer overlaps production; beyond-paper).
        return SimSystem(env, cluster, wf, pattern="dataflow",
                         plane=StreamingDStorePlane(env, cluster),
                         prewarm=False, sandbox=False, central_sched=False,
                         name=name, streaming=True, spans=spans)
    if name == "dflow-shard":
        # DFlow + DShard: Algorithm 1 invocation over per-node DStore
        # shards with local routing tables — 1-hop transfers and tiered
        # ipc/mem/net transports (beyond-paper; see core/router.py).
        return SimSystem(env, cluster, wf, pattern="dataflow",
                         plane=ShardedDStorePlane(env, cluster),
                         prewarm=False, sandbox=False, central_sched=False,
                         name=name, spans=spans)
    raise ValueError(f"unknown system {name!r}; choose from {SYSTEMS}")
