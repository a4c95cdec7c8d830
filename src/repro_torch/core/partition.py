"""Global-Scheduler DAG partitioning (paper §3.2; same GS as FaaSFlow).

The GS splits the workflow DAG into per-node sub-DAGs.  Objectives, in the
order the paper's GS (inherited from FaaSFlow) cares about them:

1. **data locality** — co-locate a function with the producers of its
   largest inputs so intra-node exchange (local store) replaces network
   transfers;
2. **load balance** — spread total execution time so no worker serialises.

We implement a deterministic greedy pass in topological order followed by a
boundary-refinement sweep (move a function to another node if that strictly
reduces cut bytes without violating the balance cap).  The same placement is
fed to *every* system (CFlow/FaaSFlow/.../DFlow) — the paper evaluates all
systems under FaaSFlow's GS, which isolates the invocation-pattern effect.

Copy of ``repro/core/partition.py`` for the PyTorch port, which imports
nothing of ``repro``; its code is the reference's, line for line.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from .dag import Workflow

__all__ = ["partition_workflow", "cut_bytes", "stage_node"]


def stage_node(wf: Workflow, key: str, placement: Mapping[str, str],
               default: str | None = None) -> str | None:
    """Node where an external input is staged: its *first* consumer's node
    (the trigger payload lands where it is first needed), or ``default``
    when nothing consumes the key.  The single authority for staging-home
    decisions — ``InstanceRun.start``, DPlan's transfer matrix and DShard's
    static routing tables must all agree on it, otherwise the planner's
    locality classification (and the router's 1-hop invariant) would
    diverge from what the runtime actually does."""
    for f in wf.functions.values():
        if key in f.inputs:
            return placement[f.name]
    return default


def _edge_bytes(wf: Workflow) -> dict[tuple[str, str], float]:
    """bytes moved along each DAG edge (producer fn -> consumer fn)."""
    out: dict[tuple[str, str], float] = {}
    for f in wf.functions.values():
        for k in f.inputs:
            p = wf.producer.get(k)
            if p is None or p == f.name:
                continue
            sz = wf.key_bytes(k)
            out[(p, f.name)] = out.get((p, f.name), 0.0) + sz
    return out


def cut_bytes(wf: Workflow, placement: Mapping[str, str]) -> float:
    """Total bytes crossing node boundaries under ``placement``."""
    return sum(sz for (u, v), sz in _edge_bytes(wf).items()
               if placement[u] != placement[v])


def partition_workflow(wf: Workflow, nodes: Sequence[str],
                       balance_slack: float = 1.35,
                       refine_iters: int = 3) -> dict[str, str]:
    """Greedy locality-first partitioning with load-balance cap.

    ``balance_slack``: a node may hold at most ``slack * total/len(nodes)``
    seconds of work; within the cap, placement maximises co-located input
    bytes (ties broken by load, then node order → deterministic).
    """
    if not nodes:
        raise ValueError("no worker nodes")
    edges = _edge_bytes(wf)
    total = max(wf.total_exec_time(), 1e-9)
    # A node loaded up to the DAG's critical path cannot extend the makespan,
    # so the balance cap never forces a sequential chain to split.
    cap = balance_slack * max(total / len(nodes), wf.critical_path_time())
    load: dict[str, float] = {n: 0.0 for n in nodes}
    placement: dict[str, str] = {}

    for fname in wf.topo_order:
        f = wf.functions[fname]
        local_bytes: dict[str, float] = {n: 0.0 for n in nodes}
        for p in wf.predecessors[fname]:
            n = placement[p]
            local_bytes[n] += edges.get((p, fname), 0.0)
        # candidates under the balance cap (always allow the emptiest node).
        order = sorted(
            nodes,
            key=lambda n: (-local_bytes[n], load[n], nodes.index(n)))
        chosen = None
        for n in order:
            if load[n] + f.exec_time <= cap:
                chosen = n
                break
        if chosen is None:
            chosen = min(nodes, key=lambda n: (load[n], nodes.index(n)))
        placement[fname] = chosen
        load[chosen] += f.exec_time

    # Boundary refinement: single-function moves that reduce cut bytes.
    for _ in range(refine_iters):
        improved = False
        for fname in wf.topo_order:
            f = wf.functions[fname]
            here = placement[fname]

            def gain(n: str) -> float:
                g = 0.0
                for p in wf.predecessors[fname]:
                    sz = edges.get((p, fname), 0.0)
                    g += (placement[p] == n) * sz - (placement[p] == here) * sz
                for s in wf.successors[fname]:
                    sz = edges.get((fname, s), 0.0)
                    g += (placement[s] == n) * sz - (placement[s] == here) * sz
                return g

            best_n, best_g = here, 0.0
            for n in nodes:
                if n == here:
                    continue
                if load[n] + f.exec_time > cap:
                    continue
                g = gain(n)
                if g > best_g + 1e-9:
                    best_n, best_g = n, g
            if best_n != here:
                load[here] -= f.exec_time
                load[best_n] += f.exec_time
                placement[fname] = best_n
                improved = True
        if not improved:
            break
    return placement
