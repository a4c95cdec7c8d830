"""Workflow DAG model + parser (paper §3.1, Figure 5 "DAG Parser").

A serverless workflow is a DAG whose nodes are functions and whose edges are
*data* dependencies: an edge u→v exists iff some output key of u is an input
key of v.  This is the representation every scheduler (DFlow's DScheduler and
all controlflow baselines) consumes.

The parser accepts the paper's ``workflow.yaml`` shape::

    name: wordcount
    functions:
      split:
        inputs: [corpus]            # keys not produced by any function are
        outputs: [shard.0, shard.1] # workflow inputs (external data)
        exec_time: 0.4              # seconds (simulator)
        output_sizes: {shard.0: 8MB, shard.1: 8MB}
      count:
        foreach: 2                  # expand into count.0, count.1 ...
        inputs: [shard.$i]
        outputs: [wc.$i]
        ...
      merge:
        inputs: [wc.*]              # glob over produced keys
        outputs: [result]

``foreach`` (paper §1: "supports complex workflows involving constructs such
as 'foreach'") expands a template into N concrete functions with ``$i``
substituted.  ``inputs`` may use a trailing ``*`` glob which is resolved
against the union of all produced keys after expansion.

Copy of ``repro/core/dag.py`` for the PyTorch port, which imports
nothing of ``repro``; its code is the reference's, line for line.
"""

from __future__ import annotations

import io
import re
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "FunctionSpec",
    "Workflow",
    "parse_workflow",
    "parse_size",
]

_SIZE_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([KMGT]?B?)\s*$", re.I)
_SIZE_MULT = {
    "": 1, "B": 1,
    "KB": 1 << 10, "K": 1 << 10,
    "MB": 1 << 20, "M": 1 << 20,
    "GB": 1 << 30, "G": 1 << 30,
    "TB": 1 << 40, "T": 1 << 40,
}


def parse_size(v: int | float | str) -> int:
    """'8MB' → 8388608.  Ints/floats pass through as bytes."""
    if isinstance(v, (int, float)):
        return int(v)
    m = _SIZE_RE.match(v)
    if not m:
        raise ValueError(f"unparsable size: {v!r}")
    return int(float(m.group(1)) * _SIZE_MULT[m.group(2).upper()])


@dataclass(frozen=True)
class FunctionSpec:
    """One node of the workflow DAG.

    ``fn`` is the real callable (threaded engine); the simulator uses
    ``exec_time``/``output_sizes``/``cold_start`` instead and never calls it.

    DStream (chunked pipelining, see :mod:`repro.core.stream`):
    ``stream_inputs`` names inputs delivered to ``fn`` as blocking chunk
    iterators instead of whole values; ``stream_outputs`` names outputs the
    engine publishes chunk-by-chunk — ``fn`` may return bytes or any
    iterable/generator of byte chunks for those keys, and downstream
    consumers start pulling while this function is still emitting.
    """

    name: str
    inputs: tuple[str, ...] = ()
    outputs: tuple[str, ...] = ()
    fn: Callable[..., Mapping[str, Any]] | None = None
    exec_time: float = 0.1           # seconds of pure compute (warm)
    output_sizes: Mapping[str, int] = field(default_factory=dict)
    cold_start: float = 0.5          # container init if no warm container
    cpu: float = 1.0                 # cores occupied while running
    stream_inputs: tuple[str, ...] = ()    # consumed as chunk iterators
    stream_outputs: tuple[str, ...] = ()   # produced via put_stream
    chunk_size: int = 1 << 18              # streaming chunk size (bytes)

    def __post_init__(self) -> None:
        object.__setattr__(self, "stream_inputs", tuple(self.stream_inputs))
        object.__setattr__(self, "stream_outputs", tuple(self.stream_outputs))
        bad = set(self.stream_inputs) - set(self.inputs)
        if bad:
            raise ValueError(
                f"{self.name}: stream_inputs {sorted(bad)} not in inputs")
        bad = set(self.stream_outputs) - set(self.outputs)
        if bad:
            raise ValueError(
                f"{self.name}: stream_outputs {sorted(bad)} not in outputs")
        if self.chunk_size <= 0:
            raise ValueError(f"{self.name}: chunk_size must be positive")
        # output_sizes naming a non-output key used to be silently ignored
        # (size_of fell back to the 1 MB default) — a typo'd key made every
        # simulator transfer-time estimate wrong with no signal.
        bad = set(self.output_sizes) - set(self.outputs)
        if bad:
            raise ValueError(
                f"{self.name}: output_sizes for non-output keys "
                f"{sorted(bad)} (outputs: {sorted(self.outputs)})")

    def size_of(self, key: str) -> int:
        return int(self.output_sizes.get(key, 1 << 20))  # default 1 MB


class Workflow:
    """Immutable DAG of :class:`FunctionSpec` with derived dependency maps."""

    def __init__(self, name: str, functions: Iterable[FunctionSpec],
                 external_inputs: Mapping[str, int] | None = None):
        self.name = name
        self.functions: dict[str, FunctionSpec] = {}
        for f in functions:
            if f.name in self.functions:
                raise ValueError(f"duplicate function {f.name!r}")
            self.functions[f.name] = f

        self.producer: dict[str, str] = {}      # data key -> producing fn
        for f in self.functions.values():
            for k in f.outputs:
                if k in self.producer:
                    raise ValueError(
                        f"key {k!r} produced by both {self.producer[k]!r} "
                        f"and {f.name!r} (DStore data is immutable)")
                self.producer[k] = f.name

        # Keys consumed but never produced are workflow (external) inputs.
        # The explicitly declared set is kept separately so the linter can
        # flag typo'd input keys that silently default into externals.
        self.declared_external: frozenset[str] = frozenset(
            external_inputs or ())
        self.external_inputs: dict[str, int] = dict(external_inputs or {})
        for f in self.functions.values():
            for k in f.inputs:
                if k not in self.producer:
                    self.external_inputs.setdefault(k, 1 << 20)

        # fn -> set of fn edges (dedup'd), from data dependencies.
        self.successors: dict[str, tuple[str, ...]] = {}
        self.predecessors: dict[str, tuple[str, ...]] = {}
        succ: dict[str, list[str]] = {n: [] for n in self.functions}
        pred: dict[str, list[str]] = {n: [] for n in self.functions}
        for f in self.functions.values():
            for k in f.inputs:
                p = self.producer.get(k)
                if p is not None and p != f.name:
                    if f.name not in succ[p]:
                        succ[p].append(f.name)
                    if p not in pred[f.name]:
                        pred[f.name].append(p)
        self.successors = {n: tuple(v) for n, v in succ.items()}
        self.predecessors = {n: tuple(v) for n, v in pred.items()}

        self.entry_points: tuple[str, ...] = tuple(
            n for n in self.functions if not self.predecessors[n])
        self.exit_points: tuple[str, ...] = tuple(
            n for n in self.functions if not self.successors[n])
        self.topo_order: tuple[str, ...] = self._toposort()

    # ------------------------------------------------------------------
    def _toposort(self) -> tuple[str, ...]:
        indeg = {n: len(self.predecessors[n]) for n in self.functions}
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: list[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            newly = []
            for s in self.successors[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    newly.append(s)
            # Keep determinism: stable-sorted insertion.
            for s in sorted(newly):
                ready.append(s)
        if len(order) != len(self.functions):
            cyc = [n for n, d in indeg.items() if d > 0]
            raise ValueError(f"workflow {self.name!r} has a cycle: {cyc}")
        return tuple(order)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.functions)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Workflow({self.name!r}, {len(self)} fns, "
                f"{sum(len(s) for s in self.successors.values())} edges)")

    def critical_path_time(self) -> float:
        """Lower bound on makespan: longest exec_time chain (no comms)."""
        dist: dict[str, float] = {}
        for n in self.topo_order:
            base = max((dist[p] for p in self.predecessors[n]), default=0.0)
            dist[n] = base + self.functions[n].exec_time
        return max(dist.values()) if dist else 0.0

    def total_exec_time(self) -> float:
        return sum(f.exec_time for f in self.functions.values())

    def key_bytes(self, key: str) -> int:
        """Declared size of ``key`` regardless of who produced it.

        The one sizing authority shared by the partitioner's cut model
        and the planner's transfer matrix, so the two can never disagree
        (stream-declared keys included: chunking changes the transfer
        granularity, not the byte count).
        """
        p = self.producer.get(key)
        if p is not None:
            return self.functions[p].size_of(key)
        return self.external_inputs.get(key, 1 << 20)

    def with_functions(self, **overrides: FunctionSpec) -> "Workflow":
        fns = [overrides.get(n, f) for n, f in self.functions.items()]
        return Workflow(self.name, fns, self.external_inputs)


# ----------------------------------------------------------------------
# Parser
# ----------------------------------------------------------------------

def _expand_foreach(name: str, spec: Mapping[str, Any]) -> list[tuple[str, dict]]:
    n = int(spec.get("foreach", 0))
    if not n:
        return [(name, dict(spec))]
    out = []
    for i in range(n):
        sub = {}
        for k, v in spec.items():
            if k == "foreach":
                continue
            sub[k] = _subst(v, i)
        out.append((f"{name}.{i}", sub))
    return out


def _subst(v: Any, i: int) -> Any:
    if isinstance(v, str):
        return v.replace("$i", str(i))
    if isinstance(v, list):
        return [_subst(x, i) for x in v]
    if isinstance(v, dict):
        return {_subst(k, i): _subst(x, i) for k, x in v.items()}
    return v


def parse_workflow(doc: Mapping[str, Any] | str,
                   fns: Mapping[str, Callable] | None = None) -> Workflow:
    """Parse a workflow description (dict or YAML text) into a Workflow.

    ``fns`` optionally binds real callables by (expanded) function name for
    the threaded engine; the simulator leaves them None.
    """
    if isinstance(doc, str):
        import yaml  # local import: simulator path never needs it

        doc = yaml.safe_load(io.StringIO(doc))
    name = doc.get("name", "workflow")
    raw = doc["functions"]

    expanded: list[tuple[str, dict]] = []
    for fname, spec in raw.items():
        expanded.extend(_expand_foreach(fname, spec))

    seen: set[str] = set()
    for fname, _ in expanded:
        if fname in seen:
            raise ValueError(
                f"function {fname!r} declared twice: a foreach expansion "
                f"collides with an explicitly declared function")
        seen.add(fname)

    produced: set[str] = set()
    for _, spec in expanded:
        produced.update(spec.get("outputs", ()) or ())

    def resolve_inputs(inputs: Iterable[str]) -> tuple[str, ...]:
        out: list[str] = []
        for k in inputs or ():
            if k.endswith("*"):
                pre = k[:-1]
                matches = sorted(p for p in produced if p.startswith(pre))
                if not matches:
                    raise ValueError(f"glob {k!r} matches no produced key")
                out.extend(matches)
            else:
                out.append(k)
        return tuple(out)

    specs: list[FunctionSpec] = []
    for fname, spec in expanded:
        sizes = {k: parse_size(v)
                 for k, v in (spec.get("output_sizes") or {}).items()}
        specs.append(FunctionSpec(
            name=fname,
            inputs=resolve_inputs(spec.get("inputs", ())),
            outputs=tuple(spec.get("outputs", ()) or ()),
            fn=(fns or {}).get(fname),
            exec_time=float(spec.get("exec_time", 0.1)),
            output_sizes=sizes,
            cold_start=float(spec.get("cold_start", 0.5)),
            cpu=float(spec.get("cpu", 1.0)),
            stream_inputs=resolve_inputs(spec.get("stream_inputs", ())),
            stream_outputs=tuple(spec.get("stream_outputs", ()) or ()),
            chunk_size=parse_size(spec.get("chunk_size", 1 << 18)),
        ))
    ext = {k: parse_size(v)
           for k, v in (doc.get("external_inputs") or {}).items()}
    return Workflow(name, specs, ext)
