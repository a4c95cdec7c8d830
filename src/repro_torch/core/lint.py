"""DCheck static half — workflow linter with stable diagnostic codes.

DFlow's correctness rests on structural properties of the workflow DAG
(§3.1/§3.3): single-producer keys, data edges derived purely from key
names, stream contracts agreed between producer and consumer, keys that
never collide with the serving layer's instance-namespace scheme.  Today a
violation of any of these either raises a bare ``ValueError`` deep inside
:class:`~repro.core.dag.Workflow`, silently degrades (a typo'd
``output_sizes`` key used to default every estimate to 1 MB), or — worst —
deadlocks the threaded engine at run time (a self-consumed key drops its
edge in the DAG build and the function then blocks on a Get of its own
output).

``lint()`` turns each of those defect classes into a :class:`Diagnostic`
with a stable code (``DF001``...), a severity, and a fix-it hint:

=======  ========  =====================================================
code     severity  meaning
=======  ========  =====================================================
DF000    error     workflow does not parse / construct at all
DF001    info      by-product output: produced by a non-exit function but
                   never consumed (still collected as a sink result)
DF002    warning   disconnected function: no inputs at all and no
                   consumed outputs — no data edge ties it to the DAG
DF003    error     self-consumed key: function consumes its own output
                   (the edge is dropped; the engine deadlocks on Get)
DF004    info      stream output consumed monolithically (pipelining
                   lost on that edge; the monolithic twin is used)
DF005    info      stream input whose producer does not stream the key
                   (reader falls back to chunking the whole value)
DF006    warning   producer/consumer chunk_size disagreement on a
                   streamed edge
DF007    error     output_sizes entry names a non-output key (size
                   estimates silently fell back to the 1 MB default)
DF008    error     key contains ':' or '#' — collides with DServe's
                   "<wf>#<i>:<key>" instance namespace / DStream's
                   "::chunk.<i>" scheme
DF009    warning*  suspicious glob: matches no produced key (error),
                   keys of multiple distinct producer families, or the
                   declaring function's own outputs
DF010    error*    missing fn binding for a function with declared
                   outputs when an engine run is requested (warning for
                   a mixed bound/unbound workflow without that request)
DF011    error     duplicate producer: two functions output one key
DF012    error     foreach expansion collides with an explicitly
                   declared function name
DF013    error     dependency cycle
DF014    warning   undeclared external input: external_inputs declares
                   some keys but another consumed key silently defaults
                   to a 1 MB external (likely a typo'd input)
DF015    error     invalid resource spec (negative exec_time/cold_start,
                   non-positive cpu)
DF016    warning   declared stream edge can never pipeline (emitted by
                   the DPlan analyzer, not ``lint_workflow``: the
                   consumer also waits on data that only exists after
                   the stream closes)
DF017    info      chunk size defeats stream pipelining (emitted by the
                   DPlan analyzer: the whole stream fits one chunk)
=======  ========  =====================================================

Two entry points: :func:`lint_workflow` checks a constructed
:class:`~repro.core.dag.Workflow`; :func:`lint` additionally accepts a
raw document (dict or YAML text), running the doc-level passes (DF007,
DF009, DF011-DF013) *before* construction so defects that
``parse_workflow`` rejects still get a code instead of a traceback.
:func:`check_workflow` is the engine hook: raise :class:`WorkflowLintError`
when any error-severity diagnostic fires.

Copy of ``repro/core/lint.py`` for the PyTorch port, which imports
nothing of ``repro``; its code is the reference's, line for line, with no
departure. Its CLI is ``python -m repro_torch.lint``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping

from .dag import Workflow, _expand_foreach

__all__ = [
    "Diagnostic", "WorkflowLintError", "CODES", "SEVERITIES",
    "lint", "lint_workflow", "lint_doc", "check_workflow", "max_severity",
]

SEVERITIES = ("info", "warning", "error")

#: code -> (default severity, one-line title)
CODES: dict[str, tuple[str, str]] = {
    "DF000": ("error", "workflow fails to parse/construct"),
    "DF001": ("info", "by-product output (produced, never consumed)"),
    "DF002": ("warning", "disconnected function (no data edges)"),
    "DF003": ("error", "self-consumed key (dropped edge; engine deadlock)"),
    "DF004": ("info", "stream output consumed monolithically"),
    "DF005": ("info", "stream input from a non-streaming producer"),
    "DF006": ("warning", "chunk_size mismatch on streamed edge"),
    "DF007": ("error", "output_sizes names a non-output key"),
    "DF008": ("error", "key collides with instance-namespace separators"),
    "DF009": ("warning", "suspicious glob resolution"),
    "DF010": ("error", "missing fn binding for engine run"),
    "DF011": ("error", "duplicate producer for key"),
    "DF012": ("error", "foreach expansion name collision"),
    "DF013": ("error", "dependency cycle"),
    "DF014": ("warning", "undeclared external input"),
    "DF015": ("error", "invalid resource spec"),
    # DF016/DF017 are registered here for stable numbering/severities but
    # emitted by the DPlan analyzer (repro.core.plan), which sees sizes
    # and placement; lint_workflow stays purely structural.
    "DF016": ("warning", "declared stream edge can never pipeline"),
    "DF017": ("info", "chunk size defeats stream pipelining"),
}

# Separators reserved by the data plane: DServe namespaces instance keys
# as "<wf>#<i>:<key>" (strip_ns prefix-matches on ':'), DStream appends
# "::chunk.<i>" to stream keys.
_RESERVED = (":", "#")


@dataclass(frozen=True)
class Diagnostic:
    """One linter finding with a stable code and a fix-it hint."""

    code: str
    message: str
    function: str | None = None      # offending function, when attributable
    key: str | None = None           # offending data key, when attributable
    hint: str | None = None
    severity: str = ""               # defaults to the code's registry entry

    def __post_init__(self) -> None:
        if not self.severity:
            object.__setattr__(self, "severity", CODES[self.code][0])

    def format(self) -> str:
        where = f" [{self.function}]" if self.function else ""
        hint = f"  (fix: {self.hint})" if self.hint else ""
        return f"{self.code} {self.severity}{where}: {self.message}{hint}"


class WorkflowLintError(ValueError):
    """Raised by :func:`check_workflow` when error diagnostics fire."""

    def __init__(self, wf_name: str, diagnostics: list[Diagnostic]):
        self.diagnostics = diagnostics
        lines = "\n  ".join(d.format() for d in diagnostics)
        super().__init__(
            f"workflow {wf_name!r} failed lint "
            f"({len(diagnostics)} error(s)):\n  {lines}")


def max_severity(diagnostics: Iterable[Diagnostic]) -> str | None:
    """Highest severity present, or None for a clean result."""
    worst = -1
    for d in diagnostics:
        worst = max(worst, SEVERITIES.index(d.severity))
    return SEVERITIES[worst] if worst >= 0 else None


# ----------------------------------------------------------------------
# Workflow-level passes (constructed Workflow objects)
# ----------------------------------------------------------------------

def lint_workflow(wf: Workflow, *,
                  require_fns: bool = False) -> list[Diagnostic]:
    """Run every semantic pass over a constructed Workflow.

    ``require_fns`` marks an intended *engine* run: every function with
    declared outputs must carry a real callable (the engine raises a
    KeyError mid-flight otherwise).
    """
    out: list[Diagnostic] = []
    consumed: dict[str, list[str]] = {}
    for f in wf.functions.values():
        for k in f.inputs:
            consumed.setdefault(k, []).append(f.name)
    exit_set = set(wf.exit_points)

    for f in wf.functions.values():
        # DF003 — before anything else: dag.py's edge derivation skips
        # p == f.name, so the dependency silently vanishes and the engine
        # blocks on a Get of a key only this very function will ever Put.
        for k in f.inputs:
            if k in f.outputs:
                out.append(Diagnostic(
                    "DF003", f"{f.name!r} consumes its own output {k!r}; "
                    "the edge is dropped and the engine deadlocks on Get",
                    function=f.name, key=k,
                    hint="rename the output or read the upstream key"))

        # DF001 — a non-exit function's output nobody reads.  It is still
        # collected as a sink by-product, so only informational.
        if f.name not in exit_set:
            for k in f.outputs:
                if k not in consumed:
                    out.append(Diagnostic(
                        "DF001", f"output {k!r} of {f.name!r} is never "
                        "consumed (collected as a by-product sink)",
                        function=f.name, key=k,
                        hint="consume it, or drop it from outputs"))

        # DF002 — no data edge at all ties the function to the workflow.
        if (len(wf) > 1 and not f.inputs
                and not any(k in consumed for k in f.outputs)):
            out.append(Diagnostic(
                "DF002", f"{f.name!r} has no inputs and none of its "
                "outputs are consumed — disconnected from the DAG",
                function=f.name,
                hint="wire it to the workflow or remove it"))

        # DF008 — reserved separators in data keys.
        for k in (*f.outputs, *f.inputs):
            if any(s in k for s in _RESERVED):
                out.append(Diagnostic(
                    "DF008", f"key {k!r} contains a reserved separator "
                    "(':' or '#'); DServe namespaces keys as "
                    "'<wf>#<i>:<key>' and DStream as '<key>::chunk.<i>'",
                    function=f.name, key=k,
                    hint="use '.', '-' or '_' inside key names"))

        # DF015 — resource fields FunctionSpec does not validate.
        if f.exec_time < 0 or f.cold_start < 0 or f.cpu <= 0:
            out.append(Diagnostic(
                "DF015", f"{f.name!r} has invalid resources "
                f"(exec_time={f.exec_time}, cold_start={f.cold_start}, "
                f"cpu={f.cpu})", function=f.name,
                hint="exec_time/cold_start must be >= 0 and cpu > 0"))

        # DF005 / DF006 — consumer-side stream contract.
        for k in f.stream_inputs:
            p = wf.producer.get(k)
            if p is None or p == f.name:
                out.append(Diagnostic(
                    "DF005", f"{f.name!r} streams input {k!r} but no "
                    "producer streams it (external or monolithic key); "
                    "the reader falls back to chunking the whole value",
                    function=f.name, key=k,
                    hint="declare it in the producer's stream_outputs"))
                continue
            prod = wf.functions[p]
            if k not in prod.stream_outputs:
                out.append(Diagnostic(
                    "DF005", f"{f.name!r} streams input {k!r} but its "
                    f"producer {p!r} puts it monolithically; no "
                    "pipelining on this edge", function=f.name, key=k,
                    hint=f"add {k!r} to {p!r}.stream_outputs"))
            elif prod.chunk_size != f.chunk_size:
                out.append(Diagnostic(
                    "DF006", f"streamed edge {p!r} -> {f.name!r} on {k!r} "
                    f"disagrees on chunk_size ({prod.chunk_size} vs "
                    f"{f.chunk_size}); chunks arrive producer-sized",
                    function=f.name, key=k,
                    hint="align both chunk_size declarations"))

        # DF004 — producer streams, some consumer reads monolithically.
        for k in f.stream_outputs:
            for c in consumed.get(k, ()):
                cf = wf.functions[c]
                if k not in cf.stream_inputs:
                    out.append(Diagnostic(
                        "DF004", f"{f.name!r} streams output {k!r} but "
                        f"{c!r} consumes it monolithically (waits for "
                        "close; pipelining lost on this edge)",
                        function=c, key=k,
                        hint=f"add {k!r} to {c!r}.stream_inputs"))

    # DF008 also applies to declared external inputs (they become keys).
    for k in wf.external_inputs:
        if any(s in k for s in _RESERVED):
            out.append(Diagnostic(
                "DF008", f"external input {k!r} contains a reserved "
                "separator (':' or '#')", key=k,
                hint="use '.', '-' or '_' inside key names"))

    # DF014 — partially declared externals: the undeclared ones silently
    # became 1 MB defaults, the classic signature of a typo'd input key.
    if wf.declared_external:
        for k in wf.external_inputs:
            if k not in wf.declared_external:
                out.append(Diagnostic(
                    "DF014", f"input {k!r} is not produced by any "
                    "function and not declared in external_inputs; it "
                    "silently defaulted to a 1 MB external",
                    key=k, hint="declare it in external_inputs or fix "
                    "the input key"))

    # DF010 — fn bindings.  With require_fns every output-bearing function
    # needs a callable; otherwise a *mixed* workflow (some bound, some
    # not) is flagged as a likely forgotten binding.
    unbound = [f.name for f in wf.functions.values()
               if f.fn is None and f.outputs]
    bound_any = any(f.fn is not None for f in wf.functions.values())
    if require_fns:
        for name in unbound:
            out.append(Diagnostic(
                "DF010", f"{name!r} has declared outputs but no fn "
                "binding; an engine run would fail mid-flight",
                function=name,
                hint="bind a callable via parse_workflow(doc, fns=...)"))
    elif bound_any and unbound:
        for name in unbound:
            out.append(Diagnostic(
                "DF010", f"{name!r} has no fn binding while other "
                "functions are bound (forgotten binding?)",
                function=name, severity="warning",
                hint="bind a callable or drop the other bindings"))
    return out


# ----------------------------------------------------------------------
# Doc-level passes (raw workflow.yaml documents, pre-construction)
# ----------------------------------------------------------------------

_FOREACH_SUFFIX = re.compile(r"\.\d+$")


def _family(name: str) -> str:
    """Producer family of an expanded function: 'count.3' -> 'count'."""
    return _FOREACH_SUFFIX.sub("", name)


def _doc_passes(doc: Mapping[str, Any]) -> tuple[list[Diagnostic], bool]:
    """Structural checks on the raw document.  Returns (diagnostics,
    constructible) — construction is skipped when a defect
    ``parse_workflow`` would reject was found."""
    out: list[Diagnostic] = []
    expanded: list[tuple[str, dict]] = []
    for fname, spec in (doc.get("functions") or {}).items():
        try:
            expanded.extend(_expand_foreach(fname, spec))
        except (TypeError, ValueError) as exc:
            out.append(Diagnostic(
                "DF000", f"foreach of {fname!r} fails to expand: {exc}",
                function=fname))
            return out, False

    # DF012 — expansion collides with an explicit declaration.
    seen: set[str] = set()
    for fname, _ in expanded:
        if fname in seen:
            out.append(Diagnostic(
                "DF012", f"function {fname!r} declared twice (foreach "
                "expansion collides with an explicit function)",
                function=fname,
                hint="rename the explicit function or shrink the foreach"))
        seen.add(fname)

    # DF011 — duplicate producer across the expanded set.
    producer: dict[str, str] = {}
    for fname, spec in expanded:
        for k in spec.get("outputs") or ():
            if k in producer and producer[k] != fname:
                out.append(Diagnostic(
                    "DF011", f"key {k!r} produced by both "
                    f"{producer[k]!r} and {fname!r} (DStore keys are "
                    "single-producer)", function=fname, key=k,
                    hint="give each producer a distinct output key"))
            else:
                producer[k] = fname

    # DF007 — output_sizes naming non-output keys.
    for fname, spec in expanded:
        outputs = set(spec.get("outputs") or ())
        for k in (spec.get("output_sizes") or {}):
            if k not in outputs:
                out.append(Diagnostic(
                    "DF007", f"{fname!r} sizes unknown key {k!r}; "
                    "simulator estimates would fall back to the 1 MB "
                    "default", function=fname, key=k,
                    hint=f"name one of {sorted(outputs)}"))

    # DF009 — suspicious glob resolutions (an input ending in '*').
    produced = set(producer)
    resolved_inputs: dict[str, list[str]] = {}
    for fname, spec in expanded:
        keys: list[str] = []
        for k in spec.get("inputs") or ():
            if not k.endswith("*"):
                keys.append(k)
                continue
            matches = sorted(p for p in produced if p.startswith(k[:-1]))
            keys.extend(matches)
            own = set(spec.get("outputs") or ())
            if not matches:
                out.append(Diagnostic(
                    "DF009", f"glob {k!r} in {fname!r} matches no "
                    "produced key", function=fname, key=k,
                    severity="error",
                    hint="fix the prefix or drop the glob"))
            elif own & set(matches):
                out.append(Diagnostic(
                    "DF009", f"glob {k!r} in {fname!r} matches its own "
                    f"output(s) {sorted(own & set(matches))}",
                    function=fname, key=k,
                    hint="narrow the glob prefix"))
            else:
                fams = {_family(producer[m]) for m in matches}
                if len(fams) > 1:
                    out.append(Diagnostic(
                        "DF009", f"glob {k!r} in {fname!r} matches keys "
                        f"from {len(fams)} distinct producers "
                        f"({sorted(fams)}) — likely over-matching",
                        function=fname, key=k,
                        hint="lengthen the glob prefix"))
        resolved_inputs[fname] = keys

    # DF013 — cycle over the resolved edge set (construction would raise).
    succ: dict[str, set[str]] = {n: set() for n, _ in expanded}
    indeg = {n: 0 for n, _ in expanded}
    for fname, _ in expanded:
        for k in resolved_inputs.get(fname, ()):
            p = producer.get(k)
            if p is not None and p != fname and fname not in succ[p]:
                succ[p].add(fname)
                indeg[fname] += 1
    ready = [n for n, d in indeg.items() if d == 0]
    done = 0
    while ready:
        n = ready.pop()
        done += 1
        for s in succ[n]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if done != len(indeg):
        cyc = sorted(n for n, d in indeg.items() if d > 0)
        out.append(Diagnostic(
            "DF013", f"dependency cycle through {cyc}",
            hint="break the cycle (keys are immutable; no in-place "
            "updates)"))

    blocking = {"DF007", "DF009", "DF011", "DF012", "DF013", "DF000"}
    constructible = not any(
        d.code in blocking and d.severity == "error" for d in out)
    return out, constructible


def lint_doc(doc: Mapping[str, Any] | str,
             fns: Mapping[str, Callable] | None = None, *,
             require_fns: bool = False) -> list[Diagnostic]:
    """Lint a raw workflow document (dict or YAML text): doc-level passes
    first, then — when the document is constructible — the full
    :func:`lint_workflow` pass over the parsed result."""
    from .dag import parse_workflow

    if isinstance(doc, str):
        import io

        import yaml
        try:
            doc = yaml.safe_load(io.StringIO(doc))
        except yaml.YAMLError as exc:
            return [Diagnostic("DF000", f"YAML does not parse: {exc}")]
    if not isinstance(doc, Mapping) or "functions" not in doc:
        return [Diagnostic(
            "DF000", "document has no 'functions' mapping",
            hint="see dag.py's module docstring for the schema")]

    out, constructible = _doc_passes(doc)
    if not constructible:
        return out
    try:
        wf = parse_workflow(doc, fns)
    except (ValueError, KeyError, TypeError) as exc:
        out.append(Diagnostic(
            "DF000", f"workflow fails to construct: {exc}"))
        return out
    dedup = {(d.code, d.function, d.key) for d in out}
    for d in lint_workflow(wf, require_fns=require_fns):
        if (d.code, d.function, d.key) not in dedup:
            out.append(d)
    return out


def lint(source: Workflow | Mapping[str, Any] | str,
         fns: Mapping[str, Callable] | None = None, *,
         require_fns: bool = False) -> list[Diagnostic]:
    """Lint a Workflow object, a parsed document, or YAML text."""
    if isinstance(source, Workflow):
        return lint_workflow(source, require_fns=require_fns)
    return lint_doc(source, fns, require_fns=require_fns)


def check_workflow(wf: Workflow, *, require_fns: bool = False) -> None:
    """Engine pre-flight: raise :class:`WorkflowLintError` when any
    error-severity diagnostic fires (deadlocks, namespace collisions and
    missing bindings are cheaper to reject here than to debug as a
    wedged Get two layers down)."""
    errors = [d for d in lint_workflow(wf, require_fns=require_fns)
              if d.severity == "error"]
    if errors:
        raise WorkflowLintError(wf.name, errors)
