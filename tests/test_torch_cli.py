"""The port's CLIs (``python -m repro_torch.lint``, ``repro_torch.plan``,
``repro_torch.obs``) and the DCheck linter (``repro_torch.core.lint``)
held to the reference's.

* The cases of tests/test_lint.py and the CLI cases of tests/test_plan.py,
  unchanged but for the package they reach: each runs once on either
  package (``[repro]``, ``[repro_torch]``) through the namespace ``C``
  (``tests/torch_cases.py``).
* Parity: each CLI's ``--format json`` output and exit code equal the
  reference CLI's on the builtin benchmarks, ``--strict`` included, and
  ``obs diff`` exits 1 on a regression in both.
"""

import importlib
import json
import pathlib
import subprocess
import sys
import types

import pytest
from torch_cases import PACKAGES, bind, both, bound_elsewhere

import repro.core.workloads as ref_workloads

IMPORTS = {
    'core.dag': ['FunctionSpec', 'Workflow'],
    'core.lint': ['CODES', 'WorkflowLintError', 'check_workflow', 'lint',
                  'lint_workflow', 'max_severity'],
    'core.workloads': ['BENCHMARKS'],
    'lint': [['main', 'lint_main']],
    'core.dscheduler': ['DFlowEngine'],
    'core.serve': ['DServe'],
    'plan': [['main', 'plan_main']],
}

C = types.SimpleNamespace()     # the names of the package under test
package = bind(C, IMPORTS)


def test_the_cases_reach_the_package_under_test(package):
    assert not bound_elsewhere(package, C)


# ----------------------------------------------------------------------
# tests/test_lint.py
# ----------------------------------------------------------------------

def _fn(**kw):
    return {}


def _spec(name, inputs=(), outputs=(), **kw):
    kw.setdefault("fn", _fn)
    return C.FunctionSpec(name, inputs=tuple(inputs), outputs=tuple(outputs),
                          **kw)


def clean_wf():
    return C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1",)),
        _spec("b", inputs=("k1",), outputs=("r",)),
    ])


def codes_of(diags):
    return {d.code for d in diags}


# ----------------------------------------------------------------------
# Baseline: the clean workflow and every built-in workload are clean.
# ----------------------------------------------------------------------

def test_clean_workflow_lints_clean():
    assert C.lint_workflow(clean_wf(), require_fns=True) == []


@pytest.mark.parametrize("name", sorted(ref_workloads.BENCHMARKS))
def test_builtin_workloads_lint_clean(name):
    assert C.lint_workflow(C.BENCHMARKS[name]()) == []


# ----------------------------------------------------------------------
# Workflow-level mutations, one code each.
# ----------------------------------------------------------------------

def test_df001_by_product_output():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1", "junk")),
        _spec("b", inputs=("k1",), outputs=("r",)),
    ])
    diags = C.lint_workflow(wf)
    assert codes_of(diags) == {"DF001"}
    (d,) = diags
    assert d.key == "junk" and d.severity == "info"


def test_df001_not_raised_for_exit_outputs():
    # Exit-function outputs are the workflow's results, not by-products.
    assert C.lint_workflow(clean_wf()) == []


def test_df002_disconnected_function():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1",)),
        _spec("b", inputs=("k1",), outputs=("r",)),
        _spec("island", inputs=(), outputs=("z",)),
    ])
    assert "DF002" in codes_of(C.lint_workflow(wf))


def test_df003_self_consumed_key():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1",)),
        _spec("b", inputs=("k1", "r"), outputs=("r",)),
    ])
    diags = [d for d in C.lint_workflow(wf) if d.code == "DF003"]
    assert diags and diags[0].key == "r" and diags[0].severity == "error"


def test_df004_stream_output_consumed_monolithically():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1",), stream_outputs=("k1",)),
        _spec("b", inputs=("k1",), outputs=("r",)),
    ])
    diags = [d for d in C.lint_workflow(wf) if d.code == "DF004"]
    assert diags and diags[0].severity == "info"


def test_df005_stream_input_from_monolithic_producer():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1",)),
        _spec("b", inputs=("k1",), outputs=("r",), stream_inputs=("k1",)),
    ])
    assert "DF005" in codes_of(C.lint_workflow(wf))


def test_df006_chunk_size_mismatch():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1",), stream_outputs=("k1",),
              chunk_size=512),
        _spec("b", inputs=("k1",), outputs=("r",), stream_inputs=("k1",),
              chunk_size=1024),
    ])
    diags = [d for d in C.lint_workflow(wf) if d.code == "DF006"]
    assert diags and diags[0].severity == "warning"


def test_df006_silent_when_sizes_agree():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1",), stream_outputs=("k1",),
              chunk_size=512),
        _spec("b", inputs=("k1",), outputs=("r",), stream_inputs=("k1",),
              chunk_size=512),
    ])
    assert "DF006" not in codes_of(C.lint_workflow(wf))


def test_df008_reserved_separator_in_key():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k:1",)),
        _spec("b", inputs=("k:1",), outputs=("r#2",)),
    ])
    diags = [d for d in C.lint_workflow(wf) if d.code == "DF008"]
    assert {d.key for d in diags} == {"k:1", "r#2"}
    assert all(d.severity == "error" for d in diags)


def test_df010_missing_fn_binding_for_engine_run():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1",)),
        C.FunctionSpec("b", inputs=("k1",), outputs=("r",)),   # fn=None
    ])
    diags = [d for d in C.lint_workflow(wf, require_fns=True)
             if d.code == "DF010"]
    assert diags and diags[0].severity == "error"
    # Without an engine-run request, a mixed workflow is only a warning.
    diags = [d for d in C.lint_workflow(wf) if d.code == "DF010"]
    assert diags and diags[0].severity == "warning"
    # Fully unbound (simulator-style) workflows are fine.
    sim = C.Workflow("t", [
        C.FunctionSpec("a", inputs=("x",), outputs=("k1",)),
        C.FunctionSpec("b", inputs=("k1",), outputs=("r",)),
    ])
    assert C.lint_workflow(sim) == []


def test_df014_undeclared_external_input():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x", "corpsu"), outputs=("k1",)),   # typo'd key
        _spec("b", inputs=("k1",), outputs=("r",)),
    ], external_inputs={"x": 64, "corpus": 64})
    diags = [d for d in C.lint_workflow(wf) if d.code == "DF014"]
    assert diags and diags[0].key == "corpsu"


def test_df014_silent_without_declared_externals():
    # No declared set to check against: inferred externals are the normal
    # contract (keys never produced are workflow inputs).
    assert "DF014" not in codes_of(C.lint_workflow(clean_wf()))


def test_df015_invalid_resources():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1",), exec_time=-0.5),
        _spec("b", inputs=("k1",), outputs=("r",), cpu=0.0),
    ])
    diags = [d for d in C.lint_workflow(wf) if d.code == "DF015"]
    assert {d.function for d in diags} == {"a", "b"}


# ----------------------------------------------------------------------
# Doc-level mutations (defects construction would reject still get codes).
# ----------------------------------------------------------------------

def _doc(functions, **extra):
    return {"name": "t", "functions": functions, **extra}


def test_df000_unparseable_yaml():
    assert codes_of(C.lint("{:::")) == {"DF000"}
    assert codes_of(C.lint({"no_functions": True})) == {"DF000"}


def test_df007_output_sizes_unknown_key():
    doc = _doc({
        "a": {"inputs": ["x"], "outputs": ["k1"],
              "output_sizes": {"k2": "8MB"}},
        "b": {"inputs": ["k1"], "outputs": ["r"]},
    })
    diags = C.lint(doc)
    assert "DF007" in codes_of(diags)
    # Construction would raise (FunctionSpec validates now); the linter
    # still reports the precise code, not a bare DF000 traceback.
    assert "DF000" not in codes_of(diags)


def test_df009_glob_matches_nothing():
    doc = _doc({
        "a": {"inputs": ["x"], "outputs": ["k1"]},
        "b": {"inputs": ["wc.*"], "outputs": ["r"]},
    })
    diags = [d for d in C.lint(doc) if d.code == "DF009"]
    assert diags and diags[0].severity == "error"


def test_df009_glob_over_matches_families():
    doc = _doc({
        "a": {"inputs": ["x"], "outputs": ["out.1"]},
        "b": {"inputs": ["x"], "outputs": ["out.2"]},
        "c": {"inputs": ["out.*"], "outputs": ["r"]},
    })
    diags = [d for d in C.lint(doc) if d.code == "DF009"]
    assert diags and diags[0].severity == "warning"


def test_df011_duplicate_producer():
    doc = _doc({
        "a": {"inputs": ["x"], "outputs": ["k1"]},
        "b": {"inputs": ["x"], "outputs": ["k1"]},
    })
    diags = [d for d in C.lint(doc) if d.code == "DF011"]
    assert diags and diags[0].key == "k1"


def test_df012_foreach_collision():
    doc = _doc({
        "count": {"foreach": 2, "inputs": ["x"], "outputs": ["wc.$i"]},
        "count.1": {"inputs": ["x"], "outputs": ["other"]},
    })
    assert "DF012" in codes_of(C.lint(doc))


def test_df013_cycle():
    doc = _doc({
        "a": {"inputs": ["k2"], "outputs": ["k1"]},
        "b": {"inputs": ["k1"], "outputs": ["k2"]},
    })
    diags = [d for d in C.lint(doc) if d.code == "DF013"]
    assert diags and diags[0].severity == "error"


def test_clean_doc_lints_clean():
    doc = _doc({
        "split": {"inputs": ["corpus"],
                  "outputs": ["shard.0", "shard.1"],
                  "output_sizes": {"shard.0": "1KB", "shard.1": "1KB"}},
        "count": {"foreach": 2, "inputs": ["shard.$i"],
                  "outputs": ["wc.$i"]},
        "merge": {"inputs": ["wc.*"], "outputs": ["result"]},
    }, external_inputs={"corpus": "2KB"})
    assert C.lint(doc) == []


def test_registry_exercises_ten_plus_codes():
    """Acceptance floor: the linter detects >= 10 distinct codes (every
    registry entry has a dedicated mutation test above; this is the
    aggregate guard)."""
    fired = set()
    fired |= codes_of(C.lint("{:::"))
    fired |= codes_of(C.lint_workflow(C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1", "junk", "s:d")),
        _spec("island"),
        _spec("b", inputs=("k1", "r"), outputs=("r",), exec_time=-1.0,
              stream_inputs=("k1",)),
        C.FunctionSpec("c", inputs=("k1",), outputs=("q",)),
    ]), require_fns=True))
    fired |= codes_of(C.lint(_doc({
        "a": {"inputs": ["x"], "outputs": ["k1"],
              "output_sizes": {"nope": 1}},
        "b": {"inputs": ["x"], "outputs": ["k1"]},
        "count": {"foreach": 2, "inputs": ["zz.*"], "outputs": ["wc.$i"]},
        "count.1": {"inputs": ["x"], "outputs": ["o"]},
    })))
    fired |= codes_of(C.lint(_doc({
        "a": {"inputs": ["k2"], "outputs": ["k1"]},
        "b": {"inputs": ["k1"], "outputs": ["k2"]},
    })))
    assert len(fired) >= 10, sorted(fired)
    assert fired <= set(C.CODES)


# ----------------------------------------------------------------------
# check_workflow: the engine/serve pre-flight gate.
# ----------------------------------------------------------------------

def test_check_workflow_raises_on_errors():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k1",)),
        _spec("b", inputs=("k1", "r"), outputs=("r",)),
    ])
    with pytest.raises(C.WorkflowLintError) as ei:
        C.check_workflow(wf)
    assert any(d.code == "DF003" for d in ei.value.diagnostics)
    C.check_workflow(clean_wf(), require_fns=True)     # clean: no raise


def test_engine_preflight_rejects_unbound_run():
    wf = C.Workflow("t", [
        C.FunctionSpec("a", inputs=("x",), outputs=("k1",)),
    ])
    with pytest.raises(C.WorkflowLintError):
        C.DFlowEngine(n_nodes=1).run(wf, {"x": b"v"})
    # Opt-out for callers that manage binding themselves.
    eng = C.DFlowEngine(n_nodes=1, lint=False)
    assert eng.lint is False


def test_serve_preflight_rejects_bad_workflow():
    wf = C.Workflow("t", [
        _spec("a", inputs=("x",), outputs=("k:bad",)),
    ])
    with pytest.raises(C.WorkflowLintError):
        C.DServe(wf, n_nodes=1)


def test_max_severity():
    assert C.max_severity([]) is None
    assert C.max_severity(C.lint("{:::")) == "error"


# ----------------------------------------------------------------------
# Fuzz contract: every generated random DAG lints clean.
# ----------------------------------------------------------------------

def test_random_workflows_lint_clean():
    # strategies.lint_clean, on the package's own linter
    for seed in range(200):
        bad = [d for d in C.lint_workflow(C.random_workflow(seed),
                                          require_fns=True)
               if d.severity in ("warning", "error")]
        assert not bad, (seed, [d.format() for d in bad])


# ----------------------------------------------------------------------
# CLI (python -m repro.lint)
# ----------------------------------------------------------------------

CLEAN_YAML = """
name: wc
functions:
  split:
    inputs: [corpus]
    outputs: [shard.0, shard.1]
  count:
    foreach: 2
    inputs: [shard.$i]
    outputs: [wc.$i]
  merge:
    inputs: [wc.*]
    outputs: [result]
external_inputs:
  corpus: 2KB
"""

BROKEN_YAML = """
name: broken
functions:
  a:
    inputs: [x, r]
    outputs: [r]
"""


def test_cli_clean_file(tmp_path, capsys):
    p = tmp_path / "wc.yaml"
    p.write_text(CLEAN_YAML)
    assert C.lint_main([str(p)]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_broken_file_fails(tmp_path, capsys):
    p = tmp_path / "broken.yaml"
    p.write_text(BROKEN_YAML)
    assert C.lint_main([str(p)]) == 1
    assert "DF003" in capsys.readouterr().out


def test_cli_builtins_all_clean(capsys):
    assert C.lint_main(["--builtin", "all"]) == 0
    out = capsys.readouterr().out
    assert "builtin:WC" in out and "0 failed" in out


def test_cli_strict_fails_on_warning(tmp_path):
    p = tmp_path / "warn.yaml"
    # Mixed bound/unbound can't happen via YAML; use a partial external
    # declaration (DF014 warning) instead.
    p.write_text("""
name: warn
functions:
  a:
    inputs: [x, y]
    outputs: [r]
external_inputs:
  x: 1KB
""")
    assert C.lint_main([str(p)]) == 0
    assert C.lint_main([str(p), "--strict"]) == 1


def test_cli_json_format(tmp_path, capsys):
    p = tmp_path / "broken.yaml"
    p.write_text(BROKEN_YAML)
    assert C.lint_main([str(p), "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc[0]["target"] == str(p)
    assert any(d["code"] == "DF003" for d in doc[0]["diagnostics"])


def test_cli_list_codes(capsys):
    assert C.lint_main(["--list-codes"]) == 0
    out = capsys.readouterr().out
    for code in C.CODES:
        assert code in out


# ----------------------------------------------------------------------
# tests/test_plan.py: the CLI
# ----------------------------------------------------------------------

def test_cli_builtins_clean(capsys):
    assert C.plan_main(["--builtin", "all"]) == 0
    out = capsys.readouterr().out
    assert "prewarm schedule" in out and "0 failed" in out


def test_cli_json(capsys):
    assert C.plan_main(["--builtin", "Srv", "--format", "json"]) == 0
    docs = json.loads(capsys.readouterr().out)
    assert docs[0]["workflow"] == "Srv"
    assert docs[0]["self_check"] == []
    assert docs[0]["eviction_order"]
    assert docs[0]["prewarm_schedule"]


def test_cli_examples(capsys, tmp_path):
    assert C.plan_main(["examples/workflows/wordcount.yaml",
                   "examples/workflows/video_pipeline.yaml"]) == 0
    # A document that fails to parse fails the plan run.
    bad = tmp_path / "bad.yaml"
    bad.write_text("functions:\n  - name: a\n    outputs: [k]\n"
                   "  - name: b\n    outputs: [k]\n")
    assert C.plan_main([str(bad)]) == 1
    assert "PLAN FAILED" in capsys.readouterr().out


def test_cli_requires_target():
    with pytest.raises(SystemExit):
        C.plan_main([])


# ----------------------------------------------------------------------
# Parity with the reference: each CLI's JSON output and exit code
# ----------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted(str(p) for p in (ROOT / "examples" / "workflows").glob(
    "*.yaml"))


def _run(capsys, pkg: str, cli: str, argv: list) -> tuple:
    """``python -m <pkg>.<cli> argv`` through its ``main``: the exit code,
    the standard output (parsed when it is JSON) and the standard error."""
    capsys.readouterr()
    rc = importlib.import_module(f"{pkg}.{cli}").main(list(argv))
    out, err = capsys.readouterr()
    try:
        out = json.loads(out)
    except ValueError:
        pass
    return rc, out, err


def _both_agree(capsys, cli, argv):
    ref = _run(capsys, "repro", cli, argv)
    assert _run(capsys, "repro_torch", cli, argv) == ref
    return ref


@both
@pytest.mark.parametrize("argv", [
    ["--builtin", "all", "--format", "json"],
    ["--builtin", "all", "--format", "json", "--strict"],
    ["--builtin", "all", "--format", "json", "--require-fns"],
    ["--builtin", "WC", "--builtin", "Srv", "--format", "json"],
    ["--format", "json", *EXAMPLES],
    ["--format", "json", "--strict", *EXAMPLES],
    ["--builtin", "all", *EXAMPLES],
    ["--list-codes"],
], ids=["all", "strict", "require-fns", "two", "examples",
        "examples-strict", "text", "codes"])
def test_lint_cli_equals_the_reference(capsys, argv):
    rc, out, _ = _both_agree(capsys, "lint", argv)
    if "--require-fns" in argv or any("broken" in a for a in argv):
        assert rc == 1             # the gate fires in both
    if argv[-1] == "json":
        assert isinstance(out, list) and out


@both
@pytest.mark.parametrize("argv", [
    ["--builtin", "all", "--format", "json"],
    ["--builtin", "all", "--format", "json", "--nodes", "0"],
    ["--builtin", "all", "--format", "json", "--nodes", "4"],
    ["--builtin", "all", "--format", "json", "--strict"],
    ["--format", "json", "--nodes", "3", *EXAMPLES],
    ["--builtin", "all", "--nodes", "3", *EXAMPLES],
], ids=["all", "unplaced", "four", "strict", "examples", "text"])
def test_plan_cli_equals_the_reference(capsys, argv):
    rc, out, _ = _both_agree(capsys, "plan", argv)
    if "json" in argv and not any("broken" in a for a in argv):
        assert isinstance(out, list) and all(
            d.get("self_check") == [] for d in out)
    assert rc in (0, 1)


def _span_file(tmp_path) -> str:
    """The spans of a virtual-clock simulator run with its DPlan embedded,
    written by the reference."""
    from repro.core import make_workflow, run_open_loop
    from repro.core.obs import Tracer, plan_attribution, write_spans_jsonl
    from repro.core.plan import build_plan
    tr = Tracer()
    wf = make_workflow("Epi")
    run_open_loop("dflow", wf, rate_per_min=30, n_invocations=4, spans=tr,
                  poisson_seed=2)
    path = str(tmp_path / "spans.jsonl")
    write_spans_jsonl(tr.finished(), path, plan=plan_attribution(
        build_plan(wf, nodes=[f"node{i + 1}" for i in range(7)])))
    return path


@both
def test_obs_cli_equals_the_reference(capsys, tmp_path):
    path = _span_file(tmp_path)
    for argv in (["summarize", path], ["summarize", path, "--tree", "2"],
                 ["attribute", path], ["attribute", path, "--format",
                                       "json"]):
        rc, out, _ = _both_agree(capsys, "obs", argv)
        assert rc == 0 and out
    report = _run(capsys, "repro_torch", "obs",
                  ["attribute", path, "--format", "json"])[1]
    assert report["requests"] == 4 and report["functions"]
    traces = {}
    for pkg in PACKAGES:
        out = str(tmp_path / f"{pkg}.trace.json")
        assert _run(capsys, pkg, "obs", ["perfetto", path, "-o", out])[0] \
            == 0
        traces[pkg] = pathlib.Path(out).read_bytes()
    assert traces["repro_torch"] == traces["repro"]


@both
def test_obs_diff_exits_one_on_a_regression_in_both(capsys, tmp_path):
    from repro.core.obs import bench_doc, bench_metric
    old = bench_doc("b", {}, [
        bench_metric("s", "p99", 1.0, "s", direction="lower"),
        bench_metric("s", "hits", 0.9, "", direction="higher"),
        bench_metric("s", "noise", 5.0, "s")])
    docs = {"old": old,
            "same": bench_doc("b", {}, [
                bench_metric("s", "p99", 1.05), bench_metric("s", "hits", 0.9),
                bench_metric("s", "noise", 50.0)]),
            "worse": bench_doc("b", {}, [
                bench_metric("s", "p99", 1.5), bench_metric("s", "hits", 0.5),
                bench_metric("s", "noise", 5.0)])}
    paths = {}
    for name, doc in docs.items():
        paths[name] = str(tmp_path / f"{name}.json")
        pathlib.Path(paths[name]).write_text(json.dumps(doc))
    assert _both_agree(capsys, "obs", ["diff", paths["old"],
                                       paths["same"]])[0] == 0
    rc, _, err = _both_agree(capsys, "obs", ["diff", paths["old"],
                                             paths["worse"]])
    assert rc == 1 and err.count("REGRESSION") == 2
    # a default tolerance wide enough for both drifts lets the run pass
    assert _both_agree(capsys, "obs", ["diff", paths["old"], paths["worse"],
                                       "--tolerance", "0.9"])[0] == 0


@both
@pytest.mark.parametrize("cli,argv", [
    ("lint", ["--builtin", "all", "--format", "json"]),
    ("plan", ["--builtin", "Srv", "--format", "json"]),
    ("lint", ["--format", "json", str(ROOT / "examples" / "workflows"
                                      / "broken_demo.yaml")]),
], ids=["lint", "plan", "lint-broken"])
def test_python_dash_m_equals_the_reference(cli, argv):
    """``python -m repro_torch.<cli>`` as a program: the same output and
    exit code as ``python -m repro.<cli>``."""
    got = {}
    for pkg in PACKAGES:
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.{cli}", *argv],
            capture_output=True, text=True, timeout=120, cwd=ROOT,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                 "JAX_PLATFORMS": "cpu"})
        got[pkg] = (proc.returncode, json.loads(proc.stdout))
    assert got["repro_torch"] == got["repro"]


MODULES = ("core", "core.obs", "core.scale", "core.serve", "core.plan",
           "core.workloads", "core.sim", "core.simcluster",
           "core.sim_dataplane", "core.sim_systems", "core.experiments",
           "lint", "plan", "obs")


@both
@pytest.mark.parametrize("module", MODULES)
def test_exports_equal_the_reference(module):
    ref, port = (importlib.import_module(f"{p}.{module}") for p in PACKAGES)
    extra = ["GetTimeout", "RunReport"] if module == "core" else []
    assert sorted(port.__all__) == sorted(ref.__all__ + extra)
    for name in port.__all__:
        home = getattr(getattr(port, name), "__module__", None)
        assert home is None or home.startswith("repro_torch."), name
