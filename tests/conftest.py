"""Shared test fixtures/shims.

``hypothesis`` is an optional dev dependency (requirements-dev.txt): when it
is missing, property-based tests skip while the rest of their modules run.
Test modules import the shim via ``from conftest import given, settings, st``.

DCheck trace validation (opt-in): ``DFLOW_TRACE_CHECK=1`` attaches a
:class:`repro.core.check.TraceRecorder` to every DStore a test constructs
and replays the trace through :class:`TraceChecker` at teardown — any
happens-before / immutability / eviction / chunk-sequence violation fails
the test.  ``DFLOW_TRACE_STRESS=<seed>`` additionally injects seeded
random sleeps at every instrumentation point so thread interleavings are
actually explored.  Tests that *deliberately* violate invariants opt out
with ``@pytest.mark.notracecheck``.
"""

import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running sweeps (the 200-seed differential run); "
        'CI quick tier runs -m "not slow"')
    config.addinivalue_line(
        "markers",
        "notracecheck: skip DFLOW_TRACE_CHECK validation (test seeds "
        "deliberate invariant violations)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels); skips "
        "without one. On the card: python -m pytest -m cuda tests/")


if os.environ.get("DFLOW_TRACE_CHECK") == "1":
    @pytest.fixture(autouse=True)
    def _dflow_trace_check(request, monkeypatch):
        if request.node.get_closest_marker("notracecheck"):
            yield
            return
        from repro.core.check import TraceChecker, TraceRecorder
        from repro.core.dstore import DStore

        stress_env = os.environ.get("DFLOW_TRACE_STRESS")
        stress = int(stress_env) if stress_env else None
        recorders: list[TraceRecorder] = []
        orig_init = DStore.__init__

        def init(self, *args, **kwargs):
            orig_init(self, *args, **kwargs)
            rec = TraceRecorder(stress=stress)
            recorders.append(rec)
            self.attach_tracer(rec)

        monkeypatch.setattr(DStore, "__init__", init)
        yield
        checker = TraceChecker()
        for rec in recorders:
            checker.check_or_raise(rec.events())


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:
    def settings(**kw):
        return lambda fn: fn

    def given(*a, **kw):
        def deco(fn):
            @pytest.mark.skip(reason="hypothesis not installed")
            def wrapper():
                pass                  # pragma: no cover
            wrapper.__name__ = fn.__name__
            return wrapper
        return deco

    class _StStub:
        def __getattr__(self, name):
            return lambda *a, **kw: None

    st = _StStub()
