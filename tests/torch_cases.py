"""Run the reference's test cases on either package.

A ``tests/test_torch_*.py`` file that copies the cases of a reference test
file reaches the package under test through a namespace ``C``: its
``IMPORTS`` table names, for each module below the package (``""`` is the
package itself), the names the reference file imports from ``repro``. The
module-scoped fixture that :func:`bind` makes fills ``C`` from ``repro`` or
from ``repro_torch`` in turn, so each case runs once on either package
(``[repro]``, ``[repro_torch]``); a parity case that names both packages
itself overrides it with ``@both``. ``C.random_workflow`` is
``strategies.random_workflow`` rebuilt as the package's own ``Workflow``
(:func:`port_workflow`), and ``C.workflow`` does the same to any
reference workflow.
"""

from __future__ import annotations

import dataclasses
import importlib

import pytest
import strategies

PACKAGES = ("repro", "repro_torch")

both = pytest.mark.parametrize("package", ["both"])


def port_workflow(wf):
    """A reference ``Workflow`` rebuilt as the port's, each ``FunctionSpec``
    field by field."""
    from repro_torch.core import dag
    return dag.Workflow(
        wf.name,
        [dag.FunctionSpec(**{f.name: getattr(spec, f.name)
                             for f in dataclasses.fields(spec)})
         for spec in wf.functions.values()],
        external_inputs=dict(wf.external_inputs))


def names(package: str, imports: dict) -> dict:
    """``imports`` ({module: [name or [name, alias]]}) read from
    ``package``, plus ``workflow`` and ``random_workflow``."""
    out = {}
    for mod, wanted in imports.items():
        m = importlib.import_module(f"{package}.{mod}" if mod else package)
        for n in wanted:
            name, alias = (n, n) if isinstance(n, str) else n
            out[alias] = getattr(m, name)
    workflow = port_workflow if package == "repro_torch" else (lambda w: w)
    out["workflow"] = workflow
    out["random_workflow"] = (
        lambda *a, **kw: workflow(strategies.random_workflow(*a, **kw)))
    return out


def module_pair(name: str):
    """``repro.<name>`` and ``repro_torch.<name>``."""
    return tuple(importlib.import_module(f"{p}.{name}") for p in PACKAGES)


def bound_elsewhere(package: str, ns) -> list:
    """The names of ``ns`` whose class or function was defined outside
    ``package`` (``workflow`` and ``random_workflow`` are this module's)."""
    return sorted(
        k for k, v in vars(ns).items()
        if k not in ("workflow", "random_workflow")
        and isinstance(getattr(v, "__module__", None), str)
        and not v.__module__.startswith(f"{package}."))


def bind(ns, imports: dict):
    """The autouse fixture ``package`` of a test module: ``ns`` filled with
    ``imports`` from each package in turn."""
    @pytest.fixture(scope="module", params=PACKAGES, autouse=True)
    def package(request):
        ns.__dict__.update(names(request.param, imports))
        yield request.param
        ns.__dict__.clear()
    return package
