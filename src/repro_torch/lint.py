"""DCheck lint CLI — ``python -m repro_torch.lint``.

Lints workflow.yaml documents and/or the built-in benchmark workloads
against the DF-code registry in :mod:`repro_torch.core.lint`.

Usage::

    python -m repro_torch.lint examples/workflows/wordcount.yaml
    python -m repro_torch.lint --builtin all            # every BENCHMARKS entry
    python -m repro_torch.lint --builtin WC --builtin Gen file.yaml --strict
    python -m repro_torch.lint --list-codes

Exit status is 1 when any error-severity diagnostic fires (``--strict``
also fails on warnings), so the command gates CI directly.

Copy of ``repro/lint.py`` for the PyTorch port, which imports nothing of
``repro``; its code is the reference's, line for line. One departure: every
name of the package it reaches, and the program name its usage prints, is
``repro_torch``'s where the reference's is ``repro``'s, so its output for
the same arguments is the reference's.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.lint import CODES, Diagnostic, lint, max_severity

__all__ = ["main"]


def _lint_builtin(name: str, require_fns: bool) -> list[Diagnostic]:
    from repro_torch.core.workloads import BENCHMARKS

    wf = BENCHMARKS[name]()
    return lint(wf, require_fns=require_fns)


def _lint_file(path: str, require_fns: bool) -> list[Diagnostic]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint(fh.read(), require_fns=require_fns)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="DCheck workflow linter (stable DF diagnostic codes)")
    ap.add_argument("paths", nargs="*", help="workflow.yaml files to lint")
    ap.add_argument("--builtin", action="append", default=[],
                    metavar="NAME",
                    help="lint a built-in workload (repeatable; 'all' "
                    "lints every BENCHMARKS entry)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on warning-severity diagnostics")
    ap.add_argument("--require-fns", action="store_true",
                    help="treat missing fn bindings as errors (intended "
                    "engine run)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-codes", action="store_true",
                    help="print the diagnostic code table and exit")
    args = ap.parse_args(argv)

    if args.list_codes:
        for code, (severity, title) in sorted(CODES.items()):
            print(f"{code}  {severity:8s}  {title}")
        return 0

    targets: list[tuple[str, list[Diagnostic]]] = []
    builtins = args.builtin
    if "all" in builtins:
        from repro_torch.core.workloads import BENCHMARKS

        builtins = sorted(BENCHMARKS)
    for name in builtins:
        targets.append((f"builtin:{name}",
                        _lint_builtin(name, args.require_fns)))
    for path in args.paths:
        targets.append((path, _lint_file(path, args.require_fns)))
    if not targets:
        ap.error("nothing to lint: pass paths and/or --builtin")

    fail_at = ("error",) if not args.strict else ("error", "warning")
    failed = 0
    if args.format == "json":
        doc = [{"target": t, "diagnostics": [vars(d) for d in diags]}
               for t, diags in targets]
        json.dump(doc, sys.stdout, indent=2)
        print()
    for target, diags in targets:
        if args.format == "text":
            verdict = max_severity(diags) or "clean"
            print(f"{target}: {verdict} "
                  f"({len(diags)} diagnostic(s))")
            for d in diags:
                print(f"  {d.format()}")
        if any(d.severity in fail_at for d in diags):
            failed += 1
    if args.format == "text":
        print(f"# linted {len(targets)} workflow(s), {failed} failed "
              f"(fail on: {', '.join(fail_at)})")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
