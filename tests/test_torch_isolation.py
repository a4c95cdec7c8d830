"""The port stands alone: no module of ``repro_torch``, and neither
``chip_smoke.py`` nor the scripts in ``tools/``, imports JAX or anything of
the JAX package ``repro``."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# `import jax`, `from jax...`, `import repro`, `from repro(.x) import`;
# `repro_torch` itself is allowed
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
    r"|from\s+repro\b(?!_))", re.MULTILINE)


def _sources():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


def test_no_jax_or_repro_import_lines():
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in _sources()
                 for m in FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders
    assert len(_sources()) > 15     # the scan saw the whole package


def test_importing_every_module_loads_no_jax():
    """Import every module of the port in a fresh interpreter; neither jax
    nor any module of repro may end up in sys.modules."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import repro_torch\n"
        "names = ['repro_torch'] + [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import runpy; runpy.run_path(sys.argv[1], run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code,
                           str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
