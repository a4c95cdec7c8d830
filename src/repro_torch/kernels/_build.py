"""Build the port's CUDA sources and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` compiles, with ``nvcc`` alone, into a
shared library with a plain C interface, ``build/repro_torch/<name>-<hash>.so``
at the repository root (``.gitignore`` lists ``build/``). The hash covers the
source, every header in ``csrc/`` (``*.cuh``, which the sources include)
and the flags, so an edited source or header builds anew and an unchanged
one is loaded as it is. Sources build at first use, one ``nvcc`` process per
source, all started together. Nothing here runs at import time.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrapper raises on a nonzero code (:func:`check`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "library", "check"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile the named sources (all of ``csrc/`` by default) whose library
    is missing, in parallel. Returns, per source compiled, its wall seconds
    and ``nvcc``'s report (registers and spills from ``-Xptxas -v``)."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": out}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(name))   # atomic: readers never see a
                                             # half-written library
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _target(name)
        if not path.exists():
            build([name])
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def check(code: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` code from a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
