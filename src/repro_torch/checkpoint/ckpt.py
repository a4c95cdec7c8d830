"""Checkpoint save/restore (+ async saves), in the JAX package's layout.

Port of ``repro/checkpoint/ckpt.py``, on disk byte for byte the same, so a
checkpoint written by either package restores into the other: one
``step_XXXXXXXX/`` directory per step, one ``.npy`` per leaf named by its
``__``-joined tree path (dict keys by key, NamedTuple fields by name:
``params__layers__attn__wq``, ``opt__step``, ``opt__m__embed``), bf16 stored
as its raw ``uint16`` bits with ``"bfloat16"`` in ``manifest.json``.

A save writes under ``.tmp_step_*`` and renames the directory when it is
complete, so a crash leaves either the previous checkpoint or the new one.
The async manager copies every leaf to host memory synchronously (the train
step updates the tensors in place right after) and writes the files on a
thread.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading

import numpy as np
import torch

from ..models.param import tree_items, tree_map_with_path

__all__ = ["save_state", "restore_state", "latest_step",
           "CheckpointManager"]

_SEP = "__"


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf (bf16 as its uint16 bits) and its dtype."""
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _snapshot(state) -> dict[str, tuple[np.ndarray, str]]:
    return {_SEP.join(path): _host(leaf) for path, leaf in tree_items(state)}


def _write(directory, step: int, snapshot, extra) -> pathlib.Path:
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for key, (arr, dtype) in snapshot.items():
        np.save(tmp / f"{key}.npy", arr)
        manifest["leaves"][key] = {"dtype": dtype, "shape": list(arr.shape)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def save_state(directory: str | pathlib.Path, step: int, state,
               extra: dict | None = None) -> pathlib.Path:
    """Synchronous atomic save; returns the final directory."""
    return _write(directory, step, _snapshot(state), extra)


def latest_step(directory: str | pathlib.Path) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(m.group(1)) for p in directory.iterdir()
             if (m := re.match(r"step_(\d+)$", p.name))]
    return max(steps) if steps else None


def restore_state(directory: str | pathlib.Path, step: int, like):
    """Restore into the structure of ``like``: each leaf on the device and
    in the dtype of ``like``'s leaf at the same path."""
    directory = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((directory / "manifest.json").read_text())

    def load(path, leaf):
        key = _SEP.join(path)
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(directory / f"{key}.npy")
        if "bfloat16" in manifest["leaves"][key]["dtype"] \
                and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return tree_map_with_path(load, like)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async saves."""

    def __init__(self, directory: str | pathlib.Path, keep: int = 3,
                 async_save: bool = True):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        self._lock = threading.Lock()

    def save(self, step: int, state, extra: dict | None = None) -> None:
        snapshot = _snapshot(state)
        if not self.async_save:
            self._write(step, snapshot, extra)
            return
        self.wait()
        self._pending = threading.Thread(
            target=self._write_async, args=(step, snapshot, extra),
            daemon=True)
        self._pending.start()

    def _write(self, step, snapshot, extra):
        with self._lock:
            _write(self.directory, step, snapshot, extra)
            self._gc()

    def _write_async(self, step, snapshot, extra):
        try:
            self._write(step, snapshot, extra)
        except Exception as exc:        # re-raised by wait()
            self._error = exc

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for p in self.directory.iterdir()
            if (m := re.match(r"step_(\d+)$", p.name)))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)

    def wait(self):
        """Join the pending save; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def latest(self) -> int | None:
        self.wait()
        return latest_step(self.directory)

    def restore(self, like, step: int | None = None):
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_state(self.directory, step, like), step
