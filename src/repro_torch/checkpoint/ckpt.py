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

The layout is the reference's topology-agnostic one: every leaf a full
array keyed by its tree path, never by rank. A sharded state (one rank's
shards under ``runtime/train_lib.py::make_train_state_specs``) saves with
``specs`` and ``mesh``: each leaf is gathered from its shards, one leaf at
a time (so that no rank holds the whole state on the device), over the
ranks that cut it (:func:`gather_leaf`), and global rank 0 writes the
files, byte for byte what ``save_state`` writes for the same state held
whole; every rank waits for the rename (ZeRO-1's moments and ZeRO-3's
regions alike: a leaf is gathered over whichever axes its spec names). A
restore with ``specs`` and
``mesh`` cuts each full leaf to the rank's shard (``local_slices``), so a
checkpoint written at one mesh restores at another, or on one device, and
into the JAX package. The directory must be one that every rank reads.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import shutil
import threading

import numpy as np
import torch

from ..models.param import tree_at, tree_items, tree_map_with_path
from ..sharding.rules import local_slices, spec_axes

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


# the integer type that carries a leaf's bits through a sum, by its width:
# 16-bit leaves widened to int32, which every backend sums
_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def gather_leaf(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole of a leaf from this rank's shard ``leaf`` under ``spec``:
    a sum, over the ranks whose coordinates the spec cuts, of a zero
    buffer into which each writes its shard's bits (one all_reduce; each
    element has one nonzero term, so the sum is exact, signed zeros and
    NaNs included). A leaf the spec keeps whole comes back as it is."""
    parts = tuple(spec) + (None,) * (leaf.dim() - len(spec))
    axes = [a for a in mesh.axis_names
            if any(a in spec_axes(p) for p in parts)]
    if not axes:
        return leaf
    shape = tuple(n * math.prod(mesh.shape[a] for a in spec_axes(p))
                  for n, p in zip(leaf.shape, parts))
    bits = leaf.detach().view(_BITS[leaf.element_size()])
    wide = torch.int32 if bits.dtype == torch.int16 else bits.dtype
    full = torch.zeros(shape, dtype=wide, device=leaf.device)
    full[local_slices(spec, shape, mesh)] = bits
    torch.distributed.all_reduce(full, group=mesh.group(tuple(axes)))
    return full.to(bits.dtype).view(leaf.dtype)


def _writer() -> bool:
    """The rank that writes a sharded save: global rank 0."""
    return torch.distributed.get_rank() == 0


def _barrier(device) -> None:
    """Every rank of the process group waits for every other (an
    all_reduce of one element on ``device``, which either backend
    takes)."""
    torch.distributed.all_reduce(torch.zeros(1, device=device))


def _sharded_snapshot(state, specs, mesh) -> dict:
    """Each leaf of this rank's shards gathered whole (:func:`gather_leaf`,
    one leaf at a time); the writer keeps a host copy of each, the other
    ranks nothing."""
    out, writer = {}, _writer()
    for path, leaf in tree_items(state):
        full = gather_leaf(leaf, tree_at(specs, path), mesh)
        if writer:
            out[_SEP.join(path)] = _host(full)
        del full
    return out


def _device_of(state):
    return tree_items(state)[0][1].device


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
               extra: dict | None = None, *, specs=None,
               mesh=None) -> pathlib.Path:
    """Synchronous atomic save; returns the final directory. With
    ``specs`` (the state's PartitionSpec tree) and ``mesh`` (a live mesh),
    ``state`` is this rank's shards: every rank calls it, the leaves are
    gathered whole and global rank 0 writes them; every rank returns once
    the directory is renamed."""
    if mesh is None:
        return _write(directory, step, _snapshot(state), extra)
    snapshot = _sharded_snapshot(state, specs, mesh)
    final = pathlib.Path(directory) / f"step_{step:08d}"
    if _writer():
        _write(directory, step, snapshot, extra)
    _barrier(_device_of(state))
    return final


def latest_step(directory: str | pathlib.Path) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(m.group(1)) for p in directory.iterdir()
             if (m := re.match(r"step_(\d+)$", p.name))]
    return max(steps) if steps else None


def restore_state(directory: str | pathlib.Path, step: int, like, *,
                  specs=None, mesh=None):
    """Restore into the structure of ``like``: each leaf on the device and
    in the dtype of ``like``'s leaf at the same path. With ``specs`` and
    ``mesh``, ``like`` is this rank's shards: each full leaf on disk is cut
    to the rank's slice under its spec (read through a memory map), so
    the checkpoint may come from any mesh, or from one device."""
    directory = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((directory / "manifest.json").read_text())

    def load(path, leaf):
        key = _SEP.join(path)
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(directory / f"{key}.npy",
                      mmap_mode=None if mesh is None else "r")
        if mesh is not None:
            arr = np.array(arr[local_slices(tree_at(specs, path), arr.shape,
                                            mesh)])
        if tuple(arr.shape) != tuple(leaf.shape):
            where = "this rank's slice" if mesh is not None else "on disk"
            raise ValueError(f"{key}: {tuple(arr.shape)} ({where}), "
                             f"{tuple(leaf.shape)} in the state")
        if "bfloat16" in manifest["leaves"][key]["dtype"] \
                and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return tree_map_with_path(load, like)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async saves.

    With ``specs`` and ``mesh`` it saves and restores a sharded state, as
    :func:`save_state` and :func:`restore_state` do: every rank calls each
    method; a save gathers the leaves synchronously (the writer keeping
    them on the host, before the next step updates the shards in place),
    global rank 0 writes them, on a thread when async, and :meth:`wait`
    returns on every rank once that write is renamed."""

    def __init__(self, directory: str | pathlib.Path, keep: int = 3,
                 async_save: bool = True, *, specs=None, mesh=None):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.async_save = async_save
        self.specs, self.mesh = specs, mesh
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        self._unsynced = None    # a sharded save's device, until wait()

    def save(self, step: int, state, extra: dict | None = None) -> None:
        if self.mesh is not None:
            self._save_sharded(step, state, extra)
            return
        snapshot = _snapshot(state)
        if not self.async_save:
            self._write(step, snapshot, extra)
            return
        self.wait()
        self._start(step, snapshot, extra)

    def _save_sharded(self, step: int, state, extra) -> None:
        self.wait()
        snapshot = _sharded_snapshot(state, self.specs, self.mesh)
        self._unsynced = _device_of(state)
        if _writer():
            if self.async_save:
                self._start(step, snapshot, extra)
            else:
                self._write(step, snapshot, extra)
        if not self.async_save:
            self.wait()

    def _start(self, step, snapshot, extra) -> None:
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
        """Join the pending save (over a mesh, on every rank: once the
        writer's is renamed); raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._unsynced is not None:
            device, self._unsynced = self._unsynced, None
            _barrier(device)
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
        return restore_state(self.directory, step, like, specs=self.specs,
                             mesh=self.mesh), step
