"""Meshes of the port: port of ``repro/launch/mesh.py``.

A :class:`Mesh` names its axes and their sizes, which is all the spec
functions (``sharding/rules.py``, ``runtime/serve_lib.py::cache_specs``)
read, so they run on a mesh with no processes behind it: the role
``jax.sharding.AbstractMesh`` plays for the JAX package. A mesh built over
a process group that is up (:func:`make_local_mesh`) also carries the
``torch.distributed`` ``DeviceMesh``, this rank's coordinates and one
process group per axis.

The backend is the caller's: ``torch.distributed.init_process_group`` runs
before :func:`make_local_mesh`, with NCCL where every rank has a card of its
own, or gloo where ranks share one (NCCL refuses two ranks on one device).
Nothing here switches backend, and importing this module starts nothing.
"""

from __future__ import annotations

import math
from typing import Any

__all__ = ["Mesh", "abstract_mesh", "make_production_mesh",
           "make_local_mesh"]


class Mesh:
    """Named axes and their sizes; with a process group, also this rank's
    place on them.

    ``shape`` maps axis name -> size in axis order, as a JAX mesh's does.
    ``coords`` maps axis name -> this rank's index (0 on every axis of an
    abstract mesh); ``groups`` maps axis name -> the process group of the
    ranks that differ from this one on that axis alone (empty when
    abstract); ``device_mesh`` is the ``DeviceMesh`` (None when abstract).
    """

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 *, device_mesh: Any = None,
                 coords: dict[str, int] | None = None,
                 groups: dict[str, Any] | None = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device_mesh = device_mesh
        self.coords = dict(coords) if coords else dict.fromkeys(
            self.axis_names, 0)
        self.groups = dict(groups or {})

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def is_live(self) -> bool:
        """True when a process group stands behind the mesh."""
        return self.device_mesh is not None

    def group(self, axis):
        """The process group of ``axis``; of a tuple of axes, one axis's,
        or the whole group where they are every axis of the mesh."""
        if isinstance(axis, tuple):
            if len(axis) == 1:
                axis = axis[0]
            elif self.is_live and sorted(axis) == sorted(self.axis_names):
                import torch.distributed as dist
                return dist.group.WORLD
        if axis not in self.groups:
            raise ValueError(f"no process group for axis {axis!r} on "
                             f"{'a live' if self.is_live else 'an abstract'}"
                             f" mesh {self}")
        return self.groups[axis]

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}{', live' if self.is_live else ''})"


def abstract_mesh(shape: tuple[int, ...],
                  axis_names: tuple[str, ...] = ("data", "model")) -> Mesh:
    """A mesh of these sizes with no processes behind it."""
    return Mesh(shape, axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's 16x16 single pod (256 devices) or 2x16x16 two pods
    (512 devices), abstract: for the spec functions and their tests."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device_type: str | None = None) -> Mesh:
    """A (data, model) mesh over the process group that is up.

    Rank r sits at (r // model, r % model). ``device_type`` is the
    ``DeviceMesh``'s: by default "cuda" under NCCL and "cpu" under gloo
    (whose groups take CUDA tensors all the same; ranks that share a card
    have set their device already). Raises ``RuntimeError`` when no process
    group is up and ``ValueError`` when the world size is not ``data *
    model``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh: no process group is up; call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"make_local_mesh({data}, {model}) needs "
                         f"{data * model} ranks; the group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    names = ("data", "model")
    dm = init_device_mesh(device_type, (data, model), mesh_dim_names=names)
    coords = dict(zip(names, dm.get_coordinate()))
    groups = {name: dm.get_group(name) for name in names}
    return Mesh((data, model), names, device_mesh=dm, coords=coords,
                groups=groups)
