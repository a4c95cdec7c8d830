"""Current-mesh context: port of ``repro/sharding/context.py``.

One process-wide (thread-local) source of truth for the mesh that the
spec functions and the sharded serving steps consult. With no mesh set,
``current_mesh()`` is a 1x1 ("data", "model") mesh, as the reference's.
The mesh is the port's own (``launch/mesh.py``).
"""

from __future__ import annotations

import contextlib
import threading

from ..launch.mesh import Mesh, abstract_mesh

__all__ = ["set_current_mesh", "current_mesh", "mesh_context", "data_axes",
           "model_axis", "axis_size"]

_state = threading.local()


def set_current_mesh(mesh: Mesh | None) -> None:
    _state.mesh = mesh


def current_mesh() -> Mesh:
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        # default: a 1x1 mesh, so a caller with no mesh sees the same axes
        mesh = abstract_mesh((1, 1), ("data", "model"))
        _state.mesh = mesh
    return mesh


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    prev = getattr(_state, "mesh", None)
    set_current_mesh(mesh)
    try:
        yield mesh
    finally:
        set_current_mesh(prev)


def data_axes(mesh: Mesh | None = None) -> tuple[str, ...]:
    """Mesh axes that shard the batch: ('pod', 'data') when present."""
    mesh = mesh or current_mesh()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh: Mesh | None = None) -> str | None:
    mesh = mesh or current_mesh()
    return "model" if "model" in mesh.axis_names else None


def axis_size(name: str, mesh: Mesh | None = None) -> int:
    mesh = mesh or current_mesh()
    if name not in mesh.axis_names:
        return 1
    return mesh.shape[name]
