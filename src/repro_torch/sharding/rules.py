"""Logical-axis -> mesh-axis rules: port of ``repro/sharding/rules.py``.

Parameters carry *logical* axis names (``models/param.py``'s ``ArrayDecl``).
This module maps them onto a mesh, exactly as the reference does:

====================  =======================================
logical axis          mesh axes
====================  =======================================
batch                 ("pod", "data")  — whichever exist
heads / kv_heads      "model"   (tensor parallel attention)
mlp / expert_mlp      "model"   (tensor parallel FFN)
experts               "model"   (expert parallel)
vocab                 "model"   (sharded embedding + logits)
ssm_heads             "model"   (Mamba head parallel)
embed / seq / others  replicated (unless zero3/seq-parallel)
====================  =======================================

Every mapping is divisibility-checked against the concrete dim
(:func:`_fits`), with the reference's ``head_dim`` fallback for arrays
with a q-heads axis and its ZeRO-3 pass. The specs are the port's own
:class:`PartitionSpec`, a tuple whose entries equal the reference's entry
for entry.

Where the reference hands a spec to XLA (``NamedSharding``), the port cuts
tensors itself: :func:`local_slices` turns a spec and this rank's
coordinates into the slices of a full-shape tensor that the rank holds, and
:func:`sharding_tree` gives them for a tree of declarations.
"""

from __future__ import annotations

import math
from typing import Mapping

from ..launch.mesh import Mesh
from ..models.param import tree_map
from .context import data_axes, model_axis

__all__ = ["PartitionSpec", "make_rules", "logical_to_spec", "spec_tree",
           "sharding_tree", "batch_spec", "local_slices", "local_shape",
           "spec_axes"]

_MODEL_AXES = ("heads", "kv_heads", "mlp", "expert_mlp", "experts", "vocab",
               "ssm_heads", "ssm_inner")


class PartitionSpec(tuple):
    """One entry per array dim: None (replicated), a mesh axis name, or a
    tuple of axis names (the first the major one). ``tuple(spec)`` equals
    the reference's ``tuple(jax.sharding.PartitionSpec(...))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec


def make_rules(mesh: Mesh, *, zero3: bool = False,
               seq_parallel: bool = False, dp_only: bool = False) -> dict:
    d = data_axes(mesh)
    m = model_axis(mesh)
    if dp_only:
        # small-arch remap: the model axis becomes extra data parallelism;
        # parameters are fully replicated
        rules: dict[str, tuple[str, ...] | None] = {a: None
                                                    for a in _MODEL_AXES}
        rules["heads"] = None
        rules["batch"] = (d + ((m,) if m else ())) or None
        rules["seq"] = None
        rules["_zero3"] = (d + ((m,) if m else ())) if zero3 else None
        return rules
    rules = {a: (m,) if m else None for a in _MODEL_AXES}
    rules["batch"] = d or None
    rules["seq"] = (m,) if (seq_parallel and m) else None
    rules["_zero3"] = d if zero3 else None
    return rules


def _fits(dim: int, axes: tuple[str, ...] | None, mesh: Mesh) -> bool:
    if not axes:
        return False
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return dim % size == 0 and dim >= size


def _names(part) -> set:
    """The mesh axes one spec entry uses."""
    return {part} if isinstance(part, str) else set(part or ())


def logical_to_spec(axes: tuple[str | None, ...], shape: tuple[int, ...],
                    rules: Mapping, mesh: Mesh) -> PartitionSpec:
    """One array's logical axes + shape -> PartitionSpec."""
    parts: list = []
    used: set[str] = set()
    for dim, name in zip(shape, axes):
        target = rules.get(name) if name else None
        if target and not any(t in used for t in target) \
                and _fits(dim, tuple(target), mesh):
            parts.append(tuple(target) if len(target) > 1 else target[0])
            used.update(target)
        else:
            parts.append(None)
    # fallback for arrays with a *q-heads* axis only (wq/wo): if the model
    # axis could not be used, shard head_dim instead; K/V projections stay
    # model-replicated
    m = rules.get("heads")
    if m and "heads" in axes \
            and not any(set(m) & _names(p) for p in parts):
        for i, name in enumerate(axes):
            if name == "head_dim" and parts[i] is None \
                    and _fits(shape[i], tuple(m), mesh):
                parts[i] = tuple(m) if len(m) > 1 else m[0]
                break
    # ZeRO-3: shard the largest still-replicated axis over the data axes
    zaxes = rules.get("_zero3")
    if zaxes and not any(set(zaxes) & _names(p) for p in parts):
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if parts[i] is None and _fits(shape[i], tuple(zaxes), mesh) \
                    and axes[i] != "layers":
                parts[i] = tuple(zaxes) if len(zaxes) > 1 else zaxes[0]
                break
    return P(*parts)


def spec_tree(decls, mesh: Mesh, rules: Mapping):
    """Tree of PartitionSpec matching a tree of ArrayDecl."""
    return tree_map(lambda d: logical_to_spec(d.axes, d.shape, rules, mesh),
                    decls)


def batch_spec(mesh: Mesh, ndim: int = 2) -> PartitionSpec:
    """Inputs (batch, seq, ...): batch over the data axes."""
    d = data_axes(mesh)
    lead = tuple(d) if len(d) > 1 else (d[0] if d else None)
    return P(lead, *([None] * (ndim - 1)))


def spec_axes(part) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def local_slices(spec: PartitionSpec, shape: tuple[int, ...],
                 mesh: Mesh) -> tuple[slice, ...]:
    """The slices of a full ``shape`` tensor that this rank holds under
    ``spec``, from ``mesh.coords``. A dim over several axes is cut in the
    order they are named, the first the major one, as JAX cuts it. Entries
    past the tensor's rank must be None (the reference's per-layer
    ``length`` spec on the port's one scalar)."""
    if any(p is not None for p in tuple(spec)[len(shape):]):
        raise ValueError(f"spec {spec} shards past the {len(shape)} dims "
                         f"of {shape}")
    out = []
    for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = spec_axes(part)
        n = math.prod(mesh.shape[a] for a in axes)
        if dim % n:
            raise ValueError(f"dim {dim} of {shape} does not divide over "
                             f"{axes} ({n})")
        index = 0
        for a in axes:
            index = index * mesh.shape[a] + mesh.coords[a]
        size = dim // n
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def local_shape(spec: PartitionSpec, shape: tuple[int, ...],
                mesh: Mesh) -> tuple[int, ...]:
    return tuple(s.stop - s.start for s in local_slices(spec, shape, mesh))


def sharding_tree(decls, mesh: Mesh, rules: Mapping):
    """Tree of this rank's slices (:func:`local_slices`) matching a tree of
    ArrayDecl: what the reference's ``NamedSharding`` tree tells XLA."""
    return tree_map(lambda d: local_slices(
        logical_to_spec(d.axes, d.shape, rules, mesh), d.shape, mesh), decls)

