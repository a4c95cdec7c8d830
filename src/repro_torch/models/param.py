"""Parameter declarations and their materialisation as torch tensors.

A model declares its parameters as a nested dict of :class:`ArrayDecl`
(shape, dtype, logical axes, initializer), with the same tree paths and
shapes as the JAX package's ``LM.param_decls()``. From that schema:

* ``init_params``       — seeded random tensors with the JAX package's
  distributions (fan-in normal, ``normal_init(0.02)``, ones); the values are
  torch's, not JAX's;
* ``params_from_numpy`` — carries a parameter tree exported from JAX
  (``jax.tree.map(np.asarray, params)``) across, path for path and dtype for
  dtype, so both packages can run on the same weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["ArrayDecl", "init_params", "params_from_numpy", "normal_init",
           "ones_init", "zeros_init", "tree_map", "tree_map_with_path",
           "tree_items", "param_count"]

Initializer = Callable[[torch.Generator, tuple[int, ...], torch.dtype],
                       torch.Tensor]


# A leaf is drawn in slices of its leading axis of at most this many
# elements, each cast straight into the result, so the fp32 temporary stays
# near 4 GiB: one piece for any smaller leaf, one layer at a time for
# qwen3-moe-235b-a22b's (12, 128, 4096, 1536) expert leaves, whose whole
# fp32 draw (38.7 GB each) a card cannot hold beside the leaves already
# made. Where one row of the leading axis is itself larger (kimi-k2-1t-a32b:
# a layer of its (2, 384, 7168, 2048) expert leaves is 5.6 G elements), each
# row is drawn the same way along its own leading axis.
_SLICE_ELEMENTS = 1 << 30


def _fill_normal(out: torch.Tensor, gen, std: float) -> None:
    """``out`` filled with N(0, std^2) draws in slices of its leading axis of
    at most ``_SLICE_ELEMENTS`` elements (rows larger than that, row by row
    along their own leading axis)."""
    row = out[0].numel() if out.dim() > 1 else 1
    if row > _SLICE_ELEMENTS:
        for i in range(out.shape[0]):
            _fill_normal(out[i], gen, std)
        return
    rows = max(1, _SLICE_ELEMENTS // row)
    for i in range(0, out.shape[0], rows):
        # scaled in place: the fp32 slice is the largest tensor made here
        out[i:i + rows] = torch.randn(
            (min(rows, out.shape[0] - i),) + tuple(out.shape[1:]),
            generator=gen, device=gen.device).mul_(std)


def _normal(gen, shape, dtype, std: float) -> torch.Tensor:
    """N(0, std^2) in ``dtype`` on ``gen``'s device; the same draw for the
    same generator state."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    _fill_normal(out, gen, std)
    return out


def _fan_in_init(fan_axis: int = -2) -> Initializer:
    def init(gen, shape, dtype):
        fan_in = shape[fan_axis] if len(shape) >= 2 else shape[-1]
        return _normal(gen, shape, dtype, 1.0 / math.sqrt(max(fan_in, 1)))
    return init


def zeros_init(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def ones_init(gen, shape, dtype):
    return torch.ones(shape, dtype=dtype, device=gen.device)


def normal_init(stddev: float = 0.02) -> Initializer:
    def init(gen, shape, dtype):
        return _normal(gen, shape, dtype, stddev)
    return init


@dataclasses.dataclass(frozen=True)
class ArrayDecl:
    """Declaration of one parameter array."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]          # logical axis names, len == ndim
    dtype: torch.dtype = torch.bfloat16
    init: Initializer | None = None       # default: fan-in normal

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} vs axes {self.axes} rank mismatch")

    def initializer(self) -> Initializer:
        return self.init if self.init is not None else _fan_in_init()

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn: Callable[[tuple, Any], Any], tree,
                       prefix: tuple = ()):
    """Apply ``fn(path, leaf)`` to every leaf of a tree of dicts and
    NamedTuples, keeping its structure. A path holds the dict keys and the
    field names from the root down."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, prefix + (name,))
                            for name, v in zip(tree._fields, tree)))
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf of a tree of dicts and NamedTuples."""
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def tree_items(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in the order ``jax.tree.flatten`` walks the same
    tree: dict keys sorted, NamedTuple fields in order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], prefix + (k,))]
    if _is_namedtuple(tree):
        return [item for name, v in zip(tree._fields, tree)
                for item in tree_items(v, prefix + (name,))]
    return [(prefix, tree)]


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def param_count(decls) -> int:
    return sum(d.size for d in _leaves(decls))


def init_params(decls, generator: torch.Generator,
                device: str | torch.device):
    """Materialise a tree of ArrayDecl. Draws on ``generator``'s device (a
    CUDA generator fills a card-sized model in place) and moves the result
    to ``device``."""
    def make(d: ArrayDecl) -> torch.Tensor:
        return d.initializer()(generator, d.shape, d.dtype).to(device)
    # materialise leaves in sorted-key order so one seed gives one model
    made = {id(d): make(d) for d in _leaves(decls)}
    return tree_map(lambda d: made[id(d)], decls)


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")      # a writable copy (JAX exports read-only)
    # JAX exports bf16 as ml_dtypes.bfloat16, which torch cannot read;
    # the bits go across as uint16 and are reinterpreted, exactly
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device: str | torch.device):
    """Nested dict of numpy arrays -> the same tree of torch tensors on
    ``device``; every path, shape and dtype kept, bf16 bit-exact."""
    return tree_map(lambda a: _from_numpy(np.asarray(a), device), tree)
