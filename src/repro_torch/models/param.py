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

__all__ = ["ArrayDecl", "init_params", "shard_params", "params_from_numpy",
           "normal_init", "ones_init", "zeros_init", "tree_map",
           "tree_map_with_path", "tree_items", "tree_at", "unstack_layers",
           "param_count"]

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


def _normal_pieces(shape: tuple[int, ...], gen, std: float):
    """The N(0, std^2) draws of a ``shape`` leaf, in the order they are
    made: (index, fp32 piece) pairs, ``index`` the piece's place in the
    leaf (leading ints, then a slice of the next axis). Slices of the
    leading axis hold at most ``_SLICE_ELEMENTS`` elements; rows larger than
    that are drawn row by row along their own leading axis. No piece is
    kept here once it is handed out, so a caller that drops each piece
    before it asks for the next holds one at a time."""
    row = math.prod(shape[1:]) if len(shape) > 1 else 1
    if row > _SLICE_ELEMENTS:
        for i in range(shape[0]):
            for index, piece in _normal_pieces(shape[1:], gen, std):
                item = ((i,) + index, piece)
                del piece
                yield item
                del item
        return
    rows = max(1, _SLICE_ELEMENTS // row)
    for i in range(0, shape[0], rows):
        n = min(rows, shape[0] - i)
        # scaled in place: the fp32 slice is the largest tensor made here
        yield (slice(i, i + n),), torch.randn(
            (n,) + tuple(shape[1:]), generator=gen,
            device=gen.device).mul_(std)


def _keep(out: torch.Tensor, region: tuple[slice, ...], index: tuple,
          piece: torch.Tensor) -> None:
    """The part of ``piece`` (at ``index`` of a leaf) inside ``region``,
    copied into ``out``, which holds that region of the leaf."""
    k = len(index) - 1               # k leading ints, then a slice of axis k
    if not all(region[i].start <= index[i] < region[i].stop
               for i in range(k)):
        return
    part, r = index[k], region[k]
    lo, hi = max(r.start, part.start), min(r.stop, part.stop)
    if lo >= hi:
        return
    dst = tuple(index[i] - region[i].start for i in range(k)) \
        + (slice(lo - r.start, hi - r.start),)
    src = (slice(lo - part.start, hi - part.start),) + tuple(region[k + 1:])
    out[dst] = piece[src]


def _fill_normal(out: torch.Tensor, gen, std: float,
                 shape: tuple[int, ...] | None = None,
                 region: tuple[slice, ...] | None = None) -> None:
    """``out`` filled with N(0, std^2) draws made in slices
    (:func:`_normal_pieces`), one slice alive at a time. With ``region``,
    ``out`` is that region of a ``shape`` leaf: the whole leaf is drawn
    piece by piece, as for an unsharded ``out``, so the generator moves on
    alike, and each piece's part in the region is kept."""
    if region is None:
        for index, piece in _normal_pieces(tuple(out.shape), gen, std):
            out[index] = piece
            del piece            # before the next slice is drawn
        return
    for index, piece in _normal_pieces(tuple(shape), gen, std):
        _keep(out, region, index, piece)
        del piece


def _normal(gen, shape, dtype, std: float) -> torch.Tensor:
    """N(0, std^2) in ``dtype`` on ``gen``'s device; the same draw for the
    same generator state."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    _fill_normal(out, gen, std)
    return out


def _region_shape(region: tuple[slice, ...]) -> tuple[int, ...]:
    return tuple(r.stop - r.start for r in region)


def _normal_of(std_of: Callable[[tuple[int, ...]], float]) -> Initializer:
    """A normal initializer whose std comes from the leaf's shape. Its
    ``region`` attribute makes one region of the leaf: the same values as
    that region of the whole leaf drawn from the same generator state, with
    no more than one drawn slice held beside it (``init_params`` with
    ``specs``)."""
    def init(gen, shape, dtype):
        return _normal(gen, shape, dtype, std_of(shape))

    def region(gen, shape, dtype, region):
        out = torch.empty(_region_shape(region), dtype=dtype,
                          device=gen.device)
        _fill_normal(out, gen, std_of(shape), shape, region)
        return out
    init.region = region
    return init


def _fan_in_init(fan_axis: int = -2) -> Initializer:
    return _normal_of(lambda shape: 1.0 / math.sqrt(max(
        shape[fan_axis] if len(shape) >= 2 else shape[-1], 1)))


def zeros_init(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def ones_init(gen, shape, dtype):
    return torch.ones(shape, dtype=dtype, device=gen.device)


zeros_init.region = lambda gen, shape, dtype, region: zeros_init(
    gen, _region_shape(region), dtype)
ones_init.region = lambda gen, shape, dtype, region: ones_init(
    gen, _region_shape(region), dtype)


def normal_init(stddev: float = 0.02) -> Initializer:
    return _normal_of(lambda shape: stddev)


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


def unstack_layers(stacked, n: int) -> list:
    """The ``n`` per-layer trees of a tree whose leaves stack the layers on
    their leading axis. One unbind per leaf: under grad its gradient is one
    stack, where a slice per layer would add a full-size zero-padded
    gradient each."""
    unbound = tree_map(lambda a: a.unbind(0), stacked)
    return [tree_map(lambda a: a[i], unbound) for i in range(n)]


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


def tree_at(tree, path: tuple):
    """The subtree of ``tree`` at ``path`` (dict keys and field names, as
    ``tree_items`` gives them)."""
    for key in path:
        tree = tree[key] if isinstance(tree, dict) else getattr(tree, key)
    return tree


def init_params(decls, generator: torch.Generator,
                device: str | torch.device, *, specs=None, mesh=None):
    """Materialise a tree of ArrayDecl. Draws on ``generator``'s device (a
    CUDA generator fills a card-sized model in place) and moves the result
    to ``device``.

    With ``specs`` (a tree of PartitionSpec matching ``decls``, from
    ``sharding.rules.spec_tree``) and ``mesh``, each leaf is only this
    rank's shard (``sharding.rules.local_slices``), holding exactly the
    values of that shard of the unsharded call's leaf: every leaf is drawn
    whole, slice by slice, in the same order, and each slice's part in the
    shard is kept (a stacked expert leaf (L, E, M, F) cut on its experts
    axis, a Mamba leaf on ``ssm_inner`` or ``ssm_heads``, as any other). An
    initializer without a ``region`` attribute draws its whole leaf and
    keeps the shard."""
    from ..sharding.rules import local_slices

    def make(path: tuple, d: ArrayDecl) -> torch.Tensor:
        init = d.initializer()
        if specs is None:
            return init(generator, d.shape, d.dtype).to(device)
        region = local_slices(tree_at(specs, path), d.shape, mesh)
        if hasattr(init, "region"):
            return init.region(generator, d.shape, d.dtype, region).to(device)
        return init(generator, d.shape, d.dtype)[region].clone().to(device)
    # materialise leaves in sorted-key order so one seed gives one model
    made = {id(d): make(path, d) for path, d in tree_items(decls)}
    return tree_map(lambda d: made[id(d)], decls)


def shard_params(params, specs, mesh):
    """This rank's shards of a full parameter tree: each leaf cut to
    ``sharding.rules.local_slices`` of its spec (a copy, contiguous)."""
    from ..sharding.rules import local_slices
    return tree_map_with_path(
        lambda path, a: a[local_slices(tree_at(specs, path), tuple(a.shape),
                                       mesh)].clone(
            memory_format=torch.contiguous_format), params)


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
