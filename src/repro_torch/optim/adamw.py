"""AdamW with global-norm clipping and a warmup-cosine schedule.

Port of ``repro/optim/adamw.py``: stateless functions over explicit trees
(nested dicts of tensors), fp32 moments by default, bias correction, no
weight decay on norms / biases / 1-d scales, parameters updated in fp32 and
cast back to their dtype (no fp32 master copy, as in the reference).

Two differences, both for memory on the card:

* ``adamw_update`` writes the new parameters and moments into the tensors it
  is given and returns them (the reference's train step donates its state,
  so XLA updates in place too); a leaf is updated in row slices of at most
  ``SLICE_ELEMENTS`` elements (:func:`_pieces`), so its fp32 temporaries
  take at most ~7 x 256 MB whatever the leaf's size (an embedding of 1.25 B
  elements would take 7 x 5 GB whole), bit for bit the whole-leaf update:
  every op is elementwise;
* the step count is a 0-d int32 tensor on the parameters' device, so the
  schedule and the bias correction never wait for the host.

On a (data, model) mesh (``runtime/train_lib.py``'s sharded step),
:func:`adamw_update_sharded` runs the same arithmetic on this rank's
shards, with the global norm taken over the mesh (:func:`sharded_norm`)
and, under ZeRO-1, each rank updating the slice of each parameter that its
moment shard covers before the slices are gathered over the batch axes
(:func:`gather_updated`). Gradient compression (``optim/compress.py``)
comes later (ROADMAP A.12).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..models.param import tree_items, tree_map

__all__ = ["AdamWConfig", "OptState", "ShardPlan", "adamw_init",
           "adamw_update", "adamw_update_sharded", "clip_by_global_norm",
           "gather_updated", "global_norm", "sharded_norm", "warmup_cosine"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    state_dtype: torch.dtype = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor        # () int32, on the parameters' device
    m: Any
    v: Any


def warmup_cosine(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% of peak (fp32)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    total = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / total, 0.0, 1.0)
    cos = 0.1 + 0.9 * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (each leaf's norm
    is taken in fp32 without an fp32 copy of the leaf)."""
    return torch.sqrt(sum(torch.square(torch.linalg.vector_norm(
        g, dtype=torch.float32)) for g in leaves))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in fp32; the
    global norm before clipping)."""
    gn = global_norm(leaf for _, leaf in tree_items(grads))
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def adamw_init(params, cfg: AdamWConfig) -> OptState:
    leaves = [leaf for _, leaf in tree_items(params)]
    device = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _no_decay(path: tuple) -> bool:
    """No weight decay on norms / biases / 1-d scales (the reference's
    substring rule on the last path key)."""
    last = str(path[-1]) if path else ""
    return any(k in last for k in ("norm", "ln", "bias", "dt_bias",
                                   "A_log", "D"))


# the elements of one slice of a leaf's update: its fp32 temporaries take
# 256 MB each
SLICE_ELEMENTS = 1 << 26


def _pieces(shape: tuple, limit: int | None = None):
    """Index tuples that cover a tensor of ``shape`` in row slices of at
    most ``limit`` elements (``SLICE_ELEMENTS`` by default): slices of the
    leading dim whole rows at a time, or, where one row holds more, each
    row cut along the next dim the same way. Each index gives a view."""
    limit = limit or SLICE_ELEMENTS
    if len(shape) == 0 or math.prod(shape) <= limit:
        yield ()
        return
    row = math.prod(shape[1:])
    if row <= limit:
        step = limit // row
        for i in range(0, shape[0], step):
            yield (slice(i, min(i + step, shape[0])),)
        return
    for i in range(shape[0]):
        for rest in _pieces(shape[1:], limit):
            yield (i,) + rest


def _update(params, grads, state: OptState, cfg: AdamWConfig,
            gn: torch.Tensor, regions=None):
    """The AdamW arithmetic on each leaf (or, with ``regions``, on the
    region of each parameter that its moments cover; None: the whole
    leaf), in place, scaled by the clip of global norm ``gn``, a row slice
    at a time (:func:`_pieces`)."""
    p_items = tree_items(params)
    g_leaves = [g for _, g in tree_items(grads)]
    m_leaves = [m for _, m in tree_items(state.m)]
    v_leaves = [v for _, v in tree_items(state.v)]
    regions = regions or [None] * len(p_items)
    scale = _clip_scale(gn, cfg.clip_norm)
    step = state.step + 1
    lr = warmup_cosine(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    with torch.no_grad():
        for (path, p), g, m, v, region in zip(p_items, g_leaves, m_leaves,
                                              v_leaves, regions):
            if region is not None:
                p, g = p[region], g[region]
            decay = cfg.weight_decay and not _no_decay(path)
            for piece in _pieces(tuple(p.shape)):
                _update_slice(p[piece], g[piece], m[piece], v[piece], scale,
                              lr, c1, c2, cfg, decay)
    return OptState(step=step, m=state.m, v=state.v), lr


def _update_slice(p, g, m, v, scale, lr, c1, c2, cfg: AdamWConfig,
                  decay: bool) -> None:
    """The AdamW arithmetic on one slice of a leaf, op for op as the
    reference, each op rounded to fp32; written into the views."""
    b1, b2 = cfg.beta1, cfg.beta2
    g32 = g.float() * scale
    m32 = m.float() * b1 + g32 * (1 - b1)
    v32 = v.float() * b2 + torch.square(g32) * (1 - b2)
    upd = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
    if decay:
        upd = upd + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * upd)
    m.copy_(m32)
    v.copy_(v32)


def adamw_update(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW step, written into ``params`` and the moments of ``state``
    in place; returns (params, new state, metrics) with the same tensors."""
    gn = global_norm(g for _, g in tree_items(grads))
    state, lr = _update(params, grads, state, cfg, gn)
    return params, state, {"grad_norm": gn, "lr": lr}


class ShardPlan(NamedTuple):
    """How a rank's shards enter the sharded update, leaf by leaf in
    ``tree_items`` order: ``cuts``, the mesh axes that cut the shard the
    rank holds (the model axis, under ZeRO-3 the data axes too: its
    squares are summed over them for the global norm; a replicated leaf's,
    ``()``, are counted once); ``regions``, the slices of the parameter
    shard that the moment shard covers (ZeRO-1: cut over the batch axes),
    None where it covers the whole shard. ``mesh`` is the rank's;
    ``model_group`` and ``batch_group`` are the process groups of the
    model axis and of the axes that cut the batch (None: not cut)."""
    cuts: tuple
    regions: tuple
    mesh: Any
    model_group: Any
    batch_group: Any


def sharded_norm(leaves, cuts, mesh) -> torch.Tensor:
    """The global norm of gradient shards, each element counted once over
    the mesh: the squares of the leaves cut over the same axes (``cuts``,
    a tuple of axis names a leaf) summed, each such sum summed over the
    ranks that hold its parts, and the replicated leaves' squares counted
    once. One all_reduce, where any leaf is cut: over the axes that cut
    some leaf, each class's sum entered by the ranks at coordinate 0 of
    those axes that do not cut it (zeros elsewhere), so that no class is
    counted twice; where the model axis alone cuts, over its group, each
    rank's sum entered."""
    sums: dict = {}
    for g, axes in zip(leaves, cuts):
        sq = torch.square(torch.linalg.vector_norm(g, dtype=torch.float32))
        sums[axes] = sums[axes] + sq if axes in sums else sq
    total = sums.pop((), 0.0)
    if sums:
        classes = sorted(sums)
        over = tuple(a for a in mesh.axis_names
                     if any(a in axes for axes in classes))
        parts = torch.stack([
            sums[axes] if all(mesh.coords[a] == 0 for a in over
                              if a not in axes)
            else torch.zeros_like(sums[axes]) for axes in classes])
        torch.distributed.all_reduce(parts, group=mesh.group(over))
        for k in range(len(classes)):
            total = total + parts[k]
    return torch.sqrt(torch.as_tensor(total))


def gather_updated(parts, group) -> None:
    """ZeRO-1's gather: ``parts`` are (parameter shard, the region this
    rank updated); every rank's regions come back into every shard, in one
    all_reduce a dtype of a zero-filled buffer into which each rank writes
    its own region (exact: one nonzero term an element)."""
    by_dtype: dict = {}
    for p, region in parts:
        by_dtype.setdefault(p.dtype, []).append((p, region))
    for dtype, items in by_dtype.items():
        flat = torch.zeros(sum(p.numel() for p, _ in items), dtype=dtype,
                           device=items[0][0].device)
        views, offset = [], 0
        for p, region in items:
            view = flat[offset:offset + p.numel()].view(p.shape)
            view[region] = p[region]
            views.append(view)
            offset += p.numel()
        torch.distributed.all_reduce(flat, group=group)
        for (p, _), view in zip(items, views):
            p.copy_(view)


def adamw_update_sharded(params, grads, state: OptState, cfg: AdamWConfig,
                         plan: ShardPlan):
    """One AdamW step on this rank's shards: ``grads`` are the whole
    gradient of each parameter shard (already summed over the batch
    axes); ``state``'s moments are shards of ``plan.regions``. The global
    norm is :func:`sharded_norm`'s; each rank updates its regions, op for
    op as :func:`adamw_update`, and the updated regions are gathered over
    the batch axes (:func:`gather_updated`); a leaf whose moments cover
    its whole shard (every leaf under ZeRO-3, whose parameters are the
    moments' regions) is updated in place and not gathered.
    Returns (params, new state, metrics), written in place."""
    g_leaves = [g for _, g in tree_items(grads)]
    gn = sharded_norm(g_leaves, plan.cuts, plan.mesh)
    state, lr = _update(params, grads, state, cfg, gn, plan.regions)
    parts = [(p, region) for (_, p), region in zip(tree_items(params),
                                                    plan.regions)
             if region is not None]
    if parts:
        with torch.no_grad():
            gather_updated(parts, plan.batch_group)
    return params, state, {"grad_norm": gn, "lr": lr}
