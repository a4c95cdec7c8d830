"""Train step: microbatched gradient accumulation + AdamW, on one device or
on one rank of a (data, model) mesh.

Port of ``repro/runtime/train_lib.py``. ``train_step(state, batch)`` takes
the loss and its gradient by autograd through ``model.loss_fn`` (the
attention forward and backward run the hand-written CUDA kernels on the
card), accumulates microbatch gradients in fp32, averages loss and gradients
over the microbatches, and applies ``adamw_update``. The step writes the
new parameters and moments into the state's tensors (the reference donates
its state to XLA, which updates it in place as well).

Over a mesh (``build_train_step(..., mesh=)``; every family: dense,
vlm, moe, ssm, the hybrid's super-blocks and the encoder-decoder's two
stacks), each rank holds its shards of the state under
:func:`make_train_state_specs` (AdamW's moments like the parameters, or
with ``zero1`` also cut over the batch axes) and takes its rows of each
global microbatch, as the reference's ``shard_map`` cuts it
(:func:`group_rows`). Its loss and gradients run through ``loss_fn(...,
shard=)``: the serving path's column- and row-parallel layers, expert-
and head-parallel blocks under autograd, whose collectives carry their
gradients (``sharding/layout.py``), and a vocab-parallel cross entropy.
The reference's step is one XLA program over the global batch; here each
rank weights its tokens as the reference's global microbatches weight
them, and an MoE's aux loss is taken over each global microbatch, so that
the sums over the mesh are the reference's loss and gradient. With
``zero3`` a rank holds only its region of each parameter that the
reference's ZeRO-3 pass cuts (its model-axis shard cut again over the data
axes; the moments alike), the model gathers each unit's leaves to their
model-axis shards just before it runs them (forward and remat's
recompute), and the gathers' backward sums their gradients over the data
axes into each rank's region (``sharding/layout.py``). A sharded state's
checkpoints are the reference's topology-agnostic files
(``checkpoint/ckpt.py``), whatever its specs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from ..models.param import (init_params, tree_at, tree_items, tree_map,
                            tree_map_with_path)
from ..optim.adamw import (AdamWConfig, OptState, ShardPlan, adamw_init,
                           adamw_update, adamw_update_sharded)
from ..sharding.context import data_axes, mesh_context
from ..sharding.rules import (PartitionSpec as P, local_shape, local_slices,
                              make_rules, spec_axes, spec_tree)

__all__ = ["TrainState", "abstract_train_state", "batch_sharding",
           "build_train_step", "group_rows", "init_train_state",
           "make_train_state_specs", "shard_plan", "split_microbatches"]


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def make_train_state_specs(model, mesh, *, zero1: bool = False,
                           zero3: bool = False) -> TrainState:
    """PartitionSpec trees for TrainState: the parameters under
    ``make_rules(mesh, zero3=, dp_only=cfg.dp_only)``; the moments like
    them or, with ``zero1``, under the ZeRO-3 rules (also cut over the
    batch axes); the step count P()."""
    decls = model.param_decls()
    dp_only = getattr(model.cfg, "dp_only", False)
    pspecs = spec_tree(decls, mesh, make_rules(mesh, zero3=zero3,
                                               dp_only=dp_only))
    mspecs = spec_tree(decls, mesh, make_rules(mesh, zero3=True,
                                               dp_only=dp_only)) \
        if zero1 else pspecs
    return TrainState(params=pspecs, opt=OptState(step=P(), m=mspecs,
                                                  v=mspecs))


def batch_sharding(mesh, batch_tree, dp_only: bool = False):
    """A PartitionSpec for each leaf of ``batch_tree`` (dicts of anything
    with a ``shape``): the leading dim over the data axes, with
    ``dp_only`` the model axis joining them; a ``mrope_positions`` leaf,
    (3, B, S), cut on axis 1.

    One deliberate departure: the reference tells the positions apart by
    a leading axis of 3 and an int dtype, so it would cut a token batch of
    B = 3 on its second axis; this goes by the leaf's name, as
    :func:`split_microbatches` does. The two agree at every B other than
    3."""
    d = data_axes(mesh)
    if dp_only and "model" in mesh.axis_names:
        d = d + ("model",)
    lead = tuple(d) if len(d) > 1 else (d[0] if d else None)

    def spec_for(path, x):
        ndim = len(x.shape)
        if path and path[-1] == "mrope_positions":
            return P(None, lead, *([None] * (ndim - 2)))
        return P(lead, *([None] * (ndim - 1)))
    return tree_map_with_path(spec_for, batch_tree)


def abstract_train_state(model, opt_cfg: AdamWConfig) -> TrainState:
    """The whole TrainState on the ``meta`` device: shapes and dtypes,
    nothing allocated (the reference's ``ShapeDtypeStruct`` tree)."""
    def meta(d, dtype=None):
        return torch.empty(d.shape, dtype=dtype or d.dtype, device="meta")
    decls = model.param_decls()
    return TrainState(
        params=tree_map(meta, decls),
        opt=OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                     m=tree_map(lambda d: meta(d, opt_cfg.state_dtype),
                                decls),
                     v=tree_map(lambda d: meta(d, opt_cfg.state_dtype),
                                decls)))


def init_train_state(model, opt_cfg: AdamWConfig, seed: int = 0,
                     device: str | torch.device = "cuda", *, mesh=None,
                     zero1: bool = False, zero3: bool = False) -> TrainState:
    """Seeded random parameters (drawn on ``device``) and a zero optimizer
    state. With ``mesh``, this rank's shards under
    :func:`make_train_state_specs` (with ``zero3``, its regions): each
    leaf is drawn whole in slices, as the unsharded call draws it, and only
    this rank's part is kept (``init_params`` with specs), so no rank holds
    a whole leaf that it holds a part of; the moments are zeros of their
    shards' shapes. ``zero1`` or ``zero3`` without a mesh raises
    ``ValueError``."""
    device = torch.device(device)
    if mesh is None and (zero1 or zero3):
        raise ValueError("zero1 and zero3 cut the state over a mesh's data "
                         "axes; pass the mesh")
    gen = torch.Generator(device=device).manual_seed(seed)
    decls = model.param_decls()
    if mesh is None:
        params = init_params(decls, gen, device)
        return TrainState(params, adamw_init(params, opt_cfg))
    specs = make_train_state_specs(model, mesh, zero1=zero1, zero3=zero3)
    params = init_params(decls, gen, device, specs=specs.params, mesh=mesh)

    def zeros(path, d):
        return torch.zeros(local_shape(tree_at(specs.opt.m, path), d.shape,
                                       mesh),
                           dtype=opt_cfg.state_dtype, device=device)
    return TrainState(params, OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map_with_path(zeros, decls),
        v=tree_map_with_path(zeros, decls)))


@contextlib.contextmanager
def fp32_reductions():
    """Context: cuBLAS's reduced-precision reductions of bf16 products off
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``,
    on by default), so that every product of a train step accumulates in
    fp32, as the reference's ``preferred_element_type`` asks. With them
    on, a split-K product may sum its partials in bf16, and at some shard
    shapes (seamless-m4t's vocab shard of 128103 columns) the sharded
    step's gradients part from the fp32 step's several times further than
    the unsharded step's do (``tools/sharded_grad_floor.py`` measures
    both). On the CPU the flag is not read."""
    matmul = torch.backends.cuda.matmul
    flag = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = flag


def _loss_and_grads(model, params, batch, **kw):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.loss_fn(leaves, batch, **kw)
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, leaves)


def split_microbatches(batch: dict, mu: int) -> list[dict]:
    """``batch`` cut into ``mu`` microbatches of consecutive rows. B is
    read from ``tokens``; a ``mrope_positions`` leaf, (3, B, S), is cut on
    axis 1 and every other leaf on axis 0 (``tokens``, ``mask``, the
    vlm's ``vision_embeds`` (B, nv, d_model), the encoder-decoder's
    ``frames`` (B, T, d_model)), as the reference's
    reshape (``repro/runtime/train_lib.py:98-103``) cuts them.

    One deliberate departure: the reference tells the positions apart by
    a leading axis of 3, so it would cut a token batch of B = 3 on its
    second axis; this split goes by the leaf's name. The two agree at
    every B other than 3."""
    B = batch["tokens"].shape[0]
    if B % mu:
        raise ValueError(f"batch {B} is not divisible by {mu} microbatches")
    return [take_rows(batch, group_rows(B, mu, 1, 0, i)) for i in range(mu)]


def build_train_step(model, opt_cfg: AdamWConfig, *, mesh=None,
                     zero1: bool = False, zero3: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics hold
    ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the device. The
    global batch, divisible by ``cfg.microbatches``, is split by
    :func:`split_microbatches`.

    With ``mesh`` (a mesh over a process group, ``launch/mesh.py::
    make_local_mesh``), the step of one rank (:func:`_sharded_step`):
    ``state`` is this rank's shards (:func:`init_train_state` with the
    same ``mesh``, ``zero1`` and ``zero3``), ``batch`` the whole global
    batch, and the metrics the global loss and norm on every rank. With
    ``zero3`` the state is the rank's regions (``zero1`` then changes
    nothing: the moments are cut alike). ``zero1`` or ``zero3`` without a
    mesh raises ``ValueError`` before anything is allocated."""
    if mesh is not None:
        return _sharded_step(model, opt_cfg, mesh, zero1, zero3)
    if zero1 or zero3:
        raise ValueError("zero1 and zero3 cut the state over a mesh's data "
                         "axes; pass the mesh")
    mu = max(model.cfg.microbatches, 1)

    @fp32_reductions()
    def train_step(state: TrainState, batch):
        params = state.params
        if mu == 1:
            loss, grads = _loss_and_grads(model, params, batch)
        else:
            loss, grads = 0.0, None
            for mb in split_microbatches(batch, mu):
                l, g = _loss_and_grads(model, params, mb)
                loss = loss + l
                if grads is None:
                    grads = tree_map(lambda t: t.float(), g)
                else:
                    for (_, acc), (_, t) in zip(tree_items(grads),
                                                tree_items(g)):
                        acc.add_(t.float())
            loss = loss / mu
            for _, acc in tree_items(grads):    # in place: no second tree
                acc.div_(mu)
        params, opt, metrics = adamw_update(params, grads, state.opt,
                                            opt_cfg)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step


# ----------------------------------------------------------------------
# one rank of a (data, model) mesh
# ----------------------------------------------------------------------
def loss_weights(batch: dict, mu: int) -> torch.Tensor:
    """Each token's weight (B, S) fp32 in the reference's loss of the
    global ``batch`` with ``mu`` microbatches: the mean over the global
    microbatches (consecutive rows) of each one's masked mean, so
    ``mask / (mu * max(its microbatch's mask count, 1))``; without a mask,
    1 / (B S). A rank's share of the loss is sum(nll * weights) over its
    rows."""
    tokens = batch["tokens"]
    B, S = tokens.shape[0], tokens.shape[1] - 1
    if B % mu:
        raise ValueError(f"batch {B} is not divisible by {mu} microbatches")
    mask = batch.get("mask")
    if mask is None:
        return torch.full((B, S), 1.0 / (B * S), dtype=torch.float32,
                          device=tokens.device)
    mask = mask.float()
    counts = mask.reshape(mu, -1).sum(dim=1).clamp(min=1.0)
    return mask / (mu * counts.repeat_interleave(B // mu))[:, None]


def group_rows(B: int, mu: int, n_batch: int, index: int, i: int) -> slice:
    """The rows of the global batch that batch rank ``index`` of
    ``n_batch`` trains on in microbatch ``i`` of ``mu``: its part of the
    global microbatch of consecutive rows, ``i B/mu + index B/(mu n_batch)
    ...``, as the reference's ``shard_map`` cuts each global microbatch
    over the data axes (an MoE dispatches these rows as one group)."""
    n = B // (mu * n_batch)
    start = i * (B // mu) + index * n
    return slice(start, start + n)


def take_rows(batch: dict, rows: slice) -> dict:
    """``rows`` of every leaf of ``batch``: a ``mrope_positions`` leaf,
    (3, B, S), on axis 1 (C.1), every other leaf on axis 0."""
    return {k: x[:, rows] if k == "mrope_positions" else x[rows]
            for k, x in batch.items()}


# the blocks whose execution is model-parallel, by their key in the
# parameter tree (wherever they sit: ``layers/attn``, a hybrid block's
# ``layers/mamba``, the encoder-decoder's ``encoder/attn``,
# ``decoder/self_attn`` and ``decoder/cross_attn``), each under the
# layout's span that cuts it: a leaf of one that the specs keep whole over
# the model axis is used on the rank's part alone
_PARALLEL_BLOCKS = {"attn": "heads", "self_attn": "heads",
                    "cross_attn": "heads", "mamba": "ssm_heads",
                    "moe": "experts", "mlp": "mlp"}
# leaves of those blocks used before their region is entered, on values
# alike on every model rank: the MoE router (the reference routes outside
# its shard_map)
_OUTSIDE = frozenset({("moe", "router")})


def model_partial_leaves(model, layout) -> set:
    """Paths of the parameters whose gradient on a rank is a part: those
    that the specs keep whole over the model axis while the code uses them
    on this rank's part alone, found from the specs, in every block of
    ``_PARALLEL_BLOCKS`` wherever it sits in the tree (an LM's layers, a
    hybrid block's sublayers, the encoder-decoder's encoder and decoder).
    In an attention that is the leaves not cut where its q heads are
    (qwen3's ``q_norm`` and ``k_norm``, on the rank's heads; ``wk``/``wv``
    where the KV heads do not divide, each rank reading the KV heads its q
    heads use); in a Mamba block ``w_B``, ``w_C``, ``conv_B`` and
    ``conv_C`` (each rank's heads read them); none in an MoE but the
    router, which is outside its region, nor in an MLP, whose leaves are
    all cut where its hidden units are. The norms, the embedding and the
    head are used before ``enter`` (or all of them on every rank) and get
    the whole gradient on every rank."""
    specs = spec_tree(model.param_decls(), layout.mesh,
                      make_rules(layout.mesh, dp_only=model.cfg.dp_only))
    out = set()

    def walk(tree, prefix):
        for key, sub in tree.items():
            span = _PARALLEL_BLOCKS.get(key)
            if span is None:
                if isinstance(sub, dict):
                    walk(sub, prefix + (key,))
                continue
            if not getattr(layout, span).sharded:
                continue
            out.update(prefix + (key,) + path
                       for path, spec in tree_items(sub)
                       if "model" not in _axes_of(spec)
                       and (key,) + path not in _OUTSIDE)
    walk(specs, ())
    return out


def _axes_of(spec) -> set:
    return {axis for part in spec for axis in spec_axes(part)}


def flat_sum(grads: list, group) -> list:
    """The gradient shards summed over ``group`` in fp32, in one all_reduce
    of one flat buffer; each comes back an fp32 view of it."""
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()
    return out


def shard_plan(model, mesh, zero1: bool = False,
               zero3: bool = False) -> ShardPlan:
    """This rank's :class:`~repro_torch.optim.adamw.ShardPlan` under
    :func:`make_train_state_specs`: the mesh axes that cut each parameter
    shard the rank holds (with ``zero3``, its region), the region of each
    that its moments cover (with ``zero1``, the moments' cut over the
    batch axes; None where they cover the whole shard: every leaf under
    ``zero3``), the mesh, and the model and batch axes' process groups.
    Needs a live mesh; raises ``NotImplementedError`` naming ROADMAP A.12
    for what the sharded step does not cover
    (``serve_lib.shard_layout``)."""
    from .serve_lib import shard_layout
    layout = shard_layout(model, mesh, _batch_ranks(mesh, model.cfg))
    if not mesh.is_live:
        raise ValueError(f"the sharded train step runs on a mesh over a "
                         f"process group (make_local_mesh), not {mesh}")
    specs = make_train_state_specs(model, mesh, zero1=zero1, zero3=zero3)
    cuts, regions = [], []
    for path, d in tree_items(model.param_decls()):
        pspec, mspec = tree_at(specs.params, path), tree_at(specs.opt.m,
                                                            path)
        psl = local_slices(pspec, d.shape, mesh)
        cuts.append(tuple(sorted(_axes_of(pspec))))
        msl = local_slices(mspec, d.shape, mesh)
        # a cut over axes that hold one rank leaves the whole shard
        regions.append(None if psl == msl else tuple(
            slice(m.start - p.start, m.stop - p.start)
            for p, m in zip(psl, msl)))
    return ShardPlan(tuple(cuts), tuple(regions), mesh, layout.model_group,
                     layout.batch_group)


def _sharded_step(model, opt_cfg: AdamWConfig, mesh, zero1: bool,
                  zero3: bool):
    """One rank's ``train_step(state, batch)`` on ``mesh``.

    For each of the ``cfg.microbatches`` global microbatches (consecutive
    rows of the batch) the rank takes its rows of it (:func:`group_rows`;
    with ``mrope_positions`` on axis 1, :func:`take_rows`) and runs them
    through ``loss_fn(..., shard=, weights=, aux_weight=)`` with the
    tokens' weights in the reference's global loss (:func:`loss_weights`)
    and the aux term's 1 / microbatches, accumulating the gradient in fp32
    (without microbatches, in the parameters' dtype). An MoE dispatches
    those rows as one group, its capacity from their tokens and its aux
    loss over the global microbatch, as the reference's. A batch whose
    microbatches do not divide over the batch ranks raises ``ValueError``
    (the reference would replicate the microbatch's tokens over the data
    axes). After the backward: the leaves of
    :func:`model_partial_leaves` summed over the model axis (one flat
    all_reduce, :func:`flat_sum`), every gradient summed over the batch
    axes in fp32 (one), the loss summed over them (one), and
    ``adamw_update_sharded`` (the global norm over the mesh; with
    ``zero1`` the updated regions gathered over the batch axes).

    With ``zero3`` the leaves that the ZeRO-3 pass cuts are the rank's
    regions, gathered a unit at a time inside the model; their gradients
    come out of the gathers' backward already summed over the batch axes,
    in fp32 (``Zero3Grads``: a microbatch's added to the last's), so the
    batch axes' sum takes only the leaves the pass keeps whole, the model
    axis's sum of the partial leaves runs on the regions, and AdamW updates
    the regions in place (no gather: the moments cover them whole)."""
    from ..sharding.layout import Zero3Grads
    from .serve_lib import shard_layout
    cfg = model.cfg
    mu = max(cfg.microbatches, 1)
    plan = shard_plan(model, mesh, zero1, zero3)
    n_batch = _batch_ranks(mesh, cfg)
    cut = model_partial_leaves(model, shard_layout(model, mesh, n_batch))
    paths = [path for path, _ in tree_items(model.param_decls())]
    partial = [path in cut for path in paths]

    @fp32_reductions()
    def train_step(state: TrainState, batch):
        B = batch["tokens"].shape[0]
        if B % (n_batch * mu):
            raise ValueError(f"batch {B} does not divide into {mu} "
                             f"microbatches, each over {n_batch} batch "
                             f"ranks' rows")
        layout = shard_layout(model, mesh, B, zero3=zero3)
        z = layout.zero3
        if z is not None:
            z = dataclasses.replace(z, grads=Zero3Grads(
                z.region_shapes(), tree_items(state.params)[0][1].device))
            layout = dataclasses.replace(layout, zero3=z)
        # the leaves whose gradients the gathers' backward sums
        gathered = [z is not None and path in z.regions for path in paths]
        index = layout.batch.start // layout.batch.size
        weights = loss_weights(batch, mu)
        with mesh_context(mesh):
            loss, grads = 0.0, None
            for i in range(mu):
                rows = group_rows(B, mu, n_batch, index, i)
                l, g = _loss_and_grads(model, state.params,
                                       take_rows(batch, rows), shard=layout,
                                       weights=weights[rows],
                                       aux_weight=1.0 / mu)
                loss = loss + l
                g = [t for _, t in tree_items(g)]
                if grads is None:
                    grads = [t.float() if mu > 1 and t is not None else t
                             for t in g]
                else:
                    for acc, t in zip(grads, g):
                        if t is not None:
                            acc.add_(t.float())
            if z is not None:
                grads = [z.grads.by_path[path] if cut3 else g
                         for path, g, cut3 in zip(paths, grads, gathered)]
            if any(partial):
                summed = iter(flat_sum(
                    [g for g, p in zip(grads, partial) if p],
                    plan.model_group))
                grads = [next(summed) if p else g
                         for g, p in zip(grads, partial)]
            if plan.batch_group is not None:
                whole = [g for g, cut3 in zip(grads, gathered) if not cut3]
                if whole:
                    summed = iter(flat_sum(whole, plan.batch_group))
                    grads = [g if cut3 else next(summed)
                             for g, cut3 in zip(grads, gathered)]
                loss = loss.reshape(1).clone()
                torch.distributed.all_reduce(loss, group=plan.batch_group)
                loss = loss[0]
            by_path = dict(zip(paths, grads))
            grads = tree_map_with_path(lambda path, _: by_path[path],
                                       state.params)
            params, opt, metrics = adamw_update_sharded(
                state.params, grads, state.opt, opt_cfg, plan)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step


def _batch_ranks(mesh, cfg) -> int:
    """The ranks that :func:`batch_sharding` cuts the batch over."""
    entry = batch_sharding(mesh, {"tokens": torch.empty((1, 1),
                                                        device="meta")},
                           dp_only=cfg.dp_only)["tokens"][0]
    return math.prod(mesh.shape[axis] for axis in spec_axes(entry))
