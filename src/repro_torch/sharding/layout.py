"""What a rank of a sharded step holds, and its collectives.

``runtime/serve_lib.py`` reads the specs (``rules.spec_tree``,
``serve_lib.cache_specs``; for training ``train_lib.batch_sharding``) into
a :class:`ShardLayout`: for each dim that the model's execution cuts (q
heads, KV heads, the MLP's hidden units, the experts, the shared experts'
hidden units, the Mamba heads and their inner columns, the vocab, the
batch, the cache's sequence), the span of it that this rank holds and the
mesh axes it is cut over. The model's sharded code (``models/attention.py``,
``ffn.py``, ``moe.py``, ``ssm.py``, ``lm.py``, ``common.py``) takes the
layout as its ``shard`` argument and runs the collectives through it, over
the mesh's process groups.

Every collective is an ``all_reduce``: a gather is a sum over a zero-filled
full-size buffer into which each rank writes its own part (exact: each
element has one nonzero term), and a sum and gathers can share one buffer
(:meth:`ShardLayout.sum_with`, a Mamba layer's norm and conv tail). Gloo
takes CUDA tensors in ``broadcast`` and ``all_reduce`` alone, which is what
ranks that share one card run on; NCCL (one rank a card) takes the same
calls.

Under grad (training: the dense, vlm, moe and ssm families) these
collectives carry their gradients, each a ``torch.autograd.Function``
whose forward is the serving path's call. The rule they keep: a tensor
alike on every model rank holds its whole gradient on every rank.

* :meth:`ShardLayout.enter`, the entry to a model-parallel region (the
  normed input of the column-parallel ``wq``/``wk``/``wv``, ``w_up``/
  ``w_gate``, the experts' dispatch and the gates their combine reads, a
  Mamba block's input, the head's vocab columns): the identity forward,
  the sum of the input's gradient over the model axis backward (each
  rank's gradient is its own heads', units', experts' or columns' part).
  Without grad it returns its input and runs nothing;
* :meth:`ShardLayout.reduce_sum`, the row-parallel exit: the sum forward,
  the identity backward (every rank's partial takes the whole output's
  gradient);
* :meth:`ShardLayout.sum_exact`, the vocab-parallel lookup: the sum
  forward, the identity backward (a rank's rows take the gradient of the
  tokens they hold);
* :meth:`ShardLayout.sum_partials`, a statistic summed over the model
  ranks that each rank then applies to its own part alone (the Mamba
  block's gated norm, its mean square over ``d_inner`` columns cut over
  the model axis): the sum forward and the sum backward;
* :meth:`ShardLayout.batch_sum`, over the batch ranks (the MoE aux loss's
  per-expert sums over a global microbatch): the sum forward, the identity
  backward, with :meth:`ShardLayout.counted_once` on the loss term that
  reads it, so that its value enters the loss summed over the batch ranks
  once and its gradient reaches each rank's own tokens once.

The vocab-parallel cross entropy (``models/common.py::token_nll``) is one
more: its forward takes ``max_`` and ``sum_with``, its backward is local.
The rest (``gather``, ``gather_logits``, the decode step's merges) serve
only.

ZeRO-3 (a layout with :class:`Zero3`, ``serve_lib.shard_layout(...,
zero3=True)``): a rank holds only its region of each parameter that the
ZeRO-3 pass cuts (its slice of the leaf's model-axis shard, cut over the
data axes), and the model brings each unit's leaves up to their model-axis
shards just before it runs the unit (:meth:`ShardLayout.gather_params`: a
layer, a hybrid super-block, an encoder or decoder layer, the embedding,
the final norms and the head), inside the unit's remat body, so that the
recompute gathers again and no gathered unit outlives its use. The gather
is a sum over the data axes of a zero buffer into which each rank writes
its regions, one all_reduce a dtype; under grad its backward sums the
model-axis shard's gradient over the same axes in fp32 (one all_reduce)
and leaves the rank's region, in fp32, in the layout's ``grads`` (the
train step's; the leaves themselves get no gradient, so no fp32 sum is
rounded to a bf16 leaf's dtype).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..launch.mesh import Mesh
from ..models.param import tree_items, tree_map_with_path
from .rules import local_slices, spec_axes, PartitionSpec

__all__ = ["Span", "ShardLayout", "Zero3", "Zero3Grads", "span_of"]


class _Enter(torch.autograd.Function):
    """Identity forward on each of ``xs``; backward, their gradients
    summed over ``group`` in fp32, in one all_reduce of one flat buffer,
    each rounded once to its dtype."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.metas = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([
            torch.zeros(shape, dtype=torch.float32, device=device).reshape(-1)
            if g is None else g.reshape(-1).float()
            for g, (shape, _, device) in zip(grads, ctx.metas)])
        torch.distributed.all_reduce(flat, group=ctx.group)
        out, offset = [], 0
        for shape, dtype, _ in ctx.metas:
            n = math.prod(shape)
            out.append(flat[offset:offset + n].view(shape).to(dtype))
            offset += n
        return (None, *out)


class _Sum(torch.autograd.Function):
    """``t`` summed over ``group`` (the serving path's call, on a copy:
    ``t`` may be a view that another Function made); backward, the
    identity."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumBoth(torch.autograd.Function):
    """``t`` summed over ``group`` (on a copy); backward, the gradient
    summed over it too."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        total = grad.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(total, group=ctx.group)
        return total, None


def _gather_regions(parts, group) -> list:
    """``parts``: (region tensor, its region of the model-axis shard, the
    shard's shape). Each shard whole on every rank of ``group``: one
    zero-filled buffer a dtype into which each rank writes its regions,
    summed over ``group`` (exact: one nonzero term an element)."""
    out = [None] * len(parts)
    by_dtype: dict = {}
    for i, (t, _, _) in enumerate(parts):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, items in by_dtype.items():
        sizes = [math.prod(parts[i][2]) for i in items]
        flat = torch.zeros(sum(sizes), dtype=dtype,
                           device=parts[items[0]][0].device)
        offset = 0
        for i, n in zip(items, sizes):
            t, region, shape = parts[i]
            out[i] = flat[offset:offset + n].view(shape)
            out[i][region] = t
            offset += n
        torch.distributed.all_reduce(flat, group=group)
    return out


class _Gather(torch.autograd.Function):
    """Forward, :func:`_gather_regions` of ``ts`` (their regions and
    shards' shapes in ``keys``: (path, index, region, shape) each);
    backward, the shards' gradients summed over ``group`` in fp32 in one
    all_reduce, and each rank's region of each left in ``grads`` at its
    path and index (copied by the first gradient to reach it, added by
    the next: a tied embedding's two uses, a microbatch's); the region
    tensors get none."""

    @staticmethod
    def forward(ctx, group, keys, grads, *ts):
        ctx.group, ctx.keys, ctx.grads = group, keys, grads
        ctx.device = ts[0].device
        return tuple(_gather_regions([(t, k[2], k[3]) for t, k in
                                      zip(ts, keys)], group))

    @staticmethod
    def backward(ctx, *outs):
        sizes = [math.prod(k[3]) for k in ctx.keys]
        flat = torch.cat([
            torch.zeros(n, dtype=torch.float32, device=ctx.device)
            if g is None else g.reshape(-1).float()
            for g, n in zip(outs, sizes)])
        torch.distributed.all_reduce(flat, group=ctx.group)
        offset = 0
        for (path, index, region, shape), n in zip(ctx.keys, sizes):
            part = flat[offset:offset + n].view(shape)[region]
            offset += n
            ctx.grads.add(path, index, part)
        return (None, None, None) + (None,) * len(outs)


class Zero3Grads:
    """A ZeRO-3 train step's gradients of the regions, fp32, filled by the
    gathers' backward: ``by_path`` maps a parameter's path to its region's
    whole gradient (every layer of a stacked leaf); a (path, index) slice
    is copied by its first gradient and added to by the next."""

    def __init__(self, shapes: dict, device):
        self.shapes, self.device = shapes, device
        self.by_path: dict = {}
        self._seen: set = set()

    def add(self, path: tuple, index: tuple, part: torch.Tensor) -> None:
        dst = self.by_path.get(path)
        if dst is None:
            dst = self.by_path[path] = torch.zeros(
                self.shapes[path], dtype=torch.float32, device=self.device)
        dst = dst[index] if index else dst
        if (path, index) in self._seen:
            dst.add_(part)
        else:
            dst.copy_(part)
            self._seen.add((path, index))


@dataclasses.dataclass(frozen=True)
class Zero3:
    """A ZeRO-3 rank's parameters: ``regions`` maps the path of each leaf
    that the ZeRO-3 pass cuts to the region of its model-axis shard that
    the rank holds (a slice a dim), ``shapes`` to that shard's shape;
    ``axes`` are the mesh axes the pass cuts over (the data axes; under
    ``dp_only`` the model axis too). A leaf the pass leaves whole is in
    neither and is used as it is. ``grads`` is a train step's
    :class:`Zero3Grads` (None serving)."""

    regions: dict
    shapes: dict
    axes: tuple
    grads: Zero3Grads | None = None

    def region_shapes(self) -> dict:
        """Each cut leaf's region's shape: the shape the rank holds."""
        return {p: tuple(s.stop - s.start for s in r)
                for p, r in self.regions.items()}


def _sum(t: torch.Tensor, group, both: bool = False) -> torch.Tensor:
    """Sum over ``group``, in place; under grad through :class:`_Sum` (or,
    with ``both``, :class:`_SumBoth`)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return (_SumBoth if both else _Sum).apply(t, group)
    torch.distributed.all_reduce(t, group=group)
    return t


@dataclasses.dataclass(frozen=True)
class Span:
    """This rank's part [start, start + size) of a dim of ``total`` entries
    cut over the mesh axes ``axes`` (() when the dim is replicated)."""

    start: int
    size: int
    total: int
    axes: tuple[str, ...] = ()

    @property
    def sharded(self) -> bool:
        return bool(self.axes)

    @property
    def stop(self) -> int:
        return self.start + self.size

    def slice(self) -> slice:
        return slice(self.start, self.stop)


def span_of(entry, total: int, mesh: Mesh) -> Span:
    """The span of a ``total``-long dim whose spec entry is ``entry``."""
    sl = local_slices(PartitionSpec(entry), (total,), mesh)[0]
    return Span(sl.start, sl.stop - sl.start, total, spec_axes(entry))


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """One rank's part of a sharded model and of its serving cache (a
    training layout has no cache: ``seq`` None).

    ``vocab`` are the embedding rows and logit columns and ``batch`` the
    sequences this rank serves or trains on. A family's own dims, None
    where the family has none: ``heads`` the q heads (``wq``'s and
    ``wo``'s), ``kv_heads`` the K/V projections' heads and ``seq`` this
    rank's rows of the K/V cache (dense, vlm, moe, hybrid, encdec: its self
    cache); ``mlp`` the MLP's hidden units (dense, vlm, hybrid, encdec);
    ``experts`` the experts this rank serves and ``shared`` the shared
    experts' hidden units (moe, hybrid); ``ssm_heads`` the Mamba heads and
    ``ssm_inner`` their ``d_inner`` columns, head-major (ssm, hybrid)."""

    mesh: Mesh
    vocab: Span
    batch: Span
    heads: Span | None = None
    kv_heads: Span | None = None
    seq: Span | None = None
    mlp: Span | None = None
    experts: Span | None = None
    shared: Span | None = None
    ssm_heads: Span | None = None
    ssm_inner: Span | None = None
    zero3: Zero3 | None = None

    @property
    def model_group(self):
        """The process group of this rank's model axis: every collective
        but the logits' runs over it."""
        return self.mesh.group("model")

    @property
    def batch_group(self):
        """The process group of the mesh axes that cut the batch (the data
        axes; under ``dp_only`` the model axis too), None where they hold
        one rank: the ranks that hold the same parameter shards and sum
        their gradients."""
        if self.batch.size == self.batch.total:
            return None
        return self.mesh.group(self.batch.axes)

    def gather_params(self, tree, prefix: tuple = (), index: tuple = ()):
        """``tree`` (the parameters at ``prefix``, each leaf indexed by
        ``index`` on its leading stacked axes: a layer's or a block's
        slices) with every leaf that the ZeRO-3 pass cuts brought up from
        this rank's region to its model-axis shard (:class:`Zero3`); the
        tree as it is without ZeRO-3. Under grad the gather's backward
        leaves the regions' fp32 gradients in ``zero3.grads``."""
        z = self.zero3
        if z is None:
            return tree
        cut = [(path, t) for path, t in tree_items(tree)
               if prefix + path in z.regions]
        if not cut:
            return tree
        n = len(index)
        keys = [(prefix + path, index, z.regions[prefix + path][n:],
                 z.shapes[prefix + path][n:]) for path, t in cut]
        group = self.mesh.group(z.axes)
        ts = [t for _, t in cut]
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            if z.grads is None:
                raise ValueError("a ZeRO-3 gather under grad needs the "
                                 "train step's gradients (Zero3.grads)")
            full = _Gather.apply(group, keys, z.grads, *ts)
        else:
            full = _gather_regions([(t, k[2], k[3]) for t, k in
                                    zip(ts, keys)], group)
        by_path = {path: f for (path, _), f in zip(cut, full)}
        return tree_map_with_path(lambda p, t: by_path.get(p, t), tree)

    def reduce_sum(self, partial: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
        """Sum of every model rank's fp32 ``partial`` (a row-parallel
        product, ``common.matmul_f32``), rounded once to ``dtype``. Under
        grad the sum's backward is the identity."""
        return _sum(partial, self.model_group).to(dtype)

    @property
    def training(self) -> bool:
        """A training layout (``shard_layout(..., max_len=None)``): no
        cache."""
        return self.seq is None

    @property
    def batch_ranks(self) -> int:
        """The ranks that cut the batch (1 where it is not cut)."""
        return self.batch.total // self.batch.size

    def enter(self, *xs: torch.Tensor):
        """Each of ``xs``, replicated over the model axis, entering a
        region where each model rank computes its part: the identity; under
        grad the backward sums their gradients over the model axis, in one
        all_reduce. Without grad, the inputs themselves and no collective.
        Returns one tensor for one input, else a tuple."""
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            out = _Enter.apply(self.model_group, *xs)
        else:
            out = xs
        return out[0] if len(xs) == 1 else tuple(out)

    def sum_partials(self, partial: torch.Tensor) -> torch.Tensor:
        """Sum over the model ranks of each rank's ``partial`` of a
        statistic that every rank then applies to its own part alone (a
        norm's sum of squares over columns cut over the model axis): in
        place; under grad on a copy, and the backward sums the gradient over
        the model axis as well (each rank's gradient of the total is its
        own part's)."""
        return _sum(partial, self.model_group, both=True)

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch ranks (a no-op where the batch is not
        cut): in place; under grad on a copy whose backward is the identity,
        so each rank's own terms take the gradient of the sum that its
        loss reads (see :meth:`counted_once`)."""
        if self.batch_group is None:
            return t
        return _sum(t, self.batch_group)

    def counted_once(self, t: torch.Tensor) -> torch.Tensor:
        """A loss term alike on every batch rank (a function of
        :meth:`batch_sum`'s sums), entering the loss that the step sums
        over the batch ranks: its value divided by their number, so that
        the sum counts it once, and its gradient whole, which through the
        sum's identity backward reaches each rank's own terms once."""
        n = self.batch_ranks
        if n == 1:
            return t
        return t + t.detach() * (1.0 / n - 1.0)

    def sum_exact(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the model ranks where at most one rank's term is
        nonzero at each element (a vocab-parallel lookup, a gather): exact
        in any dtype, so taken in ``t``'s. In place (under grad on a copy,
        whose backward is the identity)."""
        return _sum(t, self.model_group)

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the model ranks, in place."""
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                     group=self.model_group)
        return t

    def gather(self, *parts: tuple) -> list[torch.Tensor]:
        """The whole of each dim cut over the model axis, in one all_reduce
        for all of them: ``parts`` are (t, dim, span), this rank's ``t``
        holding ``span`` of dim ``dim``; each comes back full on every
        rank. A part whose span is not cut comes back as it is."""
        return self.sum_with(None, *parts)[1]

    def sum_with(self, partial: torch.Tensor | None,
                 *parts: tuple) -> tuple[torch.Tensor | None,
                                         list[torch.Tensor]]:
        """``partial``'s sum over the model ranks and ``parts`` gathered as
        :meth:`gather` does, in one all_reduce of one flat buffer in
        ``partial``'s dtype (the parts' dtype without one; a bf16 part in
        an fp32 buffer comes back exact). -> (the sum, the parts)."""
        cut = [(i, t, dim, span) for i, (t, dim, span) in enumerate(parts)
               if span.sharded]
        out = [t for t, _, _ in parts]
        if partial is None and not cut:
            return None, out
        shapes = []
        for _, t, dim, span in cut:
            shape = list(t.shape)
            shape[dim] = span.total
            shapes.append(shape)
        sizes = [math.prod(shape) for shape in shapes]
        head = 0 if partial is None else partial.numel()
        like = cut[0][1] if partial is None else partial
        flat = like.new_zeros(head + sum(sizes))
        if partial is not None:
            flat[:head].copy_(partial.reshape(-1))
        offset = head
        for (i, t, dim, span), shape, size in zip(cut, shapes, sizes):
            full = flat[offset:offset + size].view(shape)
            full.narrow(dim, span.start, span.size).copy_(t)
            out[i] = full
            offset += size
        torch.distributed.all_reduce(flat, group=self.model_group)
        total = None if partial is None else flat[:head].view(partial.shape)
        return total, out

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Full (B, S, vocab) logits on every rank from this rank's (batch
        span, S, vocab span) block, as the reference's steps return
        replicated logits. One sum over every rank: a rank writes its block
        only where it is the first of the ranks that hold the same block
        (coordinate 0 on each axis that cuts neither dim)."""
        B, V = self.batch.total, self.vocab.total
        full = logits.new_zeros((B, logits.shape[1], V))
        used = set(self.batch.axes) | set(self.vocab.axes)
        if all(c == 0 for a, c in self.mesh.coords.items() if a not in used):
            full[self.batch.slice(), :, self.vocab.slice()] = logits
        torch.distributed.all_reduce(full)
        return full
