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

Under grad (training, dense family) three collectives carry their
gradients, each a ``torch.autograd.Function`` whose forward is the
serving path's call:

* :meth:`ShardLayout.enter`, the entry to a model-parallel region (the
  normed input of the column-parallel ``wq``/``wk``/``wv``, ``w_up``/
  ``w_gate`` and the head's vocab columns): the identity forward, the sum
  of the input's gradient over the model axis backward (each rank's
  gradient is its own heads', units' or columns' part). Without grad it
  returns its input and runs nothing;
* :meth:`ShardLayout.reduce_sum`, the row-parallel exit: the sum forward,
  the identity backward (every rank's partial takes the whole output's
  gradient);
* :meth:`ShardLayout.sum_exact`, the vocab-parallel lookup: the sum
  forward, the identity backward (a rank's rows take the gradient of the
  tokens they hold).

The vocab-parallel cross entropy (``models/common.py::token_nll``) is the
fourth: its forward takes ``max_`` and ``sum_with``, its backward is
local. The rest (``gather``, ``gather_logits``, the decode step's merges)
serve only.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..launch.mesh import Mesh
from .rules import local_slices, spec_axes, PartitionSpec

__all__ = ["Span", "ShardLayout", "span_of"]


class _Enter(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over ``group`` in
    fp32 and rounded once to its dtype."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(torch.float32, memory_format=torch.contiguous_format,
                        copy=True)
        torch.distributed.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


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


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, in place; under grad through :class:`_Sum`."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _Sum.apply(t, group)
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

    def reduce_sum(self, partial: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
        """Sum of every model rank's fp32 ``partial`` (a row-parallel
        product, ``common.matmul_f32``), rounded once to ``dtype``. Under
        grad the sum's backward is the identity."""
        return _sum(partial, self.model_group).to(dtype)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, replicated over the model axis, entering a region where
        each model rank computes its part: the identity; under grad the
        backward sums ``x``'s gradient over the model axis. Without grad,
        ``x`` itself and no collective."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _Enter.apply(x, self.model_group)
        return x

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
