"""Shared layer primitives: RMS norm, SiLU, softplus, rotary embeddings,
the cross-entropy loss (also vocab-parallel, :func:`token_nll`) and the
per-layer remat wrapper.

Same conventions as the JAX package's ``models/common.py``: compute in the
activation dtype, normalise, rotate and take the loss in fp32. The rest of
that module (layer norm) comes with the slice that uses it.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint, noop_context_fn

__all__ = ["matmul", "embed_tokens", "rms_norm", "silu", "gelu",
           "squared_relu", "softplus", "ACTIVATIONS", "rope_table",
           "apply_rope", "apply_mrope", "cross_entropy_loss", "token_nll",
           "remat_layer"]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype of the two, as ``jnp.einsum`` promotes
    (bf16 activations against fp32 weights give fp32)."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype of the two, accumulated in fp32 and
    returned in fp32, not rounded: a row-parallel partial product that is
    summed over the model axis before it is rounded, as the unsharded
    product rounds once. On the card one cuBLAS call with an fp32 output
    (``out_dtype``); on the CPU the operands cast up (a bf16 x bf16 product
    is exact in fp32)."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dtype), w.to(dtype)
    if dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _MatmulF32.apply(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.view(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


class _MatmulF32(torch.autograd.Function):
    """The card's fp32-output product under grad (``torch.mm``'s
    ``out_dtype`` has no derivative): its backward takes the operands'
    dtype, as the product rounded once does, ``grad`` (the gradient of a
    sum rounded to that dtype) exact in it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.view(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        gx = g @ w.T if ctx.needs_input_grad[0] else None
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1]) \
            if ctx.needs_input_grad[1] else None
        return gx, gw


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 shard=None) -> torch.Tensor:
    """Token embeddings in bf16. With ``shard`` (a
    ``sharding.layout.ShardLayout``) whose ``vocab`` is cut over the model
    axis, ``table`` holds this rank's rows: a token outside them gives 0
    here, and the sum over the model axis gives every rank the embedding
    (vocab-parallel lookup, exact: one rank's term is nonzero)."""
    if shard is None or not shard.vocab.sharded:
        return table[tokens].to(torch.bfloat16)
    row = tokens - shard.vocab.start
    inside = (row >= 0) & (row < shard.vocab.size)
    x = table[row.clamp(0, shard.vocab.size - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return shard.sum_exact(x).to(torch.bfloat16)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    # the reference's sigmoid, op for op in x's dtype: 1 / (1 + exp(-x));
    # torch.sigmoid rounds once and differs from it by a bf16 ulp
    return x * (1 / (1 + torch.exp(-x)))


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a constant to the
    array's dtype before it multiplies (torch would keep it in fp32)."""
    return torch.tensor(value, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    # the reference's jax.nn.gelu(approximate=True), op for op in x's dtype
    # with its constants in that dtype; F.gelu(approximate="tanh") rounds
    # once and differs from it by a bf16 ulp
    c = _in_dtype(math.sqrt(2 / math.pi), x.dtype)
    a = _in_dtype(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * x ** 3))))


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """Primer / Nemotron-4 activation: relu(x)**2."""
    r = torch.relu(x)
    return r * r


def softplus(x: torch.Tensor) -> torch.Tensor:
    # as the reference computes it, logaddexp(x, 0); F.softplus switches to
    # x itself above its threshold (20) and rounds differently there
    return torch.logaddexp(x, torch.zeros_like(x))


ACTIVATIONS = {"silu": silu, "gelu": gelu, "squared_relu": squared_relu}


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions.

    positions: (...,) int  ->  cos, sin: (..., head_dim // 2) fp32.
    """
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (split-half convention).  x: (B, S, H, D);
    cos/sin: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 2:         # (S, D/2) -> broadcast over batch, heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                      # (B, S, D/2) -> broadcast over heads
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, head_dim: int,
                sections: tuple[int, int, int] | None = None,
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the head dim is split into (temporal, h, w)
    sections, each rotated by its own position stream.

    x: (B, S, H, D); positions_3d: (3, B, S) int.
    ``sections`` are in half-dim units and must sum to D // 2; the default
    is Qwen2-VL's 1:1.5:1.5 split, (16, 24, 24) at D = 128.
    """
    half = head_dim // 2
    if sections is None:
        t = half // 4
        w = (half - t) // 2
        sections = (t, half - t - w, w)
    if sum(sections) != half:
        raise ValueError(f"sections {sections} must sum to {half}")
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions_3d.device) / half
    freqs = 1.0 / (theta ** exponent)
    # angle[b, s, i] = pos[section of i, b, s] * freqs[i]: each stream
    # repeated over its section's columns, with no host-side index tensor
    pos = positions_3d.float()                                # (3, B, S)
    pos_sel = torch.cat([pos[j, ..., None].expand(*pos.shape[1:], n)
                         for j, n in enumerate(sections)], dim=-1)
    angles = pos_sel * freqs                                  # (B, S, half)
    return apply_rope(x, torch.cos(angles), torch.sin(angles))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       shard=None) -> torch.Tensor:
    """Mean token-level cross entropy in fp32. logits: (..., V); labels:
    (...) int; with ``mask`` (...), sum(nll * mask) / max(sum(mask), 1).
    ``shard``: ``logits`` are a rank's vocab columns (:func:`token_nll`)."""
    nll = token_nll(logits, labels, shard)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              shard=None) -> torch.Tensor:
    """Each token's cross entropy in fp32, ``logz - gold``, as
    :func:`cross_entropy_loss` takes it. With ``shard`` whose ``vocab`` is
    cut over the model axis, ``logits`` are this rank's vocab columns
    (:class:`_VocabParallelNLL`)."""
    if shard is not None and shard.vocab.sharded:
        return _VocabParallelNLL.apply(logits, labels, shard)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


class _VocabParallelNLL(torch.autograd.Function):
    """Vocab-parallel cross entropy of this rank's logit columns (B, S,
    V_local), in fp32, with no gather of the logits: the max over the
    model axis in one all_reduce, then the sum of exponentials and the
    gold logit (nonzero on the rank that owns the label) in one
    ``sum_with``; logz = max + log(sum). The backward is local: softmax
    minus one-hot on the rank's own columns, times the gradient, in the
    logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels, shard):
        span = shard.vocab
        l32 = logits.float()
        m = shard.max_(l32.amax(dim=-1))
        sumexp = torch.exp(l32 - m[..., None]).sum(dim=-1)
        row = labels.long() - span.start
        inside = (row >= 0) & (row < span.size)
        row = row.clamp(0, span.size - 1)
        gold = torch.gather(l32, -1, row[..., None])[..., 0]
        gold = torch.where(inside, gold, torch.zeros((), device=gold.device))
        total, _ = shard.sum_with(torch.stack([sumexp, gold]))
        logz = m + torch.log(total[0])
        ctx.save_for_backward(logits, logz, row, inside)
        return logz - total[1]

    @staticmethod
    def backward(ctx, grad):
        logits, logz, row, inside = ctx.saved_tensors
        d = torch.exp(logits.float() - logz[..., None])
        d.scatter_add_(-1, row[..., None], -inside.float()[..., None])
        return (d * grad[..., None]).to(logits.dtype), None, None


def remat_layer(body, context_fn=noop_context_fn):
    """``body`` run under ``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` of a layer: with the default ``context_fn`` it saves
    only its inputs ("full"); a selective-checkpoint ``context_fn`` saves
    what its policy names."""
    def run(*args):
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)
    return run
