"""GQA attention: blockwise (flash-style) prefill + cached decode.

Port of ``repro/models/attention.py``. The two attention cores run the
hand-written CUDA kernels on CUDA tensors (``repro_torch.kernels``) and the
plain versions below on CPU tensors:

* ``blockwise_attention`` — online softmax over query and KV chunks, the
  JAX package's algorithm, step for step;
* ``decode_attention``    — one query token against the cache, masked to
  its valid length.

``attention`` is the sublayer with the reference's modes: causal or not
(the encoder's self-attention), a cache to fill or read, and ``kv_source``
(cross-attention over an encoder memory, uncached). ``cross_attention`` is
the encoder-decoder's cached cross-attention, over memory K/V projected
once at prefill.

Under grad on the card (training), the flash kernel runs as a custom op
whose gradient is the hand-written backward kernel; on the CPU
autograd differentiates the plain path op by op.

GQA stays ungrouped on both paths: Q is viewed as (kv_heads, group) and K/V
are never repeated. Head h maps to (h // G, h % G), as in the reference.

With ``shard`` (a ``sharding.layout.ShardLayout``, passed by
``runtime/serve_lib.py``'s steps and ``runtime/train_lib.py``'s sharded
train step) the sublayer runs on one rank of a (data, model) mesh, in the
layout the reference's specs give: q heads,
K/V heads and ``wo``'s heads cut over the model axis where they divide
(else replicated), the cache cut on its sequence axis, each rank holding a
contiguous span of rows (``_sharded_attention``). A prefill (and the
encoder's uncached, non-causal call) runs the flash kernel on this rank's
heads over the whole prompt; a decode step is the reference's distributed
flash-decode split-K pattern: each rank attends over its span with the
decode kernel's partial entry, and the partials merge by their
log-sum-exp (``_merge_partials``). The cached ``cross_attention`` runs
this rank's q heads over the memory K/V, which every rank holds whole.

The cache differs from the reference in one respect: JAX writes it
functionally (``dynamic_update_slice``); the port writes K/V at ``length``
in place, so a decode step moves no cache bytes it does not attend to.
``length`` is one int32 scalar on the cache's device, shared by the batch;
the host never reads it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.decode_attention import decode_attention as decode_kernel
from ..kernels.decode_attention import decode_attention_partial
from ..kernels.flash_attention import flash_attention
from .common import (apply_mrope, apply_rope, matmul, matmul_f32, rms_norm,
                     rope_table)
from .config import ModelConfig
from .param import ArrayDecl, ones_init

__all__ = ["attention_decls", "attention", "blockwise_attention",
           "cross_attention", "decode_attention", "KVCache", "init_cache"]

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor         # (B, max_len, kv_heads, head_dim)
    v: torch.Tensor         # (B, max_len, kv_heads, head_dim)
    length: torch.Tensor    # () int32 — tokens currently valid


def attention_decls(cfg: ModelConfig, layers: int | None = None) -> dict:
    """Parameter declarations; ``layers`` adds a leading stacked-layer axis."""
    H, Hk, D, M = cfg.n_heads_eff, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    lead = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    decls = {
        "wq": ArrayDecl(lead + (M, H, D), lax_ + ("embed", "heads", "head_dim")),
        "wk": ArrayDecl(lead + (M, Hk, D), lax_ + ("embed", "kv_heads", "head_dim")),
        "wv": ArrayDecl(lead + (M, Hk, D), lax_ + ("embed", "kv_heads", "head_dim")),
        "wo": ArrayDecl(lead + (H, D, M), lax_ + ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        decls["q_norm"] = ArrayDecl(lead + (D,), lax_ + (None,),
                                    init=ones_init)
        decls["k_norm"] = ArrayDecl(lead + (D,), lax_ + (None,),
                                    init=ones_init)
    return decls


# ----------------------------------------------------------------------
def _scale(D: int, dtype: torch.dtype) -> torch.Tensor:
    """1/sqrt(D) in q's dtype: in the reference ``q * scale`` takes the
    Python float weakly typed, so a bf16 q is multiplied by the scale
    rounded to bf16 (at D = 112 or 128 it is not exact: 0.25% off at 112),
    where torch would multiply by the fp32 scale."""
    return torch.tensor(1.0 / math.sqrt(D), dtype=dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_chunk: int, kv_chunk: int,
                        softmax_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Online-softmax attention (the plain path).

    q: (B, Sq, H, D);  k, v: (B, Skv, Hk, D) with H % Hk == 0.
    Returns (B, Sq, H, D). Causal positions count from 0 for queries and
    keys (the cache is empty before a prefill); ``softmax_dtype`` sets the
    score-pipeline dtype (running max and denominator stay fp32). Products accumulate in fp32, as the
    reference's ``preferred_element_type`` asks.
    """
    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    scale = _scale(D, q.dtype)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"chunking must divide: {Sq}%{q_chunk}, "
                         f"{Skv}%{kv_chunk}")
    qr = (q.reshape(B, Sq, Hk, G, D) * scale).to(q.dtype)
    dev = q.device
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qc = qr[:, q0:q0 + q_chunk].float()               # (B, cq, Hk, G, D)
        m = torch.full((B, q_chunk, Hk, G), NEG_INF, device=dev)
        l = torch.zeros((B, q_chunk, Hk, G), device=dev)
        acc = torch.zeros((B, q_chunk, Hk, G, D), device=dev)
        for k0 in range(0, Skv, kv_chunk):
            kc = k[:, k0:k0 + kv_chunk].float()
            vc = v[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qc, kc).to(softmax_dtype)
            if causal:
                qpos = q0 + torch.arange(q_chunk, device=dev)
                kpos = k0 + torch.arange(kv_chunk, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask[None, :, None, None, :], s,
                                torch.tensor(NEG_INF, dtype=s.dtype,
                                             device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1).float())
            p = torch.exp(s - m_new[..., None].to(s.dtype))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1).float()
            pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(vc.dtype).float(),
                              vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, D)


def decode_attention(q: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Single-step attention against a masked fixed-size cache (the plain
    path). q: (B, 1, H, D); cache.k/v: (B, L, Hk, D). Returns (B, 1, H, D)."""
    B, Sq, H, D = q.shape
    L, Hk = cache.k.shape[1], cache.k.shape[2]
    G = H // Hk
    qr = q.reshape(B, Sq, Hk, G, D) * _scale(D, q.dtype)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr.float(), cache.k.float())
    valid = torch.arange(L, device=q.device) < cache.length
    s = torch.where(valid, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p.to(cache.v.dtype).float(),
                       cache.v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               layers: int | None = None,
               device: str | torch.device = "cuda",
               dtype: torch.dtype = torch.bfloat16) -> KVCache:
    """Empty cache of ``dtype``; ``layers`` adds a leading stacked-layer
    axis to K/V (the length stays one scalar)."""
    lead = (layers,) if layers else ()
    shape = lead + (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


# ----------------------------------------------------------------------
def _prefill_core(q, k, v, cfg: ModelConfig,
                  causal: bool = True) -> torch.Tensor:
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, block_q=cfg.q_chunk,
                               block_k=cfg.kv_chunk)
    return blockwise_attention(
        q, k, v, causal=causal, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        softmax_dtype=getattr(torch, cfg.softmax_dtype))


def _decode_core(q, cache: KVCache) -> torch.Tensor:
    """One query token over the cache's first ``length`` rows.

    A cache in another dtype than q (the encoder-decoder's fp32 self
    cache, read by bf16 queries) goes to the kernel of the cache's dtype:
    q is cast up to it, which is exact, and the output back to q's dtype.
    The reference multiplies q by the scale in q's dtype and then promotes
    (``decode_attention``); the kernel multiplies the cast q by the fp32
    scale 1/sqrt(D). At D = 16, 64 and 256 that scale is a power of two
    and the two products are equal bit for bit; at other D the kernel's
    fp32 scale departs from the reference's bf16-rounded one, as the
    Pallas kernels' own does. On the CPU the plain path takes the mixed
    dtypes as the reference does."""
    if q.is_cuda:
        # the kernel tiles the cache itself; one block of the whole cache
        # passes the divisibility check for any capacity
        out = decode_kernel(q.to(cache.k.dtype), cache.k, cache.v,
                            cache.length, block_k=cache.k.shape[1])
        return out.to(q.dtype)
    return decode_attention(q, cache)


def attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              mrope_positions: torch.Tensor | None = None,
              causal: bool = True, cache: KVCache | None = None,
              kv_source: torch.Tensor | None = None, shard=None):
    """Attention sublayer: projections (+ qk-norm) + rope + core (+ the
    padded heads' mask) + output projection. With ``cfg.use_mrope`` and
    ``mrope_positions`` (3, B, S) given, q and k are rotated by M-RoPE at
    those (t, h, w) positions, else by the 1-D RoPE at ``length + s``, as
    the reference chooses. (The reference's explicit 1-D ``positions``
    argument, which no caller of it sets, is not ported.)

    x: (B, S, M).  Modes:
      * cache is None        -> full-sequence (training / uncached prefill),
        causal unless ``causal=False`` (the encoder);
      * cache given, S == 1  -> cached decode step;
      * cache given, S > 1   -> prefill that fills the cache (the cache is
        empty before a prefill, as in the reference).
    ``kv_source`` (B, T, M), an encoder memory, switches to cross-attention:
    q from x, k/v from the memory, no rope, not causal, no cache update.
    Returns (out, new_cache_or_None); the new cache shares the old one's
    K/V buffers, written in place. The cache rows are always ``length ..
    length + S - 1``, whatever positions rotate q and k.
    ``shard`` runs this rank's part of a sharded call
    (:func:`_sharded_attention`: cached, or uncached as the encoder's and
    training's, or over ``kv_source`` uncached, as the encoder-decoder's
    training runs its cross-attention; M-RoPE at ``mrope_positions``, this
    rank's rows, as here).
    """
    if shard is not None:
        return _sharded_attention(params, x, cfg, cache, shard, causal,
                                  mrope_positions, kv_source)
    B, S, M = x.shape
    H, Hk, D = cfg.n_heads_eff, cfg.n_kv_heads, cfg.head_dim
    is_cross = kv_source is not None
    kv_in = kv_source if is_cross else x
    T = kv_in.shape[1]
    # projections as one matmul each: contiguous (B, S, heads, D) results,
    # the layout the kernels read
    q = matmul(x, params["wq"].reshape(M, H * D)).view(B, S, H, D)
    k = matmul(kv_in, params["wk"].reshape(M, Hk * D)).view(B, T, Hk, D)
    v = matmul(kv_in, params["wv"].reshape(M, Hk * D)).view(B, T, Hk, D)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])

    if not is_cross:
        # the tokens' cache rows, and their 1-D positions: length + s, with
        # length read on the device
        rows = torch.arange(S, device=x.device)
        if cache is not None:
            rows = cache.length + rows
        if cfg.use_mrope and mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, D, theta=cfg.rope_theta)
            k = apply_mrope(k, mrope_positions, D, theta=cfg.rope_theta)
        else:
            cos, sin = rope_table(rows, D, cfg.rope_theta)  # (S, D/2)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is not None and not is_cross:
        # in place, at rows length .. length + S - 1, where the reference
        # returns an updated copy
        cache.k.index_copy_(1, rows, k.to(cache.k.dtype))
        cache.v.index_copy_(1, rows, v.to(cache.v.dtype))
        new_cache = KVCache(cache.k, cache.v, cache.length + S)
        if S == 1:
            out = _decode_core(q, new_cache)
        else:
            out = _prefill_core(q, k, v, cfg, causal)
    else:
        out = _prefill_core(q, k, v, cfg, causal and not is_cross)

    if cfg.pad_heads_to:
        # the padded heads ran through the core like the others; zeroing
        # their output makes the layer exact to the table's head count
        mask = (torch.arange(H, device=out.device) < cfg.n_heads)
        out = out * mask.to(out.dtype)[None, None, :, None]
    y = matmul(out.reshape(B, S, H * D), params["wo"].reshape(H * D, M))
    return y, new_cache


def cross_attention(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    memory: KVCache, shard=None) -> torch.Tensor:
    """Cached cross-attention of the encoder-decoder (reference
    ``encdec.py:103-108``): q from x, non-causal attention over the memory
    K/V projected at prefill, then ``wo``. memory.k/v: (B, T, Hk, D);
    memory.length: int32 scalar T on their device, made once with the
    cache.

    As in the reference, this path applies no qk-norm and no padded-heads
    mask, where the uncached ``attention(..., kv_source=...)`` applies both
    (seamless-m4t sets neither, so the two paths compute one function
    there), and the CPU's blockwise path scores in fp32 whatever the
    config's ``softmax_dtype``.

    On the card a prefill (S > 1) runs the flash kernel with S queries over
    T keys, and a decode step (S == 1) the decode kernel with ``length``
    = T; on the CPU both are the blockwise plain path over all T keys.

    With ``shard`` (one rank of a mesh) ``wq`` and ``wo`` are this rank's
    q heads, and the memory, which holds every KV head on every rank (the
    reference's spec), is read at the KV heads they use (:func:`_kv_range`;
    a strided view at decode, copied whole at the prefill); ``wo``'s
    partial products are summed over the model axis (:func:`_out_proj`).
    """
    B, S, M = x.shape
    H, D = cfg.n_heads_eff, cfg.head_dim
    k, v = memory.k, memory.v
    if shard is not None:
        H, kv = shard.heads.size, _kv_range(shard)
        k, v = k[:, :, kv], v[:, :, kv]
    q = matmul(x, params["wq"].reshape(M, H * D)).view(B, S, H, D)
    if not q.is_cuda:
        out = blockwise_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                                  kv_chunk=cfg.kv_chunk)
    elif S == 1:
        out = decode_kernel(q, k, v, memory.length, block_k=k.shape[1])
    else:
        out = flash_attention(q, k.contiguous(), v.contiguous(),
                              causal=False, block_q=cfg.q_chunk,
                              block_k=cfg.kv_chunk)
    return _out_proj(out.reshape(B, S, H * D),
                     params["wo"].reshape(H * D, M), shard)


# ----------------------------------------------------------------------
# one rank of a (data, model) mesh
# ----------------------------------------------------------------------
def _decode_partial_core(q, k, v, length) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """One span's (out fp32 (B, 1, H, D), lse fp32 (B, H)) over its first
    ``length`` rows (0 <= length <= rows): the decode kernel's partial
    entry on the card; on the CPU the plain path of ``decode_attention``
    (q scaled in its dtype, p rounded to the cache's before P.V), with
    out = 0 and lse = -inf over no valid key. q takes the cache's dtype on
    both devices, as the kernel's entries do (one entry a dtype)."""
    if q.dtype != k.dtype:
        raise ValueError(f"q {q.dtype} over a {k.dtype} cache: the partial "
                         f"entry takes one dtype (cast q to the cache's)")
    if q.is_cuda:
        return decode_attention_partial(q, k, v, length)
    B, Sq, H, D = q.shape
    L, Hk = k.shape[1], k.shape[2]
    qr = q.reshape(B, Sq, Hk, H // Hk, D) * _scale(D, q.dtype)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr.float(), k.float())
    valid = torch.arange(L, device=q.device) < length
    s = torch.where(valid, s, torch.tensor(-math.inf, device=q.device))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(valid, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    out = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, D), lse.reshape(B, H)


def _merge_partials(out: torch.Tensor, lse: torch.Tensor,
                    shard) -> torch.Tensor:
    """The model ranks' partials (out (B, 1, H, D), lse (B, H), fp32)
    merged, in fp32: M = max over ranks of lse (one all_reduce), then
    sum_r e^(lse_r - M) out_r / sum_r e^(lse_r - M) (one all_reduce of both
    sums). A span with no valid key has lse -inf, weight 0."""
    B, _, H, D = out.shape
    m = shard.max_(lse.clone())
    w = torch.exp(lse - m)                                   # (B, H)
    sums = torch.cat([(out[:, 0] * w[..., None]).reshape(B, H * D), w],
                     dim=1)
    torch.distributed.all_reduce(sums, group=shard.model_group)
    num, den = sums[:, :H * D].view(B, 1, H, D), sums[:, H * D:]
    return num / den[:, None, :, None]


def _write_token(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                 shard) -> None:
    """The new token's K/V (B, 1, Hk, D), all KV heads, written at global
    row ``length`` by the rank whose span holds it; on every other rank the
    row is rewritten with its own value. A masked write: ``length`` is read
    on the device only."""
    row = cache.length - shard.seq.start
    inside = (row >= 0) & (row < shard.seq.size)
    index = row.clamp(0, shard.seq.size - 1).reshape(1).long()
    for buf, new in ((cache.k, k), (cache.v, v)):
        old = buf.index_select(1, index)
        buf.index_copy_(1, index, torch.where(inside, new.to(buf.dtype), old))


def _kv_range(shard) -> slice:
    """The KV heads that this rank's q heads read (one, or whole groups),
    in the full head order."""
    G = shard.heads.total // shard.kv_heads.total
    return slice(shard.heads.start // G, (shard.heads.stop - 1) // G + 1)


def _out_proj(out: torch.Tensor, wo: torch.Tensor, shard) -> torch.Tensor:
    """``out @ wo``; over this rank's rows of ``wo`` (its heads cut over
    the model axis) the fp32 partials are summed over the model axis and
    rounded once."""
    if shard is not None and shard.heads.sharded:
        return shard.reduce_sum(matmul_f32(out, wo),
                                torch.promote_types(out.dtype, wo.dtype))
    return matmul(out, wo)


def _sharded_attention(params: dict, x: torch.Tensor, cfg: ModelConfig,
                       cache: KVCache | None, shard, causal: bool = True,
                       mrope_positions: torch.Tensor | None = None,
                       kv_source: torch.Tensor | None = None):
    """One rank's share of an attention call: x (B_local, S, M), params
    this rank's shards (q heads ``shard.heads``, K/V heads
    ``shard.kv_heads``), cache None (the encoder's uncached call, causal
    or not) or its span ``shard.seq`` of rows (B_local, rows, Hk, D) with
    the global ``length``.

    * Uncached: the flash kernel on this rank's q heads and the KV heads
      they read, which are among its own (the KV heads are cut as the q
      heads' groups, or whole on every rank); no collective but ``wo``'s.
      With ``kv_source`` (B_local, T, M), an encoder memory alike on every
      model rank, the cross-attention of the reference's mode: the rank's
      KV heads projected from the memory through its columns of ``wk``
      and ``wv``, no RoPE, not causal, no cache, and no gather (each
      rank's q heads read only the KV heads among its own).
    * Prefill (S > 1; the cache is empty before it, as in the reference):
      the flash kernel runs on this rank's q heads and the K/V heads they
      read, over the whole prompt; the prompt's K/V for every KV head
      (gathered over the model axis where the heads are cut) goes into the
      rows of this rank's span.
    * Decode (S == 1): the new token's K/V goes into global row
      ``length`` (:func:`_write_token`); q for every head goes to every
      rank, in the cache's dtype (the encoder-decoder's fp32 self cache
      takes a bf16 q cast up, exact, as ``_decode_core`` casts it); each
      rank attends over its span's valid rows, ``clamp(length + 1 -
      start, 0, rows)`` made on the device, with the decode kernel's
      partial entry; the partials merge by their log-sum-exp.

    This rank's heads of the output go through its rows of ``wo``, summed
    in fp32 over the model axis where the heads are cut and rounded once.
    Where the heads are cut, ``x`` (and ``kv_source``, in the same
    all_reduce) enters through ``shard.enter``: under grad (training,
    uncached) the gradient of each, its rank's heads' part, is summed over
    the model axis; ``wo``'s sum passes the gradient whole to every
    rank. q and k rotate by M-RoPE at ``mrope_positions``
    (3, B_local, S) where the config uses it and they are given (each
    rank's heads at its rows' positions), else by the 1-D RoPE at the
    cache rows. Returns (y, new cache or None)."""
    B, S, M = x.shape
    D = cfg.head_dim
    Hl, Hkl = shard.heads.size, shard.kv_heads.size
    cross = kv_source is not None
    if cross and cache is not None:
        raise ValueError("kv_source takes no cache (the cached "
                         "cross-attention is cross_attention)")
    kv_in = kv_source if cross else x
    if shard.heads.sharded:
        if cross:
            x, kv_in = shard.enter(x, kv_in)
        else:
            x = kv_in = shard.enter(x)
    T = kv_in.shape[1]
    q = matmul(x, params["wq"].reshape(M, Hl * D)).view(B, S, Hl, D)
    k = matmul(kv_in, params["wk"].reshape(M, Hkl * D)).view(B, T, Hkl, D)
    v = matmul(kv_in, params["wv"].reshape(M, Hkl * D)).view(B, T, Hkl, D)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    rows = torch.arange(S, device=x.device)
    if cache is not None:
        rows = cache.length + rows
    if not cross:           # the reference rotates no cross-attention
        if cfg.use_mrope and mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, D, theta=cfg.rope_theta)
            k = apply_mrope(k, mrope_positions, D, theta=cfg.rope_theta)
        else:
            cos, sin = rope_table(rows, D, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
    span, kv = shard.seq, _kv_range(shard)
    if cache is None:
        own = slice(kv.start - shard.kv_heads.start,
                    kv.stop - shard.kv_heads.start)
        out = _prefill_core(q, k[:, :, own].contiguous(),
                            v[:, :, own].contiguous(), cfg,
                            causal and not cross)
    elif S == 1:
        # every KV head's K/V (the cache holds them all) and every head's
        # q, in one gather
        q_all, k, v = shard.gather((q, 2, shard.heads), (k, 2, shard.kv_heads),
                                   (v, 2, shard.kv_heads))
        _write_token(cache, k, v, shard)
        local_len = (cache.length + 1 - span.start).clamp(0, span.size) \
            .to(torch.int32)
        out, lse = _decode_partial_core(q_all.to(cache.k.dtype), cache.k,
                                        cache.v, local_len)
        out = _merge_partials(out, lse, shard)[:, :, shard.heads.slice()]
        out = out.to(q.dtype)
    else:
        # every KV head's K/V: the cache holds them all
        k, v = shard.gather((k, 2, shard.kv_heads), (v, 2, shard.kv_heads))
        n = max(0, min(S, span.stop) - span.start)
        if n:
            cache.k[:, :n] = k[:, span.start:span.start + n]
            cache.v[:, :n] = v[:, span.start:span.start + n]
        out = _prefill_core(q, k[:, :, kv].contiguous(),
                            v[:, :, kv].contiguous(), cfg, causal)
    if cfg.pad_heads_to:
        mask = torch.arange(shard.heads.start, shard.heads.stop,
                            device=out.device) < cfg.n_heads
        out = out * mask.to(out.dtype)[None, None, :, None]
    y = _out_proj(out.reshape(B, S, Hl * D),
                  params["wo"].reshape(Hl * D, M), shard)
    if cache is None:
        return y, None
    return y, KVCache(cache.k, cache.v, cache.length + S)
