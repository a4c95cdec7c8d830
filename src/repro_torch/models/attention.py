"""GQA attention: blockwise (flash-style) prefill + cached decode.

Port of ``repro/models/attention.py``. The two attention cores run the
hand-written CUDA kernels on CUDA tensors (``repro_torch.kernels``) and the
plain versions below on CPU tensors:

* ``blockwise_attention`` — online softmax over query and KV chunks, the
  JAX package's algorithm, step for step;
* ``decode_attention``    — one query token against the cache, masked to
  its valid length.

Under grad on the card (training), the flash kernel runs inside an autograd
Function whose backward is the hand-written backward kernel; on the CPU
autograd differentiates the plain path op by op.

GQA stays ungrouped on both paths: Q is viewed as (kv_heads, group) and K/V
are never repeated. Head h maps to (h // G, h % G), as in the reference.

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
from ..kernels.flash_attention import flash_attention
from .common import apply_rope, matmul, rms_norm, rope_table
from .config import ModelConfig
from .param import ArrayDecl, ones_init

__all__ = ["attention_decls", "attention", "blockwise_attention",
           "decode_attention", "KVCache", "init_cache"]

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor         # (B, max_len, kv_heads, head_dim)
    v: torch.Tensor         # (B, max_len, kv_heads, head_dim)
    length: torch.Tensor    # () int32 — tokens currently valid


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.use_mrope:
        raise NotImplementedError("M-RoPE: ROADMAP item A.7")


def attention_decls(cfg: ModelConfig, layers: int | None = None) -> dict:
    """Parameter declarations; ``layers`` adds a leading stacked-layer axis."""
    _check_supported(cfg)
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
               device: str | torch.device = "cuda") -> KVCache:
    """Empty bf16 cache; ``layers`` adds a leading stacked-layer axis to K/V
    (the length stays one scalar)."""
    lead = (layers,) if layers else ()
    shape = lead + (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        v=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


# ----------------------------------------------------------------------
def _prefill_core(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    if q.is_cuda:
        return flash_attention(q, k, v, causal=True, block_q=cfg.q_chunk,
                               block_k=cfg.kv_chunk)
    return blockwise_attention(
        q, k, v, causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        softmax_dtype=getattr(torch, cfg.softmax_dtype))


def _decode_core(q, cache: KVCache) -> torch.Tensor:
    if q.is_cuda:
        # the kernel tiles the cache itself; one block of the whole cache
        # passes the divisibility check for any capacity
        return decode_kernel(q, cache.k, cache.v, cache.length,
                             block_k=cache.k.shape[1])
    return decode_attention(q, cache)


def attention(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              cache: KVCache | None = None):
    """Causal self-attention sublayer: projections (+ qk-norm) + rope + core
    (+ the padded heads' mask) + output projection. (The reference's
    cross-attention, explicit positions and M-RoPE serve families the port
    has not taken over yet.)

    x: (B, S, M).  Modes:
      * cache is None        -> full-sequence (training / uncached prefill);
      * cache given, S == 1  -> cached decode step;
      * cache given, S > 1   -> prefill that fills the cache (the cache is
        empty before a prefill, as in the reference).
    Returns (out, new_cache_or_None); the new cache shares the old one's
    K/V buffers, written in place.
    """
    _check_supported(cfg)
    B, S, M = x.shape
    H, Hk, D = cfg.n_heads_eff, cfg.n_kv_heads, cfg.head_dim
    # projections as one matmul each: contiguous (B, S, heads, D) results,
    # the layout the kernels read
    q = matmul(x, params["wq"].reshape(M, H * D)).view(B, S, H, D)
    k = matmul(x, params["wk"].reshape(M, Hk * D)).view(B, S, Hk, D)
    v = matmul(x, params["wv"].reshape(M, Hk * D)).view(B, S, Hk, D)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])

    positions = torch.arange(S, device=x.device)
    if cache is not None:
        positions = cache.length + positions
    cos, sin = rope_table(positions, D, cfg.rope_theta)      # (S, D/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is not None:
        # in place, at rows length .. length + S - 1, where the reference
        # returns an updated copy
        cache.k.index_copy_(1, positions, k.to(cache.k.dtype))
        cache.v.index_copy_(1, positions, v.to(cache.v.dtype))
        new_cache = KVCache(cache.k, cache.v, cache.length + S)
        if S == 1:
            out = _decode_core(q, new_cache)
        else:
            out = _prefill_core(q, k, v, cfg)
    else:
        out = _prefill_core(q, k, v, cfg)

    if cfg.pad_heads_to:
        # the padded heads ran through the core like the others; zeroing
        # their output makes the layer exact to the table's head count
        mask = (torch.arange(H, device=out.device) < cfg.n_heads)
        out = out * mask.to(out.dtype)[None, None, :, None]
    y = matmul(out.reshape(B, S, H * D), params["wo"].reshape(H * D, M))
    return y, new_cache
