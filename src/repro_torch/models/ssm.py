"""Mamba-2 (SSD, state-space duality) block: chunked scan + cached decode.

Port of ``repro/models/ssm.py``. The sequence is cut into chunks; within a
chunk the dual quadratic (attention-like) form is used, and an fp32
(heads, head_dim, state) recurrent state is carried across chunks:

* prefill and the uncached forward run the scan through
  ``repro_torch.kernels.ssd``: the hand-written CUDA kernel on CUDA tensors
  (under grad, in training, with the CUDA backward kernel as its gradient),
  the plain chunked scan (``ssd_chunked``, kept in ``kernels/ssd/ref.py``)
  on CPU tensors;
* decode is the O(1) recurrence ``h <- h*exp(dt*A) + dt*x(x)B;  y = h.C``
  with rolling buffers for the short causal conv, plain PyTorch on both
  devices (the reference has no kernel for it either).

The cache differs from the reference in one respect: JAX returns an updated
copy; the port writes the state and the conv tails into the cache's buffers
in place (prefill's kernel writes the final state straight into them), and
returns a cache that holds the same buffers.

With ``shard`` (a ``sharding.layout.ShardLayout``, one rank of a (data,
model) mesh, ``runtime/serve_lib.py``'s steps) whose ``ssm_heads`` are cut
over the model axis, the block is head parallel, as the reference's specs
cut it (:func:`_sharded_mamba`): the rank runs its heads, the ssd kernel
on them at the prefill and in training, and two collectives a call.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels.ssd import ssd
from ..kernels.ssd.ref import segsum as _segsum, ssd_chunked
from .common import matmul, matmul_f32, rms_norm, silu, softplus
from .config import ModelConfig
from .param import ArrayDecl, normal_init, ones_init

__all__ = ["ssm_decls", "SSMCache", "init_ssm_cache", "mamba_block",
           "ssd_chunked", "ssd_decode_step"]


class SSMCache(NamedTuple):
    state: torch.Tensor     # (B, H, P, N) fp32 recurrent state
    conv_x: torch.Tensor    # (B, K-1, DI) conv tail for x
    conv_B: torch.Tensor    # (B, K-1, N)
    conv_C: torch.Tensor    # (B, K-1, N)


def _dt_bias_init(gen, shape, dtype):
    # dt log-uniform in [1e-3, 1e-1], stored as its inverse softplus
    u = torch.rand(shape, generator=gen, device=gen.device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return (dt + torch.log(-torch.expm1(-dt))).to(dtype)


def _a_log_init(gen, shape, dtype):
    a = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=gen.device)
    return torch.log(a).expand(shape).to(dtype).contiguous()


def ssm_decls(cfg: ModelConfig, layers: int | None = None) -> dict:
    M, DI = cfg.d_model, cfg.d_inner
    H, N, K = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv
    lead = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    return {
        "w_z": ArrayDecl(lead + (M, DI), lax_ + ("embed", "ssm_inner")),
        "w_x": ArrayDecl(lead + (M, DI), lax_ + ("embed", "ssm_inner")),
        "w_B": ArrayDecl(lead + (M, N), lax_ + ("embed", None)),
        "w_C": ArrayDecl(lead + (M, N), lax_ + ("embed", None)),
        "w_dt": ArrayDecl(lead + (M, H), lax_ + ("embed", "ssm_heads")),
        "dt_bias": ArrayDecl(lead + (H,), lax_ + ("ssm_heads",),
                             dtype=torch.float32, init=_dt_bias_init),
        "A_log": ArrayDecl(lead + (H,), lax_ + ("ssm_heads",),
                           dtype=torch.float32, init=_a_log_init),
        "D": ArrayDecl(lead + (H,), lax_ + ("ssm_heads",),
                       dtype=torch.float32, init=ones_init),
        "conv_x": ArrayDecl(lead + (K, DI), lax_ + (None, "ssm_inner"),
                            init=normal_init(0.1)),
        "conv_B": ArrayDecl(lead + (K, N), lax_ + (None, None),
                            init=normal_init(0.1)),
        "conv_C": ArrayDecl(lead + (K, N), lax_ + (None, None),
                            init=normal_init(0.1)),
        "norm": ArrayDecl(lead + (DI,), lax_ + ("ssm_inner",),
                          init=ones_init),
        "out_proj": ArrayDecl(lead + (DI, M), lax_ + ("ssm_inner", "embed")),
    }


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32, *,
                   layers: int | None = None,
                   device: str | torch.device = "cuda") -> SSMCache:
    """Zero cache (fp32 by default, as the reference's); ``layers`` adds a
    leading stacked-layer axis."""
    H, P, N, K = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_conv)
    lead = (layers,) if layers else ()

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)
    return SSMCache(state=zeros(batch, H, P, N),
                    conv_x=zeros(batch, K - 1, cfg.d_inner),
                    conv_B=zeros(batch, K - 1, N),
                    conv_C=zeros(batch, K - 1, N))


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 tail: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv via K shifted adds. u: (B, S, C); w: (K, C)."""
    K = w.shape[0]
    if tail is None:
        pad = torch.zeros((u.shape[0], K - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = tail.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                   # (B, S+K-1, C)
    S = u.shape[1]
    out = torch.zeros_like(u)
    for j in range(K):
        out = out + full[:, j:j + S] * w[j]
    return out


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor):
    """One-token recurrence. x: (B, H, P); dt: (B, H); Bm, Cm: (B, N);
    state: (B, H, P, N) fp32. Returns (y, new_state)."""
    dt32 = dt.float()
    dA = torch.exp(dt32 * A)                              # (B, H)
    xdt = x.float() * dt32[..., None]                     # (B, H, P)
    upd = torch.einsum("bhp,bn->bhpn", xdt, Bm.float())
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    return y.to(x.dtype), new_state


# ----------------------------------------------------------------------
def mamba_block(params: dict, u: torch.Tensor, cfg: ModelConfig, *,
                cache: SSMCache | None = None, shard=None):
    """Full Mamba-2 block. u: (B, S, M) -> (out, cache_or_None).

    Modes: no cache (forward); cache with S > 1 (prefill from the cache's
    state and conv tails); cache with S == 1 (decode). With a cache, its
    buffers are updated in place and returned as the new cache. ``shard``
    with the heads cut: this rank's part of the call, cached or not
    (:func:`_sharded_mamba`)."""
    if shard is not None and shard.ssm_heads.sharded:
        return _sharded_mamba(params, u, cfg, cache, shard)
    Bb, S, M = u.shape
    H, P, K = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_conv
    z = matmul(u, params["w_z"])
    x = matmul(u, params["w_x"])
    Bm = matmul(u, params["w_B"])
    Cm = matmul(u, params["w_C"])
    dt_raw = matmul(u, params["w_dt"])
    dt = softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                      # (H,) negative

    if cache is not None and S == 1:
        # conv via rolling buffers, in the cache's dtype (fp32)
        cx = torch.cat([cache.conv_x, x.to(cache.conv_x.dtype)], 1)
        cB = torch.cat([cache.conv_B, Bm.to(cache.conv_B.dtype)], 1)
        cC = torch.cat([cache.conv_C, Cm.to(cache.conv_C.dtype)], 1)
        xc = torch.einsum("bkd,kd->bd", cx, params["conv_x"].to(cx.dtype))
        Bc = torch.einsum("bkn,kn->bn", cB, params["conv_B"].to(cB.dtype))
        Cc = torch.einsum("bkn,kn->bn", cC, params["conv_C"].to(cC.dtype))
        xa, Ba, Ca = silu(xc), silu(Bc), silu(Cc)
        xh = xa.reshape(Bb, H, P)
        y, new_state = ssd_decode_step(xh, dt[:, 0], A, Ba, Ca, cache.state)
        y = y + params["D"][:, None] * xh.float()
        y = y.reshape(Bb, 1, H * P)
        cache.state.copy_(new_state)
        cache.conv_x.copy_(cx[:, 1:])
        cache.conv_B.copy_(cB[:, 1:])
        cache.conv_C.copy_(cC[:, 1:])
    else:
        tail = (cache.conv_x, cache.conv_B, cache.conv_C) \
            if cache is not None else (None, None, None)
        xa = silu(_causal_conv(x, params["conv_x"].to(x.dtype), tail[0]))
        Ba = silu(_causal_conv(Bm, params["conv_B"].to(Bm.dtype), tail[1]))
        Ca = silu(_causal_conv(Cm, params["conv_C"].to(Cm.dtype), tail[2]))
        xh = xa.reshape(Bb, S, H, P)
        state0 = cache.state if cache is not None else None
        # on CUDA the kernel reads the cached state and writes the final
        # one over it
        y, _ = ssd(xh, dt, A, Ba, Ca, chunk=min(cfg.q_chunk, 256),
                   state0=state0, state_out=state0)
        y = y + params["D"][None, None, :, None] * xh
        y = y.reshape(Bb, S, H * P)
        if cache is not None:
            cache.conv_x.copy_(x[:, -(K - 1):])
            cache.conv_B.copy_(Bm[:, -(K - 1):])
            cache.conv_C.copy_(Cm[:, -(K - 1):])

    y = y.to(u.dtype)
    y = rms_norm(y * silu(z), params["norm"])
    out = matmul(y, params["out_proj"])
    return out.to(u.dtype), cache


# ----------------------------------------------------------------------
# one rank of a (data, model) mesh
# ----------------------------------------------------------------------
def _norm_and_tail(g: torch.Tensor, new_x: torch.Tensor,
                   shard) -> tuple[torch.Tensor, torch.Tensor]:
    """One all_reduce for two things: the gated norm's mean square over
    the whole ``d_inner`` (g (B, S, local columns) fp32, the rank's sum of
    squares summed over the model ranks, over the full width), and the
    conv tail's new x columns (new_x (B, n, local columns)) gathered to
    every column, in fp32 (exact for bf16). -> (mean square (B, S, 1),
    x (B, n, d_inner) fp32)."""
    total, (x_full,) = shard.sum_with(g.square().sum(dim=-1, keepdim=True),
                                      (new_x, 2, shard.ssm_inner))
    return total / shard.ssm_inner.total, x_full


def _sharded_mamba(params: dict, u: torch.Tensor, cfg: ModelConfig,
                   cache: SSMCache | None, shard):
    """One rank's share of a Mamba-2 call (the reference's
    ``mamba_block`` under its specs): params this rank's slices, its
    ``shard.ssm_inner`` columns of ``w_z``, ``w_x``, ``conv_x`` and
    ``norm``, its rows of ``out_proj``, its ``shard.ssm_heads`` of
    ``w_dt``, ``dt_bias``, ``A_log`` and ``D``, and ``w_B``, ``w_C``,
    ``conv_B``, ``conv_C`` whole (one group, shared by every head); cache
    its heads' state (B, local heads, P, N) and every column of the conv
    tails, which the reference's spec keeps alike on every model rank.

    The prefill runs the ssd kernel on the rank's heads, from its state
    shard into it; a decode step the recurrence on them. The gated
    RMSNorm is over the whole ``d_inner``, and the rank's new x columns
    go to every rank's conv tail, in one all_reduce
    (:func:`_norm_and_tail`); ``out_proj`` is row parallel, its fp32
    partials summed over the model axis and rounded once: two collectives
    a call.

    Without a cache (training, under grad) the conv starts from zeros and
    the ssd kernel from a zero state, keeping its chunk states for its
    backward; the norm's sum of squares is summed over the model axis by
    ``shard.sum_partials``, whose backward is that sum too (each rank
    normalises its own columns by the total), and ``u`` enters through
    ``shard.enter``: every projection reads it, and the rank's heads use
    ``w_B``/``w_C`` and their convs, whole on every rank, for their own
    part, so those weights' gradients are parts as well (the sharded train
    step sums them over the model axis)."""
    Bb, S, M = u.shape
    P, K = cfg.ssm_head_dim, cfg.ssm_conv
    H, cols = shard.ssm_heads.size, shard.ssm_inner.slice()
    u = shard.enter(u)
    z = matmul(u, params["w_z"])
    x = matmul(u, params["w_x"])
    Bm = matmul(u, params["w_B"])
    Cm = matmul(u, params["w_C"])
    dt = softplus(matmul(u, params["w_dt"]).float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    if cache is None:
        xh = silu(_causal_conv(x, params["conv_x"].to(x.dtype))).reshape(
            Bb, S, H, P)
        Ba = silu(_causal_conv(Bm, params["conv_B"].to(Bm.dtype)))
        Ca = silu(_causal_conv(Cm, params["conv_C"].to(Cm.dtype)))
        y, _ = ssd(xh, dt, A, Ba, Ca, chunk=min(cfg.q_chunk, 256))
        y = (y + params["D"][None, None, :, None] * xh).reshape(Bb, S, H * P)
        g = y.to(u.dtype) * silu(z)
        ms = shard.sum_partials(g.float().square().sum(dim=-1, keepdim=True)) \
            / shard.ssm_inner.total
        return _gated_out(g, ms, params, shard).to(u.dtype), None
    if S == 1:
        cx = torch.cat([cache.conv_x[:, :, cols],
                        x.to(cache.conv_x.dtype)], 1)
        cB = torch.cat([cache.conv_B, Bm.to(cache.conv_B.dtype)], 1)
        cC = torch.cat([cache.conv_C, Cm.to(cache.conv_C.dtype)], 1)
        xc = torch.einsum("bkd,kd->bd", cx, params["conv_x"].to(cx.dtype))
        Bc = torch.einsum("bkn,kn->bn", cB, params["conv_B"].to(cB.dtype))
        Cc = torch.einsum("bkn,kn->bn", cC, params["conv_C"].to(cC.dtype))
        xh = silu(xc).reshape(Bb, H, P)
        y, new_state = ssd_decode_step(xh, dt[:, 0], A, silu(Bc), silu(Cc),
                                       cache.state)
        y = (y + params["D"][:, None] * xh.float()).reshape(Bb, 1, H * P)
        cache.state.copy_(new_state)
        cache.conv_B.copy_(cB[:, 1:])
        cache.conv_C.copy_(cC[:, 1:])
        new_x = x
    else:
        xa = silu(_causal_conv(x, params["conv_x"].to(x.dtype),
                               cache.conv_x[:, :, cols]))
        Ba = silu(_causal_conv(Bm, params["conv_B"].to(Bm.dtype),
                               cache.conv_B))
        Ca = silu(_causal_conv(Cm, params["conv_C"].to(Cm.dtype),
                               cache.conv_C))
        xh = xa.reshape(Bb, S, H, P)
        y, _ = ssd(xh, dt, A, Ba, Ca, chunk=min(cfg.q_chunk, 256),
                   state0=cache.state, state_out=cache.state)
        y = (y + params["D"][None, None, :, None] * xh).reshape(Bb, S, H * P)
        cache.conv_B.copy_(Bm[:, -(K - 1):])
        cache.conv_C.copy_(Cm[:, -(K - 1):])
        new_x = x[:, -(K - 1):]
    g = y.to(u.dtype) * silu(z)
    ms, x_full = _norm_and_tail(g.float(), new_x, shard)
    if S == 1:
        x_full = torch.cat([cache.conv_x[:, 1:],
                            x_full.to(cache.conv_x.dtype)], 1)
    cache.conv_x.copy_(x_full)
    return _gated_out(g, ms, params, shard).to(u.dtype), cache


def _gated_out(g: torch.Tensor, ms: torch.Tensor, params: dict,
               shard) -> torch.Tensor:
    """``common.rms_norm`` of the rank's gated columns ``g`` with the whole
    width's mean square ``ms``, then the row-parallel ``out_proj``: its
    fp32 partials summed over the model axis and rounded once."""
    y = (g.float() * torch.rsqrt(ms + 1e-6)
         * params["norm"].float()).to(g.dtype)
    return shard.reduce_sum(matmul_f32(y, params["out_proj"]),
                            torch.promote_types(y.dtype,
                                                params["out_proj"].dtype))
