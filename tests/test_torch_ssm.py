"""The port's Mamba-2 layer (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), function by function, on the same numpy
inputs; and the scan's own properties (tests/test_models.py:166-199).

JAX runs op by op here (``jax.disable_jit()``), so both sides round at the
same places. Tolerances, relative to the largest magnitude of the
reference:

* fp32 element-wise results (softplus, the conv): 1e-6, libm rounding;
* fp32 contractions (the scan, the decode step): 1e-5, sums taken in
  another order over up to a few hundred terms;
* bf16 results of the same ops, the whole block's output included: 2^-8,
  one bf16 ulp (the block's fp32 sums, taken in another order, may move a
  bf16 rounding by one ulp);
* the cache's fp32 members after the block: 1e-5, as the scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import ssm as tssm
from repro_torch.models.common import softplus
from repro_torch.models.param import params_from_numpy

FP32, SUM, BF16 = 1e-6, 1e-5, 2.0 ** -8
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def to_torch(a):
    return params_from_numpy({"a": np.asarray(a)}, "cpu")["a"]


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_err(ref, got) -> float:
    ref, got = f32(ref), f32(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def scan_inputs(seed, B, S, H, P, N, dtype="float32", dt_dtype="float32"):
    """x, dt, A, B, C as (jax, torch) pairs with identical bits: dt a
    softplus of a normal draw, A = -exp(normal), as the reference tests."""
    rng = np.random.default_rng(seed)
    arrays = [
        jnp.asarray(rng.standard_normal((B, S, H, P)), DTYPES[dtype]),
        jnp.asarray(np.logaddexp(rng.standard_normal((B, S, H)), 0),
                    DTYPES[dt_dtype]),
        jnp.asarray(-np.exp(rng.standard_normal(H)), jnp.float32),
        jnp.asarray(rng.standard_normal((B, S, N)), DTYPES[dtype]),
        jnp.asarray(rng.standard_normal((B, S, N)), DTYPES[dtype]),
    ]
    return [(a, to_torch(a)) for a in arrays]


def test_softplus_matches_jax():
    # both sides of F.softplus's threshold (20), where it would differ
    x = jnp.asarray(np.random.default_rng(0).standard_normal(4096) * 30,
                    jnp.float32)
    got = softplus(to_torch(x))
    assert got.dtype == torch.float32
    assert rel_err(jax.nn.softplus(x), got) <= FP32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(dtype, with_tail):
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal((2, 9, 24)), DTYPES[dtype])
    w = jnp.asarray(rng.standard_normal((4, 24)) * 0.5, DTYPES[dtype])
    tail = jnp.asarray(rng.standard_normal((2, 3, 24)), jnp.float32) \
        if with_tail else None
    ref = jssm._causal_conv(u, w, tail)
    got = tssm._causal_conv(to_torch(u), to_torch(w),
                            to_torch(tail) if with_tail else None)
    assert got.dtype == to_torch(u).dtype and tuple(got.shape) == ref.shape
    assert rel_err(ref, got) <= (FP32 if dtype == "float32" else BF16)


def test_segsum_matches_jax():
    logd = jnp.asarray(-np.abs(np.random.default_rng(2).standard_normal(
        (2, 3, 16))), jnp.float32)
    ref, got = f32(jssm._segsum(logd)), f32(tssm._segsum(to_torch(logd)))
    assert np.array_equal(np.isneginf(ref), np.isneginf(got))
    lower = np.isfinite(ref)
    assert np.isneginf(ref[..., 0, 1]).all() and lower[..., 1, 0].all()
    assert np.abs(ref[lower] - got[lower]).max() <= FP32 * np.abs(
        ref[lower]).max()


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype,dt_dtype,chunk", [
    ("float32", "float32", 8),
    ("float32", "float32", 32),
    ("bfloat16", "float32", 16),    # as the model passes them
])
def test_ssd_chunked_matches_jax(with_state, dtype, dt_dtype, chunk):
    B, S, H, P, N = 2, 32, 4, 8, 16
    (xj, xt), (dj, dtt), (aj, at), (bj, bt), (cj, ct) = scan_inputs(
        3, B, S, H, P, N, dtype, dt_dtype)
    s0 = jnp.asarray(np.random.default_rng(4).standard_normal(
        (B, H, P, N)), jnp.float32) if with_state else None
    y_ref, st_ref = jssm.ssd_chunked(xj, dj, aj, bj, cj, chunk, state0=s0)
    y, st = tssm.ssd_chunked(xt, dtt, at, bt, ct, chunk,
                             state0=to_torch(s0) if with_state else None)
    assert y.dtype == xt.dtype and st.dtype == torch.float32
    assert tuple(y.shape) == y_ref.shape and tuple(st.shape) == st_ref.shape
    assert rel_err(y_ref, y) <= (SUM if dtype == "float32" else BF16)
    assert rel_err(st_ref, st) <= SUM


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(5)
    B, H, P, N = 2, 4, 8, 16
    x = jnp.asarray(rng.standard_normal((B, H, P)), jnp.float32)
    dt = jnp.asarray(np.logaddexp(rng.standard_normal((B, H)), 0),
                     jnp.float32)
    A = jnp.asarray(-np.exp(rng.standard_normal(H)), jnp.float32)
    Bm = jnp.asarray(rng.standard_normal((B, N)), jnp.float32)
    Cm = jnp.asarray(rng.standard_normal((B, N)), jnp.float32)
    state = jnp.asarray(rng.standard_normal((B, H, P, N)), jnp.float32)
    y_ref, st_ref = jssm.ssd_decode_step(x, dt, A, Bm, Cm, state)
    y, st = tssm.ssd_decode_step(*(to_torch(a) for a in
                                   (x, dt, A, Bm, Cm, state)))
    assert rel_err(y_ref, y) <= SUM and rel_err(st_ref, st) <= SUM


# ----------------------------------------------------------------------
def _block(seed):
    """One mamba block of the reduced mamba2-370m config: the JAX params
    and the same params carried across."""
    jcfg = jax_get_config("mamba2-370m", reduced=True)
    params_j = jax_init_params(jssm.ssm_decls(jcfg), jax.random.key(seed))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return jcfg, params_j, get_config("mamba2-370m", reduced=True), params_t


def _caches(jcfg, cfg, batch, seed=None):
    """A zero cache on both sides, or (seed given) one of random state and
    conv tails."""
    jc = jssm.init_ssm_cache(jcfg, batch)
    if seed is not None:
        rng = np.random.default_rng(seed)
        jc = jssm.SSMCache(*(jnp.asarray(rng.standard_normal(a.shape) * 0.5,
                                         a.dtype) for a in jc))
    tc = tssm.SSMCache(*(to_torch(a) for a in jc))
    zeros = tssm.init_ssm_cache(cfg, batch, device="cpu")
    assert all(t.shape == z.shape and t.dtype == z.dtype == torch.float32
               for t, z in zip(tc, zeros))
    return jc, tc


def _check_cache(jc, tc, tol):
    for name, ref, got in zip(jssm.SSMCache._fields, jc, tc):
        assert tuple(got.shape) == ref.shape, name
        assert got.dtype == torch.float32, name
        assert rel_err(ref, got) <= tol, name


@pytest.mark.parametrize("seed", [0, 1])
def test_mamba_block_uncached_matches_jax(seed):
    jcfg, pj, cfg, pt = _block(seed)
    u = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (2, 16, cfg.d_model)), jnp.bfloat16)
    with jax.disable_jit():
        ref, ref_cache = jssm.mamba_block(pj, u, jcfg)
    got, cache = tssm.mamba_block(pt, to_torch(u), cfg)
    assert ref_cache is None and cache is None
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    assert rel_err(ref, got) <= BF16


@pytest.mark.parametrize("cache_seed", [None, 7])
def test_mamba_block_prefill_then_decode_match_jax(cache_seed):
    """Cached prefill (S > 1) from a zero or a random cache, then two
    decode steps (S == 1): outputs and every member of the cache."""
    jcfg, pj, cfg, pt = _block(0)
    rng = np.random.default_rng(8)
    u = jnp.asarray(rng.standard_normal((2, 16, cfg.d_model)), jnp.bfloat16)
    steps = [jnp.asarray(rng.standard_normal((2, 1, cfg.d_model)),
                         jnp.bfloat16) for _ in range(2)]
    jc, tc = _caches(jcfg, cfg, 2, cache_seed)
    buffers = [t.data_ptr() for t in tc]
    for inp in [u] + steps:
        with jax.disable_jit():
            ref, jc = jssm.mamba_block(pj, inp, jcfg, cache=jc)
        got, tc = tssm.mamba_block(pt, to_torch(inp), cfg, cache=tc)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
        assert rel_err(ref, got) <= BF16
        _check_cache(jc, tc, SUM)
        # updated in place: the returned cache holds the same buffers
        assert [t.data_ptr() for t in tc] == buffers


def test_ssd_chunked_matches_sequential():
    B, S, H, P, N = 2, 32, 4, 8, 16
    x, dt, A, Bm, Cm = (t for _, t in scan_inputs(0, B, S, H, P, N))
    state = torch.zeros(B, H, P, N)
    ys = []
    for t in range(S):
        yt, state = tssm.ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t],
                                         Cm[:, t], state)
        ys.append(yt)
    y_ref = torch.stack(ys, 1)
    for chunk in (4, 8, 32):
        y, st = tssm.ssd_chunked(x, dt, A, Bm, Cm, chunk)
        assert rel_err(y_ref, y) < 1e-4
        assert rel_err(state, st) < 1e-4


def test_ssd_state_decay_bounds():
    """With very negative A the state forgets; with A ~ 0 it accumulates."""
    B, S, H, P, N = 1, 16, 1, 4, 4
    x = torch.ones(B, S, H, P)
    dt = torch.ones(B, S, H)
    Bm = Cm = torch.ones(B, S, N)
    _, st_forget = tssm.ssd_chunked(x, dt, torch.tensor([-20.0]), Bm, Cm, 8)
    _, st_keep = tssm.ssd_chunked(x, dt, torch.tensor([-1e-4]), Bm, Cm, 8)
    assert float(st_forget.abs().max()) < 1.5       # only the last token
    assert float(st_keep.abs().max()) > 10.0        # ~S accumulated


def test_ssd_chunked_rejects_bad_chunk():
    x, dt, A, Bm, Cm = (t for _, t in scan_inputs(0, 1, 24, 2, 4, 4))
    with pytest.raises(ValueError, match="chunk"):
        tssm.ssd_chunked(x, dt, A, Bm, Cm, 16)
