"""The port's attention sublayer against ``repro.models.attention.attention``
in its three modes: no cache, cached prefill, cached S == 1 decode.

JAX runs op by op (no jit), so both sides round bf16 at the same places; the
budget is rel < 2^-7 of the output's largest magnitude (two bf16 ulps), for
the few sums taken in another order. The JAX flags ``decode_unexpanded_gqa``
and ``onehot_cache_update`` change how JAX computes, not what: the port,
which has one way, must match both settings.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models.attention import attention as jax_attention
from repro.models.attention import attention_decls as jax_attention_decls
from repro.models.attention import init_cache as jax_init_cache
from repro_torch.configs import get_config
from repro_torch.models.attention import attention, init_cache
from repro_torch.models.common import matmul
from repro_torch.models.param import params_from_numpy

REL = 2.0 ** -7


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def rel_err(ref, got) -> float:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
@pytest.mark.parametrize("unexpanded_gqa", [False, True])
@pytest.mark.parametrize("onehot", [False, True])
def test_attention_matches_jax(mode, unexpanded_gqa, onehot):
    jcfg = dataclasses.replace(jax_get_config("tinyllama-1.1b", reduced=True),
                               decode_unexpanded_gqa=unexpanded_gqa,
                               onehot_cache_update=onehot)
    tcfg = dataclasses.replace(get_config("tinyllama-1.1b", reduced=True),
                               decode_unexpanded_gqa=unexpanded_gqa,
                               onehot_cache_update=onehot)
    params_j = jax_init_params(jax_attention_decls(jcfg), jax.random.key(0))
    params_t = to_torch(params_j)
    B, S, L = 2, 16, jcfg.max_cache_len
    rng = np.random.default_rng(0)
    x_j = jnp.asarray(rng.standard_normal((B, S + 1, jcfg.d_model)),
                      jnp.bfloat16)
    x_t = to_torch({"x": x_j})["x"]

    if mode == "no_cache":
        ref, _ = jax_attention(params_j, x_j[:, :S], jcfg)
        got, new = attention(params_t, x_t[:, :S], tcfg)
        assert new is None
        assert rel_err(ref, got) < REL
        return

    cache_j = jax_init_cache(jcfg, B, L)
    cache_t = init_cache(tcfg, B, L, device="cpu")
    ref, cache_j = jax_attention(params_j, x_j[:, :S], jcfg, cache=cache_j)
    got, cache_t = attention(params_t, x_t[:, :S], tcfg, cache=cache_t)
    if mode == "decode":
        ref, cache_j = jax_attention(params_j, x_j[:, S:], jcfg,
                                     cache=cache_j)
        got, cache_t = attention(params_t, x_t[:, S:], tcfg, cache=cache_t)
    n = S + (mode == "decode")
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert rel_err(ref, got) < REL
    assert int(cache_t.length) == int(cache_j.length) == n
    assert cache_t.length.dtype == torch.int32 and cache_t.length.dim() == 0
    for name in ("k", "v"):   # written rows agree, unwritten rows stay zero
        ref_c, got_c = getattr(cache_j, name), getattr(cache_t, name)
        assert rel_err(ref_c[:, :n], got_c[:, :n]) < REL
        assert not bool(got_c[:, n:].any())


def test_cache_is_written_in_place():
    """The port writes K/V into the cache's buffers (the JAX package returns
    a copy); the returned cache shares them and advances the length."""
    cfg = get_config("tinyllama-1.1b", reduced=True)
    params = to_torch(jax_init_params(
        jax_attention_decls(jax_get_config("tinyllama-1.1b", reduced=True)),
        jax.random.key(1)))
    cache = init_cache(cfg, 1, cfg.max_cache_len, device="cpu")
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    _, new = attention(params, x, cfg, cache=cache)
    assert new.k.data_ptr() == cache.k.data_ptr()
    assert bool(cache.k[:, :4].any()) and not bool(cache.k[:, 4:].any())
    assert int(cache.length) == 0 and int(new.length) == 4


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
@pytest.mark.parametrize("head_dim", [112, 128])
def test_inexact_scale_rounds_as_jax(mode, head_dim):
    """At D = 112 (kimi-k2) and 128, 1/sqrt(D) is no bf16 number. The
    reference multiplies a bf16 q by the scale rounded to bf16 (a weakly
    typed Python float takes the array's dtype), and so must the port: with
    the fp32 scale its plain path parted from the reference's by 1.7% of
    this layer's output at D = 112."""
    jcfg, tcfg = (dataclasses.replace(get("kimi-k2-1t-a32b", reduced=True),
                                      head_dim=head_dim)
                  for get in (jax_get_config, get_config))
    params_j = jax_init_params(jax_attention_decls(jcfg), jax.random.key(0))
    S = 16
    x_j = jnp.asarray(np.random.default_rng(0).standard_normal(
        (2, S + 1, jcfg.d_model)), jnp.bfloat16)
    ref, got = run_modes(params_j, to_torch(params_j), jcfg, tcfg, mode,
                         x_j, to_torch({"x": x_j})["x"], S)
    assert got.shape == ref.shape and rel_err(ref, got) < REL


def qwen3_configs(pad):
    """Reduced qwen3-14b (qk-norm; 4 heads over 2 KV heads) on both sides;
    ``pad`` sets ``pad_heads_to``, which ``reduced()`` resets to None."""
    return tuple(dataclasses.replace(get("qwen3-14b", reduced=True),
                                     pad_heads_to=pad)
                 for get in (jax_get_config, get_config))


def run_modes(params_j, params_t, jcfg, tcfg, mode, x_j, x_t, S):
    """(JAX's output, the port's) of one mode, as the test above runs it."""
    if mode == "no_cache":
        return (jax_attention(params_j, x_j[:, :S], jcfg)[0],
                attention(params_t, x_t[:, :S], tcfg)[0])
    L = jcfg.max_cache_len
    cache_j, cache_t = jax_init_cache(jcfg, 2, L), init_cache(tcfg, 2, L,
                                                              device="cpu")
    ref, cache_j = jax_attention(params_j, x_j[:, :S], jcfg, cache=cache_j)
    got, cache_t = attention(params_t, x_t[:, :S], tcfg, cache=cache_t)
    if mode == "decode":
        ref, _ = jax_attention(params_j, x_j[:, S:], jcfg, cache=cache_j)
        got, _ = attention(params_t, x_t[:, S:], tcfg, cache=cache_t)
    return ref, got


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
@pytest.mark.parametrize("pad", [None, 6])
def test_qk_norm_and_padded_heads_match_jax(mode, pad):
    """qwen3's attention: the RMSNorm over D on q and k before RoPE (with
    q_norm / k_norm leaves drawn away from their ones init, so the scale
    matters) and, with ``pad``, 6 lowered heads of which 2 are masked."""
    jcfg, tcfg = qwen3_configs(pad)
    params_j = jax_init_params(jax_attention_decls(jcfg), jax.random.key(3))
    rng = np.random.default_rng(3)
    for name in ("q_norm", "k_norm"):
        assert params_j[name].shape == (jcfg.head_dim,)
        params_j[name] = jnp.asarray(
            1 + 0.5 * rng.standard_normal(jcfg.head_dim), jnp.bfloat16)
    params_t = to_torch(params_j)
    assert params_t["wq"].shape[-2] == (pad or jcfg.n_heads)
    S = 16
    x_j = jnp.asarray(rng.standard_normal((2, S + 1, jcfg.d_model)),
                      jnp.bfloat16)
    ref, got = run_modes(params_j, params_t, jcfg, tcfg, mode, x_j,
                         to_torch({"x": x_j})["x"], S)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert rel_err(ref, got) < REL


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
def test_padded_heads_are_zero_before_wo(monkeypatch, mode):
    """The attention output that meets ``wo`` is exactly zero on the padded
    heads (4 real of 6) and not on the real ones."""
    import repro_torch.models.attention as attn_mod
    jcfg, tcfg = qwen3_configs(6)
    params_t = to_torch(jax_init_params(jax_attention_decls(jcfg),
                                        jax.random.key(4)))
    H, D = 6, tcfg.head_dim
    seen = []

    def recording(x, w):
        if w.shape[0] == H * D:          # the output projection's input
            seen.append(x.detach().clone())
        return matmul(x, w)
    monkeypatch.setattr(attn_mod, "matmul", recording)
    x = torch.randn(2, 9, tcfg.d_model,
                    generator=torch.Generator().manual_seed(5)).bfloat16()
    if mode == "no_cache":
        attention(params_t, x[:, :8], tcfg)
    else:
        cache = init_cache(tcfg, 2, tcfg.max_cache_len, device="cpu")
        _, cache = attention(params_t, x[:, :8], tcfg, cache=cache)
        if mode == "decode":
            seen.clear()
            attention(params_t, x[:, 8:], tcfg, cache=cache)
    (out,) = seen
    heads = out.reshape(*out.shape[:2], H, D)
    assert not bool(heads[:, :, tcfg.n_heads:].any())
    assert bool((heads[:, :, :tcfg.n_heads].abs().amax(dim=-1) > 0).all())


def test_model_and_kernel_algorithms_part_at_a_saturated_softmax():
    """The reference has two attention algorithms: its model's
    ``blockwise_attention`` rounds q / sqrt(D) to bf16 before the scores,
    its Pallas kernels' ``ref.py`` scales the fp32 scores. The port copies
    both (its plain model path; its kernels' plain version, which the CUDA
    kernels follow), each matching its JAX original at unit-scale scores,
    where the two algorithms agree. At a saturated softmax (q and k 20x
    larger: scores of std ~400, as the reference's attention init gives
    starcoder2-15b's layer 0) the reference's two algorithms part by far
    more than the model checks' 0.06 (and so do the two frameworks' runs of
    one algorithm, which sum in another order): why chip_smoke.py's
    card-against-CPU model checks draw the attention at fan-in std."""
    from repro.kernels.flash_attention.ref import \
        flash_attention_ref as jax_ref
    from repro.models.attention import blockwise_attention as jax_blockwise
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.attention import blockwise_attention
    B, S, H, Hk, D = 1, 64, 4, 1, 128

    def both(spread):
        rng = np.random.default_rng(6)
        q, k, v = (jnp.asarray(rng.standard_normal((B, S, h, D)) * s,
                               jnp.bfloat16)
                   for h, s in ((H, spread), (Hk, spread), (Hk, 1.0)))
        with jax.disable_jit():
            model = jax_blockwise(q, k, v, causal=True, q_chunk=32,
                                  kv_chunk=32)
            kernel = jax_ref(
                q.reshape(B, S, Hk, H // Hk, D).transpose(0, 2, 3, 1, 4),
                k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
                causal=True).transpose(0, 3, 1, 2, 4).reshape(B, S, H, D)
        return (q, k, v), model, kernel

    (q, k, v), j_model, j_kernel = both(1.0)
    qt, kt, vt = (to_torch({"a": a})["a"] for a in (q, k, v))
    assert rel_err(j_model, blockwise_attention(
        qt, kt, vt, causal=True, q_chunk=32, kv_chunk=32)) < REL
    assert rel_err(j_kernel, flash_attention_plain(qt, kt, vt)) < REL
    assert rel_err(j_kernel, to_torch({"a": j_model})["a"]) < REL
    _, j_model, j_kernel = both(20.0)
    assert rel_err(j_kernel, to_torch({"a": j_model})["a"]) > 0.06
