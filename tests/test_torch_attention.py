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


@pytest.mark.parametrize("field,item", [("qk_norm", "A.2"),
                                        ("pad_heads_to", "A.2"),
                                        ("use_mrope", "A.7")])
def test_unported_attention_options_raise(field, item):
    value = 8 if field == "pad_heads_to" else True
    cfg = dataclasses.replace(get_config("tinyllama-1.1b", reduced=True),
                              **{field: value})
    x = torch.zeros(1, 2, cfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match=item):
        attention({}, x, cfg)
