"""The port's LM and serving loop against the JAX package's, for each arch
the port runs, reduced (dense: tinyllama-1.1b, starcoder2-15b with gelu and
nemotron-4-15b with squared ReLU in a plain MLP, qwen3-14b with qk-norm;
ssm: mamba2-370m), with the JAX weights carried across. ``reduced()``
resets ``pad_heads_to``, so qwen3's zero-masked padded heads run in a
variant that sets it again (``qwen3-14b/pad6``: 6 lowered heads over 2 KV
heads, 4 of them real).

Two references, and why:

* JAX op by op (``jax.disable_jit()``: the same entry points, ``lax.scan``
  run as a loop). It rounds bf16 after every op, as the port does, so the
  port is held tightly: rel < 2^-6 of the logits' largest magnitude (a few
  bf16 ulps for sums taken in another order) and equal argmax everywhere.
* JAX jitted, as ``tests/test_archs.py`` runs it. XLA keeps fused
  intermediates in fp32, and on these random fan-in weights the residual
  stream grows layer by layer, so jitted JAX moves the logits from its own
  op-by-op run by far more than the tight budget. The port is held to be
  no further from jitted JAX than JAX's op-by-op run is, plus the tight
  budget above; each test measures that spread itself.

The port's own consistency, prefill(S) + decode(1) against forward(S+1), is
held to tests/test_archs.py's bound: rel < 0.06 and equal argmax.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import LM, build_model, params_from_numpy

TIGHT = 2.0 ** -6
ARCH = "tinyllama-1.1b"
ARCHS = ["tinyllama-1.1b", "mamba2-370m", "starcoder2-15b", "nemotron-4-15b",
         "qwen3-14b"]
VARIANTS = ARCHS + ["qwen3-14b/pad6"]


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_err(ref, got) -> float:
    ref, got = f32(ref), f32(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def same_argmax(ref, got) -> bool:
    return bool((f32(ref).argmax(-1) == f32(got).argmax(-1)).all())


def configs(variant):
    """The reduced configs of ``arch`` or ``arch/padN`` (JAX's, the
    port's), the latter with ``pad_heads_to=N``."""
    arch, _, pad = variant.partition("/pad")
    return tuple(dataclasses.replace(get(arch, reduced=True),
                                     pad_heads_to=int(pad) if pad else None)
                 for get in (jax_get_config, get_config))


def models(seed, arch=ARCH):
    jcfg, tcfg = configs(arch)
    jmodel = jax_build_model(jcfg)
    params_j = jax_init_params(jmodel.param_decls(), jax.random.key(seed))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return jmodel, params_j, build_model(tcfg), params_t


def jax_serving(jmodel, params, toks, S, *, eager):
    """prefill(toks[:, :S]) + decode(toks[:, S]) through the JAX entry
    points, outside any mesh (as tests/test_archs.py composes them)."""
    with jax.disable_jit() if eager else contextlib.nullcontext():
        prefill = jmodel.prefill if eager else jax.jit(jmodel.prefill)
        decode = jmodel.decode_step if eager else jax.jit(jmodel.decode_step)
        cache = jmodel.init_cache(toks.shape[0],
                                  max_len=jmodel.cfg.max_cache_len)
        pre, cache = prefill(params, jnp.asarray(toks[:, :S]), cache)
        dec, _ = decode(params, jnp.asarray(toks[:, S:S + 1]), cache)
    return pre, dec


def port_serving(model, params, toks, S):
    cache = model.init_cache(toks.shape[0], model.cfg.max_cache_len,
                             device="cpu")
    pre, cache = model.prefill(params, torch.as_tensor(toks[:, :S]), cache)
    dec, cache = model.decode_step(params, torch.as_tensor(toks[:, S:S + 1]),
                                   cache)
    if model.cfg.family == "ssm":
        assert cache.kv is None and cache.ssm is not None
    else:
        assert int(cache.kv.length) == S + 1 and cache.ssm is None
    return pre, dec


@pytest.mark.parametrize("arch", VARIANTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed, arch):
    jmodel, params_j, model, params_t = models(seed, arch)
    toks = np.random.default_rng(seed).integers(0, 256, size=(2, 17))
    got, aux = model.forward(params_t, torch.as_tensor(toks))
    assert got.shape == (2, 17, 256) and got.dtype == torch.bfloat16
    assert aux == 0.0
    with jax.disable_jit():
        eager, _ = jmodel.forward(params_j, jnp.asarray(toks))
    assert rel_err(eager, got) < TIGHT and same_argmax(eager, got)
    jitted, _ = jmodel.forward(params_j, jnp.asarray(toks))
    assert rel_err(jitted, got) <= rel_err(jitted, eager) + TIGHT


@pytest.mark.parametrize("arch", VARIANTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_decode_match_jax(seed, arch):
    jmodel, params_j, model, params_t = models(seed, arch)
    toks = np.random.default_rng(seed).integers(0, 256, size=(2, 17))
    pre, dec = port_serving(model, params_t, toks, 16)
    assert pre.shape == dec.shape == (2, 1, 256)
    eager = jax_serving(jmodel, params_j, toks, 16, eager=True)
    jitted = jax_serving(jmodel, params_j, toks, 16, eager=False)
    for got, ref_e, ref_j in zip((pre, dec), eager, jitted):
        assert rel_err(ref_e, got) < TIGHT and same_argmax(ref_e, got)
        assert rel_err(ref_j, got) <= rel_err(ref_j, ref_e) + TIGHT


@pytest.mark.parametrize("arch", VARIANTS)
def test_prefill_decode_match_forward(arch):
    """prefill(S) + decode(1) ≍ forward(S + 1), in the port alone, on the
    weights and tokens tests/test_archs.py holds the JAX package to. The
    bound is a property of these draws, not of the algorithm: bf16 rounding
    compounds through the random-weight layers, and on other tokens the
    two paths (softmax of the full row vs online softmax) can part by
    more, in JAX as in the port."""
    S = 16
    _, _, model, params_t = models(0, arch)
    ks = jax.random.split(jax.random.key(2), 4)
    toks = np.array(jax.random.randint(ks[1], (2, S + 1), 0, 256))
    _, dec = port_serving(model, params_t, toks, S)
    full, _ = model.forward(params_t, torch.as_tensor(toks))
    ref, got = full[:, S], dec[:, 0]
    assert rel_err(ref, got) < 0.06 and same_argmax(ref, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_matches_jax(monkeypatch, arch):
    """serve_loop on the CPU, run on the JAX weights (substituted for its
    seeded init) with a model that records each step's logits: every step
    matches JAX's greedy loop (op by op) within the model-level bound and
    picks the same token, so each step runs on the prefix JAX's greedy
    tokens give."""
    batch, prompt_len, gen = 2, 32, 6
    jmodel, params_j, _, params_t = models(0, arch)
    steps = []

    class Recording(LM):
        def _apply_cached(self, params, tokens, cache):
            logits, cache = super()._apply_cached(params, tokens, cache)
            steps.append(logits[:, -1].float())
            return logits, cache

    monkeypatch.setattr(serve, "build_model", Recording)
    monkeypatch.setattr(serve, "init_params", lambda *a, **k: params_t)
    out = serve.serve_loop(arch, batch=batch, prompt_len=prompt_len,
                           gen_tokens=gen, seed=0, device="cpu",
                           reduced=True)
    assert out["tokens"].shape == (batch, gen) and len(steps) == gen
    assert out["prefill_s"] > 0 and out["decode_tok_per_s"] > 0
    assert torch.equal(out["logits"], steps[-1])
    assert out["peak_bytes"] is None          # measured on the card only

    # the JAX side of the same loop: launch/serve.py's config and prompts
    cfg = dataclasses.replace(jmodel.cfg, q_chunk=16, kv_chunk=16,
                              max_cache_len=prompt_len + gen)
    jmodel = jax_build_model(cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                size=(batch, prompt_len))
    with jax.disable_jit():
        cache = jmodel.init_cache(batch, max_len=prompt_len + gen)
        logits, cache = jmodel.prefill(params_j, jnp.asarray(prompts), cache)
        for step in range(gen):
            ref = logits[:, -1]
            assert rel_err(ref, steps[step]) < 0.06, step
            tok = f32(ref).argmax(-1)
            assert (tok == out["tokens"][:, step]).all(), step
            if step + 1 < gen:
                logits, cache = jmodel.decode_step(
                    params_j, jnp.asarray(tok[:, None], jnp.int32), cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_without_cuda_raises(monkeypatch, arch):
    """The default device is the card: with no CUDA it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve_loop(arch, batch=1, prompt_len=16, gen_tokens=2,
                         reduced=True)


@pytest.mark.parametrize("family,item", [("moe", "A.8"), ("hybrid", "A.10"),
                                         ("encdec", "A.11"), ("vlm", "A.7")])
def test_unported_families_raise(family, item):
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), family=family,
                              n_experts=8, ssm_state=16)
    with pytest.raises(NotImplementedError, match=item):
        build_model(cfg)
