"""The port's LM and serving loop against the JAX package's, for each arch
the port runs, reduced (dense: tinyllama-1.1b, starcoder2-15b with gelu and
nemotron-4-15b with squared ReLU in a plain MLP, qwen3-14b with qk-norm;
moe: qwen3-moe-235b-a22b, 8 experts top-2 with qk-norm, and
kimi-k2-1t-a32b, 8 experts top-2 and a shared expert; ssm: mamba2-370m;
vlm: qwen2-vl-72b, run here on tokens alone, as the reference's serve
and train loops run it; tests/test_torch_vlm.py holds its M-RoPE and
vision embeddings),
with the JAX weights carried across. ``reduced()``
resets ``pad_heads_to``, so qwen3's zero-masked padded heads run in a
variant that sets it again (``qwen3-14b/pad6``: 6 lowered heads over 2 KV
heads, 4 of them real), and sets ``head_dim`` to 16, so kimi-k2's own
head size runs in a variant that sets 112 again on both sides
(``kimi-k2-1t-a32b/d112``).

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
held to tests/test_archs.py's bound: rel < 0.06 and equal argmax (the MoE
with a capacity factor of 8.0 there, as that test sets it, so that capacity
cannot couple the token sets).

The JAX MoE layer runs inside a ``shard_map`` over a 1 x 1 mesh, which run
op by op compiles each primitive alone (~10 s a layer); the autouse
``one_device_moe`` fixture runs the reference's per-device block without
that wrapper, which changes no bit (tests/test_torch_moe.py).
"""

import contextlib
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jax_moe_mod
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import LM, build_model, params_from_numpy

TIGHT = 2.0 ** -6
ARCH = "tinyllama-1.1b"
ARCHS = ["tinyllama-1.1b", "mamba2-370m", "starcoder2-15b", "nemotron-4-15b",
         "qwen3-14b", "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
         "qwen2-vl-72b"]
VARIANTS = ARCHS + ["qwen3-14b/pad6", "kimi-k2-1t-a32b/d112"]


@pytest.fixture(autouse=True)
def one_device_moe(monkeypatch):
    monkeypatch.setattr(jax_moe_mod, "shard_map", lambda f, **_: f)
    monkeypatch.setattr(jax_moe_mod, "model_axis", lambda mesh=None: None)


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
    """The reduced configs of ``arch``, ``arch/padN`` or ``arch/dN`` (JAX's,
    the port's), the second with ``pad_heads_to=N``, the third with
    ``head_dim=N``."""
    arch, _, over = variant.partition("/")
    kw = {}
    if over:
        name, n = re.fullmatch(r"([a-z]+)(\d+)", over).groups()
        kw = {{"pad": "pad_heads_to", "d": "head_dim"}[name]: int(n)}
    return tuple(dataclasses.replace(get(arch, reduced=True), **kw)
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
    with jax.disable_jit():
        eager, eager_aux = jmodel.forward(params_j, jnp.asarray(toks))
    assert rel_err(eager, got) < TIGHT and same_argmax(eager, got)
    if model.cfg.family == "moe":        # the layers' summed aux losses
        assert aux.dtype == torch.float32
        assert abs(float(aux) - float(eager_aux)) < 1e-5
    else:
        assert aux == 0.0
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
    if model.cfg.n_experts:
        model = build_model(dataclasses.replace(model.cfg,
                                                capacity_factor=8.0))
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
        def _apply_cached(self, params, tokens, cache, **kw):
            logits, cache = super()._apply_cached(params, tokens, cache,
                                                  **kw)
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


@pytest.mark.parametrize("family,error,match", [
    # every family is ported (the hybrid: tests/test_torch_hybrid.py); a
    # config of the encoder-decoder family without encoder layers raises
    # the reference's ValueError
    ("encdec", ValueError, "encdec needs n_encoder_layers")])
def test_unported_families_raise(family, error, match):
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), family=family,
                              n_experts=8, ssm_state=16)
    with pytest.raises(error, match=match):
        build_model(cfg)
    if family == "encdec":
        jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True),
                                   family=family)
        with pytest.raises(ValueError, match=match):
            jax_build_model(jcfg)


def test_moe_loss_carries_the_aux_term():
    """loss_fn = cross entropy + AUX_COEF x the layers' summed aux losses
    (reference lm.py:251-253); each layer's aux is ~1 on a balanced-ish
    router, so the sum over 4 layers lies near 4."""
    from repro_torch.models.common import cross_entropy_loss
    from repro_torch.models.lm import AUX_COEF
    _, _, model, params_t = models(0, "qwen3-moe-235b-a22b")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 256,
                                                             (2, 17)))
    logits, aux = model.forward(params_t, toks[:, :-1])
    loss = model.loss_fn(params_t, {"tokens": toks})
    ce = cross_entropy_loss(logits, toks[:, 1:])
    assert AUX_COEF == 0.01 and 2.0 < float(aux) < 8.0
    assert float(loss) == float(ce + AUX_COEF * aux)


def refuses_full_depth(monkeypatch, arch: str, layers: int) -> None:
    """On an 80 GiB card serve_loop of ``arch`` at full depth raises
    ValueError naming A.12 before it draws a weight; at ``layers`` layers it
    passes the check (stopped here where it makes the weights'
    generator)."""
    class Props:
        total_memory = 80 * 2 ** 30
    made = []

    def generator(*args, **kw):
        made.append(1)
        raise RuntimeError("stop")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    monkeypatch.setattr(torch, "Generator", generator)
    with pytest.raises(ValueError, match=r"A\.12.*cut depth"):
        serve.serve_loop(arch, device="cuda")
    assert not made
    full = serve.get_config
    monkeypatch.setattr(serve, "get_config", lambda arch, reduced=False:
                        dataclasses.replace(full(arch), n_layers=layers))
    with pytest.raises(RuntimeError, match="stop"):
        serve.serve_loop(arch, device="cuda")
    assert made


def test_full_depth_moe_serving_on_one_card_raises(monkeypatch):
    """qwen3-moe-235b-a22b's 94 layers hold 470 GB of bf16 weights; 12
    layers (62 GB) fit."""
    refuses_full_depth(monkeypatch, "qwen3-moe-235b-a22b", 12)


def test_full_depth_kimi_serving_on_one_card_raises(monkeypatch):
    """kimi-k2-1t-a32b's 61 layers hold 2.09 TB of bf16 weights; 2 layers
    (73.0 GB) fit."""
    refuses_full_depth(monkeypatch, "kimi-k2-1t-a32b", 2)


def test_full_depth_qwen2_vl_serving_on_one_card_raises(monkeypatch):
    """qwen2-vl-72b's 80 layers hold 145.4 GB of bf16 weights; 40 layers
    (75.2 GB) fit."""
    refuses_full_depth(monkeypatch, "qwen2-vl-72b", 40)


def test_full_depth_qwen2_vl_training_on_one_card_raises(monkeypatch):
    """qwen2-vl-72b's training state at its 80 layers, 12 bytes a
    parameter, is 872 GB: on an 80 GiB card train_loop raises ValueError
    naming A.12 before it builds anything; at 1 layer (40.4 GB) it passes
    the check (stopped here at the build, which needs nvcc)."""
    from repro_torch.launch import train as train_mod

    class Props:
        total_memory = 80 * 2 ** 30
    built = []

    def build():
        built.append(1)
        raise RuntimeError("stop")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    monkeypatch.setattr(train_mod._build, "build", build)
    with pytest.raises(ValueError, match=r"A\.12.*cut depth"):
        train_mod.train_loop("qwen2-vl-72b", steps=1, device="cuda")
    assert not built
    full = train_mod.get_config
    monkeypatch.setattr(train_mod, "get_config", lambda arch, reduced=False:
                        dataclasses.replace(full(arch), n_layers=1))
    with pytest.raises(RuntimeError, match="stop"):
        train_mod.train_loop("qwen2-vl-72b", steps=1, device="cuda")
    assert built
