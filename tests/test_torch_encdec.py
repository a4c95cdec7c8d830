"""The port's encoder-decoder (``repro_torch.models.encdec``) against the JAX
package's, on the reduced seamless-m4t-large-v2 (2 encoder and 4 decoder
layers, d_model 64, 4 heads over 2 KV heads, head_dim 16, vocab 256) with
the JAX weights carried across by ``params_from_numpy``; and the attention
modes it adds (``kv_source`` cross-attention, a bf16 query over an fp32
cache).

Tolerances, in tests/test_torch_lm.py's terms, and why:

* JAX op by op (``jax.disable_jit()``) rounds bf16 after every op, as the
  port does: logits within ``TIGHT`` = 2^-6 of their largest magnitude (a
  few bf16 ulps of sums taken in another order) with equal argmax; the
  encoder's memory within ``TIGHT`` of its largest magnitude.
* JAX jitted keeps fused intermediates in fp32 and lands far from its own
  op-by-op run on these random weights: the port no further from it than
  the op-by-op run is, plus ``TIGHT``.
* prefill(S) + decode(1) against forward(S + 1), in the port alone:
  tests/test_archs.py's bound, rel < 0.06 and equal argmax.
* loss and gradients against ``jax.value_and_grad`` op by op:
  tests/test_torch_train.py's rule, loss 1e-3 relative and each leaf within
  2^-5 of its largest magnitude.

The JAX model runs outside any mesh, as tests/test_archs.py runs it (the
reference's serve loop raises under its mesh: ROADMAP §C). The JAX runs are
made once a module (fixtures) and shared by the tests that read them.
"""

import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jax_attention
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import EncDecCache, EncDecLM, build_model
from repro_torch.models import params_from_numpy
from repro_torch.models.attention import KVCache, attention, \
    decode_attention
from repro_torch.models.param import tree_items, tree_map

TIGHT = 2.0 ** -6
ARCH = "seamless-m4t-large-v2"
B, T, S = 2, 16, 16           # batch, frames, prompt tokens


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_err(ref, got) -> float:
    ref, got = f32(ref), f32(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def same_argmax(ref, got) -> bool:
    return bool((f32(ref).argmax(-1) == f32(got).argmax(-1)).all())


def fan_in(params):
    """The reference's weights with every attention's wq, wk, wv and wo
    rescaled to std 1/sqrt(fan-in) (d_model; H * D for wo), the rule of
    tools/attention_conditioning.py::fan_in_std. The reference's own draw
    reads fan-in from shape[-2] (the heads), so its attention weights come
    out 4x too large here and the softmax saturates (ROADMAP §C)."""
    def rescale(at):
        at = dict(at)
        for n in ("wq", "wk", "wv"):
            at[n] = (at[n].astype(jnp.float32) * math.sqrt(
                at[n].shape[-2] / 64)).astype(jnp.bfloat16)
        at["wo"] = (at["wo"].astype(jnp.float32) / math.sqrt(
            at["wo"].shape[-3])).astype(jnp.bfloat16)
        return at
    enc, dec = dict(params["encoder"]), dict(params["decoder"])
    enc["attn"] = rescale(enc["attn"])
    dec["self_attn"] = rescale(dec["self_attn"])
    dec["cross_attn"] = rescale(dec["cross_attn"])
    return {**params, "encoder": enc, "decoder": dec}


def models(seed=0, draw="reference", **over):
    """JAX's reduced model and weights (the reference's draw, or with the
    attention weights at fan-in std), the port's model and the same
    weights carried across; ``over`` replaces config fields on both."""
    jcfg, tcfg = (dataclasses.replace(get(ARCH, reduced=True), **over)
                  for get in (jax_get_config, get_config))
    jmodel = jax_build_model(jcfg)
    params_j = jax_init_params(jmodel.param_decls(), jax.random.key(seed))
    if draw == "fan-in":
        params_j = fan_in(params_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return jmodel, params_j, build_model(tcfg), params_t


def inputs(seed):
    """fp32 frames (B, T, M) and tokens (B, S + 1)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, 64)).astype(np.float32),
            rng.integers(0, 256, size=(B, S + 1)))


def archs_inputs():
    """The frames and tokens tests/test_archs.py holds the JAX package's
    prefill + decode to."""
    ks = jax.random.split(jax.random.key(2), 4)
    return (np.array(jax.random.normal(ks[0], (B, T, 64))),
            np.array(jax.random.randint(ks[1], (B, S + 1), 0, 256)))


# case -> (weight seed, inputs): two seeds, and seed 0's weights on
# tests/test_archs.py's inputs, where the reference's draw saturates the
# softmax
CASES = {0: (0, lambda: inputs(0)), 1: (1, lambda: inputs(1)),
         "archs": (0, archs_inputs)}


@pytest.fixture(scope="module")
def jax_runs():
    """For each case: the JAX model's encode, forward and prefill(S) +
    decode(1), op by op and jitted, with its cache after the decode. The
    cases share one config, so each function is jitted once."""
    runs, jitted = {}, None
    for case, (seed, make_inputs) in CASES.items():
        jmodel, params_j, model, params_t = models(seed)
        if jitted is None:
            jitted = {name: jax.jit(getattr(jmodel, name)) for name in
                      ("encode", "forward", "prefill", "decode_step")}
        frames, toks = make_inputs()
        fr, tk = jnp.asarray(frames), jnp.asarray(toks)
        out = {"port": (model, params_t), "inputs": (frames, toks)}
        for name, fns in (("eager", None), ("jit", jitted)):
            def fn(n):
                return fns[n] if fns else getattr(jmodel, n)
            with jax.disable_jit() if name == "eager" \
                    else contextlib.nullcontext():
                memory = fn("encode")(params_j, fr)
                logits, _ = fn("forward")(params_j, fr, tk)
                cache = jmodel.init_cache(B, max_len=jmodel.cfg.max_cache_len,
                                          memory_len=T)
                pre, cache = fn("prefill")(params_j, fr, tk[:, :S], cache)
                dec, cache = fn("decode_step")(params_j, tk[:, S:S + 1],
                                               cache)
            out[name] = dict(memory=memory, logits=logits, pre=pre, dec=dec,
                             cache=cache)
        runs[case] = out
    return runs


@pytest.mark.parametrize("case", list(CASES))
def test_encode_matches_jax(case, jax_runs):
    run = jax_runs[case]
    model, params = run["port"]
    frames, _ = run["inputs"]
    got = model.encode(params, torch.as_tensor(frames))
    assert got.shape == (B, T, 64) and got.dtype == torch.bfloat16
    eager, jitted = run["eager"]["memory"], run["jit"]["memory"]
    assert rel_err(eager, got) < TIGHT
    assert rel_err(jitted, got) <= rel_err(jitted, eager) + TIGHT


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case, jax_runs):
    run = jax_runs[case]
    model, params = run["port"]
    frames, toks = run["inputs"]
    got, aux = model.forward(params, torch.as_tensor(frames),
                             torch.as_tensor(toks))
    assert got.shape == (B, S + 1, 256) and got.dtype == torch.bfloat16
    assert aux.shape == () and aux.dtype == torch.float32 and aux == 0.0
    eager, jitted = run["eager"]["logits"], run["jit"]["logits"]
    assert rel_err(eager, got) < TIGHT and same_argmax(eager, got)
    assert rel_err(jitted, got) <= rel_err(jitted, eager) + TIGHT


def port_serving(model, params, frames, toks):
    """prefill(toks[:, :S]) + decode(toks[:, S]) through the port's entry
    points on the CPU; the cache after each."""
    cache = model.init_cache(B, model.cfg.max_cache_len, T, device="cpu")
    pre, cache = model.prefill(params, torch.as_tensor(frames),
                               torch.as_tensor(toks[:, :S]), cache)
    dec, cache = model.decode_step(params, torch.as_tensor(toks[:, S:S + 1]),
                                   cache)
    return pre, dec, cache


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_decode_match_jax(case, jax_runs):
    """Both steps' logits, and the caches they leave: the fp32 self-KV rows
    written so far and the bf16 memory K/V of every layer, within TIGHT of
    JAX's op-by-op caches; the untouched self rows stay zero."""
    run = jax_runs[case]
    model, params = run["port"]
    pre, dec, cache = port_serving(model, params, *run["inputs"])
    assert isinstance(cache, EncDecCache)
    assert pre.shape == dec.shape == (B, 1, 256)
    for got, key in ((pre, "pre"), (dec, "dec")):
        eager, jitted = run["eager"][key], run["jit"][key]
        assert rel_err(eager, got) < TIGHT and same_argmax(eager, got)
        assert rel_err(jitted, got) <= rel_err(jitted, eager) + TIGHT
    ref = run["eager"]["cache"]
    kv = cache.self_kv
    assert kv.k.dtype == kv.v.dtype == torch.float32
    assert cache.cross_k.dtype == cache.cross_v.dtype == torch.bfloat16
    assert int(kv.length) == S + 1 and int(cache.cross_length) == T
    assert cache.cross_k.shape == (4, B, T, 2, 16)
    for got, want in ((kv.k, ref.self_kv.k), (kv.v, ref.self_kv.v)):
        assert rel_err(want[:, :, :S + 1], got[:, :, :S + 1]) < TIGHT
        assert not got[:, :, S + 1:].any()
    for got, want in ((cache.cross_k, ref.cross_k),
                      (cache.cross_v, ref.cross_v)):
        assert rel_err(want, got) < TIGHT


@pytest.mark.parametrize("draw", ["reference", "fan-in"])
def test_prefill_decode_match_forward(draw, jax_runs):
    """prefill(S) + decode(1) against forward(S + 1) in the port alone, on
    the frames and tokens tests/test_archs.py holds the JAX package to.

    With the attention weights at fan-in std the port is held to that
    test's bound, rel < 0.06 and equal argmax. At the reference's draw the
    softmax saturates and the two paths' roundings (the fp32 self cache,
    P.V without P rounded to bf16, one softmax against the online one)
    pick other keys: JAX run op by op parts there too (rel 0.41, argmax
    unequal; tests/test_archs.py passes it jitted, where XLA keeps fp32
    intermediates). So there the port's gap is held to JAX's op-by-op gap
    on the same weights and inputs (``jax_runs``' "archs" case) within
    TIGHT, with the same argmax agreement: its consistency is the
    reference's own."""
    if draw == "fan-in":
        _, _, model, params = models(0, draw)
        frames, toks = archs_inputs()
    else:
        run = jax_runs["archs"]
        model, params = run["port"]
        frames, toks = run["inputs"]
    with torch.inference_mode():
        _, dec, _ = port_serving(model, params, frames, toks)
        full, _ = model.forward(params, torch.as_tensor(frames),
                                torch.as_tensor(toks))
    ref, got = full[:, S], dec[:, 0]
    if draw == "fan-in":
        assert rel_err(ref, got) < 0.06 and same_argmax(ref, got)
        return
    jref, jgot = run["eager"]["logits"][:, S], run["eager"]["dec"][:, 0]
    assert rel_err(ref, got) <= rel_err(jref, jgot) + TIGHT
    assert same_argmax(ref, got) == same_argmax(jref, jgot)


def test_serve_loop_matches_jax(monkeypatch):
    """serve_loop on the CPU, run on the JAX weights (substituted for its
    seeded init) with a model that records each step's logits: the prompts
    and then the frames come from default_rng(0), as the reference's
    serve_loop draws them, and every step matches JAX's greedy loop op by
    op within the model-level bound and picks the same token."""
    batch, prompt_len, gen = 2, 16, 4
    jmodel, params_j, _, params_t = models(0)
    steps = []

    class Recording(EncDecLM):
        def _run_decoder_cached(self, params, tokens, cache, shard=None):
            logits, cache = super()._run_decoder_cached(params, tokens,
                                                        cache, shard)
            steps.append(logits[:, -1].float())
            return logits, cache

    monkeypatch.setattr(serve, "build_model", Recording)
    monkeypatch.setattr(serve, "init_params", lambda *a, **k: params_t)
    out = serve.serve_loop(ARCH, batch=batch, prompt_len=prompt_len,
                           gen_tokens=gen, seed=0, device="cpu",
                           reduced=True)
    assert out["tokens"].shape == (batch, gen) and len(steps) == gen
    assert torch.equal(out["logits"], steps[-1])
    assert out["peak_bytes"] is None

    # the JAX side: the reference serve_loop's config, prompts and frames
    cfg = dataclasses.replace(jmodel.cfg, q_chunk=16, kv_chunk=16,
                              max_cache_len=prompt_len + gen)
    jmodel = jax_build_model(cfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(batch, prompt_len))
    frames = jnp.asarray(rng.normal(size=(batch, 16, cfg.d_model)),
                         jnp.bfloat16)
    with jax.disable_jit():
        cache = jmodel.init_cache(batch, max_len=prompt_len + gen,
                                  memory_len=16)
        logits, cache = jmodel.prefill(params_j, frames,
                                       jnp.asarray(prompts), cache)
        for step in range(gen):
            ref = logits[:, -1]
            assert rel_err(ref, steps[step]) < TIGHT, step
            tok = f32(ref).argmax(-1)
            assert (tok == out["tokens"][:, step]).all(), step
            if step + 1 < gen:
                logits, cache = jmodel.decode_step(
                    params_j, jnp.asarray(tok[:, None], jnp.int32), cache)


def test_serve_loop_draws_full_length_frames(monkeypatch):
    """At full width the encoder takes FRAMES_LEN (1024) frames a prompt,
    the JAX package's audio stub length; reduced, 16. The loop is stopped
    at the prefill, which gets the frames: the tiny model's encoder over
    1024 frames would take minutes of plain attention on the CPU."""
    seen = []

    class Stop(Exception):
        pass

    class Recording(EncDecLM):
        def init_cache(self, batch, max_len, memory_len, **kw):
            seen.append(memory_len)
            return super().init_cache(batch, max_len, memory_len, **kw)

        def prefill(self, params, frames, tokens, cache):
            seen.append((tuple(frames.shape), frames.dtype))
            raise Stop

    def tiny(arch, *, reduced=False):
        cfg = get_config(arch, reduced=True)
        return cfg if reduced else dataclasses.replace(cfg, name=arch)

    monkeypatch.setattr(serve, "build_model", Recording)
    monkeypatch.setattr(serve, "get_config", tiny)
    for reduced in (False, True):
        with pytest.raises(Stop):
            serve.serve_loop(ARCH, batch=1, prompt_len=16, gen_tokens=2,
                             device="cpu", reduced=reduced)
    assert serve.FRAMES_LEN == 1024
    assert seen == [serve.FRAMES_LEN, ((1, 1024, 64), torch.bfloat16),
                    16, ((1, 16, 64), torch.bfloat16)]


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """JAX's loss and gradients op by op, with remat on and off (the
    reference wraps each layer in jax.checkpoint when ``remat`` is set),
    and the loss alone at the reference's draw (remat changes no value of
    the forward, so it is taken once)."""
    frames, toks = inputs(3)
    batch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    out = {}
    for remat in (True, False):
        jmodel, params_j, model, params_t = models(0, "fan-in", remat=remat)
        with jax.disable_jit():
            out[remat] = (model, params_t) + jax.value_and_grad(
                jmodel.loss_fn)(params_j, batch)
    jmodel, params_j, _, params_t = models(0)
    with jax.disable_jit():
        out["reference"] = (params_t, jmodel.loss_fn(params_j, batch))
    return frames, toks, out


def port_grads(model, params, frames, toks):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.loss_fn(leaves, {"frames": torch.as_tensor(frames),
                                  "tokens": torch.as_tensor(toks)})
    loss.backward()
    return loss.detach(), {"/".join(path): t.grad
                           for path, t in tree_items(leaves)}


def jax_by_path(tree) -> dict:
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(remat, jax_loss_and_grads):
    """loss_fn and every gradient leaf against jax.value_and_grad op by op
    under the same remat setting, on the fan-in draw: loss 1e-3 relative,
    each leaf within 2^-5 of its largest magnitude (tests/test_torch_train.py's
    rule); the port's own remat on and off give the same bits. At the
    reference's draw the loss is held alike; its gradients are not: with
    the softmax saturated JAX's own jitted and op-by-op gradients part by
    78-186% of a leaf's largest magnitude, and the port's parts from the
    op-by-op run by up to 6.9% (the decoder's self-attention wk)."""
    frames, toks, runs = jax_loss_and_grads
    model, params, jloss, jgrads = runs[remat]
    assert model.cfg.remat is remat
    loss, grads = port_grads(model, params, frames, toks)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-3)
    want = jax_by_path(jgrads)
    assert set(grads) == set(want)
    for k, w in want.items():
        got, w = f32(grads[k]), f32(w)
        assert grads[k].dtype == torch.bfloat16, k
        assert np.abs(got - w).max() <= 2 ** -5 * np.abs(w).max(), k
    other = build_model(dataclasses.replace(model.cfg, remat=not remat))
    loss2, grads2 = port_grads(other, params, frames, toks)
    assert float(loss2) == float(loss)
    for k, g in grads.items():
        assert torch.equal(g, grads2[k]), k
    params, jloss = runs["reference"]
    loss, _ = port_grads(model, params, frames, toks)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-3)


def test_masked_loss_matches_jax():
    jmodel, params_j, model, params_t = models(1, remat=False)
    frames, toks = inputs(4)
    mask = (np.random.default_rng(5).random((B, S)) < 0.6).astype(
        np.float32)
    with jax.disable_jit():
        want = jmodel.loss_fn(params_j, {"frames": jnp.asarray(frames),
                                         "tokens": jnp.asarray(toks),
                                         "mask": jnp.asarray(mask)})
    got = model.loss_fn(params_t, {"frames": torch.as_tensor(frames),
                                   "tokens": torch.as_tensor(toks),
                                   "mask": torch.as_tensor(mask)})
    assert float(got) == pytest.approx(float(want), rel=1e-3)


@pytest.mark.parametrize("D", [16, 64])
def test_mixed_dtype_decode_matches_jax(D):
    """A bf16 q over an fp32 cache (the decoder's self-attention step): the
    port's plain decode_attention against the reference's, and the card
    path's kernel input, q cast to fp32 times the fp32 scale 1/sqrt(D),
    equal bit for bit to the reference's bf16 ``q * scale`` promoted to
    fp32 (the scale is a power of two at D = 16 and 64)."""
    rng = np.random.default_rng(D)
    Bq, L, H, Hk, n = 2, 40, 4, 2, 27
    q = rng.normal(size=(Bq, 1, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(Bq, L, Hk, D)).astype(np.float32)
            for _ in range(2))
    qj = jnp.asarray(q, jnp.bfloat16)
    want = jax_attention.decode_attention(qj, jax_attention.KVCache(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(n, jnp.int32)))
    qt = torch.as_tensor(q).bfloat16()
    got = decode_attention(qt, KVCache(torch.as_tensor(k),
                                       torch.as_tensor(v),
                                       torch.tensor(n, dtype=torch.int32)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert rel_err(want, got) < TIGHT
    scaled_ref = f32((qj * (1.0 / math.sqrt(D))).astype(jnp.float32))
    scaled_card = (qt.float() * torch.tensor(1.0 / math.sqrt(D),
                                             dtype=torch.float32)).numpy()
    assert np.array_equal(scaled_ref.view(np.uint32),
                          scaled_card.view(np.uint32))


@pytest.mark.parametrize("arch,over", [
    (ARCH, {}),
    # qk-norm and zero-masked padded heads, which the seamless config
    # does not set: 6 lowered heads over 2 KV heads, 4 of them real
    ("qwen3-14b", {"pad_heads_to": 6})])
def test_kv_source_cross_attention_matches_jax(arch, over):
    """The uncached cross-attention, ``attention(..., kv_source=memory)``:
    q from x, k/v from a memory of another length, qk-norm where the config
    sets it, no rope, not causal, the padded heads' mask, no cache; against
    the reference's, op by op, within TIGHT."""
    jcfg, tcfg = (dataclasses.replace(get(arch, reduced=True), **over)
                  for get in (jax_get_config, get_config))
    decls = jax_attention.attention_decls(jcfg)
    params_j = jax_init_params(decls, jax.random.key(7))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S + 1, 64)).astype(np.float32)
    memory = rng.normal(size=(B, T, 64)).astype(np.float32)
    with jax.disable_jit():
        want, cache = jax_attention.attention(
            params_j, jnp.asarray(x, jnp.bfloat16), jcfg,
            kv_source=jnp.asarray(memory, jnp.bfloat16))
    got, new_cache = attention(params_t, torch.as_tensor(x).bfloat16(),
                               tcfg,
                               kv_source=torch.as_tensor(memory).bfloat16())
    assert cache is None and new_cache is None
    assert got.shape == (B, S + 1, 64) and got.dtype == torch.bfloat16
    assert rel_err(want, got) < TIGHT


def test_non_causal_attention_matches_jax():
    """The encoder's self-attention, ``causal=False``, with rope, against
    the reference's, op by op."""
    jcfg, tcfg = (get(ARCH, reduced=True)
                  for get in (jax_get_config, get_config))
    params_j = jax_init_params(jax_attention.attention_decls(jcfg),
                               jax.random.key(8))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    x = np.random.default_rng(8).normal(size=(B, T, 64)).astype(np.float32)
    with jax.disable_jit():
        want, _ = jax_attention.attention(
            params_j, jnp.asarray(x, jnp.bfloat16), jcfg, causal=False)
    got, _ = attention(params_t, torch.as_tensor(x).bfloat16(), tcfg,
                       causal=False)
    causal, _ = attention(params_t, torch.as_tensor(x).bfloat16(), tcfg)
    assert rel_err(want, got) < TIGHT
    assert rel_err(want, causal) > 10 * TIGHT     # the mode matters


# ---------------------------------------------------------- the train step
def to_jax(tree):
    """A port tree (bf16 or fp32 torch leaves) as JAX arrays, bit for bit."""
    return jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


def unflatten(flat: dict) -> dict:
    """{"a/b": leaf} -> {"a": {"b": leaf}}."""
    tree = {}
    for path, leaf in flat.items():
        *head, last = path.split("/")
        node = tree
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def frames_batch(frames, toks) -> dict:
    return {"frames": torch.as_tensor(frames), "tokens": torch.as_tensor(toks)}


def test_train_step_is_adamw_on_the_port_gradients(jax_loss_and_grads):
    """One composed train step on the reduced model's {'frames', 'tokens'}
    batch equals the JAX package's ``adamw_update`` applied to the port's
    own gradients (which test_loss_and_grads_match_jax holds to JAX's):
    bf16 parameters within one rounding (2^-8 relative), the fp32 moments
    1e-5 (tests/test_torch_train.py's rule). The step writes into its
    state, so it steps a copy of the shared weights."""
    from repro.optim import adamw as jax_adamw
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import TrainState, build_train_step
    frames, toks, runs = jax_loss_and_grads
    model, params = runs[True][:2]
    cfg = dict(lr=5e-3, warmup_steps=2, total_steps=50)
    loss, grads = port_grads(model, params, frames, toks)
    jcfg = jax_adamw.AdamWConfig(**cfg)
    jparams = to_jax(params)
    jgrads = to_jax(unflatten(grads))
    # jitted: op by op it would compile each primitive at each leaf's shape
    jp, jstate, _ = jax.jit(lambda p, g, st: jax_adamw.adamw_update(
        p, g, st, jcfg))(jparams, jgrads, jax_adamw.adamw_init(jparams, jcfg))
    tcfg = AdamWConfig(**cfg)
    tparams = tree_map(torch.clone, params)
    state = TrainState(tparams, adamw_init(tparams, tcfg))
    state, metrics = build_train_step(model, tcfg)(
        state, frames_batch(frames, toks))
    assert float(metrics["loss"]) == float(loss)
    got_p = {"/".join(p): t for p, t in tree_items(state.params)}
    got_m = {"/".join(p): t for p, t in tree_items(state.opt.m)}
    want_m = jax_by_path(jstate.m)
    for k, want in jax_by_path(jp).items():
        np.testing.assert_allclose(f32(got_p[k]), f32(want), rtol=2 ** -8,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(f32(got_m[k]), f32(want_m[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)


def test_four_train_steps_track_jax_jitted():
    """Four composed train steps on one {'frames', 'tokens'} batch, from
    the fan-in draw, against the JAX package's jitted
    ``value_and_grad(EncDecLM.loss_fn)`` + ``adamw_update``: the losses
    within 5e-2 relative (tests/test_torch_train.py's bound: Adam's first
    steps move each bf16 weight by ~lr whatever its gradient's size, and
    jitted JAX rounds elsewhere than the op-by-op run the port follows);
    both descend."""
    from repro.optim import adamw as jax_adamw
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import TrainState, build_train_step
    jmodel, params_j, model, params_t = models(0, "fan-in")
    frames, toks = inputs(6)
    cfg = dict(lr=5e-3, warmup_steps=2, total_steps=50)
    jcfg = jax_adamw.AdamWConfig(**cfg)

    @jax.jit
    def jstep(p, opt, batch):
        loss, grads = jax.value_and_grad(jmodel.loss_fn)(p, batch)
        p, opt, _ = jax_adamw.adamw_update(p, grads, opt, jcfg)
        return p, opt, loss

    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    jp, jopt, jlosses = params_j, jax_adamw.adamw_init(params_j, jcfg), []
    for _ in range(4):
        jp, jopt, loss = jstep(jp, jopt, jbatch)
        jlosses.append(float(loss))
    tcfg = AdamWConfig(**cfg)
    state = TrainState(params_t, adamw_init(params_t, tcfg))
    step = build_train_step(model, tcfg)
    losses = []
    for _ in range(4):
        state, metrics = step(state, frames_batch(frames, toks))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=5e-2)
    assert losses[-1] < losses[0] and jlosses[-1] < jlosses[0]
    assert int(state.opt.step) == 4


@pytest.mark.parametrize("Bm,mu", [(2, 2), (4, 2), (4, 4)])
def test_microbatch_split_of_frames_matches_the_reference(Bm, mu):
    """``split_microbatches`` on a {'frames', 'tokens', 'mask'} batch
    against the reference's reshape (``src/repro/runtime/train_lib.py:
    98-103``, evaluated with jnp: its train_step does not run on this jax,
    ROADMAP §C): frames (B, T, M) are cut on axis 0 like the tokens. B = 3
    is left out: the reference tells M-RoPE positions apart by a leading
    axis of 3, so at B = 3 it would cut the frames on their frame axis
    (ROADMAP C.1), where the port keys on the leaf's name."""
    from repro_torch.runtime.train_lib import split_microbatches
    rng = np.random.default_rng(Bm + mu)
    batch = {"frames": rng.normal(size=(Bm, T, 64)).astype(np.float32),
             "tokens": rng.integers(0, 256, (Bm, S + 1)).astype(np.int32),
             "mask": (rng.random((Bm, S)) < 0.7).astype(np.float32)}
    want = jax.tree.map(
        lambda x: x.reshape((mu, x.shape[0] // mu) + x.shape[1:])
        if x.shape[0] != 3 else
        x.reshape((x.shape[0], mu, x.shape[1] // mu)
                  + x.shape[2:]).swapaxes(0, 1),
        {k: jnp.asarray(x) for k, x in batch.items()})
    got = split_microbatches({k: torch.as_tensor(x)
                              for k, x in batch.items()}, mu)
    assert len(got) == mu
    for k in batch:
        for i in range(mu):
            np.testing.assert_array_equal(got[i][k].numpy(),
                                          np.asarray(want[k][i]), err_msg=k)


def test_batch_at_is_keyed_by_seed_and_step(monkeypatch):
    """``batch_at(setup, i)``, the encoder-decoder's batch of step i: the
    same (seed, step) gives the same tokens and frames; another step or
    seed other frames. The tokens are ``SyntheticLM``'s, the frames
    ``default_rng((seed, step))``'s normal draws rounded to bf16, 16 a
    sequence reduced and ``FRAMES_LEN`` (1024) at full width (checked on
    the reduced width under the full-width name, as
    test_serve_loop_draws_full_length_frames checks the serving frames)."""
    from repro_torch.data import SyntheticLM

    def setup(seed=0, **kw):
        return train.setup_training(ARCH, steps=2, batch=2, seq=16,
                                    seed=seed, device="cpu", **kw)
    s = setup(reduced=True)
    assert s.frames_len == 16
    a, again, other = (train.batch_at(s, i) for i in (3, 3, 4))
    assert set(a) == {"frames", "tokens"}
    for k in a:
        assert torch.equal(a[k], again[k]), k
    assert not torch.equal(a["frames"], other["frames"])
    assert not torch.equal(a["frames"],
                           train.batch_at(setup(seed=1, reduced=True),
                                          3)["frames"])
    np.testing.assert_array_equal(
        a["tokens"].numpy(), SyntheticLM(s.data).batch_at(3)["tokens"])
    want = torch.as_tensor(np.random.default_rng((0, 3)).normal(
        size=(2, 16, 64))).to(torch.bfloat16)
    assert a["frames"].dtype == torch.bfloat16
    assert torch.equal(a["frames"], want)

    def tiny(arch, *, reduced=False):
        cfg = get_config(arch, reduced=True)
        return cfg if reduced else dataclasses.replace(cfg, name=arch)
    monkeypatch.setattr(train, "get_config", tiny)
    full = setup()
    assert full.frames_len == serve.FRAMES_LEN == 1024
    assert train.batch_at(full, 0)["frames"].shape == (2, 1024, 64)


def test_setup_training_takes_encdec_and_its_step_descends():
    """setup_training on the CPU takes the reduced encoder-decoder (its
    set-up has no frames-less path to refuse): four steps of its step_fn on
    batch_at's batches give finite losses, and the last below the first on
    a batch seen twice."""
    s = train.setup_training(ARCH, steps=4, batch=2, seq=16, reduced=True,
                             device="cpu")
    state, losses = s.state, []
    for i in (0, 1, 0, 0):
        state, metrics = s.step_fn(state, train.batch_at(s, i))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_setup_training_refuses_encdec_larger_than_the_card(monkeypatch):
    """On the card the encoder-decoder's training state is held to the
    card's memory before anything is built: seamless-m4t at full depth,
    19.6 GB (derived: 1.632 B parameters at 12 bytes), passes an 80 GiB
    card and stops here at the build (it needs nvcc), and raises on a
    16 GiB one naming A.12."""
    class Card:
        total_memory = 80 * 2 ** 30
    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Card)
    monkeypatch.setattr(train._build, "build",
                        lambda: built.append(1) or {})
    monkeypatch.setattr(train, "init_train_state",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("stop")))
    with pytest.raises(RuntimeError, match="stop"):
        train.setup_training(ARCH, steps=1, batch=8, seq=512)
    assert built
    need = train._state_bytes(build_model(get_config(ARCH)),
                              train.AdamWConfig())
    assert 19.5e9 < need < 19.7e9
    Card.total_memory = 16 * 2 ** 30
    built.clear()
    with pytest.raises(ValueError, match="A.12"):
        train.setup_training(ARCH, steps=1, batch=8, seq=512)
    assert not built


def test_train_loop_refuses_encdec():
    """The reference's train_loop refuses the family (SystemExit) before it
    builds anything; the port's names ROADMAP A.11."""
    with pytest.raises(SystemExit, match="A.11"):
        train.train_loop(ARCH, reduced=True, device="cpu", steps=1)


def test_serve_loop_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve_loop(ARCH, batch=1, prompt_len=16, gen_tokens=2,
                         reduced=True)
