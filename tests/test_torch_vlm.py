"""The port's ``vlm`` family (qwen2-vl-72b: M-RoPE and vision embeddings)
against the JAX package's, on the reduced qwen2-vl-72b (4 layers, d_model
64, 4 heads over 2 KV heads, head_dim 16, vocab 256) with the JAX weights
carried across by ``params_from_numpy``.

The positions follow Qwen2-VL's layout (arXiv:2409.12191 §2.1), with
distinct (t, h, w) streams: each row's first ``NV`` = 8 tokens are patches
of a grid, patch (r, c) at (0, r, c) (row 0 a 2 x 4 grid, row 1 a 4 x 2
one); the text after them starts at max(grid h, grid w) and advances in all
three streams together.

Tolerances, and why:

* ``apply_mrope`` in fp32 within 1e-6 of the largest magnitude: the angles
  are the same fp32 products on both sides, and the two libraries' cos and
  sin differ by an fp32 ulp at most; in bf16 bit-equal or one bf16 ulp
  apart (a one-ulp fp32 difference can round to either neighbour).
* the attention sublayer within 2^-7 of the output's largest magnitude
  (tests/test_torch_attention.py's rule: two bf16 ulps of sums taken in
  another order); the cache rows exactly where JAX writes them.
* the model against JAX run op by op (``jax.disable_jit()``, which rounds
  bf16 after every op as the port does): logits within 2^-6 of their
  largest magnitude with equal argmax; against jitted JAX no further than
  the op-by-op run is, plus 2^-6 (tests/test_torch_lm.py's rules).
* prefill(S) + decode(1) against forward(S + 1) in the port alone:
  tests/test_archs.py's bound, rel < 0.06 and equal argmax.
* loss and gradients against ``jax.value_and_grad`` op by op: loss 1e-3
  relative, each leaf within 2^-5 of its largest magnitude
  (tests/test_torch_train.py's rule), on weights whose attention is drawn
  at fan-in std (``fan_in``). At the reference's draw the softmax
  saturates (ROADMAP §C) and the gradients are so ill-conditioned that on
  some batches the port's and JAX's op-by-op runs part by more than the
  rule with no fault in either (seed 8, rows 2-3 of the microbatch test's
  batch: wo 7.4% and wk 7.0% of their largest magnitude); the loss is held
  there as well.

The JAX runs are made once a module (fixtures) and shared by the tests
that read them.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jax_attention
import repro.models.common as jax_common
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.attention import attention, init_cache
from repro_torch.models.common import apply_mrope, apply_rope, rope_table
from repro_torch.models.param import tree_items, tree_map
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import TrainState, build_train_step
from repro_torch.runtime import train_lib

ARCH = "qwen2-vl-72b"
TIGHT = 2.0 ** -6
REL = 2.0 ** -7
B, S, NV = 2, 16, 8           # batch, prompt tokens, patches a row
GRIDS = ((2, 4), (4, 2))      # each row's patch grid (h, w)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_err(ref, got) -> float:
    ref, got = f32(ref), f32(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def same_argmax(ref, got) -> bool:
    return bool((f32(ref).argmax(-1) == f32(got).argmax(-1)).all())


def positions(seq: int, grids=GRIDS) -> np.ndarray:
    """(3, len(grids), seq) int32: Qwen2-VL's layout of one grid of patches
    a row, then text."""
    out = []
    for gh, gw in grids:
        r, c = np.divmod(np.arange(gh * gw), gw)
        text = max(gh, gw) + np.arange(seq - gh * gw)
        out.append([np.concatenate([np.zeros(gh * gw, int), text]),
                    np.concatenate([r, text]), np.concatenate([c, text])])
    return np.asarray(out, np.int32).transpose(1, 0, 2)


def test_positions_follow_the_qwen2_vl_layout():
    pos = positions(11)
    assert pos.shape == (3, 2, 11)
    np.testing.assert_array_equal(pos[:, 0, :8], [[0] * 8, [0, 0, 0, 0, 1,
                                                            1, 1, 1],
                                                  [0, 1, 2, 3] * 2])
    np.testing.assert_array_equal(pos[:, 1, :8], [[0] * 8, [0, 0, 1, 1, 2,
                                                            2, 3, 3],
                                                  [0, 1] * 4])
    np.testing.assert_array_equal(pos[:, :, 8:], np.broadcast_to(
        [4, 5, 6], (3, 2, 3)))


def configs(**over):
    return tuple(dataclasses.replace(get(ARCH, reduced=True), **over)
                 for get in (jax_get_config, get_config))


def fan_in(params):
    """The reference's weights with the attention's wq, wk, wv and wo
    rescaled to std 1/sqrt(fan-in) (d_model; H * D for wo), the rule of
    tools/attention_conditioning.py::fan_in_std (the reference reads
    fan-in from shape[-2], the heads, and draws them 4-6x too large
    here)."""
    at = dict(params["layers"]["attn"])
    for n in ("wq", "wk", "wv"):
        at[n] = (at[n].astype(jnp.float32) * np.sqrt(
            at[n].shape[-2] / 64)).astype(jnp.bfloat16)
    at["wo"] = (at["wo"].astype(jnp.float32) / np.sqrt(
        at["wo"].shape[-3])).astype(jnp.bfloat16)
    return {**params, "layers": {**params["layers"], "attn": at}}


def models(seed=0, draw="reference", **over):
    """JAX's reduced model and weights (the reference's draw, or with the
    attention at fan-in std), the port's model and the same weights
    carried across; ``over`` replaces config fields on both."""
    jcfg, tcfg = configs(**over)
    jmodel = jax_build_model(jcfg)
    params_j = jax_init_params(jmodel.param_decls(), jax.random.key(seed))
    if draw == "fan-in":
        params_j = fan_in(params_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return jmodel, params_j, build_model(tcfg), params_t


def inputs(seed):
    """Tokens (B, S + 1), fp32 patch embeddings (B, NV, M) and the
    positions of the S + 1 tokens (3, B, S + 1)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(B, S + 1)).astype(np.int32),
            rng.normal(size=(B, NV, 64)).astype(np.float32),
            positions(S + 1))


# ------------------------------------------------------------ apply_mrope
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,sections", [(16, None), (16, (4, 2, 2)),
                                        (128, None), (128, (32, 16, 16))])
def test_apply_mrope_matches_jax(dtype, D, sections):
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2, 11, 4, D)).astype(np.float32)
    pos = rng.integers(0, 300, size=(3, 2, 11)).astype(np.int32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    with jax.disable_jit():
        want = jax_common.apply_mrope(xj, jnp.asarray(pos), D, sections)
    got = apply_mrope(torch.as_tensor(x).to(getattr(torch, dtype)),
                      torch.as_tensor(pos), D, sections)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    if dtype == "float32":
        assert rel_err(want, got) < 1e-6
        return
    w, g = f32(want), f32(got)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert bool((np.abs(w - g) <= ulp).all())


def test_apply_mrope_default_sections():
    """The default split is (D/8, rest split h >= w): (16, 24, 24) at D =
    128, (2, 3, 3) at 16: each stream rotates its own columns only."""
    for D, want in ((128, (16, 24, 24)), (16, (2, 3, 3))):
        x = torch.ones(1, 1, 1, D)
        for j in range(3):
            pos = torch.zeros(3, 1, 1, dtype=torch.int64)
            pos[j] = 5
            moved = (apply_mrope(x, pos, D)[0, 0, 0, :D // 2] != 1)
            start = sum(want[:j])
            assert bool(moved[start:start + want[j]].all())
            assert int(moved.sum()) == want[j]
    x = torch.ones(1, 1, 1, 16)
    assert torch.equal(apply_mrope(x, torch.full((3, 1, 1), 7), 16),
                       apply_mrope(x, torch.full((3, 1, 1), 7), 16,
                                   (2, 3, 3)))


@pytest.mark.parametrize("sections", [(4, 4, 4), (8, 8, 8)])
def test_apply_mrope_sections_must_sum_to_half_dim(sections):
    x = np.zeros((1, 2, 1, 16), np.float32)
    pos = np.zeros((3, 1, 2), np.int32)
    with pytest.raises(ValueError, match="must sum to 8"):
        jax_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 16,
                               sections)
    with pytest.raises(ValueError, match="must sum to 8"):
        apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 16, sections)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_equal_positions_reduce_to_rope(dtype):
    """Three equal streams rotate as the 1-D RoPE does, bit for bit."""
    x = torch.randn(2, 9, 4, 16, generator=torch.Generator().manual_seed(3))
    x = x.to(dtype)
    p = torch.arange(9) + 5
    got = apply_mrope(x, p.expand(3, 2, 9), 16, theta=1e6)
    assert torch.equal(got, apply_rope(x, *rope_table(p, 16, 1e6)))


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
def test_attention_with_mrope_matches_jax(mode):
    """The sublayer with M-RoPE positions, in each mode. Under a cache the
    tokens rotate at their (t, h, w) positions but are written at rows
    length .. length + S - 1, as the reference's dynamic_update_slice at
    cache.length writes them: the decode token's positions (12) are not
    its row (16)."""
    jcfg, tcfg = configs()
    params_j = jax_init_params(jax_attention.attention_decls(jcfg),
                               jax.random.key(5))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    x = np.random.default_rng(5).normal(size=(B, S + 1, 64))
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
    pos = positions(S + 1)
    pj, pt = jnp.asarray(pos), torch.as_tensor(pos)
    assert int(pos[0, 0, S]) == 12
    if mode == "no_cache":
        with jax.disable_jit():
            want, _ = jax_attention.attention(params_j, xj[:, :S], jcfg,
                                              mrope_positions=pj[..., :S])
        got, new = attention(params_t, xt[:, :S], tcfg,
                             mrope_positions=pt[..., :S])
        assert new is None and rel_err(want, got) < REL
        # the positions matter: the 1-D RoPE gives another output
        plain, _ = attention(params_t, xt[:, :S], tcfg)
        assert rel_err(want, plain) > 10 * REL
        return
    L = jcfg.max_cache_len
    cache_j = jax_attention.init_cache(jcfg, B, L)
    cache_t = init_cache(tcfg, B, L, device="cpu")
    with jax.disable_jit():
        want, cache_j = jax_attention.attention(
            params_j, xj[:, :S], jcfg, cache=cache_j,
            mrope_positions=pj[..., :S])
        if mode == "decode":
            want, cache_j = jax_attention.attention(
                params_j, xj[:, S:], jcfg, cache=cache_j,
                mrope_positions=pj[..., S:])
    got, cache_t = attention(params_t, xt[:, :S], tcfg, cache=cache_t,
                             mrope_positions=pt[..., :S])
    if mode == "decode":
        got, cache_t = attention(params_t, xt[:, S:], tcfg, cache=cache_t,
                                 mrope_positions=pt[..., S:])
    n = S + (mode == "decode")
    assert got.shape == want.shape and rel_err(want, got) < REL
    assert int(cache_t.length) == int(cache_j.length) == n
    for name in ("k", "v"):
        ref_c, got_c = getattr(cache_j, name), getattr(cache_t, name)
        assert rel_err(ref_c[:, :n], got_c[:, :n]) < REL
        assert bool(got_c[:, n - 1].any())
        assert not bool(got_c[:, n:].any())


def test_mrope_positions_need_use_mrope():
    """As in the reference, positions given to a config without
    ``use_mrope`` leave the 1-D RoPE in place."""
    _, tcfg = configs(use_mrope=False)
    params = tree_map(lambda a: a[0], models(6)[3]["layers"]["attn"])
    x = torch.randn(B, S, 64, generator=torch.Generator().manual_seed(6))
    x = x.bfloat16()
    pos = torch.as_tensor(positions(S))
    assert torch.equal(attention(params, x, tcfg, mrope_positions=pos)[0],
                       attention(params, x, tcfg)[0])


# ------------------------------------------------------------------ model
CASES = {0: 0, 1: 1}         # case -> weight and input seed


@pytest.fixture(scope="module")
def jax_runs():
    """For each case: the JAX model's forward with the vision embeddings
    (nv = 8 and nv = 0) and positions, and without either; prefill(S) +
    decode(1) with positions and without; op by op and jitted."""
    runs, jitted = {}, None
    for case, seed in CASES.items():
        jmodel, params_j, model, params_t = models(seed)
        if jitted is None:
            jitted = {name: jax.jit(getattr(jmodel, name)) for name in
                      ("forward", "prefill", "decode_step")}
        toks, vision, pos = inputs(seed)
        tk, vj, pj = (jnp.asarray(a) for a in (toks, vision, pos))
        out = {"port": (model, params_t), "inputs": (toks, vision, pos)}
        for name, fns in (("eager", None), ("jit", jitted)):
            def fn(n):
                return fns[n] if fns else getattr(jmodel, n)
            res = {}
            with jax.disable_jit() if name == "eager" \
                    else contextlib.nullcontext():
                for nv in (NV, 0):
                    res[f"forward{nv}"], _ = fn("forward")(
                        params_j, tk[:, :S], vision_embeds=vj[:, :nv],
                        mrope_positions=pj[..., :S])
                res["forward_plain"], _ = fn("forward")(params_j, tk[:, :S])
                for kind, kw, kw1 in (
                        ("mrope", {"mrope_positions": pj[..., :S]},
                         {"mrope_positions": pj[..., S:]}),
                        ("plain", {}, {})):
                    cache = jmodel.init_cache(B, jmodel.cfg.max_cache_len)
                    pre, cache = fn("prefill")(params_j, tk[:, :S], cache,
                                               **kw)
                    dec, _ = fn("decode_step")(params_j, tk[:, S:], cache,
                                               **kw1)
                    res[f"serve_{kind}"] = (pre, dec)
            out[name] = res
        runs[case] = out
    return runs


@pytest.mark.parametrize("nv", [NV, 0])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_with_vision_embeds_matches_jax(case, nv, jax_runs):
    run = jax_runs[case]
    model, params = run["port"]
    toks, vision, pos = run["inputs"]
    got, aux = model.forward(params, torch.as_tensor(toks[:, :S]),
                             vision_embeds=torch.as_tensor(vision[:, :nv]),
                             mrope_positions=torch.as_tensor(pos[..., :S]))
    assert got.shape == (B, S, 256) and got.dtype == torch.bfloat16
    assert aux == 0.0
    eager, jitted = (run[k][f"forward{nv}"] for k in ("eager", "jit"))
    assert rel_err(eager, got) < TIGHT and same_argmax(eager, got)
    assert rel_err(jitted, got) <= rel_err(jitted, eager) + TIGHT


@pytest.mark.parametrize("case", list(CASES))
def test_forward_without_positions_matches_jax(case, jax_runs):
    run = jax_runs[case]
    model, params = run["port"]
    toks = run["inputs"][0]
    got, _ = model.forward(params, torch.as_tensor(toks[:, :S]))
    eager, jitted = (run[k]["forward_plain"] for k in ("eager", "jit"))
    assert rel_err(eager, got) < TIGHT and same_argmax(eager, got)
    assert rel_err(jitted, got) <= rel_err(jitted, eager) + TIGHT


def test_vision_embeds_take_the_first_rows():
    """The splice: the vision rows first, then the token embeddings of the
    first S - nv tokens, cut to S; nv = 0 leaves the embeddings as they
    are; more vision rows than tokens keep the first S of them."""
    model, params = models(2)[2:]
    seen = []

    class Probe(type(model)):
        def _layer(self, lp, x, **kw):
            seen.append(x.detach().clone())
            return super()._layer(lp, x, **kw)
    probe = Probe(model.cfg)
    toks = torch.as_tensor(inputs(2)[0][:, :S]).long()
    vision = torch.randn(B, S + 3, 64, generator=torch.Generator()
                         .manual_seed(2))
    emb = params["embed"][toks].bfloat16()
    for nv, want in ((NV, torch.cat([vision[:, :NV].bfloat16(),
                                     emb[:, :S - NV]], 1)),
                     (0, emb), (S + 3, vision[:, :S].bfloat16())):
        seen.clear()
        probe.forward(params, toks, vision_embeds=vision[:, :nv])
        assert torch.equal(seen[0], want), nv


def test_vlm_without_inputs_is_the_dense_model_bit_for_bit():
    """Without positions and vision embeddings the vlm family computes the
    dense family's function on the same weights: forward, loss and
    gradients, prefill and decode, bit for bit."""
    _, _, model, params = models(3)
    dense = build_model(dataclasses.replace(model.cfg, family="dense",
                                            use_mrope=False))
    toks = torch.as_tensor(inputs(3)[0])
    a, b = (m.forward(params, toks)[0] for m in (model, dense))
    assert torch.equal(a, b)
    grads = []
    for m in (model, dense):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        m.loss_fn(leaves, {"tokens": toks}).backward()
        grads.append([t.grad for _, t in tree_items(leaves)])
    assert all(torch.equal(x, y) for x, y in zip(*grads))
    outs = []
    for m in (model, dense):
        cache = m.init_cache(B, m.cfg.max_cache_len, device="cpu")
        pre, cache = m.prefill(params, toks[:, :S], cache)
        dec, _ = m.decode_step(params, toks[:, S:], cache)
        outs.append((pre, dec))
    assert all(torch.equal(x, y) for x, y in zip(*outs))


def port_serving(model, params, toks, pos=None):
    kw, kw1 = ({"mrope_positions": torch.as_tensor(pos[..., :S])},
               {"mrope_positions": torch.as_tensor(pos[..., S:])}) \
        if pos is not None else ({}, {})
    cache = model.init_cache(B, model.cfg.max_cache_len, device="cpu")
    pre, cache = model.prefill(params, torch.as_tensor(toks[:, :S]), cache,
                               **kw)
    dec, cache = model.decode_step(params, torch.as_tensor(toks[:, S:]),
                                   cache, **kw1)
    assert int(cache.kv.length) == S + 1 and cache.ssm is None
    return pre, dec


@pytest.mark.parametrize("kind", ["mrope", "plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_decode_match_jax(case, kind, jax_runs):
    run = jax_runs[case]
    model, params = run["port"]
    toks, _, pos = run["inputs"]
    got = port_serving(model, params, toks, pos if kind == "mrope" else None)
    eager, jitted = (run[k][f"serve_{kind}"] for k in ("eager", "jit"))
    for g, e, j in zip(got, eager, jitted):
        assert g.shape == (B, 1, 256)
        assert rel_err(e, g) < TIGHT and same_argmax(e, g)
        assert rel_err(j, g) <= rel_err(j, e) + TIGHT
    if kind == "mrope":     # the positions reach the cached path
        plain = port_serving(model, params, toks)
        assert rel_err(eager[1], plain[1]) > TIGHT


def test_prefill_decode_match_forward_with_positions(jax_runs):
    """prefill(S) + decode(1) with positions against forward(S + 1) with
    the same positions, in the port alone: tests/test_archs.py's bound."""
    model, params = jax_runs[0]["port"]
    toks, _, pos = jax_runs[0]["inputs"]
    _, dec = port_serving(model, params, toks, pos)
    full, _ = model.forward(params, torch.as_tensor(toks),
                            mrope_positions=torch.as_tensor(pos))
    ref, got = full[:, S], dec[:, 0]
    assert rel_err(ref, got) < 0.06 and same_argmax(ref, got)


# ------------------------------------------------------------------ train
def vlm_batch(toks, vision, pos) -> dict:
    """The VLM batch: tokens (B, S + 1), vision embeddings and the
    positions of the S input tokens."""
    return {"tokens": toks, "vision_embeds": vision,
            "mrope_positions": pos[..., :S]}


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """JAX's loss and gradients op by op on the VLM batch at the fan-in
    draw, remat on and off, and the loss alone at the reference's draw."""
    batch = vlm_batch(*inputs(4))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for remat in (True, False):
        jmodel, params_j, model, params_t = models(4, "fan-in", remat=remat)
        with jax.disable_jit():
            out[remat] = (model, params_t) + jax.value_and_grad(
                jmodel.loss_fn)(params_j, jbatch)
    jmodel, params_j, _, params_t = models(4)
    with jax.disable_jit():
        out["reference"] = (params_t, jmodel.loss_fn(params_j, jbatch))
    return batch, out


def port_loss_and_grads(model, params, batch):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.loss_fn(leaves, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    loss.backward()
    return loss.detach(), {"/".join(p): t.grad for p, t in tree_items(leaves)}


def jax_by_path(tree) -> dict:
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(remat, jax_loss_and_grads):
    """loss_fn on the VLM batch and every gradient leaf against
    jax.value_and_grad op by op under the same remat setting; the port's
    remat on and off give the same bits; the loss at the reference's draw
    too."""
    batch, runs = jax_loss_and_grads
    model, params, jloss, jgrads = runs[remat]
    assert model.cfg.remat is remat
    loss, grads = port_loss_and_grads(model, params, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-3)
    want = jax_by_path(jgrads)
    assert set(grads) == set(want)
    for k, w in want.items():
        got, w = f32(grads[k]), f32(w)
        assert grads[k].dtype == torch.bfloat16, k
        assert np.abs(got - w).max() <= 2 ** -5 * np.abs(w).max(), k
    other = build_model(dataclasses.replace(model.cfg, remat=not remat))
    loss2, grads2 = port_loss_and_grads(other, params, batch)
    assert float(loss2) == float(loss)
    for k, g in grads.items():
        assert torch.equal(g, grads2[k]), k
    params, jloss = runs["reference"]
    loss, _ = port_loss_and_grads(model, params, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-3)


@pytest.mark.parametrize("policy", ["dots", "names"])
def test_positions_reach_the_selective_remat_policies(policy,
                                                      jax_loss_and_grads):
    """Under the "dots" and "names" policies the positions go through the
    selective checkpoint too: the same loss and gradients, bit for bit, as
    with remat off."""
    batch, runs = jax_loss_and_grads
    model, params = runs[False][:2]
    loss, grads = port_loss_and_grads(model, params, batch)
    other = build_model(dataclasses.replace(model.cfg, remat=True,
                                            remat_policy=policy))
    loss2, grads2 = port_loss_and_grads(other, params, batch)
    assert float(loss2) == float(loss)
    assert all(torch.equal(g, grads2[k]) for k, g in grads.items())


def test_two_microbatch_step_cuts_vision_and_positions_alike(monkeypatch):
    """A 2-microbatch train step on a VLM batch of 4 rows: the step's
    gradient (captured where it enters AdamW) is the mean of JAX's op-by-op
    gradients on the two halves, each half cut by the reference's reshape
    (vision embeddings and tokens on axis 0, the positions on axis 1),
    within the loss-gradient rule; and its loss their mean."""
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 256, size=(4, S + 1)).astype(np.int32)
    vision = rng.normal(size=(4, NV, 64)).astype(np.float32)
    pos = positions(S, GRIDS + ((1, 8), (8, 1)))   # the halves differ
    batch = {"tokens": toks, "vision_embeds": vision,
             "mrope_positions": pos}
    jmodel, params_j, model, params_t = models(8, "fan-in", microbatches=2)
    halves = []
    with jax.disable_jit():
        for i in range(2):
            half = {"tokens": toks[2 * i:2 * i + 2],
                    "vision_embeds": vision[2 * i:2 * i + 2],
                    "mrope_positions": pos[:, 2 * i:2 * i + 2]}
            halves.append(jax.value_and_grad(jmodel.loss_fn)(
                params_j, {k: jnp.asarray(v) for k, v in half.items()}))
    seen = []
    update = train_lib.adamw_update
    monkeypatch.setattr(train_lib, "adamw_update",
                        lambda p, g, *a: seen.append(g) or update(p, g, *a))
    cfg = AdamWConfig()
    _, metrics = build_train_step(model, cfg)(
        TrainState(params_t, adamw_init(params_t, cfg)),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    want_loss = (float(halves[0][0]) + float(halves[1][0])) / 2
    assert float(metrics["loss"]) == pytest.approx(want_loss, rel=1e-3)
    (grads,) = seen
    got = {"/".join(p): t for p, t in tree_items(grads)}
    a, b = (jax_by_path(h[1]) for h in halves)
    for k in a:
        w = (f32(a[k]) + f32(b[k])) / 2
        assert got[k].dtype == torch.float32, k
        assert np.abs(f32(got[k]) - w).max() <= 2 ** -5 * np.abs(w).max(), k


def test_split_microbatches_cuts_vision_embeds_on_rows():
    toks, vision, pos = inputs(9)
    parts = train_lib.split_microbatches(
        {k: torch.as_tensor(v) for k, v in
         vlm_batch(toks, vision, pos).items()}, 2)
    for i, part in enumerate(parts):
        assert torch.equal(part["vision_embeds"],
                           torch.as_tensor(vision[i:i + 1]))
        assert torch.equal(part["mrope_positions"],
                           torch.as_tensor(pos[:, i:i + 1, :S]))
