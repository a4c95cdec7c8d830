"""The port's ``hybrid`` family (jamba-1.5-large-398b: Mamba-2, attention
and MoE sublayers in super-blocks) against the JAX package's, with the JAX
weights carried across by ``params_from_numpy``.

Two reduced configs, both with d_model 64, 4 heads over 2 KV heads of 16,
8 experts top-2, 8 SSM heads of P = 16, N = 16, vocab 256:

* ``p8``: ``reduced()`` itself, one super-block of the published period 8
  (attention at sublayer 3, 7 Mamba sublayers, MoE on the odd ones);
* ``p4x2``: period 4 over 8 layers, two super-blocks of 3 Mamba sublayers,
  attention at 3 and MoE at 1 and 3, so that the block axis, its stacked
  cache and the per-block loop all run with nb = 2. The card runs one
  full-width block of this period (``chip_smoke.py``), a different model
  from jamba's 1:7 interleave.

Tolerances, and why:

* the model against JAX run op by op (``jax.disable_jit()``, which rounds
  bf16 after every op as the port does): logits within 2^-6 of their
  largest magnitude with equal argmax (tests/test_torch_lm.py's rule: a
  few bf16 ulps of sums taken in another order), the aux loss within 1e-5
  relative (fp32 means over the same routing, of router probabilities
  whose inputs carry those ulps); the caches after prefill + decode
  within 2^-6 of their largest magnitude (the K/V rows are bf16 products
  of those inputs; the fp32 SSM states sum bf16 inputs that carry the
  same ulps);
* prefill(S) + decode(1) against forward(S + 1) in the port alone:
  tests/test_archs.py's bound, rel < 0.06 and equal argmax, with the
  capacity factor at 8.0 as that test sets it, on the weights and tokens
  that test holds the JAX package's jamba to. The bound is a property of
  those draws: on others a top-2 choice at the decode token falls the
  other way at a near-tie in one MoE sublayer and the two paths part by
  0.3-1.0 of the largest logit, in JAX as in the port (the port follows
  JAX op by op on both paths, below);
* loss and gradients against ``jax.value_and_grad`` op by op: loss 1e-3
  relative, each leaf within 2^-5 of its norm, ||port - JAX|| / ||JAX||
  (the card's train-check rule in chip_smoke.py, 3e-2), on weights whose
  attention is drawn at fan-in std, as the vlm and encoder-decoder
  gradient tests draw it (at the reference's draw the softmax saturates,
  ROADMAP §C). Through 8 sublayers the largest element of a leaf whose
  terms cancel (A_log, conv_B) moves more: the port reads 3.7-4.9% of the
  largest magnitude there and at most 2.4% of any leaf's norm, where
  jitted JAX parts from its own op-by-op run by 6.6% (p8) and 18% (p4x2)
  of a leaf's norm, so tests/test_torch_train.py's element rule would hold
  rounding, not the port. A gradient is
  held only where both sides route every token alike: one (token, k)
  choice apart moves an expert leaf's gradient by a whole token's share
  (0.20 of w_down's largest magnitude on one p4x2 draw). So the forward test
  first asserts each MoE call's top-k equal on both sides, on the weights
  and tokens the gradients are taken on;
* the remat policies change what the backward recomputes, never a value:
  bit-equal to remat off.

The reference's MoE layer runs without its ``shard_map`` over the 1 x 1
mesh (the autouse ``one_device_moe``), which changes no bit
(tests/test_torch_moe.py). The JAX runs are made once a module (fixtures)
and shared by the tests that read them.
"""

import collections
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.models.moe as jax_moe_mod
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.launch import train as train_mod
from repro_torch.models import LM, build_model, params_from_numpy
from repro_torch.models.param import param_count, tree_items, tree_map

ARCH = "jamba-1.5-large-398b"
TIGHT = 2.0 ** -6
B, S = 2, 16
GEN = 5                   # tokens serve_loop generates here
# the chunking and cache length serve_loop sets for S-token prompts, so
# that the op-by-op runs compile each primitive at one set of shapes
SERVE = {"q_chunk": 16, "kv_chunk": 16, "max_cache_len": S + GEN}
# case -> (config fields replaced on both sides, weight and input seed)
# (p4x2's draw is one on which both sides route every token alike, as the
# forward and gradient tests assert: at seed 3 one choice falls the other
# way at a near-tie, and the expert leaves' gradients part by up to 0.20)
CASES = {"p8": ({}, 0), "p4x2": ({"hybrid_period": 4, "n_layers": 8}, 4)}
# the card's cut: one super-block of period 4 at full width
CARD_CUT = {"hybrid_period": 4, "n_layers": 4}


@pytest.fixture(autouse=True)
def one_device_moe(monkeypatch):
    monkeypatch.setattr(jax_moe_mod, "shard_map", lambda f, **_: f)
    monkeypatch.setattr(jax_moe_mod, "model_axis", lambda mesh=None: None)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_err(ref, got) -> float:
    ref, got = f32(ref), f32(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def same_argmax(ref, got) -> bool:
    return bool((f32(ref).argmax(-1) == f32(got).argmax(-1)).all())


def configs(reduced=True, **over):
    return tuple(dataclasses.replace(get(ARCH, reduced=reduced), **over)
                 for get in (jax_get_config, get_config))


def fan_in(params):
    """The reference's weights with the attention's wq, wk, wv and wo
    rescaled to std 1/sqrt(fan-in) (d_model 64; H * D for wo), as
    tests/test_torch_vlm.py rescales them; the leading block axis leaves
    the heads at shape[-2] (wq, wk, wv) and shape[-3] (wo)."""
    at = dict(params["layers"]["attn"])
    for n in ("wq", "wk", "wv"):
        at[n] = (at[n].astype(jnp.float32) * np.sqrt(
            at[n].shape[-2] / 64)).astype(jnp.bfloat16)
    at["wo"] = (at["wo"].astype(jnp.float32) / np.sqrt(
        at["wo"].shape[-3])).astype(jnp.bfloat16)
    return {**params, "layers": {**params["layers"], "attn": at}}


_DRAWS = {}


def jax_draw(jmodel, seed: int):
    """The JAX package's ``init_params`` of ``jmodel`` from ``key(seed)``,
    compiled as one program (leaf by leaf, op by op, it takes ~18 s), once
    for each set of leaf shapes."""
    decls = jmodel.param_decls()
    shapes = repr(jax.tree.map(lambda d: d.shape, decls,
                               is_leaf=lambda d: hasattr(d, "initializer")))
    if shapes not in _DRAWS:
        _DRAWS[shapes] = jax.jit(lambda key: jax_init_params(decls, key))
    return _DRAWS[shapes](jax.random.key(seed))


def models(case, draw="reference", **more):
    """JAX's model and weights of ``case`` (the reference's draw, or with
    the attention at fan-in std), the port's model and the same weights
    carried across; ``more`` replaces further config fields on both."""
    over, seed = CASES[case]
    jcfg, tcfg = configs(**{**SERVE, **over, **more})
    jmodel = jax_build_model(jcfg)
    params_j = jax_draw(jmodel, seed)
    if draw == "fan-in":
        params_j = fan_in(params_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return jmodel, params_j, build_model(tcfg), params_t


def tokens(seed, rows=B, cols=S + 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, size=(rows, cols)).astype(np.int32)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}


# ----------------------------------------------------------------- config
@pytest.mark.parametrize("reduced", [True, False])
def test_config_matches_jax_field_by_field(reduced):
    jcfg, tcfg = configs(reduced)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.d_inner, tcfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads)
    if not reduced:       # the published shapes of every sublayer
        assert (tcfg.family, tcfg.n_layers, tcfg.d_model, tcfg.n_heads,
                tcfg.n_kv_heads, tcfg.head_dim, tcfg.d_ff, tcfg.n_experts,
                tcfg.top_k, tcfg.ssm_heads, tcfg.ssm_head_dim,
                tcfg.ssm_state, tcfg.vocab, tcfg.hybrid_period,
                tcfg.hybrid_attn_index, tcfg.hybrid_moe_every) == \
            ("hybrid", 72, 8192, 64, 8, 128, 24576, 16, 2, 256, 64, 128,
             65536, 8, 3, 2)


# (name, reduced, fields replaced): the reduced period 8, one block; the
# reduced period 4, two blocks; the card's cut, full width
SCHEMAS = [("p8", True, {}), ("p4x2", True, CASES["p4x2"][0]),
           ("card-cut", False, CARD_CUT)]


@pytest.mark.parametrize("name,reduced,over", SCHEMAS)
def test_param_schema_matches_jax(name, reduced, over):
    """Same tree paths, shapes, logical axes and dtypes as the JAX
    package's ``LM.param_decls()``: a leading block axis on every leaf;
    Mamba stacked period - 1, MoE period // moe_every, MLP the rest."""
    jcfg, tcfg = configs(reduced, **over)
    jdecls = _paths(jax_build_model(jcfg).param_decls())
    tdecls = _paths(build_model(tcfg).param_decls())
    assert set(jdecls) == set(tdecls)
    for path, jd in jdecls.items():
        td = tdecls[path]
        assert tuple(jd.shape) == td.shape, path
        assert tuple(jd.axes) == td.axes, path
        assert jnp.dtype(jd.dtype).name == str(td.dtype).split(".")[1], path
    per = tcfg.hybrid_period
    lead = (tcfg.n_layers // per,)
    assert tdecls[("layers", "mamba", "w_x")].shape[:2] == lead + (per - 1,)
    assert tdecls[("layers", "moe", "w_up")].shape[:2] == lead + (per // 2,)
    assert tdecls[("layers", "mlp", "w_up")].shape[:2] == lead + (per // 2,)
    assert tdecls[("layers", "attn", "wq")].shape[0] == lead[0]
    assert tdecls[("layers", "ln_mix")].shape == lead + (per, tcfg.d_model)
    if name == "card-cut":
        # one period-4 block at full width: 22.98 B parameters, 45.96 GB
        n = param_count(build_model(tcfg).param_decls())
        assert 22.97e9 < n < 22.99e9


def test_full_depth_parameter_count():
    """72 layers, 9 period-8 blocks: 397.7 B parameters (795 GB of bf16)."""
    n = param_count(build_model(get_config(ARCH)).param_decls())
    assert 397.6e9 < n < 397.8e9


# ------------------------------------------------------------ JAX's runs
@contextlib.contextmanager
def record_jax_routes(seen: list):
    """Context: each MoE call of the JAX model appends its top-k experts
    (T, k), as its ``moe`` ranks them, to ``seen`` (op by op only)."""
    import repro.models.lm as jax_lm
    moe = jax_lm.moe

    def recording(params, x, cfg):
        logits = jnp.einsum("bsm,me->bse", x.astype(jnp.float32),
                            params["router"])
        topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)[1]
        seen.append(np.asarray(topi).reshape(-1, cfg.top_k))
        return moe(params, x, cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lm, "moe", recording)
        yield


@pytest.fixture(scope="module")
def jax_runs():
    """For each case, at the fan-in draw, op by op: the JAX model's
    forward over S tokens (logits, aux and each MoE call's top-k),
    prefill(S) + decode(1) with the cache after, and the loss and every
    gradient of loss_fn on the same S + 1 tokens (whose forward takes the
    same S)."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_moe_mod, "shard_map", lambda f, **_: f)
        mp.setattr(jax_moe_mod, "model_axis", lambda mesh=None: None)
        for case, (_, seed) in CASES.items():
            # remat off: it changes no value op by op, and jax.checkpoint
            # traces its body even then, where the recorder reads
            # concrete values
            jmodel, params_j, model, params_t = models(case, "fan-in",
                                                       remat=False)
            model = build_model(dataclasses.replace(model.cfg, remat=True))
            toks = tokens(seed)
            tk = jnp.asarray(toks)
            routes = []
            with jax.disable_jit():
                with record_jax_routes(routes):
                    logits, aux = jmodel.forward(params_j, tk[:, :S])
                cache = jmodel.init_cache(B, jmodel.cfg.max_cache_len)
                pre, cache = jmodel.prefill(params_j, tk[:, :S], cache)
                dec, cache = jmodel.decode_step(params_j, tk[:, S:], cache)
                loss, grads = jax.value_and_grad(jmodel.loss_fn)(
                    params_j, {"tokens": tk})
            runs[case] = {"port": (model, params_t), "jax": params_j,
                          "tokens": toks,
                          "forward": (logits, aux, routes),
                          "serve": (pre, dec), "cache": cache,
                          "grads": (loss, grads)}
    return runs


def port_serving(model, params, toks):
    cache = model.init_cache(B, model.cfg.max_cache_len, device="cpu")
    pre, cache = model.prefill(params, torch.as_tensor(toks[:, :S]), cache)
    dec, cache = model.decode_step(params, torch.as_tensor(toks[:, S:]),
                                   cache)
    return pre, dec, cache


@contextlib.contextmanager
def record_port_routes(seen: list):
    """Context: each MoE call of the port appends its top-k experts (T, k)
    to ``seen``."""
    import importlib
    moe_mod = importlib.import_module("repro_torch.models.moe")
    route = moe_mod._route

    def recording(router, x, cfg):
        topi, gates, aux = route(router, x, cfg)
        seen.append(topi.numpy())
        return topi, gates, aux
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe_mod, "_route", recording)
        yield


def assert_routes_equal(got: list, want: list, cfg, recomputed: bool):
    """Call by call, the port's top-k equal to JAX's forward's; where the
    backward ``recomputed`` the blocks (remat), their calls follow the
    forward's again, the last block's first."""
    per = cfg.hybrid_period // cfg.hybrid_moe_every
    blocks = [want[i:i + per] for i in range(0, len(want), per)]
    expect = want + [c for b in blocks[::-1] for c in b] if recomputed \
        else want
    assert len(got) == len(expect)
    for i, (a, b) in enumerate(zip(got, expect)):
        assert np.array_equal(a, b), i


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("case", list(CASES))
def test_forward_aux_and_routing_match_jax(case, jax_runs):
    """The logits, the summed aux loss and, call by call, every MoE
    sublayer's top-k experts: equal to JAX's."""
    run = jax_runs[case]
    model, params = run["port"]
    routes = []
    with record_port_routes(routes):
        got, aux = model.forward(params,
                                 torch.as_tensor(run["tokens"][:, :S]))
    want, want_aux, want_routes = run["forward"]
    assert got.shape == (B, S, 256) and got.dtype == torch.bfloat16
    assert rel_err(want, got) < TIGHT and same_argmax(want, got)
    # the blocks' MoE sublayers' summed load-balance losses (~1 each)
    assert aux.dtype == torch.float32
    n_moe = model.cfg.n_layers // model.cfg.hybrid_moe_every
    assert 0.5 * n_moe < float(aux) < 2.0 * n_moe
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    assert len(want_routes) == n_moe
    assert_routes_equal(routes, want_routes, model.cfg, recomputed=False)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_decode_and_caches_match_jax(case, jax_runs):
    """Logits of prefill(S) and decode(1); then the caches: K/V stacked
    (nb, B, max_len, Hk, D) with one device-side length S + 1 (the
    reference broadcasts it per block), and each block's SSM state and
    conv tails stacked (nb, period - 1, ...)."""
    run = jax_runs[case]
    model, params = run["port"]
    pre, dec, cache = port_serving(model, params, run["tokens"])
    for got, want in zip((pre, dec), run["serve"]):
        assert got.shape == (B, 1, 256)
        assert rel_err(want, got) < TIGHT and same_argmax(want, got)
    jcache, cfg = run["cache"], model.cfg
    nb, nm = cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period - 1
    assert cache.kv.length.shape == () and int(cache.kv.length) == S + 1
    assert (np.asarray(jcache.kv.length) == S + 1).all()
    assert cache.kv.k.shape == (nb, B, cfg.max_cache_len, 2, 16)
    for name in ("k", "v"):
        got, want = getattr(cache.kv, name), getattr(jcache.kv, name)
        assert rel_err(want[:, :, :S + 1], got[:, :, :S + 1]) < TIGHT
        assert not bool(got[:, :, S + 1:].any())
    for name in ("state", "conv_x", "conv_B", "conv_C"):
        got, want = getattr(cache.ssm, name), getattr(jcache.ssm, name)
        assert got.shape[:2] == (nb, nm) and got.shape == want.shape, name
        assert got.dtype == torch.float32
        assert rel_err(want, got) < TIGHT, name


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_decode_match_forward(case):
    """prefill(S) + decode(1) ≍ forward(S + 1) in the port alone, on
    tests/test_archs.py's draws (weights from key 0, tokens from key 2)
    and its bound, the capacity factor at 8.0 so that capacity cannot
    couple the token sets."""
    over = CASES[case][0]
    jcfg, tcfg = configs(**over, capacity_factor=8.0)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_draw(
        jax_build_model(jcfg), 0)), "cpu")
    model = build_model(tcfg)
    toks = np.array(jax.random.randint(jax.random.split(
        jax.random.key(2), 4)[1], (B, S + 1), 0, 256))
    _, dec, _ = port_serving(model, params, toks)
    full, _ = model.forward(params, torch.as_tensor(toks))
    assert rel_err(full[:, S], dec[:, 0]) < 0.06
    assert same_argmax(full[:, S], dec[:, 0])


def test_cache_is_written_in_place():
    """The cache the entry points return holds the buffers of the one
    given: K/V rows 0..S-1 written at prefill, every block's SSM state and
    conv tails filled; no row past the length touched."""
    _, _, model, params = models("p4x2")
    cache = model.init_cache(B, model.cfg.max_cache_len, device="cpu")
    ptrs = [t.data_ptr() for t in (*cache.kv[:2], *cache.ssm)]
    _, out = model.prefill(params, torch.as_tensor(tokens(3)[:, :S]), cache)
    assert [t.data_ptr() for t in (*out.kv[:2], *out.ssm)] == ptrs
    assert out.kv.length is not cache.kv.length and int(out.kv.length) == S
    assert int(cache.kv.length) == 0
    assert bool(out.kv.k[:, :, S - 1].any()) and not out.kv.k[:, :, S:].any()
    state = out.ssm.state
    assert all(bool(state[b, m].any()) for b in range(2) for m in range(3))


def test_decode_carries_the_prefill_state():
    """A decode step from a zeroed SSM state gives other logits than from
    the state prefill left, and attention at sublayer 2 in place of 3
    another model, each by more than the port-vs-JAX rule
    (chip_smoke.py plants both faults on the card)."""
    _, _, model, params = models("p8")
    toks = tokens(4)
    _, dec, _ = port_serving(model, params, toks)
    cache = model.init_cache(B, model.cfg.max_cache_len, device="cpu")
    _, cache = model.prefill(params, torch.as_tensor(toks[:, :S]), cache)
    cache.ssm.state.zero_()
    cold, _ = model.decode_step(params, torch.as_tensor(toks[:, S:]), cache)
    assert rel_err(dec, cold) > TIGHT
    moved = build_model(dataclasses.replace(model.cfg, hybrid_attn_index=2))
    a, b = (m.forward(params, torch.as_tensor(toks[:, :S]))[0]
            for m in (model, moved))
    assert rel_err(a, b) > TIGHT


# ------------------------------------------------------------------ train
def port_loss_and_grads(model, params, toks):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.loss_fn(leaves, {"tokens": torch.as_tensor(toks)})
    loss.backward()
    return loss.detach(), {"/".join(p): t.grad for p, t in tree_items(leaves)}


def jax_by_path(tree) -> dict:
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case, remat, jax_runs):
    """loss_fn (cross entropy + AUX_COEF x the summed aux) and every
    gradient leaf, each in its parameter's dtype (the SSM's dt_bias, A_log
    and D and the MoE router in fp32), against JAX's op-by-op run; every
    leaf gets a gradient. The rule holds only where both sides route
    alike, so the port's routing in this very run (the forward's, and
    under remat its recomputation's) is first held to JAX's forward's."""
    run = jax_runs[case]
    model, params = run["port"]
    jloss, jgrads = run["grads"]
    model = build_model(dataclasses.replace(model.cfg, remat=remat))
    routes = []
    with record_port_routes(routes):
        loss, grads = port_loss_and_grads(model, params, run["tokens"])
    assert_routes_equal(routes, run["forward"][2], model.cfg,
                        recomputed=remat)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-3)
    want = jax_by_path(jgrads)
    assert set(grads) == set(want)
    dtypes = {"/".join(p): t.dtype for p, t in tree_items(params)}
    for k, w in want.items():
        assert grads[k].dtype == dtypes[k], k
        got, w = f32(grads[k]), f32(w)
        assert np.abs(w).max() > 0, k
        assert np.linalg.norm(got - w) <= 2 ** -5 * np.linalg.norm(w), k


class _OpCounts(TorchDispatchMode):
    """Calls of each op (by its packet's name) while the mode is on."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["full", "dots", "names"])
def test_remat_policies_give_remat_offs_gradients(policy, jax_runs):
    """Each policy on the two-block model: the loss and every gradient
    bit-equal to remat off. The reference's hybrid block marks no MoE
    output, so "names" marks nothing and saves nothing (it recomputes the
    matrix products, as "full" does); "dots" recomputes none of them."""
    run = jax_runs["p4x2"]
    (model, params), toks = run["port"], run["tokens"]
    off = build_model(dataclasses.replace(model.cfg, remat=False))
    on = build_model(dataclasses.replace(model.cfg, remat=True,
                                         remat_policy=policy))
    counts = {}
    for name, m in (("off", off), ("on", on)):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with _OpCounts() as fwd:
            loss = m.loss_fn(leaves, {"tokens": torch.as_tensor(toks)})
        with _OpCounts() as bwd:
            loss.backward()
        counts[name] = (loss.detach(), [t.grad for _, t in
                                        tree_items(leaves)], fwd.n, bwd.n)
    (l_off, g_off, _, b_off), (l_on, g_on, f_on, b_on) = counts.values()
    assert float(l_on) == float(l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    assert f_on["repro_torch.checkpoint_name"] == 0

    def products(n):
        return n["aten.mm"] + n["aten.bmm"]
    if policy == "dots":
        assert products(b_on) == products(b_off)
    else:
        assert products(b_on) > products(b_off)


# ---------------------------------------------------------------- drivers
def test_serve_loop_matches_jax(monkeypatch, jax_runs):
    """serve_loop on the CPU (period 8, one block), run on the JAX weights
    with a model that records each step's logits: every step matches JAX's
    greedy loop op by op within the model-level bound (rel < 0.06) and
    picks the same token."""
    batch, prompt_len, gen = B, S, GEN
    params_t, params_j = jax_runs["p8"]["port"][1], jax_runs["p8"]["jax"]
    # serve_loop's config: the reduced one, chunked and cached as SERVE
    jmodel = jax_build_model(configs(**SERVE)[0])
    steps = []

    class Recording(LM):
        def _apply_cached(self, params, tokens, cache, **kw):
            logits, cache = super()._apply_cached(params, tokens, cache,
                                                  **kw)
            steps.append(logits[:, -1].float())
            return logits, cache

    monkeypatch.setattr(serve, "build_model", Recording)
    monkeypatch.setattr(serve, "init_params", lambda *a, **k: params_t)
    out = serve.serve_loop(ARCH, batch=batch, prompt_len=prompt_len,
                           gen_tokens=gen, seed=0, device="cpu",
                           reduced=True)
    assert out["tokens"].shape == (batch, gen) and len(steps) == gen
    assert torch.equal(out["logits"], steps[-1])
    cfg = jmodel.cfg
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


def test_serve_loop_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve_loop(ARCH, batch=1, prompt_len=16, gen_tokens=2,
                         reduced=True)


@pytest.fixture
def card_of_80_gib(monkeypatch):
    """An 80 GiB card as far as the drivers can see; the first thing each
    allocates after its size check (the serving weights' generator, the
    training build) stops the run and is recorded."""
    class Props:
        total_memory = 80 * 2 ** 30
    made = []

    def stop(*args, **kw):
        made.append(1)
        raise RuntimeError("stop")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    monkeypatch.setattr(torch, "Generator", stop)
    monkeypatch.setattr(train_mod._build, "build", stop)
    return made


def cut(monkeypatch, module):
    full = module.get_config
    monkeypatch.setattr(module, "get_config", lambda arch, reduced=False:
                        dataclasses.replace(full(arch), **CARD_CUT))


def test_full_depth_serving_on_one_card_raises(monkeypatch, card_of_80_gib):
    """At 72 layers jamba's weights are 795 GB: serve_loop raises
    ValueError naming A.12 before it draws a weight; one period-4 block
    (45.96 GB) passes the check."""
    with pytest.raises(ValueError, match=r"A\.12.*cut depth"):
        serve.serve_loop(ARCH, device="cuda")
    assert not card_of_80_gib
    cut(monkeypatch, serve)
    with pytest.raises(RuntimeError, match="stop"):
        serve.serve_loop(ARCH, device="cuda")
    assert card_of_80_gib


def test_training_on_one_card_raises(monkeypatch, card_of_80_gib):
    """Training state, 12 bytes a parameter: 4.77 TB at 72 layers, and
    276 GB for one period-4 block (one MoE sublayer alone is 9.66 B
    parameters): train_loop raises ValueError naming A.12 before it builds
    anything, at either depth."""
    with pytest.raises(ValueError, match=r"A\.12.*cut depth"):
        train_mod.train_loop(ARCH, steps=1, device="cuda")
    cut(monkeypatch, train_mod)
    with pytest.raises(ValueError, match=r"A\.12"):
        train_mod.train_loop(ARCH, steps=1, device="cuda")
    assert not card_of_80_gib
