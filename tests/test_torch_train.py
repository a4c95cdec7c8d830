"""Training of the port against the JAX package's: cross entropy, the
optimizer, ``loss_fn`` and its gradients, remat, the composed train step,
microbatches, ``train_loop`` and the gradient of the flash kernel's plain
version. Reduced tinyllama-1.1b (4 layers, d_model 64, vocab 256) with the
JAX weights carried across; everything on the CPU.

Tolerances, and why:

* cross entropy, schedule, clipping, AdamW: fp32 arithmetic op for op as the
  reference; 1e-6 relative (sums taken in another order), bf16 parameters
  within one bf16 rounding (2^-8 relative);
* ``loss_fn`` and its gradients against ``jax.value_and_grad`` run op by op
  (``jax.disable_jit()``, which rounds bf16 after every op as the port
  does): loss 1e-3 relative, each leaf's gradient max |diff| <= 2^-5 of its
  largest magnitude (a few bf16 ulps of sums taken in another order);
* the composed train step: exactly JAX's ``adamw_update`` applied to the
  port's own gradients (bf16 parameters within one rounding), and the loss
  trajectory of four steps on one batch within 5e-2 relative of JAX's jitted
  step. That bound is loose for a reason: Adam's first steps move each bf16
  weight by about +-lr whatever its gradient's size, so rounding-level
  gradient differences flip the sign of a share of those moves (JAX's own
  op-by-op and jitted runs differ by 1e-2 after one step).
"""

import collections
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

import repro.optim.adamw as jax_adamw
from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models.common import cross_entropy_loss as jax_cross_entropy
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd_plain)
from repro_torch.kernels.ssd import ssd
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import cross_entropy_loss
from repro_torch.models.param import tree_items, tree_map
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, warmup_cosine)
from repro_torch.optim.adamw import _no_decay
from repro_torch.runtime import TrainState, build_train_step
from repro_torch.runtime.train_lib import split_microbatches

ARCH = "tinyllama-1.1b"


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def by_path(tree) -> dict:
    """A JAX tree as {'a/b/c': leaf}."""
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_by_path(tree) -> dict:
    return {"/".join(path): leaf for path, leaf in tree_items(tree)}


def jax_models(seed=0, arch=ARCH, pad=None):
    """JAX's reduced model and weights, and the port's model; ``pad`` sets
    ``pad_heads_to`` on both, which ``reduced()`` resets."""
    jcfg, tcfg = (dataclasses.replace(get(arch, reduced=True),
                                      pad_heads_to=pad)
                  for get in (jax_get_config, get_config))
    jmodel = jax_build_model(jcfg)
    params = jax_init_params(jmodel.param_decls(), jax.random.key(seed))
    return jmodel, params, build_model(tcfg)


def tokens(seed, batch=2, seq=32) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (batch, seq + 1)).astype(np.int32)


def port_grads(model, params, toks, **batch_extra):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.loss_fn(leaves, {"tokens": torch.as_tensor(toks),
                                  **batch_extra})
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, leaves)


# ------------------------------------------------------------- the loss
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(dtype, masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 17)) * 3).astype(np.float32)
    labels = rng.integers(0, 17, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked else None
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    want = jax_cross_entropy(jl, jnp.asarray(labels),
                             None if mask is None else jnp.asarray(mask))
    tl = torch.as_tensor(logits).to(getattr(torch, dtype))
    got = cross_entropy_loss(tl, torch.as_tensor(labels),
                             None if mask is None else torch.as_tensor(mask))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_cross_entropy_empty_mask_is_zero():
    logits = torch.randn(2, 3, 7)
    labels = torch.zeros(2, 3, dtype=torch.int64)
    assert float(cross_entropy_loss(logits, labels,
                                    torch.zeros(2, 3))) == 0.0


# ------------------------------------------------------------ optimizer
def test_warmup_cosine_matches_jax():
    for cfg in (dict(lr=1.0, warmup_steps=10, total_steps=100),
                dict(lr=3e-4, warmup_steps=0, total_steps=7),
                dict(lr=1e-3, warmup_steps=5, total_steps=5)):
        jcfg, tcfg = jax_adamw.AdamWConfig(**cfg), AdamWConfig(**cfg)
        for s in range(0, 120, 3):
            want = float(jax_adamw.warmup_cosine(jcfg, jnp.asarray(s)))
            got = float(warmup_cosine(tcfg, torch.tensor(s, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_warmup_cosine_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(warmup_cosine(cfg, torch.tensor(s))) for s in range(100)]
    assert lrs[0] == pytest.approx(0.0)
    assert lrs[10] == pytest.approx(1.0, abs=0.1)
    assert lrs[99] < 0.2
    assert min(lrs[10:]) >= 0.1 - 1e-6         # the 10% floor
    assert max(lrs) <= 1.0 + 1e-6


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((10,)).astype(np.float32) * 10,
         "b": {"c": rng.standard_normal((3, 4)).astype(np.float32)}}
    jc, jgn = jax_adamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), max_norm)
    tc, tgn = clip_by_global_norm(tree_map(torch.as_tensor, g), max_norm)
    assert float(tgn) == pytest.approx(float(jgn), rel=1e-6)
    for k, v in by_path(jc).items():
        np.testing.assert_allclose(f32(port_by_path(tc)[k]), f32(v),
                                   rtol=1e-6)
    if max_norm == 1.0:
        norm = float(torch.sqrt(sum(t.square().sum() for _, t in
                                    tree_items(tc))))
        assert norm == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-370m"])
def test_no_decay_matches_jax_leaf_by_leaf(arch):
    jmodel = jax_build_model(jax_get_config(arch))
    jpaths = jax.tree_util.tree_flatten_with_path(jmodel.param_decls(),
                                                  is_leaf=lambda x: hasattr(
                                                      x, "shape"))[0]
    want = {"/".join(str(k.key) for k in path): jax_adamw._no_decay(path)
            for path, _ in jpaths}
    got = {"/".join(path): _no_decay(path) for path, _ in
           tree_items(build_model(get_config(arch)).param_decls())}
    assert got == want
    assert any(got.values()) and not all(got.values())


def test_no_decay_rule():
    assert _no_decay(("layers", "ln1"))
    assert _no_decay(("layers", "attn", "q_norm"))
    assert _no_decay(("layers", "mamba", "A_log"))
    assert not _no_decay(("layers", "attn", "wq"))


def test_adamw_update_matches_jax_three_steps():
    """The same numpy parameters (bf16 and fp32 leaves, decayed and not) and
    the same gradients, three steps, clipping active at the second."""
    rng = np.random.default_rng(2)
    p_np = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "ln1": rng.standard_normal((5,)).astype(np.float32),
            "layers": {"wq": rng.standard_normal((3, 4)).astype(np.float32)}}
    bf16 = {"w"}
    jp = {k: (jnp.asarray(v, jnp.bfloat16) if k in bf16 else
              jax.tree.map(jnp.asarray, v)) for k, v in p_np.items()}
    tp = to_torch(jp)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1,
               clip_norm=5.0)
    jcfg, tcfg = jax_adamw.AdamWConfig(**cfg), AdamWConfig(**cfg)
    jstate, tstate = jax_adamw.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for step, scale in enumerate((0.1, 10.0, 1.0)):
        g_np = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(
                np.float32), p_np)
        jp, jstate, jm = jax_adamw.adamw_update(
            jp, jax.tree.map(jnp.asarray, g_np), jstate, jcfg)
        tp, tstate, tm = adamw_update(tp, tree_map(torch.as_tensor, g_np),
                                      tstate, tcfg)
        assert int(tstate.step) == step + 1
        assert tstate.step.dtype == torch.int32
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for tree_j, tree_t, rtol in ((jp, tp, 2 ** -8),
                                     (jstate.m, tstate.m, 1e-5),
                                     (jstate.v, tstate.v, 1e-5)):
            tt = port_by_path(tree_t)
            for k, v in by_path(tree_j).items():
                assert tt[k].dtype == (torch.bfloat16 if v.dtype ==
                                       jnp.bfloat16 else torch.float32)
                np.testing.assert_allclose(f32(tt[k]), f32(v), rtol=rtol,
                                           atol=1e-7)


@pytest.mark.parametrize("limit", [1, 7, 20, 41])
def test_adamw_in_row_slices_is_the_whole_leaf_update(monkeypatch, limit):
    """The update a row slice at a time (``SLICE_ELEMENTS`` set to
    ``limit``: one element, slices that cut a row, rows whole and a
    leaf's dim 0 in uneven slices) gives the whole-leaf update's
    parameters and moments bit for bit, three steps with clipping and
    weight decay, bf16 and fp32 leaves of 0 to 3 dims; and so does a
    sharded update's region (ZeRO-1's moments over part of a shard)."""
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.optim import OptState
    rng = np.random.default_rng(3)

    def draw(shape, dtype):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    params = {"w": draw((6, 5), torch.bfloat16),
              "ln1": draw((5,), torch.float32),
              "layers": {"wq": draw((3, 4, 7), torch.bfloat16)},
              "scale": draw((), torch.float32)}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                      weight_decay=0.1, clip_norm=5.0)
    runs = []
    for sliced in (False, True):
        with monkeypatch.context() as mp:
            if sliced:
                mp.setattr(adamw_mod, "SLICE_ELEMENTS", limit)
                assert len(list(adamw_mod._pieces((3, 4, 7)))) > 1
            tp = tree_map(lambda a: a.clone(), params)
            state = adamw_init(tp, cfg)
            grng = np.random.default_rng(4)
            for scale in (0.1, 10.0, 1.0):
                g = tree_map(lambda a: torch.as_tensor(
                    grng.standard_normal(tuple(a.shape)).astype(np.float32)
                    * scale), tp)
                tp, state, _ = adamw_update(tp, g, state, cfg)
            region = (slice(1, 3), slice(None), slice(2, 7))
            wq = params["layers"]["wq"].clone()
            m = torch.zeros((2, 4, 5))
            adamw_mod._update({"wq": wq}, {"wq": torch.ones_like(wq)},
                              OptState(torch.zeros((), dtype=torch.int32),
                                       {"wq": m}, {"wq": m.clone()}),
                              cfg, torch.tensor(3.0), [region])
            runs.append((tp, state, wq, m))
    (p0, s0, w0, m0), (p1, s1, w1, m1) = runs
    for a, b in ((p0, p1), (s0.m, s1.m), (s0.v, s1.v)):
        for (path, x), (_, y) in zip(tree_items(a), tree_items(b)):
            assert torch.equal(x, y), path
    assert torch.equal(w0, w1) and torch.equal(m0, m1)


def test_adamw_reduces_quadratic_loss():
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100,
                      weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    l0 = float((params["w"] ** 2).sum())
    for _ in range(50):
        g = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(params, g, state, cfg)
    assert float((params["w"] ** 2).sum()) < 0.1 * l0
    assert int(state.step) == 50


def test_adamw_state_dtype():
    cfg = AdamWConfig(state_dtype=torch.bfloat16)
    state = adamw_init({"w": torch.ones(3)}, cfg)
    assert state.m["w"].dtype == torch.bfloat16
    assert state.step.shape == () and state.step.dtype == torch.int32


# ---------------------------------------------------- loss and gradients
def _jax_loss_and_grads(arch, pad=None):
    jmodel, params, model = jax_models(0, arch, pad)
    toks = tokens(0)
    with jax.disable_jit():
        loss, grads = jax.value_and_grad(jmodel.loss_fn)(
            params, {"tokens": jnp.asarray(toks)})
    return params, toks, model, loss, grads


@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """JAX's loss and gradients op by op (about 20 s), once."""
    return _jax_loss_and_grads(ARCH)


@pytest.fixture(scope="module")
def jax_mamba2_loss_and_grads():
    """The same for the reduced mamba2 (the SSM's scan under autodiff)."""
    return _jax_loss_and_grads("mamba2-370m")


@pytest.fixture(scope="module")
def jax_starcoder2_loss_and_grads():
    """The same for the reduced starcoder2 (gelu in a plain MLP)."""
    return _jax_loss_and_grads("starcoder2-15b")


@pytest.fixture(scope="module")
def jax_qwen3_loss_and_grads():
    """The same for the reduced qwen3 (qk-norm), its heads padded from 4 to
    6 as the full config pads 40 to 48: the masked heads' wq and wo
    columns get zero gradients on both sides."""
    return _jax_loss_and_grads("qwen3-14b", pad=6)


@pytest.fixture(scope="module")
def jax_qwen3_moe_loss_and_grads():
    """The same for the reduced qwen3-moe (8 experts, top-2): the loss
    carries ``AUX_COEF`` times the layers' aux losses, and the fp32 router
    gets its gradient through the gates and the aux loss. The reference's
    MoE layer runs without its shard_map wrapper over the 1 x 1 mesh,
    which changes no bit (tests/test_torch_moe.py) and spares its op-by-op
    run a compile per primitive."""
    import repro.models.moe as jax_moe_mod
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_moe_mod, "shard_map", lambda f, **_: f)
        mp.setattr(jax_moe_mod, "model_axis", lambda mesh=None: None)
        return _jax_loss_and_grads("qwen3-moe-235b-a22b")


@pytest.mark.parametrize("fixture", ["jax_loss_and_grads",
                                     "jax_mamba2_loss_and_grads",
                                     "jax_starcoder2_loss_and_grads",
                                     "jax_qwen3_loss_and_grads",
                                     "jax_qwen3_moe_loss_and_grads"])
def test_loss_and_grads_match_jax(fixture, request):
    params, toks, model, jloss, jgrads = request.getfixturevalue(fixture)
    tparams = to_torch(params)
    loss, grads = port_grads(model, tparams, toks)
    assert_matches_jax(model, tparams, loss, grads, jloss, jgrads)


def assert_matches_jax(model, tparams, loss, grads, jloss, jgrads):
    """The loss within 1e-3 relative and each leaf's gradient within 2^-5
    of its largest magnitude of JAX's op-by-op run (module docstring)."""
    assert float(loss) == pytest.approx(float(jloss), rel=1e-3)
    tg = port_by_path(grads)
    jg = by_path(jgrads)
    assert set(tg) == set(jg)
    for k, want in jg.items():
        got, want = f32(tg[k]), f32(want)
        # bf16 weights (mamba2 keeps dt_bias, A_log and D in fp32, the MoE
        # its router)
        assert tg[k].dtype == port_by_path(tparams)[k].dtype
        assert tg[k].dtype == torch.bfloat16 or "mamba" in k \
            or k.endswith("moe/router")
        assert np.abs(got - want).max() <= 2 ** -5 * np.abs(want).max(), k
    if model.cfg.pad_heads_to:      # the masked heads learn nothing
        n = model.cfg.n_heads
        assert not bool(tg["layers/attn/wq"][..., n:, :].any())
        assert not bool(tg["layers/attn/wo"][:, n:].any())
        assert bool(tg["layers/attn/wq"][..., :n, :].any())


def test_train_step_is_adamw_on_the_port_gradients(jax_loss_and_grads):
    """One composed train step equals JAX's ``adamw_update`` applied to the
    port's own gradients (which the test above holds to JAX's)."""
    params, toks, model, _, _ = jax_loss_and_grads
    cfg = dict(lr=5e-3, warmup_steps=2, total_steps=50)
    tparams = to_torch(params)
    loss, grads = port_grads(model, tparams, toks)
    jgrads = jax.tree.map(lambda g: jnp.asarray(g.float().numpy()),
                          grads)
    jp, jstate, _ = jax_adamw.adamw_update(
        params, jgrads, jax_adamw.adamw_init(params, jax_adamw.AdamWConfig(
            **cfg)), jax_adamw.AdamWConfig(**cfg))
    tcfg = AdamWConfig(**cfg)
    state = TrainState(tparams, adamw_init(tparams, tcfg))
    state, metrics = build_train_step(model, tcfg)(
        state, {"tokens": torch.as_tensor(toks)})
    assert float(metrics["loss"]) == float(loss)
    got = port_by_path(state.params)
    for k, want in by_path(jp).items():
        np.testing.assert_allclose(f32(got[k]), f32(want), rtol=2 ** -8,
                                   atol=1e-7, err_msg=k)
    for k, want in by_path(jstate.m).items():
        np.testing.assert_allclose(f32(port_by_path(state.opt.m)[k]),
                                   f32(want), rtol=1e-5, atol=1e-9)


def test_four_train_steps_track_jax_jitted():
    jmodel, params, model = jax_models(0)
    toks = tokens(0, batch=4)
    cfg = dict(lr=5e-3, warmup_steps=2, total_steps=50)
    jcfg = jax_adamw.AdamWConfig(**cfg)

    @jax.jit
    def jstep(p, opt, batch):
        loss, grads = jax.value_and_grad(jmodel.loss_fn)(p, batch)
        p, opt, _ = jax_adamw.adamw_update(p, grads, opt, jcfg)
        return p, opt, loss

    jp, jopt, jlosses = params, jax_adamw.adamw_init(params, jcfg), []
    for _ in range(4):
        jp, jopt, loss = jstep(jp, jopt, {"tokens": jnp.asarray(toks)})
        jlosses.append(float(loss))
    tcfg = AdamWConfig(**cfg)
    tparams = to_torch(params)
    state = TrainState(tparams, adamw_init(tparams, tcfg))
    step = build_train_step(model, tcfg)
    losses = []
    for _ in range(4):
        state, metrics = step(state, {"tokens": torch.as_tensor(toks)})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=5e-2)
    assert losses[-1] < losses[0] and jlosses[-1] < jlosses[0]
    assert int(state.opt.step) == 4


def test_masked_loss_matches_jax_and_ignores_masked_tokens():
    jmodel, params, model = jax_models(1)
    toks = tokens(1, seq=16)
    mask = np.ones((2, 16), np.float32)
    mask[:, 8:] = 0.0
    jloss = jax.jit(jmodel.loss_fn)(params, {"tokens": jnp.asarray(toks),
                                             "mask": jnp.asarray(mask)})
    tp = to_torch(params)
    with torch.no_grad():
        loss = model.loss_fn(tp, {"tokens": torch.as_tensor(toks),
                                  "mask": torch.as_tensor(mask)})
        other = toks.copy()
        other[:, 10:] = (other[:, 10:] + 1) % 256   # masked labels only
        same = model.loss_fn(tp, {"tokens": torch.as_tensor(other),
                                  "mask": torch.as_tensor(mask)})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-2)
    assert float(same) == float(loss)


# (arch, moe_dispatch): the reduced dense arch and the reduced MoE arch in
# both dispatch modes
REMAT_ARCHS = [("tinyllama-1.1b", "scatter"),
               ("qwen3-moe-235b-a22b", "scatter"),
               ("qwen3-moe-235b-a22b", "gather")]
POLICIES = ["full", "dots", "names"]


def _policy_model(arch, mode, policy):
    return build_model(dataclasses.replace(
        get_config(arch, reduced=True), moe_dispatch=mode,
        remat_policy=policy))


@pytest.mark.parametrize("arch,mode", REMAT_ARCHS)
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_on_and_off_give_the_same_gradients(policy, arch, mode):
    """Each remat policy changes what the backward recomputes, never a
    value: the loss and every gradient bit-equal to remat off."""
    model = _policy_model(arch, mode, policy)
    tp = to_torch(jax_models(2, arch)[1])
    toks = tokens(2)
    assert model.cfg.remat
    loss_on, g_on = port_grads(model, tp, toks)
    off = build_model(dataclasses.replace(model.cfg, remat=False))
    loss_off, g_off = port_grads(off, tp, toks)
    assert float(loss_on) == float(loss_off)
    for (k, a), (_, b) in zip(tree_items(g_on), tree_items(g_off)):
        assert torch.equal(a, b), k


@pytest.fixture(scope="module")
def jax_policy_runs():
    """JAX's loss and gradients op by op under each remat policy, by
    (arch, moe_dispatch, policy), each computed once; the MoE layer without
    its shard_map, as ``jax_qwen3_moe_loss_and_grads`` runs it."""
    import repro.models.moe as jax_moe_mod
    runs = {}

    def run(arch, mode, policy):
        if (arch, mode, policy) not in runs:
            jmodel, params, _ = jax_models(0, arch)
            jmodel = jax_build_model(dataclasses.replace(
                jmodel.cfg, moe_dispatch=mode, remat_policy=policy))
            with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
                mp.setattr(jax_moe_mod, "shard_map", lambda f, **_: f)
                mp.setattr(jax_moe_mod, "model_axis", lambda mesh=None: None)
                runs[arch, mode, policy] = (params,) + jax.value_and_grad(
                    jmodel.loss_fn)(params, {"tokens": jnp.asarray(
                        tokens(0))})
        return runs[arch, mode, policy]
    return run


@pytest.mark.parametrize("arch,mode", REMAT_ARCHS)
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_jax(policy, arch, mode, jax_policy_runs):
    """Under each policy the port's loss and gradients against
    ``jax.value_and_grad(model.loss_fn)`` under the same ``remat_policy``
    (``jax.checkpoint_dots``, ``save_only_these_names("moe_out")``)."""
    params, jloss, jgrads = jax_policy_runs(arch, mode, policy)
    model = _policy_model(arch, mode, policy)
    tparams = to_torch(params)
    loss, grads = port_grads(model, tparams, tokens(0))
    assert_matches_jax(model, tparams, loss, grads, jloss, jgrads)


class _OpCounts(TorchDispatchMode):
    """Calls of each op (by its packet's name) while the mode is on."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _forward_and_backward_ops(model, tparams, toks):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), tparams)
    with _OpCounts() as fwd:
        loss = model.loss_fn(leaves, {"tokens": torch.as_tensor(toks)})
    with _OpCounts() as bwd:
        loss.backward()
    return fwd.n, bwd.n


@pytest.mark.parametrize("arch,mode", REMAT_ARCHS)
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_recomputes_what_it_does_not_save(policy, arch, mode):
    """What the backward runs under each policy, counted at the dispatcher
    against remat off (whose backward recomputes nothing): "full" runs the
    matrix products (mm, bmm) again; "dots" runs none of them again but
    the elementwise work (exp) yes; "names" marks each MoE layer's output
    once in the forward and never again (the saved ``moe_out``), and runs
    the products again; without MoE layers it is "full"."""
    model = _policy_model(arch, mode, policy)
    tp = to_torch(jax_models(2, arch)[1])
    toks = tokens(2)
    _, off = _forward_and_backward_ops(
        build_model(dataclasses.replace(model.cfg, remat=False)), tp, toks)
    fwd, bwd = _forward_and_backward_ops(model, tp, toks)

    def products(n):
        return n["aten.mm"] + n["aten.bmm"]
    assert bwd["aten.exp"] > off["aten.exp"]
    if policy == "dots":
        assert products(bwd) == products(off)
    else:
        assert products(bwd) > products(off)
    marks = model.cfg.n_layers \
        if policy == "names" and model.cfg.family == "moe" else 0
    assert fwd["repro_torch.checkpoint_name"] == marks
    assert bwd["repro_torch.checkpoint_name"] == 0
    with torch.no_grad(), _OpCounts() as ops:  # no remat without grad
        model.loss_fn(tp, {"tokens": torch.as_tensor(toks)})
    assert ops.n["repro_torch.checkpoint_name"] == 0


@pytest.mark.parametrize("policy", POLICIES)
def test_dots_saves_the_flash_kernels_output(policy, monkeypatch):
    """The flash kernel's forward is an op that the policies see: "dots"
    saves its output and log-sum-exp, so the backward runs it no second
    time; "full" and "names" run it again. The kernels are replaced here by
    their plain versions on the CPU (the CUDA ones run only on the card,
    tests/test_torch_cuda.py)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_lse_plain, flash_attention_plain, ops)
    from repro_torch.models.lm import _POLICIES
    calls = []

    def forward(q, k, v, *, causal, return_lse):
        calls.append(1)
        return (flash_attention_plain(q, k, v, causal=causal),
                flash_attention_lse_plain(q, k, causal=causal))
    monkeypatch.setattr(ops, "flash_attention_cuda", forward)
    monkeypatch.setattr(ops, "flash_attention_bwd_cuda",
                        lambda q, k, v, o, do, lse, causal:
                        flash_attention_bwd_plain(q, k, v, do,
                                                  causal=causal))
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 16, 4, 16, generator=gen).requires_grad_()
    k, v = (torch.randn(2, 16, 2, 16, generator=gen).requires_grad_()
            for _ in range(2))
    context_fn = functools.partial(
        create_selective_checkpoint_contexts, _POLICIES[policy]) \
        if policy in _POLICIES else noop_context_fn
    out = checkpoint(lambda q, k, v: ops.flash_attention_fwd(
        q, k, v, True)[0] * 2, q, k, v, use_reentrant=False,
        context_fn=context_fn)
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert len(calls) == (1 if policy == "dots" else 2)
    want = torch.autograd.grad(
        (flash_attention_plain(q, k, v) * 2).square().sum(), (q, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_microbatched_step_matches_full():
    """Gradient accumulation over 2 microbatches against one full step
    (tests/test_runtime.py's check of the reference's step)."""
    _, params, model = jax_models(1)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                      weight_decay=0.0)
    batch = {"tokens": torch.as_tensor(tokens(1, batch=4))}
    out = {}
    for mu in (1, 2):
        m = build_model(dataclasses.replace(model.cfg, microbatches=mu))
        tp = to_torch(params)
        state, metrics = build_train_step(m, cfg)(
            TrainState(tp, adamw_init(tp, cfg)), batch)
        out[mu] = (float(metrics["loss"]), state.params)
    assert out[1][0] == pytest.approx(out[2][0], rel=5e-2)
    for (k, a), (_, b) in zip(tree_items(out[1][1]), tree_items(out[2][1])):
        assert torch.allclose(a.float(), b.float(), atol=1e-2), k
    with pytest.raises(ValueError, match="divisible"):
        m = build_model(dataclasses.replace(model.cfg, microbatches=3))
        build_train_step(m, cfg)(TrainState(tp, adamw_init(tp, cfg)), batch)


@pytest.mark.parametrize("B,mu", [(4, 2), (3, 3)])
def test_microbatch_split_matches_the_reference(B, mu):
    """The split of a batch with M-RoPE positions (3, B, S) against the
    reference's reshape (``src/repro/runtime/train_lib.py:98-103``),
    evaluated here with jnp: the reference's train_step does not run on
    this jax (ROADMAP §C). The positions are cut on axis 1, the rest on
    axis 0. At B = 3 the reference's key, a leading axis of 3, would take
    tokens and mask for positions; the port keys on the leaf's name, and
    the reference's two expressions applied by name are what it gives."""
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, 256, (B, 17)).astype(np.int32),
             "mask": (rng.random((B, 16)) < 0.7).astype(np.float32),
             "mrope_positions": rng.integers(0, 64, (3, B, 16))
             .astype(np.int32)}

    def by_rows(x):
        return x.reshape((mu, x.shape[0] // mu) + x.shape[1:])

    def by_positions(x):
        return x.reshape((x.shape[0], mu, x.shape[1] // mu)
                         + x.shape[2:]).swapaxes(0, 1)
    if B != 3:      # the reference's own expression, keyed on the shape
        want = jax.tree.map(lambda x: by_rows(x) if x.shape[0] != 3
                            else by_positions(x),
                            {k: jnp.asarray(x) for k, x in batch.items()})
    else:
        assert all(x.shape[0] == 3 for x in batch.values())
        want = {k: by_positions(jnp.asarray(x)) if k == "mrope_positions"
                else by_rows(jnp.asarray(x)) for k, x in batch.items()}
    got = split_microbatches({k: torch.as_tensor(x)
                              for k, x in batch.items()}, mu)
    assert len(got) == mu
    for k in batch:
        for i in range(mu):
            np.testing.assert_array_equal(got[i][k].numpy(),
                                          np.asarray(want[k][i]), err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        split_microbatches({k: torch.as_tensor(x)
                            for k, x in batch.items()}, mu + 1)


def test_microbatch_loss_is_the_mean_of_the_halves():
    _, params, model = jax_models(1)
    tp = to_torch(params)
    toks = tokens(1, batch=4)
    with torch.no_grad():
        halves = [float(model.loss_fn(tp, {"tokens": torch.as_tensor(t)}))
                  for t in (toks[:2], toks[2:])]
    m = build_model(dataclasses.replace(model.cfg, microbatches=2))
    cfg = AdamWConfig()
    _, metrics = build_train_step(m, cfg)(
        TrainState(tp, adamw_init(tp, cfg)), {"tokens": torch.as_tensor(toks)})
    assert float(metrics["loss"]) == pytest.approx(sum(halves) / 2,
                                                   rel=1e-6)


# ------------------------------------------------------------ train_loop
def test_train_loop_checkpoint_restart_reproduces_trajectory(tmp_path):
    """Crash + resume lands on the same losses (tests/test_runtime.py's
    check of the reference's loop)."""
    kw = dict(steps=6, batch=2, seq=32, reduced=True, log_every=0, seed=3,
              device="cpu")
    out_full = train_loop(ARCH, **kw)
    with pytest.raises(RuntimeError, match="simulated"):
        train_loop(ARCH, ckpt_dir=str(tmp_path), ckpt_every=2,
                   simulate_failure=4, **kw)
    out_resumed = train_loop(ARCH, ckpt_dir=str(tmp_path), ckpt_every=2,
                             resume=True, **kw)
    assert out_resumed["start_step"] == 4
    np.testing.assert_allclose(out_full["losses"][4:],
                               out_resumed["losses"], rtol=2e-2)
    assert len(out_full["losses"]) == 6
    assert np.isfinite(out_full["losses"]).all()


def test_train_loop_trains_both_families_on_the_cpu():
    for arch in ("tinyllama-1.1b", "mamba2-370m"):
        out = train_loop(arch, steps=3, batch=2, seq=16, reduced=True,
                         log_every=0, device="cpu", microbatches=2)
        assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
        assert out["tokens_per_s"] > 0 and out["start_step"] == 0


def test_train_loop_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_loop(ARCH, steps=1, batch=2, seq=16, reduced=True)
    with pytest.raises(ValueError):
        train_loop(ARCH, steps=1, batch=2, seq=16, reduced=True,
                   device="meta")


# ------------------------------------------- gradients of the kernels' paths
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,D", [
    (2, 16, 4, 2, 16), (1, 24, 6, 3, 8), (1, 8, 2, 2, 32),
    # S = (Sq, Skv): fewer queries than keys (the encoder-decoder's
    # cross-attention) and more
    pytest.param(2, (8, 24), 4, 4, 16, id="2-8x24-4-4-16"),
    pytest.param(1, (24, 8), 6, 3, 8, id="1-24x8-6-3-8")])
def test_flash_bwd_plain_matches_jax_grad(causal, B, S, H, Hk, D):
    """The backward kernel's plain version against ``jax.vjp`` of the JAX
    package's flash oracle, in fp32 (sums in another order: 1e-5)."""
    Sq, Skv = S if isinstance(S, tuple) else (S, S)
    rng = np.random.default_rng(B * Sq + D)
    q, do = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, Hk, D)).astype(np.float32)
            for _ in range(2))
    G = H // Hk

    def fold(x):       # (B, Sq, H, D) -> (B, Hk, G, Sq, D)
        return jnp.asarray(x).reshape(B, Sq, Hk, G, D).transpose(
            0, 2, 3, 1, 4)

    def jfn(qg, kk, vv):
        return jax_flash_ref(qg, kk, vv, causal=causal)
    kt, vt = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (k, v))
    _, vjp = jax.vjp(jfn, fold(q), kt, vt)
    jdq, jdk, jdv = vjp(fold(do))
    want = (np.asarray(jdq).transpose(0, 3, 1, 2, 4).reshape(B, Sq, H, D),
            np.asarray(jdk).transpose(0, 2, 1, 3),
            np.asarray(jdv).transpose(0, 2, 1, 3))
    got = flash_attention_bwd_plain(*(torch.as_tensor(x)
                                      for x in (q, k, v, do)), causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def _tolerance_tool():
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "flash_bwd_tolerance.py"
    spec = importlib.util.spec_from_file_location("flash_bwd_tolerance", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_tolerance_tool_takes_the_plain_gradient(causal):
    """tools/flash_bwd_tolerance.py's fp64 formulas, without the kernel's
    rounding, give the plain version's gradient (both rounded to bf16 at
    the end: 1e-3 of the norm)."""
    tool = _tolerance_tool()
    gen = torch.Generator().manual_seed(1)
    q, do = (torch.randn(2, 40, 6, 16, generator=gen).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(2, 40, 3, 16, generator=gen).bfloat16()
            for _ in range(2))
    got = tool.backward(q, k, v, do, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, do, causal=causal)
    for g, w in zip(got, want):
        assert tool.grad_err(g, w) < 1e-3


def test_flash_bwd_rule_passes_the_kernel_rounding_and_fails_faults():
    """The backward kernel's rule (||got - want|| <= 1e-2 ||want||, in
    chip_smoke.py and tests/test_torch_cuda.py) leaves room for the bf16
    kernel's rounding (emulated: under half of it) and fails each planted
    fault (dv or dk 10% low past key 128, dv zeroed or dq 10% low on the
    last 12% of positions), at the training shape's S and D."""
    readings = _tolerance_tool().kernel_readings(B=1, S=512, H=8, Hk=2, D=64)
    for name, err in readings.items():
        if name.startswith("rounding"):
            assert err < 0.5e-2, name
        else:
            assert err > 1e-2, name


def test_zeroed_row_sums_keep_dq_within_the_rule_on_common_keys():
    """The backward kernel's dq pass makes each row of dS sum to 0 (its
    delta from the forward's bf16 output is off by that output's
    rounding). On the attention calls of a depth-2 + 2, full-width
    seamless-m4t train step (tools/flash_bwd_tolerance.py's encdec
    readings, the kernel's rounding emulated), dq stays well inside the
    1e-2 rule at every call; without the correction it is several times
    larger at the call whose keys share the largest common component (a
    decoder self-attention: 1.1e-2 there, 1.09e-2 on an H100 before the
    repair)."""
    readings = _tolerance_tool().encdec_readings()
    assert len(readings) == 6
    for call in readings.values():
        assert call["dq"] < 0.5e-2 and call["dk"] < 0.5e-2
    common = max(readings.values(),
                 key=lambda c: c["keys' common component"])
    assert common["causal"]
    assert common["dq, row sums not zeroed"] > 4 * common["dq"]


def test_flash_attention_on_the_cpu_is_differentiable():
    """On a CPU tensor ``flash_attention`` is the plain path; autograd
    through it gives the plain backward's gradient."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 32, 4, 16, generator=gen, requires_grad=True)
    k = torch.randn(1, 32, 2, 16, generator=gen, requires_grad=True)
    v = torch.randn(1, 32, 2, 16, generator=gen, requires_grad=True)
    do = torch.randn(1, 32, 4, 16, generator=gen)
    got = torch.autograd.grad(flash_attention(q, k, v, block_q=16,
                                              block_k=16), (q, k, v), do)
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, do)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_ssd_on_the_cpu_stays_differentiable():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 32, 2, 8, generator=gen, requires_grad=True)
    dt = torch.nn.functional.softplus(torch.randn(1, 32, 2, generator=gen))
    A = -torch.exp(torch.randn(2, generator=gen))
    Bm, Cm = (torch.randn(1, 32, 16, generator=gen) for _ in range(2))
    y, _ = ssd(x, dt, A, Bm, Cm, chunk=16)
    y.square().sum().backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0


@pytest.fixture
def card_of_80_gib(monkeypatch):
    """A CUDA card of 80 GiB as ``train_loop`` sees it; the build is
    recorded in the returned list, and the state's draw stops the run."""
    from repro_torch.launch import train as train_mod

    class Props:
        total_memory = 80 * 2 ** 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    built = []
    monkeypatch.setattr(train_mod._build, "build",
                        lambda: built.append(1) or {})
    monkeypatch.setattr(train_mod, "init_train_state",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("stop")))
    return built


def _cut_depth(monkeypatch, layers):
    from repro_torch.launch import train as train_mod
    full = train_mod.get_config
    monkeypatch.setattr(train_mod, "get_config", lambda arch, reduced=False:
                        dataclasses.replace(full(arch), n_layers=layers))


def test_full_depth_15b_training_on_one_card_raises(monkeypatch,
                                                    card_of_80_gib):
    """A 15 B arch's training state (~190 GB) does not fit one 80 GB card:
    train_loop raises before it builds anything; a cut depth passes the
    check (it stops here at the build, which needs nvcc)."""
    with pytest.raises(ValueError, match="A.12"):
        train_loop("starcoder2-15b", steps=1, device="cuda")
    assert not card_of_80_gib
    _cut_depth(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="stop"):
        train_loop("starcoder2-15b", steps=1, device="cuda")
    assert card_of_80_gib


def test_microbatch_accumulator_counts_against_the_card(monkeypatch,
                                                        card_of_80_gib):
    """With microbatches > 1 the step also holds an fp32 gradient
    accumulator, 4 bytes a parameter. qwen3-moe at 2 layers (6.22 B
    parameters, derived) takes 74.7 GB at 12 bytes a parameter, under the
    80 GiB card, and 99.6 GB with the accumulator, over it."""
    _cut_depth(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="stop"):
        train_loop("qwen3-moe-235b-a22b", steps=1, device="cuda")
    assert card_of_80_gib
    card_of_80_gib.clear()
    with pytest.raises(ValueError, match="accumulator"):
        train_loop("qwen3-moe-235b-a22b", steps=1, device="cuda",
                   microbatches=4)
    assert not card_of_80_gib


def test_unknown_activation_raises_key_error():
    from repro_torch.models.ffn import mlp
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              activation="swish")
    with pytest.raises(KeyError, match="swish"):
        mlp({}, torch.zeros(1, 2, cfg.d_model), cfg)
