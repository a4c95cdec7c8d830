"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on the CPU, with the JAX weights carried
across and inputs made from a numpy seed.

Configs: the reduced qwen3-moe-235b-a22b (8 experts, top-2, SwiGLU) and the
reduced kimi-k2-1t-a32b (the same plus one shared expert), built from the
JAX registry's fields; a plain gelu variant; both ``moe_dispatch`` modes; a
capacity factor loose enough to drop nothing (8.0) and a tight one (0.05)
that drops most choices.

The reference runs its layer inside a ``shard_map`` over the current mesh,
a 1 x 1 mesh outside any context, where it is the identity map and no rank
owns a drop row. Run op by op (``jax.disable_jit()``), that ``shard_map``
compiles each of its ~300 primitives alone (~10 s a call), so the
``one_device_moe`` fixture calls the reference's per-device block,
``_moe_local``, without the wrapper (its ``model_axis`` read as None: no
``axis_index``, no ``psum``). ``test_one_device_reference_is_the_reference``
shows that this changes no bit of the jitted reference.

Tolerances, and why:

* routing exactly: ``topi`` equal to the reference's (no ties at these
  draws; an all-tie router is tested apart), and the kept mask and every
  slot equal to the reference's rule (arrival order within each expert,
  the first C kept), written out here in numpy;
* fp32 outputs within 1e-5 of their largest magnitude (the same products,
  summed in another order; the gather combine sums each token's k rows in
  k order where the reference scatter-adds them by slot), ``aux`` within
  1e-6;
* bf16 outputs against the reference run op by op: rel < 2^-6 of the
  largest magnitude, tests/test_torch_lm.py's rule.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jax_moe_mod
from repro.configs import get_config as jax_get_config
from repro.models.param import init_params as jax_init_params
from repro_torch.models import ModelConfig, init_params, params_from_numpy
from repro_torch.models.moe import (_capacity, _route, _slot_map, _slots,
                                    moe, moe_decls)

TIGHT = 2.0 ** -6
# the module; ``repro_torch.models.moe`` is the function it exports
port_moe_mod = importlib.import_module("repro_torch.models.moe")


@pytest.fixture
def one_device_moe(monkeypatch):
    """The reference's layer on one device without its shard_map wrapper;
    records the routing (topi, gates) each call hands its per-device
    block."""
    seen = []
    block = jax_moe_mod._moe_local

    def recording(x, topi, gates, *rest, **kw):
        if not isinstance(gates, jax.core.Tracer):   # not under jax.grad
            k = topi.shape[-1]
            seen.append((np.asarray(topi).reshape(-1, k),
                         np.asarray(gates).reshape(-1, k)))
        return block(x, topi, gates, *rest, **kw)
    monkeypatch.setattr(jax_moe_mod, "shard_map", lambda f, **_: f)
    monkeypatch.setattr(jax_moe_mod, "model_axis", lambda mesh=None: None)
    monkeypatch.setattr(jax_moe_mod, "_moe_local", recording)
    return seen


def configs(variant: str, **kw):
    """(JAX config, port config) of a reduced arch, ``variant`` one of
    "qwen3-moe" (SwiGLU), "kimi-k2" (SwiGLU + a shared expert), "gelu"
    (qwen3-moe with a plain gelu MLP)."""
    arch = {"qwen3-moe": "qwen3-moe-235b-a22b", "gelu": "qwen3-moe-235b-a22b",
            "kimi-k2": "kimi-k2-1t-a32b"}[variant]
    jcfg = jax_get_config(arch, reduced=True)
    if variant == "gelu":
        kw = dict(activation="gelu", glu=False, **kw)
    jcfg = dataclasses.replace(jcfg, **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def layer_params(jcfg, seed=0):
    pj = jax_init_params(jax_moe_mod.moe_decls(jcfg), jax.random.key(seed))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


def inputs(seed, B=2, S=16, M=64):
    return np.random.default_rng(seed).standard_normal(
        (B, S, M)).astype(np.float32)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_err(ref, got) -> float:
    ref, got = f32(ref), f32(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def reference_plan(topi: np.ndarray, E: int, C: int):
    """The reference's dispatch rule, written out: each flat (token, k)
    choice in arrival order takes the next slot of its expert; the first C
    are kept. -> keep (T·k,), slot (T·k,; C when dropped), grid (E, C) of
    flat indices, valid (E, C)."""
    flat = topi.reshape(-1)
    keep = np.zeros(flat.size, bool)
    slot = np.full(flat.size, C)
    grid = np.zeros((E, C), np.int64)
    valid = np.zeros((E, C), bool)
    used = np.zeros(E, np.int64)
    for i, e in enumerate(flat):
        if used[e] < C:
            keep[i], slot[i] = True, used[e]
            grid[e, used[e]], valid[e, used[e]] = i, True
        used[e] += 1
    return keep, slot, grid, valid


@pytest.mark.parametrize("tokens,k,E,cf", [(4096, 8, 128, 1.25),
                                           (8, 8, 128, 1.25),
                                           (34, 2, 8, 1.25), (32, 2, 8, 0.05),
                                           (64, 2, 8, 8.0), (1, 1, 4, 1.0)])
def test_capacity_matches_jax(tokens, k, E, cf):
    assert _capacity(tokens, k, E, cf) == jax_moe_mod._capacity(tokens, k,
                                                                 E, cf)
    if (tokens, k, E, cf) == (4096, 8, 128, 1.25):
        assert _capacity(tokens, k, E, cf) == 320     # the prefill's C
    if (tokens, k, E, cf) == (8, 8, 128, 1.25):
        assert _capacity(tokens, k, E, cf) == 4       # a decode step's C


@pytest.mark.parametrize("mode", ["scatter", "gather"])
@pytest.mark.parametrize("variant", ["qwen3-moe", "kimi-k2", "gelu"])
@pytest.mark.parametrize("cf", [8.0, 0.05])
def test_moe_matches_jax_fp32(one_device_moe, mode, variant, cf):
    jcfg, tcfg = configs(variant, moe_dispatch=mode, capacity_factor=cf)
    pj, pt = layer_params(jcfg)
    x = inputs(1, S=16 if cf > 1 else 64)    # tight: C = 4 of 32 choices
    with jax.disable_jit():
        y_ref, aux_ref = jax_moe_mod.moe(pj, jnp.asarray(x), jcfg)
    y, aux = moe(pt, torch.as_tensor(x), tcfg)
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert rel_err(y_ref, y) < 1e-5
    assert abs(float(aux) - float(aux_ref)) < 1e-6

    # routing: the reference's topi exactly, the plan by its rule
    (topi_ref, gates_ref), = one_device_moe
    topi, gates, _ = _route(pt["router"], torch.as_tensor(x), tcfg)
    np.testing.assert_array_equal(topi.numpy(), topi_ref)
    np.testing.assert_allclose(gates.numpy(), gates_ref, rtol=1e-6)
    E, T = tcfg.n_experts, x.shape[0] * x.shape[1]
    C = _capacity(T, tcfg.top_k, E, cf)
    keep_ref, slot_ref, grid_ref, valid_ref = reference_plan(topi_ref, E, C)
    keep, slot = _slots(topi, E, C)
    np.testing.assert_array_equal(keep.numpy(), keep_ref)
    np.testing.assert_array_equal(slot.numpy(), slot_ref)
    grid, valid, slot_of = _slot_map(topi, E, C)
    np.testing.assert_array_equal(valid.numpy(), valid_ref)
    np.testing.assert_array_equal(np.where(valid_ref, grid.numpy(), 0),
                                  grid_ref)
    np.testing.assert_array_equal(
        slot_of.numpy(), np.where(keep_ref, topi_ref.reshape(-1) * C
                                  + slot_ref, E * C))
    if cf == 8.0:
        assert keep_ref.all()                # nothing dropped
    else:
        assert keep_ref.mean() <= 0.125      # most choices dropped


@pytest.mark.parametrize("mode", ["scatter", "gather"])
@pytest.mark.parametrize("variant", ["qwen3-moe", "kimi-k2"])
def test_moe_matches_jax_bf16_op_by_op(one_device_moe, mode, variant):
    jcfg, tcfg = configs(variant, moe_dispatch=mode)
    pj, pt = layer_params(jcfg, seed=2)
    x = inputs(3)
    with jax.disable_jit():
        y_ref, aux_ref = jax_moe_mod.moe(pj, jnp.asarray(x, jnp.bfloat16),
                                         jcfg)
    y, aux = moe(pt, torch.as_tensor(x).bfloat16(), tcfg)
    assert y.dtype == torch.bfloat16
    assert rel_err(y_ref, y) < TIGHT
    assert abs(float(aux) - float(aux_ref)) < 1e-6
    (topi_ref, _), = one_device_moe
    topi, _, _ = _route(pt["router"], torch.as_tensor(x).bfloat16(), tcfg)
    np.testing.assert_array_equal(topi.numpy(), topi_ref)


def test_one_device_reference_is_the_reference():
    """The fixture's unwrapped reference against the reference as it runs
    (its shard_map over the 1 x 1 mesh), both jitted: the same bits."""
    jcfg, _ = configs("kimi-k2", capacity_factor=0.5)
    pj, _ = layer_params(jcfg)
    x = jnp.asarray(inputs(4))
    run = jax.jit(jax_moe_mod.moe, static_argnums=2)
    y_mesh, aux_mesh = run(pj, x, jcfg)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_moe_mod, "shard_map", lambda f, **_: f)
        mp.setattr(jax_moe_mod, "model_axis", lambda mesh=None: None)
        y_one, aux_one = jax.jit(jax_moe_mod.moe, static_argnums=2)(pj, x,
                                                                    jcfg)
    finally:
        mp.undo()
    np.testing.assert_array_equal(np.asarray(y_one), np.asarray(y_mesh))
    assert float(aux_one) == float(aux_mesh)


@pytest.mark.parametrize("mode", ["scatter", "gather"])
def test_tied_router_takes_the_lower_expert_first(one_device_moe, mode):
    """A zero router ties every expert for every token: jax.lax.top_k
    picks experts 0..k-1 in order, and so must the port (the order of the
    k choices decides arrival order, hence which tokens overflow drops,
    and which expert ``aux`` counts as top-1)."""
    jcfg, tcfg = configs("qwen3-moe", moe_dispatch=mode, capacity_factor=0.5)
    pj, pt = layer_params(jcfg)
    pj = dict(pj, router=jnp.zeros_like(pj["router"]))
    pt = dict(pt, router=torch.zeros_like(pt["router"]))
    x = inputs(5)
    with jax.disable_jit():
        y_ref, aux_ref = jax_moe_mod.moe(pj, jnp.asarray(x), jcfg)
    y, aux = moe(pt, torch.as_tensor(x), tcfg)
    (topi_ref, _), = one_device_moe
    topi, _, _ = _route(pt["router"], torch.as_tensor(x), tcfg)
    k = tcfg.top_k
    assert (topi_ref == np.arange(k)).all()
    np.testing.assert_array_equal(topi.numpy(), topi_ref)
    assert rel_err(y_ref, y) < 1e-5
    assert abs(float(aux) - float(aux_ref)) < 1e-6


@pytest.mark.parametrize("mode", ["scatter", "gather"])
def test_moe_reads_no_value_on_the_host(mode):
    """The layer runs on meta tensors, which hold no values: no boolean
    mask, ``nonzero``, ``.item()`` or ``repeat_interleave`` without an
    output size is on its path, so on the card it never waits for the
    device and a call can be captured in a CUDA graph."""
    _, tcfg = configs("kimi-k2", moe_dispatch=mode)
    params = init_params(moe_decls(tcfg), torch.Generator().manual_seed(0),
                         "meta")
    x = torch.empty(2, 16, tcfg.d_model, dtype=torch.bfloat16, device="meta")
    y, aux = moe(params, x, tcfg)
    assert y.shape == x.shape and y.dtype == x.dtype and aux.shape == ()
    with pytest.raises(NotImplementedError):     # what a mask would do
        x[x > 0]


@pytest.mark.parametrize("mode", ["scatter", "gather"])
def test_moe_grads_match_jax(one_device_moe, mode):
    """d(sum(y * w) + aux)/d(params, x) against jax.grad, fp32, a tight
    capacity: the gates' and the router's gradients (through the gates and
    aux's importance term) and the experts' through dispatch and combine."""
    jcfg, tcfg = configs("kimi-k2", moe_dispatch=mode, capacity_factor=0.5)
    pj, pt = layer_params(jcfg)
    pj = jax.tree.map(lambda a: a.astype(jnp.float32), pj)
    x = inputs(6)
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jax_moe_mod.moe(p, x, jcfg)
        return jnp.sum(y * w) + aux
    with jax.disable_jit():
        gp_ref, gx_ref = jax.grad(jloss, argnums=(0, 1))(pj, jnp.asarray(x))
    pt = {k: torch.tensor(np.array(v)).requires_grad_()
          for k, v in pj.items()}
    xt = torch.as_tensor(x).requires_grad_()
    y, aux = moe(pt, xt, tcfg)
    (torch.sum(y * torch.as_tensor(w)) + aux).backward()
    assert rel_err(gx_ref, xt.grad) < 1e-5
    for k, want in gp_ref.items():
        assert rel_err(want, pt[k].grad) < 1e-5, k


def _port_cfg(**kw):
    base = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab=128, n_experts=8, top_k=2,
                capacity_factor=4.0)
    base.update(kw)
    return ModelConfig(**base)


def test_moe_matches_dense_reference():
    """The port's mirror of tests/test_models.py's dense check: every
    expert on every token, then each token's top-k rows weighted by its
    gates; 1e-4 relative, the reference's bound."""
    cfg = _port_cfg()
    params = init_params(moe_decls(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 16, 32)).astype(np.float32))
    y, aux = moe(params, x, cfg)

    t = x.reshape(-1, 32)
    probs = torch.softmax(t @ params["router"], -1)
    topv, topi = torch.topk(probs, cfg.top_k)
    gates = topv / topv.sum(-1, keepdim=True)
    per_expert = []
    for e in range(cfg.n_experts):
        g = t @ params["w_gate"][e].float()
        u = t @ params["w_up"][e].float()
        per_expert.append(((g * torch.sigmoid(g)) * u)
                          @ params["w_down"][e].float())
    stacked = torch.stack(per_expert, 1)                  # (T, E, M)
    ref = torch.zeros_like(t)
    for kk in range(cfg.top_k):
        ref = ref + gates[:, kk, None] * stacked[torch.arange(t.shape[0]),
                                                 topi[:, kk]]
    ref = ref.reshape(2, 16, 32)
    assert float((y - ref).abs().max() / ref.abs().max()) < 1e-4
    assert 0.5 < float(aux) < 4.0       # balanced-ish router at init


def test_moe_capacity_drops_tokens():
    """With capacity_factor << 1 most choices are dropped: the output
    shrinks (the port's mirror of tests/test_models.py's check)."""
    cfg_full = _port_cfg(capacity_factor=8.0)
    cfg_tight = _port_cfg(capacity_factor=0.05)
    params = init_params(moe_decls(cfg_full),
                         torch.Generator().manual_seed(0), "cpu")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 32, 32)).astype(np.float32))
    y_full, _ = moe(params, x, cfg_full)
    y_tight, _ = moe(params, x, cfg_tight)
    assert float(y_tight.abs().mean()) < float(y_full.abs().mean())


def test_dropped_rows_do_not_reach_kept_slots():
    """Tight capacity in gather mode: the duplicate writes of the dropped
    choices (all on the trash slot) leave every kept slot holding its own
    token, so both modes give the same output bit for bit (k = 2: the two
    combines add the same two products)."""
    out = {}
    for mode in ("scatter", "gather"):
        cfg = _port_cfg(capacity_factor=0.05, moe_dispatch=mode)
        params = init_params(moe_decls(cfg), torch.Generator().manual_seed(3),
                             "cpu")
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(
            (2, 32, 32)).astype(np.float32))
        out[mode] = moe(params, x, cfg)
    assert torch.equal(out["scatter"][0], out["gather"][0])
    assert torch.equal(out["scatter"][1], out["gather"][1])


def test_port_module_is_the_models_export():
    from repro_torch import models
    assert models.moe is port_moe_mod.moe
    assert models.moe_decls is port_moe_mod.moe_decls


# ----------------------------------------------------------------------
# chip_smoke.py's MoE model check compares the card's routing with the
# CPU's through ``routes_apart``; its rules, on routings made here by the
# port's own ``_route``
def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _recorded(logits: torch.Tensor, k: int) -> tuple:
    """(topi, gates, logits) as ``record_routes`` holds one call: the
    router's input is the identity, so its logits are ``logits``."""
    T, E = logits.shape
    cfg = ModelConfig(name="t", family="moe", n_layers=1, d_model=T,
                      n_heads=1, n_kv_heads=1, head_dim=T, d_ff=8,
                      vocab=8, n_experts=E, top_k=k)
    topi, gates, _ = _route(logits, torch.eye(T)[None], cfg)
    return topi, gates, logits


def _near_tie_logits(T=64, E=48, k=4, seed=0):
    """CPU logits with a near-tie between token 0's k-th and (k+1)-th
    expert (1e-4 apart), and the card's: the CPU's plus 1e-5 noise, with
    that pair swapped by 2e-4."""
    rng = np.random.default_rng(seed)
    cpu = torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32))
    order = cpu[0].argsort(descending=True)
    a, b = order[k - 1], order[k]
    cpu[0, b] = cpu[0, a] - 1e-4
    card = cpu + torch.from_numpy(
        rng.normal(0, 1e-5, (T, E)).astype(np.float32))
    card[0, b] = cpu[0, a] + 1e-4
    return cpu, card, k


def test_routes_apart_passes_a_near_tie_flipped():
    smoke = _chip_smoke()
    cpu, card, k = _near_tie_logits()
    got = smoke.routes_apart(_recorded(cpu, k), _recorded(card, k))
    assert got["apart"] == 1 and got["choices"] == cpu.shape[0] * k
    assert 0 < got["gap"] <= 1.5e-4
    assert got["excess"] <= 0
    assert got["gate_err"] < smoke.GATE_TOL


def test_routes_apart_fails_a_top_k_off_by_one():
    """The card's k-th choice replaced by its (k+1)-th ranked expert, as
    chip_smoke.py's planted fault does: the tokens route apart, each past
    what the logits' difference accounts for."""
    smoke = _chip_smoke()
    cpu, card, k = _near_tie_logits()
    topi, gates, logits = _recorded(card, k)
    order = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True,
                       stable=True)[1]
    wrong = torch.cat([topi[:, :-1], order[:, k:k + 1]], 1)
    got = smoke.routes_apart(_recorded(cpu, k), (wrong, gates, logits))
    # token 0's card already took the CPU's (k+1)-th: there the fault
    # routes it back to the CPU's choice
    assert got["apart"] == cpu.shape[0] - 1
    assert got["apart"] > smoke.APART_MAX * got["choices"]
    assert got["excess"] > 0


def test_routes_apart_fails_gates_not_renormalised():
    smoke = _chip_smoke()
    cpu, card, k = _near_tie_logits()
    topi, gates, logits = _recorded(card, k)
    probs = torch.softmax(logits, -1).gather(1, topi)
    got = smoke.routes_apart(_recorded(cpu, k), (topi, probs, logits))
    assert got["gate_err"] > smoke.GATE_TOL
    sound = smoke.routes_apart(_recorded(cpu, k), (topi, gates, logits))
    assert sound["gate_err"] < 1e-4
