"""Sharded serving of the port (``repro_torch.runtime.serve_lib``) on the
CPU, against the JAX package's model.

Each mesh runs as a gloo group of spawned ranks (``torch_serve_worker``,
one thread a rank, a ``file://`` rendezvous): (1, 2), (2, 2) and (1, 4).
At (1, 4) the reduced models' 2 KV heads do not divide over the model axis
and stay replicated while the 4 q heads are cut, one a rank. Every group
runs all of its cases in one spawn, the three groups at once, and each is
joined with a timeout, so a hung rank fails the test.

The cases, each on weights carried from JAX ``init_params`` through numpy:
reduced tinyllama-1.1b and reduced starcoder2-15b (plain gelu MLP, untied
head); reduced qwen2-vl-72b, its tokens path (1-D RoPE, as the reference's
serve steps run it); reduced qwen3-moe-235b-a22b and kimi-k2-1t-a32b (8
experts, top-2, kimi with a shared expert: 4, 4 and 2 experts a rank);
reduced mamba2-370m (8 heads: 4, 4 and 2 a rank; tied head); and the
reduced qwen3-moe at capacity factor 0.5 on both sides (``CAPACITY``),
where the prefill drops tokens. Batch 4, a 16-token prompt and 4 decode
steps fed the next tokens (teacher-forced). The cache holds 36 rows: at
(1, 2) and (2, 2) each model rank holds 18, so the prompt ends in rank 0's
span, the decode crosses into rank 1's, and rank 1 has 0 valid keys in the
first two steps; at (1, 4), 9 rows a rank, the prompt spans ranks 0 and 1,
the decode crosses from rank 1 into rank 2, and rank 3 has 0 valid keys
throughout.

The reference's MoE layer runs without its ``shard_map`` on one device
(the wrapper patched to the identity, as ``tests/test_torch_moe.py`` runs
it). Its ``shard_map`` cuts the batch over the data axes, so each data
shard's capacity comes from that shard's tokens: at a data axis of 2 an
MoE case is held, data shard by data shard, to JAX run on that shard's
rows alone (``jax_refs``). At capacity factor 0.5 that C (4 at the
prefill) is not the whole batch's (8), and the whole batch's reference
gives other logits (``test_capacity_case_tells_the_shard_capacity_apart``).

The attention weights are rescaled to std 1/sqrt(fan-in) on both sides
(``fan_in``), as ``tests/test_torch_vlm.py`` draws them: at the
reference's draw the softmax saturates, and the row-parallel products'
partial sums, each rounded to bf16 before the sum over the model axis,
move the logits far past any rounding budget with no fault in either path.

The logits are held to JAX jitted outside any mesh (the reference's own
serve loop fails under its mesh, ROADMAP §C) by the rule
``tests/test_torch_lm.py`` holds the unsharded port to there: no further
from jitted JAX than JAX's op-by-op run is, plus 2^-6 of the logits'
largest magnitude (a few bf16 ulps for sums taken in another order). The
sharded path sums bf16 partial products over the model axis where one
product accumulates in fp32, so it is not held to the op-by-op run's
tight bound (it parts from it by 0.009-0.025 here, as far as jitted JAX
does); it must pick the same argmax as the op-by-op run at every step.
"""

import contextlib
import dataclasses
import multiprocessing
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.models.moe as jax_moe_mod
import torch_serve_worker
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.sharding.rules import make_rules as jax_make_rules
from repro.sharding.rules import spec_tree as jax_spec_tree
from repro.runtime.serve_lib import cache_specs as jax_cache_specs
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh, abstract_mesh
from repro_torch.models import build_model, init_params, params_from_numpy
from repro_torch.models import param as param_mod
from repro_torch.models.param import shard_params, tree_at, tree_items
from repro_torch.runtime import serve_lib
from repro_torch.sharding.rules import local_slices

TIGHT = 2.0 ** -6
KV_ARCHS = ["tinyllama-1.1b", "starcoder2-15b", "qwen2-vl-72b",
            "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"]
SSM_ARCH = "mamba2-370m"
ARCHS = KV_ARCHS + [SSM_ARCH]
MOE_ARCHS = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"]
# the capacity-binding case: reduced qwen3-moe at capacity factor 0.5
CAPACITY = "qwen3-moe-235b-a22b@cf0.5"
CASES = ARCHS + [CAPACITY]
MESHES = [(1, 2), (2, 2), (1, 4)]
B, PROMPT, TOKENS, MAX_LEN = 4, 16, 20, 36
JOIN_S = 360


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_err(ref, got) -> float:
    ref, got = f32(ref), f32(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def fan_in(params):
    """The reference's weights with the attention's wq, wk, wv and wo at
    std 1/sqrt(fan-in) (d_model; H * D for wo), as in
    tests/test_torch_vlm.py; a model without attention as it is."""
    if "attn" not in params["layers"]:
        return params
    at = dict(params["layers"]["attn"])
    for n in ("wq", "wk", "wv"):
        at[n] = (at[n].astype(jnp.float32) * np.sqrt(
            at[n].shape[-2] / at[n].shape[-3])).astype(jnp.bfloat16)
    at["wo"] = (at["wo"].astype(jnp.float32) / np.sqrt(
        at["wo"].shape[-3])).astype(jnp.bfloat16)
    return {**params, "layers": {**params["layers"], "attn": at}}


def jax_steps(jmodel, params, toks, *, eager):
    """JAX's prefill of the prompt, then a decode step fed each next
    token, outside any mesh; the logits of each step, the final cache
    (numpy) and, op by op, each MoE call's routing (topi, gates) and
    router input x, as its per-device block receives them."""
    calls = []
    block = jax_moe_mod._moe_local

    def recording(x, topi, gates, *rest, **kw):
        if eager:
            k = topi.shape[-1]
            calls.append((np.asarray(topi).reshape(-1, k),
                          np.asarray(gates).reshape(-1, k), f32(x)))
        return block(x, topi, gates, *rest, **kw)
    with jax.disable_jit() if eager else contextlib.nullcontext(), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_moe_mod, "_moe_local", recording)
        prefill = jmodel.prefill if eager else jax.jit(jmodel.prefill)
        decode = jmodel.decode_step if eager else jax.jit(jmodel.decode_step)
        cache = jmodel.init_cache(toks.shape[0], max_len=MAX_LEN)
        logits, cache = prefill(params, jnp.asarray(toks[:, :PROMPT]), cache)
        out = [f32(logits)]
        for t in range(PROMPT, TOKENS):
            logits, cache = decode(params, jnp.asarray(toks[:, t:t + 1]),
                                   cache)
            out.append(f32(logits))
    return out, jax.tree.map(f32, cache), calls


def jax_refs(jmodel, params, toks, shards: int) -> dict:
    """Op-by-op and jitted JAX logits of each step, the batch run as
    ``shards`` data shards, each on its rows alone (the reference's MoE
    capacity is a data shard's), put back together along the batch; the
    op-by-op final cache, and an MoE model's routing of each call (topi,
    gates, router logits (T, E) in fp32), the same way."""
    runs = {eager: [jax_steps(jmodel, params, rows, eager=eager)
                    for rows in np.split(toks, shards)]
            for eager in (True, False)}
    out = {name: [np.concatenate(step) for step in zip(*(r[0] for r
                                                          in runs[eager]))]
           for name, eager in (("eager", True), ("jitted", False))}
    caches = [r[1] for r in runs[True]]
    out["cache"] = caches[0] if shards == 1 else jax.tree.map(
        lambda *a: np.concatenate(a, axis=1) if a[0].ndim > 1 else a[0],
        *caches)
    if jmodel.cfg.family == "moe":
        # every shard makes the same calls, layer by layer, step by step
        routers = np.asarray(params["layers"]["moe"]["router"], np.float32)
        out["routes"] = []
        for c, per_shard in enumerate(zip(*(r[2] for r in runs[True]))):
            x = np.concatenate([x.reshape(-1, x.shape[-1])
                                for _, _, x in per_shard])
            out["routes"].append(
                (np.concatenate([t for t, _, _ in per_shard]),
                 np.concatenate([g for _, g, _ in per_shard]),
                 x @ routers[c % jmodel.cfg.n_layers]))
    return out


def port_cache(cfg, params, toks):
    """The unsharded port's K/V cache after the same steps."""
    model = build_model(cfg)
    cache = model.init_cache(B, MAX_LEN, device="cpu")
    with torch.inference_mode():
        _, cache = model.prefill(params, torch.as_tensor(toks[:, :PROMPT]),
                                 cache)
        for t in range(PROMPT, TOKENS):
            _, cache = model.decode_step(params,
                                         torch.as_tensor(toks[:, t:t + 1]),
                                         cache)
    return cache.kv.k.float().numpy(), cache.kv.v.float().numpy()


def case_configs(name: str):
    """(JAX config, port config) of a case: the reduced arch, at capacity
    factor 0.5 for ``CAPACITY``."""
    arch, _, cf = name.partition("@cf")
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    if cf:
        jcfg = dataclasses.replace(jcfg, capacity_factor=float(cf))
        cfg = dataclasses.replace(cfg, capacity_factor=float(cf))
    return jcfg, cfg


@pytest.fixture(scope="module")
def runs():
    """The JAX references (for an MoE case, also as two data shards, and
    the routing its ranks are fed), the unsharded port's K/V caches, and
    every rank's results of the three groups, spawned at once."""
    refs, cases = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        # the reference's MoE layer on one device, its shard_map the
        # identity (tests/test_torch_moe.py)
        mp.setattr(jax_moe_mod, "shard_map", lambda f, **_: f)
        mp.setattr(jax_moe_mod, "model_axis", lambda mesh=None: None)
        for i, name in enumerate(CASES):
            jcfg, cfg = case_configs(name)
            jmodel = jax_build_model(jcfg)
            seed = ARCHS.index(name.partition("@")[0])
            params_j = fan_in(jax_init_params(jmodel.param_decls(),
                                              jax.random.key(seed)))
            toks = np.random.default_rng(seed).integers(0, 256,
                                                        size=(B, TOKENS))
            params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                         "cpu")
            refs[name] = {"jmodel": jmodel,
                          1: jax_refs(jmodel, params_j, toks, 1)}
            cases[name] = {"cfg": cfg, "params": params_t, "tokens": toks,
                           "prompt": PROMPT, "max_len": MAX_LEN}
            if jcfg.family == "moe":
                # the K/V reference is JAX's (the fed runs route as it does)
                refs[name][2] = jax_refs(jmodel, params_j, toks, 2)
                cases[name]["routes"] = {
                    n: [(t, g) for t, g, _ in refs[name][n]["routes"]]
                    for n in (1, 2)}
            elif jcfg.family != "ssm":
                refs[name]["cache"] = port_cache(cfg, params_t, toks)
    ctx = multiprocessing.get_context("spawn")
    groups = {}
    with tempfile.TemporaryDirectory() as tmp:
        for data, model in MESHES:
            queue = ctx.Queue()
            init = os.path.join(tmp, f"init-{data}x{model}")
            procs = [ctx.Process(target=torch_serve_worker.run_rank,
                                 args=(r, data, model, init, cases, queue))
                     for r in range(data * model)]
            for p in procs:
                p.start()
            groups[(data, model)] = (queue, procs)
        results = {}
        for mesh, (queue, procs) in groups.items():
            got = {}
            try:
                for _ in procs:
                    rank, out = queue.get(timeout=JOIN_S)
                    got[rank] = out
            except Exception:
                got = None
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    got = None
            results[mesh] = got
    return refs, results


def reference(runs, name: str, mesh) -> dict:
    """The JAX reference a mesh's ranks are held to: an MoE case's data
    shards each on their own rows."""
    ref = runs[0][name]
    return ref[mesh[0]] if mesh[0] in ref else ref[1]


def group(runs, mesh) -> dict:
    results = runs[1][mesh]
    assert results is not None, f"a rank of {mesh} hung or died"
    failed = {r: out for r, out in results.items() if isinstance(out, str)}
    assert not failed, failed
    assert sorted(results) == list(range(mesh[0] * mesh[1]))
    return results


def picks_apart(got, want, ties: bool) -> list:
    """The rows whose argmax differs; with ``ties``, but the near-ties
    (``chip_smoke.py``'s rule for the card's sharded runs: the reference's
    gap between its pick and this run's within twice the row's largest
    logit difference)."""
    got, want = got[:, 0], want[:, 0]
    rows = []
    for r in np.nonzero(got.argmax(-1) != want.argmax(-1))[0]:
        gap = want[r].max() - want[r, got[r].argmax()]
        if not (ties and gap <= 2 * np.abs(got[r] - want[r]).max()):
            rows.append(int(r))
    return rows


def logits_rule(got: list, ref: dict, ties: bool = False) -> list:
    """The steps (index, rel, bound, rows picked apart) at which ``got``
    breaks the rule: rel to jitted JAX above the op-by-op run's plus 2^-6,
    or an argmax apart from the op-by-op run's (``picks_apart``)."""
    broken = []
    for i, (g, eager, jitted) in enumerate(zip(got, ref["eager"],
                                               ref["jitted"])):
        bound = rel_err(jitted, eager) + TIGHT
        apart = picks_apart(g, eager, ties)
        if rel_err(jitted, g) > bound or apart:
            broken.append((i, rel_err(jitted, g), bound, apart))
    return broken


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def routes_apart_at_near_ties(own: list, ref: dict, rows: slice) -> list:
    """Each MoE call's routing on a rank (its rows) against JAX's, by
    ``chip_smoke.py::routes_apart``: the choices apart, and the most by
    which the reference's logit gap between a choice apart and the rank's
    exceeds what the two runs' router logits' difference accounts for
    (<= 0 at a near-tie)."""
    smoke = _chip_smoke()
    calls = []
    for (t, g, l), (ti, gi, li) in zip(ref["routes"], own):
        k, E = t.shape[-1], l.shape[-1]
        want = tuple(torch.as_tensor(a.reshape(B, -1, n)[rows].reshape(-1, n))
                     for a, n in ((t, k), (g, k), (l, E)))
        calls.append(smoke.routes_apart(
            want, (torch.as_tensor(ti), torch.as_tensor(gi),
                   torch.as_tensor(li))))
    return calls


# the cases held to the dense rule as it stood, equal argmax; the others
# admit a pick apart at a near-tie (``picks_apart``)
STRICT = ("tinyllama-1.1b", "starcoder2-15b")


@pytest.mark.parametrize("arch", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_logits_match_jax(runs, mesh, arch):
    """The prefill's and every decode step's logits, the whole batch on
    every rank, against JAX op by op and jitted (an MoE case at a data axis
    of 2: each data shard's rows against JAX on those rows alone). An MoE
    case's logits fed JAX's routing keep the rule; with its own routing
    they keep it too, or its routing parts from JAX's, only at
    near-ties."""
    ref = reference(runs, arch, mesh)
    ties = arch not in STRICT
    results = group(runs, mesh)
    for rank, out in results.items():
        steps = out[arch]["logits"]
        assert len(steps) == 1 + TOKENS - PROMPT
        assert all(got.shape == (B, 1, 256) for got in steps), rank
        broken = logits_rule(steps, ref, ties)
        if "routes" in ref:
            fed = logits_rule(out[arch]["logits_fed"], ref, ties)
            assert not fed, (rank, fed)
            if broken:
                b = out["coords"]["data"] * (B // mesh[0])
                calls = routes_apart_at_near_ties(
                    out[arch]["routes"], ref, slice(b, b + B // mesh[0]))
                assert sum(c["apart"] for c in calls), (rank, broken)
                assert max(c["excess"] for c in calls) <= 0, (rank, calls)
                broken = []
        assert not broken, (rank, broken)
        # the logits are replicated: every rank returns the same ones
        assert all(np.array_equal(a, b) for a, b in
                   zip(steps, results[0][arch]["logits"])), rank


def test_capacity_case_tells_the_shard_capacity_apart(runs):
    """At capacity factor 0.5 the prefill drops tokens, and the capacity
    taken from a data shard's tokens (C = 4) gives other logits than the
    whole batch's (C = 8): the (2, 2) ranks, fed JAX's routing of each
    shard's rows, break the rule against JAX on the whole batch; the (1,
    2) ranks, one data shard, keep it."""
    from repro_torch.models.moe import _capacity
    cfg = case_configs(CAPACITY)[1]
    assert _capacity(B * PROMPT, cfg.top_k, cfg.n_experts,
                     cfg.capacity_factor) == 8
    assert _capacity(B // 2 * PROMPT, cfg.top_k, cfg.n_experts,
                     cfg.capacity_factor) == 4
    whole, shards = runs[0][CAPACITY][1], runs[0][CAPACITY][2]
    assert logits_rule(shards["eager"], whole, ties=True)
    for rank, out in group(runs, (2, 2)).items():
        assert logits_rule(out[CAPACITY]["logits_fed"], whole, ties=True), \
            rank
    for rank, out in group(runs, (1, 2)).items():
        assert not logits_rule(out[CAPACITY]["logits_fed"], whole,
                               ties=True), rank


def _reference_local_shapes(jmodel, mesh) -> tuple[dict, dict]:
    """Each parameter's and each cache leaf's shard shape under the
    reference's own specs (dims divided by the mesh axes each spec entry
    names); the K/V ``length`` is the port's one scalar, ()."""
    amesh = AbstractMesh(mesh, ("data", "model"))
    sizes = dict(zip(("data", "model"), mesh))

    def cut(spec, shape):
        out = []
        for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
            axes = () if part is None else (
                (part,) if isinstance(part, str) else tuple(part))
            out.append(dim // int(np.prod([sizes[a] for a in axes])))
        return tuple(out)

    def flat(tree, specs):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        spec_leaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in path): cut(spec, leaf.shape)
                for (path, leaf), spec in zip(leaves, spec_leaves)}

    decls = jmodel.param_decls()
    specs = jax_spec_tree(decls, amesh, jax_make_rules(amesh))
    flat_decls = jax.tree_util.tree_leaves(
        decls, is_leaf=lambda x: hasattr(x, "axes"))
    flat_specs = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    params = {"/".join(str(k.key) for k in path): cut(spec, d.shape)
              for (path, spec), d in zip(flat_specs, flat_decls)}
    cache = jax.eval_shape(lambda: jmodel.init_cache(B, MAX_LEN))
    cache = flat(cache, jax_cache_specs(jmodel, amesh, B, MAX_LEN))
    if "kv/length" in cache:
        cache["kv/length"] = ()
    return params, cache


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_shard_shapes_follow_the_reference_specs(runs, mesh, arch):
    want_params, want_cache = _reference_local_shapes(
        runs[0][arch]["jmodel"], mesh)
    for rank, out in group(runs, mesh).items():
        assert out[arch]["params"] == want_params, rank
        assert out[arch]["cache"] == want_cache, rank
        assert out["coords"] == {"data": rank // mesh[1],
                                 "model": rank % mesh[1]}


@pytest.mark.parametrize("arch", KV_ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_span_crossing_and_empty_span(runs, mesh, arch):
    """The decode crosses a span boundary, a rank attends over 0 valid
    keys in some step, and the ranks' spans of the cache, put together,
    hold the unsharded port's cache (an MoE case's run fed JAX's routing:
    JAX's cache, each data shard's its own) (layer 0 within 2^-6, every
    layer within the model rule's 0.06), and zeros past the length."""
    if "cache" in runs[0][arch]:
        k_ref, v_ref = runs[0][arch]["cache"]
    else:
        kv = reference(runs, arch, mesh)["cache"].kv
        k_ref, v_ref = kv.k, kv.v
    results = group(runs, mesh)
    keys = {rank: out[arch]["span_keys"] for rank, out in results.items()}
    assert any(k[0] == 0 and k[-1] > 0 for k in keys.values()), keys
    assert any(0 in k for k in keys.values()), keys
    b_local = B // mesh[0]
    for rank, out in results.items():
        start, size = out[arch]["span"]
        b0 = out["coords"]["data"] * b_local
        assert out[arch]["length"] == TOKENS
        for got, ref in zip(out[arch]["kv"], (k_ref, v_ref)):
            want = ref[:, b0:b0 + b_local, start:start + size]
            # layer 0's K/V come from the embeddings alone, before any sum
            # over the model axis; the later layers' carry its rounding
            assert rel_err(want[0], got[0]) < TIGHT, (rank, start)
            assert rel_err(want, got) < 0.06, (rank, start)
            assert not got[:, :, max(0, TOKENS - start):].any(), rank


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ssm_cache_shards_match_jax(runs, mesh):
    """Each rank's SSM cache after the steps against JAX op by op: its
    heads' state, and the conv tails, ``conv_x`` whole on every model
    rank (layer 0 within 2^-6, every layer within the model rule's 0.06);
    ``conv_x`` bit for bit alike on the model ranks of a data shard."""
    want = reference(runs, SSM_ARCH, mesh)["cache"].ssm
    results = group(runs, mesh)
    b_local = B // mesh[0]
    for rank, out in results.items():
        start, size = out[SSM_ARCH]["heads"]
        assert size == 8 // mesh[1]
        b = slice(out["coords"]["data"] * b_local,
                  (out["coords"]["data"] + 1) * b_local)
        state, conv_x, conv_B, conv_C = out[SSM_ARCH]["ssm"]
        for got, ref in ((state, want.state[:, b, start:start + size]),
                         (conv_x, want.conv_x[:, b]),
                         (conv_B, want.conv_B[:, b]),
                         (conv_C, want.conv_C[:, b])):
            assert got.shape == ref.shape, rank
            assert rel_err(ref[0], got[0]) < TIGHT, rank
            assert rel_err(ref, got) < 0.06, rank
        first = results[out["coords"]["data"] * mesh[1]]
        assert np.array_equal(conv_x, first[SSM_ARCH]["ssm"][1]), rank


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4), (2, 16)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_init_and_shard_params_hold_the_unsharded_model(
        monkeypatch, mesh, arch):
    """``init_params`` with specs gives each rank exactly its shards of
    the unsharded call's leaves, drawn in small slices here so that a
    leaf's draw spans several slices; ``shard_params`` cuts the same."""
    monkeypatch.setattr(param_mod, "_SLICE_ELEMENTS", 1000)
    model = build_model(get_config(arch, reduced=True))
    decls = model.param_decls()
    full = init_params(decls, torch.Generator().manual_seed(5), "cpu")
    for d in range(mesh[0]):
        for m in range(mesh[1]):
            rank = Mesh(mesh, ("data", "model"),
                        coords={"data": d, "model": m})
            specs = serve_lib.param_specs(model, rank)
            got = init_params(decls, torch.Generator().manual_seed(5),
                              "cpu", specs=specs, mesh=rank)
            cut = shard_params(full, specs, rank)
            for (path, a), (_, b), (_, f) in zip(tree_items(got),
                                                 tree_items(cut),
                                                 tree_items(full)):
                region = local_slices(tree_at(specs, path), tuple(f.shape),
                                      rank)
                assert torch.equal(a, f[region]), path
                assert torch.equal(a, b), path


@pytest.mark.parametrize("arch,mesh,kw,match", [
    # 4 q heads do not divide over 8: the reference shards head_dim instead
    ("seamless-m4t-large-v2", (1, 8), {}, "head_dim fallback"),
    # 8 experts do not divide over 16: the specs cut expert_mlp instead
    ("qwen3-moe-235b-a22b", (1, 16), {}, "expert_mlp"),
    # 8 heads do not divide over 16, their 128 inner columns do
    ("mamba2-370m", (1, 16), {}, "ssm_inner"),
    # 8 experts do not divide over 16: the specs cut expert_mlp instead
    ("jamba-1.5-large-398b", (1, 16), {}, "expert_mlp"),
    # 4 q heads do not divide over 8: the reference shards head_dim instead
    ("tinyllama-1.1b", (1, 8), {}, "head_dim fallback"),
    # the long-context branch (A.12 item 3): batch 1 does not divide over
    # the data axis of 2, so the reference cuts the cache's sequence over
    # every axis
    ("tinyllama-1.1b", (2, 2), {"batch": 1}, "K/V cache spec"),
    # 34 rows do not divide over 4: the cache's sequence stays replicated
    ("starcoder2-15b", (1, 4), {"max_len": 34}, "K/V cache spec"),
])
def test_uncovered_specs_raise_before_allocating(arch, mesh, kw, match):
    model = build_model(get_config(arch, reduced=True))
    max_len = kw.pop("max_len", 32)
    batch = kw.pop("batch", 8)
    with pytest.raises(NotImplementedError, match=f"(?s){match}.*A.12"):
        serve_lib.shard_layout(model, abstract_mesh(mesh), batch, max_len,
                               **kw)
    with pytest.raises(NotImplementedError, match="A.12"):
        serve_lib.build_decode_step(model, abstract_mesh(mesh), batch,
                                    max_len, **kw)


def test_steps_need_a_live_mesh():
    model = build_model(get_config("tinyllama-1.1b", reduced=True))
    with pytest.raises(ValueError, match="process group"):
        serve_lib.build_prefill_step(model, abstract_mesh((1, 2)), 8, 16, 32)


def test_row_parallel_partials_stay_fp32():
    """``matmul_f32``: bf16 operands' product summed in fp32 and not
    rounded; rounded once, it is the product ``matmul`` gives."""
    from repro_torch.models.common import matmul, matmul_f32
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 3, 64, generator=gen).bfloat16()
    w = torch.randn(64, 16, generator=gen).bfloat16()
    got = matmul_f32(x, w)
    want = x.double() @ w.double()
    assert got.dtype == torch.float32 and got.shape == (2, 3, 16)
    assert float((got.double() - want).abs().max()) < 1e-4
    assert torch.equal(got.bfloat16(), matmul(x, w))


@pytest.mark.parametrize("shape", [(10, 30), (3, 4, 50), (5, 200)])
def test_normal_draw_holds_one_slice_at_a_time(monkeypatch, shape):
    """A leaf is drawn in slices, and no slice outlives the next one's draw
    (a card-sized leaf's fp32 slices are 4 GiB each), whole or by region;
    rows over the slice size are drawn along their own axis (5 x 200)."""
    import weakref
    live, peak = [], [0]
    randn = torch.randn

    def counted(*args, **kw):
        t = randn(*args, **kw)
        peak[0] = max(peak[0], 1 + sum(w() is not None for w in live))
        live.append(weakref.ref(t))
        return t
    monkeypatch.setattr(param_mod, "_SLICE_ELEMENTS", 100)
    monkeypatch.setattr(param_mod.torch, "randn", counted)
    whole = torch.empty(shape)
    param_mod._fill_normal(whole, torch.Generator().manual_seed(0), 1.0)
    region = tuple(slice(s // 3, s // 3 + max(1, s // 2)) for s in shape)
    part = torch.empty(tuple(r.stop - r.start for r in region))
    param_mod._fill_normal(part, torch.Generator().manual_seed(0), 1.0,
                           shape, region)
    assert peak[0] == 1 and len(live) > 2
    assert torch.equal(part, whole[region])
