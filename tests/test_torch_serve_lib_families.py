"""Sharded serving of the hybrid and encoder-decoder families
(``repro_torch.runtime.serve_lib``) on the CPU, against the JAX package's
model; ``tests/test_torch_serve_lib.py`` holds the other families, and
this file shares its rules, its meshes and its worker
(``torch_serve_worker``: one spawned rank a process, a gloo group a mesh,
one group at a time, each joined with a timeout, so a hung rank fails the
test).

The cases, on weights carried from JAX ``init_params`` through numpy, the
attention at std 1/sqrt(fan-in) on both sides (``fan_in``: at the
reference's draw the softmax saturates, as the other file says):

* reduced jamba-1.5-large-398b: one super-block of period 8 (the
  attention at sublayer 3, 7 Mamba sublayers, the MoE at sublayers 1, 3,
  5, 7: 4 MoE and 4 MLP sublayers), 4 heads over 2 KV heads, 8 experts
  top-2, 8 SSM heads;
* reduced seamless-m4t-large-v2: 2 encoder and 4 decoder layers, 4 heads
  over 2 KV heads, over 16 frames a sequence;

each at (1, 2), (2, 2) and (1, 4): batch 4, a 16-token prompt, 4 decode
steps fed the next tokens, a cache of 36 rows (18 a rank at a model axis
of 2, the decode crossing into rank 1's span; 9 at 4). At (1, 4) the 2 KV
heads stay whole on every rank while the 4 q heads are cut, one a rank.

* Logits: the other file's rule against JAX jitted outside a mesh, no
  further from it than JAX's op-by-op run is plus 2^-6, and the op-by-op
  run's picks (the encoder-decoder's equal; jamba's apart only at
  near-ties where its routing parts). The hybrid's JAX MoE runs with its
  ``shard_map`` the identity; at a data axis of 2 each data shard is held
  to JAX on its own rows (the reference's capacity is a data shard's); its
  logits are also held fed JAX's routing, and with its own routing only
  where the routing parts at near-ties.
* Caches, against JAX op by op: each rank's span of the K/V cache (the
  hybrid's block, the encoder-decoder's fp32 self cache) and zeros past
  the length; the hybrid's SSM state shards (heads on axis 3 of the
  stacked (blocks, sublayers, B, H, P, N) state) and conv tails,
  ``conv_x`` alike on the model ranks; the encoder-decoder's memory K/V,
  every head on every rank. Each within the model rule's 0.06, and the
  first layer of those computed before any sum over the model axis
  (the encoder-decoder's self K/V of layer 0, from the embeddings) within
  2^-6.
* Shard shapes against the reference's ``spec_tree`` and ``cache_specs``.
* A decoder layer of the reduced seamless over its fp32 self cache,
  sharded against unsharded (``torch_serve_worker.decoder_layer_case``):
  within 2^-6, the decode's partial entry called with q in the cache's
  fp32, as the kernel's entries take it (one dtype a call).
"""

import contextlib
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
from repro.runtime.serve_lib import cache_specs as jax_cache_specs
from repro.sharding.rules import make_rules as jax_make_rules
from repro.sharding.rules import spec_tree as jax_spec_tree
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh, abstract_mesh
from repro_torch.models import build_model, params_from_numpy
from repro_torch.runtime import serve_lib
from test_torch_serve_lib import (B, JOIN_S, MAX_LEN, MESHES, PROMPT, TIGHT,
                                  TOKENS, f32, group, logits_rule, rel_err,
                                  routes_apart_at_near_ties)

HYBRID, ENCDEC = "jamba-1.5-large-398b", "seamless-m4t-large-v2"
ARCHS = [HYBRID, ENCDEC]
FRAMES = 16
# the repair case: one decoder layer over the fp32 self cache
LAYER = "seamless decoder layer"
MODEL_TOL = 0.06


def attention_roots(family: str) -> tuple:
    return (("encoder", "attn"), ("decoder", "self_attn"),
            ("decoder", "cross_attn")) if family == "encdec" \
        else (("layers", "attn"),)


def fan_in(params, family: str):
    """The reference's weights with every attention's wq, wk, wv and wo at
    std 1/sqrt(fan-in) (d_model; H * D for wo), as
    tests/test_torch_serve_lib.py rescales them."""
    params = dict(params)
    for outer, name in attention_roots(family):
        at = dict(params[outer][name])
        for n in ("wq", "wk", "wv"):
            at[n] = (at[n].astype(jnp.float32) * np.sqrt(
                at[n].shape[-2] / at[n].shape[-3])).astype(jnp.bfloat16)
        at["wo"] = (at["wo"].astype(jnp.float32) / np.sqrt(
            at["wo"].shape[-3])).astype(jnp.bfloat16)
        params[outer] = {**params[outer], name: at}
    return params


def jax_steps(jmodel, params, toks, frames, *, eager):
    """JAX's prefill of the prompt (over ``frames``, an encoder-decoder's),
    then a decode step fed each next token, outside any mesh: each step's
    logits, the final cache (numpy) and, op by op, each MoE call's routing
    (topi, gates) and router input x, as its per-device block receives
    them."""
    calls = []
    block = jax_moe_mod._moe_local

    def recording(x, topi, gates, *rest, **kw):
        if eager:
            k = topi.shape[-1]
            calls.append((np.asarray(topi).reshape(-1, k),
                          np.asarray(gates).reshape(-1, k), f32(x)))
        return block(x, topi, gates, *rest, **kw)
    n = toks.shape[0]
    if frames is None:
        cache, inputs = jmodel.init_cache(n, max_len=MAX_LEN), ()
    else:
        cache = jmodel.init_cache(n, max_len=MAX_LEN, memory_len=FRAMES)
        inputs = (jnp.asarray(frames),)
    with jax.disable_jit() if eager else contextlib.nullcontext(), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_moe_mod, "_moe_local", recording)
        prefill = jmodel.prefill if eager else jax.jit(jmodel.prefill)
        decode = jmodel.decode_step if eager else jax.jit(jmodel.decode_step)
        logits, cache = prefill(params, *inputs, jnp.asarray(toks[:, :PROMPT]),
                                cache)
        out = [f32(logits)]
        for t in range(PROMPT, TOKENS):
            logits, cache = decode(params, jnp.asarray(toks[:, t:t + 1]),
                                   cache)
            out.append(f32(logits))
    return out, jax.tree.map(f32, cache), calls


def _cat_batch(caches: list, family: str):
    """The data shards' caches put back together along the batch: axis 1
    of the K/V and memory leaves, axis 2 of a hybrid's SSM leaves (behind
    its block and sublayer axes); a length as it is."""
    if len(caches) == 1:
        return caches[0]

    def cat(axis):
        return lambda *a: np.concatenate(a, axis=axis) if a[0].ndim > 1 \
            else a[0]
    if family == "hybrid":
        return caches[0]._replace(
            kv=jax.tree.map(cat(1), *(c.kv for c in caches)),
            ssm=jax.tree.map(cat(2), *(c.ssm for c in caches)))
    return jax.tree.map(cat(1), *caches)


def jax_refs(jmodel, params, toks, frames, shards: int) -> dict:
    """Op-by-op and jitted JAX logits of each step, the batch run as
    ``shards`` data shards, each on its rows alone, put back together
    along the batch; the op-by-op final cache, and the MoE layers'
    routing of each call (topi, gates, router logits (T, E) fp32) the same
    way (as tests/test_torch_serve_lib.py's ``jax_refs``)."""
    parts = list(zip(np.split(toks, shards), [None] * shards
                     if frames is None else np.split(frames, shards)))
    runs = {eager: [jax_steps(jmodel, params, rows, fr, eager=eager)
                    for rows, fr in parts] for eager in (True, False)}
    out = {name: [np.concatenate(step) for step in zip(*(r[0] for r
                                                          in runs[eager]))]
           for name, eager in (("eager", True), ("jitted", False))}
    out["cache"] = _cat_batch([r[1] for r in runs[True]], jmodel.cfg.family)
    if jmodel.cfg.n_experts:
        # one router a MoE sublayer, in the order the model calls them
        routers = np.asarray(params["layers"]["moe"]["router"], np.float32)
        routers = routers.reshape((-1,) + routers.shape[-2:])
        out["routes"] = []
        for c, per_shard in enumerate(zip(*(r[2] for r in runs[True]))):
            x = np.concatenate([x.reshape(-1, x.shape[-1])
                                for _, _, x in per_shard])
            out["routes"].append(
                (np.concatenate([t for t, _, _ in per_shard]),
                 np.concatenate([g for _, g, _ in per_shard]),
                 x @ routers[c % len(routers)]))
    return out


@pytest.fixture(scope="module")
def runs():
    """The JAX references (the hybrid also as two data shards, and the
    routing its ranks are fed) and every rank's results of the three
    groups (``run_group``)."""
    refs, cases = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        # the reference's MoE layer on one device, its shard_map the
        # identity (tests/test_torch_moe.py)
        mp.setattr(jax_moe_mod, "shard_map", lambda f, **_: f)
        mp.setattr(jax_moe_mod, "model_axis", lambda mesh=None: None)
        for seed, arch in enumerate(ARCHS):
            jcfg, cfg = (get(arch, reduced=True)
                         for get in (jax_get_config, get_config))
            jmodel = jax_build_model(jcfg)
            decls = jmodel.param_decls()
            # one compiled draw: leaf by leaf, op by op, it takes ~18 s
            params_j = fan_in(jax.jit(lambda key: jax_init_params(
                decls, key))(jax.random.key(seed)), jcfg.family)
            rng = np.random.default_rng(seed)
            toks = rng.integers(0, 256, size=(B, TOKENS))
            frames = None
            if jcfg.family == "encdec":
                frames = rng.normal(size=(B, FRAMES, jcfg.d_model)) \
                    .astype(np.float32)
            params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                         "cpu")
            refs[arch] = {"jmodel": jmodel,
                          1: jax_refs(jmodel, params_j, toks, frames, 1)}
            cases[arch] = {"cfg": cfg, "params": params_t, "tokens": toks,
                           "frames": frames, "prompt": PROMPT,
                           "max_len": MAX_LEN}
            if jcfg.n_experts:
                refs[arch][2] = jax_refs(jmodel, params_j, toks, frames, 2)
                cases[arch]["routes"] = {
                    n: [(t, g) for t, g, _ in refs[arch][n]["routes"]]
                    for n in (1, 2)}
    gen = torch.Generator().manual_seed(7)
    seamless = cases[ENCDEC]["cfg"]
    memory = (seamless.n_layers, B, FRAMES, seamless.n_kv_heads,
              seamless.head_dim)
    cases[LAYER] = {
        "run": torch_serve_worker.decoder_layer_case, "cfg": seamless,
        "params": cases[ENCDEC]["params"], "prompt": PROMPT,
        "max_len": MAX_LEN,
        "x": torch.randn(B, TOKENS, seamless.d_model,
                         generator=gen).bfloat16(),
        "cross": tuple(torch.randn(memory, generator=gen).bfloat16()
                       for _ in range(2))}
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = {mesh: run_group(ctx, os.path.join(
            tmp, f"init-{mesh[0]}x{mesh[1]}"), mesh, cases)
            for mesh in MESHES}
    return refs, results


def run_group(ctx, init: str, mesh, cases: dict) -> dict | None:
    """Every rank of ``mesh`` serving ``cases`` (``torch_serve_worker``),
    joined with a timeout: rank -> its results, or None when a rank hung or
    died. One group at a time, so that at most four ranks run beside the
    suite's other workers."""
    data, model = mesh
    queue = ctx.Queue()
    procs = [ctx.Process(target=torch_serve_worker.run_rank,
                         args=(r, data, model, init, cases, queue))
             for r in range(data * model)]
    for p in procs:
        p.start()
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
    return got


def reference(runs, name: str, mesh) -> dict:
    """The JAX reference a mesh's ranks are held to: the hybrid's data
    shards each on their own rows."""
    ref = runs[0][name]
    return ref[mesh[0]] if mesh[0] in ref else ref[1]


def batch_rows(out: dict, mesh) -> slice:
    b = B // mesh[0]
    return slice(out["coords"]["data"] * b, (out["coords"]["data"] + 1) * b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_logits_match_jax(runs, mesh, arch):
    """The prefill's and every decode step's logits, the whole batch on
    every rank, against JAX op by op and jitted. The hybrid's logits fed
    JAX's routing keep the rule; with its own routing they keep it too,
    or the routing of some data shard parts from JAX's, only at
    near-ties (every rank returns the whole batch's logits)."""
    ref = reference(runs, arch, mesh)
    results = group(runs, mesh)
    for rank, out in results.items():
        steps = out[arch]["logits"]
        assert len(steps) == 1 + TOKENS - PROMPT
        assert all(got.shape == (B, 1, 256) for got in steps), rank
        broken = logits_rule(steps, ref, ties=arch == HYBRID)
        if "routes" in ref:
            fed = logits_rule(out[arch]["logits_fed"], ref, ties=True)
            assert not fed, (rank, fed)
            if broken:
                # the logits are the whole batch's: each data shard's
                # routing, as its first model rank made it
                calls = [c for o in results.values()
                         if o["coords"]["model"] == 0
                         for c in routes_apart_at_near_ties(
                             o[arch]["routes"], ref, batch_rows(o, mesh))]
                assert sum(c["apart"] for c in calls), (rank, broken)
                assert max(c["excess"] for c in calls) <= 0, (rank, calls)
                broken = []
        assert not broken, (rank, broken)
        # the logits are replicated: every rank returns the same ones
        assert all(np.array_equal(a, b) for a, b in
                   zip(steps, results[0][arch]["logits"])), rank


def _reference_local_shapes(jmodel, mesh) -> tuple[dict, dict]:
    """Each parameter's and each cache leaf's shard shape under the
    reference's own specs (dims divided by the mesh axes each spec entry
    names); the K/V ``length`` is the port's one scalar, (), and the
    encoder-decoder's ``cross_length``, which the reference's cache has
    not, ()."""
    amesh = AbstractMesh(mesh, ("data", "model"))
    sizes = dict(zip(("data", "model"), mesh))

    def cut(spec, shape):
        out = []
        for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
            axes = () if part is None else (
                (part,) if isinstance(part, str) else tuple(part))
            out.append(dim // int(np.prod([sizes[a] for a in axes])))
        return tuple(out)

    def is_spec(x):
        return isinstance(x, jax.sharding.PartitionSpec)

    def flat(tree, specs):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=is_spec)
        return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in path): cut(spec, leaf.shape)
                for (path, leaf), spec in zip(leaves, spec_leaves)}

    decls = jmodel.param_decls()
    specs = jax_spec_tree(decls, amesh, jax_make_rules(amesh))
    flat_decls = jax.tree_util.tree_leaves(
        decls, is_leaf=lambda x: hasattr(x, "axes"))
    flat_specs = jax.tree_util.tree_flatten_with_path(specs,
                                                      is_leaf=is_spec)[0]
    params = {"/".join(str(k.key) for k in path): cut(spec, d.shape)
              for (path, spec), d in zip(flat_specs, flat_decls)}
    if jmodel.cfg.family == "encdec":
        cache = jax.eval_shape(lambda: jmodel.init_cache(B, MAX_LEN, FRAMES))
    else:
        cache = jax.eval_shape(lambda: jmodel.init_cache(B, MAX_LEN))
    cache = flat(cache, jax_cache_specs(jmodel, amesh, B, MAX_LEN))
    for name in ("kv/length", "self_kv/length"):
        if name in cache:
            cache[name] = ()
    if jmodel.cfg.family == "encdec":
        cache["cross_length"] = ()
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_kv_spans_match_jax(runs, mesh, arch):
    """The decode crosses a span boundary, a rank attends over 0 valid
    keys in some step, and each rank's span of the K/V cache (the
    hybrid's, its run fed JAX's routing; the encoder-decoder's fp32 self
    cache) holds JAX's rows (every layer within 0.06; the
    encoder-decoder's layer 0, made from the embeddings before any sum
    over the model axis, within 2^-6), and zeros past the length."""
    cache = reference(runs, arch, mesh)["cache"]
    kv = cache.kv if arch == HYBRID else cache.self_kv
    results = group(runs, mesh)
    keys = {rank: out[arch]["span_keys"] for rank, out in results.items()}
    assert any(k[0] == 0 and k[-1] > 0 for k in keys.values()), keys
    assert any(0 in k for k in keys.values()), keys
    for rank, out in results.items():
        start, size = out[arch]["span"]
        b = batch_rows(out, mesh)
        assert out[arch]["length"] == TOKENS
        for got, ref in zip(out[arch]["kv"], (kv.k, kv.v)):
            want = ref[:, b, start:start + size]
            assert got.shape == want.shape, rank
            if arch == ENCDEC:
                assert rel_err(want[0], got[0]) < TIGHT, (rank, start)
            assert rel_err(want, got) < MODEL_TOL, (rank, start)
            assert not got[:, :, max(0, TOKENS - start):].any(), rank


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_hybrid_ssm_shards_match_jax(runs, mesh):
    """Each rank's SSM cache after the steps (its run fed JAX's routing)
    against JAX's, sublayer by sublayer: its heads' state (axis 3 of the
    stacked (blocks, sublayers, B, H, P, N) state), and the conv tails,
    ``conv_x`` whole on every model rank, within 0.06; ``conv_x`` bit for
    bit alike on the model ranks of a data shard."""
    want = reference(runs, HYBRID, mesh)["cache"].ssm
    results = group(runs, mesh)
    for rank, out in results.items():
        start, size = out[HYBRID]["heads"]
        assert size == 8 // mesh[1]
        b = batch_rows(out, mesh)
        state, conv_x, conv_B, conv_C = out[HYBRID]["ssm"]
        for got, ref in ((state, want.state[:, :, b, start:start + size]),
                         (conv_x, want.conv_x[:, :, b]),
                         (conv_B, want.conv_B[:, :, b]),
                         (conv_C, want.conv_C[:, :, b])):
            assert got.shape == ref.shape, rank
            for i in range(ref.shape[1]):
                assert rel_err(ref[:, i], got[:, i]) < MODEL_TOL, (rank, i)
        first = results[out["coords"]["data"] * mesh[1]]
        assert np.array_equal(conv_x, first[HYBRID]["ssm"][1]), rank


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_encdec_cross_cache_matches_jax(runs, mesh):
    """Each rank's memory K/V after the prefill, every KV head of every
    layer (the reference's spec: the heads gathered from every model
    rank's projection), against JAX's ``cross_k``/``cross_v`` of its
    rows within 0.06, layer 0 within 2^-6 (two encoder layers' row-parallel
    sums apart from JAX's op-by-op products)."""
    want = reference(runs, ENCDEC, mesh)["cache"]
    for rank, out in group(runs, mesh).items():
        b = batch_rows(out, mesh)
        for got, ref in zip(out[ENCDEC]["cross"],
                            (want.cross_k, want.cross_v)):
            assert got.shape == ref[:, b].shape == (4, B // mesh[0], FRAMES,
                                                    2, 16), rank
            assert rel_err(ref[0, b], got[0]) < TIGHT, rank
            assert rel_err(ref[:, b], got) < MODEL_TOL, rank


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_decoder_layer_over_fp32_cache(runs, mesh):
    """A decoder layer of the reduced seamless, sharded over its fp32 self
    cache, against the same layer unsharded: the prefill's and each decode
    step's output within 2^-6 (the row-parallel products are summed in
    fp32 and rounded once); the decode's partial entry takes q in the
    cache's fp32, as the kernel's entries take one dtype a call (a bf16 q
    over the fp32 cache raises)."""
    for rank, out in group(runs, mesh).items():
        res = out[LAYER]
        r0, r1 = res["rows"]
        assert len(res["sharded"]) == 1 + TOKENS - PROMPT
        for got, want in zip(res["sharded"], res["unsharded"]):
            assert rel_err(want[r0:r1], got) < TIGHT, rank
        # one call a decode step of the sharded run
        assert res["partial_dtypes"] == [("torch.float32", "torch.float32")
                                         ] * (TOKENS - PROMPT), rank


def test_partial_entry_refuses_mixed_dtypes():
    """The plain partial decode takes what the kernel's entries take: q
    and the cache of one dtype."""
    from repro_torch.models.attention import _decode_partial_core
    q = torch.zeros(1, 1, 2, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="one dtype"):
        _decode_partial_core(q, k, k, torch.tensor(4, dtype=torch.int32))
    out, lse = _decode_partial_core(q.float(), k, k,
                                    torch.tensor(4, dtype=torch.int32))
    assert out.shape == (1, 1, 2, 16) and lse.shape == (1, 2)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_encdec_cache_shards(mesh):
    """``init_cache_shards`` of the encoder-decoder on every rank: the
    fp32 self cache over the rank's rows of its batch span, the bf16
    memory K/V with every KV head over ``memory_len`` frames, and
    ``cross_length`` = ``memory_len``."""
    model = build_model(get_config(ENCDEC, reduced=True))
    cfg = model.cfg
    for d in range(mesh[0]):
        for m in range(mesh[1]):
            rank = Mesh(mesh, ("data", "model"),
                        coords={"data": d, "model": m})
            cache = serve_lib.init_cache_shards(model, rank, B, MAX_LEN,
                                                memory_len=FRAMES,
                                                device="cpu")
            b = B // mesh[0]
            assert cache.self_kv.k.dtype == torch.float32
            assert cache.self_kv.k.shape == (cfg.n_layers, b,
                                             MAX_LEN // mesh[1],
                                             cfg.n_kv_heads, cfg.head_dim)
            for t in (cache.cross_k, cache.cross_v):
                assert t.dtype == torch.bfloat16
                assert t.shape == (cfg.n_layers, b, FRAMES, cfg.n_kv_heads,
                                   cfg.head_dim)
            assert int(cache.cross_length) == FRAMES
            assert int(cache.self_kv.length) == 0


@pytest.mark.parametrize("leaf,axis", [("wq", "heads"), ("wk", "kv_heads")])
def test_encdec_attention_spans_must_agree(monkeypatch, leaf, axis):
    """The encoder-decoder's layout reads its attention spans from the
    encoder's, the decoder's self- and cross-attention; one cut unlike
    the others is refused, naming A.12, before anything is allocated."""
    model = build_model(get_config(ENCDEC, reduced=True))
    param_specs = serve_lib.param_specs

    def unlike(model, mesh, **kw):
        specs = param_specs(model, mesh, **kw)
        enc = dict(specs["encoder"])
        attn = dict(enc["attn"])
        attn[leaf] = type(attn[leaf])(*(None for _ in attn[leaf]))
        enc["attn"] = attn
        return {**specs, "encoder": enc}
    monkeypatch.setattr(serve_lib, "param_specs", unlike)
    with pytest.raises(NotImplementedError,
                       match=f"(?s){axis} axis cut unlike.*A.12"):
        serve_lib.shard_layout(model, abstract_mesh((1, 2)), B, MAX_LEN)
