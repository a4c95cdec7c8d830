"""Sharded serving of the port (``repro_torch.runtime.serve_lib``) on the
CPU, against the JAX package's model.

Each mesh runs as a gloo group of spawned ranks (``torch_serve_worker``,
one thread a rank, a ``file://`` rendezvous): (1, 2), (2, 2) and (1, 4).
At (1, 4) the reduced models' 2 KV heads do not divide over the model axis
and stay replicated while the 4 q heads are cut, one a rank. Every group
runs all of its cases in one spawn, the three groups at once, and each is
joined with a timeout, so a hung rank fails the test.

The cases: reduced tinyllama-1.1b and reduced starcoder2-15b (plain gelu
MLP, untied head), batch 4, a 16-token prompt and 4 decode steps fed the
next tokens (teacher-forced), on weights carried from JAX ``init_params``
through numpy. The cache holds 36 rows: at (1, 2) and (2, 2) each model
rank holds 18, so the prompt ends in rank 0's span, the decode crosses
into rank 1's, and rank 1 has 0 valid keys in the first two steps; at (1,
4), 9 rows a rank, the prompt spans ranks 0 and 1, the decode crosses
from rank 1 into rank 2, and rank 3 has 0 valid keys throughout.

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
import multiprocessing
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

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
ARCHS = ["tinyllama-1.1b", "starcoder2-15b"]
MESHES = [(1, 2), (2, 2), (1, 4)]
B, PROMPT, TOKENS, MAX_LEN = 4, 16, 20, 36
JOIN_S = 240


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def rel_err(ref, got) -> float:
    ref, got = f32(ref), f32(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


def fan_in(params):
    """The reference's weights with the attention's wq, wk, wv and wo at
    std 1/sqrt(fan-in) (d_model; H * D for wo), as in
    tests/test_torch_vlm.py."""
    at = dict(params["layers"]["attn"])
    for n in ("wq", "wk", "wv"):
        at[n] = (at[n].astype(jnp.float32) * np.sqrt(
            at[n].shape[-2] / at[n].shape[-3])).astype(jnp.bfloat16)
    at["wo"] = (at["wo"].astype(jnp.float32) / np.sqrt(
        at["wo"].shape[-3])).astype(jnp.bfloat16)
    return {**params, "layers": {**params["layers"], "attn": at}}


def jax_steps(jmodel, params, toks, *, eager):
    """JAX's prefill of the prompt, then a decode step fed each next
    token, outside any mesh; the logits of each step."""
    with jax.disable_jit() if eager else contextlib.nullcontext():
        prefill = jmodel.prefill if eager else jax.jit(jmodel.prefill)
        decode = jmodel.decode_step if eager else jax.jit(jmodel.decode_step)
        cache = jmodel.init_cache(B, max_len=MAX_LEN)
        logits, cache = prefill(params, jnp.asarray(toks[:, :PROMPT]), cache)
        out = [f32(logits)]
        for t in range(PROMPT, TOKENS):
            logits, cache = decode(params, jnp.asarray(toks[:, t:t + 1]),
                                   cache)
            out.append(f32(logits))
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


@pytest.fixture(scope="module")
def runs():
    """The JAX references, the unsharded port's caches, and every rank's
    results of the three groups, spawned at once."""
    refs, cases = {}, {}
    for i, arch in enumerate(ARCHS):
        jcfg = jax_get_config(arch, reduced=True)
        jmodel = jax_build_model(jcfg)
        params_j = fan_in(jax_init_params(jmodel.param_decls(),
                                          jax.random.key(i)))
        toks = np.random.default_rng(i).integers(0, 256, size=(B, TOKENS))
        params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                     "cpu")
        cfg = get_config(arch, reduced=True)
        refs[arch] = {"eager": jax_steps(jmodel, params_j, toks, eager=True),
                      "jitted": jax_steps(jmodel, params_j, toks,
                                          eager=False),
                      "cache": port_cache(cfg, params_t, toks),
                      "jmodel": jmodel}
        cases[arch] = {"cfg": cfg, "params": params_t, "tokens": toks,
                       "prompt": PROMPT, "max_len": MAX_LEN}
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


def group(runs, mesh) -> dict:
    results = runs[1][mesh]
    assert results is not None, f"a rank of {mesh} hung or died"
    failed = {r: out for r, out in results.items() if isinstance(out, str)}
    assert not failed, failed
    assert sorted(results) == list(range(mesh[0] * mesh[1]))
    return results


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_logits_match_jax(runs, mesh, arch):
    """The prefill's and every decode step's logits, the whole batch on
    every rank, against JAX op by op and jitted."""
    ref = runs[0][arch]
    results = group(runs, mesh)
    for rank, out in results.items():
        steps = out[arch]["logits"]
        assert len(steps) == 1 + TOKENS - PROMPT
        for i, (got, eager, jitted) in enumerate(zip(steps, ref["eager"],
                                                     ref["jitted"])):
            assert got.shape == (B, 1, 256), (rank, i)
            assert rel_err(jitted, got) <= rel_err(jitted, eager) + TIGHT, \
                (rank, i)
            assert (eager.argmax(-1) == got.argmax(-1)).all(), (rank, i)
        # the logits are replicated: every rank returns the same ones
        assert all(np.array_equal(a, b) for a, b in
                   zip(steps, results[0][arch]["logits"])), rank


def _reference_local_shapes(jmodel, mesh) -> tuple[dict, tuple]:
    """Each leaf's shard shape under the reference's own specs (dims
    divided by the mesh axes each spec entry names)."""
    amesh = AbstractMesh(mesh, ("data", "model"))
    sizes = dict(zip(("data", "model"), mesh))

    def cut(spec, shape):
        out = []
        for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
            axes = () if part is None else (
                (part,) if isinstance(part, str) else tuple(part))
            out.append(dim // int(np.prod([sizes[a] for a in axes])))
        return tuple(out)

    decls = jmodel.param_decls()
    specs = jax_spec_tree(decls, amesh, jax_make_rules(amesh))
    flat_decls = jax.tree_util.tree_leaves(
        decls, is_leaf=lambda x: hasattr(x, "axes"))
    flat_specs = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    params = {"/".join(str(k.key) for k in path): cut(spec, d.shape)
              for (path, spec), d in zip(flat_specs, flat_decls)}
    kv = jax_cache_specs(jmodel, amesh, B, MAX_LEN).kv.k
    full = (jmodel.cfg.n_layers, B, MAX_LEN, jmodel.cfg.n_kv_heads,
            jmodel.cfg.head_dim)
    return params, cut(kv, full)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_shard_shapes_follow_the_reference_specs(runs, mesh, arch):
    want_params, want_kv = _reference_local_shapes(runs[0][arch]["jmodel"],
                                                   mesh)
    for rank, out in group(runs, mesh).items():
        assert out[arch]["params"] == want_params, rank
        assert out[arch]["cache"]["kv/k"] == want_kv, rank
        assert out[arch]["cache"]["kv/v"] == want_kv, rank
        assert out[arch]["cache"]["kv/length"] == (), rank
        assert out["coords"] == {"data": rank // mesh[1],
                                 "model": rank % mesh[1]}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_span_crossing_and_empty_span(runs, mesh, arch):
    """The decode crosses a span boundary, a rank attends over 0 valid
    keys in some step, and the ranks' spans of the cache, put together,
    hold the unsharded port's cache (layer 0 within 2^-6, every layer
    within the model rule's 0.06), and zeros past the length."""
    k_ref, v_ref = runs[0][arch]["cache"]
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
    ("qwen3-moe-235b-a22b", (1, 2), {}, "moe family"),
    ("mamba2-370m", (1, 2), {}, "ssm family"),
    ("jamba-1.5-large-398b", (1, 2), {}, "hybrid family"),
    ("qwen2-vl-72b", (1, 2), {}, "vlm family"),
    # 4 q heads do not divide over 8: the reference shards head_dim instead
    ("tinyllama-1.1b", (1, 8), {}, "head_dim fallback"),
    ("tinyllama-1.1b", (2, 2), {"zero3": True}, "ZeRO-3"),
    # 34 rows do not divide over 4: the cache's sequence stays replicated
    ("starcoder2-15b", (1, 4), {"max_len": 34}, "K/V cache spec"),
])
def test_uncovered_specs_raise_before_allocating(arch, mesh, kw, match):
    model = build_model(get_config(arch, reduced=True))
    max_len = kw.pop("max_len", 32)
    with pytest.raises(NotImplementedError, match=f"(?s){match}.*A.12"):
        serve_lib.shard_layout(model, abstract_mesh(mesh), 8, max_len, **kw)
    with pytest.raises(NotImplementedError, match="A.12"):
        serve_lib.build_decode_step(model, abstract_mesh(mesh), 8, max_len,
                                    **kw)


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
