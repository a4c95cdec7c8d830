"""Sharded training of the port (``runtime/train_lib.py``'s
``build_train_step(..., mesh=)``) on the CPU, against the port's unsharded
step and against JAX.

Each mesh runs as a gloo group of spawned ranks (``torch_serve_worker``'s
``"run"`` cases, ``train_case``): (1, 2), (2, 2), (1, 4) and (2, 1), four
ranks at a time (the first four beside the references), each group joined
with a timeout, so a hung rank fails the test.
At (1, 4) the reduced models' 2 KV heads do not divide over the model axis:
``wk``/``wv`` stay whole on every rank and their gradients are parts,
summed over the model axis. At (2, 1) the model axis holds one rank.

The cases: each dense arch's reduced config (tinyllama-1.1b, starcoder2-15b,
nemotron-4-15b, qwen3-14b: 4 layers, H = 4, Hk = 2, vocab 256) in bf16 with
one microbatch, no mask and ZeRO-1 off, and in fp32 with 2 microbatches, a
mask whose counts differ between microbatches and data shards, and ZeRO-1
on; tinyllama under ``dp_only`` (the model axis joins the data axes;
every parameter whole on every rank); qwen3-14b with ``pad_heads_to=6``,
so that rank 1 of a model axis of 2 holds the padded heads 4 and 5; and
the four planted faults of ``chip_smoke.py``'s ``TRAIN_FAULTS``, the same
code as on the card. Batch 8 x 32 tokens, weights from JAX's
``init_params`` with the attention at std 1/sqrt(fan-in) (``fan_in``: at
the reference's draw the softmax saturates and the orders of the sums part
the gradients with no fault in either path). An fp32 case casts every
weight to fp32, so every activation but the embedding's output (bf16, as
``embed_tokens`` rounds it) is fp32.

Each rank's loss, ``grad_norm``, gradient shards, updated parameter shards
and moment shards are held to the port's unsharded step on the whole batch
(which ``tests/test_torch_train.py`` holds to JAX), and for tinyllama (bf16,
and fp32) and qwen3-14b (padded, 2 microbatches, masked) also to
``jax.value_and_grad(model.loss_fn)`` op by op, averaged over the
reference's global microbatches, and JAX's ``adamw_update``. Tolerances,
and why:

* fp32: loss rel 1e-5 (fp32 sums in another order); each gradient shard
  within 1e-4 of its slice's norm, but ``embed`` and ``layers/ln1``
  within 2^-5: their gradients pass through the bf16 embedding output,
  which both paths round to bf16 at sums taken in another order; so the
  norm, to which ``embed`` adds most, rel 1e-3; against JAX each
  gradient within 1e-3 (its ops sum in other orders: up to 1.2e-4);
* bf16: loss rel 1e-3, norm rel 1e-2, each gradient shard within
  ``TRAIN_GRAD_TOL`` (3e-2) of its slice's norm, the card's train-check
  rule (bf16 products rounded per rank before the sum over the model
  axis, the unsharded path rounds the whole sum once; measured here
  0.009-0.015);
* updates, both: ``chip_smoke.update_rule``: Adam's first step moves
  each weight by lr g / (|g| + eps), +-lr whatever the gradient's size,
  so an element whose gradient is off the reference's by more than half
  its size (a flipped sign among them), or whose clipped gradient is
  within 100 eps of 0, moves otherwise under a rounding of the gradient
  that the gradient rule admits (a tie): each leaf's other elements
  within 3e-2 of their norm, and no more ties than the elements the
  gradient rule lets tie (those whose reference gradient is under twice
  its admitted error an element, 3e-2 ||g|| / sqrt(n), or the eps
  floor); the moment shards within the gradient's tolerance plus the
  norm's (the clip scales the gradient by the norm; v twice it, being
  squared);
* the all_reduce calls of the step equal ``chip_smoke.train_collectives``;
* each planted fault breaks one of these rules on every rank of its run.
"""

import dataclasses
import multiprocessing
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim.adamw as jax_adamw
import torch_serve_worker
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.param import tree_at, tree_items, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import train_lib
from repro_torch.sharding.rules import local_slices


SMOKE = torch_serve_worker.chip_smoke()
ARCHS = ["tinyllama-1.1b", "starcoder2-15b", "nemotron-4-15b", "qwen3-14b"]
MESHES = [(1, 2), (2, 2), (1, 4), (2, 1)]
B, S = 8, 32
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
JOIN_S = 300
GRAD_TOL = {"float32": 1e-4, "bfloat16": SMOKE.TRAIN_GRAD_TOL}
# against JAX op by op in fp32 the orders of the sums part the gradients
# by up to 1.2e-4 of their norm (4 layers; the sharded and unsharded port
# within ~1e-6 of each other)
JAX_GRAD_TOL = {"float32": 1e-3, "bfloat16": SMOKE.TRAIN_GRAD_TOL}
# leaves whose fp32 gradient passes through the bf16 embedding output
BF16_ROUNDED = ("embed", "layers/ln1")
FAULT_ARCH = "tinyllama-1.1b"


def spec(name: str) -> dict:
    """A case's arch, dtype, microbatches, mask, ZeRO-1 and config
    changes, from its name: "<arch>/bf16", "<arch>/fp32",
    "tinyllama-1.1b/dp_only", "qwen3-14b/pad6" or "fault:<i>"."""
    if name.startswith("fault:"):
        i = int(name.split(":")[1])
        return dict(arch=FAULT_ARCH, dtype="bfloat16", mu=1, mask=False,
                    zero1=i == 3, changes={},
                    fault=SMOKE.TRAIN_FAULTS[i])
    arch, kind = name.split("/")
    return {"bf16": dict(arch=arch, dtype="bfloat16", mu=1, mask=False,
                         zero1=False, changes={}),
            "fp32": dict(arch=arch, dtype="float32", mu=2, mask=True,
                         zero1=True, changes={}),
            "dp_only": dict(arch=arch, dtype="bfloat16", mu=2, mask=True,
                            zero1=True, changes={"dp_only": True}),
            "pad6": dict(arch=arch, dtype="bfloat16", mu=2, mask=True,
                         zero1=False, changes={"pad_heads_to": 6}),
            }[kind]


def cases_of(mesh) -> list:
    names = [f"{a}/{k}" for a in ARCHS for k in ("bf16", "fp32")]
    if mesh in ((1, 2), (2, 2)):
        names.append("tinyllama-1.1b/dp_only")
    if mesh != (1, 4):               # 6 heads do not divide over 4
        names.append("qwen3-14b/pad6")
    names += [f"fault:{i}" for i, f in enumerate(SMOKE.TRAIN_FAULTS)
              if f in SMOKE.TRAIN_FAULTS_AT.get(mesh, ())]
    return names


JAX_CASES = ["tinyllama-1.1b/bf16", "tinyllama-1.1b/fp32", "qwen3-14b/pad6"]


def configs(sp: dict):
    jcfg = dataclasses.replace(jax_get_config(sp["arch"], reduced=True),
                               microbatches=sp["mu"], **sp["changes"])
    cfg = dataclasses.replace(get_config(sp["arch"], reduced=True),
                              microbatches=sp["mu"], **sp["changes"])
    return jcfg, cfg


def fan_in(params, cfg):
    """JAX's weights with the attention's wq, wk, wv and wo at std
    1/sqrt(fan-in), as ``chip_smoke.attention_at_fan_in`` draws them."""
    at = dict(params["layers"]["attn"])
    for n, heads in (("wq", cfg.n_heads_eff), ("wk", cfg.n_kv_heads),
                     ("wv", cfg.n_kv_heads)):
        at[n] = (at[n].astype(jnp.float32) * np.sqrt(heads / cfg.d_model)
                 ).astype(at[n].dtype)
    at["wo"] = (at["wo"].astype(jnp.float32) / np.sqrt(cfg.n_heads_eff)
                ).astype(at["wo"].dtype)
    return {**params, "layers": {**params["layers"], "attn": at}}


def batch_of(seed: int, masked: bool) -> dict:
    """8 x 33 tokens; the mask leaves data shard 0's first rows (the first
    microbatch) with fewer tokens than the rest."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 256, (B, S + 1)).astype(np.int32)}
    if masked:
        mask = (rng.random((B, S)) < 0.6).astype(np.float32)
        mask[:2, S // 4:] = 0.0
        batch["mask"] = mask
    return batch


def port_reference(cfg, params_t, batch) -> dict:
    """The unsharded step's loss, norm, gradients, updated parameters and
    moments (fp32 numpy by path)."""
    model = build_model(cfg)
    opt = AdamWConfig(**OPT)
    params = tree_map(lambda a: a.clone(), params_t)
    state = train_lib.TrainState(params, train_lib.adamw_init(params, opt))
    kept = {}

    def capture(update):
        def recording(p, g, s, c):
            kept.update({"/".join(k): t.float().numpy().copy()
                         for k, t in tree_items(g)})
            return update(p, g, s, c)
        return recording
    with SMOKE.patched(train_lib, "adamw_update", capture):
        state, metrics = train_lib.build_train_step(model, opt)(
            state, {k: torch.as_tensor(v) for k, v in batch.items()})
    flat = lambda tree: {"/".join(k): a.float().numpy()
                         for k, a in tree_items(tree)}
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]), "grads": kept,
            "p1": flat(state.params), "m": flat(state.opt.m),
            "v": flat(state.opt.v)}


def jax_reference(jcfg, params_j, batch) -> dict:
    """JAX's loss and gradients op by op, the mean over the reference's
    global microbatches (consecutive rows), and its ``adamw_update``."""
    jmodel = jax_build_model(jcfg)
    mu = jcfg.microbatches
    n = B // mu
    loss, grads = 0.0, None
    with jax.disable_jit():
        for i in range(mu):
            mb = {k: jnp.asarray(v[i * n:(i + 1) * n])
                  for k, v in batch.items()}
            l, g = jax.value_and_grad(jmodel.loss_fn)(params_j, mb)
            g = jax.tree.map(lambda t: t.astype(jnp.float32), g)
            loss = loss + float(l)
            grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    grads = jax.tree.map(lambda t: t / mu, grads)
    cfg = jax_adamw.AdamWConfig(**OPT)
    p1, state, metrics = jax_adamw.adamw_update(
        params_j, grads, jax_adamw.adamw_init(params_j, cfg), cfg)

    def flat(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(jnp.asarray(a, jnp.float32))
                for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {"loss": loss / mu, "grad_norm": float(metrics["grad_norm"]),
            "grads": flat(grads), "p1": flat(p1), "m": flat(state.m),
            "v": flat(state.v)}


def rel(got, want) -> float:
    num = float(np.linalg.norm((got - want).ravel()))
    den = float(np.linalg.norm(want.ravel()))
    return num / den if den else (0.0 if num == 0 else float("inf"))


@pytest.fixture(scope="module")
def runs():
    """Every mesh's ranks, spawned at once; while they run, the port's
    unsharded references and the JAX references. -> (cases by name,
    port references, JAX references, results by mesh)."""
    cases, weights = {}, {}
    names = sorted({n for mesh in MESHES for n in cases_of(mesh)})
    for name in names:
        sp = spec(name)
        jcfg, cfg = configs(sp)
        key = (sp["arch"], tuple(sorted(sp["changes"].items())))
        if key not in weights:
            seed = ARCHS.index(sp["arch"])
            weights[key] = fan_in(jax_init_params(
                jax_build_model(jcfg).param_decls(), jax.random.key(seed)),
                cfg)
        params_j = weights[key]
        if sp["dtype"] == "float32":
            params_j = jax.tree.map(lambda a: a.astype(jnp.float32),
                                    params_j)
        cases[name] = {"run": torch_serve_worker.train_case, "cfg": cfg,
                       "jcfg": jcfg, "params_j": params_j,
                       "params": params_from_numpy(
                           jax.tree.map(np.asarray, params_j), "cpu"),
                       "batch": batch_of(ARCHS.index(sp["arch"]),
                                         sp["mask"]),
                       "opt": OPT, "zero1": sp["zero1"],
                       "fault": sp.get("fault")}
    ctx = multiprocessing.get_context("spawn")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:

        def spawn(data, model):
            queue = ctx.Queue()
            init = os.path.join(tmp, f"init-{data}x{model}")
            mine = {n: {k: v for k, v in cases[n].items()
                        if k not in ("jcfg", "params_j")}
                    for n in cases_of((data, model))}
            procs = [ctx.Process(target=torch_serve_worker.run_rank,
                                 args=(r, data, model, init, mine, queue))
                     for r in range(data * model)]
            for p in procs:
                p.start()
            return queue, procs

        def join(mesh, queue, procs):
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

        # four ranks at a time, the first wave beside the references
        waves = [[(2, 2)], [(1, 4)], [(1, 2), (2, 1)]]
        running = {mesh: spawn(*mesh) for mesh in waves[0]}
        refs = {n: port_reference(c["cfg"], c["params"], c["batch"])
                for n, c in cases.items()
                if not n.startswith("fault:") or n == "fault:0"}
        jrefs = {n: jax_reference(cases[n]["jcfg"], cases[n]["params_j"],
                                  cases[n]["batch"]) for n in JAX_CASES}
        for wave in waves[1:] + [[]]:
            for mesh, (queue, procs) in running.items():
                join(mesh, queue, procs)
            running = {mesh: spawn(*mesh) for mesh in wave}
    return cases, refs, jrefs, results


def group(runs, mesh) -> dict:
    results = runs[3][mesh]
    assert results is not None, f"a rank of {mesh} hung or died"
    failed = {r: out for r, out in results.items() if isinstance(out, str)}
    assert not failed, failed
    assert sorted(results) == list(range(mesh[0] * mesh[1]))
    return results


def regions(cfg, mesh, coords, zero1):
    """This rank's slices of each leaf: (parameter region, moment region)
    by path."""
    rank = Mesh(mesh, ("data", "model"), coords=coords)
    model = build_model(cfg)
    specs = train_lib.make_train_state_specs(model, rank, zero1=zero1)
    return {"/".join(p): (local_slices(tree_at(specs.params, p), d.shape,
                                       rank),
                          local_slices(tree_at(specs.opt.m, p), d.shape,
                                       rank))
            for p, d in tree_items(model.param_decls())}


def broken_rules(out: dict, ref: dict, cfg, mesh, zero1: bool,
                 dtype: str, tol: float | None = None) -> list:
    """The rules (module docstring) a rank's ``out`` breaks against the
    reference ``ref`` (the unsharded step's or JAX's): (rule, detail)
    pairs. ``tol``: the gradients' tolerance, ``GRAD_TOL``'s by
    default."""
    tol = tol or GRAD_TOL[dtype]
    loose = 2 ** -5 if dtype == "float32" else tol
    broken = []
    loss_tol, gn_tol = (1e-5, 1e-3) if dtype == "float32" else (1e-3, 1e-2)
    ties = admitted = 0
    floor = SMOKE.update_floor(AdamWConfig(**OPT), ref["grad_norm"])
    if abs(out["loss"] - ref["loss"]) > loss_tol * abs(ref["loss"]):
        broken.append(("loss", out["loss"], ref["loss"]))
    if abs(out["grad_norm"] - ref["grad_norm"]) > gn_tol * ref["grad_norm"]:
        broken.append(("grad_norm", out["grad_norm"], ref["grad_norm"]))
    for path, (preg, mreg) in regions(cfg, mesh, out["coords"],
                                      zero1).items():
        leaf_tol = loose if path in BF16_ROUNDED else tol
        g, want_g = out["grads"][path], ref["grads"][path][preg]
        if rel(g, want_g) > leaf_tol:
            broken.append(("gradient", path, rel(g, want_g)))
        upd = out["p1"][path] - out["p0"][path]
        want_upd = ref["p1"][path][preg] - out["p0"][path]
        err, n, ok = SMOKE.update_rule(torch, *(torch.as_tensor(a) for a in (
            upd, want_upd, g, want_g)), floor)
        ties, admitted = ties + n, admitted + ok
        if err > SMOKE.TRAIN_GRAD_TOL:
            broken.append(("update", path, err))
        for name, t in (("m", leaf_tol + gn_tol),
                        ("v", 2 * (leaf_tol + gn_tol))):
            if rel(out[name][path], ref[name][path][mreg]) > t:
                broken.append((name, path,
                               rel(out[name][path], ref[name][path][mreg])))
    if ties > admitted:
        broken.append(("update ties", ties, admitted))
    return broken


def _ids(meshes):
    return [f"{m[0]}x{m[1]}" for m in meshes]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
def test_each_rank_matches_the_unsharded_step(runs, mesh, dtype, arch):
    """bf16, one microbatch, no mask, ZeRO-1 off; fp32, 2 microbatches, a
    mask, ZeRO-1 on: every rank's loss, norm, gradient, parameter and
    moment shards against the unsharded step, and its all_reduce calls
    against ``train_collectives``."""
    name = f"{arch}/{dtype}"
    case, ref = runs[0][name], runs[1][name]
    for rank, out in group(runs, mesh).items():
        got = out[name]
        assert broken_rules(got, ref, case["cfg"], mesh, case["zero1"],
                            spec(name)["dtype"]) == [], rank
        assert got["collectives"] == SMOKE.train_collectives(
            case["cfg"], mesh, case["zero1"]), rank


@pytest.mark.parametrize("name", ["tinyllama-1.1b/dp_only",
                                  "qwen3-14b/pad6"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=_ids([(1, 2),
                                                             (2, 2)]))
def test_dp_only_and_padded_heads_match_the_unsharded_step(runs, mesh,
                                                            name):
    """``dp_only``: every parameter whole on every rank, the batch over
    (data, model), ZeRO-1 cutting the moments over both; qwen3's padded
    heads (rank 1 of the model axis holds heads 4 and 5): their ``wq``
    and ``wo`` rows get zero gradient on that rank."""
    case, ref = runs[0][name], runs[1][name]
    cfg = case["cfg"]
    for rank, out in group(runs, mesh).items():
        got = out[name]
        assert broken_rules(got, ref, cfg, mesh, case["zero1"],
                            "bfloat16") == [], rank
        assert got["collectives"] == SMOKE.train_collectives(
            cfg, mesh, case["zero1"]), rank
        if cfg.dp_only:
            assert got["grads"]["embed"].shape == (cfg.vocab, cfg.d_model)
        else:
            m = got["coords"]["model"]
            heads = range(3 * m, 3 * m + 3)
            padded = [i for i, h in enumerate(heads) if h >= cfg.n_heads]
            assert padded == ([] if m == 0 else [1, 2])
            wq, wo = got["grads"]["layers/attn/wq"], \
                got["grads"]["layers/attn/wo"]
            assert not wq[:, :, padded].any() and not wo[:, padded].any()
            assert wq[:, :, [i for i in range(3) if i not in padded]].any()


def test_padded_heads_at_two_by_one(runs):
    """At (2, 1) one model rank holds all 6 heads, 2 of them padded."""
    name = "qwen3-14b/pad6"
    case, ref = runs[0][name], runs[1][name]
    for rank, out in group(runs, (2, 1)).items():
        got = out[name]
        assert broken_rules(got, ref, case["cfg"], (2, 1), case["zero1"],
                            "bfloat16") == [], rank
        assert not got["grads"]["layers/attn/wq"][:, :, 4:].any()


@pytest.mark.parametrize("mesh,name", [
    (mesh, name) for name in JAX_CASES for mesh in MESHES
    if name in cases_of(mesh)], ids=lambda v: v if isinstance(v, str)
    else f"{v[0]}x{v[1]}")
def test_each_rank_matches_jax(runs, mesh, name):
    """tinyllama (bf16, and fp32 with 2 microbatches, a mask and ZeRO-1)
    and qwen3-14b (padded heads, 2 microbatches, a mask) against
    ``jax.value_and_grad`` op by op, the mean over the global
    microbatches, and JAX's ``adamw_update``, by the same rules as
    against the unsharded step but an fp32 gradient within 1e-3 of its
    norm (``JAX_GRAD_TOL``)."""
    case = runs[0][name]
    dtype = spec(name)["dtype"]
    for rank, out in group(runs, mesh).items():
        assert broken_rules(out[name], runs[2][name], case["cfg"], mesh,
                            case["zero1"], dtype, JAX_GRAD_TOL[dtype]) == [], \
            rank


@pytest.mark.parametrize("i", range(len(SMOKE.TRAIN_FAULTS)))
def test_each_planted_fault_breaks_a_rule_on_every_rank(runs, i):
    """``chip_smoke.py``'s planted faults, each at its mesh: (i) and (ii)
    at (1, 2), (iii) and (iv) at (2, 2) with ZeRO-1."""
    fault = SMOKE.TRAIN_FAULTS[i]
    mesh = next(m for m, fs in SMOKE.TRAIN_FAULTS_AT.items() if fault in fs)
    name = f"fault:{i}"
    case = runs[0][name]
    ref = runs[1]["fault:0"]           # the same model, weights and batch
    for rank, out in group(runs, mesh).items():
        assert broken_rules(out[name], ref, case["cfg"], mesh,
                            case["zero1"], "bfloat16"), (fault, rank)

