"""Sharded training of the vlm, MoE and SSM families
(``runtime/train_lib.py``'s ``build_train_step(..., mesh=)``) on the CPU,
against the port's unsharded step and against JAX. The dense family's
file, ``tests/test_torch_train_sharded.py``, holds the rules this file
applies (``broken_rules``) and the worker both use
(``torch_serve_worker``: one spawned rank a process, a gloo group a mesh,
four ranks at a time, each group joined with a timeout, so a hung rank
fails the test).

The cases, on weights carried from JAX ``init_params`` through numpy, the
attention at std 1/sqrt(fan-in) (the dense file's ``fan_in``), batch 8 x
32 tokens: reduced qwen2-vl-72b (4 layers, 4 heads over 2 KV heads,
M-RoPE; each row's 8 patch embeddings spliced in front of its tokens and
its 3-D positions in Qwen2-VL's layout, one grid of patches a row, the
grids and text starts differing between rows), qwen3-moe-235b-a22b (8
experts top-2, qk-norm), kimi-k2-1t-a32b (8 experts top-2 and a shared
expert) and mamba2-370m (8 SSM heads, a tied head), each at (1, 2), (2,
2), (1, 4) and (2, 1): in bf16 with one microbatch (the MoE archs two),
no mask and ZeRO-1 off, and in fp32 with two microbatches, a mask and
ZeRO-1 on; qwen3-moe at capacity factor 0.5 at (2, 2); and the six
planted faults of ``chip_smoke.FAMILY_TRAIN_FAULTS``, the same code as on
the card.

Each rank is held to the port's unsharded step on the whole batch. For
an MoE that step dispatches each (microbatch, data shard) group of rows
alone, as the reference's ``shard_map`` does over the data axes (its
capacity from the group's tokens), and takes its aux loss over the whole
global microbatch (``grouped_experts``); at a data axis of 1 a group is
the microbatch and that step is the plain one. Each MoE rank is fed the
reference step's top-k experts at its rows (``microbatch_routes``), its
gates and aux loss its own: in bf16 the row-parallel sums round apart
from the unsharded ones, and a choice at a near-tie would then move a
token by a whole expert's output (ROADMAP C.2). A few cases are also held
to ``jax.value_and_grad(model.loss_fn)`` op by op, averaged over the
reference's global microbatches, and JAX's ``adamw_update``: qwen2-vl in
fp32 at every mesh and qwen3-moe in fp32 at the data axis of 1 (JAX's MoE,
its ``shard_map`` the identity, dispatches the whole microbatch as one
group; its own routing equals the fed one there). The JAX references run
op by op in a thread of their own while the ranks run (each takes ~50 s
alone).

Tolerances are the dense file's, and why: fp32 loss rel 1e-5, each
gradient shard within 1e-4 of its slice's norm (``embed`` and
``layers/ln1``, behind the bf16 embedding output, 2^-5), norm rel 1e-3;
bf16 loss rel 1e-3, norm rel 1e-2, gradients 3e-2 (``TRAIN_GRAD_TOL``, the
card's rule); updates by ``chip_smoke.update_rule``; moments within the
gradient's tolerance plus the norm's. Two departures, for mamba2 alone:
its fp32 case is held to the bf16 rules, since its residual stream is
bf16 in both paths (the embedding's bf16 output, and each Mamba block's
output cast to its input's dtype), so a bf16 rounding of the row-parallel
``out_proj`` sum reaches every leaf (measured 3e-3 to 1.3e-2 of a leaf's
norm at (1, 2) and (1, 4)); and its one-number-a-head leaves (``A_log``,
``dt_bias``, ``D``) are held, gradient and moments, against the whole
leaf's norm (``HEAD_LEAVES``): a rank's heads can be the fastest-decaying
(A = -7 and -8 at (1, 4)), whose ``A_log`` gradients are two orders under
the leaf's largest, while those roundings are alike in size on every head
(measured 4.3e-2 of that rank's slice, 6e-7 absolute). The all_reduce
calls of each step equal ``chip_smoke.train_collectives``. Each planted
fault breaks a rule on every rank of its run.
"""

import concurrent.futures
import contextlib
import dataclasses
import importlib
import multiprocessing
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim.adamw as jax_adamw
import test_torch_train_sharded as dense
import torch_serve_worker
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.moe import _capacity
from repro_torch.runtime import train_lib

SMOKE = torch_serve_worker.chip_smoke()
ARCHS = ["qwen2-vl-72b", "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
         "mamba2-370m"]
MOE = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b")
MESHES = [(1, 2), (2, 2), (1, 4), (2, 1)]
B, S, NV = 8, 32, 8
OPT = dense.OPT
JOIN_S = 300
CAPACITY = "qwen3-moe-235b-a22b/cf0.5"
# each planted fault: the case whose model, weights and batch it runs, and
# its mesh (the aux loss's needs a data axis of 2; the positions' two
# microbatches, so that a rank's rows are not the whole batch)
FAULT_AT = {SMOKE.MOE_TRAIN_FAULTS[0]: ("qwen3-moe-235b-a22b/bf16", (1, 2)),
            SMOKE.MOE_TRAIN_FAULTS[1]: ("qwen3-moe-235b-a22b/fp32", (2, 2)),
            SMOKE.MOE_TRAIN_FAULTS[2]: ("qwen3-moe-235b-a22b/bf16", (1, 2)),
            SMOKE.SSM_TRAIN_FAULTS[0]: ("mamba2-370m/bf16", (1, 2)),
            SMOKE.SSM_TRAIN_FAULTS[1]: ("mamba2-370m/bf16", (1, 2)),
            SMOKE.VLM_TRAIN_FAULTS[0]: ("qwen2-vl-72b/fp32", (1, 2))}
FAULTS = SMOKE.FAMILY_TRAIN_FAULTS
JAX_AT = {"qwen2-vl-72b/fp32": MESHES,
          "qwen3-moe-235b-a22b/fp32": [(1, 2), (1, 4)]}


# leaves of one number a head and layer, held against the whole leaf's
# norm (module docstring)
HEAD_LEAVES = ("layers/mamba/A_log", "layers/mamba/dt_bias",
               "layers/mamba/D")


def spec(name: str) -> dict:
    """A case's arch, dtype, microbatches, mask, ZeRO-1 and config
    changes, from its name: "<arch>/bf16", "<arch>/fp32", ``CAPACITY`` or
    "fault:<i>" (``FAULTS[i]`` on its case of ``FAULT_AT``)."""
    if name.startswith("fault:"):
        fault = FAULTS[int(name.split(":")[1])]
        return dict(spec(FAULT_AT[fault][0]), fault=fault)
    if name == CAPACITY:
        return dict(arch=MOE[0], dtype="float32", mu=2, mask=False,
                    zero1=False, changes={"capacity_factor": 0.5})
    arch, kind = name.split("/")
    if kind == "bf16":
        return dict(arch=arch, dtype="bfloat16", mu=2 if arch in MOE else 1,
                    mask=False, zero1=False, changes={})
    return dict(arch=arch, dtype="float32", mu=2, mask=True, zero1=True,
                changes={})


def base(name: str) -> str:
    """The case whose reference a case is held to."""
    if name.startswith("fault:"):
        return FAULT_AT[FAULTS[int(name.split(":")[1])]][0]
    return name


def cases_of(mesh) -> list:
    names = [f"{a}/{k}" for a in ARCHS for k in ("bf16", "fp32")]
    if mesh == (2, 2):
        names.append(CAPACITY)
    return names + [f"fault:{i}" for i, f in enumerate(FAULTS)
                    if FAULT_AT[f][1] == mesh] + [f"loop:{a}" for a in ARCHS]


def rules_dtype(name: str) -> str:
    """The rules a case is held to: its dtype's, but bf16's for mamba2's
    fp32 case (its residual stream is bf16, module docstring)."""
    sp = spec(name)
    return "bfloat16" if sp["arch"] == "mamba2-370m" else sp["dtype"]


def configs(sp: dict):
    jcfg = dataclasses.replace(jax_get_config(sp["arch"], reduced=True),
                               microbatches=sp["mu"], **sp["changes"])
    cfg = dataclasses.replace(get_config(sp["arch"], reduced=True),
                              microbatches=sp["mu"], **sp["changes"])
    return jcfg, cfg


def positions() -> np.ndarray:
    """(3, B, S) int32 M-RoPE positions in Qwen2-VL's layout: a grid of NV
    patches a row at (0, r, c) (2 x 4 or 4 x 2, alternating), then text
    from max(h, w) plus the row's index, advancing in all three streams."""
    out = []
    for b in range(B):
        gh, gw = ((2, 4), (4, 2))[b % 2]
        r, c = np.divmod(np.arange(gh * gw), gw)
        text = max(gh, gw) + b + np.arange(S - gh * gw)
        out.append([np.concatenate([np.zeros(gh * gw, int), text]),
                    np.concatenate([r, text]), np.concatenate([c, text])])
    return np.asarray(out, np.int32).transpose(1, 0, 2)


def batch_of(sp: dict) -> dict:
    """The dense file's batch (8 x 33 tokens, its mask) and, for the vlm,
    8 fp32 patch embeddings a row and the positions."""
    batch = dense.batch_of(ARCHS.index(sp["arch"]), sp["mask"])
    if sp["arch"] == "qwen2-vl-72b":
        rng = np.random.default_rng(7)
        batch["vision_embeds"] = rng.normal(size=(B, NV, 64)).astype(
            np.float32)
        batch["mrope_positions"] = positions()
    return batch


@contextlib.contextmanager
def grouped_experts(n_data: int):
    """Context: the port's MoE layer dispatches each of ``n_data`` groups of
    its call's sequences alone (the reference's per-data-shard dispatch
    over a global microbatch), its routing and aux loss over them all."""
    moe_mod = importlib.import_module("repro_torch.models.moe")
    local = moe_mod._moe_local

    def grouped(x, topi, gates, *weights, cfg, shard=None):
        k = cfg.top_k
        parts = zip(x.chunk(n_data), topi.reshape(x.shape[0], -1, k)
                    .chunk(n_data), gates.reshape(x.shape[0], -1, k)
                    .chunk(n_data))
        return torch.cat([local(xg, tg.reshape(-1, k), gg.reshape(-1, k),
                                *weights, cfg=cfg)
                          for xg, tg, gg in parts])
    moe_mod._moe_local = grouped
    try:
        yield
    finally:
        moe_mod._moe_local = local


def port_reference(cfg, params_t, batch, n_data: int) -> dict:
    """The unsharded step (``dense.port_reference``), an MoE's groups of
    ``n_data`` (``grouped_experts``); with its top-k experts recorded for
    each microbatch and layer (``routes``)."""
    routes = []
    moe = cfg.family == "moe"
    with grouped_experts(n_data) if moe else contextlib.nullcontext(), \
            torch_serve_worker.microbatch_routes(record=routes) if moe \
            else contextlib.nullcontext():
        ref = dense.port_reference(cfg, params_t, batch)
    ref["routes"] = routes
    return ref


def jax_reference(jcfg, params_j, batch) -> dict:
    """JAX's loss and gradients op by op, the mean over the reference's
    global microbatches (consecutive rows; the positions cut on axis 1, as
    the reference's reshape cuts them), and its ``adamw_update``, as
    ``dense.jax_reference``; the reference's MoE layer on one device, its
    ``shard_map`` the identity (its own mesh step fails on this jax;
    ROADMAP §C)."""
    jmodel = jax_build_model(jcfg)
    mu = jcfg.microbatches
    loss, grads = 0.0, None
    jax_moe_mod = importlib.import_module("repro.models.moe")
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jax_moe_mod, "shard_map", lambda f, **_: f)
        mp.setattr(jax_moe_mod, "model_axis", lambda mesh=None: None)
        for i in range(mu):
            rows = train_lib.group_rows(B, mu, 1, 0, i)
            mb = {k: jnp.asarray(v) for k, v in train_lib.take_rows(
                batch, rows).items()}
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


@pytest.fixture(scope="module")
def runs():
    """Every mesh's ranks, spawned four at a time; while the first wave
    runs, the port's unsharded references and the JAX references. ->
    (cases by name, port references by (name, data axis), JAX references,
    results by mesh)."""
    cases, weights = {}, {}
    names = sorted({n for mesh in MESHES for n in cases_of(mesh)
                    if not n.startswith("loop:")})
    for name in names:
        sp = spec(name)
        jcfg, cfg = configs(sp)
        if sp["arch"] not in weights:
            seed = ARCHS.index(sp["arch"])
            params_j = jax_init_params(jax_build_model(jcfg).param_decls(),
                                       jax.random.key(seed))
            weights[sp["arch"]] = dense.fan_in(params_j, cfg) \
                if "attn" in params_j["layers"] else params_j
        params_j = weights[sp["arch"]]
        if sp["dtype"] == "float32":
            params_j = jax.tree.map(lambda a: a.astype(jnp.float32),
                                    params_j)
        cases[name] = {"run": torch_serve_worker.train_case, "cfg": cfg,
                       "jcfg": jcfg, "params_j": params_j,
                       "params": params_from_numpy(
                           jax.tree.map(np.asarray, params_j), "cpu"),
                       "batch": batch_of(sp), "opt": OPT,
                       "zero1": sp["zero1"], "fault": sp.get("fault")}
    # the MoE references first: the ranks take their routing
    refs = {}
    for name in names:
        if name.startswith("fault:"):
            continue
        c = cases[name]
        for n_data in ((1, 2) if c["cfg"].family == "moe" else (1,)):
            refs[name, n_data] = port_reference(c["cfg"], c["params"],
                                                c["batch"], n_data)
    for name in names:
        if cases[name]["cfg"].family == "moe":
            cases[name]["routes"] = {n: refs[base(name), n]["routes"]
                                     for n in (1, 2)}
    # train_loop over each mesh, and on one device (an MoE's dispatched in
    # the groups of each data axis, its routing recorded for the ranks)
    for arch in ARCHS:
        loop = cases[f"loop:{arch}"] = {
            "run": torch_serve_worker.train_loop_case, "arch": arch, "mu": 2}
        for n_data in ((1, 2) if arch in MOE else (1,)):
            routes = []
            with grouped_experts(n_data) if arch in MOE \
                    else contextlib.nullcontext(), \
                    torch_serve_worker.microbatch_routes(record=routes) \
                    if arch in MOE else contextlib.nullcontext():
                refs[f"loop:{arch}", n_data] = train_lib_loop(arch)
            if arch in MOE:
                loop.setdefault("routes", {})[n_data] = routes
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

        waves = [[(2, 2)], [(1, 4)], [(1, 2), (2, 1)]]
        running = {mesh: spawn(*mesh) for mesh in waves[0]}
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            jax_future = pool.submit(lambda: {
                n: jax_reference(cases[n]["jcfg"], cases[n]["params_j"],
                                 cases[n]["batch"]) for n in JAX_AT})
            try:
                for wave in waves[1:] + [[]]:
                    for mesh, (queue, procs) in running.items():
                        join(mesh, queue, procs)
                    running = {mesh: spawn(*mesh) for mesh in wave}
            finally:
                # a wave that raised leaves no rank behind
                for _, procs in running.values():
                    for p in procs:
                        p.kill()
            jrefs = jax_future.result()
    return cases, refs, jrefs, results


def broken_rules(out: dict, ref: dict, cfg, mesh, zero1: bool, dtype: str,
                 tol: float | None = None) -> list:
    """``dense.broken_rules``, with the gradient and moment shards of each
    of ``HEAD_LEAVES`` held against the whole leaf's norm in place of
    their slice's: the rules ``out`` breaks, (rule, detail) pairs."""
    whole = [p for p in HEAD_LEAVES if p in out["grads"]]
    broken = [b for b in dense.broken_rules(out, ref, cfg, mesh, zero1,
                                            dtype, tol)
              if not (b[0] in ("gradient", "m", "v") and b[1] in whole)]
    tol = tol or dense.GRAD_TOL[dtype]
    gn_tol = 1e-3 if dtype == "float32" else 1e-2
    slices = dense.regions(cfg, mesh, out["coords"], zero1)
    for path in whole:
        preg, mreg = slices[path]
        for rule, key, region, t in (("gradient", "grads", preg, tol),
                                     ("m", "m", mreg, tol + gn_tol),
                                     ("v", "v", mreg, 2 * (tol + gn_tol))):
            want = ref[key][path]
            err = float(np.linalg.norm((out[key][path] - want[region])
                                       .ravel())) \
                / float(np.linalg.norm(want.ravel()))
            if err > t:
                broken.append((rule, path, err))
    return broken


def train_lib_loop(arch: str) -> dict:
    """``train_loop`` of ``arch`` on one device, as ``train_loop_case``
    runs it on each rank."""
    from repro_torch.launch.train import train_loop
    return train_loop(arch, reduced=True, device="cpu", steps=2, batch=8,
                      seq=16, microbatches=2, log_every=0)


def ref_of(runs, name: str, mesh) -> dict:
    """The port reference a case is held to at ``mesh``: an MoE's for the
    mesh's data axis."""
    moe = runs[0][name]["cfg"].family == "moe"
    return runs[1][base(name), mesh[0] if moe else 1]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("mesh", MESHES, ids=dense._ids(MESHES))
def test_each_rank_matches_the_unsharded_step(runs, mesh, dtype, arch):
    """Every rank's loss, norm, gradient, parameter and moment shards
    against the unsharded step (an MoE's groups of the mesh's data axis),
    and its all_reduce calls against ``train_collectives``."""
    name = f"{arch}/{dtype}"
    case = runs[0][name]
    ref = ref_of(runs, name, mesh)
    for rank, out in dense.group(runs, mesh).items():
        got = out[name]
        assert broken_rules(got, ref, case["cfg"], mesh, case["zero1"],
                            rules_dtype(name)) == [], \
            rank
        assert got["collectives"] == SMOKE.train_collectives(
            case["cfg"], mesh, case["zero1"]), rank


@pytest.mark.parametrize("mesh,name", [
    (mesh, name) for name, meshes in JAX_AT.items() for mesh in meshes],
    ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_each_rank_matches_jax(runs, mesh, name):
    """qwen2-vl (fp32: vision embeddings, M-RoPE positions, two
    microbatches, a mask, ZeRO-1) and qwen3-moe (fp32 at a data axis of 1)
    against ``jax.value_and_grad`` op by op and JAX's
    ``adamw_update``, by the same rules as against the unsharded step but
    an fp32 gradient within 1e-3 of its norm (``dense.JAX_GRAD_TOL``)."""
    case = runs[0][name]
    dtype = rules_dtype(name)
    for rank, out in dense.group(runs, mesh).items():
        assert broken_rules(out[name], runs[2][name], case["cfg"],
                                  mesh, case["zero1"], dtype,
                                  dense.JAX_GRAD_TOL[dtype]) == [], rank


def test_capacity_case_tells_the_group_capacity_apart(runs):
    """At capacity factor 0.5 a (microbatch, data shard) group's capacity
    (8 a local expert over its 2 x 32 tokens) is not the whole
    microbatch's (16): every rank at (2, 2) matches the unsharded step
    that dispatches the groups alone and breaks the rules against the one
    that dispatches each microbatch whole."""
    cfg = runs[0][CAPACITY]["cfg"]
    group = B // (cfg.microbatches * 2) * S
    assert _capacity(group, cfg.top_k, cfg.n_experts,
                     cfg.capacity_factor) == 8
    assert _capacity(2 * group, cfg.top_k, cfg.n_experts,
                     cfg.capacity_factor) == 16
    for rank, out in dense.group(runs, (2, 2)).items():
        got = out[CAPACITY]
        assert broken_rules(got, runs[1][CAPACITY, 2], cfg, (2, 2), False,
                            "float32") == [], rank
        assert broken_rules(got, runs[1][CAPACITY, 1], cfg, (2, 2), False,
                            "float32"), rank


@pytest.mark.parametrize("i", range(len(FAULTS)), ids=[
    f.split(" ")[0] + f"-{i}" for i, f in enumerate(FAULTS)])
def test_each_planted_fault_breaks_a_rule_on_every_rank(runs, i):
    """``chip_smoke.py``'s planted faults of the families, each on its
    case and mesh (``FAULT_AT``): the MoE's gates or tokens without their
    model-axis sum and its aux loss over a rank's rows, the Mamba norm's
    identity backward and ``w_B``/``w_C`` left out of the partial leaves,
    and the positions cut on their first axis."""
    fault = FAULTS[i]
    name, mesh = f"fault:{i}", FAULT_AT[fault][1]
    case = runs[0][name]
    ref = ref_of(runs, name, mesh)
    for rank, out in dense.group(runs, mesh).items():
        assert broken_rules(out[name], ref, case["cfg"], mesh,
                            case["zero1"], rules_dtype(name)), (fault, rank)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=dense._ids(MESHES))
def test_train_loop_trains_each_family_over_the_mesh(runs, mesh, arch):
    """``train_loop(..., data=, model=)`` from every rank: the same losses
    on every rank (the global batch's), finite, the first within bf16's
    loss rule (1e-3) of ``train_loop`` on one device (an MoE's dispatched in
    the data axis's groups, its ranks fed that run's experts, as the other
    MoE cases are). The second is not held to it: Adam's first step moves
    each weight by ~lr whatever its gradient's size, so a gradient near 0
    that the bf16 roundings part moves its weight the other way (kimi-k2
    at (1, 4) reads 1.5% apart there; the other cases hold each leaf's
    update by ``update_rule``)."""
    n_data = mesh[0] if arch in MOE else 1
    want = runs[1][f"loop:{arch}", n_data]["losses"]
    losses = [out[f"loop:{arch}"]["losses"]
              for _, out in sorted(dense.group(runs, mesh).items())]
    assert all(got == losses[0] for got in losses), losses
    got = losses[0]
    assert len(got) == 2 and all(np.isfinite(got)), got
    assert abs(got[0] - want[0]) <= 1e-3 * abs(want[0]), (got, want)


def test_moe_leaves_and_mamba_leaves_whose_gradient_is_a_part():
    """From the specs: a Mamba block's ``w_B``, ``w_C``, ``conv_B`` and
    ``conv_C`` (whole on every rank, read by each rank's heads) and
    qwen3-moe's qk-norm, not its router (routing runs whole on every rank,
    outside the experts' region) nor its experts (cut)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime.serve_lib import shard_layout

    def partial(arch):
        model = build_model(get_config(arch, reduced=True))
        layout = shard_layout(model, Mesh((1, 2), ("data", "model")), B)
        return {"/".join(p) for p in
                train_lib.model_partial_leaves(model, layout)}
    assert partial("mamba2-370m") == {f"layers/mamba/{n}" for n in (
        "w_B", "w_C", "conv_B", "conv_C")}
    assert partial("qwen3-moe-235b-a22b") == {"layers/attn/q_norm",
                                              "layers/attn/k_norm"}
    assert partial("kimi-k2-1t-a32b") == set()


@pytest.mark.parametrize("mesh,rows", [
    ((1, 2), [[0, 1, 2, 3], [4, 5, 6, 7]]),
    ((2, 2), [[0, 1], [4, 5], [2, 3], [6, 7]])])
def test_group_rows_cut_each_global_microbatch(mesh, rows):
    """At B = 8 and two microbatches, data rank d's microbatch i holds rows
    4 i + d 4 / n_data ..., as the reference's ``shard_map`` cuts each
    global microbatch (data rank 0's first, then data rank 1's)."""
    n_data = mesh[0]
    got = [list(range(8))[train_lib.group_rows(8, 2, n_data, d, i)]
           for d in range(n_data) for i in range(2)]
    assert got == rows


def test_take_rows_cuts_positions_on_their_batch_axis():
    batch = {"tokens": torch.arange(8 * 3).reshape(8, 3),
             "mrope_positions": torch.as_tensor(positions()),
             "vision_embeds": torch.zeros(8, NV, 4)}
    out = train_lib.take_rows(batch, slice(2, 4))
    assert torch.equal(out["tokens"], batch["tokens"][2:4])
    assert torch.equal(out["mrope_positions"],
                       batch["mrope_positions"][:, 2:4])
    assert out["vision_embeds"].shape == (2, NV, 4)

