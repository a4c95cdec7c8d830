"""ZeRO-3 in the port's sharded train and serve steps on the CPU, in gloo
groups of spawned ranks (``torch_serve_worker``: one process a rank, each
group joined with a timeout, so a hung rank fails the test): a (2, 2)
group of four ranks and a (2, 1) group of two, and beside them (1, 2)
groups for the checkpoints.

Under ``make_train_state_specs(model, mesh, zero3=True)`` a rank holds its
region of each leaf (its slice of the leaf's model-axis shard, cut over
the data axes on the axis the reference's ZeRO-3 pass picks), gathers each
unit's leaves to their model-axis shards just before the unit runs, and
the gathers' backward sums the gradients over the data axes into its
regions (``sharding/layout.py``). The gathered tensors are the shards the
ZeRO-1 step holds, bit for bit, so each ZeRO-3 step is held to the same
mesh's ZeRO-1 step (which ``tests/test_torch_train_sharded*.py`` hold to
the unsharded step and to JAX) on the same weights and batch:

* the loss bit for bit;
* each gradient region bit for bit, but where the order of its sums
  changes (``named_leaves``), held within ``NAMED_TOL`` (2^-20, ~1e-6) of
  its norm (measured up to 6.8e-8): the leaves whose gradient is a part on
  the model axis (``train_lib.model_partial_leaves``: ZeRO-1 sums them
  over the model axis first, ZeRO-3's gathers over the data axes first),
  every leaf at two microbatches (ZeRO-1 adds the microbatches before the
  data axes' sum, ZeRO-3 after), and a tied embedding (mamba2's: its two
  uses, the lookup and the head, each gathered, their gradients summed in
  fp32 where ZeRO-1's autograd sums them in the leaf's dtype: in bf16 held
  within ``TIED_BF16_TOL``, 2^-8, one bf16 rounding of the sum; measured
  1.7e-3);
* the global norm rel 1e-4 (its squares summed in another order, and the
  tied bf16 embedding's rounding; measured up to 6.5e-5), the update by
  ``chip_smoke.update_rule`` and the moments within the update rule's
  3e-2 plus the norm's tolerance;
* the all_reduce calls equal ``chip_smoke.train_collectives(...,
  zero3=True)``, the calls that the card's kernels carry equal the ZeRO-1
  step's (``chip_smoke.train_kernels``), and the state a rank holds is
  the ZeRO-3 specs' local shapes, byte for byte.

The cases: reduced tinyllama-1.1b, qwen2-vl-72b (8 vision embeddings a
row, M-RoPE positions), qwen3-moe-235b-a22b and jamba-1.5-large-398b (each
rank fed the unsharded step's top-k experts at its rows,
``torch_serve_worker.fed_routes``, as the other sharded files do; the
ZeRO-1 and ZeRO-3 steps' own routing would agree all the same, their
forwards being one), mamba2-370m and seamless-m4t-large-v2 (16 frames a
row) at (2, 2) and (2, 1), in bf16 with one microbatch and no mask and in
fp32 (every weight cast) with two microbatches and a mask. One fp32 dense
case at (2, 2) is also held to ``jax.value_and_grad(model.loss_fn)`` and
``adamw_update`` op by op, as ``tests/test_torch_train_sharded.py`` holds
its ZeRO-1 step. Each of ``chip_smoke.ZERO3_FAULTS`` (a gather without
its all_reduce, a backward that keeps the rank's unsummed gradient,
regions written at the other data rank's slices) must break a rule on
every rank.

Serving: every family's ZeRO-3 prefill and decode steps
(``build_prefill_step``/``build_decode_step(..., zero3=True)`` over the
regions of ``param_specs(..., zero3=True)``) give the same mesh's
non-ZeRO-3 steps' logits and caches bit for bit, with
``chip_smoke.shard_collectives(..., zero3=True)`` all_reduce calls a
decode step. Checkpoints: a ZeRO-3 state saved at (2, 2) restores at (1,
2) without ZeRO-3 and on one device, and a (1, 2) save restores into the
ZeRO-3 regions at (2, 2), each bit for bit.
"""

import dataclasses
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_sharded as dense
import test_torch_train_sharded_families as families
import test_torch_train_sharded_hybrid_encdec as hybrid_encdec
import torch_serve_worker
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.checkpoint import restore_state
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model, init_params, params_from_numpy
from repro_torch.models.param import tree_at, tree_items, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import serve_lib, train_lib
from repro_torch.sharding.rules import local_shape, local_slices

SMOKE = torch_serve_worker.chip_smoke()
DENSE, VLM, MOE = "tinyllama-1.1b", "qwen2-vl-72b", "qwen3-moe-235b-a22b"
SSM, HYBRID, ENCDEC = ("mamba2-370m", "jamba-1.5-large-398b",
                       "seamless-m4t-large-v2")
ARCHS = [DENSE, VLM, MOE, SSM, HYBRID, ENCDEC]
MESHES = [(2, 2), (2, 1)]
CKPT_ARCH = SSM
B, S = dense.B, dense.S
SERVE_B, PROMPT, TOKENS, MAX_LEN, FRAMES = 4, 16, 20, 36, 16
OPT = dense.OPT
JOIN_S = 300
NAMED_TOL = 2 ** -20
TIED_BF16_TOL = 2 ** -8
GN_TOL = 1e-4
FAULTS = SMOKE.ZERO3_FAULTS


def spec(name: str) -> dict:
    """A train case's arch, dtype, microbatches, mask and ZeRO-3 from its
    name, "<arch>/<bf16|fp32>/<z1|z3>" or "fault:<i>" (tinyllama's bf16
    ZeRO-3 step under ``FAULTS[i]``)."""
    if name.startswith("fault:"):
        return dict(spec(f"{DENSE}/bf16/z3"),
                    fault=FAULTS[int(name.split(":")[1])])
    arch, kind, z = name.split("/")
    return dict(arch=arch, dtype="bfloat16" if kind == "bf16" else "float32",
                mu=1 if kind == "bf16" else 2, mask=kind == "fp32",
                zero3=z == "z3")


def train_names() -> list:
    return [f"{a}/{k}/{z}" for a in ARCHS for k in ("bf16", "fp32")
            for z in ("z1", "z3")]


def config(sp: dict):
    return dataclasses.replace(get_config(sp["arch"], reduced=True),
                               microbatches=sp["mu"])


def weights(arch: str):
    """The reduced arch's weights, bf16 as drawn: tinyllama's from JAX's
    ``init_params`` at fan-in std, as ``tests/test_torch_train_sharded.py``
    draws them (the JAX case reads them), the others from the port's."""
    if arch == DENSE:
        jcfg = jax_get_config(arch, reduced=True)
        params_j = dense.fan_in(jax_init_params(
            jax_build_model(jcfg).param_decls(), jax.random.key(0)),
            get_config(arch, reduced=True))
        return params_j, params_from_numpy(jax.tree.map(np.asarray,
                                                        params_j), "cpu")
    model = build_model(get_config(arch, reduced=True))
    return None, init_params(model.param_decls(), torch.Generator()
                             .manual_seed(ARCHS.index(arch)), "cpu")


def batch_of(sp: dict) -> dict:
    """The sharded files' batch of the arch: 8 x 33 tokens (a mask in the
    fp32 cases), the vlm's vision embeddings and positions, the
    encoder-decoder's 16 frames a row."""
    if sp["arch"] == VLM:
        return families.batch_of(dict(sp, arch=VLM))
    if sp["arch"] == ENCDEC:
        return hybrid_encdec.batch_of(sp)
    return dense.batch_of(ARCHS.index(sp["arch"]), sp["mask"])


def _spawn(ctx, tmp, mesh, cases, tag: str = ""):
    queue = ctx.Queue()
    init = os.path.join(tmp, f"init-{mesh[0]}x{mesh[1]}{tag}")
    procs = [ctx.Process(target=torch_serve_worker.run_rank,
                         args=(r, mesh[0], mesh[1], init, cases, queue))
             for r in range(mesh[0] * mesh[1])]
    for p in procs:
        p.start()
    return queue, procs


def _join(queue, procs):
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The train, serve, fault and checkpoint cases of each mesh. First
    wave: (2, 2) with (1, 2)'s save beside it; second: (2, 1) with (1,
    2)'s restore of the (2, 2) ZeRO-3 save. The MoE archs' unsharded
    references (their top-k experts, fed to the ranks) run beside the
    first wave's start, and the JAX reference of the dense fp32 case
    while it runs. -> (cases by name, results by group, the JAX
    reference, the checkpoints' directories)."""
    tmp = tmp_path_factory.mktemp("zero3")
    drawn = {a: weights(a) for a in ARCHS}
    cases = {}
    for name in train_names() + [f"fault:{i}" for i in range(len(FAULTS))]:
        sp = spec(name)
        params = drawn[sp["arch"]][1]
        if sp["dtype"] == "float32":
            params = tree_map(lambda a: a.float(), params)
        cases[name] = {"run": torch_serve_worker.train_case,
                       "cfg": config(sp), "params": params,
                       "batch": batch_of(sp), "opt": OPT, "zero1": True,
                       "zero3": sp["zero3"], "fault": sp.get("fault")}
    routes = {}
    for name, case in cases.items():
        if case["cfg"].n_experts and not name.startswith("fault:"):
            key = name.rsplit("/", 1)[0]
            if key not in routes:
                routes[key] = hybrid_encdec.port_reference(
                    case["cfg"], case["params"], case["batch"], 2)["routes"]
            case["routes"] = {2: routes[key]}
    rng = np.random.default_rng(5)
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        cases[f"serve:{arch}"] = {
            "run": torch_serve_worker.zero3_serve_case, "cfg": cfg,
            "params": drawn[arch][1], "prompt": PROMPT, "max_len": MAX_LEN,
            "tokens": rng.integers(0, cfg.vocab, (SERVE_B, TOKENS)).astype(
                np.int32)}
        if arch == ENCDEC:
            cases[f"serve:{arch}"]["frames"] = rng.normal(size=(
                SERVE_B, FRAMES, cfg.d_model)).astype(np.float32)
    ckpt_cfg = dataclasses.replace(get_config(CKPT_ARCH, reduced=True),
                                   microbatches=1)
    ckpt = {"cfg": ckpt_cfg, "opt": OPT, "params": drawn[CKPT_ARCH][1],
            "batch": dense.batch_of(0, False)}
    dirs = {"z3": str(tmp / "saved-zero3"), "12": str(tmp / "saved-1x2")}
    first = dict(cases)
    first.update({
        "save3": dict(ckpt, run=torch_serve_worker.ckpt_save_case,
                      dir=dirs["z3"], zero3=True),
        "restore3": dict(ckpt, run=torch_serve_worker.ckpt_restore_case,
                         dir=dirs["12"], zero1=False, zero3=True,
                         wait=True)})
    second = {n: c for n, c in cases.items() if not n.startswith("fault:")}
    ctx = multiprocessing.get_context("spawn")
    results = {}
    running = {(2, 2): _spawn(ctx, str(tmp), (2, 2), first),
               (1, 2): _spawn(ctx, str(tmp), (1, 2), {
                   "save": dict(ckpt, run=torch_serve_worker.ckpt_save_case,
                                dir=dirs["12"])})}
    try:
        jref = dense.jax_reference(
            dataclasses.replace(jax_get_config(DENSE, reduced=True),
                                microbatches=2),
            jax.tree.map(lambda a: a.astype(jnp.float32), drawn[DENSE][0]),
            cases[f"{DENSE}/fp32/z3"]["batch"])
        for mesh, (queue, procs) in running.items():
            results[mesh] = _join(queue, procs)
        running = {(2, 1): _spawn(ctx, str(tmp), (2, 1), second),
                   "restore": _spawn(ctx, str(tmp), (1, 2), {
                       "restore": dict(
                           ckpt, run=torch_serve_worker.ckpt_restore_case,
                           dir=dirs["z3"], zero1=False)}, "-restore")}
        for mesh, (queue, procs) in running.items():
            results[mesh] = _join(queue, procs)
        running = {}
    finally:
        # a wave that raised leaves no rank behind
        for _, procs in running.values():
            for p in procs:
                p.kill()
    return cases, results, jref, dirs


def group(runs, mesh) -> dict:
    results = runs[1][mesh]
    assert results is not None, f"a rank of {mesh} hung or died"
    failed = {r: out for r, out in results.items() if isinstance(out, str)}
    assert not failed, failed
    n = 2 if mesh == "restore" else mesh[0] * mesh[1]
    assert sorted(results) == list(range(n))
    return results


def rank_mesh(mesh, coords) -> Mesh:
    return Mesh(mesh, ("data", "model"), coords=coords)


def zero3_regions(cfg, mesh, coords) -> dict:
    """Each leaf's ZeRO-3 region within its ZeRO-1 shard on this rank, by
    path, and its slices of the whole leaf."""
    rank = rank_mesh(mesh, coords)
    model = build_model(cfg)
    z1 = train_lib.make_train_state_specs(model, rank, zero1=True)
    z3 = train_lib.make_train_state_specs(model, rank, zero3=True)
    out = {}
    for p, d in tree_items(model.param_decls()):
        shard = local_slices(tree_at(z1.params, p), d.shape, rank)
        mine = local_slices(tree_at(z3.params, p), d.shape, rank)
        out["/".join(p)] = tuple(slice(m.start - s.start, m.stop - s.start)
                                 for s, m in zip(shard, mine))
    return out


def named_leaves(cfg, mesh) -> dict:
    """The leaves whose sums run in another order under ZeRO-3, each with
    its tolerance (module docstring)."""
    model = build_model(cfg)
    layout = serve_lib.shard_layout(model, Mesh(mesh, ("data", "model")), B)
    out = {"/".join(p): NAMED_TOL
           for p in train_lib.model_partial_leaves(model, layout)}
    if cfg.microbatches > 1:
        out.update({"/".join(p): NAMED_TOL
                    for p, _ in tree_items(model.param_decls())})
    if cfg.tie_embeddings:
        out["embed"] = NAMED_TOL
    return out


def broken_rules(z3: dict, z1: dict, cfg, mesh, dtype: str) -> list:
    """The rules of the module docstring that a rank's ZeRO-3 step ``z3``
    breaks against its ZeRO-1 step ``z1``: (rule, detail) pairs."""
    broken = []
    if z3["loss"] != z1["loss"]:
        broken.append(("loss", z3["loss"], z1["loss"]))
    if abs(z3["grad_norm"] - z1["grad_norm"]) > GN_TOL * z1["grad_norm"]:
        broken.append(("grad_norm", z3["grad_norm"], z1["grad_norm"]))
    named = named_leaves(cfg, mesh)
    if cfg.tie_embeddings and dtype == "bfloat16":
        named["embed"] = TIED_BF16_TOL
    floor = SMOKE.update_floor(AdamWConfig(**OPT), z1["grad_norm"])
    ties = admitted = 0
    for path, region in zero3_regions(cfg, mesh, z3["coords"]).items():
        g, want = z3["grads"][path], z1["grads"][path][region]
        if path in named:
            if dense.rel(g, want) > named[path]:
                broken.append(("named gradient", path, dense.rel(g, want)))
        elif not np.array_equal(g, want):
            broken.append(("gradient", path, dense.rel(g, want)))
        start = z3["p0"][path]
        if not np.array_equal(start, z1["p0"][path][region]):
            broken.append(("start", path))
        err, n, ok = SMOKE.update_rule(torch, *(torch.as_tensor(a) for a in (
            z3["p1"][path] - start, z1["p1"][path][region] - start, g,
            want)), floor)
        ties, admitted = ties + n, admitted + ok
        if err > SMOKE.TRAIN_GRAD_TOL:
            broken.append(("update", path, err))
        # ZeRO-1's moments are cut as ZeRO-3's parameters are
        for name, tol in (("m", SMOKE.TRAIN_GRAD_TOL + GN_TOL),
                          ("v", 2 * (SMOKE.TRAIN_GRAD_TOL + GN_TOL))):
            r = dense.rel(z3[name][path], z1[name][path])
            if r > tol:
                broken.append((name, path, r))
    if ties > admitted:
        broken.append(("update ties", ties, admitted))
    return broken


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["bf16", "fp32"])
@pytest.mark.parametrize("mesh", MESHES, ids=dense._ids(MESHES))
def test_zero3_step_matches_zero1_at_the_same_mesh(runs, mesh, kind, arch):
    """Every rank's ZeRO-3 loss, gradient regions, norm, update and
    moments against its ZeRO-1 step (module docstring), its all_reduce
    calls against ``train_collectives(..., zero3=True)``, its
    kernel-carrying calls against the ZeRO-1 step's and
    ``train_kernels``."""
    cases = runs[0]
    name = f"{arch}/{kind}"
    cfg = cases[f"{name}/z3"]["cfg"]
    dtype = spec(f"{name}/z3")["dtype"]
    for rank, out in group(runs, mesh).items():
        z1, z3 = out[f"{name}/z1"], out[f"{name}/z3"]
        assert broken_rules(z3, z1, cfg, mesh, dtype) == [], rank
        assert z3["collectives"] == SMOKE.train_collectives(
            cfg, mesh, True, zero3=True, one_dtype=dtype == "float32"), rank
        assert z3["kernels"] == z1["kernels"], rank
        assert {k: n for k, n in z3["kernels"].items() if n} == \
            SMOKE.train_kernels(cfg), rank


@pytest.mark.parametrize("mesh", MESHES, ids=dense._ids(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_a_rank_holds_its_regions_alone(runs, arch, mesh):
    """The state a rank holds under ZeRO-3 is, byte for byte, the ZeRO-3
    specs' local shapes (its parameters in the case's dtype, fp32
    moments), less than its ZeRO-1 state, and every leaf that the ZeRO-3
    pass cuts is cut to its region."""
    cfg = runs[0][f"{arch}/bf16/z3"]["cfg"]
    model = build_model(cfg)
    for rank, out in group(runs, mesh).items():
        specs = train_lib.make_train_state_specs(
            model, rank_mesh(mesh, out["coords"]), zero3=True)
        want = 0
        for p, d in tree_items(model.param_decls()):
            n = int(np.prod(local_shape(tree_at(specs.params, p), d.shape,
                                        rank_mesh(mesh, out["coords"]))))
            want += n * (d.dtype.itemsize + 8)
            got = out[f"{arch}/bf16/z3"]["p0"]["/".join(p)]
            assert got.size == n, (rank, p)
        z3 = out[f"{arch}/bf16/z3"]["state_bytes"]
        assert z3 == want, rank
        assert z3 < out[f"{arch}/bf16/z1"]["state_bytes"], rank


def test_zero3_dense_step_matches_jax(runs, monkeypatch):
    """The dense fp32 ZeRO-3 step at (2, 2) (two microbatches, a mask)
    against ``jax.value_and_grad(model.loss_fn)`` and ``adamw_update`` op
    by op, by ``tests/test_torch_train_sharded.py``'s rules against JAX,
    each rank's regions."""
    name = f"{DENSE}/fp32/z3"
    cfg = runs[0][name]["cfg"]

    def regions(cfg, mesh, coords, zero1):
        rank = rank_mesh(mesh, coords)
        specs = train_lib.make_train_state_specs(build_model(cfg), rank,
                                                 zero3=True)
        return {"/".join(p): (local_slices(tree_at(specs.params, p),
                                           d.shape, rank),) * 2
                for p, d in tree_items(build_model(cfg).param_decls())}
    monkeypatch.setattr(dense, "regions", regions)
    for rank, out in group(runs, (2, 2)).items():
        assert dense.broken_rules(out[name], runs[2], cfg, (2, 2), True,
                                  "float32",
                                  tol=dense.JAX_GRAD_TOL["float32"]) == [], \
            rank


@pytest.mark.parametrize("i", range(len(FAULTS)),
                         ids=["no-gather-sum", "unsummed-backward",
                              "other-slice"])
def test_each_planted_fault_breaks_a_rule_on_every_rank(runs, i):
    """Each of ``chip_smoke.ZERO3_FAULTS`` in tinyllama's bf16 ZeRO-3 step
    at (2, 2) breaks a rule against the ZeRO-1 step on every rank."""
    cfg = runs[0][f"fault:{i}"]["cfg"]
    for rank, out in group(runs, (2, 2)).items():
        assert broken_rules(out[f"fault:{i}"], out[f"{DENSE}/bf16/z1"], cfg,
                            (2, 2), "bfloat16"), (FAULTS[i], rank)


@pytest.mark.parametrize("mesh", MESHES, ids=dense._ids(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zero3_serving_matches_the_same_mesh(runs, arch, mesh):
    """Each rank's ZeRO-3 prefill and decode steps give the non-ZeRO-3
    steps' logits and caches bit for bit, from less weight memory, with
    ``shard_collectives(..., zero3=True)`` all_reduce calls a decode
    step."""
    cfg = get_config(arch, reduced=True)
    steps = TOKENS - PROMPT
    for rank, out in group(runs, mesh).items():
        got, want = out[f"serve:{arch}"]["zero3"], out[f"serve:{arch}"][
            "shards"]
        assert len(got["logits"]) == steps + 1
        for a, b in zip(got["logits"], want["logits"]):
            assert np.array_equal(a, b), rank
        assert got["cache"].keys() == want["cache"].keys()
        for key in want["cache"]:
            assert np.array_equal(got["cache"][key], want["cache"][key]), \
                (rank, key)
        assert got["bytes"] < want["bytes"], rank
        assert got["collectives"] == steps * SMOKE.shard_collectives(
            cfg, zero3_mesh=mesh), rank
        assert want["collectives"] == steps * SMOKE.shard_collectives(cfg), \
            rank


def _whole(shards: dict, mesh, specs_of) -> dict:
    """The whole state, by checkpoint key, from each rank's shards (bits)
    under ``specs_of(rank mesh)``."""
    out = {}
    for r, res in shards.items():
        rank = rank_mesh(mesh, res["coords"])
        specs = specs_of(rank)
        model = build_model(dataclasses.replace(
            get_config(CKPT_ARCH, reduced=True), microbatches=1))
        for path, leaf in tree_items(train_lib.abstract_train_state(
                model, AdamWConfig(**OPT))):
            key = "__".join(path)
            if key not in out:
                dtype = np.uint16 if leaf.dtype == torch.bfloat16 else \
                    torch.empty((), dtype=leaf.dtype).numpy().dtype
                out[key] = np.zeros(tuple(leaf.shape), dtype=dtype)
            out[key][local_slices(tree_at(specs, path), out[key].shape,
                                  rank)] = res["shards"][key]
    return out


def test_a_zero3_save_restores_without_zero3_and_on_one_device(runs):
    """The (2, 2) ZeRO-3 save after one step restores at (1, 2) without
    ZeRO-3 and on one device, each leaf bit for bit its slice of the
    state assembled from the (2, 2) ranks' regions."""
    model = build_model(dataclasses.replace(get_config(CKPT_ARCH,
                                                       reduced=True),
                                            microbatches=1))
    saved = {r: out["save3"] for r, out in group(runs, (2, 2)).items()}
    full = _whole(saved, (2, 2), lambda rank: train_lib.make_train_state_specs(
        model, rank, zero3=True))
    for rank, out in group(runs, "restore").items():
        mesh = rank_mesh((1, 2), out["restore"]["coords"])
        specs = train_lib.make_train_state_specs(model, mesh)
        for path, _ in tree_items(specs):
            key = "__".join(path)
            assert np.array_equal(out["restore"]["shards"][key], full[key][
                local_slices(tree_at(specs, path), full[key].shape, mesh)]), \
                (rank, key)
    like = train_lib.init_train_state(model, AdamWConfig(**OPT), seed=5,
                                      device="cpu")
    for path, a in tree_items(restore_state(runs[3]["z3"], 1, like)):
        assert np.array_equal(torch_serve_worker.leaf_bits(a),
                              full["__".join(path)]), path


def test_a_one_by_two_save_restores_into_zero3_regions(runs):
    """The (1, 2) save restores into the ZeRO-3 regions at (2, 2), each
    bit for bit its slice of the state assembled from the (1, 2)
    ranks' shards."""
    model = build_model(dataclasses.replace(get_config(CKPT_ARCH,
                                                       reduced=True),
                                            microbatches=1))
    saved = {r: out["save"] for r, out in group(runs, (1, 2)).items()}
    full = _whole(saved, (1, 2), lambda rank: train_lib.make_train_state_specs(
        model, rank))
    for rank, out in group(runs, (2, 2)).items():
        mesh = rank_mesh((2, 2), out["restore3"]["coords"])
        specs = train_lib.make_train_state_specs(model, mesh, zero3=True)
        for path, _ in tree_items(specs):
            key = "__".join(path)
            want = full[key][local_slices(tree_at(specs, path),
                                          full[key].shape, mesh)]
            assert np.array_equal(out["restore3"]["shards"][key], want), \
                (rank, key)


@pytest.mark.parametrize("arch,mesh,collectives", [
    # 8 layers: ZeRO-1's 48, and a gather a layer and at each end, each
    # with its backward and each layer's recomputed: 10 + 8 + 10; the
    # gradients' sum over the data axis leaves (every leaf is cut)
    (DENSE, (2, 2), 48 + 10 + 8 + 10 - 2),
    # 6 layers: ZeRO-1's 39, 8 gathers forward and backward, 6
    # recomputed; the per-head leaves' sum over the data axis stays
    (SSM, (2, 2), 39 + 8 + 6 + 8 - 1)])
def test_the_card_runs_predictions(arch, mesh, collectives):
    """``train_collectives(..., zero3=True)`` of the card's ZeRO-3 runs at
    (2, 2) (``chip_smoke.sharded_train_config``: tinyllama at 8 layers,
    mamba2 at 6), against the counts derived by hand; their launches are
    the ZeRO-1 runs'."""
    cfg = SMOKE.sharded_train_config(arch)
    assert SMOKE.train_collectives(cfg, mesh, True, zero3=True) == \
        collectives
    assert SMOKE.train_collectives(cfg, mesh, True, zero3=True) == \
        SMOKE.train_collectives(cfg, mesh, False, zero3=True)
