"""Sharded training of the hybrid and encoder-decoder families
(``runtime/train_lib.py``'s ``build_train_step(..., mesh=)``) on the CPU,
against the port's unsharded step, which ``tests/test_torch_hybrid.py``
and ``tests/test_torch_encdec.py`` hold to ``jax.value_and_grad`` and
``adamw_update`` op by op, so no JAX forward runs here. The rules are
the dense file's (``tests/test_torch_train_sharded.py``), with the
families file's treatment of the Mamba leaves of one number a head
(``tests/test_torch_train_sharded_families.py``: ``broken_rules``); the
ranks are ``torch_serve_worker``'s, one spawned process a rank, a gloo
group a mesh, four ranks at a time, each group joined with a timeout, so a
hung rank fails the test.

The cases, on weights carried from JAX ``init_params`` through numpy (drawn
once a module), the attention at std 1/sqrt(fan-in) (the dense file's
``fan_in``, on every attention stack), batch 8 x 32 tokens: reduced
jamba-1.5-large-398b (one super-block of period 8: seven Mamba-2
sublayers, an attention at index 3, four MoE sublayers of 8 experts top-2
and four MLPs; 4 heads over 2 KV heads, 8 SSM heads) and reduced
seamless-m4t-large-v2 (2 encoder and 4 decoder layers, 4 heads over 2 KV
heads, 16 frames a sequence), each at (1, 2), (2, 2), (1, 4) and (2, 1):
in bf16 with one microbatch (jamba's two: its MoE), no mask and ZeRO-1
off, and in fp32 with two microbatches, a mask and ZeRO-1 on; and the
planted faults of ``chip_smoke.HYBRID_TRAIN_FAULTS`` and
``ENCDEC_TRAIN_FAULTS``, the same code as on the card.

Each rank is held to the port's unsharded step on the whole batch. For
jamba that step dispatches each (microbatch, data shard) group of rows
alone, as the reference's ``shard_map`` does (the families file's
``grouped_experts``), and every rank is fed its top-k experts at the
rank's rows (``torch_serve_worker.microbatch_routes``; ROADMAP C.2: a
near-tie routed apart moves a token by a whole expert's output). Rules
and tolerances are the dense file's (bf16: loss rel 1e-3, norm rel 1e-2,
each gradient shard within 3e-2 of its slice's norm; fp32: loss 1e-5,
gradients 1e-4, norm 1e-3; updates by ``chip_smoke.update_rule``), with
two stated departures. jamba's fp32 case is held to the bf16 rules, as
mamba2's is: its residual stream is bf16 in both paths (the embedding's
bf16 output, and each Mamba sublayer's output cast to its input's dtype,
the first sublayer's a bf16 input). seamless's fp32 case holds the
gradients that pass through a bf16 rounding that both paths make at sums
taken in other orders to 2^-5 of their norm, as the dense file holds
``embed`` and ``layers/ln1`` (``BF16_ROUNDED``): the token embedding and
the decoder's first norm, behind the bf16 embedding output, and the
encoder's first norm, behind the frames cast to bf16 (``encode``)
(measured 2.5e-3 to 2.7e-3 of ``decoder/ln1``'s norm and 2.8e-3 to
3.0e-3 of ``encoder/ln1``'s). Each step's all_reduce
calls equal ``chip_smoke.train_collectives``, and its calls of the cores
that the card's kernels carry (``torch_serve_worker.counting_cores``)
equal ``chip_smoke.train_kernels``.
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

import test_torch_train_sharded as dense
import test_torch_train_sharded_families as families
import torch_serve_worker
from test_torch_sharding import jax_leaves, port_leaves
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.runtime import train_lib as jax_train_lib
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh, abstract_mesh
from repro_torch.models import build_model, params_from_numpy
from repro_torch.runtime import train_lib
from repro_torch.runtime.serve_lib import shard_layout

SMOKE = torch_serve_worker.chip_smoke()
HYBRID, ENCDEC = "jamba-1.5-large-398b", "seamless-m4t-large-v2"
ARCHS = [HYBRID, ENCDEC]
MESHES = [(1, 2), (2, 2), (1, 4), (2, 1)]
B, S, FRAMES = 8, 32, 16
OPT = dense.OPT
JOIN_S = 300
FAULTS = SMOKE.HYBRID_TRAIN_FAULTS + SMOKE.ENCDEC_TRAIN_FAULTS
# each planted fault: the case whose model, weights and batch it runs, and
# its mesh (the encoder's rolled K/V heads need a rank that holds two KV
# heads: at (1, 4) the 2 KV heads do not divide and every rank holds both)
FAULT_AT = {SMOKE.HYBRID_TRAIN_FAULTS[0]: (f"{HYBRID}/bf16", (1, 2)),
            SMOKE.ENCDEC_TRAIN_FAULTS[0]: (f"{ENCDEC}/bf16", (1, 2)),
            SMOKE.ENCDEC_TRAIN_FAULTS[1]: (f"{ENCDEC}/bf16", (1, 4))}
# seamless's fp32 leaves behind a bf16 rounding both paths make (module
# docstring), held to 2^-5 of their norm
ENCDEC_BF16_ROUNDED = ("embed", "decoder/ln1", "encoder/ln1")


def spec(name: str) -> dict:
    """A case's arch, dtype, microbatches, mask and ZeRO-1, from its name:
    "<arch>/bf16", "<arch>/fp32" or "fault:<i>" (``FAULTS[i]`` on its case
    of ``FAULT_AT``)."""
    if name.startswith("fault:"):
        fault = FAULTS[int(name.split(":")[1])]
        return dict(spec(FAULT_AT[fault][0]), fault=fault)
    arch, kind = name.split("/")
    if kind == "bf16":
        return dict(arch=arch, dtype="bfloat16",
                    mu=2 if arch == HYBRID else 1, mask=False, zero1=False)
    return dict(arch=arch, dtype="float32", mu=2, mask=True, zero1=True)


def base(name: str) -> str:
    """The case whose reference a case is held to."""
    if name.startswith("fault:"):
        return FAULT_AT[FAULTS[int(name.split(":")[1])]][0]
    return name


def cases_of(mesh) -> list:
    return [f"{a}/{k}" for a in ARCHS for k in ("bf16", "fp32")] + [
        f"fault:{i}" for i, f in enumerate(FAULTS) if FAULT_AT[f][1] == mesh]


def rules_dtype(name: str) -> str:
    """jamba's fp32 case is held to the bf16 rules (module docstring)."""
    sp = spec(name)
    return "bfloat16" if sp["arch"] == HYBRID else sp["dtype"]


def configs(sp: dict):
    return tuple(dataclasses.replace(get(sp["arch"], reduced=True),
                                     microbatches=sp["mu"])
                 for get in (jax_get_config, get_config))


def fan_in(params, cfg):
    """``dense.fan_in`` on every attention stack of the tree: a hybrid's
    ``layers/attn``, the encoder-decoder's ``encoder/attn``,
    ``decoder/self_attn`` and ``decoder/cross_attn``."""
    out = dict(params)
    for stack, blocks in (("layers", ("attn",)), ("encoder", ("attn",)),
                          ("decoder", ("self_attn", "cross_attn"))):
        if stack not in params:
            continue
        sub = dict(params[stack])
        for block in blocks:
            sub[block] = dense.fan_in({"layers": {"attn": sub[block]}},
                                      cfg)["layers"]["attn"]
        out[stack] = sub
    return out


def batch_of(sp: dict) -> dict:
    """The dense file's batch (8 x 33 tokens, its mask) and, for the
    encoder-decoder, 16 fp32 frame embeddings a row."""
    batch = dense.batch_of(ARCHS.index(sp["arch"]), sp["mask"])
    if sp["arch"] == ENCDEC:
        rng = np.random.default_rng(11)
        batch["frames"] = rng.normal(size=(B, FRAMES, 64)).astype(
            np.float32)
    return batch


def port_reference(cfg, params_t, batch, n_data: int) -> dict:
    """The unsharded step (``dense.port_reference``); jamba's MoE
    dispatched in ``n_data`` groups (``families.grouped_experts``), its
    top-k experts recorded for each microbatch and layer (``routes``)."""
    routes = []
    moe = bool(cfg.n_experts)
    with families.grouped_experts(n_data) if moe \
            else contextlib.nullcontext(), \
            torch_serve_worker.microbatch_routes(record=routes) if moe \
            else contextlib.nullcontext():
        ref = dense.port_reference(cfg, params_t, batch)
    ref["routes"] = routes
    return ref


@pytest.fixture(scope="module")
def runs():
    """Every mesh's ranks, spawned four at a time; the port's unsharded
    references (jamba's at each data axis) first, since the ranks take
    their routing. -> (cases by name, references by (name, data axis),
    results by mesh)."""
    cases, weights = {}, {}
    names = sorted({n for mesh in MESHES for n in cases_of(mesh)})
    for name in names:
        sp = spec(name)
        jcfg, cfg = configs(sp)
        if sp["arch"] not in weights:
            params_j = jax_init_params(jax_build_model(jcfg).param_decls(),
                                       jax.random.key(ARCHS.index(
                                           sp["arch"])))
            weights[sp["arch"]] = fan_in(params_j, cfg)
        params_j = weights[sp["arch"]]
        if sp["dtype"] == "float32":
            params_j = jax.tree.map(lambda a: a.astype(jnp.float32),
                                    params_j)
        cases[name] = {"run": torch_serve_worker.train_case, "cfg": cfg,
                       "params": params_from_numpy(
                           jax.tree.map(np.asarray, params_j), "cpu"),
                       "batch": batch_of(sp), "opt": OPT,
                       "zero1": sp["zero1"], "fault": sp.get("fault")}
    refs = {}
    for name in names:
        if name.startswith("fault:"):
            continue
        c = cases[name]
        for n_data in ((1, 2) if c["cfg"].n_experts else (1,)):
            refs[name, n_data] = port_reference(c["cfg"], c["params"],
                                                c["batch"], n_data)
    for name in names:
        if cases[name]["cfg"].n_experts:
            cases[name]["routes"] = {n: refs[base(name), n]["routes"]
                                     for n in (1, 2)}
    ctx = multiprocessing.get_context("spawn")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:

        def spawn(data, model):
            queue = ctx.Queue()
            init = os.path.join(tmp, f"init-{data}x{model}")
            mine = {n: cases[n] for n in cases_of((data, model))}
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

        running = {}
        try:
            for wave in [[(2, 2)], [(1, 4)], [(1, 2), (2, 1)], []]:
                for mesh, (queue, procs) in running.items():
                    join(mesh, queue, procs)
                running = {mesh: spawn(*mesh) for mesh in wave}
        finally:
            # a wave that raised leaves no rank behind
            for _, procs in running.values():
                for p in procs:
                    p.kill()
    return cases, refs, results


def ref_of(runs, name: str, mesh) -> dict:
    """The reference a case is held to at ``mesh``: jamba's for the mesh's
    data axis."""
    moe = bool(runs[0][name]["cfg"].n_experts)
    return runs[1][base(name), mesh[0] if moe else 1]


def broken_rules(out, ref, case: dict, name: str, mesh) -> list:
    """``families.broken_rules`` at the case's rules, seamless's fp32
    leaves of ``ENCDEC_BF16_ROUNDED`` at 2^-5 (module docstring)."""
    dtype = rules_dtype(name)
    rounded = ENCDEC_BF16_ROUNDED if spec(name)["arch"] == ENCDEC \
        else dense.BF16_ROUNDED
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dense, "BF16_ROUNDED", rounded)
        return families.broken_rules(out, ref, case["cfg"], mesh,
                                     case["zero1"], dtype)


def group(runs, mesh) -> dict:
    results = runs[2][mesh]
    assert results is not None, f"a rank of {mesh} hung or died"
    failed = {r: out for r, out in results.items() if isinstance(out, str)}
    assert not failed, failed
    assert sorted(results) == list(range(mesh[0] * mesh[1]))
    return results


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("mesh", MESHES, ids=dense._ids(MESHES))
def test_each_rank_matches_the_unsharded_step(runs, mesh, dtype, arch):
    """Every rank's loss, norm, gradient, parameter and moment shards
    against the unsharded step (jamba's MoE in the groups of the mesh's
    data axis, each rank fed its experts), its all_reduce calls against
    ``train_collectives`` and its kernel-carrying calls against
    ``train_kernels``."""
    name = f"{arch}/{dtype}"
    case = runs[0][name]
    ref = ref_of(runs, name, mesh)
    want = SMOKE.train_kernels(case["cfg"])
    for rank, out in group(runs, mesh).items():
        got = out[name]
        assert broken_rules(got, ref, case, name, mesh) == [], rank
        assert got["collectives"] == SMOKE.train_collectives(
            case["cfg"], mesh, case["zero1"]), rank
        assert {k: n for k, n in got["kernels"].items() if n} == want, rank


@pytest.mark.parametrize("i", range(len(FAULTS)), ids=[
    f.split(" ")[0] + f"-{i}" for i, f in enumerate(FAULTS)])
def test_each_planted_fault_breaks_a_rule_on_every_rank(runs, i):
    """``chip_smoke.py``'s planted faults of the two families, each on its
    case and mesh (``FAULT_AT``): the Mamba sublayers' norm summed over
    the rank's own columns, the cross-attention's ``wo`` sum skipped, the
    encoder's K/V heads rolled by one."""
    fault = FAULTS[i]
    name, mesh = f"fault:{i}", FAULT_AT[fault][1]
    ref = ref_of(runs, name, mesh)
    for rank, out in group(runs, mesh).items():
        assert broken_rules(out[name], ref, runs[0][name], name, mesh), \
            (fault, rank)


def test_model_partial_leaves_of_both_families():
    """From the specs, against a hand list: the hybrid's Mamba sublayers'
    ``w_B``, ``w_C``, ``conv_B``, ``conv_C`` (and, where the 2 KV heads do
    not divide over 4, its attention's ``wk``/``wv``); the
    encoder-decoder's nothing where the KV heads divide and, at (1, 4),
    ``wk``/``wv`` of each of its three attention stacks; neither's MoE
    router, MoE experts or MLP."""
    def partial(arch, mesh):
        model = build_model(get_config(arch, reduced=True))
        layout = shard_layout(model, Mesh(mesh, ("data", "model")), B)
        return {"/".join(p) for p in
                train_lib.model_partial_leaves(model, layout)}
    mamba = {f"layers/mamba/{n}" for n in ("w_B", "w_C", "conv_B",
                                           "conv_C")}
    assert partial(HYBRID, (1, 2)) == mamba
    assert partial(HYBRID, (1, 4)) == mamba | {"layers/attn/wk",
                                               "layers/attn/wv"}
    assert partial(ENCDEC, (1, 2)) == set()
    assert partial(ENCDEC, (1, 4)) == {
        f"{stack}/{w}" for stack in ("encoder/attn", "decoder/self_attn",
                                     "decoder/cross_attn")
        for w in ("wk", "wv")}


@pytest.mark.parametrize("zero1", [False, True], ids=["", "zero1"])
@pytest.mark.parametrize("mesh", MESHES, ids=dense._ids(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, mesh, zero1):
    """At each mesh of the cases, the reduced configs' TrainState specs
    (with and without ZeRO-1) and the specs of an encoder-decoder batch
    (tokens, mask, frames: all cut on axis 0) equal the reference's."""
    jmesh = AbstractMesh(mesh, ("data", "model"))
    tmesh = abstract_mesh(mesh)
    jcfg, cfg = configs(spec(f"{arch}/bf16"))
    want = jax_train_lib.make_train_state_specs(jax_build_model(jcfg),
                                                jmesh, zero1=zero1)
    got = train_lib.make_train_state_specs(build_model(cfg), tmesh,
                                           zero1=zero1)
    assert port_leaves(got) == jax_leaves(want)
    shapes = {"tokens": ((B, S + 1), "int32"), "mask": ((B, S), "float32"),
              "frames": ((B, FRAMES, cfg.d_model), "bfloat16")}
    jtree = {k: jax.ShapeDtypeStruct(s, getattr(jnp, d))
             for k, (s, d) in shapes.items()}
    ttree = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
             for k, (s, d) in shapes.items()}
    want = jax_train_lib.batch_sharding(jmesh, jtree)
    got = train_lib.batch_sharding(tmesh, ttree)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert tuple(got["frames"]) == (tuple(got["tokens"])[0], None, None)


@pytest.mark.parametrize("arch,collectives,kernels", [
    # 6 + 6 layers: forward 1 + 2 * 6 + 3 * 6 + 2, backward 1 + 12 + 18,
    # remat 6 + 12, the norm's 1
    (ENCDEC, 83, {"flash_attention": 36, "flash_attention_bwd": 18}),
    # one period-4 block: its 3 * 4 - 1 sums forward and backward (with
    # the embedding, the loss and the head), 10 recomputed, the partial
    # leaves' and the norm's
    (HYBRID, 38, {"flash_attention": 2, "flash_attention_bwd": 1,
                  "ssd": 6, "ssd_bwd": 3})])
def test_the_card_runs_predictions(arch, collectives, kernels):
    """``train_collectives`` and ``train_kernels`` of the card's runs at
    (1, 2) (``chip_smoke.sharded_train_config``: seamless at full width,
    6 + 6 layers; jamba's reduced config cut to one period-4 block),
    against the counts derived by hand."""
    cfg = SMOKE.sharded_train_config(arch)
    assert SMOKE.train_collectives(cfg, (1, 2), False) == collectives
    assert SMOKE.train_kernels(cfg) == kernels
