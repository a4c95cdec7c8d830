"""Checkpoints of a sharded training state (``checkpoint/ckpt.py`` with
``specs`` and ``mesh``; ``launch/train.py::train_loop(..., data=,
model=, ckpt_dir=)``) on the CPU, in gloo groups of spawned ranks
(``torch_serve_worker``: one process a rank, each group joined with a
timeout, so a hung rank fails the test).

The contract is the reference's (``repro/checkpoint/ckpt.py``): every leaf
a full array keyed by its tree path, whatever mesh wrote it. So a (1, 2)
save of reduced mamba2-370m after one sharded step must be, file for
file, what ``save_state`` writes for the same state held whole (assembled
here from the ranks' shards), restore bit for bit into the JAX package
(``repro.checkpoint.ckpt.restore_state``), and restore at (2, 2) under
ZeRO-1 and on one device, each rank's shards equal bit for bit to their
slices of that state. ``train_loop`` over (1, 2), stopped by its
simulated failure after step 2 and resumed, gives the uninterrupted
run's losses (the rule of ``tests/test_runtime.py``'s restart test, rtol
2e-2, and here bit for bit: the same mesh sums in the same order). The
planted fault of ``chip_smoke.CKPT_FAULT`` (a ZeRO-1 moment restored from
the other data rank's slice) must break that equality on every rank.
"""

import dataclasses
import multiprocessing
import os

import jax
import numpy as np
import pytest
import torch

import repro.checkpoint.ckpt as jax_ckpt
import torch_serve_worker
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.runtime.train_lib import TrainState as JaxTrainState
from repro_torch.checkpoint import restore_state, save_state
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model, init_params
from repro_torch.models.param import tree_at, tree_items, tree_map_with_path
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import train_lib
from repro_torch.sharding.rules import local_slices

ARCH, LOOP_ARCH = "mamba2-370m", "tinyllama-1.1b"
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
JOIN_S = 300


def _cfg():
    return dataclasses.replace(get_config(ARCH, reduced=True),
                               microbatches=1)


def _spawn(ctx, tmp, mesh, cases):
    queue = ctx.Queue()
    init = os.path.join(tmp, f"init-{mesh[0]}x{mesh[1]}")
    procs = [ctx.Process(target=torch_serve_worker.run_rank,
                         args=(r, mesh[0], mesh[1], init, cases, queue))
             for r in range(mesh[0] * mesh[1])]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, out = queue.get(timeout=JOIN_S)
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    failed = {r: out for r, out in got.items() if isinstance(out, str)}
    assert not failed, failed
    assert sorted(got) == list(range(mesh[0] * mesh[1]))
    return got


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The (1, 2) ranks' save and ``train_loop`` runs, then the (2, 2)
    ranks' restores (ZeRO-1; once more under the planted fault). ->
    (directory, the state assembled from the (1, 2) shards by key, the
    (1, 2) results, the (2, 2) results)."""
    tmp = tmp_path_factory.mktemp("ckpt_sharded")
    cfg = _cfg()
    model = build_model(cfg)
    params = init_params(model.param_decls(),
                         torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (8, 33)).astype(np.int32)}
    directory = str(tmp / "sharded")
    ctx = multiprocessing.get_context("spawn")
    one_two = _spawn(ctx, str(tmp), (1, 2), {
        "save": {"run": torch_serve_worker.ckpt_save_case, "cfg": cfg,
                 "params": params, "batch": batch, "opt": OPT,
                 "dir": directory},
        "loop": {"run": torch_serve_worker.ckpt_loop_case,
                 "arch": LOOP_ARCH, "dir": str(tmp / "loop")}})
    restore = {"run": torch_serve_worker.ckpt_restore_case, "cfg": cfg,
               "opt": OPT, "dir": directory, "zero1": True}
    two_two = _spawn(ctx, str(tmp), (2, 2), {
        "restore": restore, "fault": dict(restore, fault=True)})
    # the whole state, from the (1, 2) ranks' shards
    specs = train_lib.make_train_state_specs(model, Mesh((1, 2), (
        "data", "model")))
    full = {}
    for path, leaf in tree_items(train_lib.abstract_train_state(
            model, AdamWConfig(**OPT))):
        key = "__".join(path)
        dtype = np.uint16 if leaf.dtype == torch.bfloat16 else \
            torch.empty((), dtype=leaf.dtype).numpy().dtype
        whole = np.zeros(tuple(leaf.shape), dtype=dtype)
        for out in one_two.values():
            rank = Mesh((1, 2), ("data", "model"), coords=out["coords"])
            whole[local_slices(tree_at(specs, path), whole.shape, rank)] = \
                out["save"]["shards"][key]
        full[key] = whole
    return directory, full, one_two, two_two


def test_a_sharded_save_is_the_unsharded_save_file_for_file(saved,
                                                            tmp_path):
    """Every file of the (1, 2) save, the manifest included, has the bytes
    that ``save_state`` writes for the assembled state held whole."""
    directory, full, _, _ = saved
    model = build_model(_cfg())
    like = train_lib.init_train_state(model, AdamWConfig(**OPT),
                                      device="cpu")

    def leaf(path, a):
        bits = torch.from_numpy(full["__".join(path)].copy())
        return bits.view(torch.int16).view(torch.bfloat16) \
            if a.dtype == torch.bfloat16 else bits
    whole = tree_map_with_path(leaf, like)
    save_state(tmp_path, 1, whole)
    got = sorted(os.listdir(os.path.join(directory, "step_00000001")))
    want = sorted(os.listdir(tmp_path / "step_00000001"))
    assert got == want and len(got) == len(full) + 1
    for name in got:
        with open(os.path.join(directory, "step_00000001", name), "rb") as f:
            a = f.read()
        assert a == (tmp_path / "step_00000001" / name).read_bytes(), name


def test_a_sharded_save_restores_into_jax_bit_for_bit(saved):
    directory, full, _, _ = saved
    jmodel = jax_build_model(dataclasses.replace(
        jax_get_config(ARCH, reduced=True), microbatches=1))
    params = jax_init_params(jmodel.param_decls(), jax.random.key(0))
    like = JaxTrainState(params, jax_adamw_init(params, JaxAdamWConfig()))
    restored = jax_ckpt.restore_state(directory, 1, like)
    flat = {"__".join(str(getattr(k, "key", getattr(k, "name", k)))
                      for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                restored)[0]}
    assert set(flat) == set(full)
    for key, leaf in flat.items():
        a = np.asarray(leaf)
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert a.dtype == full[key].dtype and np.array_equal(a, full[key]), \
            key


def test_a_sharded_save_restores_on_one_device(saved):
    directory, full, _, _ = saved
    model = build_model(_cfg())
    like = train_lib.init_train_state(model, AdamWConfig(**OPT), seed=5,
                                      device="cpu")
    restored = restore_state(directory, 1, like)
    for path, a in tree_items(restored):
        assert np.array_equal(torch_serve_worker.leaf_bits(a),
                              full["__".join(path)]), path


@pytest.mark.parametrize("fault", [False, True], ids=["", "planted fault"])
def test_a_one_by_two_save_restores_at_two_by_two_with_zero1(saved, fault):
    """Each (2, 2) rank's restored shards under ZeRO-1 are their slices of
    the saved state, bit for bit; under ``chip_smoke.CKPT_FAULT`` every
    rank's moments differ from theirs."""
    _, full, _, two_two = saved
    model = build_model(_cfg())
    for rank, out in two_two.items():
        mesh = Mesh((2, 2), ("data", "model"), coords=out["coords"])
        specs = train_lib.make_train_state_specs(model, mesh, zero1=True)
        apart = []
        for path, _ in tree_items(specs):
            key = "__".join(path)
            want = full[key][local_slices(tree_at(specs, path),
                                          full[key].shape, mesh)]
            if not np.array_equal(out["fault" if fault else "restore"]
                                  ["shards"][key], want):
                apart.append(key)
        if fault:
            assert apart and all(k.startswith("opt__") for k in apart), \
                (rank, apart)
        else:
            assert apart == [], (rank, apart)


def test_train_loop_resumes_a_sharded_run(saved):
    """``train_loop(..., data=1, model=2, ckpt_dir=, simulate_failure=2)``
    and a resume give the uninterrupted run's losses from step 2 on, the
    same on both ranks: within the restart rule of
    ``tests/test_runtime.py`` (rtol 2e-2) and, the mesh being the same,
    bit for bit."""
    runs = [out["loop"] for _, out in sorted(saved[2].items())]
    assert runs[0] == runs[1]
    run = runs[0]
    assert run["start_step"] == 2 and len(run["whole"]) == 4
    assert np.allclose(run["resumed"], run["whole"][2:], rtol=2e-2)
    assert run["resumed"] == run["whole"][2:]
