"""The port's checkpoints: the JAX package's on-disk layout, so that a
checkpoint written by either package restores into the other bit for bit;
round trip, garbage collection and async saves, dtypes
(tests/test_substrate.py's checks)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.ckpt as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.runtime.train_lib import TrainState as JaxTrainState
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_state, save_state)
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.param import tree_items
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainState, init_train_state


def bits(x) -> np.ndarray:
    """Raw bits of a leaf of either package, for an exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def jax_state(seed=0):
    """A reference TrainState of reduced tinyllama, trained one fake step
    (nonzero moments and step), built without a mesh."""
    jmodel = jax_build_model(jax_get_config("tinyllama-1.1b", reduced=True))
    params = jax_init_params(jmodel.param_decls(), jax.random.key(seed))
    opt = jax_adamw_init(params, JaxAdamWConfig())
    opt = opt._replace(step=jnp.asarray(3, jnp.int32),
                       m=jax.tree.map(lambda a: a + 0.25, opt.m),
                       v=jax.tree.map(lambda a: a + 0.5, opt.v))
    return JaxTrainState(params, opt)


def port_state(seed=1):
    model = build_model(get_config("tinyllama-1.1b", reduced=True))
    return init_train_state(model, AdamWConfig(), seed=seed, device="cpu")


def jax_by_path(tree):
    return {"__".join(str(getattr(k, "key", getattr(k, "name", k)))
                      for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_layout_names_leaves_as_the_reference(tmp_path):
    state = port_state()
    save_state(tmp_path / "port", 5, state)
    jax_ckpt.save_state(tmp_path / "jax", 5, jax_state())
    port = json.loads((tmp_path / "port" / "step_00000005" /
                       "manifest.json").read_text())
    ref = json.loads((tmp_path / "jax" / "step_00000005" /
                      "manifest.json").read_text())
    assert port["leaves"] == ref["leaves"]       # names, dtypes, shapes
    assert port["step"] == 5
    for name in ("params__layers__attn__wq", "opt__step", "opt__m__embed"):
        assert (tmp_path / "port" / "step_00000005" / f"{name}.npy").exists()
    assert port["leaves"]["params__embed"]["dtype"] == "bfloat16"
    assert port["leaves"]["opt__step"] == {"dtype": "int32", "shape": []}


def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path):
    jstate = jax_state()
    jax_ckpt.save_state(tmp_path, 3, jstate)
    restored = restore_state(tmp_path, 3, port_state())
    want = jax_by_path(jstate)
    got = {"__".join(p): leaf for p, leaf in tree_items(restored)}
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.array_equal(bits(got[k]), bits(w)), k
    assert restored.opt.step.dtype == torch.int32
    assert restored.params["embed"].dtype == torch.bfloat16


def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path):
    state = port_state()
    save_state(tmp_path, 4, state)
    restored = jax_ckpt.restore_state(tmp_path, 4, jax_state())
    got = jax_by_path(restored)
    for path, leaf in tree_items(state):
        k = "__".join(path)
        assert got[k].dtype == (jnp.bfloat16 if leaf.dtype == torch.bfloat16
                                else jnp.dtype(str(leaf.dtype)[6:]))
        assert np.array_equal(bits(got[k]), bits(leaf)), k


def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6, dtype=torch.float32)
                        .reshape(2, 3)},
             "step": torch.tensor(7, dtype=torch.int32)}
    save_state(tmp_path, 7, state)
    assert latest_step(tmp_path) == 7
    assert latest_step(tmp_path / "missing") is None
    like = {"params": {"w": torch.zeros(2, 3)},
            "step": torch.tensor(0, dtype=torch.int32)}
    restored = restore_state(tmp_path, 7, like)
    assert torch.equal(restored["params"]["w"],
                       torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert int(restored["step"]) == 7
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_checkpoint_missing_leaf_raises(tmp_path):
    save_state(tmp_path, 1, {"w": torch.ones(2)})
    with pytest.raises(KeyError, match="v"):
        restore_state(tmp_path, 1, {"w": torch.ones(2), "v": torch.ones(2)})


def test_checkpoint_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    state = {"w": torch.ones(3)}
    for s in (1, 2, 3):
        state["w"].mul_(2)
        mgr.save(s, state)
        state["w"].add_(100)      # the saved snapshot was taken at save()
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert steps == [2, 3]
    restored, step = mgr.restore({"w": torch.zeros(3)})
    assert step == 3
    assert torch.equal(restored["w"], torch.full((3,), 608.0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"w": torch.zeros(3)})


def test_checkpoint_manager_sync_and_error(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1, async_save=False)
    mgr.save(1, {"w": torch.ones(2)})
    mgr.save(2, {"w": torch.ones(2)})
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000002"]
    (tmp_path / "blocker").write_text("")
    bad = CheckpointManager(tmp_path / "blocker" / "x", async_save=True)
    bad.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        bad.wait()


def test_checkpoint_restore_respects_dtype(tmp_path):
    save_state(tmp_path, 1, {"w": torch.ones(4, dtype=torch.float32)})
    restored = restore_state(tmp_path, 1,
                             {"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].float(), torch.ones(4))


def test_restore_keeps_the_train_state_structure(tmp_path):
    state = port_state()
    save_state(tmp_path, 2, state)
    like = port_state(seed=9)
    restored = restore_state(tmp_path, 2, like)
    assert isinstance(restored, TrainState)
    assert type(restored.opt) is type(like.opt)
    for (p, a), (_, b) in zip(tree_items(restored), tree_items(state)):
        assert torch.equal(a, b), p
