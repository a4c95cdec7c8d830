"""The port's DFlow-orchestrated training (``repro_torch.runtime.
orchestrator``) against the reference's (``repro.runtime.orchestrator``) and
against the port's own ``train_loop``.

* tests/test_runtime.py's two orchestrator cases, on both packages; the
  checkpoint steps compared as a set (the reference's test asserts their
  order, which thread scheduling does not fix);
* the DAG: the reference's functions, plus ``ckpt.k`` an input of
  ``step.{k+1}`` (the in-place rule);
* reduced tinyllama under ``run_training``: the losses and checkpoints of
  ``train_loop`` bit for bit under both patterns (same ops on the same data
  in the same order, only on other threads), also when the save waits for
  the next step before it snapshots;
* what the port refuses: a straggler factor, a DScale budget.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.runtime.orchestrator import \
    OrchestratorConfig as RefOrchestratorConfig
from repro.runtime.orchestrator import \
    build_training_workflow as ref_build_training_workflow
from repro.runtime.orchestrator import run_training as ref_run_training
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import DFlowEngine, FunctionSpec, Workflow
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import setup_training, train_loop
from repro_torch.runtime.orchestrator import (OrchestratorConfig,
                                              build_training_workflow,
                                              run_training)

ARCH = "tinyllama-1.1b"
PACKAGES = {"repro": (RefOrchestratorConfig, ref_run_training),
            "repro_torch": (OrchestratorConfig, run_training)}


# ------------------------------------------- tests/test_runtime.py's cases
@pytest.mark.parametrize("package", list(PACKAGES))
def test_orchestrator_runs_training_dag(package):
    Config, run = PACKAGES[package]

    def fetch(i):
        return np.full((2, 2), i, np.float32)

    def train(state, batch):
        new_state = state + batch.sum()
        return new_state, {"loss": float(new_state)}

    saves = []
    cfg = Config(n_steps=4, ckpt_every=2, pattern="dataflow")
    rep = run(cfg, init_state=np.float32(0.0), fetch=fetch, train=train,
              save=lambda i, s: saves.append((i, s)))
    # final state = sum of batch sums 0+4+8+12
    assert rep.outputs["final_state"] == pytest.approx(24.0)
    assert sorted(saves) == [(1, 4.0), (3, 24.0)]
    assert len(rep.per_function) == 4 + 4 + 2 + 1  # fetch + step + ckpt + emit


@pytest.mark.parametrize("package", list(PACKAGES))
def test_orchestrator_dataflow_overlaps_fetch(package):
    """With a slow transport, dataflow (prefetch overlap) beats
    controlflow."""
    Config, run = PACKAGES[package]

    def fetch(i):
        time.sleep(0.05)
        return np.ones((64, 64), np.float32)   # 16 KB payload

    def train(state, batch):
        time.sleep(0.05)
        return state + float(batch.mean()), {}

    times = {}
    for pattern in ("dataflow", "controlflow"):
        cfg = Config(n_steps=5, pattern=pattern, transport_bandwidth=2e6)
        t0 = time.monotonic()
        rep = run(cfg, init_state=np.float32(0.0), fetch=fetch, train=train)
        times[pattern] = time.monotonic() - t0
        assert rep.outputs["final_state"] == pytest.approx(5.0)
    # dataflow must not be slower; usually clearly faster.
    assert times["dataflow"] <= times["controlflow"] * 1.1


# ------------------------------------------------------------------ the DAG
@pytest.mark.parametrize("n_steps,ckpt_every", [(4, 2), (5, 2), (3, 1),
                                                (4, 0), (1, 1)])
def test_the_dag_is_the_reference_plus_the_checkpoint_edges(n_steps,
                                                            ckpt_every):
    kw = dict(fetch=lambda i: i, train=lambda s, b: (s, {}),
              save=lambda i, s: None, ckpt_every=ckpt_every)
    ref = ref_build_training_workflow(n_steps, **kw)
    ours = build_training_workflow(n_steps, **kw)
    assert list(ours.functions) == list(ref.functions)
    ckpts = [i for i in range(n_steps) if ckpt_every
             and (i + 1) % ckpt_every == 0]
    for name, f in ours.functions.items():
        want = ref.functions[name].inputs
        if name.startswith("step.") and int(name[5:]) - 1 in ckpts:
            want = want + (f"ckpt.{int(name[5:]) - 1}",)
        assert f.inputs == want, name
        assert f.outputs == ref.functions[name].outputs, name
    for i in ckpts:
        after = ("step.%d" % (i + 1),) if i + 1 < n_steps else ()
        assert tuple(ours.successors[f"ckpt.{i}"]) == after


def test_without_a_save_the_dag_is_the_reference():
    kw = dict(fetch=lambda i: i, train=lambda s, b: (s, {}), ckpt_every=2)
    ref = ref_build_training_workflow(4, **kw)
    ours = build_training_workflow(4, **kw)
    assert {n: (f.inputs, f.outputs) for n, f in ours.functions.items()} == \
           {n: (f.inputs, f.outputs) for n, f in ref.functions.items()}


# ------------------------------------------------- reduced tinyllama, CPU
KW = dict(steps=4, batch=2, seq=32, reduced=True, seed=3, device="cpu")


def _orchestrated(pattern: str, *, steps: int = 4, ckpt_dir=None,
                  ckpt_every: int = 0, save=None, wrap_train=None,
                  run=run_training, config=OrchestratorConfig):
    """``train_loop``'s job under ``run_training``: its set-up, its step, the
    pipeline's source moved to the device as the fetch, its checkpoint
    manager's save (``train_loop`` saves after step i as step i + 1)."""
    s = setup_training(ARCH, **{**KW, "steps": steps})
    source = SyntheticLM(s.data)

    def fetch(i):
        return {k: torch.as_tensor(v).to(s.device)
                for k, v in source.batch_at(i).items()}

    mgr = None
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir, keep=2, async_save=True)
        save = save or (lambda i, state: mgr.save(i + 1, state))
    train = wrap_train(s.step_fn) if wrap_train else s.step_fn
    rep = run(config(n_steps=steps, ckpt_every=ckpt_every, pattern=pattern),
              init_state=s.state, fetch=fetch, train=train, save=save)
    if mgr is not None:
        mgr.wait()
    return [float(rep.outputs[f"metrics.{i}"]["loss"])
            for i in range(steps)], rep, mgr


def _leaves(directory, step: int) -> dict:
    d = directory / f"step_{step:08d}"
    return {p.stem: np.load(p) for p in sorted(d.glob("*.npy"))}


def _same_checkpoints(a, b, steps) -> bool:
    for step in steps:
        la, lb = _leaves(a, step), _leaves(b, step)
        assert la and set(la) == set(lb)
        if not all(np.array_equal(la[k], lb[k]) for k in la):
            return False
    return True


@pytest.fixture(scope="module")
def loop_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    out = train_loop(ARCH, ckpt_dir=str(d), ckpt_every=2, log_every=0, **KW)
    return out["losses"], d


@pytest.mark.parametrize("pattern", ["dataflow", "controlflow"])
def test_run_training_gives_train_loops_losses_bit_for_bit(pattern,
                                                          loop_run):
    losses, _ = _orchestrated(pattern)[:2]
    assert losses == loop_run[0]


@pytest.mark.parametrize("pattern", ["dataflow", "controlflow"])
def test_run_training_saves_train_loops_checkpoints_bit_for_bit(
        pattern, loop_run, tmp_path):
    losses, rep, _ = _orchestrated(pattern, ckpt_dir=tmp_path, ckpt_every=2)
    assert losses == loop_run[0]
    assert _same_checkpoints(tmp_path, loop_run[1], (2, 4))
    assert "ckpt.3" in rep.outputs and "ckpt.1" not in rep.outputs


def test_the_reference_engine_runs_the_port_step_to_the_same_losses(
        loop_run):
    """Without checkpoints the reference's orchestrator, on the port's
    train step, takes the same steps."""
    losses = _orchestrated("dataflow", run=ref_run_training,
                           config=RefOrchestratorConfig)[0]
    assert losses == loop_run[0]


def _saving_late(tmp_path, wait_s: float):
    """A ``save`` that waits (up to ``wait_s``) until the next step has run
    before it snapshots, and a train wrapper that says when a step has."""
    finished = [threading.Event() for _ in range(KW["steps"] + 1)]
    calls = []
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    waited = []

    def wrap(step_fn):
        def train(state, batch):
            i = len(calls)
            calls.append(i)
            out = step_fn(state, batch)
            finished[i].set()
            return out
        return train

    def save(i, state):
        waited.append(finished[i + 1].wait(wait_s))
        mgr.save(i + 1, state)
    return wrap, save, mgr, waited


@pytest.mark.parametrize("pattern", ["dataflow", "controlflow"])
def test_a_save_that_waits_for_the_next_step_still_saves_its_own(
        pattern, loop_run, tmp_path):
    """The race of the in-place rule: ``ckpt.k`` holds off its snapshot
    until ``step.{k+1}`` has run, if anything lets it run. Nothing does, so
    every wait times out and the checkpoints are ``train_loop``'s."""
    wrap, save, mgr, waited = _saving_late(tmp_path, wait_s=1.0)
    losses, _, _ = _orchestrated(pattern, ckpt_every=2, save=save,
                                 wrap_train=wrap)
    mgr.wait()
    assert losses == loop_run[0]
    assert _same_checkpoints(tmp_path, loop_run[1], (2, 4))
    assert waited == [False, False]


def test_grad_mode_follows_the_caller():
    """Each DAG function runs on a thread of its own; ``train`` sees the
    grad mode of the thread that called ``run_training``."""
    seen = []

    def train(state, batch):
        seen.append(torch.is_grad_enabled())
        return state + 1, {}

    cfg = OrchestratorConfig(n_steps=2)
    run_training(cfg, init_state=0, fetch=lambda i: i, train=train)
    with torch.no_grad():
        run_training(cfg, init_state=0, fetch=lambda i: i, train=train)
    assert seen == [True, True, False, False]


# ------------------------------------------------------- what is refused
def test_a_straggler_factor_is_refused():
    with pytest.raises(ValueError, match="AdamW twice"):
        run_training(OrchestratorConfig(n_steps=2, straggler_factor=3.0),
                     init_state=0, fetch=lambda i: i,
                     train=lambda s, b: (s + 1, {}))


def test_the_engines_straggler_path_stays_for_pure_functions():
    calls = []

    def slow_once():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(1.0)
        return {"v": 7}

    wf = Workflow("strag", [
        FunctionSpec("s", outputs=("v",), fn=slow_once, exec_time=0.02),
        FunctionSpec("use", inputs=("v",), outputs=("y",),
                     fn=lambda v: {"y": v * 2}, exec_time=0.01)])
    rep = DFlowEngine(n_nodes=2, straggler_factor=3.0).run(wf)
    assert rep.outputs["y"] == 14 and len(calls) >= 2


def test_a_prewarm_budget_is_refused():
    wf = Workflow("w", [FunctionSpec("f", outputs=("y",),
                                     fn=lambda: {"y": 1})])
    with pytest.raises(NotImplementedError, match="A.15"):
        DFlowEngine(n_nodes=1).start(wf, budget=object())
