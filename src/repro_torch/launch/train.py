"""Training driver: ``python -m repro_torch.launch.train --arch <id> ...``

Port of ``repro/launch/train.py::train_loop``: the synthetic data pipeline
with background prefetch, the train step (loss, gradients through the
hand-written kernels on the card: flash attention for the dense archs, the
SSD scan for mamba2, each forward with its backward kernel; AdamW),
checkpoints and restart. It runs on the card (``device="cuda"``, full width
and depth) unless the caller asks for the CPU, where it takes the kernels'
plain versions; without CUDA and without ``device="cpu"`` it raises.

On one card it trains what fits: the parameters, their gradients and
AdamW's two fp32 moments take ~12 bytes a parameter, ~190 GB for a 15 B
arch (starcoder2-15b, nemotron-4-15b, qwen3-14b), so a full-depth run of
one on a single card raises ``ValueError``; a cut depth of them trains.
Every family but the encoder-decoder also trains through it over a
(data, model) mesh (``data=``, ``model=``; every rank of a live process
group calls :func:`train_loop`): each rank holds its shards of the state
and its rows of each global microbatch, and the refusal counts those
shards; its checkpoints are the reference's full arrays, gathered from the
shards and written by one rank, and a resume cuts them to each rank's
shards again (``checkpoint/ckpt.py``), so a run may resume on another
mesh. ZeRO-3 (each rank's regions of the state, gathered a unit at a
time) is ``runtime/train_lib.py``'s ``build_train_step(..., mesh=,
zero3=True)``; this loop runs without it. qwen2-vl-72b (872 GB of state at its
80 layers; at 1 layer, 40 GB) trains as the reference's ``train_loop``
trains it: on the synthetic tokens alone, so its attention takes the 1-D
RoPE (``loss_fn`` reads ``vision_embeds`` and ``mrope_positions`` when a
batch carries them). jamba-1.5-large-398b does not train on one card at
any depth: one MoE sublayer alone is 9.66 B parameters, 116 GB of state,
so ``train_loop`` on one card raises ``ValueError`` naming A.12 (4.77 TB
at its 72 layers, 276 GB for one period-4 super-block); over a mesh each
rank's shards of it are counted instead, and its reduced config trains
there (and on the CPU).

The encoder-decoder (seamless-m4t-large-v2, 1.63 B parameters, ~20 GB of
training state at full depth) trains as the reference trains it: not
through ``train_loop``, which refuses the family as the reference's does,
but through :func:`setup_training`'s ``step_fn`` (``build_train_step``)
on the ``{'frames', 'tokens'}`` batch of :func:`batch_at`, keyed by step:
the tokens of ``SyntheticLM``, and ``FRAMES_LEN`` seeded random frame
embeddings a sequence (16 with ``reduced=True``), as ``launch/serve.py``
draws them for a prompt. ``setup_training(..., mesh=)`` gives a rank's
step of it over a mesh, which takes the whole batch of :func:`batch_at`
and cuts its rows of ``frames`` with its tokens.

Fault tolerance: ``--simulate-failure K`` raises after step K; rerunning
the same command with ``--resume`` resumes from the last complete
checkpoint and reproduces the loss trajectory (the data pipeline is keyed
by step).

The same job runs under the DFlow engine through
:func:`repro_torch.runtime.orchestrator.run_training` (the reference's
entry point is ``repro.runtime.orchestrator.run_training``; its
``train_loop`` has no orchestrated mode). :func:`setup_training` gives both
one set-up: compose ``run_training`` with its ``step_fn``, its ``state``,
``SyntheticLM(setup.data).batch_at(i)`` moved to ``setup.device`` as the
fetch and ``CheckpointManager.save`` as the save, and the run takes
``train_loop``'s steps on ``train_loop``'s data.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, list_archs
from repro_torch.data import DataConfig, SyntheticLM, make_pipeline
from repro_torch.kernels import _build
from repro_torch.launch import resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import FRAMES_LEN
from repro_torch.models import build_model
from repro_torch.models.param import tree_at, tree_items
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import (TrainState, build_train_step,
                                 init_train_state, make_train_state_specs)
from repro_torch.sharding.rules import local_shape

__all__ = ["TrainSetup", "batch_at", "main", "setup_training",
           "train_loop"]


def _state_bytes(model, opt_cfg: AdamWConfig, mesh=None) -> int:
    """Bytes of a training state: each parameter, its gradient (both in the
    parameter's dtype) and AdamW's two moments; with more than one
    microbatch also the step's fp32 gradient accumulator. With ``mesh``,
    this rank's shards of them (``make_train_state_specs``)."""
    moment = torch.empty((), dtype=opt_cfg.state_dtype).element_size()
    accumulator = 4 if model.cfg.microbatches > 1 else 0
    specs = None if mesh is None else make_train_state_specs(model,
                                                             mesh).params
    total = 0
    for path, d in tree_items(model.param_decls()):
        n = d.size if specs is None else math.prod(
            local_shape(tree_at(specs, path), d.shape, mesh))
        total += n * (2 * torch.empty((), dtype=d.dtype).element_size()
                      + 2 * moment + accumulator)
    return total


class TrainSetup(NamedTuple):
    """One training job, as :func:`train_loop` sets it up."""
    model: Any
    opt_cfg: AdamWConfig
    step_fn: Callable
    state: TrainState
    data: DataConfig
    device: torch.device
    frames_len: int = 0      # the encoder's frames a sequence (encdec)


def setup_training(arch: str, *, steps: int, batch: int, seq: int,
                   reduced: bool = False, seed: int = 0,
                   microbatches: int | None = None,
                   device: str | torch.device = "cuda",
                   mesh=None) -> TrainSetup:
    """The model of ``arch`` for ``seq``-token sequences, AdamW scheduled
    over ``steps`` steps, the train step, the seeded initial state on
    ``device`` and the data config of ``batch`` x ``seq`` tokens (for the
    encoder-decoder also ``frames_len``, the frames a sequence:
    ``FRAMES_LEN``, 16 reduced). On the card it first refuses a state
    larger than the card and builds the kernels, so no kernel builds inside
    a step. With ``mesh`` (a live mesh; every family), this rank's step
    and shards of the state (``build_train_step(..., mesh=)``), the
    refusal counting those shards."""
    device = resolve_device(device, "train_loop")
    cfg = get_config(arch, reduced=reduced)
    cfg = dataclasses.replace(cfg, q_chunk=max(seq // 2, 16),
                              kv_chunk=max(seq // 2, 16),
                              microbatches=microbatches or 1)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=max(steps // 10, 1),
                          total_steps=steps)
    step_fn = build_train_step(model, opt_cfg, mesh=mesh)
    if device.type == "cuda":
        need = _state_bytes(model, opt_cfg, mesh)
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            acc = " with the microbatches' fp32 gradient accumulator" \
                if cfg.microbatches > 1 else ""
            shards = " (this rank's shards)" if mesh is not None else ""
            raise ValueError(
                f"{cfg.name} at {cfg.n_layers} layers: its training state"
                f"{acc}{shards} takes {need / 1e9:.0f} GB, more than the "
                f"card's {have / 1e9:.0f} GB; training it needs more "
                f"devices (ROADMAP item A.12), or a cut depth")
        _build.build()               # set-up, outside the timed loop
    frames_len = 0
    if cfg.family == "encdec":
        frames_len = 16 if reduced else FRAMES_LEN
    return TrainSetup(
        model, opt_cfg, step_fn,
        init_train_state(model, opt_cfg, seed=seed, device=device,
                         mesh=mesh),
        DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                   seed=seed),
        device, frames_len)


def batch_at(setup: TrainSetup, step: int) -> dict:
    """The batch of step ``step`` on the set-up's device, a pure function of
    (seed, step): ``tokens`` (B, seq + 1) from ``SyntheticLM(setup.data)``
    and, for the encoder-decoder, ``frames`` (B, ``setup.frames_len``,
    d_model) bf16, standard normal draws of ``numpy.random.default_rng(
    (seed, step))`` (``launch/serve.py`` draws a prompt's frames alike)."""
    data = setup.data
    batch = {"tokens": torch.as_tensor(
        SyntheticLM(data).batch_at(step)["tokens"]).to(setup.device)}
    if setup.frames_len:
        rng = np.random.default_rng((data.seed, step))
        batch["frames"] = torch.as_tensor(rng.normal(size=(
            data.global_batch, setup.frames_len,
            setup.model.cfg.d_model))).to(torch.bfloat16).to(setup.device)
    return batch


def train_loop(arch: str, *, steps: int = 20, batch: int = 8, seq: int = 128,
               reduced: bool = False, ckpt_dir: str | None = None,
               ckpt_every: int = 0, resume: bool = False,
               simulate_failure: int | None = None, seed: int = 0,
               log_every: int = 1, microbatches: int | None = None,
               device: str | torch.device = "cuda", data: int = 1,
               model: int = 1) -> dict:
    """Train ``arch`` for ``steps`` steps of ``batch`` x ``seq`` tokens.

    With ``data * model > 1`` every rank of a live process group calls it
    (one rank a card under NCCL, or ranks that share one under gloo, each
    with its device set): the step runs over ``make_local_mesh(data,
    model)``, each rank on its rows of the pipeline's global batch and its
    shards of the state (every family but the encoder-decoder, on tokens
    alone as the reference's loop feeds them; the reference's signature).
    With no process group up it raises ``RuntimeError``, as
    ``make_local_mesh`` does. Its checkpoints (``ckpt_dir``, a directory
    every rank reads) hold the whole state in the one-device layout:
    each save gathers the shards and rank 0 writes them, and ``resume``
    cuts them to this mesh's shards, whatever mesh wrote them.

    Returns ``losses`` (one a step run, the global batch's), ``wall_s``,
    ``tokens_per_s`` (the global batch's tokens), ``final_loss`` and
    ``start_step`` (nonzero after a resume)."""
    cfg = get_config(arch, reduced=reduced)
    mesh = None
    if data * model > 1:
        mesh = make_local_mesh(data, model)
    if cfg.family == "encdec":
        # refused before anything is allocated, as the reference's
        # train_loop refuses this family
        raise SystemExit(
            f"{cfg.name}: train_loop does not train the encoder-decoder, "
            "as the reference's does not (ROADMAP item A.11, its "
            "training): train it through setup_training(...).step_fn, "
            "build_train_step's step, on batch_at(setup, i), the "
            "{'frames', 'tokens'} batch")
    setup = setup_training(arch, steps=steps, batch=batch, seq=seq,
                           reduced=reduced, seed=seed,
                           microbatches=microbatches, device=device,
                           mesh=mesh)
    device, step_fn, state = setup.device, setup.step_fn, setup.state
    on_card = device.type == "cuda"

    mgr = None
    start_step = 0
    if ckpt_dir:
        mgr = CheckpointManager(
            ckpt_dir, keep=2, async_save=True, mesh=mesh,
            specs=None if mesh is None else make_train_state_specs(
                setup.model, mesh))
        if resume and mgr.latest() is not None:
            state, start_step = mgr.restore(state)
            print(f"[train] resumed from step {start_step}")

    def clock() -> float:
        if on_card:
            torch.cuda.synchronize(device)
        return time.perf_counter()

    pipe = make_pipeline(setup.data, start_step=start_step)
    losses = []
    t0 = clock()
    try:
        for i in range(start_step, steps):
            step_idx, np_batch = pipe.next()
            if step_idx != i:
                raise RuntimeError(f"pipeline gave step {step_idx} at {i}")
            batch_dev = {k: torch.as_tensor(v).to(device)
                         for k, v in np_batch.items()}
            state, metrics = step_fn(state, batch_dev)
            loss = float(metrics["loss"])
            losses.append(loss)
            if log_every and i % log_every == 0:
                print(f"[train] step {i:4d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            if mgr and ckpt_every and (i + 1) % ckpt_every == 0:
                mgr.save(i + 1, state)
            if simulate_failure is not None and i + 1 == simulate_failure:
                raise RuntimeError(
                    f"simulated node failure at step {i + 1}")
    finally:
        pipe.close()
        if mgr:
            mgr.wait()
    wall = clock() - t0
    tokens = (steps - start_step) * batch * seq
    return {"losses": losses, "wall_s": wall,
            "tokens_per_s": tokens / max(wall, 1e-9),
            "final_loss": losses[-1] if losses else float("nan"),
            "start_step": start_step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list_archs(),
                    help="the 15 B archs (starcoder2-15b, nemotron-4-15b, "
                         "qwen3-14b) do not fit one card's memory at full "
                         "depth and raise there (ROADMAP A.12)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced (CPU-test) width of the arch")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train_loop(args.arch, steps=args.steps, batch=args.batch,
                     seq=args.seq, reduced=args.reduced,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     resume=args.resume,
                     simulate_failure=args.simulate_failure,
                     microbatches=args.microbatches, seed=args.seed,
                     device=args.device)
    print(f"[train] done: final_loss={out['final_loss']:.4f} "
          f"tokens/s={out['tokens_per_s']:.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
