"""DFlow-orchestrated training: the port's DFlow engine driving a torch job.

Port of ``repro/runtime/orchestrator.py``. The training job is a workflow
DAG executed by the threaded DFlow engine (:mod:`repro_torch.core`):

* ``fetch.i``   — data-pipeline fetch for step *i* (no precursors);
* ``step.i``    — train step: consumes ``state.{i-1}`` + ``batch.i``,
  produces ``state.i`` (+ ``metrics.i``);
* ``ckpt.k``    — checkpoint save consuming ``state.k``;
* ``emit``      — passes the last state on as ``final_state``.

Under the **dataflow** invocation pattern ``step.i`` is launched while
``step.{i-1}`` still runs and blocks on its inputs, and every fetch runs
ahead of its step; under **controlflow** (the ablation) a function is
launched only once its precursors have completed.

The port's train step writes the new parameters and moments into the
state's tensors (``runtime/train_lib.py``, ``optim/adamw.py``), so
``state.k`` and ``state.{k+1}`` are the same tensors, where the
reference's JAX arrays are immutable. Three rules follow:

1. **``ckpt.k`` saves exactly ``state.k``.** In the reference ``ckpt.k``
   and ``step.{k+1}`` both wait only on ``state.k``, so a snapshot could
   read parameters that ``step.{k+1}``'s AdamW has half rewritten. Here
   ``step.{k+1}`` also consumes the datum ``ckpt.k``: it starts once the
   save has returned. ``save`` must therefore hold its own copy of the
   state when it returns, as ``CheckpointManager.save`` does (a host
   snapshot taken before it returns, the files written on a thread). The
   price is that snapshot, on the critical path of every step after a
   checkpoint. An out-of-place step would remove it but keep every
   published ``state.i`` alive in DStore until the run ends (~11 GB a
   state for tinyllama-1.1b).
2. **No straggler duplicates.** A duplicate ``step.i`` would apply AdamW a
   second time to the same tensors, and nothing would notice: DStore's
   divergence check cannot see a CUDA tensor (``core/check.py``).
   :func:`run_training` raises :class:`ValueError` for a
   ``straggler_factor``; the engine's own straggler path stays, for pure
   functions.
3. **Build before running.** The caller builds the kernels first
   (``launch.train.setup_training`` does), so no ``nvcc`` runs inside a
   DAG thread against the engine's 120 s Get timeout.

Each function runs on a thread of its own, and grad mode and the current
CUDA stream are per thread: :func:`run_training` runs ``fetch``, ``train``
and ``save`` under the grad mode and CUDA stream of the thread that calls
it, so they are ordered on one stream as ``train_loop``'s steps are.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Any, Callable

import torch

from ..core.dag import FunctionSpec, Workflow
from ..core.dscheduler import DFlowEngine, RunReport
from ..core.dstore import Transport

__all__ = ["OrchestratorConfig", "build_training_workflow", "run_training"]


@dataclasses.dataclass(frozen=True)
class OrchestratorConfig:
    n_steps: int = 4
    ckpt_every: int = 0               # 0 = no checkpoints
    pattern: str = "dataflow"         # "dataflow" | "controlflow" ablation
    n_nodes: int = 2
    transport_bandwidth: float | None = None
    straggler_factor: float | None = None    # refused (rule 2)


def build_training_workflow(n_steps: int, *, fetch: Callable[[int], Any],
                            train: Callable[[Any, Any], tuple],
                            save: Callable[[int, Any], Any] | None = None,
                            ckpt_every: int = 0,
                            fetch_time: float = 0.05,
                            step_time: float = 0.2) -> Workflow:
    """The reference's DAG, with ``ckpt.{i-1}`` an input of ``step.i``
    wherever a checkpoint precedes it (rule 1). The function count is the
    reference's; ``ckpt.k`` is a sink output only where no step follows
    it."""
    ckpts = {i for i in range(n_steps) if save is not None and ckpt_every
             and (i + 1) % ckpt_every == 0}
    fns = []
    for i in range(n_steps):
        def mk_fetch(i=i):
            def f():
                return {f"batch.{i}": fetch(i)}
            return f

        fns.append(FunctionSpec(
            name=f"fetch.{i}", inputs=(), outputs=(f"batch.{i}",),
            fn=mk_fetch(), exec_time=fetch_time,
            output_sizes={f"batch.{i}": 4 << 20}))

        def mk_step(i=i):
            def f(**kw):
                state = kw[f"state.{i - 1}"] if i else kw["state.init"]
                batch = kw[f"batch.{i}"]
                new_state, metrics = train(state, batch)
                return {f"state.{i}": new_state, f"metrics.{i}": metrics}
            return f

        prev = f"state.{i - 1}" if i else "state.init"
        after = (f"ckpt.{i - 1}",) if i - 1 in ckpts else ()
        fns.append(FunctionSpec(
            name=f"step.{i}", inputs=(prev, f"batch.{i}", *after),
            outputs=(f"state.{i}", f"metrics.{i}"), fn=mk_step(),
            exec_time=step_time,
            output_sizes={f"state.{i}": 16 << 20,
                          f"metrics.{i}": 1 << 10}))

        if i in ckpts:
            def mk_save(i=i):
                def f(**kw):
                    return {f"ckpt.{i}": save(i, kw[f"state.{i}"])}
                return f
            fns.append(FunctionSpec(
                name=f"ckpt.{i}", inputs=(f"state.{i}",),
                outputs=(f"ckpt.{i}",), fn=mk_save(), exec_time=0.05,
                output_sizes={f"ckpt.{i}": 1 << 10}))

    last = f"state.{n_steps - 1}"
    fns.append(FunctionSpec(
        name="emit", inputs=(last,), outputs=("final_state",),
        fn=lambda **kw: {"final_state": kw[last]}, exec_time=0.0,
        output_sizes={"final_state": 16 << 20}))
    return Workflow("training", fns)


def _in_callers_context(fn: Callable) -> Callable:
    """``fn``, run on any thread under the calling thread's grad mode and,
    once CUDA is in use, its current CUDA stream."""
    grad = torch.is_grad_enabled()
    stream = (torch.cuda.current_stream() if torch.cuda.is_initialized()
              else None)

    def call(*args):
        with torch.set_grad_enabled(grad), (
                torch.cuda.stream(stream) if stream is not None
                else nullcontext()):
            return fn(*args)
    return call


def run_training(cfg: OrchestratorConfig, *, init_state: Any,
                 fetch: Callable[[int], Any],
                 train: Callable[[Any, Any], tuple],
                 save: Callable[[int, Any], Any] | None = None) -> RunReport:
    """Run ``cfg.n_steps`` steps of ``train`` on the DFlow engine.
    ``save(i, state)`` must hold its own copy of ``state`` when it returns
    (rule 1). The report's outputs hold ``metrics.i`` for every step and
    ``final_state``, which is the state itself: a caller that keeps the
    report keeps the state's tensors alive."""
    if cfg.straggler_factor:
        raise ValueError(
            "straggler_factor: a duplicate step would apply AdamW twice to "
            "the state's tensors, which the port's train step updates in "
            "place, and DStore cannot catch it (a CUDA tensor is opaque to "
            "its content digest)")
    wf = build_training_workflow(
        cfg.n_steps, fetch=_in_callers_context(fetch),
        train=_in_callers_context(train),
        save=_in_callers_context(save) if save is not None else None,
        ckpt_every=cfg.ckpt_every)
    transport = Transport(bandwidth=cfg.transport_bandwidth)
    engine = DFlowEngine(n_nodes=cfg.n_nodes, pattern=cfg.pattern,
                         transport=transport)
    return engine.run(wf, {"state.init": init_state})
