"""Train step: microbatched gradient accumulation + AdamW, on one device.

Port of ``repro/runtime/train_lib.py``. ``train_step(state, batch)`` takes
the loss and its gradient by autograd through ``model.loss_fn`` (the
attention forward and backward run the hand-written CUDA kernels on the
card), accumulates microbatch gradients in fp32, averages loss and gradients
over the microbatches, and applies ``adamw_update``. The step writes the
new parameters and moments into the state's tensors (the reference donates
its state to XLA, which updates it in place as well).

Meshes, ``make_train_state_specs``, ``batch_sharding`` and ZeRO shard the
reference's state over many devices; they come with multi-device training
(ROADMAP A.12).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..models.param import init_params, tree_items, tree_map
from ..optim.adamw import AdamWConfig, OptState, adamw_init, adamw_update

__all__ = ["TrainState", "build_train_step", "init_train_state"]


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(model, opt_cfg: AdamWConfig, seed: int = 0,
                     device: str | torch.device = "cuda") -> TrainState:
    """Seeded random parameters (drawn on ``device``) and a zero optimizer
    state."""
    device = torch.device(device)
    params = init_params(model.param_decls(),
                         torch.Generator(device=device).manual_seed(seed),
                         device)
    return TrainState(params, adamw_init(params, opt_cfg))


def _loss_and_grads(model, params, batch):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.loss_fn(leaves, batch)
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, leaves)


def build_train_step(model, opt_cfg: AdamWConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics hold
    ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the device. Batch
    leaves lead with the global batch, divisible by ``cfg.microbatches``."""
    mu = max(model.cfg.microbatches, 1)

    def train_step(state: TrainState, batch):
        params = state.params
        if mu == 1:
            loss, grads = _loss_and_grads(model, params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % mu:
                raise ValueError(f"batch {B} is not divisible by "
                                 f"{mu} microbatches")
            loss, grads = 0.0, None
            for i in range(mu):
                mb = {k: x[i * (B // mu):(i + 1) * (B // mu)]
                      for k, x in batch.items()}
                l, g = _loss_and_grads(model, params, mb)
                loss = loss + l
                if grads is None:
                    grads = tree_map(lambda t: t.float(), g)
                else:
                    for (_, acc), (_, t) in zip(tree_items(grads),
                                                tree_items(g)):
                        acc.add_(t.float())
            loss = loss / mu
            grads = tree_map(lambda t: t / mu, grads)
        params, opt, metrics = adamw_update(params, grads, state.opt,
                                            opt_cfg)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step
