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

__all__ = ["TrainState", "build_train_step", "init_train_state",
           "split_microbatches"]


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


def split_microbatches(batch: dict, mu: int) -> list[dict]:
    """``batch`` cut into ``mu`` microbatches of consecutive rows. B is
    read from ``tokens``; a ``mrope_positions`` leaf, (3, B, S), is cut on
    axis 1 and every other leaf on axis 0 (``tokens``, ``mask``, the
    encoder-decoder's ``frames`` (B, T, d_model)), as the reference's
    reshape (``repro/runtime/train_lib.py:98-103``) cuts them.

    One deliberate departure: the reference tells the positions apart by
    a leading axis of 3, so it would cut a token batch of B = 3 on its
    second axis; this split goes by the leaf's name. The two agree at
    every B other than 3."""
    B = batch["tokens"].shape[0]
    if B % mu:
        raise ValueError(f"batch {B} is not divisible by {mu} microbatches")
    n = B // mu
    return [{k: x[:, i * n:(i + 1) * n] if k == "mrope_positions"
             else x[i * n:(i + 1) * n] for k, x in batch.items()}
            for i in range(mu)]


def build_train_step(model, opt_cfg: AdamWConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics hold
    ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the device. The
    global batch, divisible by ``cfg.microbatches``, is split by
    :func:`split_microbatches`."""
    mu = max(model.cfg.microbatches, 1)

    def train_step(state: TrainState, batch):
        params = state.params
        if mu == 1:
            loss, grads = _loss_and_grads(model, params, batch)
        else:
            loss, grads = 0.0, None
            for mb in split_microbatches(batch, mu):
                l, g = _loss_and_grads(model, params, mb)
                loss = loss + l
                if grads is None:
                    grads = tree_map(lambda t: t.float(), g)
                else:
                    for (_, acc), (_, t) in zip(tree_items(grads),
                                                tree_items(g)):
                        acc.add_(t.float())
            loss = loss / mu
            for _, acc in tree_items(grads):    # in place: no second tree
                acc.div_(mu)
        params, opt, metrics = adamw_update(params, grads, state.opt,
                                            opt_cfg)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step
