"""AdamW with global-norm clipping and a warmup-cosine schedule.

Port of ``repro/optim/adamw.py``: stateless functions over explicit trees
(nested dicts of tensors), fp32 moments by default, bias correction, no
weight decay on norms / biases / 1-d scales, parameters updated in fp32 and
cast back to their dtype (no fp32 master copy, as in the reference).

Two differences, both for memory on the card:

* ``adamw_update`` writes the new parameters and moments into the tensors it
  is given and returns them (the reference's train step donates its state,
  so XLA updates in place too); each leaf's fp32 temporaries live only while
  that leaf is updated;
* the step count is a 0-d int32 tensor on the parameters' device, so the
  schedule and the bias correction never wait for the host.

Gradient compression (``optim/compress.py``) comes with multi-device
training (ROADMAP A.12).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..models.param import tree_items, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "warmup_cosine"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    state_dtype: torch.dtype = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor        # () int32, on the parameters' device
    m: Any
    v: Any


def warmup_cosine(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% of peak (fp32)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    total = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / total, 0.0, 1.0)
    cos = 0.1 + 0.9 * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (each leaf's norm
    is taken in fp32 without an fp32 copy of the leaf)."""
    return torch.sqrt(sum(torch.square(torch.linalg.vector_norm(
        g, dtype=torch.float32)) for g in leaves))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in fp32; the
    global norm before clipping)."""
    gn = global_norm(leaf for _, leaf in tree_items(grads))
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def adamw_init(params, cfg: AdamWConfig) -> OptState:
    leaves = [leaf for _, leaf in tree_items(params)]
    device = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _no_decay(path: tuple) -> bool:
    """No weight decay on norms / biases / 1-d scales (the reference's
    substring rule on the last path key)."""
    last = str(path[-1]) if path else ""
    return any(k in last for k in ("norm", "ln", "bias", "dt_bias",
                                   "A_log", "D"))


def adamw_update(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW step, written into ``params`` and the moments of ``state``
    in place; returns (params, new state, metrics) with the same tensors."""
    p_items = tree_items(params)
    g_leaves = [g for _, g in tree_items(grads)]
    m_leaves = [m for _, m in tree_items(state.m)]
    v_leaves = [v for _, v in tree_items(state.v)]
    gn = global_norm(g_leaves)
    scale = _clip_scale(gn, cfg.clip_norm)
    step = state.step + 1
    lr = warmup_cosine(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    with torch.no_grad():
        for (path, p), g, m, v in zip(p_items, g_leaves, m_leaves, v_leaves):
            # op for op as the reference, each op rounded to fp32
            g32 = g.float() * scale
            m32 = m.float() * b1 + g32 * (1 - b1)
            v32 = v.float() * b2 + torch.square(g32) * (1 - b2)
            upd = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
            if cfg.weight_decay and not _no_decay(path):
                upd = upd + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * upd)
            m.copy_(m32)
            v.copy_(v32)
    return params, OptState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gn, "lr": lr}
