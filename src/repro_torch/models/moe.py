"""Mixture-of-Experts FFN: port of ``repro/models/moe.py``.

The reference shards the experts over the ``model`` mesh axis inside a
``shard_map`` and sums the ranks' outputs with a ``psum``. Here a call
without ``shard`` is the reference's ``n_model = 1``: every expert on the
one device, no collective. With ``shard`` (a ``sharding.layout.
ShardLayout``, one rank of a (data, model) mesh, ``runtime/serve_lib.py``'s
steps) the rank serves the experts ``shard.experts`` and the shared
experts' hidden units ``shard.shared``, over this data shard's rows, as the
reference's ``_moe_local``: every other rank's expert is its drop row, the
capacity comes from the rank's own tokens, and its fp32 output is summed
over the model axis by one all_reduce. What the layer computes is the
reference's:

* routing: fp32 router logits, softmax, top-k (the lower expert first among
  equal probabilities, as ``jax.lax.top_k``), gates renormalised with a
  ``1e-9`` floor, and the GShard load-balance aux loss; on a rank, over its
  rows with the replicated router (the reference routes outside its
  ``shard_map``). Serving's aux loss is over the rank's rows, which no
  one reads; a training layout's is the reference's, over the global
  microbatch: the per-expert sums of the probabilities and of the top-1
  choices summed over the batch ranks in one fp32 all_reduce
  (``ShardLayout.batch_sum``);
* capacity ``C = max(ceil(T·k/E · capacity_factor), 4)`` from the T of the
  call (a rank's: its data shard's tokens, with the global E); a stable
  sort ranks each (token, k) choice within its expert in arrival order, and
  choices ranked at C or later are dropped;
* dispatch into an ``(E_local, C, M)`` buffer in the activations' dtype, by
  ``cfg.moe_dispatch``: "scatter" writes each kept (token, k) row into its
  slot; "gather" builds the slot -> (token, k) map once and gathers the
  buffer's rows;
* the expert products (plain ``torch.matmul``, as the reference leaves them
  to XLA), then the combine in fp32 weighted by the gates, shared experts
  added, and the output cast back to the activations' dtype (on a rank,
  after the sum over the model axis).

Under grad on a rank (training) the tokens and the gates enter the
expert-parallel region through ``ShardLayout.enter``: a rank's dispatch,
shared experts and combine read its own experts' and hidden units' part,
so the gradients of the tokens and of the gates are parts, summed over the
model axis in one all_reduce, while the router's own backward (the
softmax, the aux loss) runs whole and alike on every rank, where the
reference leaves it to XLA outside its ``shard_map``.

Nothing on the path reads a value on the host (no boolean-mask indexing,
``nonzero`` or ``.item()``): every shape follows from the input's, so a
call can be captured in a CUDA graph. Both combines sum each token's k
contributions in a fixed order, with no atomics, so two forward calls on
the same input give the same bits. The backward is another matter: the
gathers ``t[tok]``, ``t[grid // k]``, ``out_buf[eid, slot]`` and
``rows[slot_of[:, j]]`` differentiate into accumulating index writes,
which CUDA runs with atomic adds, so on the card the gradients of x and
of the expert products' inputs are not bit-reproducible from run to run.
"""

from __future__ import annotations

import math

import torch

from .common import ACTIVATIONS, matmul
from .config import ModelConfig
from .param import ArrayDecl, normal_init

__all__ = ["moe_decls", "moe"]


def moe_decls(cfg: ModelConfig, layers: int | None = None) -> dict:
    M, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    decls = {
        "router": ArrayDecl(lead + (M, E), lax_ + ("embed", None),
                            init=normal_init(0.02), dtype=torch.float32),
        "w_up": ArrayDecl(lead + (E, M, F),
                          lax_ + ("experts", "embed", "expert_mlp")),
        "w_down": ArrayDecl(lead + (E, F, M),
                            lax_ + ("experts", "expert_mlp", "embed")),
    }
    if cfg.glu:
        decls["w_gate"] = ArrayDecl(lead + (E, M, F),
                                    lax_ + ("experts", "embed", "expert_mlp"))
    if cfg.n_shared_experts:
        Fs = F * cfg.n_shared_experts
        decls["shared_up"] = ArrayDecl(lead + (M, Fs), lax_ + ("embed", "mlp"))
        decls["shared_gate"] = ArrayDecl(lead + (M, Fs),
                                         lax_ + ("embed", "mlp"))
        decls["shared_down"] = ArrayDecl(lead + (Fs, M),
                                         lax_ + ("mlp", "embed"))
    return decls


def _capacity(tokens: int, k: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(tokens * k / n_experts * factor))
    return max(c, 4)


def _router_probs(router: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, M) -> the softmax (T, E) of the fp32 router logits."""
    logits = matmul(x.float().reshape(-1, x.shape[-1]), router)   # (T, E)
    # jax.nn.softmax, op for op
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


def _gates_and_aux(probs: torch.Tensor, topi: torch.Tensor,
                   cfg: ModelConfig, shard=None):
    """The chosen experts' probabilities renormalised into gates (T, k)
    fp32, and the GShard load-balance aux () fp32. With a training
    ``shard``, the aux over every batch rank's tokens of the microbatch
    (:func:`_global_means`)."""
    topv = probs.gather(1, topi)
    gates = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-9)
    # importance x top-1 load over the tokens
    experts = torch.arange(cfg.n_experts, device=probs.device)
    top1 = (topi[:, :1] == experts).float()
    if shard is not None and shard.training and shard.batch_ranks > 1:
        me, ce = _global_means(probs, top1, shard)
    else:
        me, ce = probs.mean(dim=0), top1.mean(dim=0)
    return gates, cfg.n_experts * torch.sum(me * ce)


def _global_means(probs: torch.Tensor, top1: torch.Tensor, shard):
    """The means over the global microbatch of the probabilities and of
    the top-1 one-hot (E,) fp32: each rank's per-expert sums over its own
    tokens, summed over the batch ranks in one all_reduce, over every
    rank's tokens (each rank holds as many)."""
    sums = shard.batch_sum(torch.stack([probs.sum(dim=0), top1.sum(dim=0)]))
    me, ce = sums / (probs.shape[0] * shard.batch_ranks)
    return me, ce


def _route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
           shard=None):
    """x (B, S, M) -> topi (T, k) int64, gates (T, k) fp32, aux () fp32;
    ``shard`` reaches the aux loss (:func:`_gates_and_aux`)."""
    probs = _router_probs(router, x)
    # jax.lax.top_k puts the lower index first among equal values; a
    # stable descending sort does too, where torch.topk promises no order
    topi = torch.sort(probs.detach(), dim=-1, descending=True,
                      stable=True)[1][:, :cfg.top_k]
    gates, aux = _gates_and_aux(probs, topi, cfg, shard)
    return topi, gates, aux


def _rank(topi: torch.Tensor, n_experts: int):
    """Arrival-order rank of each (token, k) choice within its expert;
    ``topi`` holds ids in [0, n_experts], ``n_experts`` the drop row of
    another rank's experts. Returns ``order`` (the stable sort of the flat
    (T·k,) expert ids), ``sorted_eid`` and ``pos_sorted``, the rank of each
    sorted entry."""
    eid = topi.reshape(-1)
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    starts = torch.searchsorted(
        sorted_eid, torch.arange(n_experts + 1, device=eid.device))
    pos_sorted = torch.arange(eid.numel(), device=eid.device) \
        - starts[sorted_eid]
    return order, sorted_eid, pos_sorted


def _slots(topi: torch.Tensor, n_experts: int, C: int):
    """Scatter mode's plan: for each flat (token, k) choice in arrival
    order, whether it is kept (within capacity, and not in the drop row)
    and its slot in its expert (C, the trash slot, when not)."""
    order, _, pos_sorted = _rank(topi, n_experts)
    pos = torch.empty_like(pos_sorted).index_put_((order,), pos_sorted)
    keep = (pos < C) & (topi.reshape(-1) < n_experts)
    return keep, torch.where(keep, pos, C)


def _slot_map(topi: torch.Tensor, n_experts: int, C: int):
    """Gather mode's plan: ``grid`` (E, C), the flat (token, k) index each
    slot holds, ``valid`` (E, C), whether it holds one, and ``slot_of``
    (T·k,), the flat slot ``e * C + c`` each kept choice lands in (E·C,
    past the last slot, when dropped or in the drop row E)."""
    order, sorted_eid, pos_sorted = _rank(topi, n_experts)
    kept = (pos_sorted < C) & (sorted_eid < n_experts)
    Cp1 = C + 1
    flat = sorted_eid * Cp1 + torch.clamp(pos_sorted, max=C)
    # the kept entries' slots are distinct; every dropped entry lands on
    # its expert's trash slot C or in the drop row, which the slices cut
    # away, so which of them a duplicate write leaves there never matters
    n_flat = (n_experts + 1) * Cp1
    grid = torch.zeros(n_flat, dtype=order.dtype, device=order.device) \
        .index_put_((flat,), order)
    valid = torch.zeros(n_flat, dtype=torch.bool, device=order.device) \
        .index_put_((flat,), kept)
    grid = grid.reshape(n_experts + 1, Cp1)[:n_experts, :C]
    valid = valid.reshape(n_experts + 1, Cp1)[:n_experts, :C]
    # the inverse map; ``order`` is a permutation, so each entry is
    # written once
    slot_of = torch.empty_like(order).index_put_(
        (order,), torch.where(kept, sorted_eid * C + pos_sorted,
                              n_experts * C))
    return grid, valid, slot_of


def _experts(buf: torch.Tensor, w_gate, w_up, w_down, act) -> torch.Tensor:
    """(E, C, M) -> (E, C, M): each expert's MLP on its C rows."""
    up = matmul(buf, w_up)
    if w_gate is not None:
        h = act(matmul(buf, w_gate)) * up
    else:
        h = act(up)
    return matmul(h, w_down)


def _dispatch(t: torch.Tensor, lid: torch.Tensor, n_local: int, C: int,
              cfg: ModelConfig):
    """t (T, M), routing ``lid`` (T, k) in this device's expert ids (the
    drop row ``n_local`` for another rank's) -> the (n_local, C, M) buffer
    in t's dtype and the plan ``_combine`` reads."""
    k = cfg.top_k
    if cfg.moe_dispatch == "gather":
        grid, valid, slot_of = _slot_map(lid, n_local, C)
        return torch.where(valid[..., None], t[grid // k], 0), (slot_of,)
    keep, slot = _slots(lid, n_local, C)
    eid = torch.where(keep, lid.reshape(-1), 0)
    tok = torch.arange(lid.numel(), device=t.device) // k
    x_rep = torch.where(keep[:, None], t[tok], 0)
    # the reference adds each kept row into a zero buffer; the kept slots
    # are distinct and every dropped row (zeros) goes to expert 0's trash
    # slot C, so a plain write gives the same bits without atomics
    buf = torch.zeros((n_local, C + 1, t.shape[1]), dtype=t.dtype,
                      device=t.device).index_put_((eid, slot), x_rep)
    return buf[:, :C], (keep, slot, eid)


def _combine(out_buf: torch.Tensor, plan, gates: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The experts' rows (E, C, M) back to their tokens, weighted by the
    gates: (T, M) fp32."""
    E, C, M = out_buf.shape
    T, k = gates.shape
    if cfg.moe_dispatch == "gather":
        # the reference scatter-adds the slots' weighted rows into y; here
        # each token gathers its k rows through the inverse map and sums
        # them in k order, keeping only (T, M) tensors and a fixed order
        slot_of = plan[0].reshape(T, k)
        rows = torch.cat([out_buf.reshape(E * C, M),
                          out_buf.new_zeros((1, M))])
        w = torch.where(slot_of < E * C, gates, 0.0).float()
        y = torch.zeros((T, M), dtype=torch.float32, device=out_buf.device)
        for j in range(k):
            y = y + rows[slot_of[:, j]].float() * w[:, j, None]
        return y
    keep, slot, eid = plan
    out_buf = torch.cat([out_buf, out_buf.new_zeros((E, 1, M))], dim=1)
    y_tk = out_buf[eid, slot] * keep[:, None]                # (T·k, M)
    w = (gates.reshape(-1) * keep).float()
    return (y_tk.float() * w[:, None]).reshape(T, k, M).sum(dim=1)


def _moe_local(x, topi, gates, w_gate, w_up, w_down, shared, *,
               cfg: ModelConfig, shard=None) -> torch.Tensor:
    """The reference's per-device block: x (B, S, M), routing (T, k) ->
    y (B, S, M) in x's dtype. Without ``shard`` every expert is on this
    device; with it the weights are this rank's experts ``shard.experts``
    (and its columns of ``shared_gate``/``shared_up``, rows of
    ``shared_down``), the choices of other ranks' experts go to the drop
    row, and the fp32 output is summed over the model axis before the
    cast; the tokens and the gates enter the region through
    ``shard.enter``."""
    B, S, M = x.shape
    act = ACTIVATIONS[cfg.activation]
    t = x.reshape(B * S, M)
    if shard is not None:
        t, gates = shard.enter(t, gates)
    # capacity a (local) expert: expected load T·k/E tokens from this data
    # shard's rows, padded by the capacity factor
    C = _capacity(B * S, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    lid, n_local = topi, cfg.n_experts
    if shard is not None:
        n_local = shard.experts.size
        local = topi - shard.experts.start
        lid = torch.where((local >= 0) & (local < n_local), local, n_local)
    buf, plan = _dispatch(t, lid, n_local, C, cfg)
    out_buf = _experts(buf, w_gate, w_up, w_down, act)     # (E_loc, C, M)
    y = _combine(out_buf, plan, gates, cfg)
    if shared is not None:
        s_gate, s_up, s_down = shared
        g = matmul(t, s_gate)
        u = matmul(t, s_up)
        y = y + matmul(act(g) * u, s_down).float()
    if shard is not None:
        return shard.reduce_sum(y, x.dtype).reshape(B, S, M)
    return y.reshape(B, S, M).to(x.dtype)


def moe(params: dict, x: torch.Tensor, cfg: ModelConfig, *, shard=None):
    """MoE sublayer. x: (B, S, M) -> (y (B, S, M) in x's dtype, aux ()
    fp32). ``shard``: this rank's part of an expert-parallel layer
    (:func:`_moe_local`; a training layout's aux loss over the global
    microbatch, :func:`_gates_and_aux`)."""
    topi, gates, aux = _route(params["router"], x, cfg) if shard is None \
        else _route(params["router"], x, cfg, shard=shard)
    shared = None
    if cfg.n_shared_experts:
        shared = (params["shared_gate"], params["shared_up"],
                  params["shared_down"])
    y = _moe_local(x, topi, gates, params.get("w_gate"), params["w_up"],
                   params["w_down"], shared, cfg=cfg, shard=shard)
    return y, aux
