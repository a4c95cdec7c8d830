"""Decoder-only LM, families ``dense``, ``vlm``, ``moe`` and ``ssm``: port
of ``repro/models/lm.py``.

* ``dense`` (tinyllama, starcoder2, nemotron, qwen3): token embedding, a
  stack of layers (RMSNorm -> GQA attention with RoPE, qwen3's with
  qk-norm and zero-masked padded heads -> residual -> RMSNorm -> MLP,
  SwiGLU or plain gelu / squared ReLU -> residual), final RMSNorm, vocab
  head.
* ``vlm`` (qwen2-vl): the dense model with M-RoPE: given ``mrope_positions``
  (3, B, S), every layer rotates q and k at those (t, h, w) positions
  (``common.apply_mrope``); ``forward`` also splices ``vision_embeds`` (B,
  nv, M), precomputed patch embeddings (the vision frontend is a stub, as
  in the reference), in front of the token embeddings. Without positions
  and vision embeddings it is the dense model, bit for bit.
* ``moe`` (qwen3-moe): the dense frame with the MLP replaced by the
  mixture of experts of ``moe.py``; ``forward`` also returns the sum of
  the layers' load-balance aux losses.
* ``ssm`` (mamba2): the same frame with layers ``x + mamba(RMSNorm(x))``.

Parameters are the nested dict the schema declares, with a leading stacked
layer axis; a Python loop over that axis takes the place of ``lax.scan``.

Entry points, as in the reference:

* ``loss_fn(params, batch)``            -> next-token cross entropy plus
  ``AUX_COEF`` times the aux loss (train);
* ``forward(params, tokens, *, vision_embeds=None, mrope_positions=None)``
                                        -> (logits (B, S, V), aux);
* ``prefill(params, tokens, cache, **kw)``    -> (last-token logits, cache);
* ``decode_step(params, token, cache, **kw)`` -> (logits (B, 1, V), cache);
  ``kw`` is ``mrope_positions``, as in the reference.

The cache is written in place (see ``attention.py`` and ``ssm.py``); the
returned cache holds the same buffers (with the advanced length for KV).
Under grad with ``cfg.remat``, each layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``) with the
reference's three policies: "full" saves only the layer's input; "dots"
and "names" run torch's selective checkpointing (:func:`_save_dots`,
:func:`_save_names`). The family ``hybrid`` raises ``NotImplementedError``
naming the ROADMAP item that brings it; the encoder-decoder is
``encdec.py``'s ``EncDecLM``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from .attention import KVCache, attention, attention_decls, init_cache
from .common import cross_entropy_loss, matmul, remat_layer, rms_norm
from .config import ModelConfig
from .ffn import mlp, mlp_decls
from .moe import moe, moe_decls
from .param import (ArrayDecl, normal_init, ones_init, tree_map,
                    unstack_layers)
from .ssm import SSMCache, init_ssm_cache, mamba_block, ssm_decls

__all__ = ["LM", "Cache", "AUX_COEF"]

AUX_COEF = 0.01

_PENDING_FAMILIES = {"hybrid": "A.10"}


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under ``name``, the counterpart of
    ``jax.ad_checkpoint.checkpoint_name``: an op of its own that a remat
    policy sees, with ``name`` among its arguments. A custom op may not
    return its input, so the mark is a copy; the model marks a tensor only
    where a policy reads the mark (the "names" policy)."""
    return x.clone()


checkpoint_name.register_autograd(lambda ctx, g: (g, None))


_aten = torch.ops.aten
# the matrix products as the dispatcher sees them: ``torch.matmul``'s
# decompositions (``common.matmul``'s ``@`` and the plain attention's
# einsums reach mm and bmm), addmm, and the flash kernel's forward
# (``kernels/flash_attention/ops.py``, registered when ``.attention``
# imports it)
_DOTS = frozenset((_aten.mm, _aten.bmm, _aten.addmm, _aten.mv, _aten.dot,
                   torch.ops.repro_torch.flash_attention_fwd))


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.checkpoint_dots``: save every matrix
    product's result, recompute the rest.

    The flash kernel's forward counts as a product, and its output and
    log-sum-exp are saved: in the reference the attention is
    ``blockwise_attention``, whose score and P.V einsums are dots that XLA
    saves under this policy, so its backward recomputes no attention; the
    kernel's (o, lse) is the smallest state from which the flash backward
    runs without recomputing it (the plain path saves its einsums as the
    reference does)."""
    return CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _save_names(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.save_only_these_names("moe_out")``: save
    the MoE sublayer's output, marked by :func:`checkpoint_name`, and
    recompute the rest."""
    return CheckpointPolicy.MUST_SAVE \
        if op.overloadpacket is torch.ops.repro_torch.checkpoint_name \
        and args[1] == "moe_out" else CheckpointPolicy.PREFER_RECOMPUTE


_POLICIES = {"dots": _save_dots, "names": _save_names}


class Cache(NamedTuple):
    """Stacked per-layer serving cache; each family fills its member.

    kv (families dense, vlm and moe): kv.k / kv.v are (n_layers, B, max_len,
    kv_heads, head_dim); kv.length is one () int32 for the batch (the
    reference broadcasts it per layer). ssm (family ssm): every member of the
    SSMCache has a leading n_layers axis."""
    kv: KVCache | None = None
    ssm: SSMCache | None = None


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family in _PENDING_FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r}: ROADMAP item "
                f"{_PENDING_FAMILIES[cfg.family]}")
        if cfg.family not in ("dense", "vlm", "moe", "ssm"):
            raise ValueError(cfg.family)
        self.cfg = cfg

    # ------------------------------------------------------------------
    # parameter schema (same tree paths and shapes as the reference)
    # ------------------------------------------------------------------
    def param_decls(self) -> dict:
        cfg = self.cfg
        L = cfg.n_layers
        ln1 = ArrayDecl((L, cfg.d_model), ("layers", "embed"), init=ones_init)
        if cfg.family == "ssm":
            layers = {"ln1": ln1, "mamba": ssm_decls(cfg, layers=L)}
        else:
            layers = {
                "ln1": ln1,
                "attn": attention_decls(cfg, layers=L),
                "ln2": ArrayDecl((L, cfg.d_model), ("layers", "embed"),
                                 init=ones_init),
            }
            if cfg.family == "moe":
                layers["moe"] = moe_decls(cfg, layers=L)
            else:
                layers["mlp"] = mlp_decls(cfg, layers=L)
        decls = {
            "embed": ArrayDecl((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                               init=normal_init(0.02)),
            "final_norm": ArrayDecl((cfg.d_model,), ("embed",),
                                    init=ones_init),
            "layers": layers,
        }
        if not cfg.tie_embeddings:
            decls["head"] = ArrayDecl((cfg.d_model, cfg.vocab),
                                      ("embed", "vocab"))
        return decls

    # ------------------------------------------------------------------
    def _layer(self, lp: dict, x: torch.Tensor, *, cache=None,
               mrope_positions=None, mark: bool = False):
        """-> (x, aux, new_kv); aux is 0.0 for an MLP layer. ``mark`` names
        the MoE output "moe_out" for the "names" policy."""
        h, new_kv = attention(lp["attn"], rms_norm(x, lp["ln1"]), self.cfg,
                              mrope_positions=mrope_positions, cache=cache)
        x = x + h
        if "moe" in lp:
            y, aux = moe(lp["moe"], rms_norm(x, lp["ln2"]), self.cfg)
            if mark:
                y = checkpoint_name(y, "moe_out")
        else:
            y, aux = mlp(lp["mlp"], rms_norm(x, lp["ln2"]), self.cfg), 0.0
        return x + y, aux, new_kv

    def _ssm_layer(self, lp: dict, x: torch.Tensor, *, cache=None,
                   mrope_positions=None):
        """-> (x, aux 0.0, new_ssm); ``mrope_positions`` is unused (no
        attention), taken for one layer signature across families."""
        h, new_ssm = mamba_block(lp["mamba"], rms_norm(x, lp["ln1"]),
                                 self.cfg, cache=cache)
        return x + h, 0.0, new_ssm

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens].to(torch.bfloat16)

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"])
        head = params["embed"].T if self.cfg.tie_embeddings \
            else params["head"]
        return matmul(x, head.to(x.dtype))

    def forward(self, params, tokens: torch.Tensor, *,
                vision_embeds: torch.Tensor | None = None,
                mrope_positions: torch.Tensor | None = None):
        """tokens: (B, S) -> logits (B, S, V); also returns the aux loss,
        summed over the layers (0.0 without MoE layers). ``vision_embeds``
        (B, nv, M) go in front of the token embeddings, whose last nv are
        dropped, and the sequence is cut to S; ``mrope_positions`` (3, B,
        S) reach every layer's attention."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        if vision_embeds is not None:
            nv = vision_embeds.shape[1]
            if nv:
                x = torch.cat([vision_embeds.to(x.dtype), x[:, :-nv]], dim=1)
            x = x[:, :tokens.shape[1]]
        remat = cfg.remat and torch.is_grad_enabled()
        policy = _POLICIES.get(cfg.remat_policy) if remat else None
        layer = self._ssm_layer if cfg.family == "ssm" else \
            functools.partial(self._layer, mark=policy is _save_names)

        def body(lp, x, positions):
            return layer(lp, x, mrope_positions=positions)[:2]

        run = body
        if remat and policy:
            run = remat_layer(body, functools.partial(
                create_selective_checkpoint_contexts, policy))
        elif remat:
            # any other policy name is "full", as in the reference
            run = remat_layer(body)
        aux = 0.0
        for lp in unstack_layers(params["layers"], cfg.n_layers):
            x, layer_aux = run(lp, x, mrope_positions)
            aux = aux + layer_aux
        return self._head(params, x), aux

    def loss_fn(self, params, batch) -> torch.Tensor:
        """batch: {'tokens': (B, S+1), optional 'vision_embeds' (B, nv, M),
        'mrope_positions' (3, B, S), 'mask' (B, S)} -> scalar fp32
        next-token cross entropy plus ``AUX_COEF`` times the aux loss (0
        without MoE layers)."""
        tokens = batch["tokens"]
        logits, aux = self.forward(
            params, tokens[:, :-1], vision_embeds=batch.get("vision_embeds"),
            mrope_positions=batch.get("mrope_positions"))
        ce = cross_entropy_loss(logits, tokens[:, 1:], batch.get("mask"))
        return ce + AUX_COEF * aux

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *,
                   device: str | torch.device = "cuda") -> Cache:
        """Zero cache. An SSM cache has no length, so ``max_len`` is unused
        there (kept for one signature across families)."""
        L = self.cfg.n_layers
        if self.cfg.family == "ssm":
            return Cache(ssm=init_ssm_cache(self.cfg, batch, layers=L,
                                            device=device))
        return Cache(kv=init_cache(self.cfg, batch, max_len, layers=L,
                                   device=device))

    def _apply_cached(self, params, tokens: torch.Tensor, cache: Cache, *,
                      mrope_positions=None):
        x = self._embed(params, tokens)
        if self.cfg.family == "ssm":
            for i in range(self.cfg.n_layers):
                lp = tree_map(lambda a: a[i], params["layers"])
                x, _, _ = self._ssm_layer(
                    lp, x, cache=SSMCache(*(a[i] for a in cache.ssm)))
            return self._head(params, x[:, -1:]), cache
        kv = cache.kv
        new_len = kv.length
        for i in range(self.cfg.n_layers):
            lp = tree_map(lambda a: a[i], params["layers"])
            x, _, new_kv = self._layer(
                lp, x, cache=KVCache(kv.k[i], kv.v[i], kv.length),
                mrope_positions=mrope_positions)
            new_len = new_kv.length
        logits = self._head(params, x[:, -1:])
        return logits, Cache(kv=KVCache(kv.k, kv.v, new_len))

    def prefill(self, params, tokens: torch.Tensor, cache: Cache, **kw):
        """tokens: (B, S); ``kw``: ``mrope_positions`` (3, B, S). Returns
        (last-token logits (B, 1, V), cache)."""
        return self._apply_cached(params, tokens, cache, **kw)

    def decode_step(self, params, token: torch.Tensor, cache: Cache, **kw):
        """token: (B, 1); ``kw``: ``mrope_positions`` (3, B, 1). Returns
        (logits (B, 1, V), cache)."""
        return self._apply_cached(params, token, cache, **kw)
