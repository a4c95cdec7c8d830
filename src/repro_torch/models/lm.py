"""Decoder-only LM, families ``dense``, ``vlm``, ``moe``, ``ssm`` and
``hybrid``: port of ``repro/models/lm.py``.

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
* ``hybrid`` (jamba): the frame over super-blocks of ``hybrid_period``
  sublayers (``_hybrid_block``). Each sublayer is RMSNorm -> a mixer ->
  residual -> RMSNorm -> an FFN -> residual; the mixer is the attention at
  ``hybrid_attn_index`` and a Mamba-2 block elsewhere, the FFN is the MoE
  where ``i % hybrid_moe_every == 1`` and the MLP elsewhere. ``forward``
  returns the sum of the blocks' MoE aux losses.

Parameters are the nested dict the schema declares, with a leading stacked
layer axis (for ``hybrid``, a leading block axis, and inside a block the
Mamba, MoE and MLP sublayers stacked apart); a Python loop over that axis
takes the place of ``lax.scan``.

Entry points, as in the reference:

* ``loss_fn(params, batch)``            -> next-token cross entropy plus
  ``AUX_COEF`` times the aux loss (train);
* ``forward(params, tokens, *, vision_embeds=None, mrope_positions=None)``
                                        -> (logits (B, S, V), aux);

both also take ``shard``, one rank's part of a (data, model) mesh under
autograd (every family; ``runtime/train_lib.py``'s sharded step; under
ZeRO-3 each unit's leaves gathered before it runs), and ``loss_fn``
per-token ``weights`` and the aux term's ``aux_weight``;
* ``prefill(params, tokens, cache, **kw)``    -> (last-token logits, cache);
* ``decode_step(params, token, cache, **kw)`` -> (logits (B, 1, V), cache);
  ``kw`` is ``mrope_positions``, as in the reference.

The cache is written in place (see ``attention.py`` and ``ssm.py``); the
returned cache holds the same buffers (with the advanced length for KV).
Under grad with ``cfg.remat``, each layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``) with the
reference's three policies: "full" saves only the layer's input; "dots"
and "names" run torch's selective checkpointing (:func:`_save_dots`,
:func:`_save_names`). A hybrid super-block is one such layer. The
encoder-decoder is ``encdec.py``'s ``EncDecLM``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from .attention import KVCache, attention, attention_decls, init_cache
from .common import (cross_entropy_loss, embed_tokens, matmul, remat_layer,
                     rms_norm, token_nll)
from .config import ModelConfig
from .ffn import mlp, mlp_decls
from .moe import moe, moe_decls
from .param import (ArrayDecl, normal_init, ones_init, tree_map,
                    unstack_layers)
from .ssm import SSMCache, init_ssm_cache, mamba_block, ssm_decls

__all__ = ["LM", "Cache", "AUX_COEF"]

AUX_COEF = 0.01


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
    SSMCache has a leading n_layers axis. Family hybrid holds both: kv.k /
    kv.v (nb, B, max_len, kv_heads, head_dim), one attention a block, and
    every SSMCache member (nb, hybrid_period - 1, ...), with nb =
    n_layers // hybrid_period."""
    kv: KVCache | None = None
    ssm: SSMCache | None = None


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid"):
            raise ValueError(cfg.family)
        self.cfg = cfg

    # ------------------------------------------------------------------
    # parameter schema (same tree paths and shapes as the reference)
    # ------------------------------------------------------------------
    def _n_stacked(self) -> int:
        """Entries of the stacked layer axis: layers, or super-blocks."""
        cfg = self.cfg
        return cfg.n_layers // cfg.hybrid_period \
            if cfg.family == "hybrid" else cfg.n_layers

    def _hybrid_decls(self) -> dict:
        """One super-block's sublayers, each leaf with a leading block axis:
        the Mamba blocks stacked ``period - 1``, the MoE ``period //
        moe_every``, the MLP the rest, one attention, and the two norms of
        each sublayer, (period, d_model)."""
        cfg = self.cfg
        per = cfg.hybrid_period
        n_moe = per // cfg.hybrid_moe_every
        sub = {
            "mamba": ssm_decls(cfg, layers=per - 1),
            "attn": attention_decls(cfg),
            "moe": moe_decls(cfg, layers=n_moe),
            "mlp": mlp_decls(cfg, layers=per - n_moe),
            "ln_mix": ArrayDecl((per, cfg.d_model), (None, "embed"),
                                init=ones_init),
            "ln_ffn": ArrayDecl((per, cfg.d_model), (None, "embed"),
                                init=ones_init),
        }
        nb = cfg.n_layers // per
        return tree_map(lambda d: ArrayDecl(
            (nb,) + d.shape, ("layers",) + d.axes, dtype=d.dtype,
            init=d.init), sub)

    def param_decls(self) -> dict:
        cfg = self.cfg
        L = cfg.n_layers
        ln1 = ArrayDecl((L, cfg.d_model), ("layers", "embed"), init=ones_init)
        if cfg.family == "hybrid":
            layers = self._hybrid_decls()
        elif cfg.family == "ssm":
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
               mrope_positions=None, mark: bool = False, shard=None):
        """-> (x, aux, new_kv); aux is 0.0 for an MLP layer. ``mark`` names
        the MoE output "moe_out" for the "names" policy; ``shard`` runs this
        rank's part of a sharded layer (see ``_apply_cached``)."""
        h, new_kv = attention(lp["attn"], rms_norm(x, lp["ln1"]), self.cfg,
                              mrope_positions=mrope_positions, cache=cache,
                              shard=shard)
        x = x + h
        if "moe" in lp:
            y, aux = moe(lp["moe"], rms_norm(x, lp["ln2"]), self.cfg,
                         shard=shard)
            if mark:
                y = checkpoint_name(y, "moe_out")
        else:
            y, aux = mlp(lp["mlp"], rms_norm(x, lp["ln2"]), self.cfg,
                         shard=shard), 0.0
        return x + y, aux, new_kv

    def _ssm_layer(self, lp: dict, x: torch.Tensor, *, cache=None,
                   mrope_positions=None, shard=None):
        """-> (x, aux 0.0, new_ssm); ``mrope_positions`` is unused (no
        attention), taken for one layer signature across families;
        ``shard`` as in ``_layer``."""
        h, new_ssm = mamba_block(lp["mamba"], rms_norm(x, lp["ln1"]),
                                 self.cfg, cache=cache, shard=shard)
        return x + h, 0.0, new_ssm

    def _hybrid_block(self, bp: dict, x: torch.Tensor, *, cache=None,
                      mrope_positions=None, shard=None):
        """One super-block, the reference's sublayers in its order: the
        attention at ``hybrid_attn_index`` (cache ``cache.kv``), a Mamba
        block elsewhere (the ``mi``-th, cache ``cache.ssm``'s ``mi``-th
        slice, written in place); then the ``fi_moe``-th MoE where ``i %
        hybrid_moe_every == 1``, the ``fi_mlp``-th MLP elsewhere. -> (x,
        the MoE sublayers' summed aux, new_kv). ``mrope_positions`` is
        unused (the reference's block takes none), taken for one layer
        signature across families. The reference marks no MoE output
        here, so the "names" policy saves nothing in a hybrid block.
        ``shard`` goes to every sublayer, each cut as in its own family
        (the attention over the block's K/V span, Mamba-2 head parallel
        over the ``mi``-th SSM cache slice, the MoE expert parallel, the
        MLP row parallel; see ``_apply_cached``)."""
        cfg = self.cfg
        per = cfg.hybrid_period
        n_moe = per // cfg.hybrid_moe_every
        mamba = unstack_layers(bp["mamba"], per - 1)
        moes = unstack_layers(bp["moe"], n_moe)
        mlps = unstack_layers(bp["mlp"], per - n_moe)
        ln_mix, ln_ffn = bp["ln_mix"].unbind(0), bp["ln_ffn"].unbind(0)
        aux, new_kv = 0.0, None
        mi = fi_moe = fi_mlp = 0
        for i in range(per):
            xn = rms_norm(x, ln_mix[i])
            if i == cfg.hybrid_attn_index:
                h, new_kv = attention(bp["attn"], xn, cfg, cache=None
                                      if cache is None else cache.kv,
                                      shard=shard)
            else:
                sc = None if cache is None else \
                    SSMCache(*(a[mi] for a in cache.ssm))
                h, _ = mamba_block(mamba[mi], xn, cfg, cache=sc, shard=shard)
                mi += 1
            x = x + h
            xn = rms_norm(x, ln_ffn[i])
            if i % cfg.hybrid_moe_every == 1:
                y, layer_aux = moe(moes[fi_moe], xn, cfg, shard=shard)
                aux = aux + layer_aux
                fi_moe += 1
            else:
                y = mlp(mlps[fi_mlp], xn, cfg, shard=shard)
                fi_mlp += 1
            x = x + y
        return x, aux, new_kv

    def _layer_fn(self, mark: bool = False):
        """The family's layer, (lp, x, *, cache, mrope_positions) -> (x,
        aux, new cache): ``_layer`` (``mark`` as there), ``_ssm_layer``, or
        for ``hybrid`` a super-block (``_hybrid_block``)."""
        if self.cfg.family == "ssm":
            return self._ssm_layer
        if self.cfg.family == "hybrid":
            return self._hybrid_block
        return functools.partial(self._layer, mark=mark)

    def _embed(self, params, tokens: torch.Tensor,
               shard=None) -> torch.Tensor:
        """Token embeddings; with ``shard``, the vocab-parallel lookup
        (``common.embed_tokens``), the table gathered first under ZeRO-3
        (``ShardLayout.gather_params``)."""
        if shard is None:
            return embed_tokens(params["embed"], tokens)
        table = shard.gather_params({"embed": params["embed"]})["embed"]
        return embed_tokens(table, tokens, shard)

    def _head(self, params, x: torch.Tensor, shard=None) -> torch.Tensor:
        """The logits of the normed ``x``; with ``shard`` whose vocab is
        cut, this rank's columns (a tied head: its embedding rows'
        transpose), ``x`` entering through ``shard.enter``; under ZeRO-3
        the final norm and the head (or the tied embedding) gathered
        first."""
        key = "embed" if self.cfg.tie_embeddings else "head"
        params = {"final_norm": params["final_norm"], key: params[key]}
        if shard is not None:
            params = shard.gather_params(params)
        x = rms_norm(x, params["final_norm"])
        if shard is not None and shard.vocab.sharded:
            x = shard.enter(x)
        head = params["embed"].T if self.cfg.tie_embeddings \
            else params["head"]
        return matmul(x, head.to(x.dtype))

    def forward(self, params, tokens: torch.Tensor, *,
                vision_embeds: torch.Tensor | None = None,
                mrope_positions: torch.Tensor | None = None, shard=None):
        """tokens: (B, S) -> logits (B, S, V); also returns the aux loss,
        summed over the layers (0.0 without MoE layers). ``vision_embeds``
        (B, nv, M) go in front of the token embeddings, whose last nv are
        dropped, and the sequence is cut to S; ``mrope_positions`` (3, B,
        S) reach every layer's attention.

        With ``shard`` (a training ``ShardLayout`` from
        ``runtime/serve_lib.py::shard_layout``): this rank's part of a
        (data, model) mesh under autograd. ``tokens``, ``vision_embeds``
        and ``mrope_positions`` are this rank's rows and ``params`` its
        shards; the vocab-parallel embedding (the rank's ``vision_embeds``
        spliced in after it), each layer's column- and row-parallel
        attention (M-RoPE on the rank's heads) and MLP, expert-parallel MoE
        or head-parallel Mamba block, or a hybrid super-block whose
        sublayers are each cut as in their own family (under remat, one
        unit a layer or a block), and the logits at this rank's vocab
        columns (B, S, V_local). Under ZeRO-3 (``shard.zero3``) ``params``
        are this rank's regions, and each unit's leaves are gathered at
        the start of its remat body (``ShardLayout.gather_params``), so
        that the recompute gathers them again."""
        cfg = self.cfg
        x = self._embed(params, tokens) if shard is None \
            else self._embed(params, tokens, shard)
        if vision_embeds is not None:
            nv = vision_embeds.shape[1]
            if nv:
                x = torch.cat([vision_embeds.to(x.dtype), x[:, :-nv]], dim=1)
            x = x[:, :tokens.shape[1]]
        remat = cfg.remat and torch.is_grad_enabled()
        policy = _POLICIES.get(cfg.remat_policy) if remat else None
        layer = self._layer_fn(mark=policy is _save_names)
        if shard is not None:
            layer = functools.partial(layer, shard=shard)

        def body(lp, x, positions, i):
            if shard is not None:
                lp = shard.gather_params(lp, ("layers",), (i,))
            return layer(lp, x, mrope_positions=positions)[:2]

        run = body
        if remat and policy:
            run = remat_layer(body, functools.partial(
                create_selective_checkpoint_contexts, policy))
        elif remat:
            # any other policy name is "full", as in the reference
            run = remat_layer(body)
        aux = 0.0
        for i, lp in enumerate(unstack_layers(params["layers"],
                                              self._n_stacked())):
            x, layer_aux = run(lp, x, mrope_positions, i)
            aux = aux + layer_aux
        return self._head(params, x, shard), aux

    def loss_fn(self, params, batch, *, shard=None,
                weights: torch.Tensor | None = None,
                aux_weight: float = 1.0) -> torch.Tensor:
        """batch: {'tokens': (B, S+1), optional 'vision_embeds' (B, nv, M),
        'mrope_positions' (3, B, S), 'mask' (B, S)} -> scalar fp32
        next-token cross entropy plus ``AUX_COEF`` times the aux loss (0
        without MoE layers).

        ``shard``: this rank's part of a mesh (:meth:`forward`), the batch
        its rows; the cross entropy is vocab-parallel
        (``common.token_nll``), the same on every model rank. ``weights``
        (B, S) fp32: the cross entropy is sum(nll * weights) in place of
        the masked mean (the sharded train step's share of the global
        batch's loss; ``mask`` is then unused), and the aux loss enters
        times ``aux_weight`` (the step's 1 / microbatches), counted once
        over the batch ranks (``ShardLayout.counted_once``: every batch
        rank computes the same aux over the global microbatch)."""
        tokens = batch["tokens"]
        logits, aux = self.forward(
            params, tokens[:, :-1], vision_embeds=batch.get("vision_embeds"),
            mrope_positions=batch.get("mrope_positions"), shard=shard)
        if weights is None:
            ce = cross_entropy_loss(logits, tokens[:, 1:], batch.get("mask"),
                                    shard)
            return ce + AUX_COEF * aux
        ce = (token_nll(logits, tokens[:, 1:], shard) * weights).sum()
        if shard is not None and torch.is_tensor(aux):
            aux = shard.counted_once(aux)
        return ce + AUX_COEF * aux_weight * aux

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *,
                   device: str | torch.device = "cuda") -> Cache:
        """Zero cache. An SSM cache has no length, so ``max_len`` is unused
        there (kept for one signature across families)."""
        cfg, L = self.cfg, self._n_stacked()
        if cfg.family == "ssm":
            return Cache(ssm=init_ssm_cache(cfg, batch, layers=L,
                                            device=device))
        kv = init_cache(cfg, batch, max_len, layers=L, device=device)
        if cfg.family != "hybrid":
            return Cache(kv=kv)
        nm = cfg.hybrid_period - 1
        ssm = init_ssm_cache(cfg, batch, layers=L * nm, device=device)
        return Cache(kv=kv, ssm=SSMCache(*(
            a.view((L, nm) + a.shape[1:]) for a in ssm)))

    def _apply_cached(self, params, tokens: torch.Tensor, cache: Cache, *,
                      mrope_positions=None, shard=None):
        """With ``shard`` (a ``sharding.layout.ShardLayout``, given by
        ``runtime/serve_lib.py``'s steps; families dense, vlm (its tokens
        path: 1-D RoPE), moe, ssm and hybrid): this rank's part of a
        (data, model) mesh. ``tokens`` are this rank's batch rows,
        ``params`` and ``cache`` its shards; the embedding, the attention,
        the MLP, the experts and the Mamba blocks run their collectives
        over the model axis, and this rank's logit columns (with a tied
        head, its embedding rows' transpose) are gathered to the full (B,
        S, vocab) logits on every rank, as the reference's steps return
        them."""
        x = self._embed(params, tokens, shard)
        layer, kv, ssm = self._layer_fn(), cache.kv, cache.ssm
        if shard is not None:
            layer = functools.partial(layer, shard=shard)
        for i in range(self._n_stacked()):
            lp = tree_map(lambda a: a[i], params["layers"])
            if shard is not None:
                lp = shard.gather_params(lp, ("layers",), (i,))
            # layer (or block) i's slices of the cache, written in place
            kv_i = None if kv is None else KVCache(kv.k[i], kv.v[i],
                                                   kv.length)
            ssm_i = None if ssm is None else SSMCache(*(a[i] for a in ssm))
            if self.cfg.family == "hybrid":
                cache_i = Cache(kv_i, ssm_i)
            else:
                cache_i = ssm_i if kv is None else kv_i
            x, _, new = layer(lp, x, cache=cache_i,
                              mrope_positions=mrope_positions)
        logits = self._head(params, x[:, -1:], shard)
        if shard is not None:
            logits = shard.gather_logits(logits)
        if kv is None:
            return logits, cache
        # every layer's K/V cache moves to the same new length
        return logits, Cache(KVCache(kv.k, kv.v, new.length), ssm)

    def prefill(self, params, tokens: torch.Tensor, cache: Cache, **kw):
        """tokens: (B, S); ``kw``: ``mrope_positions`` (3, B, S), or
        ``shard`` for one rank of a mesh (``_apply_cached``). Returns
        (last-token logits (B, 1, V), cache)."""
        return self._apply_cached(params, tokens, cache, **kw)

    def decode_step(self, params, token: torch.Tensor, cache: Cache, **kw):
        """token: (B, 1); ``kw``: ``mrope_positions`` (3, B, 1), or
        ``shard`` (``_apply_cached``). Returns (logits (B, 1, V), cache)."""
        return self._apply_cached(params, token, cache, **kw)
