"""Encoder-decoder LM (seamless-m4t-v2 backbone): port of
``repro/models/encdec.py``.

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, T, d_model). The encoder is a stack of
non-causal self-attention layers (with RoPE) and MLPs; the decoder a causal
transformer whose layers add cross-attention over the encoder's memory.

Entry points, as in the reference:

* ``loss_fn(params, batch)``   -> next-token cross entropy; batch is
  ``{'frames': (B, T, M), 'tokens': (B, S+1)[, 'mask': (B, S)]}``;
* ``forward(params, frames, tokens)`` -> (logits (B, S, V), 0-dim zero);

both also take ``shard``, one rank's part of a (data, model) mesh under
autograd (``runtime/train_lib.py``'s sharded step), and ``loss_fn`` the
per-token ``weights`` and ``aux_weight`` that ``LM.loss_fn`` takes;
* ``encode(params, frames)``   -> memory (B, T, M);
* ``prefill(params, frames, tokens, cache)`` -> (last-token logits, cache);
* ``decode_step(params, token, cache)``      -> (logits (B, 1, V), cache).

Serving caches the decoder's self-attention K/V in fp32 (the reference's
reason: ``init_cache`` below) and the encoder memory's K/V, projected for
every layer once at prefill, in bf16. On the card every attention runs a
hand-written kernel: the encoder's and the uncached cross-attention's
through the flash kernel non-causal, the decoder's prefill causal, the
cached cross-attention's prefill through the flash kernel with the prompt's
queries over the memory's keys, and a decode step's self- and
cross-attention through the decode kernel (fp32 and bf16).

With ``shard`` (a ``sharding.layout.ShardLayout``, given by
``runtime/serve_lib.py``'s steps) ``prefill`` and ``decode_step`` run one
rank of a (data, model) mesh: its batch rows; the vocab-parallel
embedding and this rank's columns of the untied ``head``, gathered to the
full logits; every attention on this rank's q heads (the encoder's
uncached and non-causal, the decoder's self-attention over this rank's
span of the fp32 self cache, the cross-attention over the memory K/V,
which every rank holds whole) and the MLP on its hidden units, each
row-parallel product summed over the model axis. At the prefill each rank
projects the memory through its ``wk``/``wv`` heads of every layer, and
the heads are gathered, in one all_reduce, into the whole cross cache
(``_cross_kv``), as the reference's spec keeps it. ``forward`` and
``loss_fn`` with ``shard`` (training) run the same cut under autograd:
the encoder on the rank's heads and hidden units, the decoder's
cross-attention uncached over the memory through the rank's columns of
``wk``/``wv`` (no gather: a rank's q heads read only its own KV heads),
the vocab-parallel head and cross entropy (``common.token_nll``). Under
ZeRO-3 (``shard.zero3``) ``params`` are the rank's regions: each encoder
and decoder layer's leaves are gathered at the start of its body (under
remat, again in the recompute), the embedding, the head with the final
norm, the encoder's final norm and, at the prefill, each layer's memory
projections just before their use (``ShardLayout.gather_params``).

Parameters are the reference's tree (same paths and shapes), with leading
stacked layer axes; a Python loop over them takes the place of
``lax.scan``. The caches are written in place (``attention.py``). Under
grad with ``cfg.remat``, each encoder and decoder layer runs under
``torch.utils.checkpoint`` saving only its inputs: the reference wraps both
bodies in ``jax.checkpoint`` with no policy and never reads
``remat_policy`` for this family, and so does the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .attention import (KVCache, attention, attention_decls,
                        cross_attention, init_cache)
from .common import (cross_entropy_loss, embed_tokens, matmul, remat_layer,
                     rms_norm, token_nll)
from .config import ModelConfig
from .ffn import mlp, mlp_decls
from .param import ArrayDecl, normal_init, ones_init, unstack_layers

__all__ = ["EncDecLM", "EncDecCache"]


class EncDecCache(NamedTuple):
    """self_kv: the decoder's stacked fp32 self-attention cache, k/v
    (L, B, max_len, Hk, D) and one () int32 length for the batch (the
    reference broadcasts it per layer). cross_k, cross_v: (L, B, T, Hk, D)
    bf16, the memory's K/V of every decoder layer. cross_length: () int32
    T on the cache's device, which the card's decode kernel reads."""
    self_kv: KVCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_length: torch.Tensor


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "encdec":
            raise ValueError(cfg.family)
        if not cfg.n_encoder_layers:
            raise ValueError("encdec needs n_encoder_layers")
        self.cfg = cfg

    # -- schema ------------------------------------------------------------
    def param_decls(self) -> dict:
        cfg = self.cfg
        Le, Ld = cfg.n_encoder_layers, cfg.n_layers

        def norm(L):
            return ArrayDecl((L, cfg.d_model), ("layers", "embed"),
                             init=ones_init)
        return {
            "embed": ArrayDecl((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                               init=normal_init(0.02)),
            "head": ArrayDecl((cfg.d_model, cfg.vocab), ("embed", "vocab")),
            "enc_final_norm": ArrayDecl((cfg.d_model,), ("embed",),
                                        init=ones_init),
            "final_norm": ArrayDecl((cfg.d_model,), ("embed",),
                                    init=ones_init),
            "encoder": {
                "ln1": norm(Le),
                "attn": attention_decls(cfg, layers=Le),
                "ln2": norm(Le),
                "mlp": mlp_decls(cfg, layers=Le),
            },
            "decoder": {
                "ln1": norm(Ld),
                "self_attn": attention_decls(cfg, layers=Ld),
                "ln2": norm(Ld),
                "cross_attn": attention_decls(cfg, layers=Ld),
                "ln3": norm(Ld),
                "mlp": mlp_decls(cfg, layers=Ld),
            },
        }

    def _run(self, body, lp: dict, *args):
        """``body(lp, *args)``, under ``torch.utils.checkpoint`` when grad
        is on and the config asks for remat."""
        if self.cfg.remat and torch.is_grad_enabled():
            return remat_layer(body)(lp, *args)
        return body(lp, *args)

    # -- encoder -----------------------------------------------------------
    def _encoder_layer(self, lp: dict, x: torch.Tensor, shard=None,
                       i: int = 0) -> torch.Tensor:
        """Encoder layer ``i``; under ZeRO-3 its leaves gathered first."""
        if shard is not None:
            lp = shard.gather_params(lp, ("encoder",), (i,))
        h, _ = attention(lp["attn"], rms_norm(x, lp["ln1"]), self.cfg,
                         causal=False, shard=shard)
        x = x + h
        return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"]), self.cfg,
                       shard=shard)

    def encode(self, params, frames: torch.Tensor,
               shard=None) -> torch.Tensor:
        """frames: (B, T, M) precomputed embeddings -> memory (B, T, M);
        ``shard``: this rank's part of a sharded call (every rank returns
        the memory of its rows)."""
        x = frames.to(torch.bfloat16)
        for i, lp in enumerate(unstack_layers(params["encoder"],
                                              self.cfg.n_encoder_layers)):
            x = self._run(self._encoder_layer, lp, x, shard, i)
        norm = params["enc_final_norm"]
        if shard is not None:
            norm = shard.gather_params({"enc_final_norm": norm})[
                "enc_final_norm"]
        return rms_norm(x, norm)

    # -- decoder -----------------------------------------------------------
    def _decoder_layer(self, lp: dict, x: torch.Tensor,
                       memory: torch.Tensor | None, *, self_cache=None,
                       cross_kv: KVCache | None = None, shard=None):
        """-> (x, new self cache or None). Cross-attention over ``cross_kv``
        (the cached memory K/V) when given, else over ``memory``;
        ``shard`` as in ``_run_decoder_cached``."""
        cfg = self.cfg
        h, new_kv = attention(lp["self_attn"], rms_norm(x, lp["ln1"]), cfg,
                              cache=self_cache, shard=shard)
        x = x + h
        xn = rms_norm(x, lp["ln2"])
        if cross_kv is not None:
            h = cross_attention(lp["cross_attn"], xn, cfg, cross_kv, shard)
        else:
            h, _ = attention(lp["cross_attn"], xn, cfg, kv_source=memory,
                             shard=shard)
        x = x + h
        x = x + mlp(lp["mlp"], rms_norm(x, lp["ln3"]), cfg, shard=shard)
        return x, new_kv

    def _embed(self, params, tokens: torch.Tensor,
               shard=None) -> torch.Tensor:
        if shard is None:
            return embed_tokens(params["embed"], tokens)
        table = shard.gather_params({"embed": params["embed"]})["embed"]
        return embed_tokens(table, tokens, shard)

    def _head(self, params, x: torch.Tensor, shard=None) -> torch.Tensor:
        """The logits of the normed ``x``; with ``shard`` whose vocab is
        cut, this rank's columns of ``head``, ``x`` entering through
        ``shard.enter`` (as ``LM._head``; under ZeRO-3 the final norm and
        the head gathered first)."""
        params = {"final_norm": params["final_norm"], "head": params["head"]}
        if shard is not None:
            params = shard.gather_params(params)
        x = rms_norm(x, params["final_norm"])
        if shard is not None and shard.vocab.sharded:
            x = shard.enter(x)
        return matmul(x, params["head"].to(x.dtype))

    def forward(self, params, frames: torch.Tensor, tokens: torch.Tensor, *,
                shard=None):
        """Training path: (B, T, M) frames + (B, S) tokens -> logits
        (B, S, V) and a 0-dim fp32 zero (no aux loss).

        With ``shard`` (a training ``ShardLayout`` from
        ``runtime/serve_lib.py::shard_layout``): this rank's part of a
        (data, model) mesh under autograd, ``frames`` and ``tokens`` its
        rows and ``params`` its shards; the encoder's and the decoder's
        attention on the rank's heads (the cross-attention over the
        memory, which every model rank holds alike, uncached) and MLPs on
        its hidden units, each row-parallel product summed over the model
        axis; the logits at this rank's vocab columns (B, S, V_local)."""
        memory = self.encode(params, frames, shard)
        x = self._embed(params, tokens, shard)

        def body(lp, x, memory, i):
            if shard is not None:
                lp = shard.gather_params(lp, ("decoder",), (i,))
            return self._decoder_layer(lp, x, memory, shard=shard)[0]

        for i, lp in enumerate(unstack_layers(params["decoder"],
                                              self.cfg.n_layers)):
            x = self._run(body, lp, x, memory, i)
        return self._head(params, x, shard), torch.zeros(
            (), dtype=torch.float32, device=x.device)

    def loss_fn(self, params, batch, *, shard=None,
                weights: torch.Tensor | None = None,
                aux_weight: float = 1.0) -> torch.Tensor:
        """batch: {'frames': (B, T, M), 'tokens': (B, S+1), optional 'mask'
        (B, S)} -> scalar fp32 next-token cross entropy.

        ``shard``: this rank's part of a mesh (:meth:`forward`), the batch
        its rows; the cross entropy is vocab-parallel
        (``common.token_nll``). ``weights`` (B, S) fp32: the cross entropy
        is sum(nll * weights) in place of the masked mean (the sharded
        train step's share of the global batch's loss; ``mask`` is then
        unused). ``aux_weight`` is taken for ``LM.loss_fn``'s signature:
        the family has no aux loss."""
        tokens = batch["tokens"]
        logits, _ = self.forward(params, batch["frames"], tokens[:, :-1],
                                 shard=shard)
        if weights is None:
            return cross_entropy_loss(logits, tokens[:, 1:],
                                      batch.get("mask"), shard)
        return (token_nll(logits, tokens[:, 1:], shard) * weights).sum()

    # -- serving -----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, memory_len: int, *,
                   device: str | torch.device = "cuda") -> EncDecCache:
        """Zero cache for ``max_len`` decoder tokens over ``memory_len``
        frames.

        The self-attention K/V stay at compute precision (fp32), as in the
        reference: the double-sublayer decoder amplifies bf16 cache
        rounding through the residual stream (~20x over 4 layers), breaking
        prefill+decode vs forward consistency. The cross K/V stay bf16:
        their inputs are bf16 already, so the round trip is exact."""
        cfg = self.cfg
        L = cfg.n_layers
        shape = (L, batch, memory_len, cfg.n_kv_heads, cfg.head_dim)
        return EncDecCache(
            self_kv=init_cache(cfg, batch, max_len, layers=L, device=device,
                               dtype=torch.float32),
            cross_k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
            cross_v=torch.zeros(shape, dtype=torch.bfloat16, device=device),
            cross_length=torch.tensor(memory_len, dtype=torch.int32,
                                      device=device))

    def _cross_kv(self, params, memory: torch.Tensor, cache: EncDecCache,
                  shard=None) -> None:
        """Every decoder layer's K/V of the memory (B, T, M), projected
        once into ``cache.cross_k``/``cross_v``. With ``shard`` this rank
        projects its KV heads of every layer (its ``wk``/``wv`` shards),
        and the heads are gathered over the model axis in one all_reduce
        for every layer's K and V, so that each rank's cache holds every
        KV head."""
        cfg = self.cfg
        cross = params["decoder"]["cross_attn"]
        M, D = memory.shape[-1], cfg.head_dim
        Hk = cfg.n_kv_heads if shard is None else shard.kv_heads.size
        if shard is None:
            k, v = cache.cross_k, cache.cross_v
        else:
            k = memory.new_empty((cfg.n_layers,) + memory.shape[:2]
                                 + (Hk, D))
            v = torch.empty_like(k)
        for i in range(cfg.n_layers):
            w = {"wk": cross["wk"][i], "wv": cross["wv"][i]}
            if shard is not None:
                w = shard.gather_params(w, ("decoder", "cross_attn"), (i,))
            k[i].copy_(matmul(memory, w["wk"].reshape(M, Hk * D))
                       .view(k.shape[1:]))
            v[i].copy_(matmul(memory, w["wv"].reshape(M, Hk * D))
                       .view(v.shape[1:]))
        if shard is not None:
            k, v = shard.gather((k, 3, shard.kv_heads),
                                (v, 3, shard.kv_heads))
            cache.cross_k.copy_(k)
            cache.cross_v.copy_(v)

    def prefill(self, params, frames: torch.Tensor, tokens: torch.Tensor,
                cache: EncDecCache, *, shard=None):
        """Encode, project every layer's memory K/V once into the cache,
        run the decoder over the prompt. Returns (last-token logits
        (B, 1, V), cache). ``shard``: as in ``_run_decoder_cached``."""
        memory = self.encode(params, frames, shard)
        self._cross_kv(params, memory, cache, shard)
        return self._run_decoder_cached(params, tokens, cache, shard)

    def decode_step(self, params, token: torch.Tensor, cache: EncDecCache,
                    *, shard=None):
        """token: (B, 1). Returns (logits (B, 1, V), cache)."""
        return self._run_decoder_cached(params, token, cache, shard)

    def _run_decoder_cached(self, params, tokens: torch.Tensor,
                            cache: EncDecCache, shard=None):
        """The decoder over ``tokens`` with the caches. With ``shard`` (a
        ``sharding.layout.ShardLayout``, ``runtime/serve_lib.py``'s steps)
        this rank's part of a (data, model) mesh: ``tokens`` its batch
        rows, ``params`` and ``cache`` its shards; this rank's logit
        columns are gathered to the full (B, S, vocab) logits on every
        rank, as the reference's steps return them."""
        kv = cache.self_kv
        x = self._embed(params, tokens, shard)
        new_len = kv.length
        layers = unstack_layers(params["decoder"], self.cfg.n_layers)
        for i, lp in enumerate(layers):
            if shard is not None:
                lp = shard.gather_params(lp, ("decoder",), (i,))
            x, new_kv = self._decoder_layer(
                lp, x, None, self_cache=KVCache(kv.k[i], kv.v[i], kv.length),
                cross_kv=KVCache(cache.cross_k[i], cache.cross_v[i],
                                 cache.cross_length), shard=shard)
            new_len = new_kv.length
        logits = self._head(params, x[:, -1:], shard)
        if shard is not None:
            logits = shard.gather_logits(logits)
        return logits, cache._replace(self_kv=KVCache(kv.k, kv.v, new_len))
