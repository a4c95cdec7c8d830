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
from .common import cross_entropy_loss, matmul, remat_layer, rms_norm
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
    def _encoder_layer(self, lp: dict, x: torch.Tensor) -> torch.Tensor:
        h, _ = attention(lp["attn"], rms_norm(x, lp["ln1"]), self.cfg,
                         causal=False)
        x = x + h
        return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"]), self.cfg)

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T, M) precomputed embeddings -> memory (B, T, M)."""
        x = frames.to(torch.bfloat16)
        for lp in unstack_layers(params["encoder"], self.cfg.n_encoder_layers):
            x = self._run(self._encoder_layer, lp, x)
        return rms_norm(x, params["enc_final_norm"])

    # -- decoder -----------------------------------------------------------
    def _decoder_layer(self, lp: dict, x: torch.Tensor,
                       memory: torch.Tensor | None, *, self_cache=None,
                       cross_kv: KVCache | None = None):
        """-> (x, new self cache or None). Cross-attention over ``cross_kv``
        (the cached memory K/V) when given, else over ``memory``."""
        cfg = self.cfg
        h, new_kv = attention(lp["self_attn"], rms_norm(x, lp["ln1"]), cfg,
                              cache=self_cache)
        x = x + h
        xn = rms_norm(x, lp["ln2"])
        if cross_kv is not None:
            h = cross_attention(lp["cross_attn"], xn, cfg, cross_kv)
        else:
            h, _ = attention(lp["cross_attn"], xn, cfg, kv_source=memory)
        x = x + h
        x = x + mlp(lp["mlp"], rms_norm(x, lp["ln3"]), cfg)
        return x, new_kv

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens].to(torch.bfloat16)

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"])
        return matmul(x, params["head"].to(x.dtype))

    def forward(self, params, frames: torch.Tensor, tokens: torch.Tensor):
        """Training path: (B, T, M) frames + (B, S) tokens -> logits
        (B, S, V) and a 0-dim fp32 zero (no aux loss)."""
        memory = self.encode(params, frames)
        x = self._embed(params, tokens)

        def body(lp, x, memory):
            return self._decoder_layer(lp, x, memory)[0]

        for lp in unstack_layers(params["decoder"], self.cfg.n_layers):
            x = self._run(body, lp, x, memory)
        return self._head(params, x), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)

    def loss_fn(self, params, batch) -> torch.Tensor:
        """batch: {'frames': (B, T, M), 'tokens': (B, S+1), optional 'mask'
        (B, S)} -> scalar fp32 next-token cross entropy."""
        tokens = batch["tokens"]
        logits, _ = self.forward(params, batch["frames"], tokens[:, :-1])
        return cross_entropy_loss(logits, tokens[:, 1:], batch.get("mask"))

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

    def prefill(self, params, frames: torch.Tensor, tokens: torch.Tensor,
                cache: EncDecCache):
        """Encode, project every layer's memory K/V once into the cache,
        run the decoder over the prompt. Returns (last-token logits
        (B, 1, V), cache)."""
        cfg = self.cfg
        memory = self.encode(params, frames)
        B, T, M = memory.shape
        HkD = cfg.n_kv_heads * cfg.head_dim
        cross = params["decoder"]["cross_attn"]
        for i in range(cfg.n_layers):
            cache.cross_k[i].copy_(matmul(memory, cross["wk"][i].reshape(
                M, HkD)).view(cache.cross_k.shape[1:]))
            cache.cross_v[i].copy_(matmul(memory, cross["wv"][i].reshape(
                M, HkD)).view(cache.cross_v.shape[1:]))
        return self._run_decoder_cached(params, tokens, cache)

    def decode_step(self, params, token: torch.Tensor, cache: EncDecCache):
        """token: (B, 1). Returns (logits (B, 1, V), cache)."""
        return self._run_decoder_cached(params, token, cache)

    def _run_decoder_cached(self, params, tokens: torch.Tensor,
                            cache: EncDecCache):
        kv = cache.self_kv
        x = self._embed(params, tokens)
        new_len = kv.length
        layers = unstack_layers(params["decoder"], self.cfg.n_layers)
        for i, lp in enumerate(layers):
            x, new_kv = self._decoder_layer(
                lp, x, None, self_cache=KVCache(kv.k[i], kv.v[i], kv.length),
                cross_kv=KVCache(cache.cross_k[i], cache.cross_v[i],
                                 cache.cross_length))
            new_len = new_kv.length
        logits = self._head(params, x[:, -1:])
        return logits, cache._replace(self_kv=KVCache(kv.k, kv.v, new_len))
