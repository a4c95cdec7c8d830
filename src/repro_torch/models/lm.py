"""Decoder-only LM, families ``dense``, ``moe`` and ``ssm``: port of
``repro/models/lm.py``.

* ``dense`` (tinyllama, starcoder2, nemotron, qwen3): token embedding, a
  stack of layers (RMSNorm -> GQA attention with RoPE, qwen3's with
  qk-norm and zero-masked padded heads -> residual -> RMSNorm -> MLP,
  SwiGLU or plain gelu / squared ReLU -> residual), final RMSNorm, vocab
  head.
* ``moe`` (qwen3-moe): the dense frame with the MLP replaced by the
  mixture of experts of ``moe.py``; ``forward`` also returns the sum of
  the layers' load-balance aux losses.
* ``ssm`` (mamba2): the same frame with layers ``x + mamba(RMSNorm(x))``.

Parameters are the nested dict the schema declares, with a leading stacked
layer axis; a Python loop over that axis takes the place of ``lax.scan``.

Entry points, as in the reference:

* ``loss_fn(params, batch)``            -> next-token cross entropy plus
  ``AUX_COEF`` times the aux loss (train);
* ``forward(params, tokens)``           -> (logits (B, S, V), aux);
* ``prefill(params, tokens, cache)``    -> (last-token logits, cache);
* ``decode_step(params, token, cache)`` -> (logits (B, 1, V), cache).

The cache is written in place (see ``attention.py`` and ``ssm.py``); the
returned cache holds the same buffers (with the advanced length for KV).
Under grad with ``cfg.remat``, each layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``, policy
"full"); the "dots" and "names" policies raise.
Other families raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import KVCache, attention, attention_decls, init_cache
from .common import cross_entropy_loss, matmul, rms_norm
from .config import ModelConfig
from .ffn import mlp, mlp_decls
from .moe import moe, moe_decls
from .param import ArrayDecl, normal_init, ones_init, tree_map
from .ssm import SSMCache, init_ssm_cache, mamba_block, ssm_decls

__all__ = ["LM", "Cache", "AUX_COEF"]

AUX_COEF = 0.01

_PENDING_FAMILIES = {"hybrid": "A.10", "encdec": "A.11", "vlm": "A.7"}


class Cache(NamedTuple):
    """Stacked per-layer serving cache; each family fills its member.

    kv (families dense and moe): kv.k / kv.v are (n_layers, B, max_len,
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
        if cfg.family not in ("dense", "moe", "ssm"):
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
    def _layer(self, lp: dict, x: torch.Tensor, *, cache=None):
        """-> (x, aux, new_kv); aux is 0.0 for an MLP layer."""
        h, new_kv = attention(lp["attn"], rms_norm(x, lp["ln1"]), self.cfg,
                              cache=cache)
        x = x + h
        if "moe" in lp:
            y, aux = moe(lp["moe"], rms_norm(x, lp["ln2"]), self.cfg)
        else:
            y, aux = mlp(lp["mlp"], rms_norm(x, lp["ln2"]), self.cfg), 0.0
        return x + y, aux, new_kv

    def _ssm_layer(self, lp: dict, x: torch.Tensor, *, cache=None):
        """-> (x, aux 0.0, new_ssm)."""
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

    def forward(self, params, tokens: torch.Tensor):
        """tokens: (B, S) -> logits (B, S, V); also returns the aux loss,
        summed over the layers (0.0 without MoE layers)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        layer = self._ssm_layer if cfg.family == "ssm" else self._layer

        def body(lp, x):
            return layer(lp, x)[:2]

        run = body
        if cfg.remat and torch.is_grad_enabled():
            if cfg.remat_policy in ("dots", "names"):
                raise NotImplementedError(
                    f"remat_policy {cfg.remat_policy!r}: ROADMAP item A.3")
            def run(lp, x):
                return checkpoint(body, lp, x, use_reentrant=False,
                                  preserve_rng_state=False)
        # one unbind per stacked leaf: its gradient is one stack, where a
        # slice per layer would add a full-size zero-padded gradient each
        unbound = tree_map(lambda a: a.unbind(0), params["layers"])
        aux = 0.0
        for i in range(cfg.n_layers):
            x, layer_aux = run(tree_map(lambda a: a[i], unbound), x)
            aux = aux + layer_aux
        return self._head(params, x), aux

    def loss_fn(self, params, batch) -> torch.Tensor:
        """batch: {'tokens': (B, S+1), optional 'mask' (B, S)} -> scalar fp32
        next-token cross entropy plus ``AUX_COEF`` times the aux loss (0
        without MoE layers)."""
        tokens = batch["tokens"]
        logits, aux = self.forward(params, tokens[:, :-1])
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

    def _apply_cached(self, params, tokens: torch.Tensor, cache: Cache):
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
                lp, x, cache=KVCache(kv.k[i], kv.v[i], kv.length))
            new_len = new_kv.length
        logits = self._head(params, x[:, -1:])
        return logits, Cache(kv=KVCache(kv.k, kv.v, new_len))

    def prefill(self, params, tokens: torch.Tensor, cache: Cache):
        """tokens: (B, S). Returns (last-token logits (B, 1, V), cache)."""
        return self._apply_cached(params, tokens, cache)

    def decode_step(self, params, token: torch.Tensor, cache: Cache):
        """token: (B, 1). Returns (logits (B, 1, V), cache)."""
        return self._apply_cached(params, token, cache)
