#!/usr/bin/env python3
"""What the flash backward's checks can tell apart, on the CPU.

    PYTHONPATH=src python3 tools/flash_bwd_tolerance.py   # repository root

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the backward kernel
(``src/repro_torch/csrc/flash_attention_bwd.cu``) to
||got - want|| / ||want|| <= 1e-2 in bf16, and ``chip_smoke.py``'s depth-2
train check holds each leaf's gradient to 3e-2 of its norm. This script
gives the numbers those limits rest on:

- kernel: the bf16 kernel's rounding, emulated in fp64 (P = exp(s - lse)
  from the forward's lse, which is fp32; P and dS enter the products
  rounded to bf16; delta = rowsum(dO o) reads the forward's bf16 output;
  dq, and dk/dv after the fp32 partial sums of the row ranges are added,
  are rounded to bf16 once), against the exact gradient rounded to bf16, at the training shape cut to batch 2 (B=2, S=512, H=32, Hk=4,
  D=64, causal, standard normal inputs); and the error of planted faults
  (dv or dk scaled by 0.9 past key 128, dv zeroed or dq scaled by 0.9 on
  the last 12% of positions);
- model: depth-2, full-width tinyllama-1.1b, bf16, batch 2 x 256 tokens,
  with its attention weights at std 1/sqrt(fan-in): each leaf's gradient
  from the plain path against two other correct computations (the exact
  softmax in place of the blockwise one; fp32 weights and activations) and
  against a backward whose dv is 10% low past a quarter of the keys.

Prints one line per reading and, last, all of them as one JSON object.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def grad_err(got, want) -> float:
    """||got - want|| / ||want|| (Frobenius)."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _bf16(t):
    return t.to(torch.bfloat16).double()


def backward(q, k, v, do, *, causal=True, kernel_rounding=False):
    """dq, dk, dv of causal GQA attention in fp64, model layout: q, do
    (B, S, H, D); k, v (B, S, Hk, D). With ``kernel_rounding``, P comes
    from the rows' log-sum-exp rounded to fp32 (the forward's lse), and P,
    dS and the forward's output round to bf16 where the bf16 kernels round
    them. Both results are rounded to bf16 at the end, as the kernel's and
    the plain version's outputs are (the kernel accumulates in fp32 and sums
    its fp32 partials before that one rounding: ~1e-6 of the norm, far
    under bf16's)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qh, doh = (t.double().transpose(1, 2) for t in (q, do))      # B H S D
    kh, vh = (t.double().transpose(1, 2).repeat_interleave(G, 1)
              for t in (k, v))
    s = qh @ kh.transpose(-1, -2) / math.sqrt(D)
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    if kernel_rounding:
        lse = torch.logsumexp(s, -1, keepdim=True).float().double()
        p = torch.exp(s - lse)
    else:
        p = torch.softmax(s, -1)
    o = p @ vh
    if kernel_rounding:
        o = _bf16(o)
    ds = p * (doh @ vh.transpose(-1, -2) - (doh * o).sum(-1, keepdim=True))
    if kernel_rounding:
        p, ds = _bf16(p), _bf16(ds)
    dq = ds @ kh / math.sqrt(D)
    dk = (ds.transpose(-1, -2) @ qh / math.sqrt(D)).unflatten(
        1, (-1, G)).sum(2)
    dv = (p.transpose(-1, -2) @ doh).unflatten(1, (-1, G)).sum(2)
    return tuple(_bf16(t.transpose(1, 2)) for t in (dq, dk, dv))


def planted_faults(grads, S: int) -> dict:
    """name -> (index of the gradient, the faulty copy of it)."""
    dq, dk, dv = grads
    tail = S - S * 12 // 100

    def scaled(g, start, factor):
        bad = g.clone()
        bad[:, start:] *= factor
        return bad
    return {"dv x 0.9 past key 128": (2, scaled(dv, 128, 0.9)),
            "dk x 0.9 past key 128": (1, scaled(dk, 128, 0.9)),
            "dv = 0 on the last 12% of keys": (2, scaled(dv, tail, 0.0)),
            "dq x 0.9 on the last 12% of rows": (0, scaled(dq, tail, 0.9))}


def kernel_readings(B=2, S=512, H=32, Hk=4, D=64, seed=0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(B, S, H, D, generator=gen).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, S, Hk, D, generator=gen).bfloat16()
            for _ in range(2))
    want = backward(q, k, v, do)
    got = backward(q, k, v, do, kernel_rounding=True)
    out = {f"rounding {n}": grad_err(g, w)
           for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    for name, (i, bad) in planted_faults(got, S).items():
        out[name] = grad_err(bad, want[i])
    return out


def model_readings(seq=256, seed=0) -> dict:
    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import build_model, init_params
    from repro_torch.models.param import tree_items, tree_map
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2,
                              remat=False, q_chunk=seq // 2,
                              kv_chunk=seq // 2)
    params = init_params(build_model(cfg).param_decls(),
                         torch.Generator().manual_seed(seed), "cpu")
    attn = params["layers"]["attn"]
    for n in ("wq", "wk", "wv"):            # (L, M, H, D): fan-in M
        attn[n] = (attn[n].float() * math.sqrt(attn[n].shape[-2]
                                               / cfg.d_model)).bfloat16()
    attn["wo"] = (attn["wo"].float() / math.sqrt(      # (L, H, D, M)
        attn["wo"].shape[-3])).bfloat16()
    toks = torch.as_tensor(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=2)).batch_at(0)["tokens"])
    blockwise = attention._prefill_core

    class LowDv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v):
            return v.view_as(v)

        @staticmethod
        def backward(ctx, g):
            g = g.clone()
            g[:, seq // 4:] *= 0.9
            return g

    def exact(q, k, v, cfg, causal=True):
        return flash_attention_plain(q, k, v, causal=causal)

    def low_dv(q, k, v, cfg, *args):
        return blockwise(q, k, LowDv.apply(v), cfg, *args)

    def grads(core, dtype):
        model = build_model(cfg)
        if dtype is torch.float32:       # the model casts the embedding
            model._embed = lambda p, tokens: p["embed"][tokens]
        leaves = tree_map(lambda a: a.to(dtype, copy=True).requires_grad_(),
                          params)
        attention._prefill_core = core
        try:
            model.loss_fn(leaves, {"tokens": toks}).backward()
        finally:
            attention._prefill_core = blockwise
        return {"/".join(p): t.grad for p, t in tree_items(leaves)}

    base = grads(blockwise, torch.bfloat16)
    others = {"exact softmax": grads(exact, torch.bfloat16),
              "fp32": grads(blockwise, torch.float32),
              "dv 10% low past a quarter of the keys":
                  grads(low_dv, torch.bfloat16)}
    out = {}
    for name, g in others.items():
        errs = {k: grad_err(g[k], w) for k, w in base.items()}
        top = max(errs, key=errs.get)
        out[f"{name}: worst leaf"] = top
        out[f"{name}: worst leaf error"] = errs[top]
    return out


def main() -> int:
    torch.manual_seed(0)
    readings = {"kernel": kernel_readings(), "model": model_readings()}
    for part, values in readings.items():
        for name, value in values.items():
            print(f"[{part}] {name}: {value}")
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
