#!/usr/bin/env python3
"""Where the card's model path and the CPU's plain path part, call by call
(card only).

    python3 tools/model_path_diff.py [arch ...]   # repository root

For each arch (default: the four dense archs) a depth-2, full-width model
with the reference's random weights (drawn on the card, copied to the CPU)
runs prefill(64) + decode(1) three times: on the CPU (the plain path), on
the card through the kernels, and on the card through the plain path (the
model's ``blockwise_attention`` and ``decode_attention`` on CUDA tensors,
which the port itself never does). Each attention call's q, k and output
are captured. Printed: the logits of each pair of runs (max |diff| / max
|ref|, argmax equal), the same for each captured call, the kernels against
their plain versions (``flash_attention_plain``, ``decode_attention_plain``:
the Pallas kernels' algorithm) on the kernel run's own inputs, and the
spread of layer 0's scores. ``tools/attention_conditioning.py`` gives the
CPU side of the same finding.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.models.attention as attention  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_plain  # noqa: E402
from repro_torch.models import build_model, init_params  # noqa: E402
from repro_torch.models.param import tree_map  # noqa: E402

DENSE = ("starcoder2-15b", "nemotron-4-15b", "qwen3-14b", "tinyllama-1.1b")
KERNELS = (attention._prefill_core, attention._decode_core)


def plain_prefill(q, k, v, cfg, causal=True):
    return attention.blockwise_attention(q, k, v, causal=causal,
                                         q_chunk=cfg.q_chunk,
                                         kv_chunk=cfg.kv_chunk)


def plain_decode(q, cache):
    return attention.decode_attention(q, cache)


def rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def run(model, params, toks, dev, cores):
    """(decode logits, captured calls) of prefill(64) + decode(1) with the
    attention cores ``cores``."""
    calls = []

    def prefill(q, k, v, cfg, *args):
        out = cores[0](q, k, v, cfg, *args)
        calls.append(("prefill", q, k, v, None, out))
        return out

    def decode(q, cache):
        out = cores[1](q, cache)
        calls.append(("decode", q, cache.k, cache.v, cache.length, out))
        return out
    attention._prefill_core, attention._decode_core = prefill, decode
    try:
        with torch.inference_mode():
            cache = model.init_cache(2, 72, device=dev)
            _, cache = model.prefill(params, toks[:, :64].to(dev), cache)
            logits, _ = model.decode_step(params, toks[:, 64:].to(dev), cache)
    finally:
        attention._prefill_core, attention._decode_core = KERNELS
    return logits[:, 0].float().cpu(), calls


def main(archs) -> int:
    if not torch.cuda.is_available():
        print("model_path_diff: no CUDA device", file=sys.stderr)
        return 2
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch), n_layers=2, q_chunk=32,
                                  kv_chunk=32, max_cache_len=72)
        model = build_model(cfg)
        on_card = init_params(model.param_decls(),
                              torch.Generator(device="cuda").manual_seed(0),
                              "cuda")
        on_cpu = tree_map(lambda a: a.cpu(), on_card)
        toks = torch.randint(0, cfg.vocab, (2, 65),
                             generator=torch.Generator().manual_seed(1))
        runs = {"cpu": run(model, on_cpu, toks, "cpu", KERNELS),
                "card, kernels": run(model, on_card, toks, "cuda", KERNELS),
                "card, plain": run(model, on_card, toks, "cuda",
                                   (plain_prefill, plain_decode))}
        for a, b in (("card, kernels", "cpu"), ("card, plain", "cpu"),
                     ("card, kernels", "card, plain")):
            (la, ca), (lb, cb) = runs[a], runs[b]
            print(f"{arch} {a} vs {b}: logits rel {rel(la, lb):.4f}, argmax "
                  f"equal {bool((la.argmax(-1) == lb.argmax(-1)).all())}")
            for i, (x, y) in enumerate(zip(ca, cb)):
                print(f"    call {i} ({x[0]}): q rel {rel(x[1], y[1]):.4f}, "
                      f"k rel {rel(x[2], y[2]):.4f}, out rel "
                      f"{rel(x[5], y[5]):.4f}")
        for kind, q, k, v, length, out in runs["card, kernels"][1]:
            want = (flash_attention_plain(q, k, v, causal=True)
                    if kind == "prefill"
                    else decode_attention_plain(q, k, v, length))
            print(f"    {kind} kernel against its plain version on the "
                  f"model's inputs: max_abs_err "
                  f"{float((out.float() - want.float()).abs().max()):.3e}, "
                  f"|out| max {float(want.float().abs().max()):.3e}")
        _, q, k, _, _, _ = runs["card, kernels"][1][0]
        G, D = q.shape[2] // k.shape[2], q.shape[-1]
        scores = torch.einsum(
            "bqhgd,bkhd->bhgqk",
            q.float().reshape(*q.shape[:2], k.shape[2], G, D),
            k.float()) / D ** 0.5
        print(f"    layer-0 scores: std {float(scores.std()):.1f}, max "
              f"{float(scores.abs().max()):.1f}", flush=True)
        del on_card, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or DENSE))
