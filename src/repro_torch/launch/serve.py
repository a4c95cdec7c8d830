"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> ...``

Port of ``repro/launch/serve.py``: a batched prefill of seeded random
prompts, then a greedy decode loop, on random weights made from the seed.
It runs on the card (``device="cuda"``, full width and depth) unless the
caller asks for the CPU, where it takes the kernels' plain versions; without
CUDA and without ``device="cpu"`` it raises. The archs are those of
``repro_torch.configs``: tinyllama-1.1b, mamba2-370m, starcoder2-15b,
nemotron-4-15b, qwen3-14b, qwen3-moe-235b-a22b, kimi-k2-1t-a32b,
qwen2-vl-72b, the hybrid jamba-1.5-large-398b and the encoder-decoder
seamless-m4t-large-v2 (1.63 B parameters, 3.3 GB, at full
depth on one card), whose encoder takes seeded random frame embeddings,
``FRAMES_LEN`` of them a prompt (16 with ``reduced=True``, as the
reference's ``serve_loop``). Each of the three 15 B archs holds ~30 GB of
bf16 weights, so one card serves one of them at a time. The two MoE archs
and qwen2-vl serve on one card only at a cut depth: qwen3-moe-235b-a22b
holds 470 GB at its 94 layers (12 layers: 62 GB), kimi-k2-1t-a32b ~2 TB at
its 61 (2 layers: 73 GB), qwen2-vl-72b 145 GB at its 80 (40 layers: 75
GB). jamba-1.5-large-398b holds 795 GB in its 9 period-8 super-blocks, and
one such block, 90.3 GB, does not fit either; one super-block cut to period
4 (``hybrid_period=4, n_layers=4``: 3 Mamba sublayers, attention at 3, MoE
at 1 and 3, every sublayer at its published width) holds 46.0 GB and
serves, a different model from jamba's 1:7 interleave. A model whose
weights exceed the card's memory raises ``ValueError``
naming ROADMAP item A.12 before anything is allocated. qwen2-vl serves as
the reference's serve loop runs it: on tokens alone, with no vision
embeddings and no M-RoPE positions, so its attention takes the 1-D RoPE
(the model's ``forward``, ``prefill`` and ``decode_step`` take both).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import _build
from repro_torch.launch import resolve_device
from repro_torch.models import build_model, init_params
from repro_torch.models.param import tree_items

__all__ = ["FRAMES_LEN", "main", "serve_loop"]

# The encoder's frames a prompt at full width: the JAX package's audio stub
# length (``repro/launch/input_specs.py::FRAMES_LEN``).
FRAMES_LEN = 1024


def serve_loop(arch: str, *, batch: int = 4, prompt_len: int = 32,
               gen_tokens: int = 16, seed: int = 0,
               device: str | torch.device = "cuda",
               reduced: bool = False) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``gen_tokens`` tokens greedily (the first from the prefill's logits).

    Returns ``prefill_s``, ``decode_s``, ``decode_tok_per_s``, ``tokens``
    (batch, gen_tokens), ``logits`` (the last step's, (batch, vocab) fp32
    on the host) and ``peak_bytes``: on the card, the most memory allocated
    from the prefill to the last token (weights, cache and activations; the
    peak statistic is reset before the prefill), else None.
    """
    device = resolve_device(device, "serve_loop")
    cfg = get_config(arch, reduced=reduced)
    max_len = prompt_len + gen_tokens
    cfg = dataclasses.replace(cfg, q_chunk=max(prompt_len // 2, 16),
                              kv_chunk=max(prompt_len // 2, 16),
                              max_cache_len=max_len)
    model = build_model(cfg)
    if device.type == "cuda":
        need = sum(d.size * torch.empty((), dtype=d.dtype).element_size()
                   for _, d in tree_items(model.param_decls()))
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            raise ValueError(
                f"{cfg.name} at {cfg.n_layers} layers: its weights take "
                f"{need / 1e9:.0f} GB, more than the card's "
                f"{have / 1e9:.0f} GB; serving it needs several devices "
                f"(ROADMAP item A.12), or a cut depth")
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(model.param_decls(), gen, device)
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(batch, prompt_len)),
        dtype=torch.int64, device=device)
    encdec = cfg.family == "encdec"
    if encdec:
        # drawn after the prompts, from the same generator, as the
        # reference draws them
        frames_len = 16 if reduced else FRAMES_LEN
        frames = torch.as_tensor(
            rng.normal(size=(batch, frames_len, cfg.d_model))).to(
                torch.bfloat16).to(device)

    on_card = device.type == "cuda"
    if on_card:
        _build.build()               # set-up, outside the timed prefill

    def clock() -> float:
        if on_card:
            torch.cuda.synchronize(device)
        return time.perf_counter()

    with torch.inference_mode():
        if encdec:
            cache = model.init_cache(batch, max_len=max_len,
                                     memory_len=frames_len, device=device)
            inputs = (frames, prompts)
        else:
            cache = model.init_cache(batch, max_len=max_len, device=device)
            inputs = (prompts,)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = clock()
        logits, cache = model.prefill(params, *inputs, cache)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
        t_prefill = clock() - t0
        generated = [tok]
        t0 = clock()
        for _ in range(gen_tokens - 1):
            logits, cache = model.decode_step(params, tok, cache)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            generated.append(tok)
        t_decode = clock() - t0
        peak = torch.cuda.max_memory_allocated(device) if on_card else None
        out_tokens = torch.cat(generated, dim=1).cpu().numpy()
    return {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen_tokens - 1) / max(t_decode, 1e-9),
        "tokens": out_tokens,
        "logits": logits[:, -1].float().cpu(),
        "peak_bytes": peak,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced (CPU-test) width of the arch")
    args = ap.parse_args(argv)
    out = serve_loop(args.arch, batch=args.batch,
                     prompt_len=args.prompt_len, gen_tokens=args.gen_tokens,
                     device=args.device,
                     reduced=args.reduced)
    print(f"[serve] prefill={out['prefill_s']:.3f}s "
          f"decode={out['decode_s']:.3f}s "
          f"({out['decode_tok_per_s']:.1f} tok/s)")
    print(f"[serve] sample tokens: {out['tokens'][0][:8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
