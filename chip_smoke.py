#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` (flash_attention,
   flash_attention_bwd, decode_attention, ssd, ssd_bwd) for ``sm_90a`` into
   ``build/repro_torch/`` (one process per source, in parallel);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main paths' shapes and at the edges of their designs (decode:
   lengths on the key-split boundaries, G = 1 and 16, D = 128, a batch-1
   8192-key cache, the stale tail, a CUDA-graph replay; flash: ragged S,
   D = 128, G = 1, a 2048-token prompt; flash backward: the training shape,
   ragged S, G = 1, D = 128, a 2048-token sequence, fp32; ssd: zero and
   random state0, dt in bf16, fp32, ragged S, S = 513, P = 8, an in-place
   update of a stacked cache, a batch-1 8192-token prompt; ssd backward:
   the training shape in bf16 and fp32, random state0 with a final-state
   cotangent, a ragged S, P = 8, a 2048-token sequence; and the 15 B archs'
   heads at D = 128, G = 12 (starcoder2) and G = 6 (nemotron, qwen3): flash
   forward and decode at their serving shapes, the backward at 2 x 256
   tokens with planted faults on the G = 12 blocks' edges; qwen3-moe's
   heads, G = 16 at D = 128: flash at its serving shape and a ragged S,
   decode at its serving shape, G x D at the kernel's limit, the backward
   at its training shape (8 x 512 tokens; timed, with SDPA's backward
   beside it; the record's "g16" entry) and a ragged S, with planted
   faults on the G = 16 blocks' edges; kimi-k2's
   heads, G = 8 at D = 112, in bf16 and fp32: flash at its serving shape
   and a ragged S, decode at its serving shape; seamless-m4t's heads,
   G = 1 at D = 64: flash non-causal at 8 x 1024 (the encoder), causal at
   8 x 512 (the decoder's prefill), non-causal with 512 queries over 1024
   keys (the cross-attention) and at ragged Sq < Skv and Sq > Skv in bf16
   and fp32, decode over an fp32 cache at the serving lengths and over a
   bf16 memory of 1024 keys, all read; the backward at the encoder's
   non-causal 8 x 1024, the cross-attention's non-causal 512 queries over
   1024 keys and the decoder's causal 8 x 512 (timed, with planted faults
   at the first two), 1024 queries over 512 keys, fp32, ragged Sq != Skv
   and causal Sq != Skv; qwen2-vl's heads, G = 8 at D = 128: flash at its
   prefill shape, causal (timed with and without lse) and not, bf16 and
   fp32, and a ragged S, decode at its serving shape, the backward at its
   training shape (timed, with planted faults on the G = 8 blocks' edges)
   and a ragged S; jamba's SSD at its prefill shape, 256 heads of P = 64,
   N = 128, state0 and state_out a slice of a zeroed stacked cache, timed),
   to bf16 2e-2
   and fp32 2e-5 absolute (the JAX package's kernel tolerances; 5x those
   relative for ssd's output and 1e-4 relative for its final state and the
   chunk states it writes for the backward; each gradient of the two
   backward kernels within 1e-2 of its norm in bf16 and 1e-4 in fp32, and
   planted faults shown to fail that rule; TF32 off), with CUDA-event
   times of the kernel, the plain version and, where one exists, one
   PyTorch library call as a yardstick, and the least time the card could
   take (``bound_ms``);
4. main paths, each at full width and depth on seeded random weights:
   ``serve_loop("tinyllama-1.1b")`` (flash and decode attention),
   ``serve_loop("mamba2-370m")`` (ssd at prefill; decode is the plain
   recurrence) and ``serve_loop`` of starcoder2-15b, nemotron-4-15b and
   qwen3-14b (flash and decode attention; ~30 GB of weights each, one on
   the card at a time) and of qwen3-moe-235b-a22b at full width cut to 12
   of its 94 layers (62 GB; its MoE layers in plain torch, flash and decode
   at G = 16) and of kimi-k2-1t-a32b at full width cut to 2 of its 61
   layers (73 GB; 384 experts and a shared expert, flash and decode at
   G = 8, D = 112) and of qwen2-vl-72b at full width cut to 40 of its 80
   layers (75.2 GB; tokens only, as the reference's serve loop runs it;
   flash and decode at G = 8, D = 128) and of jamba-1.5-large-398b
   cut to one super-block of period 4 (``cut_hybrid``: 3 Mamba sublayers,
   attention at 3, MoE at 1 and 3, each at its published width, 45.96 GB;
   a different model from jamba's 1:7 interleave; flash 1, decode 31 and
   ssd 3 launches, no other kernel) and of the encoder-decoder
   seamless-m4t-large-v2 at
   full width and full depth (24 + 24 layers, 3.26 GB; 1024 frames a
   prompt; flash 72 launches at the prefill, decode 48 a step), batch 8,
   512-token prompts, 32 new tokens; and
   ``train_loop("tinyllama-1.1b")`` (flash forward and backward), batch 8,
   512 tokens, ``train_loop("mamba2-370m")`` (ssd forward and
   backward) and ``train_loop("qwen3-moe-235b-a22b")`` at full width cut
   to 1 of its 94 layers (44.8 GB of training state; flash forward and
   backward at G = 16, D = 128; 805 M-element expert leaves under AdamW;
   ms a step, tokens/s, 6·N_active·tokens/s / 989 TFLOP/s, the peak held
   within 1.05 x AdamW's derived peak: the state plus 7 fp32 temporaries
   of the largest leaf) and ``train_loop("qwen2-vl-72b")`` at full width
   cut to 1 of its 80 layers (40.4 GB of training state; flash at G = 8,
   D = 128; the peak held alike, 70.14 GiB derived), the same shape, remat
   "full", on the synthetic pipeline; and seamless-m4t-large-v2 at full width and depth trained
   through ``setup_training``'s step on ``batch_at``'s ``{'frames',
   'tokens'}`` batches (``train_loop`` refuses the family, as the
   reference's does): 8 x 512 tokens over 1024 frames, remat, 19.6 GB of
   training state; the flash forward twice and the backward once for each
   of its 72 attention calls a step. Each is called once to warm up
   (the first call of each shape pays one-time library and module-loading
   costs) and once counted, its kernels' launch counts set to 0 just
   before and read just after: they must show every layer of the counted
   run went through them;
5. profile: ``torch.profiler`` over a few decode steps of tinyllama, mamba2,
   starcoder2-15b, the 12-layer qwen3-moe, the 2-layer kimi-k2, the
   40-layer qwen2-vl, the period-4 jamba block (its device time split
   into Mamba, attention, MoE and MLP sublayers) and
   seamless-m4t (its two decode kernels' device ms apart) (beside
   the bytes a step must read; the MoE archs' device time also split into
   routing, dispatch, expert products, combine and attention), one
   seamless-m4t prefill (1024 frames; the flash kernel's and the GEMMs'
   shares), one mamba2 prefill and one train step of each trained model
   (qwen3-moe and qwen2-vl at 1 layer), for the device's busy share and
   the kernels
   that take its time (at prefill, the ssd kernel's share; in training,
   of each trained model and of seamless-m4t, the flash or ssd forward's
   and backward's, the GEMMs', the elementwise work's, the expert
   products' (``aten::bmm``), the kernels inside ``adamw_update`` and the
   rest; and AdamW's alone);
6. model check (attention weights at std 1/sqrt(fan-in), where the
   reference's draw saturates the softmax: ``model_check``): jamba's
   period-4 block at full width first (its host copy 46.0 GB; the MoE
   rules, each Mamba sublayer's scan y, output and state, and four faults
   of its own: the attention at sublayer 2 in place of 3, a decode step
   from a zeroed SSM state, the ssd kernel's y zeroed in its last chunk,
   a Mamba output dropped at decode), a depth-2,
   full-width model of each of six archs, and kimi-k2 at depth 1 (the
   host holds a copy of the weights: 38.8 GB), on the card against the
   same model on the CPU's plain path (relative error < 0.06, equal
   argmax; kimi-k2's own-routing logits are printed, not held: a decode
   choice routes apart at a near-tie; the MoE archs' routing held call by
   call: few choices apart, each a near-tie that the router logits'
   difference accounts for, the gates of the rest alike; the card's logits
   again with the CPU's routing fed to its MoE layers, and its router
   logits; four planted faults, each of which must break a rule);
   seamless-m4t at full width cut to 2 encoder and 2 decoder layers
   (``encdec_model_check``: prefill of 64 tokens over 64 frames + decode,
   the logits and each layer's decode-step cross-attention output rel <
   0.06, equal argmax; a planted fault, the card's cross length half the
   memory, must break a rule) and its train step (``encdec_train_check``:
   2 x 256 tokens over 512 frames, remat on the card, against the CPU:
   loss, every leaf, each of the 6 attention calls' backward-kernel
   gradients; two planted faults, the cross-attention's backward run
   causal and the memory detached before the decoder, must each break a
   rule); qwen2-vl-72b at full width cut to 2 layers (``vlm_model_check``:
   forward over 64 tokens whose first 16 are vision embeddings, and
   prefill(64) + decode(1), each with Qwen2-VL's 3-D positions; the
   logits and layer 0's attention output rel < 0.06, equal argmax; a
   planted 1-D RoPE on the card must break a rule in both); one
   full-width qwen3-moe MoE layer at a decode step's and a prefill's shape
   in each dispatch mode captured in a CUDA graph and replayed after its
   input changes on the device, bit for bit an eager call, with its device
   ms (``moe_graph_check``); a bf16 train step of tinyllama and qwen3-14b
   at depth 2, of starcoder2 and nemotron at depth 1
   (``TRAIN_CHECK_15B_DEPTH``) and of qwen2-vl at depth 1 (with 16
   vision embeddings and 3-D positions) on the card against the CPU (loss
   1e-2 relative,
   each gradient within 3e-2 of its norm, each layer's backward-kernel
   gradients against the plain backward on the same captured tensors
   within 1e-2 of their norm); the same step of a depth-2 mamba2 (each
   gradient within 3e-2 of its norm); the same step of a depth-2
   qwen3-moe (``moe_train_check``: 2 x 256 tokens, the CPU's experts fed
   to the card's MoE layers, in both dispatch modes, remat off and under
   "full", "dots" and "names"; its own-routing step printed, not held);
   one depth-1 qwen3-moe step at 8 x 512 tokens under each remat policy
   and without remat, with its ms, peak and flash launches
   (``remat_policy_steps``); for tinyllama and mamba2 a crash
   after step 4 and a resume from the checkpoint saved there, reproducing
   the uninterrupted losses (tinyllama rtol 2e-2, mamba2 bit for bit);
7. orchestrate (``orchestrate_check``): tinyllama's train step under the
   port's DFlow engine (``runtime/orchestrator.py::run_training``). At
   depth 2 and full width, with a checkpoint every 2 steps, its losses and
   checkpoints against ``train_loop``'s (rtol 2e-2), also with a save that
   waits for the next step before it snapshots; at full depth and width
   (batch 8 x 512, remat, 6 steps) ``train_loop`` and the DAG under
   "dataflow" and "controlflow": ms a step, 44 flash forward and 22
   backward launches a step in the DAG's threads (set to 0 before each
   run, read after), the engine's per-function times, and each peak
   within 1.05x of ``train_loop``'s; then "dataflow, traced", the same
   job with the port's DScope on (``orchestrate_trace``): the engine's
   ``Tracer`` and its store's ``MetricsRegistry``, one request span and
   an invoke span a function nested in it, the spans' attribution against
   the DAG's own DPlan, in process and through ``python -m
   repro_torch.obs``, the same launches and, within rtol 2e-2, the same
   losses as the untraced "dataflow" run.

The run's whole time is printed when every phase has passed. The line
before the last is the kernels' JSON record (the flash and decode entries
also hold their D = 112 rows, "d112" in bf16 and "d112_f32", and
seamless-m4t's, "seamless", with the launches of its counted serve_loop
and a record for each of its timed shapes; the flash backward its G = 16
row, "g16", with its launches on the qwen3-moe training path, and
seamless-m4t's, "seamless", with the launches of its counted training run
and a record for each of its three timed shapes; the flash, decode and
backward entries qwen2-vl's G = 8, D = 128 row, "qwen2vl", with the
launches of its counted serve_loop or training run; the flash and decode
entries jamba's launches, "jamba", at qwen2-vl's timed shape, and the ssd
entry jamba's H = 256 row, "jamba", with its launches); the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository around it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12              # outside the tensor cores
PEAK_BYTES = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call; the 64 MB L2 is flushed before
    each timed call, as the serving path finds these inputs cold. After the
    flush the card is held busy (``torch.cuda._sleep``, about 2-3 ms) while
    the host enqueues the timed call, so the events time device work and not
    the host's launch path."""

    HOLD_CYCLES = 5_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 30, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.HOLD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(flops: float, nbytes: float, flops_peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_ms(torch, timer, q, k, v, causal: bool):
    """One library call on the same inputs (model layout), or None for a
    torch without ``enable_gqa``."""
    F = torch.nn.functional
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    try:
        return timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
    except TypeError:
        return None


LSE_TOL = 1e-4


def peak_flops(torch, dtype) -> float:
    return PEAK_BF16_FLOPS if dtype is torch.bfloat16 else PEAK_FP32_FLOPS


def check_flash(torch, timer, gen) -> dict:
    """The flash kernel against its plain version at the prefill shape (bf16
    causal and full, fp32), a ragged S, D = 128, G = 1 and a long B = 1
    prompt, and kimi-k2's D = 112 (the 128 tile with its last 16 columns
    zero) at its prefill shape in bf16 and fp32 and at a ragged S,
    qwen2-vl's G = 8 at D = 128 at its prefill shape in bf16 and fp32 and
    at a ragged S, and seamless-m4t's G = 1 heads: the encoder's non-causal 8 x 1024, the
    decoder's causal 8 x 512, the cross-attention's 512 queries over 1024
    keys, and ragged cross shapes with Sq < Skv and Sq > Skv (bf16 and
    fp32); the serving shapes, kimi-k2's, qwen2-vl's and seamless's
    included, and the long prompt are timed, each with its own causal flag. A row's S is
    Sq = Skv, or the pair (Sq, Skv). Each row names the record it goes
    into: "" (the kernel's own entry, whose time is the bf16 serving
    shape's), "d112", "d112_f32", "qwen2vl" or "seamless_<shape>"; a record's
    max_abs_err is its rows' worst and its time its first timed row's. At
    each shape the rows' log-sum-exp that the kernel writes when asked (the
    training forward) is held to ``flash_attention_lse_plain`` within
    ``LSE_TOL`` (1e-4 absolute, fp32: the kernel sums 2^x from ex2.approx,
    ~2 ulp each, with an online rescaling, where the plain version takes an
    exact fp32 logsumexp; |lse| stays under ~10 here), and the output with
    lse asked for must equal the one without. Each timed shape is timed
    with lse ("lse_ms", the training forward) and without ("ms")."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_lse_plain,
        flash_attention_plain)
    errs, rows = {}, {}
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, Hk, D, dtype, causal, timed, record)
    for label, B, S, H, Hk, D, dtype, causal, timed, key in (
            ("serving", 8, 512, 32, 4, 64, bf16, True, True, ""),
            ("serving", 8, 512, 32, 4, 64, bf16, False, False, ""),
            ("serving", 8, 512, 32, 4, 64, f32, True, False, None),
            ("ragged", 2, 100, 32, 4, 64, bf16, True, False, ""),
            ("ragged", 2, 100, 32, 4, 64, bf16, False, False, ""),
            ("d128", 2, 256, 32, 4, 128, bf16, True, False, ""),
            ("g1", 2, 256, 8, 8, 64, bf16, True, False, ""),
            ("long", 1, 2048, 32, 4, 64, bf16, True, True, ""),
            # the 15 B archs' prefill at D = 128: starcoder2's G = 12 (5
            # positions a block, rows 60-63 dead), nemotron's and qwen3's
            # G = 6 (10 positions); a ragged S at G = 12
            ("g12", 8, 512, 48, 4, 128, bf16, True, True, ""),
            ("g6", 8, 512, 48, 8, 128, bf16, True, True, ""),
            ("ragged-g12", 2, 100, 48, 4, 128, bf16, True, False, ""),
            # qwen3-moe's prefill: G = 16 at D = 128, 4 positions a block,
            # and a ragged S at that group
            ("g16-d128", 8, 512, 64, 4, 128, bf16, True, True, ""),
            ("ragged-g16-d128", 2, 100, 64, 4, 128, bf16, True, False, ""),
            # kimi-k2's prefill: G = 8 at D = 112, in bf16 and fp32, and a
            # ragged S at that shape
            ("kimi-d112", 8, 512, 64, 8, 112, bf16, True, True, "d112"),
            ("kimi-d112", 8, 512, 64, 8, 112, bf16, False, False, "d112"),
            ("kimi-d112", 8, 512, 64, 8, 112, f32, True, True, "d112_f32"),
            ("ragged-kimi-d112", 2, 100, 64, 8, 112, bf16, True, False,
             "d112"),
            ("ragged-kimi-d112", 2, 100, 64, 8, 112, f32, True, False,
             "d112_f32"),
            # qwen2-vl-72b's prefill and training forward: G = 8 at D =
            # 128 (8 positions a block), causal (timed, with and without
            # lse) and not, bf16 and fp32, and a ragged S
            ("qwen2vl", 8, 512, 64, 8, 128, bf16, True, True, "qwen2vl"),
            ("qwen2vl", 8, 512, 64, 8, 128, bf16, False, False, "qwen2vl"),
            ("qwen2vl", 8, 512, 64, 8, 128, f32, True, False, None),
            ("ragged-qwen2vl", 2, 100, 64, 8, 128, bf16, True, False,
             "qwen2vl"),
            ("ragged-qwen2vl", 2, 100, 64, 8, 128, bf16, False, False,
             "qwen2vl"),
            ("ragged-qwen2vl", 2, 100, 64, 8, 128, f32, False, False, None),
            # seamless-m4t's heads, H = Hk = 16 at D = 64 (G = 1): the
            # encoder's non-causal self-attention over 1024 frames, the
            # decoder's causal prefill, the cross-attention of the 512
            # prompt tokens over the 1024-frame memory (S = (Sq, Skv)), and
            # ragged cross shapes with fewer and with more queries than keys
            ("seamless-encoder", 8, 1024, 16, 16, 64, bf16, False, True,
             "seamless_encoder"),
            ("seamless-prefill", 8, 512, 16, 16, 64, bf16, True, True,
             "seamless_prefill"),
            ("seamless-cross", 8, (512, 1024), 16, 16, 64, bf16, False, True,
             "seamless_cross"),
            ("ragged-cross", 2, (100, 200), 16, 16, 64, bf16, False, False,
             "seamless_cross"),
            ("ragged-cross", 2, (200, 100), 16, 16, 64, bf16, False, False,
             "seamless_cross"),
            ("ragged-cross", 2, (100, 200), 16, 16, 64, f32, False, False,
             None),
            ("ragged-cross", 2, (200, 100), 16, 16, 64, f32, False, False,
             None)):
        Sq, Skv = S if isinstance(S, tuple) else (S, S)
        q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, Skv, Hk, D, generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn(B, Skv, Hk, D, generator=gen,
                        device="cuda").to(dtype)
        got = flash_attention_cuda(q, k, v, causal=causal)
        with_lse, lse = flash_attention_cuda(q, k, v, causal=causal,
                                             return_lse=True)
        want = flash_attention_plain(q, k, v, causal=causal)
        want_lse = flash_attention_lse_plain(q, k, causal=causal)
        torch.cuda.synchronize()
        err, lse_err = max_err(got, want), max_err(lse, want_lse)
        name = str(dtype).split(".")[1]
        log(f"[kernels] flash_attention {label} {name} causal={causal} "
            f"B={B} Sq={Sq} Skv={Skv} H={H} Hk={Hk} D={D}: "
            f"max_abs_err={err:.3e} "
            f"(tol {TOL[name]:g}); lse max_abs_err={lse_err:.3e} (tol "
            f"{LSE_TOL:g}, |lse| max {float(want_lse.abs().max()):.3f})")
        if not err < TOL[name]:
            raise AssertionError(f"flash_attention {label} {name} "
                                 f"causal={causal}: max_abs_err {err} >= "
                                 f"{TOL[name]}")
        if not (lse_err < LSE_TOL and torch.equal(with_lse, got)):
            raise AssertionError(f"flash_attention {label} {name} "
                                 f"causal={causal}: lse max_abs_err "
                                 f"{lse_err} (tol {LSE_TOL}), or the output "
                                 f"changed when lse was asked for")
        if key is not None:
            errs[key] = max(errs.get(key, 0.0), err)
        if not timed:
            continue
        ms = timer.ms(lambda: flash_attention_cuda(q, k, v, causal=causal))
        lse_ms = timer.ms(lambda: flash_attention_cuda(
            q, k, v, causal=causal, return_lse=True))
        plain_ms = timer.ms(
            lambda: flash_attention_plain(q, k, v, causal=causal), iters=10)
        lib_ms = sdpa_ms(torch, timer, q, k, v, causal=causal)
        # causal rows are square: half the score matrix
        flops = 4 * B * H * Sq * Skv * D / (2 if causal else 1)
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                     + q.numel())
        b_ms, b_by = bound(flops, nbytes, peak_flops(torch, dtype))
        log(f"[kernels] flash_attention {label} {name} causal={causal} "
            f"B={B} Sq={Sq} Skv={Skv} H={H} Hk={Hk} D={D}: "
            f"{ms:.4f} ms, with lse {lse_ms:.4f} ms (plain {plain_ms:.4f} "
            f"ms, sdpa {lib_ms} ms, bound {b_ms:.4f} ms by {b_by})")
        if key is not None:
            rows.setdefault(key, {"ms": ms, "lse_ms": lse_ms,
                                  "plain_ms": plain_ms,
                                  "library_ms": lib_ms, "bound_ms": b_ms,
                                  "bound_by": b_by})
    return _records(rows, errs)


def _records(rows: dict, errs: dict) -> dict:
    """A kernel's JSON entry: the "" record's numbers, and each other
    record ("d112", ...) under its key, each with its rows' worst error."""
    rec = dict(rows.pop(""), max_abs_err=errs.pop(""))
    rec.update({key: dict(row, max_abs_err=errs[key])
                for key, row in rows.items()})
    return rec


def check_decode(torch, timer, gen) -> dict:
    """The decode kernel against its plain version: the serving shape at
    lengths on the split boundaries, G = 1, G = 16, D = 128, fp32, a batch-1
    8192-key cache; the stale tail; a call captured in a CUDA graph and
    replayed after `length` changes on the device; kimi-k2's D = 112 at G =
    8 in bf16 and fp32 (28 lanes to a key row in the fp32 kernel) at the
    serving shape's lengths; qwen2-vl's G = 8 at D = 128 at the same
    lengths; seamless-m4t's G = 1, D = 64 step over its
    fp32 self cache (L = 544, the serving lengths) and over its bf16
    memory (L = length = 1024). The serving shapes, kimi-k2's in both
    dtypes, qwen2-vl's, seamless's two and the long cache are timed. Each row names
    its record, as in ``check_flash``."""
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    from repro_torch.kernels.decode_attention.kernel import keys_per_split
    split = keys_per_split()
    B, L, H, Hk, D = 8, 544, 32, 4, 64
    timed_len = 528           # the mean cache length of the serving path
    edges = (1, split - 1, split, split + 1, 300, timed_len, L)
    errs, rows = {}, {}
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, L, H, Hk, D, dtype, lengths, timed length, record)
    for label, Bc, Lc, Hc, Hkc, Dc, dtype, lengths, timed, key in (
            ("serving", B, L, H, Hk, D, bf16, edges, timed_len, ""),
            ("serving", B, L, H, Hk, D, f32, (split, 300), None, None),
            ("g1", 2, L, 4, 4, D, bf16, (1, split + 1, L), None, ""),
            ("g16", 2, L, 64, 4, D, bf16, (1, split + 1, L), None, ""),
            ("d128", 2, L, 32, 4, 128, bf16, (1, split + 1, L), None, ""),
            ("long", 1, 8192, H, Hk, D, bf16, (8000,), 8000, ""),
            # the 15 B archs' decode: G = 12 (starcoder2, 12 of the 16 MMA
            # rows at work) and G = 6 (nemotron, qwen3), D = 128
            ("g12", B, L, 48, 4, 128, bf16, edges, timed_len, ""),
            ("g6", B, L, 48, 8, 128, bf16, edges, timed_len, ""),
            # qwen3-moe's decode: G = 16 at D = 128, G x D = 2048, the
            # kernel's limit
            ("g16-d128", B, L, 64, 4, 128, bf16, edges, timed_len, ""),
            # kimi-k2's decode: G = 8 at D = 112, bf16 and fp32
            ("kimi-d112", B, L, 64, 8, 112, bf16, edges, timed_len, "d112"),
            ("kimi-d112", B, L, 64, 8, 112, f32, edges, timed_len,
             "d112_f32"),
            # qwen2-vl-72b's decode: G = 8 at D = 128
            ("qwen2vl", B, L, 64, 8, 128, bf16, edges, timed_len,
             "qwen2vl"),
            # seamless-m4t's decode step, H = Hk = 16 at D = 64: the
            # decoder's fp32 self cache at the serving lengths (513-543),
            # and the bf16 memory of 1024 frames, read whole
            ("seamless-self", B, L, 16, 16, 64, f32,
             (1, split, split + 1, 513, timed_len, 543, L), timed_len,
             "seamless_self_f32"),
            ("seamless-cross", B, 1024, 16, 16, 64, bf16, (1024,), 1024,
             "seamless_cross")):
        name = str(dtype).split(".")[1]
        # one layer's view of a stacked cache, as the model passes it
        cache_k = torch.randn(2, Bc, Lc, Hkc, Dc, generator=gen,
                              device="cuda").to(dtype)
        cache_v = torch.randn(2, Bc, Lc, Hkc, Dc, generator=gen,
                              device="cuda").to(dtype)
        k, v = cache_k[1], cache_v[1]
        q = torch.randn(Bc, 1, Hc, Dc, generator=gen, device="cuda").to(dtype)
        for n in lengths:
            length = torch.tensor(n, dtype=torch.int32, device="cuda")
            got = decode_attention_cuda(q, k, v, length)
            want = decode_attention_plain(q, k, v, length)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"[kernels] decode_attention {label} {name} B={Bc} L={Lc} "
                f"H={Hc} Hk={Hkc} D={Dc} length={n}: max_abs_err={err:.3e} "
                f"(tol {TOL[name]:g})")
            if not err < TOL[name]:
                raise AssertionError(f"decode_attention {label} {name} "
                                     f"length={n}: max_abs_err {err} >= "
                                     f"{TOL[name]}")
            if key is not None:
                errs[key] = max(errs.get(key, 0.0), err)
            if n != timed:
                continue
            ms = timer.ms(lambda: decode_attention_cuda(q, k, v, length))
            plain_ms = timer.ms(lambda: decode_attention_plain(q, k, v,
                                                               length))
            lib_ms = sdpa_ms(torch, timer, q, k[:, :n], v[:, :n],
                             causal=False)
            flops = 4 * Bc * Hc * n * Dc
            nbytes = q.element_size() * (2 * Bc * Hkc * n * Dc
                                         + 2 * q.numel())
            b_ms, b_by = bound(flops, nbytes, peak_flops(torch, dtype))
            log(f"[kernels] decode_attention {label} {name} B={Bc} H={Hc} "
                f"Hk={Hkc} D={Dc} length={n}: {ms:.4f} ms (plain "
                f"{plain_ms:.4f} ms, sdpa "
                f"{lib_ms} ms, bound {b_ms:.4f} ms by {b_by})")
            if key is not None:
                rows.setdefault(key, {"ms": ms, "plain_ms": plain_ms,
                                      "library_ms": lib_ms, "bound_ms": b_ms,
                                      "bound_by": b_by})

    # stale tail: garbage past `length` must not reach the output
    k = torch.randn(B, L, Hk, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, L, Hk, D, generator=gen, device="cuda").bfloat16()
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").bfloat16()
    length = torch.tensor(300, dtype=torch.int32, device="cuda")
    clean = decode_attention_cuda(q, k, v, length)
    k[:, 300:] = 1e4
    v[:, 300:] = float("nan")
    dirty = decode_attention_cuda(q, k, v, length)
    torch.cuda.synchronize()
    if not torch.equal(clean, dirty):
        raise AssertionError("decode_attention read the cache past length")
    log("[kernels] decode_attention stale tail past length=300: "
        "output unchanged")

    # a call captured in a CUDA graph, replayed after `length` moves on the
    # device: it must equal an eager call at the new length
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_attention_cuda(q, k, v, length)
    for n in (1, split + 1, 299):
        length.fill_(n)
        graph.replay()
        eager = decode_attention_cuda(q, k, v, length)
        torch.cuda.synchronize()
        if not torch.equal(captured, eager):
            raise AssertionError(f"decode_attention graph replay at length "
                                 f"{n} differs from an eager call")
    log("[kernels] decode_attention in a CUDA graph, replayed at lengths "
        "1, 65, 299 set on the device: equal to eager calls")
    return _records(rows, errs)


def check_ssd(torch, timer, gen) -> dict:
    """The SSD kernel against its plain version: y (relative to its largest
    magnitude, 5x the bf16/fp32 tolerance, as tests/test_kernels.py holds
    the Pallas kernel) and the final state (relative, 1e-4, the bound
    tests/test_models.py holds chunk lengths 4-32 to). The serving shape,
    a batch-1 8192-token prompt and jamba's 256-head prefill (its record
    under "jamba") are timed."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import kernel as ssd_k
    from repro_torch.kernels.ssd import ssd_cuda, ssd_plain
    H, N = 32, 128
    F = torch.nn.functional
    lib = _build.library("ssd")
    for P in (16, 32, 64):        # one, two and four warps a block
        geo = ssd_k.plan(8, H, P, N, torch.bfloat16)
        if lib.ssd_bf16_smem_bytes(N, geo.warps) != geo.smem_bytes:
            raise AssertionError(f"ssd plan: {geo.smem_bytes} bytes of "
                                 f"shared memory, the source says "
                                 f"{lib.ssd_bf16_smem_bytes(N, geo.warps)}")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def plan_line(B, Hc, P) -> str:
        geo = ssd_k.plan(B, Hc, P, N, torch.bfloat16)
        return (f"{geo.grid[0] * geo.grid[1]} blocks of {geo.warps} warps, "
                f"{geo.smem_bytes} B shared memory, {geo.blocks_per_sm} "
                f"blocks an SM")

    def rel(got, want) -> float:
        return max_err(got, want) / (float(want.float().abs().max()) + 1e-30)

    def check(label, got, want, name):
        (y, st), (y_ref, st_ref) = got, want
        torch.cuda.synchronize()
        err_y, err_s = rel(y, y_ref), rel(st, st_ref)
        finite = bool(torch.isfinite(y).all() and torch.isfinite(st).all())
        log(f"[kernels] ssd {label}: y rel={err_y:.3e} (tol "
            f"{5 * TOL[name]:g}), state rel={err_s:.3e} (tol 1e-4), "
            f"finite={finite}")
        if not (err_y < 5 * TOL[name] and err_s < 1e-4 and finite):
            raise AssertionError(f"ssd {label}: y rel {err_y}, state rel "
                                 f"{err_s}, finite {finite}")
        return max_err(y, y_ref)

    def bound_of(B, S, Hc, P, x, dt, A, Bm, Cm, st):
        # the work of the kernel's chunks (Q = 64), lower triangle of each
        # chunk's Q x Q products only; each input read and output written
        # once
        Q = 64
        tri = Q * (Q + 1) // 2
        flops = B * Hc * -(-S // Q) * (2 * tri * (N + P) + 4 * Q * P * N)
        nbytes = (2 * x.element_size() * x.numel() + dt.element_size()
                  * dt.numel() + 4 * A.numel() + Bm.element_size()
                  * (Bm.numel() + Cm.numel()) + 2 * 4 * st.numel())
        return bound(flops, nbytes, PEAK_BF16_FLOPS)

    rec, worst = None, 0.0
    # (label, batch, S, heads, P, x/B/C dtype, dt dtype, plain chunk,
    #  state0, timed): the serving shape as the model passes it (chunk
    # 256), with the zero state of a first prefill and a random one; dt in
    # bf16; all fp32; a ragged S (not a multiple of the kernel's 64); S =
    # 513, one position in the last chunk; P = 8, half of a warp's 16 state
    # rows; a long S in fp32; a batch-1 8192-token prompt at full width
    for label, B, S, Hc, P, dtype, dt_dtype, chunk, with_state, timed in (
            ("serving", 8, 512, H, 64, torch.bfloat16, torch.float32, 256,
             False, False),
            ("serving", 8, 512, H, 64, torch.bfloat16, torch.float32, 256,
             True, True),
            ("dt-bf16", 2, 512, H, 64, torch.bfloat16, torch.bfloat16, 256,
             True, False),
            ("fp32", 2, 512, H, 64, torch.float32, torch.float32, 128, True,
             False),
            ("ragged", 2, 200, 8, 64, torch.bfloat16, torch.float32, 40,
             True, False),
            ("s513", 2, 513, H, 64, torch.bfloat16, torch.float32, 171,
             True, False),
            ("p8", 2, 512, H, 8, torch.bfloat16, torch.float32, 256, True,
             False),
            ("long", 1, 8192, 4, 64, torch.float32, torch.float32, 256,
             True, False),
            ("long-b1", 1, 8192, H, 64, torch.bfloat16, torch.float32, 256,
             True, True)):
        x = randn(B, S, Hc, P, dtype=dtype)
        dt = F.softplus(randn(B, S, Hc)).to(dt_dtype)
        A = -torch.exp(randn(Hc))
        Bm, Cm = randn(B, S, N, dtype=dtype), randn(B, S, N, dtype=dtype)
        state0 = randn(B, Hc, P, N) if with_state else None
        name = str(dtype).split(".")[1]
        out = ssd_cuda(x, dt, A, Bm, Cm, state0=state0)
        desc = (f"{label} x={name} dt={str(dt_dtype)[6:]} B={B} S={S} "
                f"H={Hc} P={P} N={N} state0="
                f"{'random' if with_state else 'zero'}")
        worst = max(worst, check(desc, out, ssd_plain(
            x, dt, A, Bm, Cm, chunk=chunk, state0=state0), name))
        if not timed:
            continue
        launches = ssd_k.launches
        ms = timer.ms(lambda: ssd_cuda(x, dt, A, Bm, Cm, state0=state0))
        plain_ms = timer.ms(lambda: ssd_plain(
            x, dt, A, Bm, Cm, chunk=chunk, state0=state0), iters=10)
        b_ms, b_by = bound_of(B, S, Hc, P, x, dt, A, Bm, Cm, out[1])
        log(f"[kernels] ssd {label} bf16 B={B} S={S} H={Hc}: {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, no library call computes SSD, bound "
            f"{b_ms:.4f} ms by {b_by}, {plan_line(B, Hc, P)})")
        if label == "serving":
            rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by}
        ssd_k.launches = launches     # timing launches are not the path's

    # in place, as the model calls it: state0 and state_out one layer's
    # slice of a stacked cache, at the serving shape
    x = randn(8, 512, H, 64, dtype=torch.bfloat16)
    dt, A = F.softplus(randn(8, 512, H)), -torch.exp(randn(H))
    Bm = randn(8, 512, N, dtype=torch.bfloat16)
    Cm = randn(8, 512, N, dtype=torch.bfloat16)
    cache = randn(3, 8, H, 64, N)
    before = cache.clone()
    want = ssd_plain(x, dt, A, Bm, Cm, chunk=256, state0=before[1])
    got = ssd_cuda(x, dt, A, Bm, Cm, state0=cache[1], state_out=cache[1])
    worst = max(worst, check("in place in a stacked cache, serving shape",
                             got, want, "bfloat16"))
    if got[1].data_ptr() != cache[1].data_ptr() \
            or not torch.equal(cache[0], before[0]) \
            or not torch.equal(cache[2], before[2]):
        raise AssertionError("ssd in place: wrote outside its layer's slice "
                             "or returned another tensor")
    rec["max_abs_err"] = worst

    # jamba-1.5-large-398b's prefill: 256 heads, state0 and state_out one
    # Mamba sublayer's slice of the block's zeroed (period - 1, B, H, P, N)
    # cache, as models/ssm.py calls it there; the row's own record
    B, S, Hj, P = 8, 512, 256, 64
    x = randn(B, S, Hj, P, dtype=torch.bfloat16)
    dt, A = F.softplus(randn(B, S, Hj)), -torch.exp(randn(Hj))
    Bm = randn(B, S, N, dtype=torch.bfloat16)
    Cm = randn(B, S, N, dtype=torch.bfloat16)
    cache = torch.zeros(JAMBA_PERIOD - 1, B, Hj, P, N, device="cuda")
    want = ssd_plain(x, dt, A, Bm, Cm, chunk=256, state0=cache[1].clone())
    got = ssd_cuda(x, dt, A, Bm, Cm, state0=cache[1], state_out=cache[1])
    err = check(f"jamba x=bfloat16 dt=float32 B={B} S={S} H={Hj} P={P} "
                f"N={N} state0=zero, in place in the block's cache", got,
                want, "bfloat16")
    launches = ssd_k.launches
    # the same work every call: state0 is read whatever it holds
    ms = timer.ms(lambda: ssd_cuda(x, dt, A, Bm, Cm, state0=cache[1],
                                   state_out=cache[1]))
    plain_ms = timer.ms(lambda: ssd_plain(x, dt, A, Bm, Cm, chunk=256,
                                          state0=cache[1]), iters=10)
    ssd_k.launches = launches         # timing launches are not the path's
    b_ms, b_by = bound_of(B, S, Hj, P, x, dt, A, Bm, Cm, got[1])
    log(f"[kernels] ssd jamba bf16 B={B} S={S} H={Hj}: {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms, no library call computes SSD, bound "
        f"{b_ms:.4f} ms by {b_by}, {plan_line(B, Hj, P)})")
    rec["jamba"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    return rec


BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# the names of cuBLAS's GEMM kernels, as the profiler shows them
GEMMS = ("nvjet", "gemm", "cutlass", "xmma")
# the names of the flash kernels' launches (bf16), as the profiler shows them
FLASH_FWD = ("flash_bf16_kernel",)
FLASH_BWD = ("bwd_dq_bf16", "bwd_dkdv_bf16", "bwd_reduce")


def profiled(passes: dict) -> str:
    return ", ".join(f"{n} {t:.4f} ms" for n, t in passes.items()) \
        or "not traced"


def kernel_ms(torch, timer, fn, names, iters: int = 20) -> dict:
    """Mean device ms a call of ``fn`` spends in the kernels whose names
    contain each of ``names`` (``torch.profiler``), the L2 flushed before
    each call as ``Timer`` does; empty when the profiler traced none of
    them (it has missed a window's device events on this card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for n in names:
                if n in e.name:
                    us[n] += e.time_range.elapsed_us()
    if not any(us.values()):
        return {}
    return {n: t / iters / 1e3 for n, t in us.items()}


def block_edge_faults(grads, G: int) -> dict:
    """Faults where a group of G heads meets the forward's 64-row blocks:
    the forward folds P = 64 // G positions x G heads into a block's rows
    (G = 12: 5 positions, rows 60-63 dead), so a fault of its row mapping
    lands on a block's last position. dq and dv x 0.9 at every P-th
    position (the last of each block's), and dq x 0.9 on the last 4 folded
    rows of each of the backward's 64-row tiles."""
    dq, dk, dv = grads
    P = 64 // G
    S, H, D = dq.shape[1], dq.shape[2], dq.shape[3]

    def scaled(g, index):
        bad = g.clone()
        bad[:, index] *= 0.9
        return bad
    last = slice(P - 1, None, P)
    folded = dq.reshape(dq.shape[0], S, H // G, G, D).permute(
        0, 2, 1, 3, 4).reshape(dq.shape[0], H // G, S * G, D).clone()
    for r in range(60, S * G, 64):
        folded[:, :, r:r + 4] *= 0.9
    tile_end = folded.reshape(dq.shape[0], H // G, S, G, D).permute(
        0, 2, 1, 3, 4).reshape(dq.shape)
    return {f"dq x 0.9 at each {P}-position block's last position":
            (0, scaled(dq, last)),
            f"dv x 0.9 at every {P}th key": (2, scaled(dv, last)),
            "dq x 0.9 on folded rows 60-63 of each 64-row tile":
            (0, tile_end)}


def check_flash_bwd(torch, timer, gen) -> dict:
    """The flash backward kernel against autograd through the plain version:
    dq, dk and dv each within ``BWD_TOL`` of their norm (||got - want|| /
    ||want||, 1e-2 in bf16, 1e-4 in fp32) at the training shape, causal and
    full; ragged S; G = 1; D = 128; a 2048-token sequence; fp32; the 15 B
    archs' G = 12 and 6 and qwen3-moe's G = 16 at D = 128 (its training
    shape, 8 x 512 tokens, and a ragged S), whose numbers go into the
    record's "g16" entry; qwen2-vl's G = 8 at D = 128 (its training shape
    and a ragged S, the record's "qwen2vl" entry); and seamless-m4t's G = 1 heads at D = 64, whose
    numbers go into its "seamless" entry: the encoder's non-causal 8 x 1024,
    the cross-attention's non-causal 512 queries over 1024 keys, the
    decoder's causal 8 x 512 (the three timed), non-causal 1024 queries
    over 512 keys, fp32 at the encoder's and the cross's lengths, ragged
    Sq != Skv both ways, and causal Sq != Skv both ways (the mask qpos >=
    kpos, both from 0, as the plain version's). A row's S is Sq = Skv, or
    the pair (Sq, Skv). A rule on the largest magnitude would not do:
    under the causal mask the first keys' dk and dv are ~100x the typical
    key's, so it would pass a kernel that is 10% wrong on most keys. At the
    training shape, G = 12, G = 16, qwen2-vl's and seamless's encoder and
    cross rows the
    check is shown to see such faults: the kernel's own result, with dv or
    dk scaled by 0.9 past key 128, dv zeroed on the last 12% of keys or dq
    scaled by 0.9 on the last 12% of rows, must each fail the rule
    (``tools/flash_bwd_tolerance.py`` gives the kernel's rounding ~0.3% and
    these faults 1.9-4.3% on the CPU), at G = 12, 16 and 8 so must
    ``block_edge_faults``, and the rows unsplit (``n_split=1``) must pass.
    The training shape, the long sequence, the G = 12, 6, 16 and 8 shapes and
    seamless's three are timed, backward alone, each with its own lengths
    and causal flag: the kernel, the plain version and, as the yardstick,
    SDPA's backward (``torch.autograd.grad`` through SDPA with
    ``enable_gqa``, its forward outside the timed call)."""
    from flash_bwd_tolerance import grad_err, planted_faults
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel_bwd import (auto_split,
                                                                split_plan)
    F = torch.nn.functional
    bf16, f32 = torch.bfloat16, torch.float32
    rows, worst = {}, {}
    # the rows whose planted faults must fail the rule, and whose n_split=1
    # run must pass it: (label, causal)
    faulted = {("training", True), ("g12", True), ("g16", True),
               ("qwen2vl", True), ("seamless-encoder", False),
               ("seamless-cross", False)}
    # (label, B, S, H, Hk, D, dtype, causal, timed, record)
    for label, B, S, H, Hk, D, dtype, causal, timed, key in (
            ("training", 8, 512, 32, 4, 64, bf16, True, True, ""),
            ("training", 8, 512, 32, 4, 64, bf16, False, False, ""),
            ("ragged", 2, 100, 32, 4, 64, bf16, True, False, ""),
            ("g1", 2, 256, 8, 8, 64, bf16, True, False, ""),
            ("d128", 2, 256, 32, 4, 128, bf16, True, False, ""),
            ("long", 1, 2048, 32, 4, 64, bf16, True, True, None),
            ("fp32", 2, 256, 32, 4, 64, f32, True, False, None),
            # the 15 B archs' heads at the train check's length: G = 12
            # (starcoder2) and G = 6 (qwen3, nemotron), D = 128
            ("g12", 2, 256, 48, 4, 128, bf16, True, True, None),
            ("g6", 2, 256, 48, 8, 128, bf16, True, True, None),
            # qwen3-moe's training shape: G = 16 at D = 128 (4 positions a
            # forward block, 8192 folded rows a (b, hk)), and a ragged S
            ("g16", 8, 512, 64, 4, 128, bf16, True, True, "g16"),
            ("ragged-g16", 2, 100, 64, 4, 128, bf16, True, False, "g16"),
            # qwen2-vl-72b's training shape: G = 8 at D = 128 (8
            # positions a forward block), and a ragged S
            ("qwen2vl", 8, 512, 64, 8, 128, bf16, True, True, "qwen2vl"),
            ("ragged-qwen2vl", 2, 100, 64, 8, 128, bf16, True, False,
             "qwen2vl"),
            # seamless-m4t's training path, H = Hk = 16 at D = 64: the
            # encoder's self-attention over 1024 frames, the
            # cross-attention of 512 tokens over the 1024-frame memory, the
            # decoder's causal self-attention; more queries than keys;
            # fp32; ragged lengths; the causal mask with Sq != Skv
            ("seamless-encoder", 8, 1024, 16, 16, 64, bf16, False, True,
             "seamless_encoder"),
            ("seamless-cross", 8, (512, 1024), 16, 16, 64, bf16, False, True,
             "seamless_cross"),
            ("seamless-decoder", 8, 512, 16, 16, 64, bf16, True, True,
             "seamless_decoder"),
            ("seamless-sq>skv", 8, (1024, 512), 16, 16, 64, bf16, False,
             False, "seamless_cross"),
            ("seamless-encoder", 2, 1024, 16, 16, 64, f32, False, False,
             None),
            ("seamless-cross", 2, (512, 1024), 16, 16, 64, f32, False, False,
             None),
            ("ragged-cross", 2, (100, 300), 16, 16, 64, bf16, False, False,
             "seamless_cross"),
            ("ragged-cross", 2, (300, 100), 16, 16, 64, bf16, False, False,
             "seamless_cross"),
            ("causal-sq<skv", 2, (512, 1024), 16, 16, 64, bf16, True, False,
             None),
            ("causal-sq>skv", 2, (1024, 512), 16, 16, 64, bf16, True, False,
             None)):
        Sq, Skv = S if isinstance(S, tuple) else (S, S)
        q, do = (torch.randn(B, Sq, H, D, generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, Skv, Hk, D, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                      return_lse=True)
        got = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal)
        want = flash_attention_bwd_plain(q, k, v, do, causal=causal)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[1]
        tol = BWD_TOL[name]
        shape = f"B={B} Sq={Sq} Skv={Skv} H={H} Hk={Hk} D={D}"
        for grad, g, w in zip(("dq", "dk", "dv"), got, want):
            err, wa = grad_err(g, w), w.float().abs()
            log(f"[kernels] flash_attention_bwd {label} {name} "
                f"causal={causal} {shape} {grad}: "
                f"||err||/||want|| {err:.3e} (tol {tol:g}), max_abs_err "
                f"{max_err(g, w):.3e}, |want| median {wa.median():.3e} "
                f"max {wa.max():.3e}")
            if not err <= tol:
                raise AssertionError(f"flash_attention_bwd {label} {name} "
                                     f"causal={causal} {grad}: "
                                     f"||err||/||want|| {err} > {tol}")
            # the kernel's own entry ("") holds every bf16 row's worst,
            # each other record its own rows' worst
            for rec in {key, "" if dtype is bf16 else None} - {None}:
                worst[rec] = max(worst.get(rec, 0.0), max_err(g, w))
        if (label, causal) in faulted:
            # the rows unsplit: one range a key tile, the partials summed
            # from one term, within the same rule
            one = flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                           causal=causal, n_split=1)
            errs = [grad_err(g, w) for g, w in zip(one, want)]
            log(f"[kernels] flash_attention_bwd {label} n_split=1: "
                f"||err||/||want|| dq, dk, dv "
                f"{', '.join(f'{e:.3e}' for e in errs)} (tol {tol:g})")
            if not max(errs) <= tol:
                raise AssertionError(f"flash_attention_bwd {label} "
                                     f"n_split=1: ||err||/||want|| {errs} "
                                     f"> {tol}")
            faults = planted_faults(got)
            if label in ("g12", "g16", "qwen2vl"):
                faults.update(block_edge_faults(got, H // Hk))
            for fault, (i, bad) in faults.items():
                err = grad_err(bad, want[i])
                log(f"[kernels] flash_attention_bwd {label} planted fault, "
                    f"{fault}: ||err||/||want|| {err:.3e} (must exceed "
                    f"{tol:g})")
                if not err > tol:
                    raise AssertionError(f"the backward's check passes a "
                                         f"planted fault at {label}: {fault}")
        if not timed:
            continue

        def backward():
            return flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                            causal=causal)
        ms = timer.ms(backward)
        passes = kernel_ms(torch, timer, backward, FLASH_BWD)
        plain_ms = timer.ms(lambda: flash_attention_bwd_plain(
            q, k, v, do, causal=causal), iters=10)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        try:
            out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal,
                                                 enable_gqa=True)
            lib_ms = timer.ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        except TypeError:       # a torch without enable_gqa
            lib_ms = None
        # five products (S, dP, dV, dK, dQ) of 2 * B * H * D over the
        # (query, key) pairs: Sq * Skv, half of it under the causal mask
        # (the timed causal rows are square); q, o, do, dq and k, v, dk, dv
        # moved once (lse, 4 bytes a row, read once)
        assert not causal or Sq == Skv
        flops = 5 * 2 * B * H * Sq * Skv * D / (2 if causal else 1)
        nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        # this design also writes and reads back fp32 partial dk, dv: one
        # (64, D) slice of each a block of its dk/dv pass
        n_split = auto_split(B, Hk, Sq, Skv, H // Hk, causal,
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
        ranges = split_plan(Sq, Skv, H // Hk, causal, n_split)[1]
        part_bytes = 2 * 2 * B * Hk * ranges * 64 * D * 4
        bp_ms, bp_by = bound(flops, nbytes + part_bytes, PEAK_BF16_FLOPS)
        log(f"[kernels] flash_attention_bwd {label} bf16 causal={causal} "
            f"{shape}: {ms:.4f} ms (passes, profiled: "
            f"{profiled(passes)}; "
            f"plain {plain_ms:.4f} ms, sdpa backward {lib_ms} ms, bound "
            f"{b_ms:.4f} ms by {b_by}: {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB; n_split {n_split}, {B * Hk * ranges} "
            f"dk/dv blocks, whose fp32 partials add {part_bytes / 1e6:.1f} "
            f"MB: bound with them {bp_ms:.4f} ms by {bp_by})")
        if key is not None:
            rows.setdefault(key, {"ms": ms, "plain_ms": plain_ms,
                                  "library_ms": lib_ms, "bound_ms": b_ms,
                                  "bound_by": b_by})
    return _records(rows, worst)


# the names of the ssd kernels' launches (bf16), as the profiler shows them
SSD_FWD = ("ssd_bf16_kernel",)
SSD_BWD = ("ssd_bwd_tc_kernel", "ssd_bwd_kernel", "ssd_bwd_reduce")
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dstate0")


def check_ssd_bwd(torch, timer, gen) -> dict:
    """The SSD backward kernel against autograd through the plain scan
    (``ssd_bwd_plain``, fp32, at the model's chunk): each of dx, ddt, dA,
    dB, dC and dstate0 within ``BWD_TOL`` of its norm (1e-2 in bf16, 1e-4
    in fp32), and the chunk states the forward writes for it within 1e-4
    of the plain scan's, at the training shape (bf16, and fp32), a random
    state0 with a final-state cotangent, a ragged S, P = 8 (the scalar
    kernel in bf16: the tensor-core one is built for mamba2's P = 64,
    N = 128) and a 2048-token sequence. At the training shape two calls must give the
    same bits, and
    three planted faults, each made by the kernel on altered inputs
    (``tools/ssd_bwd_tolerance.py``: the chunk states read as zeros, half
    the heads, each chunk alone), must each fail the rule. The training
    shape and the long sequence are timed: the kernel (and each of its two
    launches, profiled), the forward with its chunk states against
    without, and the plain version."""
    from ssd_bwd_tolerance import chunk_states, grad_err, planted_faults
    from repro_torch.kernels.ssd import (ssd_bwd_cuda, ssd_bwd_plain,
                                         ssd_cuda)
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd.kernel_bwd import tensor_cores
    F = torch.nn.functional
    rec, worst = None, 0.0
    lib = _build.library("ssd_bwd")

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    # (label, B, S, H, P, N, x/B/C/dy dtype, plain chunk, state0 and a
    #  final-state cotangent, timed)
    for label, B, S, H, P, N, dtype, chunk, with_state, timed in (
            ("training", 8, 512, 32, 64, 128, torch.bfloat16, 256, False,
             True),
            ("training", 8, 512, 32, 64, 128, torch.float32, 256, False,
             False),
            ("state", 2, 512, 32, 64, 128, torch.bfloat16, 256, True, False),
            ("ragged", 2, 200, 4, 64, 128, torch.bfloat16, 100, True, False),
            ("p8", 2, 512, 32, 8, 128, torch.bfloat16, 256, True, False),
            ("small", 2, 100, 3, 8, 16, torch.float32, 50, True, False),
            ("long", 1, 2048, 32, 64, 128, torch.bfloat16, 256, False,
             True)):
        x, dy = randn(B, S, H, P, dtype=dtype), randn(B, S, H, P, dtype=dtype)
        dt, A = F.softplus(randn(B, S, H)), -torch.exp(randn(H))
        Bm, Cm = randn(B, S, N, dtype=dtype), randn(B, S, N, dtype=dtype)
        s0 = randn(B, H, P, N) if with_state else None
        ds = randn(B, H, P, N) if with_state else None
        name = str(dtype).split(".")[1]
        tol = BWD_TOL[name]
        _, _, states = ssd_cuda(x, dt, A, Bm, Cm, state0=s0,
                                return_states=True)
        got = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states, dstate=ds,
                           want_dstate0=with_state)
        want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, state0=s0, dstate=ds,
                             chunk=chunk)
        torch.cuda.synchronize()
        st_want = chunk_states(x, dt, A, Bm, Cm, s0)      # fp64
        st_err = grad_err(states[:, :, 1:], st_want[:, :, 1:])
        errs = {g: grad_err(a, b) for g, a, b in zip(SSD_GRADS, got, want)
                if b is not None}
        finite = all(bool(torch.isfinite(a).all()) for a in got
                     if a is not None)
        kind = "tensor cores" if tensor_cores(dtype, P, N) else "scalar"
        log(f"[kernels] ssd_bwd {label} {name} B={B} S={S} H={H} P={P} "
            f"N={N} state0={'random' if with_state else 'zero'} ({kind}): "
            f"||err||/||want|| "
            f"{', '.join(f'{g} {e:.3e}' for g, e in errs.items())} (tol "
            f"{tol:g}); chunk states {st_err:.3e} (tol 1e-4); "
            f"finite={finite}")
        if not (max(errs.values()) <= tol and st_err <= 1e-4 and finite):
            raise AssertionError(f"ssd_bwd {label} {name}: {errs}, chunk "
                                 f"states {st_err}, finite {finite}")
        if dtype is torch.bfloat16:
            worst = max(worst, *(max_err(a, b) for a, b in zip(got, want)
                                 if b is not None))
        if label == "training" and dtype is torch.bfloat16:
            again = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states)
            if not all(torch.equal(a, b) for a, b in zip(got[:5], again)):
                raise AssertionError("ssd_bwd: two calls differ")
            for fault, (k, bad) in planted_faults(
                    ssd_bwd_cuda, x, dt, A, Bm, Cm, dy, states).items():
                err = grad_err(bad, want[k])
                log(f"[kernels] ssd_bwd planted fault, {fault}: "
                    f"||err||/||want|| {err:.3e} (must exceed {tol:g})")
                if not err > tol:
                    raise AssertionError(f"the ssd backward's check passes "
                                         f"a planted fault: {fault}")
            log("[kernels] ssd_bwd: two calls give the same bits")
        if not timed:
            continue
        ms = timer.ms(lambda: ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states))
        passes = {n: t for n, t in kernel_ms(
            torch, timer, lambda: ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states),
            SSD_BWD).items() if t}        # the launches this shape made
        fwd_ms = timer.ms(lambda: ssd_cuda(x, dt, A, Bm, Cm))
        fwd_st_ms = timer.ms(lambda: ssd_cuda(x, dt, A, Bm, Cm,
                                              return_states=True))
        plain_ms = timer.ms(lambda: ssd_bwd_plain(
            x, dt, A, Bm, Cm, dy, chunk=chunk), iters=10)
        # the products per (b, h, chunk): C B^T, dy x^T (Q Q N, Q Q P),
        # dxdt (Q Q P + Q N P), dC and dB (Q Q N + Q P N each), g (Q P N),
        # the five Q x Q ones over the 10 of 16 16 x 16 blocks on or below
        # the diagonal, as the tensor-core kernel runs them (L is 0 above);
        # x, dy, dx, dt, ddt, A, dA, B, C, dB, dC moved once
        Q, nc = 64, -(-S // 64)
        flops = 2 * B * H * nc * (Q * Q * (3 * N + 2 * P) * 10 // 16
                                  + 4 * Q * P * N)
        nbytes = (3 * x.element_size() * x.numel() + 2 * 4 * dt.numel()
                  + 2 * 4 * H + 4 * Bm.element_size() * Bm.numel())
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        # this design also reads the stored chunk states and writes and
        # reads back the per-head fp32 partials of dB and dC
        extra = 4 * states.numel() + 2 * 2 * 4 * B * H * S * N
        bx_ms, bx_by = bound(flops, nbytes + extra, PEAK_BF16_FLOPS)
        log(f"[kernels] ssd_bwd {label} bf16 B={B} S={S} H={H}: {ms:.4f} ms "
            f"(launches, profiled: "
            f"{profiled(passes)}; "
            f"plain {plain_ms:.4f} ms, no library call computes it, bound "
            f"{b_ms:.4f} ms by {b_by}: {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB; with the chunk states and the "
            f"partials, {extra / 1e6:.1f} MB more: {bx_ms:.4f} ms by "
            f"{bx_by}; {B * H} blocks, "
            f"{lib.ssd_bwd_tc_smem_bytes(P, N)} B shared memory each); "
            f"the forward {fwd_ms:.4f} ms, with its chunk states "
            f"{fwd_st_ms:.4f} ms")
        if label == "training":
            rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by}
    rec["max_abs_err"] = worst
    return rec


def _serving_model(torch, arch: str):
    """Model of ``arch`` on the card with seeded random weights, at the
    depth ``launch/serve.py``'s ``get_config`` gives (``cut_depth`` cuts
    it), configured as ``serve_loop`` runs it for 512-token prompts."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model, init_params
    cfg = dataclasses.replace(serve_mod.get_config(arch), q_chunk=256,
                              kv_chunk=256, max_cache_len=544)
    model = build_model(cfg)
    params = init_params(model.param_decls(),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    return cfg, model, params


def _profile_report(prof, what: str, wall: float, steps: int,
                    ours: dict[str, tuple], top: int = 6,
                    ranges: tuple = ()) -> dict:
    """Device kernel time of a profiled window: per step, its busy share of
    the wall time, the ``top`` largest kernels, and for each group of
    ``ours`` the share of the kernels whose names contain one of its
    fragments. The device-side spans of the ``record_function`` ranges
    named in ``ranges`` are not kernels and are left out. Returns the
    device ms a step ("device") and each group's (empty when nothing was
    traced)."""
    from torch.autograd import DeviceType
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in ranges:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    if not by_name:
        log(f"[profile] {what}: no device events traced; busy share not "
            "measured")
        return {}
    busy = sum(by_name.values()) / 1e6
    log(f"[profile] {what}, {steps} step(s) under the profiler: "
        f"{wall / steps * 1e3:.3f} ms/step wall, "
        f"{busy / steps * 1e3:.3f} ms/step of device kernels in "
        f"{n_kernels / steps:.0f} launches/step, busy share "
        f"{busy / wall:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile]   {us / steps / 1e3:.4f} ms/step "
            f"({us / 1e6 / busy:.3f})  {name[:90]}")
    out = {"device": busy * 1e3 / steps}
    for label, frags in ours.items():
        mine = [us for name, us in by_name.items()
                if any(frag in name for frag in frags)]
        out[label] = sum(mine) / 1e3 / steps
        log(f"[profile] {what}: {label} (kernels named {list(frags)}) take "
            f"{sum(mine) / 1e3 / steps:.4f} ms/step, a share of "
            f"{sum(mine) / 1e6 / busy:.3f} of the device time")
    return out


# The MoE decode step's phases: label -> (module, function), each call of
# which the split profile wraps in a ``record_function`` range
MOE_PHASES = {
    "routing (router, softmax, top-k sort, gates, aux)":
        ("repro_torch.models.moe", "_route"),
    "dispatch (rank in expert, slots, rows into (E, C, M))":
        ("repro_torch.models.moe", "_dispatch"),
    "expert products": ("repro_torch.models.moe", "_experts"),
    "combine": ("repro_torch.models.moe", "_combine"),
    "attention (projections, norms, rope, decode kernel)":
        ("repro_torch.models.lm", "attention"),
}


@contextlib.contextmanager
def patched(owner, name: str, wrap):
    """``owner.name`` replaced by ``wrap(original)`` while the context lasts;
    callers that look the name up on ``owner`` (a module's own functions
    calling each other do) see the replacement."""
    original = getattr(owner, name)
    setattr(owner, name, wrap(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


@contextlib.contextmanager
def phase_ranges(torch, phases: dict):
    """Each function of ``phases`` wrapped, while the context lasts, in a
    ``record_function`` range named by its label."""
    import importlib

    def in_range(label):
        def wrap(fn):
            def wrapped(*args, **kw):
                with torch.profiler.record_function(label):
                    return fn(*args, **kw)
            return wrapped
        return wrap
    with contextlib.ExitStack() as stack:
        for label, (module, name) in phases.items():
            stack.enter_context(patched(importlib.import_module(module),
                                        name, in_range(label)))
        yield


def _phase_split(prof, phases: dict, steps: int,
                 bound_ms: float | None = None) -> dict:
    """Per step, the device time of the kernels launched inside each phase's
    ranges (host-side ranges, their kernels summed) and the span of the
    ranges on the device; returns the former, ms a step by phase."""
    from torch.autograd import DeviceType
    kernel_us = dict.fromkeys(phases, 0.0)
    span_us = dict.fromkeys(phases, 0.0)
    for e in prof.events():
        if e.name not in phases:
            continue
        if e.device_type == DeviceType.CUDA:
            span_us[e.name] += e.time_range.elapsed_us()
        else:
            us = getattr(e, "device_time_total", None)
            kernel_us[e.name] += e.cuda_time_total if us is None else us
    total = sum(kernel_us.values())
    for label in phases:
        ms = kernel_us[label] / steps / 1e3
        log(f"[profile]   {label}: kernels {ms:.4f} ms/step "
            f"({kernel_us[label] / max(total, 1e-9):.3f} of the phases' "
            f"{total / steps / 1e3:.4f} ms), device span "
            f"{span_us[label] / steps / 1e3:.4f} ms/step")
    if bound_ms is not None:
        log(f"[profile]   the phases' kernels against the step's bytes "
            f"bound {bound_ms:.3f} ms: "
            f"{total / steps / 1e3 / bound_ms:.3f}x")
    return {label: us / steps / 1e3 for label, us in kernel_us.items()}


def _prefill_args(torch, cfg, model, tok) -> tuple:
    """A prefill's arguments after the weights at the serving shape, the
    empty cache last: the encoder-decoder's ``FRAMES_LEN`` random frames
    a prompt before the tokens."""
    if cfg.family == "encdec":
        from repro_torch.launch.serve import FRAMES_LEN
        frames = torch.randn(8, FRAMES_LEN, cfg.d_model,
                             device="cuda").bfloat16()
        return frames, tok, model.init_cache(8, 544, FRAMES_LEN,
                                             device="cuda")
    return tok, model.init_cache(8, 544, device="cuda")


def profile_decode(torch, arch: str, ours: dict | None = None,
                   steps: int = 4, phases: dict | None = None) -> None:
    """Wall time and device kernel time of decode steps at the serving
    shape (batch 8, 512-token prompts, the depth ``_serving_model`` gives),
    and the share of that device time spent in the port's kernels whose names
    contain one of ``ours``; with ``phases``, the device time split by the
    model's phases (``phase_ranges``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.param import tree_items
    cfg, model, params = _serving_model(torch, arch)
    tok = torch.randint(0, cfg.vocab, (8, 512), device="cuda")
    encdec = cfg.family == "encdec"
    with torch.inference_mode():
        logits, cache = model.prefill(params, *_prefill_args(torch, cfg,
                                                             model, tok))
        for _ in range(2):                                    # warm
            tok = logits[:, -1].argmax(-1)[:, None]
            logits, cache = model.decode_step(params, tok, cache)
        torch.cuda.synchronize()
        with phase_ranges(torch, phases or {}), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                tok = logits[:, -1].argmax(-1)[:, None]
                logits, cache = model.decode_step(params, tok, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _profile_report(prof, f"{arch} decode at batch 8, after 514 tokens, "
                    f"{cfg.n_layers} layers", wall, steps, {**(ours or {}), "GEMMs": GEMMS},
                    ranges=tuple(phases or ()))
    # a step reads every weight but the embedding's (8 rows of it), and the
    # cache: the K/V rows up to its length, or the whole SSM state; the
    # encoder-decoder's step reads the decoder's weights but the cross
    # wk/wv (their products sit in the memory cache), the final norm and
    # the head, its fp32 self cache up to the length and the whole memory
    def read(path) -> bool:
        if encdec:
            return path[0] in ("final_norm", "head") or (
                path[0] == "decoder" and path[-2:] not in (
                    ("cross_attn", "wk"), ("cross_attn", "wv")))
        return path != ("embed",) or cfg.tie_embeddings
    nbytes = sum(t.numel() * t.element_size()
                 for path, t in tree_items(params) if read(path))
    if encdec:
        k = cache.self_kv.k                 # (layers, B, max_len, Hk, D)
        nbytes += 2 * k.numel() * k.element_size() * int(
            cache.self_kv.length) // k.shape[2]
        nbytes += 2 * cache.cross_k.numel() * cache.cross_k.element_size()
    else:
        # a hybrid's cache holds both: K/V a block, and the SSM state and
        # conv tails of each of its Mamba sublayers
        if cache.kv is not None:
            k = cache.kv.k                  # (layers, B, max_len, Hk, D)
            nbytes += 2 * k.numel() * k.element_size() * int(
                cache.kv.length) // k.shape[2]
        if cache.ssm is not None:
            nbytes += sum(t.numel() * t.element_size() for t in cache.ssm)
    log(f"[profile] {arch} decode: a step reads {nbytes / 1e9:.3f} GB "
        f"(weights but the embedding, the cache), bound "
        f"{nbytes / PEAK_BYTES * 1e3:.3f} ms at 3.35 TB/s")
    if phases:
        log(f"[profile] {arch} decode, device time by phase:")
        _phase_split(prof, phases, steps, nbytes / PEAK_BYTES * 1e3)


def profile_prefill(torch, arch: str, ours: dict) -> None:
    """Wall time and device kernel time of one prefill at the serving shape
    (batch 8, 512-token prompts, 1024 frames for the encoder-decoder, an
    empty cache), after a warm-up prefill, with the share of the kernels
    named in ``ours``."""
    from torch.profiler import ProfilerActivity, profile
    cfg, model, params = _serving_model(torch, arch)
    tok = torch.randint(0, cfg.vocab, (8, 512), device="cuda")
    with torch.inference_mode():
        model.prefill(params, *_prefill_args(torch, cfg, model, tok))
        args = _prefill_args(torch, cfg, model, tok)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.prefill(params, *args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _profile_report(prof, f"{arch} prefill at batch 8 x 512 tokens", wall,
                    1, ours)


def _router_logits(router, x):
    """The fp32 router logits (T, E) that ``models/moe.py::_route`` ranks,
    on the host."""
    from repro_torch.models.common import matmul
    return matmul(x.float().reshape(-1, x.shape[-1]), router).cpu()


def record_routes(routes: dict):
    """Context: each MoE layer's routing, its top-k experts (T, k), gates
    (T, k) and router logits (T, E) on the host, appended to
    ``routes[device type]``."""
    import importlib
    moe_mod = importlib.import_module("repro_torch.models.moe")

    def wrap(route):
        def recording(router, x, cfg):
            topi, gates, aux = route(router, x, cfg)
            routes[x.device.type].append(
                (topi.cpu(), gates.detach().cpu(),
                 _router_logits(router, x).detach()))
            return topi, gates, aux
        return recording
    return patched(moe_mod, "_route", wrap)


def routed_as(recorded: list, own: list):
    """Context: the MoE layers' calls, in order, take their top-k experts
    and gates from ``recorded`` (``record_routes``' list of one device)
    in place of their own; the routing and its aux loss still run, and each
    call's own routing is appended to ``own`` as ``record_routes`` holds
    it."""
    import importlib
    moe_mod = importlib.import_module("repro_torch.models.moe")
    calls = iter(recorded)

    def wrap(route):
        def forced(router, x, cfg):
            topi, gates, aux = route(router, x, cfg)
            own.append((topi.cpu(), gates.cpu(), _router_logits(router, x)))
            topi, gates, _ = next(calls)
            return topi.to(x.device), gates.to(x.device), aux
        return forced
    return patched(moe_mod, "_route", wrap)


def experts_as(recorded: list):
    """Context for a train step: each MoE layer takes its top-k experts
    from ``recorded`` (``record_routes``' list of the CPU's calls, one a
    layer) in place of its own and forms its gates and aux loss by
    ``models/moe.py``'s own ``_router_probs`` and ``_gates_and_aux``, so
    the gradient reaches the router through the gates as it does on the
    CPU (fed gates would carry none). A layer's call is keyed by its
    router's address: the forward a remat policy recomputes calls it
    again, takes the same experts and runs the same ops (the policy's
    selective checkpoint pairs the recomputed ops with the saved ones in
    order)."""
    import importlib
    moe_mod = importlib.import_module("repro_torch.models.moe")
    calls, fed = iter(recorded), {}

    def forced(router, x, cfg):
        if router.data_ptr() not in fed:
            fed[router.data_ptr()] = next(calls)[0]
        topi = fed[router.data_ptr()].to(x.device)
        probs = moe_mod._router_probs(router, x)
        return (topi,) + moe_mod._gates_and_aux(probs, topi, cfg)
    return patched(moe_mod, "_route", lambda route: forced)


def host_memory() -> str:
    """The host's total and available memory (``/proc/meminfo``)."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            info[key] = int(value.split()[0]) * 1024
    return (f"host memory {info['MemTotal'] / 2**30:.1f} GiB, available "
            f"{info['MemAvailable'] / 2**30:.1f} GiB")


# The MoE model check's limits beyond rel < 0.06 (readings on the H100:
# PERF.md §6, "the MoE model check")
ROUTER_TOL = 0.02     # router logits, rel to their largest, CPU's routing fed
GATE_TOL = 0.02       # gates of the tokens that route alike, absolute
APART_MAX = 0.02      # share of the (token, k) choices that may route apart


def routes_apart(cpu: tuple, card: tuple) -> dict:
    """One MoE call's routing on the card against the CPU's, each its
    ``record_routes`` entry (topi (T, k), gates (T, k), router logits
    (T, E)) on the host:

    * ``apart``: the CPU's (token, k) choices that the card did not make;
    * ``gap``: the largest CPU logit gap lc[a] - lc[b] between an expert a
      that only the CPU chose for a token and one b that only the card
      chose (0 when none);
    * ``excess``: the most by which such a gap exceeds |lg[a] - lc[a]| +
      |lg[b] - lc[b]|, the two devices' logit difference at those experts,
      less 2^-16 of the CPU's largest logit for the softmax's rounding.
      The card chose b over a, so where it ranked its own logits right
      (lg[b] >= lg[a]) the excess is <= 0: the choice is a near-tie that
      the logits' difference flips. A card that picks past its own top-k
      makes it positive;
    * ``gate_err``: the largest gate difference, expert by expert, over the
      tokens whose choices agree."""
    (ti_c, g_c, l_c), (ti_g, g_g, l_g) = cpu, card
    only_c = ~(ti_c[:, :, None] == ti_g[:, None, :]).any(-1)    # (T, k)
    only_g = ~(ti_g[:, :, None] == ti_c[:, None, :]).any(-1)
    pairs = only_c[:, :, None] & only_g[:, None, :]             # (T, k, k)
    diff = (l_g - l_c).abs()
    gap = l_c.gather(1, ti_c)[:, :, None] - l_c.gather(1, ti_g)[:, None, :]
    allowed = diff.gather(1, ti_c)[:, :, None] \
        + diff.gather(1, ti_g)[:, None, :]
    slack = 2.0 ** -16 * float(l_c.abs().max())
    alike = ~only_c.any(-1)
    gate_diff = g_g.gather(1, ti_g.argsort(-1)) \
        - g_c.gather(1, ti_c.argsort(-1))
    return {"apart": int(only_c.sum()), "choices": only_c.numel(),
            "gap": float(gap[pairs].max()) if pairs.any() else 0.0,
            "excess": float((gap - allowed)[pairs].max()) - slack
            if pairs.any() else float("-inf"),
            "gate_err": float(gate_diff[alike].abs().max())
            if alike.any() else 0.0}


def planted_faults(torch) -> dict:
    """Faults planted on the card's path only, each a context factory, that
    the MoE model check reads: the card's top-k taking its (k+1)-th expert
    in place of its k-th ("top-k off by one"); gates left as the top-k
    probabilities, not renormalised; head 0 of the attention core's output
    dropped; q scaled by sqrt(112/128) before the core (at D = 112 the
    scale of D = 128)."""
    import importlib
    import math
    from repro_torch.models.common import matmul
    moe_mod = importlib.import_module("repro_torch.models.moe")
    attn_mod = importlib.import_module("repro_torch.models.attention")

    def routing(change):
        def wrap(route):
            def faulty(router, x, cfg):
                topi, gates, aux = route(router, x, cfg)
                if x.is_cuda:
                    probs = torch.softmax(matmul(
                        x.float().reshape(-1, x.shape[-1]), router), -1)
                    topi, gates = change(probs, topi, gates, cfg.top_k)
                return topi, gates, aux
            return faulty
        return lambda: patched(moe_mod, "_route", wrap)

    def cores(pre=lambda q: q, post=lambda out: out):
        def wrap(core):
            def faulty(q, *args):
                return post(core(pre(q), *args)) if q.is_cuda \
                    else core(q, *args)
            return faulty

        @contextlib.contextmanager
        def both():
            with patched(attn_mod, "_prefill_core", wrap), \
                    patched(attn_mod, "_decode_core", wrap):
                yield
        return both

    def past_top_k(probs, topi, gates, k):
        order = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
        return torch.cat([topi[:, :-1], order[:, k:k + 1]], 1), gates

    def dropped_head(out):
        return out.index_fill(2, torch.zeros(1, dtype=torch.long,
                                             device=out.device), 0)
    return {
        "top-k off by one": routing(past_top_k),
        "gates not renormalised": routing(
            lambda probs, topi, gates, k: (topi, probs.gather(1, topi))),
        "head 0 dropped": cores(post=dropped_head),
        "q x sqrt(112/128)": cores(
            pre=lambda q: (q * math.sqrt(112 / 128)).to(q.dtype)),
    }


def model_check(torch, arch: str, depth: int = 2,
                own_routing: bool = True) -> None:
    """Full-width model cut to ``depth`` layers: CUDA (kernels) vs CPU
    (plain path), same weights, prefill(64) + decode(1), logits rel < 0.06
    (largest difference over largest value) and equal argmax. The host
    holds a copy of the weights (kimi-k2 at depth 2 would need 73 GB of
    it; depth 1, 38.8 GB), so the host's memory is printed before and
    after.

    The attention weights are drawn at std 1/sqrt(fan-in), as the train
    check draws them. At the reference's draw (ROADMAP C) layer 0's scores
    have a std of ~180 (tinyllama) to ~440 (starcoder2): the softmax is
    one-hot, and the CPU's plain path, which rounds q / sqrt(D) to bf16
    first as the JAX model does, parts from the kernels' fp32 scaling (the
    Pallas kernels' and their ``ref.py``'s) by 46-51% of the output on
    starcoder2 and nemotron with no fault in either
    (``tools/attention_conditioning.py``); at the fan-in std they agree to
    0.4-0.5%.

    An MoE arch's card runs again with the CPU's routing (experts and
    gates) fed to its MoE layers, so that each layer's input differs from
    the CPU's by rounding only (with its own routing, a choice apart in one
    layer changes the next layer's input), and is held there to logits rel
    < 0.06 and equal argmax, router logits within ``ROUTER_TOL`` and, on
    the routing that the card computes beside the fed one, to
    ``routes_apart``'s rules in every call: at most ``APART_MAX`` of the
    (token, k) choices apart, each a near-tie that the two devices' router
    logits account for (excess <= 0), and the gates of the tokens that
    route alike within ``GATE_TOL``. Then each of ``planted_faults`` is run
    on the card and must break one of these rules; its readings are
    printed. ``own_routing=False`` drops the rule on the own-routing logits
    (rel and argmax, printed still): a choice that routes apart at the
    decode token moves the compared logits by a whole expert's output
    (kimi-k2 at depth 1 on the H100: 1 of its 16 decode choices, rel
    0.0729-0.0736, ROADMAP C).

    A hybrid arch (jamba) runs, in place of ``depth`` layers, one
    super-block of ``JAMBA_PERIOD`` sublayers (``one_block``: every
    sublayer at full width) and is held to the MoE rules over its MoE
    sublayers and, in the run fed the CPU's routing (inputs apart by
    rounding only), each Mamba sublayer to rel < 0.06 in five readings:
    the scan's y (the ssd kernel's on the card) at the prefill, the
    recurrence's y at the decode step, the sublayer's output at each, and
    the SSM state it carries out of the decode step. At this draw the
    D-skip term outweighs the scan in a Mamba output (dt ~ 1e-3..1e-1),
    so a scan wrong over half the prefill moves the sublayers' outputs and
    the logits by less than their rules; the scans' y are held for that.
    ``hybrid_faults`` join the planted faults."""
    import repro_torch.models.lm as lm_mod
    import repro_torch.models.ssm as ssm_mod
    from attention_conditioning import fan_in_std
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.param import tree_map
    cfg = get_config(arch)
    hybrid = cfg.family == "hybrid"
    what = f"one period-{JAMBA_PERIOD} block of {arch}" if hybrid \
        else f"depth-{depth} {arch}"
    log(f"[model] {what}: {host_memory()} before")
    cfg = one_block(cfg) if hybrid \
        else dataclasses.replace(cfg, n_layers=depth)
    cfg = dataclasses.replace(cfg, q_chunk=32, kv_chunk=32, max_cache_len=72)
    moe = cfg.family in ("moe", "hybrid")
    n_moe = cfg.n_layers // cfg.hybrid_moe_every if hybrid else depth
    model = build_model(cfg)
    # drawn on the card and copied: the CPU's generator takes minutes for a
    # 15 B arch's vocab-wide embedding and head
    params_gpu = init_params(model.param_decls(),
                             torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
    if cfg.attends:
        layers = params_gpu["layers"]
        layers["attn"] = fan_in_std(layers["attn"], cfg.d_model)
    params_cpu = tree_map(lambda a: a.cpu(), params_gpu)
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(1))

    last = {}     # a hybrid's Mamba readings in the latest run
    # the functions whose outputs are recorded: the Mamba sublayer (its
    # first JAMBA_PERIOD - 1 calls at the prefill, the rest at the decode
    # step), the scan at the prefill, the recurrence at the decode step
    recorded = {"block": (lm_mod, "mamba_block"), "ssd": (ssm_mod, "ssd"),
                "step": (ssm_mod, "ssd_decode_step")}

    def logits_on(dev: str, params):
        rec = {name: [] for name in recorded}
        with contextlib.ExitStack() as stack:
            for name, (owner, fn) in recorded.items() if hybrid else ():
                stack.enter_context(outputs_of(owner, fn, rec[name]))
            cache = model.init_cache(2, cfg.max_cache_len, device=dev)
            _, cache = model.prefill(params, toks[:, :64].to(dev), cache)
            logits, cache = model.decode_step(params, toks[:, 64:].to(dev),
                                              cache)
        if hybrid:       # each reading a list of one tensor a sublayer
            nm = JAMBA_PERIOD - 1
            last.update({
                "scan's y at the prefill": rec["ssd"],
                "output at the prefill": rec["block"][:nm],
                "recurrence's y at the decode step": rec["step"],
                "output at the decode step": rec["block"][nm:],
                "SSM state after the decode step":
                    list(cache.ssm.state.flatten(0, 1).float().cpu())})
            counts = [len(v) for v in last.values()]
            if counts != [nm] * len(counts):
                raise AssertionError(f"model check {arch}: Mamba readings "
                                     f"{counts} a kind, want {nm}")
        return logits[:, 0].float().cpu()

    def against_cpu(got) -> tuple[float, bool]:
        return (float((got - ref).abs().max() / (ref.abs().max() + 1e-9)),
                bool((got.argmax(-1) == ref.argmax(-1)).all()))

    routes = {"cpu": [], "cuda": []}   # each MoE call's topi, gates, logits
    with torch.inference_mode(), record_routes(routes):
        ref = logits_on("cpu", params_cpu)
    ref_mamba = dict(last)
    if moe and len(routes["cpu"]) != 2 * n_moe:
        raise AssertionError(f"model check {arch}: {len(routes['cpu'])} MoE "
                             f"calls recorded, want {2 * n_moe}")

    def on_card(fault) -> tuple[str, list]:
        """The card's run under the context ``fault``: its readings and
        the rules they break."""
        own = {"cpu": [], "cuda": []}
        with torch.inference_mode(), fault(), record_routes(own):
            rel, same = against_cpu(logits_on("cuda", params_gpu))
        text = f"rel={rel:.4f} argmax_equal={same}"
        broken = [] if rel < 0.06 and same or not own_routing \
            else ["rel < 0.06 and equal argmax"]
        if not moe:
            return text, broken
        apart = [routes_apart(a, b)["apart"]
                 for a, b in zip(routes["cpu"], own["cuda"])]
        text += (f", choices apart per call (prefill's layers, then "
                 f"decode's) {apart}")
        fed = []
        with torch.inference_mode(), fault(), routed_as(routes["cpu"], fed):
            fed_rel, fed_same = against_cpu(logits_on("cuda", params_gpu))
        calls = [routes_apart(a, b) for a, b in zip(routes["cpu"], fed)]
        router_rel = max(float((b - a).abs().max() / a.abs().max())
                         for (_, _, a), (_, _, b) in zip(routes["cpu"], fed))
        apart = sum(c["apart"] for c in calls)
        choices = sum(c["choices"] for c in calls)
        excess = max(c["excess"] for c in calls)
        gate_err = max(c["gate_err"] for c in calls)
        text += (f"; with the CPU's routing fed: rel={fed_rel:.4f} (< 0.06) "
                 f"argmax_equal={fed_same}, router logits rel "
                 f"{router_rel:.4f} (< {ROUTER_TOL}), the card's own choices "
                 f"apart per call {[c['apart'] for c in calls]} of "
                 f"{[c['choices'] for c in calls]} (<= {APART_MAX}), "
                 f"largest CPU gap {max(c['gap'] for c in calls):.3e}, "
                 f"excess over the logits' difference {excess:.3e} (<= 0), "
                 f"gates {gate_err:.3e} (< {GATE_TOL})")
        broken += [rule for rule, ok in (
            (f"<= {APART_MAX} of choices apart",
             apart <= APART_MAX * choices),
            ("each choice apart a near-tie", excess <= 0),
            ("gates", gate_err < GATE_TOL),
            ("fed rel < 0.06 and equal argmax", fed_rel < 0.06 and fed_same),
            ("router logits", router_rel < ROUTER_TOL)) if not ok]
        for name, want in ref_mamba.items():      # a hybrid's, fed
            rels = [float((g - w).abs().max() / w.abs().max())
                    for g, w in zip(last[name], want)]
            text += (f"; fed, each Mamba sublayer's {name} rel "
                     f"{[f'{r:.4f}' for r in rels]} (< 0.06)")
            if max(rels) >= 0.06:
                broken.append(f"each Mamba sublayer's {name} rel < 0.06")
        return text, broken

    drawn = " (attention weights at std 1/sqrt(fan-in))" if cfg.attends \
        else ""
    held = "" if own_routing else " (own-routing rel and argmax not held)"
    text, broken = on_card(contextlib.nullcontext)
    log(f"[model] {what} prefill(64)+decode(1){drawn}, cuda "
        f"vs cpu{held}: {text}; broken: {broken or 'none'}; "
        f"{host_memory()} with the host's copy")
    missed = []
    faults = {**planted_faults(torch),
              **(hybrid_faults(torch) if hybrid else {})} if moe else {}
    for name, fault in faults.items():
        text, caught = on_card(fault)
        log(f"[model] {what} planted fault, {name}: {text}; "
            f"broken: {caught or 'none'}")
        missed += [] if caught else [name]
    if broken or missed:
        raise AssertionError(f"model check {arch}: rules broken {broken}, "
                             f"planted faults passed {missed}")


def _train_model(arch: str):
    """``arch`` at the depth ``launch/train.py``'s ``get_config`` gives
    (``cut_depth`` cuts it), configured as ``train_loop`` runs it for
    512-token sequences (one microbatch: qwen3-moe's config asks for 4,
    and ``train_loop`` takes 1 unless told otherwise)."""
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    return build_model(dataclasses.replace(
        train_mod.get_config(arch), q_chunk=256, kv_chunk=256,
        microbatches=1))


def op_device_ms(prof, op: str) -> float:
    """Device ms of the kernels that the calls of aten op ``op`` (e.g.
    ``aten::bmm``) launched, over the profiled window."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.key == op) / 1e3


# the train step's optimizer, which the training profile wraps in a
# ``record_function`` range
TRAIN_PHASES = {"AdamW": ("repro_torch.runtime.train_lib", "adamw_update")}


def profile_train(torch, arch: str, ours: dict) -> None:
    """One train step of ``arch`` (full depth unless ``cut_depth`` cuts
    it; batch 8 x 512 tokens, the encoder-decoder over ``FRAMES_LEN``
    random frames a sequence; remat, AdamW) under the profiler, after a
    warm step: busy share, the largest kernels, the shares of ``ours`` (the
    port's kernels), the GEMMs' and the elementwise ops', the kernels
    launched inside ``adamw_update`` (a ``record_function`` range) and the
    rest of the device time, and the kernels launched by ``aten::bmm``
    calls (on the card only the MoE's batched expert products, forward,
    recomputed and backward); then the AdamW update alone under CUDA
    events."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import FRAMES_LEN
    from repro_torch.models.param import tree_items, tree_map
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.runtime import build_train_step, init_train_state
    model = _train_model(arch)
    cfg = model.cfg
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(model, opt, seed=0, device="cuda")
    step = build_train_step(model, opt)
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 513),
                                     device="cuda", dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(8, FRAMES_LEN, cfg.d_model,
                                      device="cuda").to(torch.bfloat16)
    state, _ = step(state, batch)                             # warm
    torch.cuda.synchronize()
    with phase_ranges(torch, TRAIN_PHASES), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = _profile_report(
        prof, f"{arch} train step at batch 8 x 512 tokens", wall, 1,
        {**ours, "GEMMs": GEMMS, "elementwise, reductions and copies": (
            "elementwise", "reduce", "Memcpy", "copy")},
        top=12, ranges=tuple(TRAIN_PHASES))
    adamw = _phase_split(prof, TRAIN_PHASES, 1)["AdamW"]
    if split:
        parts = {label: split[label] for label in (*ours, "GEMMs")}
        parts["AdamW"] = adamw
        rest = split["device"] - sum(parts.values())
        log(f"[profile] {arch} train step, device ms by part: "
            f"{', '.join(f'{k} {v:.3f}' for k, v in parts.items())}, the "
            f"rest {rest:.3f}, of {split['device']:.3f} ms of device "
            f"kernels in {wall * 1e3:.3f} ms wall")
    bmm_ms = op_device_ms(prof, "aten::bmm")
    if bmm_ms:
        log(f"[profile] {arch} train step: the kernels of aten::bmm (the "
            f"expert products: forward, recomputed and backward) take "
            f"{bmm_ms:.4f} ms/step")
    # the optimizer alone, with CUDA events (it writes into the state)
    grads = tree_map(torch.zeros_like, state.params)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    adamw_update(state.params, grads, state.opt, opt)
    end.record()
    torch.cuda.synchronize()
    log(f"[profile] {arch} AdamW update alone (eager, per leaf, "
        f"{len(tree_items(grads))} stacked leaves): "
        f"{start.elapsed_time(end):.2f} ms")


def _loss_and_grads(model, params, toks, dev: str, **extra):
    """The loss and every leaf's gradient (fp32, on the host; zeros where
    none reached the leaf) of ``params`` copied to ``dev``, on the batch of
    ``toks`` and the tensors ``extra`` (the encoder-decoder's frames)."""
    from repro_torch.models.param import tree_items, tree_map
    leaves = tree_map(lambda a: a.to(dev, copy=True).requires_grad_(),
                      params)
    batch = {"tokens": toks, **extra}
    value = model.loss_fn(leaves, {k: t.to(dev) for k, t in batch.items()})
    value.backward()
    return float(value.detach()), {
        "/".join(p): (t.grad if t.grad is not None
                      else t.detach().new_zeros(t.shape)).float().cpu()
        for p, t in tree_items(leaves)}


TRAIN_GRAD_TOL = 3e-2
# the 15 B archs' train-check depths. qwen3-14b runs two layers: its G = 6
# backward calls (padded heads, qk-norm) get dO through an upper layer's
# backward, and each leaf's gradient below the top layer passes through
# two kernel backwards. starcoder2 (G = 12) and nemotron (G = 6) run one,
# so that the script keeps its time: their CPU steps took 28.1 and 59.3 s
# at two layers, 17.8 and 49.8 s at one (qwen3-14b 37.0 and 28.1; H100
# 80GB HBM3 host, PERF.md §6). At one layer no G = 12 backward call is
# fed by an upper layer's, and no starcoder2 or nemotron leaf's gradient
# passes through two kernel backwards; tinyllama (G = 8, D = 64), qwen3-14b
# (G = 6) and the encoder-decoder (G = 1) check chained layers
TRAIN_CHECK_15B_DEPTH = {"starcoder2-15b": 1, "nemotron-4-15b": 1,
                         "qwen3-14b": 2}


@contextlib.contextmanager
def captured_attention(seen: list):
    """Context: each call of the attention core (``_prefill_core``, the
    flash kernels on the card) appends a dict of its q, k, v and causal
    flag and, by hooks, its dq, dk, dv and dO to ``seen``. Under remat the
    recomputed calls are captured too; their hooks never fire, as the
    gradients run through the first forward's graph."""
    import repro_torch.models.attention as attention

    def wrap(core):
        def capturing_core(q, k, v, cfg, causal=True):
            out = core(q, k, v, cfg, causal)
            rec = {"q": q.detach(), "k": k.detach(), "v": v.detach(),
                   "causal": causal}
            for name, t in (("dq", q), ("dk", k), ("dv", v), ("do", out)):
                t.register_hook(lambda g, name=name: rec.update({name: g}))
            seen.append(rec)
            return out
        return capturing_core
    with patched(attention, "_prefill_core", wrap):
        yield


def attention_grad_errs(seen: list, calls: int) -> list:
    """Per captured attention call (``captured_attention``) whose
    gradients arrived, ``calls`` of them (one a layer, three a decoder
    layer of the encoder-decoder), the backward kernel's dq, dk and dv
    inside the step against ``flash_attention_bwd_plain`` on the same
    tensors with the call's causal flag, each ||got - want|| / ||want||."""
    from flash_bwd_tolerance import grad_err
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain
    done = [rec for rec in seen
            if all(n in rec for n in ("dq", "dk", "dv", "do"))]
    if len(done) != calls:
        raise AssertionError(f"train check: captured {len(done)} attention "
                             f"calls with gradients, want {calls}")
    errs = []
    for rec in done:
        want = flash_attention_bwd_plain(rec["q"], rec["k"], rec["v"],
                                         rec["do"], causal=rec["causal"])
        errs.append([grad_err(rec[n], w)
                     for n, w in zip(("dq", "dk", "dv"), want)])
    return errs


def train_check(torch, arch: str, depth: int = 2) -> None:
    """Full-width ``arch`` (dense or vlm) cut to ``depth`` layers, in bf16:
    the loss and every leaf's gradient of one train step on the card (the
    flash kernels) against the CPU (the plain path), same weights and batch
    (2 x 256 tokens; for the vlm family also 16 vision embeddings and the
    3-D positions of ``qwen2vl_positions``), remat off
    (the launch counts of ``train_loop`` cover remat). Held: the loss within
    1e-2 relative; each leaf within ``TRAIN_GRAD_TOL`` (3e-2) of the CPU's,
    ||card - cpu|| / ||cpu||; and each layer's attention gradient as the
    backward kernel computed it inside the step (dq, dk, dv, with q, k, v
    and dO captured by hooks) against ``flash_attention_bwd_plain`` on the
    card on the same tensors, within the kernel check's ``BWD_TOL``.

    For this check only, the attention weights are drawn at std
    1/sqrt(fan-in): the reference's initializer takes the head count as
    the fan-in of wq, wk and wv and D as wo's, so it draws them
    sqrt(d_model / heads) and sqrt(heads) times larger (wq: tinyllama 8x,
    starcoder2 11.3x, qwen3 10.3x at its 48 lowered heads; wk and wv by
    the KV heads: 22.6x, 39.2x, 25.3x; wo: 5.7x, 6.9x, 6.9x; ROADMAP C),
    which leaves the bf16 gradients so ill-conditioned that two correct
    computations differ by ~30% of a leaf.
    At the true fan-in, ``tools/flash_bwd_tolerance.py`` finds two correct
    CPU computations (blockwise against exact softmax, bf16 against fp32)
    1.3-1.4% apart at most, and a backward with dv 10% low past a quarter of
    the keys 6.1% off on wv."""
    from attention_conditioning import fan_in_std
    from repro_torch.data import DataConfig, SyntheticLM
    from flash_bwd_tolerance import grad_err
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.param import tree_map
    seq = 256
    model = build_model(dataclasses.replace(
        get_config(arch), n_layers=depth, remat=False,
        q_chunk=seq // 2, kv_chunk=seq // 2))
    # drawn on the card and copied to the CPU, as model_check does
    params = tree_map(lambda a: a.cpu(), init_params(
        model.param_decls(), torch.Generator(device="cuda").manual_seed(0),
        "cuda"))
    torch.cuda.empty_cache()
    cfg = model.cfg
    params["layers"]["attn"] = fan_in_std(params["layers"]["attn"],
                                          cfg.d_model)
    toks = torch.as_tensor(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=2)).batch_at(0)["tokens"])
    extra, what = {}, ""
    if cfg.family == "vlm":
        n_vis = QWEN2VL_GRID[0] * QWEN2VL_GRID[1]
        extra = {"vision_embeds": torch.randn(
            2, n_vis, cfg.d_model, generator=torch.Generator().manual_seed(
                2)).bfloat16(),
            "mrope_positions": qwen2vl_positions(torch, seq, 2)}
        what = f", {n_vis} vision embeddings and 3-D positions"

    seen = []
    t0 = time.perf_counter()
    with captured_attention(seen):
        loss, grads = _loss_and_grads(model, params, toks, "cuda", **extra)
    ref_loss, ref_grads = _loss_and_grads(model, params, toks, "cpu",
                                          **extra)
    seconds = time.perf_counter() - t0

    rel = abs(loss - ref_loss) / abs(ref_loss)
    errs = {k: grad_err(grads[k], w) for k, w in ref_grads.items()}
    top = sorted(errs, key=lambda k: -errs[k])[:4]
    attn_errs = attention_grad_errs(seen, cfg.n_layers)
    log(f"[model] depth-{depth} {arch} bf16 train step{what} (attention "
        f"weights at std 1/sqrt(fan-in); {seconds:.1f} s; "
        f"{host_memory()}), cuda vs cpu: loss "
        f"{loss:.6f} vs "
        f"{ref_loss:.6f} (rel {rel:.2e}, tol 1e-2); worst ||diff||/||g|| "
        f"{', '.join(f'{k} {errs[k]:.2e}' for k in top)} (tol "
        f"{TRAIN_GRAD_TOL:g}); the backward kernel in the step against the "
        f"plain version, per layer (dq, dk, dv): "
        f"{[[f'{e:.2e}' for e in l] for l in attn_errs]} (tol "
        f"{BWD_TOL['bfloat16']:g})")
    if not (rel < 1e-2 and max(errs.values()) <= TRAIN_GRAD_TOL
            and max(map(max, attn_errs)) <= BWD_TOL["bfloat16"]):
        raise AssertionError(f"bf16 train check {arch}: CUDA and CPU "
                             f"disagree")


def train_check_ssm(torch) -> None:
    """Depth-2, full-width mamba2 in bf16: the loss and every leaf's
    gradient of one train step on the card (the ssd kernels, forward and
    backward) against the CPU (the plain scan under autograd), same weights
    and batch (2 x 256 tokens), remat off. Held: the loss within 1e-2
    relative; each leaf within ``TRAIN_GRAD_TOL`` (3e-2) of the CPU's,
    ||card - cpu|| / ||cpu||."""
    from flash_bwd_tolerance import grad_err
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.ssd import kernel_bwd as ssd_bwd_k
    from repro_torch.models import build_model, init_params
    seq = 256
    model = build_model(dataclasses.replace(
        get_config("mamba2-370m"), n_layers=2, remat=False,
        q_chunk=seq // 2, kv_chunk=seq // 2))
    params = init_params(model.param_decls(),
                         torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(SyntheticLM(DataConfig(
        vocab=model.cfg.vocab, seq_len=seq,
        global_batch=2)).batch_at(0)["tokens"])
    before = ssd_bwd_k.launches
    loss, grads = _loss_and_grads(model, params, toks, "cuda")
    calls = ssd_bwd_k.launches - before
    ref_loss, ref_grads = _loss_and_grads(model, params, toks, "cpu")
    rel = abs(loss - ref_loss) / abs(ref_loss)
    errs = {k: grad_err(grads[k], w) for k, w in ref_grads.items()}
    top = sorted(errs, key=lambda k: -errs[k])[:4]
    log(f"[model] depth-2 mamba2-370m bf16 train step, cuda vs cpu: loss "
        f"{loss:.6f} vs {ref_loss:.6f} (rel {rel:.2e}, tol 1e-2); worst "
        f"||diff||/||g|| {', '.join(f'{k} {errs[k]:.2e}' for k in top)} "
        f"(tol {TRAIN_GRAD_TOL:g}); {calls} ssd backward calls")
    if calls != 2 or not (rel < 1e-2
                          and max(errs.values()) <= TRAIN_GRAD_TOL):
        raise AssertionError("mamba2 bf16 train check: CUDA and CPU "
                             "disagree")


# qwen3-moe trains at 1 of its 94 layers: 2.488 B parameters a layer plus
# 1.245 B of embedding and head take 44.8 GB of training state (derived);
# at 2 layers, 74.7 GB
MOE_TRAIN_LAYERS = 1
# the train check against the CPU: 2 layers, 6.22 B parameters (12.4 GB in
# bf16, derived), whose CPU copy and gradients the host holds
MOE_CHECK_LAYERS = 2
POLICIES = ("full", "dots", "names")


def leaf_err(got, want) -> float:
    """||got - want|| / ||want|| in fp32, 2^28 elements at a time (a
    depth-2 expert leaf in fp32 would take 12.9 GB)."""
    num = den = 0.0
    for g, w in zip(got.reshape(-1).split(1 << 28),
                    want.reshape(-1).split(1 << 28)):
        w = w.float()
        num += float((g.float() - w).square().sum())
        den += float(w.square().sum())
    return (num / den) ** 0.5


def moe_train_check(torch) -> None:
    """Full-width qwen3-moe-235b-a22b cut to ``MOE_CHECK_LAYERS`` layers,
    in bf16: one train step's loss and every leaf's gradient on
    the card (the flash kernels, the MoE in plain torch) against the CPU
    (the plain path), same weights and batch (2 x 256 tokens), the
    attention weights at std 1/sqrt(fan-in) as ``train_check`` draws them.
    The CPU runs once, remat off, "scatter" dispatch, its routing recorded;
    the gradients are compared on the card, leaf by leaf. The card runs:

    * with its own routing, remat off: loss and gradients printed, not
      held (a near-tie that routes apart moves a whole expert's gradient:
      ROADMAP C.2);
    * with the CPU's experts (``experts_as``), remat off, in each dispatch
      mode ("scatter" and "gather" compute one function, so both are held
      to the one CPU run): the loss within 1e-2 relative, each leaf within
      ``TRAIN_GRAD_TOL`` of its norm and, in "scatter", each layer's
      flash-backward gradients inside the step against
      ``flash_attention_bwd_plain`` within ``BWD_TOL``;
    * with the CPU's experts, "scatter", under each remat policy: the loss
      equal to the remat-off run's bit for bit (a policy changes what the
      backward recomputes, not the forward) and each leaf within
      ``TRAIN_GRAD_TOL`` of the CPU's. The card's gradients are not
      bit-reproducible (the MoE backward's index writes accumulate with
      atomics, ``models/moe.py``), so the policies are held to the CPU by
      the rule, not to each other by their bits."""
    from attention_conditioning import fan_in_std
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build_model, init_params
    from repro_torch.models.param import tree_items, tree_map
    t_phase = time.perf_counter()
    seq = 256
    tag = f"depth-{MOE_CHECK_LAYERS} {MOE_ARCH}"
    log(f"[model] {tag} train check: {host_memory()} before")
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=MOE_CHECK_LAYERS, remat=False,
                              q_chunk=seq // 2, kv_chunk=seq // 2)
    params = init_params(build_model(cfg).param_decls(),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    params["layers"]["attn"] = fan_in_std(params["layers"]["attn"],
                                          cfg.d_model)
    toks = torch.as_tensor(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=2)).batch_at(0)["tokens"])

    def step(dev: str, **changes):
        """The loss and each leaf's gradient (in its dtype, on ``dev``)."""
        model = build_model(dataclasses.replace(cfg, **changes))
        leaves = tree_map(lambda a: a.to(dev, copy=True).requires_grad_(),
                          params if dev == "cuda" else params_cpu)
        value = model.loss_fn(leaves, {"tokens": toks.to(dev)})
        value.backward()
        return float(value.detach()), {"/".join(p): t.grad
                                       for p, t in tree_items(leaves)}

    params_cpu = tree_map(lambda a: a.cpu(), params)
    routes = {"cpu": [], "cuda": []}
    t0 = time.perf_counter()
    with record_routes(routes):
        ref_loss, ref = step("cpu")
    cpu_s = time.perf_counter() - t0
    log(f"[model] {tag} train step on the CPU: "
        f"{cpu_s:.1f} s; {host_memory()} with the host's copy and its "
        f"gradients")
    ref = {k: g.to("cuda") for k, g in ref.items()}
    del params_cpu
    gc.collect()

    def against_cpu(label: str, loss: float, grads: dict) -> tuple:
        rel = abs(loss - ref_loss) / abs(ref_loss)
        errs = {k: leaf_err(grads[k], w) for k, w in ref.items()}
        top = sorted(errs, key=lambda k: -errs[k])[:4]
        log(f"[model] {tag} bf16 train step, {label}, "
            f"cuda vs cpu: loss {loss:.6f} vs {ref_loss:.6f} (rel "
            f"{rel:.2e}); worst ||diff||/||g|| "
            f"{', '.join(f'{k} {errs[k]:.2e}' for k in top)}")
        return rel, max(errs.values())

    against_cpu("own routing (printed, not held: ROADMAP C.2)",
                *step("cuda"))
    failed = []
    fed_loss = None
    for mode in ("scatter", "gather"):
        seen = []
        with experts_as(routes["cpu"]), captured_attention(seen):
            loss, grads = step("cuda", moe_dispatch=mode)
        rel, worst = against_cpu(f"the CPU's experts fed, {mode}, remat "
                                 f"off", loss, grads)
        del grads
        ok = rel < 1e-2 and worst <= TRAIN_GRAD_TOL
        if mode == "scatter":
            fed_loss = loss
            attn = attention_grad_errs(seen, MOE_CHECK_LAYERS)
            log(f"[model] {tag} the backward kernel in "
                f"the step against the plain version, per layer (dq, dk, "
                f"dv): {[[f'{e:.2e}' for e in l] for l in attn]} (tol "
                f"{BWD_TOL['bfloat16']:g})")
            ok = ok and max(map(max, attn)) <= BWD_TOL["bfloat16"]
        failed += [] if ok else [mode]
    for policy in POLICIES:
        with experts_as(routes["cpu"]):
            loss, grads = step("cuda", remat=True, remat_policy=policy)
        rel, worst = against_cpu(f"the CPU's experts fed, remat "
                                 f"{policy!r}", loss, grads)
        del grads
        log(f"[model] {tag} remat {policy!r}: loss "
            f"equal to remat off's bit for bit: {loss == fed_loss}")
        if not (loss == fed_loss and rel < 1e-2
                and worst <= TRAIN_GRAD_TOL):
            failed.append(policy)
    log(f"[model] {tag} train check (held: loss 1e-2, "
        f"each leaf {TRAIN_GRAD_TOL:g} of its norm, the backward kernel "
        f"{BWD_TOL['bfloat16']:g}) in {time.perf_counter() - t_phase:.1f} "
        f"s; failed: {failed or 'none'}")
    if failed:
        raise AssertionError(f"{MOE_ARCH} train check: CUDA and CPU "
                             f"disagree under {failed}")


def remat_policy_steps(torch, counters: dict) -> None:
    """qwen3-moe at full width cut to ``MOE_TRAIN_LAYERS`` layer, one
    train step (batch 8 x 512 tokens, AdamW) under each remat policy and
    with remat off, on one state: host ms of the step (after a warm step
    of its own, ended by reading the loss), peak memory, and the flash
    kernels' launches: the forward twice a layer under "full" and "names"
    (recomputed), once under "dots" (its output saved) and without remat;
    the backward once. The losses must be finite."""
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import build_train_step, init_train_state
    t_phase = time.perf_counter()
    with cut_depth(train_mod, MOE_TRAIN_LAYERS):
        base = _train_model(MOE_ARCH)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = init_train_state(base, opt, seed=0, device="cuda")
    batch = {"tokens": torch.randint(0, base.cfg.vocab, (8, 513),
                                     device="cuda", dtype=torch.int32)}
    layers = base.cfg.n_layers
    for remat, policy in ((True, "full"), (True, "dots"), (True, "names"),
                          (False, "off")):
        step = build_train_step(build_model(dataclasses.replace(
            base.cfg, remat=remat, remat_policy=policy)), opt)
        state, _ = step(state, batch)                            # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        counts = {name: k.launches for name, k in counters.items()}
        fwd = 2 * layers if remat and policy != "dots" else layers
        log(f"[train] {MOE_ARCH} at {layers} layer, batch 8 x 512, remat "
            f"{policy}: {ms:.1f} ms a step, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss "
            f"{loss:.4f}, flash launches forward "
            f"{counts['flash_attention']} (want {fwd}) backward "
            f"{counts['flash_attention_bwd']} (want {layers})")
        if not (loss == loss and abs(loss) < float("inf")
                and counts["flash_attention"] == fwd
                and counts["flash_attention_bwd"] == layers):
            raise AssertionError(f"{MOE_ARCH} remat {policy}: loss {loss}, "
                                 f"launches {counts}")
    log(f"[train] {MOE_ARCH} remat policies' steps in "
        f"{time.perf_counter() - t_phase:.1f} s")


def cut_configs(launch_mod, change):
    """Context: the configs a launch module reads (``launch/train.py``,
    ``launch/serve.py``) passed through ``change``."""
    def wrap(full):
        def cut(arch, *, reduced=False):
            return change(full(arch, reduced=reduced))
        return cut
    return patched(launch_mod, "get_config", wrap)


def cut_depth(launch_mod, layers: int = 2):
    """Context: the launch module's configs cut to ``layers`` layers, at
    full width."""
    return cut_configs(launch_mod, lambda cfg: dataclasses.replace(
        cfg, n_layers=layers))


def resume_check(torch, arch: str, exact: bool = False) -> None:
    """Depth-2, full-width ``arch`` through ``train_loop`` on the card: six
    steps uninterrupted; six again with a checkpoint every 2 steps and a
    simulated crash after step 4; then a resume, which must start at step 4
    and reproduce the uninterrupted losses (rtol 2e-2, as
    tests/test_runtime.py holds the reference; with ``exact``, bit for bit:
    no kernel of the path sums in an order that changes from run to run).
    Checkpoints (2.2 GB each for tinyllama) go to build/, which the run
    deletes after."""
    import shutil
    from repro_torch.launch import train as train_mod
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(steps=6, batch=4, seq=256, seed=3, log_every=0, device="cuda")
    try:
        with cut_depth(train_mod):
            t0 = time.perf_counter()
            full = train_mod.train_loop(arch, **kw)
            try:
                train_mod.train_loop(arch, ckpt_dir=str(ckpt),
                                     ckpt_every=2, simulate_failure=4, **kw)
            except RuntimeError as exc:
                if "simulated" not in str(exc):
                    raise
            else:
                raise AssertionError("train_loop did not simulate its failure")
            resumed = train_mod.train_loop(arch, ckpt_dir=str(ckpt),
                                           ckpt_every=2, resume=True, **kw)
            seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    worst = max(abs(a - b) / abs(b) for a, b in
                zip(resumed["losses"], full["losses"][4:]))
    same = resumed["losses"] == full["losses"][4:]
    log(f"[model] depth-2 {arch} crash after step 4 and resume: "
        f"start_step {resumed['start_step']}, losses {resumed['losses']} vs "
        f"uninterrupted {full['losses'][4:]} (max rel {worst:.2e}, tol "
        f"{'0: bit for bit' if exact else '2e-2'}; identical={same}); "
        f"{seconds:.1f} s with checkpoints")
    if resumed["start_step"] != 4 or len(resumed["losses"]) != 2 \
            or not worst < 2e-2 or (exact and not same):
        raise AssertionError("resume did not reproduce the trajectory")


# ----------------------------------------------------------- orchestration
ORCH_ARCH = "tinyllama-1.1b"


def run_orchestrated(torch, train_mod, pattern: str, kw: dict, *,
                     ckpt_dir=None, save_late: bool = False) -> dict:
    """``train_loop``'s job (``kw``) under the port's DFlow engine:
    ``run_training`` composed with ``setup_training``'s step and state, the
    synthetic source's ``batch_at(i)`` moved to the card and
    ``CheckpointManager.save`` (every 2 steps when ``ckpt_dir`` is set).
    With ``save_late`` each save first waits (up to 2 s) for the next step
    to finish, which only a missing in-place rule would let happen. Returns
    the losses, the host wall time of ``run_training`` between two
    ``cuda.synchronize``, the engine's per-function completion times and
    each save's host ms (the final state is not kept)."""
    import threading
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime.orchestrator import (OrchestratorConfig,
                                                  run_training)
    s = train_mod.setup_training(ORCH_ARCH, device="cuda", **kw)
    source = SyntheticLM(s.data)
    steps = kw["steps"]
    finished = [threading.Event() for _ in range(steps + 1)]
    calls, save_ms, waited = [], [], []

    def fetch(i):
        return {k: torch.as_tensor(v).to(s.device)
                for k, v in source.batch_at(i).items()}

    def train(state, batch):
        i = len(calls)
        calls.append(i)
        out = s.step_fn(state, batch)
        finished[i].set()
        return out

    mgr = save = None
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir, keep=2, async_save=True)

        def save(i, state):
            if save_late:
                waited.append(finished[i + 1].wait(2.0))
            t0 = time.perf_counter()
            mgr.save(i + 1, state)        # returns once it holds its copy
            save_ms.append((time.perf_counter() - t0) * 1e3)
    cfg = OrchestratorConfig(n_steps=steps, ckpt_every=2 if mgr else 0,
                             pattern=pattern)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = run_training(cfg, init_state=s.state, fetch=fetch, train=train,
                       save=save)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if mgr is not None:
        mgr.wait()
    losses = [float(rep.outputs[f"metrics.{i}"]["loss"])
              for i in range(steps)]
    return {"losses": losses, "wall_s": wall,
            "per_function": rep.per_function, "save_ms": save_ms,
            "waited": waited}


def run_traced(torch, train_mod, kw: dict) -> dict:
    """``run_orchestrated``'s "dataflow" job with the port's DScope on: the
    engine that ``run_training`` builds gets a ``Tracer`` through its
    ``spans=`` argument, and its instance's store a ``MetricsRegistry``
    (``DStore.attach_metrics``), both bound by ``patched`` while the run
    lasts. Returns ``run_orchestrated``'s result, the finished spans, the
    tracer's span count and the registry's totals, read at once (the
    registry's collectors hold the store, and with it the state)."""
    from repro_torch.core.dstore import DStore
    from repro_torch.core.obs import MetricsRegistry, Tracer
    from repro_torch.runtime import orchestrator
    tracer, registry = Tracer(), MetricsRegistry()

    def traced(engine):
        class TracedEngine(engine):
            def __init__(self, *args, **kw):
                super().__init__(*args, spans=tracer, **kw)

            def start(self, wf, inputs=None, *, store=None, **kw):
                if store is None:
                    store = DStore(self.nodes, self.transport)
                    store.attach_metrics(registry)
                return super().start(wf, inputs, store=store, **kw)
        return TracedEngine

    with patched(orchestrator, "DFlowEngine", traced):
        out = run_orchestrated(torch, train_mod, "dataflow", kw)
    dump = registry.collect()
    gets = registry.histogram("dstore_get_seconds")
    out.update(spans=tracer.finished(), started=tracer._next_id,
               gets=(gets.count, gets.summary()["sum"]),
               registry={k: v for k, v in sorted(
                   {**dump["counters"], **dump["gauges"]}.items())})
    return out


def orchestrate_trace(traced: dict, untraced: dict, steps: int) -> None:
    """The traced run's spans held to the engine's rules, attributed
    against the DPlan of the DAG that ``run_training`` builds
    (``build_training_workflow``'s exec-time hints: 0.05 s a fetch, 0.2 s
    a step; the plan is read, not run), written under ``build/`` and read
    back by ``python -m repro_torch.obs summarize`` and ``attribute
    --format json``, whose report must equal the one computed here. Its
    losses within rtol 2e-2 of the untraced "dataflow" run's."""
    import collections
    from repro_torch.core.obs import (attribute, plan_attribution,
                                      read_spans_jsonl, write_spans_jsonl)
    from repro_torch.core.plan import build_plan
    from repro_torch.runtime.orchestrator import build_training_workflow
    wf = build_training_workflow(steps, fetch=lambda i: None,
                                 train=lambda state, batch: (state, {}))
    plan = build_plan(wf, nodes=["node0", "node1"])
    spans = traced["spans"]
    kinds = collections.Counter(s.kind for s in spans)
    log(f"[orchestrate] traced: {len(spans)} spans by kind "
        f"{dict(sorted(kinds.items()))}")
    problems = []
    requests = [s for s in spans if s.kind == "request"]
    invokes = [s for s in spans if s.kind == "invoke"]
    if len(requests) != 1:
        problems.append(f"{len(requests)} request spans, want 1")
    if sorted(s.name for s in invokes) != sorted(wf.functions):
        problems.append(f"invoke spans {sorted(s.name for s in invokes)}, "
                        f"want one for each of {sorted(wf.functions)}")
    if sorted(s.id for s in spans) != list(range(1, traced["started"] + 1)):
        problems.append(f"{traced['started'] - len(spans)} spans left open")
    for req in requests[:1]:
        for s in invokes:
            if s.parent != req.id or not (
                    req.start <= s.start and s.end <= req.end):
                problems.append(f"invoke {s.name} not nested in the "
                                f"request span")
    path = ROOT / "build" / "chip_smoke_orchestrate_spans.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    write_spans_jsonl(spans, str(path), plan=plan_attribution(plan))
    back, meta = read_spans_jsonl(str(path))
    report = attribute(back, meta["plan"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = {cmd: subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", cmd, str(path), *extra],
        capture_output=True, text=True, env=env, timeout=300)
        for cmd, extra in (("summarize", ()),
                           ("attribute", ("--format", "json")))}
    for cmd, proc in cli.items():
        if proc.returncode:
            problems.append(f"python -m repro_torch.obs {cmd} exited "
                            f"{proc.returncode}: {proc.stderr[-2000:]}")
    log("[orchestrate] python -m repro_torch.obs summarize:\n"
        + cli["summarize"].stdout.rstrip())
    same = (not cli["attribute"].returncode and json.dumps(
        json.loads(cli["attribute"].stdout), sort_keys=True)
        == json.dumps(report, sort_keys=True))
    log(f"[orchestrate] attribute --format json equals the in-process "
        f"attribution: {same}")
    if not same:
        problems.append("the CLI's attribution differs from attribute()")
    dur = {s.name: s.duration for s in invokes}
    rows = {r["function"]: r for r in report["functions"]}
    if sorted(rows) != sorted(wf.functions):
        problems.append(f"the attribution covers {sorted(rows)}")

    def ms(agg):
        return agg.get("mean", float("nan")) * 1e3
    for name in sorted(rows, key=lambda f: (f.split(".")[-1], f)):
        r, fp = rows[name], plan.functions[name]
        log(f"[orchestrate] traced {name}: invoke "
            f"{dur.get(name, float('nan')) * 1e3:.1f} ms (plan "
            f"{(fp.eft - fp.est) * 1e3:.0f}), start drift "
            f"{ms(r['start_drift']):.1f} ms, finish drift "
            f"{ms(r['finish_drift']):.1f} ms")
    log(f"[orchestrate] traced request: latency "
        f"{report['latency']['mean'] * 1e3:.1f} ms against the plan's "
        f"critical path {report['critical_path'] * 1e3:.0f} ms, drift "
        f"{report['cp_drift']['mean'] * 1e3:.1f} ms")
    n_gets, get_s = traced["gets"]
    log(f"[orchestrate] traced registry: {n_gets} Gets, {get_s * 1e3:.1f} "
        f"ms inside them; {kinds.get('put', 0)} Puts (spans); totals "
        f"(DStore's sizes, a dict of tensors 64 bytes: metadata, not the "
        f"state's bytes) {traced['registry']}")
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(traced["losses"], untraced["losses"]))
    log(f"[orchestrate] traced {traced['wall_s'] / steps * 1e3:.1f} ms a "
        f"step against untraced dataflow's "
        f"{untraced['wall_s'] / steps * 1e3:.1f} (one run each, "
        f"unordered); losses max rel {rel:.2e} (tol 2e-2), identical: "
        f"{traced['losses'] == untraced['losses']}")
    if not rel < 2e-2:
        problems.append(f"losses rel {rel:.2e} from the untraced run's")
    if problems:
        raise AssertionError("traced orchestrate run: " + "; ".join(problems))


def _ckpt_leaves(directory: Path, step: int) -> dict:
    """Every leaf of a saved checkpoint as fp64 (bf16 from its bits)."""
    import numpy as np
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    out = {}
    for key, meta in manifest["leaves"].items():
        a = np.load(d / f"{key}.npy")
        if meta["dtype"] == "bfloat16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[key] = a.astype(np.float64)
    return out


def _ckpts_agree(got: Path, want: Path, steps) -> tuple[float, bool]:
    """The largest leaf difference relative to that leaf's largest
    magnitude over ``steps``, and whether every leaf is bit for bit."""
    import numpy as np
    worst, same = 0.0, True
    for step in steps:
        a, b = _ckpt_leaves(got, step), _ckpt_leaves(want, step)
        if set(a) != set(b):
            raise AssertionError(f"checkpoint {step}: leaves differ")
        for k in b:
            scale = max(float(np.abs(b[k]).max()), 1e-30)
            worst = max(worst, float(np.abs(a[k] - b[k]).max()) / scale)
            same = same and bool(np.array_equal(a[k], b[k]))
    return worst, same


def orchestrate_check(torch, counters: dict) -> None:
    """The port's train step under its DFlow engine (``runtime/
    orchestrator.py``), on the card.

    Depth 2, full width (batch 4 x 256, 4 steps, a checkpoint every 2):
    ``run_training`` under "dataflow" against ``train_loop``, losses and
    every leaf of the checkpoints at steps 2 and 4 within 2e-2 (the
    tinyllama resume rule; leaves relative to their largest magnitude),
    then again with a save that waits for the next step before it
    snapshots. Full depth and width (batch 8 x 512, remat, 6 steps):
    ``train_loop``, then ``run_training`` under "dataflow" and
    "controlflow": ms a step, the flash kernels' launches a step (44 and
    22, so the kernels ran in the DAG's threads), the engine's per-function
    completion times, and the peak memory, each orchestrated peak within
    1.05x of ``train_loop``'s."""
    import shutil
    from repro_torch.launch import train as train_mod
    root = ROOT / "build" / "chip_smoke_orchestrate"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(steps=4, batch=4, seq=256, seed=3)
    try:
        with cut_depth(train_mod):
            loop = train_mod.train_loop(ORCH_ARCH, ckpt_dir=str(root / "loop"),
                                        ckpt_every=2, log_every=0,
                                        device="cuda", **kw)
            for label, late in (("dataflow", False),
                                ("dataflow, each save waiting for the next "
                                 "step", True)):
                out = run_orchestrated(torch, train_mod, "dataflow", kw,
                                       ckpt_dir=root / "dag", save_late=late)
                rel = max(abs(a - b) / abs(b)
                          for a, b in zip(out["losses"], loop["losses"]))
                worst, same = _ckpts_agree(root / "dag", root / "loop",
                                           (2, 4))
                log(f"[orchestrate] depth-2 {ORCH_ARCH} run_training "
                    f"({label}), 4 steps: losses {out['losses']} vs "
                    f"train_loop {loop['losses']} (max rel {rel:.2e}, tol "
                    f"2e-2; identical={out['losses'] == loop['losses']}); "
                    f"checkpoints 2, 4: worst leaf {worst:.2e} of its "
                    f"largest magnitude (tol 2e-2; bit for bit={same}); "
                    f"each save's snapshot on the critical path "
                    f"{[round(ms, 1) for ms in out['save_ms']]} ms"
                    + (f"; the next step ran during the wait: "
                       f"{out['waited']}" if late else ""))
                if not (rel < 2e-2 and worst < 2e-2) or any(out["waited"]):
                    raise AssertionError(f"orchestrated depth-2 run "
                                         f"({label}) disagrees with "
                                         f"train_loop")
                shutil.rmtree(root / "dag")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    kw = dict(steps=6, batch=8, seq=512, seed=0)
    layers, steps = 22, kw["steps"]
    runs = {}
    for how in ("train_loop", "dataflow", "controlflow", "dataflow, traced"):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for k in counters.values():
            k.launches = 0
        if how == "train_loop":
            out = train_mod.train_loop(ORCH_ARCH, log_every=0,
                                       device="cuda", **kw)
        elif how == "dataflow, traced":
            out = run_traced(torch, train_mod, kw)
        else:
            out = run_orchestrated(torch, train_mod, how, kw)
        peak = torch.cuda.max_memory_allocated()
        counts = {name: k.launches for name, k in counters.items()}
        runs[how] = (out, peak)
        done = ""
        if "per_function" in out:
            done = "; completed at (ms from the start) " + ", ".join(
                f"{f} {t * 1e3:.1f}" for f, t in sorted(
                    out["per_function"].items(), key=lambda kv: kv[1]))
        log(f"[orchestrate] {ORCH_ARCH} {how}, batch=8 seq=512, {layers} "
            f"layers, remat, {steps} steps: "
            f"{out['wall_s'] / steps * 1e3:.1f} ms/step; flash forward "
            f"{counts['flash_attention'] / steps:g} and backward "
            f"{counts['flash_attention_bwd'] / steps:g} launches a step; "
            f"peak {peak / 2**30:.2f} GiB ({before / 2**30:.2f} GiB "
            f"allocated before); losses {out['losses']}{done}")
        want = dict.fromkeys(counters, 0)
        want.update(flash_attention=steps * 2 * layers,
                    flash_attention_bwd=steps * layers)
        if counts != want:
            raise AssertionError(f"{how}: launches {counts}, want {want}")
        if len(out["losses"]) != steps or not all(
                l == l and abs(l) < float("inf") for l in out["losses"]):
            raise AssertionError(f"{how}: losses {out['losses']}")
    loop, loop_peak = runs["train_loop"]
    for how in ("dataflow", "controlflow", "dataflow, traced"):
        out, peak = runs[how]
        same = out["losses"] == loop["losses"]
        log(f"[orchestrate] {how}: peak / train_loop's "
            f"{peak / loop_peak:.4f} (tol 1.05); losses identical to "
            f"train_loop's: {same}")
        if peak > 1.05 * loop_peak:
            raise AssertionError(f"{how} peaks at {peak / 2**30:.2f} GiB, "
                                 f"over 1.05x train_loop's")
    orchestrate_trace(runs["dataflow, traced"][0], runs["dataflow"][0],
                      steps)


# ------------------------------------------------------ encoder-decoder
SEAMLESS_ARCH = "seamless-m4t-large-v2"
ENCDEC_CHECK_LAYERS = 2  # encoder and decoder layers of encdec_model_check


def encdec_prefill_flops(cfg, batch: int, prompt: int, frames: int) -> float:
    """FLOPs of an encoder-decoder prefill of ``batch`` prompts of
    ``prompt`` tokens over ``frames`` frames: 2 x each weight x the tokens
    it multiplies (the encoder's and the decoder's cross wk, wv over the
    frames, the rest of the decoder over the prompt, the head over each
    prompt's last token; norms and the embedding lookup left out), plus
    the attention's two products: the encoder's frames x frames, the
    decoder's causal prompt x prompt / 2, the cross prompt x frames."""
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_items
    flops = 0.0
    for path, d in tree_items(build_model(cfg).param_decls()):
        name = path[-1]
        if path == ("embed",) or name.startswith("ln") \
                or name.endswith("norm"):
            continue
        if path[0] == "encoder" or path[-2:] in (("cross_attn", "wk"),
                                                 ("cross_attn", "wv")):
            tokens = batch * frames
        elif path == ("head",):
            tokens = batch
        else:
            tokens = batch * prompt
        flops += 2 * d.size * tokens
    per_pair = 4 * batch * cfg.n_heads * cfg.head_dim
    return flops + per_pair * (
        cfg.n_encoder_layers * frames * frames
        + cfg.n_layers * (prompt * prompt / 2 + prompt * frames))


def encdec_serve_check(torch, counters: dict) -> dict:
    """seamless-m4t-large-v2 at full width and full depth (24 encoder and
    24 decoder layers, 1.632 B parameters) through ``serve_counted``, 1024
    frames a prompt: the flash kernel once an encoder layer (non-causal,
    1024 x 1024), once a decoder layer (causal, 512) and once a decoder
    layer's cross-attention (512 over 1024) at the prefill, and the decode
    kernel twice a decoder layer each decode step (fp32 over the self
    cache, bf16 over the memory); no other kernel."""
    from repro_torch.configs import get_config
    cfg = get_config(SEAMLESS_ARCH)
    counts = serve_counted(torch, counters, SEAMLESS_ARCH, cfg.n_layers,
                           cfg.vocab)
    want = dict.fromkeys(counters, 0)
    want.update(flash_attention=cfg.n_encoder_layers + 2 * cfg.n_layers,
                decode_attention=2 * cfg.n_layers * 31)
    if counts != want:
        raise AssertionError(f"{SEAMLESS_ARCH} launches {counts}: want "
                             f"{want}")
    return counts


def encdec_model_check(torch) -> None:
    """seamless-m4t-large-v2 at full width cut to ``ENCDEC_CHECK_LAYERS``
    encoder and as many decoder layers, the attention weights at std
    1/sqrt(fan-in) (as ``model_check`` draws them): prefill(64 tokens over
    64 frames) + decode(1) on the card against the CPU's plain path, the
    logits held to rel < 0.06 with equal argmax, and each decoder layer's
    cross-attention output at the decode step to rel < 0.06 of its largest
    magnitude. A
    planted fault, the card's cross length set to half the memory (the
    decode kernel then reads 32 of the 64 frames), must break a rule."""
    import importlib
    from attention_conditioning import fan_in_std
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.param import tree_map
    encdec_mod = importlib.import_module("repro_torch.models.encdec")
    cfg = dataclasses.replace(get_config(SEAMLESS_ARCH),
                              n_layers=ENCDEC_CHECK_LAYERS,
                              n_encoder_layers=ENCDEC_CHECK_LAYERS,
                              q_chunk=32, kv_chunk=32, max_cache_len=72)
    model = build_model(cfg)
    params_gpu = init_params(model.param_decls(),
                             torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
    params_gpu["encoder"]["attn"] = fan_in_std(params_gpu["encoder"]["attn"],
                                               cfg.d_model)
    for name in ("self_attn", "cross_attn"):
        params_gpu["decoder"][name] = fan_in_std(
            params_gpu["decoder"][name], cfg.d_model)
    params_cpu = tree_map(lambda a: a.cpu(), params_gpu)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen)
    frames = torch.randn(2, 64, cfg.d_model, generator=gen).bfloat16()

    def run(dev: str, params):
        """The decode step's logits and each layer's cross-attention
        output at that step, on the host."""
        crosses = []

        def recording(cross):
            def wrapped(p, x, c, memory):
                out = cross(p, x, c, memory)
                if x.shape[1] == 1:
                    crosses.append(out.float().cpu())
                return out
            return wrapped
        with torch.inference_mode(), \
                patched(encdec_mod, "cross_attention", recording):
            cache = model.init_cache(2, cfg.max_cache_len, 64, device=dev)
            _, cache = model.prefill(params, frames.to(dev),
                                     toks[:, :64].to(dev), cache)
            logits, _ = model.decode_step(params, toks[:, 64:].to(dev),
                                          cache)
        return logits[:, 0].float().cpu(), crosses

    def rel(got, want) -> float:
        return float((got - want).abs().max() / (want.abs().max() + 1e-9))

    ref, ref_cross = run("cpu", params_cpu)

    def on_card(fault) -> tuple[str, list]:
        with fault():
            got, cross = run("cuda", params_gpu)
        r = rel(got, ref)
        same = bool((got.argmax(-1) == ref.argmax(-1)).all())
        layers = [rel(c, w) for c, w in zip(cross, ref_cross)]
        broken = [rule for rule, ok in (
            ("rel < 0.06 and equal argmax", r < 0.06 and same),
            ("each layer's cross-attention rel < 0.06",
             len(layers) == ENCDEC_CHECK_LAYERS and max(layers) < 0.06))
            if not ok]
        return (f"rel={r:.4f} argmax_equal={same}, decode-step "
                f"cross-attention rel by layer "
                f"{[round(x, 4) for x in layers]}"), broken

    def half_memory():
        def wrap(init_cache):
            def faulty(self, batch, max_len, memory_len, *, device="cuda"):
                cache = init_cache(self, batch, max_len, memory_len,
                                   device=device)
                if cache.cross_length.is_cuda:
                    cache.cross_length.fill_(memory_len // 2)
                return cache
            return faulty
        return patched(encdec_mod.EncDecLM, "init_cache", wrap)

    tag = (f"depth-{ENCDEC_CHECK_LAYERS}+{ENCDEC_CHECK_LAYERS} "
           f"{SEAMLESS_ARCH}")
    text, broken = on_card(contextlib.nullcontext)
    log(f"[model] {tag} prefill(64 tokens, "
        f"64 frames)+decode(1) (attention weights at std 1/sqrt(fan-in)), "
        f"cuda vs cpu: {text}; broken: {broken or 'none'}")
    fault_text, caught = on_card(half_memory)
    log(f"[model] {tag} planted fault, "
        f"cross length half the memory: {fault_text}; broken: "
        f"{caught or 'none'}")
    if broken or not caught:
        raise AssertionError(f"model check {SEAMLESS_ARCH}: rules broken "
                             f"{broken}, planted fault caught {caught}")


def encdec_train_flops(cfg, batch: int, tokens: int, frames: int) -> float:
    """Model FLOPs of one encoder-decoder train step over ``batch``
    sequences of ``tokens`` tokens and ``frames`` frames: three times a
    forward (the backward's two products a weight and a score product),
    the forward counted as ``encdec_prefill_flops`` counts a prefill but
    with the head over every token. Remat's recomputed forward is not
    counted."""
    head = 2 * cfg.d_model * cfg.vocab * batch * (tokens - 1)
    return 3 * (encdec_prefill_flops(cfg, batch, tokens, frames) + head)


def encdec_train_counted(torch, counters: dict) -> int:
    """seamless-m4t-large-v2 at full width and full depth trained on the
    card at batch 8 x 512 tokens over ``FRAMES_LEN`` frames, remat on,
    through the port's own way for the family (``train_loop`` refuses it,
    as the reference's does): ``setup_training``'s ``step_fn``
    (``build_train_step``) on ``batch_at(setup, i)``, the batches drawn
    before the timed steps. A cold call of 2 steps, then a counted call of
    4, its kernels' launch counts set to 0 just before and read just
    after. Held: each of the 72 attention calls a step (24 encoder, 24
    decoder self, 24 cross) launches the flash forward twice (remat
    recomputes it) and the backward once, no other kernel; finite losses;
    the peak under the card's memory. Printed: ms a step, decoder tokens/s,
    the share of 989 TFLOP/s of ``encdec_train_flops`` (and with the
    recomputed forward), the peak beside the derived training state.
    Returns the backward's launches."""
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.train import _state_bytes
    from repro_torch.models import param_count
    kw = dict(batch=8, seq=512, seed=0, device="cuda")

    def run(steps: int, counted: bool):
        setup = train_mod.setup_training(SEAMLESS_ARCH, steps=steps, **kw)
        batches = [train_mod.batch_at(setup, i) for i in range(steps)]
        state, losses = setup.state, []
        torch.cuda.synchronize()
        if counted:
            torch.cuda.reset_peak_memory_stats()
            for k in counters.values():
                k.launches = 0
        t0 = time.perf_counter()
        for b in batches:
            state, metrics = setup.step_fn(state, b)
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: k.launches for name, k in counters.items()}
        return setup, wall / steps, losses, counts

    t_phase = time.perf_counter()
    setup, ms, losses, _ = run(2, False)
    log(f"[train] {SEAMLESS_ARCH} first call (cold), 2 steps: "
        f"{ms * 1e3:.1f} ms/step, losses {losses}")
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    steps = 4
    setup, ms, losses, counts = run(steps, True)
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    cfg = setup.model.cfg
    B, S = kw["batch"], kw["seq"]
    flops = encdec_train_flops(cfg, B, S, setup.frames_len)
    recompute = encdec_prefill_flops(cfg, B, S, setup.frames_len)
    state_bytes = _state_bytes(setup.model, setup.opt_cfg)
    n_params = param_count(setup.model.param_decls())
    log(f"[train] {SEAMLESS_ARCH} batch={B} x {S} tokens over "
        f"{setup.frames_len} frames ({n_params / 1e9:.3f} B params, "
        f"{cfg.n_encoder_layers} + {cfg.n_layers} layers, remat) {steps} "
        f"steps: {ms * 1e3:.1f} ms/step, {B * S / ms:.0f} decoder "
        f"tokens/s; losses {losses}; launches {counts}; peak memory "
        f"{peak / 2**30:.2f} GiB of the card's {card / 2**30:.2f} "
        f"(training state {state_bytes / 1e9:.1f} GB, derived); derived: "
        f"model FLOPs a step {flops / 1e12:.2f} T / step s / 989 TFLOP/s "
        f"= {flops / ms / PEAK_BF16_FLOPS:.3f}, with remat's recomputed "
        f"forward ({recompute / 1e12:.2f} T more) "
        f"{(flops + recompute) / ms / PEAK_BF16_FLOPS:.3f}; both calls in "
        f"{time.perf_counter() - t_phase:.1f} s")
    calls = cfg.n_encoder_layers + 2 * cfg.n_layers
    want = dict.fromkeys(counters, 0)
    want.update(flash_attention=steps * 2 * calls,
                flash_attention_bwd=steps * calls)
    if counts != want:
        raise AssertionError(f"{SEAMLESS_ARCH} training launches {counts}: "
                             f"want {want} ({calls} attention calls a step, "
                             f"the forward recomputed under remat)")
    if len(losses) != steps or not all(
            l == l and abs(l) < float("inf") for l in losses):
        raise AssertionError(f"{SEAMLESS_ARCH} training losses {losses}")
    if not peak < card:
        raise AssertionError(f"{SEAMLESS_ARCH} training peak {peak} bytes "
                             f"over the card's {card}")
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    return counts["flash_attention_bwd"]


def encdec_train_check(torch) -> None:
    """seamless-m4t-large-v2 at full width cut to ``ENCDEC_CHECK_LAYERS``
    encoder and as many decoder layers, in bf16, the attention weights at
    std 1/sqrt(fan-in) (as ``encdec_model_check`` draws them): one train
    step's loss and every leaf's gradient on the card (the flash kernels,
    remat on: each layer's forward recomputed) against the CPU (the plain
    path, remat off), same weights and batch (2 x 256 tokens over 512
    frames, so the cross-attention keeps Sq != Skv). Held, as
    ``train_check`` holds a dense arch: the loss within 1e-2 relative; each
    leaf within ``TRAIN_GRAD_TOL`` of its norm; each of the 6 attention
    calls' dq, dk and dv as the backward kernel computed them inside the
    step against ``flash_attention_bwd_plain`` on the card on the same
    tensors, within ``BWD_TOL``; the flash forward launched twice a call,
    the backward once. Two planted faults must each break a rule: the
    cross-attention's backward run with ``causal=True``, and the memory
    detached before the decoder (the encoder's leaves then get no
    gradient)."""
    import importlib
    from attention_conditioning import fan_in_std
    from flash_bwd_tolerance import grad_err
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as flash_k
    from repro_torch.kernels.flash_attention import kernel_bwd as bwd_k
    from repro_torch.models import build_model, init_params
    from repro_torch.models.param import tree_map
    ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")
    encdec_mod = importlib.import_module("repro_torch.models.encdec")
    L, seq, frames_len = ENCDEC_CHECK_LAYERS, 256, 512
    cfg = dataclasses.replace(get_config(SEAMLESS_ARCH), n_layers=L,
                              n_encoder_layers=L, remat=False,
                              q_chunk=seq // 2, kv_chunk=seq // 2)
    model = build_model(cfg)
    on_card = build_model(dataclasses.replace(cfg, remat=True))
    params = init_params(model.param_decls(),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    params["encoder"]["attn"] = fan_in_std(params["encoder"]["attn"],
                                           cfg.d_model)
    for name in ("self_attn", "cross_attn"):
        params["decoder"][name] = fan_in_std(params["decoder"][name],
                                             cfg.d_model)
    params = tree_map(lambda a: a.cpu(), params)
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, seq + 1), generator=gen)
    frames = torch.randn(2, frames_len, cfg.d_model,
                         generator=gen).to(torch.bfloat16)
    calls = L + 2 * L

    t0 = time.perf_counter()
    ref_loss, ref_grads = _loss_and_grads(model, params, toks, "cpu",
                                          frames=frames)
    cpu_s = time.perf_counter() - t0

    def card_step(fault) -> tuple[str, list]:
        seen = []
        flash_k.launches = bwd_k.launches = 0
        with fault(), captured_attention(seen):
            loss, grads = _loss_and_grads(on_card, params, toks, "cuda",
                                          frames=frames)
        launches = (flash_k.launches, bwd_k.launches)
        rel = abs(loss - ref_loss) / abs(ref_loss)
        errs = {k: grad_err(grads[k], w) for k, w in ref_grads.items()}
        top = sorted(errs, key=lambda k: -errs[k])[:4]
        try:
            attn = attention_grad_errs(seen, calls)
            attn_ok = max(map(max, attn)) <= BWD_TOL["bfloat16"]
        except AssertionError as e:     # calls that got no gradient
            attn, attn_ok = str(e), False
        broken = [rule for rule, ok in (
            ("loss rel < 1e-2", rel < 1e-2),
            (f"each leaf within {TRAIN_GRAD_TOL:g} of its norm",
             max(errs.values()) <= TRAIN_GRAD_TOL),
            (f"each call's dq, dk, dv within {BWD_TOL['bfloat16']:g}",
             attn_ok),
            ("flash launches: 2 forward, 1 backward a call",
             launches == (2 * calls, calls))) if not ok]
        shown = attn if isinstance(attn, str) else [
            [f"{e:.2e}" for e in errs_of_call] for errs_of_call in attn]
        return (f"loss {loss:.6f} vs {ref_loss:.6f} (rel {rel:.2e}); worst "
                f"||diff||/||g|| "
                f"{', '.join(f'{k} {errs[k]:.2e}' for k in top)}; the "
                f"backward kernel in the step against the plain version, "
                f"per call (dq, dk, dv; encoder, then each decoder layer's "
                f"self and cross): {shown}; launches (forward, backward) "
                f"{launches}"), broken

    def cross_causal():
        def wrap(bwd):
            def faulty(q, k, v, o, do, lse, *, causal=True, n_split=None):
                if q.shape[1] != k.shape[1]:    # the cross-attention
                    causal = True
                return bwd(q, k, v, o, do, lse, causal=causal,
                           n_split=n_split)
            return faulty
        return patched(ops, "flash_attention_bwd_cuda", wrap)

    def memory_detached():
        def wrap(encode):
            def faulty(self, params, frames):
                return encode(self, params, frames).detach()
            return faulty
        return patched(encdec_mod.EncDecLM, "encode", wrap)

    tag = f"depth-{L}+{L} {SEAMLESS_ARCH}"
    text, broken = card_step(contextlib.nullcontext)
    log(f"[model] {tag} bf16 train step, 2 x {seq} tokens over "
        f"{frames_len} frames (attention weights at std 1/sqrt(fan-in); "
        f"the card under remat, the CPU step {cpu_s:.1f} s), cuda vs cpu: "
        f"{text}; broken: {broken or 'none'}")
    caught = {}
    for fault, plant in (("the cross-attention's backward run causal",
                          cross_causal),
                         ("the memory detached before the decoder",
                          memory_detached)):
        fault_text, caught[fault] = card_step(plant)
        log(f"[model] {tag} planted fault, {fault}: {fault_text}; broken: "
            f"{caught[fault] or 'none'}")
    if broken or not all(caught.values()):
        raise AssertionError(f"train check {SEAMLESS_ARCH}: rules broken "
                             f"{broken}, planted faults caught {caught}")


# ------------------------------------------------------------------- MoE
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 12
# kimi-k2: 36.5 B parameters (73.0 GB) at 2 of its 61 layers; D = 112
KIMI_ARCH, KIMI_LAYERS, KIMI_CHECK_DEPTH = "kimi-k2-1t-a32b", 2, 1


def moe_prefill_flops(cfg, batch: int, prompt: int) -> tuple[float, float]:
    """An MoE model's active parameters a token (attention, router,
    ``top_k / n_experts`` of the expert weights, head; in a hybrid also
    the Mamba and MLP sublayers' weights; the embedding is a lookup) and
    the FLOPs of a prefill of ``batch`` x ``prompt`` tokens with capacity
    padding: every token's projections (attention, Mamba, MLP) and router,
    the expert products over all E x C slots whether filled or not, the
    head on each prompt's last token. The attention's scores and the SSD
    scan are left out."""
    from repro_torch.models import build_model
    from repro_torch.models.moe import _capacity
    from repro_torch.models.param import tree_items
    expert = per_token = head = 0
    for path, d in tree_items(build_model(cfg).param_decls()):
        if path[-2:] in (("moe", "w_up"), ("moe", "w_gate"),
                         ("moe", "w_down")):
            expert += d.size
        elif path == ("head",):
            head += d.size
        elif path != ("embed",):
            per_token += d.size
    active = per_token + expert * cfg.top_k / cfg.n_experts + head
    tokens = batch * prompt
    C = _capacity(tokens, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    padded = 2 * tokens * per_token + 2 * C * expert + 2 * batch * head
    return active, padded


def moe_graph_check(torch, timer) -> None:
    """One full-width MoE layer of qwen3-moe-235b-a22b (128 experts of
    4096 x 1536, top-8; 4.8 GB of weights) at a decode step's shape (batch
    8, one token; C = 4) and a prefill's (batch 8 x 512 tokens; C = 320),
    in each dispatch mode, captured in a CUDA graph and replayed after its
    input changes on the device: equal to an eager call bit for bit. Also
    the replay's CUDA-event ms (the layer's device time, no host gaps) and
    the host ms of an eager call and of a replay (median of 20, each ended
    by a synchronize)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, moe, moe_decls
    from repro_torch.models.moe import _capacity
    cfg = get_config(MOE_ARCH)
    params = init_params(moe_decls(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def host_ms(fn) -> float:
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    with torch.inference_mode():
        for S in (1, 512):
            x = torch.randn(8, S, cfg.d_model, generator=gen,
                            device="cuda").bfloat16()
            C = _capacity(8 * S, cfg.top_k, cfg.n_experts,
                          cfg.capacity_factor)
            for mode in ("scatter", "gather"):
                mcfg = dataclasses.replace(cfg, moe_dispatch=mode)
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):                 # warm
                    moe(params, x, mcfg)
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    y, aux = moe(params, x, mcfg)
                for _ in range(2):
                    x.copy_(torch.randn(x.shape, generator=gen,
                                        device="cuda"))
                    graph.replay()
                    want, want_aux = moe(params, x, mcfg)
                    torch.cuda.synchronize()
                    if not (torch.equal(y, want)
                            and torch.equal(aux, want_aux)):
                        raise AssertionError(
                            f"MoE layer ({mode}, batch 8 x {S}) replayed "
                            f"from a CUDA graph differs from an eager call")
                device_ms = timer.ms(graph.replay, iters=20)
                eager_ms = host_ms(lambda: moe(params, x, mcfg))
                replay_ms = host_ms(graph.replay)
                log(f"[moe] {MOE_ARCH} MoE layer ({mode}), batch 8 x {S} "
                    f"tokens (C = {C}), in a CUDA graph replayed after its "
                    f"input changed on the device twice: equal to eager "
                    f"calls bit for bit; device ms a replay {device_ms:.4f}"
                    f"; host ms a call (median of 20): eager "
                    f"{eager_ms:.3f}, replay {replay_ms:.3f}")
                del graph, y, aux, want, want_aux
            del x
            torch.cuda.empty_cache()


# qwen2-vl-72b serves at 40 of its 80 layers (37.598 B parameters, 75.2 GB
# of bf16 weights; 145.4 GB at full depth) and trains at 1 (3.369 B
# parameters, 40.4 GB of state; at 2 layers, 51.0 GB of state and AdamW's
# fp32 temporaries of the 1.246 B-element embedding or head, 34.9 GB, pass
# the card); all derived
QWEN2VL_ARCH = "qwen2-vl-72b"
QWEN2VL_SERVE_LAYERS, QWEN2VL_TRAIN_LAYERS = 40, 1
QWEN2VL_CHECK_DEPTH, QWEN2VL_TRAIN_CHECK_DEPTH = 2, 1
QWEN2VL_GRID = (4, 4)        # the checks' image: 16 patches


def qwen2vl_positions(torch, seq: int, batch: int):
    """(3, batch, seq) int64 M-RoPE positions in Qwen2-VL's layout
    (arXiv:2409.12191 §2.1): the ``QWEN2VL_GRID`` of patches first, patch (r, c) at
    (t, h, w) = (0, r, c); then text from max(grid h, grid w), advancing in
    all three streams together (a decode token continues the text)."""
    gh, gw = QWEN2VL_GRID
    n = gh * gw
    text = max(gh, gw) + torch.arange(seq - n)
    cell = torch.arange(n)
    pos = torch.stack([torch.cat([torch.zeros(n, dtype=torch.long), text]),
                       torch.cat([cell // gw, text]),
                       torch.cat([cell % gw, text])])
    return pos[:, None].expand(3, batch, seq).contiguous()


@contextlib.contextmanager
def rope_1d_on_card(torch):
    """Planted fault: on the card, M-RoPE replaced by the 1-D RoPE over 0 ..
    S-1 of each call's S tokens, as if the 3-D positions were lost."""
    import repro_torch.models.attention as attn_mod
    from repro_torch.models.common import apply_rope, rope_table

    def wrap(mrope):
        def faulty(x, positions_3d, head_dim, sections=None, theta=1e6):
            if not x.is_cuda:
                return mrope(x, positions_3d, head_dim, sections, theta)
            p = torch.arange(x.shape[1], device=x.device)
            return apply_rope(x, *rope_table(p, head_dim, theta))
        return faulty
    with patched(attn_mod, "apply_mrope", wrap):
        yield


@contextlib.contextmanager
def outputs_of(owner, name: str, outs: list):
    """Context: each call of ``owner.name`` (a sublayer of
    ``models/lm.py``, a scan of ``models/ssm.py``) appends the first
    member of what it returns (the sublayer's output before the residual,
    the scan's y) to ``outs``, on the host in fp32, in the order of the
    calls."""
    def wrap(fn):
        def recording(*args, **kw):
            out = fn(*args, **kw)
            outs.append(out[0].detach().float().cpu())
            return out
        return recording
    with patched(owner, name, wrap):
        yield


def vlm_model_check(torch) -> None:
    """qwen2-vl-72b at full width cut to ``QWEN2VL_CHECK_DEPTH`` layers: the card (the
    kernels) against the CPU (the plain path), same weights with the
    attention at fan-in std (as ``model_check`` draws them), in two cases,
    each with Qwen2-VL's 3-D positions (``qwen2vl_positions``, a 4 x 4
    grid): ``forward`` over 64 tokens whose first 16 are vision embeddings,
    and ``prefill(64)`` + ``decode_step(1)``. Held in each case: the logits
    rel < 0.06 (every position of the forward's) with equal argmax (the
    forward's last position; the share of its positions whose argmax agree
    is printed), and layer 0's attention output (the forward's, the decode
    step's) rel < 0.06. A planted fault, the 1-D RoPE over 0 .. S-1 on the
    card (``rope_1d_on_card``), must break a rule in each case; its
    readings are printed. The host holds a copy of the weights (8.5 GB at
    depth 2), so its memory is printed."""
    import repro_torch.models.lm as lm_mod
    from attention_conditioning import fan_in_std
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.param import tree_map
    tag = f"depth-{QWEN2VL_CHECK_DEPTH} {QWEN2VL_ARCH}"
    log(f"[model] {tag}: {host_memory()} before")
    cfg = dataclasses.replace(get_config(QWEN2VL_ARCH),
                              n_layers=QWEN2VL_CHECK_DEPTH,
                              q_chunk=32, kv_chunk=32, max_cache_len=72)
    model = build_model(cfg)
    params_gpu = init_params(model.param_decls(),
                             torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
    params_gpu["layers"]["attn"] = fan_in_std(params_gpu["layers"]["attn"],
                                              cfg.d_model)
    params_cpu = tree_map(lambda a: a.cpu(), params_gpu)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen)
    n_vis = QWEN2VL_GRID[0] * QWEN2VL_GRID[1]
    vision = torch.randn(2, n_vis, cfg.d_model, generator=gen).bfloat16()
    pos = qwen2vl_positions(torch, 65, 2)

    def run(dev: str, params) -> dict:
        """case -> (logits, layer 0's attention output), on the host."""
        outs = []
        with torch.inference_mode(), \
                outputs_of(lm_mod, "attention", outs):
            full, _ = model.forward(
                params, toks[:, :64].to(dev), vision_embeds=vision.to(dev),
                mrope_positions=pos[..., :64].to(dev))
            cache = model.init_cache(2, cfg.max_cache_len, device=dev)
            _, cache = model.prefill(params, toks[:, :64].to(dev), cache,
                                     mrope_positions=pos[..., :64].to(dev))
            n_before = len(outs)
            logits, _ = model.decode_step(
                params, toks[:, 64:].to(dev), cache,
                mrope_positions=pos[..., 64:].to(dev))
        return {"forward": (full.float().cpu(), outs[0]),
                "decode": (logits[:, 0].float().cpu(), outs[n_before])}

    ref = run("cpu", params_cpu)

    def on_card(fault) -> tuple[str, list]:
        with fault():
            got = run("cuda", params_gpu)
        readings, broken = [], []
        for case, ((g, g_attn), (r, r_attn)) in zip(
                ("forward", "decode"), zip(got.values(), ref.values())):
            rel = float((g - r).abs().max() / r.abs().max())
            agree = g.argmax(-1) == r.argmax(-1)
            same = bool(agree[..., -1].all() if case == "forward"
                        else agree.all())
            attn = float((g_attn - r_attn).abs().max() / r_attn.abs().max())
            text = (f"{case}: rel={rel:.4f} argmax_equal={same} layer-0 "
                    f"attention rel={attn:.4f}")
            if case == "forward":
                text += (f" (argmax equal at {int(agree.sum())} of "
                         f"{agree.numel()} positions)")
            readings.append(text)
            broken += [f"{case}: {rule}" for rule, ok in (
                ("rel < 0.06 and equal argmax", rel < 0.06 and same),
                ("layer-0 attention rel < 0.06", attn < 0.06)) if not ok]
        return "; ".join(readings), broken

    text, broken = on_card(contextlib.nullcontext)
    log(f"[model] {tag} forward(64, 16 vision embeddings) and "
        f"prefill(64)+decode(1), 3-D positions on a {QWEN2VL_GRID} grid "
        f"(attention weights at std 1/sqrt(fan-in)), cuda vs cpu: {text}; "
        f"broken: {broken or 'none'}; {host_memory()} with the host's copy")
    text, caught = on_card(lambda: rope_1d_on_card(torch))
    missed = [case for case in ("forward", "decode")
              if not any(rule.startswith(case) for rule in caught)]
    log(f"[model] {tag} planted fault, the 1-D RoPE over 0..S-1 on the "
        f"card: {text}; broken: {caught or 'none'}")
    if broken or missed:
        raise AssertionError(f"model check {QWEN2VL_ARCH}: rules broken "
                             f"{broken}, planted fault passed in {missed}")


# ---------------------------------------------------------------- hybrid
# jamba-1.5-large-398b: one period-8 super-block at full width holds 45.14 B
# parameters (90.3 GB, derived), more than the card; one block of period 4
# (attention at 3, MoE at 1 and 3, 3 Mamba sublayers, every sublayer at its
# published width) holds 22.98 B (45.96 GB): a different model from
# jamba's 1:7 interleave, the one the card serves here
JAMBA_ARCH, JAMBA_PERIOD = "jamba-1.5-large-398b", 4


def one_block(cfg):
    """A hybrid config cut to one whole super-block of ``JAMBA_PERIOD``
    sublayers at full width; refuses a config of another family, or one
    whose attention sublayer the cut leaves out."""
    cfg = dataclasses.replace(cfg, hybrid_period=JAMBA_PERIOD,
                              n_layers=JAMBA_PERIOD)
    if cfg.family != "hybrid" or cfg.hybrid_attn_index >= JAMBA_PERIOD:
        raise AssertionError(f"{cfg.name}: no period-{JAMBA_PERIOD} hybrid "
                             f"block (family {cfg.family}, attention at "
                             f"{cfg.hybrid_attn_index})")
    return cfg


def cut_hybrid(launch_mod):
    """Context beside ``cut_depth``: the launch module's configs cut to one
    super-block of ``JAMBA_PERIOD`` sublayers (``one_block``)."""
    return cut_configs(launch_mod, one_block)


# jamba's decode step by phase: each sublayer kind, wrapped where the
# hybrid block calls it (``models/lm.py``'s own names)
HYBRID_PHASES = {
    "Mamba (projections, conv, recurrence, gated norm, out projection)":
        ("repro_torch.models.lm", "mamba_block"),
    "attention (projections, RoPE, decode kernel)":
        ("repro_torch.models.lm", "attention"),
    "MoE (routing, dispatch, expert products, combine)":
        ("repro_torch.models.lm", "moe"),
    "MLP": ("repro_torch.models.lm", "mlp"),
}


def hybrid_serve_check(torch, counters: dict) -> dict:
    """jamba-1.5-large-398b cut to one period-4 block through
    ``serve_counted`` (batch 8, 512-token prompts, 32 new tokens): the
    flash kernel once (the block's attention, at the prefill), the decode
    kernel once a decode step (31), the ssd kernel once a Mamba sublayer
    at the prefill (3), no other kernel. Returns the launch counts."""
    from repro_torch.launch import serve as serve_mod
    t0 = time.perf_counter()
    with cut_hybrid(serve_mod):
        counts = serve_counted(torch, counters, JAMBA_ARCH, JAMBA_PERIOD,
                               65536)
    want = dict.fromkeys(counters, 0)
    want.update(flash_attention=1, decode_attention=31,
                ssd=JAMBA_PERIOD - 1)
    if counts != want:
        raise AssertionError(f"{JAMBA_ARCH} launches {counts}: want {want}")
    log(f"[serve] {JAMBA_ARCH} serving phase in "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


def hybrid_faults(torch) -> dict:
    """Faults of the hybrid's own, planted on the card's path only, each a
    context factory that the model check reads: the attention at sublayer
    2 in place of 3 (``hybrid_attn_index``); each decode step's Mamba
    sublayers run from a zeroed SSM state, so that the state prefill left
    is not carried; the ssd kernel's y zeroed in its last chunk at the
    prefill; the first Mamba sublayer's output dropped at each decode
    step."""
    import copy
    import importlib
    lm_mod = importlib.import_module("repro_torch.models.lm")
    ssm_mod = importlib.import_module("repro_torch.models.ssm")

    def attention_moved(block):
        def faulty(self, bp, x, **kw):
            if x.is_cuda:
                self = copy.copy(self)
                self.cfg = dataclasses.replace(self.cfg, hybrid_attn_index=2)
            return block(self, bp, x, **kw)
        return faulty

    def state_zeroed(mamba_block):
        def faulty(params, u, cfg, *, cache=None):
            if u.is_cuda and cache is not None and u.shape[1] == 1:
                cache.state.zero_()
            return mamba_block(params, u, cfg, cache=cache)
        return faulty

    def last_chunk_zeroed(ssd):
        def faulty(x, *args, chunk, **kw):
            y, state = ssd(x, *args, chunk=chunk, **kw)
            if x.is_cuda:
                y[:, (y.shape[1] - 1) // chunk * chunk:] = 0
            return y, state
        return faulty

    def first_output_dropped(mamba_block):
        decode_calls = [0]

        def faulty(params, u, cfg, *, cache=None):
            out, cache = mamba_block(params, u, cfg, cache=cache)
            if u.is_cuda and u.shape[1] == 1:
                decode_calls[0] += 1
                if decode_calls[0] % (JAMBA_PERIOD - 1) == 1:
                    out = torch.zeros_like(out)
            return out, cache
        return faulty
    return {
        "attention at sublayer 2 in place of 3":
            lambda: patched(lm_mod.LM, "_hybrid_block", attention_moved),
        "decode from a zeroed SSM state":
            lambda: patched(lm_mod, "mamba_block", state_zeroed),
        "ssd's y zeroed in its last chunk at the prefill":
            lambda: patched(ssm_mod, "ssd", last_chunk_zeroed),
        "Mamba sublayer 0's output dropped at the decode step":
            lambda: patched(lm_mod, "mamba_block", first_output_dropped),
    }


def serve_counted(torch, counters: dict, arch: str, layers: int,
                  vocab: int) -> dict:
    """``serve_loop(arch)`` at batch 8, 512-token prompts, 32 new tokens:
    a first (cold) call, then a counted one, its kernels' launch counts set
    to 0 just before and returned; its tokens in range and its last logits
    finite. The depth is what ``launch/serve.py``'s ``get_config`` gives
    (``cut_depth`` cuts it)."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import build_model, param_count
    serve_loop = serve_mod.serve_loop
    serve = dict(batch=8, prompt_len=512, gen_tokens=32, seed=0,
                 device="cuda")
    out = serve_loop(arch, **serve)
    log(f"[serve] {arch} first call (cold): prefill "
        f"{out['prefill_s']:.4f} s, decode {out['decode_s']:.4f} s, "
        f"{out['decode_tok_per_s']:.1f} tok/s")
    torch.cuda.empty_cache()
    for k in counters.values():
        k.launches = 0
    out = serve_loop(arch, **serve)
    counts = {name: k.launches for name, k in counters.items()}
    tokens, logits = out["tokens"], out["logits"]
    cfg = serve_mod.get_config(arch)          # the depth it served
    n_params = param_count(build_model(cfg).param_decls())
    prefill_s = out["prefill_s"]
    rate = prefill_s * PEAK_BF16_FLOPS
    if cfg.family == "encdec":
        flops = encdec_prefill_flops(cfg, batch=8, prompt=512,
                                     frames=serve_mod.FRAMES_LEN)
        derived = (f"derived: prefill FLOPs (every weight over the tokens "
                   f"it sees: the encoder and the cross wk/wv over "
                   f"{serve_mod.FRAMES_LEN} frames a prompt, the rest of "
                   f"the decoder over the prompt, the head on its last "
                   f"token; and the attention) {flops / 1e12:.2f} T / "
                   f"prefill s / 989 TFLOP/s = {flops / rate:.3f}")
    elif cfg.family in ("moe", "hybrid"):
        active, padded = moe_prefill_flops(cfg, batch=8, prompt=512)
        dense = "attention, Mamba and MLP sublayers, router" \
            if cfg.family == "hybrid" else "attention, router"
        derived = (
            f"derived: 2 * N_active * prompt tokens / prefill s / 989 "
            f"TFLOP/s = {2 * active * 8 * 512 / rate:.3f}"
            f" (N_active {active / 1e9:.3f} B: {dense}, "
            f"top_k / n_experts of the expert weights, head); "
            f"capacity-padded prefill FLOPs (projections of every "
            f"token, the expert products over all E x C slots, the head "
            f"on each prompt's last token) {padded / 1e12:.2f} T / "
            f"prefill s / 989 TFLOP/s = {padded / rate:.3f}")
    else:
        derived = (f"derived: 2 * N * prompt tokens / prefill s / 989 "
                   f"TFLOP/s = {2 * n_params * 8 * 512 / rate:.3f}")
    log(f"[serve] {arch} batch=8 prompt=512 gen=32 ({layers} layers, "
        f"{n_params / 1e9:.3f} B params): prefill "
        f"{prefill_s:.4f} s, decode {out['decode_s']:.4f} s, "
        f"{out['decode_tok_per_s']:.1f} tok/s; launches {counts}; peak "
        f"memory from the prefill on {out['peak_bytes'] / 2**30:.2f} "
        f"GiB; {derived}")
    if tokens.shape != (8, 32) or tokens.min() < 0 \
            or tokens.max() >= vocab:
        raise AssertionError(f"{arch}: tokens {tokens.shape} out of "
                             f"[0, {vocab})")
    if logits.shape != (8, vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: last logits {tuple(logits.shape)}"
                             f" not finite or not (8, {vocab})")
    torch.cuda.empty_cache()
    return counts


def cut_serve_check(torch, counters: dict, arch: str = MOE_ARCH,
                    layers: int = MOE_LAYERS, vocab: int = 151936) -> dict:
    """An arch at full width cut to ``layers`` layers through
    ``serve_counted``: qwen3-moe-235b-a22b at 12 of its 94 layers (62 GB of
    weights; its full depth, 470 GB, raises in ``serve_loop``), G = 16 at
    D = 128 in both attention kernels; kimi-k2-1t-a32b at 2 of its 61 (73
    GB; 2.09 TB at full depth), G = 8 at D = 112; qwen2-vl-72b at 40 of its
    80 (75.2 GB; 145.4 GB at full depth), G = 8 at D = 128, on tokens alone
    as the reference's serve loop runs it. The MoE layers run in plain
    torch; exactly one flash launch a layer and one decode launch a layer
    a decode step, no other kernel. Returns the launch counts."""
    from repro_torch.launch import serve as serve_mod
    with cut_depth(serve_mod, layers):
        counts = serve_counted(torch, counters, arch, layers, vocab)
    want = dict.fromkeys(counters, 0)
    want.update(flash_attention=layers, decode_attention=layers * 31)
    if counts != want:
        raise AssertionError(f"{arch} launches {counts}: want {want}")
    return counts


# fp32 temporaries of one leaf that ``optim/adamw.py::adamw_update`` holds
# at once, at its last line: g32, m32, v32, upd, p.float(), lr * upd and
# their difference
ADAMW_TEMPORARIES = 7
# the held peak's margin over the optimizer's derived peak
PEAK_MARGIN = 1.05


def optimizer_peak(model) -> int:
    """Derived bytes at AdamW's peak: the training state
    (``launch/train.py::_state_bytes``) plus ``ADAMW_TEMPORARIES`` fp32
    copies of the largest leaf."""
    from repro_torch.launch.train import _state_bytes
    from repro_torch.models.param import tree_items
    from repro_torch.optim import AdamWConfig
    largest = max(d.size for _, d in tree_items(model.param_decls()))
    return _state_bytes(model, AdamWConfig()) + ADAMW_TEMPORARIES * 4 * largest


def train_counted(torch, counters: dict, arch: str, layers: int,
                  kernels: tuple, optimizer_bound: bool = False) -> dict:
    """``train_loop(arch)`` at batch 8 x 512 tokens, remat on: a first
    (cold) call of 2 steps, then a counted one of 4, its kernels' launch
    counts set to 0 just before and returned; the depth is what
    ``launch/train.py``'s ``get_config`` gives (``cut_depth`` cuts it).
    Held: the forward kernel twice a layer a step (remat recomputes it),
    the backward once, no other kernel; finite losses; with
    ``optimizer_bound`` (an arch whose peak the optimizer sets, not the
    activations), the peak within ``PEAK_MARGIN`` of ``optimizer_peak``.
    The peak and the derived peak are printed for every arch."""
    from repro_torch.launch.train import _state_bytes, train_loop
    from repro_torch.models import param_count
    from repro_torch.optim import AdamWConfig
    t_arch = time.perf_counter()
    train = dict(batch=8, seq=512, seed=0, log_every=0, device="cuda")
    out = train_loop(arch, steps=2, **train)
    log(f"[train] {arch} first call (cold), 2 steps: "
        f"{out['wall_s'] / 2 * 1e3:.1f} ms/step, losses {out['losses']}")
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    steps = 4
    out = train_loop(arch, steps=steps, **train)
    counts = {name: k.launches for name, k in counters.items()}
    model = _train_model(arch)
    n_params = param_count(model.param_decls())
    rate = out["tokens_per_s"] / PEAK_BF16_FLOPS
    if model.cfg.family == "moe":
        active = moe_prefill_flops(model.cfg, batch=8, prompt=512)[0]
        derived = (f"6 * N_active * tokens/s / 989 TFLOP/s = "
                   f"{6 * active * rate:.3f} (N_active {active / 1e9:.3f} "
                   f"B: attention, router, top_k / n_experts of the "
                   f"experts, head)")
    else:
        derived = f"6 * N * tokens/s / 989 TFLOP/s = {6 * n_params * rate:.3f}"
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"[train] {arch} batch=8 seq=512 ({n_params / 1e9:.3f} B "
        f"params, {layers} layers, remat) {steps} steps: "
        f"{out['wall_s'] / steps * 1e3:.1f} ms/step, "
        f"{out['tokens_per_s']:.0f} tokens/s; losses {out['losses']}; "
        f"launches {counts}; peak memory {peak / 2**30:.2f} GiB of the "
        f"card's {card / 2**30:.2f} (training state "
        f"{_state_bytes(model, AdamWConfig()) / 1e9:.1f} GB, AdamW's peak "
        f"{optimizer_peak(model) / 2**30:.2f} GiB, derived); "
        f"derived: {derived}; both calls in "
        f"{time.perf_counter() - t_arch:.1f} s")
    if optimizer_bound and peak > PEAK_MARGIN * optimizer_peak(model):
        raise AssertionError(f"{arch}: peak {peak} bytes over "
                             f"{PEAK_MARGIN} x the optimizer's derived "
                             f"{optimizer_peak(model)}")
    # the forward kernel twice a layer a step (remat recomputes it), its
    # backward once
    fwd, bwd = kernels
    want = dict.fromkeys(counters, 0)
    want.update({fwd: steps * 2 * layers, bwd: steps * layers})
    if counts != want:
        raise AssertionError(f"{arch} training launches {counts}: want "
                             f"{want} ({2 * layers} forward a step: "
                             f"{layers} and {layers} recomputed under "
                             f"remat; {layers} backward)")
    if len(out["losses"]) != steps or not all(
            l == l and abs(l) < float("inf") for l in out["losses"]):
        raise AssertionError(f"{arch} training losses {out['losses']}")
    return counts


def kernel_counters() -> dict:
    """Each kernel's launcher module, whose ``launches`` counts its
    launches."""
    from repro_torch.kernels.decode_attention import kernel as decode_k
    from repro_torch.kernels.flash_attention import kernel as flash_k
    from repro_torch.kernels.flash_attention import kernel_bwd as flash_bwd_k
    from repro_torch.kernels.ssd import kernel as ssd_k
    from repro_torch.kernels.ssd import kernel_bwd as ssd_bwd_k
    return {"flash_attention": flash_k, "flash_attention_bwd": flash_bwd_k,
            "decode_attention": decode_k, "ssd": ssd_k, "ssd_bwd": ssd_bwd_k}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod

    t_start = time.perf_counter()
    log(f"[card] {card_line()}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    report = _build.build()
    log(f"[build] {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[kernels] TF32 off for fp32 matmuls and convolutions")
    timer = Timer(torch)
    one = torch.zeros(1, device="cuda")
    log(f"[kernels] timer floor: one 1-element add under the same method "
        f"takes {timer.ms(lambda: one.add_(0)):.4f} ms")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = check_flash(torch, timer, gen)
    decode = check_decode(torch, timer, gen)
    ssd = check_ssd(torch, timer, gen)
    flash_bwd = check_flash_bwd(torch, timer, gen)
    ssd_bwd = check_ssd_bwd(torch, timer, gen)

    counters = kernel_counters()

    dense = serve_counted(torch, counters, "tinyllama-1.1b", 22, 32000)
    if dense["flash_attention"] != 22 or dense["decode_attention"] != 22 * 31:
        raise AssertionError(f"tinyllama launches {dense}: want flash 22, "
                             f"decode {22 * 31}")
    ssm = serve_counted(torch, counters, "mamba2-370m", 48, 50280)
    if ssm["ssd"] != 48:
        raise AssertionError(f"mamba2 launches {ssm}: want ssd 48")
    n_flash, n_decode, n_ssd = (dense["flash_attention"],
                                dense["decode_attention"], ssm["ssd"])
    # the 15 B archs, full width and depth, one on the card at a time (~30
    # GB of weights each): the flash kernel once a layer at the prefill,
    # the decode kernel once a layer in each of the 31 decode steps
    for arch, layers, vocab in (("starcoder2-15b", 40, 49152),
                                ("nemotron-4-15b", 32, 256000),
                                ("qwen3-14b", 40, 151936)):
        counts = serve_counted(torch, counters, arch, layers, vocab)
        want = dict.fromkeys(counters, 0)
        want.update(flash_attention=layers, decode_attention=layers * 31)
        if counts != want:
            raise AssertionError(f"{arch} launches {counts}: want {want}")
    cut_serve_check(torch, counters)
    cut_serve_check(torch, counters, KIMI_ARCH, KIMI_LAYERS, 163840)
    qwen2vl = cut_serve_check(torch, counters, QWEN2VL_ARCH,
                              QWEN2VL_SERVE_LAYERS, 152064)
    torch.cuda.empty_cache()
    # jamba cut to one period-4 super-block (45.96 GB): flash 1, decode 31,
    # ssd 3
    jamba = hybrid_serve_check(torch, counters)
    torch.cuda.empty_cache()
    seamless = encdec_serve_check(torch, counters)

    n_flash_bwd = train_counted(torch, counters, "tinyllama-1.1b", 22, (
        "flash_attention", "flash_attention_bwd"))["flash_attention_bwd"]
    n_ssd_bwd = train_counted(torch, counters, "mamba2-370m", 48,
                              ("ssd", "ssd_bwd"))["ssd_bwd"]
    # qwen3-moe at full width cut to 1 of its 94 layers (44.8 GB of
    # training state, derived): flash at G = 16, D = 128
    torch.cuda.empty_cache()
    with cut_depth(train_mod, MOE_TRAIN_LAYERS):
        n_moe_bwd = train_counted(
            torch, counters, MOE_ARCH, MOE_TRAIN_LAYERS,
            ("flash_attention", "flash_attention_bwd"),
            optimizer_bound=True)["flash_attention_bwd"]
    torch.cuda.empty_cache()
    # qwen2-vl at full width cut to 1 of its 80 layers (40.4 GB of training
    # state, derived): flash at G = 8, D = 128; AdamW's peak near the card's
    with cut_depth(train_mod, QWEN2VL_TRAIN_LAYERS):
        qwen2vl_train = train_counted(
            torch, counters, QWEN2VL_ARCH, QWEN2VL_TRAIN_LAYERS,
            ("flash_attention", "flash_attention_bwd"), optimizer_bound=True)
    torch.cuda.empty_cache()
    # seamless-m4t at full width and depth (19.6 GB of training state)
    n_seamless_bwd = encdec_train_counted(torch, counters)

    # the split kernels are split_bf16_kernel and split_f32_kernel
    decode_kernels = {"decode_attention": ("split_bf16_kernel",
                                           "split_f32_kernel",
                                           "combine_kernel")}
    profile_decode(torch, "tinyllama-1.1b", ours=decode_kernels)
    profile_decode(torch, "mamba2-370m")
    profile_decode(torch, "starcoder2-15b", ours=decode_kernels)
    torch.cuda.empty_cache()          # its ~30 GB of weights, released
    for arch, layers in ((MOE_ARCH, MOE_LAYERS), (KIMI_ARCH, KIMI_LAYERS)):
        with cut_depth(serve_mod, layers):
            profile_decode(torch, arch, ours=decode_kernels,
                           phases=MOE_PHASES)
        torch.cuda.empty_cache()      # its 62 or 73 GB of weights, released
    with cut_depth(serve_mod, QWEN2VL_SERVE_LAYERS):
        profile_decode(torch, QWEN2VL_ARCH, ours=decode_kernels)
    torch.cuda.empty_cache()          # its 75.2 GB of weights, released
    t0 = time.perf_counter()
    with cut_hybrid(serve_mod):
        profile_decode(torch, JAMBA_ARCH, ours=decode_kernels,
                       phases=HYBRID_PHASES)
    torch.cuda.empty_cache()          # its 45.96 GB of weights, released
    log(f"[profile] {JAMBA_ARCH} decode profiled in "
        f"{time.perf_counter() - t0:.1f} s")
    profile_decode(torch, SEAMLESS_ARCH, ours={
        "decode fp32 (self cache)": ("split_f32_kernel",),
        "decode bf16 (memory)": ("split_bf16_kernel",),
        "decode merge (both)": ("combine_kernel",)})
    profile_prefill(torch, SEAMLESS_ARCH, ours={"flash": FLASH_FWD,
                                                "GEMMs": GEMMS})
    torch.cuda.empty_cache()
    profile_prefill(torch, "mamba2-370m", ours={"ssd": ("ssd",)})
    profile_train(torch, "tinyllama-1.1b", {"flash forward": FLASH_FWD,
                                            "flash backward": FLASH_BWD})
    profile_train(torch, "mamba2-370m", {"ssd forward": SSD_FWD,
                                         "ssd backward": SSD_BWD})
    t0 = time.perf_counter()
    with cut_depth(train_mod, MOE_TRAIN_LAYERS):
        profile_train(torch, MOE_ARCH, {"flash forward": FLASH_FWD,
                                        "flash backward": FLASH_BWD})
    torch.cuda.empty_cache()
    log(f"[profile] {MOE_ARCH} train step profiled in "
        f"{time.perf_counter() - t0:.1f} s")
    with cut_depth(train_mod, QWEN2VL_TRAIN_LAYERS):
        profile_train(torch, QWEN2VL_ARCH, {"flash forward": FLASH_FWD,
                                            "flash backward": FLASH_BWD})
    torch.cuda.empty_cache()
    profile_train(torch, SEAMLESS_ARCH, {"flash forward": FLASH_FWD,
                                         "flash backward": FLASH_BWD})
    gc.collect()
    torch.cuda.empty_cache()
    # jamba first, where the host has the most room for its 42.8 GiB copy
    t0 = time.perf_counter()
    model_check(torch, JAMBA_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[model] {JAMBA_ARCH} model check in "
        f"{time.perf_counter() - t0:.1f} s; {host_memory()} after")
    for arch in ("tinyllama-1.1b", "mamba2-370m", "starcoder2-15b",
                 "nemotron-4-15b", "qwen3-14b", MOE_ARCH):
        model_check(torch, arch)
        torch.cuda.empty_cache()      # the model's card memory, released
    model_check(torch, KIMI_ARCH, depth=KIMI_CHECK_DEPTH,
                own_routing=False)
    gc.collect()
    torch.cuda.empty_cache()
    vlm_model_check(torch)
    gc.collect()
    torch.cuda.empty_cache()
    encdec_model_check(torch)
    encdec_train_check(torch)
    gc.collect()
    torch.cuda.empty_cache()
    moe_graph_check(torch, timer)
    torch.cuda.empty_cache()
    # tinyllama and qwen3-14b at depth 2 (chained layers at G = 8 and
    # G = 6), starcoder2 and nemotron at depth 1 (``TRAIN_CHECK_15B_DEPTH``)
    train_check(torch, "tinyllama-1.1b")
    for arch, depth in TRAIN_CHECK_15B_DEPTH.items():
        train_check(torch, arch, depth=depth)
        torch.cuda.empty_cache()
    train_check(torch, QWEN2VL_ARCH, depth=QWEN2VL_TRAIN_CHECK_DEPTH)
    gc.collect()
    torch.cuda.empty_cache()
    train_check_ssm(torch)
    moe_train_check(torch)
    torch.cuda.empty_cache()
    remat_policy_steps(torch, counters)
    torch.cuda.empty_cache()
    resume_check(torch, "tinyllama-1.1b")
    resume_check(torch, "mamba2-370m", exact=True)
    orchestrate_check(torch, counters)

    # the backward's G = 16 row: launched on the qwen3-moe training path
    flash_bwd["g16"]["launches"] = n_moe_bwd
    # qwen2-vl's rows (G = 8, D = 128), each with the launches of its
    # counted serve_loop (flash: 40, one a layer; decode: 40 x 31) or of
    # its counted training run (the backward 4, the forward 8)
    flash["qwen2vl"] = {"launches": qwen2vl["flash_attention"],
                        "train_launches": qwen2vl_train["flash_attention"],
                        **flash.pop("qwen2vl")}
    decode["qwen2vl"] = {"launches": qwen2vl["decode_attention"],
                         **decode.pop("qwen2vl")}
    flash_bwd["qwen2vl"] = {"launches": qwen2vl_train["flash_attention_bwd"],
                            **flash_bwd.pop("qwen2vl")}
    # jamba's launches of its counted serve_loop: its attention is
    # qwen2-vl's shape (G = 8, D = 128; that row's times), its ssd row
    # H = 256
    for rec, name in ((flash, "flash_attention"),
                      (decode, "decode_attention")):
        rec["jamba"] = {"launches": jamba[name], "timed_row": "qwen2vl"}
    ssd["jamba"] = {"launches": jamba["ssd"], **ssd["jamba"]}
    # seamless-m4t's rows, under one entry with the launches of its counted
    # serve_loop (flash: encoder, decoder prefill and cross, 24 each;
    # decode: the fp32 self and bf16 memory steps, 24 each a step) or, for
    # the backward, of its counted training run (72 a step)
    for rec, launches in ((flash, seamless["flash_attention"]),
                          (decode, seamless["decode_attention"]),
                          (flash_bwd, n_seamless_bwd)):
        rec["seamless"] = {"launches": launches, **{
            key.removeprefix("seamless_"): rec.pop(key)
            for key in list(rec) if key.startswith("seamless_")}}
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:93",
             launches=n_flash, **flash),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:73",
             launches=n_decode, **decode),
        dict(name="ssd", route="cuda", source="src/repro_torch/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd/kernel.py:75",
             launches=n_ssd, **ssd),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="none: the gradient of "
                      "src/repro/kernels/flash_attention/kernel.py:93, "
                      "taken by autodiff (XLA) in the JAX package",
             launches=n_flash_bwd, **flash_bwd),
        dict(name="ssd_bwd", route="cuda",
             source="src/repro_torch/csrc/ssd_bwd.cu",
             replaces="none: the gradient of "
                      "src/repro/kernels/ssd/kernel.py:75, taken by autodiff "
                      "(XLA) of repro/models/ssm.py::ssd_chunked in the JAX "
                      "package",
             launches=n_ssd_bwd, **ssd_bwd),
    ]
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
