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
   N = 128, state0 and state_out a slice of a zeroed stacked cache, timed;
   mamba2's prefill on one rank of a (1, 2) mesh, 16 of its 32 heads,
   and jamba's, 128 of its 256, each timed; a rank's heads of the sharded
   training at a model axis of 2, timed: flash and its backward at
   tinyllama's 16 over 2 KV heads, qwen2-vl's 32 over 4 and qwen3-moe's 32
   over 2, the ssd forward with its chunk states and the ssd backward at
   mamba2's 16 heads and at jamba's full width's 128 (the backward's two
   calls bit-equal and its four planted faults failing there too); a
   seamless rank's decode step
   over its 8 heads of the memory, a strided view of the cache's 16,
   timed), and the decode kernel's partial entry (one span of a
   sequence-cut cache: out and lse, at local lengths 0, 1, a mid value
   and the whole span, D = 64, 112, 128 and G = 1, 8, 12, 16, bf16 and
   fp32; timed at each sharded run's span, seamless's over its fp32 self
   cache with q cast from bf16), to bf16
   2e-2
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
   run went through them; then ``sharded_serve_check``: every family
   over a (data, model) mesh through ``runtime/serve_lib.py``'s steps, at
   the same serving shape with the K/V cache's 1056 rows cut on their
   sequence axis (at a model axis of 2 the decode crosses from rank 0's
   span into rank 1's), one spawn a mesh (``SHARD_GROUPS``), each rank a
   process on the one card serving its archs one after another, joined
   with a timeout: tinyllama-1.1b cut to 8 layers at (1, 1) under NCCL
   and at (1, 2) under gloo; under gloo at (1, 2) starcoder2-15b cut to 4
   layers, qwen2-vl-72b to 2 (its tokens path), qwen3-moe-235b-a22b to 1
   (also at (2, 2), each data shard against the unsharded run on its rows
   alone), kimi-k2-1t-a32b to 1, mamba2-370m to 6, seamless-m4t-large-v2
   to 6 + 6 over 1024 seeded frames (``SHARD_LAYERS``) and
   jamba-1.5-large-398b's period-4 super-block; every rank's prefill and 31
   teacher-forced decode steps against the unsharded ``serve_loop`` of the
   same cut model on the same seed (rel < 0.06, picks apart only at
   near-ties; its span of the first and last layers' K/V cache alike; the
   MoE routing at most 2% apart, each a near-tie, the logits and caches
   of an arch with MoE layers held fed the reference's routing, its own
   printed; the SSM state shards, conv tails and the first Mamba block's
   output alike, ``conv_x`` equal on the model ranks; seamless's fp32
   self-cache span and its memory K/V, every head on every rank, alike),
   its shard shapes against the specs, its launches
   (``shard_launches``: flash once an attention at the prefill, the
   decode kernel's partial entry once a cached self-attention a step, the
   whole-cache decode once a cross-attention a step, ssd once a Mamba
   block, nothing else) and all_reduce calls a decode step
   (``shard_collectives``) as predicted, and planted faults, each of
   which must break a rule on some rank: a merge that drops model rank
   0's partial, the new token's K/V written into every rank's span, a
   vocab shard one shard off (tinyllama at (1, 1), the first alone, and
   (1, 2)); every rank serving experts 0..E_loc-1, the experts' sum
   skipped (each multi-rank MoE run); a rank's dt_bias, A_log and D from
   heads 0..H_loc-1, the gated norm over a rank's own columns (mamba2);
   every Mamba sublayer of a block on SSM cache slice 0, and the experts
   0..E_loc-1 (jamba); the memory K/V gather skipped, the encoder's
   row-parallel ``wo`` sum skipped (seamless); and in the (1, 2) and
   (2, 2) spawns ``sharded_train_check``: tinyllama-1.1b cut to 8 layers
   and mamba2-370m to 6 trained over both meshes, qwen2-vl-72b (with 16
   vision embeddings a row and 3-D positions) and qwen3-moe-235b-a22b (fed
   the unsharded step's experts; its own routing printed, not held) at 1
   layer over (1, 2) (``build_train_step(..., mesh=)``, full width, batch
   8 x 512, remat "full", ZeRO-1 at (2, 2)) against the unsharded step on
   the card (loss and norm rel 1e-2, each gradient shard within 3e-2 of
   its slice's norm, each leaf's update by ``update_rule``, the sharded
   AdamW fed the reference's gradients within 1e-5), its all_reduce calls
   (``train_collectives``) and flash or ssd launches as derived, and
   planted faults, each breaking a rule on every rank: tinyllama's four
   (``TRAIN_FAULTS``: ``enter``'s sum skipped at the attention input, the
   norm over a rank's own shards (at (1, 2)), the data-axis sum skipped,
   ZeRO-1's gather skipped (at (2, 2))), qwen3-moe's gates and tokens
   each without their model-axis sum, mamba2's norm sum with an identity
   backward and ``w_B``/``w_C`` left out of the partial leaves (at (1,
   2); ``FAMILY_TRAIN_FAULTS_AT``); seamless-m4t-large-v2 at 6 + 6 layers
   over 1024 frames (its cross-attention uncached over the memory on each
   rank's heads) and jamba's reduced config cut to one period-4 block
   (fed the unsharded step's experts; one card cannot hold a full-width
   block's state) over (1, 2), by the same rules, with their planted
   faults (the cross-attention's ``wo`` sum skipped, the encoder's K/V
   heads rolled; the Mamba sublayers' norm over the rank's own columns);
   and the sharded checkpoint: mamba2's (1, 2) state after its checked
   step saved over the mesh (its seconds and bytes), the directory held
   file for file to ``save_state`` of the state assembled from the ranks'
   shards, restored by the (2, 2) ZeRO-1 ranks bit for bit to their
   slices, and again under ``CKPT_FAULT``, which must part a leaf;
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
   vision embeddings and 3-D positions), one sequence of 128 tokens
   (``TRAIN_CHECK_BATCH``, ``TRAIN_CHECK_SEQ``), on the card against the
   CPU (loss
   1e-2 relative,
   each gradient within 3e-2 of its norm, each layer's backward-kernel
   gradients against the plain backward on the same captured tensors
   within 1e-2 of their norm); the same step of a depth-2 mamba2 (each
   gradient within 3e-2 of its norm); the same step of qwen3-moe
   (``moe_train_check``, at 1 layer, ``MOE_CHECK_LAYERS``: 1 x
   256 tokens, the CPU's experts fed
   to the card's MoE layers, in both dispatch modes, remat off and under
   "full", "dots" and "names"; its own-routing step printed, not held);
   one depth-1 qwen3-moe step at 8 x 512 tokens under each remat policy
   and without remat, with its ms, peak and flash launches
   (``remat_policy_steps``); for tinyllama and mamba2 a crash
   after step 4 and a resume from the checkpoint saved there, reproducing
   the uninterrupted losses (tinyllama rtol 2e-2, mamba2 bit for bit);
7. orchestrate (``orchestrate_check``): tinyllama's train step under the
   port's DFlow engine (``runtime/orchestrator.py::run_training``). At
   1 layer (``ORCH_CHECK_LAYERS``) and full width, with a checkpoint every
   2 steps, its losses and
   checkpoints against ``train_loop``'s (rtol 2e-2), also with a save that
   waits for the next step before it snapshots; at 8 of its 22 layers
   (``ORCH_LAYERS``) and full width (batch 8 x 512, remat, 4 steps)
   ``train_loop`` and the DAG under
   "dataflow" and "controlflow": ms a step, 16 flash forward and 8
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
entry jamba's H = 256 row, "jamba", with its launches, and a mamba2 rank's
H = 16 row, "h16", and a jamba rank's H = 128 row, "h128", with the
sharded runs' launches; the flash and backward entries a rank's heads
of the sharded training, "rank_train" (tinyllama's, H = 16 over Hk = 2,
D = 64), "rank_train_g8_d128" (qwen2-vl's, H = 32 over 4) and
"rank_train_g16_d128" (qwen3-moe's, H = 32 over 2), and the ssd and ssd
backward entries "rank_train_h16" (mamba2's 16 heads, the forward with
its chunk states), each with the launches of every rank's checked step
of its arch, and "rank_train_h128" (jamba's full width at a model axis of
2, 128 heads), with the launches of the reduced jamba's sharded training
at its own shape (``launch_shape``); the flash and backward entries'
"seamless" also seamless's sharded training launches; the decode entry a seamless
rank's row over the
memory, "rank_cross", with its sharded launches; the partial decode
entry qwen3-moe's, qwen2-vl's (and jamba's), kimi-k2's and seamless's
spans, "g16_d128", "g8_d128", "g8_d112" and "g1_d64_f32", each with its
archs' sharded launches); the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository around it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
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
            # a rank's heads of tinyllama's sharded training at a model
            # axis of 2 (sharded_train_check): 16 q and 2 KV heads, G = 8
            # at D = 64, the training forward (timed with and without lse)
            ("rank-train", 8, 512, 16, 2, 64, bf16, True, True,
             "rank_train"),
            # a rank's heads of the families' sharded training at a model
            # axis of 2: qwen2-vl's 32 q over 4 KV heads (G = 8) and
            # qwen3-moe's 32 over 2 (G = 16), D = 128
            ("rank-train-g8-d128", 8, 512, 32, 4, 128, bf16, True, True,
             "rank_train_g8_d128"),
            ("rank-train-g16-d128", 8, 512, 32, 2, 128, bf16, True, True,
             "rank_train_g16_d128"),
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
    memory (L = length = 1024), and a seamless rank's 8 q heads of a (1,
    2) mesh over their 8 KV heads of that memory (a strided view of its
    16, "rank_cross"). The serving shapes, kimi-k2's in both dtypes,
    qwen2-vl's, seamless's three and the long cache are timed. Each row
    names its record, as in ``check_flash``."""
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

    # a seamless rank's step over the memory on a (1, 2) mesh: its 8 q heads
    # over their 8 KV heads of the 1024-frame cache, which holds all 16 (a
    # strided view, as models/attention.py's cross_attention reads it)
    memory = torch.randn(2, 8, 1024, 16, 64, generator=gen,
                         device="cuda").bfloat16()
    k, v = memory[0, :, :, 8:], memory[1, :, :, 8:]
    q = torch.randn(8, 1, 8, 64, generator=gen, device="cuda").bfloat16()
    length = torch.tensor(1024, dtype=torch.int32, device="cuda")
    err = max_err(decode_attention_cuda(q, k, v, length),
                  decode_attention_plain(q, k, v, length))
    log(f"[kernels] decode_attention seamless-rank bfloat16 B=8 L=1024 H=8 "
        f"of 16 KV heads (strided) D=64 length=1024: max_abs_err={err:.3e} "
        f"(tol {TOL['bfloat16']:g})")
    if not err < TOL["bfloat16"]:
        raise AssertionError(f"decode_attention seamless-rank: {err}")
    ms = timer.ms(lambda: decode_attention_cuda(q, k, v, length))
    plain_ms = timer.ms(lambda: decode_attention_plain(q, k, v, length))
    lib_ms = sdpa_ms(torch, timer, q, k, v, causal=False)
    b_ms, b_by = bound(4 * 8 * 8 * 1024 * 64,
                       2 * (2 * 8 * 8 * 1024 * 64 + 2 * q.numel()),
                       PEAK_BF16_FLOPS)
    log(f"[kernels] decode_attention seamless-rank bfloat16 B=8 H=8 Hk=8 "
        f"D=64 length=1024: {ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa "
        f"{lib_ms} ms, bound {b_ms:.4f} ms by {b_by})")
    rows["rank_cross"] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": b_ms,
                          "bound_by": b_by}
    errs["rank_cross"] = err

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


def check_decode_partial(torch, timer, gen) -> dict:
    """The decode kernel's partial entry (one rank's span of a cache cut on
    its sequence axis) against its plain version, bf16 and fp32, at local
    lengths 0, 1, a mid value and the whole span, at D = 64, 112 and 128
    and G = 1, 8, 12 and 16, to ``check_decode``'s tolerances; its lse to
    ``LSE_TOL`` (relative to its largest magnitude over 1), and at length 0
    out 0 and lse -inf. Timed at each sharded run's span of a (1, 2) mesh
    (528 rows, 512 valid: the first decode step's; every head's q, as the
    decode step gathers it): tinyllama's (the "" record), qwen3-moe's G =
    16 at D = 128 ("g16_d128"), qwen2-vl's (and jamba's) G = 8 at D = 128
    ("g8_d128"), kimi-k2's G = 8 at D = 112 ("g8_d112") and seamless's
    G = 1 at D = 64 over its fp32 self cache, q cast from bf16
    ("g1_d64_f32"); no single PyTorch call returns the (out, lse) pair
    with GQA, so no library time."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_partial_cuda, decode_attention_partial_plain)
    errs, rows = {}, {}
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, record, B, L, H, Hk, D, dtype, timed length)
    for label, key, Bc, Lc, Hc, Hkc, Dc, dtype, timed in (
            ("tinyllama-span", "", 8, 528, 32, 4, 64, bf16, 512),
            ("tinyllama-span", "", 8, 528, 32, 4, 64, f32, None),
            ("g1", "", 2, 272, 4, 4, 64, bf16, None),
            ("g1", "", 2, 272, 4, 4, 64, f32, None),
            ("g12-d128", "", 8, 528, 48, 4, 128, bf16, None),
            ("g12-d128", "", 8, 528, 48, 4, 128, f32, None),
            ("qwen3-moe-span g16-d128", "g16_d128", 8, 528, 64, 4, 128, bf16,
             512),
            ("g16-d128", "g16_d128", 2, 272, 64, 4, 128, f32, None),
            ("qwen2-vl-span g8-d128", "g8_d128", 8, 528, 64, 8, 128, bf16,
             512),
            ("g8-d128", "g8_d128", 2, 272, 64, 8, 128, f32, None),
            ("kimi-k2-span g8-d112", "g8_d112", 8, 528, 64, 8, 112, bf16,
             512),
            ("g8-d112", "g8_d112", 2, 272, 64, 8, 112, f32, None),
            # seamless's fp32 self cache: every head's q, bf16 cast up
            ("seamless-span g1-d64", "g1_d64_f32", 8, 528, 16, 16, 64, f32,
             512)):
        name = str(dtype).split(".")[1]
        cache_k = torch.randn(2, Bc, Lc, Hkc, Dc, generator=gen,
                              device="cuda").to(dtype)
        cache_v = torch.randn(2, Bc, Lc, Hkc, Dc, generator=gen,
                              device="cuda").to(dtype)
        k, v = cache_k[1], cache_v[1]
        q = torch.randn(Bc, 1, Hc, Dc, generator=gen, device="cuda").to(dtype)
        if key == "g1_d64_f32":
            # the decoder's bf16 q, cast to the cache's fp32 as
            # models/attention.py's sharded decode casts it
            q = q.bfloat16().to(dtype)
        for n in (0, 1, Lc // 2 + 3, Lc):
            length = torch.tensor(n, dtype=torch.int32, device="cuda")
            out, lse = decode_attention_partial_cuda(q, k, v, length)
            want_out, want_lse = decode_attention_partial_plain(q, k, v,
                                                                length)
            torch.cuda.synchronize()
            err = max_err(out, want_out)
            if n == 0:
                lse_err = 0.0 if bool(torch.isneginf(lse).all()) \
                    else float("inf")
            else:
                lse_err = max_err(lse, want_lse) / max(
                    1.0, float(want_lse.abs().max()))
            log(f"[kernels] decode_attention_partial {label} {name} B={Bc} "
                f"L={Lc} H={Hc} Hk={Hkc} D={Dc} length={n}: out "
                f"max_abs_err={err:.3e} (tol {TOL[name]:g}), lse "
                f"err={lse_err:.3e} (tol {LSE_TOL:g})")
            if not (err < TOL[name] and lse_err < LSE_TOL):
                raise AssertionError(f"decode_attention_partial {label} "
                                     f"{name} length={n}: out {err}, lse "
                                     f"{lse_err}")
            errs[key] = max(errs.get(key, 0.0), err)
            if n == 0 and bool(out.any()):
                raise AssertionError("decode_attention_partial: a span of 0 "
                                     "valid keys gave a nonzero output")
        if timed is None:
            continue
        length = torch.tensor(timed, dtype=torch.int32, device="cuda")
        ms = timer.ms(lambda: decode_attention_partial_cuda(q, k, v, length))
        plain_ms = timer.ms(lambda: decode_attention_partial_plain(
            q, k, v, length))
        flops = 4 * Bc * Hc * timed * Dc
        nbytes = (q.element_size() * (2 * Bc * Hkc * timed * Dc + q.numel())
                  + 4 * (q.numel() + Bc * Hc))
        b_ms, b_by = bound(flops, nbytes, peak_flops(torch, dtype))
        log(f"[kernels] decode_attention_partial {label} {name} B={Bc} "
            f"H={Hc} Hk={Hkc} D={Dc} length={timed}: {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; no library "
            f"call returns out and lse with GQA)")
        rows[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": b_ms, "bound_by": b_by}
    return _records(rows, errs)


def check_ssd(torch, timer, gen) -> dict:
    """The SSD kernel against its plain version: y (relative to its largest
    magnitude, 5x the bf16/fp32 tolerance, as tests/test_kernels.py holds
    the Pallas kernel) and the final state (relative, 1e-4, the bound
    tests/test_models.py holds chunk lengths 4-32 to). The serving shape,
    a batch-1 8192-token prompt, mamba2's prefill on one rank of a (1, 2)
    mesh (16 of its 32 heads: 128 blocks on the 132 SMs; its record under
    "h16"), jamba's 256-head prefill ("jamba") and a jamba rank's 128
    heads of a (1, 2) mesh ("h128") are timed (``ssd_row``)."""
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

    def bound_of(B, S, Hc, P, x, dt, A, Bm, Cm, st, parts=False):
        # the work of the kernel's chunks (Q = 64), lower triangle of each
        # chunk's Q x Q products only; each input read and output written
        # once (with ``parts``, the operations and bytes themselves)
        Q = 64
        tri = Q * (Q + 1) // 2
        flops = B * Hc * -(-S // Q) * (2 * tri * (N + P) + 4 * Q * P * N)
        nbytes = (2 * x.element_size() * x.numel() + dt.element_size()
                  * dt.numel() + 4 * A.numel() + Bm.element_size()
                  * (Bm.numel() + Cm.numel()) + 2 * 4 * st.numel())
        if parts:
            return flops, nbytes
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

    # mamba2's prefill on one rank of a (1, 2) mesh: 16 of its 32 heads,
    # state0 and state_out one layer's slice of the rank's zeroed stacked
    # state shard, as models/ssm.py's sharded block calls it; its record
    rec["h16"] = ssd_row(torch, timer, randn, check, bound_of, plan_line,
                         "mamba2 rank of (1, 2)", 8, 512, H // 2, 12)
    # mamba2's training forward on one rank of a (1, 2) mesh: its 16 heads
    # from a zero state, writing the chunk-entry states its backward reads
    # (sharded_train_check); its record
    rec["rank_train_h16"] = ssd_states_row(torch, timer, randn, check,
                                           bound_of, 8, 512, H // 2)
    # jamba's at full width on one rank of a (1, 2) mesh: 128 of its 256
    # heads (the card trains jamba's reduced config, sharded_train_check;
    # this is the shape its full width gives a rank); its record
    rec["rank_train_h128"] = ssd_states_row(torch, timer, randn, check,
                                            bound_of, 8, 512, 128)

    # jamba-1.5-large-398b's prefill: 256 heads, state0 and state_out one
    # Mamba sublayer's slice of the block's zeroed (period - 1, B, H, P, N)
    # cache, as models/ssm.py calls it there; the row's own record
    rec["jamba"] = ssd_row(torch, timer, randn, check, bound_of, plan_line,
                           "jamba", 8, 512, 256, JAMBA_PERIOD - 1)
    # the same on one rank of a (1, 2) mesh: 128 of its 256 heads
    rec["h128"] = ssd_row(torch, timer, randn, check, bound_of, plan_line,
                          "jamba rank of (1, 2)", 8, 512, 128,
                          JAMBA_PERIOD - 1)
    return rec


def ssd_row(torch, timer, randn, check, bound_of, plan_line, label: str,
            B: int, S: int, H: int, layers: int) -> dict:
    """One timed ssd row of ``check_ssd`` at a model's prefill shape (P =
    64, N = 128, bf16, dt fp32), state0 and state_out layer 1's slice of a
    zeroed stacked (``layers``, B, H, P, N) cache, as models/ssm.py calls
    it: checked, timed, its record."""
    from repro_torch.kernels.ssd import kernel as ssd_k
    from repro_torch.kernels.ssd import ssd_cuda, ssd_plain
    F = torch.nn.functional
    P, N = 64, 128
    x = randn(B, S, H, P, dtype=torch.bfloat16)
    dt, A = F.softplus(randn(B, S, H)), -torch.exp(randn(H))
    Bm = randn(B, S, N, dtype=torch.bfloat16)
    Cm = randn(B, S, N, dtype=torch.bfloat16)
    cache = torch.zeros(layers, B, H, P, N, device="cuda")
    want = ssd_plain(x, dt, A, Bm, Cm, chunk=256, state0=cache[1].clone())
    got = ssd_cuda(x, dt, A, Bm, Cm, state0=cache[1], state_out=cache[1])
    err = check(f"{label} x=bfloat16 dt=float32 B={B} S={S} H={H} P={P} "
                f"N={N} state0=zero, in place in a stacked cache", got, want,
                "bfloat16")
    launches = ssd_k.launches
    # the same work every call: state0 is read whatever it holds
    ms = timer.ms(lambda: ssd_cuda(x, dt, A, Bm, Cm, state0=cache[1],
                                   state_out=cache[1]))
    plain_ms = timer.ms(lambda: ssd_plain(x, dt, A, Bm, Cm, chunk=256,
                                          state0=cache[1]), iters=10)
    ssd_k.launches = launches         # timing launches are not the path's
    b_ms, b_by = bound_of(B, S, H, P, x, dt, A, Bm, Cm, got[1])
    log(f"[kernels] ssd {label} bf16 B={B} S={S} H={H}: {ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms, no library call computes SSD, bound "
        f"{b_ms:.4f} ms by {b_by}, {plan_line(B, H, P)})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


def ssd_states_row(torch, timer, randn, check, bound_of, B: int, S: int,
                   H: int) -> dict:
    """One timed ssd row of ``check_ssd`` at a training forward's shape (P =
    64, N = 128, bf16, dt fp32, a zero state), the kernel asked for its
    chunk-entry states as ``kernels/ssd/ops.py`` asks under grad: y and the
    final state checked as ``check`` does, the chunk states within 1e-4 of
    the fp64 recurrence (``ssd_bwd_tolerance.chunk_states``); timed, its
    bound counting the chunk states written; its record."""
    from ssd_bwd_tolerance import chunk_states, grad_err
    from repro_torch.kernels.ssd import kernel as ssd_k
    from repro_torch.kernels.ssd import ssd_cuda, ssd_plain
    F = torch.nn.functional
    P, N = 64, 128
    x = randn(B, S, H, P, dtype=torch.bfloat16)
    dt, A = F.softplus(randn(B, S, H)), -torch.exp(randn(H))
    Bm = randn(B, S, N, dtype=torch.bfloat16)
    Cm = randn(B, S, N, dtype=torch.bfloat16)
    y, final, states = ssd_cuda(x, dt, A, Bm, Cm, return_states=True)
    label = f"training forward with chunk states B={B} S={S} H={H}"
    err = check(f"{label} x=bfloat16 dt=float32 P={P} N={N} state0=zero",
                (y, final), ssd_plain(x, dt, A, Bm, Cm, chunk=256),
                "bfloat16")
    st_err = grad_err(states[:, :, 1:], chunk_states(x, dt, A, Bm, Cm,
                                                     None)[:, :, 1:])
    log(f"[kernels] ssd {label}: chunk states {st_err:.3e} (tol 1e-4)")
    if not st_err <= 1e-4:
        raise AssertionError(f"ssd {label}: chunk states {st_err}")
    launches = ssd_k.launches
    ms = timer.ms(lambda: ssd_cuda(x, dt, A, Bm, Cm, return_states=True))
    plain_ms = timer.ms(lambda: ssd_plain(x, dt, A, Bm, Cm, chunk=256),
                        iters=10)
    ssd_k.launches = launches         # timing launches are not the path's
    flops, nbytes = bound_of(B, S, H, P, x, dt, A, Bm, Cm, final,
                             parts=True)
    b_ms, b_by = bound(flops, nbytes + 4 * states.numel(), PEAK_BF16_FLOPS)
    log(f"[kernels] ssd {label} bf16: {ms:.4f} ms (plain {plain_ms:.4f} "
        f"ms, no library call computes SSD, bound {b_ms:.4f} ms by {b_by}, "
        f"the chunk states' {4 * states.numel() / 1e6:.1f} MB counted)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


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
            # a rank's heads of tinyllama's sharded training at a model
            # axis of 2 (sharded_train_check): G = 8 at D = 64
            ("rank-train", 8, 512, 16, 2, 64, bf16, True, True,
             "rank_train"),
            # a rank's heads of qwen2-vl's (G = 8) and qwen3-moe's (G =
            # 16) sharded training at a model axis of 2, D = 128
            ("rank-train-g8-d128", 8, 512, 32, 4, 128, bf16, True, True,
             "rank_train_g8_d128"),
            ("rank-train-g16-d128", 8, 512, 32, 2, 128, bf16, True, True,
             "rank_train_g16_d128"),
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
SSD_BWD = ("ssd_bwd_wgmma_kernel", "ssd_bwd_kernel", "ssd_bwd_reduce")
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dstate0")
# ssd_bwd.cu's sum of a cluster's two blocks' rows, and the same sum left
# to the block's own heads: the fourth planted fault of check_ssd_bwd,
# built from the source
SSD_BWD_SUM = "if (csz == 2) {\n            const float4 o = "
SSD_BWD_LOCAL = "if (false) {\n            const float4 o = "


def ssd_bwd_moved_bytes(B: int, S: int, H: int, P: int, N: int,
                        cluster: int, itemsize: int = 2) -> tuple[int, int]:
    """Bytes of the SSD backward at one shape: (what the function must
    move, what the design moves). The function reads x, dy (B, S, H, P), B,
    C (B, S, N) in ``itemsize`` bytes and dt (B, S, H), A (H,) in fp32, and
    writes dx, dB, dC and ddt, dA alike, each once. The design also reads
    the forward's fp32 chunk states (B, H, ceil(S / 64), P, N) and writes
    and reads back the fp32 partials of dB and dC the walk leaves: H / cluster
    a batch row when that is over 1 (the wgmma walk's clusters of heads),
    none when the cluster holds every head; ``cluster`` = 1 is the per-head
    partials of the scalar walk and of the design before the clusters."""
    fn = (3 * B * S * H * P * itemsize + 2 * 4 * B * S * H + 2 * 4 * H
          + 4 * B * S * N * itemsize)
    states = 4 * B * H * -(-S // 64) * P * N
    parts = H // cluster if H // cluster > 1 else 0
    return fn, fn + states + 2 * 2 * 4 * B * parts * S * N


def start_ssd_bwd_fault_build():
    """``nvcc`` of ssd_bwd.cu with each block of a cluster summing its
    rows of dB and dC over its own heads alone (``SSD_BWD_LOCAL``), started
    now so that it compiles while the card checks the other kernels:
    (library path, process)."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "ssd_bwd.cu").read_text()
    if src.count(SSD_BWD_SUM) != 1:
        raise RuntimeError(f"ssd_bwd.cu: {SSD_BWD_SUM!r} found "
                           f"{src.count(SSD_BWD_SUM)} times, want 1")
    src = src.replace(SSD_BWD_SUM, SSD_BWD_LOCAL)
    out = ROOT / "build" / "ssd_bwd_fault"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd_bwd.cu").write_text(src)
    lib = out / "ssd_bwd.so"
    return lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(lib), str(out / "ssd_bwd.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def ssd_bwd_fault_kernel(fault_build):
    """A function with ``ssd_bwd_cuda``'s arguments that runs the faulty
    library of ``start_ssd_bwd_fault_build`` (waited for here)."""
    import ctypes
    from repro_torch.kernels.ssd import kernel_bwd
    lib_path, proc = fault_build
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of the planted fault:\n{out}")
    fn = ctypes.CDLL(str(lib_path)).ssd_bwd
    entry = kernel_bwd._entry()
    fn.argtypes, fn.restype = entry.argtypes, entry.restype

    def run(*args, **kwargs):
        orig = kernel_bwd._entry
        kernel_bwd._entry = lambda: fn
        try:
            return kernel_bwd.ssd_bwd_cuda(*args, **kwargs)
        finally:
            kernel_bwd._entry = orig
    return run


def check_ssd_bwd(torch, timer, gen, fault_build) -> dict:
    """The SSD backward kernel against autograd through the plain scan
    (``ssd_bwd_plain``, fp32, at the model's chunk): each of dx, ddt, dA,
    dB, dC and dstate0 within ``BWD_TOL`` of its norm (1e-2 in bf16, 1e-4
    in fp32), and the chunk states the forward writes for it within 1e-4
    of the plain scan's, at the training shape (bf16, and fp32), a random
    state0 with a final-state cotangent, a ragged S, P = 8 (the scalar
    kernel in bf16: the wgmma walk is built for mamba2's P = 64,
    N = 128), a 2048-token sequence and a mamba2 rank's 16 heads. At the
    training shape two calls must give the same bits, and four planted
    faults must each fail the rule: three made by the kernel on altered
    inputs (``tools/ssd_bwd_tolerance.py``: the chunk states read as zeros,
    half the heads, each chunk alone) and one made by the kernel built with
    each block of a cluster summing its rows of dB and dC over its own
    heads alone (``fault_build``, from ``start_ssd_bwd_fault_build``,
    started after the kernels' build). The training shape, the long
    sequence and the ranks' heads are timed: the kernel (and each of its
    two launches, profiled), the forward with its chunk states against
    without, and the plain version; the bytes are
    ``ssd_bwd_moved_bytes``'s."""
    import ctypes
    from ssd_bwd_tolerance import (chunk_states, cluster_fault, grad_err,
                                   planted_faults)
    from repro_torch.kernels.ssd import (ssd_bwd_cuda, ssd_bwd_plain,
                                         ssd_cuda)
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd.kernel_bwd import (cluster_size, layout,
                                                    partial_heads,
                                                    tensor_cores)
    F = torch.nn.functional
    rec, worst, rank_rows, faulty = None, 0.0, {}, None
    lib = _build.library("ssd_bwd")
    lib.ssd_bwd_cluster_size.argtypes = [ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

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
             True),
            # mamba2's training backward on one rank of a (1, 2) mesh (16
            # of its 32 heads; sharded_train_check), its own record
            ("rank-train-h16", 8, 512, 16, 64, 128, torch.bfloat16, 256,
             False, True),
            # jamba's at full width on one rank of a (1, 2) mesh (128 of
            # its 256 heads), its own record, with the training shape's
            # two-call and planted-fault checks
            ("rank-train-h128", 8, 512, 128, 64, 128, torch.bfloat16, 256,
             False, True)):
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
        if tensor_cores(dtype, P, N):
            if lib.ssd_bwd_cluster_size(B, H) != cluster_size(B, H, sms):
                raise AssertionError(
                    f"ssd_bwd: the C entry sums "
                    f"{lib.ssd_bwd_cluster_size(B, H)} heads at B={B} "
                    f"H={H}, the wrapper {cluster_size(B, H, sms)}")
            hb, blocks = layout(B, H, sms)
            kind = (f"wgmma, {hb} head(s) a block, clusters of {blocks} "
                    f"blocks")
        else:
            kind = "scalar"
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
        if label in ("training", "rank-train-h128") \
                and dtype is torch.bfloat16:
            again = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states)
            if not all(torch.equal(a, b) for a, b in zip(got[:5], again)):
                raise AssertionError(f"ssd_bwd {label}: two calls differ")
            faults = planted_faults(ssd_bwd_cuda, x, dt, A, Bm, Cm, dy,
                                    states)
            if faulty is None:        # waits for its build, once
                faulty = ssd_bwd_fault_kernel(fault_build)
            faults.update(cluster_fault(faulty, x, dt, A, Bm, Cm, dy,
                                        states))
            for fault, (k, bad) in faults.items():
                err = grad_err(bad, want[k])
                log(f"[kernels] ssd_bwd {label} planted fault, {fault}: "
                    f"||err||/||want|| {err:.3e} (must exceed {tol:g})")
                if not err > tol:
                    raise AssertionError(f"the ssd backward's check passes "
                                         f"a planted fault at {label}: "
                                         f"{fault}")
            log(f"[kernels] ssd_bwd {label}: two calls give the same bits")
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
        cl = cluster_size(B, H, sms)
        nbytes, moved = ssd_bwd_moved_bytes(B, S, H, P, N, cl)
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        # this design also reads the stored chunk states and writes and
        # reads back the fp32 partials of dB and dC that its clusters leave
        bx_ms, bx_by = bound(flops, moved, PEAK_BF16_FLOPS)
        scratch = 2 * 4 * B * partial_heads(dtype, B, H, P, N, sms) * S * N
        log(f"[kernels] ssd_bwd {label} bf16 B={B} S={S} H={H}: {ms:.4f} ms "
            f"(launches, profiled: "
            f"{profiled(passes)}; "
            f"plain {plain_ms:.4f} ms, no library call computes it, bound "
            f"{b_ms:.4f} ms by {b_by}: {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB; with the chunk states and the "
            f"partials, {moved / 1e6:.1f} MB: {bx_ms:.4f} ms by {bx_by}; "
            f"{B * H} heads, {cl} of them summed on chip a cluster, "
            f"{lib.ssd_bwd_tc_smem_bytes(P, N)} B shared memory a block, "
            f"fp32 scratch of dB and dC {scratch / 1e6:.1f} MB); "
            f"the forward {fwd_ms:.4f} ms, with its chunk states "
            f"{fwd_st_ms:.4f} ms")
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by, "design_bound_ms": bx_ms,
               "launch_ms": passes}
        if label == "training":
            rec = row
        elif label.startswith("rank-train"):
            rank_rows[label.replace("-", "_")] = dict(row, max_abs_err=max(
                max_err(a, b) for a, b in zip(got, want) if b is not None))
        else:
            long_row = row
    rec["max_abs_err"] = worst
    rec.update(rank_rows)
    rec["long"] = long_row
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
        def recording(router, x, cfg, **kw):
            topi, gates, aux = route(router, x, cfg, **kw)
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
        def forced(router, x, cfg, **kw):
            topi, gates, aux = route(router, x, cfg, **kw)
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
    order). A sharded rank's call (``shard``) forms them as ``_route``
    does there."""
    import importlib
    moe_mod = importlib.import_module("repro_torch.models.moe")
    calls, fed = iter(recorded), {}

    def forced(router, x, cfg, shard=None):
        if router.data_ptr() not in fed:
            fed[router.data_ptr()] = next(calls)[0]
        topi = fed[router.data_ptr()].to(x.device)
        probs = moe_mod._router_probs(router, x)
        return (topi,) + moe_mod._gates_and_aux(probs, topi, cfg, shard)
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
      tokens whose choices agree;
    * ``gate_excess``: the most by which such a token's gate difference
      exceeds half the two devices' largest logit difference at its
      chosen experts, less the slack above. The gates are the softmax of
      the chosen experts' logits, whose Jacobian's rows sum to at most
      1/2 in absolute value, so gates computed right from logits that
      differ by d differ by at most d / 2: <= 0 unless the gates part
      from their own logits."""
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
    gate_bound = 0.5 * diff.gather(1, ti_c).max(-1).values[:, None]
    return {"apart": int(only_c.sum()), "choices": only_c.numel(),
            "gap": float(gap[pairs].max()) if pairs.any() else 0.0,
            "excess": float((gap - allowed)[pairs].max()) - slack
            if pairs.any() else float("-inf"),
            "gate_err": float(gate_diff[alike].abs().max())
            if alike.any() else 0.0,
            "gate_excess": float((gate_diff.abs() - gate_bound)[alike].max())
            - slack if alike.any() else float("-inf")}


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
            def faulty(router, x, cfg, **kw):
                topi, gates, aux = route(router, x, cfg, **kw)
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
# the batch of ``train_check`` (and of ``moe_train_check``'s CPU step):
# once 2 x 256 tokens, cut to 1 sequence, and ``train_check``'s to 128
# tokens, for the script's time when the families' sharded training came in
# (on an H100 80GB HBM3 at 700 W, the CPU references of nemotron-4-15b and
# qwen2-vl-72b at depth 1 and qwen3-14b at depth 2 took 50.2, 60.0 and
# 40.6 s of a 960.9 s script at 2 x 256; at 1 x 256, 41.4, 39.5 and 28.0 s
# of a 1099.8 s script on a slower host)
TRAIN_CHECK_BATCH = 1
TRAIN_CHECK_SEQ = 128
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
    (``TRAIN_CHECK_BATCH`` x ``TRAIN_CHECK_SEQ`` tokens; for the vlm family
    also 16 vision embeddings and the 3-D positions of
    ``qwen2vl_positions``), remat off
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
    seq = TRAIN_CHECK_SEQ
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
    rows = TRAIN_CHECK_BATCH
    toks = torch.as_tensor(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=rows)).batch_at(0)[
            "tokens"])
    extra, what = {}, ""
    if cfg.family == "vlm":
        n_vis = QWEN2VL_GRID[0] * QWEN2VL_GRID[1]
        extra = {"vision_embeds": torch.randn(
            rows, n_vis, cfg.d_model,
            generator=torch.Generator().manual_seed(2)).bfloat16(),
            "mrope_positions": qwen2vl_positions(torch, seq, rows)}
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
# the train check against the CPU: 1 layer, 3.73 B parameters (7.5 GB in
# bf16, derived), whose CPU copy and gradients the host holds; cut from 2
# layers (6.22 B) for the script's time when sharded_train_check came in:
# its eight steps (the CPU's and the card's seven) at half the depth, every
# rule kept (the MoE backward still feeds the layer's flash backward)
MOE_CHECK_LAYERS = 1
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
    (the plain path), same weights and batch (``TRAIN_CHECK_BATCH`` x 256
    tokens), the attention weights at std 1/sqrt(fan-in) as
    ``train_check`` draws them.
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
        vocab=cfg.vocab, seq_len=seq, global_batch=TRAIN_CHECK_BATCH))
        .batch_at(0)["tokens"])

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
# the layers of orchestrate_check's runs with checkpoints against
# train_loop's: 1 (1.75 GB of parameters and moments a checkpoint, derived),
# cut from 2 (2.19 GB) for the script's time when sharded_train_check came
# in; every rule kept
ORCH_CHECK_LAYERS = 1
# the steps of each orchestrated run at ORCH_LAYERS, cut from 6 for the
# same reason (ms a step, launches a step and peaks kept)
ORCH_STEPS = 4
# the layers of those runs, cut from tinyllama's full 22 for the script's
# time when the hybrid's and the encoder-decoder's sharded training came
# in (every rule kept: ms a step, 2 flash forward and 1 backward launches
# a layer a step, the peaks within 1.05x, the traced run's spans)
ORCH_LAYERS = 8


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


def _ckpt_leaf(d: Path, key: str, meta: dict):
    """One leaf of a saved checkpoint's directory ``d`` as fp64 (bf16 from
    its bits)."""
    import numpy as np
    a = np.load(d / f"{key}.npy")
    if meta["dtype"] == "bfloat16":
        a = (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float64)


def _same_bytes(a: Path, b: Path, chunk: int = 1 << 26) -> bool:
    """Whether two files hold the same bytes, read a chunk at a time."""
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if x != fb.read(chunk):
                return False
            if not x:
                return True


def _ckpts_agree(got: Path, want: Path, steps) -> tuple[float, bool]:
    """The largest leaf difference relative to that leaf's largest
    magnitude over ``steps``, and whether every leaf is bit for bit. A leaf
    whose file holds the same bytes in both (the manifests alike) differs
    by 0; only the others are read as fp64 (``_ckpt_leaf``)."""
    import numpy as np
    worst, same = 0.0, True
    for step in steps:
        a_dir, b_dir = (d / f"step_{step:08d}" for d in (got, want))
        manifests = [json.loads((d / "manifest.json").read_text())["leaves"]
                     for d in (a_dir, b_dir)]
        if set(manifests[0]) != set(manifests[1]):
            raise AssertionError(f"checkpoint {step}: leaves differ")
        for k, meta in manifests[1].items():
            if manifests[0][k] == meta and _same_bytes(
                    a_dir / f"{k}.npy", b_dir / f"{k}.npy"):
                continue
            a, b = (_ckpt_leaf(d, k, m) for d, m in (
                (a_dir, manifests[0][k]), (b_dir, meta)))
            scale = max(float(np.abs(b).max()), 1e-30)
            worst = max(worst, float(np.abs(a - b).max()) / scale)
            same = same and bool(np.array_equal(a, b))
    return worst, same


def orchestrated_run(torch, train_mod, counters: dict, how: str, kw: dict,
                     layers: int) -> tuple:
    """One run of ``orchestrate_check`` at ``layers`` layers: ``train_loop``,
    ``run_training`` under "dataflow" or "controlflow", or "dataflow,
    traced"; its ms a step, launches a step (held to 2 flash forward and
    1 backward a layer) and peak logged. -> (its result, its peak)."""
    steps = kw["steps"]
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    if how == "train_loop":
        out = train_mod.train_loop(ORCH_ARCH, log_every=0, device="cuda",
                                   **kw)
    elif how == "dataflow, traced":
        out = run_traced(torch, train_mod, kw)
    else:
        out = run_orchestrated(torch, train_mod, how, kw)
    peak = torch.cuda.max_memory_allocated()
    counts = {name: k.launches for name, k in counters.items()}
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
    return out, peak


def orchestrate_check(torch, counters: dict) -> None:
    """The port's train step under its DFlow engine (``runtime/
    orchestrator.py``), on the card; each part's seconds logged.

    At ``ORCH_CHECK_LAYERS`` layers, full width (batch 4 x 256, 4 steps, a
    checkpoint every 2):
    ``run_training`` under "dataflow" against ``train_loop``, losses and
    every leaf of the checkpoints at steps 2 and 4 within 2e-2 (the
    tinyllama resume rule; leaves relative to their largest magnitude),
    then again with a save that waits for the next step before it
    snapshots. At ``ORCH_LAYERS`` layers and full width (batch 8 x 512,
    remat, ``ORCH_STEPS`` steps):
    ``train_loop``, then ``run_training`` under "dataflow" and
    "controlflow": ms a step, the flash kernels' launches a step (2 and 1
    a layer, so the kernels ran in the DAG's threads), the engine's
    per-function completion times, and the peak memory, each orchestrated
    peak within 1.05x of ``train_loop``'s."""
    import shutil
    from repro_torch.launch import train as train_mod
    root = ROOT / "build" / "chip_smoke_orchestrate"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(steps=4, batch=4, seq=256, seed=3)
    t0 = time.perf_counter()
    try:
        with cut_depth(train_mod, ORCH_CHECK_LAYERS):
            loop = train_mod.train_loop(ORCH_ARCH, ckpt_dir=str(root / "loop"),
                                        ckpt_every=2, log_every=0,
                                        device="cuda", **kw)
            seconds = {"train_loop": time.perf_counter() - t0}
            for label, late in (("dataflow", False),
                                ("dataflow, each save waiting for the next "
                                 "step", True)):
                t1 = time.perf_counter()
                out = run_orchestrated(torch, train_mod, "dataflow", kw,
                                       ckpt_dir=root / "dag", save_late=late)
                t2 = time.perf_counter()
                rel = max(abs(a - b) / abs(b)
                          for a, b in zip(out["losses"], loop["losses"]))
                worst, same = _ckpts_agree(root / "dag", root / "loop",
                                           (2, 4))
                seconds[label] = (t2 - t1, time.perf_counter() - t2)
                log(f"[orchestrate] depth-{ORCH_CHECK_LAYERS} {ORCH_ARCH} "
                    f"run_training "
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
                    raise AssertionError(f"orchestrated depth-"
                                         f"{ORCH_CHECK_LAYERS} run "
                                         f"({label}) disagrees with "
                                         f"train_loop")
                shutil.rmtree(root / "dag")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[orchestrate] depth-{ORCH_CHECK_LAYERS} runs with checkpoints in "
        f"{time.perf_counter() - t0:.1f} s (seconds: train_loop's run "
        f"{seconds['train_loop']:.1f}; each run_training's run and its "
        f"checkpoints' comparison: "
        + "; ".join(f"{k} {v[0]:.1f} and {v[1]:.1f}"
                    for k, v in seconds.items() if k != "train_loop") + ")")

    kw = dict(steps=ORCH_STEPS, batch=8, seq=512, seed=0)
    layers, steps = ORCH_LAYERS, kw["steps"]
    runs = {}
    t0 = time.perf_counter()
    with cut_depth(train_mod, ORCH_LAYERS):
        for how in ("train_loop", "dataflow", "controlflow",
                    "dataflow, traced"):
            runs[how] = orchestrated_run(torch, train_mod, counters, how,
                                         kw, layers)
    log(f"[orchestrate] the {ORCH_LAYERS}-layer runs in "
        f"{time.perf_counter() - t0:.1f} s")
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
            def wrapped(p, x, c, memory, *rest):
                out = cross(p, x, c, memory, *rest)
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
            def faulty(self, params, frames, *rest):
                return encode(self, params, frames, *rest).detach()
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
        def faulty(params, u, cfg, *, cache=None, **kw):
            if u.is_cuda and cache is not None and u.shape[1] == 1:
                cache.state.zero_()
            return mamba_block(params, u, cfg, cache=cache, **kw)
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

        def faulty(params, u, cfg, *, cache=None, **kw):
            out, cache = mamba_block(params, u, cfg, cache=cache, **kw)
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


# fp32 temporaries of one slice of a leaf that ``optim/adamw.py``'s update
# holds at once, at its last line: g32, m32, v32, upd, p.float(), lr * upd
# and their difference
ADAMW_TEMPORARIES = 7
# the held peak's margin over the optimizer's derived peak
PEAK_MARGIN = 1.05


def largest_slice(model) -> int:
    """Elements of the largest row slice that ``optim/adamw.py`` updates at
    once (``_pieces``, at most ``SLICE_ELEMENTS``), over every leaf."""
    import torch
    from repro_torch.models.param import tree_items
    from repro_torch.optim.adamw import _pieces
    return max(torch.empty(d.shape, device="meta")[piece].numel()
               for _, d in tree_items(model.param_decls())
               for piece in _pieces(tuple(d.shape)))


def optimizer_peak(model) -> int:
    """Derived bytes at AdamW's peak: the training state
    (``launch/train.py::_state_bytes``) plus ``ADAMW_TEMPORARIES`` fp32
    copies of the largest slice it updates at once (``largest_slice``;
    when each leaf was updated whole, the largest leaf set it)."""
    from repro_torch.launch.train import _state_bytes
    from repro_torch.optim import AdamWConfig
    return _state_bytes(model, AdamWConfig()) \
        + ADAMW_TEMPORARIES * 4 * largest_slice(model)


def train_counted(torch, counters: dict, arch: str, layers: int,
                  kernels: tuple, optimizer_bound: bool = False) -> dict:
    """``train_loop(arch)`` at batch 8 x 512 tokens, remat on: a first
    (cold) call of 2 steps, then a counted one of 4, its kernels' launch
    counts set to 0 just before and returned; the depth is what
    ``launch/train.py``'s ``get_config`` gives (``cut_depth`` cuts it).
    Held: the forward kernel twice a layer a step (remat recomputes it),
    the backward once, no other kernel; finite losses; with
    ``optimizer_bound`` (an arch of ~40 GB of state), AdamW's own peak
    (its calls' ``max_memory_allocated``, the peak counter reset as each
    begins) within ``PEAK_MARGIN`` of ``optimizer_peak``. The step's peak,
    AdamW's and the derived peak are printed for every arch."""
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
    peaks = {"run": 0, "adamw": 0}

    def measured(update):
        def run(*args, **kw):
            peaks["run"] = max(peaks["run"], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            out = update(*args, **kw)
            peaks["adamw"] = max(peaks["adamw"],
                                 torch.cuda.max_memory_allocated())
            return out
        return run
    from repro_torch.runtime import train_lib
    with patched(train_lib, "adamw_update", measured):
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
    peak = max(peaks["run"], torch.cuda.max_memory_allocated())
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"[train] {arch} batch=8 seq=512 ({n_params / 1e9:.3f} B "
        f"params, {layers} layers, remat) {steps} steps: "
        f"{out['wall_s'] / steps * 1e3:.1f} ms/step, "
        f"{out['tokens_per_s']:.0f} tokens/s; losses {out['losses']}; "
        f"launches {counts}; peak memory {peak / 2**30:.2f} GiB of the "
        f"card's {card / 2**30:.2f}, AdamW's own "
        f"{peaks['adamw'] / 2**30:.2f} GiB (training state "
        f"{_state_bytes(model, AdamWConfig()) / 1e9:.1f} GB, AdamW's peak "
        f"{optimizer_peak(model) / 2**30:.2f} GiB, derived: slices of "
        f"{largest_slice(model)} elements at most); "
        f"derived: {derived}; both calls in "
        f"{time.perf_counter() - t_arch:.1f} s")
    if optimizer_bound and \
            peaks["adamw"] > PEAK_MARGIN * optimizer_peak(model):
        raise AssertionError(f"{arch}: AdamW's peak {peaks['adamw']} bytes "
                             f"over {PEAK_MARGIN} x its derived "
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


# ------------------------------------------------------- sharded serving
# One arch over a (data, model) mesh through ``runtime/serve_lib.py``'s
# steps: batch 8, 512-token prompts, 32 new tokens, seeded random weights.
SHARD_BATCH, SHARD_PROMPT, SHARD_GEN = 8, 512, 32
# cache rows of a sharded run: at a model axis of 2 each rank holds 528, so
# the prompt (rows 0-511) ends in rank 0's span and the decode (rows
# 512-543) crosses into rank 1's at row 528
SHARD_MAX_LEN = 1056
# the layers a sharded run keeps, at full width (full depth where the arch
# is not named; jamba one super-block of period 4, ``one_block``, as the
# card serves it unsharded): tinyllama-1.1b cut to fit the script's time
# (at full depth the whole script took 1067.3 s on an H100 80GB HBM3 at
# 700 W whose gloo ranks decoded tinyllama at 13.8 tok/s, its 112
# collectives a step), also for sharded_train_check; qwen2-vl and kimi-k2
# to what ranks that share the one card hold beside the unsharded
# reference's run; starcoder2-15b, qwen3-moe, mamba2 and seamless-m4t (both
# stacks alike) cut again, to 4, 1, 6 and 6 + 6 layers, for the script's
# time when sharded_train_check came in (the whole script took 1101.4 s
# on a slower host of the same card with them at 8, 2, 12 and 12 + 12)
SHARD_LAYERS = {"tinyllama-1.1b": 8, "starcoder2-15b": 4, QWEN2VL_ARCH: 2,
                MOE_ARCH: 1, KIMI_ARCH: 1, "mamba2-370m": 6,
                SEAMLESS_ARCH: 6}
# ((data, model), backend, archs): one spawn a mesh, its ranks serving the
# archs one after another; NCCL at 1 x 1, gloo for ranks that share the one
# card (NCCL refuses two ranks on one device). The data axis of 2 runs
# qwen3-moe alone (tinyllama's (2, 2) run, which it covers, was cut for
# the script's time)
SHARD_GROUPS = (((1, 1), "nccl", ("tinyllama-1.1b",)),
                ((1, 2), "gloo", ("tinyllama-1.1b", "starcoder2-15b",
                                  QWEN2VL_ARCH, MOE_ARCH, KIMI_ARCH,
                                  "mamba2-370m", JAMBA_ARCH, SEAMLESS_ARCH)),
                ((2, 2), "gloo", (MOE_ARCH,)))
SHARD_JOIN_S = 900
MODEL_TOL = 0.06      # tests/test_archs.py's rule: rel, with equal argmax
# the planted faults of the dense family, run at tinyllama's (1, 1) (the
# first alone: at a model axis of 1 the last two are the correct program,
# one span taking every token, one vocab shard every row) and (1, 2)
SHARD_FAULTS = ("merge drops model rank 0's partial",
                "new token's K/V written into every rank's span",
                "vocab shard's row offset one shard off")
# the MoE family's, run in every multi-rank MoE run
MOE_FAULTS = ("every rank serves experts 0..E_loc-1",
              "experts' sum over the model axis skipped")
# the SSM family's, run in every multi-rank SSM run
SSM_FAULTS = ("a rank's dt_bias, A_log and D from heads 0..H_loc-1",
              "gated norm over the rank's own columns")
# the hybrid family's, run in every multi-rank hybrid run: its own, and
# the MoE's first in its block
HYBRID_FAULTS = ("every Mamba sublayer of a block on SSM cache slice 0",
                 MOE_FAULTS[0])
# the encoder-decoder's, run in every multi-rank encdec run
ENCDEC_FAULTS = ("memory K/V gather skipped: a rank's own heads and zeros",
                 "encoder's row-parallel wo sum skipped")
# the faults planted in the decode step alone start from the counted pass's
# cache after its prefill (and its prefill logits); every other fault runs
# its own prefill; each fault's pass runs one decode step: the dropped
# partial and the shifted vocab show at the prefill, the everywhere-write
# at the first step, where rank 1 writes the token at row 512 into its own
# first row (global 528), which the reference holds empty
DECODE_ONLY_FAULTS = SHARD_FAULTS[:2]
FAULT_STEPS = 1


def shard_faults_of(arch: str, family: str, mesh_shape: tuple) -> tuple:
    """The planted faults a run of ``arch`` on ``mesh_shape`` carries."""
    data, model = mesh_shape
    if model == 1:
        return SHARD_FAULTS[:1] if arch == "tinyllama-1.1b" else ()
    by_family = {"moe": MOE_FAULTS, "ssm": SSM_FAULTS,
                 "hybrid": HYBRID_FAULTS, "encdec": ENCDEC_FAULTS}
    if family in by_family:
        return by_family[family]
    return SHARD_FAULTS if arch == "tinyllama-1.1b" and data == 1 else ()


def shard_cut(cfg):
    """The config a sharded run serves: jamba one super-block of period 4
    (``one_block``), an arch of ``SHARD_LAYERS`` cut to its layers (an
    encoder-decoder's both stacks alike), the rest as they are."""
    if cfg.family == "hybrid":
        return one_block(cfg)
    if cfg.name not in SHARD_LAYERS:
        return cfg
    layers = SHARD_LAYERS[cfg.name]
    return dataclasses.replace(cfg, n_layers=layers, **(
        {"n_encoder_layers": layers} if cfg.family == "encdec" else {}))


def shard_collectives(cfg, zero3_mesh: tuple | None = None) -> int:
    """all_reduce calls a decode step of a sharded run: the embedding and
    the logits 2, and each layer's own: an attention 4 (the q and new K/V
    gather, the lse max, the merge's sums, ``wo``), an MLP or MoE 1, a
    Mamba block 2 (the norm with the conv tail, ``out_proj``); an
    encoder-decoder's decoder layer adds its cross-attention's ``wo``,
    1. A ZeRO-3 run on ``zero3_mesh`` adds its gathers' (``zero3_gathers``:
    the embedding, each layer or block, the head, one a dtype)."""
    if zero3_mesh is not None:
        return shard_collectives(cfg) + zero3_gathers(cfg,
                                                      zero3_mesh)["decode"]
    fam = cfg.family
    if fam == "ssm":
        per = 2 * cfg.n_layers
    elif fam == "hybrid":
        per_block = 4 + cfg.hybrid_period + 2 * (cfg.hybrid_period - 1)
        per = per_block * (cfg.n_layers // cfg.hybrid_period)
    else:
        per = (6 if fam == "encdec" else 5) * cfg.n_layers
    return 2 + per


def shard_launches(cfg, steps: int) -> dict:
    """Each kernel's launches a rank makes in a sharded run's counted
    pass (a prefill, ``steps`` decode steps): flash once an attention at
    the prefill (an encoder-decoder's encoder, decoder and
    cross-attention), the partial decode once a cached self-attention a
    step, the whole-cache decode once a cross-attention a step, ssd once
    a Mamba block at the prefill."""
    fam = cfg.family
    if fam == "ssm":
        return {"ssd": cfg.n_layers}
    if fam == "hybrid":
        nb = cfg.n_layers // cfg.hybrid_period
        return {"flash_attention": nb, "decode_attention_partial": nb * steps,
                "ssd": nb * (cfg.hybrid_period - 1)}
    if fam == "encdec":
        return {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers,
                "decode_attention_partial": cfg.n_layers * steps,
                "decode_attention": cfg.n_layers * steps}
    return {"flash_attention": cfg.n_layers,
            "decode_attention_partial": cfg.n_layers * steps}


def attention_at_fan_in(params: dict, cfg) -> None:
    """Every attention's wq, wk, wv and wo (the encoder-decoder's three
    kinds) rescaled in place from the reference's draw (std
    1/sqrt(heads); wo 1/sqrt(D)) to std 1/sqrt(fan-in) (d_model; H * D for
    wo), as ``model_check`` draws them
    (``tools/attention_conditioning.py::fan_in_std``). Elementwise with the
    global head counts, so a rank's shards are rescaled exactly as the
    whole leaves. A model without attention is left as it is."""
    if not cfg.attends:
        return
    roots = ((params["encoder"], "attn"), (params["decoder"], "self_attn"),
             (params["decoder"], "cross_attn")) \
        if cfg.family == "encdec" else ((params["layers"], "attn"),)
    for outer, name in roots:
        attn = outer[name]
        for leaf, heads in (("wq", cfg.n_heads_eff), ("wk", cfg.n_kv_heads),
                            ("wv", cfg.n_kv_heads)):
            attn[leaf].mul_((heads / cfg.d_model) ** 0.5)
        attn["wo"].mul_(cfg.n_heads_eff ** -0.5)


@contextlib.contextmanager
def first_output(owner, name: str, kept: dict):
    """Context: the first call of ``owner.name`` inside it (layer 0's
    Mamba block at the prefill) keeps the first member of what it returns,
    the output before the residual, under ``kept["out"]`` on the host in
    fp32."""
    def wrap(fn):
        def recording(*args, **kw):
            out = fn(*args, **kw)
            if "out" not in kept:
                kept["out"] = out[0].detach().float().cpu()
            return out
        return recording
    with patched(owner, name, wrap):
        yield


def _ssm_snapshot(cache) -> dict:
    """The first and last layers of an SSM cache on the host; of a
    hybrid's (its leaves (blocks, Mamba sublayers, ...)), every Mamba
    sublayer, block by block."""
    hybrid = cache.ssm.state.dim() == 6
    return {field: (a.flatten(0, 1) if hybrid else a[[0, -1]]).float().cpu()
            for field, a in zip(cache.ssm._fields, cache.ssm)}


def _kv_of(cache):
    """The K/V cache a sharded run cuts into spans: the decoder-only
    families' ``kv``, an encoder-decoder's fp32 ``self_kv``."""
    return cache.self_kv if hasattr(cache, "self_kv") else cache.kv


def sharded_reference(torch, arch: str, path: Path, shards: int = 1) -> None:
    """``serve_loop(arch)`` unsharded on the card (batch 8, 512-token
    prompts, 32 new tokens, seed 0, cut by ``shard_cut``) with a model
    that keeps each step's logits on the host; saved to ``path`` for the
    ranks with its prompts, its tokens and the first and last layers of its
    final K/V cache (an encoder-decoder's fp32 self cache, and its memory
    K/V with the seeded frames its prefill took), or of its SSM cache after
    the first decode step and after the last (a hybrid's every Mamba
    sublayer), with the first Mamba block's output at the prefill; the
    routing of every MoE call too. ``shards`` > 1: the batch as as many
    data shards, each served alone on its rows of the same prompts (the
    reference's MoE capacity is a data shard's), put back together along
    the batch; the routing a list a shard. The card's memory is released
    after."""
    import numpy as np
    import repro_torch.models.lm as lm_mod
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import LM, EncDecLM
    full = get_config(arch)
    family = full.family
    prompts = np.random.default_rng(0).integers(
        0, full.vocab, size=(SHARD_BATCH, SHARD_PROMPT))
    parts = []
    for rows in np.split(np.arange(SHARD_BATCH), shards):
        steps, kept, routes, mamba0 = [], {}, {"cuda": []}, {}

        def keep(logits, cache):
            steps.append(logits[:, -1].float().cpu())
            if getattr(cache, "ssm", None) is not None and \
                    len(steps) - 1 in (FAULT_STEPS, SHARD_GEN - 1):
                kept[len(steps) - 1] = _ssm_snapshot(cache)
            kept["kv"] = _kv_of(cache)
            if family == "encdec":
                kept["cross"] = (cache.cross_k, cache.cross_v)

        class Recording(LM):
            def _apply_cached(self, params, tokens, cache, **kw):
                if tokens.shape[1] > 1:       # the prefill: these rows
                    tokens = torch.as_tensor(prompts[rows],
                                             device=tokens.device)
                logits, cache = super()._apply_cached(params, tokens, cache,
                                                      **kw)
                keep(logits, cache)
                return logits, cache

        class RecordingEncDec(EncDecLM):
            def prefill(self, params, frames, tokens, cache, **kw):
                kept["frames"] = frames.cpu()
                return super().prefill(params, frames, tokens, cache, **kw)

            def _run_decoder_cached(self, params, tokens, cache, shard=None):
                logits, cache = super()._run_decoder_cached(params, tokens,
                                                            cache, shard)
                keep(logits, cache)
                return logits, cache

        def drawn_at_fan_in(init):
            def init_params(decls, gen, device):
                params = init(decls, gen, device)
                attention_at_fan_in(params, kept["cfg"])
                return params
            return init_params

        def recording(build):
            def build_model(cfg):
                kept["cfg"] = cfg
                return (RecordingEncDec if family == "encdec"
                        else Recording)(cfg)
            return build_model

        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(serve_mod, "build_model", recording))
            stack.enter_context(patched(serve_mod, "init_params",
                                        drawn_at_fan_in))
            stack.enter_context(cut_configs(serve_mod, shard_cut))
            if full.n_experts:
                stack.enter_context(record_routes(routes))
            if full.ssm_state:
                stack.enter_context(first_output(lm_mod, "mamba_block",
                                                 mamba0))
            out = serve_mod.serve_loop(arch, batch=len(rows),
                                       prompt_len=SHARD_PROMPT,
                                       gen_tokens=SHARD_GEN, seed=0,
                                       device="cuda")
        kv = kept.pop("kv")
        part = {"tokens": torch.as_tensor(out["tokens"]),
                "logits": torch.stack(steps), "routes": routes["cuda"]}
        if kv is not None:
            part.update(k=kv.k[[0, -1]].cpu(), v=kv.v[[0, -1]].cpu())
        if family == "encdec":
            cross = kept.pop("cross")
            part.update(frames=kept.pop("frames"),
                        cross_k=cross[0][[0, -1]].cpu(),
                        cross_v=cross[1][[0, -1]].cpu())
            del cross
        if full.ssm_state:
            part.update(mamba0=mamba0["out"], ssm={
                n: kept[n] for n in (FAULT_STEPS, SHARD_GEN - 1)})
        parts.append(part)
        del kv, out, kept
        gc.collect()
        torch.cuda.empty_cache()
    saved = {"prompts": torch.as_tensor(prompts),
             "tokens": torch.cat([p["tokens"] for p in parts]),
             "logits": torch.cat([p["logits"] for p in parts], dim=1),
             "routes": [p["routes"] for p in parts]}
    for name, dim in (("k", 1), ("v", 1), ("cross_k", 1), ("cross_v", 1),
                      ("frames", 0), ("mamba0", 0)):
        if name in parts[0]:
            saved[name] = torch.cat([p[name] for p in parts], dim=dim)
    if full.ssm_state:
        saved["ssm"] = {n: {field: torch.cat([p["ssm"][n][field]
                                              for p in parts], dim=1)
                            for field in parts[0]["ssm"][n]}
                        for n in parts[0]["ssm"]}
    torch.save(saved, path)


def _rel(got, want) -> float:
    """max |got - want| over max |want|; over an all-zero ``want`` (a span
    no token reached), 0 if ``got`` is zero too, else inf."""
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if diff != diff:                  # a NaN breaks the rule
        return float("inf")
    return diff / scale if scale else (0.0 if diff == 0 else float("inf"))


class _NoModelSum:
    """A layout whose ``reduce_sum`` skips the sum over the model axis (the
    planted faults "experts' sum over the model axis skipped" and
    "encoder's row-parallel wo sum skipped"), and whose ``gather`` puts
    this rank's part into zeros with no collective (the planted fault
    "memory K/V gather skipped")."""

    def __init__(self, layout):
        self.layout = layout

    def __getattr__(self, name):
        return getattr(self.layout, name)

    def reduce_sum(self, partial, dtype):
        return partial.to(dtype)

    def gather(self, *parts):
        out = []
        for t, dim, span in parts:
            shape = list(t.shape)
            shape[dim] = span.total
            full = t.new_zeros(shape)
            full.narrow(dim, span.start, span.size).copy_(t)
            out.append(full)
        return out


def _shard_faults(torch, which: str, params0: dict | None = None):
    """A context that plants one of the planted faults in this rank's
    modules. ``params0``: for the SSM's heads fault, the rank's parameter
    tree whose ``dt_bias``, ``A_log`` and ``D`` are swapped, in place while
    the context lasts, for those of model rank 0 (heads 0..H_loc-1)."""
    import importlib
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import lm as lm_mod
    from repro_torch.runtime import serve_lib
    moe_mod = importlib.import_module("repro_torch.models.moe")
    ssm_mod = importlib.import_module("repro_torch.models.ssm")

    def drop_rank0(merge):
        def faulty(out, lse, shard):
            if shard.mesh.coords["model"] == 0:
                out = torch.zeros_like(out)
                lse = torch.full_like(lse, float("-inf"))
            return merge(out, lse, shard)
        return faulty

    def write_everywhere(write):
        def faulty(cache, k, v, shard):
            row = (cache.length - shard.seq.start).clamp(
                0, shard.seq.size - 1).reshape(1).long()
            for buf, new in ((cache.k, k), (cache.v, v)):
                buf.index_copy_(1, row, new.to(buf.dtype))
        return faulty

    def span_moved(name, start):
        def wrap(layout_fn):
            def faulty(*args, **kw):
                layout = layout_fn(*args, **kw)
                span = getattr(layout, name)
                return dataclasses.replace(layout, **{
                    name: dataclasses.replace(span, start=start(span))})
            return faulty
        return wrap

    def no_expert_sum(local):
        def faulty(*args, shard=None, **kw):
            return local(*args, shard=_NoModelSum(shard), **kw)
        return faulty

    def slice_zero(block):
        # every Mamba sublayer's cache slice a view of slice 0 (read and
        # written in place there)
        def faulty(self, bp, x, *, cache=None, **kw):
            if cache is not None:
                cache = cache._replace(ssm=type(cache.ssm)(
                    *(a[:1].expand_as(a) for a in cache.ssm)))
            return block(self, bp, x, cache=cache, **kw)
        return faulty

    def no_memory_gather(cross_kv):
        def faulty(self, params, memory, cache, shard=None):
            return cross_kv(self, params, memory, cache, _NoModelSum(shard))
        return faulty

    def no_encoder_sum(attention):
        def faulty(params, x, cfg, *, causal=True, shard=None, **kw):
            if not causal and shard is not None:
                shard = _NoModelSum(shard)
            return attention(params, x, cfg, causal=causal, shard=shard,
                             **kw)
        return faulty

    def own_columns(norm_and_tail):
        def faulty(g, new_x, shard):
            _, x_full = norm_and_tail(g, new_x, shard)
            return g.square().mean(dim=-1, keepdim=True), x_full
        return faulty

    @contextlib.contextmanager
    def heads_from_rank0():
        mamba = params0["rank"]["layers"]["mamba"]
        saved = {n: mamba[n].clone() for n in ("dt_bias", "A_log", "D")}
        for n in saved:
            mamba[n].copy_(params0["rank0"]["layers"]["mamba"][n])
        try:
            yield
        finally:
            for n, a in saved.items():
                mamba[n].copy_(a)

    patches = {
        SHARD_FAULTS[0]: (attn_mod, "_merge_partials", drop_rank0),
        SHARD_FAULTS[1]: (attn_mod, "_write_token", write_everywhere),
        SHARD_FAULTS[2]: (serve_lib, "shard_layout", span_moved(
            "vocab", lambda s: (s.start + s.size) % s.total)),
        MOE_FAULTS[0]: (serve_lib, "shard_layout", span_moved(
            "experts", lambda s: 0)),
        MOE_FAULTS[1]: (moe_mod, "_moe_local", no_expert_sum),
        SSM_FAULTS[1]: (ssm_mod, "_norm_and_tail", own_columns),
        HYBRID_FAULTS[0]: (lm_mod.LM, "_hybrid_block", slice_zero),
        ENCDEC_FAULTS[0]: (encdec_mod.EncDecLM, "_cross_kv",
                           no_memory_gather),
        ENCDEC_FAULTS[1]: (encdec_mod, "attention", no_encoder_sum)}
    if which == SSM_FAULTS[0]:
        return heads_from_rank0()
    return patched(*patches[which])


@contextlib.contextmanager
def counting_all_reduce(torch, count: list):
    """Context: every ``torch.distributed.all_reduce`` call counted into
    ``count[0]``."""
    def wrap(all_reduce):
        def counted(*args, **kw):
            count[0] += 1
            return all_reduce(*args, **kw)
        return counted
    with patched(torch.distributed, "all_reduce", wrap):
        yield


def sharded_rank_run(torch, mesh, arch: str, ref_path: str,
                     zero3: bool = False) -> dict:
    """One rank's part of a sharded run of ``arch`` on ``mesh``: this
    rank's weights drawn from the unsharded model's seeded draw, its shard
    shapes (weights and cache) against the specs, a short warm-up, the
    counted pass (prefill, then 31 decode steps fed the reference's
    tokens; each decode step's all_reduce calls counted), and one pass
    under each of its planted faults (``shard_faults_of``: a prefill, or
    the counted pass's prefilled cache for a fault of the decode step, and
    ``FAULT_STEPS`` decode steps). Each pass is held to the reference:

    * every step's logits rel < 0.06; each token picked apart from the
      reference's a near-tie (the reference's gap between the two within
      twice the row's largest logit difference: bf16 logits near 5 are
      2^-5 apart, and many rows' top two are within one or two of those
      steps);
    * with a K/V cache (an encoder-decoder's fp32 self cache), this
      rank's span of the first and last layers' K/V rel < 0.06, rows the
      reference had not written yet zeros;
    * an encoder-decoder's memory K/V of the first and last layers, every
      KV head on every rank, rel < 0.06;
    * with an SSM cache, this rank's heads of the first and last layers'
      state (a hybrid's every Mamba sublayer) and their three conv tails
      (``conv_x`` every column) rel < 0.06, and the first Mamba block's
      output at the prefill rel < 0.06;
    * an arch with MoE layers: each call's own routing
      (``record_routes``, counted pass only) against the reference's
      (``routes_apart``): at most
      ``APART_MAX`` of the choices apart, each a near-tie. Its own-routing
      logits and K/V are printed, not held (ROADMAP C.2: a choice apart
      moves its token's next layer, and the logits, by a whole expert's
      output): the counted pass is followed by a pass fed the reference's
      routing (``routed_as``), held to the logits and K/V rules and, on
      the routing it computes beside the fed one, to ``routes_apart``'s
      (router logits within ``ROUTER_TOL``; the gates of the tokens that
      route alike within what their logits' difference accounts for,
      ``gate_excess`` <= 0, and, for the MoE family, within ``GATE_TOL``;
      a hybrid's absolute gate difference is printed: at jamba's router
      logits, ~7 at most, the rounding that ``ROUTER_TOL`` admits moves a
      gate by more than ``GATE_TOL``); its fault passes run fed.

    With ``zero3`` the rank holds its ZeRO-3 regions of the weights
    (``param_specs(..., zero3=True)``) and serves through the ZeRO-3 steps,
    its all_reduce calls a decode step ``shard_collectives``' with the
    gathers; after the counted pass its prefill and first decode step run
    again on its weights without ZeRO-3, and their logits must equal the
    counted pass's bit for bit (``zero3_bits``)."""
    import repro_torch.models.lm as lm_mod
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model, init_params
    from repro_torch.models.param import tree_at, tree_items
    from repro_torch.runtime import serve_lib
    from repro_torch.sharding.rules import local_shape
    from repro_torch.launch.serve import FRAMES_LEN
    ref = torch.load(ref_path)
    cfg = dataclasses.replace(shard_cut(get_config(arch)),
                              q_chunk=SHARD_PROMPT // 2,
                              kv_chunk=SHARD_PROMPT // 2,
                              max_cache_len=SHARD_MAX_LEN)
    family = cfg.family
    memory_len = FRAMES_LEN if family == "encdec" else None
    lm = build_model(cfg)
    B, S, T = SHARD_BATCH, SHARD_PROMPT, SHARD_MAX_LEN
    layout = serve_lib.shard_layout(lm, mesh, B, T)
    specs = serve_lib.param_specs(lm, mesh, zero3=zero3)
    t0 = time.perf_counter()

    def draw(specs):
        params = init_params(lm.param_decls(),
                             torch.Generator(device="cuda").manual_seed(0),
                             "cuda", specs=specs, mesh=mesh)
        attention_at_fan_in(params, cfg)
        return params
    params = draw(specs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    decls = dict(tree_items(lm.param_decls()))
    shape_faults = []
    for path, a in tree_items(params):
        want = local_shape(tree_at(specs, path), decls[path].shape, mesh)
        if tuple(a.shape) != want:
            shape_faults.append(("/".join(path), tuple(a.shape), want))
    cache_specs = serve_lib.cache_specs(lm, mesh, B, T)
    cache_shapes = {
        path: local_shape(tree_at(cache_specs, path), tuple(a.shape), mesh)
        for path, a in tree_items(serve_lib.abstract_cache(
            lm, B, T, filled=False, memory_len=memory_len)) if a is not None}
    weights = sum(a.numel() * a.element_size() for _, a in tree_items(params))
    prompts = ref["prompts"].cuda()
    tokens = ref["tokens"].cuda()
    # an encoder-decoder's prefill takes the reference's seeded frames
    inputs = (ref["frames"].cuda(),) if family == "encdec" else ()
    span, b = layout.seq, layout.batch.slice()
    d = mesh.coords["data"]
    counters = kernel_counters()
    params0 = None
    if family == "ssm":
        # model rank 0's heads, for the planted heads fault
        rank0 = Mesh(tuple(mesh.shape.values()), tuple(mesh.shape),
                     coords={**mesh.coords, "model": 0})
        params0 = {"rank": params, "rank0": init_params(
            lm.param_decls(), torch.Generator(device="cuda").manual_seed(0),
            "cuda", specs=specs, mesh=rank0)}
    snapshot = {}

    def run_pass(steps: int, prefill_first: bool = True,
                 keep: bool = False, resume: bool = False,
                 count: list | None = None, params=params,
                 zero3: bool = zero3):
        """``steps`` decode steps after a prefill (``prefill_first``), or
        from the kept K/V cache and prefill logits (``resume``); ``keep``
        keeps them after this pass's prefill; ``count`` counts the decode
        steps' all_reduce calls; ``params`` and ``zero3``: the weights and
        the steps (the run's by default)."""
        cache = serve_lib.init_cache_shards(lm, mesh, B, T, device="cuda",
                                            memory_len=memory_len)
        for path, a in tree_items(cache):
            if a is not None and tuple(a.shape) != cache_shapes[path]:
                shape_faults.append(("/".join(path), tuple(a.shape),
                                     cache_shapes[path]))
        prefill = serve_lib.build_prefill_step(lm, mesh, B, S, T,
                                               zero3=zero3)
        decode = serve_lib.build_decode_step(lm, mesh, B, T, zero3=zero3)
        torch.cuda.reset_peak_memory_stats()
        mamba0 = {}
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = []
            if resume:
                cache.kv.k.copy_(snapshot["k"])
                cache.kv.v.copy_(snapshot["v"])
                cache.kv.length.copy_(snapshot["length"])
                out.append(snapshot["logits"])
            elif prefill_first:
                with first_output(lm_mod, "mamba_block", mamba0):
                    logits, cache = prefill(params, *inputs, prompts, cache)
                out.append(logits[:, -1])
                if keep and getattr(cache, "kv", None) is not None:
                    snapshot.update(k=cache.kv.k.clone(), v=cache.kv.v.clone(),
                                    length=cache.kv.length.clone(),
                                    logits=logits[:, -1].clone())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with counting_all_reduce(torch, count) if count is not None \
                    else contextlib.nullcontext():
                for i in range(steps):
                    logits, cache = decode(params, tokens[:, i:i + 1], cache)
                    out.append(logits[:, -1])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        times = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                 "decode_tok_per_s": B * steps / max(t2 - t1, 1e-9),
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        return times, out, cache, mamba0.get("out")

    def rules(out: list, cache, steps: int, mamba0=None) -> dict:
        """The pass's readings against the reference's after as many
        steps, and the rules they break (``broken``)."""
        errs = [_rel(got.cpu(), want) for got, want in
                zip(out, ref["logits"])]
        # picks apart: (step, row, the reference's gap between its top
        # logit and its logit at this run's pick, the row's largest logit
        # difference); a near-tie when the gap is within twice it
        apart = []
        for step, (got, want) in enumerate(zip(out, ref["logits"])):
            got = got.cpu().float()
            top, pick = want.argmax(-1), got.argmax(-1)
            for row in (top != pick).nonzero().flatten().tolist():
                gap = float(want[row, top[row]] - want[row, pick[row]])
                diff = float((got[row] - want[row]).abs().max())
                apart.append((step, row, gap, diff))
        res = {"max_rel": max(errs), "apart": apart[:8],
               "n_apart": len(apart), "picks": len(out) * B}
        broken = []
        if max(errs) >= MODEL_TOL:
            broken.append("logits")
        if not all(gap <= 2 * diff for _, _, gap, diff in apart):
            broken.append("picks apart near-ties")
        rows = S + steps          # K/V rows written after the pass
        kv = _kv_of(cache)
        if kv is not None:
            kv_errs = []          # first layer, last layer
            for buf, want in ((kv.k, ref["k"]), (kv.v, ref["v"])):
                whole = torch.zeros(want.shape[:2] + (T,) + want.shape[3:],
                                    dtype=want.dtype)
                whole[:, :, :rows] = want[:, :, :rows]
                got = buf[[0, -1]].cpu()
                kv_errs.append([_rel(got[i], whole[i, b, span.slice()])
                                for i in (0, 1)])
            res["kv_rel"] = [max(k, v) for k, v in zip(*kv_errs)]
            if max(res["kv_rel"]) >= MODEL_TOL:
                broken.append("K/V")
        if family == "encdec":
            res["cross_rel"] = [max(
                _rel(cache.cross_k[i].cpu(), ref["cross_k"][j][b]),
                _rel(cache.cross_v[i].cpu(), ref["cross_v"][j][b]))
                for j, i in enumerate((0, -1))]
            if max(res["cross_rel"]) >= MODEL_TOL:
                broken.append("memory K/V")
        if getattr(cache, "ssm", None) is not None:
            heads = layout.ssm_heads.slice()
            want = ref["ssm"][steps]
            got = _ssm_snapshot(cache)
            res["ssm_rel"] = {
                field: [_rel(got[field][i], want[field][i][b][
                    (slice(None), heads) if field == "state" else ()])
                        for i in range(len(got[field]))] for field in got}
            # numpy: a tensor would cross the queue by a handle into
            # the rank's memory, gone once the rank exits
            res["conv_x"] = got["conv_x"].numpy()
            res["mamba0_rel"] = _rel(mamba0, ref["mamba0"][b])
            if max(max(v) for v in res["ssm_rel"].values()) >= MODEL_TOL:
                broken.append("SSM cache")
            if res["mamba0_rel"] >= MODEL_TOL:
                broken.append("the first Mamba block's output")
        res["broken"] = broken
        return res

    def routing_rules(res: dict, own: list, fed: bool) -> None:
        """Each MoE call's routing against the reference's (its data
        shard's), into ``res``; at most ``APART_MAX`` of the choices
        apart, each a near-tie, and, fed, the gates and router logits
        alike."""
        want = ref["routes"][d]
        if len(own) != len(want):
            res["broken"].append(f"{len(own)} MoE calls, want {len(want)}")
            return
        calls = [routes_apart(a, g) for a, g in zip(want, own)]
        apart = sum(c["apart"] for c in calls)
        choices = sum(c["choices"] for c in calls)
        res.update(routes_apart=apart, routes_choices=choices,
                   routes_excess=max(c["excess"] for c in calls),
                   gate_err=max(c["gate_err"] for c in calls),
                   gate_excess=max(c["gate_excess"] for c in calls),
                   router_rel=max(_rel(g[2], a[2])
                                  for a, g in zip(want, own)))
        held = [("routes apart", apart <= APART_MAX * choices),
                ("routes near-ties", res["routes_excess"] <= 0)]
        if fed:
            held += [("gates", res["gate_excess"] <= 0 and (
                family == "hybrid" or res["gate_err"] < GATE_TOL)),
                     ("router logits", res["router_rel"] < ROUTER_TOL)]
        res["broken"] += [name for name, ok in held if not ok]

    fed_runs = bool(cfg.n_experts)

    def feeding(own: list):
        return routed_as(ref["routes"][d], own) if fed_runs \
            else contextlib.nullcontext()

    # warm-up: two decode steps on an empty cache (the prefill's first
    # call is in its timed pass)
    run_pass(2, prefill_first=False)
    for k in counters.values():
        k.launches = 0
    count = [0]
    routes = {"cuda": []}
    with record_routes(routes) if fed_runs else contextlib.nullcontext():
        times, out, cache, mamba0 = run_pass(SHARD_GEN - 1, keep=True,
                                             count=count)
    launches = {name: k.launches for name, k in counters.items()}
    counted = rules(out, cache, SHARD_GEN - 1, mamba0)
    if fed_runs:
        routing_rules(counted, routes["cuda"], fed=False)
    if fed_runs:
        # own-routing logits and K/V printed, not held: a choice apart at a
        # near-tie moves its token's next layer by a whole expert's output
        # (ROADMAP C.2); held fed the reference's routing below
        counted["own_logits_broken"] = [
            r for r in counted["broken"]
            if r in ("logits", "K/V", "picks apart near-ties", "SSM cache",
                     "the first Mamba block's output")]
        counted["broken"] = [r for r in counted["broken"]
                             if r not in counted["own_logits_broken"]]
    if zero3:
        # the same mesh without ZeRO-3: its prefill and first decode step
        shards = draw(serve_lib.param_specs(lm, mesh))
        _, plain, _, _ = run_pass(1, params=shards, zero3=False)
        counted["zero3_bits"] = {
            "equal": [bool(torch.equal(a, b)) for a, b in zip(out, plain)],
            "shard_gib": sum(a.numel() * a.element_size()
                             for _, a in tree_items(shards)) / 2**30}
        del shards, plain
    result = {"coords": dict(mesh.coords), "family": family,
              "layers": cfg.n_layers, "want_launches": shard_launches(
                  cfg, SHARD_GEN - 1),
              "want_collectives": shard_collectives(
                  cfg, tuple(mesh.shape.values()) if zero3 else None),
              "span": None if span is None else (span.start, span.size),
              "init_s": init_s, "weights_gib": weights / 2**30,
              "launches": launches, "collectives_a_step":
                  count[0] / (SHARD_GEN - 1), **times, **counted}
    del out, cache
    if fed_runs:
        own = []
        with feeding(own):
            _, out, cache, mamba0 = run_pass(SHARD_GEN - 1)
        fed = rules(out, cache, SHARD_GEN - 1, mamba0)
        routing_rules(fed, own, fed=True)
        result["fed"] = fed
        del out, cache
    faults = {}
    for which in shard_faults_of(arch, family, tuple(mesh.shape.values())):
        with _shard_faults(torch, which, params0), feeding([]):
            _, out, cache, mamba0 = run_pass(
                FAULT_STEPS, resume=which in DECODE_ONLY_FAULTS)
            faults[which] = rules(out, cache, FAULT_STEPS, mamba0)
        del out, cache
    result["faults"] = faults
    result["shape_faults"] = shape_faults
    return result


def _shard_rank(rank: int, runs: tuple, mesh_shape: tuple, backend: str,
                init_file: str, queue) -> None:
    """Entry of a spawned rank: its process group (``backend`` over a
    ``file://`` rendezvous), its mesh, each of ``runs`` ((arch, reference
    path); ``TRAIN_RUN``:arch for an arch's sharded training run,
    ``TRAIN3_RUN``:arch its ZeRO-3 run, ``ZERO3_RUN``:arch its ZeRO-3
    serving run) one
    after another, its card memory released between them, and
    ``(rank, {arch: result} or the traceback)`` on ``queue``."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        data, model = mesh_shape
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=data * model, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(data, model)
        results = {}
        for arch, ref_path in runs:
            kind, _, named = arch.partition(":")
            if kind == TRAIN_RUN and named:
                results[arch] = sharded_train_rank_run(
                    torch, mesh, named, ref_path,
                    dict(SHARD_TRAIN[mesh_shape])[named])
            elif kind == TRAIN3_RUN:
                results[arch] = sharded_train_rank_run(
                    torch, mesh, named, ref_path, True, zero3=True)
            elif kind == ZERO3_RUN:
                results[arch] = sharded_rank_run(torch, mesh, named,
                                                 ref_path, zero3=True)
            else:
                results[arch] = sharded_rank_run(torch, mesh, arch, ref_path)
            gc.collect()
            torch.cuda.empty_cache()
        queue.put((rank, results))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(mesh_shape: tuple, backend: str, runs: tuple) -> dict:
    """Each rank of the mesh in a process of its own (start method
    ``spawn``), all on the one card, serving ``runs`` one after another;
    every rank joined with a timeout. A rank that fails, hangs or exits
    nonzero fails the run."""
    import multiprocessing
    import queue as queue_mod
    import tempfile
    ctx = multiprocessing.get_context("spawn")
    results = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out = ctx.Queue()
        n = mesh_shape[0] * mesh_shape[1]
        procs = [ctx.Process(target=_shard_rank, args=(
            r, runs, mesh_shape, backend, os.path.join(tmp, "rendezvous"),
            out)) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + SHARD_JOIN_S
        try:
            # until every rank has reported, the time is up, or a rank has
            # died without reporting
            while len(results) < n and time.perf_counter() < deadline:
                try:
                    rank, res = out.get(timeout=5.0)
                    results[rank] = res
                except queue_mod.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs) or \
                            all(p.exitcode is not None for p in procs):
                        break
        finally:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.perf_counter()))
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = {r: res for r, res in results.items() if isinstance(res, str)}
    codes = [p.exitcode for p in procs]
    if failed or len(results) < n or any(codes):
        raise AssertionError(f"{[a for a, _ in runs]} on {mesh_shape} "
                             f"({backend}): ranks {sorted(results)} of {n} "
                             f"reported, exit codes {codes}; failures: "
                             f"{failed}")
    return results


def _rank_line(res: dict) -> str:
    """One rank's readings of a counted pass, for the log."""
    text = (f"logits max rel {res['max_rel']:.4f}, picks apart "
            f"{res['n_apart']} of {res['picks']} (step, row, gap, largest "
            f"difference: {res['apart']})")
    if "kv_rel" in res:
        text += f", K/V rel (first, last layer) {res['kv_rel']}"
    if "cross_rel" in res:
        text += f", memory K/V rel (first, last layer) {res['cross_rel']}"
    if "ssm_rel" in res:
        text += (f", SSM cache rel (first, last layer; a hybrid's each "
                 f"Mamba sublayer) {res['ssm_rel']}, the first Mamba "
                 f"block's output rel {res['mamba0_rel']:.4f}")
    if "routes_apart" in res:
        text += (f", routes apart {res['routes_apart']} of "
                 f"{res['routes_choices']} (<= {APART_MAX}), excess "
                 f"{res['routes_excess']:.3e} (<= 0), gates "
                 f"{res['gate_err']:.3e} (excess over half the logits' "
                 f"difference {res['gate_excess']:.3e}, <= 0), router "
                 f"logits rel {res['router_rel']:.4f}")
    return text + f"; broken: {res['broken'] or 'none'}"


def sharded_serve_check(torch) -> dict:
    """``sharded_serve_check``: every family served over a (data, model)
    mesh through ``runtime/serve_lib.py``, at full width (``SHARD_GROUPS``,
    one spawn a mesh): tinyllama-1.1b at 8 of its 22 layers at (1, 1)
    under NCCL and at (1, 2) under gloo; under gloo at (1, 2),
    starcoder2-15b at 4 of its 40 layers (G = 12, D = 128, 2 of its 4 KV
    heads and 24576 of its 49152 vocab rows a rank), qwen2-vl-72b at 2 of
    80 (its tokens path, 1-D RoPE; 32 q and 4 KV heads a rank),
    qwen3-moe-235b-a22b at 1 of 94 (64 of 128 experts a rank; also at (2,
    2)), kimi-k2-1t-a32b at 1 of 61 (192 of 384 experts and 1024 of the
    shared expert's 2048 hidden units a rank) and mamba2-370m at 6 of 48
    (16 of 32 heads a rank through ``ssd``; its tied head, 25140 of 50280
    vocab rows a rank), jamba-1.5-large-398b cut to one super-block of
    period 4 (32 q and 4 KV heads, 8 of 16 experts, 128 of 256 SSM heads,
    12288 of 24576 MLP units and 32768 of 65536 vocab rows a rank) and
    seamless-m4t-large-v2 at 6 + 6 of its 24 + 24 layers over 1024
    seeded frames (8 of 16
    q and KV heads, 4096 of 8192 MLP units, 128103 of 256206 vocab rows a
    rank; the memory K/V whole on each). Several ranks share the one card:
    their times are of processes on one card over gloo's host-staged
    transport, not a multi-card figure.

    For each arch the unsharded ``serve_loop`` of the same cut model first
    gives the reference (an MoE arch at a data axis of 2: each data
    shard's rows served alone, as the reference's capacity is a data
    shard's), with the attention weights at fan-in std on both sides (at
    the reference's draw the softmax saturates and any other order of the
    sums moves the logits, as ``model_check`` finds), written to disk and
    its card memory released; then the ranks run (``sharded_rank_run``):
    its rules on every rank, the shard shapes the specs give; the counted
    pass's launches (``shard_launches``) and all_reduce calls a decode
    step (``shard_collectives``), each as predicted; each planted fault
    (``shard_faults_of``) must break a rule on some rank. The decode
    crosses rank 0's span into rank 1's at a model axis of 2; ``conv_x``
    must be equal on the model ranks of a data shard. Returns the partial
    decode's and ssd's launches over every counted pass, in all, and every
    kernel's by arch (``"by_arch"``).

    A mesh of ``SHARD_TRAIN`` also runs its archs' sharded training in its
    spawn, after its serving runs: each arch's unsharded step's reference
    first (``sharded_train_reference``, once an arch), then each rank's
    run (``sharded_train_rank_run``), held by ``sharded_train_check``; the
    kernels' launches over every rank and mesh go under ``"train"``, by
    arch. ZeRO-3 (the (2, 2) spawn): ``SHARD_ZERO3_SERVE``'s archs served
    and ``SHARD_TRAIN_ZERO3``'s trained again over ZeRO-3 regions, against
    the same references, after the mesh's other runs."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    launched = {"decode_attention_partial": 0, "ssd": 0, "by_arch": {},
                "train": {}}
    refs = {}
    train_paths = {arch: ROOT / "build" / f"sharded-train-reference-{arch}.pt"
                   for arch in [a for runs in SHARD_TRAIN.values()
                                for a, _ in runs]
                   + [a for archs in SHARD_TRAIN_ZERO3.values()
                      for a in archs]}
    for path in train_paths.values():
        path.unlink(missing_ok=True)
    ckpt_cleanup()
    for mesh_shape, backend, archs in SHARD_GROUPS:
        data, model = mesh_shape
        runs = []
        zero3_served = SHARD_ZERO3_SERVE.get(mesh_shape, ())
        for arch in tuple(archs) + tuple(zero3_served):
            shards = data if get_config(arch).n_experts else 1
            path = ROOT / "build" / f"sharded-reference-{arch}-{shards}.pt"
            if path not in refs.values():
                t0 = time.perf_counter()
                sharded_reference(torch, arch, path, shards)
                refs[arch, shards] = path
                log(f"[sharded] {arch}: unsharded serve_loop reference "
                    f"({shards} data shard{'s' if shards > 1 else ''}) in "
                    f"{time.perf_counter() - t0:.1f} s")
            # a ZeRO-3 run against the same reference as the arch's others
            runs.append((arch if arch in archs else f"{ZERO3_RUN}:{arch}",
                         str(path)))
        trained = [(f"{TRAIN_RUN}:{arch}", arch)
                   for arch, _ in SHARD_TRAIN.get(mesh_shape, ())] + [
            (f"{TRAIN3_RUN}:{arch}", arch)
            for arch in SHARD_TRAIN_ZERO3.get(mesh_shape, ())]
        for name, arch in trained:
            path = train_paths[arch]
            if not path.exists():
                t0 = time.perf_counter()
                sharded_train_reference(torch, arch, path)
                log(f"[sharded-train] {arch}: unsharded train step "
                    f"reference in {time.perf_counter() - t0:.1f} s, "
                    f"{path.stat().st_size / 1e9:.2f} GB on disk")
            runs.append((name, str(path)))
        t0 = time.perf_counter()
        results = spawn_ranks(mesh_shape, backend, tuple(runs))
        wall = time.perf_counter() - t0
        label = ("one process, NCCL" if backend == "nccl" else
                 f"{data * model} processes sharing one card over gloo's "
                 f"host-staged transport, not a multi-card figure")
        served = list(archs) + [f"{ZERO3_RUN}:{a}" for a in zero3_served]
        for arch in served:
            for rank, res in sorted((r, res[arch])
                                    for r, res in results.items()):
                if "zero3_bits" in res:
                    log(f"[sharded] {arch} mesh {mesh_shape} rank {rank}: "
                        f"weights {res['weights_gib']:.3f} GiB a rank (ZeRO-3"
                        f" regions) against {res['zero3_bits']['shard_gib']:.3f}"
                        f" GiB without ZeRO-3; the prefill's and the first "
                        f"decode step's logits bit-equal to the same mesh's "
                        f"steps without ZeRO-3: "
                        f"{res['zero3_bits']['equal']} (must be both)")
                    if res["zero3_bits"]["equal"] != [True, True]:
                        res["broken"].append("ZeRO-3 logits bit-equal")
                log(f"[sharded] {arch} ({res['layers']} layers) mesh "
                    f"{mesh_shape} "
                    f"({label}) rank {rank} {res['coords']} span "
                    f"{res['span']}: weights {res['weights_gib']:.2f} GiB "
                    f"(drawn in {res['init_s']:.1f} s), prefill "
                    f"{res['prefill_s']:.4f} s, decode {res['decode_s']:.4f} "
                    f"s ({res['decode_tok_per_s']:.1f} tok/s, "
                    f"{res['collectives_a_step']:.1f} all_reduce calls a "
                    f"step), peak {res['peak_gib']:.2f} GiB; "
                    f"{_rank_line(res)}; launches {res['launches']}")
                if "own_logits_broken" in res:
                    log(f"[sharded] {arch} rank {rank}: own-routing logits "
                        f"and K/V printed, not held (ROADMAP C.2): break "
                        f"{res['own_logits_broken'] or 'none'}; fed the "
                        f"reference's routing: {_rank_line(res['fed'])}")
                want = {name: 0 for name in res["launches"]}
                want.update(res["want_launches"])
                if res["launches"] != want:
                    raise AssertionError(f"{arch} {mesh_shape} rank {rank} "
                                         f"launches {res['launches']}: want "
                                         f"{want}")
                if res["collectives_a_step"] != res["want_collectives"]:
                    raise AssertionError(
                        f"{arch} {mesh_shape} rank {rank}: "
                        f"{res['collectives_a_step']} all_reduce calls a "
                        f"decode step, want {res['want_collectives']}")
                broken = res["broken"] + res.get("fed", {}).get("broken", [])
                if broken or res["shape_faults"]:
                    raise AssertionError(
                        f"{arch} {mesh_shape} rank {rank}: rules broken "
                        f"{broken}, shapes {res['shape_faults']} ({res})")
                by_arch = launched["by_arch"].setdefault(arch, {})
                for name, n in res["launches"].items():
                    by_arch[name] = by_arch.get(name, 0) + n
                for name in ("decode_attention_partial", "ssd"):
                    launched[name] += res["launches"][name]
            for which in results[0][arch]["faults"]:
                got = {r: res[arch]["faults"][which]
                       for r, res in results.items()}
                broke = [r for r, f in got.items() if f["broken"]]
                log(f"[sharded] {arch} {mesh_shape} planted fault '{which}': "
                    f"breaks a rule on ranks {broke} ("
                    + "; ".join(f"rank {r}: {_rank_line(f)}"
                                for r, f in sorted(got.items())) + ")")
                if not broke:
                    raise AssertionError(f"{arch} {mesh_shape}: the planted "
                                         f"fault '{which}' broke no rule")
            spans = [res[arch]["span"] for res in results.values()]
            # the decode steps write rows 512-542: some span must start there
            if model > 1 and spans[0] is not None and not any(
                    SHARD_PROMPT < s[0] <= SHARD_PROMPT + SHARD_GEN - 2
                    for s in spans):
                raise AssertionError(f"{arch} {mesh_shape}: the decode "
                                     f"crossed no span boundary")
            # conv_x: the same whole tail on the model ranks of a data shard
            for r, res in results.items():
                conv_x = res[arch].get("conv_x")
                first = results[r - r % model][arch].get("conv_x")
                if conv_x is not None and not (conv_x == first).all():
                    raise AssertionError(f"{arch} {mesh_shape}: rank {r}'s "
                                         f"conv_x differs from rank "
                                         f"{r - r % model}'s")
        peaks = {}
        for name, arch in trained:
            counts = sharded_train_check(torch, mesh_shape, arch, {
                r: res[name] for r, res in results.items()}, peaks)
            mine = launched["train"].setdefault(arch, {})
            for kernel, n in counts.items():
                mine[kernel] = mine.get(kernel, 0) + n
        if mesh_shape == CKPT_SAVE_AT:
            ckpt_directory_check(torch)
        log(f"[sharded] mesh {mesh_shape} ({backend}): "
            f"{[a for a, _ in runs]} in one spawn, {wall:.1f} s")
        # a training reference no later mesh reads leaves the disk
        later = {arch for m, _, _ in SHARD_GROUPS[
            [g[0] for g in SHARD_GROUPS].index(mesh_shape) + 1:]
            for arch in [a for a, _ in SHARD_TRAIN.get(m, ())]
            + list(SHARD_TRAIN_ZERO3.get(m, ()))}
        for arch, path in train_paths.items():
            if arch not in later:
                path.unlink(missing_ok=True)
    for path in list(refs.values()) + list(train_paths.values()):
        path.unlink(missing_ok=True)
    ckpt_cleanup()
    log(f"[sharded] sharded_serve_check phase in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched


# ------------------------------------------------------ sharded training
# Each arch at full width, cut to ``SHARD_TRAIN_LAYERS``, trained over a
# (data, model) mesh through ``build_train_step(..., mesh=)``: one batch of
# 8 x 512 tokens, remat "full", the attention weights at fan-in std
# (``attention_at_fan_in``): tinyllama-1.1b (dense) and mamba2-370m at
# their sharded serving depth (``SHARD_LAYERS``); qwen2-vl-72b (16 vision
# embeddings a row and Qwen2-VL's 3-D positions, ``qwen2vl_positions``)
# and qwen3-moe-235b-a22b (fed the unsharded step's experts,
# ``experts_as``) at one layer: a rank of (1, 2) holds 16.8 or 18.7 GB of
# state, 3.4 or 3.7 GB of gradients and ~5 GB of activations (derived), so
# two share the card; a qwen3-moe rank of (2, 2) would add the gradients'
# 7.5 GB fp32 sum over the data axis to its 11.2 GB of ZeRO-1 state, ~27 GB,
# and four would not fit it
SHARD_TRAIN_ARCH = "tinyllama-1.1b"
SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ = 8, 512
SHARD_TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# seamless-m4t-large-v2 (both stacks) at its sharded serving depth, 6 + 6
# of 24 + 24 layers (0.80 B parameters, 12.8 GB of training state, 6.4 GB
# a rank at (1, 2), derived), over FRAMES_LEN frames a row. jamba's full
# width does not train on the card: one period-4 block is 276 GB of state
# (138 GB a rank at (1, 2)), so its run takes its reduced config cut to one
# block of period 4 (``one_block``: d_model 64, 4 heads over 2 KV heads, 8
# SSM heads of P = 16, N = 16, 8 experts top-2), fed the unsharded step's
# experts; its sublayers at full width are each held on the card by
# another family's run: the attention at G = 8, D = 128 by qwen2-vl's,
# Mamba-2 at P = 64, N = 128 by mamba2's, the MoE by qwen3-moe's
SHARD_TRAIN_LAYERS = {SHARD_TRAIN_ARCH: SHARD_LAYERS[SHARD_TRAIN_ARCH],
                      QWEN2VL_ARCH: 1, MOE_ARCH: 1,
                      "mamba2-370m": SHARD_LAYERS["mamba2-370m"],
                      SEAMLESS_ARCH: SHARD_LAYERS[SEAMLESS_ARCH]}
# (data, model) -> its runs, (arch, zero1), each in the mesh's spawn of
# ``SHARD_GROUPS`` under the name ``TRAIN_RUN``:arch
SHARD_TRAIN = {(1, 2): ((SHARD_TRAIN_ARCH, False), (QWEN2VL_ARCH, False),
                        (MOE_ARCH, False), ("mamba2-370m", False),
                        (SEAMLESS_ARCH, False), (JAMBA_ARCH, False)),
               (2, 2): ((SHARD_TRAIN_ARCH, True), ("mamba2-370m", True))}
# the sharded checkpoint check: this arch's (1, 2) run saves its state
# after the checked step (``CKPT_SAVE_AT``), its (2, 2) ZeRO-1 run restores
# it (``CKPT_RESTORE_AT``); the (1, 2) ranks also keep their shards on
# disk, from which the check assembles the whole state on its own
CKPT_ARCH, CKPT_SAVE_AT, CKPT_RESTORE_AT = "mamba2-370m", (1, 2), (2, 2)
# (data, model) -> the archs trained again with ZeRO-3 in its spawn, after
# its ``SHARD_TRAIN`` runs, each held to the same rules against the same
# reference, its launches equal to its ZeRO-1 run's and its state bytes to
# the ZeRO-3 specs' local shapes; the ``CKPT_ARCH`` run restores the
# checkpoint into its regions too (under the name ``TRAIN3_RUN``:arch)
SHARD_TRAIN_ZERO3 = {(2, 2): (SHARD_TRAIN_ARCH, "mamba2-370m")}
# (data, model) -> the archs served with ZeRO-3 in its spawn (under the name
# ``ZERO3_RUN``:arch), held to the sharded serving rules against the same
# unsharded reference, and its prefill and first decode step bit-equal to
# the same mesh's steps without ZeRO-3
SHARD_ZERO3_SERVE = {(2, 2): ("tinyllama-1.1b",)}
CKPT_DIR = ROOT / "build" / "sharded-ckpt"
# the runs whose parameters are cast to fp32 (the CPU tests' fp32 cases
# do the same), through the kernels' fp32 entries: jamba's reduced block,
# whose unsharded bf16 step stands a few hundredths of a leaf's norm from
# its own fp32 step at d_model 64 (``tools/sharded_grad_floor.py``), so
# that a sharded bf16 step, rounding in another order, cannot be held to
# it within the gradient rule; the full-width runs hold it in bf16
SHARD_TRAIN_FP32 = (JAMBA_ARCH,)
TRAIN_RUN = "train"
TRAIN3_RUN = "train-zero3"
ZERO3_RUN = "zero3"
# steps timed after the checked one, on the state it leaves (the checked
# step's time holds each rank's first-call costs)
TRAIN_TIMED_STEPS = 1
TRAIN_FAULTS = ("enter's backward sum skipped at the attention input",
                "global norm over the rank's own shards",
                "data-axis gradient sum skipped",
                "ZeRO-1 gather of the updated slices skipped")
# the planted faults of each mesh's run: the model axis's two at (1, 2),
# the data axis's two at (2, 2)
TRAIN_FAULTS_AT = {(1, 2): TRAIN_FAULTS[:2], (2, 2): TRAIN_FAULTS[2:]}
# the vlm, MoE and SSM families' planted faults in sharded training; the
# card plants the MoE's first and last and the SSM's two at (1, 2), the
# CPU tests every one (the aux loss's at a data axis of 2)
MOE_TRAIN_FAULTS = ("gates enter the experts' region without their "
                    "model-axis sum",
                    "aux loss over the rank's own rows",
                    "tokens enter the experts' region without their "
                    "model-axis sum")
SSM_TRAIN_FAULTS = ("gated norm's mean square with an identity backward",
                    "w_B and w_C left out of the partial leaves")
VLM_TRAIN_FAULTS = ("mrope_positions cut on axis 0, as a (B, 3, S) leaf",)
FAMILY_TRAIN_FAULTS = MOE_TRAIN_FAULTS + SSM_TRAIN_FAULTS + VLM_TRAIN_FAULTS
# the hybrid and encoder-decoder families' (the card plants each in its
# arch's (1, 2) run; the CPU tests the encoder's where a rank holds two KV
# heads)
HYBRID_TRAIN_FAULTS = ("Mamba sublayers' gated norm summed over the "
                       "rank's own columns",)
ENCDEC_TRAIN_FAULTS = ("cross-attention's row-parallel wo sum skipped",
                       "encoder's K/V heads rolled by one within the "
                       "rank's")
# ZeRO-3's (the card plants the first two in tinyllama's (2, 2) ZeRO-3
# run, the CPU tests all three)
ZERO3_FAULTS = ("ZeRO-3 gather without its all_reduce: the rank's own "
                "regions, zeros elsewhere",
                "ZeRO-3 gather's backward keeps the rank's unsummed "
                "gradient",
                "ZeRO-3 regions written at the other data rank's slices")
FAMILY_TRAIN_FAULTS_AT = {(MOE_ARCH, (1, 2)): (MOE_TRAIN_FAULTS[0],
                                               MOE_TRAIN_FAULTS[2]),
                          ("mamba2-370m", (1, 2)): SSM_TRAIN_FAULTS,
                          (JAMBA_ARCH, (1, 2)): HYBRID_TRAIN_FAULTS,
                          (SEAMLESS_ARCH, (1, 2)): ENCDEC_TRAIN_FAULTS}


def train_faults_of(arch: str, mesh_shape: tuple,
                    zero3: bool = False) -> tuple:
    """The planted faults of ``arch``'s sharded training run on the card at
    ``mesh_shape`` (its ZeRO-3 run's: ``ZERO3_FAULTS``' first two, in the
    dense arch's)."""
    if zero3:
        return ZERO3_FAULTS[:2] if arch == SHARD_TRAIN_ARCH else ()
    if arch == SHARD_TRAIN_ARCH:
        return TRAIN_FAULTS_AT[mesh_shape]
    return FAMILY_TRAIN_FAULTS_AT.get((arch, mesh_shape), ())
# Adam's first step moves each weight by lr g / (|g| + eps) of its clipped
# gradient g: +-lr wherever |g| >> eps, whatever its size. So an element
# whose gradient is off the reference's by more than half its size (its
# sign flipped, among them), or whose clipped gradient is within
# UPDATE_EPS_FLOOR eps of 0 (where the move is short of lr and follows the
# gradient's rounding), moves otherwise under a rounding of the gradient
# that the gradient rule admits: a tie. The update rule holds the other
# elements of each leaf within TRAIN_GRAD_TOL of their norm, and the ties
# to the elements that the gradient rule lets tie: those whose reference
# gradient is under twice the rule's error an element
# (TRAIN_GRAD_TOL ||g|| / sqrt(n)), or under the eps floor
UPDATE_EPS_FLOOR = 100
# the sharded AdamW fed the reference's gradients: its update against the
# reference's arithmetic at the norm the sharded AdamW took, each leaf
# relative to the reference's update norm; that norm against the
# reference's within FED_NORM_TOL. (Held against the unsharded step's own
# update, whose norm sums the squares in another order, a qwen3-moe rank's
# 1.87 B parameters read over FED_TOL: that norm's last bit moves a few
# hundred bf16 weights across a rounding boundary.)
FED_TOL = 1e-5
FED_NORM_TOL = 1e-6


def update_rule(torch, got, want, grad, ref_grad,
                floor: float = 0.0) -> tuple[float, int, int]:
    """A leaf's update ``got`` against the reference's ``want``, their
    gradients ``grad`` and ``ref_grad``: (||got - want|| / ||want|| over
    the elements that are not ties, the number of ties, the number the
    gradient rule admits). A tie is an element whose gradient is off the
    reference's by more than half the reference's, or whose reference
    gradient is under ``floor`` (``update_floor``) and not equal to its
    own; the rule admits the elements whose reference gradient is under
    twice ``TRAIN_GRAD_TOL`` ||ref_grad|| / sqrt(n), or under ``floor``."""
    per = 2 * TRAIN_GRAD_TOL * float(ref_grad.float().norm()) \
        / ref_grad.numel() ** 0.5
    num, den, ties, admitted = update_sums(torch, got, want, grad, ref_grad,
                                           floor, per)
    num, den = num ** 0.5, den ** 0.5
    return (num / den if den else (0.0 if num == 0 else float("inf"))), \
        ties, admitted


def update_sums(torch, got, want, grad, ref_grad, floor: float,
                per: float) -> tuple[float, float, int, int]:
    """``update_rule``'s sums over a leaf or a slice of one: ||got -
    want||^2 and ||want||^2 over the elements that are not ties, the ties,
    and the elements admitted, ``per`` the admitted bound of the whole
    leaf (2 ``TRAIN_GRAD_TOL`` ||ref_grad|| / sqrt(n))."""
    grad, ref_grad = grad.float(), ref_grad.float()
    diff, size = (grad - ref_grad).abs(), ref_grad.abs()
    tie = (diff > size / 2) | ((size < floor) & (diff > 0))
    keep = ~tie
    den = float((want.float() * keep).square().sum())
    num = float(((got.float() - want.float()) * keep).square().sum())
    admitted = int(((size < per) | (size < floor)).sum())
    return num, den, int(tie.sum()), admitted


def update_floor(opt_cfg, grad_norm: float) -> float:
    """The gradient under which Adam's first move follows the gradient's
    rounding: the clipped gradient within ``UPDATE_EPS_FLOOR`` eps of 0,
    in the gradient's units (the clip scales it by min(1, clip_norm /
    grad_norm))."""
    return UPDATE_EPS_FLOOR * opt_cfg.eps / min(1.0, opt_cfg.clip_norm
                                                / grad_norm)


def zero3_gathers(cfg, mesh_shape: tuple, one_dtype: bool = False) -> dict:
    """ZeRO-3's gathers in one forward of ``cfg`` on a (data, model) mesh,
    from the ZeRO-3 specs (``serve_lib.zero3_of``): one gather a unit that
    holds a leaf the pass cuts, one all_reduce a dtype among those leaves
    (every parameter one dtype with ``one_dtype``: parameters cast), its
    backward one all_reduce. The units: the embedding, the final norm with
    the head (a tied head: the embedding again), an encoder-decoder's
    encoder final norm, and each layer or hybrid block (an
    encoder-decoder's encoder and decoder layers), the remat units. ->
    {"forward": the calls of one forward's gathers, "units": of the remat
    units' alone (remat's recompute gathers them again), "gathers": the
    gathers (their backward's calls), "decode": the calls of a decode
    step's gathers (the embedding, each decoder layer or block, the head),
    "whole": whether the pass keeps some leaf whole (its gradient summed
    over the batch axes by the step)}."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_items
    from repro_torch.runtime.serve_lib import zero3_of
    from repro_torch.sharding.rules import make_rules, spec_tree
    model = build_model(cfg)
    mesh = abstract_mesh(mesh_shape)
    decls = dict(tree_items(model.param_decls()))
    z = zero3_of(model, mesh, spec_tree(model.param_decls(), mesh, make_rules(
        mesh, dp_only=cfg.dp_only)), True)
    cut = {} if z is None else z.regions

    def calls(*roots) -> int:
        dtypes = {decls[p].dtype for p in cut if p[0] in roots}
        return min(len(dtypes), 1) if one_dtype else len(dtypes)
    head = "head" if "head" in {p[0] for p in decls} else "embed"
    ends = [calls("embed"), calls("final_norm", head)]
    if cfg.family == "encdec":
        ends.append(calls("enc_final_norm"))
        stacks = [(calls("encoder"), cfg.n_encoder_layers),
                  (calls("decoder"), cfg.n_layers)]
    else:
        stacks = [(calls("layers"), model._n_stacked())]
    units = sum(c * n for c, n in stacks)
    return {"forward": sum(ends) + units, "units": units,
            "gathers": sum(map(bool, ends)) + sum(n for c, n in stacks if c),
            "decode": ends[0] + ends[1] + stacks[-1][0] * stacks[-1][1],
            "whole": len(cut) < len(decls)}


def train_collectives(cfg, mesh_shape: tuple, zero1: bool,
                      zero3: bool = False, one_dtype: bool = False) -> int:
    """all_reduce calls of one sharded train step of ``cfg`` on a (data,
    model) mesh whose model axis cuts the heads, the MLP or the experts,
    the Mamba heads and the vocab (under ``dp_only`` nothing): a
    microbatch's forward takes the embedding's sum, each layer's sums (an
    attention's row-parallel ``wo``, an MLP's or MoE's sum, a Mamba
    block's norm sum and ``out_proj``; an MoE's aux sums over the batch
    ranks too, where they are more than one) and the loss's max and
    ``sum_with``; its backward the head's ``enter`` and each layer's
    (the attention's and the MLP's ``enter``, or the MoE's one ``enter``
    of its tokens and gates; the Mamba block's ``enter`` and its norm sum's
    backward) and, under remat, the forward's sums of each remat unit (a
    layer, a hybrid block) but its last (``torch.utils.checkpoint`` stops
    recomputing a unit once it has remade the tensors the backward needs,
    and the unit's last sum is not among them). The layers by family
    (``layer_sums``): an attention layer's two, a Mamba layer's two, a
    hybrid block of period p 3p - 1 (its attention's one, each Mamba
    sublayer's two, each FFN's one), an encoder layer's two and a decoder
    layer's three (its cross-attention's ``wo`` and ``enter``, which takes
    the memory's gradient with the query's). Then one sum of the leaves
    whose gradient is a part (qk-norm; ``wk``/``wv`` where the KV heads do
    not divide; a Mamba block's ``w_B``, ``w_C``, ``conv_B``, ``conv_C``),
    the global norm's one, and where the batch is cut over more than one
    rank: the gradients' sum, the loss metric's and, with ``zero1``, the
    gather of the updated slices (``optim/adamw.py::gather_updated``: one
    all_reduce a dtype among the leaves it gathers, one in every ZeRO-1
    run here: the CPU tests' fp32 cases cast every leaf to fp32, the
    card's tinyllama is all bf16, and mamba2's fp32 leaves are not cut
    over the data axis).

    With ``zero3`` (``zero3_gathers``; ``one_dtype``: the parameters cast
    to one dtype) each microbatch adds its gathers' calls, forward and
    remat's recompute of each layer unit, and each gather's backward; the
    gradients' sum over the batch axes takes only the leaves the pass
    keeps whole (none: no call), and nothing is gathered after the update
    (``zero1`` changes nothing)."""
    data, model = mesh_shape
    mu = max(cfg.microbatches, 1)
    if cfg.dp_only:
        per_microbatch = extra = 0
        batch_ranks = data * model
    else:
        batch_ranks = data
        # each remat unit's sums, its MoE aux sums, and its units
        sums, aux, units = layer_sums(cfg, batch_ranks > 1)
        per_microbatch = (1 + sums + aux + 2) + (1 + sums) \
            + (sums + aux - units if cfg.remat else 0)
        extra = 1 + int(cfg.family in ("ssm", "hybrid") or cfg.qk_norm
                        or cfg.n_kv_heads % model != 0)
    tail = 2 + int(zero1) if batch_ranks > 1 else 0
    if zero3 and batch_ranks > 1:
        g = zero3_gathers(cfg, mesh_shape, one_dtype)
        per_microbatch += g["forward"] + g["gathers"] + (
            g["units"] if cfg.remat else 0)
        tail = 1 + int(g["whole"])
    return mu * per_microbatch + extra + tail


def layer_sums(cfg, aux_summed: bool) -> tuple[int, int, int]:
    """(the model-axis sums of one forward of every layer, the MoE aux
    sums over the batch ranks among them where ``aux_summed``, the remat
    units), by family (``train_collectives``)."""
    L, fam = cfg.n_layers, cfg.family
    if fam == "hybrid":
        per, blocks = cfg.hybrid_period, L // cfg.hybrid_period
        n_moe = per // cfg.hybrid_moe_every
        return blocks * (3 * per - 1), blocks * n_moe * aux_summed, blocks
    if fam == "encdec":
        return 2 * cfg.n_encoder_layers + 3 * L, 0, cfg.n_encoder_layers + L
    return 2 * L, L * (fam == "moe" and aux_summed), L


class _EnterSome:
    """A layout whose ``enter`` passes on through the layout's own only its
    inputs at ``keep`` (their gradients summed over the model axis) and
    returns the others as they are, under grad too (the planted faults that
    skip that sum at the attention input, ``keep`` empty, or leave the
    MoE's gates or tokens without it)."""

    def __init__(self, layout, keep: tuple):
        self.layout, self.keep = layout, keep

    def __getattr__(self, name):
        return getattr(self.layout, name)

    def enter(self, *xs):
        out = tuple(self.layout.enter(x) if i in self.keep else x
                    for i, x in enumerate(xs))
        return out[0] if len(out) == 1 else out


def train_faults(torch, which: str, mesh):
    """A context that plants one of ``TRAIN_FAULTS`` or
    ``FAMILY_TRAIN_FAULTS`` in this rank's modules (``mesh`` the rank's:
    its model axis's group tells the partial leaves' sum from the data
    axes'). "w_B and w_C left out of the partial leaves" acts where the
    step is built, the others where it runs."""
    import importlib
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.runtime import train_lib
    from repro_torch.sharding import layout as layout_mod
    moe_mod = importlib.import_module("repro_torch.models.moe")

    def no_enter(sharded):
        def faulty(params, x, cfg, cache, shard, *rest):
            return sharded(params, x, cfg, cache, _EnterSome(shard, ()),
                           *rest)
        return faulty

    def own_norm(norm):
        def faulty(leaves, cuts, mesh):
            return adamw_mod.global_norm(leaves)
        return faulty

    def no_data_sum(flat_sum):
        def faulty(grads, group):
            if group is mesh.group("model"):
                return flat_sum(grads, group)
            return [g.float() for g in grads]
        return faulty

    def no_gather(gather):
        return lambda parts, group: None

    def entering(keep):
        # the MoE enters (tokens, gates) in that order
        def wrap(local):
            def faulty(*args, shard=None, **kw):
                return local(*args, shard=_EnterSome(shard, keep), **kw)
            return faulty
        return wrap

    def own_rows(global_means):
        return lambda probs, top1, shard: (probs.mean(dim=0),
                                           top1.mean(dim=0))

    def identity_backward(sum_partials):
        return lambda self, t: layout_mod._sum(t, self.model_group)

    def without_b_c(partial_leaves):
        def faulty(model, layout):
            return {p for p in partial_leaves(model, layout)
                    if p[-1] not in ("w_B", "w_C")}
        return faulty

    def own_columns(sum_partials):
        return lambda self, t: t

    def cross_without_sum(attention):
        def faulty(params, x, cfg, *, kv_source=None, shard=None, **kw):
            if kv_source is not None and shard is not None:
                shard = _NoModelSum(shard)
            return attention(params, x, cfg, kv_source=kv_source,
                             shard=shard, **kw)
        return faulty

    def rolled_kv(attention):
        def faulty(params, x, cfg, *, causal=True, kv_source=None, **kw):
            if not causal and kv_source is None:     # the encoder's
                params = {**params, **{n: params[n].roll(1, dims=-2)
                                       for n in ("wk", "wv")}}
            return attention(params, x, cfg, causal=causal,
                             kv_source=kv_source, **kw)
        return faulty

    def no_all_reduce(fn):
        def faulty(*args, **kw):
            with patched(torch.distributed, "all_reduce",
                         lambda _: lambda *a, **k: None):
                return fn(*args, **kw)
        return faulty

    def other_data_slice(gather_regions):
        # each region moved along its data-cut dim by its own size
        def faulty(parts, group):
            return gather_regions([(t, tuple(
                slice(r.stop % n, r.stop % n + r.stop - r.start)
                if r.stop - r.start < n else r
                for r, n in zip(region, shape)), shape)
                for t, region, shape in parts], group)
        return faulty

    def positions_on_axis_0(take_rows):
        def faulty(batch, rows):
            out = take_rows(batch, rows)
            pos = batch.get("mrope_positions")
            if pos is not None:
                _, B, S = pos.shape
                out["mrope_positions"] = pos.reshape(B, 3, S)[rows] \
                    .reshape(3, -1, S)
            return out
        return faulty
    owner, name, wrap = {
        TRAIN_FAULTS[0]: (attn_mod, "_sharded_attention", no_enter),
        TRAIN_FAULTS[1]: (adamw_mod, "sharded_norm", own_norm),
        TRAIN_FAULTS[2]: (train_lib, "flat_sum", no_data_sum),
        TRAIN_FAULTS[3]: (adamw_mod, "gather_updated", no_gather),
        MOE_TRAIN_FAULTS[0]: (moe_mod, "_moe_local", entering((0,))),
        MOE_TRAIN_FAULTS[1]: (moe_mod, "_global_means", own_rows),
        MOE_TRAIN_FAULTS[2]: (moe_mod, "_moe_local", entering((1,))),
        SSM_TRAIN_FAULTS[0]: (layout_mod.ShardLayout, "sum_partials",
                              identity_backward),
        SSM_TRAIN_FAULTS[1]: (train_lib, "model_partial_leaves",
                              without_b_c),
        VLM_TRAIN_FAULTS[0]: (train_lib, "take_rows",
                              positions_on_axis_0),
        HYBRID_TRAIN_FAULTS[0]: (layout_mod.ShardLayout, "sum_partials",
                                 own_columns),
        ENCDEC_TRAIN_FAULTS[0]: (encdec_mod, "attention", cross_without_sum),
        ENCDEC_TRAIN_FAULTS[1]: (encdec_mod, "attention", rolled_kv),
        ZERO3_FAULTS[0]: (layout_mod, "_gather_regions", no_all_reduce),
        ZERO3_FAULTS[1]: (layout_mod._Gather, "backward", no_all_reduce),
        ZERO3_FAULTS[2]: (layout_mod, "_gather_regions",
                          other_data_slice)}[which]
    return patched(owner, name, wrap)


# the sharded checkpoint's planted fault, in a restore at a data axis of 2
# under ZeRO-1 (the card's (2, 2) run; the CPU tests')
CKPT_FAULT = "a ZeRO-1 moment restored from the wrong data rank's slice"


def ckpt_fault(torch):
    """Context: ``checkpoint/ckpt.py``'s restore cuts each leaf whose spec
    names the data axis (ZeRO-1's moments) at the next data rank's slice
    (``CKPT_FAULT``)."""
    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.rules import spec_axes

    def next_data_rank(local_slices):
        def faulty(spec, shape, mesh):
            if any("data" in spec_axes(part) for part in spec):
                coords = dict(mesh.coords)
                coords["data"] = (coords["data"] + 1) % mesh.shape["data"]
                mesh = Mesh(tuple(mesh.shape.values()), mesh.axis_names,
                            coords=coords)
            return local_slices(spec, shape, mesh)
        return faulty
    return patched(ckpt_mod, "local_slices", next_data_rank)


def ckpt_shards_path(rank: int) -> Path:
    return ROOT / "build" / f"sharded-ckpt-shards-{rank}.pt"


def ckpt_cleanup() -> None:
    """The sharded checkpoint check's files off the disk."""
    import shutil
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    for r in range(CKPT_SAVE_AT[0] * CKPT_SAVE_AT[1]):
        ckpt_shards_path(r).unlink(missing_ok=True)


def _bit_view(torch, t):
    """``t``'s bits as integers, for an exact comparison (signed zeros and
    NaNs told apart)."""
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def ckpt_whole(torch):
    """The whole state of ``CKPT_ARCH``'s (1, 2) run after its checked step,
    assembled on the host from the ranks' shards on disk
    (``ckpt_shards_path``, mapped) under the (1, 2) specs, independently of
    ``checkpoint/ckpt.py``: a TrainState of CPU tensors."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_at, tree_map_with_path
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import train_lib
    from repro_torch.sharding.rules import local_slices
    model = build_model(sharded_train_config(CKPT_ARCH))
    data, width = CKPT_SAVE_AT
    specs = train_lib.make_train_state_specs(model, Mesh(CKPT_SAVE_AT, (
        "data", "model")))
    shards = [torch.load(ckpt_shards_path(r), mmap=True)
              for r in range(data * width)]

    def whole(path, like):
        full = torch.empty(like.shape, dtype=like.dtype)
        for r, shard in enumerate(shards):
            rank = Mesh(CKPT_SAVE_AT, ("data", "model"), coords={
                "data": r // width, "model": r % width})
            full[local_slices(tree_at(specs, path), tuple(like.shape),
                              rank)] = shard["__".join(path)]
        return full
    return tree_map_with_path(whole, train_lib.abstract_train_state(
        model, AdamWConfig(**SHARD_TRAIN_OPT)))


def ckpt_save(torch, mesh, state, specs) -> dict:
    """``CKPT_ARCH``'s (1, 2) rank: its state saved over the mesh
    (``save_state(..., specs=, mesh=)``: gathered leaf by leaf, rank 0
    writes), timed; its shards also kept on disk for ``ckpt_whole``.
    -> the save's seconds and the directory's bytes."""
    from repro_torch.checkpoint import save_state
    from repro_torch.models.param import tree_items
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = save_state(CKPT_DIR, 1, state, specs=specs, mesh=mesh)
    seconds = time.perf_counter() - t0
    torch.save({"__".join(p): a.detach().cpu() for p, a in tree_items(state)},
               ckpt_shards_path(torch.distributed.get_rank()))
    return {"save_s": seconds,
            "bytes": sum(f.stat().st_size for f in final.iterdir())}


def ckpt_restore(torch, mesh, state, specs) -> dict:
    """``CKPT_ARCH``'s (2, 2) ZeRO-1 rank: the (1, 2) checkpoint restored
    into its shards (``restore_state(..., specs=, mesh=)``), timed, each
    leaf held bit for bit to its slice of ``ckpt_whole``; then restored
    again under ``ckpt_fault``, which must part some leaf from its slice.
    -> seconds, the shards' bytes, the leaves apart in each restore."""
    from repro_torch.checkpoint import restore_state
    from repro_torch.models.param import tree_at, tree_items
    from repro_torch.sharding.rules import local_slices
    whole = dict(tree_items(ckpt_whole(torch)))

    def apart(restored) -> list:
        return ["__".join(p) for p, a in tree_items(restored)
                if not torch.equal(_bit_view(torch, a.cpu()), _bit_view(
                    torch, whole[p][local_slices(tree_at(specs, p),
                                                 tuple(whole[p].shape),
                                                 mesh)]))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = restore_state(CKPT_DIR, 1, state, specs=specs, mesh=mesh)
    torch.cuda.synchronize()
    out = {"restore_s": time.perf_counter() - t0,
           "bytes": sum(a.numel() * a.element_size()
                        for _, a in tree_items(restored)),
           "apart": apart(restored)}
    del restored
    with ckpt_fault(torch):
        faulty = restore_state(CKPT_DIR, 1, state, specs=specs, mesh=mesh)
    out["fault_apart"] = apart(faulty)
    return out


def ckpt_directory_check(torch) -> None:
    """After the (1, 2) spawn: the directory its ranks saved must equal,
    file for file and byte for byte, what ``save_state`` writes for the
    whole state assembled from their shards (``ckpt_whole``)."""
    import filecmp
    import shutil
    from repro_torch.checkpoint import save_state
    other = ROOT / "build" / "sharded-ckpt-whole"
    shutil.rmtree(other, ignore_errors=True)
    t0 = time.perf_counter()
    save_state(other, 1, ckpt_whole(torch))
    got = sorted(f.name for f in (CKPT_DIR / "step_00000001").iterdir())
    want = sorted(f.name for f in (other / "step_00000001").iterdir())
    differ = [n for n in got if n in want and not filecmp.cmp(
        CKPT_DIR / "step_00000001" / n, other / "step_00000001" / n,
        shallow=False)]
    log(f"[sharded-ckpt] {CKPT_ARCH} ({SHARD_TRAIN_LAYERS[CKPT_ARCH]} "
        f"layers) saved at {CKPT_SAVE_AT}: {len(got)} files; against "
        f"save_state of the state assembled from the ranks' shards "
        f"({len(want)} files, {time.perf_counter() - t0:.1f} s): names "
        f"equal {got == want}, files whose bytes differ {differ}")
    shutil.rmtree(other, ignore_errors=True)
    if got != want or differ:
        raise AssertionError(f"the sharded checkpoint is not save_state's "
                             f"of the whole state: {differ}")


def sharded_train_config(arch: str = SHARD_TRAIN_ARCH):
    """The config of ``arch``'s sharded training run: full width at
    ``SHARD_TRAIN_LAYERS`` (an encoder-decoder's both stacks), jamba its
    reduced config cut to one period-4 block; remat "full"."""
    from repro_torch.configs import get_config
    if arch == JAMBA_ARCH:
        cfg = one_block(get_config(arch, reduced=True))
    else:
        layers = SHARD_TRAIN_LAYERS[arch]
        cfg = dataclasses.replace(get_config(arch), n_layers=layers, **(
            {"n_encoder_layers": layers}
            if get_config(arch).family == "encdec" else {}))
    return dataclasses.replace(
        cfg, q_chunk=SHARD_TRAIN_SEQ // 2, kv_chunk=SHARD_TRAIN_SEQ // 2,
        remat=True, remat_policy="full", microbatches=1)


def sharded_train_state(torch, model, opt, arch: str, mesh=None,
                        zero1: bool = False, zero3: bool = False):
    """The seeded training state of ``arch``'s sharded run on the card (this
    rank's shards over ``mesh``, with ``zero3`` its regions, or whole), the
    attention at fan-in std, the parameters cast to fp32 for an arch of
    ``SHARD_TRAIN_FP32``."""
    from repro_torch.models.param import tree_map
    from repro_torch.runtime import train_lib
    state = train_lib.init_train_state(model, opt, seed=0, device="cuda",
                                       mesh=mesh, zero1=zero1, zero3=zero3)
    attention_at_fan_in(state.params, model.cfg)
    if arch in SHARD_TRAIN_FP32:
        state = train_lib.TrainState(
            tree_map(lambda a: a.float(), state.params), state.opt)
    return state


def sharded_train_batch(torch, cfg) -> dict:
    """The global batch of ``cfg``'s sharded training on the host: 8
    seeded sequences of 513 tokens; for the vlm also 16 seeded bf16 vision
    embeddings a row and ``qwen2vl_positions`` (as the single-card qwen2-vl
    train check feeds them); for the encoder-decoder ``FRAMES_LEN`` seeded
    bf16 frame embeddings a row."""
    import numpy as np
    from repro_torch.launch.serve import FRAMES_LEN
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(SHARD_TRAIN_BATCH, SHARD_TRAIN_SEQ + 1)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            SHARD_TRAIN_BATCH, FRAMES_LEN, cfg.d_model,
            generator=torch.Generator().manual_seed(3)).bfloat16()
    if cfg.family == "vlm":
        n_vis = QWEN2VL_GRID[0] * QWEN2VL_GRID[1]
        batch["vision_embeds"] = torch.randn(
            SHARD_TRAIN_BATCH, n_vis, cfg.d_model,
            generator=torch.Generator().manual_seed(2)).bfloat16()
        batch["mrope_positions"] = qwen2vl_positions(
            torch, SHARD_TRAIN_SEQ, SHARD_TRAIN_BATCH)
    return batch


def sharded_train_reference(torch, arch: str, path: Path) -> None:
    """The unsharded train step (``build_train_step(model, opt)``) on the
    card of ``sharded_train_config(arch)``'s model, seed 0 with the
    attention at fan-in std, on ``sharded_train_batch``: saved to ``path``
    with the batch, the loss, the norm and every leaf's gradient in its
    parameter's dtype (an MoE's also its layers' top-k experts, which the
    ranks are fed); the card's memory released after. The updated
    parameters are not kept: the update is elementwise in the parameter,
    its gradient and the norm, so each rank remakes its shards' from the
    same seeded parameters (``reference_update``)."""
    from repro_torch.models import build_model
    from repro_torch.models.param import tree_items
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import train_lib
    cfg = sharded_train_config(arch)
    model = build_model(cfg)
    opt = AdamWConfig(**SHARD_TRAIN_OPT)
    state = sharded_train_state(torch, model, opt, arch)
    batch = sharded_train_batch(torch, cfg)
    kept, routes = {}, {"cuda": [], "cpu": []}

    def capture(update):
        def recording(params, grads, opt_state, opt_cfg):
            kept.update({"/".join(p): g.cpu() for p, g in tree_items(grads)})
            return update(params, grads, opt_state, opt_cfg)
        return recording
    with patched(train_lib, "adamw_update", capture), \
            record_routes(routes) if cfg.n_experts \
            else contextlib.nullcontext():
        state, metrics = train_lib.build_train_step(model, opt)(
            state, {k: t.cuda() for k, t in batch.items()})
    # the forward's calls, one an MoE layer or sublayer (remat's recompute
    # calls them again)
    n_moe = cfg.n_layers // cfg.hybrid_moe_every \
        if cfg.family == "hybrid" else cfg.n_layers
    torch.save({"batch": batch, "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]), "grads": kept,
                "routes": [t for t, _, _ in (routes["cuda"] + routes["cpu"])[
                    :n_moe]]},
               path)
    del state, metrics, kept
    gc.collect()
    torch.cuda.empty_cache()


def reference_update(torch, path: tuple, p0, grad, opt_cfg, grad_norm):
    """The unsharded step's update of one slice of a parameter: AdamW's
    first step (``optim/adamw.py::_update``) on ``p0`` (the seeded value)
    with the reference's gradient ``grad`` and global norm, from zero
    moments, as the unsharded step made it; fp32, on the card."""
    from repro_torch.optim import adamw as adamw_mod
    p = p0.cuda().clone()
    m = torch.zeros(p.shape, device="cuda")

    def tree(t):
        # the leaf under its path, which names its weight decay
        for key in reversed(path):
            t = {key: t}
        return t
    adamw_mod._update(tree(p), tree(grad.cuda()), adamw_mod.OptState(
        step=torch.zeros((), dtype=torch.int32, device="cuda"),
        m=tree(m), v=tree(m.clone())), opt_cfg,
        torch.tensor(grad_norm, device="cuda"))
    return p.float() - p0.cuda().float()


def shard_leaf_rules(torch, path: tuple, new, p0, grad, ref_grad, opt_cfg,
                     grad_norm: float, floor: float) -> tuple:
    """One leaf of a rank's step against the reference, a row slice at a
    time (``optim/adamw.py::_pieces``, bounding the fp32 temporaries):
    (||grad - ref_grad||^2, ||ref_grad||^2, and ``update_rule``'s sums of
    the update ``new - p0`` against the reference's,
    ``reference_update``)."""
    from repro_torch.optim.adamw import _pieces
    pieces = list(_pieces(tuple(grad.shape)))
    d2 = r2 = 0.0
    for pc in pieces:
        rg = ref_grad[pc].cuda().float()
        d2 += float((grad[pc].float() - rg).square().sum())
        r2 += float(rg.square().sum())
    per = 2 * TRAIN_GRAD_TOL * r2 ** 0.5 / grad.numel() ** 0.5
    sums = [0.0, 0.0, 0, 0]
    for pc in pieces:
        start = p0[pc].cuda().float()
        want = reference_update(torch, path, p0[pc], ref_grad[pc], opt_cfg,
                                grad_norm)
        for i, v in enumerate(update_sums(
                torch, new[pc].float() - start, want, grad[pc],
                ref_grad[pc].cuda(), floor, per)):
            sums[i] += v
    return d2, r2, sums


def sharded_train_rank_run(torch, mesh, arch: str, ref_path: str,
                           zero1: bool, zero3: bool = False) -> dict:
    """One rank's sharded training of ``sharded_train_config(arch)``'s
    model on ``mesh``: its shards of the seeded state, the checked step on
    the reference's batch (an MoE fed the reference's experts,
    ``experts_as``; its all_reduce calls and kernel launches counted),
    ``TRAIN_TIMED_STEPS`` timed steps on the state it leaves, an MoE's step
    on its own routing (printed, not held: ROADMAP C.2), the sharded AdamW
    fed the reference's gradients, and one step under each planted fault
    of ``train_faults_of`` (its step built under the fault), each from the
    seeded state again (the parameters copied back from the host, the
    moments zeroed). Each step is held to the reference
    (``sharded_train_reference``): the loss rel 1e-2, each gradient shard
    within ``TRAIN_GRAD_TOL`` of its slice's norm, the norm rel 1e-2, each
    leaf's update by ``update_rule`` (``TRAIN_GRAD_TOL``, the ties within
    the admitted; the reference's update remade by ``reference_update``);
    the fed AdamW's update within ``FED_TOL`` of the reference's arithmetic
    at the norm it took, that norm within ``FED_NORM_TOL`` of the
    reference's. One state lives at a time, beside the seeded parameters
    and the reference's gradient shards on the card (a qwen3-moe rank's
    3.7 GB each). With ``zero3`` the state is the rank's ZeRO-3 regions
    and every rule is held on them; the state's bytes are returned beside
    the ZeRO-3 specs' local shapes' (``want_state_bytes``)."""
    from repro_torch.models import build_model
    from repro_torch.models.param import (tree_at, tree_items,
                                          tree_map_with_path)
    from repro_torch.optim import AdamWConfig, adamw as adamw_mod
    from repro_torch.runtime import train_lib
    from repro_torch.sharding.rules import local_shape, local_slices
    ref = torch.load(ref_path, mmap=True)
    cfg = sharded_train_config(arch)
    model = build_model(cfg)
    opt = AdamWConfig(**SHARD_TRAIN_OPT)
    specs = train_lib.make_train_state_specs(model, mesh, zero1=zero1,
                                             zero3=zero3)
    paths = [p for p, _ in tree_items(model.param_decls())]
    region = {p: local_slices(tree_at(specs.params, p), d.shape, mesh)
              for p, d in tree_items(model.param_decls())}
    ref_g = {p: ref["grads"]["/".join(p)][region[p]].cuda() for p in paths}
    n_params = sum(t.numel() for t in ref_g.values())
    batch = {k: t.cuda() for k, t in ref["batch"].items()}
    routes = [(t,) for t in ref["routes"]]
    want_loss, want_gn = ref["loss"], ref["grad_norm"]
    floor = update_floor(opt, want_gn)
    mesh_shape = tuple(mesh.shape.values())

    def fed():
        return experts_as(routes) if routes else contextlib.nullcontext()

    def build():
        return train_lib.build_train_step(model, opt, mesh=mesh, zero1=zero1,
                                          zero3=zero3)

    state = sharded_train_state(torch, model, opt, arch, mesh, zero1, zero3)
    p0 = {p: a.detach().clone() for p, a in tree_items(state.params)}

    def reset(state):
        """The seeded state again, in place: the steps write into it."""
        with torch.no_grad():
            for p, a in tree_items(state.params):
                a.copy_(p0[p])
            for tree in (state.opt.m, state.opt.v):
                for _, a in tree_items(tree):
                    a.zero_()
            state.opt.step.zero_()

    def run(state, step, routing, count=None):
        seen = {}

        def capture(update):
            def recording(params, grads, opt_state, opt_cfg, plan):
                seen.update(tree_items(grads))
                return update(params, grads, opt_state, opt_cfg, plan)
            return recording
        with patched(train_lib, "adamw_update_sharded", capture), \
                counting_all_reduce(torch, count) if count is not None \
                else contextlib.nullcontext(), routing:
            state, metrics = step(state, batch)
        return state, metrics, seen

    def rules(state, metrics, grads) -> dict:
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        grad_errs, upd, ties, admitted = {}, {}, 0, 0
        for p, a in tree_items(state.params):
            d2, r2, (num2, den2, n_tie, ok) = shard_leaf_rules(
                torch, p, a, p0[p], grads[p], ref_g[p], opt, want_gn, floor)
            name = "/".join(p)
            grad_errs[name] = (d2 / r2) ** 0.5 if r2 else (
                0.0 if d2 == 0 else float("inf"))
            upd[name] = (num2 / den2) ** 0.5 if den2 else (
                0.0 if num2 == 0 else float("inf"))
            ties, admitted = ties + n_tie, admitted + ok
        res = {"loss": loss, "loss_rel": abs(loss - want_loss) / want_loss,
               "grad_norm": gn, "gn_rel": abs(gn - want_gn) / want_gn,
               "grad_err": max(grad_errs.values()),
               "grad_worst": sorted(grad_errs, key=grad_errs.get)[-3:],
               "update_err": max(upd.values()),
               "update_ties": ties / n_params,
               "ties_admitted": admitted / n_params}
        res["broken"] = [name for name, ok in (
            ("loss", res["loss_rel"] < 1e-2),
            ("gradients", res["grad_err"] <= TRAIN_GRAD_TOL),
            ("grad_norm", res["gn_rel"] < 1e-2),
            ("update", res["update_err"] <= TRAIN_GRAD_TOL
             and res["update_ties"] <= res["ties_admitted"])) if not ok]
        return res

    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    count = [0]
    step = build()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics, grads = run(state, step, fed(), count)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    result = {"coords": dict(mesh.coords), "zero1": zero1, "zero3": zero3,
              "arch": arch, "layers": cfg.n_layers, "collectives": count[0],
              "want_collectives": train_collectives(cfg, mesh_shape, zero1,
                                                    zero3),
              "launches": launches, "first_s": first_s,
              **rules(state, metrics, grads)}
    del grads
    if arch == CKPT_ARCH and mesh_shape == CKPT_SAVE_AT:
        result["ckpt"] = ckpt_save(torch, mesh, state, specs)
    state_bytes = sum(a.numel() * a.element_size() for tree in (
        state.params, state.opt.m, state.opt.v) for _, a in tree_items(tree))
    # the specs' local shapes: the parameters in their dtype, fp32 moments
    result["want_state_bytes"] = sum(
        math.prod(local_shape(tree_at(specs.params, p), d.shape, mesh)) * (
            (4 if arch in SHARD_TRAIN_FP32 else d.dtype.itemsize) + 8)
        for p, d in tree_items(model.param_decls()))
    result["state_bytes"] = state_bytes
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        times.append(time.perf_counter() - t0)
    step_s = sum(times) / len(times)
    result.update(ms_a_step=step_s * 1e3,
                  tokens_per_s=SHARD_TRAIN_BATCH * SHARD_TRAIN_SEQ / step_s,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  state_gb=state_bytes / 1e9)
    if routes:
        # its own routing, from the seeded state: printed, not held
        reset(state)
        state, metrics, grads = run(state, step, contextlib.nullcontext())
        result["own"] = rules(state, metrics, grads)
        del grads
    # the sharded AdamW fed the reference's gradients, on the seeded state
    reset(state)
    plan = train_lib.shard_plan(model, mesh, zero1, zero3)
    params, _, fed_metrics = adamw_mod.adamw_update_sharded(
        state.params, tree_map_with_path(lambda p, _: ref_g[p].cuda(),
                                         state.params),
        state.opt, opt, plan)
    fed_gn = float(fed_metrics["grad_norm"])
    fed_errs = []
    for p, a in tree_items(params):
        _, _, (num2, den2, _, _) = shard_leaf_rules(
            torch, p, a, p0[p], ref_g[p].cuda(), ref_g[p], opt, fed_gn, 0.0)
        fed_errs.append((num2 / den2) ** 0.5 if den2 else (
            0.0 if num2 == 0 else float("inf")))
    result["fed_err"] = max(fed_errs)
    result["fed_gn_rel"] = abs(fed_gn - want_gn) / want_gn
    if not (result["fed_err"] <= FED_TOL
            and result["fed_gn_rel"] <= FED_NORM_TOL):
        result["broken"].append("fed AdamW")
    del params
    faults = {}
    for which in train_faults_of(arch, mesh_shape, zero3):
        reset(state)
        with train_faults(torch, which, mesh):
            state, metrics, grads = run(state, build(), fed())
        faults[which] = rules(state, metrics, grads)
        del grads
    result["faults"] = faults
    if arch == CKPT_ARCH and mesh_shape == CKPT_RESTORE_AT:
        result["ckpt"] = dict(ckpt_restore(torch, mesh, state, specs),
                              under="ZeRO-3" if zero3 else "ZeRO-1")
    del state, metrics
    return result


def _train_line(res: dict) -> str:
    return (f"loss {res['loss']:.6f} (rel {res['loss_rel']:.2e}, tol 1e-2), "
            f"grad_norm {res['grad_norm']:.4f} (rel {res['gn_rel']:.2e}, "
            f"tol 1e-2), worst gradient shard {res['grad_err']:.3e} of its "
            f"slice's norm (tol {TRAIN_GRAD_TOL:g}; worst leaves "
            f"{res['grad_worst']}), update {res['update_err']:.3e} on the "
            f"elements that are not ties (tol {TRAIN_GRAD_TOL:g}), ties' "
            f"share {res['update_ties']:.2e} (tol: the admitted share "
            f"{res['ties_admitted']:.2e}); "
            f"broken: {res['broken'] or 'none'}")


def train_kernels(cfg) -> dict:
    """The kernel launches of one sharded train step a rank, each
    microbatch: the flash forward once an attention, twice under remat
    (which recomputes it), and its backward once; the ssd forward and
    backward alike a Mamba block; no other kernel. An attention is one a
    layer (the encoder-decoder's: its encoder's, and its decoder's self-
    and cross-attention), one a hybrid block; a Mamba block one a layer of
    the ssm family, ``hybrid_period - 1`` a hybrid block."""
    mu = max(cfg.microbatches, 1)
    fam = cfg.family
    if fam == "ssm":
        attn, mamba = 0, cfg.n_layers
    elif fam == "hybrid":
        blocks = cfg.n_layers // cfg.hybrid_period
        attn, mamba = blocks, blocks * (cfg.hybrid_period - 1)
    elif fam == "encdec":
        attn, mamba = cfg.n_encoder_layers + 2 * cfg.n_layers, 0
    else:
        attn, mamba = cfg.n_layers, 0
    fwd = 2 if cfg.remat else 1
    out = {}
    if attn:
        out.update(flash_attention=fwd * attn * mu,
                   flash_attention_bwd=attn * mu)
    if mamba:
        out.update(ssd=fwd * mamba * mu, ssd_bwd=mamba * mu)
    return out


def sharded_train_check(torch, mesh_shape: tuple, arch: str,
                        results: dict, peaks: dict | None = None) -> dict:
    """``sharded_train_check``: one mesh's ranks of ``arch``'s sharded
    training run (``sharded_train_rank_run``, in the spawn of the mesh's
    serving group), logged and held: every rule on every rank; the
    all_reduce calls of the checked step equal to ``train_collectives``;
    the kernels' launches of ``train_kernels``; each planted fault of
    ``train_faults_of`` breaking a rule on every rank. An MoE's step on its
    own routing is printed, not held (ROADMAP C.2). Ranks that share the
    one card over gloo: their times are not a multi-card figure. A ZeRO-3
    run is held to the same rules, its launches to ``train_kernels`` (its
    ZeRO-1 run's) and its state bytes a rank to the ZeRO-3 specs' local
    shapes; its peak is printed beside the arch's ZeRO-1 run's in the same
    spawn (``peaks``, filled by each run: arch -> the ranks' largest peak).
    Returns the kernels' launches summed over the ranks."""
    from repro_torch.launch.serve import FRAMES_LEN
    cfg = sharded_train_config(arch)
    launched = {}
    extra = f", {QWEN2VL_GRID[0] * QWEN2VL_GRID[1]} vision embeddings a " \
        f"row and 3-D positions" if cfg.family == "vlm" else (
            ", fed the unsharded step's experts" if cfg.n_experts else "")
    if cfg.family == "encdec":
        extra += f", over {FRAMES_LEN} frames a row"
    if arch in SHARD_TRAIN_FP32:
        extra += ", parameters in fp32"
    if cfg.family == "hybrid":
        extra += (f"; the reduced config, d_model {cfg.d_model}: one card "
                  f"cannot hold a full-width block's state, and jamba's "
                  f"sublayers at full width are held by qwen2-vl's "
                  f"attention (G = 8, D = 128), mamba2's Mamba-2 (P = 64, "
                  f"N = 128) and qwen3-moe's MoE runs")
    depth = f"{cfg.n_encoder_layers} + {cfg.n_layers}" \
        if cfg.family == "encdec" else str(cfg.n_layers)
    zero3 = any(res["zero3"] for res in results.values())
    for rank, res in sorted(results.items()):
        log(f"[sharded-train] {arch} ({depth} layers, batch "
            f"{SHARD_TRAIN_BATCH} x {SHARD_TRAIN_SEQ}{extra}, zero1 "
            f"{res['zero1']}, zero3 {res['zero3']}) mesh {mesh_shape} rank "
            f"{rank} "
            f"{res['coords']} (processes sharing one card over gloo, not a "
            f"multi-card figure): {res['ms_a_step']:.1f} ms a step, "
            f"{res['tokens_per_s']:.0f} tokens/s, first step "
            f"{res['first_s']:.2f} s, peak {res['peak_gib']:.2f} GiB, state "
            f"{res['state_gb']:.3f} GB; all_reduce calls {res['collectives']}"
            f" (want {res['want_collectives']}); launches {res['launches']};"
            f" fed AdamW's update {res['fed_err']:.2e} of the reference's "
            f"at its norm (tol {FED_TOL:g}), that norm {res['fed_gn_rel']:.2e}"
            f" from the reference's (tol {FED_NORM_TOL:g}); "
            f"{_train_line(res)}")
        if zero3:
            log(f"[sharded-train] {arch} ZeRO-3 {mesh_shape} rank {rank}: "
                f"state {res['state_bytes']} bytes (the ZeRO-3 specs' local "
                f"shapes: {res['want_state_bytes']}); peak "
                f"{res['peak_gib']:.2f} GiB against the ZeRO-1 run's "
                f"{(peaks or {}).get(arch, float('nan')):.2f} GiB (the "
                f"largest of its ranks)")
            if res["state_bytes"] != res["want_state_bytes"]:
                raise AssertionError(f"ZeRO-3 training {arch} {mesh_shape} "
                                     f"rank {rank}: state "
                                     f"{res['state_bytes']} bytes, want "
                                     f"{res['want_state_bytes']}")
        if "own" in res:
            log(f"[sharded-train] {arch} rank {rank}, its own routing "
                f"(printed, not held: ROADMAP C.2): {_train_line(res['own'])}")
        want = dict.fromkeys(res["launches"], 0)
        want.update(train_kernels(cfg))
        if res["launches"] != want:
            raise AssertionError(f"sharded training {arch} {mesh_shape} "
                                 f"rank {rank}: launches {res['launches']}, "
                                 f"want {want}")
        if res["collectives"] != res["want_collectives"]:
            raise AssertionError(f"sharded training {arch} {mesh_shape} "
                                 f"rank {rank}: {res['collectives']} "
                                 f"all_reduce calls, want "
                                 f"{res['want_collectives']}")
        if res["broken"]:
            raise AssertionError(f"sharded training {arch} {mesh_shape} "
                                 f"rank {rank}: rules broken {res['broken']}")
        if "ckpt" in res:
            ckpt_line(mesh_shape, rank, res["ckpt"])
        for name, n in res["launches"].items():
            launched[name] = launched.get(name, 0) + n
    if peaks is not None and not zero3:
        peaks[arch] = max(res["peak_gib"] for res in results.values())
    for which in train_faults_of(arch, mesh_shape, zero3):
        got = {r: res["faults"][which] for r, res in results.items()}
        broke = sorted(r for r, f in got.items() if f["broken"])
        log(f"[sharded-train] {arch} {mesh_shape} planted fault '{which}': "
            f"breaks a rule on ranks {broke} (" + "; ".join(
                f"rank {r}: {_train_line(f)}" for r, f in sorted(got.items()))
            + ")")
        if broke != sorted(results):
            raise AssertionError(f"sharded training {arch} {mesh_shape}: "
                                 f"the planted fault '{which}' broke no rule "
                                 f"on ranks "
                                 f"{sorted(set(results) - set(broke))}")
    return launched


def ckpt_line(mesh_shape: tuple, rank: int, ckpt: dict) -> None:
    """One rank's sharded checkpoint readings, logged and held: a save's
    seconds and bytes; a restore's, its leaves bit-equal to their slices
    and the planted ``CKPT_FAULT`` parting some leaf from its slice."""
    if "save_s" in ckpt:
        log(f"[sharded-ckpt] {CKPT_ARCH} save at {mesh_shape} rank {rank} "
            f"(gathered leaf by leaf, rank 0 writes): {ckpt['save_s']:.2f} "
            f"s, {ckpt['bytes'] / 1e9:.3f} GB on disk")
        return
    log(f"[sharded-ckpt] {CKPT_ARCH} restore of the {CKPT_SAVE_AT} save at "
        f"{mesh_shape} with {ckpt['under']}, rank {rank}: "
        f"{ckpt['restore_s']:.2f} s, "
        f"{ckpt['bytes'] / 1e9:.3f} GB of shards; leaves apart from their "
        f"slices of the whole state {ckpt['apart'] or 'none'} (must be "
        f"none); planted fault '{CKPT_FAULT}': "
        f"{len(ckpt['fault_apart'])} leaves apart (must be some)")
    if ckpt["apart"] or not ckpt["fault_apart"]:
        raise AssertionError(f"sharded checkpoint restore at {mesh_shape} "
                             f"rank {rank}: {ckpt}")


def kernel_counters() -> dict:
    """Each kernel's launcher module, whose ``launches`` counts its
    launches."""
    from repro_torch.kernels.decode_attention import kernel as decode_k
    from repro_torch.kernels.decode_attention import partial as partial_k
    from repro_torch.kernels.flash_attention import kernel as flash_k
    from repro_torch.kernels.flash_attention import kernel_bwd as flash_bwd_k
    from repro_torch.kernels.ssd import kernel as ssd_k
    from repro_torch.kernels.ssd import kernel_bwd as ssd_bwd_k
    return {"flash_attention": flash_k, "flash_attention_bwd": flash_bwd_k,
            "decode_attention": decode_k, "ssd": ssd_k, "ssd_bwd": ssd_bwd_k,
            "decode_attention_partial": partial_k}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod

    t_start = time.perf_counter()

    last = [t_start]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        log(f"[time] {name} done at {now - t_start:.1f} s ({now - last[0]:.1f}"
            f" s in the phase)")
        last[0] = now

    log(f"[card] {card_line()}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    report = _build.build()
    log(f"[build] {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    phase_done("build")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    ssd_bwd_fault = start_ssd_bwd_fault_build()   # while the checks run
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
    decode_partial = check_decode_partial(torch, timer, gen)
    ssd = check_ssd(torch, timer, gen)
    flash_bwd = check_flash_bwd(torch, timer, gen)
    ssd_bwd = check_ssd_bwd(torch, timer, gen, ssd_bwd_fault)
    phase_done("kernels")

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
    phase_done("serving")
    gc.collect()
    torch.cuda.empty_cache()
    sharded = sharded_serve_check(torch)
    phase_done("sharded serving")

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
    phase_done("training")

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
    phase_done("profiles")
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
    phase_done("model checks")
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
    phase_done("train checks")
    orchestrate_check(torch, counters)
    phase_done("orchestrate")

    # the backward's G = 16 row: launched on the qwen3-moe training path
    flash_bwd["g16"]["launches"] = n_moe_bwd
    # the sharded runs' rows, each with its archs' launches over the
    # sharded counted passes: the partial decode at qwen3-moe's, qwen2-vl's
    # and jamba's (one shape), kimi-k2's heads and seamless's fp32 self
    # cache, ssd at a mamba2 rank's 16 heads and a jamba rank's 128, the
    # whole-cache decode at a seamless rank's heads of the memory
    by_arch = sharded["by_arch"]
    for rec, key, name, archs in (
            (decode_partial, "g16_d128", "decode_attention_partial",
             (MOE_ARCH,)),
            (decode_partial, "g8_d128", "decode_attention_partial",
             (QWEN2VL_ARCH, JAMBA_ARCH)),
            (decode_partial, "g8_d112", "decode_attention_partial",
             (KIMI_ARCH,)),
            (decode_partial, "g1_d64_f32", "decode_attention_partial",
             (SEAMLESS_ARCH,)),
            (ssd, "h16", "ssd", ("mamba2-370m",)),
            (ssd, "h128", "ssd", (JAMBA_ARCH,)),
            (decode, "rank_cross", "decode_attention", (SEAMLESS_ARCH,))):
        rec[key]["launches"] = sum(by_arch[a][name] for a in archs)
    # the sharded training's rows (a rank's heads at a model axis of 2),
    # each with the launches of every rank's checked step of its arch at
    # (1, 2) and (2, 2): tinyllama's G = 8 at D = 64, qwen2-vl's G = 8 and
    # qwen3-moe's G = 16 at D = 128, mamba2's 16 ssd heads
    train = sharded["train"]
    for rec, key, arch, name in (
            (flash, "rank_train", SHARD_TRAIN_ARCH, "flash_attention"),
            (flash_bwd, "rank_train", SHARD_TRAIN_ARCH,
             "flash_attention_bwd"),
            (flash, "rank_train_g8_d128", QWEN2VL_ARCH, "flash_attention"),
            (flash_bwd, "rank_train_g8_d128", QWEN2VL_ARCH,
             "flash_attention_bwd"),
            (flash, "rank_train_g16_d128", MOE_ARCH, "flash_attention"),
            (flash_bwd, "rank_train_g16_d128", MOE_ARCH,
             "flash_attention_bwd"),
            (ssd, "rank_train_h16", "mamba2-370m", "ssd"),
            (ssd_bwd, "rank_train_h16", "mamba2-370m", "ssd_bwd")):
        rec[key]["launches"] = train[arch][name]
    # jamba's full-width rank shape (H = 128): the card trains jamba's
    # reduced config alone, so these rows carry that run's launches, at
    # its own shape
    for rec, name in ((ssd, "ssd"), (ssd_bwd, "ssd_bwd")):
        rec["rank_train_h128"].update(
            launches=train[JAMBA_ARCH][name],
            launch_shape=f"jamba's reduced config, one period-4 block, "
                         f"{sharded_train_config(JAMBA_ARCH).ssm_heads // 2}"
                         f" heads a rank at P = 16, N = 16")
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
    # and its sharded training's (a rank's 8 of 16 heads at (1, 2))
    for rec, name in ((flash, "flash_attention"),
                      (flash_bwd, "flash_attention_bwd")):
        rec["seamless"]["sharded_train_launches"] = \
            train[SEAMLESS_ARCH][name]
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:93",
             launches=n_flash, **flash),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:73",
             launches=n_decode, **decode),
        dict(name="decode_attention_partial", route="cuda",
             source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:73",
             launches=sharded["decode_attention_partial"], **decode_partial),
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
