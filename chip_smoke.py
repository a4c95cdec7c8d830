#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` (flash_attention,
   flash_attention_bwd, decode_attention, ssd) for ``sm_90a`` into
   ``build/repro_torch/`` (one process per source, in parallel);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main paths' shapes and at the edges of their designs (decode:
   lengths on the key-split boundaries, G = 1 and 16, D = 128, a batch-1
   8192-key cache, the stale tail, a CUDA-graph replay; flash: ragged S,
   D = 128, G = 1, a 2048-token prompt; flash backward: the training shape,
   ragged S, G = 1, D = 128, a 2048-token sequence, fp32; ssd: zero and
   random state0, dt in bf16, fp32, ragged S, S = 513, P = 8, an in-place
   update of a stacked cache, a batch-1 8192-token prompt), to bf16 2e-2
   and fp32 2e-5 absolute (the JAX package's kernel tolerances; 5x those
   relative for ssd's output and 1e-4 relative for its final state; the
   backward's dq, dk, dv within 1e-2 of their norm in bf16 and 1e-4 in
   fp32, and planted faults shown to fail that rule; TF32 off), with
   CUDA-event times of the kernel, the plain version and, where one
   exists, one PyTorch library call as a yardstick, and the least time the
   card could take (``bound_ms``);
4. main paths, each at full width and depth on seeded random weights:
   ``serve_loop("tinyllama-1.1b")`` (flash and decode attention) and
   ``serve_loop("mamba2-370m")`` (ssd at prefill; decode is the plain
   recurrence), batch 8, 512-token prompts, 32 new tokens; and
   ``train_loop("tinyllama-1.1b")`` (flash forward and backward), batch 8,
   512 tokens, on the synthetic pipeline. Each is called once to warm up
   (the first call of each shape pays one-time library and module-loading
   costs) and once counted, its kernels' launch counts set to 0 just
   before and read just after: they must show every layer of the counted
   run went through them;
5. profile: ``torch.profiler`` over a few decode steps of each model, one
   mamba2 prefill and one tinyllama train step, for the device's busy
   share and the kernels that take its time (at prefill, the ssd kernel's
   share; in training, the flash forward's and backward's);
6. model check: a depth-2, full-width model of each arch on the card
   against the same model on the CPU's plain path (relative error < 0.06,
   equal argmax); a depth-2 tinyllama bf16 train step on the card against
   the CPU (attention weights at std 1/sqrt(fan-in) for this check only:
   loss 1e-2 relative, each gradient within 3e-2 of its norm, each layer's
   backward-kernel gradients against the plain backward on the same
   captured tensors within 1e-2 of their norm); a crash after step 4 and a
   resume from the checkpoint saved there, reproducing the uninterrupted
   losses (rtol 2e-2).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the repository
around it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
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


def check_flash(torch, timer, gen) -> dict:
    """The flash kernel against its plain version at the prefill shape (bf16
    causal and full, fp32), a ragged S, D = 128, G = 1 and a long B = 1
    prompt; the serving shape and the long prompt are timed. At each shape
    the rows' log-sum-exp that the kernel writes when asked (the training
    forward) is held to ``flash_attention_lse_plain`` within ``LSE_TOL``
    (1e-4 absolute, fp32: the kernel sums 2^x from ex2.approx, ~2 ulp each,
    with an online rescaling, where the plain version takes an exact fp32
    logsumexp; |lse| stays under ~10 here), and the output with lse asked
    for must equal the one without. The serving shape is timed with lse
    and without."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_lse_plain,
        flash_attention_plain)
    rec, worst = None, 0.0
    # (label, B, S, H, Hk, D, dtype, causal, timed)
    for label, B, S, H, Hk, D, dtype, causal, timed in (
            ("serving", 8, 512, 32, 4, 64, torch.bfloat16, True, True),
            ("serving", 8, 512, 32, 4, 64, torch.bfloat16, False, False),
            ("serving", 8, 512, 32, 4, 64, torch.float32, True, False),
            ("ragged", 2, 100, 32, 4, 64, torch.bfloat16, True, False),
            ("ragged", 2, 100, 32, 4, 64, torch.bfloat16, False, False),
            ("d128", 2, 256, 32, 4, 128, torch.bfloat16, True, False),
            ("g1", 2, 256, 8, 8, 64, torch.bfloat16, True, False),
            ("long", 1, 2048, 32, 4, 64, torch.bfloat16, True, True)):
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, S, Hk, D, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, S, Hk, D, generator=gen, device="cuda").to(dtype)
        got = flash_attention_cuda(q, k, v, causal=causal)
        with_lse, lse = flash_attention_cuda(q, k, v, causal=causal,
                                             return_lse=True)
        want = flash_attention_plain(q, k, v, causal=causal)
        want_lse = flash_attention_lse_plain(q, k, causal=causal)
        torch.cuda.synchronize()
        err, lse_err = max_err(got, want), max_err(lse, want_lse)
        name = str(dtype).split(".")[1]
        log(f"[kernels] flash_attention {label} {name} causal={causal} "
            f"B={B} S={S} H={H} Hk={Hk} D={D}: max_abs_err={err:.3e} "
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
        if dtype is torch.bfloat16:
            worst = max(worst, err)
        if not timed:
            continue
        ms = timer.ms(lambda: flash_attention_cuda(q, k, v, causal=True))
        lse_ms = timer.ms(lambda: flash_attention_cuda(
            q, k, v, causal=True, return_lse=True))
        plain_ms = timer.ms(
            lambda: flash_attention_plain(q, k, v, causal=True), iters=10)
        lib_ms = sdpa_ms(torch, timer, q, k, v, causal=True)
        flops = 4 * B * H * S * S * D / 2
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        log(f"[kernels] flash_attention {label} bf16 causal B={B} S={S}: "
            f"{ms:.4f} ms, with lse {lse_ms:.4f} ms (plain {plain_ms:.4f} "
            f"ms, sdpa {lib_ms} ms, bound {b_ms:.4f} ms by {b_by})")
        if label == "serving":
            rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
    rec["max_abs_err"] = worst
    return rec


def check_decode(torch, timer, gen) -> dict:
    """The decode kernel against its plain version: the serving shape at
    lengths on the split boundaries, G = 1, G = 16, D = 128, fp32, a batch-1
    8192-key cache; the stale tail; a call captured in a CUDA graph and
    replayed after `length` changes on the device. The serving shape and
    the long cache are timed."""
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    from repro_torch.kernels.decode_attention.kernel import keys_per_split
    split = keys_per_split()
    B, L, H, Hk, D = 8, 544, 32, 4, 64
    timed_len = 528           # the mean cache length of the serving path
    edges = (1, split - 1, split, split + 1, 300, timed_len, L)
    rec, worst = None, 0.0
    # (label, B, L, H, Hk, D, dtype, lengths, timed length)
    for label, Bc, Lc, Hc, Hkc, Dc, dtype, lengths, timed in (
            ("serving", B, L, H, Hk, D, torch.bfloat16, edges, timed_len),
            ("serving", B, L, H, Hk, D, torch.float32, (split, 300), None),
            ("g1", 2, L, 4, 4, D, torch.bfloat16, (1, split + 1, L), None),
            ("g16", 2, L, 64, 4, D, torch.bfloat16, (1, split + 1, L), None),
            ("d128", 2, L, 32, 4, 128, torch.bfloat16, (1, split + 1, L),
             None),
            ("long", 1, 8192, H, Hk, D, torch.bfloat16, (8000,), 8000)):
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
            if dtype is torch.bfloat16:
                worst = max(worst, err)
            if n != timed:
                continue
            ms = timer.ms(lambda: decode_attention_cuda(q, k, v, length))
            plain_ms = timer.ms(lambda: decode_attention_plain(q, k, v,
                                                               length))
            lib_ms = sdpa_ms(torch, timer, q, k[:, :n], v[:, :n],
                             causal=False)
            flops = 4 * Bc * Hc * n * Dc
            nbytes = 2 * (2 * Bc * Hkc * n * Dc + 2 * q.numel())
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            log(f"[kernels] decode_attention {label} bf16 B={Bc} "
                f"length={n}: {ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms} ms, bound {b_ms:.4f} ms by {b_by})")
            if label == "serving":
                rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by}

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
    rec["max_abs_err"] = worst
    return rec


def check_ssd(torch, timer, gen) -> dict:
    """The SSD kernel against its plain version: y (relative to its largest
    magnitude, 5x the bf16/fp32 tolerance, as tests/test_kernels.py holds
    the Pallas kernel) and the final state (relative, 1e-4, the bound
    tests/test_models.py holds chunk lengths 4-32 to). The serving shape and
    a batch-1 8192-token prompt are timed."""
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
    return rec


BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# the names of the flash kernels' launches (bf16), as the profiler shows them
FLASH_FWD = ("flash_bf16_kernel",)
FLASH_BWD = ("bwd_dq_bf16", "bwd_dkdv_bf16", "bwd_reduce")


def kernel_ms(torch, timer, fn, names, iters: int = 20) -> dict:
    """Mean device ms a call of ``fn`` spends in the kernels whose names
    contain each of ``names`` (``torch.profiler``), the L2 flushed before
    each call as ``Timer`` does."""
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
    return {n: t / iters / 1e3 for n, t in us.items()}


def check_flash_bwd(torch, timer, gen) -> dict:
    """The flash backward kernel against autograd through the plain version:
    dq, dk and dv each within ``BWD_TOL`` of their norm (||got - want|| /
    ||want||, 1e-2 in bf16, 1e-4 in fp32) at the training shape, causal and
    full; ragged S; G = 1; D = 128; a 2048-token sequence; fp32. A rule on
    the largest magnitude would not do: under the causal mask the first
    keys' dk and dv are ~100x the typical key's, so it would pass a kernel
    that is 10% wrong on most keys. At the training shape the check is
    shown to see such faults: the kernel's own result, with dv or dk scaled
    by 0.9 past key 128, dv zeroed on the last 12% of keys or dq scaled by
    0.9 on the last 12% of rows, must each fail the rule
    (``tools/flash_bwd_tolerance.py`` gives the kernel's rounding ~0.3% and
    these faults 1.9-4.3% on the CPU). The training shape and the long
    sequence are timed, backward alone: the kernel, the plain version and,
    as the yardstick, SDPA's backward (``torch.autograd.grad`` through SDPA
    with ``enable_gqa``, its forward outside the timed call)."""
    from flash_bwd_tolerance import grad_err, planted_faults
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel_bwd import (auto_split,
                                                                split_plan)
    F = torch.nn.functional
    rec, worst = None, 0.0
    # (label, B, S, H, Hk, D, dtype, causal, timed)
    for label, B, S, H, Hk, D, dtype, causal, timed in (
            ("training", 8, 512, 32, 4, 64, torch.bfloat16, True, True),
            ("training", 8, 512, 32, 4, 64, torch.bfloat16, False, False),
            ("ragged", 2, 100, 32, 4, 64, torch.bfloat16, True, False),
            ("g1", 2, 256, 8, 8, 64, torch.bfloat16, True, False),
            ("d128", 2, 256, 32, 4, 128, torch.bfloat16, True, False),
            ("long", 1, 2048, 32, 4, 64, torch.bfloat16, True, True),
            ("fp32", 2, 256, 32, 4, 64, torch.float32, True, False)):
        q, do = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, S, Hk, D, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                      return_lse=True)
        got = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal)
        want = flash_attention_bwd_plain(q, k, v, do, causal=causal)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[1]
        tol = BWD_TOL[name]
        for grad, g, w in zip(("dq", "dk", "dv"), got, want):
            err, wa = grad_err(g, w), w.float().abs()
            log(f"[kernels] flash_attention_bwd {label} {name} "
                f"causal={causal} B={B} S={S} H={H} Hk={Hk} D={D} {grad}: "
                f"||err||/||want|| {err:.3e} (tol {tol:g}), max_abs_err "
                f"{max_err(g, w):.3e}, |want| median {wa.median():.3e} "
                f"max {wa.max():.3e}")
            if not err <= tol:
                raise AssertionError(f"flash_attention_bwd {label} {name} "
                                     f"causal={causal} {grad}: "
                                     f"||err||/||want|| {err} > {tol}")
            if dtype is torch.bfloat16:
                worst = max(worst, max_err(g, w))
        if label == "training" and causal:
            # the rows unsplit: one range a key tile, the partials summed
            # from one term, within the same rule
            one = flash_attention_bwd_cuda(q, k, v, o, do, lse, n_split=1)
            errs = [grad_err(g, w) for g, w in zip(one, want)]
            log(f"[kernels] flash_attention_bwd {label} n_split=1: "
                f"||err||/||want|| dq, dk, dv "
                f"{', '.join(f'{e:.3e}' for e in errs)} (tol {tol:g})")
            if not max(errs) <= tol:
                raise AssertionError(f"flash_attention_bwd n_split=1: "
                                     f"||err||/||want|| {errs} > {tol}")
            for fault, (i, bad) in planted_faults(got, S).items():
                err = grad_err(bad, want[i])
                log(f"[kernels] flash_attention_bwd planted fault, "
                    f"{fault}: ||err||/||want|| {err:.3e} (must exceed "
                    f"{tol:g})")
                if not err > tol:
                    raise AssertionError(f"the backward's check passes a "
                                         f"planted fault: {fault}")
        if not timed:
            continue
        ms = timer.ms(lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse))
        passes = kernel_ms(torch, timer, lambda: flash_attention_bwd_cuda(
            q, k, v, o, do, lse), FLASH_BWD)
        plain_ms = timer.ms(
            lambda: flash_attention_bwd_plain(q, k, v, do), iters=10)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        try:
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
            lib_ms = timer.ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
        except TypeError:       # a torch without enable_gqa
            lib_ms = None
        # five causal products (S, dP, dV, dK, dQ) of 2 * B * H * S^2 / 2 * D
        # each; q, o, do, dq and k, v, dk, dv moved once (lse, 4 bytes a
        # row, read once)
        flops = 5 * 2 * B * H * S * S * D / 2
        nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        # this design also writes and reads back fp32 partial dk, dv: one
        # (64, D) slice of each a block of its dk/dv pass
        n_split = auto_split(B, Hk, S, S, H // Hk, True,
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
        ranges = split_plan(S, S, H // Hk, True, n_split)[1]
        part_bytes = 2 * 2 * B * Hk * ranges * 64 * D * 4
        bp_ms, bp_by = bound(flops, nbytes + part_bytes, PEAK_BF16_FLOPS)
        log(f"[kernels] flash_attention_bwd {label} bf16 causal B={B} S={S}: "
            f"{ms:.4f} ms (passes, profiled: "
            f"{', '.join(f'{n} {t:.4f}' for n, t in passes.items())} ms; "
            f"plain {plain_ms:.4f} ms, sdpa backward {lib_ms} ms, bound "
            f"{b_ms:.4f} ms by {b_by}: {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB; n_split {n_split}, {B * Hk * ranges} "
            f"dk/dv blocks, whose fp32 partials add {part_bytes / 1e6:.1f} "
            f"MB: bound with them {bp_ms:.4f} ms by {bp_by})")
        if label == "training":
            rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
    rec["max_abs_err"] = worst
    return rec


def _serving_model(torch, arch: str):
    """Full-depth model of ``arch`` on the card with seeded random weights,
    configured as ``serve_loop`` runs it for 512-token prompts."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    cfg = dataclasses.replace(get_config(arch), q_chunk=256, kv_chunk=256,
                              max_cache_len=544)
    model = build_model(cfg)
    params = init_params(model.param_decls(),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    return cfg, model, params


def _profile_report(prof, what: str, wall: float, steps: int,
                    ours: dict[str, tuple], top: int = 6) -> None:
    """Device kernel time of a profiled window: per step, its busy share of
    the wall time, the ``top`` largest kernels, and for each group of
    ``ours`` the share of the kernels whose names contain one of its
    fragments."""
    from torch.autograd import DeviceType
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    if not by_name:
        log(f"[profile] {what}: no device events traced; busy share not "
            "measured")
        return
    busy = sum(by_name.values()) / 1e6
    log(f"[profile] {what}, {steps} step(s) under the profiler: "
        f"{wall / steps * 1e3:.3f} ms/step wall, "
        f"{busy / steps * 1e3:.3f} ms/step of device kernels in "
        f"{n_kernels / steps:.0f} launches/step, busy share "
        f"{busy / wall:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile]   {us / steps / 1e3:.4f} ms/step "
            f"({us / 1e6 / busy:.3f})  {name[:90]}")
    for label, frags in ours.items():
        mine = [us for name, us in by_name.items()
                if any(frag in name for frag in frags)]
        log(f"[profile] {what}: {label} (kernels named {list(frags)}) take "
            f"{sum(mine) / 1e3 / steps:.4f} ms/step, a share of "
            f"{sum(mine) / 1e6 / busy:.3f} of the device time")


def profile_decode(torch, arch: str, ours: dict | None = None,
                   steps: int = 4) -> None:
    """Wall time and device kernel time of decode steps at the serving
    shape (batch 8, 512-token prompts, full depth), and the share of that
    device time spent in the port's kernels whose names contain one of
    ``ours``."""
    from torch.profiler import ProfilerActivity, profile
    cfg, model, params = _serving_model(torch, arch)
    tok = torch.randint(0, cfg.vocab, (8, 512), device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(8, 544, device="cuda")
        logits, cache = model.prefill(params, tok, cache)
        for _ in range(2):                                    # warm
            tok = logits[:, -1].argmax(-1)[:, None]
            logits, cache = model.decode_step(params, tok, cache)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                tok = logits[:, -1].argmax(-1)[:, None]
                logits, cache = model.decode_step(params, tok, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _profile_report(prof, f"{arch} decode at batch 8, after 514 tokens",
                    wall, steps, ours or {})


def profile_prefill(torch, arch: str, ours: dict) -> None:
    """Wall time and device kernel time of one prefill at the serving shape
    (batch 8, 512-token prompts, full depth, an empty cache), after a
    warm-up prefill, with the share of the kernels named in ``ours``."""
    from torch.profiler import ProfilerActivity, profile
    cfg, model, params = _serving_model(torch, arch)
    tok = torch.randint(0, cfg.vocab, (8, 512), device="cuda")
    with torch.inference_mode():
        model.prefill(params, tok, model.init_cache(8, 544, device="cuda"))
        cache = model.init_cache(8, 544, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.prefill(params, tok, cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _profile_report(prof, f"{arch} prefill at batch 8 x 512 tokens", wall,
                    1, ours)


def model_check(torch, arch: str) -> None:
    """Depth-2, full-width model: CUDA (kernels) vs CPU (plain path)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.param import tree_map
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              q_chunk=32, kv_chunk=32, max_cache_len=72)
    model = build_model(cfg)
    params_cpu = init_params(model.param_decls(),
                             torch.Generator().manual_seed(0), "cpu")
    params_gpu = tree_map(lambda a: a.to("cuda"), params_cpu)
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    with torch.inference_mode():
        for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
            cache = model.init_cache(2, cfg.max_cache_len, device=dev)
            _, cache = model.prefill(params, toks[:, :64].to(dev), cache)
            logits, _ = model.decode_step(params, toks[:, 64:].to(dev), cache)
            out[dev] = logits[:, 0].float().cpu()
    ref, got = out["cpu"], out["cuda"]
    rel = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
    same = bool((got.argmax(-1) == ref.argmax(-1)).all())
    log(f"[model] depth-2 {arch} prefill(64)+decode(1), cuda vs cpu: "
        f"rel={rel:.4f} (< 0.06) argmax_equal={same}")
    if not (rel < 0.06 and same):
        raise AssertionError("model check: CUDA and CPU logits disagree")


def _train_model():
    """Full tinyllama-1.1b, configured as ``train_loop`` runs it for
    512-token sequences."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    return build_model(dataclasses.replace(
        get_config("tinyllama-1.1b"), q_chunk=256, kv_chunk=256))


def profile_train(torch) -> None:
    """One train step of full-depth tinyllama (batch 8 x 512 tokens, remat,
    AdamW) under the profiler, after a warm step: busy share, the largest
    kernels, the flash forward's and backward's shares, the GEMMs' and the
    elementwise ops'; then the AdamW update alone under CUDA events."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.param import tree_items, tree_map
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.runtime import build_train_step, init_train_state
    model = _train_model()
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = init_train_state(model, opt, seed=0, device="cuda")
    step = build_train_step(model, opt)
    batch = {"tokens": torch.randint(0, model.cfg.vocab, (8, 513),
                                     device="cuda", dtype=torch.int32)}
    state, _ = step(state, batch)                             # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _profile_report(prof, "tinyllama-1.1b train step at batch 8 x 512 "
                    "tokens", wall, 1, {
                        "flash forward": FLASH_FWD,
                        "flash backward": FLASH_BWD,
                        "GEMMs": ("nvjet", "gemm", "cutlass", "xmma"),
                        "elementwise, reductions and copies": (
                            "elementwise", "reduce", "Memcpy", "copy")},
                    top=12)
    # the optimizer alone, with CUDA events (it writes into the state)
    grads = tree_map(torch.zeros_like, state.params)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    adamw_update(state.params, grads, state.opt, opt)
    end.record()
    torch.cuda.synchronize()
    log(f"[profile] tinyllama-1.1b AdamW update alone (eager, per leaf, "
        f"{len(tree_items(grads))} stacked leaves): "
        f"{start.elapsed_time(end):.2f} ms")


def _loss_and_grads(model, params, toks, dev: str):
    """The loss and every leaf's gradient (fp32, on the host) of ``params``
    copied to ``dev``."""
    from repro_torch.models.param import tree_items, tree_map
    leaves = tree_map(lambda a: a.to(dev, copy=True).requires_grad_(),
                      params)
    value = model.loss_fn(leaves, {"tokens": toks.to(dev)})
    value.backward()
    return float(value.detach()), {"/".join(p): t.grad.float().cpu()
                                   for p, t in tree_items(leaves)}


TRAIN_GRAD_TOL = 3e-2


def train_check(torch) -> None:
    """Depth-2, full-width tinyllama in bf16: the loss and every leaf's
    gradient of one train step on the card (the flash kernels) against the
    CPU (the plain path), same weights and batch (2 x 256 tokens), remat off
    (the launch counts of ``train_loop`` cover remat). Held: the loss within
    1e-2 relative; each leaf within ``TRAIN_GRAD_TOL`` (3e-2) of the CPU's,
    ||card - cpu|| / ||cpu||; and each layer's attention gradient as the
    backward kernel computed it inside the step (dq, dk, dv, with q, k, v
    and dO captured by hooks) against ``flash_attention_bwd_plain`` on the
    card on the same tensors, within the kernel check's ``BWD_TOL``.

    For this check only, the attention weights are drawn at std
    1/sqrt(fan-in): the reference's initializer draws them 8x (wq, wk, wv)
    and 5.7x (wo) larger (ROADMAP C), which leaves the bf16 gradients so
    ill-conditioned that two correct computations differ by ~30% of a leaf.
    At the true fan-in, ``tools/flash_bwd_tolerance.py`` finds two correct
    CPU computations (blockwise against exact softmax, bf16 against fp32)
    1.3-1.4% apart at most, and a backward with dv 10% low past a quarter of
    the keys 6.1% off on wv."""
    import math
    import repro_torch.models.attention as attention
    from repro_torch.data import DataConfig, SyntheticLM
    from flash_bwd_tolerance import grad_err
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain
    from repro_torch.models import build_model, init_params
    seq = 256
    model = build_model(dataclasses.replace(
        get_config("tinyllama-1.1b"), n_layers=2, remat=False,
        q_chunk=seq // 2, kv_chunk=seq // 2))
    params = init_params(model.param_decls(),
                         torch.Generator().manual_seed(0), "cpu")
    cfg, attn = model.cfg, params["layers"]["attn"]
    for n in ("wq", "wk", "wv"):            # (L, M, H, D): fan-in M
        attn[n] = (attn[n].float() * math.sqrt(attn[n].shape[-2]
                                               / cfg.d_model)).bfloat16()
    attn["wo"] = (attn["wo"].float() / math.sqrt(      # (L, H, D, M)
        attn["wo"].shape[-3])).bfloat16()
    toks = torch.as_tensor(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=2)).batch_at(0)["tokens"])

    kernels_core, seen = attention._prefill_core, []

    def capturing_core(q, k, v, cfg):
        out = kernels_core(q, k, v, cfg)
        rec = {"q": q.detach(), "k": k.detach(), "v": v.detach()}
        for name, t in (("dq", q), ("dk", k), ("dv", v), ("do", out)):
            t.register_hook(lambda g, name=name: rec.update({name: g}))
        seen.append(rec)
        return out
    attention._prefill_core = capturing_core
    try:
        loss, grads = _loss_and_grads(model, params, toks, "cuda")
    finally:
        attention._prefill_core = kernels_core
    ref_loss, ref_grads = _loss_and_grads(model, params, toks, "cpu")

    rel = abs(loss - ref_loss) / abs(ref_loss)
    errs = {k: grad_err(grads[k], w) for k, w in ref_grads.items()}
    top = sorted(errs, key=lambda k: -errs[k])[:4]
    attn_errs = []
    for rec in seen:
        want = flash_attention_bwd_plain(rec["q"], rec["k"], rec["v"],
                                         rec["do"])
        attn_errs.append([grad_err(rec[n], w)
                          for n, w in zip(("dq", "dk", "dv"), want)])
    log(f"[model] depth-2 tinyllama-1.1b bf16 train step (attention weights "
        f"at std 1/sqrt(fan-in)), cuda vs cpu: loss {loss:.6f} vs "
        f"{ref_loss:.6f} (rel {rel:.2e}, tol 1e-2); worst ||diff||/||g|| "
        f"{', '.join(f'{k} {errs[k]:.2e}' for k in top)} (tol "
        f"{TRAIN_GRAD_TOL:g}); the backward kernel in the step against the "
        f"plain version, per layer (dq, dk, dv): "
        f"{[[f'{e:.2e}' for e in l] for l in attn_errs]} (tol "
        f"{BWD_TOL['bfloat16']:g})")
    if len(seen) != cfg.n_layers or not all(
            len(rec) == 7 for rec in seen):
        raise AssertionError(f"train check: captured {len(seen)} attention "
                             f"calls, want {cfg.n_layers} with gradients")
    if not (rel < 1e-2 and max(errs.values()) <= TRAIN_GRAD_TOL
            and max(map(max, attn_errs)) <= BWD_TOL["bfloat16"]):
        raise AssertionError("bf16 train check: CUDA and CPU disagree")


def resume_check(torch) -> None:
    """Depth-2, full-width tinyllama through ``train_loop`` on the card:
    six steps uninterrupted; six again with a checkpoint every 2 steps and a
    simulated crash after step 4; then a resume, which must start at step 4
    and reproduce the uninterrupted losses (rtol 2e-2, as
    tests/test_runtime.py holds the reference). Checkpoints (2.2 GB each)
    go to build/, which the run deletes after."""
    import shutil
    from repro_torch.launch import train as train_mod
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    full_depth = train_mod.get_config

    def depth2(arch, *, reduced=False):
        return dataclasses.replace(full_depth(arch, reduced=reduced),
                                   n_layers=2)
    kw = dict(steps=6, batch=4, seq=256, seed=3, log_every=0, device="cuda")
    train_mod.get_config = depth2
    try:
        t0 = time.perf_counter()
        full = train_mod.train_loop("tinyllama-1.1b", **kw)
        try:
            train_mod.train_loop("tinyllama-1.1b", ckpt_dir=str(ckpt),
                                 ckpt_every=2, simulate_failure=4, **kw)
        except RuntimeError as exc:
            if "simulated" not in str(exc):
                raise
        else:
            raise AssertionError("train_loop did not simulate its failure")
        resumed = train_mod.train_loop("tinyllama-1.1b", ckpt_dir=str(ckpt),
                                       ckpt_every=2, resume=True, **kw)
        seconds = time.perf_counter() - t0
    finally:
        train_mod.get_config = full_depth
        shutil.rmtree(ckpt, ignore_errors=True)
    worst = max(abs(a - b) / abs(b) for a, b in
                zip(resumed["losses"], full["losses"][4:]))
    log(f"[model] depth-2 tinyllama-1.1b crash after step 4 and resume: "
        f"start_step {resumed['start_step']}, losses {resumed['losses']} vs "
        f"uninterrupted {full['losses'][4:]} (max rel {worst:.2e}, tol "
        f"2e-2); {seconds:.1f} s with checkpoints")
    if resumed["start_step"] != 4 or len(resumed["losses"]) != 2 \
            or not worst < 2e-2:
        raise AssertionError("resume did not reproduce the trajectory")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as decode_k
    from repro_torch.kernels.flash_attention import kernel as flash_k
    from repro_torch.kernels.flash_attention import kernel_bwd as flash_bwd_k
    from repro_torch.kernels.ssd import kernel as ssd_k
    from repro_torch.launch.serve import serve_loop
    from repro_torch.launch.train import train_loop
    from repro_torch.models import param_count

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

    counters = {"flash_attention": flash_k, "flash_attention_bwd": flash_bwd_k,
                "decode_attention": decode_k, "ssd": ssd_k}

    def serve_counted(arch: str, layers: int, vocab: int) -> dict:
        serve = dict(batch=8, prompt_len=512, gen_tokens=32, seed=0,
                     device="cuda")
        out = serve_loop(arch, **serve)
        log(f"[serve] {arch} first call (cold): prefill "
            f"{out['prefill_s']:.4f} s, decode {out['decode_s']:.4f} s, "
            f"{out['decode_tok_per_s']:.1f} tok/s")
        torch.cuda.reset_peak_memory_stats()
        for k in counters.values():
            k.launches = 0
        out = serve_loop(arch, **serve)
        counts = {name: k.launches for name, k in counters.items()}
        tokens = out["tokens"]
        log(f"[serve] {arch} batch=8 prompt=512 gen=32 ({layers} layers): "
            f"prefill {out['prefill_s']:.4f} s, decode "
            f"{out['decode_s']:.4f} s, {out['decode_tok_per_s']:.1f} tok/s; "
            f"launches {counts}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if tokens.shape != (8, 32) or tokens.min() < 0 \
                or tokens.max() >= vocab:
            raise AssertionError(f"{arch}: tokens {tokens.shape} out of "
                                 f"[0, {vocab})")
        return counts

    dense = serve_counted("tinyllama-1.1b", 22, 32000)
    if dense["flash_attention"] != 22 or dense["decode_attention"] != 22 * 31:
        raise AssertionError(f"tinyllama launches {dense}: want flash 22, "
                             f"decode {22 * 31}")
    ssm = serve_counted("mamba2-370m", 48, 50280)
    if ssm["ssd"] != 48:
        raise AssertionError(f"mamba2 launches {ssm}: want ssd 48")
    n_flash, n_decode, n_ssd = (dense["flash_attention"],
                                dense["decode_attention"], ssm["ssd"])

    # training: batch 8 x 512 tokens, full width and depth, remat on
    train = dict(batch=8, seq=512, seed=0, log_every=0, device="cuda")
    out = train_loop("tinyllama-1.1b", steps=2, **train)
    log(f"[train] tinyllama-1.1b first call (cold), 2 steps: "
        f"{out['wall_s'] / 2 * 1e3:.1f} ms/step, losses {out['losses']}")
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    steps = 4
    out = train_loop("tinyllama-1.1b", steps=steps, **train)
    counts = {name: k.launches for name, k in counters.items()}
    n_params = param_count(_train_model().param_decls())
    share = 6 * n_params * out["tokens_per_s"] / PEAK_BF16_FLOPS
    log(f"[train] tinyllama-1.1b batch=8 seq=512 ({n_params / 1e9:.3f} B "
        f"params, 22 layers, remat) {steps} steps: "
        f"{out['wall_s'] / steps * 1e3:.1f} ms/step, "
        f"{out['tokens_per_s']:.0f} tokens/s; losses {out['losses']}; "
        f"launches {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; derived: "
        f"6 * N * tokens/s / 989 TFLOP/s = {share:.3f}")
    want = {"flash_attention": steps * 44, "flash_attention_bwd": steps * 22,
            "decode_attention": 0, "ssd": 0}
    if counts != want:
        raise AssertionError(f"training launches {counts}: want {want} "
                             "(44 forward a step: 22 and 22 recomputed "
                             "under remat; 22 backward)")
    if len(out["losses"]) != steps or not all(
            l == l and abs(l) < float("inf") for l in out["losses"]):
        raise AssertionError(f"training losses {out['losses']}")
    n_flash_bwd = counts["flash_attention_bwd"]

    profile_decode(torch, "tinyllama-1.1b", ours={
        "decode_attention": ("split_kernel", "combine_kernel")})
    profile_decode(torch, "mamba2-370m")
    profile_prefill(torch, "mamba2-370m", ours={"ssd": ("ssd",)})
    profile_train(torch)
    for arch in ("tinyllama-1.1b", "mamba2-370m"):
        model_check(torch, arch)
    train_check(torch)
    resume_check(torch)

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
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
