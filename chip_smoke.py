#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` (flash_attention,
   decode_attention, ssd) for ``sm_90a`` into ``build/repro_torch/`` (one
   process per source, in parallel);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the serving paths' shapes (bf16 2e-2, fp32 2e-5 absolute, the JAX
   package's kernel tolerances, 5x those relative for ssd's output and 1e-4
   relative for its final state; TF32 off), with CUDA-event times of the
   kernel, the plain version and, where one exists, one PyTorch library
   call as a yardstick, and the least time the card could take
   (``bound_ms``);
4. main paths, each at full width and depth on seeded random weights, batch
   8, 512-token prompts, 32 new tokens: ``serve_loop("tinyllama-1.1b")``
   (flash and decode attention) and ``serve_loop("mamba2-370m")`` (ssd at
   prefill; decode is the plain recurrence), each once to warm up (the
   first call of each shape pays one-time library and module-loading
   costs) and once counted, its kernels' launch counts set to 0 just before
   and read just after: they must show every layer of the counted run went
   through them;
5. profile: ``torch.profiler`` over a few decode steps of each model, for
   the device's busy share and the kernels that take its time;
6. model check: a depth-2, full-width model of each arch on the card
   against the same model on the CPU's plain path (relative error < 0.06,
   equal argmax).

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


def check_flash(torch, timer, gen) -> dict:
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    F = torch.nn.functional
    B, S, H, Hk, D = 8, 512, 32, 4, 64
    rec, worst = None, 0.0
    for dtype, causal in ((torch.bfloat16, True), (torch.bfloat16, False),
                          (torch.float32, True)):
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, S, Hk, D, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, S, Hk, D, generator=gen, device="cuda").to(dtype)
        got = flash_attention_cuda(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = max_err(got, want)
        name = str(dtype).split(".")[1]
        log(f"[kernels] flash_attention {name} causal={causal} "
            f"B={B} S={S} H={H} Hk={Hk} D={D}: max_abs_err={err:.3e} "
            f"(tol {TOL[name]:g})")
        if not err < TOL[name]:
            raise AssertionError(f"flash_attention {name} causal={causal}: "
                                 f"max_abs_err {err} >= {TOL[name]}")
        if dtype is torch.bfloat16:
            worst = max(worst, err)
        if dtype is torch.bfloat16 and causal:   # the prefill path's case
            ms = timer.ms(lambda: flash_attention_cuda(q, k, v, causal=True))
            plain_ms = timer.ms(
                lambda: flash_attention_plain(q, k, v, causal=True), iters=10)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            try:
                lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
            except TypeError:            # a torch without enable_gqa
                lib_ms = None
            flops = 4 * B * H * S * S * D / 2
            nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            log(f"[kernels] flash_attention bf16 causal: {ms:.4f} ms "
                f"(plain {plain_ms:.4f} ms, sdpa {lib_ms} ms, "
                f"bound {b_ms:.4f} ms by {b_by})")
    rec["max_abs_err"] = worst
    return rec


def check_decode(torch, timer, gen) -> dict:
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_plain)
    F = torch.nn.functional
    B, L, H, Hk, D = 8, 544, 32, 4, 64
    timed_len = 528           # the mean cache length of the serving path
    rec, worst = None, 0.0
    for dtype, lengths in ((torch.bfloat16, (1, 63, 300, timed_len, 544)),
                           (torch.float32, (300,))):
        name = str(dtype).split(".")[1]
        # one layer's view of a stacked cache, as the model passes it
        cache_k = torch.randn(2, B, L, Hk, D, generator=gen,
                              device="cuda").to(dtype)
        cache_v = torch.randn(2, B, L, Hk, D, generator=gen,
                              device="cuda").to(dtype)
        k, v = cache_k[1], cache_v[1]
        q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(dtype)
        for n in lengths:
            length = torch.tensor(n, dtype=torch.int32, device="cuda")
            got = decode_attention_cuda(q, k, v, length)
            want = decode_attention_plain(q, k, v, length)
            torch.cuda.synchronize()
            err = max_err(got, want)
            log(f"[kernels] decode_attention {name} B={B} L={L} length={n}: "
                f"max_abs_err={err:.3e} (tol {TOL[name]:g})")
            if not err < TOL[name]:
                raise AssertionError(f"decode_attention {name} length={n}: "
                                     f"max_abs_err {err} >= {TOL[name]}")
            if dtype is torch.bfloat16:
                worst = max(worst, err)
            if dtype is torch.bfloat16 and n == timed_len:
                ms = timer.ms(lambda: decode_attention_cuda(q, k, v, length))
                plain_ms = timer.ms(
                    lambda: decode_attention_plain(q, k, v, length))
                qt = q.transpose(1, 2)
                kt, vt = k[:, :n].transpose(1, 2), v[:, :n].transpose(1, 2)
                try:
                    lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, enable_gqa=True))
                except TypeError:
                    lib_ms = None
                flops = 4 * B * H * n * D
                nbytes = 2 * (2 * B * Hk * n * D + 2 * q.numel())
                b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
                rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
                log(f"[kernels] decode_attention bf16 length={n}: "
                    f"{ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa {lib_ms} ms, "
                    f"bound {b_ms:.4f} ms by {b_by})")
    # stale tail: garbage past `length` must not reach the output
    length = torch.tensor(300, dtype=torch.int32, device="cuda")
    k, v = cache_k[1].clone(), cache_v[1].clone()
    clean = decode_attention_cuda(q, k, v, length)
    k[:, 300:] = 1e4
    v[:, 300:] = float("nan")
    dirty = decode_attention_cuda(q, k, v, length)
    torch.cuda.synchronize()
    if not torch.equal(clean, dirty):
        raise AssertionError("decode_attention read the cache past length")
    log("[kernels] decode_attention stale tail past length=300: "
        "output unchanged")
    rec["max_abs_err"] = worst
    return rec


def check_ssd(torch, timer, gen) -> dict:
    """The SSD kernel against its plain version: y (relative to its largest
    magnitude, 5x the bf16/fp32 tolerance, as tests/test_kernels.py holds
    the Pallas kernel) and the final state (relative, 1e-4, the bound
    tests/test_models.py holds chunk lengths 4-32 to)."""
    from repro_torch.kernels.ssd import kernel as ssd_k
    from repro_torch.kernels.ssd import ssd_cuda, ssd_plain
    H, P, N = 32, 64, 128
    F = torch.nn.functional

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def rel(got, want) -> float:
        return max_err(got, want) / (float(want.float().abs().max()) + 1e-30)

    rec, worst = None, 0.0
    # (label, batch, S, heads, x/B/C dtype, dt dtype, plain chunk, state0,
    #  timed): the serving shape as the model passes it (chunk 256), with
    # the zero state of a first prefill and a random one; all fp32; a
    # ragged S (not a multiple of the kernel's 64); a long S
    for label, B, S, Hc, dtype, dt_dtype, chunk, with_state, timed in (
            ("serving", 8, 512, H, torch.bfloat16, torch.float32, 256,
             False, False),
            ("serving", 8, 512, H, torch.bfloat16, torch.float32, 256,
             True, True),
            ("fp32", 2, 512, H, torch.float32, torch.float32, 128, True,
             False),
            ("ragged", 2, 200, 8, torch.bfloat16, torch.float32, 40, True,
             False),
            ("long", 1, 8192, 4, torch.float32, torch.float32, 256, True,
             False)):
        x = randn(B, S, Hc, P, dtype=dtype)
        dt = F.softplus(randn(B, S, Hc)).to(dt_dtype)
        A = -torch.exp(randn(Hc))
        Bm, Cm = randn(B, S, N, dtype=dtype), randn(B, S, N, dtype=dtype)
        state0 = randn(B, Hc, P, N) if with_state else None
        y, st = ssd_cuda(x, dt, A, Bm, Cm, state0=state0)
        y_ref, st_ref = ssd_plain(x, dt, A, Bm, Cm, chunk=chunk,
                                  state0=state0)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[1]
        err_y, err_s = rel(y, y_ref), rel(st, st_ref)
        finite = bool(torch.isfinite(y).all() and torch.isfinite(st).all())
        log(f"[kernels] ssd {label} x={name} dt={str(dt_dtype)[6:]} B={B} "
            f"S={S} H={Hc} P={P} N={N} state0={'random' if with_state else 'zero'}"
            f": y rel={err_y:.3e} (tol {5 * TOL[name]:g}), state "
            f"rel={err_s:.3e} (tol 1e-4), finite={finite}")
        if not (err_y < 5 * TOL[name] and err_s < 1e-4 and finite):
            raise AssertionError(f"ssd {label}: y rel {err_y}, state rel "
                                 f"{err_s}, finite {finite}")
        worst = max(worst, max_err(y, y_ref))
        if timed:
            launches = ssd_k.launches
            ms = timer.ms(lambda: ssd_cuda(x, dt, A, Bm, Cm, state0=state0))
            plain_ms = timer.ms(lambda: ssd_plain(
                x, dt, A, Bm, Cm, chunk=chunk, state0=state0), iters=10)
            ssd_k.launches = launches     # timing launches are not the path's
            # the work of the kernel's chunks (Q = 64), lower triangle of
            # each chunk's Q x Q products only
            Q = 64
            tri = Q * (Q + 1) // 2
            flops = B * Hc * (S // Q) * (2 * tri * (N + P) + 4 * Q * P * N)
            nbytes = (2 * 2 * x.numel() + 4 * dt.numel() + 4 * A.numel()
                      + 2 * (Bm.numel() + Cm.numel()) + 2 * 4 * st.numel())
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by}
            log(f"[kernels] ssd serving bf16: {ms:.4f} ms (plain "
                f"{plain_ms:.4f} ms, no library call computes SSD, bound "
                f"{b_ms:.4f} ms by {b_by})")
    rec["max_abs_err"] = worst
    return rec


def profile_decode(torch, arch: str, steps: int = 4) -> None:
    """Wall time and device kernel time of decode steps at the serving
    shape (batch 8, 512-token prompts, full depth)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    cfg = dataclasses.replace(get_config(arch), q_chunk=256, kv_chunk=256,
                              max_cache_len=544)
    model = build_model(cfg)
    params = init_params(model.param_decls(),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
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
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    if not by_name:
        log(f"[profile] {arch} decode: no device events traced; busy share "
            "not measured")
        return
    log(f"[profile] {arch} decode at batch 8, after 514 tokens, {steps} steps "
        f"under the profiler: {wall / steps * 1e3:.3f} ms/step wall, "
        f"{busy / steps * 1e3:.3f} ms/step of device kernels in "
        f"{n_kernels / steps:.0f} launches/step, busy share "
        f"{busy / wall:.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[profile]   {us / steps / 1e3:.4f} ms/step  {name[:90]}")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as decode_k
    from repro_torch.kernels.flash_attention import kernel as flash_k
    from repro_torch.kernels.ssd import kernel as ssd_k
    from repro_torch.launch.serve import serve_loop

    log(f"[card] {card_line()}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    report = _build.build()
    log(f"[build] {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[kernels] TF32 off for fp32 matmuls and convolutions")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = check_flash(torch, timer, gen)
    decode = check_decode(torch, timer, gen)
    ssd = check_ssd(torch, timer, gen)

    counters = {"flash_attention": flash_k, "decode_attention": decode_k,
                "ssd": ssd_k}

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

    for arch in ("tinyllama-1.1b", "mamba2-370m"):
        profile_decode(torch, arch)
    for arch in ("tinyllama-1.1b", "mamba2-370m"):
        model_check(torch, arch)

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
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
