"""The port on a CUDA card: each CUDA kernel against its plain version, and
the model's kernel path against its CPU plain path. Every test is marked
``cuda`` and skips without a card. This file imports no JAX, so it runs on
a machine that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernel tolerances are tests/test_kernels.py's (2e-5 absolute in fp32 with
TF32 off, 2e-2 in bf16; for ssd, relative to y's largest magnitude, 5x those,
and 1e-4 relative for its final state, tests/test_models.py's bound between
chunk lengths); the model is held to tests/test_archs.py's bound (rel < 0.06
of the largest logit, equal argmax). The flash backward kernel is held to
autograd through its plain version: ||got - want|| <= 1e-2 ||want|| in
bf16 (P and dS enter the products rounded to bf16, as the forward rounds P;
~0.3% by tools/flash_bwd_tolerance.py), 1e-4 ||want|| in fp32. The rows'
log-sum-exp that the flash forward writes for it is held to its plain
version within 1e-4 absolute (fp32: ex2.approx, ~2 ulp a term, and the
online rescaling, against an exact logsumexp; |lse| < 10 here).
"""

import dataclasses

import pytest
import torch

import repro_torch.kernels.decode_attention.kernel as decode_kernel
import repro_torch.kernels.flash_attention.kernel as flash_kernel
import repro_torch.kernels.flash_attention.kernel_bwd as flash_bwd_kernel
import repro_torch.kernels.ssd.kernel as ssd_kernel
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda,
                                                 flash_attention_lse_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention.kernel_bwd import split_plan
from repro_torch.kernels.ssd import ssd, ssd_plain
from repro_torch.launch.serve import serve_loop
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model, init_params
from repro_torch.models.attention import attention
from repro_torch.models.param import tree_map

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,D", [
    (1, 32, 2, 2, 16), (2, 64, 4, 2, 32), (1, 100, 8, 2, 64),
    (8, 512, 32, 4, 64), (1, 64, 12, 2, 128), (2, 8, 6, 1, 32),
    (2, 100, 32, 4, 64),                  # ragged S: a partial last tile
    (2, 256, 32, 4, 128),                 # D = 128: two swizzle panels
    (2, 256, 8, 8, 64),                   # G = 1: 128 positions a block
    (2, 200, 64, 4, 64),                  # G = 16: 8 positions a block
    (1, 2048, 32, 4, 64)])                # a long prompt
def test_flash_cuda_matches_plain(dtype, causal, B, S, H, Hk, D):
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = randn(gen, B, S, H, D, dtype=tdt)
    k = randn(gen, B, S, Hk, D, dtype=tdt)
    v = randn(gen, B, S, Hk, D, dtype=tdt)
    before = flash_kernel.launches
    got = flash_attention(q, k, v, causal=causal, block_q=S, block_k=S)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,D", [
    (1, 32, 2, 2, 16), (2, 64, 4, 2, 32), (2, 100, 32, 4, 64),
    (8, 512, 32, 4, 64), (2, 256, 32, 4, 128), (2, 256, 8, 8, 64),
    (2, 200, 64, 4, 64), (1, 48, 6, 2, 16), (1, 2048, 32, 4, 64)])
def test_flash_cuda_lse_matches_plain(dtype, causal, B, S, H, Hk, D):
    """The rows' log-sum-exp the forward writes when asked, in the folded
    (B, Hk, Sq * G) layout, against its plain version; the output is the
    same as without it."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = randn(gen, B, S, H, D, dtype=tdt)
    k = randn(gen, B, S, Hk, D, dtype=tdt)
    v = randn(gen, B, S, Hk, D, dtype=tdt)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    want = flash_attention_lse_plain(q, k, causal=causal)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert float((lse - want).abs().max()) < LSE_TOL
    assert torch.equal(out, flash_attention_cuda(q, k, v, causal=causal))


def test_flash_serving_call_allocates_no_lse():
    """Without grad (serving) the forward asks for no lse: the call
    allocates its output and nothing more."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    q = randn(gen, 2, 256, 32, 64, dtype=torch.bfloat16)
    k = randn(gen, 2, 256, 4, 64, dtype=torch.bfloat16)
    v = randn(gen, 2, 256, 4, 64, dtype=torch.bfloat16)
    flash_attention(q, k, v)                      # build and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base == \
        out.numel() * out.element_size()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cuda_reads_strided_views(dtype):
    """q, k, v as views of one fused (B, S, H + 2 Hk, D) projection: the
    kernel reads them through their strides, with no copy."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, S, H, Hk, D = 2, 96, 8, 2, 64
    qkv = randn(gen, B, S, H + 2 * Hk, D, dtype=tdt)
    q, k, v = qkv.split([H, Hk, Hk], dim=2)
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, causal=True, block_q=S, block_k=S)
    want = flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [1, 63, 64, 65, 300, 544])
def test_decode_cuda_matches_plain(dtype, length):
    """Lengths 63, 64, 65 sit on the first boundary of the kernel's 64-key
    splits; 544 fills the cache (9 splits, the last one half full)."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, L, H, Hk, D = 8, 544, 32, 4, 64
    cache_k = randn(gen, 2, B, L, Hk, D, dtype=tdt)   # a stacked cache
    cache_v = randn(gen, 2, B, L, Hk, D, dtype=tdt)
    q = randn(gen, B, 1, H, D, dtype=tdt)
    n = torch.tensor(length, dtype=torch.int32, device="cuda")
    before = decode_kernel.launches
    got = decode_attention(q, cache_k[1], cache_v[1], n, block_k=L)
    want = decode_attention_plain(q, cache_k[1], cache_v[1], n)
    torch.cuda.synchronize()
    assert decode_kernel.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) < TOL[dtype]


@pytest.mark.parametrize("B,H,Hk,D,L", [(2, 8, 2, 32, 256),
                                        (1, 4, 4, 16, 256),
                                        (3, 6, 1, 64, 256),
                                        (2, 32, 4, 128, 1000),
                                        (2, 4, 4, 64, 544),     # G = 1
                                        (2, 64, 4, 64, 544),    # G = 16
                                        (1, 8, 1, 256, 200)])   # D = 256
def test_decode_cuda_other_shapes(B, H, Hk, D, L):
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = randn(gen, B, 1, H, D, dtype=torch.bfloat16)
    k = randn(gen, B, L, Hk, D, dtype=torch.bfloat16)
    v = randn(gen, B, L, Hk, D, dtype=torch.bfloat16)
    for length in (1, L // 3, L):
        n = torch.tensor(length, dtype=torch.int32, device="cuda")
        got = decode_attention(q, k, v, n, block_k=L)
        want = decode_attention_plain(q, k, v, n)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) < 2e-2


def test_decode_cuda_long_cache_batch_one():
    """Batch 1 against an 8192-key cache: 128 splits for each of the 4 KV
    heads, merged by the combine kernel."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = randn(gen, 1, 1, 32, 64, dtype=torch.bfloat16)
    k = randn(gen, 1, 8192, 4, 64, dtype=torch.bfloat16)
    v = randn(gen, 1, 8192, 4, 64, dtype=torch.bfloat16)
    n = torch.tensor(8000, dtype=torch.int32, device="cuda")
    got = decode_attention(q, k, v, n, block_k=512)
    want = decode_attention_plain(q, k, v, n)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < 2e-2


def test_decode_cuda_graph_replay_follows_length():
    """A decode call captured in a CUDA graph reads `length` on the device:
    replayed after the length changes, it equals an eager call."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = randn(gen, 8, 1, 32, 64, dtype=torch.bfloat16)
    k = randn(gen, 8, 544, 4, 64, dtype=torch.bfloat16)
    v = randn(gen, 8, 544, 4, 64, dtype=torch.bfloat16)
    n = torch.tensor(544, dtype=torch.int32, device="cuda")
    decode_attention(q, k, v, n, block_k=544)            # load the library
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_attention(q, k, v, n, block_k=544)
    for length in (1, 64, 65, 300):
        n.fill_(length)
        graph.replay()
        eager = decode_attention(q, k, v, n, block_k=544)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


def test_decode_cuda_ignores_stale_tail():
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = randn(gen, 2, 1, 8, 64, dtype=torch.bfloat16)
    k = randn(gen, 2, 128, 2, 64, dtype=torch.bfloat16)
    v = randn(gen, 2, 128, 2, 64, dtype=torch.bfloat16)
    n = torch.tensor(40, dtype=torch.int32, device="cuda")
    clean = decode_attention(q, k, v, n, block_k=128)
    k[:, 40:] = 1e4
    v[:, 40:] = float("nan")
    dirty = decode_attention(q, k, v, n, block_k=128)
    assert torch.equal(clean, dirty)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / (want.float().abs().max() + 1e-30))


@pytest.mark.parametrize("dtype,dt_dtype", [("float32", "float32"),
                                            ("bfloat16", "bfloat16"),
                                            ("bfloat16", "float32")])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 32, 2, 8, 16, 16), (2, 64, 4, 16, 32, 32), (1, 128, 8, 64, 128, 64),
    (2, 64, 4, 16, 32, 64), (2, 100, 3, 8, 16, 50),    # ragged: 100 % 64
    (8, 512, 32, 64, 128, 256),                        # the serving shape
    (2, 200, 4, 8, 128, 100),          # P = 8: half of a warp's 16 rows
    (2, 513, 32, 64, 128, 171),        # one position in the last chunk
    (1, 8192, 32, 64, 128, 256)])      # a long prompt at batch 1
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_cuda_matches_plain(dtype, dt_dtype, B, S, H, P, N, chunk,
                                with_state):
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = randn(gen, B, S, H, P, dtype=tdt)
    dt = torch.nn.functional.softplus(
        randn(gen, B, S, H, dtype=torch.float32)).to(getattr(torch, dt_dtype))
    A = -torch.exp(randn(gen, H, dtype=torch.float32))
    Bm, Cm = randn(gen, B, S, N, dtype=tdt), randn(gen, B, S, N, dtype=tdt)
    state0 = randn(gen, B, H, P, N, dtype=torch.float32) if with_state \
        else None
    before = ssd_kernel.launches
    y, st = ssd(x, dt, A, Bm, Cm, chunk=chunk, state0=state0)
    y_ref, st_ref = ssd_plain(x, dt, A, Bm, Cm, chunk=chunk, state0=state0)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1
    assert y.dtype == tdt and st.dtype == torch.float32
    assert _rel(y, y_ref) < 5 * TOL[dtype]
    assert _rel(st, st_ref) < 1e-4


def test_ssd_cuda_updates_a_stacked_state_in_place():
    """state0 and state_out as one layer's slice of a stacked cache: the
    kernel reads the slice, then writes the final state over it, and leaves
    the other layers alone."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    B, S, H, P, N = 2, 128, 4, 64, 128
    x = randn(gen, B, S, H, P, dtype=torch.bfloat16)
    dt = torch.nn.functional.softplus(randn(gen, B, S, H,
                                            dtype=torch.float32))
    A = -torch.exp(randn(gen, H, dtype=torch.float32))
    Bm = randn(gen, B, S, N, dtype=torch.bfloat16)
    Cm = randn(gen, B, S, N, dtype=torch.bfloat16)
    cache = randn(gen, 3, B, H, P, N, dtype=torch.float32)
    before = cache.clone()
    y_ref, st_ref = ssd_plain(x, dt, A, Bm, Cm, chunk=64, state0=cache[1])
    y, st = ssd(x, dt, A, Bm, Cm, chunk=64, state0=cache[1],
                state_out=cache[1])
    torch.cuda.synchronize()
    assert st.data_ptr() == cache[1].data_ptr()
    assert _rel(y, y_ref) < 5 * TOL["bfloat16"] and _rel(st, st_ref) < 1e-4
    assert torch.equal(cache[0], before[0]) and torch.equal(cache[2],
                                                            before[2])


def _ssd_serving_inputs(gen, B=8, S=512, H=32, P=64, N=128):
    x = randn(gen, B, S, H, P, dtype=torch.bfloat16)
    dt = torch.nn.functional.softplus(randn(gen, B, S, H,
                                            dtype=torch.float32))
    A = -torch.exp(randn(gen, H, dtype=torch.float32))
    Bm = randn(gen, B, S, N, dtype=torch.bfloat16)
    Cm = randn(gen, B, S, N, dtype=torch.bfloat16)
    return x, dt, A, Bm, Cm


def test_ssd_cuda_in_place_at_the_serving_shape():
    """As the model calls it: state0 and state_out the same layer slice of a
    stacked fp32 cache, at mamba2-370m's prefill shape."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    x, dt, A, Bm, Cm = _ssd_serving_inputs(gen)
    cache = randn(gen, 3, 8, 32, 64, 128, dtype=torch.float32)
    before = cache.clone()
    y_ref, st_ref = ssd_plain(x, dt, A, Bm, Cm, chunk=256, state0=before[1])
    y, st = ssd(x, dt, A, Bm, Cm, chunk=256, state0=cache[1],
                state_out=cache[1])
    torch.cuda.synchronize()
    assert st.data_ptr() == cache[1].data_ptr()
    assert _rel(y, y_ref) < 5 * TOL["bfloat16"] and _rel(st, st_ref) < 1e-4
    assert torch.equal(cache[0], before[0]) and torch.equal(cache[2],
                                                            before[2])


def test_ssd_cuda_takes_unaligned_views():
    """x, B and C as views whose rows do not start on 16 bytes (the bf16
    kernel's copy size): the launcher copies them, the result is the plain
    scan's."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    B, S, H, P, N = 2, 100, 3, 16, 32
    x = randn(gen, B, S, H, P + 1, dtype=torch.bfloat16)[..., 1:]
    dt = torch.nn.functional.softplus(randn(gen, B, S, H,
                                            dtype=torch.float32))
    A = -torch.exp(randn(gen, H, dtype=torch.float32))
    Bm = randn(gen, B, S, N + 4, dtype=torch.bfloat16)[..., 4:]
    Cm = randn(gen, B, S, N + 4, dtype=torch.bfloat16)[..., 4:]
    y, st = ssd(x, dt, A, Bm, Cm, chunk=50)
    y_ref, st_ref = ssd_plain(x, dt, A, Bm, Cm, chunk=50)
    torch.cuda.synchronize()
    assert _rel(y, y_ref) < 5 * TOL["bfloat16"] and _rel(st, st_ref) < 1e-4


def test_ssd_cuda_long_context_is_finite():
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, S, H, P, N = 1, 8192, 2, 8, 16
    x = randn(gen, B, S, H, P, dtype=torch.float32)
    dt = torch.nn.functional.softplus(randn(gen, B, S, H,
                                            dtype=torch.float32))
    A = -torch.exp(randn(gen, H, dtype=torch.float32))
    Bm = randn(gen, B, S, N, dtype=torch.float32)
    Cm = randn(gen, B, S, N, dtype=torch.float32)
    y, st = ssd(x, dt, A, Bm, Cm, chunk=256)
    y_ref, st_ref = ssd_plain(x, dt, A, Bm, Cm, chunk=256)
    assert bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    assert _rel(y, y_ref) < 5 * TOL["float32"] and _rel(st, st_ref) < 1e-4


def _reduced_model(arch="tinyllama-1.1b"):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              q_chunk=16, kv_chunk=16)
    model = build_model(cfg)
    params = init_params(model.param_decls(),
                         torch.Generator().manual_seed(0), "cpu")
    return model, params


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-370m"])
def test_lm_cuda_matches_cpu(arch):
    """prefill(16) + decode(1) of the reduced model: the kernel path on the
    card against the plain path on the CPU, same weights."""
    model, params_cpu = _reduced_model(arch)
    params_gpu = tree_map(lambda a: a.to("cuda"), params_cpu)
    toks = torch.randint(0, 256, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        cache = model.init_cache(2, model.cfg.max_cache_len, device=dev)
        _, cache = model.prefill(params, toks[:, :16].to(dev), cache)
        logits, _ = model.decode_step(params, toks[:, 16:].to(dev), cache)
        out[dev] = logits[:, 0].float().cpu()
    ref, got = out["cpu"], out["cuda"]
    assert float((got - ref).abs().max() / ref.abs().max()) < 0.06
    assert bool((got.argmax(-1) == ref.argmax(-1)).all())


def test_serve_loop_cuda_goes_through_the_kernels():
    flash_kernel.launches = decode_kernel.launches = 0
    out = serve_loop("tinyllama-1.1b", batch=2, prompt_len=32, gen_tokens=5,
                     reduced=True)
    assert out["tokens"].shape == (2, 5)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 256)).all()
    n_layers = get_config("tinyllama-1.1b", reduced=True).n_layers
    assert flash_kernel.launches == n_layers
    assert decode_kernel.launches == n_layers * 4


def test_mamba2_depth2_full_width_cuda_matches_cpu():
    """Two layers of mamba2-370m at full width (H=32, P=64, N=128):
    prefill(64) through the ssd kernel + decode(1) on the card against the
    plain path on the CPU."""
    cfg = dataclasses.replace(get_config("mamba2-370m"), n_layers=2,
                              q_chunk=32)
    model = build_model(cfg)
    params_cpu = init_params(model.param_decls(),
                             torch.Generator().manual_seed(0), "cpu")
    params_gpu = tree_map(lambda a: a.to("cuda"), params_cpu)
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    ssd_kernel.launches = 0
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        cache = model.init_cache(2, 65, device=dev)
        _, cache = model.prefill(params, toks[:, :64].to(dev), cache)
        logits, _ = model.decode_step(params, toks[:, 64:].to(dev), cache)
        out[dev] = logits[:, 0].float().cpu()
    assert ssd_kernel.launches == 2
    ref, got = out["cpu"], out["cuda"]
    assert float((got - ref).abs().max() / ref.abs().max()) < 0.06
    assert bool((got.argmax(-1) == ref.argmax(-1)).all())


def test_serve_loop_mamba2_goes_through_the_ssd_kernel():
    ssd_kernel.launches = 0
    out = serve_loop("mamba2-370m", batch=2, prompt_len=32, gen_tokens=5,
                     reduced=True)
    assert out["tokens"].shape == (2, 5)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 256)).all()
    # one launch per layer, at prefill only: decode is the plain recurrence
    assert ssd_kernel.launches == get_config("mamba2-370m",
                                             reduced=True).n_layers


def _bwd_close(got, want, dtype) -> bool:
    """||got - want|| / ||want|| within 1e-2 (bf16) or 1e-4 (fp32), the
    rule of chip_smoke.py: a bound on the largest magnitude would pass a
    causal dk or dv that is wrong on most keys, whose values are ~100x
    smaller than the first keys'."""
    got, want = got.double(), want.double()
    err = float((got - want).norm() / want.norm())
    return err <= (1e-2 if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,D", [
    (8, 512, 32, 4, 64),                  # the training shape
    (2, 100, 32, 4, 64),                  # ragged S: partial tiles
    (2, 256, 8, 8, 128),                  # G = 1, D = 128
    (1, 48, 6, 2, 16),                    # G = 3 (rows of a tile split
    (1, 40, 6, 3, 32)])                   # positions), small D
def test_flash_bwd_cuda_matches_plain(dtype, causal, B, S, H, Hk, D):
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = randn(gen, B, S, H, D, dtype=tdt)
    k = randn(gen, B, S, Hk, D, dtype=tdt)
    v = randn(gen, B, S, Hk, D, dtype=tdt)
    do = randn(gen, B, S, H, D, dtype=tdt)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    before = flash_bwd_kernel.launches
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal)
    want = flash_attention_bwd_plain(q, k, v, do, causal=causal)
    torch.cuda.synchronize()
    assert flash_bwd_kernel.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == tdt
        assert _bwd_close(g, w, dtype)


@pytest.mark.parametrize("n_split", [None, 1, 4])
def test_flash_bwd_cuda_is_deterministic(n_split):
    """Two calls give the same bits, with the rows split over ranges whose
    fp32 partials are summed in a fixed order too."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, do = (randn(gen, 2, 256, 32, 64, dtype=torch.bfloat16)
             for _ in range(2))
    k, v = (randn(gen, 2, 256, 4, 64, dtype=torch.bfloat16)
            for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    a = flash_attention_bwd_cuda(q, k, v, o, do, lse, n_split=n_split)
    b = flash_attention_bwd_cuda(q, k, v, o, do, lse, n_split=n_split)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,D,n_split", [
    (8, 512, 32, 4, 64, 4), (2, 100, 32, 4, 64, 3), (2, 256, 8, 8, 128, 2),
    (1, 48, 6, 2, 16, 2), (1, 2048, 32, 4, 64, 8)])
def test_flash_bwd_cuda_row_split_matches_one_range(dtype, causal, B, S, H,
                                                    Hk, D, n_split):
    """The dk/dv pass with its rows split over ranges (fp32 partials summed
    by the reduce pass) against n_split = 1 (one range a key tile) and the
    plain gradient, within the rule; dq does not depend on the split."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, do = (randn(gen, B, S, H, D, dtype=tdt) for _ in range(2))
    k, v = (randn(gen, B, S, Hk, D, dtype=tdt) for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    assert split_plan(S, S, H // Hk, causal, n_split)[1] > \
        split_plan(S, S, H // Hk, causal, 1)[1]
    one = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                   n_split=1)
    split = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                     n_split=n_split)
    want = flash_attention_bwd_plain(q, k, v, do, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(one[0], split[0])
    for a, b, w in zip(one, split, want):
        assert _bwd_close(b, a, dtype) and _bwd_close(b, w, dtype)


def test_flash_bwd_cuda_rejects_what_it_does_not_take():
    gen = torch.Generator(device="cuda").manual_seed(4)

    def call(B=1, S=64, H=4, Hk=2, D=64, dtype=torch.bfloat16, n_split=None,
             **over):
        t = {"q": randn(gen, B, S, H, D, dtype=dtype),
             "k": randn(gen, B, S, Hk, D, dtype=dtype),
             "v": randn(gen, B, S, Hk, D, dtype=dtype),
             "o": randn(gen, B, S, H, D, dtype=dtype),
             "do": randn(gen, B, S, H, D, dtype=dtype),
             "lse": randn(gen, B, Hk, S * H // Hk, dtype=torch.float32)}
        t.update(over)
        return flash_attention_bwd_cuda(t["q"], t["k"], t["v"], t["o"],
                                        t["do"], t["lse"], n_split=n_split)
    for kwargs in ({"D": 48}, {"H": 34, "Hk": 2}, {"dtype": torch.float16},
                   {"o": randn(gen, 1, 64, 4, 32, dtype=torch.bfloat16)},
                   {"do": randn(gen, 1, 64, 4, 64,
                                dtype=torch.float32)},
                   {"k": randn(gen, 1, 64, 4, 128,
                               dtype=torch.bfloat16)[..., ::2]},
                   {"do": torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)},
                   {"lse": randn(gen, 1, 2, 64, dtype=torch.float32)},
                   {"lse": randn(gen, 1, 2, 128, dtype=torch.bfloat16)},
                   {"lse": torch.zeros(1, 2, 128)}):
        with pytest.raises(ValueError):
            call(**kwargs)
    with pytest.raises(ValueError, match="n_split"):
        call(n_split=0)


def test_flash_attention_grad_goes_through_the_backward_kernel():
    """flash_attention under grad on the card: the Function's gradient
    (the backward kernel) against autograd through the plain version; a
    non-contiguous dO is taken as it comes."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = randn(gen, 2, 128, 8, 64, dtype=torch.bfloat16).requires_grad_()
    k = randn(gen, 2, 128, 2, 64, dtype=torch.bfloat16).requires_grad_()
    v = randn(gen, 2, 128, 2, 64, dtype=torch.bfloat16).requires_grad_()
    do = randn(gen, 2, 128, 64, 8, dtype=torch.bfloat16).transpose(2, 3)
    before = (flash_kernel.launches, flash_bwd_kernel.launches)
    out = flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (flash_kernel.launches, flash_bwd_kernel.launches) == \
        (before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, do, causal=True)
    for g, w in zip(got, want):
        assert _bwd_close(g, w, "bfloat16")
    with torch.no_grad():
        flash_attention(q, k, v)
    assert flash_bwd_kernel.launches == before[1] + 1


def test_attention_grads_reach_wq_wk_wv_on_the_card():
    """The attention sublayer of the reduced model (no cache): gradients of
    wq, wk, wv and wo on the card, through the kernels, against the CPU
    plain path on the same weights."""
    model, params = _reduced_model()
    lp = tree_map(lambda a: a[0].clone(), params["layers"])
    x = torch.randn(2, 32, model.cfg.d_model,
                    generator=torch.Generator().manual_seed(6)
                    ).to(torch.bfloat16)
    grads = {}
    for dev in ("cpu", "cuda"):
        w = {n: lp["attn"][n].to(dev, copy=True).requires_grad_()
             for n in ("wq", "wk", "wv", "wo")}
        y, _ = attention(w, x.to(dev), model.cfg)
        (y.float().square().sum()).backward()
        grads[dev] = {n: t.grad.float().cpu() for n, t in w.items()}
    for n in ("wq", "wk", "wv", "wo"):
        want, got = grads["cpu"][n], grads["cuda"][n]
        assert float(got.abs().max()) > 0
        assert float((got - want).abs().max()) <= 2 ** -5 * \
            float(want.abs().max())


def test_ssd_under_grad_on_the_card_raises():
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = randn(gen, 1, 64, 2, 16, dtype=torch.bfloat16).requires_grad_()
    dt = torch.nn.functional.softplus(randn(gen, 1, 64, 2,
                                            dtype=torch.float32))
    A = -torch.exp(randn(gen, 2, dtype=torch.float32))
    Bm = randn(gen, 1, 64, 16, dtype=torch.bfloat16)
    Cm = randn(gen, 1, 64, 16, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="A.14"):
        ssd(x, dt, A, Bm, Cm, chunk=64)
    with torch.no_grad():
        y, _ = ssd(x, dt, A, Bm, Cm, chunk=64)
    assert y.shape == x.shape


def test_train_loop_cuda_goes_through_the_kernels():
    """Reduced tinyllama trained on the card: each step runs the flash
    forward twice a layer (remat recomputes it) and the backward once."""
    flash_kernel.launches = flash_bwd_kernel.launches = 0
    out = train_loop("tinyllama-1.1b", steps=3, batch=2, seq=32,
                     reduced=True, log_every=0)
    n_layers = get_config("tinyllama-1.1b", reduced=True).n_layers
    assert len(out["losses"]) == 3
    assert all(torch.isfinite(torch.tensor(out["losses"])))
    assert flash_kernel.launches == 3 * 2 * n_layers
    assert flash_bwd_kernel.launches == 3 * n_layers


def test_train_loop_mamba2_on_the_card_raises():
    with pytest.raises(NotImplementedError, match="A.14"):
        train_loop("mamba2-370m", steps=1, batch=2, seq=32, reduced=True,
                   log_every=0)
