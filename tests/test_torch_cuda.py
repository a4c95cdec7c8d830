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
online rescaling, against an exact logsumexp; |lse| < 10 here). The SSD
backward kernel is held to autograd through the plain scan by the same
norm rule, each of dx, ddt, dA, dB, dC and dstate0 (its tensor-core walk
stages some operands in bf16: ~0.3% of the norm by
tools/ssd_bwd_tolerance.py; its scalar walk ~1e-4), and the chunk states
the forward writes for it to the plain scan's within 1e-4 of their norm.
The MoE layer (plain torch on both devices) is held to the CPU with its
routing equal, the output within 1e-5 (fp32) or 2^-6 (bf16,
tests/test_torch_lm.py's rule) of its largest magnitude, and to itself bit
for bit across two calls and a CUDA-graph replay. A reduced qwen3-moe
train step under each remat policy, fed the CPU's experts, is held to the
CPU by chip_smoke.py's train-check rule (loss 1e-2 relative, each leaf
within 3e-2 of its norm).
"""

import ctypes
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

import repro_torch.kernels.decode_attention.kernel as decode_kernel
import repro_torch.kernels.decode_attention.partial as partial_kernel
import repro_torch.kernels.flash_attention.kernel as flash_kernel
import repro_torch.kernels.flash_attention.kernel_bwd as flash_bwd_kernel
import repro_torch.kernels.ssd.kernel as ssd_kernel
import repro_torch.kernels.ssd.kernel_bwd as ssd_bwd_kernel
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_partial,
    decode_attention_partial_plain, decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda,
                                                 flash_attention_lse_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention.kernel_bwd import split_plan
from repro_torch.kernels.ssd import (ssd, ssd_bwd_cuda, ssd_bwd_plain,
                                     ssd_cuda, ssd_plain)
from repro_torch.launch.serve import serve_loop
from repro_torch.launch.train import train_loop
from repro_torch.models import build_model, init_params
from repro_torch.models.attention import attention
from repro_torch.models.moe import _route, moe, moe_decls
from repro_torch.models.param import tree_items, tree_map

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
    (1, 2048, 32, 4, 64),                 # a long prompt
    (8, 512, 48, 4, 128),                 # starcoder2: G = 12, 5 positions
    (8, 512, 48, 8, 128),                 # nemotron, qwen3: G = 6, 10
    (2, 100, 48, 4, 128),                 # G = 12, ragged S
    (8, 512, 64, 4, 128),                 # qwen3-moe: G = 16, 4 positions
    (2, 100, 64, 4, 128),                 # G = 16 at D = 128, ragged S
    (8, 512, 64, 8, 112),                 # kimi-k2: D = 112 in the 128
    (2, 100, 64, 8, 112),                 # tile, G = 8; and a ragged S
    (1, 64, 16, 2, 112),
    (8, 512, 64, 8, 128),                 # qwen2-vl: G = 8, D = 128, 8
    (2, 100, 64, 8, 128)])                # positions a block; ragged S
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
    (2, 200, 64, 4, 64), (1, 48, 6, 2, 16), (1, 2048, 32, 4, 64),
    (8, 512, 48, 4, 128), (8, 512, 48, 8, 128), (2, 100, 48, 4, 128),
    (8, 512, 64, 4, 128), (8, 512, 64, 8, 112), (2, 100, 64, 8, 112),
    (8, 512, 64, 8, 128), (2, 100, 64, 8, 128)])
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hk,D", [
    (2, 100, 200, 16, 16, 64),            # cross-attention shapes: fewer
    (2, 200, 100, 16, 16, 64),            # queries than keys, and more
    (8, 512, 1024, 16, 16, 64),           # seamless: 512 over 1024 frames
    (8, 1024, 1024, 16, 16, 64),          # seamless's encoder
    (2, 100, 200, 32, 4, 64),             # G = 8 over a longer memory
    (2, 48, 16, 4, 2, 16)])               # the reduced seamless
def test_flash_cuda_cross_attention_shapes(dtype, B, Sq, Skv, H, Hk, D):
    """Non-causal flash with Sq != Skv (the encoder-decoder's
    cross-attention at prefill) and the encoder's non-causal S = 1024:
    the output and the rows' lse against their plain versions."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = randn(gen, B, Sq, H, D, dtype=tdt)
    k = randn(gen, B, Skv, Hk, D, dtype=tdt)
    v = randn(gen, B, Skv, Hk, D, dtype=tdt)
    before = flash_kernel.launches
    got = flash_attention(q, k, v, causal=False, block_q=Sq, block_k=Skv)
    out, lse = flash_attention_cuda(q, k, v, causal=False, return_lse=True)
    want = flash_attention_plain(q, k, v, causal=False)
    want_lse = flash_attention_lse_plain(q, k, causal=False)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 2
    assert got.shape == (B, Sq, H, D)
    assert float((got.float() - want.float()).abs().max()) < TOL[dtype]
    assert float((lse - want_lse).abs().max()) < LSE_TOL
    assert torch.equal(out, got)


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
@pytest.mark.parametrize("length", [1, 63, 64, 65, 300, 527, 528, 544])
@pytest.mark.parametrize("H,Hk,D", [(32, 4, 64),     # tinyllama
                                    (48, 4, 128),    # starcoder2: G = 12
                                    (48, 8, 128),    # nemotron, qwen3: G = 6
                                    (64, 4, 128),    # qwen3-moe: G = 16,
                                    # G x D = 2048, the kernel's limit
                                    (64, 8, 112),    # kimi-k2: G = 8
                                    (64, 8, 128)])   # qwen2-vl: G = 8
def test_decode_cuda_matches_plain(dtype, length, H, Hk, D):
    """Lengths 63, 64, 65 sit on the first boundary of the kernel's 64-key
    splits, 527 and 528 inside the last full one (528: the mean cache
    length of the serving path); 544 fills the cache (9 splits, the last
    one half full). D = 112 in fp32 takes the 28-lane key rows."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, L = 8, 544
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [0, 1, 300, 544])
@pytest.mark.parametrize("H,Hk,D", [(4, 4, 64),      # G = 1
                                    (32, 4, 64),     # tinyllama: G = 8
                                    (48, 4, 128),    # starcoder2: G = 12
                                    (64, 4, 128),    # G = 16
                                    (64, 8, 112)])   # kimi-k2: G = 8
def test_decode_partial_cuda_matches_plain(dtype, length, H, Hk, D):
    """The partial entry over one span of a sharded cache: out (fp32) and
    lse at a local length of 0 (out 0, lse -inf), 1, a mid value and the
    whole span."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, L = 8, 544
    cache_k = randn(gen, 2, B, L, Hk, D, dtype=tdt)
    cache_v = randn(gen, 2, B, L, Hk, D, dtype=tdt)
    q = randn(gen, B, 1, H, D, dtype=tdt)
    n = torch.tensor(length, dtype=torch.int32, device="cuda")
    before = partial_kernel.launches
    out, lse = decode_attention_partial(q, cache_k[1], cache_v[1], n)
    want_out, want_lse = decode_attention_partial_plain(q, cache_k[1],
                                                        cache_v[1], n)
    torch.cuda.synchronize()
    assert partial_kernel.launches == before + 1
    assert out.dtype == lse.dtype == torch.float32
    assert float((out - want_out).abs().max()) < TOL[dtype]
    if length == 0:
        assert not out.any() and torch.isneginf(lse).all()
    else:
        assert float((lse - want_lse).abs().max()) < LSE_TOL * max(
            1.0, float(want_lse.abs().max()))


@pytest.mark.parametrize("B,H,Hk,D,L", [(2, 8, 2, 32, 256),
                                        (1, 4, 4, 16, 256),
                                        (3, 6, 1, 64, 256),
                                        (2, 32, 4, 128, 1000),
                                        (2, 4, 4, 64, 544),     # G = 1
                                        (2, 64, 4, 64, 544),    # G = 16
                                        (1, 8, 1, 256, 200),    # D = 256
                                        (2, 16, 2, 112, 256),   # D = 112
                                        (1, 16, 1, 112, 8192)])
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


@pytest.mark.parametrize("length", [1, 64, 65, 513, 528, 543, 544])
def test_decode_cuda_fp32_cache_at_g1(length):
    """The encoder-decoder's self-attention step: an fp32 cache read by a
    bf16 query at G = 1, D = 64 (seamless's heads), through the model's
    ``_decode_core`` (q cast up to fp32, the fp32 kernel, the output cast
    back), against the plain path at the serving lengths."""
    from repro_torch.models.attention import KVCache, _decode_core
    gen = torch.Generator(device="cuda").manual_seed(13)
    B, L, H, D = 8, 544, 16, 64
    k = randn(gen, B, L, H, D, dtype=torch.float32)
    v = randn(gen, B, L, H, D, dtype=torch.float32)
    q = randn(gen, B, 1, H, D, dtype=torch.bfloat16)
    n = torch.tensor(length, dtype=torch.int32, device="cuda")
    before = decode_kernel.launches
    got = _decode_core(q, KVCache(k, v, n))
    want = decode_attention_plain(q.float(), k, v, n)
    torch.cuda.synchronize()
    assert decode_kernel.launches == before + 1
    assert got.dtype == torch.bfloat16
    # the kernel's fp32 result within fp32's tolerance (2e-5), then one
    # rounding to bf16, at most 2^-8 of the value
    assert bool(((got.float() - want).abs()
                 <= 2 ** -8 * want.abs() + 3e-5).all())


def test_decode_cuda_bf16_over_the_whole_memory():
    """The encoder-decoder's cached cross-attention step: one bf16 query
    over 1024 memory keys with length = L = 1024, G = 1, D = 64, through
    ``cross_attention``'s decode-kernel branch, against the plain
    version."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    B, L, H, D = 8, 1024, 16, 64
    k = randn(gen, B, L, H, D, dtype=torch.bfloat16)
    v = randn(gen, B, L, H, D, dtype=torch.bfloat16)
    q = randn(gen, B, 1, H, D, dtype=torch.bfloat16)
    n = torch.tensor(L, dtype=torch.int32, device="cuda")
    got = decode_attention(q, k, v, n, block_k=L)
    want = decode_attention_plain(q, k, v, n)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < TOL["bfloat16"]


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
    (1, 8192, 32, 64, 128, 256),       # a long prompt at batch 1
    (8, 512, 256, 64, 128, 256)])      # jamba's 256 heads at its prefill
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


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-370m",
                                  "jamba-1.5-large-398b"])
def test_lm_cuda_matches_cpu(arch):
    """prefill(16) + decode(1) of the reduced model: the kernel path on the
    card against the plain path on the CPU, same weights. The reduced
    jamba (one period-8 block: flash, decode and ssd kernels) draws its
    attention at std 1/sqrt(fan-in), as chip_smoke.py's model checks and
    the vlm and encoder-decoder tests do."""
    model, params_cpu = _reduced_model(arch)
    if model.cfg.family == "hybrid":
        _chip_smoke()             # puts tools/ on the path
        from attention_conditioning import fan_in_std
        layers = params_cpu["layers"]
        layers["attn"] = fan_in_std(layers["attn"], model.cfg.d_model)
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
    rel = float((got - ref).abs().max() / ref.abs().max())
    same = got.argmax(-1) == ref.argmax(-1)
    print(f"{arch}: rel {rel:.4f}, argmax equal {same.tolist()}")
    assert rel < 0.06 and bool(same.all())


def test_vlm_cuda_matches_cpu():
    """The reduced qwen2-vl with M-RoPE positions (distinct (t, h, w): a
    2 x 4 grid of patches, then text from 4): forward over 8 vision
    embeddings and 9 tokens, and prefill(16) + decode(1) with positions,
    the kernels on the card against the plain path on the CPU."""
    model, params_cpu = _reduced_model("qwen2-vl-72b")
    params_gpu = tree_map(lambda a: a.to("cuda"), params_cpu)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 256, (2, 17), generator=gen)
    vision = torch.randn(2, 8, model.cfg.d_model, generator=gen)
    r, c = torch.arange(8) // 4, torch.arange(8) % 4
    text = 4 + torch.arange(9)
    pos = torch.stack([torch.cat([torch.zeros(8, dtype=torch.long), text]),
                       torch.cat([r, text]), torch.cat([c, text])])
    pos = pos[:, None].expand(3, 2, 17)
    out = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        full, _ = model.forward(params, toks[:, :16].to(dev),
                                vision_embeds=vision.to(dev),
                                mrope_positions=pos[..., :16].to(dev))
        cache = model.init_cache(2, model.cfg.max_cache_len, device=dev)
        _, cache = model.prefill(params, toks[:, :16].to(dev), cache,
                                 mrope_positions=pos[..., :16].to(dev))
        logits, _ = model.decode_step(params, toks[:, 16:].to(dev), cache,
                                      mrope_positions=pos[..., 16:].to(dev))
        out[dev] = (full.float().cpu(), logits[:, 0].float().cpu())
    for ref, got in zip(out["cpu"], out["cuda"]):
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


def test_qwen3_depth2_full_width_cuda_matches_cpu():
    """Two layers of qwen3-14b at full width (d_model 5120, 48 lowered heads
    of which 40 are real, over 8 KV heads; qk-norm; vocab 151936):
    prefill(64) through the flash kernel + decode(1) through the decode
    kernel on the card against the plain path on the CPU, same weights
    (drawn on the card, copied to the CPU)."""
    cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=2,
                              q_chunk=32, kv_chunk=32)
    model = build_model(cfg)
    params_gpu = init_params(model.param_decls(),
                             torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
    params_cpu = tree_map(lambda a: a.cpu(), params_gpu)
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    flash_kernel.launches = decode_kernel.launches = 0
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        cache = model.init_cache(2, 72, device=dev)
        _, cache = model.prefill(params, toks[:, :64].to(dev), cache)
        logits, _ = model.decode_step(params, toks[:, 64:].to(dev), cache)
        out[dev] = logits[:, 0].float().cpu()
    assert (flash_kernel.launches, decode_kernel.launches) == (2, 2)
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


def test_serve_loop_jamba_goes_through_the_three_kernels():
    """The reduced jamba (one period-8 super-block) served on the card: the
    flash kernel once at the prefill (the block's one attention), the
    decode kernel once a decode step, the ssd kernel once a Mamba sublayer
    at the prefill (7); the Mamba decode is the plain recurrence."""
    for k in (flash_kernel, decode_kernel, ssd_kernel):
        k.launches = 0
    out = serve_loop("jamba-1.5-large-398b", batch=2, prompt_len=32,
                     gen_tokens=5, reduced=True)
    assert out["tokens"].shape == (2, 5)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 256)).all()
    assert (flash_kernel.launches, decode_kernel.launches,
            ssd_kernel.launches) == (1, 4, 7)


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
    (1, 40, 6, 3, 32),                    # positions), small D
    (2, 256, 48, 4, 128),                 # starcoder2: G = 12, D = 128
    (2, 256, 48, 8, 128),                 # nemotron, qwen3: G = 6
    (2, 100, 48, 4, 128),                 # G = 12, ragged S
    (8, 512, 64, 4, 128),                 # qwen3-moe's training shape:
    (2, 100, 64, 4, 128),                 # G = 16, D = 128; ragged S
    (8, 512, 64, 8, 128),                 # qwen2-vl's training shape:
    (2, 100, 64, 8, 128),                 # G = 8, D = 128; ragged S
    # S = (Sq, Skv), seamless-m4t's heads (G = 1, D = 64): the
    # cross-attention's 512 queries over 1024 keys, more queries than
    # keys, and ragged lengths both ways
    pytest.param(2, (512, 1024), 16, 16, 64, id="2-512x1024-16-16-64"),
    pytest.param(2, (1024, 512), 16, 16, 64, id="2-1024x512-16-16-64"),
    pytest.param(2, (100, 300), 16, 16, 64, id="2-100x300-16-16-64"),
    pytest.param(2, (300, 100), 16, 16, 64, id="2-300x100-16-16-64")])
def test_flash_bwd_cuda_matches_plain(dtype, causal, B, S, H, Hk, D):
    tdt = getattr(torch, dtype)
    Sq, Skv = S if isinstance(S, tuple) else (S, S)
    gen = torch.Generator(device="cuda").manual_seed(2)
    q = randn(gen, B, Sq, H, D, dtype=tdt)
    k = randn(gen, B, Skv, Hk, D, dtype=tdt)
    v = randn(gen, B, Skv, Hk, D, dtype=tdt)
    do = randn(gen, B, Sq, H, D, dtype=tdt)
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
    (1, 48, 6, 2, 16, 2), (1, 2048, 32, 4, 64, 8),
    # S = (Sq, Skv): seamless-m4t's cross-attention and its mirror
    pytest.param(2, (512, 1024), 16, 16, 64, 4, id="2-512x1024-16-16-64-4"),
    pytest.param(2, (1024, 512), 16, 16, 64, 4, id="2-1024x512-16-16-64-4")])
def test_flash_bwd_cuda_row_split_matches_one_range(dtype, causal, B, S, H,
                                                    Hk, D, n_split):
    """The dk/dv pass with its rows split over ranges (fp32 partials summed
    by the reduce pass) against n_split = 1 (one range a key tile) and the
    plain gradient, within the rule; dq does not depend on the split."""
    tdt = getattr(torch, dtype)
    Sq, Skv = S if isinstance(S, tuple) else (S, S)
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, do = (randn(gen, B, Sq, H, D, dtype=tdt) for _ in range(2))
    k, v = (randn(gen, B, Skv, Hk, D, dtype=tdt) for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    assert split_plan(Sq, Skv, H // Hk, causal, n_split)[1] > \
        split_plan(Sq, Skv, H // Hk, causal, 1)[1]
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
    """flash_attention under grad on the card: the custom op's gradient
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
    """Under grad the in-place update of the final state (``state_out``)
    raises: the backward reads the state it would overwrite. Without
    ``state_out`` the call goes through the backward kernel's Function,
    and outside grad through the bare kernel."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = randn(gen, 1, 64, 2, 16, dtype=torch.bfloat16).requires_grad_()
    dt = torch.nn.functional.softplus(randn(gen, 1, 64, 2,
                                            dtype=torch.float32))
    A = -torch.exp(randn(gen, 2, dtype=torch.float32))
    Bm = randn(gen, 1, 64, 16, dtype=torch.bfloat16)
    Cm = randn(gen, 1, 64, 16, dtype=torch.bfloat16)
    s0 = randn(gen, 1, 2, 16, 16, dtype=torch.float32)
    with pytest.raises(ValueError, match="state_out"):
        ssd(x, dt, A, Bm, Cm, chunk=64, state0=s0, state_out=s0)
    y, _ = ssd(x, dt, A, Bm, Cm, chunk=64, state0=s0)
    assert y.grad_fn is not None
    with torch.no_grad():
        y, st = ssd(x, dt, A, Bm, Cm, chunk=64, state0=s0, state_out=s0)
    assert y.shape == x.shape and st.data_ptr() == s0.data_ptr()


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


def test_train_loop_mamba2_goes_through_the_ssd_kernels():
    """Reduced mamba2 trained on the card: each step runs the ssd forward
    twice a layer (remat recomputes it) and its backward once, and no
    attention kernel."""
    ssd_kernel.launches = ssd_bwd_kernel.launches = 0
    flash_kernel.launches = flash_bwd_kernel.launches = 0
    out = train_loop("mamba2-370m", steps=3, batch=2, seq=64,
                     reduced=True, log_every=0)
    n_layers = get_config("mamba2-370m", reduced=True).n_layers
    assert len(out["losses"]) == 3
    assert all(torch.isfinite(torch.tensor(out["losses"])))
    assert ssd_kernel.launches == 3 * 2 * n_layers
    assert ssd_bwd_kernel.launches == 3 * n_layers
    assert flash_kernel.launches == flash_bwd_kernel.launches == 0


@pytest.mark.parametrize("policy", ["full", "dots", "names"])
def test_moe_train_step_under_each_remat_policy_matches_cpu(policy):
    """One step of the reduced qwen3-moe under each remat policy on the
    card, its MoE layers fed the CPU's experts (``record_routes`` /
    ``experts_as`` of chip_smoke.py: a near-tie that routes apart would
    move a whole expert's gradient), against the CPU's step with remat off:
    loss 1e-2 relative, each leaf within 3e-2 of its norm (chip_smoke.py's
    rule for the depth-2 model). The flash forward runs twice a layer under
    "full" and "names" (recomputed), once under "dots" (its output and
    log-sum-exp saved); the backward once."""
    smoke = _chip_smoke()
    model, params = _reduced_model("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(model.cfg, remat=False)
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(2))

    def step(dev, **changes):
        m = build_model(dataclasses.replace(cfg, **changes))
        leaves = tree_map(lambda a: a.to(dev, copy=True).requires_grad_(),
                          params)
        loss = m.loss_fn(leaves, {"tokens": toks.to(dev)})
        loss.backward()
        return float(loss.detach()), {"/".join(k): t.grad.double().cpu()
                                      for k, t in tree_items(leaves)}
    routes = {"cpu": [], "cuda": []}
    with smoke.record_routes(routes):
        l_cpu, g_cpu = step("cpu")
    flash_kernel.launches = flash_bwd_kernel.launches = 0
    with smoke.experts_as(routes["cpu"]):
        l_gpu, g_gpu = step("cuda", remat=True, remat_policy=policy)
    layers = cfg.n_layers
    assert flash_kernel.launches == (layers if policy == "dots"
                                     else 2 * layers)
    assert flash_bwd_kernel.launches == layers
    assert abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu)
    for k, w in g_cpu.items():
        assert float((g_gpu[k] - w).norm()) <= 3e-2 * float(w.norm()), k


def test_encdec_train_step_matches_cpu():
    """One step of the reduced seamless-m4t cut to 2 encoder and 2 decoder
    layers (2 x 32 tokens over 64 frames: the cross-attention keeps Sq !=
    Skv) with its attention weights at std 1/sqrt(fan-in): on the card
    under remat, against the CPU with remat off, by chip_smoke.py's
    train-check rule (loss 1e-2 relative, each leaf within 3e-2 of its
    norm). Each of its 6 attention calls launches the flash forward twice
    (remat recomputes it) and the backward once."""
    smoke = _chip_smoke()
    from attention_conditioning import fan_in_std
    cfg = dataclasses.replace(
        get_config("seamless-m4t-large-v2", reduced=True), n_layers=2,
        n_encoder_layers=2, remat=False, q_chunk=16, kv_chunk=16)
    params = init_params(build_model(cfg).param_decls(),
                         torch.Generator().manual_seed(0), "cpu")
    params["encoder"]["attn"] = fan_in_std(params["encoder"]["attn"],
                                           cfg.d_model)
    for name in ("self_attn", "cross_attn"):
        params["decoder"][name] = fan_in_std(params["decoder"][name],
                                             cfg.d_model)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 33), generator=gen)
    frames = torch.randn(2, 64, cfg.d_model, generator=gen).bfloat16()
    l_cpu, g_cpu = smoke._loss_and_grads(build_model(cfg), params, toks,
                                         "cpu", frames=frames)
    flash_kernel.launches = flash_bwd_kernel.launches = 0
    l_gpu, g_gpu = smoke._loss_and_grads(
        build_model(dataclasses.replace(cfg, remat=True)), params, toks,
        "cuda", frames=frames)
    assert (flash_kernel.launches, flash_bwd_kernel.launches) == (12, 6)
    assert abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu)
    for k, w in g_cpu.items():
        assert float((g_gpu[k] - w).norm()) <= 3e-2 * float(w.norm()), k


def test_setup_training_trains_encdec_on_the_card():
    """The reduced seamless-m4t trained on the card the port's way for the
    family: setup_training's step on batch_at's {'frames', 'tokens'}
    batches (16 frames a sequence), 2 steps: finite losses, the flash
    forward twice and the backward once for each attention call."""
    from repro_torch.launch.train import batch_at, setup_training
    s = setup_training("seamless-m4t-large-v2", steps=2, batch=2, seq=32,
                       reduced=True)
    cfg = s.model.cfg
    calls = cfg.n_encoder_layers + 2 * cfg.n_layers
    flash_kernel.launches = flash_bwd_kernel.launches = 0
    state, losses = s.state, []
    for i in range(2):
        batch = batch_at(s, i)
        assert batch["frames"].shape == (2, 16, cfg.d_model)
        assert batch["frames"].is_cuda and batch["tokens"].is_cuda
        state, metrics = s.step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(torch.isfinite(torch.tensor(losses)))
    assert (flash_kernel.launches, flash_bwd_kernel.launches) == \
        (2 * 2 * calls, 2 * calls)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------- under the DFlow engine
def test_a_put_of_a_cuda_tensor_digests_to_none_without_a_sync():
    """DStore's Put digests its value; a CUDA tensor is opaque (None), and
    neither the digest nor a Put and a remote Get waits for the card: a
    kernel queued before them is still running after them."""
    from repro_torch.core import DStore, content_digest
    t = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    torch.cuda._sleep(1_000_000_000)            # ~0.5 s of the card's time
    assert content_digest(t) is None
    assert content_digest({"w": t, "step": 3}) is None
    ds = DStore(["n0", "n1"])
    ds.put("n0", "k", t)
    assert ds.get("n1", "k") is t
    assert not stream.query()                   # nothing synchronized
    torch.cuda.synchronize()


def test_run_training_on_the_card_takes_train_loops_steps(tmp_path,
                                                          monkeypatch):
    """Depth-2, full-width tinyllama under the port's DFlow engine: the
    flash kernels run in the DAG's threads (twice a layer forward under
    remat, once backward), and the losses and the checkpoint at step 2 are
    ``train_loop``'s (the resume rule, 2e-2)."""
    import numpy as np
    import repro_torch.launch.train as train_mod
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLM
    from repro_torch.runtime.orchestrator import (OrchestratorConfig,
                                                  run_training)
    full_depth = train_mod.get_config
    monkeypatch.setattr(train_mod, "get_config", lambda arch, reduced=False:
                        dataclasses.replace(full_depth(arch), n_layers=2))
    kw = dict(steps=3, batch=2, seq=256, seed=3)
    loop = train_loop("tinyllama-1.1b", ckpt_dir=str(tmp_path / "loop"),
                      ckpt_every=2, log_every=0, **kw)
    s = train_mod.setup_training("tinyllama-1.1b", **kw)
    source = SyntheticLM(s.data)
    mgr = CheckpointManager(tmp_path / "dag", keep=2)
    flash_kernel.launches = flash_bwd_kernel.launches = 0
    rep = run_training(
        OrchestratorConfig(n_steps=3, ckpt_every=2, pattern="dataflow"),
        init_state=s.state, train=s.step_fn,
        fetch=lambda i: {k: torch.as_tensor(v).cuda()
                         for k, v in source.batch_at(i).items()},
        save=lambda i, state: mgr.save(i + 1, state))
    mgr.wait()
    assert flash_kernel.launches == 3 * 2 * 2
    assert flash_bwd_kernel.launches == 3 * 2
    losses = [float(rep.outputs[f"metrics.{i}"]["loss"]) for i in range(3)]
    np.testing.assert_allclose(losses, loop["losses"], rtol=2e-2)
    got, want = (tmp_path / d / "step_00000002" for d in ("dag", "loop"))
    names = sorted(p.name for p in want.glob("*.npy"))
    assert names and names == sorted(p.name for p in got.glob("*.npy"))
    for name in names:
        a, b = np.load(got / name), np.load(want / name)
        if b.dtype == np.uint16:                # bf16 bits
            a, b = ((x.astype(np.uint32) << 16).view(np.float32)
                    for x in (a, b))
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= 2e-2 * scale, name



def test_run_training_on_the_card_under_a_tracer(monkeypatch):
    """Depth-2, full-width tinyllama under the port's DFlow engine with its
    DScope on (the engine's ``spans=``, as ``chip_smoke.py`` binds it):
    one request span, an invoke span a function nested in it and none left
    open, the kernels launched in the DAG's threads, and an attribution
    against the DAG's own DPlan that covers every ``step.i``."""
    import functools
    import repro_torch.launch.train as train_mod
    import repro_torch.runtime.orchestrator as orchestrator
    from repro_torch.core.obs import Tracer, attribute, plan_attribution
    from repro_torch.core.plan import build_plan
    from repro_torch.data import SyntheticLM
    full_depth = train_mod.get_config
    monkeypatch.setattr(train_mod, "get_config", lambda arch, reduced=False:
                        dataclasses.replace(full_depth(arch), n_layers=2))
    tracer = Tracer()
    monkeypatch.setattr(orchestrator, "DFlowEngine", functools.partial(
        orchestrator.DFlowEngine, spans=tracer))
    s = train_mod.setup_training("tinyllama-1.1b", steps=3, batch=2,
                                 seq=256, seed=3)
    source = SyntheticLM(s.data)
    flash_kernel.launches = flash_bwd_kernel.launches = 0
    rep = orchestrator.run_training(
        orchestrator.OrchestratorConfig(n_steps=3, pattern="dataflow"),
        init_state=s.state, train=s.step_fn,
        fetch=lambda i: {k: torch.as_tensor(v).cuda()
                         for k, v in source.batch_at(i).items()})
    assert flash_kernel.launches == 3 * 2 * 2
    assert flash_bwd_kernel.launches == 3 * 2
    losses = [float(rep.outputs[f"metrics.{i}"]["loss"]) for i in range(3)]
    assert all(l == l for l in losses)
    spans = tracer.finished()
    assert sorted(sp.id for sp in spans) == list(
        range(1, tracer._next_id + 1))            # every span ended
    (req,) = [sp for sp in spans if sp.kind == "request"]
    invokes = [sp for sp in spans if sp.kind == "invoke"]
    wf = orchestrator.build_training_workflow(
        3, fetch=lambda i: None, train=lambda state, batch: (state, {}))
    assert sorted(sp.name for sp in invokes) == sorted(wf.functions)
    for sp in invokes:
        assert sp.parent == req.id
        assert req.start <= sp.start <= sp.end <= req.end
    report = attribute(spans, plan_attribution(
        build_plan(wf, nodes=["node0", "node1"])))
    assert report["requests"] == 1
    covered = {r["function"] for r in report["functions"]}
    assert {f"step.{i}" for i in range(3)} <= covered


# ------------------------------------------------------- the SSD backward
def _ssd_tool():
    spec = importlib.util.spec_from_file_location(
        "ssd_bwd_tolerance", Path(__file__).resolve().parents[1] / "tools"
        / "ssd_bwd_tolerance.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _ssd_bwd_inputs(gen, B, S, H, P, N, dtype, with_state):
    x, dy = (randn(gen, B, S, H, P, dtype=dtype) for _ in range(2))
    dt = torch.nn.functional.softplus(randn(gen, B, S, H,
                                            dtype=torch.float32))
    A = -torch.exp(randn(gen, H, dtype=torch.float32))
    Bm, Cm = (randn(gen, B, S, N, dtype=dtype) for _ in range(2))
    s0, ds = ((randn(gen, B, H, P, N, dtype=torch.float32)
               for _ in range(2)) if with_state else (None, None))
    return x, dt, A, Bm, Cm, dy, s0, ds


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 8, 16, 64), (2, 100, 3, 8, 16, 50),     # ragged: 100 % 64
    (2, 200, 4, 64, 128, 100),
    (8, 512, 32, 64, 128, 256),                         # the training shape
    (1, 2048, 32, 64, 128, 256), (2, 513, 4, 16, 32, 171),
    (2, 256, 4, 8, 128, 128),          # bf16 on the scalar kernel: P = 8
    (2, 128, 3, 16, 128, 64), (2, 128, 3, 32, 16, 64)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_bwd_cuda_matches_plain(dtype, B, S, H, P, N, chunk,
                                    with_state):
    tdt = getattr(torch, dtype)
    tool = _ssd_tool()
    gen = torch.Generator(device="cuda").manual_seed(12)
    x, dt, A, Bm, Cm, dy, s0, ds = _ssd_bwd_inputs(gen, B, S, H, P, N, tdt,
                                                   with_state)
    _, _, states = ssd_cuda(x, dt, A, Bm, Cm, state0=s0, return_states=True)
    before = ssd_bwd_kernel.launches
    got = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states, dstate=ds,
                       want_dstate0=with_state)
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, state0=s0, dstate=ds,
                         chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_bwd_kernel.launches == before + 1
    for g, w, like in zip(got, want, (tdt, torch.float32, torch.float32,
                                      tdt, tdt, torch.float32)):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.shape == w.shape and g.dtype == like
            assert _bwd_close(g, w, dtype)
    if S > 64:                       # the states after the first chunk
        assert tool.grad_err(states[:, :, 1:], tool.chunk_states(
            x, dt, A, Bm, Cm, s0)[:, :, 1:]) <= 1e-4


def test_ssd_bwd_cuda_is_deterministic_and_fails_planted_faults():
    """Two calls give the same bits (per-head partials summed in a fixed
    order, no atomics); and each planted fault of
    tools/ssd_bwd_tolerance.py, made by the kernel on altered inputs,
    fails the rule at the training shape."""
    tool = _ssd_tool()
    gen = torch.Generator(device="cuda").manual_seed(13)
    x, dt, A, Bm, Cm, dy, _, _ = _ssd_bwd_inputs(gen, 8, 512, 32, 64, 128,
                                                 torch.bfloat16, False)
    _, _, states = ssd_cuda(x, dt, A, Bm, Cm, return_states=True)
    a = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states)
    b = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states)
    assert all(torch.equal(u, v) for u, v in zip(a[:5], b[:5]))
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=256)
    faults = tool.planted_faults(ssd_bwd_cuda, x, dt, A, Bm, Cm, dy, states)
    assert len(faults) == 3
    for name, (k, bad) in faults.items():
        assert not _bwd_close(bad, want[k], "bfloat16"), name


@pytest.mark.parametrize("B,S,H", [(8, 512, 32), (8, 512, 16), (2, 200, 4),
                                   (2, 128, 12), (1, 256, 3), (48, 128, 4),
                                   (2, 128, 2), (32, 128, 6)])
def test_ssd_bwd_walks_in_clusters_of_heads(B, S, H):
    """The bf16 walk at mamba2's heads is ``ssd_bwd_wgmma_kernel``, laid out
    as the wrapper's ``layout`` says (the C entry sums as many heads on
    chip): two heads a block in clusters of two at the training shape,
    one a block where the card holds every head at once (H = 16, 12, 3),
    the cluster holding every head (48 x 4, 2 x 2: dB and dC written by the
    walk, the reduce pass sums dA alone), a block's pair with no cluster
    (32 x 6); it meets the rule."""
    from torch.profiler import ProfilerActivity, profile
    lib = ssd_bwd_kernel._build.library("ssd_bwd")
    lib.ssd_bwd_cluster_size.argtypes = [ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert lib.ssd_bwd_cluster_size(B, H) == \
        ssd_bwd_kernel.cluster_size(B, H, sms)
    gen = torch.Generator(device="cuda").manual_seed(18)
    x, dt, A, Bm, Cm, dy, _, _ = _ssd_bwd_inputs(gen, B, S, H, 64, 128,
                                                 torch.bfloat16, False)
    _, _, states = ssd_cuda(x, dt, A, Bm, Cm, return_states=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert any("ssd_bwd_wgmma_kernel" in n for n in names), names
    assert not any("ssd_bwd_kernel" in n for n in names), names
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=min(S, 256))
    for g, w in zip(got[:5], want[:5]):
        assert _bwd_close(g, w, "bfloat16")


def test_ssd_bwd_scalar_and_tensor_core_kernels_agree(monkeypatch):
    """At the training shape in bf16 the scalar kernel (fp32 FMA, what fp32
    and the other sizes take) and the tensor-core one each meet the rule
    against the plain gradient and against each other."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    x, dt, A, Bm, Cm, dy, _, _ = _ssd_bwd_inputs(gen, 8, 512, 32, 64, 128,
                                                 torch.bfloat16, False)
    _, _, states = ssd_cuda(x, dt, A, Bm, Cm, return_states=True)
    assert ssd_bwd_kernel.tensor_cores(torch.bfloat16, 64, 128)
    tc = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states)
    monkeypatch.setattr(ssd_bwd_kernel, "tensor_cores", lambda *a: False)
    scalar = ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, states)
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=256)
    for a, b, w in zip(tc[:5], scalar[:5], want[:5]):
        assert _bwd_close(a, w, "bfloat16") and _bwd_close(b, w, "bfloat16")
        assert _bwd_close(a, b, "bfloat16")


def test_ssd_forward_writes_chunk_states_only_when_asked():
    """The chunk states are the plain scan's; serving allocates none and
    its y and final state equal the training forward's."""
    tool = _ssd_tool()
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, dt, A, Bm, Cm, _, s0, _ = _ssd_bwd_inputs(gen, 2, 300, 4, 64, 128,
                                                 torch.bfloat16, True)
    y, st = ssd_cuda(x, dt, A, Bm, Cm, state0=s0)
    y2, st2, states = ssd_cuda(x, dt, A, Bm, Cm, state0=s0,
                               return_states=True)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    assert states.shape == (2, 4, 5, 64, 128)
    assert torch.equal(states[:, :, 0], s0)
    assert tool.grad_err(states, tool.chunk_states(x, dt, A, Bm, Cm,
                                                   s0)) <= 1e-4


def test_ssd_grad_goes_through_the_backward_kernel():
    """ssd under grad on the card: the Function's gradients (the backward
    kernel) of x, dt, A, B, C and state0 against the plain gradient, for a
    loss on y and the final state; a strided dy is taken as it comes."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    x, dt, A, Bm, Cm, _, s0, ds = _ssd_bwd_inputs(gen, 2, 128, 4, 16, 32,
                                                  torch.bfloat16, True)
    leaves = [t.requires_grad_() for t in (x, dt, A, Bm, Cm, s0)]
    dy = randn(gen, 2, 128, 16, 4, dtype=torch.bfloat16).transpose(2, 3)
    before = (ssd_kernel.launches, ssd_bwd_kernel.launches)
    y, final = ssd(*leaves[:5], chunk=64, state0=s0)
    got = torch.autograd.grad((y, final), leaves, (dy, ds))
    assert (ssd_kernel.launches, ssd_bwd_kernel.launches) == \
        (before[0] + 1, before[1] + 1)
    want = ssd_bwd_plain(*leaves[:5], dy, state0=s0, dstate=ds, chunk=64)
    for g, w in zip(got, want):
        assert _bwd_close(g, w, "bfloat16")


def test_ssd_bwd_cuda_rejects_what_it_does_not_take():
    gen = torch.Generator(device="cuda").manual_seed(16)
    x, dt, A, Bm, Cm, dy, _, _ = _ssd_bwd_inputs(gen, 1, 64, 2, 8, 16,
                                                 torch.bfloat16, False)
    states = torch.zeros(1, 2, 1, 8, 16, device="cuda")
    for bad in ({"dy": dy.float()}, {"A": A.bfloat16()},
                {"states": states[..., :8]}, {"states": states.bfloat16()},
                {"dy": randn(gen, 1, 64, 2, 16, dtype=torch.bfloat16)
                 [..., ::2]},
                {"x": randn(gen, 1, 64, 2, 6, dtype=torch.bfloat16),
                 "dy": randn(gen, 1, 64, 2, 6, dtype=torch.bfloat16)}):
        t = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm, "dy": dy,
             "states": states}
        t.update(bad)
        with pytest.raises(ValueError):
            ssd_bwd_cuda(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                         t["dy"], t["states"])


def test_mamba2_grads_on_the_card_match_cpu():
    """The reduced mamba2's loss and every leaf's gradient on the card
    (the ssd kernels) against the CPU (the plain scan), same weights and
    batch: loss 1e-2 relative, each leaf within 3e-2 of its norm (bf16,
    chip_smoke.py's rule for the depth-2 model)."""
    model, params = _reduced_model("mamba2-370m")
    toks = torch.randint(0, model.cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", "cuda"):
        leaves = tree_map(lambda a: a.to(dev, copy=True).requires_grad_(),
                          params)
        loss = model.loss_fn(leaves, {"tokens": toks.to(dev)})
        loss.backward()
        out[dev] = (float(loss), {"/".join(k): t.grad.double().cpu()
                                  for k, t in tree_items(leaves)})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu)
    for k, w in g_cpu.items():
        assert float((g_gpu[k] - w).norm()) <= 3e-2 * float(w.norm()), k


# ------------------------------------------------------------------- MoE
def _moe_layer(mode: str, dtype=torch.bfloat16, **kw):
    """One MoE layer between the reduced and the full qwen3-moe width
    (d_model 256, 16 experts of width 128, top-4, capacity factor 1.25),
    weights drawn on the CPU, and its input (2 x 64 tokens)."""
    cfg = dataclasses.replace(
        get_config("qwen3-moe-235b-a22b", reduced=True), d_model=256,
        d_ff=128, n_experts=16, top_k=4, moe_dispatch=mode, **kw)
    params = init_params(moe_decls(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    x = torch.randn(2, 64, 256, generator=torch.Generator().manual_seed(1))
    return cfg, params, x.to(dtype)


@pytest.mark.parametrize("mode", ["scatter", "gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_cuda_matches_cpu(mode, dtype):
    """The MoE layer on the card against the CPU, same weights and input:
    the routing (top-k experts) equal, the output within 1e-5 (fp32) or
    2^-6 (bf16, tests/test_torch_lm.py's rule) of its largest magnitude,
    aux within 1e-6."""
    cfg, params, x = _moe_layer(mode, getattr(torch, dtype))
    gpu = tree_map(lambda a: a.to("cuda"), params)
    y_cpu, aux_cpu = moe(params, x, cfg)
    y_gpu, aux_gpu = moe(gpu, x.to("cuda"), cfg)
    topi_cpu = _route(params["router"], x, cfg)[0]
    topi_gpu = _route(gpu["router"], x.to("cuda"), cfg)[0]
    assert torch.equal(topi_gpu.cpu(), topi_cpu)
    tol = 1e-5 if dtype == "float32" else 2 ** -6
    err = (y_gpu.float().cpu() - y_cpu.float()).abs().max()
    assert float(err / y_cpu.float().abs().max()) < tol
    assert abs(float(aux_gpu) - float(aux_cpu)) < 1e-6


@pytest.mark.parametrize("mode", ["scatter", "gather"])
def test_moe_cuda_gives_the_same_bits_twice(mode):
    """No atomics on the layer's path: two calls on one input, at a tight
    capacity (drops) and a loose one, give the same bits."""
    for cf in (0.3, 8.0):
        cfg, params, x = _moe_layer(mode, capacity_factor=cf)
        gpu = tree_map(lambda a: a.to("cuda"), params)
        a, aux_a = moe(gpu, x.to("cuda"), cfg)
        b, aux_b = moe(gpu, x.to("cuda"), cfg)
        assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.parametrize("mode", ["scatter", "gather"])
def test_moe_cuda_graph_replay_follows_its_input(mode):
    """The layer at a decode step's shape (8 tokens), captured in a CUDA
    graph: replayed after its input changes on the device, it equals an
    eager call bit for bit (nothing on its path reads a value on the
    host)."""
    cfg, params, _ = _moe_layer(mode)
    gpu = tree_map(lambda a: a.to("cuda"), params)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = randn(gen, 8, 1, cfg.d_model, dtype=torch.bfloat16)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):                   # warm, then capture
        moe(gpu, x, cfg)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, aux = moe(gpu, x, cfg)
    for seed in (5, 6):
        x.copy_(randn(torch.Generator(device="cuda").manual_seed(seed), 8, 1,
                      cfg.d_model, dtype=torch.bfloat16))
        graph.replay()
        want, want_aux = moe(gpu, x, cfg)
        torch.cuda.synchronize()
        assert torch.equal(y, want) and torch.equal(aux, want_aux)


def test_serve_loop_moe_goes_through_the_kernels():
    flash_kernel.launches = decode_kernel.launches = 0
    out = serve_loop("qwen3-moe-235b-a22b", batch=2, prompt_len=32,
                     gen_tokens=5, reduced=True)
    assert out["tokens"].shape == (2, 5)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 256)).all()
    n_layers = get_config("qwen3-moe-235b-a22b", reduced=True).n_layers
    assert flash_kernel.launches == n_layers
    assert decode_kernel.launches == n_layers * 4


def test_serve_loop_encdec_goes_through_the_kernels():
    """The reduced seamless-m4t served on the card: at prefill the flash
    kernel once an encoder layer (non-causal), once a decoder layer
    (causal) and once a decoder layer's cross-attention (the prompt over
    the memory); each decode step the decode kernel twice a decoder layer
    (the fp32 self cache and the bf16 memory)."""
    flash_kernel.launches = decode_kernel.launches = 0
    gen = 5
    out = serve_loop("seamless-m4t-large-v2", batch=2, prompt_len=32,
                     gen_tokens=gen, reduced=True)
    cfg = get_config("seamless-m4t-large-v2", reduced=True)
    assert out["tokens"].shape == (2, gen)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab)).all()
    assert torch.isfinite(out["logits"]).all()
    assert flash_kernel.launches == cfg.n_encoder_layers + 2 * cfg.n_layers
    assert decode_kernel.launches == 2 * cfg.n_layers * (gen - 1)


def test_serve_loop_refuses_full_depth_moe_before_allocating():
    """qwen3-moe-235b-a22b at its 94 layers (470 GB of weights) on one
    card: ValueError naming A.12, and nothing allocated."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with pytest.raises(ValueError, match="A.12"):
        serve_loop("qwen3-moe-235b-a22b", batch=1, prompt_len=16,
                   gen_tokens=2)
    assert torch.cuda.memory_allocated() == before


def test_flash_bwd_cuda_refuses_head_dim_112():
    """The forward serves D = 112; the backward raises ValueError naming
    ROADMAP item B.6 and launches nothing."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, o, do = (randn(gen, 1, 64, 16, 112, dtype=torch.bfloat16)
                for _ in range(3))
    k, v = (randn(gen, 1, 64, 2, 112, dtype=torch.bfloat16)
            for _ in range(2))
    _, lse = flash_attention_cuda(q, k, v, return_lse=True)
    before = flash_bwd_kernel.launches
    with pytest.raises(ValueError, match=r"head_dim 112.*B\.6"):
        flash_attention_bwd_cuda(q, k, v, o, do, lse)
    assert flash_bwd_kernel.launches == before


def test_serve_loop_refuses_full_depth_kimi_before_allocating():
    """kimi-k2-1t-a32b at its 61 layers (2.09 TB of weights) on one card:
    ValueError naming A.12, and nothing allocated."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with pytest.raises(ValueError, match="A.12"):
        serve_loop("kimi-k2-1t-a32b", batch=1, prompt_len=16, gen_tokens=2)
    assert torch.cuda.memory_allocated() == before
