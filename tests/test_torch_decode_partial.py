"""The decode kernel's partial entry on the CPU: its plain version over a
cache cut into spans, merged by log-sum-exp, against the whole-cache
oracle; its empty span against the Pallas kernel's 0 output; the model's
CPU partial core against its plain decode; and the dispatch. The CUDA
entry against the plain version is in tests/test_torch_cuda.py.

Tolerances are tests/test_kernels.py's: 2e-5 absolute in fp32 (sums in
another order), 2e-2 absolute in bf16.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.decode_attention.partial as partial_kernel
from repro.kernels.decode_attention import \
    decode_attention as jax_decode_attention
from repro_torch.kernels.decode_attention import (
    decode_attention_partial, decode_attention_partial_cuda,
    decode_attention_partial_plain, decode_attention_partial_ref,
    decode_attention_plain, decode_attention_ref)
from repro_torch.models.attention import (KVCache, _decode_partial_core,
                                          decode_attention)
from repro_torch.models.param import params_from_numpy

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def draws(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
            .to(getattr(torch, dtype)) for s in shapes]


def merge(parts):
    """The ranks' (out, lse) merged as the sharded model merges them."""
    lse = torch.stack([lse for _, lse in parts])
    m = lse.amax(0)
    w = torch.exp(lse - m)
    num = sum(wi[:, None, :, None] * out for wi, (out, _) in zip(w, parts))
    return num / w.sum(0)[:, None, :, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [1, 17, 63, 64, 65, 100, 127, 128])
@pytest.mark.parametrize("spans", [2, 4])
@pytest.mark.parametrize("H,Hk,D", [(8, 2, 32), (12, 1, 16), (16, 2, 112)])
def test_spans_merged_equal_the_whole_cache(H, Hk, D, spans, length, dtype):
    """Lengths below L / spans leave the later spans empty (local length
    0: out 0, lse -inf, weight 0)."""
    B, L = 2, 128
    q, k, v = draws(0, dtype, (B, 1, H, D), (B, L, Hk, D), (B, L, Hk, D))
    Ls = L // spans
    parts = [decode_attention_partial_plain(
        q, k[:, r * Ls:(r + 1) * Ls], v[:, r * Ls:(r + 1) * Ls],
        torch.tensor(min(max(length - r * Ls, 0), Ls), dtype=torch.int32))
        for r in range(spans)]
    for out, lse in parts:
        assert out.dtype == lse.dtype == torch.float32
        assert out.shape == (B, 1, H, D) and lse.shape == (B, H)
    want = decode_attention_ref(q[:, 0].reshape(B, Hk, H // Hk, D),
                                k.transpose(1, 2), v.transpose(1, 2),
                                length).float().reshape(B, 1, H, D)
    assert float((merge(parts) - want).abs().max()) < TOL[dtype]
    if length <= Ls * (spans - 1):
        out, lse = parts[-1]
        assert not out.any() and torch.isneginf(lse).all()


@pytest.mark.parametrize("length", [1, 5, 32])
def test_lse_is_the_log_sum_exp_of_the_scaled_scores(length):
    B, H, Hk, D, L = 1, 4, 2, 16, 32
    q, k, v = draws(1, "float32", (B, 1, H, D), (B, L, Hk, D), (B, L, Hk, D))
    _, lse = decode_attention_partial_plain(q, k, v, length)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0],
                     k.repeat_interleave(H // Hk, dim=2)) / math.sqrt(D)
    assert torch.allclose(lse, torch.logsumexp(s[..., :length], -1),
                          atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_span_matches_the_pallas_kernels_zero(dtype):
    """At a local length of 0 the Pallas kernel outputs 0
    (src/repro/kernels/decode_attention/kernel.py:46,69), and so does the
    partial entry; ``decode_attention_ref`` would give the mean of V."""
    rng = np.random.default_rng(2)
    B, H, Hk, D, L = 2, 8, 2, 32, 64
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    arrays = [jnp.asarray(rng.standard_normal(s), jdt)
              for s in ((B, 1, H, D), (B, L, Hk, D), (B, L, Hk, D))]
    pallas = jax_decode_attention(*arrays, jnp.int32(0), block_k=32,
                                  interpret=True)
    q, k, v = (params_from_numpy({"a": np.asarray(a)}, "cpu")["a"]
               for a in arrays)
    out, lse = decode_attention_partial_plain(q, k, v, 0)
    assert not np.asarray(pallas.astype(jnp.float32)).any()
    assert not out.any() and torch.isneginf(lse).all()


@pytest.mark.parametrize("spans", [2, 4])
@pytest.mark.parametrize("length", [1, 9, 30])
def test_model_partial_core_merges_to_the_plain_decode(spans, length):
    """The sharded model's CPU core (q scaled in bf16, as the reference
    scales it) over spans, merged, against the model's plain decode over
    the whole cache, in bf16."""
    B, H, Hk, D, L = 2, 8, 2, 16, 32
    q, k, v = draws(3, "bfloat16", (B, 1, H, D), (B, L, Hk, D),
                    (B, L, Hk, D))
    Ls = L // spans
    parts = [_decode_partial_core(
        q, k[:, r * Ls:(r + 1) * Ls], v[:, r * Ls:(r + 1) * Ls],
        torch.tensor(length - r * Ls).clamp(0, Ls)) for r in range(spans)]
    want = decode_attention(q, KVCache(k, v, torch.tensor(length)))
    assert float((merge(parts) - want.float()).abs().max()) < TOL["bfloat16"]


def test_partial_dispatch_on_the_cpu(monkeypatch):
    """A CPU tensor takes the plain version, with no launch counted; the
    CUDA launcher refuses a CPU tensor before any build."""
    def no_launch(*args, **kwargs):
        raise AssertionError("CUDA launcher reached from a CPU tensor")
    monkeypatch.setattr(partial_kernel, "launches", 0)
    monkeypatch.setattr(partial_kernel, "_entry", no_launch)
    q, k, v = draws(4, "bfloat16", (2, 1, 8, 16), (2, 32, 2, 16),
                    (2, 32, 2, 16))
    n = torch.tensor(7, dtype=torch.int32)
    got = decode_attention_partial(q, k, v, n)
    want = decode_attention_partial_plain(q, k, v, n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert partial_kernel.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_partial_cuda(q, k, v, n)
    with pytest.raises(ValueError, match="single query"):
        decode_attention_partial(torch.zeros(2, 2, 8, 16), k, v, n)
    # the plain decode is the partial's normalised output, cast back
    out, _ = decode_attention_partial_ref(
        q[:, 0].reshape(2, 2, 4, 16), k.transpose(1, 2), v.transpose(1, 2), 7)
    assert float((out.reshape(2, 1, 8, 16) - decode_attention_plain(
        q, k, v, 7).float()).abs().max()) < TOL["bfloat16"]
