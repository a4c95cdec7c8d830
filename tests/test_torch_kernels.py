"""The port's attention kernels: plain versions vs the JAX package's Pallas
kernels (run with ``interpret=True`` on the CPU, as tests/test_kernels.py
runs them) and the dispatch of the entry points. The CUDA kernels against
their plain versions are in tests/test_torch_cuda.py (the card's machine has
no JAX).

Tolerances are tests/test_kernels.py's: 2e-5 absolute in fp32 (the sums run
in another order), 2e-2 absolute in bf16 (the Pallas kernels round p to bf16
before P.V; the plain versions keep it fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.decode_attention.kernel as decode_kernel
import repro_torch.kernels.flash_attention.kernel as flash_kernel
from repro.kernels.decode_attention import \
    decode_attention as jax_decode_attention
from repro.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.models.param import params_from_numpy

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def inputs(seed, dtype, *shapes):
    """Seeded numpy draws, as a JAX array and the bit-identical torch
    tensor each."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = jnp.asarray(rng.standard_normal(shape), JAX_DTYPE[dtype])
        out.append((a, params_from_numpy({"a": np.asarray(a)}, "cpu")["a"]))
    return out


def max_err(ref, got) -> float:
    return float(np.abs(np.asarray(ref.astype(jnp.float32))
                        - got.float().numpy()).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hk,D,bq,bk", [
    (1, 32, 2, 2, 16, 16, 16),      # MHA
    (2, 64, 4, 2, 32, 32, 32),      # GQA group 2
    (1, 128, 8, 2, 64, 64, 32),     # GQA group 4, rectangular blocks
    (1, 64, 6, 1, 32, 16, 64),      # MQA-ish, bk > bq
])
def test_flash_plain_matches_pallas(dtype, causal, B, S, H, Hk, D, bq, bk):
    (qj, qt), (kj, kt), (vj, vt) = inputs(
        0, dtype, (B, S, H, D), (B, S, Hk, D), (B, S, Hk, D))
    ref = jax_flash_attention(qj, kj, vj, causal=causal, block_q=bq,
                              block_k=bk, interpret=True)
    got = flash_attention(qt, kt, vt, causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == qt.dtype and tuple(got.shape) == ref.shape
    assert max_err(ref, got) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("used", [1, 63, 128, 256])
@pytest.mark.parametrize("B,H,Hk,D,L,bk", [
    (2, 8, 2, 32, 256, 64),
    (1, 4, 4, 16, 256, 128),        # MHA
    (3, 6, 1, 64, 256, 256),        # MQA, single block
])
def test_decode_plain_matches_pallas(dtype, used, B, H, Hk, D, L, bk):
    (qj, qt), (kj, kt), (vj, vt) = inputs(
        1, dtype, (B, 1, H, D), (B, L, Hk, D), (B, L, Hk, D))
    ref = jax_decode_attention(qj, kj, vj, jnp.int32(used), block_k=bk,
                               interpret=True)
    got = decode_attention(qt, kt, vt, torch.tensor(used, dtype=torch.int32),
                           block_k=bk)
    assert got.dtype == qt.dtype and tuple(got.shape) == ref.shape
    assert max_err(ref, got) < TOL[dtype]


def test_decode_ignores_stale_tail():
    """Garbage beyond `length` must not leak into the output."""
    (_, q), (_, k), (_, v) = inputs(2, "float32", (1, 1, 4, 16),
                                    (1, 64, 2, 16), (1, 64, 2, 16))
    k_dirty, v_dirty = k.clone(), v.clone()
    k_dirty[:, 40:] = 1e4
    v_dirty[:, 40:] = -1e4
    length = torch.tensor(40, dtype=torch.int32)
    a = decode_attention(q, k, v, length, block_k=32)
    b = decode_attention(q, k_dirty, v_dirty, length, block_k=32)
    assert torch.allclose(a, b, atol=1e-5)


def test_flash_rejects_bad_blocks():
    q = k = v = torch.zeros(1, 30, 2, 16)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(q, k, v, block_q=16, block_k=16)


def test_decode_rejects_bad_blocks():
    q = torch.zeros(1, 1, 2, 16)
    k = v = torch.zeros(1, 100, 2, 16)
    with pytest.raises(ValueError, match="block_k"):
        decode_attention(q, k, v, torch.tensor(1, dtype=torch.int32),
                         block_k=64)
    with pytest.raises(ValueError, match="single query"):
        decode_attention(torch.zeros(1, 2, 2, 16), k, v, 1, block_k=100)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """On CPU tensors the entry points run the plain versions: no launch is
    counted and the CUDA launchers are never reached."""
    def no_launch(*args, **kwargs):
        raise AssertionError("CUDA launcher reached from a CPU tensor")
    monkeypatch.setattr(flash_kernel, "launches", 0)
    monkeypatch.setattr(decode_kernel, "launches", 0)
    monkeypatch.setattr(flash_kernel, "_entry", no_launch)
    monkeypatch.setattr(decode_kernel, "_entry", no_launch)
    (_, q), (_, k), (_, v) = inputs(3, "bfloat16", (2, 32, 8, 16),
                                    (2, 32, 2, 16), (2, 32, 2, 16))
    out = flash_attention(q, k, v, block_q=16, block_k=16)
    assert torch.equal(out, flash_attention_plain(q, k, v))
    out = decode_attention(q[:, :1], k, v, torch.tensor(5, dtype=torch.int32),
                           block_k=32)
    assert torch.equal(out, decode_attention_plain(q[:, :1], k, v, 5))
    assert flash_kernel.launches == 0 and decode_kernel.launches == 0


def test_cuda_launchers_refuse_cpu_tensors():
    """The CUDA launchers take CUDA tensors only: a CPU tensor raises before
    any build or launch, it is never computed another way."""
    q = k = v = torch.zeros(1, 16, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q[:, :1], k, v,
                              torch.tensor(1, dtype=torch.int32))
