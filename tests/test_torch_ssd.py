"""The port's SSD entry point (``repro_torch.kernels.ssd``): its plain version
against the JAX package's Pallas kernel (run with ``interpret=True`` on the
CPU, as tests/test_kernels.py runs it), and its dispatch. The CUDA kernel
against the plain version is in tests/test_torch_cuda.py (the card's machine
has no JAX).

Tolerance is tests/test_kernels.py's for ssd: relative to y's largest
magnitude, 5x the dtype's (2e-5 fp32, 2e-2 bf16), since the two scan in
chunks and sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.ssd.kernel as ssd_kernel
from repro.kernels.ssd import ssd as jax_ssd
from repro_torch.kernels.ssd import ssd, ssd_cuda, ssd_plain
from repro_torch.models.param import params_from_numpy

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def inputs(seed, B, S, H, P, N, dtype, dt_dtype):
    """x, dt, A, B, C as (jax, torch) pairs with identical bits, drawn as
    tests/test_kernels.py draws them (dt a softplus of a normal, A =
    -exp(normal) in fp32)."""
    rng = np.random.default_rng(seed)
    arrays = [
        jnp.asarray(rng.standard_normal((B, S, H, P)), DTYPES[dtype]),
        jnp.asarray(np.logaddexp(rng.standard_normal((B, S, H)), 0),
                    DTYPES[dt_dtype]),
        jnp.asarray(-np.exp(rng.standard_normal(H)), jnp.float32),
        jnp.asarray(rng.standard_normal((B, S, N)), DTYPES[dtype]),
        jnp.asarray(rng.standard_normal((B, S, N)), DTYPES[dtype]),
    ]
    return [(a, params_from_numpy({"a": np.asarray(a)}, "cpu")["a"])
            for a in arrays]


def rel_err(ref, got) -> float:
    ref = np.asarray(ref.astype(jnp.float32))
    return float(np.abs(ref - got.float().numpy()).max()
                 / (np.abs(ref).max() + 1e-9))


@pytest.mark.parametrize("dtype,dt_dtype", [
    ("float32", "float32"),
    ("bfloat16", "bfloat16"),
    ("bfloat16", "float32"),        # as the model passes them
])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 32, 2, 8, 16, 16),
    (2, 64, 4, 16, 32, 32),
    (1, 128, 8, 64, 128, 64),       # full-size head dims (mamba2-370m)
    (2, 64, 4, 16, 32, 64),         # one chunk covers S
])
def test_ssd_plain_matches_pallas(dtype, dt_dtype, B, S, H, P, N, chunk):
    (xj, xt), (dj, dtt), (aj, at), (bj, bt), (cj, ct) = inputs(
        3, B, S, H, P, N, dtype, dt_dtype)
    ref = jax_ssd(xj, dj, aj, bj, cj, chunk=chunk, interpret=True)
    y, state = ssd(xt, dtt, at, bt, ct, chunk=chunk)
    assert y.dtype == xt.dtype and tuple(y.shape) == ref.shape
    assert state.dtype == torch.float32 and tuple(state.shape) == (B, H, P, N)
    assert rel_err(ref, y) < 5 * TOL[dtype]


def test_ssd_long_context_stability():
    """A decaying state over many chunks: no NaN or Inf."""
    x, dt, A, Bm, Cm = [t for _, t in inputs(4, 1, 512, 2, 8, 16, "float32",
                                             "float32")]
    y, state = ssd(x, dt, A, Bm, Cm, chunk=64)
    assert bool(torch.isfinite(y).all() and torch.isfinite(state).all())


def test_ssd_rejects_chunk_that_does_not_divide():
    x, dt, A, Bm, Cm = [t for _, t in inputs(0, 1, 48, 2, 8, 16, "float32",
                                             "float32")]
    with pytest.raises(ValueError, match="chunk"):
        ssd(x, dt, A, Bm, Cm, chunk=32)
    ssd(x, dt, A, Bm, Cm, chunk=64)          # min(chunk, S) = S divides


def test_ssd_state0_and_state_out():
    """state0 seeds the scan (two halves == the whole); state_out receives
    the final state in place and is what is returned."""
    x, dt, A, Bm, Cm = [t for _, t in inputs(5, 2, 64, 4, 8, 16, "float32",
                                             "float32")]
    y, state = ssd(x, dt, A, Bm, Cm, chunk=16)
    buf = torch.zeros(2, 4, 8, 16)
    y1, s1 = ssd(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32], chunk=16,
                 state_out=buf)
    assert s1 is buf
    y2, s2 = ssd(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:], chunk=16,
                 state0=buf, state_out=buf)
    assert s2 is buf
    assert torch.allclose(torch.cat([y1, y2], 1), y, rtol=1e-5, atol=1e-5)
    assert torch.allclose(buf, state, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """On CPU tensors the entry point runs the plain version: no launch is
    counted and the CUDA launcher is never reached."""
    def no_launch(*args, **kwargs):
        raise AssertionError("CUDA launcher reached from a CPU tensor")
    monkeypatch.setattr(ssd_kernel, "launches", 0)
    monkeypatch.setattr(ssd_kernel, "_entry", no_launch)
    x, dt, A, Bm, Cm = [t for _, t in inputs(6, 2, 32, 4, 8, 16, "bfloat16",
                                             "float32")]
    y, state = ssd(x, dt, A, Bm, Cm, chunk=16)
    y_ref, state_ref = ssd_plain(x, dt, A, Bm, Cm, chunk=16)
    assert torch.equal(y, y_ref) and torch.equal(state, state_ref)
    assert ssd_kernel.launches == 0


def test_ssd_cuda_refuses_cpu_tensors():
    """The CUDA launcher takes CUDA tensors only: a CPU tensor raises before
    any build or launch; it is never computed another way."""
    x, dt, A, Bm, Cm = [t for _, t in inputs(7, 1, 16, 2, 8, 16, "bfloat16",
                                             "float32")]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(x, dt, A, Bm, Cm)


def test_serving_shape_fits_shared_memory():
    """mamba2-370m's heads (P=64, N=128) fit one block's shared memory."""
    assert ssd_kernel.smem_bytes(64, 128) <= ssd_kernel._MAX_SMEM
    assert ssd_kernel.smem_bytes(128, 256) > ssd_kernel._MAX_SMEM
