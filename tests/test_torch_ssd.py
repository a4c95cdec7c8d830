"""The port's SSD entry point (``repro_torch.kernels.ssd``): its plain version
against the JAX package's Pallas kernel (run with ``interpret=True`` on the
CPU, as tests/test_kernels.py runs it), and its dispatch. The CUDA kernel
against the plain version is in tests/test_torch_cuda.py (the card's machine
has no JAX).

Tolerance is tests/test_kernels.py's for ssd: relative to y's largest
magnitude, 5x the dtype's (2e-5 fp32, 2e-2 bf16), since the two scan in
chunks and sum in different orders.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.ssd.kernel as ssd_kernel
from repro.kernels.ssd import ssd as jax_ssd
from repro_torch.kernels.ssd import ssd, ssd_cuda, ssd_plain
from repro_torch.models.param import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
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
    """mamba2-370m's heads (P=64, N=128) fit the bf16 kernel's design: one
    block of four 16-row slices per (b, h), two blocks an SM by shared
    memory, so the serving batch's 8 x 32 blocks fill 132 SMs in one wave.
    The fp32 kernel fits one block's shared memory there, and not at
    P=128, N=256."""
    geo = ssd_kernel.plan(8, 32, 64, 128, torch.bfloat16)
    assert (geo.kernel, geo.warps, geo.rows) == ("bf16", 4, 64)
    assert geo.smem_bytes == 99328 <= ssd_kernel._MAX_SMEM
    assert geo.blocks_per_sm == 2 and geo.grid == (256, 1)
    assert geo.grid[0] * geo.grid[1] <= 132 * geo.blocks_per_sm
    f32 = ssd_kernel.plan(8, 32, 64, 128, torch.float32)
    assert f32.smem_bytes <= ssd_kernel._MAX_SMEM and f32.grid == (256, 1)
    with pytest.raises(ValueError, match="shared"):
        ssd_kernel.plan(1, 1, 128, 256, torch.float32)


@pytest.mark.parametrize("P,N,warps,rows,grid", [
    (8, 16, 1, 16, (256, 1)),       # P = 8: half of one warp's 16 rows
    (16, 32, 1, 16, (256, 1)),
    (48, 64, 2, 32, (256, 2)),
    (64, 128, 4, 64, (256, 1)),
    (128, 128, 4, 64, (256, 2)),    # past 64 rows, more blocks per (b, h)
])
def test_plan_slices_the_state_rows(P, N, warps, rows, grid):
    """The bf16 launch at the serving batch (B*H = 8*32): 16 state rows a
    warp, up to 4 warps a block, the rest of P over more blocks."""
    geo = ssd_kernel.plan(8, 32, P, N, torch.bfloat16)
    assert (geo.warps, geo.rows, geo.grid) == (warps, rows, grid)
    assert geo.smem_bytes <= ssd_kernel._MAX_SMEM and geo.blocks_per_sm >= 2


@pytest.mark.parametrize("P,warps,smem", [
    (16, 1, 87040), (32, 2, 91136), (64, 4, 99328)])
def test_plan_shared_memory_by_warps(P, warps, smem):
    """At N=128 every block stages the chunk's whole B and C whatever its
    warps, so the shared memory grows only with the rows of x and y a block
    owns; one, two or four warps all keep two blocks an SM."""
    geo = ssd_kernel.plan(8, 32, P, 128, torch.bfloat16)
    assert (geo.warps, geo.smem_bytes, geo.blocks_per_sm) == (warps, smem, 2)


def test_phase_ablation_finds_step_one():
    """tools/ssd_phases.py times copies of ssd.cu with parts of step 1 cut
    out; its anchors must each match the source once, and the cuts must
    remove C B^T's products (no-CB) or all of step 1 (no-M)."""
    spec = importlib.util.spec_from_file_location(
        "ssd_phases", ROOT / "tools" / "ssd_phases.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (ROOT / "src" / "repro_torch" / "csrc" / "ssd.cu").read_text()
    no_cb = tool._cut(src, tool._ACC, tool._EPILOGUE)
    no_m = tool._cut(src, tool._ACC, tool._STEP2)
    assert src.count("mma_16816(acc[k]") == 2
    assert "mma_16816(acc[k]" not in no_cb and "__expf(ci - cj0)" in no_cb
    assert "mma_16816(acc[k]" not in no_m and "__expf(ci - cj0)" not in no_m
    assert no_m.count("mma_16816(") == src.count("mma_16816(") - 2


@pytest.mark.parametrize("P,N,dtype,match", [
    (64, 256, torch.bfloat16, "N in"),    # N/2 fp32 values a lane
    (64, 48, torch.bfloat16, "N in"),
    (12, 128, torch.bfloat16, "P % 8"),   # 16-byte copies of x
    (64, 128, torch.float16, "dtype"),
])
def test_plan_rejects(P, N, dtype, match):
    with pytest.raises(ValueError, match=match):
        ssd_kernel.plan(2, 3, P, N, dtype)
