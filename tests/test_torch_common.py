"""Parity of the port's layer primitives with the JAX package's.

Same numpy inputs through ``repro.models.common`` and
``repro_torch.models.common``. JAX runs op by op here (no jit), so both sides
round at the same places: fp32 results agree to float32 rounding (1e-6
relative, libm differences in cos/sin/rsqrt); bf16 results agree to one bf16
ulp (2^-8 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jc
from repro_torch.models import common as tc
from repro_torch.models.param import params_from_numpy

TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def to_torch(a):
    return params_from_numpy({"a": np.asarray(a)}, "cpu")["a"]


def rel_err(ref, got) -> float:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 8, 64)) * 3, jd)
    scale = jnp.asarray(rng.standard_normal(64), jd)
    got = tc.rms_norm(to_torch(x), to_torch(scale))
    assert got.dtype == td
    assert rel_err(jc.rms_norm(x, scale), got) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_matches_jax(dtype):
    jd, td = DTYPES[dtype]
    x = jnp.asarray(np.random.default_rng(1).standard_normal((4, 64)) * 4, jd)
    got = tc.silu(to_torch(x))
    assert got.dtype == td
    assert rel_err(jc.silu(x), got) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["gelu", "squared_relu"])
def test_plain_mlp_activations_match_jax(name, dtype):
    """gelu (tanh form) and squared ReLU, the plain MLPs' activations. In
    bf16 the port rounds op for op where JAX does (gelu's constants in bf16
    too), so the results are equal bit for bit: ``F.gelu(approximate=
    "tanh")``, which rounds once, misses by a bf16 ulp on ~1/3 of these
    inputs, and this test would catch it. In fp32 the only difference is
    libm's tanh: 1e-6 of the largest magnitude."""
    jd, td = DTYPES[dtype]
    x = jnp.asarray(np.random.default_rng(4).standard_normal((8, 512)) * 4,
                    jd)
    got = getattr(tc, name)(to_torch(x))
    want = getattr(jc, name)(x)
    assert got.dtype == td
    if dtype == "bfloat16":
        assert np.array_equal(np.asarray(want.astype(jnp.float32)),
                              got.float().numpy())
    else:
        assert rel_err(want, got) <= TOL[dtype]


def test_activations_registry_matches_jax():
    assert set(tc.ACTIVATIONS) == set(jc.ACTIVATIONS)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_table_matches_jax(theta):
    pos = np.arange(0, 544, 7).reshape(2, -1)
    cos_j, sin_j = jc.rope_table(jnp.asarray(pos), 64, theta)
    cos_t, sin_t = tc.rope_table(torch.as_tensor(pos), 64, theta)
    assert cos_t.dtype == torch.float32 and cos_t.shape == cos_j.shape
    # angles up to 543 rad: cos/sin of the same fp32 angle, to fp32 rounding
    # of the argument (543 * 2^-24 ~ 3e-5 absolute)
    assert np.abs(np.asarray(cos_j) - cos_t.numpy()).max() < 1e-4
    assert np.abs(np.asarray(sin_j) - sin_t.numpy()).max() < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("table_rank", [2, 3])
def test_apply_rope_matches_jax(dtype, table_rank):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 9, 4, 16)), jd)
    pos = np.arange(9) if table_rank == 2 else \
        np.stack([np.arange(9), np.arange(9) + 5])
    cos, sin = jc.rope_table(jnp.asarray(pos), 16)
    got = tc.apply_rope(to_torch(x), to_torch(cos), to_torch(sin))
    assert got.dtype == td and tuple(got.shape) == x.shape
    assert rel_err(jc.apply_rope(x, cos, sin), got) <= TOL[dtype]


def test_matmul_promotes_like_einsum():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 3, 8)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((8, 5)), jnp.float32)
    ref = jnp.einsum("bsm,mf->bsf", x, w)
    got = tc.matmul(to_torch(x), to_torch(w))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    assert rel_err(ref, got) <= 1e-6
