"""The rounding of the bf16 SSD kernel (``csrc/ssd.cu``, ``ssd_bf16_kernel``),
emulated on the CPU, against the port's plain scan (``ssd_plain``) and the
JAX package's ``ssd_chunked``.

The kernel cannot run here, so this emulation repeats its arithmetic in
plain PyTorch, rounding where the kernel rounds: chunks of 64 positions;
C B^T exact (bf16 operands, fp32 sums); M = (C B^T) o L o dt_j rounded once
to bf16; the state rounded once to bf16 as the operand of state C^T; y
summed in fp32 and written in bf16; the state update with x w as a bf16
hi/lo pair and fp32 sums; each warp's 16 state rows on their own.

Tolerances are the kernel's own, halved: y relative to its largest
magnitude within half of 5 x 2e-2 (bf16), the final state relative within
half of 1e-4 (tests/test_torch_cuda.py holds the kernel to the full ones).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels.ssd import ssd_plain
from repro_torch.models.param import params_from_numpy

Q, SLICE = 64, 16
Y_TOL, STATE_TOL = 0.5 * 5 * 2e-2, 0.5 * 1e-4
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def emulate(x, dt, A, Bm, Cm, state0, split_state_update=True):
    """The bf16 kernel's arithmetic: x, Bm, Cm bf16; dt bf16 or fp32; A
    fp32; state0 fp32 -> (y bf16, final state fp32). With
    ``split_state_update=False`` the state update takes x w rounded once to
    bf16 instead of as a hi/lo pair."""
    B, S, H, P = x.shape
    pad = -S % Q                                   # the ragged tail: zeros

    def padded(t):
        return torch.cat([t.float(), t.new_zeros((B, pad) + t.shape[2:])
                          .float()], 1)

    xs, dts, Bs, Cs = padded(x), padded(dt), padded(Bm), padded(Cm)
    state = state0.clone()
    ii = torch.arange(Q)
    lower = (ii[:, None] >= ii[None, :])[None, :, :, None]     # (1, i, j, 1)
    ys = []
    for c0 in range(0, S + pad, Q):
        xc, dtc = xs[:, c0:c0 + Q], dts[:, c0:c0 + Q]
        Bc, Cc = Bs[:, c0:c0 + Q], Cs[:, c0:c0 + Q]
        cum = torch.cumsum(dtc * A, 1)                          # (B, Q, H)
        last = cum[:, -1]                                       # (B, H)
        w = dtc * torch.exp(last[:, None] - cum)
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)               # exact
        seg = cum[:, :, None, :] - cum[:, None, :, :]           # (B, i, j, H)
        m = torch.where(lower, cb[..., None] * torch.exp(
            torch.where(lower, seg, 0.0)) * dtc[:, None], 0.0)
        mb = bf16(m)
        y = torch.empty_like(xc)
        for p0 in range(0, P, SLICE):                           # one warp
            sl = slice(p0, p0 + SLICE)
            st = state[:, :, sl]                                # (B, H, 16, N)
            y_inter = torch.einsum("bin,bhpn->bihp", Cc, bf16(st)) \
                * torch.exp(cum)[..., None]
            y[..., sl] = y_inter + torch.einsum("bijh,bjhp->bihp", mb,
                                                xc[..., sl])
            xw = xc[..., sl] * w[..., None]                     # (B, j, H, 16)
            hi = bf16(xw)
            upd = torch.einsum("bjhp,bjn->bhpn", hi, Bc)
            if split_state_update:
                upd = upd + torch.einsum("bjhp,bjn->bhpn", bf16(xw - hi), Bc)
            state[:, :, sl] = st * torch.exp(last)[..., None, None] + upd
        ys.append(y)
    return torch.cat(ys, 1)[:, :S].to(torch.bfloat16), state


def inputs(seed, B, S, H, P, N, dt_dtype):
    """x, dt, A, B, C, state0 as (jax, torch) pairs with identical bits:
    x/B/C bf16, dt a softplus of a normal draw, A = -exp(normal), a random
    fp32 state0, as the kernel's checks on the card draw them."""
    rng = np.random.default_rng(seed)
    arrays = [
        jnp.asarray(rng.standard_normal((B, S, H, P)), jnp.bfloat16),
        jnp.asarray(np.logaddexp(rng.standard_normal((B, S, H)), 0),
                    DTYPES[dt_dtype]),
        jnp.asarray(-np.exp(rng.standard_normal(H)), jnp.float32),
        jnp.asarray(rng.standard_normal((B, S, N)), jnp.bfloat16),
        jnp.asarray(rng.standard_normal((B, S, N)), jnp.bfloat16),
        jnp.asarray(rng.standard_normal((B, H, P, N)), jnp.float32),
    ]
    return [(a, params_from_numpy({"a": np.asarray(a)}, "cpu")["a"])
            for a in arrays]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


CASES = [
    # (B, S, H, P, N, plain chunk, dt dtype)
    (2, 200, 3, 16, 32, 40, "float32"),      # reduced, a ragged last chunk
    (2, 200, 3, 8, 16, 40, "bfloat16"),      # P = 8: half a warp's slice
    (1, 512, 2, 64, 128, 256, "float32"),    # one full-width head group
]


@pytest.mark.parametrize("B,S,H,P,N,chunk,dt_dtype", CASES)
def test_split_rounding_within_half_the_tolerance(B, S, H, P, N, chunk,
                                                   dt_dtype):
    pairs = inputs(11, B, S, H, P, N, dt_dtype)
    (xj, xt), (dj, dtt), (aj, at), (bj, bt), (cj, ct), (sj, st) = pairs
    y, state = emulate(xt, dtt, at, bt, ct, st)
    y_plain, state_plain = ssd_plain(xt, dtt, at, bt, ct, chunk, st)
    y_jax, state_jax = jssm.ssd_chunked(xj, dj, aj, bj, cj, chunk,
                                        state0=sj)
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(state).all())
    for y_ref, s_ref in ((f32(y_plain), f32(state_plain)),
                         (f32(y_jax), f32(state_jax))):
        assert rel(f32(y), y_ref) <= Y_TOL
        assert rel(f32(state), s_ref) < STATE_TOL


def test_single_rounding_of_the_state_update_misses_the_bound():
    """Why the kernel carries x w as a hi/lo pair: rounded once to bf16, the
    state update alone puts the final state past the bound at one
    full-width head group."""
    pairs = inputs(11, 1, 512, 2, 64, 128, "float32")
    (_, xt), (_, dtt), (_, at), (_, bt), (_, ct), (_, st) = pairs
    _, state_plain = ssd_plain(xt, dtt, at, bt, ct, 256, st)
    _, state = emulate(xt, dtt, at, bt, ct, st, split_state_update=False)
    assert rel(f32(state), f32(state_plain)) > 1e-4


def test_slices_are_independent():
    """The P split is exact: a slice's rows scanned alone equal the same
    rows of the whole scan."""
    pairs = inputs(12, 1, 130, 2, 32, 32, "float32")
    (_, xt), (_, dtt), (_, at), (_, bt), (_, ct), (_, st) = pairs
    y, state = emulate(xt, dtt, at, bt, ct, st)
    y1, state1 = emulate(xt[..., 16:], dtt, at, bt, ct, st[:, :, 16:])
    assert torch.equal(y[..., 16:], y1) and torch.equal(state[:, :, 16:],
                                                        state1)
