"""The SSD scan's gradient in the port, on the CPU: ``ssd_bwd_plain`` and
the chunk walk that the CUDA backward kernel (``csrc/ssd_bwd.cu``) computes
against ``jax.vjp`` of the JAX package's ``ssd_chunked``; the autograd
Function that carries the kernels on the card, with the kernels replaced by
their plain versions; and the rule the card holds the kernel to
(||got - want|| <= 1e-2 ||want|| in bf16), against the kernel's emulated
rounding and planted faults (``tools/ssd_bwd_tolerance.py``). The kernel
itself against its plain version is in tests/test_torch_cuda.py.

Tolerances, each ||got - want|| / ||want||:

* fp32: 1e-5 (the same sums taken in another order and another chunking);
  dA 1e-4: each of its H values sums dt_t da_t over B S positions, terms of
  either sign and larger than their sum, so their rounding is not;
* bf16 inputs: dx, dB and dC are bf16 on both sides, each rounded once from
  fp32 sums taken in another order, so an element may land one bf16 step
  (2^-8 of it) apart: 4e-3; ddt, dA and dstate0 are fp32 (as above).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.ssd.ops as ssd_ops
import repro_torch.models.ssm as port_ssm
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ssd, ssd_bwd_cuda, ssd_bwd_plain
from repro_torch.kernels.ssd import kernel_bwd
from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.models import build_model, init_params
from repro_torch.models.param import tree_items, tree_map

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dstate0")
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "ssd_bwd_tolerance", ROOT / "tools" / "ssd_bwd_tolerance.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def err(got, want) -> float:
    got = torch.as_tensor(np.asarray(got, np.float64)) \
        if not isinstance(got, torch.Tensor) else got.double()
    want = torch.as_tensor(np.asarray(want, np.float64)) \
        if not isinstance(want, torch.Tensor) else want.double()
    return float((got - want).norm() / want.norm())


def tol(name: str, dtype: str) -> float:
    if dtype == "bfloat16" and name in ("dx", "dB", "dC"):
        return 4e-3
    return 1e-4 if name == "dA" else 1e-5


def draw(seed, B, S, H, P, N, dtype, with_state, with_dstate):
    """x, dt, A, B, C, dy, state0, dstate as numpy arrays (x, B, C, dy
    already rounded to ``dtype``), drawn as the kernel checks draw them."""
    rng = np.random.default_rng(seed)

    def rounded(shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(a, DTYPES[dtype]).astype(jnp.float32))
    x, Bm, Cm, dy = (rounded(s) for s in ((B, S, H, P), (B, S, N),
                                          (B, S, N), (B, S, H, P)))
    dt = np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    state0 = rng.standard_normal((B, H, P, N)).astype(np.float32) \
        if with_state else None
    dstate = rng.standard_normal((B, H, P, N)).astype(np.float32) \
        if with_dstate else None
    return x, dt, A, Bm, Cm, dy, state0, dstate


def jax_vjp(x, dt, A, Bm, Cm, dy, state0, dstate, chunk, dtype):
    """The cotangents of ssd_chunked's inputs (and of state0, or None)."""
    t = DTYPES[dtype]
    args = [jnp.asarray(x, t), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(Bm, t), jnp.asarray(Cm, t)]
    if state0 is not None:
        args.append(jnp.asarray(state0))

    def f(*a):
        return jssm.ssd_chunked(*a[:5], chunk, a[5] if len(a) > 5 else None)
    (y, final), vjp = jax.vjp(f, *args)
    ds = jnp.zeros_like(final) if dstate is None else jnp.asarray(dstate)
    grads = vjp((jnp.asarray(dy, t), ds))
    out = [np.asarray(g.astype(jnp.float32)) for g in grads]
    return out + [None] * (6 - len(out))


def torch_of(a, dtype="float32"):
    return None if a is None else torch.tensor(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("with_dstate", [False, True])
def test_ssd_bwd_plain_matches_jax_vjp(dtype, chunk, with_state,
                                       with_dstate):
    B, S, H, P, N = 2, 128, 3, 8, 16
    x, dt, A, Bm, Cm, dy, s0, ds = draw(chunk + 2 * with_state + with_dstate,
                                        B, S, H, P, N, dtype, with_state,
                                        with_dstate)
    want = jax_vjp(x, dt, A, Bm, Cm, dy, s0, ds, chunk, dtype)
    got = ssd_bwd_plain(torch_of(x, dtype), torch_of(dt), torch_of(A),
                        torch_of(Bm, dtype), torch_of(Cm, dtype),
                        torch_of(dy, dtype), state0=torch_of(s0),
                        dstate=torch_of(ds), chunk=chunk)
    for name, g, w, like in zip(NAMES, got, want,
                                (dtype, "float32", "float32", dtype, dtype,
                                 "float32")):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == getattr(torch, like), name
        assert err(g, w) <= tol(name, dtype), name


@pytest.mark.parametrize("S,chunk", [(128, 32), (100, 25), (64, 64)])
@pytest.mark.parametrize("with_state,with_dstate", [(False, False),
                                                    (True, True)])
def test_kernel_chunk_walk_matches_jax_vjp(S, chunk, with_state,
                                           with_dstate):
    """The kernel's formulas (tools/ssd_bwd_tolerance.py::backward, fp64,
    chunks of 64, a ragged S padded with zeros) against jax.vjp at the
    reference's own chunk, fp32 inputs (1e-5; dA 1e-4)."""
    tool = _tool()
    x, dt, A, Bm, Cm, dy, s0, ds = draw(S + with_state, 2, S, 3, 8, 16,
                                        "float32", with_state, with_dstate)
    want = jax_vjp(x, dt, A, Bm, Cm, dy, s0, ds, chunk, "float32")
    t = [torch_of(a) for a in (x, dt, A, Bm, Cm, dy, s0, ds)]
    states = tool.chunk_states(*t[:5], t[6])
    got = tool.backward(*t[:6], states, t[7])
    for name, g, w in zip(NAMES, got, want):
        if w is not None:
            assert err(g, w) <= tol(name, "float32"), name


def test_chunk_states_are_the_scan_of_each_prefix():
    """The state entering chunk c, as the forward kernel writes it for the
    backward, is the final state of the plain scan over the first 64 c
    positions (or state0 at c = 0)."""
    tool = _tool()
    x, dt, A, Bm, Cm, _, s0, _ = (torch_of(a) for a in draw(
        9, 2, 200, 3, 8, 16, "float32", True, False))
    states = tool.chunk_states(x, dt, A, Bm, Cm, s0)
    assert states.shape == (2, 3, 4, 8, 16)
    assert torch.equal(states[:, :, 0], s0.double())
    for c in (1, 2, 3):
        _, want = ssd_chunked(x[:, :64 * c], dt[:, :64 * c], A,
                              Bm[:, :64 * c], Cm[:, :64 * c], 64, s0)
        assert err(states[:, :, c], want) <= 1e-5


def _plain_states(x, dt, A, Bm, Cm, state0):
    """The forward kernel's chunk-entry states, by the plain scan."""
    S = x.shape[1]
    out = [state0 if state0 is not None else torch.zeros(
        x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1])]
    for c0 in range(64, S, 64):
        out.append(ssd_chunked(x[:, :c0], dt[:, :c0], A, Bm[:, :c0],
                               Cm[:, :c0], 64, state0)[1])
    return torch.stack(out, 2).float()


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """``_SSD`` with its two CUDA kernels replaced by their plain versions,
    so that its wiring runs on CPU tensors; counts the calls."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(x, dt, A, Bm, Cm, *, state0=None, return_states=False):
        assert return_states
        calls["fwd"] += 1
        y, final = ssd_chunked(x, dt, A, Bm, Cm, 64, state0)
        return y, final, _plain_states(x.float(), dt, A, Bm.float(),
                                       Cm.float(), state0)

    def bwd(x, dt, A, Bm, Cm, dy, states, *, dstate=None,
            want_dstate0=False):
        calls["bwd"] += 1
        assert states.shape[2] == -(-x.shape[1] // 64)
        out = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=64,
                            state0=states[:, :, 0] if want_dstate0 else None,
                            dstate=dstate)
        return out[:5] + (out[5] if want_dstate0 else None,)
    monkeypatch.setattr(ssd_ops, "ssd_cuda", fwd)
    monkeypatch.setattr(ssd_ops, "ssd_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_function_gradients_reach_every_input(kernels_as_plain,
                                                  with_state, dtype):
    """Through ``_SSD`` (the path of a CUDA tensor under grad) the
    gradients of x, dt, A, B, C and state0, for a loss on y and on the
    final state, are autograd's through ``ssd_chunked`` (the tolerances
    above)."""
    tdt = getattr(torch, dtype)
    x, dt, A, Bm, Cm, dy, s0, ds = draw(4, 2, 128, 3, 8, 16, dtype,
                                        with_state, True)

    def leaves():
        t = [torch_of(x, dtype), torch_of(dt), torch_of(A),
             torch_of(Bm, dtype), torch_of(Cm, dtype), torch_of(s0)]
        return [None if a is None else a.requires_grad_() for a in t]
    cot = (torch_of(dy, dtype), torch_of(ds))
    via = leaves()
    y, final = ssd_ops._SSD.apply(*via)
    assert y.grad_fn is not None and y.dtype == tdt
    torch.autograd.backward((y, final), cot)
    plain = leaves()
    y_ref, final_ref = ssd_chunked(*plain[:5], 64, plain[5])
    torch.autograd.backward((y_ref, final_ref), cot)
    assert kernels_as_plain == {"fwd": 1, "bwd": 1}
    for name, g, w in zip(NAMES, via, plain):
        if w is None:
            continue
        assert g.grad is not None and g.grad.dtype == w.grad.dtype, name
        assert err(g.grad, w.grad) <= tol(name, dtype), name


def test_ssd_function_takes_an_unused_final_state(kernels_as_plain):
    """The training path reads y only: the final state's cotangent reaches
    the backward as None, and a strided dy is taken as it comes."""
    x, dt, A, Bm, Cm, dy, _, _ = draw(5, 1, 64, 2, 8, 16, "bfloat16", False,
                                      False)
    t = [torch_of(x, "bfloat16"), torch_of(dt), torch_of(A),
         torch_of(Bm, "bfloat16"), torch_of(Cm, "bfloat16")]
    for a in t:
        a.requires_grad_()
    dyt = torch_of(dy, "bfloat16").transpose(2, 3).contiguous() \
        .transpose(2, 3)
    y, _ = ssd_ops._SSD.apply(*t, None)
    got = torch.autograd.grad(y, t, dyt)
    want = ssd_bwd_plain(*t, dyt, chunk=64)
    for name, g, w in zip(NAMES, got, want):
        assert err(g, w) <= tol(name, "bfloat16"), name


def test_mamba_block_gradients_go_through_the_function(kernels_as_plain,
                                                       monkeypatch):
    """The reduced mamba2 model's loss: every leaf's gradient (dt_bias,
    A_log, D, the projections, the convs, the norm, the embedding) with the
    scan routed through ``_SSD`` as on the card, against autograd through
    ``ssd_chunked`` (the CPU path), fp32 weights: 1e-5 of each leaf's
    norm."""
    cfg = get_config("mamba2-370m", reduced=True)
    model = build_model(cfg)
    params = tree_map(lambda a: a.float(), init_params(
        model.param_decls(), torch.Generator().manual_seed(0), "cpu"))
    model._embed = lambda p, tokens: p["embed"][tokens]
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 129)))

    def grads():
        leaves = tree_map(lambda a: a.clone().requires_grad_(), params)
        model.loss_fn(leaves, {"tokens": toks}).backward()
        return {"/".join(p): t.grad for p, t in tree_items(leaves)}
    want = grads()

    def via_function(x, dt, A, Bm, Cm, *, chunk, state0=None,
                     state_out=None):
        assert state0 is None and state_out is None
        return ssd_ops._SSD.apply(x, dt, A, Bm, Cm, state0)
    monkeypatch.setattr(port_ssm, "ssd", via_function)
    got = grads()
    n = cfg.n_layers * (2 if cfg.remat else 1)
    assert kernels_as_plain == {"fwd": n, "bwd": cfg.n_layers}
    assert set(got) == set(want)
    for k in ("layers/mamba/dt_bias", "layers/mamba/A_log",
              "layers/mamba/w_x", "layers/mamba/w_B", "layers/mamba/w_C",
              "layers/mamba/w_dt"):
        assert k in got and float(got[k].abs().max()) > 0, k
    for k, w in want.items():
        assert got[k] is not None and err(got[k], w) <= 1e-5, k


def test_state_out_under_grad_raises():
    x, dt, A, Bm, Cm, _, s0, _ = (torch_of(a) for a in draw(
        6, 1, 32, 2, 8, 16, "float32", True, False))
    x.requires_grad_()
    with pytest.raises(ValueError, match="state_out"):
        ssd(x, dt, A, Bm, Cm, chunk=16, state0=s0, state_out=s0)
    with torch.no_grad():
        y, st = ssd(x, dt, A, Bm, Cm, chunk=16, state0=s0, state_out=s0)
    assert st is s0 and y.shape == x.shape


def test_ssd_bwd_cuda_refuses_cpu_tensors():
    x, dt, A, Bm, Cm, dy, _, _ = (torch_of(a) for a in draw(
        7, 1, 64, 2, 8, 16, "float32", False, False))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_bwd_cuda(x, dt, A, Bm, Cm, dy, torch.zeros(1, 2, 1, 8, 16))


@pytest.mark.parametrize("dtype,P,N,tc", [
    (torch.bfloat16, 64, 128, True), (torch.bfloat16, 16, 16, False),
    (torch.bfloat16, 32, 64, False), (torch.float32, 64, 128, False),
    (torch.bfloat16, 8, 128, False), (torch.bfloat16, 128, 128, False),
    (torch.bfloat16, 64, 256, False), (torch.bfloat16, 48, 64, False),
    (torch.bfloat16, 64, 64, False), (torch.bfloat16, 32, 128, False)])
def test_tensor_core_kernel_takes_its_sizes(dtype, P, N, tc):
    """bf16 at mamba2-370m's heads (P = 64, N = 128), the one size the
    source instantiates, walks on the tensor cores; the rest on the scalar
    kernel."""
    assert kernel_bwd.tensor_cores(dtype, P, N) == tc


def test_rule_passes_the_kernel_rounding_and_fails_planted_faults():
    """The kernel's rule (||got - want|| <= 1e-2 ||want||, bf16) against
    the kernel's arithmetic emulated (fp32 walk, dx, dB, dC rounded to
    bf16): under half of it; and each planted fault (chunk states read as
    zeros, dB over half the heads, no state gradient across chunks): over
    it. The training shape's P and N, cut to B=1, S=256, H=8."""
    readings = _tool().kernel_readings(B=1, S=256, H=8, P=64, N=128)
    assert len(readings) == 8
    for name, value in readings.items():
        if name.startswith("rounding"):
            assert value < 0.5e-2, name
        else:
            assert value > 1e-2, name
