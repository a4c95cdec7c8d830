"""Plain PyTorch versions of the SSD kernel and of its gradient: the chunked
scan itself, and autograd through it.

This is the port's one copy of the JAX package's
``repro/models/ssm.py::ssd_chunked`` (the Pallas kernel's oracle there).
``models/ssm.py`` imports it from here: models import kernels, never the
other way, so there is no import cycle (in JAX, ``kernels/ssd/ref.py``
imports the model instead).
"""

from __future__ import annotations

import torch

__all__ = ["segsum", "ssd_chunked", "ssd_bwd_plain"]


def segsum(logd: torch.Tensor) -> torch.Tensor:
    """L[i, j] = sum_{j < t <= i} logd_t for j <= i, else -inf.
    logd: (..., Q) -> (..., Q, Q)."""
    Q = logd.shape[-1]
    cs = torch.cumsum(logd, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(Q, device=logd.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, diff, torch.tensor(-torch.inf, dtype=diff.dtype,
                                                device=diff.device))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                state0: torch.Tensor | None = None):
    """Chunked SSD. x: (B, S, H, P); dt: (B, S, H); A: (H,) negative;
    Bm, Cm: (B, S, N) (head-shared, G=1); state0: (B, H, P, N) fp32 or None.
    Returns (y (B, S, H, P) in x's dtype, final_state (B, H, P, N) fp32)."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq {S} % chunk {chunk} != 0")
    state = state0 if state0 is not None else torch.zeros(
        (Bb, H, P, N), dtype=torch.float32, device=x.device)
    A = A.float()
    ys = []
    for c0 in range(0, S, chunk):
        xc, dtc = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bc = Bm[:, c0:c0 + chunk].float()
        Cc = Cm[:, c0:c0 + chunk].float()
        dtc32 = dtc.float()
        logd = dtc32 * A                                  # (B, Q, H)
        xdt = xc.float() * dtc32[..., None]
        # intra-chunk (dual / attention form)
        L = torch.exp(segsum(logd.transpose(1, 2)))       # (B, H, Q, Q)
        scores = torch.einsum("bqn,bkn->bqk", Cc, Bc)     # (B, Q, Q)
        M = scores[:, None] * L
        y_intra = torch.einsum("bhqk,bkhp->bqhp", M, xdt)
        # inter-chunk: contribution of the incoming state
        cum = torch.cumsum(logd, dim=1)                   # (B, Q, H)
        decay_in = torch.exp(cum)
        y_inter = torch.einsum("bqn,bhpn,bqh->bqhp", Cc, state, decay_in)
        # state update
        total = torch.exp(cum[:, -1])                     # (B, H)
        decay_out = torch.exp(cum[:, -1][:, None] - cum)  # (B, Q, H)
        chunk_state = torch.einsum("bqhp,bqn,bqh->bhpn", xdt, Bc, decay_out)
        state = state * total[..., None, None] + chunk_state
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1), state


def ssd_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                  state0: torch.Tensor | None = None,
                  dstate: torch.Tensor | None = None, chunk: int = 64):
    """The gradient of ``ssd_chunked`` by autograd in fp32, in the layout of
    the backward kernel: dy (B, S, H, P) is the cotangent of y, ``dstate``
    (B, H, P, N) that of the final state (None: zeros). Returns (dx, ddt,
    dA, dB, dC, dstate0) in the inputs' dtypes; dstate0 is None when
    ``state0`` is."""
    with torch.enable_grad():
        xf, dtf, Af, Bf, Cf = (t.detach().float().requires_grad_()
                               for t in (x, dt, A, Bm, Cm))
        leaves = [xf, dtf, Af, Bf, Cf]
        s0 = None
        if state0 is not None:
            s0 = state0.detach().float().requires_grad_()
            leaves.append(s0)
        y, final = ssd_chunked(xf, dtf, Af, Bf, Cf, chunk, s0)
        outs, cots = [y], [dy.float()]
        if dstate is not None:
            outs.append(final)
            cots.append(dstate.float())
        grads = torch.autograd.grad(outs, leaves, cots)
    out = [g.to(t.dtype) for g, t in zip(grads, (x, dt, A, Bm, Cm))]
    return (*out, grads[5] if state0 is not None else None)
