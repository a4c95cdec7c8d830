#!/usr/bin/env python3
"""What the SSD backward's check can tell apart, on the CPU.

    PYTHONPATH=src python3 tools/ssd_bwd_tolerance.py   # repository root

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the SSD backward
kernel (``src/repro_torch/csrc/ssd_bwd.cu``) to ||got - want|| / ||want||
<= 1e-2 in bf16 (1e-4 in fp32) for each of dx, ddt, dA, dB, dC and dstate0,
against ``ssd_bwd_plain`` (autograd through the chunked scan in fp32). This
script gives the numbers that rule rests on, at the training shape cut to
batch 2 (B=2, S=512, H=32, P=64, N=128; x, B, C, dy bf16 standard normal,
dt fp32 a softplus of a normal, A = -exp(normal)), the plain version at the
model's chunk (256):

- rounding: the bf16 kernel's arithmetic (the wgmma walk), emulated
  (:func:`backward` with ``kernel_rounding``: the chunk walk of the
  source's head note in fp32, chunks of 64, the operands it feeds its
  products in bf16 rounded once where it rounds them: (C B^T) o L,
  (dy x^T) o L dt, the entering state s, g, and e_in dy; dB and dC summed
  over the heads in the walk's order on an H100 (:func:`head_sum`: each
  pair of heads, then a cluster's two pairs, then the clusters' partials
  in order); dx, dB and dC rounded to bf16 at the end, as the kernel
  writes them; ddt and dA stay fp32);
- planted faults, each made by the same walk on altered inputs, as
  ``chip_smoke.py`` makes them with the kernel (:func:`planted_faults`):
  the stored chunk states read as zeros (dC loses its carried-state term),
  dB summed over half the heads, and the state's gradient not carried
  from chunk to chunk (dx); and one made by the kernel itself
  (:func:`cluster_fault`; ``chip_smoke.py`` builds it from the source):
  each block of a cluster sums its rows of dB and dC over its own heads
  alone, the other block's left out.

Prints one line per reading and, last, all of them as one JSON object.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

Q = 64                                   # the kernels' chunk (kQ)


SMS = 132                                # an H100's SMs


def cluster_size(B: int, H: int, sms: int = SMS) -> int:
    """The heads the wgmma walk sums on chip on a card of ``sms`` SMs."""
    from repro_torch.kernels.ssd.kernel_bwd import cluster_size
    return cluster_size(B, H, sms)


def head_sum(t, cluster: int, local: bool = False):
    """One chunk's per-head (B, H, Q, N) dB or dC summed over the heads as
    the wgmma walk sums them, in ``t``'s dtype: each pair of heads (2 k,
    then 2 k + 1), then a cluster's two pairs (rank 0's first), then the
    H / cluster partials in order. With ``local`` (a planted fault), the
    rows that each block of a cluster sums (rank r: rows 32 r ..) take its
    own heads alone."""
    H = t.shape[1]
    heads = t.unflatten(1, (H // cluster, cluster))
    rows = Q // 2
    if cluster == 1:
        sums = heads[:, :, 0]
    elif cluster == 2 and local:       # a head a block
        sums = torch.cat([heads[:, :, 0, :rows], heads[:, :, 1, rows:]], 2)
    else:
        pairs = [heads[:, :, k] + heads[:, :, k + 1]
                 for k in range(0, cluster, 2)]
        if len(pairs) == 1:
            sums = pairs[0]
        elif local:
            sums = torch.cat([pairs[0][:, :, :rows], pairs[1][:, :, rows:]],
                             2)
        else:
            sums = pairs[0] + pairs[1]
    out = sums[:, 0]
    for k in range(1, sums.shape[1]):
        out = out + sums[:, k]
    return out


def grad_err(got, want) -> float:
    """||got - want|| / ||want|| (Frobenius)."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _chunks(t, S):
    """``t`` (B, S, ...) padded with zeros to whole chunks, as
    (B, nc, Q, ...), in its own dtype."""
    pad = -S % Q
    t = torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)
    return t.unflatten(1, (-1, Q))


def chunk_states(x, dt, A, Bm, Cm, state0=None, dtype=torch.float64):
    """The state entering each chunk of 64, (B, H, nc, P, N), as
    ``ssd_cuda(..., return_states=True)`` writes it (in ``dtype``)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    xc, dtc, Bc = (_chunks(t.to(dtype), S) for t in (x, dt, Bm))
    cum = torch.cumsum(dtc * A.to(dtype), 2)               # (B, nc, Q, H)
    eout = torch.exp(cum[:, :, -1:] - cum)
    s = state0.to(dtype) if state0 is not None else \
        torch.zeros(B, H, P, N, dtype=dtype, device=x.device)
    out = []
    for c in range(xc.shape[1]):
        out.append(s)
        w = dtc[:, c] * eout[:, c]                          # (B, Q, H)
        s = s * torch.exp(cum[:, c, -1])[..., None, None] + torch.einsum(
            "bqhp,bqh,bqn->bhpn", xc[:, c], w, Bc[:, c])
    return torch.stack(out, 2)


def backward(x, dt, A, Bm, Cm, dy, states, dstate=None, *,
             kernel_rounding=False, local_sum=False, sms=SMS):
    """dx, ddt, dA, dB, dC, dstate0 by the chunk walk of
    ``csrc/ssd_bwd.cu``'s head note, in the model layout; ``states`` are
    the chunk-entry states (B, H, nc, P, N), ``dstate`` the final state's
    cotangent or None. In fp64; with ``kernel_rounding`` in fp32, with the
    operands the bf16 wgmma walk feeds its products in bf16 rounded once to
    it (x, B, C, dy are bf16 already), dB and dC summed over the heads in
    its order on a card of ``sms`` SMs (:func:`head_sum`), and dx, dB, dC
    rounded to x's dtype, ddt to dt's, as the kernel writes them.
    ``local_sum`` plants :func:`head_sum`'s fault."""
    dtype = torch.float32 if kernel_rounding else torch.float64

    def staged(t):          # an operand the kernel stages in bf16
        return t.to(torch.bfloat16).to(dtype) if kernel_rounding else t
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    xc, dtc, Bc, Cc, dyc = (_chunks(t.to(dtype), S)
                            for t in (x, dt, Bm, Cm, dy))
    a = A.to(dtype)
    cum = torch.cumsum(dtc * a, 2)                          # (B, nc, Q, H)
    i = torch.arange(Q, device=x.device)
    lower = i[:, None] >= i[None, :]                        # (i, j)
    g = dstate.to(dtype) if dstate is not None else \
        torch.zeros(B, H, P, N, dtype=dtype, device=x.device)
    dx, ddt, dB, dC = (torch.zeros_like(t) for t in (xc, dtc, Bc, Cc))
    dA = torch.zeros(H, dtype=dtype, device=x.device)
    for c in reversed(range(xc.shape[1])):
        xq, dtq, Bq, Cq, dyq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c], \
            dyc[:, c]
        cq = cum[:, c]                                      # (B, Q, H)
        s = states[:, :, c].to(dtype)                       # (B, H, P, N)
        ein, eout = torch.exp(cq), torch.exp(cq[:, -1:] - cq)
        total = torch.exp(cq[:, -1])                        # (B, H)
        seg = cq[:, :, None] - cq[:, None, :]               # (B, i, j, H)
        L = torch.where(lower[None, :, :, None], torch.exp(
            torch.where(lower[None, :, :, None], seg, 0)), 0)
        xdt = xq * dtq[..., None]
        cb = torch.einsum("bin,bjn->bij", Cq, Bq)[..., None] * L
        dd = torch.einsum("bihp,bjhp->bijh", dyq, xq) * dtq[:, None]
        K = cb * dd                                         # (B, i, j, H)
        cbl, dxl = staged(cb), staged(dd * L)
        gr, sr = staged(g), staged(s)
        dxdt = (torch.einsum("bijh,bihp->bjhp", cbl, dyq)
                + eout[..., None] * torch.einsum("bjn,bhpn->bjhp", Bq, gr))
        dC_in = ein.transpose(1, 2)[..., None] * torch.einsum(
            "bihp,bhpn->bhin", dyq, sr)
        dC_h = torch.einsum("bijh,bjn->bhin", dxl, Bq) + dC_in
        dB_in = (eout * dtq).transpose(1, 2)[..., None] * torch.einsum(
            "bjhp,bhpn->bhjn", xq, gr)
        dB_h = torch.einsum("bijh,bin->bhjn", dxl, Cq) + dB_in
        dcum = (K.sum(2) - K.sum(1) + torch.einsum("bin,bhin->bih", Cq, dC_in)
                - torch.einsum("bin,bhin->bih", Bq, dB_in))
        dcum[:, -1] += total * (g * s).sum((-1, -2)) + torch.einsum(
            "bjn,bhjn->bh", Bq, dB_in)
        da = dcum.flip(1).cumsum(1).flip(1)
        dx[:, c] = dtq[..., None] * dxdt
        ddt[:, c] = a * da + (xq * dxdt).sum(-1)
        dA += (dtq * da).sum((0, 1))
        if kernel_rounding:
            dB[:, c], dC[:, c] = (
                head_sum(t, cluster_size(B, H, sms), local_sum)
                for t in (dB_h, dC_h))
        else:
            dB[:, c], dC[:, c] = dB_h.sum(1), dC_h.sum(1)
        g = total[..., None, None] * g + torch.einsum(
            "bihp,bin->bhpn", staged(ein[..., None] * dyq), Cq)

    def unchunk(t, like):
        t = t.flatten(1, 2)[:, :S]
        return t.to(like.dtype) if kernel_rounding else t
    return (unchunk(dx, x), unchunk(ddt, dt), dA, unchunk(dB, Bm),
            unchunk(dC, Cm), g)


def planted_faults(run, x, dt, A, Bm, Cm, dy, states) -> dict:
    """name -> (index in (dx, ddt, dA, dB, dC), the faulty gradient), each
    from ``run(x, dt, A, Bm, Cm, dy, states)`` (the kernel on the card, or
    :func:`backward` here) on altered inputs: the stored chunk states read
    as zeros; half the heads only; each chunk alone, so that no state
    gradient crosses from one chunk to the one before."""
    H, S = x.shape[2], x.shape[1]
    h = H // 2
    half = run(x[:, :, :h], dt[..., :h], A[:h], Bm, Cm, dy[:, :, :h],
               states[:, :h].contiguous())
    alone = [run(x[:, c * Q:(c + 1) * Q], dt[:, c * Q:(c + 1) * Q], A, Bm[
        :, c * Q:(c + 1) * Q], Cm[:, c * Q:(c + 1) * Q], dy[
        :, c * Q:(c + 1) * Q], states[:, :, c:c + 1].contiguous())[0]
        for c in range(-(-S // Q))]
    return {"dC without the carried-state term (chunk states read as 0)":
                (4, run(x, dt, A, Bm, Cm, dy, torch.zeros_like(states))[4]),
            "dB summed over half the heads": (3, half[3]),
            "the state gradient not carried across chunks (dx)":
                (0, torch.cat(alone, 1))}


def cluster_fault(run_faulty, x, dt, A, Bm, Cm, dy, states) -> dict:
    """name -> (index in (dx, ddt, dA, dB, dC), the faulty gradient) of the
    fault the kernel itself plants: ``run_faulty`` is the kernel built with
    each block's rows of dB and dC summed over its own heads alone (on the
    card), or :func:`backward` with ``local_sum`` (here)."""
    return {"dB with each block's rows left to its own heads":
                (3, run_faulty(x, dt, A, Bm, Cm, dy, states)[3])}


def inputs(B=2, S=512, H=32, P=64, N=128, seed=0, dtype=torch.bfloat16):
    """x, dt, A, B, C, dy as the card's checks draw them (CPU, seeded)."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen)
    x = randn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H))
    A = -torch.exp(randn(H))
    Bm, Cm, dy = randn(B, S, N).to(dtype), randn(B, S, N).to(dtype), \
        randn(B, S, H, P).to(dtype)
    return x, dt, A, Bm, Cm, dy


def kernel_readings(B=2, S=512, H=32, P=64, N=128, chunk=256,
                    seed=0) -> dict:
    from repro_torch.kernels.ssd import ssd_bwd_plain
    x, dt, A, Bm, Cm, dy = inputs(B, S, H, P, N, seed)
    want = ssd_bwd_plain(x, dt, A, Bm, Cm, dy, chunk=chunk)
    states = chunk_states(x, dt, A, Bm, Cm, dtype=torch.float32)

    def run(*args):
        return backward(*args, kernel_rounding=True)
    got = run(x, dt, A, Bm, Cm, dy, states)
    names = ("dx", "ddt", "dA", "dB", "dC")
    out = {f"rounding {n}": grad_err(g, w)
           for n, g, w in zip(names, got, want)}
    faults = planted_faults(run, x, dt, A, Bm, Cm, dy, states)
    faults.update(cluster_fault(
        lambda *args: backward(*args, kernel_rounding=True, local_sum=True),
        x, dt, A, Bm, Cm, dy, states))
    for name, (k, bad) in faults.items():
        out[name] = grad_err(bad, want[k])
    return out


def main() -> int:
    readings = {"kernel": kernel_readings()}
    for part, values in readings.items():
        for name, value in values.items():
            print(f"[{part}] {name}: {value}")
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
