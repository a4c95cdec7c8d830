"""Public SSD entry point (model-layout adapter).

Counterpart of ``repro/kernels/ssd/ops.py::ssd``, returning the final state
beside y as the model's scan does. A CUDA tensor goes to the CUDA kernel (or
raises); a CPU tensor goes to the plain version. ``chunk`` keeps the
reference's signature and its ``ValueError`` on a length it does not
divide; the plain version scans in chunks of that length, the CUDA kernel in
its own (the result differs only by fp32 rounding).

The CUDA kernel has no backward (nor has the reference's Pallas kernel):
under grad, with an input that requires it, a CUDA call raises instead of
returning a result detached from its inputs. The CPU path stays
differentiable.
"""

from __future__ import annotations

import torch

from .kernel import ssd_cuda
from .ref import ssd_chunked

__all__ = ["ssd", "ssd_plain"]


# the plain version, on any device, is the model's own chunked scan
ssd_plain = ssd_chunked


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int = 128,
        state0: torch.Tensor | None = None,
        state_out: torch.Tensor | None = None):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, N);
    state0: (B, H, P, N) fp32 or None -> (y (B, S, H, P), final state).

    With ``state_out`` the final state is written there (it may be
    ``state0``: the model updates its cache in place) and returned."""
    S = x.shape[1]
    if S % min(chunk, S):
        raise ValueError(f"S {S} % chunk {chunk}")
    if x.is_cuda:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, dt, A, Bm, Cm, state0)):
            raise NotImplementedError(
                "ssd has no CUDA backward kernel yet: training mamba2 on the "
                "card is ROADMAP item A.14")
        return ssd_cuda(x, dt, A, Bm, Cm, state0=state0, state_out=state_out)
    if x.device.type != "cpu":
        raise ValueError(f"no ssd for device {x.device}")
    y, state = ssd_chunked(x, dt, A, Bm, Cm, chunk, state0)
    if state_out is not None:
        state = state_out.copy_(state)
    return y, state
