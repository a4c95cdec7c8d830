"""Public SSD entry point (model-layout adapter).

Counterpart of ``repro/kernels/ssd/ops.py::ssd``, returning the final state
beside y as the model's scan does. A CUDA tensor goes to the CUDA kernel (or
raises); a CPU tensor goes to the plain version. ``chunk`` keeps the
reference's signature and its ``ValueError`` on a length it does not
divide; the plain version scans in chunks of that length, the CUDA kernel in
its own (the result differs only by fp32 rounding).

Under grad, with an input that requires it, a CUDA call goes through an
autograd Function: its forward is the CUDA kernel, which then also writes
the state entering each chunk, and its backward is the CUDA backward kernel
(``csrc/ssd_bwd.cu``; the reference's Pallas kernel has none, JAX
differentiates the scan under XLA). Serving, outside grad, calls the bare
kernel. The CPU path is the plain scan, which autograd differentiates op by
op.
"""

from __future__ import annotations

import torch

from .kernel import ssd_cuda
from .kernel_bwd import ssd_bwd_cuda
from .ref import ssd_chunked

__all__ = ["ssd", "ssd_plain"]


# the plain version, on any device, is the model's own chunked scan
ssd_plain = ssd_chunked


class _SSD(torch.autograd.Function):
    """The CUDA forward, and the CUDA backward as its gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, state0):
        # the state entering each chunk, fp32, saved for the backward (under
        # remat the recomputed forward writes it again)
        y, final, states = ssd_cuda(x, dt, A, Bm, Cm, state0=state0,
                                    return_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        ctx.with_state0 = state0 is not None
        # the gradient of an output the loss does not read arrives as None
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        elif dy.stride(-1) != 1:
            # autograd may hand over a strided or offset view
            dy = dy.clone(memory_format=torch.contiguous_format)
        if dstate is not None:
            dstate = dstate.contiguous()
        dx, ddt, dA, dB, dC, dstate0 = ssd_bwd_cuda(
            x, dt, A, Bm, Cm, dy, states, dstate=dstate,
            want_dstate0=ctx.with_state0 and ctx.needs_input_grad[5])
        return dx, ddt, dA, dB, dC, dstate0


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int = 128,
        state0: torch.Tensor | None = None,
        state_out: torch.Tensor | None = None):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, N);
    state0: (B, H, P, N) fp32 or None -> (y (B, S, H, P), final state).

    With ``state_out`` the final state is written there (it may be
    ``state0``: the model updates its cache in place) and returned; under
    grad ``state_out`` raises ``ValueError``."""
    S = x.shape[1]
    if S % min(chunk, S):
        raise ValueError(f"S {S} % chunk {chunk}")
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, state0))
    if grad and state_out is not None:
        raise ValueError("ssd under grad takes no state_out: the final state "
                         "written in place over state0 would overwrite a "
                         "tensor that the backward reads")
    if x.is_cuda:
        if grad:
            return _SSD.apply(x, dt, A, Bm, Cm, state0)
        return ssd_cuda(x, dt, A, Bm, Cm, state0=state0, state_out=state_out)
    if x.device.type != "cpu":
        raise ValueError(f"no ssd for device {x.device}")
    y, state = ssd_chunked(x, dt, A, Bm, Cm, chunk, state0)
    if state_out is not None:
        state = state_out.copy_(state)
    return y, state
