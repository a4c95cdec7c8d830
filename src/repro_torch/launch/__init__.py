"""Drivers of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device, caller: str) -> torch.device:
    """The device a driver runs on: the card unless the caller asks for the
    CPU; without CUDA, asking for the card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: CUDA is not available; pass "
                           "device='cpu' to run the plain path on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{caller} runs on cuda or cpu, not {device}")
    return device
