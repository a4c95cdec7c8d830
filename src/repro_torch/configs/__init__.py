"""Architecture registry of the port: ``--arch <id>`` resolution.

It holds only the archs the port runs. Every other arch of the JAX
package's registry raises ``KeyError`` naming the ROADMAP item that
brings it over.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "list_archs"]

# arch id (CLI form) -> module name
ARCHS = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "mamba2-370m": "mamba2_370m",
    "starcoder2-15b": "starcoder2_15b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-14b": "qwen3_14b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-vl-72b": "qwen2_vl_72b",
}

# archs of the JAX package not ported yet -> the ROADMAP item that brings them
PENDING = {
    "jamba-1.5-large-398b": "A.10 (hybrid)",
}


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch in PENDING:
        raise KeyError(f"arch {arch!r} is not ported yet: ROADMAP item "
                       f"{PENDING[arch]}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg = mod.config()
    return cfg.reduced() if reduced else cfg


def list_archs() -> list[str]:
    return list(ARCHS)
