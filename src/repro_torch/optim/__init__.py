"""Optimizer of the port: AdamW with global-norm clipping and a
warmup-cosine schedule (``repro/optim``; gradient compression waits for
ROADMAP A.12)."""

from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm, warmup_cosine)

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "warmup_cosine"]
