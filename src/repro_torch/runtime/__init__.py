"""Runtime of the port: the single-device train step (``repro/runtime``;
the DFlow orchestrator is ROADMAP A.13, meshes A.12)."""

from .train_lib import TrainState, build_train_step, init_train_state

__all__ = ["TrainState", "build_train_step", "init_train_state"]
