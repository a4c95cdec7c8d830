"""Runtime of the port: the single-device train step (``repro/runtime``)
and the DFlow-orchestrated training DAG (``orchestrator.run_training``,
imported from its module as in the reference); meshes are ROADMAP A.12."""

from .train_lib import TrainState, build_train_step, init_train_state

__all__ = ["TrainState", "build_train_step", "init_train_state"]
