"""Runtime of the port: the single-device train step (``repro/runtime``),
the serving steps over a (data, model) mesh (``serve_lib``) and the
DFlow-orchestrated training DAG (``orchestrator.run_training``, imported
from its module as in the reference)."""

from .serve_lib import build_decode_step, build_prefill_step, cache_specs
from .train_lib import TrainState, build_train_step, init_train_state

__all__ = ["TrainState", "build_train_step", "init_train_state",
           "build_decode_step", "build_prefill_step", "cache_specs"]
