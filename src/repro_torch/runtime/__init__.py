"""Runtime of the port: the train step on one device or one rank of a
(data, model) mesh and its spec functions (``repro/runtime``),
the serving steps over a (data, model) mesh (``serve_lib``) and the
DFlow-orchestrated training DAG (``orchestrator.run_training``, imported
from its module as in the reference)."""

from .serve_lib import build_decode_step, build_prefill_step, cache_specs
from .train_lib import (TrainState, abstract_train_state, batch_sharding,
                        build_train_step, init_train_state,
                        make_train_state_specs)

__all__ = ["TrainState", "build_train_step", "init_train_state",
           "abstract_train_state", "batch_sharding", "make_train_state_specs",
           "build_decode_step", "build_prefill_step", "cache_specs"]
