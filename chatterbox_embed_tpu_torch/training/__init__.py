"""Training steps of the port's two trainable model families (T3 and the
flow-matching estimator), on one device or on a dp x tp mesh
(parallel/mesh.py); pipeline-parallel T3 training is parallel/pipeline.py."""
from .train_step import (TrainState, init_flow_train_state, init_t3_train_state,
                         make_flow_train_step, make_t3_train_step, shard_flow_state,
                         shard_t3_state)

__all__ = ["TrainState", "init_flow_train_state", "init_t3_train_state",
           "make_flow_train_step", "make_t3_train_step", "shard_flow_state",
           "shard_t3_state"]
