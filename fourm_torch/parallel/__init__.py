"""Training on one card or over several (fourm_tpu/parallel): TrainState,
init_train_state, build_train_step and frozen_trunk_mask; the mesh and its
sharding rules (mesh.py); the process-group start (launch.py); the rank's
shards, its units and the step's collectives (shard.py), and meta_params
for a model born sharded."""

from .mesh import make_mesh
from .shard import meta_params
from .train import TrainState, build_train_step, frozen_trunk_mask, init_train_state

__all__ = ["TrainState", "build_train_step", "frozen_trunk_mask", "init_train_state",
           "make_mesh", "meta_params"]
