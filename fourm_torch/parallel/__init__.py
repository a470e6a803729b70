"""The single-card training step (fourm_tpu/parallel's TrainState,
init_train_state, build_train_step and frozen_trunk_mask; the mesh, FSDP
and tensor parallelism are not ported yet)."""

from .train import TrainState, build_train_step, frozen_trunk_mask, init_train_state

__all__ = ["TrainState", "build_train_step", "frozen_trunk_mask", "init_train_state"]
