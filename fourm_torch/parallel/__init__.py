"""The single-card training step (fourm_tpu/parallel's TrainState,
init_train_state and build_train_step; the mesh, FSDP and tensor
parallelism are not ported yet)."""

from .train import TrainState, build_train_step, init_train_state

__all__ = ["TrainState", "build_train_step", "init_train_state"]
