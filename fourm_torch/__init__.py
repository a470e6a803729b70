"""fourm_torch: the PyTorch / CUDA port of fourm_tpu for NVIDIA Hopper.

The JAX package fourm_tpu stays the reference; this package mirrors its
module paths, class and method names. Its hot path runs hand-written CUDA
kernels (fourm_torch/kernels/csrc), built with nvcc on first use; on CPU
tensors every kernel wrapper computes its plain PyTorch twin instead.
"""

__version__ = "0.1.0"
