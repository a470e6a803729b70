"""The data pipeline of 4M pre-training, PyTorch port (fourm_tpu/data/):
modality registry, transforms, augmenters, masking, datasets, loaders.
The modules import numpy only (no torch), so that loader workers start
light."""

from .modality_info import MODALITY_INFO, ModalitySpec

__all__ = ["MODALITY_INFO", "ModalitySpec"]
