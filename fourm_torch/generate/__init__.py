from .init_helpers import (custom_text, expand_to_batch, init_empty_target_modality,
                           init_full_input_modality)
from .sampler import GenerationSampler
from .schedules import build_chained_generation_schedules

__all__ = ["GenerationSampler", "build_chained_generation_schedules", "custom_text",
           "expand_to_batch", "init_empty_target_modality", "init_full_input_modality"]
