from .modality_info import MODALITY_INFO, ModalitySpec

__all__ = ["MODALITY_INFO", "ModalitySpec"]
