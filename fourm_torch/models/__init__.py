from .fourm import (MODEL_REGISTRY, MODEL_SIZES, FourM, FourMConfig, create_fourm_config,
                    init_weights)

__all__ = ["FourM", "FourMConfig", "MODEL_REGISTRY", "MODEL_SIZES",
           "create_fourm_config", "init_weights"]
