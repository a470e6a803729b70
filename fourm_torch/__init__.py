"""fourm_torch: the PyTorch / CUDA port of fourm_tpu for NVIDIA Hopper.

The JAX package fourm_tpu stays the reference; this package mirrors its
module paths, class and method names. Its hot path runs hand-written CUDA
kernels (fourm_torch/kernels/csrc), built with nvcc on first use; on CPU
tensors every kernel wrapper computes its plain PyTorch twin instead.
"""

__version__ = "0.1.0"

# The top-level API; importing it loads torch and none of JAX, `tokenizers`,
# safetensors or PIL
from .models import FourM, FourMConfig, create_fourm_config  # noqa: E402,F401


def load_sampler(fm_path: str, tokenizers=None, text_tokenizer_path=None, device=None,
                 config_override=None, **kw):
    """One-call setup (fourm_tpu/__init__.py:26-37): a released 4M
    safetensors file (local) -> a ready FourMSampler on `device` (the card
    unless "cpu" is asked). config_override updates the file's config; its
    "dtype" ("bfloat16", which the kernels compute in) sets the compute
    dtype, float32 without it. text_tokenizer_path: a WordPiece
    tokenizer.json; other keywords go to FourMSampler."""
    from .api import FourMSampler, resolve_device
    from .utils.checkpoint import load_fourm_safetensors
    from .utils.text_tokenizer import load_tokenizer

    dev = resolve_device(device)
    _, model = load_fourm_safetensors(fm_path, config_override, device=dev)
    text_tokenizer = load_tokenizer(text_tokenizer_path) if text_tokenizer_path else None
    return FourMSampler(model, text_tokenizer=text_tokenizer, tokenizers=tokenizers,
                        device=dev, **kw)
