"""Hand-written CUDA kernels (csrc/) for the port's hot path, with their
wrappers, plain PyTorch twins and launch counters: `fused_mlp.ln_matmul`,
`fused_mlp.ln_mlp`, `attention.flash_mha`, `attention.attention`, the
decode step's `decode_step.self_decode`, `decode_step.cross_decode_attn`,
`decode_step.decode_attention`, `decode_step.decode_attention_int8` (the
int8 cross K/V mode), `decode_step.residual_mlp`, and VQ
tokenization's `attention.attn_block`, `attention.mha_short`,
`vq_codebook.nearest_code`, `vq_codebook.nearest_code_cosine`, and the
train step's `attention_train.attention_train_fwd`,
`attention_train.attention_train_bwd` (the forward and backward of the
`attention_train` Function) and `fused_adamw.fused_adamw`.
Importing this package needs no CUDA toolkit: the kernels build on first
launch (see _build)."""

from . import attention as _attention
from . import attention_train as _attention_train
from . import decode_step as _decode_step
from . import fused_adamw as _fused_adamw
from . import fused_mlp as _fused_mlp
from . import vq_codebook as _vq_codebook

WRAPPERS = {"ln_matmul": _fused_mlp.ln_matmul, "ln_mlp": _fused_mlp.ln_mlp,
            "flash_mha": _attention.flash_mha, "attention": _attention.attention,
            "self_decode": _decode_step.self_decode,
            "cross_decode_attn": _decode_step.cross_decode_attn,
            "decode_attention": _decode_step.decode_attention,
            "decode_attention_int8": _decode_step.decode_attention_int8,
            "residual_mlp": _decode_step.residual_mlp,
            "attn_block": _attention.attn_block, "mha_short": _attention.mha_short,
            "nearest_code": _vq_codebook.nearest_code,
            "nearest_code_cosine": _vq_codebook.nearest_code_cosine,
            "attention_train_fwd": _attention_train.attention_train_fwd,
            "attention_train_bwd": _attention_train.attention_train_bwd,
            "fused_adamw": _fused_adamw.fused_adamw}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
