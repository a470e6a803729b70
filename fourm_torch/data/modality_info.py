"""Modality registry for the PyTorch port.

The port's own copy of fourm_tpu/data/modality_info.py: same names, ids,
vocab sizes and token budgets, kept identical so both packages agree.

Mirrors the reference registry (fourm/data/modality_info.py:32-383) with the same
modality names, ids (uint15 hashes), vocab sizes, token budgets and types — but as
declarative `ModalitySpec` records instead of torch-module partials: in JAX, the
FourM builder consumes these static specs to construct embedding modules once.

Modality types:
  img        - dense 2D modality, tokens on a (H/ps, W/ps) grid
  seq        - discrete token sequence (WordPiece vocab), span-maskable
  seq_emb    - pre-computed continuous embedding sequence (e.g. T5-XXL)
  seq_token  - discrete token sequence that is never span-masked
  feature_map- dense feature map (tokenizer training only, no FourM embedding)
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

# --- constants shared with the reference data pipeline (utils/data_constants.py) ---
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)
IMAGENET_SURFACE_NORMAL_MEAN = (0.501, 0.405, 0.137)
IMAGENET_SURFACE_NORMAL_STD = (0.114, 0.165, 0.081)
COCO_SEMSEG_NUM_CLASSES = 133 + 1  # one extra no-class
PAD_ID = 0
SEG_IGNORE_INDEX = 255


def generate_uint15_hash(seed_str: str) -> int:
    """Deterministic uint15 modality id (reference utils/misc.py:39-41)."""
    return int(hashlib.sha256(seed_str.encode("utf-8")).hexdigest(), 16) % (2**15)


@dataclass(frozen=True)
class ModalitySpec:
    """Static description of one modality."""

    name: str
    type: str  # img | seq | seq_emb | seq_token | feature_map
    id: int
    vocab_size: Optional[int] = None
    min_tokens: int = 0
    max_tokens: Optional[int] = None
    input_size: Optional[int] = None
    patch_size: Optional[int] = None
    num_channels: Optional[int] = None
    num_labels: Optional[int] = None
    pretokenized: bool = False
    shared_vocab: Tuple[str, ...] = ()
    path: Optional[str] = None
    # Embedding construction hints consumed by the FourM builder:
    encoder_embedding: Optional[str] = None  # image | image_token | sequence | sequence_emb
    decoder_embedding: Optional[str] = None  # image_token | sequence
    sincos_pos_emb: bool = True
    max_length: Optional[int] = None  # for sequence embeddings
    orig_emb_dim: int = 4096  # for sequence_emb (T5-XXL)

    @property
    def grid_size(self) -> Optional[Tuple[int, int]]:
        if self.type == "img" and self.input_size and self.patch_size:
            n = self.input_size // self.patch_size
            return (n, n)
        return None

    def resolved_max_tokens(self) -> int:
        """max_tokens, defaulting to the full token grid for img modalities
        (reference run_training_4m.py:247-253 sets None -> grid size)."""
        if self.max_tokens is not None:
            return self.max_tokens
        g = self.grid_size
        if g is None:
            raise ValueError(f"modality {self.name} has no resolvable max_tokens")
        return g[0] * g[1]


def _img_tok(name: str, vocab: int, input_size: int = 224, patch_size: int = 16) -> ModalitySpec:
    return ModalitySpec(
        name=name, type="img", id=generate_uint15_hash(name), vocab_size=vocab,
        input_size=input_size, patch_size=patch_size, pretokenized=True,
        encoder_embedding="image_token", decoder_embedding="image_token",
    )


def _seq(name: str, max_length: int, vocab: int = 30_000, shared_vocab: Tuple[str, ...] = (),
         max_tokens: Optional[int] = None, pretokenized: bool = False) -> ModalitySpec:
    return ModalitySpec(
        name=name, type="seq", id=generate_uint15_hash(name), vocab_size=vocab,
        max_tokens=max_tokens if max_tokens is not None else max_length,
        max_length=max_length, shared_vocab=shared_vocab, pretokenized=pretokenized,
        encoder_embedding="sequence", decoder_embedding="sequence",
    )


MODALITY_INFO: Dict[str, ModalitySpec] = {
    # ---- 4M-7 modalities (reference modality_info.py:34-150) ----
    "rgb@224": ModalitySpec(
        name="rgb@224", type="img", id=generate_uint15_hash("rgb@224"),
        input_size=224, patch_size=16, num_channels=3, path="rgb",
        encoder_embedding="image", decoder_embedding=None,
    ),
    "rgb": ModalitySpec(  # tokenizer training
        name="rgb", type="img", id=generate_uint15_hash("rgb"), num_channels=3, path="rgb",
    ),
    "caption": _seq("caption", 256),
    "det": _seq("det", 256),
    "tok_rgb@224": _img_tok("tok_rgb@224", 16384),
    "tok_depth@224": _img_tok("tok_depth@224", 8192),
    "depth": ModalitySpec(name="depth", type="img", id=generate_uint15_hash("depth"), num_channels=1),
    "tok_normal@224": _img_tok("tok_normal@224", 8192),
    "normal": ModalitySpec(name="normal", type="img", id=generate_uint15_hash("normal"), num_channels=3),
    "tok_semseg@224": _img_tok("tok_semseg@224", 4096),
    "semseg_coco": ModalitySpec(
        name="semseg_coco", type="img", id=generate_uint15_hash("semseg_coco"),
        num_channels=64, num_labels=COCO_SEMSEG_NUM_CLASSES,
    ),
    "tok_clip@224": _img_tok("tok_clip@224", 8192),
    "CLIP-B16": ModalitySpec(
        name="CLIP-B16", type="feature_map", id=generate_uint15_hash("CLIP-B16"), num_channels=512,
    ),
    # ---- 4M-21 modalities (reference modality_info.py:152-305) ----
    "t5_caption": ModalitySpec(
        name="t5_caption", type="seq_emb", id=generate_uint15_hash("t5_caption"),
        max_tokens=77, max_length=77, encoder_embedding="sequence_emb", decoder_embedding=None,
    ),
    "metadata": _seq("metadata", 40, shared_vocab=("caption",)),
    "human_poses": _seq("human_poses", 263, shared_vocab=("caption",), max_tokens=275),
    "color_palette": _seq("color_palette", 23, shared_vocab=("caption",)),
    "sam_mask": ModalitySpec(
        name="sam_mask", type="img", id=generate_uint15_hash("sam_mask"),
        num_channels=1, max_tokens=64,
    ),
    "sam_instance": _seq("sam_instance", 290, shared_vocab=("caption",), pretokenized=True),
    "tok_canny_edge@224": _img_tok("tok_canny_edge@224", 8192),
    "canny_edge": ModalitySpec(name="canny_edge", type="img", id=generate_uint15_hash("canny_edge"), num_channels=1),
    "tok_sam_edge@224": _img_tok("tok_sam_edge@224", 8192),
    "tok_dinov2@224": _img_tok("tok_dinov2@224", 8192, patch_size=14),
    "DINOv2-B14": ModalitySpec(
        name="DINOv2-B14", type="feature_map", id=generate_uint15_hash("DINOv2-B14"), num_channels=768,
    ),
    "tok_imagebind@224": _img_tok("tok_imagebind@224", 8192, patch_size=14),
    "ImageBind-H14": ModalitySpec(
        name="ImageBind-H14", type="feature_map", id=generate_uint15_hash("ImageBind-H14"), num_channels=1280,
    ),
    "tok_dinov2_global": ModalitySpec(
        name="tok_dinov2_global", type="img", id=generate_uint15_hash("tok_dinov2_global"),
        vocab_size=8192, patch_size=56, max_tokens=16, pretokenized=True,
        encoder_embedding="image_token", decoder_embedding="image_token", sincos_pos_emb=False,
    ),
    "DINOv2-B14-global": ModalitySpec(
        name="DINOv2-B14-global", type="feature_map",
        id=generate_uint15_hash("DINOv2-B14-global"), num_channels=768,
    ),
    "tok_imagebind_global": ModalitySpec(
        name="tok_imagebind_global", type="img", id=generate_uint15_hash("tok_imagebind_global"),
        vocab_size=8192, patch_size=56, max_tokens=16, pretokenized=True,
        encoder_embedding="image_token", decoder_embedding="image_token", sincos_pos_emb=False,
    ),
    "ImageBind-H14-global": ModalitySpec(
        name="ImageBind-H14-global", type="feature_map",
        id=generate_uint15_hash("ImageBind-H14-global"), num_channels=1280,
    ),
    # ---- 224 -> 448 super-resolution modalities (reference modality_info.py:307-383) ----
    "rgb@448": ModalitySpec(
        name="rgb@448", type="img", id=generate_uint15_hash("rgb@448"),
        input_size=448, patch_size=16, num_channels=3, path="rgb",
        encoder_embedding="image", decoder_embedding=None,
    ),
    "tok_rgb@448": _img_tok("tok_rgb@448", 16384, input_size=448),
    "tok_depth@448": _img_tok("tok_depth@448", 8192, input_size=448),
    "tok_normal@448": _img_tok("tok_normal@448", 8192, input_size=448),
    "tok_semseg@448": _img_tok("tok_semseg@448", 4096, input_size=448),
    "tok_clip@448": _img_tok("tok_clip@448", 8192, input_size=448),
}


def get_modality(name: str) -> ModalitySpec:
    return MODALITY_INFO[name]


def with_image_size(spec: ModalitySpec, image_size: int) -> ModalitySpec:
    """Return a copy of an img spec resized to `image_size` (for SR / multi-res)."""
    return replace(spec, input_size=image_size, max_tokens=None)
