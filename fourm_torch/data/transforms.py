"""What token decoding reads of the modality transforms, PyTorch port.

The port's own copies of fourm_tpu/data/transforms.py's name helpers
(:38-47, reference modality_transforms.py:39-40) and of the metadata maps
of its MetadataTransform (:531-611, reference :843-1007), which
utils/decoding.py:decode_metadata needs to turn generated 'v1=<type>
v0=<bin>' chunks back into values. The data pipeline itself is not ported
yet.
"""

from __future__ import annotations


def get_transform_key(mod_name: str) -> str:
    """Strip the @resolution suffix."""
    return mod_name.split("@")[0]


def get_transform_resolution(mod_name: str, default_resolution, to_tuple: bool = True):
    res = int(mod_name.split("@")[1]) if "@" in mod_name else default_resolution
    return (res, res) if to_tuple and not isinstance(res, tuple) else res


# metadata type -> its 'v1=' id
METADATA_ID_MAP = {
    "original_width": "v1=0", "original_height": "v1=1", "caption_n_chars": "v1=2",
    "caption_n_words": "v1=3", "caption_n_sentences": "v1=4", "n_humans": "v1=5",
    "n_sam_instances": "v1=6", "n_coco_instances": "v1=7",
    "coco_instance_diversity": "v1=8", "colorfulness": "v1=9", "brightness": "v1=10",
    "contrast": "v1=11", "saturation": "v1=12", "entropy": "v1=13",
    "walkability": "v1=14", "objectness": "v1=15", "semantic_diversity": "v1=16",
    "geometric_complexity": "v1=17", "occlusion_score": "v1=18",
    "watermark_score": "v1=19", "aesthetic_score": "v1=20",
}
ID_METADATA_MAP = {v: k for k, v in METADATA_ID_MAP.items()}
# image sizes are binned by IMAGE_DIM_BIN_SIZE pixels
IMAGE_DIM_MODALITIES = ["original_height", "original_width"]
IMAGE_DIM_BIN_SIZE = 32
# continuous types: (min, max, bins)
MIN_MAX_BINS = {
    "colorfulness": (0, 150, 50), "brightness": (0, 255, 50), "contrast": (0, 127, 50),
    "saturation": (0, 255, 50), "entropy": (0, 10, 50), "walkability": (0, 1, 50),
    "objectness": (0, 1, 50), "geometric_complexity": (0, 0.75, 50),
    "occlusion_score": (0, 0.25, 50),
}
