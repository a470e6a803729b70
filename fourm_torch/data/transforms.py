"""Per-modality load / preprocess / augment / postprocess transforms of 4M
pre-training, PyTorch port.

The port's own copy of the pre-training part of fourm_tpu/data/
transforms.py (reference fourm/data/modality_transforms.py): one sampled
crop / flip applied to every modality of a sample by UnifiedDataTransform
(:104); the RGB image, pre-computed tokens, captions and caption
embeddings; detection, metadata, poses, palettes and SAM instances as
coordinate-token strings for the shared WordPiece tokenizer. Outputs are
numpy, channel-last (H, W, C), as the JAX package's.

What differs, and why:
  * Images are numpy uint8 arrays, not PIL images: data/image_io.py
    decodes PNG and JPEG and crops, resizes (Pillow's BICUBIC, byte for
    byte) and flips without Pillow, which the machine with the card lacks;
    `color_jitter`'s ImageEnhance / ImageOps steps are data/image_enhance.py,
    byte for byte.
  * Randomness comes from explicit generators, not the global `random`
    and `np.random` that the JAX transforms draw from: each transform
    takes `rng` (random.Random) and `np_rng` (np.random.RandomState),
    given one pair per dataset (data/pretrain_utils.py), and draws from
    them in the JAX order. Seeding the JAX globals with the same seed gives
    the same stream.
  * SAMInstanceTokTransform and SAMInstanceTransform test points against
    instance polygons with `point_in_polygon`, the port's copy of what
    cv2.pointPolygonTest(contour, point, measureDist=True) >= 0 decides,
    and SAMInstanceTransform rasterises them with `fill_contour`, the
    port's copy of cv2.drawContours(..., thickness=cv2.FILLED) (no cv2 on
    the card's machine).
  * The DiVAE-training transforms (`divae_modality_transforms`: depth,
    normals, COCO semseg, validity masks, canny edges, SMPL poses, raw SAM
    instances) read 16-bit depth maps (Pillow's I;16) and palette semseg
    maps as Pillow opens them (image_io.decode_image_mode) and resample
    them as Pillow does: BICUBIC on I;16, NEAREST on class maps and masks.

The name helpers and the metadata maps are also what token decoding reads
(utils/decoding.py:decode_metadata).
"""

from __future__ import annotations

import gzip
import json
import random
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from . import image_enhance, image_io
from .modality_info import (IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, IMAGENET_INCEPTION_MEAN,
                            IMAGENET_INCEPTION_STD, IMAGENET_SURFACE_NORMAL_MEAN,
                            IMAGENET_SURFACE_NORMAL_STD)


# ------------------------------------------------------------- name helpers

def get_transform_key(mod_name: str) -> str:
    """Strip the @resolution suffix."""
    return mod_name.split("@")[0]


def get_transform_resolution(mod_name: str, default_resolution, to_tuple: bool = True):
    res = int(mod_name.split("@")[1]) if "@" in mod_name else default_resolution
    return (res, res) if to_tuple and not isinstance(res, tuple) else res


def get_transform(mod_name: str, transforms_dict: Dict):
    transform = transforms_dict.get(get_transform_key(mod_name))
    return _IDENTITY if transform is None else transform


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
INT_MODALITIES = [
    "caption_n_chars", "caption_n_words", "caption_n_sentences", "n_humans",
    "n_sam_instances", "n_coco_instances", "coco_instance_diversity", "semantic_diversity",
]
MANUAL_BINS = {"watermark_score": [0.5], "aesthetic_score": [4.5, 5.5]}
# continuous types: (min, max, bins)
MIN_MAX_BINS = {
    "colorfulness": (0, 150, 50), "brightness": (0, 255, 50), "contrast": (0, 127, 50),
    "saturation": (0, 255, 50), "entropy": (0, 10, 50), "walkability": (0, 1, 50),
    "objectness": (0, 1, 50), "geometric_complexity": (0, 0.75, 50),
    "occlusion_score": (0, 0.25, 50),
}


# ------------------------------------------------------------------ bbox ops

class bbox_ops:
    """Normalized-bbox math equivalent to albumentations' helpers
    (transforms.py:62-99)."""

    @staticmethod
    def crop(bbox, x_min, y_min, x_max, y_max, rows, cols):
        """Crop a normalized (x0, y0, x1, y1) bbox; crop window in pixels."""
        crop_w, crop_h = x_max - x_min, y_max - y_min
        x0, y0, x1, y1 = bbox[:4]
        return (
            (x0 * cols - x_min) / crop_w,
            (y0 * rows - y_min) / crop_h,
            (x1 * cols - x_min) / crop_w,
            (y1 * rows - y_min) / crop_h,
        )

    @staticmethod
    def hflip(bbox):
        x0, y0, x1, y1 = bbox[:4]
        return (1.0 - x1, y0, 1.0 - x0, y1)

    @staticmethod
    def filter(bboxes, rows, cols, min_visibility=0.0, min_area=0.0):
        """Clip to [0,1], drop degenerate / mostly-out-of-frame boxes
        (albumentations filter_bboxes semantics)."""
        out = []
        for bbox in bboxes:
            coords = np.asarray(bbox[:4], dtype=np.float64)
            if (coords[2] <= 0 or coords[3] <= 0 or coords[0] >= 1 or coords[1] >= 1):
                continue
            clipped = np.clip(coords, 0.0, 1.0)
            area = (coords[2] - coords[0]) * (coords[3] - coords[1]) * rows * cols
            clip_area = (clipped[2] - clipped[0]) * (clipped[3] - clipped[1]) * rows * cols
            if clip_area <= min_area or area <= 0:
                continue
            if clip_area / max(area, 1e-12) < min_visibility:
                continue
            out.append(tuple(clipped.tolist()) + tuple(bbox[4:]))
        return out


# ---------------------------------------------------------- unified transform

class UnifiedDataTransform:
    """Apply ONE sampled crop/flip consistently to every modality
    (transforms.py:104-134; reference modality_transforms.py:67-135)."""

    def __init__(self, transforms_dict: Dict, image_augmenter, resample_mode: Optional[str] = None,
                 add_sizes: bool = False):
        self.transforms_dict = transforms_dict
        self.image_augmenter = image_augmenter
        self.resample_mode = resample_mode
        self.add_sizes = add_sizes

    def __call__(self, mod_dict: Dict) -> Dict:
        crop_settings = mod_dict.pop("crop_settings", None)
        mod_dict = {k: get_transform(k, self.transforms_dict).preprocess(v)
                    for k, v in mod_dict.items()}
        crop_coords, flip, orig_size, target_size, rand_aug_idx = self.image_augmenter(
            mod_dict, crop_settings
        )
        out = {
            k: get_transform(k, self.transforms_dict).image_augment(
                v, crop_coords=crop_coords, flip=flip, orig_size=orig_size,
                target_size=get_transform_resolution(k, target_size),
                rand_aug_idx=rand_aug_idx, resample_mode=self.resample_mode,
            )
            for k, v in mod_dict.items()
        }
        out = {k: get_transform(k, self.transforms_dict).postprocess(v) for k, v in out.items()}
        if self.add_sizes:
            out["crop_coords"] = np.asarray(crop_coords)
            out["orig_size"] = np.asarray(orig_size)
        return out


class AbstractTransform(ABC):
    """A modality's transform. `rng` / `np_rng` are its generators (fresh,
    OS-seeded ones unless given)."""

    def __init__(self, rng: Optional[random.Random] = None,
                 np_rng: Optional[np.random.RandomState] = None):
        self.rng = rng if rng is not None else random.Random()
        self.np_rng = np_rng if np_rng is not None else np.random.RandomState()

    @abstractmethod
    def load(self, sample):
        ...

    @abstractmethod
    def preprocess(self, sample):
        ...

    @abstractmethod
    def image_augment(self, v, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        ...

    @abstractmethod
    def postprocess(self, v):
        ...


class ImageTransform(AbstractTransform):
    @staticmethod
    def pil_loader(path: str) -> np.ndarray:
        """The image file's pixels (data/image_io.py:decode_image)."""
        return image_io.decode_image(Path(path).read_bytes(), path)

    @staticmethod
    def load_mode(path: str):
        """The image file's pixels and Pillow's mode for them (L, RGB, RGBA,
        I;16, P indices; image_io.decode_image_mode)."""
        return image_io.decode_image_mode(Path(path).read_bytes(), path)

    @staticmethod
    def image_hflip(img: np.ndarray, flip: bool) -> np.ndarray:
        return image_io.hflip(img) if flip else img

    @staticmethod
    def image_crop_and_resize(img: np.ndarray, crop_coords, target_size,
                              resample_mode: Optional[str] = None) -> np.ndarray:
        top, left, h, w = crop_coords
        th, tw = target_size
        img = image_io.crop(img, (left, top, left + w, top + h))
        return image_io.resize(img, (tw, th), resample=resample_mode)


class RGBTransform(ImageTransform):
    """(transforms.py:174-218) -> float32 (H, W, 3), normalized."""

    def __init__(self, imagenet_default_mean_and_std: bool = True, color_jitter: bool = False,
                 color_jitter_strength: float = 0.5, **rngs):
        super().__init__(**rngs)
        self.mean = np.asarray(
            IMAGENET_DEFAULT_MEAN if imagenet_default_mean_and_std else IMAGENET_INCEPTION_MEAN,
            dtype=np.float32,
        )
        self.std = np.asarray(
            IMAGENET_DEFAULT_STD if imagenet_default_mean_and_std else IMAGENET_INCEPTION_STD,
            dtype=np.float32,
        )
        self.color_jitter = color_jitter
        self.strength = color_jitter_strength

    def _jitter(self, img: np.ndarray) -> np.ndarray:
        """Brightness, contrast and saturation by factors U(1 +- 0.8 s) with
        p 0.8, then grayscale with p 0.2 (transforms.py:190-201)."""
        s = self.strength
        if self.rng.random() < 0.8:
            for enhance in (image_enhance.brightness, image_enhance.contrast,
                            image_enhance.color):
                img = enhance(img, 1.0 + self.rng.uniform(-0.8 * s, 0.8 * s))
        if self.rng.random() < 0.2:
            img = image_enhance.grayscale_rgb(img)
        return img

    def load(self, path):
        return self.pil_loader(path)

    def preprocess(self, sample):
        sample = image_io.to_rgb(sample)
        return self._jitter(sample) if self.color_jitter else sample

    def image_augment(self, img, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        img = self.image_crop_and_resize(img, crop_coords, target_size, resample_mode)
        return self.image_hflip(img, flip)

    def postprocess(self, sample):
        arr = np.asarray(sample, dtype=np.float32) / 255.0
        return (arr - self.mean) / self.std


class DepthTransform(ImageTransform):
    """uint16 depth -> float32 (H, W, 1), optionally robust-standardized
    (transforms.py:221-250). A 16-bit PNG is I;16: cropped and resized
    (BICUBIC) in 16 bits, as Pillow 12 does."""

    def __init__(self, standardize_depth: bool = True, **rngs):
        super().__init__(**rngs)
        self.standardize_depth = standardize_depth

    @staticmethod
    def truncated_depth_standardization(depth: np.ndarray, thresh: float = 0.1) -> np.ndarray:
        trunc = np.sort(depth.reshape(-1))
        trunc = trunc[int(thresh * len(trunc)): int((1 - thresh) * len(trunc))]
        return (depth - trunc.mean()) / np.sqrt(trunc.var() + 1e-6)

    def load(self, path):
        return self.load_mode(path)[0]

    def preprocess(self, sample):
        return sample

    def image_augment(self, img, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        img = self.image_crop_and_resize(img, crop_coords, target_size, resample_mode)
        return self.image_hflip(img, flip)

    def postprocess(self, sample):
        arr = np.asarray(sample, dtype=np.float32) / (2**16 - 1.0)
        if self.standardize_depth:
            arr = self.truncated_depth_standardization(arr)
        return arr[..., None]


class NormalTransform(ImageTransform):
    """Surface normals (an RGB image); a horizontal flip negates the x (red)
    channel (transforms.py:252-286)."""

    def __init__(self, standardize_surface_normals: bool = False, **rngs):
        super().__init__(**rngs)
        self.mean = np.asarray(
            IMAGENET_SURFACE_NORMAL_MEAN if standardize_surface_normals else (0.5, 0.5, 0.5),
            dtype=np.float32,
        )
        self.std = np.asarray(
            IMAGENET_SURFACE_NORMAL_STD if standardize_surface_normals else (0.5, 0.5, 0.5),
            dtype=np.float32,
        )

    def load(self, path):
        img, mode = self.load_mode(path)
        if mode != "RGB":
            raise ValueError(f"{path}: a surface-normal map is an RGB image, got {mode}")
        return img

    def preprocess(self, sample):
        return sample

    def image_hflip(self, img: np.ndarray, flip: bool) -> np.ndarray:
        if flip:
            img = image_io.hflip(img)
            img[:, :, 0] = 255 - img[:, :, 0]
        return img

    def image_augment(self, img, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        img = self.image_crop_and_resize(img, crop_coords, target_size, resample_mode)
        return self.image_hflip(img, flip)

    def postprocess(self, sample):
        arr = np.asarray(sample, dtype=np.float32) / 255.0
        return (arr - self.mean) / self.std


class SemsegTransform(ImageTransform):
    """Class-index maps -> int64 (H, W); nearest resampling
    (transforms.py:289-326). An image is read as Pillow's convert("P")
    leaves a palette or greyscale one: its indices, or its grey values."""

    def __init__(self, scale_factor: float = 1.0, shift_idx_by_one: bool = False,
                 id_mapping: Optional[Dict] = None, select_channel: Optional[int] = None,
                 **rngs):
        super().__init__(**rngs)
        self.scale_factor = scale_factor
        self.shift_idx_by_one = shift_idx_by_one
        self.id_mapping = id_mapping
        self.select_channel = select_channel

    def load(self, path):
        sample, mode = self.load_mode(path)
        if self.select_channel is not None:  # img.split()[c]: one band, as L
            bands = ([sample] if sample.ndim == 2
                     else [sample[..., c] for c in range(sample.shape[2])])
            sample, mode = bands[self.select_channel], "L" if sample.ndim == 3 else mode
        if mode not in ("L", "P"):
            raise ValueError(f"{path}: a class map is a palette or greyscale image, got "
                             f"{mode} (Pillow's convert('P') would quantize it)")
        return sample

    def preprocess(self, sample):
        sample = np.asarray(sample, dtype=np.uint8)
        if self.id_mapping is not None:
            sample = np.vectorize(lambda x: self.id_mapping.get(x, x))(sample).astype(np.uint8)
        if self.shift_idx_by_one:
            sample = (sample + 1).astype(np.uint8)
        return sample

    def image_augment(self, img, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        img = self.image_crop_and_resize(img, crop_coords, target_size, resample_mode="nearest")
        return self.image_hflip(img, flip)

    def postprocess(self, sample):
        if self.scale_factor != 1.0:
            th = int(sample.shape[0] * self.scale_factor)
            tw = int(sample.shape[1] * self.scale_factor)
            sample = image_io.resize(sample, (tw, th), resample="nearest")
        return np.asarray(sample, dtype=np.int64)


class MaskTransform(ImageTransform):
    """Validity masks -> bool (H, W, 1); min-pooled dilation
    (transforms.py:329-356)."""

    def __init__(self, mask_pool_size: int = 1, **rngs):
        super().__init__(**rngs)
        self.mask_pool_size = int(mask_pool_size)

    def load(self, path):
        return self.load_mode(path)[0]

    def preprocess(self, sample):
        return sample

    def image_augment(self, img, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        img = self.image_crop_and_resize(img, crop_coords, target_size, resample_mode="nearest")
        return self.image_hflip(img, flip)

    def postprocess(self, sample):
        mask = np.asarray(sample, dtype=np.float32)
        if mask.ndim == 3:
            mask = mask[..., 0]
        mask = mask / 255.0 if mask.max() > 1.0 else mask
        p = self.mask_pool_size
        if p > 1:
            H, W = mask.shape
            pooled = mask[: H // p * p, : W // p * p].reshape(H // p, p, W // p, p).min(axis=(1, 3))
            mask = np.repeat(np.repeat(pooled, p, axis=0), p, axis=1)
        return (mask == 1.0)[..., None]


class TokTransform(AbstractTransform):
    """Pre-computed token arrays: select the crop matching rand_aug_idx
    (transforms.py:359-378)."""

    def load(self, path):
        return np.load(path).astype(np.int64)

    def preprocess(self, sample):
        return sample

    def image_augment(self, v, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        if rand_aug_idx is None:
            raise ValueError(
                "Crop settings / augmentation index missing for a pre-tokenized modality"
            )
        return np.asarray(v[rand_aug_idx])

    def postprocess(self, sample):
        return sample


def _bbox_area(b):
    return (b[2] - b[0]) * (b[3] - b[1])


def _bbox_score(b):
    return b[5]


def _bbox_dist_to_orig(b):
    return b[0] ** 2 + b[1] ** 2


class DetectionTransform(AbstractTransform):
    """Instances -> coordinate-token string 'v0=.. v1=.. v2=.. v3=.. class'
    (transforms.py:397-460)."""

    def _order(self, bboxes):
        if self.bbox_order_name == "area":
            return sorted(bboxes, key=_bbox_area, reverse=True)
        if self.bbox_order_name == "score":
            return sorted(bboxes, key=_bbox_score, reverse=True)
        if self.bbox_order_name == "random":
            return sorted(bboxes, key=lambda _b: self.rng.random())
        return sorted(bboxes, key=_bbox_dist_to_orig)

    def __init__(self, det_threshold: float = 0.6, det_max_instances: Optional[int] = None,
                 bbox_order: str = "dist_to_orig", coord_bins: int = 1000,
                 min_visibility: float = 0.0, return_raw: bool = False, **rngs):
        super().__init__(**rngs)
        self.det_threshold = det_threshold
        self.det_max_instances = det_max_instances
        self.coord_bins = coord_bins
        self.min_visibility = min_visibility
        self.return_raw = return_raw
        if bbox_order not in ("area", "score", "random", "dist_to_orig"):
            raise ValueError(f"unknown bbox order {bbox_order}")
        self.bbox_order_name = bbox_order

    def load(self, path):
        with open(path) as f:
            return json.load(f)

    def preprocess(self, sample):
        return [
            inst["boxes"] + [inst["class_name"], inst["score"]]
            for inst in sample["instances"]
            if inst["score"] >= self.det_threshold
        ]

    def image_augment(self, bboxes, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx=None, resample_mode=None):
        orig_h, orig_w = orig_size
        top, left, h, w = crop_coords
        bboxes = [
            bbox_ops.crop(b, left, top, left + w, top + h, orig_h, orig_w) + tuple(b[4:])
            for b in bboxes
        ]
        bboxes = bbox_ops.filter(bboxes, h, w, min_visibility=self.min_visibility)
        if flip:
            bboxes = [bbox_ops.hflip(b) + tuple(b[4:]) for b in bboxes]
        if self.det_max_instances is not None and len(bboxes) > self.det_max_instances:
            bboxes = sorted(bboxes, key=_bbox_score, reverse=True)[: self.det_max_instances]
        return self._order(bboxes)

    def postprocess(self, bboxes):
        if self.return_raw:
            return bboxes
        bins = self.coord_bins
        parts = [
            " ".join([
                f"v0={round(x0 * (bins - 1))}", f"v1={round(y0 * (bins - 1))}",
                f"v2={round(x1 * (bins - 1))}", f"v3={round(y1 * (bins - 1))}", str(cls),
            ])
            for (x0, y0, x1, y1, cls, _score) in bboxes
        ]
        return " ".join(parts)


def _load_text_or_json(path: str):
    if path.endswith(".txt"):
        return Path(path).read_text()
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith(".json.gz"):
        with gzip.open(path, "rb") as f:
            return json.load(f)
    raise ValueError(f"unsupported caption file {path}")


class CaptionTransform(AbstractTransform):
    """(transforms.py:463-496)"""

    def __init__(self, aligned_captions: bool = True, no_aug: bool = False, **rngs):
        super().__init__(**rngs)
        self.aligned_captions = aligned_captions
        self.no_aug = no_aug

    def load(self, path):
        return _load_text_or_json(path)

    def preprocess(self, sample):
        return sample

    def image_augment(self, val, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        if isinstance(val, (list, tuple)):
            if self.aligned_captions:
                val = val[0] if rand_aug_idx is None else val[rand_aug_idx]
            else:
                val = self.rng.choice(val) if not self.no_aug else val[0]
        if isinstance(val, dict):
            val = val["caption"]
        return val

    def postprocess(self, sample):
        return sample


class CaptionEmbTransform(AbstractTransform):
    """Pre-computed caption embeddings, e.g. T5-XXL (transforms.py:499-528)."""

    def __init__(self, aligned_captions: bool = True, no_aug: bool = False, **rngs):
        super().__init__(**rngs)
        self.aligned_captions = aligned_captions
        self.no_aug = no_aug

    def load(self, path):
        if path.endswith(".npz"):
            data = np.load(path)
            return {"emb": data["emb"], "mask_valid": data["mask_valid"]}
        raise ValueError(f"invalid caption embedding file {path}")

    def preprocess(self, sample):
        return sample

    def image_augment(self, val, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        emb, mask_valid = val["emb"], val["mask_valid"].astype(bool)
        if emb.shape[0] > 1:
            if self.aligned_captions:
                idx = 0 if rand_aug_idx is None else rand_aug_idx
            else:
                idx = 0 if self.no_aug else self.rng.randint(0, emb.shape[0] - 1)
        else:
            idx = 0
        return emb[idx][mask_valid[idx]]

    def postprocess(self, sample):
        return np.asarray(sample, dtype=np.float32)


class MetadataTransform(AbstractTransform):
    """Metadata dict -> 'v1=<type> v0=<binned value>' chunks
    (transforms.py:531-608; reference :843-1007)."""

    METADATA_ID_MAP = METADATA_ID_MAP
    IMAGE_DIM_MODALITIES = IMAGE_DIM_MODALITIES
    INT_MODALITIES = INT_MODALITIES
    MANUAL_BINS = MANUAL_BINS
    MIN_MAX_BINS = MIN_MAX_BINS

    def __init__(self, special_vmin: int = 0, special_vmax: int = 999, shuffle: bool = True,
                 random_trunc: bool = False, return_chunks: bool = True,
                 return_raw: bool = False, image_dim_bin_size: int = IMAGE_DIM_BIN_SIZE, **rngs):
        super().__init__(**rngs)
        self.special_vmin = special_vmin
        self.special_vmax = special_vmax
        self.shuffle = shuffle
        self.random_trunc = random_trunc
        self.return_chunks = return_chunks
        self.return_raw = return_raw
        self.image_dim_bin_size = image_dim_bin_size
        self.id_metadata_map = ID_METADATA_MAP

    def _to_string(self, metadata, key) -> str:
        mid = self.METADATA_ID_MAP[key]
        if key in self.IMAGE_DIM_MODALITIES:
            value = metadata[key] // self.image_dim_bin_size
            value = max(self.special_vmin, min(value, self.special_vmax))
        elif key in self.INT_MODALITIES:
            value = max(self.special_vmin, min(metadata[key], self.special_vmax))
        elif key in self.MANUAL_BINS:
            value = sum(1 for b in self.MANUAL_BINS[key] if metadata[key] >= b)
        else:
            vmin, vmax, bins = self.MIN_MAX_BINS[key]
            v = max(vmin, min(metadata[key], vmax))
            value = int((v - vmin) / (vmax - vmin) * (bins - 1))
        return f"{mid} v0={value}"

    def metadata_to_string(self, metadata, keys=None):
        keys = list(metadata.keys()) if keys is None else keys
        if self.shuffle:
            self.rng.shuffle(keys)
        if self.random_trunc:
            keys = keys[: self.rng.randint(1, len(keys))]
        strings = [self._to_string(metadata, k) for k in keys]
        return strings if self.return_chunks else " ".join(strings)

    def load(self, path):
        with open(path) as f:
            return json.load(f)

    def preprocess(self, sample):
        return sample

    def image_augment(self, val, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx=None, resample_mode=None):
        return val

    def postprocess(self, metadata):
        if self.return_raw:
            return metadata
        return self.metadata_to_string(metadata)


class ColorPaletteTransform(AbstractTransform):
    """Palette JSON -> 'v1=<len> v0=.. v0=..' string (transforms.py:611-637)."""

    def __init__(self, coord_bins: int = 1000, return_raw: bool = False, **rngs):
        super().__init__(**rngs)
        self.coord_bins = coord_bins
        self.return_raw = return_raw

    def load(self, path):
        with open(path) as f:
            return json.load(f)

    def preprocess(self, sample):
        if self.return_raw:
            return sample
        length = self.rng.randint(1, 7)
        return np.asarray(sample[0][str(length)]).flatten().tolist()

    def image_augment(self, palettes, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx=None, resample_mode=None):
        return palettes

    def postprocess(self, palettes):
        if self.return_raw:
            return palettes
        colors = [f"v1={round(len(palettes) / 3)}"]
        colors += [f"v0={round(v)}" for v in palettes]
        return " ".join(colors)


class HumanPoseTransform(AbstractTransform):
    """SMPL pose instances -> coordinate-token string (transforms.py:640-725).
    only_pose=True gives the 207-dim body-pose vector of the first instance
    (zeros without one) for tokenizer training, which no augmentation or
    postprocessing changes. (The JAX transform compares that vector with
    "none" in image_augment, which numpy 2 refuses; ROADMAP.)"""

    def __init__(self, coord_bins: int = 1000, only_pose: bool = False,
                 return_raw: bool = False, **rngs):
        super().__init__(**rngs)
        self.coord_bins = coord_bins
        self.only_pose = only_pose
        self.return_raw = return_raw

    def load(self, path):
        with open(path) as f:
            return json.load(f)

    def preprocess(self, sample):
        instances = sample
        if self.only_pose:
            if len(instances) == 0:
                return np.zeros(207, dtype=np.float32)
            return np.asarray(instances["pred_smpl_params"]["body_pose"][0],
                              dtype=np.float32).flatten()
        if len(instances) == 0:
            return "none"
        n = len(instances["bbox_xyxy"])
        converted = []
        for i in range(n):
            converted.append(
                ["human"] + list(np.asarray(instances["bbox_xyxy"][i]).flatten())
                + ["global"] + list(np.asarray(instances["pred_smpl_params"]["global_orient"][i])
                                    .flatten())
                + ["pose"] + list(np.asarray(instances["pose_tokenized"][i]).flatten())
                + ["shape"] + list(np.asarray(instances["pred_smpl_params"]["betas"][i]).flatten())
                + ["camera"] + list(np.asarray(instances["pred_cam"][i]).flatten())
            )
        return converted

    def image_augment(self, humanposes, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx=None, resample_mode=None):
        if self.only_pose or humanposes == "none":
            return humanposes
        orig_h, orig_w = orig_size
        top, left, h, w = crop_coords
        out = []
        for inst in humanposes:
            bbox = np.asarray(inst[1:5], dtype=np.float64)
            bbox[0::2] /= orig_w
            bbox[1::2] /= orig_h
            bbox = np.asarray(
                bbox_ops.crop(bbox, left, top, left + w, top + h, orig_h, orig_w)
            )
            if np.all(bbox[1::2] < 0) or np.all(bbox[0::2] < 0):
                continue
            if np.all(bbox[1::2] > 1.0) or np.all(bbox[0::2] > 1.0):
                continue
            inst = list(inst)
            inst[1:5] = np.clip(bbox, 0.0, 1.0).tolist()
            out.append(inst)
        return out if out else "none"

    def postprocess(self, humanposes):
        if self.only_pose or humanposes == "none":
            return humanposes if not self.return_raw else []
        if self.return_raw:
            return humanposes
        bins = self.coord_bins
        result = ""
        for hp in humanposes:
            bboxes = hp[1:5]
            global_orient = np.asarray(hp[6:15], dtype=np.float64)
            pose_params = np.asarray(hp[16:24], dtype=np.float64)
            shape_params = np.asarray(hp[25:35], dtype=np.float64)
            camera_params = np.clip(np.asarray(hp[36:], dtype=np.float64), -1.0, 19.0)

            bbox_strs = [f"v{i}={round(bboxes[i] * (bins - 1))}" for i in range(4)]
            go = [f"v0={round(v * 499.5 + 499.5)}" for v in global_orient]
            pp = [
                f"v0={round(v)}" if v < 512 else f"v1={round(v - 512)}" for v in pose_params
            ]
            sh = [f"v0={round(v * 166.5 + 499.5)}" for v in shape_params]
            cam = [f"v0={round(v * 49.95 + 49.95)}" for v in camera_params]
            groups = [["pose"] + pp, ["global"] + go, ["camera"] + cam, ["shape"] + sh]
            self.rng.shuffle(groups)
            parts = ["human"] + bbox_strs + [t for g in groups for t in g]
            result += " ".join(str(p) for p in parts) + " "
        return result


class CropSettingsTransform(AbstractTransform):
    """(transforms.py:728-742)"""

    def load(self, path):
        return np.load(path)

    def preprocess(self, sample):
        raise NotImplementedError

    def image_augment(self, val, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        raise NotImplementedError

    def postprocess(self, sample):
        raise NotImplementedError


class IdentityTransform(AbstractTransform):
    def load(self, path):
        raise NotImplementedError

    def preprocess(self, sample):
        return sample

    def image_augment(self, val, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        return val

    def postprocess(self, sample):
        return sample


_IDENTITY = IdentityTransform()  # draws nothing: one serves every unlisted modality


class JSONTransform(AbstractTransform):
    def load(self, path):
        if path.endswith(".json"):
            with open(path) as f:
                return json.load(f)
        if path.endswith(".json.gz"):
            with gzip.open(path, "rb") as f:
                return json.load(f)
        raise ValueError(path)

    def preprocess(self, sample):
        return sample

    def image_augment(self, val, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        return val

    def postprocess(self, sample):
        return sample


def point_in_polygon(contour, point) -> bool:
    """cv2.pointPolygonTest(contour, point, measureDist=True) >= 0: the point
    is on the polygon's boundary (distance 0 to an edge) or inside it by
    OpenCV's crossing count (an edge counts when it spans the point's row,
    its lower end at or below the row and its upper end above, and the
    point lies left of it; an odd count is inside). Integer contours are
    tested exactly in int64; float ones in float64."""
    c = np.asarray(contour).reshape(-1, 2)
    c = c.astype(np.int64) if np.issubdtype(c.dtype, np.integer) else c.astype(np.float64)
    px, py = point
    v0 = np.roll(c, 1, axis=0)  # the edge from the previous vertex (cv2 starts at the last)
    x0, y0, x1, y1 = v0[:, 0], v0[:, 1], c[:, 0], c[:, 1]
    dx, dy = x1 - x0, y1 - y0
    dx1, dy1 = px - x0, py - y0
    dx2, dy2 = px - x1, py - y1
    cross = dy1 * dx - dx1 * dy
    on_segment = ((dx1 * dx + dy1 * dy <= 0) & (dx1 == 0) & (dy1 == 0)) | (
        (dx1 * dx + dy1 * dy > 0) & (dx2 * dx + dy2 * dy >= 0) & (dx2 == 0) & (dy2 == 0)) | (
        (dx1 * dx + dy1 * dy > 0) & (dx2 * dx + dy2 * dy < 0) & (cross == 0))
    if on_segment.any():
        return True
    skip = ((y0 <= py) & (y1 <= py)) | ((y0 > py) & (y1 > py)) | ((x0 < px) & (x1 < px))
    counted = np.where(dy < 0, -cross, cross) > 0
    return bool(np.sum(counted & ~skip) % 2 == 1)


# OpenCV's drawing fixed point (drawing.cpp): 16 fractional bits
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _clip_line(width, height, p1, p2):
    """OpenCV clipLine(Size2l, Point2l&, Point2l&) in int64 / double."""
    right, bottom = width - 1, height - 1
    (x1, y1), (x2, y2) = p1, p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line8(img, p1, p2, value):
    """cv2.line's LINE_8 (LineIterator, left to right) on a uint8 image."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        ok, p1, p2 = _clip_line(w, h, p1, p2)
        if not ok:
            return
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus, minus = dx + dx, -(dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        step_minor = err < 0
        err += minus + (plus if step_minor else 0)
        if vert:
            y += sy
            if step_minor:
                x += sx
        else:
            x += sx
            if step_minor:
                y += sy


def fill_contour(img, contour, value=255):
    """cv2.drawContours(img, [contour], 0, value, thickness=cv2.FILLED) on a
    uint8 (H, W) image, in place, as cv2 5.0.0 draws it: each edge drawn as
    a LINE_8 line (clipped to the image), then the scanline fill of
    fillPoly's edge list: 16.16 fixed-point edges (an edge that leaves the
    image takes x from its clipped segment), each row filled from the left
    edge rounded up to the right edge rounded down between edge pairs."""
    h, w = img.shape
    pts = np.asarray(contour).reshape(-1, 2).astype(np.int64)
    n = len(pts)
    edges = []
    pt0 = (int(pts[-1, 0]) << XY_SHIFT, int(pts[-1, 1]))
    for i in range(n):
        pt1 = (int(pts[i, 0]) << XY_SHIFT, int(pts[i, 1]))
        t0 = ((pt0[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + (XY_ONE >> 1)) >> XY_SHIFT, pt1[1])
        _line8(img, t0, t1, value)
        p0c, p1c = list(pt0), list(pt1)
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h and 0 <= t1[1] < h):
            # cv2 5.0.0 takes x from clipLine's points (clipped, or as given
            # when it rejects the line) and y only where they differ: a line
            # that clips to one border point becomes a vertical edge there
            _, c0, c1 = _clip_line(w, h, t0, t1)
            if c0[1] != c1[1]:
                p0c[1], p1c[1] = c0[1], c1[1]
            p0c[0], p1c[0] = c0[0] << XY_SHIFT, c1[0] << XY_SHIFT

        if pt0[1] != pt1[1]:
            dx = _cdiv(p1c[0] - p0c[0], p1c[1] - p0c[1])
            if pt0[1] < pt1[1]:
                edges.append([pt0[1], pt1[1], p0c[0] + (pt0[1] - p0c[1]) * dx, dx])
            else:
                edges.append([pt1[1], pt0[1], p1c[0] + (pt1[1] - p1c[1]) * dx, dx])
        pt0 = pt1
    _fill_edges(img, edges, value)


def _cdiv(a, b):
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _fill_edges(img, edges, value):
    """OpenCV's FillEdgeCollection over edges [y0, y1, x, dx] (x, dx in
    16.16 fixed point): an active list in x order, each row filled between
    consecutive pairs, the list bubble-sorted by x after each row."""
    h, w = img.shape
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    total = len(edges)
    active = []  # the active list, in its order
    i = 0
    y_max = min(y_max, h)
    y = edges[0][0]
    while y < y_max:
        # walk the active list, dropping finished edges and inserting new
        # ones (sorted position), drawing between every pair
        new_active = []
        draw = False
        k = 0
        pending = None
        while True:
            last = active[k] if k < len(active) else None
            if last is not None and last[1] == y:
                k += 1
                continue
            e = edges[i] if i < total else None
            if last is None and (e is None or e[0] != y):
                break
            if last is not None and (e is None or e[0] > y or last[2] < e[2]):
                cur = last
                k += 1
            elif e is not None:
                cur = e
                i += 1
            else:
                break
            new_active.append(cur)
            if draw:
                a, b = pending, cur
                if y >= 0:
                    if a[2] > b[2]:
                        x1, x2 = (b[2] + XY_ONE - 1) >> XY_SHIFT, a[2] >> XY_SHIFT
                    else:
                        x1, x2 = (a[2] + XY_ONE - 1) >> XY_SHIFT, b[2] >> XY_SHIFT
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0):min(x2, w - 1) + 1] = value
                a[2] += a[3]
                b[2] += b[3]
            pending = cur
            draw = not draw
        active = new_active
        # bubble sort by x (stable exchanges, as the C loop)
        n = len(active)
        swapped = True
        while swapped:
            swapped = False
            for j in range(n - 1):
                if active[j][2] > active[j + 1][2]:
                    active[j], active[j + 1] = active[j + 1], active[j]
                    swapped = True
        y += 1


class SAMInstanceTokTransform(AbstractTransform):
    """Pre-tokenized SAM instances -> query-point-conditioned token string
    (transforms.py:781-855): for random/grid query points, list the (bbox +
    token ids) of every instance polygon containing the point."""

    def __init__(self, image_size: int = 224, points_per_side: int = 7,
                 point_order: str = "random", **rngs):
        super().__init__(**rngs)
        self.H = self.W = image_size
        self.points_per_h = self.points_per_w = points_per_side
        assert point_order in ("random", "grid")
        self.point_order = point_order
        self._grid = None

    def get_query_points(self) -> np.ndarray:
        if self.point_order == "grid":
            if self._grid is None:
                y, x = np.meshgrid(
                    np.linspace(0, self.H, self.points_per_h + 2)[1:-1],
                    np.linspace(0, self.W, self.points_per_w + 2)[1:-1],
                )
                self._grid = np.stack((x, y), axis=2).astype(np.int32).reshape(-1, 2)
            return self._grid
        y = self.np_rng.randint(0, self.H, self.points_per_h)
        x = self.np_rng.randint(0, self.W, self.points_per_w)
        return np.concatenate((x[:, None], y[:, None]), axis=1)

    def get_target_tokens(self, sample, query_points):
        instances_coords = [coords[0] for coords in sample["points"]]
        tokens = sample["token_ids"]
        bboxes = sample["bbox"]
        out = {}
        for point in query_points:
            point = (int(point[0]), int(point[1]))
            out[point] = []
            for coords, tok, bbox in zip(instances_coords, tokens, bboxes):
                if point_in_polygon(coords, point):
                    out[point].append((tok, bbox))
        return out

    def convert_target_tokens_to_string(self, target_tokens) -> str:
        result = []
        points = list(target_tokens.keys())
        self.rng.shuffle(points)
        for point in points:
            result += ["point", f"v0={point[1]}", f"v1={point[0]}"]
            self.rng.shuffle(target_tokens[point])
            if not target_tokens[point]:
                result.append("none")
            for tok, bbox in target_tokens[point]:
                result.append("polygon")
                ymin, xmin, ymax, xmax = np.asarray(bbox).astype(np.int32)
                result += [f"v0={xmin}", f"v1={ymin}", f"v2={xmax}", f"v3={ymax}"]
                for idx in np.asarray(tok).tolist():
                    result.append(f"v0={idx}" if idx < 512 else f"v1={idx - 512}")
        return " ".join(result)

    def load(self, path):
        return np.load(path, allow_pickle=True)

    def preprocess(self, sample):
        for s in sample:
            s["token_ids"] = np.asarray(s["token_ids"]).astype(np.int32)
        return sample

    def image_augment(self, v, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx, resample_mode=None):
        if rand_aug_idx is None:
            raise ValueError("pre-tokenized SAM instances need an augmentation index")
        return v[rand_aug_idx]

    def postprocess(self, sample):
        qp = self.get_query_points()
        return self.convert_target_tokens_to_string(self.get_target_tokens(sample, qp))


class SAMInstanceTransform(AbstractTransform):
    """Raw SAM instance polygons -> fixed-size binary masks and boxes, for SAM
    instance tokenizer training (transforms.py:858-995): crops clip the
    polygons against the crop rectangle (border crossings added), resize,
    drop tiny instances, and rasterise each polygon to a mask_size x
    mask_size mask (`fill_contour`). At most max_instance_n instances, drawn
    from np_rng as the JAX transform draws them from np.random."""

    def __init__(self, mask_size: int = 64, max_instance_n: Optional[int] = 20,
                 bbox_area_threshold: float = 0.0005, **rngs):
        super().__init__(**rngs)
        self.mask_size = mask_size
        self.max_instance_n = max_instance_n
        self.bbox_area_threshold = bbox_area_threshold

    @staticmethod
    def get_bbox(instance):
        min_h, max_h = instance[:, :, 1].min(), instance[:, :, 1].max()
        min_w, max_w = instance[:, :, 0].min(), instance[:, :, 0].max()
        return [min_h, min_w, max_h, max_w]

    @staticmethod
    def _border_crossings(crop_points):
        p = crop_points[:, 0]
        p_next = np.roll(p, -1, axis=0)

        def fn(x, xn):
            out = []
            c_diff = p_next - p
            x_diff = x - xn
            for diff, c in zip(c_diff, p):
                A = np.array([[diff[0], x_diff[0]], [diff[1], x_diff[1]]], dtype=np.float64)
                b = (x - c).astype(np.float64)
                try:
                    lm = np.linalg.solve(A, b)
                except np.linalg.LinAlgError:
                    continue
                if 0 <= lm[0] <= 1 and 0 <= lm[1] <= 1:
                    out.append(lm[1] * xn + (1 - lm[1]) * x)
            return out

        return fn

    def crop_sample(self, sample, crop_coords):
        top, left, h, w = crop_coords
        region = (left, top, left + w, top + h)
        crop_points = np.array([
            [region[0], region[1]], [region[2], region[1]],
            [region[2], region[3]], [region[0], region[3]],
        ])[:, None]
        border_fn = self._border_crossings(crop_points)
        out = []
        for instance in sample:
            p = instance[:, 0]
            p_next = np.roll(p, -1, axis=0)
            pts = []
            for x, xn in zip(p, p_next):
                pts.append(x)
                for r in border_fn(x, xn):
                    pts.append(r.astype(np.int32))
            inst = np.stack(pts)[:, None]
            inside = (
                (inst[:, :, 0] > region[0]) & (inst[:, :, 0] < region[2])
                & (inst[:, :, 1] > region[1]) & (inst[:, :, 1] < region[3])
            )
            if not np.any(inside):
                continue
            clipped = inst.copy()
            clipped[:, :, 0] = np.clip(inst[:, :, 0], region[0], region[2])
            clipped[:, :, 1] = np.clip(inst[:, :, 1], region[1], region[3])
            # drop points that left the original polygon (redundant lines)
            kept = [q[0] for q in clipped
                    if point_in_polygon(inst, (float(q[0, 0]), float(q[0, 1])))]
            if len(kept) < 3:
                continue
            clipped = np.stack(kept)[:, None]
            clipped[:, :, 0] -= region[0]
            clipped[:, :, 1] -= region[1]
            out.append(clipped)
        return out

    def image_augment(self, v, crop_coords, flip, orig_size, target_size,
                      rand_aug_idx=None, resample_mode=None):
        v = self.crop_sample(v, crop_coords)
        _, _, h, w = crop_coords
        th, tw = target_size
        scaled = []
        for inst in v:
            c = inst.copy()
            c[:, :, 0] = np.round(tw / w * c[:, :, 0])
            c[:, :, 1] = np.round(th / h * c[:, :, 1])
            scaled.append(c)
        kept = []
        for inst in scaled:  # drop tiny instances
            min_h, min_w, max_h, max_w = self.get_bbox(inst)
            if (max_h - min_h) * (max_w - min_w) / (th * tw) >= self.bbox_area_threshold:
                kept.append(inst)
        if flip:
            flipped = []
            for inst in kept:
                c = inst.copy()
                c[:, :, 0] = tw - c[:, :, 0]
                flipped.append(c)
            kept = flipped
        return kept

    def load(self, path):
        return np.load(path, allow_pickle=True)

    def preprocess(self, sample):
        if self.max_instance_n is None or len(sample) <= self.max_instance_n:
            idx = np.arange(len(sample))
        else:
            idx = self.np_rng.choice(len(sample), size=self.max_instance_n, replace=False)
        return [p["points"] for i, p in enumerate(sample) if i in idx]

    def postprocess(self, sample):
        n = self.max_instance_n if self.max_instance_n is not None else len(sample)
        masks = np.zeros((n, self.mask_size, self.mask_size), np.float32)
        bboxes = np.zeros((n, 4), np.float32)
        valid = np.full(n, False)
        for i, inst in enumerate(sample[:n]):
            bbox = self.get_bbox(inst)
            min_h, min_w, max_h, max_w = bbox
            c = inst.copy().astype(np.float64)
            c[:, :, 0] = (c[:, :, 0] - min_w) / max(max_w - min_w, 1e-6) * self.mask_size
            c[:, :, 1] = (c[:, :, 1] - min_h) / max(max_h - min_h, 1e-6) * self.mask_size
            mask = np.zeros((self.mask_size, self.mask_size), np.uint8)
            fill_contour(mask, c.astype(np.int32), 255)
            masks[i] = mask / 255.0
            bboxes[i] = np.asarray(bbox, np.float32)
            valid[i] = True
        return {"instance": masks, "bbox": bboxes, "valid": valid}


# ---------------------------------------------------------------- registries

def default_modality_transforms(rng: Optional[random.Random] = None,
                                np_rng: Optional[np.random.RandomState] = None
                                ) -> Dict[str, AbstractTransform]:
    """The pre-training transforms (transforms.py:998-1021), every one
    drawing from `rng` / `np_rng`."""
    r = dict(rng=rng if rng is not None else random.Random(),
             np_rng=np_rng if np_rng is not None else np.random.RandomState())
    return {
        "rgb": RGBTransform(imagenet_default_mean_and_std=True, **r),
        "caption": CaptionTransform(aligned_captions=True, **r),
        "det": DetectionTransform(det_threshold=0.6, bbox_order="dist_to_orig",
                                  coord_bins=1000, min_visibility=0.0, **r),
        "tok_rgb": TokTransform(**r),
        "tok_depth": TokTransform(**r),
        "tok_normal": TokTransform(**r),
        "tok_semseg": TokTransform(**r),
        "tok_clip": TokTransform(**r),
        "t5_caption": CaptionEmbTransform(**r),
        "metadata": MetadataTransform(shuffle=True, random_trunc=False, return_chunks=True, **r),
        "human_poses": HumanPoseTransform(coord_bins=1000, **r),
        "color_palette": ColorPaletteTransform(coord_bins=1000, **r),
        "tok_canny_edge": TokTransform(**r),
        "tok_sam_edge": TokTransform(**r),
        "tok_dinov2": TokTransform(**r),
        "tok_imagebind": TokTransform(**r),
        "tok_dinov2_global": TokTransform(**r),
        "tok_imagebind_global": TokTransform(**r),
        "sam_instance": SAMInstanceTokTransform(image_size=224, points_per_side=7,
                                                point_order="random", **r),
        "mask_valid": MaskTransform(mask_pool_size=1, **r),
    }


def divae_modality_transforms(rng: Optional[random.Random] = None,
                              np_rng: Optional[np.random.RandomState] = None
                              ) -> Dict[str, AbstractTransform]:
    """The tokenizer-training transforms (transforms.py:1024-1034), every
    one drawing from `rng` / `np_rng`."""
    r = dict(rng=rng if rng is not None else random.Random(),
             np_rng=np_rng if np_rng is not None else np.random.RandomState())
    return {
        "rgb": RGBTransform(imagenet_default_mean_and_std=False, **r),
        "depth": DepthTransform(standardize_depth=True, **r),
        "normal": NormalTransform(standardize_surface_normals=False, **r),
        "mask_valid": MaskTransform(mask_pool_size=1, **r),
        "semseg_coco": SemsegTransform(shift_idx_by_one=True, **r),
        "canny_edge": RGBTransform(imagenet_default_mean_and_std=False, **r),
        "human_poses": HumanPoseTransform(coord_bins=1000, only_pose=True, **r),
        "sam_mask": SAMInstanceTransform(mask_size=64, max_instance_n=1, **r),
    }
