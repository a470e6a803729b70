"""Image augmenters: ONE (crop_coords, flip, orig_size, target_size,
rand_aug_idx) tuple shared by all modalities of a sample.

The port's own copy of fourm_tpu/data/augmenters.py (reference fourm/data/
image_augmenter.py:23-186). Images are numpy arrays (data/image_io.py), and
each augmenter draws from its own `rng` (random.Random) and `np_rng`
(np.random.RandomState) in the order in which the JAX augmenter draws from
the global `random` and `np.random`.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np


def _to2(v):
    return (v, v) if not isinstance(v, (tuple, list)) else tuple(v)


def _main_image(mod_dict, main_domain):
    img = mod_dict[main_domain] if main_domain in mod_dict else mod_dict[list(mod_dict)[0]]
    h, w = np.shape(img)[:2]
    return img, (h, w)


def random_resized_crop_params(height: int, width: int, scale, ratio,
                               rng: random.Random) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params algorithm (10 tries then center
    fallback)."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = rng.randint(0, height - h)
            left = rng.randint(0, width - w)
            return top, left, h, w
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    top = (height - h) // 2
    left = (width - w) // 2
    return top, left, h, w


class AbstractImageAugmenter:
    def __init__(self, rng: Optional[random.Random] = None,
                 np_rng: Optional[np.random.RandomState] = None):
        self.rng = rng if rng is not None else random.Random()
        self.np_rng = np_rng if np_rng is not None else np.random.RandomState()

    def __call__(self, mod_dict, crop_settings):
        raise NotImplementedError


class RandomCropImageAugmenter(AbstractImageAugmenter):
    def __init__(self, target_size=224, hflip: float = 0.5, crop_scale=(0.2, 1.0),
                 crop_ratio=(0.75, 1.3333), main_domain: str = "rgb", **rngs):
        super().__init__(**rngs)
        self.target_size = _to2(target_size)
        self.hflip = hflip
        self.crop_scale = crop_scale
        self.crop_ratio = crop_ratio
        self.main_domain = main_domain

    def __call__(self, mod_dict, crop_settings):
        if crop_settings is not None:
            raise ValueError("crop settings provided but unused by this augmenter")
        _, orig_size = _main_image(mod_dict, self.main_domain)
        crop_coords = random_resized_crop_params(*orig_size, self.crop_scale, self.crop_ratio,
                                                 self.rng)
        return crop_coords, self.rng.random() < self.hflip, orig_size, self.target_size, None


class PreTokenizedImageAugmenter(AbstractImageAugmenter):
    """Pick one of the persisted crop settings so pre-computed tokens stay aligned
    with raw modalities (reference image_augmenter.py:78-98)."""

    def __init__(self, target_size, no_aug: bool = False, main_domain: str = "rgb", **rngs):
        super().__init__(**rngs)
        self.target_size = _to2(target_size)
        self.no_aug = no_aug
        self.main_domain = main_domain

    def __call__(self, mod_dict, crop_settings):
        if self.main_domain in mod_dict and "tok" not in self.main_domain:
            _, orig_size = _main_image(mod_dict, self.main_domain)
        else:
            orig_size = None
        rand_aug_idx = 0 if self.no_aug else self.np_rng.randint(len(crop_settings))
        top, left, h, w, flip = crop_settings[rand_aug_idx]
        return (top, left, h, w), bool(flip), orig_size, self.target_size, rand_aug_idx


class CenterCropImageAugmenter(AbstractImageAugmenter):
    def __init__(self, target_size, hflip: float = 0.0, main_domain: str = "rgb", **rngs):
        super().__init__(**rngs)
        self.target_size = _to2(target_size)
        self.hflip = hflip
        self.main_domain = main_domain

    def __call__(self, mod_dict, crop_settings=None):
        _, (orig_h, orig_w) = _main_image(mod_dict, self.main_domain)
        if orig_h > orig_w:
            h = w = orig_w
            top, left = (orig_h - orig_w) // 2, 0
        else:
            h = w = orig_h
            top, left = 0, (orig_w - orig_h) // 2
        return ((top, left, h, w), self.rng.random() < self.hflip, (orig_h, orig_w),
                self.target_size, None)


class PaddingImageAugmenter(AbstractImageAugmenter):
    def __init__(self, target_size, hflip: float = 0.0, main_domain: str = "rgb", **rngs):
        super().__init__(**rngs)
        self.target_size = _to2(target_size)
        self.hflip = hflip
        self.main_domain = main_domain

    def __call__(self, mod_dict, crop_settings):
        _, (orig_h, orig_w) = _main_image(mod_dict, self.main_domain)
        h = w = max(orig_h, orig_w)
        return ((0, 0, h, w), self.rng.random() < self.hflip, (orig_h, orig_w),
                self.target_size, None)


class ScaleJitteringImageAugmenter(AbstractImageAugmenter):
    def __init__(self, target_size, hflip: float = 0.0, scale=(0.1, 2.0), main_domain: str = "rgb",
                 **rngs):
        super().__init__(**rngs)
        self.target_size = _to2(target_size)
        self.hflip = hflip
        self.scale = scale
        self.main_domain = main_domain

    def __call__(self, mod_dict, crop_settings):
        if crop_settings is not None:
            raise ValueError("crop settings provided but unused by this augmenter")
        _, (orig_h, orig_w) = _main_image(mod_dict, self.main_domain)
        rand_scale = self.np_rng.uniform(*self.scale)
        h = w = round(max(orig_h, orig_w) / rand_scale)
        top = round(max(0, self.np_rng.uniform(0, orig_h - h)))
        left = round(max(0, self.np_rng.uniform(0, orig_w - w)))
        return ((top, left, h, w), self.rng.random() < self.hflip, (orig_h, orig_w),
                self.target_size, None)


class NoImageAugmenter(AbstractImageAugmenter):
    """For non-image modality tokenization (e.g. poses)."""

    def __init__(self, no_aug: bool = True, main_domain: str = "human_poses", **rngs):
        super().__init__(**rngs)
        self.no_aug = no_aug
        self.main_domain = main_domain
        self.target_size = None

    def __call__(self, mod_dict, crop_settings):
        return (0, 0, 224, 224), 0, (224, 224), None, 0


class EmptyAugmenter(AbstractImageAugmenter):
    def __call__(self, mod_dict, crop_settings):
        return None, None, None, None, None
