"""Pillow's ImageEnhance.Brightness / Contrast / Color and ImageOps.grayscale
on uint8 RGB arrays, byte for byte (the color jitter of data/transforms.py:
RGBTransform; the machine with the card has no Pillow).

Pillow's `Image.blend(degenerate, image, factor)` computes
`degenerate + factor * (image - degenerate)` in fp32 per byte and truncates,
clipping to [0, 255] for a factor outside [0, 1]; `convert("L")` is the
ITU-R 601-2 luma in 16-bit fixed point; Contrast blends with the L image's
mean, rounded half up."""

from __future__ import annotations

import numpy as np


def to_l(img: np.ndarray) -> np.ndarray:
    """convert("L") of an (H, W, 3) uint8 image -> (H, W) uint8."""
    rgb = img.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def grayscale_rgb(img: np.ndarray) -> np.ndarray:
    """ImageOps.grayscale(img).convert("RGB")."""
    return np.repeat(to_l(img)[..., None], 3, axis=-1)


def blend(degenerate: np.ndarray, img: np.ndarray, factor: float) -> np.ndarray:
    """Image.blend(degenerate, img, factor) on uint8 arrays of one shape."""
    a = np.float32(factor)
    d = degenerate.astype(np.float32)
    out = d + a * (img.astype(np.float32) - d)
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """ImageEnhance.Brightness(img).enhance(factor)."""
    return blend(np.zeros_like(img), img, factor)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """ImageEnhance.Contrast(img).enhance(factor)."""
    lum = to_l(img)
    mean = int(float(lum.sum(dtype=np.int64)) / lum.size + 0.5)
    return blend(np.full_like(img, mean), img, factor)


def color(img: np.ndarray, factor: float) -> np.ndarray:
    """ImageEnhance.Color(img).enhance(factor)."""
    return blend(grayscale_rgb(img), img, factor)
