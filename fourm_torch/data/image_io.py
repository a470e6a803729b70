"""Image decoding and resampling of the data pipeline without Pillow: the
machine with the card has no Pillow and no cv2, and the pre-training
transforms read the RGB image (its size sets the crop of the boxes of
`det` and `human_poses`; `rgb@224` is an input of 4M-21).

  * `read_png`: 8-bit greyscale, RGB and RGBA PNGs, non-interlaced, all
    five row filters (rows reconstructed by the native library when it
    builds, by numpy otherwise); chunk CRCs checked as Pillow checks them.
    Anything else raises, naming the file. `write_png` writes one, with a
    chosen filter per row.
  * `decode_image`: PNG by `read_png`; JPEG through Pillow when it can be
    imported, else a RuntimeError naming the file and Pillow.
  * `crop`, `resize` and `hflip`: what fourm_tpu/data/transforms.py:
    ImageTransform.image_crop_and_resize (:166-171) and image_hflip do
    with Pillow, byte for byte: `img.crop(box)` (pixels outside the image
    are 0), then `img.resize((tw, th), resample=None)`, Pillow's default
    filter for an RGB / L image being BICUBIC, computed as Pillow's
    two-pass fixed-point resampler computes it (libImaging/Resample.c:
    coefficients in double, normalised and rounded to 22 fractional bits,
    horizontal pass into uint8, then vertical); other filters raise.
    Images are numpy uint8 (H, W) or (H, W, C) arrays.
"""

from __future__ import annotations

import functools
import io
import math
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> channels (L, RGB, RGBA)
PRECISION_BITS = 32 - 8 - 2  # Resample.c


# ------------------------------------------------------------------ PNG

def _unfilter_numpy(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.int64)
    for r in range(height):
        ft, f = int(rows[r, 0]), rows[r, 1:].astype(np.int64)
        if ft == 0:
            cur = f
        elif ft == 1:  # Sub: a running sum per channel, modulo 256
            cur = np.cumsum(f.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ft == 2:
            cur = (f + prev) & 0xFF
        elif ft in (3, 4):
            cur = np.zeros(rowbytes, np.int64)
            for i in range(rowbytes):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (int(f[i]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {r}: filter type {ft} is not one of 0..4")
        out[r] = cur
        prev = cur
    return out


def read_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """A PNG's pixels: (H, W) for greyscale, (H, W, 3) RGB, (H, W, 4) RGBA,
    uint8. Raises ValueError, naming `name`, on anything else (palette,
    16-bit, interlaced, a broken CRC or stream)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: broken CRC in the {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{name}: PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}: this reader takes 8-bit greyscale / RGB / RGBA, "
                         "non-interlaced")
    ch = _CHANNELS[ctype]
    rowbytes = w * ch
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (rowbytes + 1):
        raise ValueError(f"{name}: image data too short")
    raw = raw[:h * (rowbytes + 1)]
    from ..native import native_available, png_unfilter

    try:
        pixels = (png_unfilter(raw, h, rowbytes, ch) if native_available()
                  else _unfilter_numpy(np.frombuffer(raw, np.uint8), h, rowbytes, ch))
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return pixels.reshape(h, w) if ch == 1 else pixels.reshape(h, w, ch)


def _filtered(rows: np.ndarray, ft: np.ndarray, bpp: int) -> np.ndarray:
    """Every row filtered by its filter type (the PNG predictors read the raw
    neighbours, so the rows of one type are filtered at once). rows: int16."""
    a = np.concatenate([np.zeros_like(rows[:, :bpp]), rows[:, :-bpp]], axis=1)
    b = np.concatenate([np.zeros_like(rows[:1]), rows[:-1]], axis=0)
    pred = np.zeros_like(rows)
    for t in np.unique(ft):
        r = ft == t
        if t == 1:
            pred[r] = a[r]
        elif t == 2:
            pred[r] = b[r]
        elif t == 3:
            pred[r] = (a[r] + b[r]) >> 1
        elif t == 4:
            ar, br = a[r], b[r]
            cr = np.concatenate([np.zeros_like(br[:, :bpp]), br[:, :-bpp]], axis=1)
            p = ar + br - cr
            pa, pb, pc = np.abs(p - ar), np.abs(p - br), np.abs(p - cr)
            pred[r] = np.where((pa <= pb) & (pa <= pc), ar, np.where(pb <= pc, br, cr))
    return ((rows - pred) & 0xFF).astype(np.uint8)


def write_png(arr: np.ndarray, filters: Sequence[int] = (0,), level: int = 6) -> bytes:
    """A uint8 (H, W), (H, W, 3) or (H, W, 4) array as PNG bytes, row r
    filtered by filters[r % len(filters)] (each of 0..4)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] not in (3, 4)):
        raise ValueError(f"write_png takes uint8 (H, W[, 3 | 4]), got {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    ft = np.resize(np.asarray(list(filters), np.int64), h)
    if ft.min() < 0 or ft.max() > 4:
        raise ValueError(f"PNG filter types are 0..4, got {sorted(set(ft.tolist()))}")
    body = _filtered(arr.reshape(h, w * ch).astype(np.int16), ft, ch)
    raw = np.concatenate([ft.astype(np.uint8)[:, None], body], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ctype = {1: 0, 3: 2, 4: 6}[ch]
    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def decode_image(data: bytes, name: str = "<image>") -> np.ndarray:
    """PNG by read_png; JPEG (and any other format) through Pillow, which
    must then be importable."""
    if data[:8] == PNG_SIGNATURE:
        return read_png(data, name)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{name}: only PNG is decoded without Pillow; this image needs "
                           "Pillow (not installed)") from None
    img = Image.open(io.BytesIO(data))
    if img.mode not in ("L", "RGB", "RGBA"):
        img = img.convert("RGB")
    return np.asarray(img)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """Pillow's convert("RGB") of an L / RGB / RGBA image: grey repeated,
    alpha dropped."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 4:
        return np.ascontiguousarray(img[..., :3])
    return img


# ----------------------------------------------------- crop, resize, flip

def crop(img: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """Pillow's img.crop((left, top, right, bottom)): pixels outside the
    image are 0."""
    left, top, right, bottom = (int(v) for v in box)
    h, w = img.shape[:2]
    out = np.zeros((bottom - top, right - left) + img.shape[2:], img.dtype)
    y0, y1, x0, x1 = max(top, 0), min(bottom, h), max(left, 0), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def hflip(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[:, ::-1])


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


BICUBIC_SUPPORT = 2.0


@functools.lru_cache(maxsize=256)
def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resample.c:precompute_coeffs with in0 = 0, in1 = in_size, then
    normalize_coeffs_8bpc: (xmin (out,), xmax (out,), int coefficients
    (out, ksize)). The same double operations in the same order, over every
    output position at once (the weights summed tap by tap, as the C loop)."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    center = 0.0 + (np.arange(out_size) + 0.5) * scale
    xmins = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmaxs = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmins
    taps = np.arange(ksize)
    valid = taps[None, :] < xmaxs[:, None]
    w = np.where(valid, _bicubic(((taps[None, :] + xmins[:, None]) - center[:, None] + 0.5) * ss),
                 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):
        ww = ww + w[:, t]
    kk = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = kk * (1 << PRECISION_BITS)
    ints = np.where(kk < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmins, xmaxs, ints


def _pass(img: np.ndarray, axis: int, xmins, xmaxs, k) -> np.ndarray:
    """One 8bpc pass along `axis` (1: horizontal, 0: vertical): each output
    position sums its taps in 32-bit integers from 2^(P-1), as Resample.c
    does, shifts by P and clips to uint8."""
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.int32)
    n_out, ksize = k.shape
    acc = np.full((n_out,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    tail = (1,) * (src.ndim - 1)
    k = k.astype(np.int32)
    for t in range(ksize):
        valid = t < xmaxs
        if not valid.any():
            break
        idx = np.where(valid, xmins + t, 0)
        acc += src[idx] * (k[:, t] * valid).reshape((n_out,) + tail)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def resize(img: np.ndarray, size: Tuple[int, int], resample: Optional[str] = None) -> np.ndarray:
    """Pillow's img.resize((width, height), resample) of an L / RGB uint8
    image; resample None is Pillow's default for these modes, BICUBIC, the
    one filter ported."""
    if resample not in (None, "bicubic"):
        raise ValueError(f"resize: filter {resample!r} is not ported (bicubic only)")
    tw, th = size
    h, w = img.shape[:2]
    if (tw, th) == (w, h):
        return img.copy()
    need_h, need_v = tw != w, th != h
    ymins, ymaxs, kv = _coeffs(h, th)
    out = img
    if need_h:
        # only the rows the vertical pass reads (Resample.c:ImagingResampleInner)
        first, last = int(ymins[0]), int(ymins[-1] + ymaxs[-1])
        xmins, xmaxs, kh = _coeffs(w, tw)
        out = _pass(img[first:last], 1, xmins, xmaxs, kh)
        ymins = ymins - first
    if need_v:
        out = _pass(out, 0, ymins, ymaxs, kv)
    return out
