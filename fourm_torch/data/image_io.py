"""Image decoding and resampling of the data pipeline without Pillow: the
machine with the card has no Pillow and no cv2, and the pre-training
transforms read the RGB image (its size sets the crop of the boxes of
`det` and `human_poses`; `rgb@224` is an input of 4M-21).

  * `read_png_mode`: a non-interlaced PNG as Pillow opens it, with its
    mode: 8-bit greyscale "L", "RGB", "RGBA", 16-bit greyscale "I;16"
    (uint16, the depth maps of DiVAE training) and palette "P" (bit depth
    1, 2, 4 or 8: the indices, as Image.open and convert("P") keep them;
    the semantic maps); all five row filters (rows reconstructed by the
    native library when it builds, by numpy otherwise); chunk CRCs checked
    as Pillow checks them. Anything else raises, naming the file.
    `read_png` takes L / RGB / RGBA alone (a P or I;16 file raises).
    `write_png` writes L / RGB / RGBA, `palette=` P and uint16 I;16, with
    a chosen filter per row.
  * `decode_image` / `decode_image_mode`: PNG by `read_png_mode`, JPEG
    (baseline or progressive) by the native library's `decode_jpeg`, equal
    byte for byte to Pillow 12.1.0 (native/jpeg_decode.cpp); any other
    format raises, naming the file. Nothing here imports Pillow.
  * `crop`, `resize` and `hflip`: what fourm_tpu/data/transforms.py:
    ImageTransform.image_crop_and_resize (:166-171) and image_hflip do
    with Pillow, byte for byte: `img.crop(box)` (pixels outside the image
    are 0), then `img.resize((tw, th), resample=None)`, Pillow's default
    filter for an RGB / L image being BICUBIC, computed as Pillow's
    two-pass fixed-point resampler computes it (libImaging/Resample.c:
    coefficients in double, normalised and rounded to 22 fractional bits,
    horizontal pass into uint8, then vertical); for an I;16 image (uint16)
    BICUBIC too, as Resample.c's 16bpc passes compute it (double
    coefficients, the sum rounded half away from zero and stored as two
    clipped bytes); NEAREST for any image, as Geometry.c's
    ImagingScaleAffine picks its source pixels (the filter of P images,
    SemsegTransform and MaskTransform). BILINEAR has no caller in either
    package and raises. Images are numpy uint8 (H, W) or (H, W, C), or
    uint16 (H, W) arrays.
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
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}  # PNG colour type -> channels (L, RGB, P, RGBA)
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


def read_png_mode(data: bytes, name: str = "<png>") -> Tuple[np.ndarray, str]:
    """A PNG's pixels and Pillow's mode for them: (H, W) uint8 "L", (H, W,
    3) "RGB", (H, W, 4) "RGBA", (H, W) uint16 "I;16", or (H, W) uint8
    palette indices "P". Raises ValueError, naming `name`, on anything
    else (16-bit colour, interlaced, a broken CRC or stream)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat, has_plte = 8, None, [], False
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
        elif kind == b"PLTE":
            has_plte = True
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    ok = ((ctype in (2, 6) and depth == 8) or (ctype == 0 and depth in (8, 16))
          or (ctype == 3 and depth in (1, 2, 4, 8) and has_plte))
    if not ok or interlace != 0:
        raise ValueError(f"{name}: PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}: this reader takes 8-bit greyscale / RGB / RGBA, "
                         "16-bit greyscale and palette images, non-interlaced")
    ch = _CHANNELS[ctype]
    bpp = ch * max(depth // 8, 1)  # bytes a filter steps back
    rowbytes = (w * ch * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (rowbytes + 1):
        raise ValueError(f"{name}: image data too short")
    raw = raw[:h * (rowbytes + 1)]
    from ..native import native_available, png_unfilter

    try:
        rows = (png_unfilter(raw, h, rowbytes, bpp) if native_available()
                else _unfilter_numpy(np.frombuffer(raw, np.uint8), h, rowbytes, bpp))
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w), "I;16"
    if depth < 8:  # packed palette indices, most significant bits first
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (bits * weights).sum(axis=2).astype(np.uint8)
    mode = {0: "L", 2: "RGB", 3: "P", 6: "RGBA"}[ctype]
    return (rows.reshape(h, w) if ch == 1 else rows.reshape(h, w, ch)), mode


def read_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """A PNG's pixels: (H, W) for greyscale, (H, W, 3) RGB, (H, W, 4) RGBA,
    uint8. Raises ValueError, naming `name`, on anything else (palette,
    16-bit, interlaced, a broken CRC or stream): read_png_mode reads the
    palette and 16-bit images of the DiVAE transforms."""
    pixels, mode = read_png_mode(data, name)
    if mode not in ("L", "RGB", "RGBA"):
        raise ValueError(f"{name}: a {mode} PNG; read_png takes 8-bit greyscale / RGB / RGBA "
                         "(read_png_mode reads it)")
    return pixels


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


def write_png(arr: np.ndarray, filters: Sequence[int] = (0,), level: int = 6,
              palette: Optional[np.ndarray] = None) -> bytes:
    """A uint8 (H, W), (H, W, 3) or (H, W, 4) array, or a uint16 (H, W) one
    (16-bit greyscale, Pillow's I;16), as PNG bytes, row r filtered by
    filters[r % len(filters)] (each of 0..4). With `palette` ((n, 3) uint8,
    n <= 256), a uint8 (H, W) array is written as 8-bit palette indices."""
    arr = np.ascontiguousarray(arr)
    deep = arr.dtype == np.uint16 and arr.ndim == 2 and palette is None
    if not deep and (arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and (arr.shape[2] not in (3, 4) or palette is not None))):
        raise ValueError(f"write_png takes uint8 (H, W[, 3 | 4]) or uint16 (H, W), got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    ft = np.resize(np.asarray(list(filters), np.int64), h)
    if ft.min() < 0 or ft.max() > 4:
        raise ValueError(f"PNG filter types are 0..4, got {sorted(set(ft.tolist()))}")
    rows = arr.astype(">u2").view(np.uint8) if deep else arr
    bpp = 2 if deep else ch
    body = _filtered(rows.reshape(h, -1).astype(np.int16), ft, bpp)
    raw = np.concatenate([ft.astype(np.uint8)[:, None], body], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ctype = 3 if palette is not None else {1: 0, 3: 2, 4: 6}[ch]
    head = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16 if deep else 8, ctype, 0, 0, 0))
    if palette is not None:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)
        if not 1 <= len(pal) <= 256:
            raise ValueError(f"a PNG palette holds 1..256 colours, got {len(pal)}")
        head += chunk(b"PLTE", pal.tobytes())
    return (PNG_SIGNATURE + head + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def decode_image(data: bytes, name: str = "<image>") -> np.ndarray:
    """A PNG or JPEG file's pixels as Pillow opens them, as L, RGB or RGBA."""
    return decode_image_mode(data, name, ("L", "RGB", "RGBA"))[0]


def decode_image_mode(data: bytes, name: str = "<image>",
                      modes=("L", "RGB", "RGBA", "I;16", "P")) -> Tuple[np.ndarray, str]:
    """An image file's pixels and Pillow's mode for them: a PNG by
    read_png_mode (a mode outside `modes` raises, naming the file); a JPEG
    (SOI FF D8) by native.decode_jpeg, in its mode (L or RGB) when it is one
    of `modes`, else converted to RGB. Any other format raises ValueError
    naming the file."""
    if data[:8] == PNG_SIGNATURE:
        pixels, mode = read_png_mode(data, name)
        if mode not in modes:
            raise ValueError(f"{name}: a {mode} PNG; this reader takes {', '.join(modes)}")
        return pixels, mode
    if data[:2] == b"\xff\xd8":
        from ..native import decode_jpeg

        pixels, mode = decode_jpeg(data, name)
        if mode not in modes:
            pixels, mode = to_rgb(pixels), "RGB"
        return pixels, mode
    raise ValueError(f"{name}: not a PNG or JPEG file (starts with {data[:8]!r}); "
                     "the port decodes these two formats")


def read_rgb(path: str) -> np.ndarray:
    """Image.open(path).convert("RGB")'s pixels: a PNG or JPEG file as
    (H, W, 3) uint8."""
    with open(path, "rb") as f:
        return to_rgb(decode_image(f.read(), path))


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
def _coeffs_double(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resample.c:precompute_coeffs with in0 = 0, in1 = in_size: (xmin (out,),
    xmax (out,), normalised double coefficients (out, ksize)). The same
    double operations in the same order, over every output position at once
    (the weights summed tap by tap, as the C loop)."""
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
    return xmins, xmaxs, kk


@functools.lru_cache(maxsize=256)
def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """_coeffs_double's coefficients as normalize_coeffs_8bpc rounds them to
    PRECISION_BITS fractional bits (int64)."""
    xmins, xmaxs, kk = _coeffs_double(in_size, out_size)
    scaled = kk * (1 << PRECISION_BITS)
    ints = np.where(kk < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmins, xmaxs, ints


def _pass16(img: np.ndarray, axis: int, xmins, xmaxs, k) -> np.ndarray:
    """One 16bpc pass (Resample.c:ImagingResample{Horizontal,Vertical}_16bpc)
    of a uint16 image along `axis`: each output sums its taps times the
    double coefficients in tap order, rounds half away from zero
    (ROUND_UP), and stores the low byte CLIP8(v % 256) and the high byte
    CLIP8(v >> 8) with C's signed arithmetic: a negative sum gives 0, one
    past 65535 keeps its low byte under a high byte of 255."""
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.float64)
    n_out, ksize = k.shape
    acc = np.zeros((n_out,) + src.shape[1:], np.float64)
    tail = (1,) * (src.ndim - 1)
    for t in range(ksize):
        valid = t < xmaxs
        if not valid.any():
            break
        idx = np.where(valid, xmins + t, 0)
        acc = np.where(valid.reshape((n_out,) + tail), acc + src[idx] * k[:, t].reshape(
            (n_out,) + tail), acc)
    v = np.trunc(np.where(acc >= 0.0, acc + 0.5, acc - 0.5)).astype(np.int64)
    low = np.clip(np.fmod(v, 256), 0, 255)
    high = np.clip(v >> 8, 0, 255)
    out = (high * 256 + low).astype(np.uint16)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def _nearest_sources(n_in: int, n_out: int, special: bool = False) -> np.ndarray:
    """The source index of each output pixel of Pillow's NEAREST resize
    (Geometry.c:ImagingScaleAffine): x0 = scale / 2, then scale added once
    per pixel in double, each position truncated (COORD). An I;16 image
    (`special`) goes through ImagingGenericTransform instead, which
    computes each position as scale * (x + 0.5)."""
    scale = n_in / n_out
    if special:
        return np.minimum((scale * (np.arange(n_out) + 0.5)).astype(np.int64), n_in - 1)
    steps = np.full(n_out, scale)
    steps[0] = scale * 0.5
    pos = np.add.accumulate(steps)
    return np.minimum(pos.astype(np.int64), n_in - 1)


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
    """Pillow's img.resize((width, height), resample): resample None is
    Pillow's default for L / RGB (uint8) and I;16 (uint16) images,
    BICUBIC; "nearest" is Pillow's NEAREST, for any image (Pillow's filter
    for P images). BILINEAR and the rest raise."""
    if resample not in (None, "bicubic", "nearest"):
        raise ValueError(f"resize: filter {resample!r} is not ported (bicubic, nearest)")
    tw, th = size
    h, w = img.shape[:2]
    if (tw, th) == (w, h):
        return img.copy()
    if resample == "nearest":
        special = img.dtype == np.uint16
        rows, cols = _nearest_sources(h, th, special), _nearest_sources(w, tw, special)
        return np.ascontiguousarray(img[rows][:, cols])
    deep = img.dtype == np.uint16
    if deep and img.ndim != 2:
        raise ValueError(f"resize: a uint16 image is I;16, (H, W); got {img.shape}")
    need_h, need_v = tw != w, th != h
    coeffs, run = (_coeffs_double, _pass16) if deep else (_coeffs, _pass)
    ymins, ymaxs, kv = coeffs(h, th)
    out = img
    if need_h:
        # only the rows the vertical pass reads (Resample.c:ImagingResampleInner)
        first, last = int(ymins[0]), int(ymins[-1] + ymaxs[-1])
        xmins, xmaxs, kh = coeffs(w, tw)
        out = run(img[first:last], 1, xmins, xmaxs, kh)
        ymins = ymins - first
    if need_v:
        out = run(out, 0, ymins, ymaxs, kv)
    return out
