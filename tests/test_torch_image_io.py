"""The port's image decoding and resampling (fourm_torch/data/image_io.py)
against Pillow, byte for byte, on the CPU, and the RGB transform against
the JAX package's.

  * PNG: greyscale, RGB and RGBA images of random sizes written by Pillow
    (its adaptive row filters) and by the port's writer with each of the
    five filters, read equal to Pillow's pixels, by the native row
    reconstruction and by the numpy one; a palette or 16-bit PNG, a broken
    CRC, and a file neither PNG nor JPEG raise, naming the file; a JPEG
    decodes with Pillow hidden (tests/test_torch_jpeg.py holds the decoder).
  * crop + resize + flip: Pillow's crop (boxes reaching past the image),
    resize with resample=None (BICUBIC for RGB and L) and NEAREST, and the
    FLIP_LEFT_RIGHT transpose, over random sizes, crops and target sizes,
    up and down; BILINEAR raises.
  * RGBTransform: the port's preprocess / image_augment / postprocess of a
    PNG equal the JAX transform's of the same file through PIL.
"""

import io
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from fourm_tpu.data import transforms as jt
from fourm_torch.data import image_io
from fourm_torch.data import transforms as tt
from fourm_torch.native import native_available

SIZES = [(1, 1), (3, 7), (17, 5), (64, 64), (120, 97), (233, 301)]


def _image(rng, h, w, mode):
    shape = (h, w) if mode == "L" else (h, w, len(mode))
    arr = rng.integers(0, 256, shape).astype(np.uint8)
    if h > 2:  # smooth half the rows so that the filters have runs to predict
        arr[: h // 2] = np.cumsum(arr[: h // 2].astype(np.int64), axis=0).astype(np.uint8)
    return arr


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_reads_equal_pillow(mode):
    rng = np.random.default_rng(1)
    for h, w in SIZES:
        arr = _image(rng, h, w, mode)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        files = [buf.getvalue()] + [image_io.write_png(arr, filters=(f, (f + 2) % 5))
                                    for f in range(5)]
        for data in files:
            ref = np.asarray(Image.open(io.BytesIO(data)))
            assert np.array_equal(image_io.read_png(data), ref), (h, w)
            assert np.array_equal(image_io.to_rgb(image_io.read_png(data)),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
        # the numpy row reconstruction, the fallback without the native library
        raw = zlib.decompress(files[1][41:-16])  # the one IDAT of write_png
        ch = 1 if mode == "L" else len(mode)
        rows = image_io._unfilter_numpy(np.frombuffer(raw, np.uint8), h, w * ch, ch)
        assert np.array_equal(rows.reshape(arr.shape), arr)
    assert native_available()


def test_png_refusals_name_the_file(monkeypatch):
    pal = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(pal, format="PNG")
    deep = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(deep, format="PNG")
    for data in (pal.getvalue(), deep.getvalue()):
        with pytest.raises(ValueError, match="shard-7"):
            image_io.read_png(data, "shard-7")
    good = bytearray(image_io.write_png(np.zeros((4, 4, 3), np.uint8)))
    good[40] ^= 1  # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_png(bytes(good), "x.png")
    jpg = io.BytesIO()
    Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).save(jpg, format="JPEG")
    want = np.asarray(Image.open(io.BytesIO(jpg.getvalue())))
    # JPEG needs no Pillow (the port's decoder); other formats raise, naming the file
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert np.array_equal(image_io.decode_image(jpg.getvalue(), "a.jpg"), want)
    gif = b"GIF89a" + bytes(20)
    with pytest.raises(ValueError, match="a.gif: not a PNG or JPEG"):
        image_io.decode_image(gif, "a.gif")


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_crop_resize_flip_equal_pillow(mode):
    rng = np.random.default_rng(2 if mode == "RGB" else 3)
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(8, 360, 2))
        arr = _image(rng, h, w, mode)
        img = Image.fromarray(arr)
        top, left = int(rng.integers(-8, h // 2)), int(rng.integers(-8, w // 2))
        ch, cw = int(rng.integers(2, h + 8)), int(rng.integers(2, w + 8))
        size = (int(rng.integers(1, 300)), int(rng.integers(1, 300)))
        box = (left, top, left + cw, top + ch)
        for ours, theirs in ((None, None), ("bicubic", Image.BICUBIC),
                             ("nearest", Image.NEAREST)):
            ref = np.asarray(img.crop(box).resize(size, resample=theirs))
            got = image_io.resize(image_io.crop(arr, box), size, resample=ours)
            assert np.array_equal(got, ref), (h, w, box, size, ours)
        assert np.array_equal(image_io.hflip(arr),
                              np.asarray(img.transpose(Image.FLIP_LEFT_RIGHT)))
    with pytest.raises(ValueError, match="bilinear"):
        image_io.resize(arr, (3, 3), "bilinear")


def test_rgb_transform_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    arr = _image(rng, 250, 290, "RGB")
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(image_io.write_png(arr, filters=range(5)))
    ours, ref = tt.RGBTransform(), jt.RGBTransform()
    a, b = ours.preprocess(ours.load(path)), ref.preprocess(ref.load(path))
    for crop, flip in (((10, 20, 200, 230), True), ((0, 0, 250, 290), False),
                       ((40, 3, 100, 90), True)):
        x = ours.postprocess(ours.image_augment(a, crop, flip, (250, 290), (224, 224), 0))
        y = ref.postprocess(ref.image_augment(b, crop, flip, (250, 290), (224, 224), 0))
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y), crop
    # the colour jitter (transforms.py:190-201): the JAX transform draws from
    # the global `random`, the port's from its own generator, seeded alike
    import random

    for seed in range(12):
        for strength in (0.5, 1.0):
            random.seed(seed)
            ref = jt.RGBTransform(color_jitter=True, color_jitter_strength=strength)
            ours = tt.RGBTransform(color_jitter=True, color_jitter_strength=strength,
                                   rng=random.Random(seed))
            for _ in range(3):
                got, want = ours.preprocess(a), np.asarray(ref.preprocess(ref.load(path)))
                assert got.dtype == np.uint8 and np.array_equal(got, want), (seed, strength)


def test_image_enhance_equals_pillow():
    """Pillow's ImageEnhance.Brightness / Contrast / Color and
    ImageOps.grayscale(...).convert("RGB"), byte for byte, on random images
    (smooth and noisy, flat ones too) and factors in [0, 2]."""
    from PIL import ImageEnhance, ImageOps

    from fourm_torch.data import image_enhance as ie

    rng = np.random.default_rng(9)
    ops = {"brightness": ImageEnhance.Brightness, "contrast": ImageEnhance.Contrast,
           "color": ImageEnhance.Color}
    for i in range(60):
        h, w = (int(v) for v in rng.integers(1, 48, size=2))
        arr = _image(rng, h, w, "RGB") if i % 4 else np.full((h, w, 3), rng.integers(256),
                                                               np.uint8)
        pil = Image.fromarray(arr)
        factors = [0.0, 0.5, 1.0, 2.0] if i < 4 else rng.uniform(0.0, 2.0, size=3)
        for f in factors:
            for name, enhancer in ops.items():
                want = np.asarray(enhancer(pil).enhance(float(f)))
                assert np.array_equal(getattr(ie, name)(arr, float(f)), want), (name, f)
        assert np.array_equal(ie.grayscale_rgb(arr),
                              np.asarray(ImageOps.grayscale(pil).convert("RGB")))
