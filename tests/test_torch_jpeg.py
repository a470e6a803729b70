"""The port's JPEG decoder (fourm_torch/native/jpeg_decode.cpp, bound as
fourm_torch.native.decode_jpeg) against Pillow 12.1.0 (libjpeg-turbo,
features.version('jpg') 6.2), byte for byte: JPEGs that Pillow writes here
from seeded arrays at odd sizes (1 x 1, 7 x 13, 17 x 9, ...), 4:4:4 / 4:2:2
/ 4:2:0, qualities 30 / 75 / 95, progressive, optimized tables, restart
intervals in blocks and in rows, and mode L; the committed fixtures
(tests/jpeg_fixtures, scripts/make_jpeg_fixtures.py) against the SHA-256 of
Pillow's pixels recorded beside them; a truncated file, a CMYK file and a
non-image raise and name the file; and the readers that route through it
(data/image_io.py:decode_image_mode, read_rgb, ImageCaptionDataset) give
Image.open(...)'s and .convert("RGB")'s pixels."""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest

from fourm_torch.data import image_io
from fourm_torch.data.generation_datasets import ImageCaptionDataset
from fourm_torch.native import decode_jpeg

Image = pytest.importorskip("PIL.Image")
FIXTURES = Path(__file__).parent / "jpeg_fixtures"
SIZES = [(1, 1), (13, 7), (9, 17), (5, 3), (16, 16), (24, 40), (61, 97)]  # (H, W)
VARIANTS = {
    "baseline": {}, "progressive": dict(progressive=True), "optimize": dict(optimize=True),
    "rst_blocks": dict(restart_marker_blocks=2), "rst_rows": dict(restart_marker_rows=1),
    "progressive_rst": dict(progressive=True, restart_marker_blocks=3),
}


def _image(seed, h, w, channels):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([127 + 100 * np.sin(xx / (3 + 5 * c) + yy / (4 + 3 * c) + c)
                     for c in range(channels)], -1)
    img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _jpeg(arr, **opts):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _same_as_pillow(data, name="case"):
    ref = Image.open(io.BytesIO(data))
    got, mode = decode_jpeg(data, name)
    assert mode == ref.mode and got.dtype == np.uint8
    assert np.array_equal(got, np.asarray(ref)), name


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rgb_equals_pillow(subsampling, variant):
    for i, (h, w) in enumerate(SIZES):
        arr = _image(i, h, w, 3)
        for q in (30, 75, 95):
            _same_as_pillow(_jpeg(arr, quality=q, subsampling=subsampling, **VARIANTS[variant]),
                            f"{h}x{w} q{q} {subsampling} {variant}")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_grey_equals_pillow(variant):
    for i, (h, w) in enumerate(SIZES):
        for q in (30, 75, 95):
            _same_as_pillow(_jpeg(_image(i, h, w, 1), quality=q, **VARIANTS[variant]),
                            f"L {h}x{w} q{q} {variant}")


def test_fixtures_equal_their_recorded_hashes():
    meta = json.loads((FIXTURES / "fixtures.json").read_text())
    assert meta["pillow"] == "12.1.0" and len(meta["files"]) >= 20
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1_500_000
    for name, rec in meta["files"].items():
        data = (FIXTURES / name).read_bytes()
        got, mode = decode_jpeg(data, name)
        assert mode == rec["mode"] and list(got.shape) == rec["shape"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"], name
        assert np.array_equal(got, np.asarray(Image.open(io.BytesIO(data)))), name


@pytest.mark.parametrize("cut", ["half", "no_eoi", "header", "progressive_half"])
def test_truncated_file_raises_naming_it(cut):
    data = (FIXTURES / ("c2_500x375_q75_progressive.jpg" if cut.startswith("progressive")
                        else "c0_500x375_q90_420_a.jpg")).read_bytes()
    part = {"half": data[:len(data) // 2], "no_eoi": data[:-2], "header": data[:100],
            "progressive_half": data[:len(data) // 2]}[cut]
    with pytest.raises(OSError, match="(?i)truncated"):  # what Pillow's load raises
        Image.open(io.BytesIO(part)).load()
    with pytest.raises(ValueError, match=r"cut\.jpg: truncated file"):
        decode_jpeg(part, "cut.jpg")


def test_unsupported_files_raise_naming_them():
    arr = _image(0, 16, 16, 3)
    with pytest.raises(ValueError, match=r"cmyk\.jpg: four components \(CMYK / YCCK\)"):
        buf = io.BytesIO()
        Image.fromarray(arr).convert("CMYK").save(buf, "JPEG")
        decode_jpeg(buf.getvalue(), "cmyk.jpg")
    with pytest.raises(ValueError, match=r"notes\.txt: not a JPEG"):
        decode_jpeg(b"plain text, not an image", "notes.txt")
    with pytest.raises(ValueError, match=r"notes\.txt: not a PNG or JPEG"):
        image_io.decode_image(b"plain text, not an image", "notes.txt")
    # a 12-bit and an arithmetic-coded frame: the SOF marker names the feature
    data = bytearray(_jpeg(arr))
    sof = data.index(b"\xff\xc0")
    twelve = bytes(data[:sof + 4]) + b"\x0c" + bytes(data[sof + 5:])
    with pytest.raises(ValueError, match=r"a\.jpg: 12-bit samples"):
        decode_jpeg(twelve, "a.jpg")
    arith = bytes(data[:sof + 1]) + b"\xc9" + bytes(data[sof + 2:])
    with pytest.raises(ValueError, match=r"b\.jpg: arithmetic coding"):
        decode_jpeg(arith, "b.jpg")


def test_dc_huffman_symbol_above_15_raises_naming_it():
    """A DC symbol is a bit count of at most 15: libjpeg-turbo refuses a DC
    table holding 16 (jdhuff.c jpeg_make_d_derived_tbl), and so does the port."""
    data = bytearray(_jpeg(_image(5, 16, 16, 3)))
    at = 2
    while data[at + 1] != 0xC4 or data[at + 4] >> 4 != 0:  # the first DC table's DHT
        at += 2 + int.from_bytes(data[at + 2:at + 4], "big")
    data[at + 5 + 16] = 16  # its first symbol
    bad = bytes(data)
    with pytest.raises(OSError):
        Image.open(io.BytesIO(bad)).load()
    with pytest.raises(ValueError, match=r"dc\.jpg: bad Huffman table"):
        decode_jpeg(bad, "dc.jpg")


def test_readers_route_jpeg_through_the_decoder(tmp_path):
    grey = _jpeg(_image(3, 20, 30, 1), quality=80)
    colour = _jpeg(_image(4, 20, 30, 3), quality=80)
    px, mode = image_io.decode_image_mode(grey, "g.jpg")
    assert mode == "L" and np.array_equal(px, np.asarray(Image.open(io.BytesIO(grey))))
    px, mode = image_io.decode_image_mode(grey, "g.jpg", modes=("RGB",))
    assert mode == "RGB" and np.array_equal(
        px, np.asarray(Image.open(io.BytesIO(grey)).convert("RGB")))
    (tmp_path / "images").mkdir()
    (tmp_path / "captions").mkdir()
    for stem, data in (("a", grey), ("b", colour)):
        (tmp_path / "images" / f"{stem}.jpg").write_bytes(data)
        (tmp_path / "captions" / f"{stem}.txt").write_text(f"caption {stem}\n")
    ds = ImageCaptionDataset(str(tmp_path))
    for i, stem in enumerate("ab"):
        img, cap = ds[i]
        ref = Image.open(tmp_path / "images" / f"{stem}.jpg").convert("RGB")
        assert cap == f"caption {stem}" and np.array_equal(img, np.asarray(ref))
