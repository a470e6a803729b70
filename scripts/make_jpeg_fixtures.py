"""Write the JPEG fixtures of the port's decoder tests with Pillow.

    python scripts/make_jpeg_fixtures.py [--out tests/jpeg_fixtures]

Each file is a seeded smooth image (low-frequency colour fields, bicubic
up-sampled, plus mild noise) saved by Pillow at ImageNet-like sizes (500 x
375, 375 x 500, 640 x 480, 320 x 240) and at odd ones, with the variants
the decoder must take: 4:4:4 / 4:2:2 / 4:2:0, qualities 30-95,
progressive, optimized tables, restart intervals in blocks and in rows,
and mode L. `fixtures.json` records each file's Pillow mode, shape and the
SHA-256 of the pixels Pillow decodes (np.asarray(Image.open(f)).tobytes()),
and the Pillow and libjpeg versions that wrote them. The `class` of each
file names its folder in the transfer data of scripts/chip_transfer.py.
Needs Pillow; the port itself never imports it.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os

import numpy as np

# name -> (height, width, mode, Pillow save options, class)
FIXTURES = {
    "c0_500x375_q90_420_a": (375, 500, "RGB", dict(quality=90, subsampling=2), "c0"),
    "c0_500x375_q90_420_b": (375, 500, "RGB", dict(quality=90, subsampling=2), "c0"),
    "c0_500x375_q90_420_c": (375, 500, "RGB", dict(quality=90, subsampling=2), "c0"),
    "c0_500x375_q90_420_d": (375, 500, "RGB", dict(quality=90, subsampling=2), "c0"),
    "c1_375x500_q90_420_a": (500, 375, "RGB", dict(quality=90, subsampling=2), "c1"),
    "c1_375x500_q90_420_b": (500, 375, "RGB", dict(quality=90, subsampling=2), "c1"),
    "c1_640x480_q85_422": (480, 640, "RGB", dict(quality=85, subsampling=1), "c1"),
    "c1_320x240_q95_444": (240, 320, "RGB", dict(quality=95, subsampling=0), "c1"),
    "c2_500x375_q75_progressive": (375, 500, "RGB", dict(quality=75, progressive=True), "c2"),
    "c2_500x375_q75_optimize": (375, 500, "RGB", dict(quality=75, optimize=True), "c2"),
    "c2_500x375_q75_rst_blocks": (375, 500, "RGB",
                                  dict(quality=75, restart_marker_blocks=5), "c2"),
    "c2_375x500_q75_rst_rows": (500, 375, "RGB", dict(quality=75, restart_marker_rows=1), "c2"),
    "c3_320x240_q30_420": (240, 320, "RGB", dict(quality=30, subsampling=2), "c3"),
    "c3_320x240_q75_progressive_444": (240, 320, "RGB",
                                       dict(quality=75, subsampling=0, progressive=True), "c3"),
    "c3_320x240_q75_progressive_rst": (240, 320, "RGB", dict(
        quality=75, progressive=True, restart_marker_blocks=3), "c3"),
    "c3_320x240_q90_L": (240, 320, "L", dict(quality=90), "c3"),
    "odd_1x1_q75_420": (1, 1, "RGB", dict(quality=75, subsampling=2), None),
    "odd_7x13_q95_420": (13, 7, "RGB", dict(quality=95, subsampling=2), None),
    "odd_17x9_q75_422": (9, 17, "RGB", dict(quality=75, subsampling=1), None),
    "odd_17x9_q30_progressive": (9, 17, "RGB", dict(quality=30, progressive=True), None),
    "odd_3x5_q95_420": (5, 3, "RGB", dict(quality=95, subsampling=2), None),
    "odd_33x17_L_progressive": (17, 33, "L", dict(quality=75, progressive=True), None),
    "odd_97x61_q75_optimize_rst": (61, 97, "RGB", dict(
        quality=75, optimize=True, restart_marker_rows=2), None),
    "odd_13x7_L_q30": (7, 13, "L", dict(quality=30), None),
}


def smooth_image(seed: int, h: int, w: int, channels: int) -> np.ndarray:
    """Low-frequency colour fields bicubic-upsampled to (h, w), plus
    Gaussian noise of std 3, as uint8."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    gh, gw = max(h // 40, 2), max(w // 40, 2)
    planes = []
    for _ in range(channels):
        base = (rng.random((gh, gw)) * 255).astype(np.uint8)
        planes.append(np.asarray(Image.fromarray(base).resize((w, h), Image.BICUBIC),
                                 np.float64))
    img = np.stack(planes, -1) + rng.normal(0, 3, (h, w, channels))
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def main():
    from PIL import Image, features

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "..", "tests",
                                                  "jpeg_fixtures"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    meta = {"pillow": Image.__version__, "libjpeg": features.version("jpg"), "files": {}}
    for seed, (name, (h, w, mode, opts, cls)) in enumerate(sorted(FIXTURES.items())):
        arr = smooth_image(seed, h, w, 1 if mode == "L" else 3)
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "JPEG", **opts)
        data = buf.getvalue()
        with open(os.path.join(args.out, name + ".jpg"), "wb") as f:
            f.write(data)
        img = Image.open(io.BytesIO(data))
        pixels = np.asarray(img)
        meta["files"][name + ".jpg"] = {
            "mode": img.mode, "shape": list(pixels.shape), "class": cls,
            "sha256": hashlib.sha256(pixels.tobytes()).hexdigest(), "options": opts}
    with open(os.path.join(args.out, "fixtures.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(args.out, n)) for n in os.listdir(args.out))
    print(f"{len(FIXTURES)} fixtures, {total} bytes in {args.out}")


if __name__ == "__main__":
    main()
