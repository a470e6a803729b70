"""The DiVAE-training transforms of the port (fourm_torch/data/
transforms.py:divae_modality_transforms) and what they read
(fourm_torch/data/image_io.py) against Pillow 12.1.0, cv2 and the JAX
package's transforms, on the CPU.

  * PNG: 16-bit greyscale (Pillow's I;16) and palette images (bit depths 1,
    2, 4, 8) written by Pillow and by the port's writer, read equal to
    Pillow's pixels / indices;
  * resizing: NEAREST of L and P images and BICUBIC of I;16 images (values
    up to 65535, where Pillow's 16bpc pass clips bytes), with crops past
    the image, equal to Pillow's, byte for byte, on seeded sizes;
  * `fill_contour` equal to cv2.drawContours(..., thickness=cv2.FILLED),
    pixel for pixel, on seeded convex and concave polygons inside a 64 x 64
    mask;
  * each transform of divae_modality_transforms (rgb, depth, normal,
    mask_valid, semseg_coco, canny_edge, human_poses, sam_mask) against the
    JAX one on seeded files under the same crop and flip: load,
    preprocess, image_augment, postprocess, arrays equal (the SAM
    transform's instance draw fed the same seed); and one
    UnifiedDataTransform + RandomCropImageAugmenter batch of a folder
    dataset (the train CLI's reader) against JAX's with the generators
    seeded alike.
"""

import io
import random

import numpy as np
import pytest
from PIL import Image

from fourm_tpu.data import transforms as jt
from fourm_torch.data import image_io
from fourm_torch.data import transforms as tt

cv2 = pytest.importorskip("cv2")


def _crop_boxes(rng, h, w, n):
    for _ in range(n):
        top, left = int(rng.integers(-8, h // 2)), int(rng.integers(-8, w // 2))
        ch, cw = int(rng.integers(2, h + 8)), int(rng.integers(2, w + 8))
        yield (left, top, left + cw, top + ch), (int(rng.integers(1, 260)),
                                                 int(rng.integers(1, 260)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A seeded folder of one sample per DiVAE modality (and a second RGB
    sample), written by Pillow / numpy."""
    root = tmp_path_factory.mktemp("divae")
    rng = np.random.default_rng(0)
    h, w = 77, 101
    out = {}

    def save(name, img, **kw):
        path = root / name
        img.save(path, **kw)
        out[name.split(".")[0]] = str(path)

    depth = rng.integers(0, 65536, (h, w)).astype(np.uint16)
    depth[: h // 3] = 65535  # saturated rows: the 16bpc byte clip
    save("depth.png", Image.fromarray(depth))
    save("normal.png", Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)))
    save("rgb.png", Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)))
    save("canny_edge.png", Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)))
    mask = (rng.random((h, w)) < 0.7).astype(np.uint8) * 255
    save("mask_valid.png", Image.fromarray(mask))
    sem = Image.fromarray(rng.integers(0, 134, (h, w)).astype(np.uint8), mode="P")
    sem.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
    save("semseg_coco.png", sem)
    poses = {"pred_smpl_params": {"body_pose": [rng.normal(size=(23, 9)).tolist()]}}
    (root / "human_poses.json").write_text(__import__("json").dumps(poses))
    out["human_poses"] = str(root / "human_poses.json")
    sam = []
    for _ in range(4):  # polygons, some crossing the image border
        n = int(rng.integers(5, 12))
        ang = np.sort(rng.random(n) * 2 * np.pi)
        r = rng.random(n) * 40 + 5
        cx, cy = rng.integers(0, w), rng.integers(0, h)
        pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1).astype(np.int32)
        sam.append({"points": pts[:, None]})
    np.save(root / "sam_mask.npy", np.array(sam, dtype=object), allow_pickle=True)
    out["sam_mask"] = str(root / "sam_mask.npy")
    return out


def test_png_modes_equal_pillow():
    rng = np.random.default_rng(1)
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(1, 50, 2))
        deep = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        buf = io.BytesIO()
        Image.fromarray(deep).save(buf, format="PNG")
        px, mode = image_io.read_png_mode(buf.getvalue())
        assert mode == "I;16" and np.array_equal(px, deep)
        for ft in range(5):
            img = Image.open(io.BytesIO(image_io.write_png(deep, filters=(ft,))))
            assert img.mode == "I;16" and np.array_equal(np.asarray(img), deep)
        idx = rng.integers(0, 256, (h, w)).astype(np.uint8)
        pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
        img = Image.open(io.BytesIO(image_io.write_png(idx, (1, 2, 3, 4), palette=pal)))
        assert img.mode == "P" and np.array_equal(np.asarray(img.convert("P")), idx)
        for bits in (1, 2, 4, 8):
            p = Image.fromarray((idx.astype(np.int64) % (1 << bits)).astype(np.uint8), mode="P")
            p.putpalette(pal[: 1 << bits].tobytes())
            buf = io.BytesIO()
            p.save(buf, format="PNG", bits=bits)
            px, mode = image_io.read_png_mode(buf.getvalue())
            ref = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("P"))
            assert mode == "P" and np.array_equal(px, ref), bits


@pytest.mark.parametrize("mode", ["L", "P", "I;16"])
def test_resize_modes_equal_pillow(mode):
    rng = np.random.default_rng({"L": 2, "P": 3, "I;16": 4}[mode])
    for _ in range(25):
        h, w = (int(v) for v in rng.integers(2, 200, 2))
        if mode == "I;16":
            arr = rng.integers(0, 65536, (h, w)).astype(np.uint16)
            arr[: h // 3] = np.where(rng.random((h // 3, w)) < 0.5, 65535, 0)
            filters = ((None, None), ("nearest", Image.NEAREST))
        else:
            arr = rng.integers(0, 256, (h, w)).astype(np.uint8)
            filters = (("nearest", Image.NEAREST),)
        img = Image.fromarray(arr) if mode != "P" else Image.fromarray(arr, mode="P")
        for box, size in _crop_boxes(rng, h, w, 2):
            for ours, theirs in filters:
                ref = np.asarray(img.crop(box).resize(size, resample=theirs))
                got = image_io.resize(image_io.crop(arr, box), size, resample=ours)
                assert got.dtype == ref.dtype and np.array_equal(got, ref), (h, w, box, size, ours)


def test_fill_contour_equals_cv2():
    rng = np.random.default_rng(5)
    S = 64
    for i in range(300):
        n = int(rng.integers(3, 24))
        ang = np.sort(rng.random(n) * 2 * np.pi)
        r = (rng.random() * 30 + 1) * (np.ones(n) if i % 2 == 0 else rng.random(n) + 0.2)
        c = np.stack([S / 2 + r * np.cos(ang), S / 2 + r * np.sin(ang)], 1)
        c = np.clip(c, 0, S - 1).astype(np.int32)[:, None]  # convex (even i) / concave
        ref = np.zeros((S, S), np.uint8)
        cv2.drawContours(ref, [c], 0, 255, thickness=cv2.FILLED)
        got = np.zeros((S, S), np.uint8)
        tt.fill_contour(got, c, 255)
        assert np.array_equal(got, ref), (i, c[:, 0].tolist())


@pytest.mark.parametrize("case", ["random", "named"])
def test_fill_contour_equals_cv2_past_the_border(case):
    """Integer polygons whose edges leave the image: 3000 of 3-8 vertices in
    [-8, 72) on 64 x 64 (seed 0), and one whose edges clip to a single
    border pixel, which cv2 fills as a vertical edge (column 63, rows 2-50)."""
    if case == "named":
        polys = [np.array([[68, 2], [67, 7], [63, 50]], np.int32)]
    else:
        rng = np.random.default_rng(0)
        polys = [rng.integers(-8, 72, size=(int(rng.integers(3, 9)), 2)).astype(np.int32)
                 for _ in range(3000)]
    for i, c in enumerate(polys):
        ref = np.zeros((64, 64), np.uint8)
        cv2.drawContours(ref, [c], 0, 255, thickness=cv2.FILLED)
        got = np.zeros((64, 64), np.uint8)
        tt.fill_contour(got, c, 255)
        assert np.array_equal(got, ref), (i, c.tolist())
    if case == "named":
        assert got[2:51, 63].all() and got.sum() == 49 * 255


def _jax_value(t, path):
    """What the JAX transform's load gives for this file (PIL image, json,
    array)."""
    return t.load(path)


CROPS = [((5, 9, 50, 61), False), ((-3, 20, 70, 90), True), ((0, 0, 77, 101), True)]


@pytest.mark.parametrize("key", ["rgb", "depth", "normal", "mask_valid", "semseg_coco",
                                 "canny_edge", "human_poses", "sam_mask"])
def test_divae_transform_equals_jax(files, key):
    jax_t = jt.divae_modality_transforms()[key]
    path = files[key]
    target = (32, 48) if key != "sam_mask" else (64, 64)
    for crop, flip in CROPS:
        np.random.seed(0)  # the JAX SAM transform's instance draw, and ours
        ours = tt.divae_modality_transforms(random.Random(0), np.random.RandomState(0))[key]
        a = jax_t.preprocess(_jax_value(jax_t, path))
        b = ours.preprocess(ours.load(path))
        if key == "human_poses":  # the JAX image_augment refuses the vector (ROADMAP)
            assert np.array_equal(a, b) and b.shape == (207,)
            assert ours.postprocess(ours.image_augment(b, crop, flip, (77, 101), target,
                                                       None)) is b
            continue
        a = jax_t.postprocess(jax_t.image_augment(a, crop, flip, (77, 101), target, None))
        b = ours.postprocess(ours.image_augment(b, crop, flip, (77, 101), target, None))
        if key == "sam_mask":
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k]), (k, crop, flip)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
            assert np.array_equal(a, b), (key, crop, flip)


def test_folder_batch_equals_jax(files, tmp_path):
    """A DiVAE-training batch of a folder (the train CLI's reader): root/
    {depth,semseg_coco}/c/{id}.png through UnifiedDataTransform and
    RandomCropImageAugmenter, with both packages' generators seeded alike."""
    from fourm_tpu.data.augmenters import RandomCropImageAugmenter as JAug
    from fourm_tpu.data.datasets import MultiModalDatasetFolder as JFolder
    from fourm_torch.data.augmenters import RandomCropImageAugmenter as TAug
    from fourm_torch.data.datasets import MultiModalDatasetFolder as TFolder

    rng = np.random.default_rng(7)
    for mod in ("depth", "semseg_coco"):
        (tmp_path / mod / "c").mkdir(parents=True)
    for i in range(3):
        h, w = (int(v) for v in rng.integers(40, 90, 2))
        Image.fromarray(rng.integers(0, 65536, (h, w)).astype(np.uint16)).save(
            tmp_path / "depth" / "c" / f"{i}.png")
        Image.fromarray(rng.integers(0, 200, (h, w)).astype(np.uint8)).convert("P").save(
            tmp_path / "semseg_coco" / "c" / f"{i}.png")
    mods = ["depth", "semseg_coco"]
    random.seed(3)
    np.random.seed(3)
    jtr = jt.divae_modality_transforms()
    jds = JFolder(str(tmp_path), mods, jtr,
                  transform=jt.UnifiedDataTransform(jtr, JAug(target_size=32,
                                                              main_domain="depth")))
    want = [jds[i] for i in range(3)]
    r, nr = random.Random(3), np.random.RandomState(3)
    ttr = tt.divae_modality_transforms(r, nr)
    tds = TFolder(str(tmp_path), mods, ttr,
                  transform=tt.UnifiedDataTransform(ttr, TAug(target_size=32, main_domain="depth",
                                                              rng=r, np_rng=nr)))
    got = [tds[i] for i in range(3)]
    for a, b in zip(want, got):
        for m in mods:
            assert a[m].dtype == b[m].dtype and np.array_equal(a[m], b[m]), m
