"""The port's cv2- and Pillow-free drawing (fourm_torch/utils/drawing.py)
against cv2 5.0.0 and Pillow 12.1.0, pixel for pixel, on seeded cases whose
shapes leave the image as often as not: cv_line at thickness 1, 2 and 3,
cv_circle filled and outlined (radius 0-7), cv_rectangle (thickness 1) and
pil_rectangle (widths 1-3, float corners); and draw_text's glyphs."""

import _torch_threads  # noqa: F401  (torch's threads in xdist workers)
import numpy as np
import pytest

from fourm_torch.utils import drawing as dr

cv2 = pytest.importorskip("cv2")
H, W = 40, 50


def _cases(kind, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        colour = tuple(int(c) for c in rng.integers(1, 256, 3))
        if kind == "circle":
            yield (tuple(int(v) for v in rng.integers(-5, 55, 2)), int(rng.integers(0, 8)),
                   colour)
        else:
            yield (tuple(int(v) for v in rng.integers(-15, 65, 2)),
                   tuple(int(v) for v in rng.integers(-15, 65, 2)), colour)


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_line_equals_cv2(thickness):
    for p0, p1, colour in _cases("line", 400, thickness):
        ref = np.zeros((H, W, 3), np.uint8)
        cv2.line(ref, p0, p1, colour, thickness)
        got = dr.cv_line(np.zeros((H, W, 3), np.uint8), p0, p1, colour, thickness)
        assert np.array_equal(got, ref), (p0, p1, thickness)


@pytest.mark.parametrize("thickness", [-1, 1])
def test_circle_equals_cv2(thickness):
    for c, r, colour in _cases("circle", 300, 10 + thickness):
        ref = np.zeros((H, W, 3), np.uint8)
        cv2.circle(ref, c, r, colour, thickness)
        got = dr.cv_circle(np.zeros((H, W, 3), np.uint8), c, r, colour, thickness)
        assert np.array_equal(got, ref), (c, r, thickness)
    with pytest.raises(NotImplementedError):
        dr.cv_circle(np.zeros((4, 4), np.uint8), (1, 1), 1, 255, 2)


def test_rectangle_equals_cv2_and_pillow():
    for p0, p1, colour in _cases("rect", 300, 21):
        ref = np.zeros((H, W, 3), np.uint8)
        cv2.rectangle(ref, p0, p1, colour, 1)
        got = dr.cv_rectangle(np.zeros((H, W, 3), np.uint8), p0, p1, colour, 1)
        assert np.array_equal(got, ref), (p0, p1)
    Image = pytest.importorskip("PIL.Image")
    ImageDraw = pytest.importorskip("PIL.ImageDraw")
    rng = np.random.default_rng(22)
    for _ in range(400):
        x0, x1 = sorted(rng.uniform(-10, 60, 2))
        y0, y1 = sorted(rng.uniform(-10, 50, 2))
        width = int(rng.integers(1, 4))
        colour = tuple(int(c) for c in rng.integers(1, 256, 3))
        pil = Image.fromarray(np.zeros((H, W, 3), np.uint8))
        ImageDraw.Draw(pil).rectangle([x0, y0, x1, y1], outline=colour, width=width)
        got = dr.pil_rectangle(np.zeros((H, W, 3), np.uint8), (x0, y0, x1, y1), colour, width)
        assert np.array_equal(got, np.asarray(pil)), (x0, y0, x1, y1, width)


def test_draw_text_glyphs():
    img = dr.draw_text(np.zeros((7, 20), np.uint8), (1, 1), "Cat 7", 255)
    assert img[1:6, 1:4].sum() == 255 * dr._FONT["c"].count("1")
    assert img[1:6, 17:20].sum() == 255 * dr._FONT["7"].count("1")
    assert not img[0].any() and not img[6].any() and not img[:, 13:17].any()  # the space
    clipped = dr.draw_text(np.zeros((3, 3), np.uint8), (-1, -2), "%", 9)
    assert set(np.unique(clipped)) <= {0, 9}
