"""The port's numpy counterparts of OpenCV's linear resize, 5×5 Gaussian
blur and constant border (``data/raster.py``) against the installed
OpenCV, bit for bit: uint8 BGR crops and float64 maps of 10-200 px to
80² and 1000² and to other sizes, up and down, exact halvings and an
unchanged size; and the emulated fused multiply-add against exact
rational arithmetic. Tolerance: none (bit-equal)."""

from fractions import Fraction

import cv2
import numpy as np
import pytest

from mit_driverless_cv_traininginfra_tpu_torch.data import raster

SIDES = [10, 11, 13, 37, 64, 79, 80, 81, 100, 159, 160, 161, 200]


def _pairs():
    rng = np.random.default_rng(0)
    return [(int(h), int(w)) for h, w in zip(SIDES + list(rng.integers(10, 201, 13)),
                                              SIDES[::-1] + list(rng.integers(10, 201, 13)))]


@pytest.mark.parametrize("h,w", _pairs())
def test_resize_linear_uint8_equals_cv2(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    sizes = [(80, 80), (33, 47), (w, 80), (80, h), (w // 2, h // 2), (w, h), (2 * w, 3 * h)]
    for size in sizes:
        assert np.array_equal(raster.resize_linear(img, size), cv2.resize(img, size)), size
    grey = img[..., 0].copy()
    assert np.array_equal(raster.resize_linear(grey, (80, 80)), cv2.resize(grey, (80, 80)))


@pytest.mark.parametrize("h,w", [(37, 81), (200, 13), (160, 160), (10, 10)])
def test_resize_linear_uint8_to_the_dataset_render_size(h, w):
    img = np.random.default_rng(w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    assert np.array_equal(raster.resize_linear(img, (1000, 1000)), cv2.resize(img, (1000, 1000)))


@pytest.mark.parametrize("h,w", _pairs())
def test_resize_linear_f64_and_blur_equal_cv2(h, w):
    rng = np.random.default_rng(h * 7 + w)
    dense = rng.random((h, w))
    one_hot = np.zeros((h, w))
    one_hot[rng.integers(h), rng.integers(w)] = 1.0
    for m in (dense, one_hot):
        for size in [(80, 80), (33, 47), (w // 2, h // 2), (w, h), (2 * w, h)]:
            assert np.array_equal(raster.resize_linear(m, size), cv2.resize(m, size)), size
        assert np.array_equal(raster.gaussian_blur_5x5_f64(m), cv2.GaussianBlur(m, (5, 5), 0))
    r = raster.resize_linear(one_hot, (80, 80))
    assert np.array_equal(raster.gaussian_blur_5x5_f64(r), cv2.GaussianBlur(r, (5, 5), 0))


@pytest.mark.parametrize("w", range(3, 12))
def test_blur_every_width_residue(w):
    """The row pass fuses over 4·⌊W/4⌋ columns: every residue of W mod 4,
    and the smallest maps reflect-101 allows."""
    m = np.random.default_rng(w).random((w + 2, w))
    assert np.array_equal(raster.gaussian_blur_5x5_f64(m), cv2.GaussianBlur(m, (5, 5), 0))


def test_copy_make_border_constant_equals_cv2():
    img = np.random.default_rng(3).integers(0, 256, (30, 50, 3), dtype=np.uint8)
    for pads in [(0, 20, 0, 0), (0, 0, 0, 20), (1, 2, 3, 4)]:
        assert np.array_equal(raster.copy_make_border_constant(img, *pads, [128, 128, 128]),
                              cv2.copyMakeBorder(img, *pads, cv2.BORDER_CONSTANT,
                                                 value=[128, 128, 128]))


def test_fma_is_correctly_rounded():
    rng = np.random.default_rng(0)
    n = 3000
    a = rng.random(n) * 10.0 ** rng.integers(-3, 3, n)
    b = rng.random(n)
    cases = [(a, b, -rng.random(n) * 10.0 ** rng.integers(-3, 3, n)),
             # near-cancellation: c ≈ −a·b
             (a, b, -a * b * (1 + rng.integers(-3, 4, n) * 2.0 ** -52)),
             (a, np.full(n, 0.375), rng.random(n))]
    for x, y, z in cases:
        got = raster.fma(x, y, z)
        want = [float(Fraction(float(p)) * Fraction(float(q)) + Fraction(float(r)))
                for p, q, r in zip(x, y, z)]
        assert np.array_equal(got, np.asarray(want))
