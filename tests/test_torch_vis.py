"""``utils/vis.py`` and ``utils/draw.py`` against the JAX package's
``utils/vis.py`` (OpenCV and PIL), on the same arrays: every render as
drawn, before either package encodes it (the port's JPEGs are its own
encoder's, ``tests/test_torch_encode.py``).

Tolerances: bit-equal for filled dots (``cv2.circle``), rectangles
(``cv2.rectangle`` 2 px, ``ImageDraw.rectangle`` 1 and 2 px), PIL's
ellipse dots and the heatmap renders. ``cv2.line`` of thickness 2 (the
``--vis_upload_data`` keypoint chain): at most 1% of the pixels OpenCV
draws may differ — OpenCV clips each polygon edge at the image border
before walking it, the port bounds-checks each pixel (over 500 random
lines on a 200² image 50 of 165782 drawn pixels differed, in 5 lines)."""

import contextlib
import io

import cv2
import numpy as np
import pytest
from PIL import Image, ImageDraw

from mit_driverless_cv_traininginfra_tpu.utils import vis as jvis
from mit_driverless_cv_traininginfra_tpu_torch.data import encode
from mit_driverless_cv_traininginfra_tpu_torch.utils import draw, vis


@pytest.fixture
def captured(monkeypatch):
    """Arrays as the port hands them to its JPEG encoder (RGB or grey) and as
    the JAX package hands them to ``cv2.imwrite`` (BGR) or ``Image.save``,
    by destination."""
    port, jax = {}, {}

    def port_write(dest, arr, quality):
        port[dest] = (arr.copy(), quality)
        return dest

    def imwrite(path, arr):
        jax[path[:-len(".tmp.jpg")]] = arr[..., ::-1].copy() if arr.ndim == 3 else arr.copy()
        open(path, "wb").close()
        return True

    def save(self, fp, format=None, **kw):
        jax[fp[:-len(".tmp.jpg")]] = np.asarray(self).copy()
        open(fp, "wb").close()

    monkeypatch.setattr(vis, "_write_jpeg", port_write)
    monkeypatch.setattr(jvis.cv2, "imwrite", imwrite)
    monkeypatch.setattr(Image.Image, "save", save)
    return port, jax


def test_primitives_equal_opencv_and_pil():
    rng = np.random.default_rng(0)
    for _ in range(200):
        img, ref = np.zeros((40, 50, 3), np.uint8), np.zeros((40, 50, 3), np.uint8)
        c = (int(rng.integers(-5, 55)), int(rng.integers(-5, 45)))
        r = int(rng.integers(0, 6))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        cv2.circle(ref, c, r, color, -1)
        np.testing.assert_array_equal(draw.cv2_circle_filled(img, c, r, color), ref)
        p0 = (int(rng.integers(-3, 53)), int(rng.integers(-3, 43)))
        p1 = (int(rng.integers(-3, 53)), int(rng.integers(-3, 43)))
        cv2.rectangle(ref, p0, p1, color, 2)
        np.testing.assert_array_equal(draw.cv2_rectangle2(img, p0, p1, color), ref)
        im = Image.new("RGB", (50, 40))
        xs, ys = sorted(rng.uniform(-5, 55, 2)), sorted(rng.uniform(-5, 45, 2))
        width = int(rng.integers(1, 3))
        ImageDraw.Draw(im).rectangle((xs[0], ys[0], xs[1], ys[1]), outline=color, width=width)
        x, y = rng.uniform(-3, 53), rng.uniform(-3, 43)
        ImageDraw.Draw(im).ellipse((x - 2, y - 2, x + 2, y + 2), fill=(9, 8, 7))
        mine = np.zeros((40, 50, 3), np.uint8)
        draw.pil_rectangle(mine, (xs[0], ys[0], xs[1], ys[1]), color, width)
        np.testing.assert_array_equal(draw.pil_dot(mine, x, y, (9, 8, 7)), np.asarray(im))


def test_thick_lines_within_one_percent_of_opencv():
    rng = np.random.default_rng(1)
    drawn = differ = 0
    for _ in range(150):
        img, ref = np.zeros((200, 200, 3), np.uint8), np.zeros((200, 200, 3), np.uint8)
        p0, p1 = (tuple(int(v) for v in rng.integers(0, 200, 2)) for _ in range(2))
        cv2.line(ref, p0, p1, (0, 255, 0), 2)
        draw.cv2_line2(img, p0, p1, (0, 255, 0))
        drawn += int(ref.any(-1).sum())
        differ += int((img != ref).any(-1).sum())
    assert differ <= 0.01 * drawn, (differ, drawn)


def test_renders_equal_jax(captured, tmp_path):
    port, jax = captured
    rng = np.random.default_rng(2)
    out = str(tmp_path)
    bgr = rng.integers(0, 256, (90, 70, 3), dtype=np.uint8)
    pts = rng.uniform(0, 1, (7, 2))
    hm = rng.random((7, 20, 20))
    labels = np.array([[0, 3.7, 4.2, 40.9, 60.1], [0, -3, 10, 20, 95.5]], np.float32)
    vis.vis_kpt_and_save(bgr.copy(), "a", pts * [70, 90], output_uri=out)
    jvis.vis_kpt_and_save(bgr.copy(), "a", pts * [70, 90], output_uri=out)
    vis.vis_tensor_and_save(bgr.copy(), 90, 70, pts, "b", out)
    jvis.vis_tensor_and_save(bgr.copy(), 90, 70, pts, "b", out)
    vis.vis_hm_and_save(hm, "c", output_uri=out)
    jvis.vis_hm_and_save(hm, "c", output_uri=out)
    vis.vis_hm_strip_and_save(hm, "d", output_uri=out)
    jvis.vis_hm_strip_and_save(hm, "d", output_uri=out)
    rgb = bgr[..., ::-1].copy()
    for name, img, color in (("e", rgb, "red"), ("f", rgb[..., 0].copy(), "green"),
                             ("g", rgb, "blue")):
        vis.visualize_and_save_to_local(img.copy(), labels, f"{out}/{name}.jpg", color)
        jvis.visualize_and_save_to_local(Image.fromarray(img), labels, f"{out}/{name}.jpg",
                                         color)
    np.testing.assert_array_equal(vis.heatmap_strip(hm), jvis.heatmap_strip(hm))
    assert sorted(port) == sorted(jax) and len(port) == 7
    for dest, (arr, quality) in port.items():
        np.testing.assert_array_equal(arr, jax[dest], err_msg=dest)
        assert quality == (95 if dest.endswith(("_label_vis.jpg", "_inference.jpg")) else 75)


def test_dataset_render_within_the_line_tolerance(captured, tmp_path):
    port, jax = captured
    rng = np.random.default_rng(3)
    names, labels = [], []
    for i, (h, w) in enumerate([(80, 60), (45, 120), (100, 100)]):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        # the fixture has replaced cv2.imwrite and Image.save
        (tmp_path / f"x{i}.png").write_bytes(encode.encode_png(img))
        names.append(f"x{i}.png")
        labels.append(rng.uniform(0, 1, (7, 2)) * [w - 1, h - 1])
    names.append("missing.png")
    labels.append(np.zeros((7, 2)))
    out = str(tmp_path / "vis")
    with contextlib.redirect_stdout(io.StringIO()):
        n = vis.visualize_dataset(names, labels, str(tmp_path), out)
        assert n == jvis.visualize_dataset(names, labels, str(tmp_path), out) == 3
    assert sorted(port) == sorted(jax)
    for dest, (arr, quality) in port.items():
        ref = jax[dest]
        assert arr.shape == ref.shape == (1000, 1000, 3) and quality == 95
        line = np.all(ref == [0, 255, 0], -1) | np.all(arr == [0, 255, 0], -1)
        assert np.array_equal(arr[~line], ref[~line])  # the resized crop: bit-equal
        assert (arr != ref).any(-1).sum() <= 0.01 * np.all(ref == [0, 255, 0], -1).sum()
