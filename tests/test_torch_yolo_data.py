"""The port's YOLO input layer (``data/{uri,yolo_csv,raster,augment,
yolo_dataset,kmeans_anchors}.py``, ``ops/patches.py``) against the JAX
package, Pillow and OpenCV on the CPU.

Tolerances: none. The CSV, the patch geometry, the k-means CSVs and every
label are bit-equal to the JAX package's. ``raster`` is bit-equal to the
Pillow and OpenCV calls it stands for (resize with LANCZOS and BILINEAR up
and down, odd sizes; crops at fractional bounds, half-edges included; the
ImageEnhance blends; the HSV round trip over a quarter of the 8-bit
colours, every (r, g) pair among them; the
affine warp with its fill; the 8-bit Gaussian blur over 64 sigmas; the
float filter on integer images); so the augmentations and every dataset
item (tile-and-scale and letterbox, ``bw``, ``device_aug``, every
augmentation flag, two epochs) are bit-equal too: the largest difference
is 0 levels on 0% of the pixels.
"""

import contextlib
import io
import os
import random

import cv2
import numpy as np
import pytest
from PIL import Image, ImageEnhance

from mit_driverless_cv_traininginfra_tpu.data import augment as jaugment
from mit_driverless_cv_traininginfra_tpu.data import kmeans_anchors as jkmeans
from mit_driverless_cv_traininginfra_tpu.data import uri as juri
from mit_driverless_cv_traininginfra_tpu.data import yolo_csv as jcsv
from mit_driverless_cv_traininginfra_tpu.data import yolo_dataset as jdataset
from mit_driverless_cv_traininginfra_tpu.ops import patches as jpatches
from mit_driverless_cv_traininginfra_tpu_torch.data import augment, raster, uri, yolo_csv
from mit_driverless_cv_traininginfra_tpu_torch.data import kmeans_anchors, yolo_dataset
from mit_driverless_cv_traininginfra_tpu_torch.ops import patches

from _torch_port import write_cone_dataset


def _image(rng, h, w, c=3):
    """A smooth random image with pixel noise (edges and flats both)."""
    base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3), dtype=np.uint8)
    im = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR)).astype(int)
    im = np.clip(im + rng.integers(-20, 21, im.shape), 0, 255).astype(np.uint8)
    return im if c == 3 else im[..., 0]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Cone scenes at 96×144 and 130×90 (64² patches: 2×3 and 3×2 tiles
    after scaling), their all.csv, and the k-means CSVs of both packages."""
    d = tmp_path_factory.mktemp("cones")
    rng = np.random.default_rng(5)
    csv_path = write_cone_dataset(d, rng, [(96, 144), (130, 90)], per_size=5, tile=48,
                                  empty=2)
    out = {}
    for name, gen in (("jax", jkmeans.generate_dataset_csvs),
                      ("port", kmeans_anchors.generate_dataset_csvs)):
        out[name] = str(d / name)
        gen(csv_path, str(d), out[name], num_clst=4, max_cone=24, min_cone=6,
            split_up=(60, 30, 10), seed=3)
    return str(d), out


# --- CSV, URI, patches -------------------------------------------------------

def test_csv_round_trip_and_negative_rows(tmp_path):
    rows = [yolo_csv.YoloCsvRow("a.png", 30, 20, 0.5, np.array([[1, 2, 3, 4.5]], np.float32)),
            yolo_csv.YoloCsvRow("b.png", 30, 20, 1.25, np.zeros((0, 4), np.float32)),
            yolo_csv.YoloCsvRow("c.png", 30, 20, 1.0, np.array([[1, -2, 3, 4]], np.float32))]
    anchors = [(1.5, 2.0), (3.25, 4.0)]
    for mod, name in ((yolo_csv, "port.csv"), (jcsv, "jax.csv")):
        mod.write_yolo_csv(str(tmp_path / name), rows, anchors=anchors, url_prefix="u")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    with pytest.warns(UserWarning, match="negative"):
        got = yolo_csv.read_yolo_csv(str(tmp_path / "port.csv"))
    with pytest.warns(UserWarning, match="negative"):
        want = jcsv.read_yolo_csv(str(tmp_path / "port.csv"))
    assert got.anchors == want.anchors == anchors
    assert [(r.image, r.width, r.height, r.scale) for r in got.rows] == \
        [(r.image, r.width, r.height, r.scale) for r in want.rows] == \
        [("a.png", 30, 20, 0.5), ("b.png", 30, 20, 1.25)]
    for a, b in zip(got.rows, want.rows):
        np.testing.assert_array_equal(a.boxes, b.boxes)


def test_uri_mirror(tmp_path, monkeypatch):
    (tmp_path / "bucket").mkdir()
    (tmp_path / "bucket" / "t.csv").write_text("x")
    monkeypatch.setenv(uri.MIRROR_ENV, str(tmp_path))
    for u in ("gs://bucket/t.csv", "local/t.csv", None, ""):
        assert uri.resolve_uri(u) == juri.resolve_uri(u)
    with pytest.raises(FileNotFoundError):
        uri.resolve_uri("gs://bucket/missing.csv")
    monkeypatch.delenv(uri.MIRROR_ENV)
    with pytest.raises(FileNotFoundError, match=uri.MIRROR_ENV):
        uri.resolve_uri("s3://bucket/t.csv")


def test_patch_geometry_and_label_filter_equal_jax():
    rng = np.random.default_rng(1)
    for w, h in [(64, 64), (65, 64), (144, 96), (90, 130), (801, 1600), (1152, 864)]:
        pw = ph = 64 if w < 800 else 800
        assert patches.get_patch_spacings(w, h, pw, ph) == jpatches.get_patch_spacings(w, h, pw, ph)
        assert patches.pre_tile_padding(w // 2, h // 3, pw, ph) == \
            jpatches.pre_tile_padding(w // 2, h // 3, pw, ph)
        n = patches.get_patch_spacings(w, h, pw, ph)[2]
        for i in range(n):
            bnd = patches.get_patch_bounds(w, h, pw, ph, i)
            assert bnd == jpatches.get_patch_bounds(w, h, pw, ph, i)
            xy = rng.uniform(-20, max(w, h), (9, 2))
            wh = rng.uniform(1, 60, (9, 2))
            labels = np.concatenate([np.zeros((9, 1)), xy, xy + wh], 1).astype(np.float32)
            got = patches.filter_and_offset_labels(labels, bnd)
            want = jpatches.filter_and_offset_labels(labels, bnd)
            np.testing.assert_array_equal(got, want)
    # nothing survives: zeros with the input's row count (the reference's quirk)
    far = np.array([[0, 500, 500, 510, 510]] * 3, np.float32)
    np.testing.assert_array_equal(patches.filter_and_offset_labels(far, (0, 0, 64, 64)),
                                  np.zeros((3, 5), np.float32))


# --- raster against Pillow and OpenCV -----------------------------------------

@pytest.mark.parametrize("src,dst", [((97, 131), (53, 61)), ((97, 131), (200, 150)),
                                     ((120, 160), (119, 161)), ((31, 17), (17, 31)),
                                     ((50, 60), (60, 50))])
def test_resize_bit_equal_to_pillow(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = _image(rng, *src)
    for method, pil in ((raster.LANCZOS, Image.LANCZOS), (raster.BILINEAR, Image.BILINEAR)):
        want = np.asarray(Image.fromarray(img).resize(dst, pil))
        np.testing.assert_array_equal(raster.resize(img, dst, method), want, err_msg=method)
        grey = img[..., 1]
        want = np.asarray(Image.fromarray(grey).resize(dst, pil))
        np.testing.assert_array_equal(raster.resize(grey, dst, method), want)


def test_resized_crop_pad_grey_and_enhance_bit_equal_to_pillow():
    rng = np.random.default_rng(2)
    img = _image(rng, 101, 77)
    pil = Image.fromarray(img)
    canvas = Image.new("RGB", (77 + 14, 101 + 6), (127, 127, 127))
    canvas.paste(pil, (7, 3))
    np.testing.assert_array_equal(raster.pad(img, 3, 7), np.asarray(canvas))
    # crops of the scaled and padded image: half-edges round to even (0.5 →
    # 0, 1.5 → 2, 2.5 → 2) as Python's round does; outside the canvas is
    # black; the resize computed in the crop only
    for size, (vp, hp) in (((77, 101), (0, 0)), ((60, 131), (5, 9)), ((119, 55), (0, 4))):
        scaled = Image.fromarray(img).resize(size, Image.LANCZOS)
        padded = Image.new("RGB", (size[0] + 2 * hp, size[1] + 2 * vp), (127, 127, 127))
        padded.paste(scaled, (hp, vp))
        for box in [(0.5, 1.5, 50.5, 60.5), (2.5, 3.5, 40.4, 70.6), (-3, -2, 90, 120),
                    (10.49999, 0, 77, 101), (13.5, 13.5, 77.5, 77.5), (80, 1, 90, 9)]:
            np.testing.assert_array_equal(
                raster.resized_crop(img, size, vp, hp, box, raster.LANCZOS),
                np.asarray(padded.crop(box)), err_msg=f"{size} {box}")
    np.testing.assert_array_equal(raster.to_grey(img), np.asarray(pil.convert("L")))
    for f in (0.0, 0.3, 0.75, 1.0, 1.2499, 2.7):
        np.testing.assert_array_equal(raster.brightness(img, f),
                                      np.asarray(ImageEnhance.Brightness(pil).enhance(f)))
        np.testing.assert_array_equal(raster.contrast(img, f),
                                      np.asarray(ImageEnhance.Contrast(pil).enhance(f)))
        np.testing.assert_array_equal(raster.color(img, f),
                                      np.asarray(ImageEnhance.Color(pil).enhance(f)))


def test_hsv_round_trip_bit_equal_to_pillow_on_a_quarter_of_all_colours():
    # every (r, g) pair with 64 blues each, the blues' offset turning with r
    r, g, b = np.meshgrid(np.arange(256), np.arange(256), np.arange(0, 256, 4), indexing="ij")
    rgb = np.stack([r, g, b + r % 4], -1).astype(np.uint8).reshape(4096, 1024, 3)
    np.testing.assert_array_equal(raster.rgb_to_hsv(rgb),
                                  np.asarray(Image.fromarray(rgb).convert("HSV")))
    np.testing.assert_array_equal(raster.hsv_to_rgb(rgb),
                                  np.asarray(Image.fromarray(rgb, "HSV").convert("RGB")))


def test_affine_bit_equal_to_pillow():
    rng = np.random.default_rng(3)
    for i in range(4):
        img = _image(rng, 97 + i, 131 - 2 * i)
        h, w = img.shape[:2]
        M = jaugment._affine_matrix(w, h, -rng.uniform(-10, 10),
                                    (rng.uniform(-40, 40), rng.uniform(-40, 40)),
                                    rng.uniform(0.9, 1.1), (-rng.uniform(-3, 3), 0))
        coeffs = tuple(np.linalg.inv(M)[:2].ravel())
        want = Image.fromarray(img).transform((w, h), Image.AFFINE, coeffs,
                                              resample=Image.BILINEAR,
                                              fillcolor=(127, 127, 127))
        got = raster.affine(img, coeffs)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert (got == 127).all(-1).any()  # the fill reaches the border


def test_gaussian_blur_and_filter_bit_equal_to_opencv():
    rng = np.random.default_rng(4)
    img = _image(rng, 83, 91)
    sigmas = list(rng.uniform(0, 3, 56)) + [0.05, 0.09, 0.25, 0.5, 1.0, 1.5, 2.5, 2.99]
    for s in sigmas:
        np.testing.assert_array_equal(raster.gaussian_blur(img, s),
                                      cv2.GaussianBlur(img, (0, 0), sigmaX=s), err_msg=s)
    grey = img[..., 0]
    np.testing.assert_array_equal(raster.gaussian_blur(grey, 1.3),
                                  cv2.GaussianBlur(grey, (0, 0), sigmaX=1.3))
    k = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]], np.float32)
    for a in (img, grey):
        f = a.astype(np.float32)
        np.testing.assert_array_equal(raster.filter2d(f, k), cv2.filter2D(f, -1, k))


# --- augment against the JAX package's ----------------------------------------

def test_augment_equals_jax_on_the_same_draws():
    rng = np.random.default_rng(6)
    img = _image(rng, 64, 80)
    for seed in range(6):
        r1, r2 = random.Random(seed), random.Random(seed)
        got = augment.color_jitter(img, r1)
        want = np.asarray(jaugment.color_jitter(Image.fromarray(img), r2))
        np.testing.assert_array_equal(got, want)
        assert r1.random() == r2.random()  # the same draws were taken
    labels = np.array([[0, 5, 6, 30, 40], [0, 60, 2, 79, 20], [0, 1, 1, 3, 3]], np.float32)
    for k in range(4):
        ang, tr, sc, sh = (rng.uniform(-10, 10), (rng.uniform(-40, 40), rng.uniform(-40, 40)),
                           rng.uniform(0.9, 1.1), rng.uniform(-3, 3))
        np.testing.assert_array_equal(
            augment.affine_image(img, ang, tr, sc, sh),
            np.asarray(jaugment.affine_image(Image.fromarray(img), ang, tr, sc, sh)))
        np.testing.assert_array_equal(
            augment.affine_labels(64, 80, labels, -ang, tr, sc, (-sh, 0)),
            jaugment.affine_labels(64, 80, labels, -ang, tr, sc, (-sh, 0)))
    # a box the warp degenerates keeps its pre-warp coordinates
    kept = augment.affine_labels(64, 80, labels, 0, (0, 0), 1.0)
    np.testing.assert_array_equal(kept[2], labels[2])
    for s in (0.0, 0.5, 2.2):
        np.testing.assert_array_equal(augment.gaussian_blur(img, s), jaugment.gaussian_blur(img, s))
    g1, g2 = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        np.testing.assert_array_equal(augment.additive_gaussian_noise(img, 5.0, g1),
                                      jaugment.additive_gaussian_noise(img, 5.0, g2))
    np.testing.assert_array_equal(augment.sigmoid_contrast(img, 7, 0.6),
                                  jaugment.sigmoid_contrast(img, 7, 0.6))
    np.testing.assert_array_equal(augment.sharpen(img, 0.37), jaugment.sharpen(img, 0.37))


# --- the dataset, item by item ------------------------------------------------

ALL_AUGS = dict(augment_affine=True, augment_hsv=True, lr_flip=True, data_aug=True,
                blur=True, noise=True, contrast=True, sharpen=True, ud_flip=True, salt=True)


@pytest.mark.parametrize("kw", [
    dict(),
    ALL_AUGS,
    dict(ALL_AUGS, noise=False, bw=True),
    dict(augment_hsv=True, lr_flip=True, ts=False),
    dict(augment_affine=True, device_aug=True),
    dict(data_aug=True, device_aug=True, bw=True, debug_mode=True),
    dict(num_images=7, augment_affine=True, seed=11),
], ids=["plain", "all", "bw", "letterbox", "device_aug", "device_aug_bw_debug", "subset"])
def test_dataset_items_equal_jax(dataset, kw):
    root, csvs = dataset
    args = (os.path.join(csvs["port"], "train.csv"), root, 64, 64)
    got = yolo_dataset.ImageLabelDataset(*args, **kw)
    want = jdataset.ImageLabelDataset(*args, **kw)
    assert len(got) == len(want) == kw.get("num_images", len(got)) > 6
    assert got.num_targets_per_image == want.num_targets_per_image
    for epoch in (1, 2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(got)):
            u, img, lab = got[i]
            ju, jimg, jlab = want[i]
            assert u == ju and img.dtype == jimg.dtype == np.float32
            assert img.shape == jimg.shape == (64, 64, 1 if kw.get("bw") else 3)
            np.testing.assert_array_equal(lab, jlab, err_msg=f"{kw} {epoch} {i}")
            np.testing.assert_array_equal(img, jimg, err_msg=f"{kw} {epoch} {i}")


def test_dataset_refuses_vis_batch(dataset, tmp_path, monkeypatch):
    """``vis_batch`` (which this port once refused) renders every stage of
    its first items as the JAX package's ``_vis`` does — original, scaled,
    each patch or the pad-resized image, before and after the
    augmentations —, then exits: the same files, each array as drawn (boxes
    1 px, PIL's colours) equal, before either package encodes it."""
    from mit_driverless_cv_traininginfra_tpu_torch.utils import vis

    root, csvs = dataset
    monkeypatch.chdir(tmp_path)
    got, want = [], []
    monkeypatch.setattr(vis, "_write_jpeg", lambda dest, arr, q: got.append((dest, arr.copy())))

    def save(self, fp, format=None, **kw):
        want.append((fp[:-len(".tmp.jpg")], np.asarray(self).copy()))
        open(fp, "wb").close()

    monkeypatch.setattr(Image.Image, "save", save)
    args = (os.path.join(csvs["port"], "train.csv"), root, 64, 64)
    for kw in (dict(data_aug=True, augment_affine=True, lr_flip=True),
               dict(ts=False, data_aug=True), dict(augment_hsv=True)):
        for cls in (yolo_dataset.ImageLabelDataset, jdataset.ImageLabelDataset):
            ds = cls(*args, vis_batch=3, **kw)
            ds.set_epoch(1)
            with contextlib.redirect_stdout(io.StringIO()), pytest.raises(SystemExit):
                for i in range(len(ds)):
                    ds[i]
    assert len(got) > 20 and [p for p, _ in got] == [p for p, _ in want]
    assert {p.rsplit("_", 1)[-1] for p, _ in got} >= {"original.jpg", "scaled.jpg",
                                                      "resized.jpg", "aug.jpg", "augmentation.jpg"}
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=path)


# --- k-means ------------------------------------------------------------------

def test_kmeans_csvs_equal_jax(dataset):
    _, csvs = dataset
    names = sorted(os.listdir(csvs["jax"]))
    assert names == sorted(os.listdir(csvs["port"])) == [
        "all.csv", "anchors.txt", "test.csv", "train-validate.csv", "train.csv",
        "validate.csv"]
    for name in names:
        a = open(os.path.join(csvs["port"], name)).read()
        assert a == open(os.path.join(csvs["jax"], name)).read(), name
    table = yolo_csv.read_yolo_csv(os.path.join(csvs["port"], "train.csv"))
    assert len(table.anchors) == 4
    assert {(r.width, r.height): r.scale for r in table.rows}.keys() == {(144, 96), (90, 130)}


def test_kmeans_pieces_equal_jax():
    rng = np.random.default_rng(8)
    sizes = rng.uniform(5, 80, (200, 2))
    np.testing.assert_array_equal(kmeans_anchors.kmeans_boxes(sizes, 9, seed=2),
                                  jkmeans.kmeans_boxes(sizes, 9, seed=2))
    boxes = {(96, 144): [tuple(s) for s in sizes[:120]], (130, 90): [tuple(s) for s in sizes[120:]]}
    got = kmeans_anchors.compute_scale_factors(boxes, 83, 10)
    want = jkmeans.compute_scale_factors(boxes, 83, 10)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
