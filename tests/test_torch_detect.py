"""The port's detection path against the JAX package's, on the CPU: the
greedy NMS (``ops/nms.py``), the letterbox geometry and resize
(``ops/boxes.py``, ``ops/image.py``) and ``infer/detect.py`` on the tiny
Darknet cfg in f32."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import gap_threshold, tiny_models
from mit_driverless_cv_traininginfra_tpu_torch.infer import detect
from mit_driverless_cv_traininginfra_tpu_torch.ops import boxes, image, nms

# the modules themselves: the JAX package's ``ops`` re-exports functions
# under some of these names
jdetect, jboxes, jimage, jnms = (
    importlib.import_module(f"mit_driverless_cv_traininginfra_tpu.{m}")
    for m in ("infer.detect", "ops.boxes", "ops.image", "ops.nms"))

# ---------------------------------------------------------------------------
# NMS: indices and masks equal to the JAX package's
# ---------------------------------------------------------------------------


def _nms_inputs(rng, n: int, case: str):
    centers = rng.uniform(10, 90, (n // 4 + 1, 2))
    c = np.repeat(centers, 4, axis=0)[:n] + rng.normal(0, 3, (n, 2))
    wh = rng.uniform(4, 30, (n, 2))
    bx = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if case == "ties":
        scores[rng.choice(n, n // 2, replace=False)] = 0.5
    elif case == "signed_zeros":
        scores = rng.choice(np.float32([-0.0, 0.0, 0.25]), n)
    elif case == "inf_rows":
        scores[rng.choice(n, n // 3, replace=False)] = -np.inf
    return bx, scores


@pytest.mark.parametrize("n,top_k", [(300, 200), (50, 200), (200, 16)],
                         ids=["n>top_k", "top_k>n", "k16"])
@pytest.mark.parametrize("case", ["random", "ties", "signed_zeros", "inf_rows"])
def test_nms_matches_jax(case, n, top_k):
    bx, scores = _nms_inputs(np.random.default_rng(n + top_k), n, case)
    idx, mask = nms.nms(torch.from_numpy(bx), torch.from_numpy(scores),
                        overlap=0.4, top_k=top_k)
    j_idx, j_mask = jnms.nms(jnp.asarray(bx), jnp.asarray(scores),
                             overlap=0.4, top_k=top_k)
    assert idx.shape == mask.shape == (top_k,)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert int(mask.sum()) > 0
    if top_k > 16:   # 16 clustered candidates may all survive
        assert int(mask.sum()) < min(n, top_k)   # something suppressed


def test_batched_nms_matches_jax():
    rng = np.random.default_rng(3)
    pairs = [_nms_inputs(rng, 120, c) for c in ("random", "ties", "inf_rows")]
    bx = np.stack([p[0] for p in pairs])
    sc = np.stack([p[1] for p in pairs])
    idx, mask = nms.batched_nms(torch.from_numpy(bx), torch.from_numpy(sc),
                                overlap=0.3, top_k=64)
    j_idx, j_mask = jnms.batched_nms(jnp.asarray(bx), jnp.asarray(sc),
                                     overlap=0.3, top_k=64)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


# ---------------------------------------------------------------------------
# letterbox geometry and resize
# ---------------------------------------------------------------------------

SIZES = [(720, 1280), (1080, 1920), (80, 100), (100, 80), (64, 64), (13, 29),
         (416, 416), (30, 500)]


@pytest.mark.parametrize("h,w", SIZES)
def test_calculate_padding_equal(h, w):
    for out in ((416, 416), (64, 64), (320, 480)):
        assert boxes.calculate_padding(h, w, *out) == \
            jboxes.calculate_padding(h, w, *out)


# jax.image.resize runs jitted, and XLA:CPU contracts the sample centres'
# (j + 0.5)·s − 0.5 into one fused multiply-add; the port rounds the
# product and the sum apiece (as the formula is written), so a weight may
# sit a few ulps off (≤ 4e-6 of a weight ≤ 1) and a resized pixel in
# [0, 1] within 1e-5
RESIZE_ATOL = 1e-5


@pytest.mark.parametrize("shape,out", [
    ((1, 72, 128, 3), (64, 64)),     # downsample, non-square in
    ((2, 50, 30, 3), (64, 64)),      # upsample, non-square in
    ((1, 40, 40, 3), (64, 64)),      # square upsample
    ((1, 200, 200, 3), (64, 64)),    # square downsample
    ((1, 64, 100, 3), (64, 48)),     # one axis unchanged
    ((30, 50, 3), (64, 64)),         # HWC
], ids=["down", "up", "sq_up", "sq_down", "one_axis", "hwc"])
def test_resize_bilinear_matches_jax(shape, out):
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    got = image.resize_bilinear(torch.from_numpy(x), *out).numpy()
    ref = np.asarray(jimage.resize_bilinear(jnp.asarray(x), *out))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("shape", [(1, 72, 128, 3), (1, 128, 72, 3),
                                   (1, 64, 64, 3), (2, 33, 47, 3),
                                   (90, 60, 3)])
def test_letterbox_matches_jax(shape):
    x = np.random.default_rng(2).uniform(0, 1, shape).astype(np.float32)
    got, geom = image.letterbox(torch.from_numpy(x), 64, 64)
    ref, j_geom = jimage.letterbox(jnp.asarray(x), 64, 64)
    assert geom == j_geom
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=RESIZE_ATOL)


def test_pad_to_matches_jax():
    x = np.random.default_rng(3).uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        image.pad_to(torch.from_numpy(x), 2, 3).numpy(),
        np.asarray(jimage.pad_to(jnp.asarray(x), 2, 3)))


# ---------------------------------------------------------------------------
# detect.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    (jspec, jyolo, _), (yolo, _) = tiny_models(seed=6)
    return jspec, jyolo, yolo


def _gap(jspec, jyolo, images, per_frame):
    conf = np.asarray(jax.vmap(lambda d: d[:, 4])(
        jdetect.yolo_detections(jspec, jyolo, {}, jnp.asarray(images))))
    return gap_threshold(conf, per_frame)


def test_detect_batch_matches_jax(models):
    jspec, jyolo, yolo = models
    images = np.random.default_rng(4).uniform(0, 1, (3, 64, 64, 3)).astype(
        np.float32)
    thresh = _gap(jspec, jyolo, images, 20)
    got = detect.detect_batch(yolo, torch.from_numpy(images), thresh, 0.3,
                              top_k=32)
    ref = jdetect.detect_batch(jspec, jyolo, {}, jnp.asarray(images), thresh,
                               0.3, top_k=32)
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    assert m.sum() > 3
    # f32 through a few CPU convolutions in other orders (as
    # tests/test_torch_pipeline.py)
    np.testing.assert_allclose(got.boxes.numpy()[m], np.asarray(ref.boxes)[m],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy()[m],
                               np.asarray(ref.scores)[m], rtol=1e-5, atol=1e-6)


def test_unletterbox_boxes_bit_equal_to_eager_jax():
    """The IEEE quotient by the ratio, as eager JAX divides."""
    bx = np.random.default_rng(5).uniform(-5, 420, (200, 4)).astype(np.float32)
    for pad_h, pad_w, ratio in ((0, 104, 416 / 720), (52, 0, 64 / 100),
                                (0, 0, 1.0), (3, 0, 0.3)):
        got = detect.unletterbox_boxes(torch.from_numpy(bx), pad_h, pad_w,
                                       ratio).numpy()
        ref = np.asarray(jdetect.unletterbox_boxes(jnp.asarray(bx), pad_h,
                                                   pad_w, ratio))
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("kind,shape", [("uint8", (48, 80, 3)),
                                        ("float255", (100, 70, 3))])
def test_detect_image_matches_jax(models, kind, shape):
    jspec, jyolo, yolo = models
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "float255":
        img = img.astype(np.float32)        # 0-255 floats, max > 1.5
    boxed, _ = jimage.letterbox(jnp.asarray(img, jnp.float32)[None] / 255.0,
                                64, 64)
    thresh = _gap(jspec, jyolo, np.asarray(boxed), 6)
    got_b, got_s = detect.detect_image(yolo, img, conf_thresh=thresh,
                                       nms_thresh=0.3, top_k=32)
    ref_b, ref_s = jdetect.detect_image(jspec, jyolo, {}, img,
                                        conf_thresh=thresh, nms_thresh=0.3,
                                        top_k=32)
    assert got_b.shape == np.asarray(ref_b).shape and len(got_b) > 0
    # the letterbox's resize sits within 1e-5 of JAX's (see RESIZE_ATOL);
    # boxes in source pixels, through the box decode's exp
    np.testing.assert_allclose(got_b, np.asarray(ref_b), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got_s, np.asarray(ref_s), rtol=1e-4, atol=1e-5)
