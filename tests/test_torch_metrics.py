"""The port's detection metrics (``ops/metrics.py``) and box ops
(``ops/boxes.py``) against the JAX package's on the CPU, on the same numpy
inputs.

Tolerances. Box formats and the +1-pixel IoU are the same f32 operations
in the same order: bit-equal. The greedy matching's true-positive flags
are equal (they compare IoUs computed bit-equal). AP, recall and precision:
the running sums count 0/1 flags (exact), the envelope's Σ Δrecall ·
precision sums in another order: within 1e-6 absolute, and 1e-6 relative
where n_gt = 0 puts recall at tp / 1e-16 (an image the means leave out).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.ops import boxes as jboxes
from mit_driverless_cv_traininginfra_tpu.ops import metrics as jmetrics
from mit_driverless_cv_traininginfra_tpu_torch.ops import boxes, metrics

ATOL = 1e-6


def _xyxy(rng, n, size=64.0):
    x1 = rng.uniform(0, size - 8, n)
    y1 = rng.uniform(0, size - 8, n)
    return np.stack([x1, y1, x1 + rng.uniform(1, 30, n), y1 + rng.uniform(1, 30, n)],
                    -1).astype(np.float32)


def test_box_ops_bit_equal():
    rng = np.random.default_rng(0)
    xywh = rng.uniform(0, 60, (3, 7, 4)).astype(np.float32)
    got = boxes.xywh2xyxy(torch.from_numpy(xywh)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jboxes.xywh2xyxy(jnp.asarray(xywh))))
    a, b = _xyxy(rng, 9), _xyxy(rng, 5)
    a[0] = b[0]  # one identical pair
    a[1] = [0, 0, 0, 0]  # a point box (area 1 under the +1 convention)
    got = boxes.bbox_iou_pairwise(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jboxes.bbox_iou_pairwise(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (9, 5)
    np.testing.assert_array_equal(got, want)
    got = boxes.bbox_iou(torch.from_numpy(xywh[0]), torch.from_numpy(xywh[1]),
                         x1y1x2y2=False).numpy()
    want = np.asarray(jboxes.bbox_iou(jnp.asarray(xywh[0]), jnp.asarray(xywh[1]),
                                      x1y1x2y2=False))
    np.testing.assert_array_equal(got, want)


def test_compute_ap_matches_jax():
    rng = np.random.default_rng(1)
    for k in (1, 5, 40):
        rec = np.sort(rng.uniform(0, 1, k)).astype(np.float32)
        prec = rng.uniform(0, 1, k).astype(np.float32)
        got = float(metrics.compute_ap(torch.from_numpy(rec), torch.from_numpy(prec)))
        want = float(jmetrics.compute_ap(jnp.asarray(rec), jnp.asarray(prec)))
        assert got == pytest.approx(want, abs=ATOL)
    assert float(metrics.compute_ap(torch.ones(3), torch.ones(3))) == pytest.approx(1.0)
    # batched rows equal the rows one at a time
    rec = np.sort(rng.uniform(0, 1, (4, 6)), axis=1).astype(np.float32)
    prec = rng.uniform(0, 1, (4, 6)).astype(np.float32)
    rows = metrics.compute_ap(torch.from_numpy(rec), torch.from_numpy(prec))
    for r in range(4):
        assert float(rows[r]) == float(metrics.compute_ap(torch.from_numpy(rec[r]),
                                                          torch.from_numpy(prec[r])))


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_average_precision_with_tied_confidences(seed):
    """Ties in confidence keep their order (a stable sort, as jnp.argsort):
    TP flags among the ties land where JAX puts them; invalid slots sit
    among the valid ones."""
    rng = np.random.default_rng(seed)
    k = 24
    tp = (rng.uniform(0, 1, k) > 0.4).astype(np.float32)
    conf = rng.choice([0.9, 0.7, 0.7, 0.5, 0.3], k).astype(np.float32)
    valid = rng.uniform(0, 1, k) > 0.2
    for n_gt in (0, 3, int(tp.sum()) + 2):
        got = metrics.average_precision(torch.from_numpy(tp), torch.from_numpy(conf),
                                        n_gt, valid=torch.from_numpy(valid))
        want = jmetrics.average_precision(jnp.asarray(tp), jnp.asarray(conf), n_gt,
                                          valid=jnp.asarray(valid))
        for g, w in zip(got, want):
            assert float(g) == pytest.approx(float(w), rel=1e-6, abs=ATOL)
    got = metrics.average_precision(torch.from_numpy(tp), torch.from_numpy(conf), 5)
    want = jmetrics.average_precision(jnp.asarray(tp), jnp.asarray(conf), 5)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), abs=ATOL)


def test_greedy_match_matches_jax_per_image():
    """One batched loop equals JAX's loop image by image: labels claimed
    once, invalid labels and detections skipped, duplicates of one label
    past the first miss."""
    rng = np.random.default_rng(5)
    Bn, K, G = 4, 12, 5
    gt = np.stack([_xyxy(rng, G) for _ in range(Bn)])
    det = gt[:, rng.integers(0, G, K)] + rng.normal(0, 2, (Bn, K, 4)).astype(np.float32)
    det_valid = rng.uniform(0, 1, (Bn, K)) > 0.2
    det_valid[3] = False  # an image without detections
    gt_valid = rng.uniform(0, 1, (Bn, G)) > 0.3
    got = metrics.greedy_match(*map(torch.from_numpy, (det, det_valid, gt, gt_valid)), 0.5)
    assert got.shape == (Bn, K) and got.dtype == torch.float32
    for b in range(Bn):
        want = jmetrics.greedy_match(jnp.asarray(det[b]), jnp.asarray(det_valid[b]),
                                     jnp.asarray(gt[b]), jnp.asarray(gt_valid[b]), 0.5)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert float(got.sum()) > 0 and float(got[3].sum()) == 0


def _detections(rng, labels, n=300, size=64):
    """Decoded detections (B, n, 6): jittered copies of each image's
    labels with high confidence (one duplicate each), the rest random
    boxes at low confidence; image 1 gets no confident detection."""
    Bn = labels.shape[0]
    dets = np.zeros((Bn, n, 6), np.float32)
    dets[..., 0:2] = rng.uniform(0, size, (Bn, n, 2))
    dets[..., 2:4] = rng.uniform(2, 20, (Bn, n, 2))
    dets[..., 4] = rng.uniform(0, 0.4, (Bn, n))
    dets[..., 5] = rng.uniform(0, 1, (Bn, n))
    for b in range(Bn):
        if b == 1:
            continue
        real = labels[b][labels[b, :, 3] > 0]
        for t, row in enumerate(real):
            for d in range(2):
                j = 2 * t + d
                dets[b, j, 0:4] = row[1:5] * size + rng.normal(0, 0.8, 4)
                dets[b, j, 4] = 0.95 - 0.1 * d - 0.01 * t
    return dets


def test_evaluate_image_batch_and_summarize_match_jax():
    """Images with detections and labels, one with no confident detection
    (image 1), one with no labels (image 2), one label touching the left
    edge (x = 0: dropped by the reference's filter)."""
    rng = np.random.default_rng(6)
    labels = np.zeros((4, 6, 5), np.float32)
    for b in (0, 1, 3):
        n = rng.integers(2, 6)
        labels[b, :n, 1:3] = rng.uniform(0.2, 0.8, (n, 2))
        labels[b, :n, 3:5] = rng.uniform(0.08, 0.3, (n, 2))
    labels[3, 0, 1] = 0.0
    dets = _detections(rng, labels)
    kw = dict(img_width=64, img_height=64, conf_thresh=0.5, nms_thresh=0.25,
              iou_thresh=0.5, top_k=50)
    got = metrics.evaluate_image_batch(torch.from_numpy(dets), torch.from_numpy(labels), **kw)
    want = jmetrics.evaluate_image_batch(jnp.asarray(dets), jnp.asarray(labels), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.tolist() == [True, False, False, True]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    for g, w in zip(metrics.summarize(got), jmetrics.summarize(want)):
        assert g == pytest.approx(w, abs=ATOL)
    assert 0 < metrics.summarize(got)[0] <= 1
    none = metrics.ImageEval(*(torch.zeros(2) for _ in range(3)),
                             torch.zeros(2, dtype=torch.bool))
    assert metrics.summarize(none) == (0.0, 0.0, 0.0)
