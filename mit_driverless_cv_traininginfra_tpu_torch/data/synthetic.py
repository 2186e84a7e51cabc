"""Synthetic cone scenes and crops (the port's own copy of the JAX
package's numpy-only ``data/synthetic.py``; the same ``rng`` gives the
same arrays in both packages).

Renders two-tone triangular cones over a sky/ground gradient with sensor
noise, plus the matching labels:

- :func:`cone_scene` / :func:`yolo_batch`: detection frames and boxes;
- :func:`cone_crop` / :func:`rektnet_batch`: 80×80 cone crops and the 7
  RektNet keypoints, laid out as the cross-ratio loss's geometry expects
  (side chains 0-1-3-5 / 0-2-4-6, horizontal pairs (1,2), (3,4), (5,6)).
"""

from __future__ import annotations

import numpy as np

# keypoint fractions down the cone's side edges: apex, band top, band
# bottom, base — matching the 7-point chains the geo loss assumes
_KPT_T = (0.0, 0.35, 0.65, 1.0)


def _draw_cone(img, cx, base_y, h, half_w, body, band):
    """Rasterise one two-tone triangular cone; returns its xyxy box."""
    H, W, _ = img.shape
    top_y = base_y - h
    y0 = max(int(np.floor(top_y)), 0)
    y1 = min(int(np.ceil(base_y)), H - 1)
    x0 = max(int(np.floor(cx - half_w)), 0)
    x1 = min(int(np.ceil(cx + half_w)), W - 1)
    if y1 <= y0 or x1 <= x0:
        return None
    ys = np.arange(y0, y1 + 1, dtype=np.float32)
    xs = np.arange(x0, x1 + 1, dtype=np.float32)
    t = np.clip((ys - top_y) / max(h, 1e-6), 0.0, 1.0)  # 0 apex → 1 base
    width_at = half_w * t
    inside = np.abs(xs[None, :] - cx) <= width_at[:, None]  # (y, x)
    in_band = (t >= _KPT_T[1]) & (t <= _KPT_T[2])
    color = np.where(in_band[:, None, None], band, body)  # (y, 1, 3)
    # slight vertical shading for realism
    shade = (0.85 + 0.15 * t)[:, None, None]
    patch = img[y0:y1 + 1, x0:x1 + 1]
    img[y0:y1 + 1, x0:x1 + 1] = np.where(inside[..., None],
                                         color * shade, patch)
    return (max(cx - half_w, 0.0), max(top_y, 0.0),
            min(cx + half_w, W - 1.0), min(base_y, H - 1.0))


def _background(rng, h, w):
    """Sky→ground vertical gradient + low-frequency mottling + noise."""
    horizon = rng.uniform(0.3, 0.5)
    t = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    sky = np.asarray(rng.uniform(0.55, 0.8, 3), np.float32)
    ground = np.asarray(rng.uniform(0.25, 0.45, 3), np.float32)
    blend = 1 / (1 + np.exp(-(t - horizon) * 18))
    img = sky * (1 - blend) + ground * blend
    img = np.broadcast_to(img, (h, w, 3)).copy()
    # low-frequency mottling (cheap bilinear upsample of coarse noise)
    coarse = rng.uniform(-0.06, 0.06, (8, 8, 1)).astype(np.float32)
    yy = np.linspace(0, 7, h)
    xx = np.linspace(0, 7, w)
    yi, xi = np.floor(yy).astype(int), np.floor(xx).astype(int)
    yf, xf = (yy - yi)[:, None, None], (xx - xi)[None, :, None]
    yi2, xi2 = np.minimum(yi + 1, 7), np.minimum(xi + 1, 7)
    img += ((coarse[yi][:, xi] * (1 - yf) + coarse[yi2][:, xi] * yf)
            * (1 - xf)
            + (coarse[yi][:, xi2] * (1 - yf) + coarse[yi2][:, xi2] * yf) * xf)
    img += rng.normal(0, 0.015, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 1), horizon


_CONE_COLORS = (  # (body, band) — orange/white, blue/white, yellow/black
    ((0.95, 0.45, 0.10), (0.95, 0.95, 0.95)),
    ((0.15, 0.25, 0.85), (0.95, 0.95, 0.95)),
    ((0.95, 0.85, 0.15), (0.10, 0.10, 0.10)),
)


def _iou(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def cone_scene(rng, size: int = 416, max_cones: int = 8,
               min_h: int = 18, max_h: int = 120,
               max_overlap: float | None = None):
    """One frame. Returns (img (S,S,3) float32 [0,1], boxes (N,4) xyxy px).

    Cones sit below the horizon with perspective-ish size ordering (nearer
    == lower == larger), heights spanning the vanilla-anchor range.

    ``max_overlap`` (pairwise box IoU) controls scene difficulty: ``None``
    (default) places cones independently — overlapping cones whose GT
    boxes exceed the NMS threshold are then irreducible misses, which caps
    recall; a small value (e.g. 0.1) rejection-samples positions so every
    cone is separable — the regime the high-accuracy convergence tests
    certify in (tests/test_quantize_accuracy.py)."""
    img, horizon = _background(rng, size, size)
    n = int(rng.integers(2, max_cones + 1))
    boxes = []
    for _ in range(n):
        h = float(rng.uniform(min_h, max_h))
        # larger cones lower in the frame
        depth = (h - min_h) / (max_h - min_h)
        base_lo = horizon * size + 0.15 * size + h
        for _attempt in range(12):
            base_y = float(np.clip(
                base_lo + depth * (size - base_lo) * rng.uniform(0.5, 1.0),
                h + 2, size - 2))
            cx = float(rng.uniform(6, size - 6))
            half_w = h * float(rng.uniform(0.28, 0.38))
            if max_overlap is None:
                break
            cand = (max(cx - half_w, 0.0), max(base_y - h, 0.0),
                    min(cx + half_w, size - 1.0), min(base_y, size - 1.0))
            if all(_iou(cand, b) <= max_overlap for b in boxes):
                break
        else:
            continue  # couldn't place separably; skip this cone
        body, band = _CONE_COLORS[int(rng.integers(len(_CONE_COLORS)))]
        # apply the min-size gate BEFORE rasterising (the box is analytic,
        # _draw_cone returns exactly this clip): a cone that fails the
        # filter must not be painted either — visible unlabeled cone
        # pixels would be label noise against the no-object conf target
        pre = (max(cx - half_w, 0.0), max(base_y - h, 0.0),
               min(cx + half_w, size - 1.0), min(base_y, size - 1.0))
        if not ((pre[2] - pre[0]) > 4 and (pre[3] - pre[1]) > 6):
            continue
        box = _draw_cone(img, cx, base_y, h, half_w,
                         np.asarray(body, np.float32),
                         np.asarray(band, np.float32))
        if box is not None:
            boxes.append(box)
    return img, np.asarray(boxes, np.float32).reshape(-1, 4)


def yolo_batch(rng, batch: int, size: int = 416, max_targets: int = 10,
               **kw):
    """(imgs (B,S,S,3), targets (B,T,5) normalised [cls,cx,cy,w,h], zero-row
    padded) — ready for ``yolo_train_step``."""
    imgs = np.zeros((batch, size, size, 3), np.float32)
    targets = np.zeros((batch, max_targets, 5), np.float32)
    for b in range(batch):
        img, boxes = cone_scene(rng, size=size, **kw)
        imgs[b] = img
        k = min(len(boxes), max_targets)
        if k:
            bx = boxes[:k]
            targets[b, :k, 1] = (bx[:, 0] + bx[:, 2]) / 2 / size
            targets[b, :k, 2] = (bx[:, 1] + bx[:, 3]) / 2 / size
            targets[b, :k, 3] = (bx[:, 2] - bx[:, 0]) / size
            targets[b, :k, 4] = (bx[:, 3] - bx[:, 1]) / size
    return imgs, targets


def cone_crop(rng, size: int = 80):
    """One RektNet-style crop. Returns (img (S,S,3), points (7,2) in [0,1]
    crop coords, order [apex, band-top-L, band-top-R, band-bot-L,
    band-bot-R, base-L, base-R])."""
    img, _ = _background(rng, size, size)
    h = float(rng.uniform(0.7, 0.92)) * size
    half_w = h * float(rng.uniform(0.28, 0.38))
    cx = size / 2 + float(rng.uniform(-0.05, 0.05)) * size
    base_y = size / 2 + h / 2 + float(rng.uniform(-0.03, 0.03)) * size
    body, band = _CONE_COLORS[int(rng.integers(len(_CONE_COLORS)))]
    _draw_cone(img, cx, base_y, h, half_w,
               np.asarray(body, np.float32), np.asarray(band, np.float32))
    top_y = base_y - h
    pts = [(cx, top_y)]
    for t in _KPT_T[1:]:
        w_at = half_w * t
        y = top_y + h * t
        pts.append((cx - w_at, y))
        pts.append((cx + w_at, y))
    pts = np.asarray(pts, np.float32) / size
    return img, np.clip(pts, 0.0, 1.0)


def rektnet_batch(rng, batch: int, size: int = 80):
    """(imgs (B,S,S,3), points (B,7,2)) for ``rektnet_train_step`` with
    on-device gaussian heatmap synthesis (synth_target_sigma)."""
    imgs = np.zeros((batch, size, size, 3), np.float32)
    pts = np.zeros((batch, 7, 2), np.float32)
    for b in range(batch):
        imgs[b], pts[b] = cone_crop(rng, size=size)
    return imgs, pts
