"""Host-side augmentations of the YOLO dataset (the port's copy of the JAX
package's ``data/augment.py``), on numpy arrays instead of PIL images.

The same functions take the same draws from the same ``random.Random`` and
``np.random.Generator`` as the JAX package's, and compute the same pixels:
the Pillow and OpenCV calls there are ``data/raster.py``'s numpy
counterparts here. The reference's quirks stay: the jitter's shuffled
order, rejected boxes kept at their pre-warp coordinates by
:func:`affine_labels`, and :func:`sharpen`'s fixed lightness of 1.0.

Images are ``(H, W, 3)`` RGB (or ``(H, W)`` grey) uint8 arrays.
"""

from __future__ import annotations

import math
import random
from typing import Tuple

import numpy as np

from mit_driverless_cv_traininginfra_tpu_torch.data import raster


def color_jitter(
    img: np.ndarray,
    rng: random.Random,
    brightness: float = 0.25,
    contrast: float = 0.25,
    saturation: float = 0.25,
    hue: float = 0.04,
) -> np.ndarray:
    """Random-order brightness/contrast/saturation/hue jitter with uniform
    factors (torchvision ``ColorJitter``'s PIL path)."""
    ops = []
    if brightness:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: raster.brightness(im, f))
    if contrast:
        f2 = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: raster.contrast(im, f2))
    if saturation:
        f3 = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: raster.color(im, f3))
    if hue:
        h = rng.uniform(-hue, hue)

        def hue_shift(im: np.ndarray) -> np.ndarray:
            hsv = raster.rgb_to_hsv(im)
            hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(h * 255)) % 256
            return raster.hsv_to_rgb(hsv)

        ops.append(hue_shift)
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


def _affine_matrix(w: float, h: float, angle: float, translate, scale: float,
                   shear: Tuple[float, float]) -> np.ndarray:
    """Forward 3×3 homography: shear (about the centre) @ translate @
    rotate-scale (about the centre), the reference's ``M = S @ T @ R``."""
    alpha = scale * math.cos(math.radians(angle))
    beta = scale * math.sin(math.radians(angle))
    R = np.array(
        [
            [alpha, beta, (1 - alpha) * (w / 2.0) - beta * (h / 2.0)],
            [-beta, alpha, (beta * w / 2.0) + (1 - alpha) * (h / 2.0)],
            [0, 0, 1],
        ],
        dtype=np.float64,
    )
    T = np.eye(3)
    T[0, 2], T[1, 2] = translate[0], translate[1]
    S = np.eye(3)
    S[0, 1] = math.tan(math.radians(shear[0]))
    S[0, 2] = -math.tan(math.radians(shear[0])) * h / 2.0
    S[1, 0] = math.tan(math.radians(shear[1]))
    S[1, 2] = -math.tan(math.radians(shear[1])) * w / 2.0
    return S @ T @ R


def affine_image(img: np.ndarray, angle: float, translate, scale: float,
                 shear: float, fill=(127, 127, 127)) -> np.ndarray:
    """Warp the image by the inverse of the label transform's matrix
    (:func:`affine_labels` is called with ``-angle`` and ``(-shear, 0)``),
    so that image and labels stay consistent; grey outside."""
    h, w = img.shape[:2]
    M = _affine_matrix(w, h, -angle, translate, scale, (-shear, 0))
    Minv = np.linalg.inv(M)
    # the inverse (output → input) map's first two rows, as PIL takes it
    return raster.affine(img, tuple(Minv[:2].ravel()), fill=fill)


def affine_labels(h: int, w: int, targets: np.ndarray, angle: float = 0,
                  translate=(0, 0), scale: float = 1.0,
                  shear: Tuple[float, float] = (0, 0)) -> np.ndarray:
    """Rewarp (N, 5) [c, x1, y1, x2, y2] labels through the homography: warp
    all 4 corners, take the enclosing box, apply the angle-based reduction,
    clamp to [0, max(w, h)], and update only non-degenerate boxes (w, h >
    4, area ratio > 0.1, aspect < 10).

    Reference quirk: boxes that fail the degeneracy filter are not dropped;
    they keep their pre-warp coordinates."""
    targets = np.asarray(targets, np.float32).copy()
    height = max(w, h)
    M = _affine_matrix(w, h, angle, translate, scale, shear)

    n = targets.shape[0]
    if n == 0:
        return targets
    points = targets[:, 1:5]
    area0 = (points[:, 2] - points[:, 0]) * (points[:, 3] - points[:, 1])

    xy = np.ones((n * 4, 3), np.float64)
    xy[:, :2] = points[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
    xy = xy @ M.T
    xy = (xy[:, :2] / xy[:, 2:3]).reshape(n, 8)

    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    boxes = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)

    radians = angle * math.pi / 180
    reduction = max(abs(math.sin(radians)), abs(math.cos(radians))) ** 0.5
    cx = (boxes[:, 2] + boxes[:, 0]) / 2
    cy = (boxes[:, 3] + boxes[:, 1]) / 2
    bw = (boxes[:, 2] - boxes[:, 0]) * reduction
    bh = (boxes[:, 3] - boxes[:, 1]) * reduction
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], axis=1)

    boxes = np.clip(boxes, 0, height)
    bw = boxes[:, 2] - boxes[:, 0]
    bh = boxes[:, 3] - boxes[:, 1]
    area = bw * bh
    ar = np.maximum(bw / (bh + 1e-16), bh / (bw + 1e-16))
    keep = (bw > 4) & (bh > 4) & (area / (area0 + 1e-16) > 0.1) & (ar < 10)

    targets[keep, 1:5] = boxes[keep]
    return targets


def gaussian_blur(arr: np.ndarray, sigma: float) -> np.ndarray:
    """imgaug ``GaussianBlur(sigma)``: no-op for sigma ≈ 0."""
    if sigma <= 1e-3:
        return arr
    return raster.gaussian_blur(arr, sigma)


def additive_gaussian_noise(arr: np.ndarray, scale: float, rng: np.random.Generator,
                            per_channel_p: float = 0.5) -> np.ndarray:
    """imgaug ``AdditiveGaussianNoise(loc=0, scale, per_channel=0.5)``:
    with probability ``per_channel_p`` noise per channel, else one plane
    broadcast across channels."""
    h, w, c = arr.shape
    if rng.uniform() < per_channel_p:
        noise = rng.normal(0.0, scale, size=(h, w, c))
    else:
        noise = rng.normal(0.0, scale, size=(h, w, 1))
    return np.clip(arr.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def sigmoid_contrast(arr: np.ndarray, gain: float, cutoff: float) -> np.ndarray:
    """imgaug ``SigmoidContrast``: I' = 255 / (1 + exp(gain·(cutoff − I/255)))."""
    x = arr.astype(np.float32) / 255.0
    out = 1.0 / (1.0 + np.exp(gain * (cutoff - x)))
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


def sharpen(arr: np.ndarray, alpha: float, lightness: float = 1.0) -> np.ndarray:
    """imgaug ``Sharpen(alpha)``: blend identity with the sharpening kernel
    [[-1,-1,-1],[-1,8+lightness,-1],[-1,-1,-1]].

    lightness stays 1.0: the reference pins ``imgaug==0.3.0``, whose
    ``Sharpen(alpha, lightness=1)`` is a fixed scalar (the random range
    came in imgaug 0.4.0, which the reference never ran)."""
    kernel = np.array(
        [[-1, -1, -1], [-1, 8 + lightness, -1], [-1, -1, -1]], np.float32
    )
    sharp = raster.filter2d(arr.astype(np.float32), kernel)
    out = (1 - alpha) * arr.astype(np.float32) + alpha * sharp
    return np.clip(out, 0, 255).astype(np.uint8)
