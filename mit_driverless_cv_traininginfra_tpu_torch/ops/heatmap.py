"""Keypoint heatmap targets and keypoint distance metrics (counterpart of
the JAX package's ``ops/heatmap.py``; reference ``RektNet/utils.py``).

The host targets of the disk loader (:func:`prep_image`,
:func:`prep_label`, :func:`get_scale`, :func:`scale_keypoints`) make
what the JAX package makes with OpenCV, through ``data/raster.py``'s
numpy counterparts of ``cv2.resize`` and ``cv2.GaussianBlur``, bit for
bit. :func:`gaussian_heatmaps` makes targets on the device instead.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.data import raster

KPT_NAMES: Sequence[str] = (
    "top", "mid_L_top", "mid_R_top", "mid_L_bot", "mid_R_bot", "bot_L", "bot_R",
)


def prep_image(image: np.ndarray, target_image_size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize`` (linear) of a uint8 image to ``target_image_size``
    (width, height)."""
    return raster.resize_linear(image, tuple(target_image_size))


def prep_label(label: np.ndarray, target_image_size: Tuple[int, int],
               orig_image_size: Tuple[int, ...], image_path: str = "") -> np.ndarray:
    """(K, 2) pixel keypoints → (K, T0, T1) float64 heatmaps: a one-hot at
    ``[int(y), int(x)]`` at the original resolution, resized linearly,
    blurred 5×5 (σ from the kernel size) and normalised to sum 1. A map
    that sums to 0 is left as it is, with the reference's warning."""
    one_hot = np.zeros((label.shape[0], orig_image_size[0], orig_image_size[1]))
    for i in range(label.shape[0]):
        one_hot[i, int(label[i][1]), int(label[i][0])] = 1.0
    # every keypoint's map at once: the resize and blur are elementwise per map
    hm = np.zeros((label.shape[0], target_image_size[0], target_image_size[1]))
    hm[:] = raster.gaussian_blur_5x5_f64(raster.resize_linear(one_hot, tuple(target_image_size)))
    for i in range(label.shape[0]):
        s = hm[i].sum()
        if s == 0:
            print("Incorrect Data Label Detected! Please revise the image label "
                  f"below and becoming the one with data!\n{image_path}")
            continue
        hm[i] /= s
    return hm


def get_scale(actual_image_size, target_image_size):
    """``(target_h / h, target_w / w)``."""
    target_h, target_w = target_image_size
    return target_h / actual_image_size[0], target_w / actual_image_size[1]


def scale_keypoints(labels, h_scale: float, w_scale: float) -> np.ndarray:
    """``[ceil(int(x)·w_scale), ceil(int(y)·h_scale)]`` per keypoint, in
    Python floats (the reference's ``scale_labels``)."""
    return np.asarray([[math.ceil(int(pt[0]) * w_scale), math.ceil(int(pt[1]) * h_scale)]
                       for pt in np.asarray(labels)])


def gaussian_heatmaps(points, height: int, width: int, sigma: float = 1.0):
    """Unit-sum Gaussians centred on ``points`` (..., K, 2), xy in [0, 1]
    (the soft-argmax convention) → (..., K, H, W) on ``points``' device and
    in its dtype."""
    ys = torch.arange(height, dtype=points.dtype, device=points.device)
    xs = torch.arange(width, dtype=points.dtype, device=points.device)
    py = points[..., 1:2] * height  # (..., K, 1)
    px = points[..., 0:1] * width
    dy2 = (ys[None, :] - py) ** 2  # (..., K, H)
    dx2 = (xs[None, :] - px) ** 2  # (..., K, W)
    g = torch.exp(-(dy2[..., :, None] + dx2[..., None, :]) / (2.0 * sigma ** 2))
    norm = g.sum(dim=(-1, -2), keepdim=True)
    return g / torch.clamp_min(norm, 1e-12)


def keypoint_l2_distances(target_points, pred_points):
    """Per-keypoint euclidean distance: (..., K, 2) → (..., K)."""
    return torch.sqrt(((target_points - pred_points) ** 2).sum(dim=-1))


def keypoint_distance_summary(distances):
    """(mean per keypoint, total of the means, std per keypoint) over the
    batch axis of (N, K) distances, in numpy (the reference's
    ``calculate_mean_distance``)."""
    d = np.asarray(distances)
    means = d.mean(axis=0)
    return means, float(means.sum()), d.std(axis=0)
