"""Keypoint heatmap targets made on the device, and keypoint distance
metrics (counterpart of the JAX package's ``ops/heatmap.py``, whose
host-side cv2 targets wait with the disk loader)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

KPT_NAMES: Sequence[str] = (
    "top", "mid_L_top", "mid_R_top", "mid_L_bot", "mid_R_bot", "bot_L", "bot_R",
)


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
