"""Box geometry (counterpart of the JAX package's ``ops/boxes.py``)."""

from __future__ import annotations

import torch


def iou_no_plus_one_pairwise(boxes1, boxes2):
    """All-pairs IoU of xyxy boxes without the +1 pixel convention:
    (..., N, 4) × (..., M, 4) → (..., N, M). A zero union divides by 1.

    The arithmetic of the reference NMS (raw ``x2 - x1`` widths), in the
    same operation order as the JAX twin so f32 results agree bitwise;
    ``torch.maximum``/``minimum``/``clamp`` propagate NaN as jnp does."""
    x1 = torch.maximum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
    y1 = torch.maximum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
    x2 = torch.minimum(boxes1[..., :, None, 2], boxes2[..., None, :, 2])
    y2 = torch.minimum(boxes1[..., :, None, 3], boxes2[..., None, :, 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / torch.where(union == 0, torch.ones_like(union), union)
