"""Box geometry (counterpart of the JAX package's ``ops/boxes.py``): the
IoU of the reference NMS and the letterbox geometry."""

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


def calculate_padding(orig_height, orig_width, new_height, new_width):
    """Letterbox padding and scale factor of an ``orig`` image fitted into
    ``new`` (the reference's ``utils/utils.py:calculate_padding``): a host
    function of Python scalars. Returns ``(pad_h, pad_w, scale_factor)``,
    the pads on each side of the original before the resize."""
    if max(orig_height, orig_width) == orig_height:
        new_img_width = orig_height * new_width / new_height
        scale_factor = new_height / orig_height
        pad_h = 0
        pad_w = int((new_img_width - orig_width) / 2)
    else:
        scale_factor = new_width / orig_width
        new_img_height = orig_width * new_height / new_width
        pad_w = 0
        pad_h = int((new_img_height - orig_height) / 2)
    return pad_h, pad_w, scale_factor
