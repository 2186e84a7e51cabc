"""Box geometry (counterpart of the JAX package's ``ops/boxes.py``): box
formats, the evaluator's IoU with the reference's +1 pixel convention, the
IoU of the reference NMS (without it) and the letterbox geometry."""

from __future__ import annotations

import torch


def xywh2xyxy(x):
    """[cx, cy, w, h] → [x1, y1, x2, y2] over the last axis."""
    return torch.stack([x[..., 0] - x[..., 2] / 2, x[..., 1] - x[..., 3] / 2,
                        x[..., 0] + x[..., 2] / 2, x[..., 1] + x[..., 3] / 2],
                       dim=-1)


def bbox_iou(box1, box2, x1y1x2y2: bool = True):
    """Elementwise IoU with the reference evaluator's +1 pixel convention
    (widths ``x2 − x1 + 1``), broadcast over leading dims; ``x1y1x2y2=False``
    takes [cx, cy, w, h] boxes."""
    if not x1y1x2y2:
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
    b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)
    inter_w = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1) + 1).clamp(min=0)
    inter_h = (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1) + 1).clamp(min=0)
    inter = inter_w * inter_h
    area1 = (b1_x2 - b1_x1 + 1) * (b1_y2 - b1_y1 + 1)
    area2 = (b2_x2 - b2_x1 + 1) * (b2_y2 - b2_y1 + 1)
    return inter / (area1 + area2 - inter + 1e-12)


def bbox_iou_pairwise(boxes1, boxes2, x1y1x2y2: bool = True):
    """All-pairs :func:`bbox_iou`: (..., N, 4) × (..., M, 4) → (..., N, M)."""
    return bbox_iou(boxes1[..., :, None, :], boxes2[..., None, :, :], x1y1x2y2)


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
