"""Detection metrics: the per-image AP / recall / precision evaluator,
batched (counterpart of the JAX package's ``ops/metrics.py``; reference
``CVC-YOLOv3/utils/utils.py`` ``ap_per_class``/``compute_ap`` and
``validate.py``).

Per image: detections over ``conf_thresh`` go through the greedy NMS
(``ops.nms.batched_nms``, IoU without the +1 pixel), each kept detection in
descending confidence is matched to its best-IoU label (IoU with the +1
pixel convention): a true positive iff that IoU exceeds ``iou_thresh`` and
the label is not claimed yet; then the envelope AP. The JAX package runs
the matching as a ``fori_loop`` per image under ``vmap``; here one loop of
``top_k`` steps runs over the whole batch, on the device.

Reference quirks kept: a label row counts only if all of x, y, w, h are
> 0 (which also drops real boxes touching the left or top edge), and an
image with no kept detection or no label is left out of the means.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops.boxes import (
    bbox_iou_pairwise,
    xywh2xyxy,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.nms import batched_nms


def compute_ap(recall, precision):
    """Envelope AP over the last axis: sentinels (0, recall…, 1) and (0,
    precision…, 0), the precision's running maximum from the right, then
    Σ Δrecall · precision."""
    lead = recall.shape[:-1]
    zeros, ones = recall.new_zeros(lead + (1,)), recall.new_ones(lead + (1,))
    mrec = torch.cat([zeros, recall, ones], dim=-1)
    mpre = torch.cat([zeros, precision, zeros], dim=-1)
    mpre = mpre.flip(-1).cummax(dim=-1).values.flip(-1)
    return ((mrec[..., 1:] - mrec[..., :-1]) * mpre[..., 1:]).sum(dim=-1)


def average_precision(tp, conf, n_gt, valid=None):
    """AP, recall and precision of one image's detections, or of each row
    of a batch (last axis K): ``tp`` 0/1, ``conf`` and ``valid`` (K,) (all
    valid by default), ``n_gt`` the image's label count. The detections
    are ranked by confidence, stably (ties keep their order)."""
    tp = torch.as_tensor(tp, dtype=torch.float32)
    conf = torch.as_tensor(conf, dtype=torch.float32, device=tp.device)
    if valid is None:
        valid = torch.ones(tp.shape, dtype=torch.bool, device=tp.device)
    n_gt = torch.as_tensor(n_gt, device=tp.device)[..., None].float()
    v = valid.float()
    key = -torch.where(valid, conf, torch.full_like(conf, -float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)
    v = v.gather(-1, order)
    tp = tp.gather(-1, order) * v
    fp = (1.0 - tp) * v
    tpc, fpc = tp.cumsum(-1), fp.cumsum(-1)
    recall_curve = tpc / (n_gt + 1e-16)
    precision_curve = tpc / (tpc + fpc).clamp(min=1e-16)
    r = tpc[..., -1] / (n_gt[..., 0] + 1e-16)
    p = tpc[..., -1] / (tpc[..., -1] + fpc[..., -1]).clamp(min=1e-16)
    return compute_ap(recall_curve, precision_curve), r, p


def greedy_match(det_boxes, det_valid, gt_boxes, gt_valid, iou_thresh: float):
    """One detection per label, greedily in detection order (the caller
    sorts by descending confidence): (B, K, 4) xyxy detections with
    (B, K) validity against (B, G, 4) labels with (B, G) validity.
    Returns (B, K) f32 true-positive flags.

    One loop over the detection slots for the whole batch, up to the last
    slot that any image fills (one host read)."""
    B, K = det_valid.shape
    ious = bbox_iou_pairwise(det_boxes, gt_boxes)  # (B, K, G)
    ious = torch.where(gt_valid[:, None, :], ious, torch.full_like(ious, -1.0))
    best = ious.argmax(dim=-1)                                   # (B, K)
    best_iou = ious.gather(-1, best[..., None])[..., 0]
    hit = det_valid & (best_iou > iou_thresh)
    used = torch.nonzero(det_valid.any(dim=0))
    n = int(used.max()) + 1 if used.numel() else 0
    detected = torch.zeros(gt_valid.shape, dtype=torch.bool, device=det_valid.device)
    correct = torch.zeros((B, K), dtype=torch.float32, device=det_valid.device)
    for i in range(n):
        b = best[:, i:i + 1]
        ok = hit[:, i:i + 1] & ~detected.gather(1, b)
        correct[:, i:i + 1] = ok.float()
        detected.scatter_(1, b, detected.gather(1, b) | ok)
    return correct


class ImageEval(NamedTuple):
    ap: torch.Tensor
    recall: torch.Tensor
    precision: torch.Tensor
    valid: torch.Tensor  # bool: the image counts in the means


def evaluate_image_batch(detections, labels, img_width: int, img_height: int,
                         conf_thresh: float, nms_thresh: float,
                         iou_thresh: float, top_k: int = 200) -> ImageEval:
    """Per-image evaluation of a batch. ``detections``: (B, N, 5+C) [cx,
    cy, w, h, conf, cls…] in input pixels (the eval decode); ``labels``:
    (B, T, 5) normalised [class, cx, cy, w, h], zero rows are padding.
    Returns (B,) AP, recall, precision and the validity flag."""
    labels = torch.as_tensor(labels, dtype=torch.float32, device=detections.device)
    conf = detections[..., 4]
    boxes = xywh2xyxy(detections[..., 0:4])
    scores = torch.where(conf > conf_thresh, conf, torch.full_like(conf, -float("inf")))
    keep_idx, keep_mask = batched_nms(boxes, scores, overlap=nms_thresh, top_k=top_k)
    det_boxes = boxes.gather(1, keep_idx[..., None].expand(-1, -1, 4))
    det_conf = conf.gather(1, keep_idx)  # kept slots are in descending conf
    lab_valid = (labels[..., 1:5] <= 0).sum(dim=-1) == 0
    gt = xywh2xyxy(labels[..., 1:5]) * detections.new_tensor(
        [img_width, img_height, img_width, img_height])
    correct = greedy_match(det_boxes, keep_mask, gt, lab_valid, iou_thresh)
    n_gt = lab_valid.sum(dim=-1)
    ap, r, p = average_precision(correct, det_conf, n_gt, valid=keep_mask)
    valid = (keep_mask.sum(dim=-1) > 0) & (n_gt > 0)
    return ImageEval(ap, r, p, valid)


def summarize(ev: ImageEval):
    """Means of AP, recall and precision over the valid images (0.0 each
    when none is), on the host."""
    valid = ev.valid.cpu().numpy()
    if valid.sum() == 0:
        return 0.0, 0.0, 0.0
    return tuple(float(x.cpu().numpy()[valid].mean())
                 for x in (ev.ap, ev.recall, ev.precision))
