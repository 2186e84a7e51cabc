"""Two-stage perception pipeline: YOLO detect → crop → RektNet keypoints
(counterpart of the JAX package's ``infer/pipeline.py``): the bf16/f32
configuration and the int8 one (``two_stage_pipeline_int8``, the same
function).

    frames ─ Darknet ─ decode ─ threshold/top-k/NMS (K3) ─ top-K boxes
           └───────────────────────────────► ROI bilinear crop 80×80 (K1)
                                                └─ RektNet ─ soft-argmax (K2)
                                                        └─ keypoints in frame px

In the int8 configuration the detector is ``Int8Darknet`` (fused entry
with kernel K4, int8 convolutions, bf16 activations) and the keypoint net
``Int8RektNet``; frames are bf16.

Fixed capacity everywhere, as in the JAX package: every frame yields
exactly ``max_det`` slots (masked), and the compacted crop path runs
RektNet on exactly ``crop_capacity`` crops, so no stage waits on the host.
Not ported: ``kpt_pad_multiple`` (a TPU schedule experiment) and
``packed_stem`` (a TPU layout fix).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import YoloHeads
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_crop import roi_crop
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    _topk_stable,
    nms_topk,
)


class PipelineOut(NamedTuple):
    boxes: torch.Tensor      # (B, K, 4) xyxy in frame pixels
    scores: torch.Tensor     # (B, K)
    mask: torch.Tensor       # (B, K) bool — valid detections
    keypoints: torch.Tensor  # (B, K, 7, 2) xy in frame pixels


def _postprocess(dets, conf_thresh: float, nms_thresh: float, max_det: int):
    """decode output (B, N, 5+C) → conf-filtered, NMS'd top-max_det slots
    (boxes, scores, keep)."""
    conf = dets[..., 4]
    xy, wh = dets[..., 0:2], dets[..., 2:4] / 2
    corner = torch.cat([xy - wh, xy + wh], dim=-1)
    return nms_topk(corner, conf, conf_thresh=conf_thresh, k=max_det,
                    overlap=nms_thresh)


def _crops_and_keypoints(kpt_apply, frames, boxes, scores, mask,
                         crop_size: int, crop_capacity):
    """ROI crop + keypoint net, optionally compacted to the valid slots.

    ``crop_capacity=None`` (or ≥ B·K) crops every slot. Otherwise the top
    ``crop_capacity`` slots across the batch — valid first, score
    descending, ties to the lower slot (``lax.top_k`` order) — are cropped,
    run through the net and scattered back; equal to the dense pass when
    #valid ≤ capacity, and an overflow drops the lowest-score keypoints,
    never boxes. Returns ``(pts (B, K, 7, 2) in [0, 1] crop coords,
    kept (B, K) bool)``: ``kept`` marks valid slots whose crop ran."""
    B, K = mask.shape
    flat_boxes = boxes.reshape(B * K, 4)
    if crop_capacity is None or crop_capacity >= B * K:
        fidx = torch.arange(B, device=frames.device).repeat_interleave(K)
        crops = roi_crop(frames, flat_boxes, fidx, crop_size, crop_size)
        return kpt_apply(crops).reshape(B, K, 7, 2), mask
    key = torch.where(mask.reshape(-1), -scores.reshape(-1).float(),
                      torch.full((B * K,), torch.inf, device=mask.device))
    sel = _topk_stable(-key, crop_capacity)[1]
    crops_c = roi_crop(frames, flat_boxes[sel], sel // K, crop_size,
                       crop_size)
    pts_c = kpt_apply(crops_c)  # (C, 7, 2)
    pts = torch.zeros((B * K, 7, 2), dtype=pts_c.dtype, device=pts_c.device)
    pts[sel] = pts_c
    # index_fill_ takes the value as a kernel argument; kept[sel] = True
    # would copy a host scalar to the device and wait for it
    kept = torch.zeros((B * K,), dtype=torch.bool, device=mask.device)
    kept.index_fill_(0, sel, True)
    kept &= mask.reshape(-1)
    return pts.reshape(B, K, 7, 2), kept.reshape(B, K)


def normalize_u8(frames):
    """uint8 frames → f32 in [0, 1] as ``x · fl(1/255)``: bit-equal to the
    JAX package's jitted ``u8.astype(f32) / 255.0``. A division by the
    Python scalar would be the IEEE quotient on the CPU (1 ulp off for 126
    of the 256 values) and the reciprocal product on the card."""
    return frames.float() * (1.0 / 255.0)


@torch.inference_mode()
def two_stage_pipeline(yolo: YoloHeads, rekt, frames,
                       conf_thresh: float = 0.8, nms_thresh: float = 0.25,
                       max_det: int = 16, crop_size: int = 80,
                       crop_capacity=None) -> PipelineOut:
    """frames (B, H, W, 3) in [0, 1] (or uint8), H/W = the spec's input
    size, on the models' device; ``yolo`` is a ``Darknet`` or an
    ``Int8Darknet``, ``rekt`` a ``RektNet`` or an ``Int8RektNet``.

    uint8 frames are the wire-efficient feed: normalised on the device in
    f32 and cast to ``yolo.frame_dtype`` (bf16 for int8). The normalise is
    ``x · fl(1/255)``, which is what the JAX package's jitted ``/ 255``
    compiles to (XLA folds a constant divisor into a reciprocal multiply),
    on the CPU and on the card alike. Dropped and invalid slots get
    all-zero keypoints (a detectable sentinel), not the box corner."""
    if frames.dtype == torch.uint8:
        frames = normalize_u8(frames).to(yolo.frame_dtype)
    dets = yolo(frames)  # (B, N, 5): the 1-class decode
    boxes, scores, mask = _postprocess(dets, conf_thresh, nms_thresh, max_det)
    pts, kept = _crops_and_keypoints(lambda c: rekt(c)[1], frames, boxes,
                                     scores, mask, crop_size, crop_capacity)
    x0y0 = boxes[..., None, 0:2]
    wh_box = (boxes[..., 2:4] - boxes[..., 0:2])[..., None, :]
    kpts = torch.where(kept[..., None, None], x0y0 + pts * wh_box,
                       torch.zeros((), device=boxes.device))
    return PipelineOut(boxes, scores, mask, kpts)


# The int8 serving configuration (the JAX package's two_stage_pipeline_int8
# with entry_q inside the detector) runs the same stages on the models of
# models.quantize: calibrate → quantize_params → Int8Darknet (fused entry,
# kernel K4) and calibrate_rektnet → quantize_rektnet_params → Int8RektNet.
two_stage_pipeline_int8 = two_stage_pipeline
