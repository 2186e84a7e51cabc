"""Pipeline-parallel serving: the two-stage program split across devices
(counterpart of the JAX package's ``infer/pp.py``).

The fused ``two_stage_pipeline`` (``infer/pipeline.py``) is the one-device
form. Here its natural graph boundary becomes a device boundary:

    stage A (device_a): detect → NMS (K3) → top-C crop compaction → crops (K1)
    stage B (device_b): RektNet → soft-argmax (K2) → frame-px scatter

The tensor between them is the compacted crop buffer, (C, 80, 80, 3) and a
few (B, K) vectors, copied to ``device_b`` without blocking. CUDA's
launches return at once, so :class:`TwoStagePP` enqueues stage A of batch
i+1 before stage B of batch i and reads nothing on the host in between:
on two cards the stages overlap.

Selection as the fused path's compaction: valid first, score descending,
ties to the lower slot (``lax.top_k``'s order), capacity C across the
batch, ``C = min(crop_capacity, B·K)``; an overflow drops the lowest-score
keypoints, never boxes. Masks and boxes equal the fused pipeline's;
keypoints come from the same crops.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
    PipelineOut,
    _postprocess,
    kept_slots,
    normalize_u8,
    top_crop_slots,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_crop import roi_crop
from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import module_on


class StageAOut(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4) xyxy frame px
    scores: torch.Tensor   # (B, K)
    mask: torch.Tensor     # (B, K) bool
    sel: torch.Tensor      # (C,) flat crop-slot indices (batch-global top-C)
    crops: torch.Tensor    # (C, S, S, 3) compacted ROI crops


@torch.inference_mode()
def detect_stage(yolo, frames, conf_thresh: float = 0.8, nms_thresh: float = 0.25,
                 max_det: int = 16, crop_size: int = 80,
                 crop_capacity: int = 64) -> StageAOut:
    """Detect + NMS + batch-global top-C crop compaction (stage A) on
    ``yolo``'s device; uint8 frames are normalised there."""
    if frames.dtype == torch.uint8:
        frames = normalize_u8(frames).to(yolo.frame_dtype)
    boxes, scores, mask = _postprocess(yolo(frames), conf_thresh, nms_thresh,
                                       max_det)
    B, K = mask.shape
    # the selection cannot be wider than the slots: capacity ≥ B·K keeps
    # every crop
    sel = top_crop_slots(mask, scores, min(crop_capacity, B * K))
    crops = roi_crop(frames, boxes.reshape(B * K, 4)[sel], sel // K, crop_size,
                     crop_size)
    return StageAOut(boxes, scores, mask, sel, crops)


@torch.inference_mode()
def keypoint_stage(rekt, a: StageAOut) -> PipelineOut:
    """RektNet on the compacted crops + frame-px scatter (stage B)."""
    pts_c = rekt(a.crops)[1]
    B, K = a.mask.shape
    pts = torch.zeros((B * K, 7, 2), dtype=pts_c.dtype, device=pts_c.device)
    pts[a.sel] = pts_c
    pts = pts.reshape(B, K, 7, 2)
    kept = kept_slots(a.sel, a.mask)
    x0y0 = a.boxes[..., None, 0:2]
    wh_box = (a.boxes[..., 2:4] - a.boxes[..., 0:2])[..., None, :]
    kpts = torch.where(kept[..., None, None], x0y0 + pts * wh_box,
                       torch.zeros((), device=pts.device))
    return PipelineOut(a.boxes, a.scores, a.mask, kpts)


class TwoStagePP:
    """Stage A on ``device_a`` (a copy of ``yolo`` there unless it is there
    already), stage B on ``device_b`` (likewise ``rekt``).

    ``__call__`` takes a sequence of frame batches (microbatches) and
    returns one ``PipelineOut`` a batch, on ``device_b``. Dispatch order
    interleaves the stages, A(i+1) enqueued before B(i), with no host read;
    nothing is waited for until the caller reads a result."""

    def __init__(self, yolo, rekt, device_a, device_b, conf_thresh: float = 0.8,
                 nms_thresh: float = 0.25, max_det: int = 16, crop_size: int = 80,
                 crop_capacity: int = 64):
        self.device_a, self.device_b = resolve_device(device_a), resolve_device(device_b)
        self.yolo = module_on(yolo, self.device_a)
        self.rekt = module_on(rekt, self.device_b)
        self._cfg = dict(conf_thresh=conf_thresh, nms_thresh=nms_thresh,
                         max_det=max_det, crop_size=crop_size,
                         crop_capacity=crop_capacity)

    def _a(self, frames) -> StageAOut:
        frames = torch.as_tensor(frames).to(self.device_a, non_blocking=True)
        return detect_stage(self.yolo, frames, **self._cfg)

    def _b(self, a: StageAOut) -> PipelineOut:
        a = StageAOut(*(x.to(self.device_b, non_blocking=True) for x in a))
        return keypoint_stage(self.rekt, a)

    def __call__(self, frame_batches: Sequence) -> list:
        outs, pending = [], None
        for fr in frame_batches:
            a = self._a(fr)          # enqueue A(i)
            if pending is not None:
                outs.append(self._b(pending))  # B(i-1) behind A(i)
            pending = a
        if pending is not None:
            outs.append(self._b(pending))
        return outs
