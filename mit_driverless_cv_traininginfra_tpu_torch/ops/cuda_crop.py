"""K1 — the compacted ROI crop (counterpart of the JAX package's
``ops/pallas_crop.py``).

:func:`roi_crop` launches ``csrc/roi_crop.cu`` for CUDA tensors and takes
its plain version, ``ops.image.roi_crop_bilinear_indexed``, for CPU
tensors. The kernel needs no DMA window, so unlike the TPU kernel it has no
box-size contract and no applicability check: every box is sampled
exactly, and non-finite boxes never read outside the frame.
"""

from __future__ import annotations

import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib
from mit_driverless_cv_traininginfra_tpu_torch.ops.image import (
    _crop_coords,
    roi_crop_bilinear_indexed,
)


def roi_crop(frames, boxes, frame_idx, out_h: int = 80, out_w: int = 80):
    """frames (B, H, W, C) f32/bf16, boxes (N, 4) xyxy px, frame_idx (N,)
    → crops (N, out_h, out_w, C) in the frame dtype, equal to
    ``roi_crop_bilinear_indexed``."""
    if not frames.is_cuda:
        return roi_crop_bilinear_indexed(frames, boxes, frame_idx, out_h,
                                         out_w)
    B, H, W, C = frames.shape
    N = boxes.shape[0]
    if boxes.shape != (N, 4) or frame_idx.shape != (N,):
        raise ValueError(f"boxes {tuple(boxes.shape)} / frame_idx "
                         f"{tuple(frame_idx.shape)} do not describe N crops")
    if boxes.device != frames.device or frame_idx.device != frames.device:
        raise ValueError("frames, boxes and frame_idx must share a device")
    code = _lib.dtype_code(frames.dtype)
    frames = frames.contiguous()
    sx, sy = _crop_coords(boxes, out_h, out_w, H, W)
    sx, sy = sx.contiguous(), sy.contiguous()
    fidx = frame_idx.to(torch.int32).contiguous()
    out = torch.empty((N, out_h, out_w, C), dtype=frames.dtype,
                      device=frames.device)
    with torch.cuda.device(frames.device):
        rc = _lib.lib().mdcv_roi_crop(
            frames.data_ptr(), sx.data_ptr(), sy.data_ptr(), fidx.data_ptr(),
            out.data_ptr(), N, B, H, W, C, out_h, out_w, code,
            _lib.stream_ptr(frames.device))
    _lib.check(rc, "roi_crop")
    roi_crop.launches += 1
    return out


roi_crop.launches = 0
