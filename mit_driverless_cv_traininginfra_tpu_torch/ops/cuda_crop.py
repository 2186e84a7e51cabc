"""K1 — the compacted ROI crop (counterpart of the JAX package's
``ops/pallas_crop.py``).

:func:`roi_crop` launches ``csrc/roi_crop.cu`` for CUDA tensors and takes
its plain version, ``ops.image.roi_crop_bilinear_indexed``, for CPU
tensors. The kernel needs no DMA window, so unlike the TPU kernel it has no
box-size contract and no applicability check: every box is sampled
exactly, and non-finite boxes never read outside the frame.

A call is one launch: the kernel reads the boxes and frame indices as the
pipeline hands them over and computes the sampling coordinates itself,
bit for bit as ``ops.image._crop_coords`` does on the CPU. The wrapper
checks its arguments, allocates the output and launches; nothing else
reaches the card.
"""

from __future__ import annotations

import functools

import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib
from mit_driverless_cv_traininginfra_tpu_torch.ops.image import (
    roi_crop_bilinear_indexed,
)

_BOX_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FIDX_CODES = {torch.int32: 0, torch.int64: 1}


def roi_crop(frames, boxes, frame_idx, out_h: int = 80, out_w: int = 80):
    """frames (B, H, W, C) f32/bf16, boxes (N, 4) xyxy px, frame_idx (N,)
    → crops (N, out_h, out_w, C) in the frame dtype, equal to
    ``roi_crop_bilinear_indexed``. On the card, boxes are f32 or bf16 and
    frame_idx int32 or int64, in any strides."""
    if not frames.is_cuda:
        return roi_crop_bilinear_indexed(frames, boxes, frame_idx, out_h,
                                         out_w)
    B, H, W, C = frames.shape
    N = boxes.shape[0]
    if boxes.shape != (N, 4) or frame_idx.shape != (N,):
        raise ValueError(f"boxes {tuple(boxes.shape)} / frame_idx "
                         f"{tuple(frame_idx.shape)} do not describe N crops")
    dev = frames.device
    if boxes.device != dev or frame_idx.device != dev:
        raise ValueError("frames, boxes and frame_idx must share a device")
    code = _lib.dtype_code(frames.dtype)
    box_code = _BOX_CODES.get(boxes.dtype)
    fidx_code = _FIDX_CODES.get(frame_idx.dtype)
    if box_code is None or fidx_code is None:
        raise TypeError(f"boxes must be f32/bf16 and frame_idx int32/int64, "
                        f"got {boxes.dtype} / {frame_idx.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous (B, H, W, C)")
    out = torch.empty((N, out_h, out_w, C), dtype=frames.dtype, device=dev)
    with _lib.on_device(dev):
        rc = _launch()(
            frames.data_ptr(), boxes.data_ptr(), boxes.stride(0),
            boxes.stride(1), box_code, frame_idx.data_ptr(),
            frame_idx.stride(0), fidx_code, out.data_ptr(), N, B, H, W, C,
            out_h, out_w, code, _lib.stream_ptr(dev))
    _lib.check(rc, "roi_crop")
    roi_crop.launches += 1
    return out


roi_crop.launches = 0


@functools.cache
def _launch():
    """The C entry point, looked up once (the first call builds)."""
    return _lib.lib().mdcv_roi_crop
