"""ROI crops of the detect→keypoints bridge (counterpart of the JAX
package's ``ops/image.py``): the plain PyTorch versions of kernel K1.

Bilinear resampling is written, as in the JAX package, as two contractions
against two-tap "hat" matrices: rows first, then columns. Sample
coordinates are always f32 (bf16 cannot address pixels above 256 exactly);
the hat weights, which live in [0, 1], are rounded to the frame dtype.
Each contraction accumulates in f32 and rounds its result to the frame
dtype, which is what the JAX einsums do on the TPU's matrix unit and what
``csrc/roi_crop.cu`` reproduces.
"""

from __future__ import annotations

import torch


def _crop_coords(boxes, out_h: int, out_w: int, H: int, W: int):
    """Source sampling centres (half-pixel convention), border-replicated at
    the crop edge, then clipped to the frame; f32 whatever the box dtype.
    Returns ``(sx (..., out_w), sy (..., out_h))``."""
    boxes = boxes.to(torch.float32)
    x0, y0, x1, y1 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    bw = torch.clamp(x1 - x0, min=1e-3)
    bh = torch.clamp(y1 - y0, min=1e-3)
    dev = boxes.device
    js = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w
    is_ = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h
    sx = x0[..., None] + bw[..., None] * js - 0.5
    sy = y0[..., None] + bh[..., None] * is_ - 0.5
    sx = _clip(sx, x0[..., None], x1[..., None] - 1.0)
    sy = _clip(sy, y0[..., None], y1[..., None] - 1.0)
    sx = sx.clamp(0.0, W - 1.0)
    sy = sy.clamp(0.0, H - 1.0)
    return sx, sy


def _clip(x, lo, hi):
    """``jnp.clip`` with array bounds: ``minimum(maximum(x, lo), hi)``."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _hat_matrix(s, size: int):
    """Row i holds the two-tap weights ``clip(1 - |s_i - j|, 0, 1)`` over
    source positions j: contracting with the image is the resample."""
    grid = torch.arange(size, dtype=s.dtype, device=s.device)
    return torch.clamp(1.0 - torch.abs(s[..., None] - grid), 0.0, 1.0)


def _contract(eq: str, hat, x, dtype):
    """One resample pass: f32 accumulate, rounded to ``dtype``."""
    return torch.einsum(eq, hat.float(), x.float()).to(dtype)


def roi_crop_bilinear(frames, boxes, out_h: int = 80, out_w: int = 80):
    """Dense crop: frames (B, H, W, C), boxes (B, K, 4) xyxy in frame px →
    crops (B, K, out_h, out_w, C) in the frame dtype."""
    B, H, W, C = frames.shape
    K = boxes.shape[1]
    sx, sy = _crop_coords(boxes, out_h, out_w, H, W)
    Ry = _hat_matrix(sy, H).to(frames.dtype)  # (B, K, oh, H)
    Rx = _hat_matrix(sx, W).to(frames.dtype)  # (B, K, ow, W)
    rows = _contract("bkih,bhm->bkim", Ry, frames.reshape(B, H, W * C),
                     frames.dtype).reshape(B, K, out_h, W, C)
    return _contract("bkjw,bkiwc->bkijc", Rx, rows, frames.dtype)


def roi_crop_bilinear_indexed(frames, boxes, frame_idx, out_h: int = 80,
                              out_w: int = 80):
    """Compacted crop: boxes (N, 4) addressed into the batch by frame_idx
    (N,) → crops (N, out_h, out_w, C). Equal to :func:`roi_crop_bilinear`
    on the addressed slots (same contractions after a frame gather)."""
    B, H, W, C = frames.shape
    n = boxes.shape[0]
    sx, sy = _crop_coords(boxes, out_h, out_w, H, W)
    Ry = _hat_matrix(sy, H).to(frames.dtype)  # (N, oh, H)
    Rx = _hat_matrix(sx, W).to(frames.dtype)  # (N, ow, W)
    fr = frames.reshape(B, H, W * C)[frame_idx.long()]  # (N, H, W*C)
    rows = _contract("cih,chm->cim", Ry, fr, frames.dtype).reshape(
        n, out_h, W, C)
    return _contract("cjw,ciwk->cijk", Rx, rows, frames.dtype)
