"""Image ops (counterpart of the JAX package's ``ops/image.py``): the
letterbox of the detection path, and the ROI crops of the
detect→keypoints bridge, the plain PyTorch versions of kernel K1.

The letterbox pads to the model's aspect ratio with the reference's grey
and resizes as ``jax.image.resize(method="linear")`` does, antialias
included: separable weight matrices (a triangle filter widened by the
scale when downsampling, each column normalised) contracted with the
image; ``F.interpolate(antialias=False)`` keeps two taps when
downsampling, so it is not this function.

Bilinear resampling is written, as in the JAX package, as two contractions
against two-tap "hat" matrices: rows first, then columns. Sample
coordinates are always f32 (bf16 cannot address pixels above 256 exactly);
the hat weights, which live in [0, 1], are rounded to the frame dtype.
Each contraction accumulates in f32 and rounds its result to the frame
dtype, which is what the JAX einsums do on the TPU's matrix unit and what
``csrc/roi_crop.cu`` reproduces.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

GREY = 127.0 / 255.0  # the reference's pad fill (127, 127, 127) in [0, 1]


def pad_to(x, pad_h: int, pad_w: int, fill: float = GREY):
    """Symmetric constant pad of NHWC or HWC: ``pad_h`` rows above and
    below, ``pad_w`` columns left and right."""
    return F.pad(x, (0, 0, pad_w, pad_w, pad_h, pad_h), value=fill)


@functools.cache
def _resize_weights(in_size: int, out_size: int, device="cpu"):
    """(in_size, out_size) f32 weights of ``jax.image.resize``'s linear
    method with antialiasing (``jax/_src/image/scale.py:compute_weight_mat``
    at scale ``out/in``, no translation), built on the CPU in its order of
    operations and copied once per device: sample centres ``(j + 0.5) ·
    (in/out) − 0.5``; the triangle ``max(0, 1 − |s − i| / k)`` with ``k =
    max(in/out, 1)``; each column divided by its sum (zero where the sum
    is ~0); columns whose centre lies outside the input zeroed."""
    inv_scale = 1.0 / (out_size / in_size)  # Python floats, as JAX has them
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=torch.float32)
    sample = ((torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale
              - 0.5)
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp_min(1.0 - x.abs(), 0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_bilinear(x, out_h: int, out_w: int):
    """``jax.image.resize(x, ..., method="linear")`` (antialiased: the
    filter widens when downsampling) of NHWC or HWC ``x``, in f32 (an
    integer image is taken as f32 first). An axis whose size does not
    change is left as it is, as JAX leaves it."""
    batched = x.dim() == 4
    if not batched:
        x = x[None]
    if not x.is_floating_point():
        x = x.float()
    _, h, w, _ = x.shape
    if h != out_h:
        x = torch.einsum("bhwc,ho->bowc", x,
                         _resize_weights(h, out_h, x.device).to(x.dtype))
    if w != out_w:
        x = torch.einsum("bhwc,wo->bhoc", x,
                         _resize_weights(w, out_w, x.device).to(x.dtype))
    return x if batched else x[0]


def letterbox(x, out_h: int, out_w: int, fill: float = GREY):
    """Pad to the output's aspect ratio, then resize (the reference's
    ``detect.py`` letterbox and ``calculate_padding``) of NHWC or HWC
    ``x``. Returns ``(image, (pad_h, pad_w, ratio))``; ``ratio`` maps
    original pixels to output pixels."""
    h, w = (x.shape[1], x.shape[2]) if x.dim() == 4 else (x.shape[0], x.shape[1])
    if max(h, w) == h:
        new_w = h * out_w / out_h
        ratio = out_h / h
        pad_h, pad_w = 0, int((new_w - w) / 2)
    else:
        ratio = out_w / w
        new_h = w * out_h / out_w
        pad_w, pad_h = 0, int((new_h - h) / 2)
    padded = pad_to(x, pad_h, pad_w, fill)
    return resize_bilinear(padded, out_h, out_w), (pad_h, pad_w, ratio)


def _crop_coords(boxes, out_h: int, out_w: int, H: int, W: int):
    """Source sampling centres (half-pixel convention), border-replicated at
    the crop edge, then clipped to the frame; f32 whatever the box dtype.
    Returns ``(sx (..., out_w), sy (..., out_h))``."""
    boxes = boxes.to(torch.float32)
    x0, y0, x1, y1 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    bw = torch.clamp(x1 - x0, min=1e-3)
    bh = torch.clamp(y1 - y0, min=1e-3)
    js, is_ = _centres(out_w, boxes.device), _centres(out_h, boxes.device)
    sx = x0[..., None] + bw[..., None] * js - 0.5
    sy = y0[..., None] + bh[..., None] * is_ - 0.5
    sx = _clip(sx, x0[..., None], x1[..., None] - 1.0)
    sy = _clip(sy, y0[..., None], y1[..., None] - 1.0)
    sx = sx.clamp(0.0, W - 1.0)
    sy = sy.clamp(0.0, H - 1.0)
    return sx, sy


@functools.cache
def _centres(n: int, device):
    """``(arange(n) + 0.5) / n`` in f32, the IEEE quotients. Built on the
    CPU and copied once per device: on the card, PyTorch divides by a
    Python scalar as ``a · (1/n)``, 1 ulp off the quotient at 16 of the 80
    centres of an 80-wide crop."""
    return ((torch.arange(n, dtype=torch.float32) + 0.5) / n).to(device)


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
