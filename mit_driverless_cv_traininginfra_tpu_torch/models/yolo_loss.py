"""YOLO target assignment and the multi-part loss (counterpart of the JAX
package's ``models/yolo_loss.py``; reference ``CVC-YOLOv3/utils/utils.py``
``build_targets`` and ``models.py``'s training branch).

Reference quirks kept, as the JAX package keeps them:

- the anchor-vs-box IoU takes the evaluator's +1 pixel convention on
  ``(0, 0, w, h)`` boxes;
- the ignore cells are batch-global: a (gj, gi) cell whose box passes
  ``ignore_thresh`` against any anchor is dropped from the conf loss of
  every image and every anchor, not only its own;
- padded target rows (all zero) take their image's row 0, so their writes
  repeat row 0's;
- ``gi``/``gj`` truncate the box centre and clip it into the grid;
- anchors are read as (w, h).

Duplicate writes. Two rows that land in one (b, anchor, j, i) cell write
one target slot; XLA:CPU applies scatter updates in order, so the highest
row wins. ``index_put_`` leaves duplicates unspecified (on CUDA the result
varies from run to run), so :func:`build_targets` resolves them itself:
the highest row index per cell by ``scatter_reduce("amax")``, whose value
is then gathered. Card and CPU give the same bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    NetworkSpec,
    YoloBlock,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import (
    head_predictions,
)


class YoloTargets(NamedTuple):
    mask: torch.Tensor       # (B, A, H, W) bool: object cells
    conf_mask: torch.Tensor  # (B, A, H, W) bool: cells in the conf loss
    tx: torch.Tensor
    ty: torch.Tensor
    tw: torch.Tensor
    th: torch.Tensor
    tconf: torch.Tensor
    tcls: torch.Tensor       # (B, A, H, W, C)


def _f32(v) -> float:
    """``v`` (a float, or an int holding its f32 bits) rounded to f32."""
    if isinstance(v, int):
        return float(np.array([v], np.uint32).view(np.float32)[0])
    return float(np.float32(v))


# Cephes logf, the polynomial XLA:CPU evaluates for an f32 log
_LOG_P = tuple(map(_f32, (0x3D9021BB, -1.1514610310e-1, 1.1676998740e-1,
                          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRT_HALF = _f32(0x3F3504F3)
_MIN_NORMAL = _f32(0x00800000)


def _fma(a, b, c):
    """f32 ``a·b + c`` rounded once: the product is exact in f64, the sum
    is rounded to f64 and then to f32 (a double rounding, off only where
    the f64 sum lands exactly between two f32 values)."""
    return (a.double() * b + c).float()


def log_f32(x):
    """The natural log of positive finite f32 ``x`` as XLA:CPU computes it
    (Cephes' ``logf``: exponent split, a degree-8 polynomial evaluated with
    fused multiply-adds), bit for bit. ``torch.log`` differs from it by an
    ulp on ~12% of values, on the CPU and on the card alike, and ``tw``/
    ``th`` of :func:`build_targets` are logs. Every step is an f32 or f64
    operation with one rounding, so the card and the CPU agree."""
    x = x.float().clamp(min=_MIN_NORMAL)
    bits = x.view(torch.int32)
    e = (bits >> 23) - 0x7F
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    e = 1.0 + e.float()
    small = m < _SQRT_HALF
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = t * t
    x3 = x2 * t
    y = _fma(t, _LOG_P[0], _LOG_P[1])
    y1 = _fma(t, _LOG_P[3], _LOG_P[4])
    y2 = _fma(t, _LOG_P[6], _LOG_P[7])
    y = _fma(y, t, _LOG_P[2])
    y1 = _fma(y1, t, _LOG_P[5])
    y2 = _fma(y2, t, _LOG_P[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    t = t - 0.5 * x2
    t = t + y
    return t + _LOG_Q2 * e


def build_targets(target, anchors, num_classes: int, grid_h: int,
                  grid_w: int, ignore_thresh: float) -> YoloTargets:
    """GT → (anchor, cell) assignment of one head.

    ``target``: (B, T, 5) ``[class, cx, cy, w, h]`` normalised to [0, 1],
    all-zero rows are padding. ``anchors``: (A, 2) ``(w, h)`` in grid
    units, an f32 tensor on ``target``'s device."""
    target = target.float()
    dev = target.device
    B, T, _ = target.shape
    A = anchors.shape[0]

    master = target.sum(dim=2) > 0  # (B, T)

    def fill(v):
        # padded rows take row 0's value
        return torch.where(master, v, v[:, 0:1])

    gx = fill(target[:, :, 1] * grid_w)
    gy = fill(target[:, :, 2] * grid_h)
    gw = fill(target[:, :, 3] * grid_w)
    gh = fill(target[:, :, 4] * grid_h)
    gi = gx.to(torch.int32).clamp(0, grid_w - 1).long()
    gj = gy.to(torch.int32).clamp(0, grid_h - 1).long()

    # anchor IoU with the +1 convention on (0, 0, w, h) boxes
    aw, ah = anchors[:, 0], anchors[:, 1]
    inter = ((torch.minimum(gw[..., None], aw) + 1)
             * (torch.minimum(gh[..., None], ah) + 1))
    union = (gw[..., None] + 1) * (gh[..., None] + 1) + (aw + 1) * (ah + 1) - inter
    anch_ious = inter / (union + 1e-12)  # (B, T, A)

    # batch-global ignore cells (reference quirk)
    any_ignore = (anch_ious > ignore_thresh).any(dim=2)
    hw_ignore = torch.zeros(grid_h * grid_w, dtype=torch.int32, device=dev)
    hw_ignore = hw_ignore.scatter_reduce(0, (gj * grid_w + gi).reshape(-1),
                                         any_ignore.reshape(-1).int(), "amax")
    conf_mask = (hw_ignore == 0).reshape(1, 1, grid_h, grid_w).expand(
        B, A, grid_h, grid_w)

    best_n = anch_ious.argmax(dim=2)  # (B, T), first of equal maxima
    b_idx = torch.arange(B, device=dev)[:, None]
    cell = (((b_idx * A + best_n) * grid_h + gj) * grid_w + gi).reshape(-1)
    # the highest row index that writes each cell wins, as XLA's in-order
    # scatter leaves it; -1 where no row writes
    rows = torch.arange(B * T, device=dev)
    winner = torch.full((B * A * grid_h * grid_w,), -1, dtype=torch.int64,
                        device=dev).scatter_reduce(0, cell, rows, "amax")
    mask = winner >= 0
    src = winner.clamp(min=0)
    zero = torch.zeros((), device=dev)

    def put(v):
        return torch.where(mask, v.reshape(-1)[src], zero).reshape(
            B, A, grid_h, grid_w)

    gif, gjf = gi.float(), gj.float()
    tx = put(gx - gif)
    ty = put(gy - gjf)
    tw = put(log_f32(gw / anchors[best_n, 0] + 1e-16))
    th = put(log_f32(gh / anchors[best_n, 1] + 1e-16))
    mask = mask.reshape(B, A, grid_h, grid_w)
    conf_mask = conf_mask | mask
    tconf = mask.float()

    label = target[:, :, 0].to(torch.int32).clamp(0, num_classes - 1).long()
    tcls = torch.zeros(B * A * grid_h * grid_w * num_classes, device=dev)
    # every write of a (cell, class) slot is 1.0: duplicates agree
    tcls = tcls.scatter(0, cell * num_classes + label.reshape(-1), 1.0)
    tcls = tcls.reshape(B, A, grid_h, grid_w, num_classes)
    return YoloTargets(mask, conf_mask, tx, ty, tw, th, tconf, tcls)


def _masked_mean(x, m):
    return (x * m).sum() / m.sum().clamp(min=1.0)


class _Softplus(torch.autograd.Function):
    """``softplus(l) = max(l, 0) + log1p(exp(−|l|))``, the JAX package's
    form (``jnp.logaddexp(l, 0)``), with the gradient ``sigmoid(l)``."""

    @staticmethod
    def forward(ctx, logit):
        ctx.save_for_backward(logit)
        return logit.clamp(min=0) + torch.log1p(torch.exp(-logit.abs()))

    @staticmethod
    def backward(ctx, grad):
        (logit,) = ctx.saved_tensors
        return grad * torch.sigmoid(logit)


def _bce_logits(logit, t):
    """``BCELoss(sigmoid(logit))`` with torch's −100 log clamp, taken from
    logits: log σ(l) = −softplus(−l), log(1 − σ(l)) = −softplus(l), each
    term clamped at 100. Where σ(l) rounds to 1 (l > 16.6) the
    post-sigmoid form reads the clamp (100) for t = 0; this form gives the
    true loss ≈ l up to l = 100, and its gradient stays bounded."""
    return (t * _Softplus.apply(-logit).clamp(max=100.0)
            + (1.0 - t) * _Softplus.apply(logit).clamp(max=100.0))


@functools.cache
def scaled_anchors(anchors: Tuple[Tuple[float, float], ...], stride: float,
                   device: torch.device) -> torch.Tensor:
    """``anchors / stride`` as an f32 (A, 2) tensor on ``device``, divided
    on the host in f32 (the JAX package's ``jnp.asarray(anchors,
    float32) / stride``) and kept per device: no host→device copy per
    step."""
    a = np.asarray(anchors, np.float32) / np.float32(stride)
    return torch.from_numpy(a).to(device)


def yolo_head_loss(head_out, target, anchors: Sequence[Tuple[float, float]],
                   img_height: int, num_classes: int, ignore_thresh: float,
                   xy_loss: float, wh_loss: float, object_loss: float,
                   no_object_loss: float):
    """One head's loss: masked MSE on x, y, w, h, masked BCE on the
    object and no-object cells, no class loss (single-class detection).
    Returns ``(loss, components)``, components ``(x, y, w, h, obj,
    noobj)`` as a (6,) tensor."""
    _, gh, gw, _ = head_out.shape
    stride = img_height / gh  # the height's stride on both axes (reference)
    pred = head_predictions(head_out, len(anchors), num_classes)
    t = build_targets(target, scaled_anchors(tuple(map(tuple, anchors)), stride,
                                             head_out.device),
                      num_classes, gh, gw, ignore_thresh)
    m = t.mask.float()
    noobj = (t.conf_mask & ~t.mask).float()
    loss_x = xy_loss * _masked_mean((pred["x"] - t.tx) ** 2, m)
    loss_y = xy_loss * _masked_mean((pred["y"] - t.ty) ** 2, m)
    loss_w = wh_loss * _masked_mean((pred["w"] - t.tw) ** 2, m)
    loss_h = wh_loss * _masked_mean((pred["h"] - t.th) ** 2, m)
    bce = _bce_logits(pred["conf_logit"], t.tconf)
    loss_noobj = no_object_loss * _masked_mean(bce, noobj)
    loss_obj = object_loss * _masked_mean(bce, m)
    loss = loss_x + loss_y + loss_w + loss_h + loss_noobj + loss_obj
    return loss, torch.stack([loss_x, loss_y, loss_w, loss_h, loss_obj, loss_noobj])


def yolo_loss(spec: NetworkSpec, head_outputs, target, xy_loss: float,
              wh_loss: float, object_loss: float, no_object_loss: float):
    """The sum of the heads' losses: ``(total, components (6,))``."""
    yolo_blocks = [b for b in spec.blocks if isinstance(b, YoloBlock)]
    total, comps = 0.0, 0.0
    for head_out, blk in zip(head_outputs, yolo_blocks):
        loss, c = yolo_head_loss(
            head_out, target, blk.anchors, spec.net.height,
            spec.net.num_classes, spec.net.build_targets_ignore_thresh,
            xy_loss, wh_loss, object_loss, no_object_loss)
        total, comps = total + loss, comps + c
    return total, comps
