"""YOLO and RektNet train and eval steps (counterpart of the JAX package's
``train/steps.py``; reference ``CVC-YOLOv3/train.py`` and
``RektNet/train_eval.py``).

A train step is forward → loss → backward → optimizer step on one device,
with the losses left on the device (the caller reads them when it logs).
The model holds f32 master parameters and the BN running stats
(:class:`models.darknet.TrainDarknet`, :class:`models.rektnet.KeypointNet`);
``compute_dtype="bfloat16"`` casts the parameters and the inputs to bf16
for the compute, as the JAX step casts its parameter tree (not
``torch.autocast``, which rounds elsewhere), while batch statistics, the
loss and the update stay f32.
"""

from __future__ import annotations

import torch

from mit_driverless_cv_traininginfra_tpu_torch.models.cross_ratio_loss import (
    cross_ratio_loss,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.yolo_loss import yolo_loss
from mit_driverless_cv_traininginfra_tpu_torch.ops.heatmap import gaussian_heatmaps
from mit_driverless_cv_traininginfra_tpu_torch.train.optim import optimizer_step


def _compute_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {name!r}")
    if dtype == torch.float32:
        # f32 means f32 on the card too: cuDNN would run f32 convolutions
        # in TF32 (about three decimal digits) unless told not to. This
        # sets the process-wide flags.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dtype


def yolo_train_step(model, opt, images, targets, xy_loss: float = 2.0,
                    wh_loss: float = 1.6, object_loss: float = 0.1,
                    no_object_loss: float = 25.0, compute_dtype: str = "float32"):
    """One step on (B, H, W, 3) ``images`` in [0, 1] and (B, T, 5)
    ``targets`` (normalised ``[class, cx, cy, w, h]``, zero rows are
    padding), both on the model's device. Updates the :class:`TrainDarknet`'s
    parameters (through ``opt``) and BN running stats in place; returns
    ``(loss, components (6,))`` as f32 tensors on the device, with no host
    sync. The heads are cast back to f32 before the loss. In f32 the step
    turns TF32 off (cuDNN and matmul flags), so f32 is f32 on the card."""
    dtype = _compute_dtype(compute_dtype)
    opt.zero_grad(set_to_none=True)
    heads = [h.float() for h in model.forward_features(images, train=True,
                                                       dtype=dtype)]
    loss, comps = yolo_loss(model.spec, heads, targets, xy_loss, wh_loss,
                            object_loss, no_object_loss)
    loss.backward()
    optimizer_step(opt)
    return loss.detach(), comps.detach()


@torch.no_grad()
def yolo_eval_step(model, images, targets, xy_loss: float = 2.0,
                   wh_loss: float = 1.6, object_loss: float = 0.1,
                   no_object_loss: float = 25.0):
    """Eval-mode forward (running stats, f32) and the loss: ``(loss,
    components (6,))``."""
    heads = model.forward_features(images, train=False)
    return yolo_loss(model.spec, heads, targets, xy_loss, wh_loss,
                     object_loss, no_object_loss)


def rektnet_train_step(model, opt, images, target_hm, target_points,
                       loss_type: str = "l1_softargmax", include_geo: bool = True,
                       geo_loss_gamma_horz: float = 0.0,
                       geo_loss_gamma_vert: float = 0.0, cross_batch: bool = True,
                       compute_dtype: str = "float32",
                       synth_target_sigma: float = 0.0):
    """One step on (B, H, W, 3) ``images``, (B, K, H, W) ``target_hm`` and
    (B, K, 2) ``target_points``, all on the model's device. Updates the
    model's parameters (through ``opt``) and BN running stats in place;
    returns ``(total, location, geo)`` losses as 0-d f32 tensors.

    ``synth_target_sigma > 0`` ignores ``target_hm`` and makes unit-sum
    Gaussian targets around ``target_points`` on the device. In f32 the
    step turns TF32 off (cuDNN and matmul flags), so f32 is f32 on the
    card."""
    dtype = _compute_dtype(compute_dtype)
    if synth_target_sigma > 0:
        target_hm = gaussian_heatmaps(target_points, images.shape[1],
                                      images.shape[2], sigma=synth_target_sigma)
    opt.zero_grad(set_to_none=True)
    hm, pts = model(images, train=True, dtype=dtype)
    loc, geo, total = cross_ratio_loss(
        hm.float(), pts.float(), target_hm, target_points, loss_type=loss_type,
        include_geo=include_geo, geo_loss_gamma_horz=geo_loss_gamma_horz,
        geo_loss_gamma_vert=geo_loss_gamma_vert, cross_batch=cross_batch)
    total.backward()
    optimizer_step(opt)
    return total.detach(), loc.detach(), geo.detach()


@torch.no_grad()
def rektnet_eval_step(model, images, target_hm, target_points,
                      loss_type: str = "l1_softargmax", include_geo: bool = True,
                      geo_loss_gamma_horz: float = 0.0,
                      geo_loss_gamma_vert: float = 0.0, cross_batch: bool = True):
    """Eval-mode forward (running stats, f32) and losses: ``(total,
    location, geo, points (B, K, 2))``."""
    hm, pts = model(images, train=False)
    loc, geo, total = cross_ratio_loss(
        hm, pts, target_hm, target_points, loss_type=loss_type,
        include_geo=include_geo, geo_loss_gamma_horz=geo_loss_gamma_horz,
        geo_loss_gamma_vert=geo_loss_gamma_vert, cross_batch=cross_batch)
    return total, loc, geo, pts
