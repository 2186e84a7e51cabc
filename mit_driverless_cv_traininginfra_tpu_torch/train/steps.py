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

Several devices: every step takes ``mesh``, a process mesh
(``parallel/mesh.py``) of which this process is one rank, its inputs this
rank's rows of the global batch. Batch norm takes the global batch's
statistics, the losses are this rank's shares of the global loss, the
gradients are summed over the ranks before the clip and the update (so the
parameters, running stats and optimizer state stay equal on every rank),
and the losses returned are the global ones, equal on every rank.

The YOLO steps also take a 2-D ``(data, model)`` mesh (``Mesh2D``), under
which the model is a tensor-parallel :class:`TrainDarknet` on its
``model`` sub-mesh: the batch norms, the loss and the reported values then
sum over the ``data`` sub-mesh as above, and the optimizer step sums the
gradients there (``optimizer_step``).

``packed_stem=True`` trains blocks 0-1 through the packed space-to-depth
stem (``TrainDarknet.forward_features(packed_stem=True)``), alone or
under a process mesh; the spec must be ``stem_is_packable``, and a
tensor-parallel model refuses it.
"""

from __future__ import annotations

import torch

from mit_driverless_cv_traininginfra_tpu_torch.models.cross_ratio_loss import (
    cross_ratio_loss,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.yolo_loss import yolo_loss
from mit_driverless_cv_traininginfra_tpu_torch.ops import device_aug
from mit_driverless_cv_traininginfra_tpu_torch.ops.heatmap import gaussian_heatmaps
from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import all_sum_, data_axis
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
                    no_object_loss: float = 25.0, compute_dtype: str = "float32",
                    mesh=None, packed_stem: bool = False):
    """One step on (B, H, W, 3) ``images`` in [0, 1] and (B, T, 5)
    ``targets`` (normalised ``[class, cx, cy, w, h]``, zero rows are
    padding), both on the model's device. Updates the :class:`TrainDarknet`'s
    parameters (through ``opt``) and BN running stats in place; returns
    ``(loss, components (6,))`` as f32 tensors on the device, with no host
    sync. The heads are cast back to f32 before the loss. In f32 the step
    turns TF32 off (cuDNN and matmul flags), so f32 is f32 on the card."""
    dtype = _compute_dtype(compute_dtype)
    dp = data_axis(mesh)
    opt.zero_grad(set_to_none=True)
    heads = [h.float() for h in model.forward_features(
        images, train=True, dtype=dtype, mesh=dp, packed_stem=packed_stem)]
    loss, comps = yolo_loss(model.spec, heads, targets, xy_loss, wh_loss,
                            object_loss, no_object_loss, mesh=dp)
    loss.backward()
    optimizer_step(opt, mesh)
    return _global(dp, loss.detach(), comps.detach())


def yolo_train_step_device_aug(model, opt, images, labels_px, draws: dict,
                               xy_loss: float = 2.0, wh_loss: float = 1.6,
                               object_loss: float = 0.1,
                               no_object_loss: float = 25.0,
                               compute_dtype: str = "float32", mesh=None,
                               packed_stem: bool = False):
    """:func:`yolo_train_step` with the augmentation on the device in front
    of it (the JAX package's ``yolo_train_step_device_aug``): ``images``
    (B, H, W, C) as the dataset made them (``device_aug=True``: patched,
    affine-warped on the host) and ``labels_px`` (B, T, 5) pixel-corner
    labels, both on the model's device; ``draws`` from
    ``ops.device_aug.sample_draws`` on that device. The batch is augmented
    (``device_aug.apply``), its labels normalised to ``[c, cx, cy, w, h]``
    with the zero rows kept, and then stepped as :func:`yolo_train_step`
    steps. No host sync. Under a ``mesh`` the draws are the global batch's
    and this rank takes its rows of them."""
    _, H, W, _ = images.shape
    if mesh is not None:
        draws = {k: v[data_axis(mesh).rows(v.shape[0])] for k, v in draws.items()}
    images, labels_px = device_aug.apply(images, labels_px, draws)
    targets = device_aug.pixel_labels_to_targets(labels_px, H, W)
    return yolo_train_step(model, opt, images, targets, xy_loss=xy_loss,
                           wh_loss=wh_loss, object_loss=object_loss,
                           no_object_loss=no_object_loss,
                           compute_dtype=compute_dtype, mesh=mesh,
                           packed_stem=packed_stem)


def _global(mesh, *shares):
    """The global values of per-rank shares (one all-reduce for all of
    them); the values themselves without a mesh."""
    if mesh is None:
        return shares
    flat = all_sum_(torch.cat([x.reshape(-1) for x in shares]), mesh)
    return tuple(v.reshape(x.shape) for v, x in
                 zip(flat.split([x.numel() for x in shares]), shares))


@torch.no_grad()
def yolo_eval_step(model, images, targets, xy_loss: float = 2.0,
                   wh_loss: float = 1.6, object_loss: float = 0.1,
                   no_object_loss: float = 25.0, mesh=None):
    """Eval-mode forward (running stats, f32) and the loss: ``(loss,
    components (6,))``, global under a ``mesh``."""
    dp = data_axis(mesh)
    heads = model.forward_features(images, train=False)
    return _global(dp, *yolo_loss(model.spec, heads, targets, xy_loss, wh_loss,
                                  object_loss, no_object_loss, mesh=dp))


def rektnet_train_step(model, opt, images, target_hm, target_points,
                       loss_type: str = "l1_softargmax", include_geo: bool = True,
                       geo_loss_gamma_horz: float = 0.0,
                       geo_loss_gamma_vert: float = 0.0, cross_batch: bool = True,
                       compute_dtype: str = "float32",
                       synth_target_sigma: float = 0.0, mesh=None):
    """One step on (B, H, W, 3) ``images``, (B, K, H, W) ``target_hm`` and
    (B, K, 2) ``target_points``, all on the model's device. Updates the
    model's parameters (through ``opt``) and BN running stats in place;
    returns ``(total, location, geo)`` losses as 0-d f32 tensors.

    ``synth_target_sigma > 0`` ignores ``target_hm`` and makes unit-sum
    Gaussian targets around ``target_points`` on the device. In f32 the
    step turns TF32 off (cuDNN and matmul flags), so f32 is f32 on the
    card.

    The loss takes K2's points in f32 whatever the compute dtype. The JAX
    step rounds them to bf16 first, where points that the net spreads by
    less than a bf16 step (2^-9 below 0.5) coincide: a zero edge vector,
    at which ``F.normalize``'s clamp gives the geometric loss a gradient
    of 1/eps = 1e12. Both packages then take gradients some 1e5 times the
    f32 step's, whose square Adam's second moment keeps for thousands of
    steps, and B=256 bf16 training stalls."""
    dtype = _compute_dtype(compute_dtype)
    if synth_target_sigma > 0:
        target_hm = gaussian_heatmaps(target_points, images.shape[1],
                                      images.shape[2], sigma=synth_target_sigma)
    opt.zero_grad(set_to_none=True)
    hm, pts = model(images, train=True, dtype=dtype, points_dtype=torch.float32,
                    mesh=mesh)
    loc, geo, total = cross_ratio_loss(
        hm.float(), pts.float(), target_hm, target_points, loss_type=loss_type,
        include_geo=include_geo, geo_loss_gamma_horz=geo_loss_gamma_horz,
        geo_loss_gamma_vert=geo_loss_gamma_vert, cross_batch=cross_batch,
        mesh=mesh)
    total.backward()
    optimizer_step(opt, mesh)
    return _global(mesh, total.detach(), loc.detach(), geo.detach())


@torch.no_grad()
def rektnet_eval_step(model, images, target_hm, target_points,
                      loss_type: str = "l1_softargmax", include_geo: bool = True,
                      geo_loss_gamma_horz: float = 0.0,
                      geo_loss_gamma_vert: float = 0.0, cross_batch: bool = True,
                      mesh=None):
    """Eval-mode forward (running stats, f32) and losses: ``(total,
    location, geo, points (B, K, 2))``; under a ``mesh`` the losses are
    global and the points this rank's rows."""
    hm, pts = model(images, train=False)
    loc, geo, total = cross_ratio_loss(
        hm, pts, target_hm, target_points, loss_type=loss_type,
        include_geo=include_geo, geo_loss_gamma_horz=geo_loss_gamma_horz,
        geo_loss_gamma_vert=geo_loss_gamma_vert, cross_batch=cross_batch,
        mesh=mesh)
    return (*_global(mesh, total, loc, geo), pts)
