"""RektNet training loop (counterpart of the epoch loop of the JAX
package's ``train/rektnet_driver.py``; reference ``RektNet/train_eval.py``).

Per epoch: train, validate, step ExponentialLR(γ), keep the best
validation loss, write the periodic ``.pt`` checkpoint in the reference
layout, stop early after ``MAX_TOLERANCE`` epochs without improvement;
at the end, the per-keypoint L2 report and the sweep layer's score file.

:func:`train_rektnet` is fed loaders that yield the JAX loader's
5-tuples ``(images (B, H, W, 3), heatmaps (B, K, H', W'), points (B, K,
2), names, original sizes)`` as numpy arrays. Not here yet: the CSV and
disk loader, the dataset arguments of ``main`` and the CLI, and the ONNX
export of the best model.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device
from mit_driverless_cv_traininginfra_tpu_torch.ops.heatmap import (
    KPT_NAMES,
    keypoint_distance_summary,
    keypoint_l2_distances,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import (
    save_rektnet_pt,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.optim import (
    exponential_lr,
    set_lr,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.steps import (
    rektnet_eval_step,
    rektnet_train_step,
)

MAX_TOLERANCE = 8  # train_eval.py


def _on(device, imgs, hms, pts):
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (imgs, hms, pts))


def eval_model(model, loader: Iterable, loss_kw, device):
    """Mean (location, geo, total) validation losses over ``loader``."""
    sums = torch.zeros(3, dtype=torch.float64, device=device)
    n = 0
    for imgs, hms, pts, _, _ in loader:
        total, loc, geo, _ = rektnet_eval_step(model, *_on(device, imgs, hms, pts),
                                               **loss_kw)
        sums += torch.stack([loc, geo, total]).double()
        n += 1
    out = (sums / max(n, 1)).tolist()
    print(f"\tValidation: MSE/Geometric/Total Loss: "
          f"{round(out[0], 10)}/{round(out[1], 10)}/{round(out[2], 10)}")
    return out


def print_kpt_l2_distance(model, loader: Iterable, kpt_keys: Sequence[str],
                          input_size, loss_kw, device, log_dir: str,
                          study_name: str, evaluate_mode: bool = False) -> float:
    """Per-keypoint distance statistics, and ``<log_dir>/<study>.txt``
    holding the total (``rektnet_validation.txt`` gets per-image lines in
    evaluate mode)."""
    os.makedirs(log_dir, exist_ok=True)
    val_file = (open(os.path.join(log_dir, "rektnet_validation.txt"), "a")
                if evaluate_mode else None)
    rows = []
    for imgs, hms, pts, _, shapes in loader:
        t_imgs, t_hms, t_pts = _on(device, imgs, hms, pts)
        _, _, _, pred = rektnet_eval_step(model, t_imgs, t_hms, t_pts, **loss_kw)
        # reference quirk: it scales by x_batch.shape[1], which under NCHW
        # is the channel count (3), not the crop size, then by input_size
        scale = 3
        size = torch.tensor(input_size, dtype=torch.float32, device=device)
        d = keypoint_l2_distances(t_pts * scale * size, pred * scale * size)
        for row, shape in zip(d.cpu().numpy(), shapes):
            rows.append(row)
            if val_file is not None:
                val_file.write(f"{[shape[1], shape[0]]}:{float(row.sum())}\n")
    if val_file is not None:
        val_file.close()
    means, total_dist, stds = keypoint_distance_summary(np.asarray(rows))
    print("Mean distance error of each keypoint is:")
    for k, m in zip(kpt_keys, means):
        print(f"\t{k}: {m}")
    print("Standard deviation of each keypoint is:")
    for k, s in zip(kpt_keys, stds):
        print(f"\t{k}: {s}")
    print(f"Total distance error is: {total_dist}")
    with open(os.path.join(log_dir, study_name + ".txt"), "w") as f:
        f.write(str(total_dist))
    return total_dist


def train_rektnet(model, opt, train_loader: Iterable, val_loader: Iterable, *,
                  output_path: str, device="cuda", num_epochs: int = 1024,
                  lr: float = 0.1, lr_gamma: float = 0.999,
                  loss_type: str = "l1_softargmax", include_geo: bool = True,
                  geo_loss_gamma_horz: float = 0.0,
                  geo_loss_gamma_vert: float = 0.0, cross_batch: bool = True,
                  mixed_precision: bool = False, device_targets: bool = False,
                  checkpoint_interval: int = 4, save_checkpoints: bool = True,
                  input_size=(80, 80), study_name: str = "rektnet",
                  kpt_keys: Sequence[str] = KPT_NAMES, start_epoch: int = 0,
                  log_dir: str = "logs"):
    """The reference's epoch loop on ``model`` (a ``KeypointNet`` on
    ``device``, the card unless the caller asks for the CPU; a missing card
    raises) and ``opt``. ``mixed_precision`` trains in bf16 compute;
    ``device_targets`` makes Gaussian heatmap targets on the device.
    Writes ``<output_path>/<epoch>_loss_<val>.pt`` every
    ``checkpoint_interval`` epochs. Returns ``(best validation loss, best
    epoch, last epoch run)``."""
    device = resolve_device(device)
    os.makedirs(output_path, exist_ok=True)
    loss_kw = dict(loss_type=loss_type, include_geo=include_geo,
                   geo_loss_gamma_horz=geo_loss_gamma_horz,
                   geo_loss_gamma_vert=geo_loss_gamma_vert, cross_batch=cross_batch)
    best_val_loss, best_epoch, tolerance, epoch = float("inf"), 0, 0, start_epoch
    for epoch in range(start_epoch, num_epochs):
        print(f"EPOCH {epoch}")
        sums = torch.zeros(3, dtype=torch.float64, device=device)
        n = 0
        for imgs, hms, pts, _, _ in train_loader:
            total, loc, geo = rektnet_train_step(
                model, opt, *_on(device, imgs, hms, pts),
                compute_dtype="bfloat16" if mixed_precision else "float32",
                synth_target_sigma=1.0 if device_targets else 0.0, **loss_kw)
            sums += torch.stack([loc, geo, total]).double()
            n += 1
        tl = (sums / max(n, 1)).tolist()  # one host read per epoch
        print(f"\tTraining: MSE/Geometric/Total Loss: "
              f"{round(tl[0], 10)}/{round(tl[1], 10)}/{round(tl[2], 10)}")
        _, _, val_loss = eval_model(model, val_loader, loss_kw, device)
        # ExponentialLR, stepped after validation
        set_lr(opt, exponential_lr(lr, lr_gamma, epoch + 1))

        if val_loss < best_val_loss:
            best_val_loss, best_epoch, tolerance = val_loss, epoch, 0
        else:
            tolerance += 1

        if save_checkpoints and epoch != 0 and (epoch + 1) % checkpoint_interval == 0:
            pt_path = os.path.join(output_path, f"{epoch}_loss_{round(val_loss, 2)}.pt")
            print(f"Saving model to {pt_path}")
            save_rektnet_pt(pt_path, model, epoch=epoch, optimizer=opt)
        if tolerance >= MAX_TOLERANCE:
            print(f"Training is stopped due; loss no longer decreases. "
                  f"Epoch {best_epoch} is has the best validation loss.")
            break

    print_kpt_l2_distance(model, val_loader, kpt_keys, input_size, loss_kw,
                          device, log_dir, study_name)
    return best_val_loss, best_epoch, epoch
