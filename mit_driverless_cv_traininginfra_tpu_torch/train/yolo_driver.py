"""YOLO training loop (counterpart of the epoch loop of the JAX package's
``train/yolo_driver.py``; reference ``CVC-YOLOv3/train.py``).

Per epoch: StepLR at the top of the epoch (with an optional linear warmup
over the first global steps), one ``yolo_train_step`` a batch with the
reference's log line, and every ``checkpoint_interval`` epochs: the
``.weights`` file, the full train state, the validation loss, the best
loss into ``<log_dir>/result.txt`` (the sweep layer's score channel) and
the validation mAP; early stop after ``val_tolerance`` checks without
improvement past ``min_epochs``.

:func:`train_yolo` is fed loaders yielding ``(uris, images (B, H, W, 3),
labels (B, T, 5))`` numpy batches (the JAX ``DataLoader``'s); the batches
reach the card through ``data.loader.prefetch_to_device``. Not here yet:
the disk dataset and the CLI (``main``), on-device augmentation, the
device-resident pool, several devices, and the ONNX export at an early
stop (which prints, as the JAX driver does without its export module,
that it skips).
"""

from __future__ import annotations

import os
import time
from typing import Iterable

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.data.loader import prefetch_to_device
from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import (
    save_darknet_weights,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.metrics import (
    evaluate_image_batch,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import (
    load_yolo_state,
    save_yolo_state,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.optim import set_lr, step_lr
from mit_driverless_cv_traininginfra_tpu_torch.train.steps import (
    yolo_eval_step,
    yolo_train_step,
)
from mit_driverless_cv_traininginfra_tpu_torch.utils.logger import write_score_file

# Reference quirk: train.py labels the last two columns "L-noobj, L-obj"
# while the components it prints are (x, y, w, h, obj, noobj): the names
# are swapped against the values. Tools that parse the log by these
# headers expect it, so the labels stay swapped and the values stay in the
# reference's positions.
LOSS_LABELS = ["Total", "L-x", "L-y", "L-w", "L-h", "L-noobj", "L-obj"]

STATE_FILE = "state_latest.pt"  # the full train state; its epoch in .meta


def _with_host_counts(batches):
    """Count each batch's targets on the host, before the copy to the card
    (a count on the card would be a host read a step)."""
    for uris, imgs, labels in batches:
        labels = np.asarray(labels, np.float32)
        n_t = float(((labels[:, :, 1:5] > 0).sum(axis=2) > 1).sum()) + 1e-12
        yield uris, np.asarray(imgs, np.float32), labels, n_t


def run_epoch(*, label_prefix: str, data_loader, model, opt, device,
              num_steps: int, step, epoch: int, loss_consts, optimize: bool,
              compute_dtype: str = "float32", lr_warmup=None):
    """One pass over ``data_loader``, training or (``optimize=False``)
    evaluating. ``step`` is a one-element list, the global step count.
    Returns ``(epoch_losses[7], epoch_time_total, epoch_num_targets)``."""
    print(f"Model in {label_prefix} mode")
    epoch_losses = [0.0] * 7
    epoch_time_total = 0.0
    epoch_num_targets = 1e-12
    t1 = time.time()
    xy, wh, obj, noobj = loss_consts
    it = prefetch_to_device(_with_host_counts(iter(data_loader)), device)
    for i, (_, imgs, targets, step_num_targets) in enumerate(it):
        if step[0] >= num_steps:
            break
        epoch_num_targets += step_num_targets
        if optimize and lr_warmup is not None:
            # linear warmup over the first N global steps, up to the
            # epoch's StepLR value
            warm_n, epoch_lr = lr_warmup
            if step[0] < warm_n:
                set_lr(opt, epoch_lr * (step[0] + 1) / warm_n)
            elif step[0] == warm_n:
                set_lr(opt, epoch_lr)
        if optimize:
            loss, comps = yolo_train_step(
                model, opt, imgs, targets, xy_loss=xy, wh_loss=wh,
                object_loss=obj, no_object_loss=noobj,
                compute_dtype=compute_dtype)
        else:
            loss, comps = yolo_eval_step(model, imgs, targets, xy_loss=xy,
                                         wh_loss=wh, object_loss=obj,
                                         no_object_loss=noobj)
        losses = torch.cat([loss.reshape(1), comps]).tolist()  # one host read
        for j in range(7):
            epoch_losses[j] += losses[j]
        epoch_time_total = time.time() - t1

        statement = (f"{label_prefix} Epoch: {epoch}, Batch: {i + 1}/{len(data_loader)}"
                     f", Total: {losses[0] / step_num_targets:10.6f}")
        for lbl, val in zip(LOSS_LABELS[1:], losses[1:]):
            pct = val / losses[0] * 100 if losses[0] else 0.0
            statement += f",   {lbl}: {pct:5.2f}%"
        print(statement)
        if optimize:
            step[0] += 1
    return epoch_losses, epoch_time_total, epoch_num_targets


@torch.no_grad()
def validate_map(*, data_loader: Iterable, model, device="cuda", top_k: int = 200):
    """mAP, recall, precision over ``data_loader`` (the reference's
    ``validate.validate``) with the unfolded eval forward in f32, and the
    seconds per image. Returns ``(mAP, recall, precision, s_per_image)``."""
    dev = resolve_device(device)
    net = model.spec.net
    t0 = time.time()
    evs, n_images = [], 0
    for _, imgs, targets in data_loader:
        n_images += imgs.shape[0]
        imgs = torch.as_tensor(np.asarray(imgs, np.float32), device=dev)
        targets = torch.as_tensor(np.asarray(targets, np.float32), device=dev)
        ev = evaluate_image_batch(model.detections(imgs), targets, net.width,
                                  net.height, conf_thresh=net.conf_thresh,
                                  nms_thresh=net.nms_thresh,
                                  iou_thresh=net.iou_thresh, top_k=top_k)
        evs.append([x.cpu().numpy() for x in ev])
    valid = (np.concatenate([e[3] for e in evs]) if evs
             else np.zeros((0,), bool))  # an empty validation set
    if valid.sum() == 0:
        mAP = mR = mP = 0.0
    else:
        mAP, mR, mP = (float(np.concatenate([e[k] for e in evs])[valid].mean())
                       for k in range(3))
    dt = time.time() - t0
    print("mAP: {0:5.2%}, Recall: {1:5.2%}, Precision: {2:5.2%}".format(mAP, mR, mP))
    return mAP, mR, mP, dt / (n_images + 1e-12)


def train_yolo(model, opt, train_loader, val_loader, *, output_path: str,
               device="cuda", num_epochs: int = 100, num_steps: int = 10**9,
               checkpoint_interval: int = 1, lr: float = 1e-3,
               gamma: float = 0.95, lr_warmup_steps: int = 0,
               xy_loss: float = 2.0, wh_loss: float = 1.6,
               object_loss: float = 0.1, no_object_loss: float = 25.0,
               val_tolerance: int = 3, min_epochs: int = 3,
               mixed_precision: bool = False, resume: bool = False,
               evaluate: bool = False, log_dir: str = "logs", device_aug: bool = False,
               n_devices=None) -> float:
    """The reference's epoch loop (the JAX ``yolo_driver.main`` after it
    has built its loaders) on ``model``, a :class:`TrainDarknet` on
    ``device`` (the card unless the caller asks for the CPU; a missing
    card raises), and ``opt``. ``mixed_precision`` trains in bf16
    compute. ``resume`` restores the full state of ``output_path`` and
    goes on after its epoch. ``evaluate`` only runs ``validate_map``.
    Returns the best validation loss (999.0 before any check).

    Writes ``<output_path>/<epoch>.weights`` and ``STATE_FILE`` (with its
    ``.meta``) at each check. ``device_aug`` and ``n_devices`` are the JAX
    driver's on-device augmentation and mesh, which the port does not
    have yet: they raise rather than be ignored."""
    if device_aug:
        raise NotImplementedError("device_aug: on-device augmentation is not "
                                  "ported yet")
    if n_devices not in (None, 1):
        raise NotImplementedError("n_devices: training on several devices is "
                                  "not ported yet")
    device = resolve_device(device)
    spec = model.spec
    os.makedirs(output_path, exist_ok=True)
    state_path = os.path.join(output_path, STATE_FILE)
    start_epoch = 0
    if resume and os.path.exists(state_path):
        _, start_epoch = load_yolo_state(state_path, model, opt)
        print(f"Resumed from {state_path} at epoch {start_epoch}")

    loss_consts = (xy_loss, wh_loss, object_loss, no_object_loss)
    val_loss = 999.0
    val_loss_counter = 0
    step = [0]
    epoch = start_epoch
    while epoch < num_epochs and step[0] < num_steps and not evaluate:
        epoch += 1
        epoch_lr = step_lr(lr, gamma, epoch)  # StepLR at the top of the epoch
        set_lr(opt, epoch_lr)
        run_epoch(label_prefix="train", data_loader=train_loader, model=model,
                  opt=opt, device=device, num_steps=num_steps, step=step,
                  epoch=epoch, loss_consts=loss_consts, optimize=True,
                  compute_dtype="bfloat16" if mixed_precision else "float32",
                  lr_warmup=(lr_warmup_steps, epoch_lr) if lr_warmup_steps else None)
        print("Completed epoch: ", epoch)

        if epoch % checkpoint_interval == 0 or epoch == num_epochs or step[0] >= num_steps:
            params, state = model.trees()
            save_darknet_weights(spec, params, state,
                                 os.path.join(output_path, f"{epoch}.weights"))
            save_yolo_state(state_path, model, opt, step[0], epoch)
            print("Calculating loss on validate data")
            epoch_losses, _, epoch_num_targets = run_epoch(
                label_prefix="validate", data_loader=val_loader, model=model,
                opt=opt, device=device, num_steps=10**12, step=step,
                epoch=epoch, loss_consts=loss_consts, optimize=False)
            avg_epoch_loss = epoch_losses[0] / epoch_num_targets
            print("Average Validation Loss: {0:10.6f}".format(avg_epoch_loss))
            if avg_epoch_loss > val_loss and epoch > min_epochs:
                val_loss_counter += 1
                print(f"Validation loss did not decrease for {val_loss_counter}"
                      f" consecutive check(s)")
            else:
                print("Validation loss decreased. Yay!!")
                val_loss_counter = 0
                val_loss = avg_epoch_loss
                write_score_file(os.path.join(log_dir, "result.txt"), avg_epoch_loss)
            validate_map(data_loader=val_loader, model=model, device=device)
            if val_loss_counter == val_tolerance:
                print(f"Validation loss stopped decreasing over the last "
                      f"{val_tolerance} checkpoints, creating onnx file")
                print("ONNX export module unavailable; skipping export")
                break
    if evaluate:
        validate_map(data_loader=val_loader, model=model, device=device)
    return val_loss
