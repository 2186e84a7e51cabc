"""YOLO training driver (counterpart of the JAX package's
``train/yolo_driver.py``; reference ``CVC-YOLOv3/train.py``).

:func:`main` is the reference's ``train.py main`` with the JAX driver's
keyword surface: it builds the tile-and-scale datasets of the cfg's
``train_uri``/``validate_uri`` CSVs (``data/yolo_dataset.py``), their
loaders (or a device-resident pool, ``data/device_pool.py``), the
:class:`TrainDarknet` from ``init_params`` or a ``.weights`` file, the
optimizer, and runs :func:`train_yolo`.

:func:`train_yolo`, per epoch: StepLR at the top of the epoch (with an
optional linear warmup over the first global steps), one train step a
batch with the reference's log line, and every ``checkpoint_interval``
epochs: the ``.weights`` file, the full train state, the validation loss,
the best loss into ``<log_dir>/result.txt`` (the sweep layer's score
channel) and the validation mAP; early stop after ``val_tolerance`` checks
without improvement past ``min_epochs``, which writes the model as
``<output_path>/<cfg stem>_<width><onnx_height>.onnx``
(``export/yolo2onnx.py``). Loaders yield ``(uris, images
(B, H, W, C), labels (B, T, 5))`` batches, numpy or (a pool's images)
tensors on the device; numpy reaches the card through
``data.loader.prefetch_to_device``. With ``device_aug`` the labels are
pixel corners and the step augments on the device
(``train.steps.yolo_train_step_device_aug``).

Several devices (``main(n_devices=N)``, N > 1): N ranks, one a device,
through ``parallel/launch.py`` (``nccl`` on N cards, ``gloo`` on the CPU),
each running the same loop on a process mesh. Every rank reads the same
batches (same seed, same order), pads a partial one to a multiple of N by
repeating samples (the JAX driver's ``pad_pair``), and keeps its rows; the
steps take the global batch's BN statistics and loss and sum the
gradients, so the parameters follow the one-device run on the whole batch.
``validate_map`` gathers the per-image evaluations into one mAP. Only
rank 0 writes weights, state, scores and the ONNX file, and only rank 0
prints.

``packed_stem`` trains blocks 0-1 through the packed space-to-depth stem
(``train.steps``); validation runs the plain eval forward, as the JAX
package's ``train/yolo_driver.py`` does.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import load_network_spec
from mit_driverless_cv_traininginfra_tpu_torch.data.device_pool import DevicePool
from mit_driverless_cv_traininginfra_tpu_torch.data.loader import (
    DataLoader,
    prefetch_to_device,
)
from mit_driverless_cv_traininginfra_tpu_torch.data.yolo_dataset import ImageLabelDataset
from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device
from mit_driverless_cv_traininginfra_tpu_torch.export.yolo2onnx import export_yolo_onnx
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import (
    TrainDarknet,
    init_params,
    load_darknet_weights,
    save_darknet_weights,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.stem_opt import stem_is_packable
from mit_driverless_cv_traininginfra_tpu_torch.ops.device_aug import sample_draws
from mit_driverless_cv_traininginfra_tpu_torch.ops.metrics import (
    evaluate_image_batch,
)
from mit_driverless_cv_traininginfra_tpu_torch.parallel.launch import (
    launch,
    rank_devices,
    run_on_rank,
)
from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import (
    all_gather,
    pad_batch_to_devices,
    replicate,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import (
    load_yolo_state,
    save_yolo_state,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.optim import (
    make_optimizer,
    set_lr,
    step_lr,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.steps import (
    yolo_eval_step,
    yolo_train_step,
    yolo_train_step_device_aug,
)
from mit_driverless_cv_traininginfra_tpu_torch.utils.logger import write_score_file

# Reference quirk: train.py labels the last two columns "L-noobj, L-obj"
# while the components it prints are (x, y, w, h, obj, noobj): the names
# are swapped against the values. Tools that parse the log by these
# headers expect it, so the labels stay swapped and the values stay in the
# reference's positions.
LOSS_LABELS = ["Total", "L-x", "L-y", "L-w", "L-h", "L-noobj", "L-obj"]

STATE_FILE = "state_latest.pt"  # the full train state; its epoch in .meta


def _with_host_counts(batches, n_dev: int = 1):
    """Count each batch's targets on the host, before the copy to the card
    (a count on the card would be a host read a step). Host batches are
    first padded to a multiple of ``n_dev`` by repeating samples (counted
    as the JAX driver counts its padded batch). Images already on the
    device (a pool's, full batches) pass through."""
    for uris, imgs, labels in batches:
        labels = np.asarray(labels, np.float32)
        if not torch.is_tensor(imgs):
            imgs = np.asarray(imgs, np.float32)
            if n_dev > 1:
                imgs, _ = pad_batch_to_devices(imgs, n_dev)
                labels, _ = pad_batch_to_devices(labels, n_dev)
        n_t = float(((labels[:, :, 1:5] > 0).sum(axis=2) > 1).sum()) + 1e-12
        yield uris, imgs, labels, n_t


def run_epoch(*, label_prefix: str, data_loader, model, opt, device,
              num_steps: int, step, epoch: int, loss_consts, optimize: bool,
              compute_dtype: str = "float32", lr_warmup=None,
              aug_gen=None, aug_flags=None, mesh=None, packed_stem: bool = False):
    """One pass over ``data_loader``, training or (``optimize=False``)
    evaluating. ``step`` is a one-element list, the global step count.
    ``aug_gen`` (a ``torch.Generator`` on ``device``) turns on the
    device-aug step, each batch's draws taken from it with ``aug_flags``
    (the global batch's draws: each rank takes its rows). ``packed_stem``
    trains through the packed stem. Under a process
    ``mesh`` this rank steps on its rows of each padded global batch; the
    losses are global. Returns ``(epoch_losses[7], epoch_time_total,
    epoch_num_targets)``."""
    print(f"Model in {label_prefix} mode")
    epoch_losses = [0.0] * 7
    epoch_time_total = 0.0
    epoch_num_targets = 1e-12
    t1 = time.time()
    xy, wh, obj, noobj = loss_consts
    n_dev = 1 if mesh is None else mesh.size
    it = prefetch_to_device(_with_host_counts(iter(data_loader), n_dev), device,
                            mesh=mesh)
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
        if optimize and aug_gen is not None:
            draws = sample_draws(aug_gen, imgs.shape[0] * n_dev, *imgs.shape[1:],
                                 **(aug_flags or {}))
            loss, comps = yolo_train_step_device_aug(
                model, opt, imgs, targets, draws, xy_loss=xy, wh_loss=wh,
                object_loss=obj, no_object_loss=noobj,
                compute_dtype=compute_dtype, mesh=mesh, packed_stem=packed_stem)
        elif optimize:
            loss, comps = yolo_train_step(
                model, opt, imgs, targets, xy_loss=xy, wh_loss=wh,
                object_loss=obj, no_object_loss=noobj,
                compute_dtype=compute_dtype, mesh=mesh, packed_stem=packed_stem)
        else:
            loss, comps = yolo_eval_step(model, imgs, targets, xy_loss=xy,
                                         wh_loss=wh, object_loss=obj,
                                         no_object_loss=noobj, mesh=mesh)
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
def validate_map(*, data_loader: Iterable, model, device="cuda", top_k: int = 200,
                 mesh=None):
    """mAP, recall, precision over ``data_loader`` (the reference's
    ``validate.validate``) with the unfolded eval forward in f32, and the
    seconds per image. Under a process ``mesh`` each rank evaluates its
    rows of each batch (padded to a multiple of the mesh by repeating) and
    the per-image evaluations are gathered, the padding dropped: one mAP,
    the one-device one. Returns ``(mAP, recall, precision, s_per_image)``."""
    dev = resolve_device(device)
    net = model.spec.net
    t0 = time.time()
    evs, n_images = [], 0
    for _, imgs, targets in data_loader:
        n_real = imgs.shape[0]
        n_images += n_real
        imgs, targets = np.asarray(imgs, np.float32), np.asarray(targets, np.float32)
        if mesh is not None:
            imgs, _ = pad_batch_to_devices(imgs, mesh.size)
            targets, _ = pad_batch_to_devices(targets, mesh.size)
            rows = mesh.rows(imgs.shape[0])
            imgs, targets = imgs[rows], targets[rows]
        imgs = torch.as_tensor(imgs, device=dev)
        targets = torch.as_tensor(targets, device=dev)
        ev = evaluate_image_batch(model.detections(imgs), targets, net.width,
                                  net.height, conf_thresh=net.conf_thresh,
                                  nms_thresh=net.nms_thresh,
                                  iou_thresh=net.iou_thresh, top_k=top_k)
        if mesh is not None:
            ev = [all_gather(x.float(), mesh)[:n_real].to(x.dtype) for x in ev]
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
               model_cfg: str, device="cuda", num_epochs: int = 100, num_steps: int = 10**9,
               checkpoint_interval: int = 1, lr: float = 1e-3,
               gamma: float = 0.95, lr_warmup_steps: int = 0,
               xy_loss: float = 2.0, wh_loss: float = 1.6,
               object_loss: float = 0.1, no_object_loss: float = 25.0,
               val_tolerance: int = 3, min_epochs: int = 3,
               mixed_precision: bool = False, resume: bool = False,
               evaluate: bool = False, log_dir: str = "logs", device_aug: bool = False,
               aug_flags=None, seed: int = 17, train_dataset=None,
               mesh=None, packed_stem: bool = False) -> float:
    """The reference's epoch loop (the JAX ``yolo_driver.main`` after it
    has built its loaders) on ``model``, a :class:`TrainDarknet` on
    ``device`` (the card unless the caller asks for the CPU; a missing
    card raises), and ``opt``. ``mixed_precision`` trains in bf16
    compute. ``resume`` restores the full state of ``output_path`` and
    goes on after its epoch. ``evaluate`` only runs ``validate_map``.
    Returns the best validation loss (999.0 before any check).

    Writes ``<output_path>/<epoch>.weights`` and ``STATE_FILE`` (with its
    ``.meta``) at each check. ``device_aug``: the loader's labels are pixel
    corners and each step augments on the device, its draws from a
    generator on ``device`` seeded ``seed · 7919 + epoch`` each epoch, with
    ``aug_flags`` (``lr_flip``, ``jitter``, ``noise``; the step's defaults
    when None). ``train_dataset``, when given, has ``set_epoch(epoch)``
    called at the top of each epoch (fresh per-item draws). The early stop
    writes ``spec.net.onnx_name(model_cfg)`` under ``output_path``:
    ``model_cfg`` is the path of the cfg ``model`` was built from.
    ``mesh``: this rank's process mesh (each rank runs this loop on its
    rows; rank 0 alone writes files). ``packed_stem``: the train steps run
    blocks 0-1 as the packed space-to-depth stem."""
    device = resolve_device(device)
    lead = mesh is None or mesh.is_lead
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
        if train_dataset is not None:
            # fresh draws each epoch; validation keeps epoch 0, so its
            # random patch picks stay the same between checks
            train_dataset.set_epoch(epoch)
        epoch_lr = step_lr(lr, gamma, epoch)  # StepLR at the top of the epoch
        set_lr(opt, epoch_lr)
        aug_gen = (torch.Generator(device=device).manual_seed(seed * 7919 + epoch)
                   if device_aug else None)
        run_epoch(label_prefix="train", data_loader=train_loader, model=model,
                  opt=opt, device=device, num_steps=num_steps, step=step,
                  epoch=epoch, loss_consts=loss_consts, optimize=True,
                  compute_dtype="bfloat16" if mixed_precision else "float32",
                  lr_warmup=(lr_warmup_steps, epoch_lr) if lr_warmup_steps else None,
                  aug_gen=aug_gen, aug_flags=aug_flags, mesh=mesh,
                  packed_stem=packed_stem)
        print("Completed epoch: ", epoch)

        if epoch % checkpoint_interval == 0 or epoch == num_epochs or step[0] >= num_steps:
            if lead:
                params, state = model.trees()
                save_darknet_weights(spec, params, state,
                                     os.path.join(output_path, f"{epoch}.weights"))
                save_yolo_state(state_path, model, opt, step[0], epoch)
            print("Calculating loss on validate data")
            epoch_losses, _, epoch_num_targets = run_epoch(
                label_prefix="validate", data_loader=val_loader, model=model,
                opt=opt, device=device, num_steps=10**12, step=step,
                epoch=epoch, loss_consts=loss_consts, optimize=False, mesh=mesh)
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
                if lead:
                    write_score_file(os.path.join(log_dir, "result.txt"), avg_epoch_loss)
            validate_map(data_loader=val_loader, model=model, device=device, mesh=mesh)
            if val_loss_counter == val_tolerance:
                print(f"Validation loss stopped decreasing over the last "
                      f"{val_tolerance} checkpoints, creating onnx file")
                if lead:
                    export_yolo_onnx(spec, *model.trees(), os.path.join(
                        output_path, spec.net.onnx_name(model_cfg)))
                break
    if evaluate:
        validate_map(data_loader=val_loader, model=model, device=device, mesh=mesh)
    return val_loss


def main(*, model_cfg: str, weights_path: Optional[str], output_path: str,
         dataset_path: str, batch_size: int = 8, optimizer_pick: str = "Adam",
         num_epochs: int = 100, num_steps: int = 10**9,
         checkpoint_interval: int = 1, lr: float = 1e-3, momentum: float = 0.9,
         gamma: float = 0.95, weight_decay: float = 0.0,
         xy_loss: float = 2.0, wh_loss: float = 1.6,
         no_object_loss: float = 25.0, object_loss: float = 0.1,
         vanilla_anchor: bool = False, ts: bool = True,
         augment_affine: bool = False, augment_hsv: bool = False,
         lr_flip: bool = False, ud_flip: bool = False, data_aug: bool = False,
         blur: bool = False, salt: bool = False, noise: bool = False,
         contrast: bool = False, sharpen: bool = False,
         val_tolerance: int = 3, min_epochs: int = 3,
         vis_batch: int = 0, resume: bool = False,
         mixed_precision="auto", device_aug: bool = False,
         packed_stem: bool = False,
         grad_clip: float = 0.0, lr_warmup_steps: int = 0,
         val_batch_size: Optional[int] = None,
         preload_device: bool = False, preload_num: Optional[int] = None,
         preload_budget_gb: float = 6.0,
         debug_mode: bool = False, evaluate: bool = False,
         num_workers: int = 8, n_devices: Optional[int] = None,
         seed: int = 17, device="cuda", mesh=None) -> float:
    """The JAX driver's ``main`` on ``device`` (the card unless the caller
    asks for the CPU; a missing card raises). ``mixed_precision="auto"``
    is bf16 compute on the card and f32 on the CPU. ``preload_device``
    trains from a :class:`DevicePool` of the training set (bf16 under
    mixed precision). The initial weights come from ``init_params`` with
    ``torch.Generator().manual_seed(seed)``, or from ``weights_path``.
    ``n_devices`` > 1 launches that many ranks (``parallel/launch.py``:
    ``cuda:0``… on the card, raising where fewer exist; CPU processes over
    ``gloo`` with ``device="cpu"``), each running this function on its
    process ``mesh``, and returns rank 0's result. ``packed_stem`` trains
    blocks 0-1 through the packed space-to-depth stem and raises the JAX
    package's ``ValueError`` on a spec whose stem it does not fit. Returns
    the best validation loss."""
    kwargs = dict(locals())  # first statement: the call's arguments only
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be ≥ 1, got {n_devices}")
    if mesh is None and (n_devices or 1) > 1:
        del kwargs["mesh"]
        return launch(run_on_rank, rank_devices(n_devices, device),
                      args=(main, kwargs))
    dev = resolve_device(device) if mesh is None else mesh.device
    spec = load_network_spec(model_cfg, vanilla_anchor=vanilla_anchor)
    if packed_stem and not stem_is_packable(spec):
        raise ValueError("--packed_stem requires the standard YOLOv3 "
                         "stem (conv3x3/s1 then conv3x3/s2, even input)")
    os.makedirs(output_path, exist_ok=True)
    os.makedirs("logs", exist_ok=True)
    if mixed_precision == "auto":
        mixed_precision = dev.type == "cuda"

    common = dict(dataset_path=dataset_path, width=spec.net.width,
                  height=spec.net.height, bw=spec.net.channels == 1, ts=ts,
                  debug_mode=debug_mode, seed=seed)
    train_ds = ImageLabelDataset(
        spec.net.train_uri, num_images=spec.net.num_train_images,
        augment_affine=augment_affine, augment_hsv=augment_hsv,
        lr_flip=lr_flip, ud_flip=ud_flip, data_aug=data_aug, blur=blur,
        salt=salt, noise=noise, contrast=contrast, sharpen=sharpen,
        vis_batch=vis_batch, device_aug=device_aug, **common)
    val_ds = ImageLabelDataset(
        spec.net.validate_uri, num_images=spec.net.num_validate_images, **common)
    bs = 1 if debug_mode else batch_size
    # validation runs an f32 forward beside the train state (and any pool),
    # so it may need a smaller batch than training
    val_bs = 1 if debug_mode else (val_batch_size or batch_size)
    train_loader = DataLoader(train_ds, bs, shuffle=not debug_mode,
                              num_workers=num_workers, seed=seed)
    val_loader = DataLoader(val_ds, val_bs, shuffle=False,
                            num_workers=num_workers)
    print("Num train images: ", len(train_ds))
    print("Num validate images: ", len(val_ds))

    if preload_device and not debug_mode:
        pool = DevicePool.from_dataset(
            train_ds, num=preload_num, device=dev,
            budget_bytes=preload_budget_gb * 1e9,
            dtype=torch.bfloat16 if mixed_precision else torch.float32,
            num_workers=num_workers, mesh=mesh)
        print(f"Device pool: {len(pool)} samples, "
              f"{pool.nbytes / 1e9:.2f} GB in HBM")
        train_loader = pool.loader(bs, shuffle=True, seed=seed)

    params, state = init_params(spec, torch.Generator().manual_seed(seed))
    if weights_path:
        params, state, _ = load_darknet_weights(spec, params, state, weights_path)
    model = TrainDarknet(spec, params, state).to(dev)
    if mesh is not None:
        replicate(mesh, model)
    opt = make_optimizer(model.parameters(), optimizer_pick, lr=lr,
                         momentum=momentum, weight_decay=weight_decay,
                         grad_clip=grad_clip)
    return train_yolo(
        model, opt, train_loader, val_loader, output_path=output_path,
        device=dev, num_epochs=num_epochs, num_steps=num_steps,
        checkpoint_interval=checkpoint_interval, lr=lr, gamma=gamma,
        lr_warmup_steps=lr_warmup_steps, xy_loss=xy_loss, wh_loss=wh_loss,
        object_loss=object_loss, no_object_loss=no_object_loss,
        val_tolerance=val_tolerance, min_epochs=min_epochs,
        mixed_precision=bool(mixed_precision), resume=resume,
        evaluate=evaluate, log_dir="logs", device_aug=device_aug,
        # the host path's flag semantics on the device: data_aug turns on
        # the jitter (its affine runs on the host); lr_flip and noise need
        # their own flags in both modes
        aug_flags=dict(lr_flip=bool(lr_flip), jitter=bool(augment_hsv or data_aug),
                       noise=bool(noise)),
        seed=seed, train_dataset=train_ds, model_cfg=model_cfg, mesh=mesh,
        packed_stem=packed_stem)

