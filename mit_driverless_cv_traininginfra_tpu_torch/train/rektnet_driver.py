"""RektNet training loop (counterpart of the epoch loop of the JAX
package's ``train/rektnet_driver.py``; reference ``RektNet/train_eval.py``).

Per epoch: train, validate, step ExponentialLR(γ), keep the best
validation loss, write the periodic ``.pt`` checkpoint in the reference
layout, stop early after ``MAX_TOLERANCE`` epochs without improvement;
at the end, the per-keypoint L2 report and the sweep layer's score file.

:func:`train_rektnet` is fed loaders that yield the JAX loader's
5-tuples ``(images (B, H, W, 3), heatmaps (B, K, H', W'), points (B, K,
2), names, original sizes)`` as numpy arrays; :func:`main` builds them
from the label CSV and the crops on disk (``data/rektnet_data.py``), as
the JAX package's ``main`` does, on the card unless the caller asks for
the CPU. On each new best validation loss (with ``save_checkpoints``)
the loop writes the model as ``<output_path>/best_keypoints_<H><W>.onnx``
(``export/pt_to_onnx.py``).

Several devices (``main(n_devices=N)``, N > 1): N ranks through
``parallel/launch.py``, each running the loop on a process mesh. Every
rank reads the same batches, pads a partial one to a multiple of N by
repeating samples and steps on its rows (the JAX driver's pad and shard);
validation runs on every rank on the whole batch, unsharded, as the JAX
driver's does. Only rank 0 writes checkpoints, ONNX files and the
keypoint report, and only rank 0 prints.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.data.rektnet_data import (
    DEFAULT_KEYPOINT_KEYS,
    ConeDataset,
    collate_cones,
    load_train_csv_dataset,
)
from mit_driverless_cv_traininginfra_tpu_torch.data.loader import DataLoader
from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device
from mit_driverless_cv_traininginfra_tpu_torch.export.pt_to_onnx import export_rektnet_onnx
from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet
from mit_driverless_cv_traininginfra_tpu_torch.ops.heatmap import (
    KPT_NAMES,
    keypoint_distance_summary,
    keypoint_l2_distances,
)
from mit_driverless_cv_traininginfra_tpu_torch.parallel.launch import (
    launch,
    rank_devices,
    run_on_rank,
)
from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import (
    pad_batch_to_devices,
    replicate,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import (
    load_rektnet_pt,
    save_rektnet_pt,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.optim import (
    exponential_lr,
    make_optimizer,
    set_lr,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.steps import (
    rektnet_eval_step,
    rektnet_train_step,
)

MAX_TOLERANCE = 8  # train_eval.py


def _on(device, imgs, hms, pts, mesh=None):
    """The batch as f32 tensors on ``device``; under a process ``mesh``
    padded to a multiple of the mesh by repeating samples, and this rank's
    rows of it."""
    out = []
    for a in (imgs, hms, pts):
        a = np.asarray(a, np.float32)
        if mesh is not None:
            a, _ = pad_batch_to_devices(a, mesh.size)
            a = a[mesh.rows(a.shape[0])]
        out.append(torch.as_tensor(a, device=device))
    return tuple(out)


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
                  log_dir: str = "logs", mesh=None):
    """The reference's epoch loop on ``model`` (a ``KeypointNet`` on
    ``device``, the card unless the caller asks for the CPU; a missing card
    raises) and ``opt``. ``mixed_precision`` trains in bf16 compute;
    ``device_targets`` makes Gaussian heatmap targets on the device.
    Writes ``<output_path>/<epoch>_loss_<val>.pt`` (the model, its Adam
    state and the epoch) every ``checkpoint_interval`` epochs, and
    ``best_keypoints_<H><W>.onnx`` at each new best validation loss.
    ``mesh``: this rank's process mesh (each rank steps on its rows of
    each batch; rank 0 alone writes files). Returns ``(best validation
    loss, best epoch, last epoch run)``."""
    device = resolve_device(device)
    lead = mesh is None or mesh.is_lead
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
                model, opt, *_on(device, imgs, hms, pts, mesh),
                compute_dtype="bfloat16" if mixed_precision else "float32",
                synth_target_sigma=1.0 if device_targets else 0.0, mesh=mesh,
                **loss_kw)
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
            if save_checkpoints and lead:
                params, state = model.trees()
                onnx_uri = os.path.join(
                    output_path, f"best_keypoints_{input_size[0]}{input_size[1]}.onnx")
                export_rektnet_onnx(params, state, onnx_uri, input_size=input_size,
                                    num_kpt=params["out"]["w"].shape[0])
                print(f"Saving ONNX model to {onnx_uri}")
        else:
            tolerance += 1

        if (save_checkpoints and lead and epoch != 0
                and (epoch + 1) % checkpoint_interval == 0):
            pt_path = os.path.join(output_path, f"{epoch}_loss_{round(val_loss, 2)}.pt")
            print(f"Saving model to {pt_path}")
            save_rektnet_pt(pt_path, model, epoch=epoch, optimizer=opt)
        if tolerance >= MAX_TOLERANCE:
            print(f"Training is stopped due; loss no longer decreases. "
                  f"Epoch {best_epoch} is has the best validation loss.")
            break

    if lead:
        print_kpt_l2_distance(model, val_loader, kpt_keys, input_size, loss_kw,
                              device, log_dir, study_name)
    return best_val_loss, best_epoch, epoch


def latest_checkpoint(output_path: str) -> Optional[str]:
    """The ``<epoch>_loss_<val>.pt`` of the highest epoch in
    ``output_path``, or None."""
    found = [(int(m[1]), name) for name in os.listdir(output_path)
             if (m := re.fullmatch(r"(\d+)_loss_.*\.pt", name))]
    return os.path.join(output_path, max(found)[1]) if found else None


def main(*, train_dataset_uri: str, dataset_path: str, output_path: str = "outputs/",
         batch_size: int = 32, num_epochs: int = 1024, lr: float = 0.1,
         lr_gamma: float = 0.999, validation_ratio: float = 0.15,
         loss_type: str = "l1_softargmax", include_geo: bool = True,
         geo_loss_gamma_horz: float = 0.0, geo_loss_gamma_vert: float = 0.0,
         cross_batch: bool = True, checkpoint_interval: int = 4, input_size=(80, 80),
         num_kpt: int = 7, study_name: str = "rektnet", evaluate_mode: bool = False,
         save_checkpoints: bool = True, cache_location: Optional[str] = None,
         checkpoint_path: Optional[str] = None, num_workers: int = 0,
         n_devices: Optional[int] = None, seed: int = 17, mixed_precision="auto",
         device_targets: bool = False, resume: bool = False,
         vis_upload_data: bool = False, post_run_shutdown: bool = False,
         kpt_keys: Sequence[str] = tuple(DEFAULT_KEYPOINT_KEYS), device="cuda",
         log_dir: str = "logs", mesh=None):
    """The JAX package's ``main`` on ``device`` (the card unless the caller
    asks for the CPU; a missing card raises): the label CSV and its crops →
    loaders → ``train_rektnet``. The initial weights come from
    ``checkpoint_path`` (a reference ``.pt``) or from ``rektnet.init`` with
    ``torch.Generator().manual_seed(seed)``; Adam at ``lr``.
    ``mixed_precision="auto"`` is bf16 compute on the card and f32 on the
    CPU. ``resume`` restores the periodic ``.pt`` of the latest epoch in
    ``output_path`` (:func:`latest_checkpoint`) and goes on at the next
    epoch (the JAX package keeps an orbax tree beside it for that). ``evaluate_mode`` only writes the keypoint distances.
    ``vis_upload_data`` renders the training split with its keypoints
    into ``<output_path>/visualization`` and stops (then shuts the machine
    down with ``post_run_shutdown``, as the reference does). ``n_devices``
    > 1 launches that many ranks (``parallel/launch.py``: ``cuda:0``… on
    the card, raising where fewer exist; CPU processes over ``gloo`` with
    ``device="cpu"``), each running this function on its process ``mesh``,
    and returns rank 0's result. Returns the best validation loss (None
    after ``vis_upload_data``)."""
    kwargs = dict(locals())  # first statement: the call's arguments only
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be ≥ 1, got {n_devices}")
    if mesh is None and (n_devices or 1) > 1 and not vis_upload_data:
        del kwargs["mesh"]
        return launch(run_on_rank, rank_devices(n_devices, device),
                      args=(main, kwargs))
    dev = resolve_device(device) if mesh is None else mesh.device
    os.makedirs(output_path, exist_ok=True)
    if mixed_precision == "auto":
        mixed_precision = dev.type == "cuda"
    ti, tl, vi, vl = load_train_csv_dataset(
        train_dataset_uri, validation_percent=validation_ratio, keypoint_keys=kpt_keys,
        dataset_path=dataset_path, cache_location=cache_location)

    if vis_upload_data:
        from mit_driverless_cv_traininginfra_tpu_torch.utils.vis import visualize_dataset

        n = visualize_dataset(ti, tl, dataset_path, os.path.join(output_path, "visualization"))
        print(f"visualized {n} dataset images")
        if post_run_shutdown:
            print("Shutting down instance...")
            os.system("shutdown now")
        return None
    train_loader = DataLoader(
        ConeDataset(ti, tl, dataset_path, input_size, compute_heatmaps=not device_targets),
        batch_size, shuffle=False, num_workers=num_workers, collate=collate_cones)
    val_loader = DataLoader(ConeDataset(vi, vl, dataset_path, input_size), batch_size,
                            shuffle=False, num_workers=num_workers, collate=collate_cones)

    if checkpoint_path:
        params, state = rektnet.load_torch_checkpoint(checkpoint_path)
    else:
        params, state = rektnet.init(torch.Generator().manual_seed(seed), num_kpt=num_kpt)
    model = rektnet.KeypointNet(params, state).to(dev)
    if mesh is not None:
        replicate(mesh, model)
    opt = make_optimizer(model.parameters(), "Adam", lr=lr)
    start_epoch = 0
    latest = latest_checkpoint(output_path) if resume else None
    if latest is not None:
        start_epoch = load_rektnet_pt(latest, model, opt) + 1
        print(f"Resumed from {latest} at epoch {start_epoch}")

    loss_kw = dict(loss_type=loss_type, include_geo=include_geo,
                   geo_loss_gamma_horz=geo_loss_gamma_horz,
                   geo_loss_gamma_vert=geo_loss_gamma_vert, cross_batch=cross_batch)
    if evaluate_mode:
        if mesh is None or mesh.is_lead:
            print_kpt_l2_distance(model, val_loader, kpt_keys, input_size, loss_kw,
                                  dev, log_dir, study_name, evaluate_mode=True)
        return float("inf")
    best, _, _ = train_rektnet(
        model, opt, train_loader, val_loader, output_path=output_path, device=dev,
        num_epochs=num_epochs, lr=lr, lr_gamma=lr_gamma,
        mixed_precision=bool(mixed_precision), device_targets=device_targets,
        checkpoint_interval=checkpoint_interval, save_checkpoints=save_checkpoints,
        input_size=input_size, study_name=study_name, kpt_keys=kpt_keys,
        start_epoch=start_epoch, log_dir=log_dir, mesh=mesh, **loss_kw)
    return best

