"""RektNet training from the command line (the reference's
``train_eval.py`` surface, the JAX package's ``cli/rektnet_train.py``) on
the port's driver::

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.rektnet_train \\
        --train_dataset_uri dataset/rektnet_label.csv \\
        --dataset_path dataset/RektNet_Dataset/ --num_epochs 64

The flags and defaults are the JAX CLI's, plus ``--device`` (``cuda``
unless the CPU is asked for). While it runs, stdout and stderr are also
written to ``logs/<study_name>.log`` and ``logs/<study_name>.error``.
``--n_devices N`` (N > 1) trains on N ranks, one a device
(``parallel/launch.py``: ``cuda:0``… of the visible cards, or N CPU processes
with ``--device cpu``); rank 0 prints and writes the logs.
"""

from __future__ import annotations

import argparse
import os
import sys
import uuid

from mit_driverless_cv_traininginfra_tpu_torch.parallel.launch import (
    launch,
    rank_devices,
    run_on_rank,
)
from mit_driverless_cv_traininginfra_tpu_torch.train import rektnet_driver
from mit_driverless_cv_traininginfra_tpu_torch.utils.logger import Logger, add_bool_arg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="RektNet training (PyTorch)")
    parser.add_argument("--study_name", type=str, default="rektnet")
    parser.add_argument("--train_dataset_uri", type=str, default="dataset/rektnet_label.csv")
    parser.add_argument("--dataset_path", type=str, default="dataset/RektNet_Dataset/")
    parser.add_argument("--output_path", type=str, default="automatic")
    parser.add_argument("--loss_type", type=str, default="l1_softargmax",
                        help="l2_softargmax|l2_heatmap|l1_softargmax")
    parser.add_argument("--validation_ratio", type=float, default=0.15)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--num_epochs", type=int, default=1024)
    parser.add_argument("--lr", type=float, default=1e-1)
    parser.add_argument("--lr_gamma", type=float, default=0.999)
    parser.add_argument("--geo_loss_gamma_horz", type=float, default=0.0)
    parser.add_argument("--geo_loss_gamma_vert", type=float, default=0.0)
    parser.add_argument("--checkpoint_interval", type=int, default=4)
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--cache_location", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=0)
    parser.add_argument("--n_devices", type=int, default=None)
    parser.add_argument("--seed", type=int, default=17)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on ('cuda' or 'cpu')")
    add_bool_arg(parser, "geo_loss", True, "enable the geometric loss")
    add_bool_arg(parser, "evaluate_mode", False, "evaluate only")
    add_bool_arg(parser, "save_checkpoints", True, "save checkpoints")
    add_bool_arg(parser, "cross_batch_geo", True, "reference cross-batch geo-loss semantics")
    # None → the driver's "auto": bf16 on the card, f32 on the CPU
    add_bool_arg(parser, "mixed_precision", None, "bf16 compute with f32 master weights")
    add_bool_arg(parser, "device_targets", False, "synthesise heatmap targets on-device")
    add_bool_arg(parser, "resume", False, "resume from the output_path state file")
    add_bool_arg(parser, "vis_upload_data", False,
                 "render the whole dataset with keypoints, then exit")
    add_bool_arg(parser, "post_run_shutdown", False,
                 "ops hook: shut the machine down after the vis_upload_data pass")
    return parser


def driver_kwargs(argv=None) -> dict:
    """The command line → :func:`rektnet_driver.main`'s keyword arguments
    (the ``automatic`` output path resolved)."""
    opt = build_parser().parse_args(argv)
    if opt.output_path == "automatic":
        opt.output_path = os.path.join("outputs", str(uuid.uuid4()))
    return dict(
        train_dataset_uri=opt.train_dataset_uri, dataset_path=opt.dataset_path,
        output_path=opt.output_path, batch_size=opt.batch_size,
        num_epochs=opt.num_epochs, lr=opt.lr, lr_gamma=opt.lr_gamma,
        validation_ratio=opt.validation_ratio, loss_type=opt.loss_type,
        include_geo=opt.geo_loss, geo_loss_gamma_horz=opt.geo_loss_gamma_horz,
        geo_loss_gamma_vert=opt.geo_loss_gamma_vert, cross_batch=opt.cross_batch_geo,
        checkpoint_interval=opt.checkpoint_interval, study_name=opt.study_name,
        evaluate_mode=opt.evaluate_mode, save_checkpoints=opt.save_checkpoints,
        cache_location=opt.cache_location, checkpoint_path=opt.checkpoint_path,
        num_workers=opt.num_workers, n_devices=opt.n_devices, seed=opt.seed,
        mixed_precision="auto" if opt.mixed_precision is None else opt.mixed_precision,
        device_targets=opt.device_targets, resume=opt.resume,
        vis_upload_data=opt.vis_upload_data, post_run_shutdown=opt.post_run_shutdown,
        device=opt.device)


def _logged_main(mesh=None, **kwargs):
    """``rektnet_driver.main`` with stdout and stderr teed into ``logs/``
    (by rank 0 alone under a mesh)."""
    if mesh is not None and not mesh.is_lead:
        return rektnet_driver.main(**kwargs, mesh=mesh)
    os.makedirs("logs", exist_ok=True)
    out, err = sys.stdout, sys.stderr
    sys.stdout = Logger(os.path.join("logs", kwargs["study_name"] + ".log"))
    sys.stderr = Logger(os.path.join("logs", kwargs["study_name"] + ".error"))
    try:
        return rektnet_driver.main(**kwargs, mesh=mesh)
    finally:
        for tee in (sys.stdout, sys.stderr):
            tee.log.close()
        sys.stdout, sys.stderr = out, err


def main(argv=None) -> int:
    kwargs = driver_kwargs(argv)
    n = kwargs["n_devices"] or 1
    if n > 1 and not kwargs["vis_upload_data"]:
        launch(run_on_rank, rank_devices(n, kwargs["device"]),
               args=(_logged_main, kwargs))
    else:
        _logged_main(**kwargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
