"""YOLO training from the command line (the reference's ``train.py``
surface, the JAX package's ``cli/yolo_train.py``) on the port's driver::

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.yolo_train \\
        --model_cfg model_cfg/yolo_baseline.cfg --dataset_path dataset/YOLO_Dataset/ \\
        --batch_size 8 --augment_affine --augment_hsv --augment_lr_flip

The flags and defaults are the JAX CLI's (batch 7, the ``--augment_*``
names, an ``automatic`` output path under ``outputs/``), plus ``--device``
(``cuda`` unless the CPU is asked for). The ``[net]`` block's
``train_uri``/``validate_uri`` name the CSVs (``cli/kmeans_csvs`` writes
them). While it runs, stdout and stderr are also written to
``logs/<cfg>.log`` and ``logs/<cfg>.error``. ``--n_devices N`` (N > 1)
trains on N ranks, one a device (``parallel/launch.py``: ``cuda:0``… of the
visible cards, or N CPU processes with ``--device cpu``); rank 0 prints and
writes the logs.
"""

from __future__ import annotations

import argparse
import os
import sys

from mit_driverless_cv_traininginfra_tpu_torch.parallel.launch import (
    launch,
    rank_devices,
    run_on_rank,
)
from mit_driverless_cv_traininginfra_tpu_torch.train import yolo_driver
from mit_driverless_cv_traininginfra_tpu_torch.utils.logger import Logger, add_bool_arg

# the CLI keeps the reference's --augment_* names; the driver's kwargs use
# the bare names
RENAME = {"augment_lr_flip": "lr_flip", "augment_ud_flip": "ud_flip",
          "augment_blur": "blur", "augment_salt": "salt",
          "augment_noise": "noise", "augment_contrast": "contrast",
          "augment_sharpen": "sharpen"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="YOLO training (PyTorch)")

    def boolarg(name, default, help):
        add_bool_arg(parser, name, default, help)

    # 7, as the reference's default
    parser.add_argument("--batch_size", type=int, default=7)
    parser.add_argument("--optimizer_pick", type=str, default="Adam",
                        choices=["Adam", "SGD"])
    parser.add_argument("--model_cfg", type=str, default="model_cfg/yolo_baseline.cfg")
    parser.add_argument("--weights_path", type=str, default=None)
    parser.add_argument("--output_path", type=str, default="automatic")
    parser.add_argument("--dataset_path", type=str, default="dataset/YOLO_Dataset/")
    parser.add_argument("--num_epochs", type=int, default=2048)
    parser.add_argument("--num_steps", type=int, default=8388608)
    parser.add_argument("--checkpoint_interval", type=int, default=1)
    parser.add_argument("--val_tolerance", type=int, default=3)
    parser.add_argument("--min_epochs", type=int, default=3)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--gamma", type=float, default=0.95)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--xy_loss", type=float, default=2.0)
    parser.add_argument("--wh_loss", type=float, default=1.6)
    parser.add_argument("--no_object_loss", type=float, default=25.0)
    parser.add_argument("--object_loss", type=float, default=0.1)
    parser.add_argument("--grad_clip", type=float, default=0.0,
                        help="global-norm gradient clip (0 = off)")
    parser.add_argument("--lr_warmup_steps", type=int, default=0,
                        help="linear lr warmup over the first N steps")
    parser.add_argument("--val_batch_size", type=int, default=None,
                        help="validation batch size (default: batch_size)")
    parser.add_argument("--vis_batch", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--n_devices", type=int, default=None)
    parser.add_argument("--seed", type=int, default=17)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on ('cuda' or 'cpu')")
    boolarg("evaluate", False, "evaluate only, no training")
    boolarg("resume", False, "resume from the output_path checkpoint")
    # None → the driver's "auto": bf16 on the card, f32 on the CPU
    boolarg("mixed_precision", None, "bf16 compute with f32 master weights")
    boolarg("device_aug", False, "run augmentation on-device inside the train step")
    boolarg("packed_stem", False,
            "train blocks 0-1 through the exact space-to-depth rewrite")
    boolarg("preload_device", False,
            "train from a device-resident sample pool (host-bound machines)")
    parser.add_argument("--preload_num", type=int, default=None,
                        help="cap the device pool to this many samples "
                             "(default: whole dataset)")
    parser.add_argument("--preload_budget_gb", type=float, default=6.0,
                        help="device-memory budget for the pool; with bf16 "
                             "mixed precision the pool is stored bf16 "
                             "(half the bytes)")
    # the reference's flag names: --augment_lr_flip etc.
    boolarg("augment_affine", False, "enable affine augmentation")
    boolarg("augment_hsv", False, "enable HSV jitter")
    boolarg("augment_lr_flip", False, "enable left-right flips")
    boolarg("augment_ud_flip", False, "enable up-down flips")
    boolarg("data_aug", False, "enable the full augmentation suite")
    boolarg("augment_blur", False, "enable gaussian blur augmentation")
    boolarg("augment_salt", False, "enable salt augmentation")
    boolarg("augment_noise", False, "enable additive gaussian noise")
    boolarg("augment_contrast", False, "enable sigmoid contrast")
    boolarg("augment_sharpen", False, "enable sharpen augmentation")
    boolarg("ts", True, "enable tile-and-scale mode")
    boolarg("debug_mode", False, "batch 1, no shuffle, patch 0")
    boolarg("vanilla_anchor", False, "use the vanilla anchor list")
    boolarg("upload_dataset", False, "upload dataset visualizations")
    return parser


def driver_kwargs(argv=None) -> dict:
    """The command line → :func:`yolo_driver.main`'s keyword arguments
    (the ``automatic`` output path resolved)."""
    opt = build_parser().parse_args(argv)
    if opt.output_path == "automatic":
        from datetime import datetime

        stem = os.path.basename(opt.model_cfg).split(".")[0]
        month = datetime.now().strftime("%B").lower()
        year = str(datetime.now().year)
        opt.output_path = os.path.join("outputs", f"{month}-{year}-experiments", stem)
    kwargs = {RENAME.get(k, k): v for k, v in vars(opt).items()
              if k != "upload_dataset"}
    if kwargs.get("mixed_precision") is None:
        kwargs["mixed_precision"] = "auto"
    return kwargs


def _logged_main(mesh=None, **kwargs):
    """``yolo_driver.main`` with stdout and stderr teed into ``logs/`` (by
    rank 0 alone under a mesh)."""
    if mesh is not None and not mesh.is_lead:
        return yolo_driver.main(**kwargs, mesh=mesh)
    os.makedirs("logs", exist_ok=True)
    stem = os.path.basename(kwargs["model_cfg"]).split(".")[0]
    out, err = sys.stdout, sys.stderr
    sys.stdout = Logger(os.path.join("logs", stem + ".log"))
    sys.stderr = Logger(os.path.join("logs", stem + ".error"))
    try:
        return yolo_driver.main(**kwargs, mesh=mesh)
    finally:
        for tee in (sys.stdout, sys.stderr):
            tee.log.close()
        sys.stdout, sys.stderr = out, err


def main(argv=None) -> int:
    kwargs = driver_kwargs(argv)
    n = kwargs["n_devices"] or 1
    if n > 1:
        launch(run_on_rank, rank_devices(n, kwargs["device"]),
               args=(_logged_main, kwargs))
    else:
        _logged_main(**kwargs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
