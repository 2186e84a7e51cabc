#!/usr/bin/env python3
"""Evaluate a trained RektNet ``.pt`` (``cli/rektnet_train``'s output) on
held-out crops, f32 and int8 (the port's copy of the repository's
``tools/eval_rektnet_weights.py``)::

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/eval_rektnet_weights.py \\
        --pt outputs/<run>/<E>_loss_<v>.pt [--csv D/rektnet_label.csv \\
        --images D/images --ratio R] [--n 512] [--device cpu]

Two views, each the mean normalised keypoint L2 of the BN-folded
``RektNet`` (f32) and its ``Int8RektNet``: ``fresh_crops``, ``--n`` unseen
``data/synthetic.rektnet_batch`` crops at 80²; with ``--csv``, the label
CSV's chronological validation split through ``ConeDataset`` (BGR crops
decoded and resized as training reads them). The int8 model is calibrated
on 64 crops of the distribution the weights were trained on: with
``--csv``, the first 64 BGR crops of the training split through
``ConeDataset``; without, synthetic RGB crops (seed 7), as the
repository's tool always does. Runs on the card unless ``--device cpu``.
Prints one JSON line, values unrounded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.data.rektnet_data import (  # noqa: E402
    ConeDataset,
    collate_cones,
    load_train_csv_dataset,
)
from mit_driverless_cv_traininginfra_tpu_torch.data.loader import DataLoader  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.device import full_f32, resolve_device  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.models.quantize import (  # noqa: E402
    Int8RektNet,
    calibrate_rektnet,
    quantize_rektnet_params,
)

CALIB_CROPS = 64


@torch.inference_mode()
def _l2(model32, model8, imgs_np, pts_np, dev, batch: int = 256):
    """Mean normalised keypoint L2 of the f32 and int8 models over a crop
    set."""
    d32, d8, n = 0.0, 0.0, 0
    for i in range(0, len(imgs_np), batch):
        x = torch.from_numpy(np.ascontiguousarray(imgs_np[i:i + batch])).to(dev)
        t = pts_np[i:i + batch]
        p32 = model32(x)[1].float().cpu().numpy()
        p8 = model8(x)[1].float().cpu().numpy()
        d32 += float(np.linalg.norm(p32 - t, axis=-1).sum())
        d8 += float(np.linalg.norm(p8 - t, axis=-1).sum())
        n += t.shape[0] * t.shape[1]
    return d32 / n, d8 / n


def _cone_crops(names, labels, images: str, limit=None):
    """(crops, points) of ``ConeDataset`` items, in order."""
    loader = DataLoader(ConeDataset(names[:limit], labels[:limit], images, (80, 80),
                                    compute_heatmaps=False), 256, shuffle=False,
                        num_workers=1, collate=collate_cones)
    imgs, pts = [], []
    for im, _, p, _, _ in loader:
        imgs.append(im)
        pts.append(p)
    if not imgs:
        return np.zeros((0, 80, 80, 3), np.float32), np.zeros((0, 7, 2), np.float32)
    return np.concatenate(imgs), np.concatenate(pts)


def calibration_crops(args):
    """The int8 calibration crops: BGR training crops of the CSV's
    training split (``ConeDataset``) when ``--csv`` is given, else
    synthetic RGB crops."""
    if args.csv:
        ti, tl, _, _ = load_train_csv_dataset(args.csv, validation_percent=args.ratio,
                                              dataset_path=args.images or "")
        crops, _ = _cone_crops(ti, tl, args.images or "", CALIB_CROPS)
        if not len(crops):
            raise ValueError(f"{args.csv}: the training split is empty; nothing to "
                             "calibrate on")
        return crops
    return synthetic.rektnet_batch(np.random.default_rng(7), CALIB_CROPS)[0]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pt", required=True, help=".pt checkpoint")
    ap.add_argument("--csv", default=None, help="rektnet_label.csv for the disk views")
    ap.add_argument("--images", default=None)
    ap.add_argument("--ratio", type=float, default=0.15)
    ap.add_argument("--n", type=int, default=512, help="fresh held-out crops")
    ap.add_argument("--seed", type=int, default=424242)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    full_f32(dev)
    folded = rektnet.fold_bn(*rektnet.load_torch_checkpoint(args.pt))
    model32 = rektnet.RektNet(folded).to(dev).eval()

    t0 = time.perf_counter()
    cal = calibration_crops(args)
    q = quantize_rektnet_params(folded, calibrate_rektnet(folded, cal))
    model8 = Int8RektNet(q).to(dev).eval()
    ev_i, ev_p = synthetic.rektnet_batch(np.random.default_rng(args.seed), args.n)
    l2_32, l2_8 = _l2(model32, model8, ev_i, ev_p, dev)
    out = {"metric": "rektnet_production_weights_l2_80", "pt": args.pt,
           "fresh_crops": args.n, "l2_f32": l2_32, "l2_int8": l2_8,
           "int8_delta": l2_8 - l2_32,
           "calibration": "disk train BGR" if args.csv else "synthetic RGB"}
    if args.csv:
        _, _, vi, vl = load_train_csv_dataset(args.csv, validation_percent=args.ratio,
                                              dataset_path=args.images or "")
        imgs, pts = _cone_crops(vi, vl, args.images or "")
        v32, v8 = _l2(model32, model8, imgs, pts, dev)
        out.update(disk_val_crops=len(pts), disk_val_l2_f32=v32, disk_val_l2_int8=v8)
    out["eval_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
