#!/usr/bin/env python3
"""Render the synthetic cone distribution to disk in the reference's
dataset layout (the port's copy of the repository's
``tools/make_synth_dataset.py``), so the training CLIs run on files::

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/make_synth_dataset.py \\
        --out D --train 1000 --val 64 [--size 640] [--seed 5] [--format jpg]
    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/make_synth_dataset.py \\
        --out D --family rektnet --train 512 --val 64 [--format npy]

``yolo``: cone scenes (``data/synthetic.cone_scene``) under ``D/images``,
``D/train.csv`` and ``D/validate.csv`` in the k-means generator's layout
(``data/yolo_csv.py``: ``[x, y, h, w]`` top-left boxes, h before w) and
``D/yolo_synth_<net>.cfg``, the flagship YOLOv3 cfg (80 classes, vanilla
anchors) naming the CSVs. ``rektnet``: cone crops of 64-160 px
(``cone_crop``) under ``D/images`` and ``D/rektnet_label.csv`` (image,
url, the 7 keypoint cells ``"(x,y)"`` in the crop's pixels), the
validation rows first, as ``cli/rektnet_train``'s chronological split
reads them. Images are JPEG (``data/encode.py``, ``--quality``), PNG or
``.npy`` (RGB). ``D/meta.json`` records the run; for ``rektnet`` its
``validation_ratio`` is ``(val + ½) / (train + val)``, which
``int(n · ratio)`` floors to exactly ``val`` (the plain quotient, rounded,
can floor to ``val − 1``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from mit_driverless_cv_traininginfra_tpu_torch.config.cfg_factory import yolov3_cfg  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.data.encode import write_image  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.data.rektnet_data import (  # noqa: E402
    DEFAULT_KEYPOINT_KEYS,
)
from mit_driverless_cv_traininginfra_tpu_torch.data.yolo_csv import (  # noqa: E402
    YoloCsvRow,
    write_yolo_csv,
)


def validation_ratio(train: int, val: int) -> float:
    """The ``--validation_ratio`` that splits off exactly ``val`` of
    ``train + val`` rows under ``int(n · ratio)``."""
    return (val + 0.5) / (train + val)


def _save(img_dir: str, stem: str, img: np.ndarray, fmt: str, quality: int) -> str:
    """Write a float [0, 1] RGB image as ``stem.<fmt>``; returns the name."""
    name = f"{stem}.{fmt}"
    write_image(os.path.join(img_dir, name),
                (np.clip(img, 0, 1) * 255).astype(np.uint8), quality)
    return name


def _write_split(csv_path: str, img_dir: str, prefix: str, n: int, size: int, rng,
                 max_overlap, scale_range, fmt: str, quality: int) -> int:
    """Render n scenes; write the images and one reference-format CSV."""
    rows = []
    for i in range(n):
        img, boxes = synthetic.cone_scene(rng, size=size, max_overlap=max_overlap)
        name = _save(img_dir, f"{prefix}_{i:05d}", img, fmt, quality)
        xyhw = np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 3] - boxes[:, 1],
                         boxes[:, 2] - boxes[:, 0]], axis=1) if len(boxes) \
            else np.zeros((0, 4), np.float32)
        rows.append(YoloCsvRow(image=name, width=size, height=size,
                               scale=round(float(rng.uniform(*scale_range)), 4),
                               boxes=np.round(xyhw, 2).astype(np.float32)))
    write_yolo_csv(csv_path, rows, note="synthetic cone scenes (data/synthetic.py); "
                                        "vanilla anchors, no anchor row")
    return len(rows)


def _write_rektnet_split(out_dir: str, train: int, val: int, rng, size_lo: int,
                         size_hi: int, fmt: str, quality: int) -> str:
    """Cone crops of varying sizes, the validation rows first; returns the
    label CSV's path."""
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    lines = ["image,url," + ",".join(DEFAULT_KEYPOINT_KEYS)]
    for i in range(val + train):
        size = int(rng.integers(size_lo, size_hi + 1))
        img, pts = synthetic.cone_crop(rng, size=size)
        # pixel keypoints; the heatmap one-hots at int(px), so inside the crop
        px = np.clip(pts * size, 0, size - 1)
        name = _save(img_dir, f"{'va' if i < val else 'tr'}_{i:05d}", img, fmt, quality)
        cells = ",".join(f'"({p[0]:.2f},{p[1]:.2f})"' for p in px)
        lines.append(f"{name},local,{cells}")
    csv_path = os.path.join(out_dir, "rektnet_label.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return csv_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--family", default="yolo", choices=["yolo", "rektnet"])
    ap.add_argument("--train", type=int, default=1000)
    ap.add_argument("--val", type=int, default=64)
    ap.add_argument("--size", type=int, default=640,
                    help="rendered scene edge (640 → a 2×2 patch grid at 416)")
    ap.add_argument("--net-size", type=int, default=416,
                    help="the emitted cfg's width and height")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--max-overlap", type=float, default=0.1,
                    help="pairwise box IoU cap; negative = off")
    ap.add_argument("--scale-lo", type=float, default=0.85)
    ap.add_argument("--scale-hi", type=float, default=1.2)
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--format", default="jpg", choices=["jpg", "png", "npy"])
    args = ap.parse_args(argv)

    if args.family == "rektnet":
        t0 = time.perf_counter()
        csv_path = _write_rektnet_split(args.out, args.train, args.val,
                                        np.random.default_rng(args.seed), 64, 160,
                                        args.format, args.quality)
        meta = {"family": "rektnet", "train": args.train, "val": args.val,
                "validation_ratio": validation_ratio(args.train, args.val),
                "seed": args.seed, "format": args.format, "quality": args.quality,
                "render_s": round(time.perf_counter() - t0, 1)}
        with open(os.path.join(args.out, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        print(json.dumps(meta))
        print(f"csv: {csv_path}")
        return 0

    img_dir = os.path.join(args.out, "images")
    os.makedirs(img_dir, exist_ok=True)
    mo = None if args.max_overlap < 0 else args.max_overlap
    t0 = time.perf_counter()
    # separate streams per split: the held-out scenes are unseen
    split = dict(size=args.size, max_overlap=mo, scale_range=(args.scale_lo, args.scale_hi),
                 fmt=args.format, quality=args.quality)
    n_tr = _write_split(os.path.join(args.out, "train.csv"), img_dir, "tr", args.train,
                        rng=np.random.default_rng(args.seed), **split)
    n_va = _write_split(os.path.join(args.out, "validate.csv"), img_dir, "va", args.val,
                        rng=np.random.default_rng(args.seed + 10_000), **split)
    cfg_path = os.path.join(args.out, f"yolo_synth_{args.net_size}.cfg")
    with open(cfg_path, "w") as f:
        f.write(yolov3_cfg(width=args.net_size, height=args.net_size, classes=80,
                           extra_net={"train_uri": os.path.join(args.out, "train.csv"),
                                      "validate_uri": os.path.join(args.out, "validate.csv")}))
    meta = {"train": n_tr, "val": n_va, "size": args.size, "seed": args.seed,
            "max_overlap": mo, "scale_range": [args.scale_lo, args.scale_hi],
            "format": args.format, "quality": args.quality,
            "render_s": round(time.perf_counter() - t0, 1)}
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))
    print(f"cfg: {cfg_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
