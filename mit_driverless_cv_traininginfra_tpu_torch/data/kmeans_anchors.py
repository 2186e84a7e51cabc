"""k-means anchors and the dataset CSVs (the port's copy of the JAX
package's ``data/kmeans_anchors.py``; reference
``generate_kmeans_dataset_csvs.py``).

1. measure every image's resolution (``data/decode.read_rgb``);
2. per resolution, map the 5th–95th percentile cone heights onto
   [min_cone, max_cone] px → that resolution's *scale factor* (CSV column
   5), which makes the tile-and-scale loader resolution-invariant;
3. Lloyd k-means over the scaled (h, w) box sizes → ``num_clst`` anchors,
   sorted by area;
4. write train/validate/test/train-validate/all CSVs with the modulo split
   and the 0-label image trade (empty-label rows move from validate to
   train, the same count of labelled train rows the other way);
5. the anchors go as ``"h,w|h,w|..."`` into row 1 of train.csv.

The anchors are written (h, w) and read as (w, h) by the model, a
reference quirk the whole system is consistent under.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mit_driverless_cv_traininginfra_tpu_torch.data.decode import read_rgb
from mit_driverless_cv_traininginfra_tpu_torch.data.yolo_csv import (
    YoloCsvRow,
    read_yolo_csv,
    write_yolo_csv,
)


def kmeans_boxes(sizes: np.ndarray, k: int, seed: int = 0,
                 max_iters: int = 1000) -> np.ndarray:
    """Lloyd k-means on (N, 2) (h, w) sizes; random-row init; runs until the
    assignment is stable."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.float64)
    centroids = sizes[rng.integers(0, len(sizes), size=k)].copy()
    assign = np.full(len(sizes), -1)
    for _ in range(max_iters):
        d = np.linalg.norm(sizes[:, None, :] - centroids[None, :, :], axis=2)
        new_assign = d.argmin(axis=1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for i in range(k):
            m = assign == i
            if m.any():
                centroids[i] = sizes[m].mean(axis=0)
    return centroids


def compute_scale_factors(
    box_dict: Dict[Tuple[int, int], List[Tuple[float, float]]],
    max_cone: float,
    min_cone: float,
):
    """Per-resolution scale factors and the scaled box sizes."""
    scale_dict: Dict[Tuple[int, int], float] = {}
    scaled: List[Tuple[float, float]] = []
    for res, boxes in box_dict.items():
        srt = sorted(boxes, key=lambda x: x[0])
        max_h, max_w = srt[int(0.95 * len(srt)) - 1]
        min_h, min_w = srt[int(0.05 * len(srt))]
        denom = max_h - min_h
        ratio = (max_cone - min_cone) / denom if denom else 1.0
        scale_dict[res] = ratio
        for bh, bw in boxes:
            scaled.append(
                ((bh - min_h) * ratio + min_cone, (bw - min_w) * ratio + min_cone)
            )
    return scale_dict, np.asarray(scaled, np.float64)


def generate_dataset_csvs(
    csv_uri: str,
    dataset_path: str,
    output_path: str,
    num_clst: int = 9,
    max_cone: float = 83,
    min_cone: float = 10,
    split_up: Sequence[int] = (75, 15, 0),
    seed: int = 0,
    plot: bool = False,
) -> List[Tuple[float, float]]:
    """Run the whole pipeline; returns the sorted anchors [(h, w), ...].
    ``plot`` draws the box distributions with matplotlib, which it then
    needs."""
    table = read_yolo_csv(csv_uri)

    box_dict: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    out_rows: List[YoloCsvRow] = []
    for row in table.rows:
        img_path = os.path.join(dataset_path, row.image)
        if not os.path.isfile(img_path):
            raise FileNotFoundError(f"could not find image: {img_path}")
        img_h, img_w = read_rgb(img_path).shape[:2]
        for b in row.boxes:  # CSV boxes are [x, y, h, w]
            box_dict.setdefault((img_h, img_w), []).append((float(b[2]), float(b[3])))
        out_rows.append(
            YoloCsvRow(image=row.image, width=img_w, height=img_h,
                       scale=1.0, boxes=row.boxes)
        )

    scale_dict, scaled_sizes = compute_scale_factors(box_dict, max_cone, min_cone)
    for r in out_rows:
        r.scale = scale_dict[(r.height, r.width)]

    anchors = kmeans_boxes(scaled_sizes, num_clst, seed=seed)
    anchors_sorted = sorted(
        ([float(a[0]), float(a[1])] for a in anchors), key=lambda x: x[0] * x[1]
    )

    if plot:
        _plot_boxes(box_dict, scaled_sizes, anchors_sorted, output_path)

    # the modulo split
    train, validate, test, train_validate, all_rows = [], [], [], [], []
    for i, r in enumerate(out_rows):
        all_rows.append(r)
        rem = i % 100
        if rem < split_up[0]:
            train.append(r)
            train_validate.append(r)
        elif rem < split_up[0] + split_up[1]:
            validate.append(r)
            train_validate.append(r)
        else:
            test.append(r)

    # the 0-label trade: empty-label rows move from validate to train, and
    # as many labelled train rows move the other way
    empty = [r for r in validate if len(r.boxes) == 0]
    for r in empty:
        validate.remove(r)
    compensate = []
    # the count is bounded by len(empty): the reference's loop never ends
    # its compensation when there is no empty image, and would drain the
    # whole training split into validation
    for r in train:
        if len(compensate) == len(empty):
            break
        if len(r.boxes) > 0:
            compensate.append(r)
    for r in compensate:
        train.remove(r)
    train.extend(empty)
    validate.extend(compensate)
    print(f"{len(empty)} '0 label images' got traded from validation set to training set.")

    os.makedirs(output_path, exist_ok=True)
    anchor_pairs = [(a[0], a[1]) for a in anchors_sorted]
    note = "please see k-means anchor boxes in train.csv"
    write_yolo_csv(os.path.join(output_path, "train.csv"), train, anchors=anchor_pairs)
    write_yolo_csv(os.path.join(output_path, "validate.csv"), validate, note=note)
    write_yolo_csv(os.path.join(output_path, "test.csv"), test, note=note)
    write_yolo_csv(os.path.join(output_path, "train-validate.csv"), train_validate, note=note)
    write_yolo_csv(os.path.join(output_path, "all.csv"), all_rows, note=note)

    with open(os.path.join(output_path, "anchors.txt"), "w") as f:
        for h, w in anchor_pairs:
            f.write("%0.2f,%0.2f \n" % (h, w))
    return anchor_pairs


def _plot_boxes(box_dict, scaled_sizes, anchors, output_path):
    try:
        import matplotlib
    except ImportError:
        raise RuntimeError("plotting the anchor and box distributions needs "
                           "matplotlib, which is not installed: pass "
                           "--no_if_plot") from None

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_path, exist_ok=True)
    fig = plt.figure()
    for res, boxes in box_dict.items():
        b = np.asarray(boxes)
        plt.scatter(b[:, 1], b[:, 0], s=4, label=str(res))
    plt.axis((0, 450, 0, 450))
    plt.xlabel("Width")
    plt.ylabel("Height")
    plt.legend()
    fig.suptitle("Original Sizes")
    fig.savefig(os.path.join(output_path, "original_boxes.png"))

    fig2 = plt.figure()
    plt.scatter(scaled_sizes[:, 1], scaled_sizes[:, 0], s=4)
    a = np.asarray(anchors)
    plt.scatter(a[:, 1], a[:, 0], color="k")
    fig2.suptitle("Centroids and Scaled Boxes")
    fig2.savefig(os.path.join(output_path, "centroids_scaled.png"))
    plt.close("all")
