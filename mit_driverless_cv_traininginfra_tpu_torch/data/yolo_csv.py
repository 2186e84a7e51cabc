"""YOLO label CSVs, the reference's dataset interchange format (the port's
copy of the JAX package's ``data/yolo_csv.py``).

Layout, as the k-means generator writes it:

- row 1: anchors ``"w,h|w,h|..."`` (train.csv) or a free-text note;
- row 2: header ``Name, URL, Width, Height, Scale, 'X0, Y0, H0, W0', ...``;
- rows 3+: ``filename, url, img_w, img_h, scale, [x, y, h, w] json boxes...``
  (top-left corner boxes, h before w).

Rows with any negative coordinate are skipped with a warning, as the
reference's dataset does.
"""

from __future__ import annotations

import csv
import json
import os
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class YoloCsvRow:
    image: str          # filename (joined with dataset_path by consumers)
    width: int
    height: int
    scale: float
    boxes: np.ndarray   # (N, 4) float32 [x, y, h, w] top-left


@dataclass
class YoloCsv:
    anchors: Optional[List[Tuple[float, float]]]
    rows: List[YoloCsvRow]


def read_yolo_csv(path: str) -> YoloCsv:
    rows: List[YoloCsvRow] = []
    anchors = None
    with open(path) as f:
        reader = csv.reader(f)
        for i, row in enumerate(reader):
            if i == 0:
                cell = row[0] if row else ""
                if "|" in cell and "," in cell:
                    try:
                        anchors = [
                            tuple(float(v) for v in chunk.split(","))
                            for chunk in cell.split("|")
                        ]
                    except ValueError:
                        anchors = None
                continue
            if i == 1:
                continue  # header
            boxes = []
            for cell in row[5:]:
                if cell != "":
                    boxes.append(json.loads(cell))
            boxes_np = np.asarray(boxes, np.float32).reshape(-1, 4)
            if (boxes_np < 0).sum() > 0:
                warnings.warn(
                    f"Image {row[0]} at line {i + 1} has negative bounding box "
                    "coordinates; skipping"
                )
                continue
            rows.append(
                YoloCsvRow(
                    image=row[0],
                    width=int(row[2]),
                    height=int(row[3]),
                    scale=float(row[4]),
                    boxes=boxes_np,
                )
            )
    return YoloCsv(anchors=anchors, rows=rows)


def write_yolo_csv(
    path: str,
    rows: Sequence[YoloCsvRow],
    anchors: Optional[Sequence[Tuple[float, float]]] = None,
    note: str = "anchor boxes are only in train.csv",
    url_prefix: str = "",
):
    """Write the reference CSV layout (row 1 anchors/note, row 2 header)."""
    max_boxes = max((len(r.boxes) for r in rows), default=0)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        if anchors is not None:
            w.writerow(["|".join(f"{a[0]},{a[1]}" for a in anchors)])
        else:
            w.writerow([note])
        header = ["Name", "URL", "Width", "Height", "Scale"] + [
            f"'X{i}, Y{i}, H{i}, W{i}'" for i in range(max_boxes)
        ]
        w.writerow(header)
        for r in rows:
            cells = [r.image, os.path.join(url_prefix, r.image), r.width, r.height, r.scale]
            for b in np.asarray(r.boxes):
                cells.append(json.dumps([float(b[0]), float(b[1]), float(b[2]), float(b[3])]))
            w.writerow(cells)
