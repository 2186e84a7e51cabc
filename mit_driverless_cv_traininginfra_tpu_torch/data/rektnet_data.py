"""RektNet dataset from disk (the port's copy of the JAX package's
``data/rektnet_data.py``; reference ``RektNet/utils.py``
``load_train_csv_dataset`` and ``RektNet/dataset.py`` ``ConeDataset``),
with no pandas, PIL or OpenCV.

- :func:`load_train_csv_dataset` reads ``rektnet_label.csv`` with the
  ``csv`` module: column 0 the image, the keypoint columns found by header
  name, each cell ``"(x,y)"``. A row whose first keypoint cell is empty
  (or one of pandas' default NA strings) is NaN-labelled and skipped, as
  pandas reads it; so are images that do not decode or are under 10 px
  tall. The split is chronological: the first ``int(n · ratio)`` rows
  validate.
- Its ``.npy`` cache is keyed by the SHA-256 of the CSV's bytes, in a
  ``csv-sha256-<hex>`` folder of ``cache_location``. The JAX package keys
  its cache by pandas' ``hash_pandas_object``, which needs pandas: the two
  caches are not shared.
- :class:`ConeDataset` items are ``(image (H, W, 3) float32 BGR in [0, 1],
  heatmaps (K, H, W) float32 or a (K, 1, 1) placeholder, points (K, 2)
  float32 normalised, name, original shape)``, every value the JAX
  package's (``ops/heatmap.py``'s resize and blur are bit-equal to
  OpenCV's).
- :func:`collate_cones` batches them for ``data.loader.DataLoader``
  (in order, on worker threads with at most two batches in flight).
"""

from __future__ import annotations

import csv
import hashlib
import os
from typing import List, Sequence, Tuple

import numpy as np

from mit_driverless_cv_traininginfra_tpu_torch.data.decode import imread_bgr
from mit_driverless_cv_traininginfra_tpu_torch.data.uri import resolve_uri
from mit_driverless_cv_traininginfra_tpu_torch.ops.heatmap import (
    KPT_NAMES,
    get_scale,
    prep_image,
    prep_label,
    scale_keypoints,
)

DEFAULT_KEYPOINT_KEYS = list(KPT_NAMES)

# the strings pandas.read_csv takes for NaN by default
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}


def _read_label_csv(path: str, keypoint_keys: Sequence[str]):
    """(image names, keypoint cells by row) of the rows whose first
    keypoint cell is set."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    cols = [header.index(k) for k in keypoint_keys]
    first = 2  # the JAX loader tests the first keypoint column, column 2
    names, cells = [], []
    for row in body:
        if not row:
            continue
        if len(row) <= first or row[first] in _NA:
            continue
        names.append(row[0])
        cells.append([row[c] for c in cols])
    return names, cells


def load_train_csv_dataset(train_csv_uri: str, validation_percent: float,
                           keypoint_keys: Sequence[str] = tuple(DEFAULT_KEYPOINT_KEYS),
                           dataset_path: str = "", cache_location: str = None):
    """``(train names, train labels (N, K, 2), val names, val labels)`` of
    the label CSV; the first ``int(n · validation_percent)`` usable rows
    validate."""
    train_csv_uri = resolve_uri(train_csv_uri)  # gs:// via a local mirror
    with open(train_csv_uri, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()

    images = labels = None
    folder = os.path.join(cache_location, "csv-sha256-" + digest) if cache_location else None
    if folder and all(os.path.exists(os.path.join(folder, n))
                      for n in ("images.npy", "labels.npy")):
        images = np.load(os.path.join(folder, "images.npy"))
        labels = np.load(os.path.join(folder, "labels.npy"))

    if labels is None:
        names, cells = _read_label_csv(train_csv_uri, keypoint_keys)
        kept_images: List[str] = []
        kept_labels: List[np.ndarray] = []
        for name, row in zip(names, cells):
            pts = np.zeros((len(keypoint_keys), 2))
            for j, cell in enumerate(row):
                txt = cell[1:-1].split(",")
                pts[j, 0], pts[j, 1] = float(txt[0]), float(txt[1])
            uri = os.path.join(dataset_path, name)
            image = imread_bgr(uri)
            if image is None or image.shape[0] < 10:
                continue
            kept_images.append(os.path.basename(uri))
            kept_labels.append(pts)
        images = np.asarray(kept_images)
        labels = np.asarray(kept_labels)
        if folder:
            os.makedirs(folder, exist_ok=True)
            np.save(os.path.join(folder, "images.npy"), images)
            np.save(os.path.join(folder, "labels.npy"), labels)

    num_val = int(len(labels) * validation_percent)
    val_images, val_labels = images[:num_val], labels[:num_val]
    train_images, train_labels = images[num_val:], labels[num_val:]
    print(f"training image number: {len(train_images)}")
    print(f"validation image number: {len(val_images)}")
    return train_images, train_labels, val_images, val_labels


class ConeDataset:
    """Cone crops by index: decode (BGR, as ``cv2.imread``), resize to
    ``target_image_size``, heatmaps at that size (or a placeholder when
    ``compute_heatmaps`` is False: the train step makes its targets on the
    device), keypoints scaled and normalised by the target width."""

    def __init__(self, images, labels, dataset_path: str,
                 target_image_size: Tuple[int, int] = (80, 80),
                 vis_dataloader: bool = False, compute_heatmaps: bool = True):
        self.images = images
        self.labels = labels
        self.dataset_path = dataset_path
        self.target_image_size = tuple(target_image_size)
        self.vis_dataloader = vis_dataloader
        self.compute_heatmaps = compute_heatmaps

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int):
        path = os.path.join(self.dataset_path, str(self.images[index]))
        image = imread_bgr(path)
        if image is None:
            raise FileNotFoundError(path)
        orig_size = image.shape
        name = str(self.images[index]).split(".")[0]
        image = prep_image(image, self.target_image_size)
        if self.compute_heatmaps:
            hm = prep_label(np.asarray(self.labels[index]), self.target_image_size,
                            orig_size, str(self.images[index]))
        else:
            hm = np.zeros((len(self.labels[index]), 1, 1), np.float32)
        h_scale, w_scale = get_scale(orig_size, self.target_image_size)
        pts = scale_keypoints(self.labels[index], h_scale, w_scale).astype(np.float32)
        pts = pts / self.target_image_size[0]
        # BGR, as the reference trains (its dataset never converts)
        img = image.astype(np.float32) / 255.0
        return img, hm.astype(np.float32), pts, name, orig_size


def collate_cones(items):
    """:class:`ConeDataset` items → ``(images, heatmaps, points, names,
    original sizes)``: the first three stacked, the last two lists (the
    JAX package's ``RektNetLoader`` batches). Batch them in order with
    ``data.loader.DataLoader(dataset, batch_size, shuffle=False,
    num_workers=n, collate=collate_cones)``, the reference's
    ``shuffle=False`` loader."""
    return (np.stack([b[0] for b in items]), np.stack([b[1] for b in items]),
            np.stack([b[2] for b in items]), [b[3] for b in items], [b[4] for b in items])
