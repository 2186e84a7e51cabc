"""Tile-and-scale YOLO training dataset (the port's copy of the JAX
package's ``data/yolo_dataset.py``; reference ``ImageLabelDataset``),
host-side numpy with no PIL or OpenCV: decoding goes through
``data/decode.read_rgb`` and every image operation through
``data/raster.py``.

Per image, tile-and-scale (``ts``) mode: scale by the CSV's
per-resolution factor → pad to the patch grid → one random patch per
sample (the dataset holds ``n_patches`` entries per image) → labels
filtered and clipped to the patch. Otherwise: letterbox pad + resize.

Labels: class column → corner xyxy → scale → pad offset → patch filter →
augment → normalised xywh → zero rows up to ``num_targets_per_image``.
Negative final labels raise, as in the reference.

Items are ``(uri, image (H, W, C) f32 in [0, 1], labels (T, 5) f32)``.
Every draw comes from per-item generators keyed on (seed, epoch, index),
the JAX package's, so the same item has the same draws in both packages.

``vis_batch > 0`` writes each stage of the first ``vis_batch`` items —
original, scaled and every patch (or pad-resized), before and after the
augmentations — with its boxes to ``VIS_DIR`` (``utils/vis.py``), then
exits, as the JAX package does.
"""

from __future__ import annotations

import os
import random
import sys
import threading
from typing import List, Tuple

import numpy as np

from mit_driverless_cv_traininginfra_tpu_torch.data import augment as A
from mit_driverless_cv_traininginfra_tpu_torch.data import raster
from mit_driverless_cv_traininginfra_tpu_torch.data.decode import read_rgb
from mit_driverless_cv_traininginfra_tpu_torch.data.uri import resolve_uri
from mit_driverless_cv_traininginfra_tpu_torch.data.yolo_csv import read_yolo_csv
from mit_driverless_cv_traininginfra_tpu_torch.ops.boxes import calculate_padding
from mit_driverless_cv_traininginfra_tpu_torch.ops.patches import (
    filter_and_offset_labels,
    get_patch_bounds,
    get_patch_spacings,
    pre_tile_padding,
)
from mit_driverless_cv_traininginfra_tpu_torch.utils.vis import visualize_and_save_to_local

VIS_DIR = "outputs/visualization"


def _np_xyhw_to_corner_with_class(boxes: np.ndarray) -> np.ndarray:
    """[x, y, h, w] top-left → [0, x1, y1, x2, y2] (class column first)."""
    n = boxes.shape[0]
    out = np.zeros((n, 5), np.float32)
    out[:, 1] = boxes[:, 0]
    out[:, 2] = boxes[:, 1]
    out[:, 3] = boxes[:, 0] + boxes[:, 3]
    out[:, 4] = boxes[:, 1] + boxes[:, 2]
    return out


def _as_float(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W[, C]) → f32 (H, W, C) in [0, 1]."""
    arr = np.asarray(img, np.float32) / 255.0
    return arr[..., None] if arr.ndim == 2 else arr


class ImageLabelDataset:
    """Map-style dataset with the reference's constructor surface.

    ``ud_flip`` and ``salt`` are accepted and unused, as in the JAX
    package. ``device_aug`` leaves all but the affine warp to the train
    step and returns pixel-corner labels. ``debug_mode`` takes patch 0.
    """

    def __init__(
        self,
        path: str,
        dataset_path: str,
        width: int,
        height: int,
        augment_affine: bool = False,
        num_images: int = -1,
        augment_hsv: bool = False,
        lr_flip: bool = False,
        ud_flip: bool = False,
        bw: bool = False,
        vis_batch: int = 0,
        data_aug: bool = False,
        blur: bool = False,
        salt: bool = False,
        noise: bool = False,
        contrast: bool = False,
        sharpen: bool = False,
        ts: bool = True,
        debug_mode: bool = False,
        seed: int = 17,
        device_aug: bool = False,
    ):
        table = read_yolo_csv(resolve_uri(path))  # gs:// via a local mirror
        self.img_files: List[str] = []
        self.labels: List[np.ndarray] = []
        self.scales: List[float] = []
        self.ts = ts
        self.debug_mode = debug_mode
        self.width = width
        self.height = height

        for row in table.rows:
            new_w = int(row.width * row.scale)
            new_h = int(row.height * row.scale)
            vert_pad, horiz_pad = pre_tile_padding(new_w, new_h, width, height)
            full = os.path.join(dataset_path, row.image)
            if ts:
                _, _, n_patches, _, _ = get_patch_spacings(
                    new_w + horiz_pad * 2, new_h + vert_pad * 2, width, height
                )
                self.img_files.extend([full] * n_patches)
                self.labels.extend([row.boxes] * n_patches)
                self.scales.extend([row.scale] * n_patches)
            else:
                self.img_files.append(full)
                self.labels.append(row.boxes)
                self.scales.append(row.scale)

        self._seed = seed
        self._epoch = 0
        self._rng = random.Random(seed)  # the constructor's subset pick only
        if num_images >= 0 and num_images < len(self.img_files):
            idx = self._rng.sample(range(len(self.img_files)), k=num_images)
            self.img_files = [self.img_files[i] for i in idx]
            self.labels = [self.labels[i] for i in idx]
            self.scales = [self.scales[i] for i in idx]

        self.num_targets_per_image = max((len(l) for l in self.labels), default=0)

        self.augment_affine = augment_affine
        self.augment_hsv = augment_hsv
        self.lr_flip = lr_flip
        self.ud_flip = ud_flip
        self.data_aug = data_aug
        self.bw = bw
        self.vis_batch = vis_batch
        self.vis_counter = 0
        self._vis_lock = threading.Lock()
        self.blur = blur
        self.salt = salt
        self.noise = noise
        self.contrast = contrast
        self.sharpen = sharpen
        self.device_aug = device_aug

    def __len__(self) -> int:
        return len(self.img_files)

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-item random streams: draws are keyed on (seed,
        epoch, index), so an index re-augments differently across epochs
        and the same way whatever the loader's workers or batch order."""
        self._epoch = int(epoch)

    def _item_rngs(self, index: int):
        mix = (self._seed * 1_000_003 + self._epoch) * 1_000_003 + index
        return random.Random(mix), np.random.default_rng(
            [self._seed, self._epoch, index])

    def _pad_labels(self, labels: np.ndarray) -> np.ndarray:
        pad = self.num_targets_per_image - len(labels)
        if pad > 0:
            labels = np.concatenate([labels, np.zeros((pad, 5), np.float32)], 0)
        return labels

    def _vis(self, img: np.ndarray, labels, uri: str, suffix: str, color: str) -> None:
        """One stage of the ``vis_batch`` renders: ``img`` with its boxes as
        ``VIS_DIR/<name>_<suffix>.jpg``."""
        name = os.path.basename(uri).rsplit(".", 1)[0]
        path = os.path.join(VIS_DIR, f"{name}_{suffix}.jpg")
        visualize_and_save_to_local(img.copy(), labels, path, box_color=color)
        print(f"new image saved to {path}")

    def __getitem__(self, index: int) -> Tuple[str, np.ndarray, np.ndarray]:
        # per-item generators: items are read on several loader threads at
        # once, where a shared generator would interleave their draws
        rng, np_rng = self._item_rngs(index)
        img_uri = self.img_files[index]
        img_boxes = self.labels[index]
        orig = read_rgb(img_uri)
        if self.vis_batch and len(img_boxes) > 0:
            raw = _np_xyhw_to_corner_with_class(np.asarray(img_boxes, np.float32))
            self._vis(orig, raw, img_uri, "original", "green")

        if self.ts:
            scale = self.scales[index]
            oh, ow = orig.shape[:2]
            sw, sh = int(ow * scale), int(oh * scale)
            pw, ph = self.width, self.height
            vert_pad, horiz_pad = pre_tile_padding(sw, sh, pw, ph)
            cw, ch = sw + 2 * horiz_pad, sh + 2 * vert_pad  # the padded canvas
            _, _, n_patches, _, _ = get_patch_spacings(cw, ch, pw, ph)
            patch_index = 0 if self.debug_mode else rng.randint(0, n_patches - 1)
            boundary = get_patch_bounds(cw, ch, pw, ph, patch_index)
            # LANCZOS-scale, grey-pad, crop the patch: the scaling computed
            # for the patch's pixels only
            img = raster.resized_crop(orig, (sw, sh), vert_pad, horiz_pad, boundary,
                                      raster.LANCZOS)
            ratio = None
        else:
            oh, ow = orig.shape[:2]
            vert_pad, horiz_pad, ratio = calculate_padding(
                oh, ow, self.height, self.width)
            padded = raster.pad(orig, vert_pad, horiz_pad)
            img = raster.resize(padded, (self.width, self.height), raster.BILINEAR)

        if len(img_boxes) == 0:
            if self.bw:
                img = raster.to_grey(img)
            return img_uri, _as_float(img), self._pad_labels(np.zeros((0, 5), np.float32))

        labels = _np_xyhw_to_corner_with_class(np.asarray(img_boxes, np.float32))
        if self.ts:
            labels[:, 1:5] *= self.scales[index]
            labels[:, 1:5] += [horiz_pad, vert_pad, horiz_pad, vert_pad]
            if self.vis_batch:
                scaled = raster.resize(orig, (sw, sh), raster.LANCZOS)
                self._vis(raster.pad(scaled, vert_pad, horiz_pad), labels, img_uri,
                          "scaled", "red")
                for pi in range(n_patches):
                    bnd = get_patch_bounds(cw, ch, pw, ph, pi)
                    self._vis(raster.resized_crop(orig, (sw, sh), vert_pad, horiz_pad, bnd,
                                                  raster.LANCZOS),
                              filter_and_offset_labels(labels, bnd), img_uri,
                              f"patch_{pi}", "blue")
            labels = filter_and_offset_labels(labels, boundary)
        else:
            labels[:, 1:5] += [horiz_pad, vert_pad, horiz_pad, vert_pad]
            labels[:, 1:5] *= ratio
            if self.vis_batch:
                self._vis(img, labels, img_uri, "pad_resized", "blue")

        if self.device_aug:
            # the host keeps only the affine warp; jitter, flip and noise
            # run in the train step (train/steps.py)
            if self.augment_affine or self.data_aug:
                img_h, img_w = img.shape[:2]
                angle = rng.uniform(-10, 10)
                translate = (rng.uniform(-40, 40), rng.uniform(-40, 40))
                sc = rng.uniform(0.9, 1.1)
                shear = rng.uniform(-3, 3)
                img = A.affine_image(img, angle, translate, sc, shear)
                labels = A.affine_labels(img_h, img_w, labels, -angle,
                                         translate, sc, (-shear, 0))
            if self.bw:
                # the step's augmentation cannot change conv1's input width
                img = raster.to_grey(img)
            return img_uri, _as_float(img), self._pad_labels(labels.astype(np.float32))

        if self.vis_batch and self.data_aug:
            self._vis(img, labels, img_uri, "before_aug", "red")
        if (self.augment_hsv or self.data_aug) and rng.random() > 0.5:
            img = A.color_jitter(img, rng)

        img_h, img_w = img.shape[:2]
        if self.augment_affine or self.data_aug:
            angle = rng.uniform(-10, 10)
            translate = (rng.uniform(-40, 40), rng.uniform(-40, 40))
            sc = rng.uniform(0.9, 1.1)
            shear = rng.uniform(-3, 3)
            img = A.affine_image(img, angle, translate, sc, shear)
            labels = A.affine_labels(img_h, img_w, labels, -angle, translate,
                                     sc, (-shear, 0))

        if self.bw:
            img = raster.to_grey(img)

        if self.lr_flip and rng.random() > 0.5:
            img = img[:, ::-1]
            # reference quirk: swaps the x coordinates without reordering
            # x1/x2
            labels[:, 1] = img_w - labels[:, 1]
            labels[:, 3] = img_w - labels[:, 3]
            labels[:, [1, 3]] = labels[:, [3, 1]]

        arr = np.ascontiguousarray(img, np.uint8)
        if self.blur and rng.random() > 0.2:
            arr = A.gaussian_blur(arr, rng.uniform(0, 3.0))
        if self.noise and rng.random() > 0.3:
            arr = A.additive_gaussian_noise(arr, rng.uniform(0, 0.03 * 255),
                                            np_rng)
        if self.contrast and rng.random() > 0.5:
            arr = A.sigmoid_contrast(arr, rng.randint(5, 10), rng.uniform(0.45, 0.75))
        if self.sharpen and rng.random() > 0.3:
            arr = A.sharpen(arr, rng.uniform(0, 0.5))

        if self.vis_batch:
            if self.data_aug:
                self._vis(arr, labels, img_uri, "post_augmentation", "green")
            with self._vis_lock:
                self.vis_counter += 1
                done = self.vis_counter > (self.vis_batch - 1)
            if done:
                sys.exit("Finished visualizing enough images. Exiting!")

        # normalise to xywh in [0, 1]. The corner columns are copied first:
        # numpy column slices are views, so writing cx into out[:, 1] would
        # turn the later w = |x2 − x1| into |x2 − cx|
        out = labels.copy()
        x1, y1 = labels[:, 1].copy(), labels[:, 2].copy()
        x2, y2 = labels[:, 3].copy(), labels[:, 4].copy()
        out[:, 1] = (x1 + x2) / 2 / self.width
        out[:, 2] = (y1 + y2) / 2 / self.height
        out[:, 3] = np.abs(x2 - x1) / self.width
        out[:, 4] = np.abs(y2 - y1) / self.height

        out = self._pad_labels(out.astype(np.float32))
        if (out < 0).sum() > 0:
            raise ValueError(f"labels for image {img_uri} have negative values")
        return img_uri, _as_float(arr), out
