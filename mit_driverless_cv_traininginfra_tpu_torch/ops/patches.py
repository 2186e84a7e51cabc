"""Tile-and-scale patch geometry, the reference's "big image" strategy (the
port's copy of the JAX package's ``ops/patches.py``).

Each rescaled image is tiled into overlapping fixed-size patches with the
overhang spread evenly between them, and a sample trains on one random
patch. Geometry is plain Python; label filtering is vectorised numpy.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def pre_tile_padding(img_width: int, img_height: int, patch_width: int, patch_height: int) -> Tuple[int, int]:
    """Symmetric padding needed before tiling when the image is smaller than
    one patch. Returns (vert_pad, horiz_pad)."""
    vert_pad, horiz_pad = 0, 0
    if img_width < patch_width:
        horiz_pad = math.ceil((patch_width - img_width) / 2)
    if img_height < patch_height:
        vert_pad = math.ceil((patch_height - img_height) / 2)
    return vert_pad, horiz_pad


def get_patch_spacings(img_width: int, img_height: int, patch_width: int, patch_height: int):
    """(n_wide, n_high, n_total, horiz_offset, vert_offset) with the
    overhang distributed between patches."""
    if img_width < patch_width or img_height < patch_height:
        raise ValueError(f"image {img_width}x{img_height} is smaller than a "
                         f"{patch_width}x{patch_height} patch")

    horiz_num_patches = math.ceil(img_width / patch_width)
    horiz_overhang = horiz_num_patches * patch_width - img_width
    horiz_offset = 0 if horiz_num_patches == 1 else horiz_overhang / (horiz_num_patches - 1)

    vert_num_patches = math.ceil(img_height / patch_height)
    vert_overhang = vert_num_patches * patch_height - img_height
    vert_offset = 0 if vert_num_patches == 1 else vert_overhang / (vert_num_patches - 1)

    total = vert_num_patches * horiz_num_patches
    return horiz_num_patches, vert_num_patches, total, horiz_offset, vert_offset


def get_patch_bounds(img_width: int, img_height: int, patch_width: int, patch_height: int, patch_index: int):
    """(left, top, right, bottom) of patch ``patch_index``, counted from the
    upper-left, row-major. Fractional edges are kept (a crop rounds them
    itself)."""
    n_wide, _, _, horiz_offset, vert_offset = get_patch_spacings(
        img_width, img_height, patch_width, patch_height
    )
    row_position = patch_index % n_wide
    left = patch_width * row_position - horiz_offset * row_position
    right = left + patch_width
    col_position = math.floor(patch_index / n_wide)
    top = patch_height * col_position - vert_offset * col_position
    bottom = top + patch_height
    return left, top, right, bottom


def filter_and_offset_labels(
    labels: np.ndarray,
    boundary,
    overlap_threshold: float = 0.5,
    area_threshold: float = 1000.0,
) -> np.ndarray:
    """Keep boxes overlapping the patch by more than half their area or
    more than 1000 px², clip them to the patch and shift them into patch
    coordinates.

    Input/output: (N, 5) ``[class, x1, y1, x2, y2]``. If nothing survives,
    returns zeros of the input shape (the reference's quirk: zeros with the
    *input* row count).
    """
    labels = np.asarray(labels, dtype=np.float32)
    left, top, right, bottom = boundary
    if labels.shape[0] == 0:
        return np.zeros_like(labels)

    x0, y0, x1, y1 = labels[:, 1], labels[:, 2], labels[:, 3], labels[:, 4]
    box_area = (x1 - x0) * (y1 - y0)
    ox0 = np.maximum(x0, left)
    oy0 = np.maximum(y0, top)
    ox1 = np.minimum(x1, right)
    oy1 = np.minimum(y1, bottom)
    dx = ox1 - ox0
    dy = oy1 - oy0
    overlap = np.where((dx >= 0) & (dy >= 0), dx * dy, 0.0)
    keep = (overlap / np.maximum(box_area, 1e-12) > overlap_threshold) | (
        overlap > area_threshold
    )
    if not keep.any():
        return np.zeros_like(labels)
    kept = np.stack(
        [labels[keep, 0], ox0[keep] - left, oy0[keep] - top, ox1[keep] - left, oy1[keep] - top],
        axis=1,
    )
    return kept.astype(np.float32)
