"""Visualisations (the port's copy of the JAX package's ``utils/vis.py``;
reference ``RektNet/utils.py`` and ``CVC-YOLOv3/utils/utils.py``):
keypoint, heatmap and box renders for the detect CLIs and the
``--vis_batch`` / ``--vis_upload_data`` harnesses, drawn by
``utils/draw.py`` and written by ``data/encode.py``, with no PIL or
OpenCV.

Images are numpy arrays: RGB where the JAX package draws on a PIL image
(boxes), BGR where it draws with OpenCV (keypoints, the dataset render),
as it does. Every file is written to a temporary name and renamed, JPEGs
at the quality of the library the JAX package writes them with (PIL 75,
OpenCV 95).
"""

from __future__ import annotations

import os

import numpy as np

from mit_driverless_cv_traininginfra_tpu_torch.data import raster
from mit_driverless_cv_traininginfra_tpu_torch.data.decode import imread_bgr
from mit_driverless_cv_traininginfra_tpu_torch.data.encode import (
    CV2_QUALITY,
    PIL_QUALITY,
    encode_jpeg,
)
from mit_driverless_cv_traininginfra_tpu_torch.utils import draw

KPT_COLORS = [(0, 255, 0), (255, 0, 0), (255, 255, 0), (0, 255, 255),
              (255, 0, 255), (127, 255, 127), (255, 127, 127)]
# PIL's colour names as the JAX package uses them
NAMED = {"red": (255, 0, 0), "green": (0, 128, 0), "blue": (0, 0, 255)}


def _ink(img: np.ndarray, color):
    """A colour name or RGB triple as PIL inks it: RGB, or its ``L`` value
    on a grey image."""
    rgb = NAMED.get(color, color) if isinstance(color, str) else tuple(color)
    if img.ndim == 2:
        r, g, b = rgb
        return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16
    return rgb


def _write_jpeg(dest: str, rgb: np.ndarray, quality: int) -> str:
    """JPEG bytes of ``rgb`` (or grey) to ``dest`` through ``dest.tmp.jpg``
    (whatever ``dest``'s extension, as the JAX package writes)."""
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    with open(dest + ".tmp.jpg", "wb") as f:
        f.write(encode_jpeg(rgb, quality))
    os.replace(dest + ".tmp.jpg", dest)
    return dest


def draw_boxes(img: np.ndarray, labels, box_color="red") -> np.ndarray:
    """(N, 5) ``[c, x1, y1, x2, y2]`` boxes outlined 1 px on an RGB or grey
    image, in place (``ImageDraw.rectangle``)."""
    if labels is not None:
        ink = _ink(img, box_color)
        for row in np.asarray(labels):
            draw.pil_rectangle(img, (float(row[1]), float(row[2]), float(row[3]),
                                     float(row[4])), ink)
    return img


def visualize_and_save_to_local(img: np.ndarray, labels, tmp_path: str,
                                box_color="red") -> None:
    """Draw boxes on ``img`` (RGB or grey, in place) and write it as a JPEG
    to ``tmp_path``."""
    draw_boxes(img, labels, box_color)
    _write_jpeg(tmp_path, img, PIL_QUALITY)


def vis_kpt_and_save(np_image: np.ndarray, image_name: str, labels,
                     color=(52, 31, 163), output_uri: str = "outputs/visualization") -> str:
    """Radius-3 dots at the pixel keypoints on a BGR image (in place),
    written to ``<output_uri>/<name>_label_vis.jpg``."""
    for pt in np.asarray(labels):
        draw.cv2_circle_filled(np_image, (int(pt[0]), int(pt[1])), 3, color)
    return _write_jpeg(os.path.join(output_uri, image_name + "_label_vis.jpg"),
                       np_image[..., ::-1], CV2_QUALITY)


def vis_hm_and_save(np_heat_map, image_name: str,
                    output_uri: str = "outputs/visualization") -> str:
    """The per-keypoint heatmaps summed into one map, min-max scaled to
    uint8, written to ``<output_uri>/<name>_heat_map.jpg``."""
    summed = np.asarray(np_heat_map, np.float64).sum(axis=0)
    lo, hi = summed.min(), summed.max()
    img = ((summed - lo) * 255.0 / max(hi - lo, 1e-12)).astype(np.uint8)
    return _write_jpeg(os.path.join(output_uri, image_name + "_heat_map.jpg"), img,
                       PIL_QUALITY)


def heatmap_strip(np_heat_map) -> np.ndarray:
    """Each keypoint channel min-max normalised on its own, stacked
    vertically: (K·H, W) float64 in [0, 1] (the reference detect CLI's
    render)."""
    hm = np.asarray(np_heat_map, np.float64)
    rows = []
    for chan in hm:
        lo, hi = chan.min(), chan.max()
        rows.append((chan - lo) / max(hi - lo, 1e-12))
    return np.concatenate(rows, axis=0)


def vis_hm_strip_and_save(np_heat_map, image_name: str,
                          output_uri: str = "outputs/visualization") -> str:
    """:func:`heatmap_strip` as ``<output_uri>/<name>_hm.jpg``."""
    strip = (heatmap_strip(np_heat_map) * 255.0).astype(np.uint8)
    return _write_jpeg(os.path.join(output_uri, image_name + "_hm.jpg"), strip, PIL_QUALITY)


def draw_keypoints(image: np.ndarray, h: int, w: int, tensor_output) -> np.ndarray:
    """Radius-2 dots in ``KPT_COLORS`` at normalised keypoints scaled to
    (w, h), on a BGR image in place."""
    for i, pt in enumerate(np.asarray(tensor_output)):
        draw.cv2_circle_filled(image, (int(pt[0] * w), int(pt[1] * h)), 2,
                               KPT_COLORS[i % len(KPT_COLORS)])
    return image


def vis_tensor_and_save(image: np.ndarray, h: int, w: int, tensor_output,
                        image_name: str, output_uri: str) -> np.ndarray:
    """:func:`draw_keypoints` on the BGR ``image``, written to
    ``<output_uri>/<name>_inference.jpg``; returns the image."""
    draw_keypoints(image, h, w, tensor_output)
    _write_jpeg(os.path.join(output_uri, image_name + "_inference.jpg"), image[..., ::-1],
                CV2_QUALITY)
    return image


def render_dataset_item(img: np.ndarray, label) -> np.ndarray:
    """One image of the ``--vis_upload_data`` pass: a BGR crop padded to a
    square with grey 128 (below or to the right), resized to 1000², the
    keypoint chain drawn in green (radius-3 dots, 2-pixel lines). The
    keypoints are normalised by the padded square's size."""
    h, w, _ = img.shape
    d = abs(h - w)
    img = raster.copy_make_border_constant(img, 0, d if h <= w else 0, 0,
                                           0 if h <= w else d, [128, 128, 128])
    h, w, _ = img.shape
    norm = np.asarray(label, np.float32) / np.asarray([w, h], np.float32)
    img = raster.resize_linear(img, (1000, 1000))
    prev = None
    for pt in norm:
        cvpt = (int(pt[0] * 1000), int(pt[1] * 1000))
        draw.cv2_circle_filled(img, cvpt, 3, (0, 255, 0))
        if prev is not None:
            draw.cv2_line2(img, prev, cvpt, (0, 255, 0))
        prev = cvpt
    return img


def visualize_dataset(images, labels, dataset_path: str,
                      output_uri: str = "outputs/visualization/") -> int:
    """The reference's ``--vis_upload_data`` pass: :func:`render_dataset_item`
    of each decodable image, written as a JPEG under its own name in
    ``output_uri``. Returns the number rendered."""
    os.makedirs(output_uri, exist_ok=True)
    n = 0
    for name, label in zip(images, labels):
        img = imread_bgr(os.path.join(dataset_path, str(name)))
        if img is None:
            continue
        out = render_dataset_item(img, label)
        _write_jpeg(os.path.join(output_uri, str(name)), out[..., ::-1], CV2_QUALITY)
        n += 1
    return n

