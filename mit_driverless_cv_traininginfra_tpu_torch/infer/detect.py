"""Single-image and batched YOLO detection (counterpart of the JAX
package's ``infer/detect.py``): letterbox → forward → confidence filter →
NMS → boxes in the original image's pixels, the reference's
``detect.py`` path, with fixed shapes on the device.

Divisions by a Python scalar follow the JAX package's eager arithmetic,
which is the IEEE quotient: ``detect_image``'s ``/ 255`` and
``unletterbox_boxes``' ``/ ratio`` divide by a 0-d tensor of the divisor
(:func:`_div`), the quotient on the CPU and on the card alike (the card
computes ``tensor / python_scalar`` as ``a · (1/n)``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    ConvBlock,
    NetworkSpec,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import (
    Darknet,
    YoloHeads,
    fold_bn,
    load_darknet_weights,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.boxes import (
    calculate_padding,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.image import letterbox
from mit_driverless_cv_traininginfra_tpu_torch.ops.nms import batched_nms


class Detections(NamedTuple):
    boxes: torch.Tensor   # (B, top_k, 4) xyxy
    scores: torch.Tensor  # (B, top_k)
    mask: torch.Tensor    # (B, top_k) bool


def _div(x, d: float):
    """``x / d`` as the IEEE quotient on every device."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


@torch.inference_mode()
def detect_batch(yolo: YoloHeads, images, conf_thresh: float,
                 nms_thresh: float, top_k: int = 200) -> Detections:
    """Forward and postprocess model-sized images (B, H, W, C) in [0, 1]
    on the detector's device. Boxes come back in model-input pixels (map
    them back with :func:`unletterbox_boxes`)."""
    dets = yolo.detections(images.to(yolo.frame_dtype), with_classes=False)
    conf = dets[..., 4]
    xy, wh = dets[..., 0:2], dets[..., 2:4] / 2
    corner = torch.cat([xy - wh, xy + wh], dim=-1)
    scores = torch.where(conf > conf_thresh, conf,
                         torch.full_like(conf, -torch.inf))
    keep_idx, keep_mask = batched_nms(corner, scores, overlap=nms_thresh,
                                      top_k=top_k)
    boxes = torch.gather(corner, 1, keep_idx[..., None].expand(-1, -1, 4))
    return Detections(boxes, torch.gather(conf, 1, keep_idx), keep_mask)


def unletterbox_boxes(boxes, pad_h: float, pad_w: float, ratio: float):
    """Model-space xyxy boxes → original image pixels (the reference's
    ``detect.py``: divide by the ratio, then take off the pads)."""
    off = torch.tensor([pad_w, pad_h, pad_w, pad_h], dtype=boxes.dtype,
                       device=boxes.device)
    return _div(boxes, ratio) - off


def detect_image(yolo: YoloHeads, image, conf_thresh: float = None,
                 nms_thresh: float = None, top_k: int = 200):
    """Host entry: one RGB image (H, W, 3) at any resolution, uint8 or
    float → ``(boxes_xyxy_orig, scores)`` numpy arrays of the kept
    detections. Integer images are 0-255; a float image is taken as 0-255
    when its maximum exceeds 1.5 (a host read), else as [0, 1]."""
    spec = yolo.spec
    if conf_thresh is None:
        conf_thresh = spec.net.conf_thresh
    if nms_thresh is None:
        nms_thresh = spec.net.nms_thresh
    arr = np.asarray(image)
    img = torch.as_tensor(arr).to(yolo.device, torch.float32)
    if np.issubdtype(arr.dtype, np.integer) or float(img.max()) > 1.5:
        img = _div(img, 255.0)
    h, w = int(img.shape[0]), int(img.shape[1])
    pad_h, pad_w, ratio = calculate_padding(h, w, spec.net.height,
                                            spec.net.width)
    boxed, _ = letterbox(img[None], spec.net.height, spec.net.width)
    det = detect_batch(yolo, boxed, conf_thresh, nms_thresh, top_k)
    boxes = unletterbox_boxes(det.boxes[0], pad_h, pad_w, ratio)
    m = det.mask[0].cpu().numpy()
    return boxes.cpu().numpy()[m], det.scores[0].cpu().numpy()[m]


def darknet_shape_trees(spec: NetworkSpec):
    """(params, state) trees holding only each conv's weight shape, for
    :func:`models.darknet.load_darknet_weights` to fill."""
    return {str(i): {"w": torch.empty((b.filters, spec.out_channels[i], b.size, b.size))}
            for i, b in enumerate(spec.blocks) if isinstance(b, ConvBlock)}, {}


def load_detector(spec: NetworkSpec, weights_path: str, device="cpu"):
    """The serving detector of ``spec`` from a Darknet ``.weights`` file: BN
    folded, the heads sliced to their box and confidence columns
    (``stem_opt.slice_preyolo``), f32, eval mode, on ``device``. Returns
    ``(sliced spec, Darknet)``."""
    from mit_driverless_cv_traininginfra_tpu_torch.models.stem_opt import slice_preyolo

    params, state, _ = load_darknet_weights(spec, *darknet_shape_trees(spec), weights_path)
    spec1, folded = slice_preyolo(spec, fold_bn(params, state, spec))
    return spec1, Darknet(spec1, folded).to(device).eval()
