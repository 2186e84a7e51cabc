"""Spec-driven Darknet/YOLOv3 — eval-mode inference on BN-folded weights
(counterpart of the JAX package's ``models/darknet.py``).

The graph comes from the JAX package's frozen ``NetworkSpec`` (its config
modules are jax-free and imported as they are). Parameter trees mirror the
JAX package's with OIHW weights: ``{"<block index>": {"w", "bn": {"scale",
"bias"}}}`` for BN convs and ``{"w", "b"}`` for the linear pre-yolo convs,
plus a state tree of BN running ``{"mean", "var"}``. :func:`fold_bn` folds
them; :class:`Darknet` runs the folded graph. Frames come in NHWC and are
viewed as NCHW (channels_last) inside; head outputs go back out in NHWC.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mit_driverless_cv_traininginfra_tpu.config.darknet_cfg import (
    ConvBlock,
    MaxPoolBlock,
    NetworkSpec,
    RouteBlock,
    ShortcutBlock,
    UpsampleBlock,
    YoloBlock,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import (
    BN_EPS,
    conv2d,
)


def fold_bn(params, state, spec: NetworkSpec):
    """Fold BN into conv weight/bias: w' = w·γ/σ, b' = β − μ·γ/σ. Returns
    ``{"<i>": {"w", "b"}}`` for every conv block."""
    folded = {}
    for i, b in enumerate(spec.blocks):
        if not isinstance(b, ConvBlock):
            continue
        p = params[str(i)]
        if b.batch_normalize:
            s = state[str(i)]
            inv = p["bn"]["scale"] / torch.sqrt(s["var"] + BN_EPS)
            folded[str(i)] = {"w": p["w"] * inv[:, None, None, None],
                              "b": p["bn"]["bias"] - s["mean"] * inv}
        else:
            folded[str(i)] = {"w": p["w"], "b": p["b"]}
    return folded


def _maxpool(x, size: int, stride: int):
    """torch MaxPool2d semantics incl. the reference's k=2, s=1 case, which
    zero-pads one row and column at the bottom/right first."""
    if size == 2 and stride == 1:
        return F.max_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)
    return F.max_pool2d(x, size, stride, (size - 1) // 2)


def _upsample(x, stride: int):
    """Nearest-neighbour ×stride on NCHW."""
    return x.repeat_interleave(stride, dim=2).repeat_interleave(stride, dim=3)


def decode_head(head_out, anchors: Sequence[Tuple[float, float]],
                img_height: int, num_classes: int,
                with_classes: bool = True):
    """YOLO anchor decode, eval branch: head_out (B, H, W, A·(5+C)) NHWC →
    (B, A·H·W, 5+C) — or 5 columns with ``with_classes=False`` — as
    [cx, cy, w, h] in input pixels, conf, cls. Decodes in f32 whatever the
    head dtype (box centres reach 416, where bf16's ulp is 2) and uses the
    height stride on both axes (the reference's quirk). ``anchors`` (A, 2)
    (w, h) pairs; pass them as an f32 tensor on the head's device to keep
    the host from waiting on a host→device copy."""
    b, gh, gw, _ = head_out.shape
    na = len(anchors)
    nattr = 5 + num_classes
    stride = img_height / gh
    pred = head_out.float().reshape(b, gh, gw, na, nattr).permute(0, 3, 1, 2, 4)
    xy = torch.sigmoid(pred[..., 0:2])
    wh = pred[..., 2:4]
    conf = torch.sigmoid(pred[..., 4:5])
    dev = head_out.device
    grid_x = torch.arange(gw, dtype=torch.float32, device=dev)[None, None, None, :]
    grid_y = torch.arange(gh, dtype=torch.float32, device=dev)[None, None, :, None]
    anc = torch.as_tensor(anchors, dtype=torch.float32, device=dev) / stride
    aw = anc[:, 0][None, :, None, None]
    ah = anc[:, 1][None, :, None, None]
    boxes = torch.stack([xy[..., 0] + grid_x, xy[..., 1] + grid_y,
                         torch.exp(wh[..., 0]) * aw,
                         torch.exp(wh[..., 1]) * ah], dim=-1)
    cols = [boxes * stride, conf]
    if with_classes:
        cols.append(torch.sigmoid(pred[..., 5:]))
    out = torch.cat(cols, dim=-1)
    return out.reshape(b, na * gh * gw, out.shape[-1])


class Darknet(nn.Module):
    """Eval-mode Darknet on a :func:`fold_bn` tree of ``spec``."""

    def __init__(self, spec: NetworkSpec, folded):
        super().__init__()
        self.spec = spec
        self.convs = nn.ModuleDict({
            str(i): conv2d(folded[str(i)]["w"], folded[str(i)]["b"],
                           stride=b.stride, padding=(b.size - 1) // 2)
            for i, b in enumerate(spec.blocks) if isinstance(b, ConvBlock)
        })
        self._yolo = [b for b in spec.blocks if isinstance(b, YoloBlock)]
        # f32 anchors per device, kept off the module's buffers so that
        # .to(torch.bfloat16) cannot round them
        self._anchors: dict[torch.device, list[torch.Tensor]] = {}

    def _anchor_tensors(self, device):
        if device not in self._anchors:
            self._anchors[device] = [
                torch.tensor(yb.anchors, dtype=torch.float32, device=device)
                for yb in self._yolo]
        return self._anchors[device]

    def forward_features(self, x):
        """x (B, H, W, C) → raw pre-yolo maps, one per yolo head, each
        NHWC (B, h, w, A·(5+C))."""
        slope = self.spec.net.leaky_slope
        x = x.permute(0, 3, 1, 2)
        outputs, layer_outputs = [], []
        for i, b in enumerate(self.spec.blocks):
            if isinstance(b, ConvBlock):
                x = self.convs[str(i)](x)
                if b.activation == "leaky":
                    x = F.leaky_relu(x, slope)
                elif b.activation == "ReLU":
                    x = F.relu(x)
            elif isinstance(b, MaxPoolBlock):
                x = _maxpool(x, b.size, b.stride)
            elif isinstance(b, UpsampleBlock):
                x = _upsample(x, b.stride)
            elif isinstance(b, RouteBlock):
                x = torch.cat([layer_outputs[li] for li in b.layers], dim=1)
            elif isinstance(b, ShortcutBlock):
                x = layer_outputs[-1] + layer_outputs[b.from_layer]
            elif isinstance(b, YoloBlock):
                outputs.append(x.permute(0, 2, 3, 1))
            layer_outputs.append(x)
        return outputs

    def detections(self, x, with_classes: bool = True):
        """Full eval forward: per-head decodes concatenated along the box
        axis, (B, ΣA·h·w, 5+C) (or 5 with ``with_classes=False``), f32."""
        anchors = self._anchor_tensors(x.device)
        return torch.cat([
            decode_head(h, anc, self.spec.net.height,
                        self.spec.net.num_classes, with_classes=with_classes)
            for h, anc in zip(self.forward_features(x), anchors)
        ], dim=1)

    def forward(self, x):
        """The serving decode: ``detections(x, with_classes=False)``."""
        return self.detections(x, with_classes=False)
