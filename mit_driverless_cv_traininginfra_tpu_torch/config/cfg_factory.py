"""Programmatic Darknet cfg text for the standard YOLOv3 (Darknet-53 +
FPN, the architecture of ``model_cfg/yolo_baseline.cfg``), counterpart of
the JAX package's ``config/cfg_factory.py`` cut to the generator the port
uses. Route indices of the FPN skips are computed from the emitted block
list, so the text parses with :mod:`darknet_cfg` and the reference fork's
parser (its dialect: ``filters=preyolo``, ``yolo_masks`` in ``[net]``,
bare ``[yolo]`` blocks)."""

from __future__ import annotations

from typing import Dict, List, Optional


def _net_block(width: int, height: int, classes: int, masks: str, scales: str,
               extra: Optional[Dict[str, str]] = None) -> List[str]:
    base = {
        "width": width,
        "height": height,
        "onnx_height": 320,
        "classes": classes,
        "channels": 3,
        "yolo_masks": masks,
        "yolo_scales": scales,
        "validate_uri": "dataset/validate.csv",
        "train_uri": "dataset/train.csv",
        "weights_uri": "",
        "start_weights_dim": ",".join(["255"] * len(masks.split("|"))),
        "num_train_images": -1,
        "num_validate_images": -1,
        "leaky_slope": 0.1,
        "conv_activation": "leaky",
        "build_targets_ignore_thresh": 0.5,
        "conf_thresh": 0.8,
        "nms_thresh": 0.25,
        "iou_thresh": 0.5,
    }
    if extra:
        base.update(extra)
    return ["[net]"] + [f"{k}={v}" for k, v in base.items()]


class _Emitter:
    def __init__(self):
        self.lines: List[str] = []
        self.n_blocks = 0

    def block(self, kind: str, **kv):
        self.lines.append("")
        self.lines.append(f"[{kind}]")
        for k, v in kv.items():
            self.lines.append(f"{k}={v}")
        self.n_blocks += 1
        return self.n_blocks - 1  # block index (0-based, excl. [net])

    def conv(self, filters, size, stride=1):
        return self.block("convolutional", filters=filters, size=size, stride=stride)

    def residual(self, mid, out):
        self.conv(mid, 1)
        self.conv(out, 3)
        return self.block("shortcut", **{"from": -3})


def yolov3_cfg(width: int = 800, height: int = 800, classes: int = 80,
               extra_net: Optional[Dict[str, str]] = None) -> str:
    """Full Darknet-53 + FPN YOLOv3 (3 heads at strides 32/16/8)."""
    e = _Emitter()
    e.conv(32, 3)
    stage_out = {}
    for filters, n_res in [(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]:
        e.conv(filters, 3, stride=2)
        for _ in range(n_res):
            idx = e.residual(filters // 2, filters)
        stage_out[filters] = idx  # last shortcut index per stage

    def head(neck_filters, n_pairs=3):
        # alternating 1x1/3x3 neck; the last 1x1 output is the route point
        for _ in range(n_pairs - 1):
            e.conv(neck_filters, 1)
            e.conv(neck_filters * 2, 3)
        route_pt = e.conv(neck_filters, 1)
        e.conv(neck_filters * 2, 3)
        e.conv("preyolo", 1)
        e.block("yolo")
        return route_pt

    head(512)
    e.block("route", layers=-4)
    e.conv(256, 1)
    e.block("upsample", stride=2)
    e.block("route", layers=f"-1, {stage_out[512]}")
    head(256)
    e.block("route", layers=-4)
    e.conv(128, 1)
    e.block("upsample", stride=2)
    e.block("route", layers=f"-1, {stage_out[256]}")
    head(128)

    lines = _net_block(width, height, classes, "6,7,8|3,4,5|0,1,2", "32,16,8", extra_net)
    return "\n".join(lines + e.lines) + "\n"
