"""Darknet ``.cfg`` ingestion → a frozen, hashable network spec
(counterpart of the JAX package's ``config/darknet_cfg.py``, cut to what
the port uses).

The parser follows the reference fork's ``utils/parse_config.py``: blocks
open with ``[type]``, ``#`` starts a comment line, ``key=value`` pairs are
stripped, and ``convolutional`` blocks default to ``batch_normalize=0``.
Anchors come from ``anchors_override``, from row 1 of the training CSV the
``[net]`` block names, or from the vanilla COCO list.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

# COCO anchors at 416-scale, (w, h) pairs: the reference's fallback list
VANILLA_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (10, 13), (16, 30), (33, 23),
    (30, 61), (62, 45), (59, 119),
    (116, 90), (156, 198), (373, 326),
)


def parse_model_text(text: str) -> List[Dict[str, str]]:
    """Darknet ``.cfg`` text → an ordered list of block dicts."""
    lines = [ln.strip() for ln in text.split("\n")
             if ln and not ln.startswith("#")]
    module_defs: List[Dict[str, str]] = []
    for line in lines:
        if line.startswith("["):
            module_defs.append({"type": line[1:-1].rstrip()})
            if module_defs[-1]["type"] == "convolutional":
                module_defs[-1]["batch_normalize"] = "0"
        else:
            key, value = line.split("=", 1)
            module_defs[-1][key.rstrip()] = value.strip()
    return module_defs


def parse_model_config(path: str) -> List[Dict[str, str]]:
    """:func:`parse_model_text` of the file at ``path``."""
    with open(path, "r") as f:
        return parse_model_text(f.read())


def read_anchors_csv(csv_path: str) -> List[Tuple[float, float]]:
    """Anchors from row 1 of a training CSV: ``"w,h|w,h|..."`` in the first
    cell, as the k-means generator writes it."""
    with open(csv_path) as f:
        row = next(csv.reader(f))
    cell = str(row)[2:-2].split("'")[0]
    pairs = [tuple(float(v) for v in chunk.split(",")) for chunk in cell.split("|")]
    if any(len(p) != 2 for p in pairs):
        raise ValueError(f"Malformed anchor row in {csv_path!r}: {row!r}")
    return [(p[0], p[1]) for p in pairs]


@dataclasses.dataclass(frozen=True)
class ConvBlock:
    filters: int          # output channels (resolved, incl. preyolo width)
    size: int
    stride: int
    batch_normalize: bool
    activation: str       # 'leaky' | 'ReLU' | 'linear'
    is_preyolo: bool = False


@dataclasses.dataclass(frozen=True)
class MaxPoolBlock:
    size: int
    stride: int


@dataclasses.dataclass(frozen=True)
class UpsampleBlock:
    stride: int


@dataclasses.dataclass(frozen=True)
class RouteBlock:
    layers: Tuple[int, ...]  # raw cfg indices: absolute if ≥ 0, else relative


@dataclasses.dataclass(frozen=True)
class ShortcutBlock:
    from_layer: int  # relative (negative) index, as in the cfg


@dataclasses.dataclass(frozen=True)
class YoloBlock:
    anchors: Tuple[Tuple[float, float], ...]  # (w, h) for this head's mask
    mask: Tuple[int, ...]


Block = object  # union of the above


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """The ``[net]`` block, which the reference doubles as experiment
    config."""

    width: int
    height: int
    onnx_height: int
    num_classes: int
    channels: int
    yolo_masks: Tuple[Tuple[int, ...], ...]
    yolo_scales: Tuple[int, ...]
    validate_uri: str
    train_uri: str
    weights_uri: str
    start_weights_dim: Tuple[int, ...]
    num_train_images: int
    num_validate_images: int
    leaky_slope: float
    conv_activation: str
    build_targets_ignore_thresh: float
    conf_thresh: float
    nms_thresh: float
    iou_thresh: float

    def onnx_name(self, config_path: str) -> str:
        """The exported model's file name: ``<cfg stem>_<width><onnx_height>.onnx``."""
        stem = os.path.basename(config_path).split(".")[0]
        return f"{stem}_{self.width}{self.onnx_height}.onnx"


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """Full description of a Darknet graph. ``blocks`` excludes the
    ``[net]`` block; indices match the reference's ``module_list``."""

    net: NetConfig
    blocks: Tuple[Block, ...]
    anchors: Tuple[Tuple[float, float], ...]  # the full anchor list

    @property
    def out_channels(self) -> Tuple[int, ...]:
        """Output channel count after each block (input channels first)."""
        chans = [self.net.channels]
        for b in self.blocks:
            if isinstance(b, ConvBlock):
                c = b.filters
            elif isinstance(b, RouteBlock):
                # positive indices address block li's output, which lives at
                # chans[li + 1] because chans[0] is the network input
                c = sum(chans[li + 1] if li > 0 else chans[li] for li in b.layers)
            elif isinstance(b, ShortcutBlock):
                c = chans[b.from_layer]
            else:
                c = chans[-1]
            chans.append(c)
        return tuple(chans)


def spec_from_text(
    text: str,
    vanilla_anchor: bool = False,
    anchors_override: Optional[Sequence[Tuple[float, float]]] = None,
    source: str = "<text>",
) -> NetworkSpec:
    """Parse cfg text and its anchor channel into a :class:`NetworkSpec`."""
    module_defs = parse_model_text(text)
    hp = module_defs.pop(0)
    if hp["type"] != "net":
        raise ValueError(f"first block must be [net], got {hp['type']}")

    yolo_masks = tuple(
        tuple(int(y) for y in x.split(",")) for x in hp["yolo_masks"].split("|")
    )
    net = NetConfig(
        width=int(hp["width"]),
        height=int(hp["height"]),
        onnx_height=int(hp.get("onnx_height", hp["height"])),
        num_classes=int(hp["classes"]),
        channels=int(hp["channels"]),
        yolo_masks=yolo_masks,
        yolo_scales=tuple(int(s) for s in hp["yolo_scales"].split(",")),
        validate_uri=hp.get("validate_uri", ""),
        train_uri=hp.get("train_uri", ""),
        weights_uri=hp.get("weights_uri", ""),
        start_weights_dim=tuple(int(x) for x in hp["start_weights_dim"].split(","))
        if "start_weights_dim" in hp
        else (),
        num_train_images=int(hp.get("num_train_images", -1)),
        num_validate_images=int(hp.get("num_validate_images", -1)),
        leaky_slope=float(hp.get("leaky_slope", 0.1)),
        conv_activation=hp.get("conv_activation", "leaky"),
        build_targets_ignore_thresh=float(hp.get("build_targets_ignore_thresh", 0.5)),
        conf_thresh=float(hp.get("conf_thresh", 0.8)),
        nms_thresh=float(hp.get("nms_thresh", 0.25)),
        iou_thresh=float(hp.get("iou_thresh", 0.5)),
    )

    if anchors_override is not None:
        anchor_list = [tuple(a) for a in anchors_override]
    elif vanilla_anchor or not net.train_uri or not os.path.exists(net.train_uri):
        anchor_list = list(VANILLA_ANCHORS)
    else:
        try:
            anchor_list = read_anchors_csv(net.train_uri)
        except ValueError:
            import warnings

            warnings.warn(
                f"Row 1 of {net.train_uri!r} holds no anchors; falling back "
                "to the vanilla anchor list.")
            anchor_list = list(VANILLA_ANCHORS)

    blocks: List[Block] = []
    yolo_count = 0
    for md in module_defs:
        t = md["type"]
        if t == "convolutional":
            # pre-yolo convs are linear and carry no BN
            is_preyolo = md["filters"] == "preyolo"
            if is_preyolo:
                filters = (net.num_classes + 5) * len(yolo_masks[yolo_count])
            else:
                filters = int(md["filters"])
            blocks.append(ConvBlock(
                filters=filters,
                size=int(md["size"]),
                stride=int(md["stride"]),
                batch_normalize=not is_preyolo,
                activation="linear" if is_preyolo else net.conv_activation,
                is_preyolo=is_preyolo,
            ))
        elif t == "maxpool":
            blocks.append(MaxPoolBlock(size=int(md["size"]), stride=int(md["stride"])))
        elif t == "upsample":
            blocks.append(UpsampleBlock(stride=int(md["stride"])))
        elif t == "route":
            blocks.append(RouteBlock(layers=tuple(int(x) for x in md["layers"].split(","))))
        elif t == "shortcut":
            blocks.append(ShortcutBlock(from_layer=int(md["from"])))
        elif t == "yolo":
            mask = yolo_masks[yolo_count]
            blocks.append(YoloBlock(
                anchors=tuple(tuple(anchor_list[i]) for i in mask), mask=mask))
            yolo_count += 1
        else:
            raise ValueError(f"Unknown block type {t!r} in {source}")

    return NetworkSpec(net=net, blocks=tuple(blocks),
                       anchors=tuple(tuple(a) for a in anchor_list))


def load_network_spec(
    config_path: str,
    vanilla_anchor: bool = False,
    anchors_override: Optional[Sequence[Tuple[float, float]]] = None,
) -> NetworkSpec:
    """:func:`spec_from_text` of the ``.cfg`` file at ``config_path``."""
    with open(config_path, "r") as f:
        text = f.read()
    return spec_from_text(text, vanilla_anchor, anchors_override,
                          source=config_path)
