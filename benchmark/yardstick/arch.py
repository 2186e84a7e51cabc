"""The benchmark's own description of the two networks, read from a
configuration file, and the frozen operation and byte counts.

YOLOv3 (arXiv 1804.02767, darknet's ``yolov3.cfg``) is laid out block by
block in the cfg's order: a 3x3 stem conv, five Darknet-53 stages (a 3x3
stride-2 conv, then residual pairs of a 1x1 and a 3x3 conv with a shortcut),
and the three FPN heads (1x1/3x3 necks, a linear 1x1 pre-yolo conv, a yolo
block; a route and a 1x1 conv and an upsample and a route between heads).
Block indices are the cfg's, so a weight tree keyed by block index fits
any program that numbers blocks as darknet does.

RektNet (arXiv 2007.13971, ``RektNet/keypoint_net.py``): a 7x7 stem, four
residual blocks (a dilation-2 3x3, a 3x3, a 1x1 shortcut) at full crop
resolution, a 1x1 head to the keypoint heatmaps.

Nothing here imports the program: these counts are the yardstick.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}


@dataclass(frozen=True)
class Block:
    kind: str                 # conv | shortcut | route | upsample | yolo
    filters: int = 0          # conv: out channels
    size: int = 0             # conv: kernel size
    stride: int = 1           # conv / upsample stride
    bn: bool = True           # conv: batch norm (else a bias)
    leaky: bool = True        # conv: leaky activation (else linear)
    src: Tuple[int, ...] = ()  # shortcut: (from,), route: layers (absolute)
    head: int = -1            # yolo: head index


def yolov3_blocks(det: dict) -> List[Block]:
    """The block list of ``det`` (a configuration's ``detector`` entry)."""
    blocks: List[Block] = []

    def add(b: Block) -> int:
        blocks.append(b)
        return len(blocks) - 1

    def conv(filters, size, stride=1, bn=True, leaky=True):
        return add(Block("conv", filters, size, stride, bn, leaky))

    conv(det["stem_filters"], 3)
    stage_out = {}
    for filters, n_res in det["stages"]:
        conv(filters, 3, 2)
        for _ in range(n_res):
            conv(filters // 2, 1)
            conv(filters, 3)
            i = len(blocks)
            stage_out[filters] = add(Block("shortcut", src=(i - 3,)))
    nattr = 5 + det["classes"]
    n_heads = len(det["masks"])
    skips = [stage_out[f] for f, _ in det["stages"]][::-1][1:]
    for h, neck in enumerate(det["necks"]):
        for _ in range(2):
            conv(neck, 1)
            conv(neck * 2, 3)
        route_pt = conv(neck, 1)
        conv(neck * 2, 3)
        conv(len(det["masks"][h]) * nattr, 1, bn=False, leaky=False)
        add(Block("yolo", head=h))
        if h + 1 < n_heads:
            add(Block("route", src=(route_pt,)))
            conv(neck // 2, 1)
            add(Block("upsample", stride=2))
            add(Block("route", src=(len(blocks) - 1, skips[h])))
    return blocks


def conv_shapes(det: dict) -> List[dict]:
    """Every conv of the detector in block order: ``{"block", "cin", "cout",
    "size", "stride", "bn", "leaky", "preyolo", "feeds_shortcut", "hw_in",
    "hw_out"}`` at the configuration's input size."""
    blocks = yolov3_blocks(det)
    chans, sizes = [], []
    c, s = det["channels"], det["input"]
    out = []
    shortcut_from = {i - 1 for i, b in enumerate(blocks) if b.kind == "shortcut"}
    for i, b in enumerate(blocks):
        if b.kind == "conv":
            p = (b.size - 1) // 2
            s_out = (s + 2 * p - b.size) // b.stride + 1
            out.append({"block": i, "cin": c, "cout": b.filters, "size": b.size,
                        "stride": b.stride, "bn": b.bn, "leaky": b.leaky,
                        "preyolo": not b.bn, "feeds_shortcut": i in shortcut_from,
                        "hw_in": s, "hw_out": s_out})
            c, s = b.filters, s_out
        elif b.kind == "upsample":
            s = s * b.stride
        elif b.kind == "route":
            c = sum(chans[j] for j in b.src)
            s = sizes[b.src[0]]
        chans.append(c)
        sizes.append(s)
    return out


def head_grids(det: dict) -> List[int]:
    """The grid side of each yolo head, in head order."""
    blocks = yolov3_blocks(det)
    grids, s = [], det["input"]
    sizes = []
    for b in blocks:
        if b.kind == "conv":
            s = (s + 2 * ((b.size - 1) // 2) - b.size) // b.stride + 1
        elif b.kind == "upsample":
            s *= b.stride
        elif b.kind == "route":
            s = sizes[b.src[0]]
        elif b.kind == "yolo":
            grids.append(s)
        sizes.append(s)
    return grids


def detector_flops(det: dict, served_attrs: Optional[int] = None) -> int:
    """Forward FLOPs (2 per multiply-add) of one frame. ``served_attrs``:
    the attributes an anchor keeps in the pre-yolo convs that are served
    (5 when the class columns are sliced off); the configuration's own
    ``5 + classes`` by default."""
    total = 0
    for cv in conv_shapes(det):
        cout = cv["cout"]
        if cv["preyolo"] and served_attrs is not None:
            cout = cout // (5 + det["classes"]) * served_attrs
        total += 2 * cv["hw_out"] ** 2 * cv["size"] ** 2 * cv["cin"] * cout
    return total


def rektnet_convs(kp: dict) -> List[dict]:
    """RektNet's convs: ``{"name", "cin", "cout", "size", "pad", "dil"}``
    in forward order; every one at the crop's full resolution."""
    n = kp["net_size"]
    convs = [{"name": "stem", "cin": 3, "cout": n, "size": 7, "pad": 3, "dil": 1}]
    cin = n
    for i, mult in enumerate((1, 2, 4, 8), start=1):
        cout = n * mult
        convs += [{"name": f"res{i}.conv1", "cin": cin, "cout": cout, "size": 3,
                   "pad": 2, "dil": 2},
                  {"name": f"res{i}.conv2", "cin": cout, "cout": cout, "size": 3,
                   "pad": 1, "dil": 1},
                  {"name": f"res{i}.shortcut_conv", "cin": cin, "cout": cout,
                   "size": 1, "pad": 0, "dil": 1}]
        cin = cout
    convs.append({"name": "out", "cin": cin, "cout": kp["num_kpt"], "size": 1,
                  "pad": 0, "dil": 1})
    return convs


def rektnet_flops(kp: dict) -> int:
    """Forward FLOPs of one crop."""
    hw = kp["crop"] ** 2
    return sum(2 * hw * c["size"] ** 2 * c["cin"] * c["cout"]
               for c in rektnet_convs(kp))


# -- kernels' bytes and operations at the served shapes ----------------------
# Each input byte is counted read once and each output byte written once;
# operations against the peak of their type. The bound is the larger time.

def _bound_s(n_bytes: float, ops: float, kind: str) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK[kind])


def roi_crop_bound_s(B: int, H: int, W: int, C: int, n_crops: int, crop: int,
                     elem: int = 2) -> float:
    """K1: the frames (B, H, W, C), n boxes (f32 xyxy) and frame indices
    (int64) read, n crops (crop, crop, C) written; 8 f32 operations an
    output element (two bilinear passes)."""
    out = n_crops * crop * crop * C
    n_bytes = B * H * W * C * elem + n_crops * (4 * 4 + 8) + out * elem
    return _bound_s(n_bytes, 8 * out, "f32")


def softargmax_bound_s(rows: int, hw: int, elem: int = 2) -> float:
    """K2: rows of hw logits read, as many probabilities written, two f32
    points a row written."""
    return _bound_s(rows * hw * 2 * elem + rows * 2 * 4, 0, "f32")


def nms_topk_bound_s(B: int, N: int, k: int) -> float:
    """K3: B·N boxes (4 f32) and scores (f32) read; k boxes, scores,
    indices (int32) and keep flags written per frame."""
    return _bound_s(B * N * 5 * 4 + B * k * (16 + 4 + 4 + 1), 0, "f32")


def entry_block_bound_s(B: int, side: int) -> float:
    """K4: hq (B, side, side, 128) int8 read, resq (B, side, side, 64) int8
    written (its weights are a few KB); the int8 operations of its 2x2
    128->64, 1x1 64->32 and 3x3 32->64 convolutions."""
    pos = B * side * side
    ops = 2 * pos * (4 * 128 * 64 + 64 * 32 + 9 * 32 * 64)
    return _bound_s(pos * (128 + 64), ops, "int8")


def total_anchors(det: dict) -> int:
    return sum(len(m) * g * g for m, g in zip(det["masks"], head_grids(det)))
