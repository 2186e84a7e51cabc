"""Serving-graph rewrites (counterpart of the JAX package's
``models/stem_opt.py``): the 1-class head slice, and the packed
space-to-depth stem.

The packed stem runs YOLOv3's blocks 0-1 (3×3 s1 C→C1, then 3×3 s2
C1→C2) on the 2×2 space-to-depth packing of the frames: conv1 becomes a
3×3 conv of 4·C input and 4·C1 output channels over the half-resolution
grid, and conv2 a 2×2-tap stride-1 conv over the packed conv1 output,
whose output grid is conv2's own. Each original weight fills one packed
slot of each output phase it feeds (four for conv1, one for conv2), so
the rewrite sums the same products. It is the serving path
of the bf16/f32 detector (``Darknet(packed_stem=)``), of the int8 detector
without the fused entry (``Int8Darknet(stem_q=)``), and a training path
(``TrainDarknet.forward_features(packed_stem=True)``, the packed weights
rebuilt from the canonical ones by :func:`pack_stem_weights` every
forward). The int8 fused entry (``ops/entry.py:quantize_entry``) takes its
conv2p taps from :func:`build_packed_stem` too.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    ConvBlock,
    NetworkSpec,
)


def stem_is_packable(spec: NetworkSpec) -> bool:
    """Blocks 0-1 are a 3×3 s1 conv then a 3×3 s2 conv, on an even-sized
    input (the YOLOv3 stem)."""
    b = spec.blocks
    return (len(b) >= 2
            and isinstance(b[0], ConvBlock) and b[0].size == 3 and b[0].stride == 1
            and isinstance(b[1], ConvBlock) and b[1].size == 3 and b[1].stride == 2
            and spec.net.width % 2 == 0 and spec.net.height % 2 == 0)


def pack_input(x):
    """NHWC (B, H, W, C) → (B, H/2, W/2, 4C), packed channel (p, q, c) at
    ``(p·2 + q)·C + c`` for the pixel at (2i + p, 2j + q)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


@functools.cache
def _pack_index(C: int, C1: int, C2: int, device: torch.device):
    """Where each slot of the packed weights takes its value from: flat
    indices into ``w1`` (C1, C, 3, 3) for ``w1p`` (4·C1, 4·C, 3, 3) and
    into ``w2`` (C2, C1, 3, 3) for ``w2p`` (C2, 4·C1, 2, 2), the index
    one past the end for a slot that stays zero. Source offset s ∈ {−1,
    0, 1, 2} lands at packed tap D = s >> 1 with parity s − 2D."""
    n1, n2 = C1 * C * 9, C2 * C1 * 9
    src1 = np.arange(n1).reshape(C1, C, 3, 3)
    idx1 = np.full((4 * C1, 4 * C, 3, 3), n1)
    for a in range(2):
        for bb in range(2):
            for dy in range(3):
                for dx in range(3):
                    sy, sx = a + dy - 1, bb + dx - 1
                    Dy, Dx = sy >> 1, sx >> 1
                    o, i = (a * 2 + bb) * C1, ((sy - 2 * Dy) * 2 + (sx - 2 * Dx)) * C
                    idx1[o:o + C1, i:i + C, Dy + 1, Dx + 1] = src1[:, :, dy, dx]
    src2 = np.arange(n2).reshape(C2, C1, 3, 3)
    idx2 = np.full((C2, 4 * C1, 2, 2), n2)
    for dy in range(3):
        for dx in range(3):
            sy, sx = dy - 1, dx - 1
            Dy, Dx = sy >> 1, sx >> 1
            i = ((sy - 2 * Dy) * 2 + (sx - 2 * Dx)) * C1
            # each (tap, parity) pair has one source tap: a copy, no sum
            idx2[:, i:i + C1, Dy + 1, Dx + 1] = src2[:, :, dy, dx]
    return (torch.from_numpy(idx1).to(device), torch.from_numpy(idx2).to(device))


def _gather(w, idx):
    return torch.cat([w.reshape(-1), w.new_zeros(1)])[idx]


def pack_stem_weights(w1, w2):
    """OIHW ``w1`` (C1, C, 3, 3) and ``w2`` (C2, C1, 3, 3) → ``(w1p (4·C1,
    4·C, 3, 3), w2p (C2, 4·C1, 2, 2))``, the differentiable twin of the
    JAX package's ``pack_stem_weights_jnp``: one gather each, a fixed map
    that copies each ``w1`` weight into one slot of each of the four
    output phases and each ``w2`` weight into one slot. Autograd returns
    each ``w2`` weight its slot's gradient exactly, and each ``w1`` weight
    the sum of its four slots' gradients."""
    C1, C = w1.shape[:2]
    idx1, idx2 = _pack_index(C, C1, w2.shape[0], w1.device)
    return _gather(w1, idx1), _gather(w2, idx2)


def build_packed_stem(folded_params):
    """The JAX package's ``build_packed_stem`` on OIHW folded weights:
    blocks "0" (3×3 s1, C→C1) and "1" (3×3 s2, C1→C2) → ``{"w1" (4·C1,
    4·C, 3, 3), "b1", "w2" (C2, 4·C1, 2, 2), "b2"}`` (the copies are
    exact)."""
    w1p, w2p = pack_stem_weights(folded_params["0"]["w"], folded_params["1"]["w"])
    return {"w1": w1p, "b1": folded_params["0"]["b"].repeat(4),
            "w2": w2p, "b2": folded_params["1"]["b"].clone()}


def pad_packed(h):
    """NCHW ``h`` zero-padded by one row above and one column to the left:
    the packed conv2's padding (1, 0) on each axis. The pad runs on the
    NHWC view, so a channels-last tensor stays channels-last."""
    return F.pad(h.permute(0, 2, 3, 1), (0, 0, 1, 0, 1, 0)).permute(0, 3, 1, 2)


def apply_packed_stem(packed, x, leaky_slope: float):
    """x (B, H, W, C) NHWC → block 1's output (B, H/2, W/2, C2), equal to
    ``leaky(conv2(leaky(conv1(x))))`` up to summation order. ``packed``:
    :func:`build_packed_stem`'s tree, in the frames' dtype."""
    from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import _leaky

    h = F.conv2d(pack_input(x).permute(0, 3, 1, 2), packed["w1"], packed["b1"],
                 padding=1)
    out = F.conv2d(pad_packed(_leaky(h, leaky_slope)), packed["w2"], packed["b2"])
    return _leaky(out, leaky_slope).permute(0, 2, 3, 1)


def slice_preyolo(spec: NetworkSpec, folded_params):
    """Drop the class output channels of every pre-yolo conv: each
    anchor's 5+C channel block keeps its first 5 (the cone pipeline is
    single-class and never reads the class columns). Returns
    ``(spec', folded')`` with ``spec'.net.num_classes == 0``; decode with
    ``with_classes=False``. Weights are OIHW, so output channels are dim 0."""
    nattr = 5 + spec.net.num_classes
    new_params = dict(folded_params)
    new_blocks = []
    yolo_i = 0
    for i, b in enumerate(spec.blocks):
        if isinstance(b, ConvBlock) and b.is_preyolo:
            na = len(spec.net.yolo_masks[yolo_i])
            yolo_i += 1
            p = folded_params[str(i)]
            keep = torch.cat([torch.arange(a * nattr, a * nattr + 5)
                              for a in range(na)]).to(p["w"].device)
            new_params[str(i)] = {"w": p["w"][keep], "b": p["b"][keep]}
            new_blocks.append(dataclasses.replace(b, filters=5 * na))
        else:
            new_blocks.append(b)
    new_net = dataclasses.replace(spec.net, num_classes=0)
    return (dataclasses.replace(spec, net=new_net, blocks=tuple(new_blocks)),
            new_params)
