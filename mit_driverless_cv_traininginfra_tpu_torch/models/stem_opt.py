"""Serving-graph rewrites (counterpart of the JAX package's
``models/stem_opt.py``): the 1-class head slice, and the packed
space-to-depth stem's weights, which the int8 entry path
(``ops/entry.py:quantize_entry``) takes its conv2p taps from. The packed
stem as a serving path of its own is a TPU layout fix, to be measured on
the card before it is added."""

from __future__ import annotations

import dataclasses

import torch

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    ConvBlock,
    NetworkSpec,
)


def build_packed_stem(folded_params):
    """The JAX package's ``build_packed_stem`` on OIHW folded weights:
    blocks "0" (3×3 s1, C→C1) and "1" (3×3 s2, C1→C2) → ``{"w1" (4·C1,
    4·C, 3, 3), "b1", "w2" (C2, 4·C1, 2, 2), "b2"}``. Packed channel
    (p, q, c) is ``(p·2 + q)·C + c``; source offset s ∈ {−1, 0, 1, 2}
    lands at packed tap D = s >> 1 with parity s − 2D, so every original
    weight fills exactly one slot (the copies are exact)."""
    w1, b1 = folded_params["0"]["w"], folded_params["0"]["b"]
    w2, b2 = folded_params["1"]["w"], folded_params["1"]["b"]
    C1, C = w1.shape[0], w1.shape[1]
    C2 = w2.shape[0]
    w1p = w1.new_zeros((4 * C1, 4 * C, 3, 3))
    for a in range(2):
        for bb in range(2):
            for dy in range(3):
                for dx in range(3):
                    sy, sx = a + dy - 1, bb + dx - 1
                    Dy, Dx = sy >> 1, sx >> 1
                    p, q = sy - 2 * Dy, sx - 2 * Dx
                    o, i = (a * 2 + bb) * C1, (p * 2 + q) * C
                    w1p[o:o + C1, i:i + C, Dy + 1, Dx + 1] = w1[:, :, dy, dx]
    w2p = w2.new_zeros((C2, 4 * C1, 2, 2))
    for dy in range(3):
        for dx in range(3):
            sy, sx = dy - 1, dx - 1
            Dy, Dx = sy >> 1, sx >> 1
            i = ((sy - 2 * Dy) * 2 + (sx - 2 * Dx)) * C1
            w2p[:, i:i + C1, Dy + 1, Dx + 1] += w2[:, :, dy, dx]
    return {"w1": w1p, "b1": b1.repeat(4), "w2": w2p, "b2": b2.clone()}


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
