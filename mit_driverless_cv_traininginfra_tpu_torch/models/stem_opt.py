"""Serving-graph rewrites (counterpart of the JAX package's
``models/stem_opt.py``). Only the head slice is ported: the packed
space-to-depth stem is a TPU layout fix, to be measured on the card before
it is added."""

from __future__ import annotations

import dataclasses

import torch

from mit_driverless_cv_traininginfra_tpu.config.darknet_cfg import (
    ConvBlock,
    NetworkSpec,
)


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
