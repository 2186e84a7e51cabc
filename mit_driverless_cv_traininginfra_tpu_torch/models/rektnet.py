"""RektNet, the 7-keypoint cone regressor — inference on BN-folded weights
(counterpart of the JAX package's ``models/rektnet.py``).

Parameter trees mirror the JAX package's, with PyTorch's OIHW conv
weights: ``{"stem": {"w", "b", "bn": {"scale", "bias"}}, "res1": {"conv1",
"bn1", "conv2", "bn2", "shortcut_conv", "shortcut_bn"}, ..., "out"}`` and a
state tree of BN running ``{"mean", "var"}``. :func:`fold_bn` folds them;
:class:`RektNet` runs the folded net. Crops come in NHWC, as in the JAX
package, and are viewed as NCHW (channels_last) inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    fused_softargmax,
)

BN_EPS = 1e-5  # torch BatchNorm2d default, as in the JAX package


def conv2d(w, b, stride: int = 1, padding: int = 0,
           dilation: int = 1) -> nn.Conv2d:
    """An ``nn.Conv2d`` holding the given OIHW weight and bias, symmetric
    zero padding (the JAX package's NHWC/HWIO ``conv2d``)."""
    cout, cin, kh, kw = w.shape
    conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride, padding=padding,
                     dilation=dilation, bias=True, device=w.device,
                     dtype=w.dtype)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(b)
    conv.requires_grad_(False)
    return conv


def soft_argmax_2d(hm_logits):
    """Fused flat softmax + soft-argmax over (B, K, H, W) logits →
    (points (B, K, 2) xy in [0, 1) in the logits dtype, probs (B, K, H, W)).
    Runs kernel K2 (``fused_softargmax``)."""
    b, k, h, w = hm_logits.shape
    pts, probs = fused_softargmax(hm_logits.reshape(b * k, h, w))
    return (pts.reshape(b, k, 2).to(hm_logits.dtype),
            probs.reshape(b, k, h, w))


def fold_bn(params, state):
    """Fold BN into each conv: w' = w·γ/σ, b' = β + (b − μ)·γ/σ. Returns a
    tree with ``{"w", "b"}`` per conv, for :class:`RektNet`."""

    def fold(conv, bn_p, bn_s):
        inv = bn_p["scale"] / torch.sqrt(bn_s["var"] + BN_EPS)
        return {"w": conv["w"] * inv[:, None, None, None],
                "b": bn_p["bias"] + (conv["b"] - bn_s["mean"]) * inv}

    out = {
        "stem": fold(params["stem"], params["stem"]["bn"], state["stem"]),
        "out": {"w": params["out"]["w"], "b": params["out"]["b"]},
    }
    for i in range(1, 5):
        p, s = params[f"res{i}"], state[f"res{i}"]
        out[f"res{i}"] = {
            "conv1": fold(p["conv1"], p["bn1"], s["bn1"]),
            "conv2": fold(p["conv2"], p["bn2"], s["bn2"]),
            "shortcut_conv": fold(p["shortcut_conv"], p["shortcut_bn"],
                                  s["shortcut_bn"]),
        }
    return out


class _ResBlock(nn.Module):
    """Dilation-2 3×3 → ReLU → 3×3, plus a 1×1 shortcut, ReLU on the sum."""

    def __init__(self, p):
        super().__init__()
        self.conv1 = conv2d(p["conv1"]["w"], p["conv1"]["b"], padding=2,
                            dilation=2)
        self.conv2 = conv2d(p["conv2"]["w"], p["conv2"]["b"], padding=1)
        self.shortcut_conv = conv2d(p["shortcut_conv"]["w"],
                                    p["shortcut_conv"]["b"])

    def forward(self, x):
        b2 = self.conv2(F.relu(self.conv1(x)))
        return F.relu(self.shortcut_conv(x) + b2)


class RektNet(nn.Module):
    """Inference RektNet on a :func:`fold_bn` tree (the JAX package's
    ``apply_folded``). ``forward(x (N, H, W, C))`` → (probs (N, 7, H, W),
    points (N, 7, 2) xy in [0, 1) crop coordinates)."""

    def __init__(self, folded):
        super().__init__()
        self.stem = conv2d(folded["stem"]["w"], folded["stem"]["b"],
                           padding=3)
        self.res = nn.ModuleList(_ResBlock(folded[f"res{i}"])
                                 for i in range(1, 5))
        self.out = conv2d(folded["out"]["w"], folded["out"]["b"])

    def forward(self, x):
        h = F.relu(self.stem(x.permute(0, 3, 1, 2)))
        for blk in self.res:
            h = blk(h)
        points, probs = soft_argmax_2d(self.out(h))  # logits (N, K, H, W)
        return probs, points
