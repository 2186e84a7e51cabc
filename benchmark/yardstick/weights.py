"""Seeded weights, made on the device in a few large draws.

The trees are laid out as the program's constructors take them (OIHW conv
weights): YOLOv3 ``{"<block>": {"w", "bn": {"scale", "bias"}}}`` with a
state tree ``{"<block>": {"mean", "var"}}``, and ``{"w", "b"}`` for the
linear pre-yolo convs; RektNet ``{"stem": {"w", "b", "bn"}, "res1": {"conv1",
"bn1", "conv2", "bn2", "shortcut_conv", "shortcut_bn"}, ..., "out"}``.

The recipe keeps a deep random net usable as a serving workload: He-normal
conv weights with the leaky slope's gain, batch norm near identity, the BN
scale of each conv that feeds a shortcut damped by 0.3 (otherwise each of
YOLOv3's 23 residual adds doubles the variance), and the pre-yolo convs
drawn with std 0.01. A served net's running statistics are then set from
data (:func:`match_darknet_bn`, :func:`match_rektnet_bn`), as a trained
net's match the activations it sees: drawn at random, they leave the
folded net's deep activations tens of times too large, and its boxes
thousands of pixels wide with confidences stuck at 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import arch

RESIDUAL_GAIN = 0.3
HEAD_STD = 0.01


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any non-negative whole number."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def _split(flat, shapes):
    out, o = [], 0
    for s in shapes:
        n = 1
        for d in s:
            n *= d
        out.append(flat[o:o + n].view(s))
        o += n
    return out


def _bn_draws(gen, n: int, device):
    """(scale, bias, mean, var) for ``n`` channels in all: four draws."""
    u = torch.rand((2, n), generator=gen, device=device)
    g = torch.randn((2, n), generator=gen, device=device) * 0.1
    return 0.9 + 0.2 * u[0], g[0], g[1], 0.9 + 0.2 * u[1]


def darknet_trees(det: dict, gen: torch.Generator, device):
    """``(params, state)`` of the configuration's YOLOv3, f32 on ``device``."""
    convs = arch.conv_shapes(det)
    gain = 2.0 / (1.0 + det["leaky_slope"] ** 2)
    shapes = [(c["cout"], c["cin"], c["size"], c["size"]) for c in convs]
    flat = torch.randn((sum(a * b * c * d for a, b, c, d in shapes),),
                       generator=gen, device=device)
    ws = _split(flat, shapes)
    n_bn = sum(c["cout"] for c in convs)
    scale, bias, mean, var = _bn_draws(gen, n_bn, device)
    params, state, o = {}, {}, 0
    for c, w in zip(convs, ws):
        k, n = str(c["block"]), c["cout"]
        std = HEAD_STD if c["preyolo"] else (gain / (c["size"] ** 2 * c["cin"])) ** 0.5
        w = w * std
        sl = slice(o, o + n)
        o += n
        if c["bn"]:
            sc = scale[sl] * (RESIDUAL_GAIN if c["feeds_shortcut"] else 1.0)
            params[k] = {"w": w, "bn": {"scale": sc.clone(), "bias": bias[sl].clone()}}
            state[k] = {"mean": mean[sl].clone(), "var": var[sl].clone()}
        else:
            params[k] = {"w": w, "b": bias[sl].clone()}
    return params, state


def rektnet_trees(kp: dict, gen: torch.Generator, device):
    """``(params, state)`` of the configuration's RektNet, f32 on ``device``:
    fan-out He-normal conv weights, conv biases N(0, 0.05), BN near
    identity."""
    convs = arch.rektnet_convs(kp)
    shapes = [(c["cout"], c["cin"], c["size"], c["size"]) for c in convs]
    flat = torch.randn((sum(a * b * c * d for a, b, c, d in shapes),),
                       generator=gen, device=device)
    ws = _split(flat, shapes)
    n_b = sum(c["cout"] for c in convs)
    biases = torch.randn((n_b,), generator=gen, device=device) * 0.05
    n_bn = sum(c["cout"] for c in convs if c["name"] != "out")
    scale, bias, mean, var = _bn_draws(gen, n_bn, device)
    conv, o, ob = {}, 0, 0
    bn_p, bn_s = {}, {}
    for c, w in zip(convs, ws):
        n = c["cout"]
        std = (2.0 / (c["size"] ** 2 * n)) ** 0.5
        conv[c["name"]] = {"w": w * std, "b": biases[ob:ob + n].clone()}
        ob += n
        if c["name"] != "out":
            sl = slice(o, o + n)
            o += n
            bn_p[c["name"]] = {"scale": scale[sl].clone(), "bias": bias[sl].clone()}
            bn_s[c["name"]] = {"mean": mean[sl].clone(), "var": var[sl].clone()}
    params = {"stem": {**conv["stem"], "bn": bn_p["stem"]}, "out": conv["out"]}
    state = {"stem": bn_s["stem"]}
    names = {"conv1": "bn1", "conv2": "bn2", "shortcut_conv": "shortcut_bn"}
    for i in range(1, 5):
        p, s = {}, {}
        for cname, bname in names.items():
            key = f"res{i}.{cname}"
            p[cname] = conv[key]
            p[bname] = bn_p[key]
            s[bname] = bn_s[key]
        params[f"res{i}"], state[f"res{i}"] = p, s
    return params, state


def _bn_from_batch(y, bn, st):
    """Set ``st`` to the batch statistics of NCHW ``y``; normalise ``y``."""
    mean = y.mean(dim=(0, 2, 3))
    var = y.var(dim=(0, 2, 3), unbiased=False)
    st["mean"].copy_(mean)
    st["var"].copy_(var)
    inv = bn["scale"] / torch.sqrt(var + 1e-5)
    return (y - mean[None, :, None, None]) * inv[None, :, None, None] + bn["bias"][None, :, None, None]


@torch.no_grad()
def match_darknet_bn(det: dict, params, state, frames) -> None:
    """Each batch norm's running statistics, in block order, set to those
    of its conv's output on ``frames`` (B, H, W, 3) f32 in [0, 1], with the
    blocks before it already matched."""
    x = frames.permute(0, 3, 1, 2).float()
    outs = []
    for i, b in enumerate(arch.yolov3_blocks(det)):
        if b.kind == "conv":
            p = params[str(i)]
            y = F.conv2d(x, p["w"], None, b.stride, (b.size - 1) // 2)
            y = _bn_from_batch(y, p["bn"], state[str(i)]) if b.bn else y + p["b"][None, :, None, None]
            x = F.leaky_relu(y, det["leaky_slope"]) if b.leaky else y
        elif b.kind == "shortcut":
            x = outs[-1] + outs[b.src[0]]
        elif b.kind == "route":
            x = torch.cat([outs[j] for j in b.src], dim=1)
        elif b.kind == "upsample":
            x = F.interpolate(x, scale_factor=b.stride, mode="nearest")
        outs.append(x)


@torch.no_grad()
def match_rektnet_bn(params, state, crops) -> None:
    """The same for RektNet on ``crops`` (n, S, S, 3) f32."""
    def conv_bn(x, conv, bn, st, pad=0, dil=1):
        y = F.conv2d(x, conv["w"], conv["b"], 1, pad, dil)
        return _bn_from_batch(y, bn, st)

    h = crops.permute(0, 3, 1, 2).float()
    h = F.relu(conv_bn(h, params["stem"], params["stem"]["bn"], state["stem"], 3))
    for i in range(1, 5):
        p, s = params[f"res{i}"], state[f"res{i}"]
        a = F.relu(conv_bn(h, p["conv1"], p["bn1"], s["bn1"], 2, 2))
        b2 = conv_bn(a, p["conv2"], p["bn2"], s["bn2"], 1)
        h = F.relu(conv_bn(h, p["shortcut_conv"], p["shortcut_bn"], s["shortcut_bn"]) + b2)
