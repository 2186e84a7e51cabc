"""RektNet, the 7-keypoint cone regressor (counterpart of the JAX
package's ``models/rektnet.py``): training with live batch norm, and
inference on BN-folded weights.

Parameter trees mirror the JAX package's, with PyTorch's OIHW conv
weights: ``{"stem": {"w", "b", "bn": {"scale", "bias"}}, "res1": {"conv1",
"bn1", "conv2", "bn2", "shortcut_conv", "shortcut_bn"}, ..., "out"}`` and a
state tree of BN running ``{"mean", "var"}``. :func:`init` makes them;
:class:`KeypointNet` trains them (its ``state_dict`` is the reference's
``KeypointNet`` layout); :func:`fold_bn` folds them and :class:`RektNet`
runs the folded net. Crops come in NHWC, as in the JAX package, and are
viewed as NCHW (channels_last) inside.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    fused_softargmax,
)
from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import batch_mean_var

BN_EPS = 1e-5       # torch BatchNorm2d default, as in the JAX package
BN_MOMENTUM = 0.1   # running = (1 − m)·running + m·batch
NET_SIZE = 16


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


def soft_argmax_2d(hm_logits, points_dtype=None):
    """Fused flat softmax + soft-argmax over (B, K, H, W) logits →
    (points (B, K, 2) xy in [0, 1) in ``points_dtype``, by default the
    logits dtype, probs (B, K, H, W)). Runs kernel K2
    (``fused_softargmax``), whose points are f32."""
    b, k, h, w = hm_logits.shape
    pts, probs = fused_softargmax(hm_logits.reshape(b * k, h, w))
    return (pts.reshape(b, k, 2).to(points_dtype or hm_logits.dtype),
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


# ---------------------------------------------------------------------------
# training: parameters, batch norm, the module
# ---------------------------------------------------------------------------


def _res_block_channels(net_size: int = NET_SIZE) -> Tuple[Tuple[int, int], ...]:
    return ((net_size, net_size), (net_size, net_size * 2),
            (net_size * 2, net_size * 4), (net_size * 4, net_size * 8))


def _kaiming_conv(gen: torch.Generator, ksize: int, cin: int, cout: int):
    """Kaiming-normal fan_out/relu init (the reference's
    ``kaiming_normal_(mode='fan_out', nonlinearity='relu')``): std =
    sqrt(2 / (k·k·cout)); OIHW."""
    std = (2.0 / (ksize * ksize * cout)) ** 0.5
    return torch.randn((cout, cin, ksize, ksize), generator=gen) * std


def init(gen: torch.Generator, num_kpt: int = 7, in_channels: int = 3,
         net_size: int = NET_SIZE):
    """``(params, state)`` trees, f32 on the CPU: Kaiming fan-out conv
    weights drawn from ``gen``, zero conv biases, BN scale 1 / bias 0,
    running mean 0 / var 1 (the JAX package's ``init``; ``torch.Generator``
    draws other numbers than ``jax.random``)."""

    def bn_params(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c)}

    def bn_state(c):
        return {"mean": torch.zeros(c), "var": torch.ones(c)}

    params = {
        "stem": {"w": _kaiming_conv(gen, 7, in_channels, net_size),
                 "b": torch.zeros(net_size), "bn": bn_params(net_size)},
        "out": {"w": _kaiming_conv(gen, 1, net_size * 8, num_kpt),
                "b": torch.zeros(num_kpt)},
    }
    state = {"stem": bn_state(net_size)}
    for i, (cin, cout) in enumerate(_res_block_channels(net_size), start=1):
        params[f"res{i}"] = {
            "conv1": {"w": _kaiming_conv(gen, 3, cin, cout), "b": torch.zeros(cout)},
            "bn1": bn_params(cout),
            "conv2": {"w": _kaiming_conv(gen, 3, cout, cout), "b": torch.zeros(cout)},
            "bn2": bn_params(cout),
            "shortcut_conv": {"w": _kaiming_conv(gen, 1, cin, cout),
                              "b": torch.zeros(cout)},
            "shortcut_bn": bn_params(cout),
        }
        state[f"res{i}"] = {k: bn_state(cout) for k in ("bn1", "bn2", "shortcut_bn")}
    return params, state


def batch_norm(x, bn: Dict[str, torch.Tensor], train: bool = False, mesh=None):
    """Batch norm over NCHW ``x`` with torch semantics, written as the JAX
    package writes it. Returns ``(y, batch_stats)``: in training the
    statistics are taken in f32 over (N, H, W), ``y`` is normalised with
    the biased variance, and ``batch_stats = (mean, unbiased var)`` feeds
    :func:`update_running`; in eval ``bn["mean"]``, ``bn["var"]`` are used
    and ``batch_stats`` is None. ``scale = rsqrt(var + eps)·γ`` in f32,
    then cast to ``x.dtype`` like β and the mean. (f64 ``x``, a reference
    evaluation, keeps f64 throughout.)

    Under a process ``mesh`` (``parallel.mesh``) the statistics are the
    global batch's, as the JAX step takes them over its sharded batch: the
    same two passes over every rank's rows (``batch_mean_var``), the
    unbiased ``n`` the global count; the backward sums over the ranks, and
    every rank's running stats see the same values."""
    sdt = torch.promote_types(x.dtype, torch.float32)
    if train:
        xf = x.to(sdt)
        if mesh is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
            n = x.shape[0] * x.shape[2] * x.shape[3]
        else:
            mean, var, n = batch_mean_var(xf, (0, 2, 3), mesh)
        stats = (mean, var * n / max(n - 1, 1))
    else:
        mean, var = bn["mean"], bn["var"]
        stats = None
    scale = (torch.rsqrt(var.to(sdt) + BN_EPS) * bn["scale"].to(sdt)).to(x.dtype)
    bias = bn["bias"].to(x.dtype)

    def c(v):
        return v[None, :, None, None]

    return (x - c(mean.to(x.dtype))) * c(scale) + c(bias), stats


@torch.no_grad()
def update_running(bn_state: Dict[str, torch.Tensor], batch_stats,
                   momentum: float = BN_MOMENTUM) -> None:
    """``running = (1 − m)·running + m·batch`` for mean and var, in place
    on the running-stat buffers (the JAX package returns new arrays)."""
    mean, var = batch_stats
    bn_state["mean"].copy_((1 - momentum) * bn_state["mean"] + momentum * mean)
    bn_state["var"].copy_((1 - momentum) * bn_state["var"] + momentum * var)


class _Conv(nn.Module):
    """A conv's ``weight`` (OIHW) and ``bias`` parameters."""

    def __init__(self, p):
        super().__init__()
        self.weight = nn.Parameter(p["w"].detach().clone().float())
        self.bias = nn.Parameter(p["b"].detach().clone().float())

    def forward(self, x, dtype, padding: int = 0, dilation: int = 1):
        """The JAX package's ``conv2d``: the conv, then ``+ b``, each
        rounded to ``dtype`` (parameters cast from the f32 masters)."""
        y = F.conv2d(x, self.weight.to(dtype), None, 1, padding, dilation)
        return y + self.bias.to(dtype)[None, :, None, None]


class _BN(nn.Module):
    """A batch norm's ``weight``/``bias`` parameters and running-stat
    buffers, named as ``nn.BatchNorm2d``'s (``num_batches_tracked`` is
    kept at 0, as the JAX package writes it); normalised by
    :func:`batch_norm`."""

    def __init__(self, p, s):
        super().__init__()
        self.weight = nn.Parameter(p["scale"].detach().clone().float())
        self.bias = nn.Parameter(p["bias"].detach().clone().float())
        self.register_buffer("running_mean", s["mean"].detach().clone().float())
        self.register_buffer("running_var", s["var"].detach().clone().float())
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))

    def forward(self, x, dtype, train: bool, mesh=None):
        bn = {"scale": self.weight.to(dtype), "bias": self.bias.to(dtype),
              "mean": self.running_mean, "var": self.running_var}
        y, stats = batch_norm(x, bn, train, mesh)
        if train:
            update_running({"mean": self.running_mean, "var": self.running_var},
                           stats)
        return y


class _TrainResBlock(nn.Module):
    def __init__(self, p, s):
        super().__init__()
        self.conv1 = _Conv(p["conv1"])
        self.bn1 = _BN(p["bn1"], s["bn1"])
        self.conv2 = _Conv(p["conv2"])
        self.bn2 = _BN(p["bn2"], s["bn2"])
        self.shortcut_conv = _Conv(p["shortcut_conv"])
        self.shortcut_bn = _BN(p["shortcut_bn"], s["shortcut_bn"])

    def forward(self, x, dtype, train: bool, mesh=None):
        """The JAX package's ``_res_block``: dilation-2 3×3 → BN → ReLU →
        3×3 → BN, plus a 1×1-conv/BN shortcut, ReLU on the sum."""
        a1 = F.relu(self.bn1(self.conv1(x, dtype, padding=2, dilation=2), dtype,
                             train, mesh))
        b2 = self.bn2(self.conv2(a1, dtype, padding=1), dtype, train, mesh)
        sc = self.shortcut_bn(self.shortcut_conv(x, dtype), dtype, train, mesh)
        return F.relu(sc + b2)


class KeypointNet(nn.Module):
    """Trainable RektNet (the JAX package's ``apply``) from ``(params,
    state)`` trees: f32 parameters, registered in the reference
    ``KeypointNet``'s order (``conv``, ``bn``, ``res1``…``res4`` each
    ``conv1``, ``bn1``, ``conv2``, ``bn2``, ``shortcut_conv``,
    ``shortcut_bn``, then ``out``), so ``parameters()`` and
    ``state_dict()`` follow the reference; BN running stats as buffers."""

    def __init__(self, params, state):
        super().__init__()
        self.conv = _Conv(params["stem"])
        self.bn = _BN(params["stem"]["bn"], state["stem"])
        self.res1, self.res2, self.res3, self.res4 = (
            _TrainResBlock(params[f"res{i}"], state[f"res{i}"]) for i in range(1, 5))
        self.out = _Conv(params["out"])

    def logits(self, x, train: bool = False, dtype=torch.float32, mesh=None):
        """x (B, H, W, C) NHWC crops in [0, 1] → the raw heatmap logits (B,
        K, H, W) in ``dtype`` (the exported ``onnx_mode`` graph's output).
        The parameters are cast to ``dtype`` for the compute (f32 masters);
        ``train`` normalises with batch statistics (the global batch's
        under a process ``mesh``) and updates the running stats in place."""
        h = x.to(dtype).permute(0, 3, 1, 2)
        h = F.relu(self.bn(self.conv(h, dtype, padding=3), dtype, train, mesh))
        for blk in (self.res1, self.res2, self.res3, self.res4):
            h = blk(h, dtype, train, mesh)
        return self.out(h, dtype)

    def forward(self, x, train: bool = False, dtype=torch.float32,
                points_dtype=None, mesh=None):
        """:meth:`logits`, then the flat softmax and soft-argmax: (heatmap
        probs (B, K, H, W) in ``dtype``, points (B, K, 2) in
        ``points_dtype``, by default ``dtype``)."""
        points, probs = soft_argmax_2d(self.logits(x, train, dtype, mesh), points_dtype)
        return probs, points

    def trees(self):
        """The ``(params, state)`` trees of the current values (detached
        copies)."""
        def conv(m):
            return {"w": m.weight.detach().clone(), "b": m.bias.detach().clone()}

        def bn_p(m):
            return {"scale": m.weight.detach().clone(), "bias": m.bias.detach().clone()}

        def bn_s(m):
            return {"mean": m.running_mean.clone(), "var": m.running_var.clone()}

        params = {"stem": {**conv(self.conv), "bn": bn_p(self.bn)},
                  "out": conv(self.out)}
        state = {"stem": bn_s(self.bn)}
        for i in range(1, 5):
            blk = getattr(self, f"res{i}")
            params[f"res{i}"] = {
                "conv1": conv(blk.conv1), "bn1": bn_p(blk.bn1),
                "conv2": conv(blk.conv2), "bn2": bn_p(blk.bn2),
                "shortcut_conv": conv(blk.shortcut_conv),
                "shortcut_bn": bn_p(blk.shortcut_bn)}
            state[f"res{i}"] = {k: bn_s(getattr(blk, k))
                                for k in ("bn1", "bn2", "shortcut_bn")}
        return params, state


# ---------------------------------------------------------------------------
# reference checkpoints (KeypointNet state_dict ↔ trees)
# ---------------------------------------------------------------------------


def params_from_torch_state_dict(sd):
    """A reference ``KeypointNet`` state_dict (the ``model`` slot of its
    ``.pt`` checkpoints) → ``(params, state)`` trees of f32 tensors. Conv
    weights stay OIHW."""

    def arr(k):
        return torch.as_tensor(sd[k]).detach().float().clone()

    def conv(prefix):
        return {"w": arr(f"{prefix}.weight"), "b": arr(f"{prefix}.bias")}

    def bn_p(prefix):
        return {"scale": arr(f"{prefix}.weight"), "bias": arr(f"{prefix}.bias")}

    def bn_s(prefix):
        return {"mean": arr(f"{prefix}.running_mean"),
                "var": arr(f"{prefix}.running_var")}

    params = {"stem": {**conv("conv"), "bn": bn_p("bn")}, "out": conv("out")}
    state = {"stem": bn_s("bn")}
    for i in range(1, 5):
        params[f"res{i}"] = {
            "conv1": conv(f"res{i}.conv1"), "bn1": bn_p(f"res{i}.bn1"),
            "conv2": conv(f"res{i}.conv2"), "bn2": bn_p(f"res{i}.bn2"),
            "shortcut_conv": conv(f"res{i}.shortcut_conv"),
            "shortcut_bn": bn_p(f"res{i}.shortcut_bn"),
        }
        state[f"res{i}"] = {k: bn_s(f"res{i}.{k}")
                            for k in ("bn1", "bn2", "shortcut_bn")}
    return params, state


def load_torch_checkpoint(path: str):
    """A reference ``.pt`` checkpoint (``{epoch, model, optimizer}`` or a
    bare state_dict) → ``(params, state)`` trees on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    return params_from_torch_state_dict(sd)
