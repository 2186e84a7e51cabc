"""Weight carry-over between the JAX package's parameter trees and the
port's.

The JAX package keeps ``(params, state)`` as nested dicts with NHWC-side
HWIO conv weights under the key ``"w"``. :func:`from_jax` maps such a tree,
given as numpy arrays, to the same tree of torch tensors with OIHW conv
weights, and :func:`to_jax` maps a port tree back (a trained
``TrainDarknet``'s ``trees()``, say); BN folding then happens in the port's own ``fold_bn``
(``models.darknet.fold_bn``, ``models.rektnet.fold_bn``), so folding is
held against the JAX package too. :func:`quantized_from_jax` carries the
JAX package's int8 bundles across (``quantize_params``,
``quantize_rektnet_params``, ``quantize_entry``) with their dtypes, so
both packages can run on identical integers.

No trained weights ship with the repository, so :func:`init_darknet_np`
and :func:`init_rektnet_np` make seeded random JAX-layout trees in numpy;
the same arrays feed both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    ConvBlock,
    NetworkSpec,
    ShortcutBlock,
)


def from_jax(tree, device="cpu"):
    """Nested dict of numpy arrays (JAX layout) → nested dict of f32
    tensors on ``device``; 4-D arrays under ``"w"`` go HWIO → OIHW."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out[key] = from_jax(v, device)
            continue
        a = np.asarray(v, np.float32)
        if key == "w" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def to_jax(tree):
    """Nested dict of tensors (the port's layout) → nested dict of f32
    numpy arrays in the JAX package's layout: 4-D arrays under ``"w"`` go
    OIHW → HWIO."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out[key] = to_jax(v)
            continue
        a = v.detach().float().cpu().numpy()
        if key == "w" and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        out[key] = np.ascontiguousarray(a)
    return out


def quantized_from_jax(tree, device="cpu"):
    """Nested dict of numpy arrays from the JAX package's int8 bundles →
    the port's tensors on ``device``, dtypes kept (int8, f32, bf16 — a
    bf16 leaf comes as ml_dtypes' ``bfloat16`` and goes through f32,
    exactly); 4-D arrays are conv weights and go HWIO → OIHW. K4's
    ``w2`` (4, 128, 64), ``w1x1`` (64, 32) and ``w3im`` (288, 64) keep
    their layouts, which are the port's too."""
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out[key] = quantized_from_jax(v, device)
            continue
        a = np.asarray(v)
        bf16 = a.dtype.name == "bfloat16"
        if bf16:
            a = a.astype(np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        t = torch.from_numpy(a.copy())  # C order, 0-d stays 0-d
        out[key] = (t.to(torch.bfloat16) if bf16 else t).to(device)
    return out


def _bn_stats(rng, c):
    # scale and var near 1: E[scale²/var] stays ~1, so a deep stack of BN
    # convs neither grows nor shrinks its activations
    return ({"scale": rng.uniform(0.9, 1.1, c).astype(np.float32),
             "bias": rng.normal(0, 0.1, c).astype(np.float32)},
            {"mean": rng.normal(0, 0.1, c).astype(np.float32),
             "var": rng.uniform(0.9, 1.1, c).astype(np.float32)})


RESIDUAL_GAIN = 0.3   # BN scale factor of each conv that feeds a shortcut
HEAD_STD = 0.01       # weight std of the pre-yolo convs


def init_darknet_np(spec: NetworkSpec, rng: np.random.Generator):
    """Seeded Darknet ``(params, state)`` in the JAX package's layout.

    Kaiming-normal conv weights (as ``init_params``, with the gain of the
    leaky slope), BN affine and running statistics randomised around
    identity. Two more departures keep a deep random net usable as a
    serving workload: the BN scale of each conv that feeds a shortcut is
    multiplied by ``RESIDUAL_GAIN`` (otherwise every residual add doubles
    the variance, 2^23 over YOLOv3's 23 shortcuts, and every box decode
    overflows), and the pre-yolo convs draw with std ``HEAD_STD`` so
    confidences and box sizes spread instead of saturating."""
    feeds_shortcut = {i - 1 for i, b in enumerate(spec.blocks)
                      if isinstance(b, ShortcutBlock)}
    gain = 2.0 / (1.0 + spec.net.leaky_slope ** 2)
    chans = spec.out_channels
    params, state = {}, {}
    for i, b in enumerate(spec.blocks):
        if not isinstance(b, ConvBlock):
            continue
        cin = chans[i]
        std = HEAD_STD if b.is_preyolo else (gain / (b.size * b.size * cin)) ** 0.5
        w = (rng.standard_normal((b.size, b.size, cin, b.filters)) * std
             ).astype(np.float32)
        if b.batch_normalize:
            bn, st = _bn_stats(rng, b.filters)
            if i in feeds_shortcut:
                bn["scale"] = (bn["scale"] * RESIDUAL_GAIN).astype(np.float32)
            params[str(i)] = {"w": w, "bn": bn}
            state[str(i)] = st
        else:
            params[str(i)] = {"w": w, "b": rng.normal(0, 0.1, b.filters
                                                      ).astype(np.float32)}
    return params, state


def init_rektnet_np(rng: np.random.Generator, net_size: int = 16):
    """Seeded RektNet ``(params, state)`` in the JAX package's layout
    (``rektnet.init``: 3→7 keypoints, Kaiming-normal fan-out convs), with
    random conv biases and BN statistics around identity. ``net_size`` is
    the stem width (16 in the reference; narrower in tests)."""

    def conv(k, cin, cout):
        std = (2.0 / (k * k * cout)) ** 0.5
        return {"w": (rng.standard_normal((k, k, cin, cout)) * std
                      ).astype(np.float32),
                "b": rng.normal(0, 0.05, cout).astype(np.float32)}

    stem_bn, stem_st = _bn_stats(rng, net_size)
    params = {"stem": {**conv(7, 3, net_size), "bn": stem_bn},
              "out": conv(1, net_size * 8, 7)}
    state = {"stem": stem_st}
    chans = [(net_size, net_size), (net_size, net_size * 2),
             (net_size * 2, net_size * 4), (net_size * 4, net_size * 8)]
    for i, (cin, cout) in enumerate(chans, start=1):
        p = {"conv1": conv(3, cin, cout), "conv2": conv(3, cout, cout),
             "shortcut_conv": conv(1, cin, cout)}
        s = {}
        for bn_key in ("bn1", "bn2", "shortcut_bn"):
            p[bn_key], s[bn_key] = _bn_stats(rng, cout)
        params[f"res{i}"], state[f"res{i}"] = p, s
    return params, state
