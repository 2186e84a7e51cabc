"""Shared set-up of the ``test_torch_*`` files: the same seeded numpy
weights go into the JAX package and, through ``convert.from_jax``, into the
PyTorch port. Each package parses the same ``.cfg`` text with its own
parser: the port checks block types against its own classes."""

from __future__ import annotations

import dataclasses
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

from mit_driverless_cv_traininginfra_tpu.config import load_network_spec
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu.models import quantize as jquantize
from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu.models.stem_opt import (
    slice_preyolo as jslice_preyolo,
)
from mit_driverless_cv_traininginfra_tpu.ops import pallas_entry as jentry
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config import darknet_cfg as tcfg
from mit_driverless_cv_traininginfra_tpu_torch.models import (
    darknet,
    quantize,
    rektnet,
    stem_opt,
)

TINY_CFG = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")

# the YOLOv3 entry pattern (blocks 0-5) and one head at 64², the text of
# tests/test_pallas_entry.py:ENTRY_CFG
ENTRY_CFG = textwrap.dedent("""\
    [net]
    width=64
    height=64
    onnx_height=32
    classes=1
    channels=3
    yolo_masks=0,1,2
    yolo_scales=2
    leaky_slope=0.1
    conv_activation=leaky
    conf_thresh=0.8
    nms_thresh=0.25
    iou_thresh=0.5

    [convolutional]
    batch_normalize=1
    filters=32
    size=3
    stride=1
    pad=1
    activation=leaky

    [convolutional]
    batch_normalize=1
    filters=64
    size=3
    stride=2
    pad=1
    activation=leaky

    [convolutional]
    batch_normalize=1
    filters=32
    size=1
    stride=1
    pad=1
    activation=leaky

    [convolutional]
    batch_normalize=1
    filters=64
    size=3
    stride=1
    pad=1
    activation=leaky

    [shortcut]
    from=-3
    activation=linear

    [convolutional]
    batch_normalize=1
    filters=128
    size=3
    stride=2
    pad=1
    activation=leaky

    [convolutional]
    size=1
    stride=1
    pad=1
    filters=preyolo
    activation=linear

    [yolo]
    mask = 0,1,2
    anchors = 10,13,  16,30,  33,23
    classes=1
    num=3
""")


def to_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tiny_spec():
    return load_network_spec(TINY_CFG, vanilla_anchor=True)


def tiny_port_spec():
    """The tiny cfg parsed by the port's parser."""
    return tcfg.load_network_spec(TINY_CFG, vanilla_anchor=True)


def spec_key(spec):
    """A spec of either package as plain data (block type names and
    fields), so the two packages' specs compare equal when they agree."""
    return (dataclasses.asdict(spec.net), spec.anchors,
            tuple((type(b).__name__, dataclasses.asdict(b))
                  for b in spec.blocks))


def tiny_models(seed: int = 0, net_size: int = 4):
    """Serving models of both packages from one numpy init: the tiny
    Darknet cfg (BN folded, heads sliced to one class) and a narrow RektNet.

    Returns ``(jax, port)`` where ``jax = (spec, yolo_folded, rekt_folded)``
    and ``port = (yolo: Darknet, rekt: RektNet)``."""
    spec, tspec = tiny_spec(), tiny_port_spec()
    rng = np.random.default_rng(seed)
    yp, ys = convert.init_darknet_np(tspec, rng)
    rp, rs = convert.init_rektnet_np(rng, net_size=net_size)

    jspec, jfolded = jslice_preyolo(
        spec, jdarknet.fold_bn(to_jnp(yp), to_jnp(ys), spec))
    jrekt = jrektnet.fold_bn(to_jnp(rp), to_jnp(rs))

    tspec, tfolded = stem_opt.slice_preyolo(
        tspec, darknet.fold_bn(convert.from_jax(yp), convert.from_jax(ys),
                               tspec))
    yolo = darknet.Darknet(tspec, tfolded)
    rekt = rektnet.RektNet(rektnet.fold_bn(convert.from_jax(rp),
                                           convert.from_jax(rs)))
    return (jspec, jfolded, jrekt), (yolo, rekt)


def gap_threshold(conf: np.ndarray, per_frame: float) -> float:
    """A confidence threshold passing ~``per_frame`` candidates per frame,
    set mid-way between two neighbouring confidences so that f32 rounding
    differences between the packages cannot move a candidate across it."""
    flat = np.sort(conf.ravel())
    i = flat.size - int(per_frame * conf.shape[0])
    return float((flat[i - 1] + flat[i]) / 2)


def entry_specs(directory):
    """The ENTRY_CFG spec, written to a file in ``directory`` and parsed by
    both packages: ``(JAX spec, port spec)``."""
    path = os.path.join(str(directory), "entry.cfg")
    with open(path, "w") as f:
        f.write(ENTRY_CFG)
    return (load_network_spec(path, vanilla_anchor=True),
            tcfg.load_network_spec(path, vanilla_anchor=True))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def int8_models(specs, frames, seed: int = 0, net_size: int = 16,
                use_entry: bool = True):
    """Both packages' int8 serving models from one numpy init: heads sliced
    to one class, calibrated on ``frames`` (and seeded crops) and quantized
    once in JAX, then carried to the port with ``quantized_from_jax``, so
    both run on identical integers. ``specs``: one cfg parsed by both
    packages, ``(JAX spec, port spec)``.

    Returns ``(jax, port)``: ``jax = (spec', yolo_q, entry_q or None,
    rekt_q)``, ``port = (Int8Darknet, Int8RektNet)``."""
    spec, tspec = specs
    rng = np.random.default_rng(seed)
    yp, ys = convert.init_darknet_np(tspec, rng)
    rp, rs = convert.init_rektnet_np(rng, net_size=net_size)
    tspec, _ = stem_opt.slice_preyolo(
        tspec, darknet.fold_bn(convert.from_jax(yp), convert.from_jax(ys),
                               tspec))
    jspec, jfolded = jslice_preyolo(
        spec, jdarknet.fold_bn(to_jnp(yp), to_jnp(ys), spec))
    jrekt = jrektnet.fold_bn(to_jnp(rp), to_jnp(rs))
    amax = jquantize.calibrate(jspec, jfolded, jnp.asarray(frames, jnp.float32))
    yolo_q = jquantize.quantize_params(jspec, jfolded, amax)
    entry_q = jentry.quantize_entry(jfolded, amax) if use_entry else None
    crops = rng.uniform(0, 1, (8, 80, 80, 3)).astype(np.float32)
    rekt_q = jquantize.quantize_rektnet_params(
        jrekt, jquantize.calibrate_rektnet(jrekt, jnp.asarray(crops)))
    yolo = quantize.Int8Darknet(
        tspec, convert.quantized_from_jax(to_numpy(yolo_q)),
        None if entry_q is None else
        convert.quantized_from_jax(to_numpy(entry_q)))
    rekt = quantize.Int8RektNet(convert.quantized_from_jax(to_numpy(rekt_q)))
    return (jspec, yolo_q, entry_q, rekt_q), (yolo, rekt)
