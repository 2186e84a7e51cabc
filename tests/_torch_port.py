"""Shared set-up of the ``test_torch_*`` files: the same seeded numpy
weights go into the JAX package and, through ``convert.from_jax``, into the
PyTorch port."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from mit_driverless_cv_traininginfra_tpu.config import load_network_spec
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu.models.stem_opt import (
    slice_preyolo as jslice_preyolo,
)
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.models import (
    darknet,
    rektnet,
    stem_opt,
)

TINY_CFG = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")


def to_jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tiny_spec():
    return load_network_spec(TINY_CFG, vanilla_anchor=True)


def tiny_models(seed: int = 0, net_size: int = 4):
    """Serving models of both packages from one numpy init: the tiny
    Darknet cfg (BN folded, heads sliced to one class) and a narrow RektNet.

    Returns ``(jax, port)`` where ``jax = (spec, yolo_folded, rekt_folded)``
    and ``port = (yolo: Darknet, rekt: RektNet)``."""
    spec = tiny_spec()
    rng = np.random.default_rng(seed)
    yp, ys = convert.init_darknet_np(spec, rng)
    rp, rs = convert.init_rektnet_np(rng, net_size=net_size)

    jspec, jfolded = jslice_preyolo(
        spec, jdarknet.fold_bn(to_jnp(yp), to_jnp(ys), spec))
    jrekt = jrektnet.fold_bn(to_jnp(rp), to_jnp(rs))

    tspec, tfolded = stem_opt.slice_preyolo(
        spec, darknet.fold_bn(convert.from_jax(yp), convert.from_jax(ys), spec))
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
