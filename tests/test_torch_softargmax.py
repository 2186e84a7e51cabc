"""Kernel K2's plain version (the PyTorch port's soft-argmax) against the
JAX package: the Pallas kernel in interpret mode and its XLA twin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu.ops.pallas_kernels import (
    _coord_rows as jax_coord_rows,
    _pallas_softargmax,
    _xla_softargmax,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import (
    soft_argmax_2d,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    _coord_rows,
    _torch_softargmax,
    fused_softargmax,
)


@pytest.mark.parametrize("n", [13, 64, 80])
def test_coord_rows_bit_equal_to_jax(n):
    # torch.linspace differs from jnp.linspace by 1 ulp at some points for
    # n = 80; the port rebuilds JAX's formula and must match bit for bit
    xv, yv = _coord_rows(n, n + 3)
    jx, jy = jax_coord_rows(n, n + 3, jnp.float32)
    np.testing.assert_array_equal(xv.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(yv.numpy(), np.asarray(jy))


def _logits(seed, m=12, h=80, w=80):
    return np.random.default_rng(seed).normal(0, 3, (m, h, w)).astype(np.float32)


def test_plain_matches_pallas_interpret_and_xla():
    z = _logits(0)
    pts, probs = _torch_softargmax(torch.from_numpy(z))
    with pltpu.force_tpu_interpret_mode():
        pts_p, pr_p = _pallas_softargmax(jnp.asarray(z))
    pts_x, pr_x = _xla_softargmax(jnp.asarray(z))
    # f32, sums over 6400 terms in different orders: atol 1e-6
    for ref_pts, ref_pr in ((pts_p, pr_p), (pts_x, pr_x)):
        np.testing.assert_allclose(pts.numpy(), np.asarray(ref_pts), atol=1e-6)
        np.testing.assert_allclose(probs.numpy(), np.asarray(ref_pr), atol=1e-6)


def test_wrapper_takes_plain_version_on_cpu():
    z = torch.from_numpy(_logits(1, m=3))
    before = fused_softargmax.launches
    pts, probs = fused_softargmax(z)
    ref_pts, ref_probs = _torch_softargmax(z)
    assert torch.equal(pts, ref_pts) and torch.equal(probs, ref_probs)
    assert fused_softargmax.launches == before  # no kernel on a CPU tensor
    assert pts.dtype == torch.float32 and probs.shape == (3, 80, 80)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_soft_argmax_2d_matches_rektnet(dtype):
    z = _logits(2, m=2 * 7).reshape(2, 7, 80, 80)
    pts, probs = soft_argmax_2d(torch.from_numpy(z).to(getattr(torch, dtype)))
    jpts, jprobs = jrektnet.soft_argmax_2d(
        jnp.asarray(z).astype(getattr(jnp, dtype)))
    assert pts.dtype == getattr(torch, dtype)  # points cast to logits dtype
    # f32: atol 1e-6; bf16: points and probs are rounded to bf16 at the end,
    # so one bf16 ulp of a value in [0, 1): 2^-8
    atol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(pts.float().numpy(),
                               np.asarray(jpts, np.float32), atol=atol)
    np.testing.assert_allclose(probs.float().numpy(),
                               np.asarray(jprobs, np.float32), atol=atol)
