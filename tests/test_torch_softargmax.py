"""Kernel K2's plain version (the PyTorch port's soft-argmax) against the
JAX package: the Pallas kernel in interpret mode and its XLA twin; and its
backward against the JAX package's custom VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu.ops.pallas_kernels import (
    _bwd,
    _coord_rows as jax_coord_rows,
    _pallas_softargmax,
    _xla_softargmax,
)
from mit_driverless_cv_traininginfra_tpu.ops.pallas_kernels import (
    fused_softargmax as jax_fused_softargmax,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import (
    soft_argmax_2d,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    _coord_rows,
    _coord_tables,
    _torch_softargmax,
    _torch_softargmax_bwd,
    fused_softargmax,
    softargmax_bwd,
)


@pytest.mark.parametrize("n", [13, 64, 80])
def test_coord_rows_bit_equal_to_jax(n):
    # torch.linspace differs from jnp.linspace by 1 ulp at some points for
    # n = 80; the port rebuilds JAX's formula and must match bit for bit
    xv, yv = _coord_rows(n, n + 3)
    jx, jy = jax_coord_rows(n, n + 3, jnp.float32)
    np.testing.assert_array_equal(xv.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(yv.numpy(), np.asarray(jy))


@pytest.mark.parametrize("h,w", [(80, 80), (13, 17), (1, 7)])
def test_coord_tables_index_to_the_coord_rows(h, w):
    # K2's forward reads the w-entry xs and h-entry ys tables and indexes
    # them as xs[i % w], ys[i // w]: the same bits as both packages' rows
    xs, ys = _coord_tables(h, w)
    assert xs.shape == (w,) and ys.shape == (h,) and xs.dtype == torch.float32
    i = torch.arange(h * w)
    xv, yv = xs[i % w], ys[i // w]
    rx, ry = _coord_rows(h, w)
    jx, jy = jax_coord_rows(h, w, jnp.float32)
    for got, port, ref in ((xv, rx, jx), (yv, ry, jy)):
        bits = got.numpy().view(np.int32)
        np.testing.assert_array_equal(bits, port[0].numpy().view(np.int32))
        np.testing.assert_array_equal(bits, np.asarray(ref)[0].view(np.int32))


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


# ---------------------------------------------------------------------------
# K2's backward: the plain version against the JAX package's custom VJP
# ---------------------------------------------------------------------------


def _probs(seed, dtype, m=6):
    """Probabilities in the logits' dtype, as the JAX forward saves them."""
    _, probs = _xla_softargmax(jnp.asarray(_logits(seed, m=m)).astype(dtype))
    return probs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_g_probs", [True, False])
def test_backward_matches_jax_bwd(dtype, with_g_probs):
    """``_torch_softargmax_bwd`` against ``_bwd`` on the same saved probs.
    dz = p·(gp − Σ gp·p): the elementwise part rounds alike; the row sum is
    taken in another order, which moves dz by p·Δs, within 1e-5 of the
    row's largest |dz|; bf16 also rounds the result (one bf16 ulp, 2^-7
    relative, where Δs crosses a rounding boundary). A missing g_probs is
    the JAX package's symbolic zero."""
    rng = np.random.default_rng(4)
    jprobs = _probs(5, dtype)
    g_pts = rng.normal(0, 1, (6, 2)).astype(np.float32)
    g_probs = rng.normal(0, 1e-2, (6, 80, 80)).astype(np.float32)
    jg = jnp.asarray(g_probs if with_g_probs else np.zeros_like(g_probs)).astype(dtype)
    (want,) = _bwd((jprobs,), (jnp.asarray(g_pts), jg))
    probs = torch.from_numpy(np.asarray(jprobs, np.float32)).to(getattr(torch, dtype))
    got = _torch_softargmax_bwd(
        probs, torch.from_numpy(g_pts),
        torch.from_numpy(g_probs).to(probs.dtype) if with_g_probs else None)
    assert got.dtype == probs.dtype and got.shape == probs.shape
    want = np.asarray(want, np.float32)
    rtol = 0.0 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=1e-5 * np.abs(want).max())


def test_autograd_matches_jax_custom_vjp():
    """The gradient through ``fused_softargmax`` (the autograd Function,
    whose backward is K2's on the card and the plain version here) against
    ``jax.grad`` through the JAX package's ``fused_softargmax``."""
    rng = np.random.default_rng(6)
    z = _logits(7, m=5)
    w_pts = rng.normal(0, 1, (5, 2)).astype(np.float32)
    w_pr = rng.normal(0, 1, (5, 80, 80)).astype(np.float32)

    def jf(x):
        pts, probs = jax_fused_softargmax(x)
        return jnp.sum(pts * w_pts) + jnp.sum(probs * w_pr)

    want = np.asarray(jax.grad(jf)(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    before = (fused_softargmax.launches, softargmax_bwd.launches)
    pts, probs = fused_softargmax(zt)
    ((pts * torch.from_numpy(w_pts)).sum()
     + (probs * torch.from_numpy(w_pr)).sum()).backward()
    assert (fused_softargmax.launches, softargmax_bwd.launches) == before
    np.testing.assert_allclose(zt.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # only the points used: the probabilities' gradient is None, not zeros
    zt.grad = None
    pts, _ = fused_softargmax(zt)
    (pts * torch.from_numpy(w_pts)).sum().backward()
    ref = _torch_softargmax_bwd(_torch_softargmax(torch.from_numpy(z))[1],
                                torch.from_numpy(w_pts))
    assert torch.equal(zt.grad, ref)


def test_soft_argmax_2d_bf16_gradient_flows_in_bf16():
    z = torch.from_numpy(_logits(8, m=2 * 7).reshape(2, 7, 80, 80)).to(torch.bfloat16)
    z.requires_grad_(True)
    pts, probs = soft_argmax_2d(z)
    pts.float().sum().backward()
    assert z.grad.dtype == torch.bfloat16 and torch.isfinite(z.grad.float()).all()
