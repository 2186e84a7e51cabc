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


# ---------------------------------------------------------------------------
# K2's backward on the card (csrc/softargmax.cu), modelled in numpy
# ---------------------------------------------------------------------------


def _f32(x):
    return np.asarray(x, np.float32)


def _bwd_model(p, g_pts, g_probs, h, w, itemsize, aligned=True):
    """``softargmax_bwd_kernel``'s arithmetic in its order, f32: one block
    per row; thread t holds the 16-byte vectors j ≡ t (mod blockDim) (V =
    16 / itemsize values each; ``kBwdVecs`` of them in registers, the rest
    read again); gp from the w-entry xs and h-entry ys tables, element i of
    vector j at column c and row r stepped from ((j·V) % w, (j·V) // w);
    the f32 products gp·p summed in f64 per vector in element order, then
    over the thread's vectors in increasing j, then the warp's xor
    shuffles, then the same xor shuffles over the warps' partials (0 past
    the last warp), and rounded to f32 once;
    dz = p·(gp − s). Returns dz (M, h·w) in f32."""
    m, hw = p.shape
    V, NV = 16 // itemsize, 2 if itemsize == 2 else 4  # softargmax.cu: kBwdVecs
    nvec = -(-hw // V)
    nt = min(1024, -(-(-(-nvec // NV)) // 32) * 32)
    vec = hw % V == 0 and aligned
    in_row = vec and w % V == 0
    xs, ys = (t.numpy() for t in _coord_tables(h, w))
    # the lookups of each vector's elements, stepped as the kernel does
    j = np.arange(nvec)
    r, c = (j * V) // w, (j * V) % w
    cols, rws = np.zeros((nvec, V), np.int64), np.zeros((nvec, V), np.int64)
    for q in range(V):
        cols[:, q], rws[:, q] = c, r
        c = c + 1
        r = np.where(c == w, r + 1, r)
        c = np.where(c == w, 0, c)
    i = j[:, None] * V + np.arange(V)
    valid = i < hw
    np.testing.assert_array_equal(cols[valid], i[valid] % w)
    np.testing.assert_array_equal(rws[valid], i[valid] // w)
    if in_row:  # each vector inside one map row, its xs 16-byte aligned
        assert (cols[:, 0] % V == 0).all() and (rws == rws[:, :1]).all()
    pad = nvec * V - hw
    pv = np.pad(_f32(p), ((0, 0), (0, pad))).reshape(m, nvec, V)
    gx, gy = _f32(g_pts[:, 0])[:, None, None], _f32(g_pts[:, 1])[:, None, None]
    cl, rl = np.where(valid, cols, 0), np.where(valid, rws, 0)
    up = _f32(_f32(gx * xs[cl]) + _f32(gy * ys[rl]))
    if g_probs is not None:
        up = _f32(np.pad(_f32(g_probs), ((0, 0), (0, pad))).reshape(m, nvec, V) + up)
    gp = np.where(valid, up, np.float32(0))
    prod = _f32(gp * pv).astype(np.float64)  # the f32 products, summed in f64
    sv = np.zeros((m, nvec))
    for q in range(V):
        sv = sv + prod[:, :, q]
    per_thread = np.zeros((m, nt))
    for a in range(-(-nvec // nt)):
        part = sv[:, a * nt:(a + 1) * nt]
        per_thread[:, :part.shape[1]] = per_thread[:, :part.shape[1]] + part
    lanes = per_thread.reshape(m, nt // 32, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, np.arange(32) ^ o]
    warps = np.zeros((m, 32))  # lane a: warp a's partial, 0 past the last warp
    warps[:, :nt // 32] = lanes[:, :, 0]
    for o in (16, 8, 4, 2, 1):
        warps = warps + warps[:, np.arange(32) ^ o]
    s = warps[:, :1, None]
    dz = _f32(pv * _f32(gp - _f32(s)))
    return dz.reshape(m, nvec * V)[:, :hw]


@pytest.mark.parametrize("h,w", [(80, 80), (13, 17), (1, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_g_probs", [True, False])
def test_backward_kernel_model_matches_jax_bwd(h, w, dtype, with_g_probs):
    """The card kernel's schedule (``_bwd_model``) against the JAX
    package's ``_bwd`` on the same saved probabilities, within the plain
    version's tolerance: 1e-5 of the row's largest |dz| (the row sum in
    another order), one bf16 ulp in bf16; and against the plain version."""
    rng = np.random.default_rng(16)
    m = 9
    z = rng.normal(0, 3, (m, h, w)).astype(np.float32)
    _, jprobs = _xla_softargmax(jnp.asarray(z).astype(dtype))
    g_pts = rng.normal(0, 1, (m, 2)).astype(np.float32)
    g_probs = jnp.asarray(rng.normal(0, 1e-2, (m, h, w)).astype(np.float32)).astype(dtype)
    jg = g_probs if with_g_probs else jnp.zeros_like(g_probs)
    (want,) = _bwd((jprobs,), (jnp.asarray(g_pts), jg))
    want = np.asarray(want, np.float32)
    p = np.array(jprobs, np.float32).reshape(m, h * w)
    gpr = np.array(g_probs, np.float32).reshape(m, h * w) if with_g_probs else None
    dz = _bwd_model(p, g_pts, gpr, h, w, 2 if dtype == "bfloat16" else 4)
    got = torch.from_numpy(dz.reshape(m, h, w)).to(getattr(torch, dtype)).float().numpy()
    rtol = 0.0 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * np.abs(want).max())
    tdt = getattr(torch, dtype)
    plain = _torch_softargmax_bwd(
        torch.from_numpy(p.reshape(m, h, w)).to(tdt), torch.from_numpy(g_pts),
        torch.from_numpy(gpr.reshape(m, h, w)).to(tdt) if with_g_probs else None)
    plain = plain.float().numpy()
    np.testing.assert_allclose(got, plain, rtol=rtol, atol=1e-5 * np.abs(plain).max())


@pytest.mark.parametrize("h,w,itemsize,aligned", [(100, 100, 2, True), (8, 17, 2, True),
                                                  (80, 80, 4, False), (1, 7, 4, True)])
def test_backward_kernel_model_paths_match_plain(h, w, itemsize, aligned):
    """The model's other paths against the plain version in f32: a row
    longer than the block's registers (100×100: vectors read again), vectors
    that cross a map row (8×17), an unaligned base (element by element),
    a row shorter than one vector (1×7)."""
    rng = np.random.default_rng(17)
    m = 4
    z = torch.from_numpy(rng.normal(0, 3, (m, h, w)).astype(np.float32))
    _, probs = _torch_softargmax(z)
    g_pts = rng.normal(0, 1, (m, 2)).astype(np.float32)
    gpr = rng.normal(0, 1e-2, (m, h * w)).astype(np.float32)
    dz = _bwd_model(probs.reshape(m, -1).numpy(), g_pts, gpr, h, w, itemsize, aligned)
    ref = _torch_softargmax_bwd(probs, torch.from_numpy(g_pts),
                                torch.from_numpy(gpr.reshape(m, h, w))).reshape(m, -1).numpy()
    np.testing.assert_allclose(dz, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
