"""The port's on-device augmentation (``ops/device_aug.py``), its train
step (``train/steps.py:yolo_train_step_device_aug``) and its device pool
(``data/device_pool.py``) against the JAX package on the CPU.

The JAX package draws inside its functions from a ``jax.random`` key; the
tests take the same numbers from the same key splits and hand them to the
port as its ``draws``.

Tolerances. The matrices: M and its inverse within 2e-6 relative to
their largest entry (f32 trigonometry and ``linalg.inv`` of other
libraries). The warp, on the same inverse matrices, f32: within 1e-5 on
every value. The sampling coordinates (a three-term dot, summed in another
order) may differ by an ulp of a 64-px coordinate, 7.6e-6, and bilinear
sampling with its fill is continuous in them, so an output moves by at
most that times the image's range (measured: 4.4e-6). The label rewarp
within 1e-4 px (f32 corner warps of other summation orders). The whole
``augment_batch`` (affine, flip, jitter, noise) within 1e-5 in f32
(measured 3.4e-6), its labels within 1e-4 px; on a bf16 pool, where XLA
keeps its chains of bf16 products in f32 and the port rounds each, within
one bf16 step of [0.5, 1), 2^-7 (measured 4.9e-3). A bf16 pool: the coordinates are
f32, so an integer shift of a 300-pixel-wide bf16 image is exact in both
packages. ``DevicePool``: the batch order and the labels equal JAX's for
the same seed (a pass without replacement, then sampling with
replacement), a bf16 pool bit-equal to JAX's ``ml_dtypes`` one. The step:
PR 12's f32 bounds for ``yolo_train_step`` (loss and components 1e-5
relative, an SGD update within lr·1e-3 of the largest gradient, running
statistics 1e-5 of their scale), every flag off and with flip, jitter and
noise on the same draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.data import device_pool as jpool
from mit_driverless_cv_traininginfra_tpu.ops import device_aug as jaug
from mit_driverless_cv_traininginfra_tpu.train import optim as joptim
from mit_driverless_cv_traininginfra_tpu.train import steps as jsteps
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.data.device_pool import DevicePool
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet
from mit_driverless_cv_traininginfra_tpu_torch.ops import device_aug
from mit_driverless_cv_traininginfra_tpu_torch.train import optim, steps

from _torch_port import tiny_port_spec, tiny_spec, to_jnp

LOSS_KW = dict(xy_loss=2.0, wh_loss=1.6, object_loss=0.1, no_object_loss=25.0)


def _jax_draws(key, B, H, W, C, affine=True, flip=True, jitter=True, noise=True):
    """The numbers JAX's ``augment_batch`` draws from ``key``, as the
    port's draws."""
    k_aff, k_flip, k_j1, k_j2, k_j3, k_ns, k_nv = jax.random.split(key, 7)
    d = {}
    if affine:
        k1, k2, k3, k4, k5 = jax.random.split(k_aff, 5)
        for name, k, lo, hi in (("angle", k1, -10, 10), ("tx", k2, -40, 40),
                                ("ty", k3, -40, 40), ("scale", k4, 0.9, 1.1),
                                ("shear", k5, -3, 3)):
            d[name] = jax.random.uniform(k, (B,), minval=lo, maxval=hi)
    if flip:
        d["flip"] = jax.random.bernoulli(k_flip, 0.5, (B,))
    if jitter:
        for name, k in (("b", k_j1), ("c", k_j2), ("s", k_j3)):
            d[name] = jax.random.uniform(k, (B, 1, 1, 1), minval=0.75, maxval=1.25)
    if noise:
        d["noise_scale"] = jax.random.uniform(k_ns, (B, 1, 1, 1), maxval=0.03)
        d["noise"] = jax.random.normal(k_nv, (B, H, W, C))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _scenes(seed, B, size):
    """Synthetic scenes and their pixel-corner labels (class column 0)."""
    imgs, t = synthetic.yolo_batch(np.random.default_rng(seed), B, size, min_h=8,
                                   max_h=30)
    px = np.zeros_like(t)
    valid = t.sum(-1) > 0
    px[..., 1] = (t[..., 1] - t[..., 3] / 2) * size
    px[..., 2] = (t[..., 2] - t[..., 4] / 2) * size
    px[..., 3] = (t[..., 1] + t[..., 3] / 2) * size
    px[..., 4] = (t[..., 2] + t[..., 4] / 2) * size
    px[~valid] = 0
    return imgs, px


def _warp_bound(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= 1e-5, d.max()


def test_matrices_equal_jax():
    key = jax.random.PRNGKey(3)
    M, M_inv, ang = jaug._affine_matrices(key, 5, h=48, w=72)
    # _affine_matrices splits its key into five: the same draws for the port
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    d = {name: torch.from_numpy(np.array(jax.random.uniform(k, (5,), minval=lo, maxval=hi)))
         for name, k, lo, hi in (("angle", k1, -10, 10), ("tx", k2, -40, 40),
                                 ("ty", k3, -40, 40), ("scale", k4, 0.9, 1.1),
                                 ("shear", k5, -3, 3))}
    np.testing.assert_array_equal(d["angle"].numpy(), np.asarray(ang))
    tM, tM_inv = device_aug.affine_matrices(d, 48, 72)
    for got, want in ((tM, M), (tM_inv, M_inv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())


def test_warp_and_labels_equal_jax_on_the_same_matrices():
    imgs, px = _scenes(1, 4, 64)
    M, M_inv, ang = jaug._affine_matrices(jax.random.PRNGKey(7), 4, h=64, w=64)
    want = jaug._warp_bilinear(jnp.asarray(imgs), M_inv)
    got = device_aug.warp_bilinear(torch.from_numpy(imgs), torch.from_numpy(np.array(M_inv)))
    _warp_bound(got, want)
    wl = jaug._affine_labels_batch(jnp.asarray(px), M, ang, 64, 64)
    gl = device_aug.affine_labels_batch(torch.from_numpy(px), torch.from_numpy(np.array(M)),
                                        torch.from_numpy(np.array(ang)), 64, 64)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=1e-4)
    assert (gl.numpy()[px.sum(-1) == 0] == 0).all()  # padding rows stay zero


def test_bf16_pool_warps_with_f32_coordinates():
    """A shift by 3 px of a 300-wide bf16 image: a bf16 grid could not
    hold the odd columns past 256; f32 coordinates move every pixel."""
    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 1, (1, 8, 300, 3)).astype(np.float32)
    M_inv = np.array([[[1, 0, -3], [0, 1, 0], [0, 0, 1]]], np.float32)
    want = np.asarray(jaug._warp_bilinear(jnp.asarray(imgs, jnp.bfloat16), jnp.asarray(M_inv)))
    got = device_aug.warp_bilinear(torch.from_numpy(imgs).bfloat16(), torch.from_numpy(M_inv))
    assert got.dtype == torch.bfloat16
    exact = torch.from_numpy(imgs).bfloat16()[:, :, :-3]
    assert torch.equal(got[:, :, 3:], exact)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_augment_batch_equals_jax_on_its_draws(dtype):
    imgs, px = _scenes(4, 4, 64)
    key = jax.random.PRNGKey(11)
    wi, wl = jaug.augment_batch(key, jnp.asarray(imgs, dtype), jnp.asarray(px),
                                augment_affine=True, lr_flip=True, jitter=True, noise=True)
    draws = _jax_draws(key, 4, 64, 64, 3)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    gi, gl = device_aug.apply(torch.from_numpy(imgs).to(tdt), torch.from_numpy(px), draws)
    assert gi.dtype == torch.float32  # the jitter promotes, as in JAX
    if dtype == jnp.float32:
        _warp_bound(gi, wi)
    else:
        d = np.abs(gi.numpy() - np.asarray(wi, np.float32))
        assert d.max() <= 2 ** -7, d.max()
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=1e-4)
    assert draws["flip"].any() and not draws["flip"].all()


def test_sample_draws_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    d = device_aug.sample_draws(gen, 64, 8, 16, 3, augment_affine=True, noise=True)
    assert sorted(d) == sorted(["angle", "tx", "ty", "scale", "shear", "flip", "b", "c",
                                "s", "noise_scale", "noise"])
    assert d["noise"].shape == (64, 8, 16, 3) and d["b"].shape == (64, 1, 1, 1)
    assert d["flip"].dtype == torch.bool
    for k, lo, hi in (("angle", -10, 10), ("tx", -40, 40), ("scale", 0.9, 1.1),
                      ("shear", -3, 3), ("b", 0.75, 1.25), ("noise_scale", 0, 0.03)):
        assert lo <= float(d[k].min()) and float(d[k].max()) <= hi, k
    assert device_aug.sample_draws(gen, 2, 8, 8, lr_flip=False, jitter=False) == {}


# --- the pool -------------------------------------------------------------------

class _Items:
    def __init__(self, n=10, size=16):
        rng = np.random.default_rng(0)
        self.images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
        self.labels = rng.uniform(0, 1, (n, 3, 5)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return f"img{i}.png", self.images[i], self.labels[i]


def test_pool_order_and_contents_equal_jax():
    ds = _Items()
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        pool = DevicePool.from_dataset(ds, device="cpu", dtype=dt)
        jp = jpool.DevicePool.from_dataset(ds, dtype=jdt)
        assert pool.images.dtype == dt and pool.nbytes == jp.nbytes
        np.testing.assert_array_equal(pool.images.float().numpy(),
                                      np.asarray(jp.images, np.float32))
    got = pool.loader(3, seed=5, steps_per_epoch=5)
    want = jp.loader(3, seed=5, steps_per_epoch=5)
    for _ in range(2):  # two epochs: the generator runs on across them
        batches = list(got)
        wbatches = list(want)
        assert len(batches) == len(wbatches) == 5
        for (u, im, lb), (wu, wim, wlb) in zip(batches, wbatches):
            assert u == wu
            np.testing.assert_array_equal(lb, wlb)
            assert isinstance(lb, np.ndarray) and torch.is_tensor(im)
            np.testing.assert_array_equal(im.float().numpy(), np.asarray(wim, np.float32))
    with pytest.raises(ValueError, match="budget"):
        DevicePool.from_dataset(ds, device="cpu", budget_bytes=100)
    with pytest.raises(ValueError, match="cannot fill"):
        pool.loader(11)


# --- the step -------------------------------------------------------------------

@pytest.fixture(scope="module")
def case():
    spec, tspec = tiny_spec(), tiny_port_spec()
    yp, ys = convert.init_darknet_np(tspec, np.random.default_rng(0))
    imgs, px = _scenes(9, 4, 64)
    return spec, tspec, yp, ys, imgs, px


@pytest.mark.parametrize("flags", [dict(lr_flip=False, jitter=False, noise=False),
                                   dict(lr_flip=True, jitter=True, noise=True)],
                         ids=["off", "flip_jitter_noise"])
def test_device_aug_step_matches_jax(case, flags):
    spec, tspec, yp, ys, imgs, px = case
    lr = 0.01
    key = jax.random.PRNGKey(21)
    tx = joptim.make_optimizer("SGD", lr=lr, momentum=0.0)
    jts, jloss, jcomps = jsteps.yolo_train_step_device_aug(
        spec, tx, jsteps.init_train_state(to_jnp(yp), to_jnp(ys), tx), jnp.asarray(imgs),
        jnp.asarray(px), key, compute_dtype="float32", augment_affine=False, **flags,
        **LOSS_KW)
    draws = _jax_draws(key, 4, 64, 64, 3, affine=False, flip=flags["lr_flip"],
                       jitter=flags["jitter"], noise=flags["noise"])
    model = darknet.TrainDarknet(tspec, convert.from_jax(yp), convert.from_jax(ys))
    opt = optim.make_optimizer(model.parameters(), "SGD", lr=lr, momentum=0.0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, comps = steps.yolo_train_step_device_aug(
        model, opt, torch.from_numpy(imgs), torch.from_numpy(px), draws,
        compute_dtype="float32", **LOSS_KW)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps), rtol=1e-5, atol=1e-7)
    gmax = max(float((p.detach() - before[n]).abs().max()) for n, p in
               model.named_parameters()) / lr
    params, state = model.trees()
    got = jax.tree_util.tree_flatten_with_path(convert.to_jax(params))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(jts.params)[0])
    for path, v in got:
        np.testing.assert_allclose(np.asarray(v), np.asarray(want[path]), rtol=0,
                                   atol=lr * 1e-3 * gmax + 1e-7, err_msg=str(path))
    wstate = dict(jax.tree_util.tree_flatten_with_path(jts.model_state)[0])
    for path, v in jax.tree_util.tree_flatten_with_path(convert.to_jax(state))[0]:
        w = np.asarray(wstate[path])
        np.testing.assert_allclose(np.asarray(v), w, rtol=0, atol=1e-5 * np.abs(w).max())
