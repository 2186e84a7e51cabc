"""Pins of repairs of the port, against the JAX package on the CPU
(the card's side is in ``test_torch_cuda_serving.py``):

- the uint8 feed's normalise is ``x · fl(1/255)``, bit-equal to the JAX
  package's jitted ``u8.astype(f32) / 255.0`` (XLA folds the constant
  divisor into a reciprocal multiply) for all 256 values;
- the int8 weight scales ``max|w| / 127`` are the IEEE quotient, as the
  JAX package's eager division is, so every quantized leaf is bit-equal;
- the gradient clip is ``optax.clip_by_global_norm``'s formula: no
  ``1e-6`` beside the norm and no factor clamped to 1 (as
  ``torch.nn.utils.clip_grad_norm_`` has), clipping only where ``norm ≥
  max_norm``, and ``g / norm · max_norm`` divided, then multiplied;
- the bf16 RektNet step feeds its loss f32 points, where the JAX step's
  bf16 points coincide and its gradient explodes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.models import quantize as jquantize
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
    normalize_u8,
)
from mit_driverless_cv_traininginfra_tpu_torch.models import quantize, rektnet
from mit_driverless_cv_traininginfra_tpu_torch.train import optim


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_uint8_normalise_bit_equal_to_jitted_jax():
    u8 = np.arange(256, dtype=np.uint8)
    ref = jax.jit(lambda x: x.astype(jnp.float32) / 255.0)(jnp.asarray(u8))
    got = normalize_u8(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), _bits(ref))
    # the IEEE quotient, which the port used to take, is 1 ulp off for
    # some of them: the pin can see the difference
    quot = (torch.from_numpy(u8).float() / 255.0).numpy()
    assert (quot.view(np.int32) != _bits(ref)).sum() > 0


@pytest.mark.parametrize("shape,amax", [((1024, 512, 3, 3), 3.7),
                                        ((64, 3, 7, 7), 1.0),
                                        ((32, 64, 1, 1), 1e-13)])
def test_quantize_conv_leaves_bit_equal_to_jax(shape, amax):
    rng = np.random.default_rng(shape[0])
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 2.0, (shape[0], 1, 1, 1))
         ).astype(np.float32)
    w[0] = 0.0                           # an all-zero channel: the 1e-12 floor
    b = rng.standard_normal(shape[0]).astype(np.float32)
    got = quantize._quantize_conv(torch.from_numpy(w), torch.from_numpy(b),
                                  amax)
    ref = jquantize._quantize_conv(w.transpose(2, 3, 1, 0), b, amax)  # HWIO
    np.testing.assert_array_equal(got["wq"].numpy(),
                                  np.asarray(ref["wq"]).transpose(3, 2, 0, 1))
    for k in ("scale", "b", "sx_inv"):
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      _bits(ref[k]), err_msg=k)


def _rektnet_grads(scale: float, seed: int = 0):
    """Seeded numpy gradients of every RektNet parameter's shape."""
    model = rektnet.KeypointNet(*rektnet.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale, tuple(p.shape)).astype(np.float32)
            for p in model.parameters()]


def _optax_clip(grads, max_norm):
    import optax

    tree = {f"{i:03d}": g for i, g in enumerate(grads)}  # leaves in this order
    out, _ = optax.clip_by_global_norm(max_norm).update(tree, None)
    return [np.asarray(out[f"{i:03d}"]) for i in range(len(grads))], tree


# the global norm is ~5.6e-4 per unit of scale: far below, far above, and
# the limit set to optax's own norm (optax clips there: trigger is norm <
# max_norm)
@pytest.mark.parametrize("scale,max_norm", [(1e-3, 10.0), (1.0, 10.0), (1.0, None)])
def test_grad_clip_bit_equal_to_optax_on_the_same_norm(monkeypatch, scale, max_norm):
    import optax

    grads = _rektnet_grads(scale)
    norm = np.asarray(optax.global_norm({f"{i:03d}": g for i, g in enumerate(grads)}))
    if max_norm is None:
        max_norm = float(norm)
    ref, _ = _optax_clip(grads, max_norm)
    # the leaves' f32 sums run in XLA's order there and in torch's here:
    # hand the clip optax's norm to hold the formula itself bit for bit
    monkeypatch.setattr(optim, "global_norm", lambda g: torch.from_numpy(norm.copy()))
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    opt = optim.make_optimizer(params, "SGD", lr=0.0, momentum=0.0, grad_clip=max_norm)
    optim.optimizer_step(opt)
    for p, r, g in zip(params, ref, grads):
        np.testing.assert_array_equal(p.grad.numpy().view(np.int32), r.view(np.int32))
    clipped = float(norm) >= max_norm
    assert clipped == (scale == 1.0)
    assert clipped == any(not np.array_equal(p.grad.numpy(), g) for p, g in zip(params, grads))


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_optimizer_step_clips_as_optax(scale):
    """End to end: the port's norm sums each leaf in torch's order, optax's
    in XLA's, so the norms (and the clipped values) may differ in their
    last bits: within rtol 2e-6 (RektNet's 54 leaves, up to 1.2e5 values
    each, differ by up to 6 ulps); unclipped gradients stay bit-equal."""
    import optax

    grads = _rektnet_grads(scale, seed=1)
    ref, tree = _optax_clip(grads, 10.0)
    norm = optim.global_norm([torch.from_numpy(g) for g in grads])
    np.testing.assert_allclose(float(norm), float(optax.global_norm(tree)), rtol=1e-6)
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    optim.optimizer_step(optim.make_optimizer(params, "Adam", lr=0.0, grad_clip=10.0))
    for p, r in zip(params, ref):
        if scale < 1.0:
            np.testing.assert_array_equal(p.grad.numpy(), r)
        else:
            np.testing.assert_allclose(p.grad.numpy(), r, rtol=2e-6, atol=0)


def _bf16_collision_case():
    """net_size 4, B=4 crops, the head's weights scaled by 0.03: the f32
    points spread by ~3e-3, so three of the geometric loss's edge vectors
    are exactly zero once the points are rounded to bf16 (none in f32)."""
    from mit_driverless_cv_traininginfra_tpu_torch import convert
    from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic

    rng = np.random.default_rng(0)
    rp, rs = convert.init_rektnet_np(rng, net_size=4)
    rp["out"]["w"] = rp["out"]["w"] * np.float32(0.03)
    crops, pts = synthetic.rektnet_batch(rng, 4)
    return rp, rs, crops, pts


_GEO = dict(loss_type="l1_softargmax", include_geo=True, geo_loss_gamma_horz=0.05,
            geo_loss_gamma_vert=0.05)


def _jax_grad_norm(rp, rs, crops, pts, cdt) -> float:
    """The global norm of the gradient of the JAX package's step
    (``train/steps.py``'s ``loss_fn``) in ``cdt``."""
    from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
    from mit_driverless_cv_traininginfra_tpu.models.cross_ratio_loss import (
        cross_ratio_loss as j_cross_ratio_loss,
    )
    from mit_driverless_cv_traininginfra_tpu.ops.heatmap import gaussian_heatmaps

    thm = gaussian_heatmaps(jnp.asarray(pts), 80, 80, sigma=1.0)

    def loss_fn(params):
        p = jax.tree_util.tree_map(lambda v: v.astype(cdt), params)
        hm, kp, _ = jrektnet.apply(p, rs, jnp.asarray(crops).astype(cdt), train=True)
        return j_cross_ratio_loss(hm.astype(jnp.float32), kp.astype(jnp.float32), thm,
                                  jnp.asarray(pts), **_GEO)[2]

    g = jax.jit(jax.grad(loss_fn))(jax.tree_util.tree_map(jnp.asarray, rp))
    return float(jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g))))


def test_rektnet_bf16_step_takes_f32_points():
    """The bf16 RektNet step feeds the loss K2's f32 points. Rounded to
    bf16 first, as the JAX step rounds them, points closer than a bf16
    step coincide, and ``F.normalize``'s eps clamp at the zero edge vector
    makes the gradient ≥ 1e4 times the f32 step's (1e5 at B=256, where
    Adam then stalls). The port's bf16 gradient keeps the f32 one's norm
    (within 10%) and direction (cosine ≥ 0.97, the bf16 bound of
    ``test_torch_rektnet_train.py``)."""
    from mit_driverless_cv_traininginfra_tpu_torch import convert
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import rektnet_train_step

    rp, rs, crops, pts = _bf16_collision_case()
    grads = {}
    for dt in ("float32", "bfloat16"):
        model = rektnet.KeypointNet(convert.from_jax(rp), convert.from_jax(rs))
        opt = optim.make_optimizer(model.parameters(), "SGD", lr=0.0, momentum=0.0)
        rektnet_train_step(model, opt, torch.from_numpy(crops), torch.zeros(1),
                           torch.from_numpy(pts), compute_dtype=dt,
                           synth_target_sigma=1.0, **_GEO)
        # the pre-BN conv biases and the head's bias have a true gradient
        # of 0: theirs is rounding noise
        grads[dt] = torch.cat([p.grad.flatten().double() for n, p in model.named_parameters()
                               if not (n.endswith(".bias") and ("conv" in n or n == "out.bias"))])
    g32, g16 = grads["float32"], grads["bfloat16"]
    # the case hits the collision in the JAX package
    assert _jax_grad_norm(rp, rs, crops, pts, jnp.bfloat16) > 1e4 * float(g32.norm())
    assert abs(float(g16.norm()) / float(g32.norm()) - 1.0) < 0.1
    assert float(g16 @ g32 / (g16.norm() * g32.norm())) >= 0.97
