"""The PyTorch port's models against the JAX package on the same numpy
weights, carried over by ``convert.from_jax``: Darknet (tiny cfg — every
block type, the k2/s1 maxpool quirk, route, shortcut, upsample), BN
folding, decode, the 1-class head slice, and RektNet."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import spec_key, tiny_port_spec, tiny_spec, to_jnp
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

# f32 convolutions on the CPU in both frameworks (oneDNN vs XLA's Eigen),
# summed in other orders: relative differences ~1e-6 that a few layers
# grow; rtol 1e-4 / atol 1e-5 on activations in O(1).
RTOL, ATOL = 1e-4, 1e-5


def _hwio(w):
    return w.permute(2, 3, 1, 0).numpy()  # OIHW → HWIO


@pytest.fixture(scope="module")
def tiny():
    """The tiny cfg parsed by both packages, ``(JAX spec, port spec)``,
    frames and the folded weights of both."""
    spec, tspec = tiny_spec(), tiny_port_spec()
    rng = np.random.default_rng(0)
    yp, ys = convert.init_darknet_np(tspec, rng)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jfolded = jdarknet.fold_bn(to_jnp(yp), to_jnp(ys), spec)
    tfolded = darknet.fold_bn(convert.from_jax(yp), convert.from_jax(ys), tspec)
    return (spec, tspec), x, jfolded, tfolded


def test_from_jax_transposes_conv_weights_only():
    tree = {"a": {"w": np.arange(24, dtype=np.float32).reshape(1, 2, 3, 4),
                  "b": np.ones(4, np.float32)}}
    out = convert.from_jax(tree)
    assert out["a"]["w"].shape == (4, 3, 1, 2)
    np.testing.assert_array_equal(_hwio(out["a"]["w"]), tree["a"]["w"])
    assert out["a"]["b"].shape == (4,)


def test_darknet_fold_bn_matches_jax(tiny):
    spec, _, jfolded, tfolded = tiny
    assert sorted(jfolded) == sorted(tfolded)
    for k in jfolded:
        # the same elementwise f32 formula; XLA may rewrite the divide by
        # sqrt (rsqrt, reciprocal): a few ulp, rtol 5e-7
        np.testing.assert_allclose(_hwio(tfolded[k]["w"]),
                                   np.asarray(jfolded[k]["w"]), rtol=5e-7)
        np.testing.assert_allclose(tfolded[k]["b"].numpy(),
                                   np.asarray(jfolded[k]["b"]), rtol=5e-7,
                                   atol=1e-7)


def test_darknet_forward_and_detections_match_jax(tiny):
    (spec, tspec), x, jfolded, tfolded = tiny
    model = darknet.Darknet(tspec, tfolded)
    with torch.inference_mode():
        heads = model.forward_features(torch.from_numpy(x))
        dets = model.detections(torch.from_numpy(x), with_classes=True)
    jheads, _ = jdarknet.forward_features(spec, jfolded, {}, jnp.asarray(x))
    jdets = jdarknet.detections(spec, jfolded, {}, jnp.asarray(x))
    assert len(heads) == len(jheads) == 2
    for h, jh in zip(heads, jheads):
        assert h.shape == jh.shape  # NHWC at the public boundary
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL,
                                   atol=ATOL)
    assert dets.shape == jdets.shape and dets.dtype == torch.float32
    # decoded pixels (up to ~exp(head)·anchor): relative tolerance
    np.testing.assert_allclose(dets.numpy(), np.asarray(jdets), rtol=RTOL,
                               atol=1e-4)


def test_decode_is_f32_for_bf16_heads(tiny):
    (_, tspec), x, _, tfolded = tiny
    model = darknet.Darknet(tspec, tfolded).to(torch.bfloat16)
    with torch.inference_mode():
        dets = model.detections(torch.from_numpy(x).to(torch.bfloat16),
                                with_classes=False)
    assert dets.dtype == torch.float32 and dets.shape[-1] == 5


def test_slice_preyolo_matches_jax(tiny):
    (spec, tspec), x, jfolded, tfolded = tiny
    jspec, jsliced = jslice_preyolo(spec, jfolded)
    tspec, tsliced = stem_opt.slice_preyolo(tspec, tfolded)
    assert spec_key(tspec) == spec_key(jspec) and tspec.net.num_classes == 0
    for k in jsliced:
        np.testing.assert_allclose(_hwio(tsliced[k]["w"]),
                                   np.asarray(jsliced[k]["w"]), rtol=5e-7)
    with torch.inference_mode():
        dets = darknet.Darknet(tspec, tsliced).detections(
            torch.from_numpy(x), with_classes=False)
    jdets = jdarknet.detections(jspec, jsliced, {}, jnp.asarray(x),
                                with_classes=False)
    np.testing.assert_allclose(dets.numpy(), np.asarray(jdets), rtol=RTOL,
                               atol=1e-4)


def test_rektnet_fold_and_forward_match_jax():
    rng = np.random.default_rng(1)
    rp, rs = convert.init_rektnet_np(rng, net_size=4)
    x = rng.uniform(0, 1, (3, 80, 80, 3)).astype(np.float32)
    jfolded = jrektnet.fold_bn(to_jnp(rp), to_jnp(rs))
    model = rektnet.RektNet(rektnet.fold_bn(convert.from_jax(rp),
                                            convert.from_jax(rs)))
    with torch.inference_mode():
        probs, pts = model(torch.from_numpy(x))
    jprobs, jpts = jrektnet.apply_folded(jfolded, jnp.asarray(x))
    assert probs.shape == (3, 7, 80, 80) and pts.shape == (3, 7, 2)
    # probabilities ~1/6400 each; points in [0, 1)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-5)
    # and the folded net equals the unfolded JAX net in eval mode
    jprobs_u, jpts_u, _ = jrektnet.apply(to_jnp(rp), to_jnp(rs),
                                         jnp.asarray(x))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts_u), atol=1e-5)
