"""The port's int8 quantization (``models/quantize.py``) against the JAX
package's, on the CPU: calibration, the quantized leaves, the int8
convolution, and the int8 Darknet and RektNet forwards.

The JAX forwards run eagerly, one op at a time, as in the JAX package's
own tests of ``models.quantize``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    entry_specs,
    tiny_port_spec,
    tiny_spec,
    to_jnp,
    to_numpy,
)
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu.models import quantize as jquantize
from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu.ops import pallas_entry as jentry
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, quantize
from mit_driverless_cv_traininginfra_tpu_torch.models.quantize import (
    QConv,
    _int_conv,
    _qconv,
    _weight_matrix,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops import entry


@pytest.fixture(scope="module", params=["entry", "tiny"])
def darknet_case(request, tmp_path_factory):
    """A cfg parsed by both packages, its folded weights in both and
    calibration frames: the 64² YOLOv3 entry pattern, and the tiny cfg
    (maxpool, route, upsample, two heads; no entry). Returns ``(name,
    (JAX spec, port spec), JAX folded, port folded, frames)``."""
    specs = (entry_specs(tmp_path_factory.mktemp("cfg"))
             if request.param == "entry" else (tiny_spec(), tiny_port_spec()))
    rng = np.random.default_rng(0)
    yp, ys = convert.init_darknet_np(specs[1], rng)
    jfolded = jdarknet.fold_bn(to_jnp(yp), to_jnp(ys), specs[0])
    frames = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return (request.param, specs, jfolded,
            convert.from_jax(to_numpy(jfolded)), frames)


@pytest.fixture(scope="module")
def rektnet_case():
    rng = np.random.default_rng(1)
    rp, rs = convert.init_rektnet_np(rng, net_size=16)  # full width
    jfolded = jrektnet.fold_bn(to_jnp(rp), to_jnp(rs))
    crops = rng.uniform(0, 1, (3, 80, 80, 3)).astype(np.float32)
    return jfolded, convert.from_jax(to_numpy(jfolded)), crops


def _assert_trees_equal(got, want, path=""):
    """Every leaf bit-equal, with the same shape and dtype."""
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}{k}.")
            continue
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (path + k, g, w)
        assert torch.equal(g, w), path + k


def test_calibrate_matches_jax(darknet_case):
    _, (spec, tspec), jfolded, tfolded, frames = darknet_case
    want = jquantize.calibrate(spec, jfolded, jnp.asarray(frames))
    got = quantize.calibrate(tspec, tfolded, torch.from_numpy(frames))
    assert sorted(got) == sorted(want)
    # f32 convs on the CPU in both frameworks, summed in other orders
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_quantized_leaves_bit_equal_to_jax(darknet_case):
    """Given the JAX package's folded weights (through ``from_jax``) and the
    same amax, every quantized leaf is bit-equal: int8 weights, f32 scales,
    biases and input-scale inverses, bf16 pre-yolo convs."""
    _, (spec, tspec), jfolded, tfolded, frames = darknet_case
    amax = jquantize.calibrate(spec, jfolded, jnp.asarray(frames))
    want = convert.quantized_from_jax(
        to_numpy(jquantize.quantize_params(spec, jfolded, amax)))
    _assert_trees_equal(quantize.quantize_params(tspec, tfolded, amax), want)


def test_quantize_params_needs_every_amax(darknet_case):
    _, (_, tspec), _, tfolded, _ = darknet_case
    with pytest.raises(KeyError, match="amax missing"):
        quantize.quantize_params(tspec, tfolded, {})


def test_rektnet_calibrate_and_leaves_match_jax(rektnet_case):
    jfolded, tfolded, crops = rektnet_case
    want_amax = jquantize.calibrate_rektnet(jfolded, jnp.asarray(crops))
    got_amax = quantize.calibrate_rektnet(tfolded, torch.from_numpy(crops))
    assert sorted(got_amax) == sorted(want_amax)
    for k in want_amax:  # f32 convs summed in other orders
        assert got_amax[k] == pytest.approx(want_amax[k], rel=1e-5), k
    want = convert.quantized_from_jax(
        to_numpy(jquantize.quantize_rektnet_params(jfolded, want_amax)))
    _assert_trees_equal(quantize.quantize_rektnet_params(tfolded, want_amax),
                        want)


@pytest.mark.parametrize("k,stride,padding,dilation,cin,cout", [
    (3, 1, 1, 1, 32, 64),                # Darknet 3×3
    (3, 2, 1, 1, 3, 32),                 # K = 27, padded to 32
    (7, 1, 3, 1, 3, 16),                 # RektNet stem, K = 147 → 152
    (3, 1, 2, 2, 16, 24),                # RektNet conv1, dilation 2
    (1, 1, 0, 1, 64, 32),                # 1×1, no im2col
    (2, 1, ((1, 0), (1, 0)), 1, 128, 64),  # conv2p, top/left padding only
    (4, 2, 1, 1, 3, 12),                 # the entry's 4×4/s2 conv1
])
def test_int_conv_exact_against_float64(k, stride, padding, dilation, cin,
                                        cout):
    """im2col + ``torch._int_mm`` equals a float64 convolution (exact:
    every partial sum is an integer below 2^53)."""
    rng = np.random.default_rng(k * 10 + stride)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 13, 11, cin),
                                      dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k),
                                      dtype=np.int8))
    got = _int_conv(x, _weight_matrix(w), cout, k, k, stride, padding,
                    dilation)
    (pt, pb), (pl, pr) = quantize._pairs(padding)
    xp = torch.nn.functional.pad(x.double().permute(0, 3, 1, 2),
                                 (pl, pr, pt, pb))
    want = torch.nn.functional.conv2d(xp, w.double(), stride=stride,
                                      dilation=dilation).permute(0, 2, 3, 1)
    assert got.dtype == torch.int32
    assert torch.equal(got, want.to(torch.int32))


def test_qconv_matches_jax():
    """One int8 conv (quantize, int conv, dequant, bf16) on identical
    leaves: bit-equal to the JAX package's ``_qconv``."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 3, 16, 32)).astype(np.float32) * 0.2
    b = rng.standard_normal(32).astype(np.float32) * 0.1
    x = rng.normal(0, 1, (2, 9, 9, 16)).astype(np.float32)
    jq = jquantize._quantize_conv(jnp.asarray(w), jnp.asarray(b), 3.0)
    want = np.asarray(jquantize._qconv(jnp.asarray(x), jq, 2, 1,
                                       jnp.bfloat16).astype(jnp.float32))
    q = QConv(convert.quantized_from_jax(to_numpy(jq)), stride=2, padding=1)
    got = _qconv(torch.from_numpy(x), q)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_int8_darknet_heads_match_jax(darknet_case):
    """``Int8Darknet`` on identical leaves vs ``forward_features_int8``:
    correlation > 0.999 per head (±1 int8 steps from XLA's rounding may
    propagate), on the plain path and, for the entry cfg, the fused one."""
    name, (spec, tspec), jfolded, _, frames = darknet_case
    amax = jquantize.calibrate(spec, jfolded, jnp.asarray(frames))
    yolo_q = jquantize.quantize_params(spec, jfolded, amax)
    entries = [None] + ([jentry.quantize_entry(jfolded, amax)]
                        if name == "entry" else [])
    for entry_q in entries:
        want = jquantize.forward_features_int8(
            spec, yolo_q, jnp.asarray(frames), entry_q=entry_q)
        model = quantize.Int8Darknet(
            tspec, convert.quantized_from_jax(to_numpy(yolo_q)),
            None if entry_q is None else
            convert.quantized_from_jax(to_numpy(entry_q)))
        assert (model.entry is None) == (entry_q is None)
        with torch.inference_mode():
            got = model.forward_features(torch.from_numpy(frames))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            w = np.asarray(w, np.float32)
            assert g.dtype == torch.bfloat16 and g.shape == w.shape
            assert np.corrcoef(g.float().numpy().ravel(),
                               w.ravel())[0, 1] > 0.999


def test_int8_darknet_detections_decode_in_f32(darknet_case):
    name, (_, spec), _, tfolded, frames = darknet_case
    amax = quantize.calibrate(spec, tfolded, frames)
    entry_q = entry.quantize_entry(tfolded, amax) if name == "entry" else None
    model = quantize.Int8Darknet(spec, quantize.quantize_params(
        spec, tfolded, amax), entry_q)
    with torch.inference_mode():
        dets = model.detections(torch.from_numpy(frames))
    assert dets.dtype == torch.float32 and bool(torch.isfinite(dets).all())
    assert model.frame_dtype == torch.bfloat16
    assert list(model.parameters()) == []  # int8 weights are buffers


def test_int8_darknet_refuses_entry_on_other_specs():
    spec = tiny_port_spec()  # a maxpool stem: not the YOLOv3 entry
    rng = np.random.default_rng(2)
    yp, ys = convert.init_darknet_np(spec, rng)
    folded = darknet.fold_bn(convert.from_jax(yp), convert.from_jax(ys), spec)
    amax = quantize.calibrate(spec, folded,
                              rng.uniform(0, 1, (1, 64, 64, 3)))
    bogus = {"w2": torch.zeros((4, 128, 64), dtype=torch.int8)}
    with pytest.raises(ValueError, match="entry pattern"):
        quantize.Int8Darknet(spec, quantize.quantize_params(
            spec, folded, amax), bogus)


def test_int8_rektnet_matches_jax(rektnet_case):
    """``Int8RektNet`` vs ``apply_rektnet_int8`` on identical leaves and
    bf16 crops: the int8 convs are exact, the f32 head sums in another
    order — points within 1e-5 of the [0, 1) crop, probs within 1e-7."""
    jfolded, _, crops = rektnet_case
    rq = jquantize.quantize_rektnet_params(
        jfolded, jquantize.calibrate_rektnet(jfolded, jnp.asarray(crops)))
    x = jnp.asarray(crops, jnp.bfloat16)
    jprobs, jpts = jquantize.apply_rektnet_int8(rq, x)
    model = quantize.Int8RektNet(convert.quantized_from_jax(to_numpy(rq)))
    with torch.inference_mode():
        probs, pts = model(torch.from_numpy(crops).to(torch.bfloat16))
    assert probs.shape == (3, 7, 80, 80) and pts.shape == (3, 7, 2)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-7)


def test_quantized_from_jax_keeps_dtypes():
    tree = {"a": {"wq": np.arange(24, dtype=np.int8).reshape(1, 2, 3, 4),
                  "sx_inv": np.float32(0.5)},
            "w2": np.ones((4, 128, 64), np.int8),
            "h": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))}
    out = convert.quantized_from_jax(tree)
    assert out["a"]["wq"].dtype == torch.int8
    assert out["a"]["wq"].shape == (4, 3, 1, 2)  # HWIO → OIHW
    assert out["a"]["sx_inv"].shape == () and float(out["a"]["sx_inv"]) == 0.5
    assert out["w2"].shape == (4, 128, 64)       # K4 layouts as they are
    assert out["h"].dtype == torch.bfloat16
    assert out["h"].tolist() == [1.5, -2.25]
