"""The port's packed space-to-depth stem (``models/stem_opt.py`` and its
users in ``models/darknet.py``, ``models/quantize.py``, ``train/steps.py``)
against the JAX package's ``models/stem_opt.py``, on the CPU, on
``tests/fixtures/tiny_test.cfg`` (64², a packable stem: 3×3 s1 to 8
channels, 3×3 s2 to 16) from one numpy init, B=2.

Tolerances. The packing and the weight maps are copies: bit-equal. The
packed weights' gradients reach ``w2`` exactly (a slot each) and ``w1``
as the sum of its four phases' slots (rtol 1e-6: the two packages add
the four in their own orders). The
packed stem's f32 convolutions sum in other orders than XLA's: blocks 0-1
within JAX's own ``atol=2e-5`` (``tests/test_stem_opt.py``), the folded
detections as the eval forward of ``test_torch_yolo_train.py`` (1e-4
relative plus 1e-3 absolute). Training through the packed stem takes
``tests/test_stem_opt.py``'s bounds: the stem and its running stats within
1e-5, heads and running stats within 2e-3, each gradient leaf within
5e-3 of its largest value plus 2e-4; the one SGD step within
``test_torch_parallel.py``'s (loss rtol 1e-5, parameters lr·1e-3·gmax
+ 1e-7, running stats 1e-5 of their largest value). int8: the packed stem's bundle
bit-equal to JAX's; the int8 detector with it on identical integers,
the JAX side under ``jax.disable_jit()``, its detections held at
``test_torch_pipeline_int8.py``'s box bound (rtol 1e-5, atol 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    tiny_port_spec,
    tiny_spec,
    to_jnp,
    to_numpy,
)
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu.models import quantize as jquantize
from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu.models import stem_opt as jstem
from mit_driverless_cv_traininginfra_tpu.train import optim as joptim
from mit_driverless_cv_traininginfra_tpu.train import steps as jsteps
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, quantize, stem_opt
from mit_driverless_cv_traininginfra_tpu_torch.train import optim, steps

B, SLOPE, LR = 2, 0.1, 0.01
LOSS_KW = dict(xy_loss=2.0, wh_loss=1.6, object_loss=0.1, no_object_loss=25.0)


@pytest.fixture(scope="module")
def case():
    """Both specs, seeded JAX-layout trees, B scenes and their targets."""
    spec, tspec = tiny_spec(), tiny_port_spec()
    rng = np.random.default_rng(0)
    yp, ys = convert.init_darknet_np(tspec, rng)
    imgs, targets = synthetic.yolo_batch(rng, B, 64, min_h=8, max_h=30)
    return spec, tspec, yp, ys, imgs, targets


@pytest.fixture(scope="module")
def folded(case):
    """JAX's folded tree and its packed stem, and the same tree in the port."""
    spec, _, yp, ys, _, _ = case
    jfolded = jdarknet.fold_bn(to_jnp(yp), to_jnp(ys), spec)
    return jfolded, jstem.build_packed_stem(jfolded), convert.from_jax(to_numpy(jfolded))


def test_stem_is_packable_matches_jax(case):
    spec, tspec = case[:2]
    assert stem_opt.stem_is_packable(tspec) and jstem.stem_is_packable(spec)
    odd = dataclasses.replace(tspec, net=dataclasses.replace(tspec.net, width=66 + 1))
    assert not stem_opt.stem_is_packable(odd)
    swapped = dataclasses.replace(tspec, blocks=(tspec.blocks[1], tspec.blocks[0],
                                                 *tspec.blocks[2:]))
    assert not stem_opt.stem_is_packable(swapped)


def test_pack_input_bit_equal(case):
    x = np.random.default_rng(1).normal(size=(B, 8, 6, 5)).astype(np.float32)
    got = stem_opt.pack_input(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jstem.pack_input(jnp.asarray(x))))
    assert got.shape == (B, 4, 3, 20)


def test_packed_weights_bit_equal(case, folded):
    """``build_packed_stem`` on the folded tree and ``pack_stem_weights`` on
    the raw one, each bit-equal to JAX's after the HWIO → OIHW map."""
    _, _, yp, _, _, _ = case
    jfolded, jpacked, tfolded = folded
    got = convert.to_jax(stem_opt.build_packed_stem(tfolded))
    for k, v in to_numpy(jpacked).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    t = convert.from_jax(yp)
    w1p, w2p = stem_opt.pack_stem_weights(t["0"]["w"], t["1"]["w"])
    jw1p, jw2p = jstem.pack_stem_weights_jnp(jnp.asarray(yp["0"]["w"]),
                                             jnp.asarray(yp["1"]["w"]))
    got = convert.to_jax({"w1": w1p, "w2": w2p})
    np.testing.assert_array_equal(got["w1"], np.asarray(jw1p))
    np.testing.assert_array_equal(got["w2"], np.asarray(jw2p))


def test_packed_weights_gradient_is_exact(case):
    """The gradient of ⟨R, pack(w)⟩ is R read back at each weight's slots:
    equal to ``jax.grad`` through ``pack_stem_weights_jnp``, bit for bit
    for ``w2`` (one slot a weight), within the rounding of a four-term sum
    for ``w1`` (a slot in each output phase)."""
    _, _, yp, _, _, _ = case
    rng = np.random.default_rng(2)
    t = convert.from_jax(yp)
    w1 = t["0"]["w"].clone().requires_grad_(True)
    w2 = t["1"]["w"].clone().requires_grad_(True)
    w1p, w2p = stem_opt.pack_stem_weights(w1, w2)
    r1 = rng.normal(size=w1p.shape).astype(np.float32)
    r2 = rng.normal(size=w2p.shape).astype(np.float32)
    ((w1p * torch.from_numpy(r1)).sum() + (w2p * torch.from_numpy(r2)).sum()).backward()
    jr1, jr2 = (jnp.asarray(r.transpose(2, 3, 1, 0)) for r in (r1, r2))

    def inner(a, b):
        p, q = jstem.pack_stem_weights_jnp(a, b)
        return jnp.sum(p * jr1) + jnp.sum(q * jr2)

    g1, g2 = jax.grad(inner, argnums=(0, 1))(jnp.asarray(yp["0"]["w"]),
                                             jnp.asarray(yp["1"]["w"]))
    got = convert.to_jax({"w1": w1.grad, "w2": w2.grad})
    np.testing.assert_allclose(got["w1"], np.asarray(g1), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got["w2"], np.asarray(g2))
    # each w1 gradient is its four slots' R, each w2 gradient its one slot's
    w1r = np.zeros(w1.shape, np.float64)
    idx1, idx2 = stem_opt._pack_index(3, 8, 16, torch.device("cpu"))
    np.add.at(w1r.reshape(-1), idx1.numpy().ravel()[idx1.numpy().ravel() < w1.numel()],
              r1.ravel()[idx1.numpy().ravel() < w1.numel()])
    np.testing.assert_allclose(w1.grad.numpy(), w1r, rtol=1e-6, atol=1e-6)
    assert np.bincount(idx1.numpy().ravel(), minlength=w1.numel() + 1)[:-1].tolist() \
        == [4] * w1.numel()
    assert np.bincount(idx2.numpy().ravel(), minlength=w2.numel() + 1)[:-1].tolist() \
        == [1] * w2.numel()


def test_apply_packed_stem_and_plain_blocks_match_jax(case, folded):
    spec, tspec, _, _, imgs, _ = case
    jfolded, jpacked, tfolded = folded
    x = torch.from_numpy(imgs)
    packed = stem_opt.build_packed_stem(tfolded)
    with torch.no_grad():
        got = stem_opt.apply_packed_stem(packed, x, SLOPE)
        plain = darknet.Darknet(tspec, tfolded).truncated_forward(x, 1)
        via_model = darknet.Darknet(tspec, tfolded, packed).truncated_forward(x, 1)
    want = np.asarray(jstem.apply_packed_stem(jpacked, jnp.asarray(imgs), SLOPE))
    jplain = jnp.asarray(imgs)
    for i in (0, 1):
        b = spec.blocks[i]
        jplain = jdarknet._leaky(jrektnet.conv2d(jplain, jfolded[str(i)]["w"],
                                                 jfolded[str(i)]["b"], b.stride, 1), SLOPE)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jplain), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jplain), rtol=0, atol=2e-5)
    assert torch.equal(via_model, got)


def test_packed_detections_match_jax(case, folded):
    spec, tspec, _, _, imgs, _ = case
    jfolded, jpacked, tfolded = folded
    model = darknet.Darknet(tspec, tfolded, stem_opt.build_packed_stem(tfolded))
    assert set(model.convs) == {k for k in tfolded if k not in ("0", "1")}
    with torch.no_grad():
        got = model.detections(torch.from_numpy(imgs))
    want = jdarknet.detections(spec, jfolded, {}, jnp.asarray(imgs), packed_stem=jpacked)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


def _model(tspec, yp, ys):
    return darknet.TrainDarknet(tspec, convert.from_jax(yp), convert.from_jax(ys))


def _jflat(tree):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _grads(model):
    """The port's gradients as a JAX-layout flat dict."""
    tree = {}
    for key, m in model.convs.items():
        g = {"w": m.weight.grad}
        if hasattr(m, "bn"):
            g["bn"] = {"scale": m.bn.weight.grad, "bias": m.bn.bias.grad}
        else:
            g["b"] = m.bias.grad
        tree[key] = g
    return _jflat(convert.to_jax(tree))


def test_packed_train_forward_stats_and_gradients_match_jax(case):
    """``forward_features(train=True, packed_stem=True)`` against JAX's
    ``train_packed_stem=True``: the heads, every running-stat update, and
    the gradients of Σ mean(h²)."""
    spec, tspec, yp, ys, imgs, _ = case
    model = _model(tspec, yp, ys)
    heads = model.forward_features(torch.from_numpy(imgs), train=True, packed_stem=True)
    sum(torch.mean(h ** 2) for h in heads).backward()

    def loss(p):
        hs, new_state = jdarknet.forward_features(spec, p, to_jnp(ys), jnp.asarray(imgs),
                                                  train=True, train_packed_stem=True)
        return sum(jnp.mean(h ** 2) for h in hs), (hs, new_state)

    jg, (jheads, jstate) = jax.jit(jax.grad(loss, has_aux=True))(to_jnp(yp))
    for h, jh in zip(heads, jheads):
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=2e-3, atol=2e-3)
    got_state = _jflat(convert.to_jax(model.trees()[1]))
    for k, v in _jflat(jstate).items():
        bound = (dict(rtol=1e-5, atol=1e-6) if k.split("/")[0] in ("0", "1")
                 else dict(rtol=2e-3, atol=2e-3))
        np.testing.assert_allclose(got_state[k], v, err_msg=k, **bound)
    got = _grads(model)
    for k, v in _jflat(jg).items():
        scale = float(np.abs(v).max()) + 1e-12
        assert float(np.abs(got[k] - v).max()) <= 5e-3 * scale + 2e-4, k


def test_packed_stem_train_step_matches_jax(case):
    """One f32 SGD ``yolo_train_step(packed_stem=True)`` against JAX's."""
    spec, tspec, yp, ys, imgs, targets = case
    model = _model(tspec, yp, ys)
    opt = optim.make_optimizer(model.parameters(), "SGD", lr=LR)
    loss, comps = steps.yolo_train_step(model, opt, torch.from_numpy(imgs),
                                        torch.from_numpy(targets), packed_stem=True,
                                        **LOSS_KW)
    tx = joptim.make_optimizer("SGD", lr=LR, momentum=0.0)
    ts = jsteps.init_train_state(to_jnp(yp), to_jnp(ys), tx)
    ts, jloss, jcomps = jsteps.yolo_train_step(spec, tx, ts, jnp.asarray(imgs),
                                               jnp.asarray(targets), packed_stem=True,
                                               **LOSS_KW)
    np.testing.assert_allclose(np.r_[float(loss), comps.numpy()],
                               np.r_[float(jloss), np.asarray(jcomps)], rtol=1e-5, atol=1e-7)
    params, state = (_jflat(convert.to_jax(t)) for t in model.trees())
    before = _jflat(yp)
    want = _jflat(ts.params)
    lr_gmax = max(float(np.abs(want[k] - before[k]).max()) for k in want)
    for k, v in want.items():
        np.testing.assert_allclose(params[k], v, rtol=0, atol=1e-3 * lr_gmax + 1e-7,
                                   err_msg=k)
    for k, v in _jflat(ts.model_state).items():
        np.testing.assert_allclose(state[k], v, rtol=0, atol=1e-5 * np.abs(v).max(),
                                   err_msg=k)


def test_packed_stem_refuses_tensor_parallel_and_spatial(case):
    _, tspec, yp, ys, imgs, _ = case
    model = _model(tspec, yp, ys)
    model.convs["0"].split = object()   # as a model_mesh block would be
    with pytest.raises(ValueError, match="tensor parallel"):
        model.forward_features(torch.from_numpy(imgs), packed_stem=True)
    model.convs["0"].split = None
    with pytest.raises(ValueError, match="spatial"):
        model.forward_features(torch.from_numpy(imgs), packed_stem=True,
                               spatial=object())


def test_int8_packed_stem_matches_jax(case, folded):
    """``Int8Darknet(stem_q=)`` against JAX's ``detections_int8`` with
    ``packed_stem_q``, on bundles quantized once in JAX and carried over:
    the int8 stem's output bit-equal to JAX's ops run one by one (exact
    int32 sums, the same two f32 roundings), the decoded detections at the
    int8 pipeline's box bound."""
    spec, tspec, *_ = case
    jfolded, jpacked, _ = folded
    frames_u8 = np.random.default_rng(5).integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    frames = frames_u8.astype(np.float32) / 255.0
    amax = jquantize.calibrate(spec, jfolded, jnp.asarray(frames))
    yolo_q = jquantize.quantize_params(spec, jfolded, amax)
    stem_q = jquantize.quantize_packed_stem(jpacked, amax)
    yolo = quantize.Int8Darknet(tspec, convert.quantized_from_jax(to_numpy(yolo_q)),
                                stem_q=convert.quantized_from_jax(to_numpy(stem_q)))
    assert yolo.stem is not None and not {"0", "1"} & set(yolo.convs)
    with torch.inference_mode():
        stem = yolo.truncated_forward(torch.from_numpy(frames), 1)
        got = yolo.detections(torch.from_numpy(frames), with_classes=False)
    with jax.disable_jit():
        x = jstem.pack_input(jnp.asarray(frames, jnp.bfloat16))
        h = jdarknet._leaky(jquantize._qconv(x, stem_q["c1"], 1, 1, jnp.bfloat16), SLOPE)
        jstem_out = jdarknet._leaky(jquantize._qconv(h, stem_q["c2"], 1, [(1, 0), (1, 0)],
                                                     jnp.bfloat16), SLOPE)
        want = jquantize.detections_int8(spec, yolo_q, jnp.asarray(frames),
                                         packed_stem_q=stem_q, with_classes=False)
    np.testing.assert_array_equal(stem.float().numpy(),
                                  np.asarray(jstem_out, np.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_quantize_packed_stem_bit_equal_to_jax(case, folded):
    spec = case[0]
    jfolded, jpacked, tfolded = folded
    frames = np.random.default_rng(6).uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)
    amax = jquantize.calibrate(spec, jfolded, jnp.asarray(frames))
    got = quantize.quantize_packed_stem(stem_opt.build_packed_stem(tfolded), amax)
    want = convert.quantized_from_jax(to_numpy(jquantize.quantize_packed_stem(jpacked, amax)))
    for conv in ("c1", "c2"):
        for k, v in want[conv].items():
            assert got[conv][k].dtype == v.dtype and torch.equal(got[conv][k], v), (conv, k)
