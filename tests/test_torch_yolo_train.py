"""YOLO training in the port (``models/darknet.py``: ``init_params``,
``TrainDarknet``; ``train/steps.py``: ``yolo_train_step``,
``yolo_eval_step``) against the JAX package on the CPU, from the same numpy
trees (``convert.init_darknet_np``: random BN statistics) and synthetic
scenes: ``tests/fixtures/tiny_test.cfg`` at 64², B=4.

Tolerances. f32: convolutions summed in other orders (oneDNN against
XLA's Eigen) and XLA's own ``exp``/``log1p`` in the loss: heads within
1e-5 of their scale, the loss and its components within 1e-5 relative
(1e-7 absolute), batch statistics within 1e-5 of their scale. Gradients
are sums over ill-conditioned BN backward passes: held to 1e-3 of the
largest gradient, and an SGD update to lr·1e-3 of it. Adam's first step is
lr·g/(|g| + eps) ≈ lr·sign(g): a parameter whose JAX gradient lies within
that 1e-3 bound may step either way, so it is held to 2·lr; the others to
1e-3·lr, and the moments to the gradients' bound. bf16: XLA:CPU keeps
chains of bf16 elementwise ops in f32 and the two autodiffs round their
bf16 intermediates at other points, so bf16 is held in aggregate: loss
within 1e-2 relative, the gradients' direction (cosine ≥ 0.97), every
updated parameter within one SGD step of the largest gradient, batch
statistics within 1e-2 of their scale. The eval forward (unfolded, f32)
and the folded serving forward: detections within 1e-4 relative plus 1e-3
absolute (box pixels reach 64). Full width (YOLOv3-416, one class, B=1,
one f32 SGD step; ~20 s for both packages): the loss within 1e-5
relative, batch statistics within 1e-4 of their scale; 75 convolutions
deep, the gradients of the first layers are the least certain: against a
float64 evaluation of this step the port's sit up to 1.1e-3 of the
largest gradient away and JAX's up to 2.2e-3 (2.4e-3 between them), so
each parameter's update is held within 5e-3 of the largest update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.config.flagship import (
    flagship_spec as jflagship_spec,
)
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu.models.yolo_loss import yolo_loss as j_yolo_loss
from mit_driverless_cv_traininginfra_tpu.train import optim as joptim
from mit_driverless_cv_traininginfra_tpu.train import steps as jsteps
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet
from mit_driverless_cv_traininginfra_tpu_torch.train import optim, steps

from _torch_port import tiny_port_spec, tiny_spec, to_jnp

B, LR = 4, 0.01
LOSS_KW = dict(xy_loss=2.0, wh_loss=1.6, object_loss=0.1, no_object_loss=25.0)


@pytest.fixture(scope="module")
def case():
    """Seeded JAX-layout trees of the tiny cfg, B synthetic 64² scenes and
    their targets, as numpy; both packages' specs."""
    spec, tspec = tiny_spec(), tiny_port_spec()
    rng = np.random.default_rng(0)
    yp, ys = convert.init_darknet_np(tspec, rng)
    imgs, targets = synthetic.yolo_batch(rng, B, 64, min_h=8, max_h=30)
    return spec, tspec, yp, ys, imgs, targets


def _model(tspec, yp, ys):
    return darknet.TrainDarknet(tspec, convert.from_jax(yp), convert.from_jax(ys))


def _flat(tree):
    """{'<block>/<key>/...': numpy} of a port tree, in the JAX layout."""
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(convert.to_jax(tree))[0]}


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
    return _flat(tree)


def _jflat(tree):
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_init_params_keys_and_shapes():
    spec, tspec = tiny_spec(), tiny_port_spec()
    params, state = darknet.init_params(tspec, torch.Generator().manual_seed(0))
    jp, js = jax.jit(lambda key: jdarknet.init_params(spec, key))(jax.random.PRNGKey(0))
    got, want = _flat(params), _jflat(jp)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    assert _flat(state).keys() == _jflat(js).keys()
    for k, v in _jflat(js).items():
        np.testing.assert_array_equal(_flat(state)[k], v)
    for k, v in want.items():
        if not k.endswith("/w"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # He-normal: std sqrt(2 / (k·k·cin)); block 5 is 3×3 from 16 channels
    w = params["5"]["w"]
    assert abs(float(w.std()) - (2 / (9 * 16)) ** 0.5) < 0.02


def test_train_forward_heads_and_bn_state(case):
    spec, tspec, yp, ys, imgs, _ = case
    model = _model(tspec, yp, ys)
    with torch.no_grad():
        heads = model.forward_features(torch.from_numpy(imgs), train=True)
    jheads, jstate = jax.jit(lambda p, s, x: jdarknet.forward_features(
        spec, p, s, x, train=True))(to_jnp(yp), to_jnp(ys), jnp.asarray(imgs))
    assert len(heads) == len(jheads) == 2
    for h, jh in zip(heads, jheads):
        jh = np.asarray(jh)
        np.testing.assert_allclose(h.numpy(), jh, rtol=0, atol=1e-5 * np.abs(jh).max())
    _, state = model.trees()
    for k, want in _jflat(jstate).items():
        np.testing.assert_allclose(_flat(state)[k], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def _jax_step(spec, yp, ys, imgs, targets, kind, dtype):
    """JAX's gradients (``jax.grad`` of the step's own loss function) and
    its ``yolo_train_step`` with ``kind`` (no momentum): ``(grads, state
    after, loss, components)``."""
    cdt = jnp.dtype(dtype)
    jp, js = to_jnp(yp), to_jnp(ys)

    def loss_fn(params):
        p = (jax.tree_util.tree_map(lambda v: v.astype(cdt), params)
             if cdt != jnp.float32 else params)
        heads, _ = jdarknet.forward_features(spec, p, js, jnp.asarray(imgs).astype(cdt),
                                             train=True)
        heads = [h.astype(jnp.float32) for h in heads]
        return j_yolo_loss(spec, heads, jnp.asarray(targets), **LOSS_KW)[0]

    grads = jax.jit(jax.grad(loss_fn))(jp)
    tx = joptim.make_optimizer(kind, lr=LR, momentum=0.0)
    ts, loss, comps = jsteps.yolo_train_step(
        spec, tx, jsteps.init_train_state(jp, js, tx), jnp.asarray(imgs),
        jnp.asarray(targets), compute_dtype=dtype, **LOSS_KW)
    return grads, ts, loss, comps


@pytest.mark.parametrize("kind,dtype", [("SGD", "float32"), ("Adam", "float32"),
                                        ("SGD", "bfloat16")])
def test_train_step_matches_jax(case, kind, dtype):
    spec, tspec, yp, ys, imgs, targets = case
    jgrads, jts, jloss, jcomps = _jax_step(spec, yp, ys, imgs, targets, kind, dtype)
    model = _model(tspec, yp, ys)
    opt = optim.make_optimizer(model.parameters(), kind, lr=LR, momentum=0.0)
    loss, comps = steps.yolo_train_step(model, opt, torch.from_numpy(imgs),
                                        torch.from_numpy(targets),
                                        compute_dtype=dtype, **LOSS_KW)
    f32 = dtype == "float32"
    assert loss.dtype == comps.dtype == torch.float32 and comps.shape == (6,)
    assert not loss.requires_grad
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5 if f32 else 1e-2)
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps),
                               rtol=1e-5 if f32 else 2e-2, atol=1e-7 if f32 else 1e-4)

    jg, got_g = _jflat(jgrads), _grads(model)
    gmax = max(float(np.abs(g).max()) for g in jg.values())
    params, state = model.trees()
    got_p, want_p = _flat(params), _jflat(jts.params)
    before = _jflat(to_jnp(yp))
    for name, want in jg.items():
        if f32:
            np.testing.assert_allclose(got_g[name], want, rtol=0, atol=1e-3 * gmax,
                                       err_msg=name)
        if kind == "SGD":
            atol = LR * (1e-3 if f32 else 1.0) * gmax + 1e-7
            np.testing.assert_allclose(got_p[name], want_p[name], rtol=0, atol=atol,
                                       err_msg=name)
        else:
            # Adam's first step: lr·sign(g) where |g| ≫ eps
            near_zero = np.abs(want) <= 1e-3 * gmax
            diff = np.abs(got_p[name] - want_p[name])
            assert diff[near_zero].max(initial=0) <= 2 * LR + 1e-6, name
            assert diff[~near_zero].max(initial=0) <= 1e-3 * LR + 1e-6, name
            np.testing.assert_allclose(got_p[name] - before[name],
                                       want_p[name] - before[name], rtol=0,
                                       atol=2 * LR + 1e-6)
    if not f32:
        a = np.concatenate([jg[n].ravel() for n in jg]).astype(np.float64)
        b = np.concatenate([got_g[n].ravel() for n in jg])
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.97
    for name, want in _jflat(jts.model_state).items():
        np.testing.assert_allclose(_flat(state)[name], want, rtol=0,
                                   atol=(1e-5 if f32 else 1e-2) * np.abs(want).max(),
                                   err_msg=name)
    if kind == "Adam":
        st = opt.state_dict()["state"]
        named = [n for n, _ in model.named_parameters()]
        assert len(st) == len(named) and all(float(s["step"]) == 1 for s in st.values())


def test_eval_step_and_detections_match_jax(case):
    spec, tspec, yp, ys, imgs, targets = case
    model = _model(tspec, yp, ys)
    x = torch.from_numpy(imgs)
    loss, comps = steps.yolo_eval_step(model, x, torch.from_numpy(targets), **LOSS_KW)
    jloss, jcomps = jsteps.yolo_eval_step(spec, to_jnp(yp), to_jnp(ys),
                                          jnp.asarray(imgs), jnp.asarray(targets),
                                          **LOSS_KW)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    np.testing.assert_allclose(comps.numpy(), np.asarray(jcomps), rtol=1e-5, atol=1e-7)
    _, state = model.trees()  # eval leaves the running stats alone
    for name, want in _flat(convert.from_jax(ys)).items():
        np.testing.assert_array_equal(_flat(state)[name], want)

    with torch.no_grad():
        dets = model.detections(x)
        served = darknet.Darknet(tspec, model.folded()).detections(x)
    jdetect = jax.jit(lambda p, s, x: jdarknet.detections(spec, p, s, x))
    jdets = np.asarray(jdetect(to_jnp(yp), to_jnp(ys), jnp.asarray(imgs)))
    jfolded = jdarknet.fold_bn(to_jnp(yp), to_jnp(ys), spec)
    jserved = np.asarray(jdetect(jfolded, {}, jnp.asarray(imgs)))
    assert dets.shape == jdets.shape and dets.dtype == torch.float32
    np.testing.assert_allclose(dets.numpy(), jdets, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(served.numpy(), jserved, rtol=1e-4, atol=1e-3)


def test_bf16_forward_casts_and_returns_bf16_heads(case):
    _, tspec, yp, ys, imgs, _ = case
    model = _model(tspec, yp, ys)
    with torch.no_grad():
        heads = model.forward_features(torch.from_numpy(imgs), train=True,
                                       dtype=torch.bfloat16)
    assert all(h.dtype == torch.bfloat16 for h in heads)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.frame_dtype == torch.float32
    # no state of the call lingers: the next forward is eval f32 and leaves
    # the running stats as they are
    _, state = model.trees()
    with torch.no_grad():
        heads = model.forward_features(torch.from_numpy(imgs))
    assert all(h.dtype == torch.float32 for h in heads)
    for key, st in model.trees()[1].items():
        for k in ("mean", "var"):
            assert torch.equal(st[k], state[key][k])


def test_full_width_step_matches_jax():
    """One f32 SGD step of YOLOv3-416 (one class) at B=1 in both packages
    from the same numpy trees and scene."""
    spec, tspec = jflagship_spec(416, classes=1), flagship_spec(416, classes=1)
    rng = np.random.default_rng(7)
    yp, ys = convert.init_darknet_np(tspec, rng)
    imgs, targets = synthetic.yolo_batch(rng, 1, 416)
    tx = joptim.make_optimizer("SGD", lr=LR, momentum=0.0)
    jts, jloss, _ = jsteps.yolo_train_step(
        spec, tx, jsteps.init_train_state(to_jnp(yp), to_jnp(ys), tx),
        jnp.asarray(imgs), jnp.asarray(targets), **LOSS_KW)
    model = _model(tspec, yp, ys)
    opt = optim.make_optimizer(model.parameters(), "SGD", lr=LR, momentum=0.0)
    loss, _ = steps.yolo_train_step(model, opt, torch.from_numpy(imgs),
                                    torch.from_numpy(targets), **LOSS_KW)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    params, state = model.trees()
    before, got, want = _jflat(to_jnp(yp)), _flat(params), _jflat(jts.params)
    scale = max(float(np.abs(want[k] - before[k]).max()) for k in want)
    for k in want:
        np.testing.assert_allclose(got[k] - before[k], want[k] - before[k], rtol=0,
                                   atol=5e-3 * scale, err_msg=k)
    for k, w in _jflat(jts.model_state).items():
        np.testing.assert_allclose(_flat(state)[k], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
