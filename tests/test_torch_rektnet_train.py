"""RektNet training in the port (``models/rektnet.py`` training half,
``models/cross_ratio_loss.py``, ``ops/heatmap.py``, ``train/optim.py``,
``train/steps.py``) against the JAX package on the CPU, from the same numpy
parameters and crops (net_size 4, B=4, 80×80).

Tolerances. f32: convolutions summed in other orders (oneDNN against
XLA's Eigen) move the loss by ≤ 2e-5 relative and batch statistics by
≤ 1e-5 of their scale. The f32 gradients are ill-conditioned sums: against
a float64 evaluation both packages are off by up to ~5e-4 of the largest
gradient (the port never more than JAX), so they are held to 1e-3 of it.
bf16:
XLA:CPU keeps chains of bf16 elementwise ops in f32 (its default excess
precision; with ``--xla_allow_excess_precision=false`` the two forwards
agree bit for bit on these inputs), and the two autodiffs round their bf16
backward intermediates at different points, so bf16 is held in aggregate:
loss within 1e-2, the gradients' overall direction (cosine ≥ 0.97),
every updated parameter within one SGD step of the largest gradient, and
batch statistics within 1e-2. The pre-BN conv biases and the output bias
have a true gradient of 0 (BN removes the mean; soft-argmax ignores a
shift of all logits): theirs is rounding noise and is held to the bounds
in absolute terms only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu.models.cross_ratio_loss import (
    _normalize as j_normalize,
    cross_ratio_loss as j_cross_ratio_loss,
)
from mit_driverless_cv_traininginfra_tpu.ops import heatmap as jheatmap
from mit_driverless_cv_traininginfra_tpu.train import optim as joptim
from mit_driverless_cv_traininginfra_tpu.train import steps as jsteps
from mit_driverless_cv_traininginfra_tpu.train.checkpoints import (
    _rektnet_param_entries,
)
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.models import cross_ratio_loss as crl
from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet
from mit_driverless_cv_traininginfra_tpu_torch.ops import heatmap
from mit_driverless_cv_traininginfra_tpu_torch.train import optim, steps

NET, B, LR = 4, 4, 0.01
GEO = dict(include_geo=True, geo_loss_gamma_horz=0.05, geo_loss_gamma_vert=0.05)


@pytest.fixture(scope="module")
def case():
    """Seeded JAX-layout trees (random BN statistics and conv biases), B
    synthetic crops and their keypoints, as numpy."""
    rng = np.random.default_rng(0)
    rp, rs = convert.init_rektnet_np(rng, net_size=NET)
    crops, pts = synthetic.rektnet_batch(rng, B)
    return rp, rs, crops, pts


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _model(rp, rs):
    return rektnet.KeypointNet(convert.from_jax(rp), convert.from_jax(rs))


def _zero_true_grad(name: str) -> bool:
    return name == "out.bias" or (name.endswith(".bias") and "conv" in name)


def test_init_trees_match_jax_structure():
    params, state = rektnet.init(torch.Generator().manual_seed(0), net_size=NET)
    jp, js = jrektnet.init(jax.random.PRNGKey(0), net_size=NET)
    flat_t = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (_, t), (_, j) in zip(flat_t, flat_j):
        shape = tuple(j.shape)
        assert tuple(t.shape) == (shape if len(shape) < 4 else
                                  (shape[3], shape[2], shape[0], shape[1]))
    assert jax.tree_util.tree_structure(state) == jax.tree_util.tree_structure(js)
    # Kaiming fan-out: std sqrt(2 / (k·k·cout)); res4.conv2 is 3×3, 32 out
    w = params["res4"]["conv2"]["w"]
    assert abs(float(w.std()) - (2 / (9 * 32)) ** 0.5) < 0.01
    assert float(params["stem"]["b"].abs().max()) == 0.0


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_jax(train, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(0.3, 2.0, (3, 5, 7, 6)).astype(np.float32)  # NHWC
    bn = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
          "bias": rng.normal(0, 0.5, 6).astype(np.float32),
          "mean": rng.normal(0, 0.5, 6).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    jy, jstats = jrektnet.batch_norm(jnp.asarray(x).astype(dtype), _jnp(bn), train)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    y, stats = rektnet.batch_norm(tx, {k: torch.from_numpy(v) for k, v in bn.items()},
                                  train)
    assert y.dtype == tx.dtype
    # f32: sums in other orders and rsqrt (≤ a few ulp); bf16: one bf16 ulp
    atol = 1e-5 if dtype == "float32" else 2 ** -6
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).float().numpy(),
                               np.asarray(jy, np.float32), rtol=2e-6, atol=atol)
    if train:
        for got, want in zip(stats, jstats):  # mean, unbiased var (f32)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        running = {"mean": torch.from_numpy(bn["mean"]).clone(),
                   "var": torch.from_numpy(bn["var"]).clone()}
        rektnet.update_running(running, stats)
        jrun = jrektnet.update_running({"mean": bn["mean"], "var": bn["var"]}, jstats)
        for k in running:
            np.testing.assert_allclose(running[k].numpy(), np.asarray(jrun[k]),
                                       rtol=1e-5)
    else:
        assert stats is None


def test_keypointnet_registers_the_reference_order(case):
    """``parameters()`` follow the reference ``KeypointNet``'s registration
    order (the order of its Adam state) and the eval forward matches the
    JAX package's ``apply``."""
    rp, rs, crops, _ = case
    model = _model(rp, rs)
    names = [k for k, _ in _rektnet_param_entries(rp)]
    assert [n for n, _ in model.named_parameters()] == names
    assert {n for n, _ in model.named_buffers()} == {
        f"{p}.{b}" for p in {n.rsplit(".", 1)[0] for n in names if "bn" in n}
        for b in ("running_mean", "running_var", "num_batches_tracked")}
    with torch.no_grad():
        probs, pts = model(torch.from_numpy(crops))
    jprobs, jpts, _ = jrektnet.apply(_jnp(rp), _jnp(rs), jnp.asarray(crops))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)


def _jax_step(rp, rs, crops, pts, loss_kw, dtype):
    """JAX's gradients (``jax.grad`` of the step's own loss function) and
    its ``rektnet_train_step`` with SGD (no momentum): ``(grads, train
    state after, total, location, geo)``."""
    cdt = jnp.dtype(dtype)
    jp, js = _jnp(rp), _jnp(rs)
    tpts = jnp.asarray(pts)
    thm = jheatmap.gaussian_heatmaps(tpts, 80, 80, sigma=1.0)

    def loss_fn(params):
        p = (jax.tree_util.tree_map(lambda v: v.astype(cdt), params)
             if cdt != jnp.float32 else params)
        hm, pp, _ = jrektnet.apply(p, js, jnp.asarray(crops).astype(cdt), train=True)
        return j_cross_ratio_loss(hm.astype(jnp.float32), pp.astype(jnp.float32),
                                     thm, tpts, **loss_kw)[2]

    grads = jax.grad(loss_fn)(jp)
    tx = joptim.make_optimizer("SGD", lr=LR, momentum=0.0)
    ts, total, loc, geo = jsteps.rektnet_train_step(
        tx, jsteps.init_train_state(jp, js, tx), jnp.asarray(crops), thm, tpts,
        compute_dtype=dtype, synth_target_sigma=1.0, **loss_kw)
    return grads, ts, total, loc, geo


# every loss type and cross_batch in f32; bf16 on the default loss (each
# case compiles JAX's step and its gradient, ~4 s apiece)
CASES = [(lt, cb, "float32") for lt in ("l1_softargmax", "l2_softargmax", "l2_heatmap")
         for cb in (True, False)] + [("l1_softargmax", True, "bfloat16")]


@pytest.mark.parametrize("loss_type,cross_batch,dtype", CASES)
def test_train_step_matches_jax(case, loss_type, cross_batch, dtype):
    rp, rs, crops, pts = case
    loss_kw = dict(loss_type=loss_type, cross_batch=cross_batch, **GEO)
    jgrads, jts, jtotal, jloc, jgeo = _jax_step(rp, rs, crops, pts, loss_kw, dtype)

    model = _model(rp, rs)
    opt = optim.make_optimizer(model.parameters(), "SGD", lr=LR, momentum=0.0)
    total, loc, geo = steps.rektnet_train_step(
        model, opt, torch.from_numpy(crops), None, torch.from_numpy(pts),
        compute_dtype=dtype, synth_target_sigma=1.0, **loss_kw)
    f32 = dtype == "float32"
    rtol = 1e-4 if f32 else 1e-2
    for got, want in ((total, jtotal), (loc, jloc), (geo, jgeo)):
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=rtol, abs=1e-7)

    named = dict(model.named_parameters())
    jg = dict(_rektnet_param_entries(jgrads))
    jp_new = dict(_rektnet_param_entries(jts.params))
    gmax = max(float(np.abs(g).max()) for g in jg.values())
    for name, want in jg.items():
        got = named[name].grad.numpy()
        if f32:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * gmax, err_msg=name)
        # one SGD step: p − lr·g; the difference is lr·Δg plus the rounding
        # of the subtraction
        atol = LR * (1e-3 if f32 else 1.0) * gmax + 1e-7
        np.testing.assert_allclose(named[name].detach().numpy(), jp_new[name],
                                   rtol=0, atol=atol, err_msg=name)
    if not f32:
        weights = [n for n in jg if not _zero_true_grad(n)]
        a = np.concatenate([jg[n].ravel() for n in weights]).astype(np.float64)
        b = np.concatenate([named[n].grad.numpy().ravel() for n in weights])
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.97

    _, state = model.trees()
    for path, want in jax.tree_util.tree_flatten_with_path(jts.model_state)[0]:
        got = state
        for key in path:
            got = got[key.key]
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=(1e-5 if f32 else 1e-2) * np.abs(want).max(),
                                   err_msg=str(path))


def test_eval_step_matches_jax(case):
    rp, rs, crops, pts = case
    model = _model(rp, rs)
    thm = heatmap.gaussian_heatmaps(torch.from_numpy(pts), 80, 80)
    total, loc, geo, pred = steps.rektnet_eval_step(
        model, torch.from_numpy(crops), thm, torch.from_numpy(pts),
        loss_type="l2_heatmap", **GEO)
    jtotal, jloc, jgeo, jpred = jsteps.rektnet_eval_step(
        _jnp(rp), _jnp(rs), jnp.asarray(crops), jnp.asarray(thm.numpy()),
        jnp.asarray(pts), loss_type="l2_heatmap", **GEO)
    assert float(total) == pytest.approx(float(jtotal), rel=1e-4)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=1e-5)
    for k in ("stem",):  # eval leaves the running stats alone
        assert torch.equal(model.bn.running_mean, torch.from_numpy(rs[k]["mean"]))


@pytest.mark.parametrize("loss_type", ["l1_sm", "l2_sm", "l2_hm"])
@pytest.mark.parametrize("cross_batch", [True, False])
def test_cross_ratio_loss_matches_jax(loss_type, cross_batch):
    rng = np.random.default_rng(2)
    p = rng.uniform(0, 1, (5, 7, 2)).astype(np.float32)
    tp = rng.uniform(0, 1, (5, 7, 2)).astype(np.float32)
    hm = rng.uniform(0, 1e-3, (5, 7, 8, 8)).astype(np.float32)
    thm = rng.uniform(0, 1e-3, (5, 7, 8, 8)).astype(np.float32)
    kw = dict(loss_type=loss_type, cross_batch=cross_batch, **GEO)
    got = crl.cross_ratio_loss(*map(torch.from_numpy, (hm, p, thm, tp)), **kw)
    want = j_cross_ratio_loss(*map(jnp.asarray, (hm, p, thm, tp)), **kw)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-5, abs=1e-8)
    no_geo = crl.cross_ratio_loss(*map(torch.from_numpy, (hm, p, thm, tp)),
                                  loss_type=loss_type, include_geo=False)
    assert float(no_geo[1]) == 0.0 and float(no_geo[2]) == float(no_geo[0])


def test_normalize_zero_vector_has_finite_gradient():
    """The double ``where``: at an exactly zero difference vector (points
    that collapsed together) the norm's gradient is 0, not the NaN of
    sqrt's backward at 0, so the gradient stays finite (1/eps through the
    numerator, as ``F.normalize`` and the JAX package give); values and
    gradients match the JAX package's ``_normalize`` (the last row squares
    to an f32 0)."""
    v = torch.tensor([[0.0, 0.0], [3.0, -4.0], [1e-30, 0.0]], requires_grad=True)
    out = crl._normalize(v)
    (out * torch.tensor([[1.0, 2.0], [0.5, -1.0], [2.0, 1.0]])).sum().backward()
    assert torch.isfinite(v.grad).all() and torch.equal(out[0], torch.zeros(2))

    def jf(x):
        return jnp.sum(j_normalize(x) * jnp.asarray([[1.0, 2.0], [0.5, -1.0],
                                                         [2.0, 1.0]]))

    jv = jnp.asarray(v.detach().numpy())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_normalize(jv)),
                               rtol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jax.grad(jf)(jv)), rtol=1e-5)


def test_gaussian_heatmaps_match_jax():
    pts = np.random.default_rng(3).uniform(0, 1, (2, 7, 2)).astype(np.float32)
    pts[0, 0] = [0.0, 1.0]  # a corner
    got = heatmap.gaussian_heatmaps(torch.from_numpy(pts), 80, 64, sigma=1.5)
    want = jheatmap.gaussian_heatmaps(jnp.asarray(pts), 80, 64, sigma=1.5)
    assert got.shape == (2, 7, 80, 64)
    # exp of the same f32 arguments, one sum over 5120 terms in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got.sum(dim=(-1, -2)).numpy(), 1.0, rtol=1e-5)


def test_keypoint_distances_match_jax():
    rng = np.random.default_rng(4)
    t, p = rng.uniform(0, 240, (2, 9, 7, 2)).astype(np.float32)
    d = heatmap.keypoint_l2_distances(torch.from_numpy(t), torch.from_numpy(p))
    jd = jheatmap.keypoint_l2_distances(t, p)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    for got, want in zip(heatmap.keypoint_distance_summary(d.numpy()),
                         jheatmap.keypoint_distance_summary(np.asarray(jd))):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tuple(heatmap.KPT_NAMES) == tuple(jheatmap.KPT_NAMES)


def test_lr_schedules_match_jax():
    for epoch in range(5):
        assert optim.step_lr(0.1, 0.5, epoch, 2) == joptim.step_lr(0.1, 0.5, epoch, 2)
        assert optim.exponential_lr(0.1, 0.999, epoch) == joptim.exponential_lr(
            0.1, 0.999, epoch)
    opt = optim.make_optimizer([torch.nn.Parameter(torch.zeros(2))], "SGD", lr=1.0)
    optim.set_lr(opt, 0.25)
    assert [g["lr"] for g in opt.param_groups] == [0.25]
    with pytest.raises(ValueError):
        optim.make_optimizer([torch.nn.Parameter(torch.zeros(1))], "RMSprop")


def test_train_step_on_cpu_takes_the_plain_kernels(case):
    """On CPU tensors the step's soft-argmax and its backward are the plain
    versions: no kernel launch is counted."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
        fused_softargmax,
        softargmax_bwd,
    )

    rp, rs, crops, pts = case
    model = _model(rp, rs)
    opt = optim.make_optimizer(model.parameters(), "Adam", lr=1e-3)
    before = (fused_softargmax.launches, softargmax_bwd.launches)
    total, _, _ = steps.rektnet_train_step(model, opt, torch.from_numpy(crops), None,
                                           torch.from_numpy(pts), **GEO,
                                           synth_target_sigma=1.0)
    assert torch.isfinite(total)
    assert (fused_softargmax.launches, softargmax_bwd.launches) == before
    assert model.conv.weight.grad is not None
