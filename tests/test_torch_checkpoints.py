"""RektNet checkpoints and optimizers of the port (``train/checkpoints.py``,
``train/optim.py``, ``models/rektnet.py``'s state_dict mapping) against the
JAX package's, on the CPU: a ``.pt`` written by either package loads into
the other with equal tensors and Adam moments, and ``make_optimizer``'s
Adam and SGD follow optax step for step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu.train import checkpoints as jck
from mit_driverless_cv_traininginfra_tpu.train.optim import (
    make_optimizer as jmake_optimizer,
)
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet
from mit_driverless_cv_traininginfra_tpu_torch.train import checkpoints as ck
from mit_driverless_cv_traininginfra_tpu_torch.train import optim

NET = 4


def _trees(seed):
    return convert.init_rektnet_np(np.random.default_rng(seed), net_size=NET)


def _grads(tree, rng):
    """Random gradients shaped like a JAX-layout params tree."""
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1, a.shape).astype(np.float32), tree)


def _oihw(a):
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def _set_grads(model, grads_np):
    """Port gradients from a JAX-layout tree, in the reference order (own
    copies: ``clip_grad_norm_`` scales them in place)."""
    for p, (_, g) in zip(model.parameters(), jck._rektnet_param_entries(grads_np)):
        p.grad = torch.tensor(g)


def test_state_dicts_agree_in_layout_and_values():
    rp, rs = _trees(0)
    want = jck.rektnet_params_to_state_dict(rp, rs)
    got = ck.rektnet_params_to_state_dict(convert.from_jax(rp), convert.from_jax(rs))
    model_sd = rektnet.KeypointNet(convert.from_jax(rp), convert.from_jax(rs)).state_dict()
    assert list(got) == list(want) == list(model_sd)
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(model_sd[k], want[k]), k
    params, state = rektnet.params_from_torch_state_dict(got)
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves((convert.from_jax(rp),
                                               convert.from_jax(rs)))):
        assert torch.equal(a, b)


def test_jax_pt_loads_into_the_port(tmp_path):
    """JAX's ``save_rektnet_pt`` with a real optax Adam state (two steps) →
    the port's ``load_rektnet_pt``: parameters, running stats, Adam moments
    and step count equal; a further step from there matches optax."""
    rp, rs = _trees(1)
    rng = np.random.default_rng(2)
    tx = jmake_optimizer("Adam", lr=1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, rp)
    state = tx.init(jp)
    for _ in range(2):
        upd, state = tx.update(_grads(rp, rng), state, jp)
        jp = optax.apply_updates(jp, upd)
    path = str(tmp_path / "jax.pt")
    jck.save_rektnet_pt(path, jp, rs, epoch=3, optimizer_state=state)

    model = rektnet.KeypointNet(*map(convert.from_jax, _trees(5)))
    opt = optim.make_optimizer(model.parameters(), "Adam", lr=1e-3)
    assert ck.load_rektnet_pt(path, model, opt) == 3
    adam = jck._find_adam_state(state)
    mu, nu = dict(jck._rektnet_param_entries(adam.mu)), dict(jck._rektnet_param_entries(adam.nu))
    for (name, p), (_, want) in zip(model.named_parameters(),
                                    jck._rektnet_param_entries(jp)):
        np.testing.assert_array_equal(p.detach().numpy(), want)
        st = opt.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[name])
        assert float(st["step"]) == 2.0
    np.testing.assert_array_equal(model.res2.bn1.running_var.numpy(),
                                  rs["res2"]["bn1"]["var"])
    # the trees as the port's loader reads them, OIHW
    for a, b in zip(jax.tree_util.tree_leaves(rektnet.load_torch_checkpoint(path)),
                    jax.tree_util.tree_leaves((jp, rs))):
        np.testing.assert_array_equal(a.numpy(), _oihw(b))
    g = _grads(rp, rng)
    upd, _ = tx.update(g, state, jp)
    jp3 = dict(jck._rektnet_param_entries(optax.apply_updates(jp, upd)))
    _set_grads(model, g)
    optim.optimizer_step(opt)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp3[name], rtol=1e-6, atol=1e-7)


def test_port_pt_loads_into_jax(tmp_path):
    """The port's ``save_rektnet_pt`` → JAX's ``load_torch_checkpoint``:
    equal parameters and running stats; the file's Adam moments are the
    port optimizer's, and match optax's after the same gradients."""
    rp, rs = _trees(3)
    rng = np.random.default_rng(4)
    model = rektnet.KeypointNet(convert.from_jax(rp), convert.from_jax(rs))
    opt = optim.make_optimizer(model.parameters(), "Adam", lr=1e-3)
    tx = jmake_optimizer("Adam", lr=1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, rp)
    jstate = tx.init(jp)
    for _ in range(2):
        g = _grads(rp, rng)
        _set_grads(model, g)
        optim.optimizer_step(opt)
        upd, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    path = str(tmp_path / "port.pt")
    ck.save_rektnet_pt(path, model, epoch=7, optimizer=opt)

    params, state = jrektnet.load_torch_checkpoint(path)
    tparams, tstate = model.trees()
    for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                    jax.tree_util.tree_leaves((tparams, tstate))):
        np.testing.assert_array_equal(_oihw(a), b.numpy())
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["epoch"] == 7 and ckpt["optimizer"]["param_groups"][0]["lr"] == 1e-3
    adam = jck._find_adam_state(jstate)
    for i, ((_, m), (_, v)) in enumerate(zip(jck._rektnet_param_entries(adam.mu),
                                             jck._rektnet_param_entries(adam.nu))):
        st = ckpt["optimizer"]["state"][i]
        # the same moment updates, rounded differently: optax takes 1 − β
        # in f32 (1 − f32(0.999) is 1.3e-5 off 0.001), torch in double;
        # 1e-5 of each moment tensor's scale plus ulps
        for got, want in ((st["exp_avg"], m), (st["exp_avg_sq"], v)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=2e-5 * np.abs(want).max())
        assert float(st["step"]) == 2.0


@pytest.mark.parametrize("kind,weight_decay,grad_clip", [
    ("Adam", 0.0, 0.0), ("Adam", 1e-2, 0.0), ("Adam", 0.0, 5.0),
    ("SGD", 1e-2, 0.0), ("SGD", 0.0, 5.0)])
def test_optimizer_follows_optax(kind, weight_decay, grad_clip):
    """Three steps of the same gradients: ``torch.optim`` (L2 decay in the
    gradient, ``clip_grad_norm_``) against the JAX package's optax chain.
    Adam's and the clip's formulas round differently (torch divides by
    √v/√(1−β2ᵗ) + eps and clips by max/(‖g‖ + 1e-6)): each step moves a
    parameter by up to lr, and the two agree to 1e-4 of lr per step."""
    rp, _ = _trees(6)
    rng = np.random.default_rng(7)
    model = rektnet.KeypointNet(*map(convert.from_jax, _trees(6)))
    opt = optim.make_optimizer(model.parameters(), kind, lr=1e-2, momentum=0.9,
                               weight_decay=weight_decay, grad_clip=grad_clip)
    tx = jmake_optimizer(kind, lr=1e-2, momentum=0.9, weight_decay=weight_decay,
                         grad_clip=grad_clip)
    jp = jax.tree_util.tree_map(jnp.asarray, rp)
    state = tx.init(jp)
    for _ in range(3):
        g = _grads(rp, rng)
        _set_grads(model, g)
        optim.optimizer_step(opt)
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
    for (name, p), (_, want) in zip(model.named_parameters(),
                                    jck._rektnet_param_entries(jp)):
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=3 * 1e-4 * 1e-2, err_msg=name)


def test_training_loop_runs_checkpoints_and_reports(tmp_path):
    """Two epochs of ``train_rektnet`` on the CPU over in-memory loaders of
    the JAX loader's 5-tuples: the learning rate follows ExponentialLR, the
    epoch-1 ``.pt`` reloads into a fresh model and optimizer equal, and the
    score file holds the per-keypoint report's total."""
    from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
    from mit_driverless_cv_traininginfra_tpu_torch.train.rektnet_driver import (
        train_rektnet,
    )

    rng = np.random.default_rng(8)

    def batches(n):
        out = []
        for _ in range(n):
            crops, pts = synthetic.rektnet_batch(rng, 4)
            out.append((crops, np.zeros((4, 7, 1, 1), np.float32), pts,
                        ["c"] * 4, [(80, 80, 3)] * 4))
        return out

    model = rektnet.KeypointNet(*map(convert.from_jax, _trees(9)))
    opt = optim.make_optimizer(model.parameters(), "Adam", lr=1e-3)
    best, best_epoch, last = train_rektnet(
        model, opt, batches(2), batches(1), device="cpu",
        output_path=str(tmp_path / "out"), num_epochs=2, lr=1e-3, lr_gamma=0.5,
        device_targets=True, checkpoint_interval=2, log_dir=str(tmp_path / "logs"))
    assert last == 1 and np.isfinite(best) and best_epoch in (0, 1)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.5 ** 2)
    (pt,) = list((tmp_path / "out").glob("1_loss_*.pt"))
    fresh = rektnet.KeypointNet(*map(convert.from_jax, _trees(10)))
    fresh_opt = optim.make_optimizer(fresh.parameters(), "Adam", lr=1.0)
    assert ck.load_rektnet_pt(str(pt), fresh, fresh_opt) == 1
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert fresh_opt.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    total = float((tmp_path / "logs" / "rektnet.txt").read_text())
    assert np.isfinite(total) and total > 0
