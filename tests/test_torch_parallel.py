"""The port's data parallelism (``parallel/``) on the CPU: two ``gloo``
ranks against the JAX package's step on a 2-device mesh and against the
port's own step in one process on the whole batch.

One group of two ranks is spawned for the whole file (a module-scoped
fixture runs every DP job through ``parallel.dryrun.run_jobs``, a module
that imports torch and the port only, as the children re-import it). The
jobs, at B = 4 (2 a rank) on the tiny cfg and a narrow RektNet:

- the YOLO step (SGD, f32) on targets built so that the batch-global terms
  matter: rank 0's images hold one box each, rank 1's five in all (so the
  masked means' counts differ between the ranks), and rank 1's boxes make
  ignore cells that rank 0's do not (the batch-global ignore quirk);
- the YOLO step with the device augmentation (flip, jitter, noise), its
  draws JAX's from one key;
- the RektNet step, cross-batch geometric loss on and off.

Tolerances as the one-device parity tests state them
(``test_torch_yolo_train.py``, ``test_torch_rektnet_train.py``,
``test_torch_device_aug.py``): losses within rtol 1e-5 (YOLO) and 1e-4
(RektNet), components within rtol 1e-5, parameters within lr·1e-3·gmax
(gmax the largest gradient, read from the one-process update) + 1e-7, BN
running stats within 1e-5 of their largest value. After three steps the DP
run is held to the one-process run at the same bounds (lr·gmax taken as
three times the first step's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import tiny_port_spec, tiny_spec, to_jnp
from mit_driverless_cv_traininginfra_tpu.ops import heatmap as jheatmap
from mit_driverless_cv_traininginfra_tpu.parallel import mesh as jmesh
from mit_driverless_cv_traininginfra_tpu.train import optim as joptim
from mit_driverless_cv_traininginfra_tpu.train import steps as jsteps
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.models import yolo_loss
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import YoloBlock
from mit_driverless_cv_traininginfra_tpu_torch.parallel import launch as tlaunch
from mit_driverless_cv_traininginfra_tpu_torch.parallel import mesh as tmesh
from mit_driverless_cv_traininginfra_tpu_torch.parallel.dryrun import (
    pixel_corners,
    run_jobs,
)
from test_torch_device_aug import _jax_draws

B, LR = 4, 0.01
LOSS_KW = dict(xy_loss=2.0, wh_loss=1.6, object_loss=0.1, no_object_loss=25.0)
GEO = dict(geo_loss_gamma_horz=0.05, geo_loss_gamma_vert=0.05)
AUG = dict(lr_flip=True, jitter=True, noise=True)
AUG_KEY = 21


def quirk_targets() -> np.ndarray:
    """(4, 3, 5): rank 0's images (0, 1) one box each at the top left,
    rank 1's (2, 3) three and two at the bottom right."""
    t = np.zeros((B, 3, 5), np.float32)
    t[0, 0] = [0, 0.20, 0.22, 0.30, 0.40]
    t[1, 0] = [0, 0.28, 0.18, 0.25, 0.35]
    t[2, :3] = [[0, 0.70, 0.75, 0.30, 0.45], [0, 0.82, 0.62, 0.20, 0.30],
                [0, 0.60, 0.85, 0.35, 0.25]]
    t[3, :2] = [[0, 0.75, 0.70, 0.40, 0.40], [0, 0.88, 0.86, 0.18, 0.22]]
    return t


def _cases():
    spec, tspec = tiny_spec(), tiny_port_spec()
    rng = np.random.default_rng(0)
    yp, ys = convert.init_darknet_np(tspec, rng)
    imgs = rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)
    targets = quirk_targets()
    px = pixel_corners(targets, 64)
    draws = {k: v.numpy() for k, v in _jax_draws(
        jax.random.PRNGKey(AUG_KEY), B, 64, 64, 3, affine=False, flip=True,
        jitter=True, noise=True).items()}
    rp, rs = convert.init_rektnet_np(rng, net_size=4)
    crops, pts = synthetic.rektnet_batch(rng, B)
    yolo = dict(family="yolo", spec=tspec, trees=(yp, ys), lr=LR,
                step_kw=dict(LOSS_KW, compute_dtype="float32"))
    # lr 1e-3: at 1e-2 this narrow RektNet's steps amplify rounding ~100×
    # a step, so two one-process runs on a reordered batch part by 4% of
    # the update after three steps (measured), DP or not
    rekt = dict(family="rektnet", trees=(rp, rs), batch=(crops, None, pts), lr=1e-3)
    jobs = {
        "yolo": dict(yolo, batch=(imgs, targets), steps=3, keep=(1, 3)),
        "yolo_aug": dict(yolo, batch=(imgs, px), draws=[draws], steps=1),
        "rektnet_cross": dict(rekt, steps=3, keep=(1, 3), step_kw=dict(
            GEO, loss_type="l1_softargmax", cross_batch=True, synth_target_sigma=1.0)),
        "rektnet_diag": dict(rekt, steps=1, step_kw=dict(
            GEO, loss_type="l2_softargmax", cross_batch=False, synth_target_sigma=1.0)),
    }
    return spec, jobs


@pytest.fixture(scope="module")
def dp():
    """Every job on two gloo ranks and in one process; JAX's one step of
    each on a 2-device mesh."""
    spec, jobs = _cases()
    names = list(jobs)
    ranks = tlaunch.launch(run_jobs, ["cpu", "cpu"], args=([jobs[n] for n in names],))
    one = run_jobs(None, [jobs[n] for n in names], "cpu")
    mesh = jmesh.make_mesh(2)
    out = {}
    for name, r, o in zip(names, ranks, one):
        out[name] = dict(job=jobs[name], dp=r, one=o,
                         jax=_jax_step(spec, jobs[name], mesh))
    return out


def _jax_step(spec, job, mesh):
    """JAX's one step of ``job`` on ``mesh``: (returned values flat,
    params, state) as numpy."""
    tx = joptim.make_optimizer("SGD", lr=job["lr"], momentum=0.0)
    params, state = job["trees"]
    ts = jmesh.replicate(mesh, jsteps.init_train_state(to_jnp(params), to_jnp(state), tx))

    def shard(a):
        return jmesh.shard_batch(mesh, jnp.asarray(a))

    kw = job["step_kw"]
    if job["family"] == "rektnet":
        crops, _, pts = job["batch"]
        thm = jheatmap.gaussian_heatmaps(jnp.asarray(pts), 80, 80, sigma=1.0)
        ts, *vals = jsteps.rektnet_train_step(tx, ts, shard(crops), shard(thm), shard(pts),
                                              **kw)
    elif "draws" in job:
        ts, *vals = jsteps.yolo_train_step_device_aug(
            spec, tx, ts, *map(shard, job["batch"]), jax.random.PRNGKey(AUG_KEY),
            augment_affine=False, **AUG, **kw)
    else:
        ts, *vals = jsteps.yolo_train_step(spec, tx, ts, *map(shard, job["batch"]), **kw)
    flat = np.concatenate([np.ravel(np.asarray(v)) for v in vals])
    return flat, jax.tree_util.tree_map(np.asarray, (ts.params, ts.model_state))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _hold(got, want, lr_gmax):
    """``got`` vs ``want`` (params, state) at the stated bounds."""
    for name, w in _leaves(want[0]).items():
        np.testing.assert_allclose(_leaves(got[0])[name], w, rtol=0,
                                   atol=1e-3 * lr_gmax + 1e-7, err_msg=name)
    for name, w in _leaves(want[1]).items():
        np.testing.assert_allclose(_leaves(got[1])[name], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def _lr_gmax(case, step=1):
    """lr·gmax: the largest parameter change of the one-process run's first
    step (SGD without momentum moves each parameter by lr·g)."""
    before = _leaves(case["job"]["trees"][0])
    after = _leaves(case["one"]["trees"][step][0])
    return max(float(np.abs(after[k] - before[k]).max()) for k in before)


CASES = ["yolo", "yolo_aug", "rektnet_cross", "rektnet_diag"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("against", ["jax_mesh", "one_process"])
def test_dp_step_matches(dp, case, against):
    """One DP step on two ranks = JAX's step on a 2-device mesh, and = the
    port's step in one process on the concatenated batch: the loss and its
    parts, the updated parameters, the BN running stats."""
    c = dp[case]
    got = c["dp"]["losses"][0]
    want = c["jax"][0] if against == "jax_mesh" else c["one"]["losses"][0]
    rtol = 1e-4 if c["job"]["family"] == "rektnet" else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)
    ref = c["jax"][1] if against == "jax_mesh" else c["one"]["trees"][1]
    _hold(c["dp"]["trees"][1], ref, _lr_gmax(c))


@pytest.mark.parametrize("case", ["yolo", "rektnet_cross"])
def test_dp_three_steps_match_one_process(dp, case):
    """After three steps the two ranks' parameters and running stats are
    the one-process run's on the whole batch, and so are every step's
    losses."""
    c = dp[case]
    for got, want in zip(c["dp"]["losses"], c["one"]["losses"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    _hold(c["dp"]["trees"][3], c["one"]["trees"][3], 3 * _lr_gmax(c))


def test_quirk_batch_makes_the_ranks_differ():
    """The YOLO case's batch exercises the batch-global terms: the ranks'
    halves give different object counts, and rank 1's half ignores cells
    that rank 0's half does not (so a per-rank loss would differ)."""
    spec = tiny_port_spec()
    t = torch.from_numpy(quirk_targets())
    heads = [b for b in spec.blocks if isinstance(b, YoloBlock)]
    counts, extra = [], 0
    for grid, blk in zip((16, 32), heads):
        anc = yolo_loss.scaled_anchors(tuple(map(tuple, blk.anchors)), 64 / grid,
                                       torch.device("cpu"))

        def ignored(rows):
            bt = yolo_loss.build_targets(t[rows], anc, 1, grid, grid, 0.5)
            return ~bt.conf_mask[0, 0] | bt.mask[0, 0], int(bt.mask.sum())

        (i0, n0), (i1, n1) = ignored(slice(0, 2)), ignored(slice(2, 4))
        counts.append((n0, n1))
        extra += int((i1 & ~i0).sum())
    assert all(n0 != n1 for n0, n1 in counts), counts
    assert extra > 0


def test_pad_batch_to_devices_matches_jax():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    for mode in ("repeat", "zero"):
        want, n_want = jmesh.pad_batch_to_devices(x, 8, mode=mode)
        got, n = tmesh.pad_batch_to_devices(x, 8, mode=mode)
        np.testing.assert_array_equal(got, want)
        t, nt = tmesh.pad_batch_to_devices(torch.from_numpy(x), 8, mode=mode)
        np.testing.assert_array_equal(t.numpy(), want)
        assert n == nt == n_want == 5
    same, n = tmesh.pad_batch_to_devices(x[:4], 2)
    np.testing.assert_array_equal(same, x[:4])
    assert n == 4


def test_mesh_and_launch_refuse_missing_devices():
    """No fallback: more devices or ranks than exist raise."""
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="3 devices asked"):
        tmesh.make_mesh(3, devices=[cpu, cpu])
    with pytest.raises(ValueError, match="≥ 1"):
        tmesh.make_mesh(0, devices=[cpu])
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.batch_sharding(tmesh.make_mesh(2, devices=[cpu, cpu]), 3)
    with pytest.raises(ValueError, match="≥ 1"):
        tlaunch.rank_devices(0, "cpu")
    with pytest.raises(ValueError, match="nccl takes one rank per GPU"):
        tlaunch.launch(run_jobs, ["cpu", "cpu"], args=([],), backend="nccl")
    assert tlaunch.rank_devices(2, "cpu") == [cpu, cpu]
    assert tlaunch.default_backend([cpu, cpu]) == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tlaunch.rank_devices(2, "cuda")


def test_shard_batch_and_replicate_on_a_device_mesh():
    cpu = torch.device("cpu")
    mesh = tmesh.make_mesh(devices=[cpu, cpu])
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    parts = tmesh.shard_batch(mesh, (x, {"y": torch.arange(4)}))
    assert len(parts) == 2
    np.testing.assert_array_equal(parts[1][0].numpy(), x[2:])
    assert parts[0][1]["y"].tolist() == [0, 1]
    m = torch.nn.Linear(2, 2)
    assert all(r is m for r in tmesh.replicate(mesh, m))
    assert tmesh.replicated(mesh) == (cpu, cpu)
