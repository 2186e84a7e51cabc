"""The port's tensor-parallel and spatial placements (``parallel/mesh.py``,
``TrainDarknet(model_mesh=)``, ``detections(spatial=)``) against the JAX
package's ``shard_channels`` / ``shard_spatial`` programs, on the CPU.

One group of four ``gloo`` ranks, a 2-D mesh of data 2 × model 2, is
spawned for the whole file: a module fixture runs every job through
``parallel.dryrun.run_jobs`` (a module that imports no JAX, as the
children re-import it) on the tiny cfg at B = 4, 64²:

- the tensor-parallel × DP YOLO step, SGD at lr 1e-2 with momentum 0.9,
  without and with a gradient clip that acts, and the clipped step on the
  tiny cfg with block 2 at 9 filters and two classes (21-filter heads),
  convs that two model positions cannot split (they run whole on every
  rank, and the clip's norm counts them once);
- the spatially sharded detections and their gradient with respect to the
  frames.

The steps are held to JAX's one-device ``yolo_train_step`` on the same
seeded weights and batch at the JAX package's own bounds
(``tests/test_parallel_tp.py``): the loss within rtol 1e-5, the parameters
(joined by ``gather_channels``) and running stats within rtol 2e-4, atol
2e-6. The detections are held to JAX's jitted ``detections`` within 1e-5,
and their gradient to the port's in one process within 1e-5 of its
largest value. ``shard_channels``' decisions and blocks are held to JAX's
leaf for leaf in this process, with no spawn.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import TINY_CFG, tiny_port_spec, tiny_spec, to_jnp
from mit_driverless_cv_traininginfra_tpu.config import load_network_spec
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu.parallel import mesh as jmesh
from mit_driverless_cv_traininginfra_tpu.train import optim as joptim
from mit_driverless_cv_traininginfra_tpu.train import steps as jsteps
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config import darknet_cfg as tcfg
from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet
from mit_driverless_cv_traininginfra_tpu_torch.parallel import launch as tlaunch
from mit_driverless_cv_traininginfra_tpu_torch.parallel import mesh as tmesh
from mit_driverless_cv_traininginfra_tpu_torch.parallel.dryrun import run_jobs, yolo_targets

B, N_DATA, N_MODEL = 4, 2, 2
SGD = dict(lr=1e-2, momentum=0.9)
CLIP = 0.5   # below the step's gradient norm: the clip acts


def odd_specs(tmp_dir):
    """The tiny cfg with block 2 (a 1×1 conv) at 9 filters and two classes
    (21-filter heads, which carry 96% of the gradient's norm), parsed by
    both packages: ``(JAX spec, port spec)``."""
    with open(TINY_CFG) as f:
        text = f.read()
    odd = text.replace("filters=8\nsize=1", "filters=9\nsize=1").replace(
        "classes=1\n", "classes=2\n")
    assert odd.count("filters=9") == 1 and odd.count("classes=2") == 1, "tiny cfg changed"
    path = os.path.join(str(tmp_dir), "tiny_odd.cfg")
    with open(path, "w") as f:
        f.write(odd)
    return (load_network_spec(path, vanilla_anchor=True),
            tcfg.load_network_spec(path, vanilla_anchor=True))


def _jobs(tmp_dir):
    rng = np.random.default_rng(0)
    specs = {"tiny": (tiny_spec(), tiny_port_spec()), "odd": odd_specs(tmp_dir)}
    imgs = rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)
    targets = yolo_targets(rng, B)
    trees = {k: convert.init_darknet_np(s[1], rng) for k, s in specs.items()}
    step = dict(family="yolo", batch=(imgs, targets), steps=1, **SGD)
    jobs = {
        "tp": dict(step, spec=specs["tiny"][1], trees=trees["tiny"]),
        "tp_clip": dict(step, spec=specs["tiny"][1], trees=trees["tiny"], grad_clip=CLIP),
        "tp_odd_clip": dict(step, spec=specs["odd"][1], trees=trees["odd"],
                            grad_clip=CLIP),
        "spatial": dict(family="spatial", spec=specs["tiny"][1], trees=trees["tiny"],
                        batch=(imgs,), grad=True),
    }
    jax_specs = {"tp": specs["tiny"][0], "tp_clip": specs["tiny"][0],
                 "tp_odd_clip": specs["odd"][0], "spatial": specs["tiny"][0]}
    return jobs, jax_specs


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Every job on the 2 × 2 mesh of four gloo ranks, the spatial job also
    in this process, and JAX's one-device program of each."""
    jobs, jax_specs = _jobs(tmp_path_factory.mktemp("tp"))
    names = list(jobs)
    ranks = tlaunch.launch(run_jobs, ["cpu"] * (N_DATA * N_MODEL),
                           args=([jobs[n] for n in names],), mesh_shape=(N_DATA, N_MODEL))
    out = {n: dict(job=jobs[n], mesh=r, jax=_jax(jax_specs[n], jobs[n]))
           for n, r in zip(names, ranks)}
    out["spatial"]["one"] = run_jobs(None, [jobs["spatial"]], "cpu")[0]
    return out


def _jax(spec, job):
    """JAX's one-device run of ``job``: (returned values flat, params,
    state) for a step, the detections for the spatial job; numpy."""
    params, state = to_jnp(job["trees"][0]), to_jnp(job["trees"][1])
    if job["family"] == "spatial":
        det = jax.jit(lambda p, s, im: jdarknet.detections(spec, p, s, im))
        return np.asarray(det(params, state, jnp.asarray(job["batch"][0])))
    tx = joptim.make_optimizer("SGD", lr=job["lr"], momentum=job["momentum"],
                               grad_clip=job.get("grad_clip", 0.0))
    ts, *vals = jsteps.yolo_train_step(spec, tx, jsteps.init_train_state(params, state, tx),
                                       *map(jnp.asarray, job["batch"]))
    flat = np.concatenate([np.ravel(np.asarray(v)) for v in vals])
    return flat, jax.tree_util.tree_map(np.asarray, (ts.params, ts.model_state))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


STEPS = ["tp", "tp_clip", "tp_odd_clip"]


@pytest.mark.parametrize("case", STEPS)
def test_tp_dp_step_matches_jax_one_device(tp, case):
    """The 2 × 2 TP × DP step = JAX's step on one device on the whole
    batch: the loss and its parts, then every parameter and running stat
    of the joined trees."""
    c = tp[case]
    want_vals, want = c["jax"]
    np.testing.assert_allclose(c["mesh"]["losses"][0], want_vals, rtol=1e-5, atol=1e-7)
    got = c["mesh"]["trees"][1]
    for g, w in zip(got, want):
        gl, wl = _leaves(g), _leaves(w)
        assert gl.keys() == wl.keys()
        for name in wl:
            np.testing.assert_allclose(gl[name], wl[name], rtol=2e-4, atol=2e-6,
                                       err_msg=name)


@pytest.mark.parametrize("case", STEPS)
def test_tp_dp_update_matches_jax_one_device(tp, case):
    """The update itself (after − before) of every parameter within 1e-3 of
    the largest update JAX's step made, the bound the DP tests hold
    (``test_torch_parallel.py``): the parameters' own bound is loose
    beside an update of lr·g."""
    c = tp[case]
    before = _leaves(c["job"]["trees"][0])
    got, want = _leaves(c["mesh"]["trees"][1][0]), _leaves(c["jax"][1][0])
    scale = max(float(np.abs(want[k] - before[k]).max()) for k in want)
    for name in want:
        np.testing.assert_allclose(got[name] - before[name], want[name] - before[name],
                                   rtol=0, atol=1e-3 * scale + 1e-7, err_msg=name)


def test_clip_acts(tp):
    """The clipped step's update is not the plain step's (the norm is above
    the clip), so the clip's norm over the split leaves is held above."""
    plain = _leaves(tp["tp"]["jax"][1][0])
    clipped = _leaves(tp["tp_clip"]["jax"][1][0])
    assert any(not np.allclose(plain[k], clipped[k], rtol=1e-4, atol=1e-6) for k in plain)


@pytest.mark.parametrize("case", STEPS)
def test_split_leaves_stay_blocks(tp, case):
    """After the update each rank's conv 0 weight, BN scale and running
    mean are its block of out-channels (the block ``shard_channels`` cut
    from the updated whole tree), the odd cfg's block 2 and heads are
    whole, and every momentum buffer has its parameter's shape."""
    c = tp[case]
    spec = c["job"]["spec"]
    whole = c["mesh"]["trees"][1]
    for rank, (params, state) in enumerate(c["mesh"]["parts"]):
        mesh = tmesh.Mesh2D(N_DATA, N_MODEL, ["cpu"] * 4, rank=rank)
        cut = tuple(tmesh.shard_channels(mesh, t) for t in whole)
        for got, want in ((params["0"]["w"], cut[0]["0"]["w"]),
                          (params["0"]["bn"]["scale"], cut[0]["0"]["bn"]["scale"]),
                          (state["0"]["mean"], cut[1]["0"]["mean"])):
            assert got.shape[-1] == spec.blocks[0].filters // N_MODEL
            np.testing.assert_array_equal(got, want)
        odd = case == "tp_odd_clip"
        assert params["2"]["w"].shape[-1] == (9 if odd else 8 // N_MODEL)
        assert params["7"]["w"].shape[-1] == (21 if odd else 18 // N_MODEL)
    shapes = c["mesh"]["optimizer_shapes"]
    assert shapes and all(bufs == [shape] for shape, bufs in shapes.values()), shapes
    assert shapes["convs.0.weight"][0][0] == spec.blocks[0].filters // N_MODEL


@pytest.mark.parametrize("case", STEPS)
def test_ranks_agree(tp, case):
    """Whole leaves are bit-equal on all four ranks; blocks are bit-equal
    between the two data positions of a model position."""
    c = tp[case]
    parts = [_leaves(p) for p in c["mesh"]["parts"]]
    like = _leaves(c["job"]["trees"])
    for name, ref in like.items():
        split = parts[0][name].shape != ref.shape
        for rank, leaves in enumerate(parts):
            other = rank % N_MODEL if split else 0
            np.testing.assert_array_equal(leaves[name], parts[other][name],
                                          err_msg=f"{name} rank {rank}")
    n_whole = sum(parts[0][k].shape == v.shape for k, v in like.items())
    # block 2's w, scale, bias, mean, var and the two heads' w, b
    assert n_whole == (9 if case == "tp_odd_clip" else 0)


@pytest.mark.parametrize("case", STEPS)
def test_model_collectives_carry_the_local_batch(tp, case):
    """Every rank-4 model-axis collective of the step (the channel gathers
    forward, the input-gradient sums backward) carries the local batch,
    B / data = 2, never the global one; the odd cfg's whole convs add
    none."""
    colls = tp[case]["mesh"]["collectives"]
    assert {k for k, _, _ in colls} == {"all_gather", "all_reduce"}
    act = [c for c in colls if len(c[1]) == 4]
    assert act and all(shape[0] == B // N_DATA for _, shape, _ in act), act
    n_convs = sum(isinstance(b, tcfg.ConvBlock) for b in tp[case]["job"]["spec"].blocks)
    n_split = n_convs - 3 * (case == "tp_odd_clip")
    assert sum(k == "all_gather" for k, _, _ in colls) == n_split
    # the first conv's input is the frames, which need no gradient
    assert sum(k == "all_reduce" for k, _, _ in colls) == n_split - 1


def test_spatial_forward_matches_jax(tp):
    """Frame rows 0-32 and 32-64 on the two model positions: the
    detections are JAX's within 1e-5, and their gradient with respect to
    the frames (halo exchanges backward) the port's in one process."""
    c = tp["spatial"]
    assert [(r.start, r.stop) for r in c["mesh"]["rows"]] == [(0, 32), (32, 64)]
    np.testing.assert_allclose(c["mesh"]["det"], c["jax"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c["mesh"]["det"], c["one"]["det"], rtol=1e-5, atol=1e-5)
    g, g1 = c["mesh"]["grad"], c["one"]["grad"]
    np.testing.assert_allclose(g, g1, rtol=0, atol=1e-5 * np.abs(g1).max())


def test_spatial_halos_are_rows_not_activations(tp):
    """Every halo the spatial forward sends is at most ¼ of the largest
    whole activation of the network on the global batch; only the heads'
    maps are gathered."""
    c = tp["spatial"]
    spec = c["job"]["spec"]
    strides = darknet.block_strides(spec)
    largest = max(B * (64 // s) ** 2 * ch * 4
                  for s, ch in zip(strides, spec.out_channels[1:]))
    halos = [c_ for c_ in c["mesh"]["collectives"] if c_[0] == "halo"]
    assert halos and all(nbytes <= largest / 4 for _, _, nbytes in halos), halos
    assert all(shape[1] == 1 for _, shape, _ in halos)  # one row each
    gathers = [c_ for c_ in c["mesh"]["collectives"] if c_[0] == "all_gather"]
    assert len(gathers) == 2


@pytest.mark.parametrize("key_allow", ["default", None])
def test_shard_channels_matches_jax_leaf_for_leaf(key_allow):
    """JAX's two ``shard_channels`` cases on a 4 × 2 mesh: each leaf split
    where JAX shards it on ``model`` and whole where JAX replicates it
    (the (3,) ``w``, the 0-d leaf, the (9, 2) anchors, which split only
    with ``key_allow=None``), and every position's block equal to JAX's
    shard on that device."""
    kw = {} if key_allow == "default" else dict(key_allow=None)
    rng = np.random.default_rng(3)
    trees = [{"w": rng.standard_normal(3, dtype=np.float32), "scalar": np.float32(0.5),
              "b": rng.standard_normal((4, 8), dtype=np.float32)},
             {"anchors": rng.standard_normal((9, 2), dtype=np.float32),
              "layer": {"w": rng.standard_normal((3, 3, 4, 8), dtype=np.float32)}}]
    jm = jmesh.make_mesh_2d(4, 2)
    devices = list(jm.devices.flat)
    decisions = {}
    for tree in trees:
        placed = jmesh.shard_channels(jm, jax.tree_util.tree_map(jnp.asarray, tree), **kw)
        parts = [tmesh.shard_channels(tmesh.Mesh2D(4, 2, ["cpu"] * 8, rank=r), tree, **kw)
                 for r in range(8)]
        for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
            keys = tuple(p.key for p in path)
            decisions[keys] = tmesh.channel_split(keys, leaf.shape, 2, **kw)
            assert decisions[keys] == (not leaf.sharding.is_fully_replicated), keys
            for rank, mine in enumerate(parts):
                for k in keys:
                    mine = mine[k]
                shard = next(s for s in leaf.addressable_shards if s.device == devices[rank])
                np.testing.assert_array_equal(mine, np.asarray(shard.data), err_msg=str(keys))
    assert decisions == {("w",): False, ("scalar",): False, ("b",): True,
                         ("anchors",): key_allow is None, ("layer", "w"): True}


def test_spatial_rows_split_whole_coarse_rows():
    """416² YOLOv3 (coarsest stride 32) over two model positions: frame rows
    224 and 192 (13 grid rows, the first takes 7); the tiny cfg (stride 4)
    at 64²: 32 and 32; more positions than coarse rows raise."""
    assert darknet.coarsest_stride(flagship_spec()) == 32
    assert darknet.coarsest_stride(tiny_port_spec()) == 4
    rows = tmesh.spatial_rows(416, 32, 2)
    assert [(r.start, r.stop) for r in rows] == [(0, 224), (224, 416)]
    assert [(r.start, r.stop) for r in tmesh.spatial_rows(64, 4, 2)] == [(0, 32), (32, 64)]
    assert [r.stop - r.start for r in tmesh.spatial_rows(416, 32, 4)] == [128, 96, 96, 96]
    with pytest.raises(ValueError, match="at least one"):
        tmesh.spatial_rows(64, 4, 17)
    with pytest.raises(ValueError, match="not a multiple"):
        tmesh.spatial_rows(65, 4, 2)
    mesh = tmesh.Mesh2D(2, 2, ["cpu"] * 4)
    blocks = tmesh.spatial_sharding(mesh, (4, 64, 64, 3), 4)
    assert [(b.start, r.start) for _, b, r in blocks] == [(0, 0), (0, 32), (2, 0), (2, 32)]
    x = np.arange(4 * 64 * 2 * 1, dtype=np.float32).reshape(4, 64, 2, 1)
    parts = tmesh.shard_spatial(mesh, x, 4)
    np.testing.assert_array_equal(parts[3].numpy(), x[2:, 32:])


def test_make_mesh_2d_layout_and_refusals():
    """Data-major positions as JAX reshapes its devices: position r = d·2 +
    m; the data sub-mesh is a column, the model sub-mesh a row. Too few
    devices raise, as JAX's ``make_mesh_2d`` does, and so does a launch
    whose mesh does not cover its ranks."""
    mesh = tmesh.Mesh2D(3, 2, ["cpu"] * 6, rank=3)
    assert (mesh.data.rank, mesh.model.rank) == (1, 1)
    jm = jmesh.make_mesh_2d(3, 2)
    assert jm.devices.shape == (3, 2) and jm.devices[1, 1] == jax.devices()[3]
    m = tmesh.make_mesh_2d(2, 2, devices=["cpu"] * 5)
    assert m.size == 4 and m.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="needs 8 devices"):
        tmesh.make_mesh_2d(4, 2, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="needs 8 devices"):
        jmesh.make_mesh_2d(4, 2, devices=jax.devices()[:6])
    with pytest.raises(ValueError, match="2x2 mesh over 3 ranks"):
        tlaunch.launch(run_jobs, ["cpu"] * 3, args=([],), mesh_shape=(2, 2))
    assert tmesh.data_axis(mesh) is mesh.data and tmesh.data_axis(None) is None
    whole = {"a": {"w": np.arange(8, dtype=np.float32).reshape(2, 4)}}
    assert tmesh.shard_channels(mesh, whole)["a"]["w"].tolist() == [[2, 3], [6, 7]]
