"""Multi-device dry run of the port (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``)::

    python -m mit_driverless_cv_traininginfra_tpu_torch.parallel.dryrun \\
        [--n_devices N] [--device cuda|cpu]

On the tiny test cfg (``tests/fixtures/tiny_test.cfg``, 64²) and a narrow
RektNet it runs every data-parallel surface on N ranks (``launch``: one a
card over ``nccl``, or N CPU processes over ``gloo``), each against the
same step in this process on the whole batch, then the single-process
serving surfaces over a device mesh of N entries, each against one
device. One ``OK`` line a surface:

- the DP YOLO step, plain and with device augmentation;
- the DP YOLO step through the packed space-to-depth stem: the loss
  finite and the one-device step's, the parameters equal on every rank
  (the JAX dry run's 2b);
- ``evaluate_image_batch`` over the sharded batch, its per-image results
  gathered (and perfect detections, AP 1 on every image);
- the DP RektNet step (cross-batch geometric loss);
- the bf16 and int8 ``TwoStageServer(mesh=)`` on a batch split over the
  mesh, equal to the server without one;
- ``TwoStagePP`` (stage A on the first device, stage B on the last),
  equal to the fused pipeline.

When N is even and at least 4, as in the JAX package's dry run, two more
on a 2-D ``(N/2 data, 2 model)`` process mesh (``launch(mesh_shape=)``;
the data-parallel jobs then run in the same launch, on the world's 1-D
mesh):

- the tensor-parallel × DP YOLO step (SGD with momentum): the loss
  finite, ``convs["0"].weight`` still a block of out-channels after the
  update, the loss and the joined parameters the one-process step's;
- the spatially sharded detect forward (H over ``model``, halo
  exchanges), equal to one process.

:func:`run_jobs` is the step runner the dry run, ``chip_smoke.py`` and
the tests share: the same seeded jobs run under a process mesh (one rank's
rows; on a 2-D mesh one rank's rows and block of channels or frame rows)
or without one (the whole batch), and the results come back as numpy in
the JAX package's tree layout.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import load_network_spec
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import two_stage_pipeline
from mit_driverless_cv_traininginfra_tpu_torch.infer.pp import TwoStagePP
from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import TwoStageServer
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, quantize, rektnet, stem_opt
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    fused_softargmax,
    softargmax_bwd,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.metrics import evaluate_image_batch
from mit_driverless_cv_traininginfra_tpu_torch.parallel.launch import launch, rank_devices
from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import (
    Mesh2D,
    all_gather,
    gather_channels,
    make_mesh,
    process_mesh,
    replicate,
    shard_batch,
    shard_channels,
    shard_spatial,
    spatial_sharding,
)
from mit_driverless_cv_traininginfra_tpu_torch.train import optim, steps

TINY_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures", "tiny_test.cfg")


# ---------------------------------------------------------------------------
# the DP step runner
# ---------------------------------------------------------------------------


def _model(job, dev, mesh=None):
    """The job's model on ``dev``; a tensor-parallel ``TrainDarknet`` on
    this position's part of the trees under a :class:`Mesh2D`."""
    params, state = job["trees"]
    if isinstance(mesh, Mesh2D):
        params, state = shard_channels(mesh, params), shard_channels(mesh, state)
    p, s = convert.from_jax(params, dev), convert.from_jax(state, dev)
    if job["family"] == "rektnet":
        return rektnet.KeypointNet(p, s).to(dev)
    return darknet.TrainDarknet(job["spec"], p, s,
                                model_mesh=getattr(mesh, "model", None)).to(dev)


def _tensor(a, dev):
    return None if a is None else torch.as_tensor(np.asarray(a)).to(dev)


def _local(mesh, batch, dev):
    """This rank's rows of a global batch (a tuple of arrays or None) as
    tensors on ``dev``; the whole batch without a mesh."""
    if mesh is None:
        return [_tensor(a, dev) for a in batch]
    return list(shard_batch(mesh, tuple(batch))[0])


def run_job(mesh, job: dict, dev) -> dict:
    """One training job: ``job["steps"]`` steps of ``family`` ``"yolo"``
    (``yolo_train_step``, or ``yolo_train_step_device_aug`` when
    ``job["draws"]`` holds one dict of global draws a step) or
    ``"rektnet"`` (``rektnet_train_step``) from ``job["trees"]`` (JAX-layout
    numpy ``(params, state)``) on ``job["batch"]`` (the global batch as
    numpy; None entries pass), with ``job["optimizer"]`` at ``job["lr"]``
    (``job["momentum"]``, default none; ``job["grad_clip"]``, default off)
    and ``job["step_kw"]``; ``job["cudnn"] = False`` runs the
    convolutions without cuDNN (its algorithm picks depend on the batch
    size, so a rank's half batch may sum in another algorithm). Under a
    process ``mesh`` this rank takes its rows, and the trees must end
    bit-equal on every rank; under a :class:`Mesh2D` the YOLO model is
    tensor-parallel over ``model``, its blocks must end bit-equal across
    ``data`` and its whole leaves on every rank.

    Returns ``{"losses": [one flat array a step: the step's returned
    values], "trees": {step: (params, state)}, "ms": [a step's wall time,
    the device synchronised], "launches": K2's forward and backward
    wrapper counts over the steps, "mib": parameter and optimizer-state
    MiB on this rank}``, the trees for the steps in ``job["keep"]``
    (default the last), whole, JAX-layout numpy. Under a :class:`Mesh2D`
    also ``"parts"``: every rank's own trees after the last step, in rank
    order; ``"optimizer_shapes"``: each parameter's shape beside its
    optimizer state's; ``"collectives"``: this rank's model-axis
    collectives over the steps."""
    model = _model(job, dev, mesh)
    opt = optim.make_optimizer(model.parameters(), job.get("optimizer", "SGD"),
                               lr=job["lr"], momentum=job.get("momentum", 0.0),
                               grad_clip=job.get("grad_clip", 0.0))
    batch = _local(mesh, job["batch"], dev)
    kw = dict(job.get("step_kw", {}), mesh=mesh)
    keep = set(job.get("keep", (job["steps"],)))
    out = {"losses": [], "trees": {}, "ms": []}
    fused_softargmax.launches = softargmax_bwd.launches = 0
    tp = isinstance(mesh, Mesh2D)
    if tp:
        mesh.model.collectives.clear()
    with torch.backends.cudnn.flags(enabled=job.get("cudnn", True)):
        _steps(model, opt, batch, job, kw, dev, keep, out, mesh)
    out["launches"] = {"softargmax": fused_softargmax.launches,
                       "softargmax_bwd": softargmax_bwd.launches}
    out["mib"] = sum(t.numel() * t.element_size() for t in _held(model, opt)) / 2**20
    if tp:
        out["collectives"] = list(mesh.model.collectives)
        out["optimizer_shapes"] = {
            name: (tuple(p.shape), [tuple(v.shape) for v in opt.state[p].values()
                                    if torch.is_tensor(v) and v.ndim])
            for name, p in model.named_parameters()}
        p, s = model.trees()
        out["parts"] = [None] * mesh.size
        dist.all_gather_object(out["parts"], (convert.to_jax(p), convert.to_jax(s)))
    if mesh is not None:
        _check_equal_on_ranks(model, mesh)
    return out


def _held(model, opt) -> list:
    """The tensors a training rank holds for its model: parameters, buffers
    and optimizer state."""
    state = [v for st in opt.state.values() for v in st.values() if torch.is_tensor(v)]
    return list(model.parameters()) + list(model.buffers()) + state


def _steps(model, opt, batch, job, kw, dev, keep, out, mesh) -> None:
    for t in range(job["steps"]):
        t0 = time.perf_counter()
        if job["family"] == "rektnet":
            got = steps.rektnet_train_step(model, opt, *batch, **kw)
        elif job.get("draws"):
            draws = {k: _tensor(v, dev) for k, v in job["draws"][t].items()}
            got = steps.yolo_train_step_device_aug(model, opt, *batch, draws, **kw)
        else:
            got = steps.yolo_train_step(model, opt, *batch, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(np.concatenate([x.reshape(-1).cpu().numpy() for x in got]))
        if t + 1 in keep:
            trees = tuple(convert.to_jax(x) for x in model.trees())
            if isinstance(mesh, Mesh2D):
                trees = tuple(gather_channels(mesh, x, like)
                              for x, like in zip(trees, job["trees"]))
            out["trees"][t + 1] = trees


def _check_equal_on_ranks(model, mesh) -> None:
    """Rank 0's parameters and buffers, broadcast, against this rank's; on
    a :class:`Mesh2D` all of them over ``data`` and the whole (not split)
    ones over ``model``."""
    tensors = list(model.parameters()) + list(model.buffers())
    groups = [(mesh, tensors)]
    if isinstance(mesh, Mesh2D):
        split = {id(t) for c in model.modules()
                 if getattr(c, "split", None) is not None
                 for t in list(c.parameters()) + list(c.buffers())}
        groups = [(mesh.data, tensors),
                  (mesh.model, [t for t in tensors if id(t) not in split])]
    for group, ts in groups:
        if not ts:
            continue
        mine = torch.cat([t.detach().reshape(-1).float() for t in ts])
        ref = mine.clone()
        replicate(group, [ref])
        if not torch.equal(ref, mine):
            raise RuntimeError(f"rank {mesh.rank}: parameters differ from rank 0's "
                               f"of {group} (max |Δ| {float((ref - mine).abs().max())})")


@torch.no_grad()
def map_job(mesh, job: dict, dev) -> dict:
    """``evaluate_image_batch`` of a ``TrainDarknet``'s eval detections and
    of perfect detections (the targets themselves) over ``job["batch"]``
    (images, targets); under a process ``mesh`` on this rank's rows, the
    per-image results gathered. Returns ``{"model": (ap, recall, precision,
    valid), "perfect": (...)}`` as numpy over the whole batch."""
    model = _model(job, dev)
    imgs, targets = _local(mesh, job["batch"], dev)
    net = job["spec"].net
    W, H = net.width, net.height
    perfect = torch.zeros((targets.shape[0], 8, 5), device=dev)
    perfect[:, 0, :4] = targets[:, 0, 1:5] * targets.new_tensor([W, H, W, H])
    perfect[:, 0, 4] = 1.0
    out = {}
    for name, dets, conf in (("model", model.detections(imgs), 0.0),
                             ("perfect", perfect, 0.5)):
        ev = evaluate_image_batch(dets, targets, W, H, conf_thresh=conf,
                                  nms_thresh=0.25, iou_thresh=0.5, top_k=8)
        if mesh is not None:
            ev = [all_gather(x.float(), mesh).to(x.dtype) for x in ev]
        out[name] = tuple(x.cpu().numpy() for x in ev)
    return out


def spatial_job(mesh, job: dict, dev) -> dict:
    """The eval forward (``detections``) of a ``TrainDarknet`` on
    ``job["trees"]`` over ``job["batch"]`` (images,): under a
    :class:`Mesh2D` on this rank's batch rows and frame rows
    (``shard_spatial``, H over ``model``), without one on the whole batch;
    ``job["grad"]`` also takes the gradient of the detections' sum with
    respect to the images, ``job["cudnn"]`` as in :func:`run_job`.

    Returns ``{"det": (B, N, 5+C), "grad": (B, H, W, C) or None, "ms": the
    forward's wall time, the device synchronised}`` over the whole batch,
    joined from every rank's part, as numpy; under a mesh also
    ``"collectives"``: this rank's model-axis collectives, and ``"rows"``:
    each model position's frame rows."""
    params, state = job["trees"]
    model = darknet.TrainDarknet(job["spec"], convert.from_jax(params, dev),
                                 convert.from_jax(state, dev)).to(dev)
    imgs = np.asarray(job["batch"][0])
    stride = darknet.coarsest_stride(job["spec"])
    kw, out = {}, {}
    if mesh is None:
        x = torch.from_numpy(imgs).to(dev)
    else:
        x = shard_spatial(mesh, imgs, stride)[0]
        kw = dict(spatial=mesh.model)
        mesh.model.collectives.clear()
    x = x.clone().requires_grad_(bool(job.get("grad")))
    with torch.backends.cudnn.flags(enabled=job.get("cudnn", True)), \
            torch.set_grad_enabled(bool(job.get("grad"))):
        t0 = time.perf_counter()
        det = model.detections(x, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["ms"] = (time.perf_counter() - t0) * 1e3
        if job.get("grad"):
            det.sum().backward()
    grad = None if x.grad is None else x.grad.cpu().numpy()
    det = det.detach().cpu().numpy()
    if mesh is None:
        return dict(out, det=det, grad=grad)
    where = spatial_sharding(mesh, imgs.shape, stride)
    nm = mesh.model.size
    parts = [None] * mesh.size
    dist.all_gather_object(parts, (det, grad))
    # every model position of a data row holds that row's whole detections
    if any(not np.array_equal(parts[r][0], parts[r - r % nm][0]) for r in range(mesh.size)):
        raise RuntimeError("the model ranks' detections differ")
    out["det"] = np.concatenate([d for d, _ in parts[::nm]])
    out["grad"] = None
    if grad is not None:
        out["grad"] = np.zeros(imgs.shape, np.float32)
        for (_, b, rows), (_, g) in zip(where, parts):
            out["grad"][b, rows] = g
    out["collectives"] = list(mesh.model.collectives)
    out["rows"] = [rows for _, _, rows in where[:nm]]
    return out


def run_jobs(mesh, jobs, device=None) -> list:
    """Each job (:func:`run_job`, :func:`map_job` for family ``"map"``,
    :func:`spatial_job` for family ``"spatial"``) under ``mesh`` on its
    device, or without one on ``device``."""
    dev = resolve_device(device) if mesh is None else mesh.device
    runner = {"map": map_job, "spatial": spatial_job}
    return [runner.get(job["family"], run_job)(mesh, job, dev) for job in jobs]


def run_dp_and_2d(mesh: Mesh2D, dp: list, two_d: list) -> tuple:
    """:func:`run_jobs` of ``dp`` on the world's 1-D mesh (the ranks of
    ``mesh`` in their order) and of ``two_d`` on ``mesh`` itself, in one
    launch: a launch spends seconds starting its ranks."""
    return run_jobs(process_mesh(mesh.devices), dp), run_jobs(mesh, two_d)


# ---------------------------------------------------------------------------
# the dry run's cases
# ---------------------------------------------------------------------------


def yolo_targets(rng, B: int, T: int = 3) -> np.ndarray:
    """One box an image, normalised ``[class, cx, cy, w, h]`` (the JAX dry
    run's targets)."""
    t = np.zeros((B, T, 5), np.float32)
    t[:, 0, 1:] = rng.uniform(0.2, 0.8, (B, 4)) * [1, 1, 0.3, 0.3]
    return t


def pixel_corners(targets: np.ndarray, size: int) -> np.ndarray:
    """Normalised ``[c, cx, cy, w, h]`` rows → pixel ``[c, x1, y1, x2, y2]``,
    padding rows kept zero."""
    px = np.zeros_like(targets)
    c, wh = targets[..., 1:3], targets[..., 3:5] / 2
    px[..., 1:3], px[..., 3:5] = (c - wh) * size, (c + wh) * size
    px[targets.sum(-1) == 0] = 0
    return px


def dp_jobs(spec, B: int, seed: int = 0) -> list:
    """The dry run's DP jobs on ``spec`` at global batch ``B``: the YOLO
    step, the device-aug step, the mAP evaluation, the RektNet step
    (cross-batch geometric loss) and the packed-stem YOLO step, each one
    SGD step."""
    rng = np.random.default_rng(seed)
    trees = convert.init_darknet_np(spec, rng)
    imgs = rng.uniform(0, 1, (B, spec.net.height, spec.net.width, 3)).astype(np.float32)
    targets = yolo_targets(rng, B)
    gen = torch.Generator().manual_seed(seed)
    from mit_driverless_cv_traininginfra_tpu_torch.ops.device_aug import sample_draws

    draws = {k: v.numpy() for k, v in sample_draws(gen, B, *imgs.shape[1:]).items()}
    crops, pts = synthetic.rektnet_batch(rng, B)
    return [
        dict(family="yolo", spec=spec, trees=trees, batch=(imgs, targets),
             lr=1e-2, steps=1),
        dict(family="yolo", spec=spec, trees=trees,
             batch=(imgs, pixel_corners(targets, spec.net.height)), draws=[draws],
             lr=1e-2, steps=1),
        dict(family="map", spec=spec, trees=trees, batch=(imgs, targets)),
        dict(family="rektnet", trees=convert.init_rektnet_np(rng, net_size=4),
             batch=(crops, None, pts), lr=1e-2, steps=1,
             step_kw=dict(synth_target_sigma=1.0, geo_loss_gamma_horz=0.05,
                          geo_loss_gamma_vert=0.05, cross_batch=True)),
        dict(family="yolo", spec=spec, trees=trees, batch=(imgs, targets),
             lr=1e-2, steps=1, step_kw=dict(packed_stem=True)),
    ]


def mesh_2d_jobs(spec, B: int, seed: int = 1) -> list:
    """The dry run's 2-D mesh jobs on ``spec`` at global batch ``B``: one
    tensor-parallel × DP YOLO step (SGD, momentum 0.9, lr 1e-2, as the JAX
    tests take it) and the spatial forward, from one seeded tree."""
    rng = np.random.default_rng(seed)
    trees = convert.init_darknet_np(spec, rng)
    imgs = rng.uniform(0, 1, (B, spec.net.height, spec.net.width, 3)).astype(np.float32)
    return [dict(family="yolo", spec=spec, trees=trees, batch=(imgs, yolo_targets(rng, B)),
                 lr=1e-2, momentum=0.9, steps=1),
            dict(family="spatial", spec=spec, trees=trees, batch=(imgs,))]


def trees_close(a, b, rtol: float, atol: float) -> bool:
    """Two trees (dicts and tuples) of arrays equal within the tolerances,
    leaf by leaf."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(trees_close(a[k], b[k], rtol, atol) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(trees_close(x, y, rtol, atol) for x, y in zip(a, b))
    return np.allclose(a, b, rtol=rtol, atol=atol)


def check_mesh_2d(tag: str, spec, devices, jobs: list, got: list) -> None:
    """The TP × DP step and the spatial forward (``jobs``, ``got`` their
    results on an N/2 × 2 mesh), each against this process on the whole
    batch; an ``OK`` line each."""
    n = len(devices)
    tp, sp = got
    tp1, sp1 = run_jobs(None, jobs, devices[0])
    loss, filters = tp["losses"][0], spec.blocks[0].filters
    w0 = tp["parts"][0][0]["0"]["w"]
    if not (np.isfinite(loss).all() and 2 * w0.shape[-1] == filters):
        raise RuntimeError(f"{tag}: TP step loss {loss}, convs['0'] holds "
                           f"{w0.shape[-1]} of {filters} out-channels")
    if not (np.allclose(loss, tp1["losses"][0], rtol=1e-4, atol=1e-6)
            and trees_close(tp["trees"][1], tp1["trees"][1], 2e-4, 2e-6)):
        raise RuntimeError(f"{tag}: TP step (loss {loss}) differs from one "
                           f"device's (loss {tp1['losses'][0]})")
    print(f"{tag}: yolo_train_step[tp x dp, mesh {n // 2}x2] loss={loss[0]:.4f} "
          f"convs['0'] holds {w0.shape[-1]} of {filters} out-channels a rank "
          "= one device's OK")
    if not np.allclose(sp["det"], sp1["det"], rtol=1e-5, atol=1e-5):
        raise RuntimeError(f"{tag}: the spatial forward differs from one device's "
                           f"by {float(np.abs(sp['det'] - sp1['det']).max())}")
    print(f"{tag}: spatial-sharded detections (H over 'model', frame rows "
          f"{[(r.start, r.stop) for r in sp['rows']]}) match one device OK")


def serving_models(spec, frames: np.ndarray, dev, seed: int = 2):
    """bf16 and int8 serving models of ``spec`` (heads sliced to one class)
    and a narrow RektNet from one seeded init: ``{"bf16": (yolo, rekt),
    "int8": (yolo, rekt)}`` on ``dev``; int8 calibrated on ``frames``."""
    rng = np.random.default_rng(seed)
    yp, ys = convert.init_darknet_np(spec, rng)
    rp, rs = convert.init_rektnet_np(rng, net_size=4)
    spec1, folded = stem_opt.slice_preyolo(
        spec, darknet.fold_bn(convert.from_jax(yp, dev), convert.from_jax(ys, dev),
                              spec))
    rfolded = rektnet.fold_bn(convert.from_jax(rp, dev), convert.from_jax(rs, dev))
    amax = quantize.calibrate(spec1, folded, torch.from_numpy(frames).to(dev))
    crops = rng.uniform(0, 1, (8, 80, 80, 3)).astype(np.float32)
    rq = quantize.quantize_rektnet_params(rfolded, quantize.calibrate_rektnet(rfolded, crops))
    return {"bf16": (darknet.Darknet(spec1, folded).to(dtype=torch.bfloat16).eval(),
                     rektnet.RektNet(rfolded).to(dtype=torch.bfloat16).eval()),
            "int8": (quantize.Int8Darknet(spec1, quantize.quantize_params(
                spec1, folded, amax)).to(dev).eval(),
                quantize.Int8RektNet(rq).to(dev).eval())}


def outputs_agree(a, b, kpt_atol: float) -> bool:
    """Masks and boxes bit-equal, keypoints within ``kpt_atol`` px."""
    return (torch.equal(a.mask.cpu(), b.mask.cpu())
            and torch.equal(a.boxes.cpu(), b.boxes.cpu())
            and torch.equal(a.scores.cpu(), b.scores.cpu())
            and torch.allclose(a.keypoints.float().cpu(), b.keypoints.float().cpu(),
                               rtol=0, atol=kpt_atol))


KPT_ATOL = 1e-3   # px at 64²: the same crops through RektNet in another batch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="multi-device dry run")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="ranks and mesh size (default: every CUDA device)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    opt = parser.parse_args(argv)
    dev = resolve_device(opt.device)
    n = opt.n_devices or (torch.cuda.device_count() if dev.type == "cuda" else 2)
    devices = rank_devices(n, opt.device)
    tag = f"dryrun({n}, {dev.type})"
    spec = load_network_spec(TINY_CFG, vanilla_anchor=True)

    B = 2 * n
    jobs = dp_jobs(spec, B)
    two_d = n % 2 == 0 and n >= 4
    if two_d:
        jobs_2d = mesh_2d_jobs(spec, B)
        dp, got_2d = launch(run_dp_and_2d, devices, args=(jobs, jobs_2d),
                            mesh_shape=(n // 2, 2))
    else:
        dp = launch(run_jobs, devices, args=(jobs,))
    one = run_jobs(None, jobs, devices[0])
    for name, j, a, b in zip(("yolo_train_step", "yolo_train_step_device_aug"),
                             jobs[:2], dp[:2], one[:2]):
        if not np.allclose(a["losses"][0], b["losses"][0], rtol=1e-4, atol=1e-6):
            raise RuntimeError(f"{tag}: {name} loss {a['losses'][0]} != one device's "
                               f"{b['losses'][0]}")
        print(f"{tag}: {name} loss={a['losses'][0][0]:.4f} "
              f"comps={np.round(a['losses'][0][1:], 4).tolist()} = one device's OK")
    ap, ap1 = dp[2]["model"][0], one[2]["model"][0]
    perfect = dp[2]["perfect"]
    if not (np.allclose(ap, ap1, atol=1e-6) and np.allclose(perfect[0], 1.0)
            and perfect[3].all()):
        raise RuntimeError(f"{tag}: evaluate_image_batch: AP {ap} vs one device's "
                           f"{ap1}, perfect AP {perfect[0]}")
    print(f"{tag}: evaluate_image_batch mAP={float(ap.mean()):.4f} "
          f"perfect-AP={float(perfect[0].mean()):.4f} over B={B} OK")
    a, b = dp[3]["losses"][0], one[3]["losses"][0]
    if not np.allclose(a, b, rtol=1e-4, atol=1e-6):
        raise RuntimeError(f"{tag}: rektnet_train_step (total, loc, geo) {a} != {b}")
    print(f"{tag}: rektnet_train_step total={a[0]:.4f} loc={a[1]:.4f} "
          f"geo={a[2]:.4f} = one device's OK")
    # run_job held the parameters equal on every rank
    a, b = dp[4]["losses"][0], one[4]["losses"][0]
    if not (np.isfinite(a).all() and np.allclose(a, b, rtol=1e-4, atol=1e-6)):
        raise RuntimeError(f"{tag}: yolo_train_step[packed_stem] loss {a} != one "
                           f"device's {b}")
    print(f"{tag}: yolo_train_step[packed_stem] loss={a[0]:.4f} = one device's, "
          "parameters equal on every rank OK")
    if two_d:
        check_mesh_2d(tag, spec, devices, jobs_2d, got_2d)
    else:
        print(f"{tag}: not run (a 2-D mesh N/2 x 2 needs N even and at least 4): "
              "tensor-parallel x DP, spatial sharding")

    rng = np.random.default_rng(7)
    frames = rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)
    mesh = make_mesh(n, devices=devices)
    models = serving_models(spec, frames, devices[0])
    for label, (yolo, rekt) in models.items():
        x = torch.from_numpy(frames).to(yolo.frame_dtype)
        cfg = dict(conf_thresh=0.0, max_det=4, crop_size=16)
        for cap in (8, 4 * B):
            ref = TwoStageServer(yolo, rekt, **cfg)._dispatch(x, B, cap)
            got = TwoStageServer(yolo, rekt, mesh=mesh, **cfg)._dispatch(x, B, cap)
            if not outputs_agree(ref, got, KPT_ATOL):
                raise RuntimeError(f"{tag}: {label} server over the mesh differs "
                                   f"from one device at capacity {cap}")
        print(f"{tag}: TwoStageServer {label} batch split over {n} devices "
              f"matches one device (capacity 8 and {4 * B}) OK")
    yolo, rekt = models["bf16"]
    micro = [torch.from_numpy(frames[: B // 2]).to(torch.bfloat16),
             torch.from_numpy(frames[B // 2:]).to(torch.bfloat16)]
    cfg = dict(conf_thresh=0.0, max_det=4, crop_size=16, crop_capacity=8)
    pp = TwoStagePP(yolo, rekt, devices[0], devices[-1], **cfg)
    for got, fr in zip(pp(micro), micro):
        ref = two_stage_pipeline(yolo, rekt, fr.to(devices[0]), **cfg)
        if not outputs_agree(ref, got, KPT_ATOL) or got.keypoints.device != devices[-1]:
            raise RuntimeError(f"{tag}: TwoStagePP differs from the fused pipeline")
    print(f"{tag}: TwoStagePP (detect on {devices[0]}, keypoints on {devices[-1]}, "
          f"{len(micro)} microbatches) matches fused OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
