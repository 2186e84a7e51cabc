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
- ``evaluate_image_batch`` over the sharded batch, its per-image results
  gathered (and perfect detections, AP 1 on every image);
- the DP RektNet step (cross-batch geometric loss);
- the bf16 and int8 ``TwoStageServer(mesh=)`` on a batch split over the
  mesh, equal to the server without one;
- ``TwoStagePP`` (stage A on the first device, stage B on the last),
  equal to the fused pipeline.

Left out, as the port has no such surface yet: the packed-stem step, the
tensor-parallel × DP step and the spatially sharded forward (ROADMAP).

:func:`run_jobs` is the DP step runner the dry run, ``chip_smoke.py`` and
the tests share: the same seeded jobs run under a process mesh (one rank's
rows) or without one (the whole batch), and the results come back as
numpy in the JAX package's tree layout.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

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
    all_gather,
    make_mesh,
    replicate,
    shard_batch,
)
from mit_driverless_cv_traininginfra_tpu_torch.train import optim, steps

TINY_CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures", "tiny_test.cfg")


# ---------------------------------------------------------------------------
# the DP step runner
# ---------------------------------------------------------------------------


def _model(job, dev):
    params, state = job["trees"]
    p, s = convert.from_jax(params, dev), convert.from_jax(state, dev)
    if job["family"] == "rektnet":
        return rektnet.KeypointNet(p, s).to(dev)
    return darknet.TrainDarknet(job["spec"], p, s).to(dev)


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
    (no momentum) and ``job["step_kw"]``; ``job["cudnn"] = False`` runs the
    convolutions without cuDNN (its algorithm picks depend on the batch
    size, so a rank's half batch may sum in another algorithm). Under a
    process ``mesh`` this rank takes its rows, and the trees must end
    bit-equal on every rank.

    Returns ``{"losses": [one flat array a step: the step's returned
    values], "trees": {step: (params, state)}, "ms": [a step's wall time,
    the device synchronised], "launches": K2's forward and backward
    wrapper counts over the steps}``, the trees for the steps in
    ``job["keep"]`` (default the last), JAX-layout numpy."""
    model = _model(job, dev)
    opt = optim.make_optimizer(model.parameters(), job.get("optimizer", "SGD"),
                               lr=job["lr"], momentum=0.0)
    batch = _local(mesh, job["batch"], dev)
    kw = dict(job.get("step_kw", {}), mesh=mesh)
    keep = set(job.get("keep", (job["steps"],)))
    out = {"losses": [], "trees": {}, "ms": []}
    fused_softargmax.launches = softargmax_bwd.launches = 0
    with torch.backends.cudnn.flags(enabled=job.get("cudnn", True)):
        _steps(model, opt, batch, job, kw, dev, keep, out)
    out["launches"] = {"softargmax": fused_softargmax.launches,
                       "softargmax_bwd": softargmax_bwd.launches}
    if mesh is not None:
        _check_equal_on_ranks(model, mesh)
    return out


def _steps(model, opt, batch, job, kw, dev, keep, out) -> None:
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
            p, s = model.trees()
            out["trees"][t + 1] = (convert.to_jax(p), convert.to_jax(s))


def _check_equal_on_ranks(model, mesh) -> None:
    """Rank 0's parameters and buffers, broadcast, against this rank's."""
    mine = torch.cat([t.detach().reshape(-1).float()
                      for t in list(model.parameters()) + list(model.buffers())])
    ref = mine.clone()
    replicate(mesh, [ref])
    if not torch.equal(ref, mine):
        raise RuntimeError(f"rank {mesh.rank}: parameters differ from rank 0's "
                           f"(max |Δ| {float((ref - mine).abs().max())})")


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


def run_jobs(mesh, jobs, device=None) -> list:
    """Each job (:func:`run_job`, or :func:`map_job` for family ``"map"``)
    under ``mesh`` on its device, or without one on ``device``."""
    dev = resolve_device(device) if mesh is None else mesh.device
    return [(map_job if job["family"] == "map" else run_job)(mesh, job, dev)
            for job in jobs]


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
    step, the device-aug step, the mAP evaluation and the RektNet step
    (cross-batch geometric loss), each one SGD step."""
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
    ]


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
    print(f"{tag}: not run (no such surface in the port yet): packed_stem, "
          "tensor-parallel x DP, spatial sharding")
    return 0


if __name__ == "__main__":
    sys.exit(main())
