#!/usr/bin/env python3
"""Train the full YOLOv3 or RektNet on synthetic cone data on one card and
report held-out accuracy at the serving operating point, with wall-clock
(the port's copy of the repository's ``tools/train_to_map.py``)::

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/train_to_map.py \\
        [--steps 3000] [--batch 32] [--size 416] [--device cpu]
    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/train_to_map.py \\
        --family rektnet [--steps 1500]

YOLO (``flagship_train_to_map_416``): ``config/flagship.flagship_spec``
(80 classes) from ``init_params`` (seed 0), a device-resident pool of
``--pool`` scenes (``data/synthetic.yolo_batch``, seed 0), bf16
``yolo_train_step`` under Adam with ``clip_by_global_norm(10.0)`` and a
warmup → hold → cosine schedule; then mAP, recall and precision at conf
0.8, NMS 0.25, IoU 0.5 of the BN-folded f32 ``Darknet`` and of its int8
PTQ ``Int8Darknet`` (calibrated on 8 pool scenes) on ``--eval-n`` fresh
scenes (seed 999), in chunks of 16.

RektNet (``rektnet_train_to_l2_80``, batch 256 and 1500 steps unless
``--batch``/``--steps`` say otherwise): ``rektnet_train_step`` in bf16
(``l1_softargmax`` with the geometric loss at 0.05/0.05, Gaussian targets
made on the device) on a pool of 2048 crops, Adam at a constant 3e-3 and
then a cosine over the last third; the mean keypoint L2 of the folded f32
``RektNet`` and of ``Int8RektNet`` on 256 fresh crops. Each step launches
K2 and K2's backward once.

The schedule is a host function of the step (``train/optim.py``, optax's
formulas in f32) that writes the learning rate before each step; the
first step (count 0) runs outside the clock, ended by a synchronise.
Runs on the card unless ``--device cpu``. Prints one JSON line per run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from mit_driverless_cv_traininginfra_tpu_torch.device import full_f32, resolve_device  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.train.optim import (  # noqa: E402
    constant_schedule,
    cosine_decay_schedule,
    join_schedules,
    linear_schedule,
    make_optimizer,
    set_lr,
)

CHUNK = 16  # eval frames a forward: B=64 f32 at 416² beside training state is large
# RektNet: the crop pool, the held-out crops and the int8 calibration crops
RK_POOL, RK_EVAL, RK_CALIB = 2048, 256, 64


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--hold", type=float, default=0.67)
    ap.add_argument("--pool", type=int, default=128)
    ap.add_argument("--eval-n", type=int, default=64)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--family", default="yolo", choices=["yolo", "rektnet"])
    ap.add_argument("--min-h", type=int, default=18,
                    help="scene cone height range (default: the bench distribution)")
    ap.add_argument("--max-h", type=int, default=120)
    ap.add_argument("--save-weights", type=str, default="",
                    help="also write the trained model as a Darknet .weights file")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def yolo_schedule(steps: int, lr: float, hold_frac: float):
    """Linear warmup from 0 over ``min(200, hold // 2)`` steps, ``lr`` held
    to ``hold = int(steps · hold_frac)``, then a cosine to 0 over the rest:
    the 62M-parameter graph from scratch diverges at B=32 without the
    warmup and the clip."""
    hold = int(steps * hold_frac)
    warm = min(200, hold // 2)
    return join_schedules([linear_schedule(0.0, lr, warm), constant_schedule(lr),
                           cosine_decay_schedule(lr, steps - hold)], [warm, hold])


def rektnet_schedule(steps: int):
    """3e-3 to ``2·steps // 3``, then a cosine to 0 over ``steps // 3``."""
    return join_schedules([constant_schedule(3e-3),
                           cosine_decay_schedule(3e-3, steps // 3)], [2 * steps // 3])


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.family == "rektnet":
        return rektnet_main(args, dev)

    from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec
    from mit_driverless_cv_traininginfra_tpu_torch.data.synthetic import yolo_batch
    from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import (
        Darknet,
        TrainDarknet,
        init_params,
        save_darknet_weights,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.models.quantize import (
        Int8Darknet,
        calibrate,
        quantize_params,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.ops.metrics import (
        ImageEval,
        evaluate_image_batch,
        summarize,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import yolo_train_step

    scenes = dict(max_cones=8, min_h=args.min_h, max_h=args.max_h, max_overlap=0.1)
    spec = flagship_spec(args.size)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    pool_i, pool_t = yolo_batch(rng, args.pool, size=args.size, **scenes)
    pool_i = torch.from_numpy(pool_i).to(dev)  # the device-resident pool
    pool_t = torch.from_numpy(pool_t).to(dev)
    t_render = time.perf_counter() - t0

    model = TrainDarknet(spec, *init_params(spec, torch.Generator().manual_seed(0))).to(dev)
    lr_fn = yolo_schedule(args.steps, args.lr, args.hold)
    opt = make_optimizer(model.parameters(), "Adam", lr=lr_fn(0), grad_clip=10.0)

    # the first step (Adam's count 0) outside the clock: it builds and
    # autotunes, which would cut the reported imgs/sec
    set_lr(opt, lr_fn(0))
    yolo_train_step(model, opt, pool_i[:args.batch], pool_t[:args.batch],
                    compute_dtype="bfloat16")
    _sync(dev)

    t0 = time.perf_counter()
    loss = None
    for step in range(args.steps):
        idx = torch.from_numpy(rng.integers(0, args.pool, args.batch)).to(dev)
        set_lr(opt, lr_fn(step + 1))
        loss, _ = yolo_train_step(model, opt, pool_i[idx], pool_t[idx],
                                  compute_dtype="bfloat16")
        if step % 250 == 0:
            lv = float(loss)
            print(f"step {step}: loss {lv:.3f} ({time.perf_counter() - t0:.0f}s)",
                  file=sys.stderr)
            if not np.isfinite(lv):
                print("training diverged (NaN), aborting", file=sys.stderr)
                return 1
    final_loss = float(loss)  # ends the chain
    t_train = time.perf_counter() - t0

    full_f32(dev)
    folded = model.folded()
    q = quantize_params(spec, folded, calibrate(spec, folded, pool_i[:8]))
    if args.save_weights:
        save_darknet_weights(spec, *model.trees(), args.save_weights)
        print(f"weights -> {args.save_weights}", file=sys.stderr)
    del pool_i, pool_t, model, opt  # free the card's memory before the eval
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ev_i, ev_t = yolo_batch(np.random.default_rng(999), args.eval_n, size=args.size, **scenes)
    models = {"f32": Darknet(spec, folded).eval(), "int8": Int8Darknet(spec, q).eval()}
    evs = {k: [] for k in models}
    with torch.inference_mode():
        for c0 in range(0, args.eval_n, CHUNK):
            x = torch.from_numpy(ev_i[c0:c0 + CHUNK]).to(dev)
            t = torch.from_numpy(ev_t[c0:c0 + CHUNK]).to(dev)
            for k, m in models.items():
                dets = m.detections(x.to(m.frame_dtype), with_classes=False).float()
                evs[k].append(evaluate_image_batch(dets, t, args.size, args.size,
                                                   conf_thresh=0.8, nms_thresh=0.25,
                                                   iou_thresh=0.5, top_k=32))
    ev32, ev8 = (ImageEval(*(torch.cat([getattr(e, f) for e in evs[k]])
                             for f in ImageEval._fields)) for k in ("f32", "int8"))
    map32, r32, p32 = summarize(ev32)
    map8, _, _ = summarize(ev8)

    print(json.dumps({
        "metric": "flagship_train_to_map_416",
        "steps": args.steps, "batch": args.batch,
        "imgs_seen": args.steps * args.batch,
        "final_loss": round(final_loss, 3),
        "train_s": round(t_train, 1),
        "render_s": round(t_render, 1),
        "imgs_per_sec": round(args.steps * args.batch / t_train, 1),
        "eval_n": args.eval_n,
        "map_f32_conf08": round(map32, 4),
        "recall_f32": round(r32, 4), "precision_f32": round(p32, 4),
        "map_int8_conf08": round(map8, 4),
        "int8_map_delta": round(map32 - map8, 4),
        "valid_images": int(ev32.valid.sum()),
    }))
    return 0


def rektnet_main(args, dev) -> int:
    """RektNet: train on synthetic crops, report the held-out keypoint L2
    (f32 and int8) with wall-clock."""
    from mit_driverless_cv_traininginfra_tpu_torch.data.synthetic import rektnet_batch
    from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet
    from mit_driverless_cv_traininginfra_tpu_torch.models.quantize import (
        Int8RektNet,
        calibrate_rektnet,
        quantize_rektnet_params,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import rektnet_train_step

    steps = args.steps if args.steps != 3000 else 1500
    batch = args.batch if args.batch != 32 else 256
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    pool_i, pool_p = (torch.from_numpy(a).to(dev) for a in rektnet_batch(rng, RK_POOL))
    t_render = time.perf_counter() - t0

    model = rektnet.KeypointNet(*rektnet.init(torch.Generator().manual_seed(1))).to(dev)
    lr_fn = rektnet_schedule(steps)
    opt = make_optimizer(model.parameters(), "Adam", lr=lr_fn(0))
    dummy = torch.zeros((1,), device=dev)  # the targets are made on the device
    kw = dict(loss_type="l1_softargmax", include_geo=True, geo_loss_gamma_horz=0.05,
              geo_loss_gamma_vert=0.05, compute_dtype="bfloat16", synth_target_sigma=1.0)

    set_lr(opt, lr_fn(0))  # the first step outside the clock
    rektnet_train_step(model, opt, pool_i[:batch], dummy, pool_p[:batch], **kw)
    _sync(dev)

    t0 = time.perf_counter()
    total = None
    for step in range(steps):
        idx = torch.from_numpy(rng.integers(0, pool_i.shape[0], batch)).to(dev)
        set_lr(opt, lr_fn(step + 1))
        total, _, _ = rektnet_train_step(model, opt, pool_i[idx], dummy, pool_p[idx], **kw)
        if step % 250 == 0:
            print(f"step {step}: loss {float(total):.4f} ({time.perf_counter() - t0:.0f}s)",
                  file=sys.stderr)
    final_loss = float(total)
    t_train = time.perf_counter() - t0

    full_f32(dev)
    ev_i, ev_p = rektnet_batch(np.random.default_rng(999), RK_EVAL)
    ev_i = torch.from_numpy(ev_i).to(dev)
    folded = rektnet.fold_bn(*model.trees())
    with torch.inference_mode():
        _, pts32 = rektnet.RektNet(folded).eval()(ev_i)
        q = quantize_rektnet_params(folded, calibrate_rektnet(folded, pool_i[:RK_CALIB]))
        _, pts8 = Int8RektNet(q).eval()(ev_i)
    l2_32, l2_8 = (float(np.linalg.norm(p.float().cpu().numpy() - ev_p, axis=-1).mean())
                   for p in (pts32, pts8))

    print(json.dumps({
        "metric": "rektnet_train_to_l2_80",
        "steps": steps, "batch": batch,
        "imgs_seen": steps * batch,
        "final_loss": round(final_loss, 4),
        "train_s": round(t_train, 1),
        "render_s": round(t_render, 1),
        "imgs_per_sec": round(steps * batch / t_train, 1),
        "eval_n": RK_EVAL,
        "kpt_l2_f32": round(l2_32, 5),
        "kpt_l2_f32_px80": round(l2_32 * 80, 2),
        "kpt_l2_int8": round(l2_8, 5),
        "int8_l2_delta": round(l2_8 - l2_32, 5),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
