#!/usr/bin/env python3
"""Where the served paths spend their time on one CUDA card.

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/profile_serving.py \
        [--requests 16] [--top 25]

Builds the int8 and the bf16 configuration as ``chip_smoke.py`` does
(seeded YOLOv3-416 sliced to one class, RektNet-16, B=8, int8 calibrated
on the served frames) and prints for each:

- stage times with CUDA events, 10-call windows: detect, NMS (K3),
  crop + keypoints at capacity 112, RektNet alone on 112 crops, and the
  whole pipeline, each with its host-clock time beside it;
- ``torch.profiler`` over ``--requests`` served requests of a warmed
  ``TwoStageServer``: wall time, device kernel time, the device's idle
  share (1 − kernel time / wall), kernels per request, device time by
  kind of kernel and the ``--top`` kernels by device time.

Every line carries the card's name and power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import (  # noqa: E402
    AdaptiveCapacity,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer import pipeline as pl  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import (  # noqa: E402
    TwoStageServer,
)

CAPACITY = 112  # the largest warmed bucket at B=8


def host_ms(fn, iters: int = 10, warm: int = 3) -> float:
    """Mean host-clock milliseconds per call, fenced by synchronisation."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def kind(name: str) -> str:
    """A kernel's kind, by its name."""
    n = name.lower()
    for key, label in (("entry_block", "K4"), ("roi_crop", "K1"),
                       ("softargmax_bwd", "K2-bwd"), ("softargmax", "K2"),
                       ("nms_topk", "K3"), ("rs14conv", "K5")):
        if key in n:
            return label
    if "igemm" in n or "imma" in n or ("gemm" in n and "s8" in n):
        return "int8 gemm"
    if "dgemm" in n or "double" in n:
        return "f64"
    if any(k in n for k in ("conv", "gemm", "xmma", "cutlass", "sm90", "nvjet")):
        return "conv/gemm"
    for key in ("cat", "copy", "round", "clamp", "mul", "add", "where", "pad",
                "fill"):
        if key in n:
            return key
    return "other"


def stages(label, yolo, rekt, frames, thresh, smi) -> None:
    dets = yolo(frames)
    boxes, scores, mask = pl._postprocess(dets, thresh, 0.25, cs.MAX_DET)
    crops = torch.rand((CAPACITY, 80, 80, 3), device=frames.device).to(
        frames.dtype)
    kw = dict(conf_thresh=thresh, max_det=cs.MAX_DET, crop_capacity=CAPACITY)
    calls = {
        "detect": lambda: yolo(frames),
        "nms": lambda: pl._postprocess(dets, thresh, 0.25, cs.MAX_DET),
        "crop+keypoints": lambda: pl._crops_and_keypoints(
            lambda c: rekt(c)[1], frames, boxes, scores, mask, 80, CAPACITY),
        "rektnet": lambda: rekt(crops),
        "pipeline": lambda: pl.two_stage_pipeline(yolo, rekt, frames, **kw),
    }
    times = {k: (cs.cuda_ms(fn, iters=10, warm=3), host_ms(fn))
             for k, fn in calls.items()}
    print(f"{label} stages ms (events, host): "
          + ", ".join(f"{k} {e!r} / {h!r}" for k, (e, h) in times.items())
          + f" on {smi}", flush=True)


def profile_served(label, yolo, rekt, frames, thresh, smi, n: int,
                   top: int) -> None:
    policy = AdaptiveCapacity(floor=64, quantum=16, warmup_capacity=96)
    server = TwoStageServer(yolo, rekt, conf_thresh=thresh,
                            max_det=cs.MAX_DET, policy=policy)
    server.warmup([cs.B_SERVE], capacities=[64, 80, 96, CAPACITY])
    for _ in range(4):
        server(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            server(frames)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kind, rows, total, count = defaultdict(float), [], 0.0, 0
    for e in prof.key_averages():
        d = getattr(e, "self_device_time_total", 0) / 1e3
        if d <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_kind[kind(e.key)] += d
        total += d
        count += e.count
        rows.append((d, e.count, e.key[:110]))
    print(f"{label} profile: {n} requests, wall {wall!r} ms, device kernel "
          f"time {total!r} ms, idle share {1 - total / wall!r}, kernels "
          f"{count} ({count / n:.0f}/request) on {smi}", flush=True)
    print(f"{label} device ms by kind: " + json.dumps(
        dict(sorted(by_kind.items(), key=lambda kv: -kv[1]))), flush=True)
    for d, c, k in sorted(rows, reverse=True)[:top]:
        print(f"  {label} {d:10.3f} ms  n {c:6d}  {k}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    cs.phase_build()
    frames_np, _ = synthetic.yolo_batch(np.random.default_rng(42), cs.B_SERVE, cs.SIZE)
    yq, rq = cs.int8_models(cs.quantize_on_card(dev, frames_np), dev)
    yb, rb = cs.build_models(dev, torch.bfloat16)
    yb.to(memory_format=torch.channels_last)
    rb.to(memory_format=torch.channels_last)
    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    with torch.inference_mode():
        for label, yolo, rekt in (("int8", yq, rq), ("bf16", yb, rb)):
            thresh = cs.pick_conf_thresh(
                yolo.detections(frames, with_classes=False), cs.MAX_DET)
            stages(label, yolo, rekt, frames, thresh, smi)
            profile_served(label, yolo, rekt, frames, thresh, smi,
                           args.requests, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
