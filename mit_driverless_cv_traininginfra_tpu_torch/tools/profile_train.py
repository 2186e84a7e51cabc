#!/usr/bin/env python3
"""Where a RektNet or YOLO training step spends its time on one CUDA card.

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/profile_train.py \
        [--model rektnet|yolo] [--batches 32,128] [--dtypes float32,bfloat16] \
        [--size 416] [--stem] [--steps 10] [--top 12]

For each batch and compute dtype it warms ``tools/bench_train.py``'s
step for 3 steps — RektNet: Adam, l1 soft-argmax + geometric loss, device
targets, full width; YOLO: Adam, YOLOv3 one class at ``--size``², random
frames with three boxes — then runs ``--steps`` steps under ``torch.profiler``
and prints the wall time, the device's kernel time and idle share (1 −
kernel time / wall), kernels per step, the host's operator calls per
step and its time in calls that wait for the device (synchronize, copies
to the host), device time by kind of kernel (the classifier of
``tools/profile_serving.py``) and the ``--top`` kernels. Every line
carries the card's name and power limit (nvidia-smi). ``--stem`` (YOLO)
also profiles the stem alone — conv blocks 0-1 with their batch norm and
leaky, forward and backward from the frames, as the step runs them — and
prints its device time as a share of the step's.
"""

from __future__ import annotations

import argparse
import functools
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
from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import (  # noqa: E402
    flagship_spec,
)
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, rektnet  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.tools.bench_train import (  # noqa: E402
    yolo_inputs,
)
from mit_driverless_cv_traininginfra_tpu_torch.tools.profile_serving import (  # noqa: E402
    kind,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.optim import (  # noqa: E402
    make_optimizer,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.steps import (  # noqa: E402
    rektnet_train_step,
    yolo_train_step,
)

# host calls in which the host waits for the device (cudaMemcpyAsync is
# not one: it blocks only when the launch queue is full)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
         "cudaEventSynchronize")


def rektnet_step(B: int, dtype: str, dev):
    rng = np.random.default_rng(1)
    crops = torch.from_numpy(rng.uniform(0, 1, (B, 80, 80, 3)).astype(np.float32)).to(dev)
    points = torch.from_numpy(rng.uniform(0.1, 0.9, (B, 7, 2)).astype(np.float32)).to(dev)
    model = rektnet.KeypointNet(*rektnet.init(torch.Generator().manual_seed(1))).to(dev)
    opt = make_optimizer(model.parameters(), "Adam", lr=1e-3)
    return lambda: rektnet_train_step(model, opt, crops, None, points,
                                      compute_dtype=dtype, **cs.TRAIN_KW)


def yolo_model(size: int, dev):
    spec = flagship_spec(size, classes=1)
    return darknet.TrainDarknet(spec, *darknet.init_params(
        spec, torch.Generator().manual_seed(0))).to(dev)


def yolo_step(B: int, dtype: str, dev, size: int = 416):
    model = yolo_model(size, dev)
    images, targets = yolo_inputs(np.random.default_rng(0), B, size, dev)
    opt = make_optimizer(model.parameters(), "Adam", lr=1e-4)
    return lambda: yolo_train_step(model, opt, images, targets, compute_dtype=dtype)


def stem_step(B: int, dtype: str, dev, size: int = 416):
    """Blocks 0-1 of the YOLO step alone: the two convolutions with their
    batch norm (batch statistics) and leaky on the frames, and their
    backward from a gradient of ones (no gradient into the frames)."""
    model = yolo_model(size, dev)
    images, _ = yolo_inputs(np.random.default_rng(0), B, size, dev)
    conv = functools.partial(model._conv, train=True, dtype=getattr(torch, dtype))

    def step():
        out = model._walk(images.to(getattr(torch, dtype)), 2, conv)[0]
        out.backward(torch.ones_like(out))

    return step


def profile_steps(make, B: int, dtype: str, steps: int, top: int, smi: str, dev,
                  name: str = "train") -> float:
    """Profile ``steps`` steps of ``make(B, dtype, dev)``, print, and
    return the device kernel time a step (ms)."""
    step = make(B, dtype, dev)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kind, rows, total, count = defaultdict(float), [], 0.0, 0
    ops, waits = 0, defaultdict(float)
    for e in prof.key_averages():
        if e.key.startswith("aten::") and e.device_type == torch.autograd.DeviceType.CPU:
            ops += e.count
        if e.key in WAITS:
            waits[f"{e.key} x{e.count // steps}"] += e.self_cpu_time_total / 1e3 / steps
        d = getattr(e, "self_device_time_total", 0) / 1e3
        if d <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_kind[kind(e.key)] += d
        total += d
        count += e.count
        rows.append((d, e.count, e.key[:110]))
    label = f"{name} B={B} {dtype}"
    print(f"{label}: {steps} steps, wall {wall / steps!r} ms/step, device kernel "
          f"time {total / steps!r} ms/step, idle share {1 - total / wall!r}, "
          f"kernels {count / steps:.0f}/step, aten calls {ops / steps:.0f}/step, "
          f"host waiting {sum(waits.values())!r} ms/step {dict(waits)} on {smi}",
          flush=True)
    print(f"{label} device ms/step by kind: " + json.dumps(
        {k: v / steps for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])}),
        flush=True)
    for d, c, k in sorted(rows, reverse=True)[:top]:
        print(f"  {label} {d / steps:9.4f} ms/step  n {c:6d}  {k}")
    return total / steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("rektnet", "yolo"), default="rektnet")
    ap.add_argument("--batches", default="32,128")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--size", type=int, default=416, help="YOLO frame size")
    ap.add_argument("--stem", action="store_true",
                    help="YOLO: also the stem's device time and share of the step")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = torch.device("cuda:0")
    cs.phase_build()
    yolo = args.model == "yolo"
    make = functools.partial(yolo_step, size=args.size) if yolo else rektnet_step
    name = f"yolo{args.size}" if yolo else "train"
    for B in (int(b) for b in args.batches.split(",")):
        for dtype in args.dtypes.split(","):
            step_ms = profile_steps(make, B, dtype, args.steps, args.top, smi, dev, name)
            if yolo and args.stem:
                stem_ms = profile_steps(functools.partial(stem_step, size=args.size), B,
                                        dtype, args.steps, 4, smi, dev, f"stem{args.size}")
                print(f"{name} B={B} {dtype}: the stem (blocks 0-1, forward and "
                      f"backward) {stem_ms!r} of the step's {step_ms!r} device ms "
                      f"= {stem_ms / step_ms!r} on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
