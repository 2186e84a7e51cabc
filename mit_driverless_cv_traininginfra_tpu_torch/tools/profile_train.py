#!/usr/bin/env python3
"""Where a RektNet training step spends its time on one CUDA card.

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/profile_train.py \
        [--batches 32,128] [--steps 10] [--top 12]

For each batch and compute dtype (f32, bf16) it warms ``tools/bench_train.py``'s
step (Adam, l1 soft-argmax + geometric loss, device targets, full width)
for 3 steps, then runs ``--steps`` steps under ``torch.profiler`` and
prints the wall time, the device's kernel time and idle share (1 − kernel
time / wall), kernels per step, device time by kind of kernel (the
classifier of ``tools/profile_serving.py``) and the ``--top`` kernels.
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
from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.tools.profile_serving import (  # noqa: E402
    kind,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.optim import (  # noqa: E402
    make_optimizer,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.steps import (  # noqa: E402
    rektnet_train_step,
)


def profile_steps(B: int, dtype: str, steps: int, top: int, smi: str, dev) -> None:
    rng = np.random.default_rng(1)
    crops = torch.from_numpy(rng.uniform(0, 1, (B, 80, 80, 3)).astype(np.float32)).to(dev)
    points = torch.from_numpy(rng.uniform(0.1, 0.9, (B, 7, 2)).astype(np.float32)).to(dev)
    model = rektnet.KeypointNet(*rektnet.init(torch.Generator().manual_seed(1))).to(dev)
    opt = make_optimizer(model.parameters(), "Adam", lr=1e-3)

    def step():
        return rektnet_train_step(model, opt, crops, None, points, compute_dtype=dtype,
                                  **cs.TRAIN_KW)

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
    for e in prof.key_averages():
        d = getattr(e, "self_device_time_total", 0) / 1e3
        if d <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_kind[kind(e.key)] += d
        total += d
        count += e.count
        rows.append((d, e.count, e.key[:110]))
    label = f"train B={B} {dtype}"
    print(f"{label}: {steps} steps, wall {wall / steps!r} ms/step, device kernel "
          f"time {total / steps!r} ms/step, idle share {1 - total / wall!r}, "
          f"kernels {count / steps:.0f}/step on {smi}", flush=True)
    print(f"{label} device ms/step by kind: " + json.dumps(
        {k: v / steps for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])}),
        flush=True)
    for d, c, k in sorted(rows, reverse=True)[:top]:
        print(f"  {label} {d / steps:9.4f} ms/step  n {c:6d}  {k}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="32,128")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = torch.device("cuda:0")
    cs.phase_build()
    for B in (int(b) for b in args.batches.split(",")):
        for dtype in ("float32", "bfloat16"):
            profile_steps(B, dtype, args.steps, args.top, smi, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
