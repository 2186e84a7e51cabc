#!/usr/bin/env python3
"""RektNet training throughput on one CUDA card (the RektNet half of the
JAX package's ``tools/bench_train.py``).

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/bench_train.py [--batches 32,128] [--iters 32]

Runs ``rektnet_train_step`` (Adam lr 1e-3, l1 soft-argmax loss with the
geometric terms on, Gaussian targets made on the device) at full width
(net_size 16, 80×80 crops, 7 keypoints) on random crops, in f32 and bf16
compute, and prints one JSON line per configuration: step ms (host clock
over ``--iters`` steps after 3 warm-up steps, ending in a synchronise),
crops/s and the achieved TFLOP/s of the convolutions (train step = 3 ×
forward). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.train.optim import (  # noqa: E402
    make_optimizer,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.steps import (  # noqa: E402
    rektnet_train_step,
)


def rektnet_forward_flops(net_size: int = rektnet.NET_SIZE, size: int = 80,
                          num_kpt: int = 7) -> int:
    """Convolution FLOPs (2 per multiply-add) of one crop's forward."""
    hw = size * size
    macs = 7 * 7 * 3 * net_size
    for cin, cout in rektnet._res_block_channels(net_size):
        macs += 9 * cin * cout + 9 * cout * cout + cin * cout
    macs += net_size * 8 * num_kpt
    return 2 * macs * hw


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_rektnet(batches=(32, 128), iters: int = 32, device="cuda",
                  dtypes=("float32", "bfloat16"), warmup: int = 3):
    dev = resolve_device(device)
    step_gf = 3.0 * rektnet_forward_flops() / 1e9
    rng = np.random.default_rng(1)
    results = []
    for B in batches:
        crops = torch.from_numpy(rng.uniform(0, 1, (B, 80, 80, 3)).astype(np.float32)).to(dev)
        points = torch.from_numpy(rng.uniform(0.1, 0.9, (B, 7, 2)).astype(np.float32)).to(dev)
        for dt in dtypes:
            model = rektnet.KeypointNet(*rektnet.init(torch.Generator().manual_seed(1))).to(dev)
            opt = make_optimizer(model.parameters(), "Adam", lr=1e-3)

            def once():
                return rektnet_train_step(
                    model, opt, crops, None, points, loss_type="l1_softargmax",
                    include_geo=True, geo_loss_gamma_horz=0.05,
                    geo_loss_gamma_vert=0.05, compute_dtype=dt,
                    synth_target_sigma=1.0)[0]

            for _ in range(warmup):
                once()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                total = once()
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3 / iters
            r = {"config": f"rektnet80 B={B} {dt}", "device": str(dev),
                 "step_ms": ms, "crops_per_s": B * 1e3 / ms,
                 "tflops": step_gf * B / ms, "loss": float(total)}
            print(json.dumps(r), flush=True)
            results.append(r)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="32,128")
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(), flush=True)
    bench_rektnet(tuple(int(b) for b in args.batches.split(",")), args.iters,
                  args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
