#!/usr/bin/env python3
"""YOLO and RektNet training throughput on one CUDA card (the JAX package's
``tools/bench_train.py``).

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/bench_train.py [--yolo-batches 32,64,128] [--batches 32,128] [--iters 32]

YOLO: ``yolo_train_step`` (Adam lr 1e-4) on YOLOv3-416, one class
(``flagship_spec(416, classes=1)``), from ``init_params``, on random frames
with three boxes each, in f32 and bf16 compute; one JSON line per
configuration: step ms (host clock over ``--iters`` steps after 3 warm-up
steps, ending in a synchronise), frames/s, the achieved TFLOP/s of the
convolutions (train step = 3 × forward, ``utils.profiling.conv_graph_flops``)
and the peak of ``torch.cuda.max_memory_allocated`` over the run. A
configuration that runs out of memory prints its error instead.
``--yolo-batches ''`` skips YOLO, ``--batches ''`` RektNet.

RektNet: ``rektnet_train_step`` (Adam lr 1e-3, l1 soft-argmax loss with the
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
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import (  # noqa: E402
    flagship_spec,
)
from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, rektnet  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.train.optim import (  # noqa: E402
    make_optimizer,
)
from mit_driverless_cv_traininginfra_tpu_torch.train.steps import (  # noqa: E402
    rektnet_train_step,
    yolo_train_step,
)
from mit_driverless_cv_traininginfra_tpu_torch.utils.profiling import (  # noqa: E402
    conv_graph_flops,
    time_ms,
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


def yolo_inputs(rng, B: int, size: int, dev):
    """B random frames (B, size, size, 3) and their (B, 8, 5) targets,
    three boxes each, on ``dev``."""
    images = rng.uniform(0, 1, (B, size, size, 3)).astype(np.float32)
    targets = np.zeros((B, 8, 5), np.float32)
    targets[:, :3, 1:] = rng.uniform(0.2, 0.8, (B, 3, 4)) * [1, 1, .2, .2]
    return torch.from_numpy(images).to(dev), torch.from_numpy(targets).to(dev)


def bench_yolo(batches=(32, 64, 128), iters: int = 32, device="cuda",
               dtypes=("float32", "bfloat16"), size: int = 416):
    dev = resolve_device(device)
    spec = flagship_spec(size, classes=1)
    step_gf = 3.0 * conv_graph_flops(spec) / 1e9
    rng = np.random.default_rng(0)
    results = []
    for B in batches:
        images, targets = yolo_inputs(rng, B, size, dev)
        for dt in dtypes:
            name = f"yolo{size} B={B} {dt}"
            model = opt = None
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            try:
                model = darknet.TrainDarknet(spec, *darknet.init_params(
                    spec, torch.Generator().manual_seed(0))).to(dev)
                opt = make_optimizer(model.parameters(), "Adam", lr=1e-4)
                loss = []

                def once():
                    loss[:] = yolo_train_step(model, opt, images, targets,
                                              compute_dtype=dt)[:1]
                    return loss[0]

                ms = time_ms(once, lambda out: out, iters, warmup=3)
                r = {"config": name, "device": str(dev), "step_ms": ms,
                     "frames_per_s": B * 1e3 / ms, "tflops": step_gf * B / ms,
                     "loss": float(loss[0])}
            except torch.OutOfMemoryError as e:
                r = {"config": name, "device": str(dev), "error": str(e)[:200]}
            if dev.type == "cuda":
                r["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
            print(json.dumps(r), flush=True)
            results.append(r)
            del model, opt
    return results


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

            total = []

            def once():
                total[:] = rektnet_train_step(
                    model, opt, crops, None, points, loss_type="l1_softargmax",
                    include_geo=True, geo_loss_gamma_horz=0.05,
                    geo_loss_gamma_vert=0.05, compute_dtype=dt,
                    synth_target_sigma=1.0)[:1]
                return total[0]

            ms = time_ms(once, lambda out: out, iters, warmup)
            r = {"config": f"rektnet80 B={B} {dt}", "device": str(dev),
                 "step_ms": ms, "crops_per_s": B * 1e3 / ms,
                 "tflops": step_gf * B / ms, "loss": float(total[0])}
            print(json.dumps(r), flush=True)
            results.append(r)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="32,128", help="RektNet batches")
    ap.add_argument("--yolo-batches", default="32,64,128")
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(), flush=True)
    def batches(text):
        return tuple(int(b) for b in text.split(",") if b)

    bench_yolo(batches(args.yolo_batches), args.iters, args.device)
    bench_rektnet(batches(args.batches), args.iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
