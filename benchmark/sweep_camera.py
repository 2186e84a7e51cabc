#!/usr/bin/env python3
"""The knee of a camera-stream cell: the highest offered rate the program
sustains without a growing backlog, by a sweep on the card in one process.

    python3 benchmark/sweep_camera.py --workload NAME --seed N \
        --rates 400,600,800,... [--seconds 10]

For each rate it offers the cell's streams for ``--seconds`` and prints one
JSON line: the rate, the frames due, those answered inside the window, the
backlog at the window's close (frames submitted and not yet answered), the
p50 and p95 of the time from due to answered, and how late the generator
ran. The knee is the highest rate at which 99% of the frames due in the
window were answered inside it (no backlog that grows through the window);
the cell then offers 0.8 of it (``rate_fps`` of its traffic file).
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from yardstick import harness, reference, serve  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_bench(ROOT)
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.load_config(bench, ROOT, cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    reference.full_f32()
    st = serve.Setup(cfg, traffic, args.seed, torch.device("cuda:0"))
    cam = harness.runner(traffic["runner"]).CameraStreams(st)
    knee = None
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            t0, t_end, first, last = cam.run(args.seconds, rate)
            frames = cam.frames[first:last]
            lat = np.asarray([np.inf if f[3] is None else (f[3] - f[1]) * 1e3 for f in frames])
            late = np.asarray([(f[2] - f[1]) * 1e3 for f in frames])
            done = sum(1 for f in frames if f[3] is not None and f[3] <= t_end)
            backlog = sum(1 for f in frames if f[2] <= t_end and (f[3] is None or f[3] > t_end))
            row = {"rate_fps": rate, "frames": len(frames), "answered_in_window": done,
                   "answered_fps": done / args.seconds, "backlog_at_close": backlog,
                   "p50_ms": float(np.percentile(lat, 50)),
                   "p95_ms": float(np.percentile(lat, 95)),
                   "late_p95_ms": float(np.percentile(late, 95)),
                   "late_max_ms": float(late.max())}
            print(json.dumps(row), flush=True)
            if done >= 0.99 * len(frames):
                knee = rate
    finally:
        cam.stop()
    print(json.dumps({"knee_fps": knee, "cell_rate_fps": None if knee is None else 0.8 * knee,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
