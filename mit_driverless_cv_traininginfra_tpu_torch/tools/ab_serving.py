#!/usr/bin/env python3
"""Served frames/s of two checkouts of the repository on one card, in turns.

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/ab_serving.py --roots OLD,NEW

For the order OLD, NEW, NEW, OLD, each run is a fresh process started in
its checkout: it imports that checkout's ``chip_smoke.py`` and port,
builds the seeded YOLOv3-416 (one class) and RektNet, warms a bf16 and an
int8 ``TwoStageServer`` and serves 64 requests of B=8 on each
(``chip_smoke.serve``), and prints one JSON line: frames/s of each server
and the kernel launches ``chip_smoke.serve`` counts (the wrappers' counts,
or, for replayed requests, the profiler's). The two checkouts build
their own kernels (each into its own git-ignored ``build/``). Needs a CUDA
card; compare runs of one call only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic

smi = cs.phase_device()
cs.phase_build()
dev = torch.device("cuda:0")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.benchmark = True
frames_np, _ = synthetic.yolo_batch(np.random.default_rng(42), cs.B_SERVE, cs.SIZE)
frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
out = {"root": sys.argv[1], "device": smi}
yb, rb = cs.build_models(dev, torch.bfloat16)
yb.to(memory_format=torch.channels_last)
rb.to(memory_format=torch.channels_last)
yq, rq = cs.int8_models(cs.quantize_on_card(dev, frames_np), dev)
for label, yolo, rekt in (("bf16", yb, rb), ("int8", yq, rq)):
    with torch.inference_mode():
        thresh = cs.pick_conf_thresh(yolo.detections(frames, with_classes=False), cs.MAX_DET)
    launches, fps, _ = cs.serve(label, yolo, rekt, frames, thresh, smi)
    out[label] = {"frames_per_s": fps, "launches": launches, "conf_thresh": thresh}
print(json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", required=True, help="OLD,NEW checkout directories")
    args = ap.parse_args()
    old, new = (str(Path(r).resolve()) for r in args.roots.split(","))
    results = []
    for root in (old, new, new, old):
        p = subprocess.run([sys.executable, "-c", CHILD, root], cwd=root, capture_output=True,
                           text=True, timeout=900)
        if p.returncode:
            print(p.stdout[-3000:], p.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"the run in {root} failed ({p.returncode})")
        res = json.loads(p.stdout.strip().splitlines()[-1])
        print(json.dumps(res), flush=True)
        results.append(res)
    for label in ("bf16", "int8"):
        fps = {r: [x[label]["frames_per_s"] for x in results if x["root"] == r] for r in (old, new)}
        print(f"{label} frames/s: old {fps[old]}, new {fps[new]}, new/old "
              f"{sum(fps[new]) / sum(fps[old])!r} on {results[0]['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
