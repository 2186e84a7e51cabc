"""A configuration small enough for the CPU: YOLOv3 at its published
widths on 64x64 frames, RektNet-4 on 16x16 crops, batches of 2."""

from __future__ import annotations

import copy
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

from yardstick import harness  # noqa: E402

BENCH = harness.load_bench(ROOT)


def config(name: str) -> dict:
    cfg = copy.deepcopy(harness.load_config(BENCH, ROOT, name))
    cfg["detector"]["input"] = 64
    cfg["keypoints"].update(net_size=4, crop=16)
    cfg["serving"].update(capacities=[8, 16], policy={"floor": 8, "quantum": 8})
    return cfg


def traffic(name: str) -> dict:
    tr = harness.load_traffic(name)
    if tr["runner"] == "closed_loop":
        tr.update(batch=2, pool=8, buckets=[2], judge_requests=4, trace_seconds=0.5)
    elif tr["runner"] == "camera_streams":
        tr.update(pool=8, rate_fps=8.0, judge_frames=16, trace_seconds=0.5, buckets=[1, 2])
        tr["arrivals"] = dict(tr["arrivals"], streams=4)
    return tr
