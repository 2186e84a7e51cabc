#!/usr/bin/env python3
"""A/B of the int8 path's two data layouts on one CUDA card.

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/ab_int8_layouts.py

"old" runs the int8 convolutions as they were first written: row-major
weights for ``torch._int_mm`` (cuBLASLt then falls back to a WMMA kernel)
and an im2col that copies single bytes. "new" is the code as it stands:
column-major weights and im2col taps copied as int32 words. Both run in
one process on the int8 configuration of ``chip_smoke.py`` (B=8, capacity
112), in the order old, new, new, old; each prints CUDA-event times of
detect, RektNet on 112 crops and the whole pipeline (10-call windows), and
the outputs of the two must be identical. Then ``torch.profiler`` lists
the top kernels of 8 pipelines of "new".
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.infer import pipeline as pl  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.models import quantize as qz  # noqa: E402

NEW_IM2COL, NEW_INT_MM = qz._im2col, torch._int_mm


def old_im2col(x, kh, kw, stride, padding, dilation):
    """``_im2col`` as first written: taps concatenated byte by byte."""
    (pt, pb), (pl_, pr) = qz._pairs(padding)
    _, H, W, _ = x.shape
    ho = (H + pt + pb - dilation * (kh - 1) - 1) // stride + 1
    wo = (W + pl_ + pr - dilation * (kw - 1) - 1) // stride + 1
    if (kh, kw, stride) == (1, 1, 1) and (pt, pb, pl_, pr) == (0, 0, 0, 0):
        return x
    xp = F.pad(x, (0, 0, pl_, pr, pt, pb))
    return torch.cat([xp[:, dy * dilation:dy * dilation + stride * (ho - 1) + 1:stride,
                         dx * dilation:dx * dilation + stride * (wo - 1) + 1:stride, :]
                      for dy in range(kh) for dx in range(kw)], dim=-1)


def use(variant: str) -> None:
    if variant == "old":
        qz._im2col = old_im2col
        torch._int_mm = lambda a, b: NEW_INT_MM(a, b.contiguous())
    else:
        qz._im2col, torch._int_mm = NEW_IM2COL, NEW_INT_MM


def main() -> int:
    smi = cs.phase_device()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    frames_np, _ = synthetic.yolo_batch(np.random.default_rng(42), cs.B_SERVE, cs.SIZE)
    yolo, rekt = cs.int8_models(cs.quantize_on_card(dev, frames_np), dev)
    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    crops = torch.rand((112, 80, 80, 3), device=dev).to(torch.bfloat16)
    res, outs = defaultdict(list), {}
    with torch.inference_mode():
        thresh = cs.pick_conf_thresh(yolo.detections(frames, with_classes=False),
                                     cs.MAX_DET)
        kw = dict(conf_thresh=thresh, max_det=cs.MAX_DET, crop_capacity=112)
        for variant in ("old", "new", "new", "old"):
            use(variant)
            outs[variant] = pl.two_stage_pipeline(yolo, rekt, frames, **kw)
            for stage, fn in (("detect", lambda: yolo(frames)),
                              ("rektnet", lambda: rekt(crops)),
                              ("pipeline", lambda: pl.two_stage_pipeline(
                                  yolo, rekt, frames, **kw))):
                res[f"{variant} {stage}"].append(cs.cuda_ms(fn, 10, 3))
        use("new")
        same = all(torch.equal(a, b) for a, b in zip(outs["old"], outs["new"]))
        print(f"A/B outputs identical: {same}", flush=True)
        for k, v in res.items():
            print(f"A/B {k} ms (events, 2 windows): {v!r} mean "
                  f"{sum(v) / len(v)!r} on {smi}", flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(8):
                pl.two_stage_pipeline(yolo, rekt, frames, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key[:110])
            for e in prof.key_averages() if e.self_device_time_total > 0]
    print(f"new profile: 8 pipelines wall {wall!r} ms, device "
          f"{sum(r[0] for r in rows)!r} ms", flush=True)
    for d, c, k in sorted(rows, reverse=True)[:14]:
        print(f"  new {d:10.3f} ms  n {c:6d}  {k}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
