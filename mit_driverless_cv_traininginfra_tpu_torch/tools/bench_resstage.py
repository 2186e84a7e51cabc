#!/usr/bin/env python3
"""K5 (the fused int8 residual stage) against its plain version, on the
26² stage of YOLOv3-416 (S=26, C=512, n=8).

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/bench_resstage.py [--batches 8,128]

Seeded random weights (``convert.init_darknet_np``), calibrated on the
first 8 synthetic frames and quantized as ``chip_smoke.py`` does; the
stage input is the int8 forward (fused entry, then the plain int8 convs)
of the frames up to the stage. For each batch it prints the plain and K5
CUDA-event times (order plain, K5, K5, plain), the bound and the agreement
of ``yq`` and ``ybf`` (the counterpart of the JAX package's
``tools/bench_resstage.py``, whose TPU group-size sweep has none here).
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.ops import resstage  # noqa: E402


def run(batches=(8, 128), device="cuda", size: int = cs.SIZE, iters: int = 10):
    dev = resolve_device(device)
    frames_np, _ = synthetic.yolo_batch(np.random.default_rng(42), max(batches), size)
    bundles = cs.quantize_on_card(dev, frames_np[:8])
    yolo, _ = cs.int8_models(bundles, dev)
    start, nb, pk = cs.k5_setup(bundles[0], bundles[1])
    print(f"res-stage spans (start, n, C): {resstage.res_stage_spans(bundles[0])}")
    results = []
    for B in batches:
        frames = torch.from_numpy(frames_np[:B]).to(dev, torch.bfloat16)
        x, xf, yq, ybf = cs.k5_path(yolo, frames, start, nb, pk)
        S, C = x.shape[1], x.shape[3]
        ref_q, ref_b = resstage._res_stage_plain(xf, pk, S, nb, cs.SLOPE)
        agree = float((yq == ref_q).float().mean())
        max_q = int((yq.int() - ref_q.int()).abs().max())
        max_b = float((ybf.float() - ref_b.float()).abs().max())
        ops = 2 * B * S * S * nb * (C * (C // 2) + 9 * (C // 2) * C)
        b = cs.bound(cs.nbytes(xf, pk["w1_k"], pk["w3_k"], yq, ybf), ops, "int8")
        row = {"batch": B, "stage_input": list(x.shape), "n_blocks": nb,
               "yq_agree": agree, "yq_maxdiff": max_q, "ybf_maxdiff": max_b,
               "gops": ops / 1e9, **b}
        if dev.type == "cuda":
            k_ms, p_ms = cs.paired_ms(
                lambda: resstage.fused_res_stage(xf, pk, S, nb, cs.SLOPE),
                lambda: resstage._res_stage_plain(xf, pk, S, nb, cs.SLOPE), iters)
            row.update(kernel_ms=k_ms, plain_ms=p_ms, tops=ops / k_ms / 1e9)
        print(row, flush=True)
        results.append(row)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="8,128")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if torch.cuda.is_available():
        cs.phase_device()  # prints the card's name and power limit
    run(tuple(int(b) for b in args.batches.split(",")), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
