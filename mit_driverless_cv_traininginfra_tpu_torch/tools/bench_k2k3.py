#!/usr/bin/env python3
"""Device time of K2's forward (soft-argmax) and K3 (threshold + top-k +
NMS) at the serving shapes, on one card, in two checkouts.

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/bench_k2k3.py --roots OLD,NEW [--one-cta]

For the order OLD, NEW, NEW, OLD, a fresh process in each checkout
imports that checkout's ``chip_smoke.py`` and port, builds its kernels,
and times the public wrappers (``fused_softargmax``, ``nms_topk``) on
the same seeded inputs: K2 at 448 and 784 rows of 80×80 (serving
capacity 64 and 112) in bf16 and f32, K3 at B=8 and B=1 of N=10647 f32
candidates (``chip_smoke.nms_inputs``). Each prints one JSON line:
device ms a call and launches a call (``chip_smoke.device_kernels``,
``torch.profiler``) and call ms (CUDA events, the wrapper's Python
included), and for bf16 how many probabilities lie outside atol 1e-6 +
rtol 2^-8 of the plain version's bf16 and unrounded f32 probabilities
(the smoke's draws and the GPU test's). ``--one-cta`` adds, as
OLD, NEW, ONE, ONE, NEW, OLD, a copy of NEW under the git-ignored
``build/one_cta/`` whose K3 is built with one CTA per image (``kCtas``
1 in ``csrc/nms_topk.cu``) instead of a cluster of 8: the cluster
against a single larger CTA with the same register top k. Needs a CUDA
card; compare runs of one call only.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    _torch_softargmax, fused_softargmax, nms_topk)


def outside(z):
    # bf16 probabilities outside atol 1e-6 + rtol 2^-8 of the plain version's
    # bf16 output, of its f32 probabilities before rounding, and differing
    probs = fused_softargmax(z)[1].float()
    ref, unrounded = _torch_softargmax(z)[1].float(), _torch_softargmax(z.float())[1]
    bad = lambda r: int(((probs - r).abs() > 1e-6 + 2 ** -8 * r.abs()).sum())
    return {"outside_tol_of_plain_bf16": bad(ref), "outside_tol_of_plain_f32": bad(unrounded),
            "differing": int((probs != ref).sum()), "of": probs.numel()}

smi = cs.phase_device()
cs.phase_build()
dev = torch.device("cuda:0")
out = {"root": sys.argv[1], "device": smi}
rng = np.random.default_rng(2)
z_all = torch.from_numpy(rng.normal(0, 3, (784, 80, 80)).astype(np.float32)).to(dev)
for m in (448, 784):
    for dt in (torch.bfloat16, torch.float32):
        z = z_all[:m].to(dt)
        kernels, per_call, dev_ms = cs.device_kernels(lambda: fused_softargmax(z), 20)
        out[f"K2 M={m} {str(dt)[6:]}"] = {"device_ms": dev_ms, "launches_a_call": per_call,
                                          "call_ms": cs.cuda_ms(lambda: fused_softargmax(z))}
        if dt == torch.bfloat16:  # the smoke's draws, then the GPU test's
            out[f"K2 M={m} bf16 rounding"] = outside(z)
            zt = np.random.default_rng(1).normal(0, 4, (m, 80, 80)).astype(np.float32)
            out[f"K2 M={m} bf16 rounding, test draws"] = outside(
                torch.from_numpy(zt).to(dev, torch.bfloat16))
N = 3 * (13 * 13 + 26 * 26 + 52 * 52)
boxes, scores = cs.nms_inputs(np.random.default_rng(3), 8, N, 0.8)
for B, pick in ((8, slice(0, 8)), (1, slice(2, 3))):
    b, s = boxes[pick].to(dev), scores[pick].to(dev)
    fn = lambda: nms_topk(b, s, 0.8, 16, 0.25)
    kernels, per_call, dev_ms = cs.device_kernels(fn, 20)
    out[f"K3 B={B}"] = {"device_ms": dev_ms, "launches_a_call": per_call,
                        "call_ms": cs.cuda_ms(fn)}
print(json.dumps(out), flush=True)
"""


def one_cta_copy(root: Path) -> Path:
    """A copy of ``root``'s ``chip_smoke.py`` and port whose K3 cluster has
    one CTA: the kernel then takes a chunk of N in one 1024-thread CTA."""
    port = "mit_driverless_cv_traininginfra_tpu_torch"
    dst = root / port / "build" / "one_cta"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / port, dst / port, ignore=shutil.ignore_patterns("build"))
    shutil.copy(root / "chip_smoke.py", dst)
    src = dst / port / "csrc" / "nms_topk.cu"
    text = src.read_text()
    if text.count("constexpr int kCtas = 8;") != 1:
        raise SystemExit(f"{src}: no `constexpr int kCtas = 8;` to change")
    src.write_text(text.replace("constexpr int kCtas = 8;", "constexpr int kCtas = 1;"))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", required=True, help="OLD,NEW checkout directories")
    ap.add_argument("--one-cta", action="store_true",
                    help="also NEW with one CTA per image for K3")
    args = ap.parse_args()
    old, new = (Path(r).resolve() for r in args.roots.split(","))
    order = (old, new, new, old)
    if args.one_cta:
        one = one_cta_copy(new)
        order = (old, new, one, one, new, old)
    for root in order:
        proc = subprocess.run([sys.executable, "-c", CHILD, str(root)], cwd=root,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
