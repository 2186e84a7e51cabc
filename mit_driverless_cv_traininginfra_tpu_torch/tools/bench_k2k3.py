#!/usr/bin/env python3
"""Device time of K2 (soft-argmax, forward and backward), K3 (threshold +
top-k + NMS), K5 (the int8 residual stage), ``tail_conv`` (RektNet's int8
``res4.conv1``) and the probe kernels ``window_resample``, ``int8_contract``
and ``strided_map`` at their shapes, on one card, in two checkouts.

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/bench_k2k3.py --roots OLD,NEW
    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/bench_k2k3.py --roots OLD,NEW --parts probes
    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/bench_k2k3.py --roots OLD,NEW --parts k2bwd,resample

For the order OLD, NEW, NEW, OLD (one root: once), a fresh process in
each checkout imports that checkout's ``chip_smoke.py`` and port, builds
its kernels, and times the public wrappers on the same seeded inputs.
``--parts`` picks among:

- ``k2``: ``fused_softargmax`` at 448 and 784 rows of 80×80 (serving
  capacity 64 and 112) in bf16 and f32, with how many bf16 probabilities
  lie outside atol 1e-6 + rtol 2^-8 of the plain version's bf16 and
  unrounded f32 probabilities (the smoke's draws and the GPU test's);
- ``k2bwd``: ``softargmax_bwd`` at 224 and 896 rows of 80×80 (the
  training batch at B=32 and B=128) in bf16 and f32, without and with a
  probabilities' gradient, on probabilities of the plain forward, each
  held to the plain version within the smoke's tolerance (1e-5 of the
  largest |dz|, one bf16 ulp); beside each, the device ms of
  ``torch._softmax_backward_data`` on a precomputed ``gp`` (a yardstick of
  the row reduction and the elementwise pass, not the same function);
- ``k3``: ``nms_topk`` at B=8 and B=1 of N=10647 f32 candidates
  (``chip_smoke.nms_inputs``);
- ``k5``: ``fused_res_stage`` on the 26² stage (C=512, n=8) at B=8 and
  B=128, its bundle made by the checkout's own ``pack_res_stage`` from one
  seeded quantized bundle;
- ``tail``: ``tail_conv`` on the probe's draws at 64 and 512 crops;
- ``resample``: ``window_resample`` on P21 and P22 (the probes' draws),
  each held to the plain route bit for bit, with K1 (``roi_crop``) on
  P22's 512 boxes timed beside it;
- ``probes``: every probe on ``int8_contract`` or ``strided_map``, P16
  at 128× its rows included (at their full sizes, by the checkout's own
  ``probes.BY_NAME``), each with its library call
  (``probes.Probe.library``) timed the same way, and
  ``torch._int_mm`` on P16×128's product with K zero-padded from 108 to
  112 (``_int_mm`` wants K a multiple of 8).

Each run prints one JSON line: per case device ms a call and launches a
call (``chip_smoke.device_kernels``, ``torch.profiler``), call ms (CUDA
events, the wrapper's Python included) and, for the probes, host µs a call
(the least and the median of 9 windows of ``chip_smoke.host_us``:
queued without a sync; also for ``resample``); for K5 and ``tail_conv``
the CUDA-event ms of ``torch._int_mm`` on the same (M, K)·(K, N) products
(a yardstick of the GEMMs alone, not of the function). Needs a CUDA card;
compare runs of one call only.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

PARTS = ("k2", "k2bwd", "k3", "k5", "tail", "resample", "probes")

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs

smi = cs.phase_device()
cs.phase_build()
dev = torch.device("cuda:0")
parts = sys.argv[2].split(",")
out = {"root": sys.argv[1], "device": smi}


def int_mm_ms(shapes, repeat=1, iters=10):
    # torch._int_mm, each product `repeat` times, over random int8 (M, K)
    # row-major and (K, N) column-major matrices
    g = torch.Generator(device=dev).manual_seed(0)
    mats = [(torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8),
             torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8).t())
            for m, k, n in shapes]
    return cs.cuda_ms(lambda: [torch._int_mm(a, b) for _ in range(repeat) for a, b in mats],
                      iters)


def host_us(fn):
    # the least and the median of 9 windows of chip_smoke.host_us: the
    # host's clock spreads ±40% between windows on a shared machine, and
    # another process's work only ever adds to a window
    import statistics
    w = [cs.host_us(fn) for _ in range(9)]
    return {"min": min(w), "median": statistics.median(w)}


if "k2" in parts:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
        _torch_softargmax, fused_softargmax)

    def outside(z):
        # bf16 probabilities outside atol 1e-6 + rtol 2^-8 of the plain
        # version's bf16 output, of its f32 probabilities before rounding,
        # and differing
        probs = fused_softargmax(z)[1].float()
        ref, unrounded = _torch_softargmax(z)[1].float(), _torch_softargmax(z.float())[1]
        bad = lambda r: int(((probs - r).abs() > 1e-6 + 2 ** -8 * r.abs()).sum())
        return {"outside_tol_of_plain_bf16": bad(ref), "outside_tol_of_plain_f32": bad(unrounded),
                "differing": int((probs != ref).sum()), "of": probs.numel()}

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

if "k2bwd" in parts:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
        _coord_rows, _torch_softargmax, _torch_softargmax_bwd, softargmax_bwd)

    rng = np.random.default_rng(7)  # the smoke's draws (phase_k2_bwd)
    z_all = torch.from_numpy(rng.normal(0, 3, (896, 80, 80)).astype(np.float32)).to(dev)
    gpts_all = torch.from_numpy(rng.normal(0, 1, (896, 2)).astype(np.float32)).to(dev)
    gpr_all = torch.from_numpy(rng.normal(0, 1e-2, (896, 80, 80)).astype(np.float32)).to(dev)
    for m in (224, 896):
        for dt in (torch.bfloat16, torch.float32):
            probs = _torch_softargmax(z_all[:m].to(dt))[1]
            g_pts = gpts_all[:m]
            for g_probs in (None, gpr_all[:m].to(dt)):
                fn = lambda: softargmax_bwd(probs, g_pts, g_probs)
                got, ref = fn().float(), _torch_softargmax_bwd(probs, g_pts, g_probs).float()
                d = (got - ref).abs()
                rtol = 0.0 if dt == torch.float32 else 2 ** -7
                ok = bool((d <= 1e-5 * ref.abs().max() + rtol * ref.abs()).all())
                kernels, per_call, dev_ms = cs.device_kernels(fn, 20)
                given = "given" if g_probs is not None else "None"
                out[f"K2-bwd M={m} {str(dt)[6:]} g_probs {given}"] = {
                    "device_ms": dev_ms, "launches_a_call": per_call, "call_ms": cs.cuda_ms(fn),
                    "within_tol": ok, "max_abs_err": float(d.max())}
            # the yardstick: the same reduction and elementwise pass on a
            # gp computed beforehand, in the probabilities' dtype
            xv, yv = _coord_rows(80, 80, dev)
            gp = (g_pts[:, :1] * xv + g_pts[:, 1:] * yv).to(dt).reshape(probs.shape)
            sb = lambda: torch._softmax_backward_data(gp, probs, 2, dt)
            _, per_call, dev_ms = cs.device_kernels(sb, 20)
            out[f"softmax_backward_data M={m} {str(dt)[6:]} (yardstick)"] = {
                "device_ms": dev_ms, "launches_a_call": per_call, "call_ms": cs.cuda_ms(sb)}

if "k3" in parts:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import nms_topk

    N = 3 * (13 * 13 + 26 * 26 + 52 * 52)
    boxes, scores = cs.nms_inputs(np.random.default_rng(3), 8, N, 0.8)
    for B, pick in ((8, slice(0, 8)), (1, slice(2, 3))):
        b, s = boxes[pick].to(dev), scores[pick].to(dev)
        fn = lambda: nms_topk(b, s, 0.8, 16, 0.25)
        kernels, per_call, dev_ms = cs.device_kernels(fn, 20)
        out[f"K3 B={B}"] = {"device_ms": dev_ms, "launches_a_call": per_call,
                            "call_ms": cs.cuda_ms(fn)}

if "k5" in parts:
    from mit_driverless_cv_traininginfra_tpu_torch.ops import resstage
    C, S, NB = 512, 26, 8
    rng = np.random.default_rng(5)
    rs = {"w1": rng.integers(-127, 128, (NB, C, C // 2), dtype=np.int8),
          "w3": rng.integers(-127, 128, (NB, 9, C // 2, C), dtype=np.int8),
          "s1": rng.uniform(1e-5, 3e-5, (NB, 1, C // 2)).astype(np.float32),
          "b1": rng.normal(0, 0.1, (NB, 1, C // 2)).astype(np.float32),
          "s3": rng.uniform(1e-6, 3e-6, (NB, 1, C)).astype(np.float32),
          "b3": rng.normal(0, 0.1, (NB, 1, C)).astype(np.float32),
          "sx1": np.full((1, NB), 40.0, np.float32), "sx3": np.full((1, NB), 30.0, np.float32),
          "sx_out": np.float32(35.0)}
    pk = {k: v.to(dev) for k, v in resstage.pack_res_stage(
        {k: torch.from_numpy(np.asarray(v)) for k, v in rs.items()}).items()}
    x_all = torch.from_numpy(rng.normal(0, 1, (128, S, S, C)).astype(np.float32)).to(dev)
    for B in (8, 128):
        xf = resstage.res_stage_pre(x_all[:B])
        fn = lambda: resstage.fused_res_stage(xf, pk, S, NB, 0.1)
        got = fn()
        ref = resstage._res_stage_plain(xf, pk, S, NB, 0.1)
        kernels, per_call, dev_ms = cs.device_kernels(fn, 3 if B == 128 else 10)
        M = B * S * S
        out[f"K5 B={B}"] = {
            "device_ms": dev_ms, "launches_a_call": per_call, "call_ms": cs.cuda_ms(fn, 5, 2),
            "equal": bool(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])),
            "int_mm_ms": int_mm_ms([(M, C, C // 2), (M, 9 * C // 2, C)], NB, 5)}
        del ref, got
    del x_all

if "tail" in parts:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.tail_conv import tail_conv, tail_conv_plain
    from mit_driverless_cv_traininginfra_tpu_torch.probes import tail_conv1
    for crops in (64, 512):
        inp = tail_conv1.probe_inputs(crops, dev)
        q = tail_conv1.qconv_from_probe(inp["wim"], inp["scale"], inp["bias"],
                                        inp["sx_inv"]).to(dev)
        fn = lambda: tail_conv(inp["h"], q)
        equal = bool(torch.equal(fn(), tail_conv_plain(inp["h"], q)))
        kernels, per_call, dev_ms = cs.device_kernels(fn, 10)
        out[f"tail_conv crops={crops}"] = {
            "device_ms": dev_ms, "launches_a_call": per_call, "call_ms": cs.cuda_ms(fn, 20),
            "equal": equal, "int_mm_ms": int_mm_ms([(crops * 6400, 576, 128)])}
        del inp

if "resample" in parts:
    from mit_driverless_cv_traininginfra_tpu_torch.probes import BY_NAME, KERNEL
    from mit_driverless_cv_traininginfra_tpu_torch.probes.run import run_both
    for name in ("P21", "P22"):
        probe = BY_NAME[name]
        inp = probe.build(dev)
        res = run_both(probe, inp)
        fn = lambda: probe.run(inp, KERNEL)
        kernels, per_call, dev_ms = cs.device_kernels(fn, 10)
        row = {"ok": res.ok, "launches": res.launches[probe.kernel], "device_ms": dev_ms,
               "kernels_a_call": per_call, "device_kernels": sorted(set(kernels)),
               "call_ms": cs.cuda_ms(fn, 20), "host_us": host_us(fn)}
        row.update(cs.bound(*probe.work(inp, res.kernel_out)))
        if probe.beside is not None:
            label, make = probe.beside
            k1 = make(inp)
            _, k1_per_call, k1_dev = cs.device_kernels(k1, 10)
            row["beside"] = {"label": label, "device_ms": k1_dev,
                             "kernels_a_call": k1_per_call, "call_ms": cs.cuda_ms(k1, 20)}
        out[name] = row
        del inp, res

if "probes" in parts:
    from mit_driverless_cv_traininginfra_tpu_torch.probes import BY_NAME, KERNEL
    from mit_driverless_cv_traininginfra_tpu_torch.probes.mosaic import DP4A
    from mit_driverless_cv_traininginfra_tpu_torch.probes.run import run_both
    table = {**BY_NAME, DP4A.name: DP4A}
    for name, probe in table.items():
        if probe.kernel not in ("int8_contract", "strided_map"):
            continue
        inp = probe.build(dev)
        res = run_both(probe, inp)
        fn = lambda: probe.run(inp, KERNEL)
        kernels, per_call, dev_ms = cs.device_kernels(fn, 10)
        row = {"kernel": probe.kernel, "ok": res.ok, "launches": res.launches[probe.kernel],
               "device_ms": dev_ms, "kernels_a_call": per_call,
               "device_kernels": sorted(set(kernels)), "call_ms": cs.cuda_ms(fn, 20),
               "host_us": host_us(fn)}
        nb, ops, kind = probe.work(inp, res.kernel_out)
        row.update(cs.bound(nb, ops, kind))
        if probe.library is not None:
            lib = probe.library(inp)
            _, lib_per_call, lib_dev = cs.device_kernels(lib, 10)
            row.update(library_device_ms=lib_dev, library_kernels_a_call=lib_per_call,
                       library_call_ms=cs.cuda_ms(lib, 20), library_host_us=host_us(lib))
        out[name] = row
        del inp, res
        torch.cuda.empty_cache()
    # torch._int_mm on P16x128's product, K zero-padded from 108 to 112
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randint(-127, 128, (16 * 128 * 208, 112), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (128, 112), generator=g, device=dev, dtype=torch.int8).t()
    _, per_call, dev_ms = cs.device_kernels(lambda: torch._int_mm(a, b), 10)
    out["int_mm P16x128 K=112"] = {"device_ms": dev_ms, "kernels_a_call": per_call,
                                   "call_ms": cs.cuda_ms(lambda: torch._int_mm(a, b), 20)}
print(json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", required=True, help="OLD,NEW checkout directories (or one)")
    ap.add_argument("--parts", default=",".join(PARTS), help=f"comma list of {PARTS}")
    args = ap.parse_args()
    roots = [Path(r).resolve() for r in args.roots.split(",")]
    if len(roots) == 2:
        roots = [roots[0], roots[1], roots[1], roots[0]]
    bad = set(args.parts.split(",")) - set(PARTS)
    if bad or len(roots) not in (1, 4):
        ap.error(f"unknown parts {sorted(bad)} or not one or two roots")
    for root in roots:
        proc = subprocess.run([sys.executable, "-c", CHILD, str(root), args.parts],
                              cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
