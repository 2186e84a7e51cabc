#!/usr/bin/env python3
"""Every ported Pallas probe of the JAX repository's ``tools/`` on one CUDA
card: each probe's kernel route against its plain version, timed.

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/reprobe.py            # the table
    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/reprobe.py --one P16  # one probe, in-process
    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/reprobe.py --iters 0  # check only, no timing

The counterpart of the JAX repository's ``tools/reprobe.py`` and its
``probe_*.py`` files (``probes.PROBES``). Each probe runs in a subprocess
with a timeout, because a faulting kernel poisons the CUDA context. For
each it prints: the kernel, PASS / DIFFERS / FAIL / TIMEOUT, the values
that differ under the probe's rule (bits; values for the tail conv; the
f32 sum tolerance for block sums), the kernel's launches, the kernel, plain
and library times (CUDA events, in the order plain, kernel, kernel, plain),
the kernel's and the library call's device time and device kernels a call
(``chip_smoke.device_kernels``, ``torch.profiler``, 10 calls), the
kernel route's host µs a call (``chip_smoke.host_us``) and the bound
(``chip_smoke.bound``: bytes over 3.35 TB/s or operations over the
published peak). Two rows are not JAX probes: ``P16x128`` is P16's
function at 128× its rows (the contraction's large case) and P22 also
times K1 on its 512 boxes. The last line is one JSON object of all rows.
Unlike the JAX tool, it exits non-zero if any probe fails or differs: on
Hopper every probe is expected to pass.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.probes import (  # noqa: E402
    BY_NAME,
    KERNEL,
    PLAIN,
    Probe,
)
from mit_driverless_cv_traininginfra_tpu_torch.probes.mosaic import DP4A  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.probes.run import run_both  # noqa: E402

ALL = {**BY_NAME, DP4A.name: DP4A}
TIMEOUT_S = 300  # per probe's subprocess: its CUDA start-up, check and timings


def probe_row(probe: Probe, dev, iters: int) -> dict:
    """One probe on ``dev``: both routes, the rule, launches, and with
    ``iters`` > 0 the kernel / plain / library / beside times."""
    inp = probe.build(dev)
    res = run_both(probe, inp)
    nbytes_, ops, kind = probe.work(inp, res.kernel_out)
    row = {"name": probe.name, "replaces": probe.ref, "kernel": probe.kernel,
           "status": "PASS" if res.ok else "DIFFERS", "differing": res.differing,
           "of": res.kernel_out.numel(), "max_abs_err": res.max_abs_err,
           "launches": res.launches[probe.kernel], "bytes": nbytes_, "ops": ops,
           **cs.bound(nbytes_, ops, kind)}
    if probe.last_block:
        row["output"] = res.kernel_out[-1].float().mean().item()
    if res.launches[probe.kernel] == 0:
        row["status"] = "FAIL"
    if iters > 0:
        k_ms, p_ms = cs.paired_ms(lambda: probe.run(inp, KERNEL),
                                  lambda: probe.run(inp, PLAIN), iters)
        fn = lambda: probe.run(inp, KERNEL)  # noqa: E731
        _, per_call, dev_ms = cs.device_kernels(fn, 10)
        row.update(ms=k_ms, plain_ms=p_ms, library_ms=None, device_ms=dev_ms,
                   kernels_a_call=per_call, host_us=cs.host_us(fn), library_device_ms=None)
        if probe.library is not None:
            lib = probe.library(inp)
            row["library_ms"] = cs.cuda_ms(lib, iters)
            row["library_device_ms"] = cs.device_kernels(lib, 10)[2]
        if probe.beside is not None:
            label, make = probe.beside
            row["beside"] = {"label": label, "ms": cs.cuda_ms(make(inp), iters)}
        if kind == "int8":
            row["tops"] = ops / k_ms / 1e9
        row["gbps"] = nbytes_ / k_ms / 1e6
    return row


def one(name: str, iters: int) -> int:
    dev = resolve_device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    row = probe_row(ALL[name], dev, iters)
    print(json.dumps(row), flush=True)
    return 0 if row["status"] == "PASS" else 1


def attempt(name: str, iters: int) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--one", name,
           "--iters", str(iters)]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return {"name": name, "status": "TIMEOUT", "detail": f">{TIMEOUT_S} s"}
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    if lines:
        return json.loads(lines[-1])
    err = (p.stderr.strip().splitlines() or ["?"])[-1][:160]
    return {"name": name, "status": "FAIL", "detail": err}


def fmt(v, width=10):
    if v is None:
        return f"{'none':>{width}}"
    return f"{v:>{width}.4g}" if isinstance(v, float) else f"{v!s:>{width}}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--one", default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if args.one:
        return one(args.one, args.iters)
    smi = cs.phase_device()
    cs.phase_build()  # once here; the subprocesses load the cached library
    rows = [attempt(name, args.iters) for name in ALL]
    print(f"{'probe':<26} {'kernel':<16} {'status':<8} {'differ':>7} {'launch':>6} "
          f"{'ms':>10} {'device ms':>10} {'host us':>10} {'plain ms':>10} {'lib ms':>10} "
          f"{'lib dev ms':>10} {'bound ms':>10} by")
    for r in rows:
        print(f"{r['name']:<26} {r.get('kernel', '?'):<16} {r['status']:<8} "
              f"{fmt(r.get('differing'), 7)} {fmt(r.get('launches'), 6)} "
              f"{fmt(r.get('ms'))} {fmt(r.get('device_ms'))} {fmt(r.get('host_us'))} "
              f"{fmt(r.get('plain_ms'))} {fmt(r.get('library_ms'))} "
              f"{fmt(r.get('library_device_ms'))} {fmt(r.get('bound_ms'))} "
              f"{r.get('bound_by', '')} {r.get('detail', '')}")
        if "beside" in r:
            print(f"{'':<26} beside: {r['beside']['label']} {r['beside']['ms']!r} ms")
    bad = [r["name"] for r in rows if r["status"] != "PASS"]
    print(f"{len(rows) - len(bad)} of {len(rows)} probes PASS on {smi}"
          + (f"; not passing: {bad}" if bad else ""))
    print(json.dumps({"device": smi, "probes": rows}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
