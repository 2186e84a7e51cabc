#!/usr/bin/env python3
"""RektNet's int8 ``res4.conv1`` (3×3, dilation 2, padding 2, 64 → 128, then
relu) as the ``tail_conv`` kernel against its plain version on one CUDA
card, on the probe's seeded inputs.

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/probe_tail_conv1.py

The counterpart of the JAX repository's ``tools/probe_tail_conv1.py``: at
C=512 crops (the probe's size) and C=64 (the served capacity at B=8) it
checks the kernel against ``F.relu(_qconv(h, q))`` value for value, then
times both (CUDA events, plain, kernel, kernel, plain) and prints the
bound (``chip_smoke.bound``: bytes over 3.35 TB/s or int8 operations over
the published peak) and the kernel's int8 rate. The last line is one JSON
object of all rows. Exits non-zero if the kernel differs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.ops.tail_conv import (  # noqa: E402
    tail_conv,
    tail_conv_plain,
)
from mit_driverless_cv_traininginfra_tpu_torch.probes import tail_conv1  # noqa: E402

CROPS = (512, 64)  # the probe's size, the served capacity at B=8


def measure(C: int, dev, iters: int) -> dict:
    inp = tail_conv1.probe_inputs(C, dev)
    q = tail_conv1.qconv_from_probe(inp["wim"], inp["scale"], inp["bias"],
                                    inp["sx_inv"]).to(dev)
    h = inp["h"]
    got, want = tail_conv(h, q), tail_conv_plain(h, q)
    differing = int((got != want).sum())
    k_ms, p_ms = cs.paired_ms(lambda: tail_conv(h, q), lambda: tail_conv_plain(h, q),
                              iters)
    nbytes, ops, kind = tail_conv1.tail_work({"h": h, "q": q}, got)
    return {"crops": C, "differing": differing, "of": got.numel(), "ms": k_ms,
            "plain_ms": p_ms, "bytes": nbytes, "ops": ops,
            "tops": ops / k_ms / 1e9, **cs.bound(nbytes, ops, kind)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = resolve_device("cuda:0")
    cs.phase_build()
    rows = []
    for C in CROPS:
        r = measure(C, dev, args.iters)
        cs.log(f"tail_conv C={C}: differing {r['differing']}/{r['of']}, kernel "
               f"{r['ms']!r} ms ({r['tops']:.1f} TOP/s) plain {r['plain_ms']!r} ms "
               f"bound {r['bound_ms']!r} ms ({r['bound_by']}) on {smi}")
        rows.append(r)
    print(json.dumps({"device": smi, "tail_conv": rows}))
    return 1 if any(r["differing"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
