#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the card(s) the cell asks
for. The cell is found by name in ``BENCHMARK.json``; its configuration is
the file that entry names, its traffic ``benchmark/traffic/<traffic>.json``,
and each per-layer metric is read by ``benchmark/metrics/<metric>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` also
``breakdown``, then ``setup_built`` (true where this run's set-up built
the program's kernel library with nvcc, as a checkout's first run does:
its ``setup_s`` holds that build), and last ``checks``:
each compared number with its limit. The same checks are the last lines
of standard error.
"""

from __future__ import annotations

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache the program may fill lives at a fixed path in the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

from yardstick import harness, port  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = harness.load_bench(ROOT)
    cell = harness.find_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, record = harness.run(bench, args.workload, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda:0"), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    build = port.build_info()
    checks = result.pop("checks")
    result["setup_built"] = build["nvcc_ran"]
    result["checks"] = checks
    record["build"] = build
    harness.write_record(HERE, args, record)
    print(json.dumps({"record": harness.summary(record)}, default=str), file=sys.stderr)
    if build["nvcc_ran"]:
        print(f"setup_s {result['metrics'].get('setup_s', {}).get('value')} holds the first "
              f"build of the kernel library: nvcc {build['nvcc_s']:.1f} s", file=sys.stderr)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
