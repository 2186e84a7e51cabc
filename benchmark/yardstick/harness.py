"""What ``run.py`` does with a cell, driven by data: the cell from
``BENCHMARK.json``, its configuration file, its traffic file
(``benchmark/traffic/<traffic>.json``), the runner that the traffic's
``runner`` names (``benchmark/runners/<runner>.py``), the verdict on the
compared numbers against the configuration's ``limits``, the end-to-end
metrics the cell declares, and each per-layer metric by its reader
``benchmark/metrics/<name>.py``. Each is found by its name: a new cell,
traffic mix, runner or metric is a new file, and no file here changes.

A runner module has ``run(cfg, traffic, seed, seconds, traced, device,
t_start, hooks)``, which returns ``(e2e, record, numbers, attempted,
failed, memory_peak)``:

- ``e2e``: every end-to-end metric it measured, by name;
- ``record``: what the per-layer readers read (``kind`` names the runner);
- ``numbers``: the compared numbers, judged against the configuration's
  ``limits`` for the traffic's ``judge``;

and ``control_sample(setup, seconds)``, the answers of a short window and
the requests they answered, which ``controls.py`` has the control answer.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from typing import Dict, Optional

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "mit_driverless_cv_traininginfra_tpu")


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, root: str, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _module(folder: str, name: str, root: Optional[str] = None):
    path = os.path.join(root or HERE, folder, f"{name}.py")
    if not os.path.isfile(path):
        raise SystemExit(f"no {path}")
    key = f"bench_{folder}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Optional[str] = None):
    """The ``read(record)`` of ``benchmark/metrics/<name>.py``."""
    return _module("metrics", name, root).read


def runner(name: str, root: Optional[str] = None):
    """The module ``benchmark/runners/<name>.py``."""
    return _module("runners", name, root)


def memory_peak(device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def traced_record(t) -> dict:
    """The reduction of a :class:`trace.Traced` window for the record."""
    from . import trace

    red = trace.reduce(t)
    return {"busy_s": red["busy_s"], "window_s": red["window_s"],
            "kernels": red["kernels"], "device_ops": red["device_ops"],
            "idle_gaps": red["idle_gaps"]}


def cell_metrics(bench: dict, cell: str, kind: str):
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports: a
    metric with ``workloads`` where it names the cell; one without, where
    the cell reports the end-to-end metric it moves (per-layer) or always
    (end-to-end)."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every limited number at or under its limit
    and no answer missing; ``checks`` is ``{name: [value, limit]}``."""
    checks = {k: [float(numbers[k]), float(v)] for k, v in limits.items()}
    if "missing" in numbers:
        checks["missing"] = [float(numbers["missing"]), 0.0]
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    ok = ok and numbers.get("judged", 1) > 0 and numbers.get("detections", 1) > 0
    return ok, checks


def run(bench: dict, workload: str, seed: int, seconds: float, traced: bool,
        device, t_start: float, root: Optional[str] = None, hooks=None, cfg=None,
        traffic=None):
    """Run the cell once; returns ``(result line, record)``. ``cfg`` and
    ``traffic`` override the files (tests run a small configuration on the
    CPU); ``hooks`` reach into the runner (tests plant faults)."""
    from . import reference

    root = root or os.path.dirname(HERE)
    cell = find_cell(bench, workload)
    cfg = cfg or load_config(bench, root, cell["config"])
    traffic = traffic or load_traffic(cell["traffic"])
    reference.full_f32()
    e2e, rec, numbers, attempted, failed, peak = runner(traffic["runner"]).run(
        cfg, traffic, seed, seconds, traced, device, t_start, hooks)
    correct, checks = verdict(numbers, cfg["limits"][traffic["judge"]])
    correct = correct and failed == 0
    rec.update({"cell": workload, "seed": seed, "numbers": numbers,
                "cfg": {"precision": cfg["serving"]["precision"]}})
    metrics = {}
    if traced:
        for m in cell_metrics(bench, workload, "per_layer"):
            v = metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, workload, "end_to_end"):
            if m["name"] not in e2e:
                raise RuntimeError(f"the {traffic['runner']} runner measures no {m['name']}")
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if traced and "trace" in rec:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checks"] = checks
    rec["e2e"] = e2e
    return result, rec


def summary(rec: dict) -> dict:
    """The record without its per-kernel table, for a line of the log."""
    out = {k: v for k, v in rec.items() if k != "trace"}
    if "trace" in rec:
        out["trace"] = {k: v for k, v in rec["trace"].items() if k != "kernels"}
    return out


def write_record(here: str, args, rec: dict) -> None:
    """The run's whole record under ``benchmark/.runs/`` (git-ignored)."""
    d = os.path.join(here, ".runs")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{args.workload}.{args.seed}.{args.trace}.json")
    with open(path, "w") as f:
        json.dump(rec, f, default=str)
