"""The harness on the CPU: cells, configurations, traffic and metrics found
by name; the result line's keys; the frozen counts; the idle share's
union of intervals; the check for JAX modules."""

from __future__ import annotations

import json
import os
import sys
import time
import types

import pytest
import torch

import small
from yardstick import arch, harness, trace

BENCH = small.BENCH
CELL = "yolov3-416-rektnet.bf16.serve-b8"


def test_every_cell_finds_its_files():
    bench = harness.load_bench(small.ROOT)
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(small.ROOT, c["file"]))
        assert harness.load_config(bench, small.ROOT, c["name"])["detector"]["input"] == 416
    for w in bench["workloads"]:
        assert w["config"] in names
        tr = harness.load_traffic(w["traffic"])
        mod = harness.runner(tr["runner"])
        assert callable(mod.run) and callable(mod.control_sample)
        e2e = harness.cell_metrics(bench, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.cell_metrics(bench, w["name"], "per_layer")
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


NEW_RUNNER = """
def run(cfg, traffic, seed, seconds, traced, device, t_start, hooks=None):
    e2e = {"served_fps": traffic["rate"] * seconds, "setup_s": 0.5}
    rec = {"kind": "drop_in", "value": seed}
    numbers = dict.fromkeys(cfg["limits"][traffic["judge"]], 0.0)
    return e2e, rec, dict(numbers, missing=0), 1, 0, 0


def control_sample(st, seconds):
    return [], []
"""

NEW_METRIC = """
def read(rec):
    return rec["value"] if rec.get("kind") == "drop_in" else None
"""


def test_new_files_are_found_by_name_alone(tmp_path, monkeypatch):
    """A cell whose traffic names a runner, and a per-layer metric, each
    added as a file of its own in a copy of the benchmark's folder, run
    with no other file of the harness changed."""
    for sub in ("runners", "metrics", "traffic"):
        (tmp_path / sub).mkdir()
    (tmp_path / "runners" / "drop_in.py").write_text(NEW_RUNNER)
    (tmp_path / "metrics" / "drop_in.value.py").write_text(NEW_METRIC)
    (tmp_path / "traffic" / "drop-in.json").write_text(
        json.dumps({"runner": "drop_in", "judge": "serve", "rate": 3.0}))
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    bench = json.loads(json.dumps(BENCH))
    cell = "yolov3-416-rektnet.bf16.drop-in"
    bench["workloads"].append({"name": cell, "config": "yolov3-416-rektnet.bf16",
                               "traffic": "drop-in", "chips": 1})
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append({"name": "drop_in.value", "unit": "n", "better": "higher",
                               "source": "program_counter", "layer": "server",
                               "moves": "served_fps", "workloads": [cell]})
    cfg = small.config("yolov3-416-rektnet.bf16")
    res, _ = harness.run(bench, cell, 7, 2.0, False, torch.device("cpu"), 0.0,
                         root=small.ROOT, cfg=cfg)
    assert res["correct"] and res["metrics"]["served_fps"]["value"] == 6.0
    res, _ = harness.run(bench, cell, 7, 2.0, True, torch.device("cpu"), 0.0,
                         root=small.ROOT, cfg=cfg)
    assert res["metrics"] == {"drop_in.value": {"value": 7.0, "unit": "n"}}


def test_the_arrival_schedule_is_data():
    import numpy as np

    from yardstick import serve

    rng = np.random.default_rng(3)
    spec = {"streams": 4, "phase": "even", "jitter": 0.0, "burst": 1}
    due, scene = serve.arrivals(rng, spec, 40.0, 1.0, 8)
    assert due.size == 40 and np.allclose(np.diff(due), 1 / 40)
    assert scene.min() >= 0 and scene.max() < 8
    due, _ = serve.arrivals(rng, dict(spec, burst=4), 40.0, 1.0, 8)
    assert due.size == 40 and np.unique(due).size == 10
    due, _ = serve.arrivals(rng, dict(spec, phase="random", jitter=0.1), 40.0, 1.0, 8)
    assert 36 <= due.size <= 44 and np.all(np.diff(due) >= 0)


def test_a_reader_that_finds_nothing_returns_nothing():
    for m in BENCH["per_layer"]:
        assert harness.metric_reader(m["name"])({"kind": "none"}) is None


def test_frozen_counts():
    det = harness.load_config(BENCH, small.ROOT, "yolov3-416-rektnet.bf16")["detector"]
    kp = harness.load_config(BENCH, small.ROOT, "yolov3-416-rektnet.bf16")["keypoints"]
    assert round(arch.detector_flops(det) / 1e9, 1) == 65.3
    assert round(arch.detector_flops(det, served_attrs=5) / 1e9, 1) == 65.3
    assert round(arch.rektnet_flops(kp) / 1e9, 2) == 3.96
    assert arch.total_anchors(det) == 10647
    # bytes worked by hand at the served shapes, over 3.35 TB/s
    frames = 8 * 416 * 416 * 3 * 2
    assert arch.roi_crop_bound_s(8, 416, 416, 3, 64, 80) == pytest.approx(
        (frames + 64 * 24 + 64 * 80 * 80 * 3 * 2) / 3.35e12, rel=1e-12)
    assert arch.softargmax_bound_s(448, 6400) == pytest.approx(
        (448 * 6400 * 4 + 448 * 8) / 3.35e12, rel=1e-12)
    assert arch.nms_topk_bound_s(8, 10647, 16) == pytest.approx(
        (8 * 10647 * 20 + 8 * 16 * 25) / 3.35e12, rel=1e-12)
    assert arch.entry_block_bound_s(8, 208) == pytest.approx(
        8 * 208 * 208 * 192 / 3.35e12, rel=1e-12)


def test_idle_share_takes_the_union_of_overlapping_kernels():
    t = trace.Traced()
    t.t0_us, t.window_s = 0.0, 10e-6
    # two streams: [1, 4) and [2, 5) overlap, [7, 8) alone: busy 5 us of 10,
    # idle [0, 1) and [5, 7) inside the span, [8, 10) outside it
    t.device = [("a", 1.0, 4.0), ("b", 2.0, 5.0), ("a", 7.0, 8.0)]
    t.host = [("bench.server_call", 0.0, 6.0)]
    red = trace.reduce(t)
    assert red["busy_s"] == pytest.approx(5e-6)
    assert red["kernels"]["a"] == (2, pytest.approx(4e-6))
    assert [g[0] for g in red["idle_gaps"]] == ["server_call", "host idle", "server_call"]
    assert sorted(g[1] for g in red["idle_gaps"]) == pytest.approx([1e-6, 2e-6, 2e-6])
    reader = harness.metric_reader("idle_share.serve")
    assert reader({"kind": "closed_loop", "trace": red}) == pytest.approx(50.0)


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mit_driverless_cv_traininginfra_tpu_torch",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "mit_driverless_cv_traininginfra_tpu.ops",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax", "mit_driverless_cv_traininginfra_tpu"]


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(traced, monkeypatch):
    if traced:
        # the CPU has no device trace: stand a recorded one in
        class Fake(trace.Traced):
            def __enter__(self):
                self.t0_us, self._t = 0.0, time.perf_counter()
                return self

            def __exit__(self, *exc):
                self.window_s = time.perf_counter() - self._t
                self.device = [("roi_crop_kernel<bf16>", 0.0, 10.0),
                               ("nms_topk_kernel", 20.0, 30.0)]
                return False

        monkeypatch.setattr(trace, "Traced", Fake)
        monkeypatch.setattr("yardstick.serve.detector_ms", lambda *a, **k: 1.0)
        monkeypatch.setattr("yardstick.serve.keypoint_ms", lambda *a, **k: 1.0)
    res, rec = harness.run(BENCH, CELL, 2 ** 31 + 5, 1.0, traced, torch.device("cpu"),
                           time.perf_counter(), cfg=small.config("yolov3-416-rektnet.bf16"),
                           traffic=small.traffic("serve-b8"))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if traced else ["checks"]
    assert list(res) == want
    json.dumps(res)
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "k1k2k3_roofline" in res["metrics"] and "mfu.serve" in res["metrics"]
        assert "served_fps" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"served_fps", "setup_s"}
    assert set(res["checks"]) >= set(small.config("yolov3-416-rektnet.bf16")["limits"]["serve"])
    assert all(len(v) == 2 for v in res["checks"].values())
