"""The check that decides ``correct`` comes out false where it has to, at a
size that the CPU holds: the control (the reference in the precision below
the configuration's, in the program's place) and each fault a cell can
have, planted under the timed path while the rest of a run goes on as the
benchmark drives it."""

from __future__ import annotations

import time

import pytest
import torch

import small  # noqa: I001 (puts the benchmark on the path)
import controls
from yardstick import harness, reference, serve

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _f32():
    reference.full_f32()


class Broken:
    """A served path with a fault planted where its answers are made."""

    def __init__(self, server, fault: str):
        self._server, self._fault = server, fault

    def __getattr__(self, name):
        return getattr(self._server, name)

    def __call__(self, frames):
        out = self._server(frames)
        boxes, scores, mask, kpts = (t.clone() for t in out)
        B = mask.shape[0]
        if self._fault == "half_batch":
            # the second half of the batch is never served
            mask[B // 2:] = False
            kpts[B // 2:] = 0
        elif self._fault == "altered":
            # each answer's keypoints moved by half of their box
            wh = (boxes[..., 2:4] - boxes[..., 0:2])[..., None, :]
            kpts = torch.where(kpts != 0, kpts + 0.5 * wh, kpts)
        return type(out)(boxes, scores, mask, kpts)


def _limits(cfg, kind):
    return cfg["limits"][kind]


@pytest.mark.parametrize("config", ["yolov3-416-rektnet.bf16", "yolov3-416-rektnet.int8"])
def test_the_control_is_not_correct(config):
    cfg = small.config(config)
    lines = controls.readings(cfg, small.traffic("serve-b8"), 2 ** 31 + 21, 0.5, CPU, True)
    sound, ctrl = lines[0]["numbers"], lines[1]["numbers"]
    limits = _limits(cfg, "serve")
    assert harness.verdict(sound, limits)[0]
    assert not harness.verdict(ctrl, limits)[0]


@pytest.mark.parametrize("cell,traffic", [
    ("yolov3-416-rektnet.bf16.serve-b8", "serve-b8"),
    ("yolov3-416-rektnet.bf16.camera-stream", "camera-stream")])
@pytest.mark.parametrize("fault", [None, "half_batch", "altered"])
def test_a_fault_in_the_served_path_is_not_correct(cell, traffic, fault):
    cfg = small.config("yolov3-416-rektnet.bf16")
    res, _ = harness.run(small.BENCH, cell, 2 ** 31 + 31, 0.5, False, CPU, time.perf_counter(),
                         cfg=cfg, traffic=small.traffic(traffic),
                         hooks={"server": lambda s: Broken(s, fault)} if fault else None)
    assert res["correct"] is (fault is None)


def test_a_missing_answer_is_not_correct():
    n = {"det_mismatch": 0.0, "missing": 1, "judged": 3, "detections": 10}
    assert not harness.verdict(n, {"det_mismatch": 0.1})[0]
    assert harness.verdict({**n, "missing": 0}, {"det_mismatch": 0.1})[0]
    assert serve.sample(__import__("numpy").random.default_rng(0), 0, 4) == []
