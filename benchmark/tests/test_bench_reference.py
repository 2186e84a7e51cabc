"""The plain reference agrees with the program at a small size on the CPU:
the f32 pipeline, the int8 pipeline against the reference's emulation of
the int8 recipe."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import small
from yardstick import harness, judge, reference, serve


@pytest.fixture(autouse=True)
def _f32():
    reference.full_f32()
    torch.manual_seed(0)


def _served(cfg, seed=11):
    tr = small.traffic("serve-b8")
    st = serve.Setup(cfg, tr, seed, torch.device("cpu"))
    loop = harness.runner("closed_loop").ClosedLoop(st)
    loop.run(0.5)
    answers = loop.answers(range(len(loop.requests)))
    st.free_program()
    pipe = st.reference(cfg["reference"]["numerics"])
    scenes_u8 = torch.from_numpy(st.pool)
    return judge.judge(answers, judge.reference_dets(pipe, scenes_u8), pipe, scenes_u8,
                       torch.device("cpu"))


def test_f32_pipeline_agrees_with_the_reference():
    cfg = small.config("yolov3-416-rektnet.bf16")
    cfg["serving"]["precision"] = "f32"
    n = _served(cfg)
    assert n["detections"] > 0 and n["det_mismatch"] == 0.0
    assert n["box_err"] < 1e-4 and n["score_err"] < 1e-5 and n["kpt_err"] < 1e-4


def test_int8_pipeline_agrees_with_the_reference_emulation():
    n = _served(small.config("yolov3-416-rektnet.int8"))
    assert n["detections"] > 0 and n["det_mismatch"] == 0.0
    assert n["box_err"] == 0.0 and n["score_err"] == 0.0
    assert n["kpt_err"] < 1e-5


def test_crop_matches_the_documented_sampling():
    frames = torch.arange(2 * 8 * 8 * 1, dtype=torch.float32).reshape(2, 8, 8, 1)
    boxes = torch.tensor([[0.0, 0.0, 8.0, 8.0], [2.0, 2.0, 4.0, 6.0]])
    c = reference.crop(frames, boxes, torch.tensor([0, 1]), 8)
    # a whole-frame box samples pixel centres exactly
    assert torch.equal(c[0, ..., 0], frames[0, ..., 0])
    # a 2x4 box: x centres 2 + 2 (j + .5)/8 - .5, held in [2, 3]
    sx = np.clip(2 + 2 * (np.arange(8) + 0.5) / 8 - 0.5, 2, 3)
    sy = np.clip(2 + 4 * (np.arange(8) + 0.5) / 8 - 0.5, 2, 5)
    want = 64 + sy[:, None] * 8 + sx[None, :]
    assert np.allclose(c[1, ..., 0].numpy(), want, atol=1e-4)
