"""The port's pipeline-parallel serving (``infer/pp.py``) against the JAX
package's ``TwoStagePP`` and against the port's fused pipeline, on the
tiny Darknet cfg and a narrow RektNet, f32 on the CPU (as
``tests/test_parallel_tp.py::test_pipeline_parallel_matches_fused`` and
``::test_pipeline_parallel_capacity_exceeds_slots`` hold JAX's).

Against the fused pipeline: masks, boxes and scores bit-equal; keypoints
within 1e-4 px (the same crops through RektNet in another batch). Against
JAX (the overflow case, to compile JAX's stages once): masks equal at a
threshold in a gap of the confidences, boxes and keypoints at
``test_torch_pipeline.py``'s tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import gap_threshold, tiny_models
from mit_driverless_cv_traininginfra_tpu.infer.pp import TwoStagePP as JaxPP
from mit_driverless_cv_traininginfra_tpu.models.darknet import detections
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import two_stage_pipeline
from mit_driverless_cv_traininginfra_tpu_torch.infer.pp import (
    TwoStagePP,
    detect_stage,
    keypoint_stage,
)
from test_torch_pipeline import _assert_close

B, MAX_DET = 4, 16


@pytest.fixture(scope="module")
def setup():
    (jspec, jyolo, jrekt), (yolo, rekt) = tiny_models(seed=0)
    rng = np.random.default_rng(11)
    batches = [rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32) for _ in range(2)]
    conf = np.asarray(detections(jspec, jyolo, {}, jnp.asarray(np.concatenate(batches)),
                                 with_classes=False)[..., 4])
    thresh = gap_threshold(conf, per_frame=8)
    return jspec, jyolo, jrekt, yolo, rekt, batches, thresh


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))


# capacity 8 drops valid slots' keypoints (~32 valid a batch); 128 exceeds
# the B·K = 64 slots (the JAX crash shape, clamped)
@pytest.mark.parametrize("capacity", [8, 128], ids=["overflow", "above_slots"])
def test_pp_matches_fused_and_jax(setup, capacity):
    jspec, jyolo, jrekt, yolo, rekt, batches, thresh = setup
    cfg = dict(conf_thresh=thresh, max_det=MAX_DET, crop_capacity=capacity)
    cpu = torch.device("cpu")
    got = TwoStagePP(yolo, rekt, cpu, cpu, **cfg)([torch.from_numpy(b) for b in batches])
    assert len(got) == len(batches)
    if capacity < B * MAX_DET:  # JAX's compile once: the overflow case
        devs = jax.devices()
        want = JaxPP(jspec, jyolo, {}, jrekt, {}, devs[0], devs[1], **cfg)(
            [jnp.asarray(b) for b in batches])
        for g, w in zip(got, want):
            _assert_close(g, w)
    for g, fr in zip(got, batches):
        fused = two_stage_pipeline(yolo, rekt, torch.from_numpy(fr), **cfg)
        assert _bit_equal(g, fused)
        torch.testing.assert_close(g.keypoints, fused.keypoints, rtol=0, atol=1e-4)
        n_valid = int(g.mask.sum())
        kept = int((g.keypoints.abs().sum((-1, -2)) > 0).sum())
        assert kept == min(n_valid, capacity)
    assert capacity > B * MAX_DET or int(got[0].mask.sum()) > capacity


def test_stages_are_the_fused_pipeline_cut_in_two(setup):
    """detect_stage then keypoint_stage = the fused pipeline; the selection
    is the batch-global top C (valid first, score descending)."""
    _, _, _, yolo, rekt, batches, thresh = setup
    x = torch.from_numpy(batches[0])
    a = detect_stage(yolo, x, conf_thresh=thresh, max_det=MAX_DET, crop_capacity=8)
    assert a.sel.shape == (8,) and a.crops.shape == (8, 80, 80, 3)
    flat_scores = a.scores.reshape(-1)[a.sel]
    assert bool(a.mask.reshape(-1)[a.sel].all())
    assert bool((flat_scores[:-1] >= flat_scores[1:]).all())
    out = keypoint_stage(rekt, a)
    fused = two_stage_pipeline(yolo, rekt, x, conf_thresh=thresh, max_det=MAX_DET,
                               crop_capacity=8)
    assert _bit_equal(out, fused)
    torch.testing.assert_close(out.keypoints, fused.keypoints, rtol=0, atol=1e-4)


def test_uint8_frames_and_stage_devices(setup):
    """uint8 frames are normalised in stage A as the fused pipeline does;
    outputs come back on stage B's device, models already there are not
    copied."""
    _, _, _, yolo, rekt, batches, thresh = setup
    u8 = torch.from_numpy((batches[1] * 255).astype(np.uint8))
    pp = TwoStagePP(yolo, rekt, "cpu", "cpu", conf_thresh=thresh, max_det=MAX_DET)
    assert pp.yolo is yolo and pp.rekt is rekt
    (got,) = pp([u8])
    fused = two_stage_pipeline(yolo, rekt, u8, conf_thresh=thresh, max_det=MAX_DET,
                               crop_capacity=64)
    assert _bit_equal(got, fused) and got.keypoints.device == pp.device_b
    assert pp([]) == []
