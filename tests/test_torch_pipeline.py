"""The PyTorch port's two-stage pipeline and server against the JAX
package, on the tiny Darknet cfg and a narrow RektNet, f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import gap_threshold, tiny_models
from mit_driverless_cv_traininginfra_tpu.infer.pipeline import (
    two_stage_pipeline as jax_pipeline,
)
from mit_driverless_cv_traininginfra_tpu.models.darknet import detections
from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device
from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import (
    AdaptiveCapacity,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
    two_stage_pipeline,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import (
    TwoStageServer,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_crop import roi_crop
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    fused_softargmax,
    nms_topk,
)

B, MAX_DET = 3, 16


@pytest.fixture(scope="module")
def setup():
    (jspec, jyolo, jrekt), (yolo, rekt) = tiny_models(seed=0)
    rng = np.random.default_rng(5)
    frames_u8 = rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    frames = frames_u8.astype(np.float32) / 255.0
    conf = np.asarray(detections(jspec, jyolo, {}, jnp.asarray(frames),
                                 with_classes=False)[..., 4])
    thresh = gap_threshold(conf, per_frame=8)
    return jspec, jyolo, jrekt, yolo, rekt, frames, frames_u8, thresh


def _run_both(setup, frames, crop_capacity):
    jspec, jyolo, jrekt, yolo, rekt, _, _, thresh = setup
    out = two_stage_pipeline(yolo, rekt, torch.from_numpy(frames),
                             conf_thresh=thresh, max_det=MAX_DET,
                             crop_capacity=crop_capacity)
    ref = jax_pipeline(jspec, jyolo, {}, jrekt, {}, jnp.asarray(frames),
                       conf_thresh=thresh, max_det=MAX_DET,
                       crop_capacity=crop_capacity)
    return out, ref


def _assert_close(out, ref):
    # masks exactly; boxes/scores f32 through a few CPU convs (rtol 1e-4);
    # keypoints = box corner + crop point × box size, in frame pixels:
    # atol 1e-3 px on boxes of tens of pixels
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    m = np.asarray(ref.mask)
    np.testing.assert_allclose(out.boxes.numpy()[m], np.asarray(ref.boxes)[m],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.scores.numpy()[m],
                               np.asarray(ref.scores)[m], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.keypoints.numpy(),
                               np.asarray(ref.keypoints), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("capacity", [None, 32], ids=["dense", "compacted"])
def test_matches_jax(setup, capacity):
    frames = setup[5]
    out, ref = _run_both(setup, frames, capacity)
    n_valid = int(np.asarray(ref.mask).sum())
    assert 0 < n_valid <= 32  # under capacity: every valid slot cropped
    _assert_close(out, ref)


def test_compacted_overflow_zeroes_dropped_keypoints(setup):
    frames = setup[5]
    n_valid = int(_run_both(setup, frames, None)[0].mask.sum())
    cap = max(1, n_valid // 2)
    out, ref = _run_both(setup, frames, cap)
    _assert_close(out, ref)
    dropped = out.mask & (out.keypoints.abs().sum(dim=(-1, -2)) == 0)
    assert int(dropped.sum()) == n_valid - cap  # all-zero sentinel


def test_uint8_feed_matches_jax(setup):
    frames_u8 = setup[6]
    out, ref = _run_both(setup, frames_u8, 32)
    _assert_close(out, ref)
    f32_out, _ = _run_both(setup, setup[5], 32)
    np.testing.assert_array_equal(out.mask.numpy(), f32_out.mask.numpy())


def test_server_answers_and_counts(setup):
    _, _, _, yolo, rekt, frames, _, thresh = setup
    policy = AdaptiveCapacity(floor=16, quantum=16)
    server = TwoStageServer(yolo, rekt, conf_thresh=thresh, max_det=MAX_DET,
                            policy=policy, observe_every=2)
    server.warmup([B], capacities=[16, 32])
    assert server.warmed == {(B, 16), (B, 32)}
    launches = (roi_crop.launches, fused_softargmax.launches, nms_topk.launches)
    outs = [server(frames) for _ in range(4)]
    short = server(frames[:2])  # padded to the warmed B=3, sliced back
    assert short.mask.shape == (2, MAX_DET)
    direct = two_stage_pipeline(yolo, rekt, torch.from_numpy(frames),
                                conf_thresh=thresh, max_det=MAX_DET,
                                crop_capacity=server.current_capacity)
    assert torch.equal(outs[-1].mask, direct.mask)
    torch.testing.assert_close(outs[-1].keypoints, direct.keypoints)
    torch.testing.assert_close(short.keypoints, outs[-1].keypoints[:2])
    stats = server.stats()
    assert stats["calls"] == 5 and stats["batch_pads"] == 1
    assert stats["cold_calls"] == 0  # every call ran a warmed bucket
    # bootstrap + every 2nd call observed; the deferred one read by stats()
    assert stats["observations"] == 3
    assert stats["mean_load"] == float(direct.mask.sum())  # full batches
    assert stats["latency_samples"] == 1 and stats["pipeline_samples"] == 1
    # CPU tensors never launch a kernel
    assert launches == (roi_crop.launches, fused_softargmax.launches,
                        nms_topk.launches)


def test_server_refuses_int8():
    """The int8 configuration comes as models, ``Int8Darknet`` and
    ``Int8RektNet`` (tests/test_torch_pipeline_int8.py): the server refuses
    the JAX server's quantized bundles."""
    for kw in ("yolo_q", "stem_q", "rekt_q", "entry_q"):
        with pytest.raises(TypeError, match=kw):
            TwoStageServer(None, None, **{kw: {}})


def test_resolve_device_is_explicit():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
