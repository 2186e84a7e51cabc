"""The port's int8 serving configuration against the JAX package's, on the
CPU: ``two_stage_pipeline_int8`` and ``TwoStageServer`` with the fused
entry, on the 64² YOLOv3 entry cfg and a full-width RektNet.

Both packages run on identical integers (quantized once in JAX, carried
across by ``convert.quantized_from_jax``). The JAX pipeline runs under
``jax.disable_jit()``: jitted, XLA:CPU fuses ``acc·scale + b`` into FMAs
across the graph, which shifts confidences by up to ~6e-4 — more than a
threshold gap can absorb — while op by op it rounds as the port does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import entry_specs, gap_threshold, int8_models
from mit_driverless_cv_traininginfra_tpu.infer.pipeline import (
    two_stage_pipeline_int8 as jax_pipeline_int8,
)
from mit_driverless_cv_traininginfra_tpu.models import quantize as jquantize
from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import (
    AdaptiveCapacity,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
    two_stage_pipeline,
    two_stage_pipeline_int8,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import (
    TwoStageServer,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.entry import (
    fused_entry_block,
)

B, MAX_DET = 3, 16


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    specs = entry_specs(tmp_path_factory.mktemp("cfg"))
    rng = np.random.default_rng(5)
    frames_u8 = rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    frames = frames_u8.astype(np.float32) / 255.0
    (jspec, yolo_q, entry_q, rekt_q), (yolo, rekt) = int8_models(specs, frames)
    fb = (jnp.asarray(frames_u8).astype(jnp.float32) / 255.0).astype(
        jnp.bfloat16)
    with jax.disable_jit():
        conf = np.asarray(jquantize.detections_int8(
            jspec, yolo_q, fb, with_classes=False, entry_q=entry_q)[..., 4])
    thresh = gap_threshold(conf, per_frame=6)
    return (jspec, yolo_q, entry_q, rekt_q), (yolo, rekt), frames_u8, thresh


def _run_both(setup, frames, crop_capacity):
    (jspec, yolo_q, entry_q, rekt_q), (yolo, rekt), _, thresh = setup
    out = two_stage_pipeline_int8(yolo, rekt, torch.from_numpy(frames),
                                  conf_thresh=thresh, max_det=MAX_DET,
                                  crop_capacity=crop_capacity)
    with jax.disable_jit():
        ref = jax_pipeline_int8(jspec, yolo_q, None, rekt_q,
                                jnp.asarray(frames), conf_thresh=thresh,
                                max_det=MAX_DET, crop_capacity=crop_capacity,
                                entry_q=entry_q)
    return out, ref


@pytest.mark.parametrize("capacity", [None, 8], ids=["dense", "compacted"])
def test_int8_pipeline_matches_jax(setup, capacity):
    frames_u8 = setup[2]
    out, ref = _run_both(setup, frames_u8, capacity)
    m = np.asarray(ref.mask)
    assert 0 < int(m.sum())
    # masks exactly, at a threshold mid-way between two confidences
    np.testing.assert_array_equal(out.mask.numpy(), m)
    # boxes from the same integers and the same f32 decode; keypoints
    # through the bf16 crop and int8 RektNet (its f32 head sums in another
    # order): 1e-3 px on boxes of tens of pixels
    np.testing.assert_allclose(out.boxes.numpy()[m], np.asarray(ref.boxes)[m],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out.keypoints.numpy(),
                               np.asarray(ref.keypoints), rtol=1e-5,
                               atol=1e-3)
    if capacity is not None:  # dropped slots carry the all-zero sentinel
        n_dropped = int(m.sum()) - capacity
        zero = out.mask & (out.keypoints.abs().sum(dim=(-1, -2)) == 0)
        assert int(zero.sum()) == max(0, n_dropped)


def test_uint8_feed_is_the_bf16_feed(setup):
    """uint8 frames go f32 /255 then bf16 — the frames the int8 detector
    and the crops see — whatever dtype the models' buffers hold."""
    _, (yolo, rekt), frames_u8, thresh = setup
    u8 = two_stage_pipeline_int8(yolo, rekt, torch.from_numpy(frames_u8),
                                 conf_thresh=thresh, crop_capacity=8)
    bf = (torch.from_numpy(frames_u8).float() / 255.0).to(torch.bfloat16)
    direct = two_stage_pipeline_int8(yolo, rekt, bf, conf_thresh=thresh,
                                     crop_capacity=8)
    for a, b in zip(u8, direct):
        assert torch.equal(a, b)


def test_frame_dtype_comes_from_the_configuration(setup):
    """The int8 detector holds no parameters, only int8/f32/bf16 buffers:
    the pipeline and the server take its frame dtype (bf16) from the
    configuration, and a dtype read off the first parameter or buffer
    would be wrong or missing."""
    _, (yolo, rekt), frames_u8, thresh = setup
    assert list(yolo.parameters()) == []
    assert next(yolo.buffers()).dtype != torch.bfloat16
    assert yolo.frame_dtype == torch.bfloat16
    server = TwoStageServer(yolo, rekt, conf_thresh=thresh)
    assert server.frame_dtype == torch.bfloat16
    assert server.device == torch.device("cpu")
    # the bf16/f32 entry point serves the int8 models the same way
    a = two_stage_pipeline(yolo, rekt, torch.from_numpy(frames_u8),
                           conf_thresh=thresh, crop_capacity=8)
    b = two_stage_pipeline_int8(yolo, rekt, torch.from_numpy(frames_u8),
                                conf_thresh=thresh, crop_capacity=8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_int8_server_warms_pads_and_counts(setup):
    _, (yolo, rekt), frames_u8, thresh = setup
    policy = AdaptiveCapacity(floor=8, quantum=8)
    server = TwoStageServer(yolo, rekt, conf_thresh=thresh, max_det=MAX_DET,
                            policy=policy, observe_every=2)
    launches = fused_entry_block.launches
    server.warmup([B], capacities=[8, 16])
    assert server.warmed == {(B, 8), (B, 16)}
    frames = torch.from_numpy(frames_u8)
    outs = [server(frames) for _ in range(3)]
    short = server(frames[:2])  # padded to the warmed B=3, sliced back
    assert short.mask.shape == (2, MAX_DET)
    direct = two_stage_pipeline_int8(yolo, rekt, frames, conf_thresh=thresh,
                                     max_det=MAX_DET,
                                     crop_capacity=server.current_capacity)
    assert torch.equal(outs[-1].mask, direct.mask)
    assert torch.equal(outs[-1].keypoints, direct.keypoints)
    assert torch.equal(short.keypoints, outs[-1].keypoints[:2])
    stats = server.stats()
    assert stats["calls"] == 4 and stats["batch_pads"] == 1
    assert stats["compiles"] == 0
    assert stats["observations"] == 3  # bootstrap, every 2nd, drained
    assert fused_entry_block.launches == launches  # CPU: the plain version
