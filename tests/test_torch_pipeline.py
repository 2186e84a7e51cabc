"""The PyTorch port's two-stage pipeline and server against the JAX
package, on the tiny Darknet cfg and a narrow RektNet, f32 on the CPU;
``kpt_pad_multiple``, ``crop_kernel`` on boxes past the TPU crop window,
and ``TwoStageServer.from_params``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import gap_threshold, tiny_models, to_numpy
from mit_driverless_cv_traininginfra_tpu.infer.pipeline import (
    two_stage_pipeline as jax_pipeline,
)
from mit_driverless_cv_traininginfra_tpu.models import quantize as jquantize
from mit_driverless_cv_traininginfra_tpu.models import stem_opt as jstem
from mit_driverless_cv_traininginfra_tpu.models.darknet import detections
from mit_driverless_cv_traininginfra_tpu.ops.image import (
    roi_crop_bilinear_indexed as jax_roi_crop_indexed,
)
from mit_driverless_cv_traininginfra_tpu.ops.pallas_crop import (
    crop_kernel_box_limits as jax_box_limits,
)
from mit_driverless_cv_traininginfra_tpu.ops.pallas_crop import roi_crop_windowed
from mit_driverless_cv_traininginfra_tpu_torch import convert
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
from mit_driverless_cv_traininginfra_tpu_torch.models import quantize, stem_opt
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


def _run_both(setup, frames, crop_capacity, **kw):
    jspec, jyolo, jrekt, yolo, rekt, _, _, thresh = setup
    out = two_stage_pipeline(yolo, rekt, torch.from_numpy(frames),
                             conf_thresh=thresh, max_det=MAX_DET,
                             crop_capacity=crop_capacity, **kw)
    ref = jax_pipeline(jspec, jyolo, {}, jrekt, {}, jnp.asarray(frames),
                       conf_thresh=thresh, max_det=MAX_DET,
                       crop_capacity=crop_capacity, **kw)
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
    assert stats["compiles"] == 0  # every call ran a warmed bucket
    # bootstrap + every 2nd call observed; the deferred one read by stats()
    assert stats["observations"] == 3
    assert stats["mean_load"] == float(direct.mask.sum())  # full batches
    assert stats["latency_samples"] == 1 and stats["pipeline_samples"] == 1
    # CPU tensors never launch a kernel
    assert launches == (roi_crop.launches, fused_softargmax.launches,
                        nms_topk.launches)


def test_server_refuses_int8(setup):
    """The constructor takes models and refuses the JAX server's quantized
    bundles; ``TwoStageServer.from_params`` takes them (``yolo_q``,
    ``stem_q``, ``rekt_q``; this cfg has no fused entry). From the port's
    own bundles it serves bit for bit as the server built from the
    ``Int8Darknet(stem_q=)`` and ``Int8RektNet`` models, and from the JAX
    package's detector bundles through ``convert.quantized_from_jax`` as
    well, whose leaves are the port's."""
    for kw in ("yolo_q", "stem_q", "rekt_q", "entry_q"):
        with pytest.raises(TypeError, match=kw):
            TwoStageServer(None, None, **{kw: {}})
    jspec, jyolo, jrekt, yolo, rekt, frames, _, _ = setup
    spec = yolo.spec
    folded = {k: {"w": c.weight, "b": c.bias} for k, c in yolo.convs.items()}
    rfolded = convert.from_jax(to_numpy(jrekt))
    amax = quantize.calibrate(spec, folded, frames)
    crops = np.random.default_rng(9).uniform(0, 1, (4, 80, 80, 3)).astype(np.float32)
    ramax = quantize.calibrate_rektnet(rfolded, crops)
    ours = (quantize.quantize_params(spec, folded, amax),
            quantize.quantize_packed_stem(stem_opt.build_packed_stem(folded), amax),
            quantize.quantize_rektnet_params(rfolded, ramax))
    jpacked = jstem.build_packed_stem(jyolo)
    theirs = tuple(convert.quantized_from_jax(to_numpy(t)) for t in (
        jquantize.quantize_params(jspec, jyolo, amax),
        jquantize.quantize_packed_stem(jpacked, amax))) + ours[2:]
    kw = dict(conf_thresh=0.0, max_det=4, crop_size=16)
    x = torch.from_numpy(frames)
    models = TwoStageServer(quantize.Int8Darknet(spec, ours[0], stem_q=ours[1]),
                            quantize.Int8RektNet(ours[2]), **kw)
    want = models._dispatch(x, B, 8)
    for bundles in (ours, theirs):
        server = TwoStageServer.from_params(spec, *bundles, **kw)
        assert server.yolo.stem is not None and server.yolo.entry is None
        got = server._dispatch(x, B, 8)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_kpt_pad_multiple_matches_jax(setup):
    """Capacity 12 padded to 16 for the keypoint net (12 % 8 ≠ 0): equal to
    JAX's padded pipeline, and to the unpadded one within RektNet's
    batch-size rounding."""
    frames = setup[5]
    out, ref = _run_both(setup, frames, 12, kpt_pad_multiple=8)
    _assert_close(out, ref)
    plain, _ = _run_both(setup, frames, 12)
    assert torch.equal(out.mask, plain.mask)
    torch.testing.assert_close(out.keypoints, plain.keypoints, rtol=1e-5, atol=1e-4)


def test_crop_kernel_on_oversize_boxes():
    """A box past the TPU crop window (h > 240, w > 211 px at C=3) in a 416²
    frame (at 256² the window, 256 rows of 768 lanes, holds the whole
    frame): K1's plain crop, what the pipeline runs whatever the server's
    ``crop_kernel``, equals the JAX package's exact indexed crop
    (``crop_kernel=False``) within ``test_torch_crop.py``'s bound, where
    JAX's windowed kernel (interpret mode) clips the box to its window."""
    rng = np.random.default_rng(4)
    frames = rng.uniform(0, 1, (1, 416, 416, 3)).astype(np.float32)
    boxes = np.asarray([[20.5, 30.0, 360.0, 371.5], [30.0, 40.0, 90.0, 120.0]],
                       np.float32)
    fidx = np.zeros(2, np.int32)
    h, w = boxes[0, 3] - boxes[0, 1], boxes[0, 2] - boxes[0, 0]
    jmax_h, jmax_w = jax_box_limits(3)
    assert h > jmax_h and w > jmax_w
    got = roi_crop(torch.from_numpy(frames), torch.from_numpy(boxes),
                   torch.from_numpy(fidx)).numpy()
    exact = np.asarray(jax_roi_crop_indexed(jnp.asarray(frames), jnp.asarray(boxes),
                                            jnp.asarray(fidx), 80, 80))
    windowed = np.asarray(roi_crop_windowed(jnp.asarray(frames), jnp.asarray(boxes),
                                            jnp.asarray(fidx), interpret=True))
    np.testing.assert_allclose(got, exact, rtol=0, atol=5e-5)
    # the box inside the window agrees three ways; the oversize one is clipped
    np.testing.assert_allclose(windowed[1], exact[1], rtol=0, atol=5e-5)
    assert float(np.abs(windowed[0] - exact[0]).max()) > 0.1


def test_crop_kernel_flag_runs_the_same_crop(setup):
    """The server's ``crop_kernel`` changes what it reports, not what it
    runs: both settings serve the same outputs, and only the flag's keys
    differ in ``stats()``."""
    frames = torch.from_numpy(setup[5])
    servers = [TwoStageServer(*setup[3:5], conf_thresh=setup[7], max_det=MAX_DET,
                              observe_every=1, crop_kernel=on) for on in (True, False)]
    outs = [[srv(frames) for _ in range(2)] for srv in servers]
    for a, b in zip(*outs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    on, off = (srv.stats() for srv in servers)
    keys = ("oversize_boxes", "oversize_observed", "crop_kernel_active",
            "crop_kernel_switches")
    assert [on[k] for k in keys] == [0, int(outs[0][0].mask.sum()) * 2, True, 0]
    assert [off[k] for k in keys] == [None, None, False, 0]
    for k in ("calls", "compiles", "observations", "mean_load", "current_capacity"):
        assert on[k] == off[k], k


def test_resolve_device_is_explicit():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
