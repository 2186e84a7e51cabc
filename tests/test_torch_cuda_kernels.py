"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: without a CUDA device every test skips (a CUDA
kernel has no interpret mode). This file imports no JAX, so it also runs
where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.config import load_network_spec
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
    two_stage_pipeline,
)
from mit_driverless_cv_traininginfra_tpu_torch.models import (
    darknet,
    rektnet,
    stem_opt,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_crop import roi_crop
from mit_driverless_cv_traininginfra_tpu_torch.ops import entry
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    _torch_nms_topk,
    _torch_softargmax,
    fused_softargmax,
    nms_topk,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.image import (
    roi_crop_bilinear_indexed,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_crop_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.uniform(0, 1, (2, 37, 53, 3)).astype(
        np.float32)).to(cuda, dtype)
    boxes = torch.tensor([[0, 0, 53, 37], [3.5, 2.25, 20, 30], [40, 30, 53, 37],
                          [-5, -5, 60, 60], [10, 10, 10.0001, 12],
                          [-np.inf, 1, np.inf, np.nan]], device=cuda)
    fidx = torch.tensor([0, 1, 1, 0, 1, 0], device=cuda)
    got = roi_crop(frames, boxes, fidx, 16, 24)
    ref = roi_crop_bilinear_indexed(frames, boxes, fidx, 16, 24)
    torch.cuda.synchronize()
    # finite boxes: bit-exact in bf16 (tap products exact in f32), ≤ 1 ulp
    # of a [0, 1] value in f32; the non-finite box only has to stay in bounds
    tol = 0.0 if dtype == torch.bfloat16 else 2 ** -23
    assert (got[:-1].float() - ref[:-1].float()).abs().max() <= tol
    with pytest.raises(TypeError):
        roi_crop(frames.half(), boxes, fidx)


@pytest.mark.parametrize("shape", [(5, 13, 17), (3, 80, 80)])
def test_softargmax_matches_plain(cuda, shape):
    z = torch.from_numpy(np.random.default_rng(1).normal(0, 4, shape).astype(
        np.float32)).to(cuda)
    pts, probs = fused_softargmax(z)
    ref_pts, ref_probs = _torch_softargmax(z)
    torch.testing.assert_close(pts, ref_pts, atol=1e-6, rtol=0)
    torch.testing.assert_close(probs, ref_probs, atol=1e-6, rtol=0)


@pytest.mark.parametrize("k,n", [(1, 7), (16, 16), (64, 1000)])
def test_nms_topk_matches_plain_slot_for_slot(cuda, k, n):
    rng = np.random.default_rng(2)
    c = rng.uniform(0, 100, (3, n, 2))
    wh = rng.uniform(5, 40, (3, n, 2))
    boxes = torch.from_numpy(np.concatenate([c - wh / 2, c + wh / 2], -1)
                             .astype(np.float32)).to(cuda)
    scores = torch.from_numpy(rng.uniform(0, 1, (3, n)).astype(np.float32))
    scores[1, : n // 2] = 0.9  # exact ties
    scores = scores.to(cuda)
    got = nms_topk(boxes, scores, 0.5, k, 0.3)
    ref = _torch_nms_topk(boxes, scores, 0.5, k, 0.3)
    for g, r in zip(got, (ref[0], ref[1], ref[3])):
        assert torch.equal(g, r)


def test_nms_topk_rejects_bad_k(cuda):
    boxes = torch.zeros((1, 10, 4), device=cuda)
    scores = torch.zeros((1, 10), device=cuda)
    with pytest.raises(ValueError):
        nms_topk(boxes, scores, 0.5, k=11)


def test_tiny_pipeline_card_matches_cpu(cuda):
    cfg = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_test.cfg")
    spec = load_network_spec(cfg, vanilla_anchor=True)
    rng = np.random.default_rng(3)
    yp, ys = convert.init_darknet_np(spec, rng)
    rp, rs = convert.init_rektnet_np(rng, net_size=4)
    spec1, folded = stem_opt.slice_preyolo(
        spec, darknet.fold_bn(convert.from_jax(yp), convert.from_jax(ys), spec))
    yolo = darknet.Darknet(spec1, folded)
    rekt = rektnet.RektNet(rektnet.fold_bn(convert.from_jax(rp),
                                           convert.from_jax(rs)))
    frames = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        conf = yolo.detections(frames, with_classes=False)[..., 4].flatten()
    flat = conf.sort().values
    thresh = float((flat[-12] + flat[-13]) / 2)
    ref = two_stage_pipeline(yolo, rekt, frames, conf_thresh=thresh,
                             crop_capacity=8)
    launches = roi_crop.launches
    out = two_stage_pipeline(yolo.to(cuda), rekt.to(cuda), frames.to(cuda),
                             conf_thresh=thresh, crop_capacity=8)
    assert roi_crop.launches == launches + 1
    assert torch.equal(out.mask.cpu(), ref.mask)
    torch.testing.assert_close(out.keypoints.cpu(), ref.keypoints,
                               rtol=1e-4, atol=1e-3)


def _entry_bundle(cuda, seed: int):
    """A seeded, packed K4 bundle (``quantize_entry`` on random folded
    weights, then ``pack_entry``)."""
    rng = np.random.default_rng(seed)

    def conv(o, i, k):
        return {"w": torch.from_numpy(rng.standard_normal((o, i, k, k))
                                      .astype(np.float32) * 0.1),
                "b": torch.from_numpy(rng.standard_normal(o)
                                      .astype(np.float32) * 0.1)}

    folded = {"0": conv(32, 3, 3), "1": conv(64, 32, 3), "2": conv(32, 64, 1),
              "3": conv(64, 32, 3)}
    ep = entry.quantize_entry(folded, {"0": 1.0, "1": 3.0, "2": 2.0,
                                       "3": 2.5, "5": 4.0})
    return {k: v.to(cuda) for k, v in entry.pack_entry(ep).items()}, rng


@pytest.mark.parametrize("B,H,W", [(2, 32, 48), (8, 208, 208)],
                         ids=["small", "full"])
def test_entry_block_bit_equal_to_plain(cuda, B, H, W):
    """K4 against ``_entry_rest`` on the card: every int8 equal, at a small
    non-square shape and at the main path's (8, 208, 208, 128)."""
    ep, rng = _entry_bundle(cuda, 5)
    frames = torch.from_numpy(rng.uniform(0, 1, (B, 2 * H, 2 * W, 3))
                              .astype(np.float32)).to(cuda, torch.bfloat16)
    hq = entry.conv1_4x4_q8(frames, ep, 0.1)
    launches = entry.fused_entry_block.launches
    got = entry.fused_entry_block(hq, ep, 0.1)
    ref = entry._entry_rest(hq, ep, 0.1)
    torch.cuda.synchronize()
    assert entry.fused_entry_block.launches == launches + 1
    assert got.shape == (B, H, W, 64) and got.dtype == torch.int8
    assert torch.equal(got, ref)


def test_entry_block_zero_padding_with_extreme_edges(cuda):
    """±127 on every border row and column of hq: the conv2p pad (top and
    left only) and the 3×3's zeros outside the frame must match the plain
    version's padding exactly."""
    ep, rng = _entry_bundle(cuda, 6)
    hq = rng.integers(-10, 40, (3, 48, 32, 128), dtype=np.int8)
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        hq[edge] = rng.choice([-127, 127], hq[edge].shape).astype(np.int8)
    hq = torch.from_numpy(hq).to(cuda)
    got = entry.fused_entry_block(hq, ep, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, entry._entry_rest(hq, ep, 0.1))
    cpu = {k: v.cpu() for k, v in ep.items()}
    assert torch.equal(got.cpu(), entry._entry_rest(hq.cpu(), cpu, 0.1))


def test_entry_block_rejects_bad_shapes(cuda):
    ep, _ = _entry_bundle(cuda, 7)
    with pytest.raises(ValueError):
        entry.fused_entry_block(torch.zeros((1, 24, 32, 128), dtype=torch.int8,
                                            device=cuda), ep, 0.1)
    with pytest.raises(ValueError):
        entry.fused_entry_block(torch.zeros((1, 32, 32, 128), dtype=torch.int8,
                                            device=cuda),
                                {**ep, "w2_k4": ep["w2_k4"].cpu()}, 0.1)
