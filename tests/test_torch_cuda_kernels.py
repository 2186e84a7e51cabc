"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: without a CUDA device every test skips (a CUDA
kernel has no interpret mode). This file imports no JAX, so it also runs
where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    load_network_spec,
)
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
from mit_driverless_cv_traininginfra_tpu_torch.ops import resstage
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    NMS_CTAS,
    _cuda_nms_topk,
    _torch_nms_topk,
    _torch_softargmax,
    _torch_softargmax_bwd,
    fused_softargmax,
    nms_topk,
    softargmax_bwd,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.image import (
    _crop_coords,
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


def _smoke():
    """The smoke script's helpers (``crop_boxes``, ``device_kernels``,
    ``sass_count``), imported from the repository root."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def _test_boxes(n: int):
    """``chip_smoke.crop_boxes`` (edge boxes, the last non-finite) in a
    416² frame, plus a degenerate and an inverted box."""
    boxes = _smoke().crop_boxes(np.random.default_rng(14), max(n, 8))
    boxes[1] = [10, 10, 10.0005, 30]   # width below the 1e-3 floor
    boxes[2] = [50, 40, 30, 20]        # x1 < x0, y1 < y0
    return boxes


def _same_bits_nan(a, b) -> bool:
    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan())
                and torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


@pytest.mark.parametrize("out_hw", [(80, 80), (16, 24)])
def test_crop_coords_on_the_card_match_the_cpu(cuda, out_hw):
    """The plain crop's sampling coordinates are the CPU's (and so the JAX
    package's) bits on the card too."""
    boxes = torch.from_numpy(_test_boxes(64))
    sx, sy = _crop_coords(boxes.to(cuda), *out_hw, 416, 416)
    rx, ry = _crop_coords(boxes, *out_hw, 416, 416)
    assert _same_bits_nan(sx.cpu(), rx) and _same_bits_nan(sy.cpu(), ry)


@pytest.mark.parametrize("idx_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("N", [0, 1, 64, 1000])
def test_roi_crop_bit_equal_at_every_size(cuda, N, C, idx_dtype):
    """K1 against the plain crop in bf16, bit for bit on the finite boxes
    (C = 2 takes the runtime-C instantiation; 1000 crops make more blocks
    than one wave); one launch a call."""
    rng = np.random.default_rng(N + C)
    frames = torch.from_numpy(rng.uniform(0, 1, (3, 416, 416, C)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    boxes = torch.from_numpy(_test_boxes(N)[:N]).to(cuda)
    fidx = torch.from_numpy(rng.integers(0, 3, N)).to(cuda, idx_dtype)
    launches = roi_crop.launches
    got = roi_crop(frames, boxes, fidx)
    ref = roi_crop_bilinear_indexed(frames, boxes, fidx)
    torch.cuda.synchronize()
    assert roi_crop.launches == launches + 1
    assert got.shape == (N, 80, 80, C) and got.dtype == torch.bfloat16
    finite = torch.isfinite(boxes).all(dim=1)
    assert torch.equal(got[finite].view(torch.int16), ref[finite].view(torch.int16))


@pytest.mark.parametrize("value", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("field", [0, 1, 2, 3])
def test_roi_crop_non_finite_box_fields_stay_in_bounds(cuda, field, value):
    """A NaN or ±inf in any of the four box fields reads nothing outside
    the frame (no fault at the sync); the other crops stay bit-equal."""
    rng = np.random.default_rng(15)
    frames = torch.from_numpy(rng.uniform(0, 1, (2, 64, 96, 3)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    boxes = torch.tensor([[3.5, 2.25, 60, 50], [0, 0, 96, 64], [10, 5, 40, 30.5]],
                         device=cuda)
    boxes[1, field] = value
    fidx = torch.tensor([1, 0, 1], device=cuda)
    got = roi_crop(frames, boxes, fidx, 16, 24)
    ref = roi_crop_bilinear_indexed(frames, boxes, fidx, 16, 24)
    torch.cuda.synchronize()
    keep = [0, 2]
    assert torch.equal(got[keep].view(torch.int16), ref[keep].view(torch.int16))
    # what it does sample is a blend of [0, 1] pixels (or NaN)
    assert bool((got[1].float().abs() <= 1.01).logical_or(got[1].isnan()).all())


def test_roi_crop_takes_strided_bf16_boxes_and_one_kernel_a_call(cuda):
    """bf16 boxes in a strided view (the pipeline's dtypes and layouts vary)
    give the plain crop's bits, and the profiler sees exactly one launch per
    call, of K1's kernel: no cast, copy or coordinate op reaches the card."""
    rng = np.random.default_rng(16)
    frames = torch.from_numpy(rng.uniform(0, 1, (8, 416, 416, 3)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    wide = torch.from_numpy(np.concatenate([_test_boxes(64)[:-1], np.zeros((63, 4), np.float32)],
                                           1)).to(cuda, torch.bfloat16)
    boxes = wide[:, :4]  # stride (8, 1)
    fidx = torch.from_numpy(rng.integers(0, 8, 63)).to(cuda)
    got = roi_crop(frames, boxes, fidx)
    ref = roi_crop_bilinear_indexed(frames, boxes, fidx)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    kernels, per_call, _ = _smoke().device_kernels(lambda: roi_crop(frames, boxes, fidx), 5)
    assert per_call == 1 and kernels and all("roi_crop" in k for k in kernels), kernels
    with pytest.raises(TypeError):
        roi_crop(frames, boxes.double(), fidx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(448, 80, 80), (784, 80, 80), (5, 13, 17), (1, 1, 7),
                                   (4, 160, 160)])
def test_softargmax_matches_plain(cuda, shape, dtype):
    """K2's forward within the smoke's tolerances of ``_torch_softargmax``
    (sums in another order): points 1e-6 in f32, 2e-3 in bf16; probs atol
    1e-6, and in bf16 rtol 2^-8 against the plain version's probabilities
    before their bf16 rounding (half a bf16 ulp is at most 2^-8 of the
    value). Against the plain bf16 probabilities, a value whose f32 sum
    lands on a rounding boundary may round the other way: such values must
    be neighbouring bf16 numbers. Rows holding a NaN or a +inf are NaN in
    both; an all-equal row is uniform. 160×160 rows are longer than a
    block's registers hold: the kernel reads the rest again. One launch a
    call."""
    z = torch.from_numpy(np.random.default_rng(1).normal(0, 4, shape).astype(np.float32))
    if shape[0] >= 4:
        z[1, 0, -1] = np.nan
        z[2, -1, 0] = np.inf
        z[3] = 2.5
    z = z.to(cuda, dtype)
    pts, probs = fused_softargmax(z)
    ref_pts, ref_probs = _torch_softargmax(z)
    assert pts.dtype == torch.float32 and probs.dtype == dtype and probs.shape == z.shape
    torch.testing.assert_close(pts, ref_pts, atol=_smoke().PTS_ATOL[dtype], rtol=0,
                               equal_nan=True)
    unrounded = _torch_softargmax(z.float())[1]  # the plain probabilities in f32
    torch.testing.assert_close(probs.float(), unrounded, atol=1e-6,
                               rtol=0 if dtype == torch.float32 else 2 ** -8, equal_nan=True)
    if dtype == torch.bfloat16:
        step = (probs.view(torch.int16).int() - ref_probs.view(torch.int16).int()).abs()
        assert int(step[~ref_probs.isnan()].max()) <= 1
    if shape[0] >= 4:
        assert probs[1:3].isnan().all() and pts[1:3].isnan().all()
        assert bool((probs[3].float() == probs[3, 0, 0].float()).all())
    kernels, per_call, _ = _smoke().device_kernels(lambda: fused_softargmax(z), 5)
    assert per_call == 1 and kernels and all("softargmax" in k for k in kernels), kernels


@pytest.mark.parametrize("k,n", [(1, 7), (16, 16), (64, 64), (64, 1000)])
def test_nms_topk_matches_plain_slot_for_slot(cuda, k, n):
    rng = np.random.default_rng(2)
    c = rng.uniform(0, 100, (3, n, 2))
    wh = rng.uniform(5, 40, (3, n, 2))
    boxes = torch.from_numpy(np.concatenate([c - wh / 2, c + wh / 2], -1)
                             .astype(np.float32)).to(cuda)
    scores = torch.from_numpy(rng.uniform(0, 1, (3, n)).astype(np.float32))
    scores[1, : n // 2] = 0.9  # exact ties
    scores = scores.to(cuda)
    got = _cuda_nms_topk(boxes, scores, 0.5, k, 0.3)
    ref = _torch_nms_topk(boxes, scores, 0.5, k, 0.3)
    assert torch.equal(got[2].long(), ref[2])
    for g, r in zip(got, ref):
        assert _same_bits_nan(g, r) if g.dtype == torch.float32 else torch.equal(g.long(), r.long())


def _assert_nms_bit_equal(got, ref):
    """Slots, scores, indices, boxes (NaN where the plain one is) and keep
    flags of ``_cuda_nms_topk`` bit-equal to ``_torch_nms_topk``."""
    b, s, i, keep = got
    rb, rs, ri, rkeep = ref
    assert torch.equal(i.long(), ri) and torch.equal(keep, rkeep)
    assert torch.equal(s.view(torch.int32), rs.view(torch.int32))
    assert _same_bits_nan(b, rb)


@pytest.mark.parametrize("B", [1, 3, 8, 128])
def test_nms_topk_bit_equal_on_served_frames(cuda, B):
    """At 416² (N = 10647, k = 16) on ``chip_smoke.nms_inputs`` frames —
    fewer than k above conf, exact ties, none above conf, non-finite
    corners, clustered boxes — and one launch a call."""
    N, conf, ovl = 3 * (13 * 13 + 26 * 26 + 52 * 52), 0.8, 0.25
    boxes, scores = _smoke().nms_inputs(np.random.default_rng(20 + B), max(B, 5), N, conf)
    pick = np.roll(np.arange(max(B, 5)), -1)[:B]  # the special frames first
    b, s = boxes[pick].to(cuda), scores[pick].to(cuda)
    _assert_nms_bit_equal(_cuda_nms_topk(b, s, conf, 16, ovl),
                          _torch_nms_topk(b, s, conf, 16, ovl))
    kernels, per_call, _ = _smoke().device_kernels(lambda: nms_topk(b, s, conf, 16, ovl), 5)
    assert per_call == 1 and kernels and all("nms_topk" in k for k in kernels), kernels


@pytest.mark.parametrize("k", [1, 16, 64])
def test_nms_topk_ties_on_the_chunk_edges(cuda, k):
    """Equal scores on both sides of every CTA chunk's edge (and at the
    row's ends): the merge across the cluster of ``NMS_CTAS`` CTAs keeps
    lax.top_k's order, ties to the lower index."""
    N = 3 * (13 * 13 + 26 * 26 + 52 * 52)
    rng = np.random.default_rng(30 + k)
    boxes, scores = _smoke().nms_inputs(rng, 5, N, 0.8)
    chunk = -(-N // NMS_CTAS)
    for c in range(NMS_CTAS + 1):
        edge = min(N, c * chunk)
        scores[0, max(0, edge - 3):edge + 3] = 0.99
        scores[2, max(0, edge - 1):edge + 1] = 0.81
    b, s = boxes.to(cuda), scores.to(cuda)
    _assert_nms_bit_equal(_cuda_nms_topk(b, s, 0.8, k, 0.25),
                          _torch_nms_topk(b, s, 0.8, k, 0.25))


@pytest.mark.parametrize("k", [1, 16, 64])
def test_nms_topk_signed_zeros_below_zero_conf(cuda, k):
    """``conf_thresh = -1`` on scores of ±0, −0.5 and ties at the chunk
    edges: K3 ranks +0 above −0 as ``lax.top_k`` does, and its slots are
    bit-equal to the plain version's."""
    N = 3 * (13 * 13 + 26 * 26 + 52 * 52)
    rng = np.random.default_rng(40 + k)
    boxes, _ = _smoke().nms_inputs(rng, 5, N, 0.8)
    boxes = boxes[:3]
    scores = torch.from_numpy(rng.choice(np.float32([-0.0, 0.0, -0.5]), (3, N)))
    scores[2] = -0.0
    scores[2, rng.choice(N, 5, replace=False)] = 0.0
    b, s = boxes.to(cuda), scores.to(cuda)
    got = _cuda_nms_topk(b, s, -1.0, k, 0.25)
    _assert_nms_bit_equal(got, _torch_nms_topk(b, s, -1.0, k, 0.25))
    plus = torch.nonzero(scores[2].view(torch.int32) == 0).flatten().tolist()
    assert got[2][2, :min(k, 5)].tolist() == plus[:k]  # the five +0 first


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


@pytest.mark.parametrize("B,H,W", [(2, 32, 48), (1, 208, 208), (3, 208, 208),
                                   (8, 208, 208)],
                         ids=["small", "b1", "b3", "full"])
def test_entry_block_bit_equal_to_plain(cuda, B, H, W):
    """K4 against ``_entry_rest`` on the card: every int8 equal, at a small
    non-square shape and at 208² with B = 1, 3 (169 and 507 tiles: not
    multiples of the 132 persistent blocks) and the main path's 8."""
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
                                {**ep, "w2_tc": ep["w2_tc"].cpu()}, 0.1)


def test_entry_block_runs_on_integer_tensor_cores(cuda):
    """The built entry_block kernel's SASS holds integer tensor-core MMAs
    (IMMA for mma.sync, IGMMA for wgmma), and a call is one kernel launch
    and nothing else on the card."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib

    _lib.lib()
    counts = _smoke().sass_count("entry_block_kernel")
    if counts is None:
        pytest.skip("the toolkit has no cuobjdump")
    assert counts["IMMA"] + counts["IGMMA"] > 0, counts
    ep, rng = _entry_bundle(cuda, 17)
    hq = torch.from_numpy(rng.integers(-127, 128, (2, 64, 64, 128), dtype=np.int8)).to(cuda)
    kernels, per_call, _ = _smoke().device_kernels(
        lambda: entry.fused_entry_block(hq, ep, 0.1), 3)
    assert per_call == 1 and kernels and all("entry_block" in k for k in kernels), kernels


def _stage_bundle(cuda, rng, C: int, n: int):
    """A random K5 bundle packed by ``pack_res_stage``: int8 weights, small
    scales, biases."""
    rs = {"w1": rng.integers(-127, 128, (n, C, C // 2), dtype=np.int8),
          "w3": rng.integers(-127, 128, (n, 9, C // 2, C), dtype=np.int8),
          "s1": rng.uniform(1e-5, 3e-5, (n, 1, C // 2)).astype(np.float32),
          "b1": rng.normal(0, 0.1, (n, 1, C // 2)).astype(np.float32),
          "s3": rng.uniform(1e-6, 3e-6, (n, 1, C)).astype(np.float32),
          "b3": rng.normal(0, 0.1, (n, 1, C)).astype(np.float32),
          "sx1": np.full((1, n), 40.0, np.float32), "sx3": np.full((1, n), 30.0, np.float32),
          "sx_out": np.float32(35.0)}
    pk = resstage.pack_res_stage({k: torch.from_numpy(np.asarray(v)) for k, v in rs.items()})
    return {k: v.to(cuda) for k, v in pk.items()}


@pytest.mark.parametrize("B,S,C,n", [(2, 13, 128, 2), (3, 26, 512, 2), (1, 5, 64, 3),
                                     (1, 26, 512, 8), (8, 26, 512, 8), (2, 13, 1024, 2)])
def test_res_stage_bit_equal_to_plain(cuda, B, S, C, n):
    """K5 against ``_res_stage_plain`` on the card: every int8 of ``yq`` and
    every bf16 of ``ybf`` equal, borders zero, with ±5 (→ ±127 after
    quantization) on border rows and columns."""
    rng = np.random.default_rng(8)
    pk = _stage_bundle(cuda, rng, C, n)
    x = torch.from_numpy(rng.normal(0, 1, (B, S, S, C)).astype(np.float32)).to(cuda)
    x[:, 0], x[:, :, -1] = 5.0, -5.0
    xf = resstage.res_stage_pre(x)
    launches = resstage.fused_res_stage.launches
    yq, ybf = resstage.fused_res_stage(xf, pk, S, n, 0.1)
    torch.cuda.synchronize()
    assert resstage.fused_res_stage.launches == launches + 1
    ref_q, ref_b = resstage._res_stage_plain(xf, pk, S, n, 0.1)
    assert torch.equal(yq, ref_q)
    assert torch.equal(ybf.view(torch.int16), ref_b.view(torch.int16))
    full = resstage.res_stage_post(yq, B, S)
    assert int(full[:, 0].abs().max()) == 0 and int(full[:, :, -1].abs().max()) == 0


def test_res_stage_s13_with_127_on_every_border(cuda):
    """S=13 (169 positions a map, not a multiple of a block's rows), C=512,
    n=8, with values quantizing to ±127 on all four border rows and
    columns: ``yq`` and ``ybf`` bit-equal to the plain version, borders 0,
    the input untouched; a call is 2n kernel launches and nothing else,
    each of them one of K5's two tensor-core convolutions."""
    rng = np.random.default_rng(10)
    pk = _stage_bundle(cuda, rng, 512, 8)
    x = torch.from_numpy(rng.normal(0, 1, (3, 13, 13, 512)).astype(np.float32)).to(cuda)
    sign = torch.from_numpy(rng.choice([-5.0, 5.0], (4, 3, 13, 512)).astype(np.float32)).to(cuda)
    x[:, 0], x[:, -1], x[:, :, 0], x[:, :, -1] = sign
    xf = resstage.res_stage_pre(x)
    kept = xf.clone()
    yq, ybf = resstage.fused_res_stage(xf, pk, 13, 8, 0.1)
    ref_q, ref_b = resstage._res_stage_plain(xf, pk, 13, 8, 0.1)
    assert torch.equal(yq, ref_q) and torch.equal(xf, kept)
    assert torch.equal(ybf.view(torch.int16), ref_b.view(torch.int16))
    assert int((ref_q == 127).sum()) > 0 and int((ref_q == -127).sum()) > 0
    for t in (yq, ybf.view(torch.int16)):
        full = resstage.res_stage_post(t, 3, 13)
        assert all(int(e.abs().max()) == 0 for e in (full[:, 0], full[:, -1], full[:, :, 0],
                                                     full[:, :, -1]))
    kernels, per_call, _ = _smoke().device_kernels(
        lambda: resstage.fused_res_stage(xf, pk, 13, 8, 0.1), 3)
    assert per_call == 16, per_call
    assert kernels and all("conv1x1_kernel" in k or "conv3x3_kernel" in k for k in kernels), kernels


def test_res_stage_and_tail_conv_run_on_integer_tensor_cores(cuda):
    """The built K5 and tail_conv kernels' SASS holds integer tensor-core
    MMAs (IMMA for mma.sync)."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib

    _lib.lib()
    for name in ("conv1x1_kernel", "conv3x3_kernel", "tail_conv_kernel"):
        counts = _smoke().sass_count(name)
        if counts is None:
            pytest.skip("the toolkit has no cuobjdump")
        assert counts["IMMA"] + counts["IGMMA"] > 0, (name, counts)


def test_res_stage_rejects_bad_bundles(cuda):
    pk = _stage_bundle(cuda, np.random.default_rng(9), 64, 2)
    x = torch.zeros((36 * 2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        resstage.fused_res_stage(x, pk, 4, 3, 0.1)  # n does not match
    with pytest.raises(ValueError):
        resstage.fused_res_stage(x[:70], pk, 4, 2, 0.1)  # not B·(S+2)² rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_g_probs", [True, False])
@pytest.mark.parametrize("shape,offset", [((21, 80, 80), 0), ((224, 80, 80), 0),
                                          ((896, 80, 80), 0), ((0, 80, 80), 0),
                                          ((5, 13, 17), 0), ((3, 1, 7), 0), ((4, 8, 17), 0),
                                          ((2, 100, 100), 0), ((6, 80, 80), 1)])
def test_softargmax_bwd_matches_plain(cuda, shape, offset, dtype, with_g_probs):
    """K2's backward against ``_torch_softargmax_bwd``: the row sum is taken
    in another order (1e-5 of the row's largest |dz|), bf16 also rounds the
    result (one bf16 ulp). At the training batch (224 rows, B=32) and at
    B=128 (896), at M = 0, on rows that are not a multiple of the vector
    (13×17, 1×7), on vectors that cross a map row (8×17), on rows longer
    than the block's registers (100×100), and on rows whose base is not on
    16 bytes (``offset`` elements into a buffer); one kernel launch a call,
    none at M = 0."""
    m = shape[0]
    rng = np.random.default_rng(10)
    z = torch.from_numpy(rng.normal(0, 3, shape).astype(np.float32)).to(cuda, dtype)
    _, probs = _torch_softargmax(z)
    g_pts = torch.from_numpy(rng.normal(0, 1, (m, 2)).astype(np.float32)).to(cuda)
    g_probs = (torch.from_numpy(rng.normal(0, 1e-2, shape).astype(np.float32))
               .to(cuda, dtype) if with_g_probs else None)
    if offset:  # the same values at a base `offset` elements past 16 bytes
        buf = torch.empty(probs.numel() + offset, dtype=dtype, device=cuda)
        buf[offset:] = probs.reshape(-1)
        probs = buf[offset:].view(shape)
    before = softargmax_bwd.launches
    got = softargmax_bwd(probs, g_pts, g_probs)
    ref = _torch_softargmax_bwd(probs, g_pts, g_probs)
    assert softargmax_bwd.launches == before + (1 if m else 0)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if m:
        rtol = 0.0 if dtype == torch.float32 else 2 ** -7
        d = (got.float() - ref.float()).abs()
        assert bool((d <= 1e-5 * ref.float().abs().max() + rtol * ref.float().abs()).all())


def test_softargmax_autograd_launches_both_kernels(cuda):
    z = torch.from_numpy(np.random.default_rng(11).normal(0, 3, (7, 80, 80))
                         .astype(np.float32)).to(cuda).requires_grad_(True)
    before = (fused_softargmax.launches, softargmax_bwd.launches)
    pts, _ = fused_softargmax(z)
    pts.sum().backward()
    assert (fused_softargmax.launches, softargmax_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = _torch_softargmax_bwd(_torch_softargmax(z.detach())[1],
                                torch.ones((7, 2), device=cuda))
    torch.testing.assert_close(z.grad, ref, atol=1e-8, rtol=1e-5)


def test_train_step_card_matches_cpu(cuda):
    """One f32 SGD train step of a narrow RektNet on the card and on the
    CPU: loss within 1e-5, every parameter update within 1e-3 of the
    largest update (ill-conditioned f32 gradient sums), running stats
    within 1e-4 of their scale."""
    from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet as rk
    from mit_driverless_cv_traininginfra_tpu_torch.train import optim, steps

    params, state = rk.init(torch.Generator().manual_seed(2), net_size=4)
    rng = np.random.default_rng(12)
    crops = rng.uniform(0, 1, (4, 80, 80, 3)).astype(np.float32)
    pts = rng.uniform(0.2, 0.8, (4, 7, 2)).astype(np.float32)
    out = []
    for dev in ("cpu", cuda):
        model = rk.KeypointNet(params, state).to(dev)
        opt = optim.make_optimizer(model.parameters(), "SGD", lr=0.01)
        total, _, _ = steps.rektnet_train_step(
            model, opt, torch.from_numpy(crops).to(dev), None,
            torch.from_numpy(pts).to(dev), include_geo=True,
            geo_loss_gamma_horz=0.05, geo_loss_gamma_vert=0.05,
            synth_target_sigma=1.0)
        out.append((float(total), {k: v.cpu() for k, v in model.state_dict().items()}))
    (l0, sd0), (l1, sd1) = out
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    p0 = rk.KeypointNet(params, state).state_dict()
    names = {n for n, _ in rk.KeypointNet(params, state).named_parameters()}
    scale = max(float((sd0[k] - p0[k]).abs().max()) for k in names)
    for k in names:
        assert float(((sd1[k] - p0[k]) - (sd0[k] - p0[k])).abs().max()) <= 1e-3 * scale, k
    for k in sd0:
        if k.endswith(("running_mean", "running_var")):
            assert float((sd1[k] - sd0[k]).abs().max()) <= 1e-4 * float(sd0[k].abs().max())


# ---------------------------------------------------------------------------
# the four probe kernels: tail_conv, window_resample, int8_contract,
# strided_map
# ---------------------------------------------------------------------------


def _probe_names():
    from mit_driverless_cv_traininginfra_tpu_torch.probes import PROBES

    return [p.name for p in PROBES] + ["P16x128"]


def _assert_same_bits(got, want):
    """Bit for bit, except that a NaN only has to be a NaN (the card's
    conversions and torch's write different NaN payloads)."""
    if not got.is_floating_point():
        assert torch.equal(got, want)
        return
    nan = got.isnan()
    assert torch.equal(nan, want.isnan())
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[got.dtype]
    assert torch.equal(got.view(ints)[~nan], want.view(ints)[~nan])


@pytest.mark.parametrize("name", _probe_names())
def test_probe_kernel_route_matches_plain(cuda, name):
    """Each probe of ``probes.PROBES`` (its CPU-test size) through the
    kernels against its plain route, under the probe's rule."""
    from mit_driverless_cv_traininginfra_tpu_torch.probes import BY_NAME
    from mit_driverless_cv_traininginfra_tpu_torch.probes.mosaic import DP4A
    from mit_driverless_cv_traininginfra_tpu_torch.probes.run import run_both

    probe = {**BY_NAME, DP4A.name: DP4A}[name]
    res = run_both(probe, probe.build(cuda, small=True))
    assert res.kernel_out.is_cuda and res.launches[probe.kernel] >= 1
    assert res.differing == 0, (res.differing, res.max_abs_err)


def test_tail_conv_on_int8_rektnet_res4(cuda):
    """``tail_conv`` on a quantized ``Int8RektNet``'s own ``res4.conv1``
    (net_size 8: 32 → 64 channels) equals ``relu(_qconv(h, conv1))`` value
    for value, h from its ``res[0..2]``."""
    import torch.nn.functional as F

    from mit_driverless_cv_traininginfra_tpu_torch.models import quantize
    from mit_driverless_cv_traininginfra_tpu_torch.ops.tail_conv import tail_conv

    rng = np.random.default_rng(13)
    rp, rs = convert.init_rektnet_np(rng, net_size=8)
    folded = rektnet.fold_bn(convert.from_jax(rp), convert.from_jax(rs))
    crops = rng.uniform(0, 1, (5, 80, 80, 3)).astype(np.float32)
    rq = quantize.quantize_rektnet_params(folded, quantize.calibrate_rektnet(folded, crops))
    rekt = quantize.Int8RektNet(rq).to(cuda).eval()
    with torch.inference_mode():
        h = F.relu(quantize._qconv(torch.from_numpy(crops).to(cuda), rekt.stem))
        for blk in rekt.res[:3]:
            h = blk(h)
        before = tail_conv.launches
        got = tail_conv(h, rekt.res[3].conv1)
        want = F.relu(quantize._qconv(h, rekt.res[3].conv1))
    torch.cuda.synchronize()
    assert tail_conv.launches == before + 1
    assert got.shape == want.shape == (5, 80, 80, 64)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        tail_conv(h, rekt.res[3].shortcut_conv)  # a 1×1 conv


@pytest.mark.parametrize("crops", [1, 63, 64, 512])
def test_tail_conv_edge_crop_counts(cuda, crops):
    """``tail_conv`` on the probe's draws at 1, 63, 64 (the served
    capacity) and 512 (the probe's size) crops — a grid smaller than the
    card, ragged, and many tiles a block — value-equal to its plain
    version, one kernel launch a call."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.tail_conv import tail_conv, tail_conv_plain
    from mit_driverless_cv_traininginfra_tpu_torch.probes import tail_conv1

    inp = tail_conv1.probe_inputs(crops, cuda)
    q = tail_conv1.qconv_from_probe(inp["wim"], inp["scale"], inp["bias"], inp["sx_inv"]).to(cuda)
    got = tail_conv(inp["h"], q)
    want = tail_conv_plain(inp["h"], q)
    torch.cuda.synchronize()
    assert got.shape == (crops, 80, 80, 128) and torch.equal(got, want)
    del want
    # 10 calls a profiled session: with 2, CUPTI recorded no device activity
    # at all in some sessions (the host's launch count was right)
    kernels, per_call, _ = _smoke().device_kernels(lambda: tail_conv(inp["h"], q), 10)
    assert per_call == 1 and kernels and all("tail_conv" in k for k in kernels), kernels


@pytest.mark.parametrize("K", [16, 32, 48, 64, 108])
@pytest.mark.parametrize("layout", ["rows", "transposed"])
def test_int8_contract_matches_plain(cuda, K, layout):
    """Strided int8 (M, K)·(K, N) → int32 bit for bit against the float64
    product, M and N not multiples of the 64×64 tile; with the scale
    epilogue, bf16 bit for bit."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.int8_contract import (
        int8_contract,
        int8_contract_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(K)
    M, N = 203, 77
    a = torch.randint(-127, 128, (M, K) if layout == "rows" else (K, M), generator=g,
                      device=cuda, dtype=torch.int8)
    a = a if layout == "rows" else a.t()
    b = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8).t()
    got = int8_contract(a, b)
    assert got.dtype == torch.int32 and torch.equal(got, int8_contract_plain(a, b))
    scale = torch.rand(N, generator=g, device=cuda) * 1e-3
    got = int8_contract(a, b, scale)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), int8_contract_plain(a, b, scale).view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32, torch.int32])
def test_strided_map_copies_bit_for_bit(cuda, dtype):
    from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import (
        strided_map,
        strided_map_plain,
    )

    x = torch.arange(5 * 37 * 19 * 6, device=cuda).reshape(5, 37, 19, 6).to(dtype)
    for view in (x[:, 1::3, :, 2:5], x.permute(2, 0, 3, 1),
                 x.reshape(5, -1)[:, 7:900:2], x.as_strided((4, 3, 19, 6), (0, 6, 37 * 6, 1))):
        got = strided_map(view)
        assert got.is_contiguous() and torch.equal(got, strided_map_plain(view))
    out = torch.zeros((37, 30), dtype=dtype, device=cuda)
    strided_map(x[0, :, :5, 0], out=out[:, 10:15])
    assert torch.equal(out[:, 10:15], x[0, :, :5, 0]) and not out[:, :10].any()


@pytest.mark.parametrize("op", ["scale", "quantize", "compare"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_strided_map_ops_with_nan_match_plain(cuda, op, dtype):
    """Maps bit for bit, a NaN, ±inf, halves and −0.0 among the inputs."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import (
        strided_map,
        strided_map_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn((6, 130), generator=g, device=cuda) * 0.6).to(dtype)
    x[0, :6] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                             0.5 / 127, -1.5 / 127], dtype=dtype)
    c = {"scale": 2.0, "quantize": 127.0, "compare": 1.0}[op]
    view = x.t()
    got, want = strided_map(view, op, c), strided_map_plain(view, op, c)
    assert got.dtype == want.dtype
    _assert_same_bits(got, want)


@pytest.mark.parametrize("shape", [(3, 12, 208, 208), (2, 97, 13), (5, 8192), (4, 3, 7, 11)])
def test_strided_map_sums_within_tolerance(cuda, shape):
    from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import (
        SUM_RTOL,
        strided_map,
    )

    g = torch.Generator(device=cuda).manual_seed(len(shape))
    x = torch.randint(-127, 127, shape, generator=g, device=cuda, dtype=torch.int8)
    for view in (x, x.transpose(-1, -2)):
        got = strided_map(view, "sum")
        flat = view.reshape(view.shape[0], -1).double()
        tol = SUM_RTOL * flat.abs().sum(1)
        assert got.shape == (view.shape[0],)
        assert bool(((got.double() - flat.sum(1)).abs() <= tol).all())


def _int8_view(cuda, g, shape, layout, offset):
    """A (rows, cols) int8 view ``offset`` bytes into a flat buffer: row-major
    ("rows") or column-major ("cols")."""
    r, c = shape
    flat = torch.randint(-127, 128, (offset + r * c + 16,), generator=g, device=cuda,
                         dtype=torch.int8)
    strides = (c, 1) if layout == "rows" else (1, r)
    return flat.as_strided(shape, strides, offset)


@pytest.mark.parametrize("N", [40, 77, 130])
@pytest.mark.parametrize("b_layout", ["n_major", "k_major"])
@pytest.mark.parametrize("a_layout", ["rows", "cols"])
@pytest.mark.parametrize("K", [4, 16, 32, 48, 64, 108, 200])
def test_int8_contract_every_k_and_layout(cuda, K, a_layout, b_layout, N):
    """int32 and the bf16 epilogue bit for bit at K ∈ {4, …, 200} (one and
    two K chunks, zero padding), A row- and column-major, B N- and K-major,
    M and N not tile multiples (64- and 128-column tiles)."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.int8_contract import (
        int8_contract,
        int8_contract_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(K * N)
    M = 203
    a = _int8_view(cuda, g, (M, K), a_layout, 0)
    b = _int8_view(cuda, g, (K, N), "rows" if b_layout == "n_major" else "cols", 0)
    assert torch.equal(int8_contract(a, b), int8_contract_plain(a, b))
    scale = torch.rand(N, generator=g, device=cuda) * 1e-3
    got = int8_contract(a, b, scale)
    assert torch.equal(got.view(torch.int16), int8_contract_plain(a, b, scale).view(torch.int16))


@pytest.mark.parametrize("offset", [1, 2, 3, 4, 5, 8, 12, 15])
def test_int8_contract_storage_offsets(cuda, offset):
    """Operands 1–15 bytes into their storage take the copy their alignment
    allows (4-byte words or bytes), bit for bit."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.int8_contract import (
        GATHER,
        ROW4,
        TRANS4,
        int8_contract,
        int8_contract_plain,
        staging_modes,
    )

    g = torch.Generator(device=cuda).manual_seed(offset)
    for K, a_layout in ((108, "rows"), (48, "cols"), (16, "rows")):
        # column-major A's k stride (its M) a multiple of 4 for the words
        a = _int8_view(cuda, g, (300 if a_layout == "cols" else 301, K), a_layout, offset)
        b = _int8_view(cuda, g, (K, 96), "rows", 15 - offset)
        aligned = offset % 4 == 0
        want_a = (ROW4 if a_layout == "rows" else TRANS4) if aligned else GATHER
        assert staging_modes(a, b)[0] == want_a
        assert torch.equal(int8_contract(a, b), int8_contract_plain(a, b)), (K, a_layout)


@pytest.mark.parametrize("K", [32, 64, 108])
def test_int8_contract_one_tensor_core_kernel_a_call(cuda, K):
    """P16's shape at 128× its rows (128 × 128 tiles, two blocks an SM),
    also at K = 32 and 64: int32 and bf16 bit for bit, one kernel a call,
    and the kernel's SASS holds integer tensor-core MMAs."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.int8_contract import (
        int8_contract,
        int8_contract_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(K)
    a = torch.randint(-127, 128, (16 * 128 * 208, K), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (K, 128), generator=g, device=cuda, dtype=torch.int8)
    assert torch.equal(int8_contract(a, b), int8_contract_plain(a, b))
    scale = torch.rand(128, generator=g, device=cuda) * 1e-3
    assert torch.equal(int8_contract(a, b, scale).view(torch.int16),
                       int8_contract_plain(a, b, scale).view(torch.int16))
    kernels, per_call, _ = _smoke().device_kernels(lambda: int8_contract(a, b), 10)
    assert per_call == 1 and kernels and all("int8_contract" in k for k in kernels), kernels
    counts = _smoke().sass_count("int8_contract_kernel")
    if counts is None:
        pytest.skip("the toolkit has no cuobjdump")
    assert counts["IMMA"] > 0, counts


_MAP_CASES = [("copy", torch.int8), ("copy", torch.bfloat16), ("copy", torch.float32),
              ("copy", torch.int32), ("scale", torch.bfloat16), ("scale", torch.float32),
              ("quantize", torch.bfloat16), ("quantize", torch.float32),
              ("compare", torch.bfloat16), ("compare", torch.float32), ("compare", torch.int8),
              ("compare", torch.int32)]


def _map_input(cuda, dtype, shape, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    if dtype in (torch.int8, torch.int32):
        return torch.randint(-127, 128, shape, generator=g, device=cuda).to(dtype)
    x = (torch.randn(shape, generator=g, device=cuda) * 0.7).to(dtype)
    x.view(-1)[:7] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                                   0.5 / 127, -1.5 / 127, 2.5 / 127], dtype=dtype)
    return x


@pytest.mark.parametrize("op,dtype", _MAP_CASES)
@pytest.mark.parametrize("path", ["rows", "transpose", "generic"])
def test_strided_map_each_path_op_and_dtype(cuda, path, op, dtype):
    """Each path × op × dtype at odd sizes, into a fresh output and into an
    output view with strides, bit for bit (a NaN only has to be a NaN);
    compare also into every output dtype; one kernel a call."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import (
        path_of,
        strided_map,
        strided_map_plain,
    )

    x = _map_input(cuda, dtype, (6, 97, 141), len(path) + len(op))
    view = {"rows": x[:, 1:, 3:], "transpose": x[:, 1:, 3:].transpose(1, 2),
            "generic": x[:, :, 1::2]}[path]
    c = {"scale": 2.0, "quantize": 127.0}.get(op, 1.0)
    assert path_of(view, op) == path
    _assert_same_bits(strided_map(view, op, c), strided_map_plain(view, op, c))
    out_dtypes = ([torch.float32, torch.bfloat16, torch.int8, torch.int32] if op == "compare"
                  else [strided_map_plain(view, op, c).dtype])
    for od in out_dtypes:
        big = torch.zeros(view.shape[:-1] + (view.shape[-1] + 7,), dtype=od, device=cuda)
        out = big[..., 5:5 + view.shape[-1]]
        assert path_of(view, op, out) == path
        strided_map(view, op, c, out=out, out_dtype=od)
        _assert_same_bits(out, strided_map_plain(view, op, c, out_dtype=od))
        assert not big[..., :5].any() and not big[..., 5 + view.shape[-1]:].any()
    kernels, per_call, _ = _smoke().device_kernels(lambda: strided_map(view, op, c), 10)
    assert per_call == 1 and kernels, (per_call, kernels)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset", [0, 1, 3, 7, 8, 15])
def test_strided_map_rows_with_unaligned_heads_and_tails(cuda, offset, dtype):
    """The rows path on views 0–15 elements into their storage, rows of
    odd lengths whose starts fall anywhere in the 16-byte grid, output rows
    with another alignment: copy and quantize bit for bit; and Q8's shape
    cut to 3 frames."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import (
        path_of,
        strided_map,
        strided_map_plain,
    )

    x = _map_input(cuda, dtype, (offset + 5 * 11 * 61 + 40,), offset)
    view = x[offset:offset + 5 * 11 * 61].view(5, 11, 61)[:, :, 2:59]
    ops = ["copy"] + (["quantize"] if dtype != torch.int8 else [])
    for op in ops:
        assert path_of(view, op) == "rows"
        _assert_same_bits(strided_map(view, op, 127.0), strided_map_plain(view, op, 127.0))
        out = torch.zeros((5, 11, 64), dtype=strided_map_plain(view, op, 127.0).dtype,
                          device=cuda)[:, :, 3 + offset % 4:60 + offset % 4]
        strided_map(view, op, 127.0, out=out)
        _assert_same_bits(out, strided_map_plain(view, op, 127.0))
    if dtype == torch.bfloat16 and offset == 0:
        q8 = torch.rand((3, 416, 1248), device=cuda).to(torch.bfloat16)
        assert torch.equal(strided_map(q8, "quantize", 127.0),
                           strided_map_plain(q8, "quantize", 127.0))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32, torch.int32])
@pytest.mark.parametrize("shape,perm", [((416, 1248), (1, 0)), ((64, 32, 208), (1, 2, 0)),
                                        ((16, 64, 208), (0, 2, 1)), ((9, 37, 41, 6), (2, 0, 3, 1)),
                                        ((33, 1, 2049), (2, 1, 0)), ((128, 208), (1, 0))])
def test_strided_map_transposes_bit_for_bit(cuda, shape, perm, dtype):
    """Transposed and permuted views (T15's, T14's, T1c's shapes, a 4-D
    permute with a dim of 6, a size-1 dim) copied through shared-memory
    tiles, ragged tile edges included; T1a's, under ``TILED_MIN``
    elements, one element a thread."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import TILED_MIN
    from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import (
        path_of,
        strided_map,
        strided_map_plain,
    )

    view = _map_input(cuda, dtype, shape, len(shape)).permute(*perm)
    assert path_of(view) == ("transpose" if view.numel() >= TILED_MIN else "generic")
    _assert_same_bits(strided_map(view), strided_map_plain(view))


def test_strided_map_windows_with_index_bases(cuda):
    """Per-program bases from three index arrays on the rows path (P20's
    kind of window) and on the generic path (a strided inner dim), bit for
    bit."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import (
        path_of,
        strided_map,
        strided_map_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(20)
    frames = torch.rand((6, 50, 90), generator=g, device=cuda).to(torch.bfloat16)
    i = lambda v: torch.tensor(v, dtype=torch.int32, device=cuda)  # noqa: E731
    index = [(i([5, 0, 3, 1]), 50 * 90), (i([0, 7, 19, 3]), 90), (i([1, 0, 33, 60]), 1)]
    for view in (frames.as_strided((4, 31, 29), (0, 90, 1)),
                 frames.as_strided((4, 31, 14), (0, 90, 2))):
        want = strided_map_plain(view, index=index)
        assert path_of(view, index=index) == ("rows" if view.stride(2) == 1 else "generic")
        assert torch.equal(strided_map(view, index=index).view(torch.int16),
                           want.view(torch.int16))


@pytest.mark.parametrize("ch", [1, 3, 4])
@pytest.mark.parametrize("base", [0, 1, 5])
def test_window_resample_matches_plain_at_the_edges(cuda, ch, base):
    """Columns at the window's first and last tap, between taps, outside
    it, ±inf and NaN, and a crop whose taps all lie outside: bit for bit.
    Rows of 90 lanes (none but the first on 16 bytes) of frames whose base
    lies ``base`` elements past 16 bytes, odd lane origins, 50 rows (not a
    multiple of a block's band), 20 columns of 1, 3 or 4 channels (the
    output rows' runs off 16 bytes but for 4)."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.window_resample import (
        window_resample,
        window_resample_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(5)
    buf = torch.rand((3 * 120 * 90 + base,), generator=g, device=cuda).to(torch.bfloat16)
    frames = buf[base:].view(3, 120, 90)
    win_w = 20 if ch < 4 else 15
    fidx = torch.tensor([2, 0, 1, 2, 1], device=cuda)
    r0 = torch.tensor([0, 17, 40, 33, 70], device=cuda)
    l0 = torch.tensor([0, 3, 11, 90 - win_w * ch, 7], device=cuda)
    sx = torch.rand((5, 20), generator=g, device=cuda) * (win_w + 4) - 2
    sx[0, :8] = torch.tensor([0.0, win_w - 1.0, win_w - 0.5, -0.5, -3.0, float("nan"),
                              float("inf"), -float("inf")])
    sx[4] = -5.0  # no tap in the window
    got = window_resample(frames, fidx, r0, l0, sx, rows=50, win_w=win_w, ch=ch)
    want = window_resample_plain(frames, fidx, r0, l0, sx, rows=50, win_w=win_w, ch=ch)
    assert got.shape == (5, 50, 20 * ch)
    _assert_same_bits(got, want)


def test_window_resample_bit_for_bit_at_p22(cuda):
    """P22's 512 crops of 80 rows × 240 lanes from the probe's own draws,
    bit for bit, one wrapper launch a call."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.window_resample import (
        window_resample,
        window_resample_plain,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.probes.crop import crop_kernel_arrays

    d = crop_kernel_arrays(cuda)
    args = (d["frames"], d["fidx2"], d["r02"], d["l02"], d["sx2"], 80, 256, 3)
    before = window_resample.launches
    got = window_resample(*args)
    assert window_resample.launches == before + 1
    _assert_same_bits(got, window_resample_plain(*args))


def test_window_resample_wide_window_bit_for_bit(cuda):
    """A 3000-column window, whose staged band rows need more than the 48
    KB of shared memory a launch gets unasked: bit for bit."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.window_resample import (
        window_resample,
        window_resample_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(8)
    frames = torch.rand((2, 12, 3100), generator=g, device=cuda).to(torch.bfloat16)
    fidx, r0 = torch.tensor([1, 0], device=cuda), torch.tensor([2, 0], device=cuda)
    l0 = torch.tensor([33, 100], device=cuda)
    sx = torch.rand((2, 70), generator=g, device=cuda) * 3000
    got = window_resample(frames, fidx, r0, l0, sx, rows=10, win_w=3000, ch=1)
    _assert_same_bits(got, window_resample_plain(frames, fidx, r0, l0, sx, rows=10,
                                                 win_w=3000, ch=1))


# Each script first runs its kernel on windows inside the input, then on
# one window past its end, which must trap (it poisons the CUDA context,
# hence a process of its own).
_OUTSIDE = {
    "window_resample": """
from mit_driverless_cv_traininginfra_tpu_torch.ops.window_resample import window_resample
frames = torch.zeros((2, 30, 24), dtype=torch.bfloat16, device="cuda")
sx = torch.zeros((2, 4), device="cuda")
def run(r):
    window_resample(frames, i([0, 1]), i([0, r]), i([0, 6]), sx, rows=20, win_w=6, ch=3)
""",
    "strided_map": """
from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import strided_map
x = torch.arange(40, dtype=torch.float32, device="cuda").reshape(4, 10)
def run(r):
    strided_map(x.as_strided((2, 2, 5), (0, 10, 1)), index=[(i([0, r]), 10)])
""",
}


@pytest.mark.parametrize("kernel", sorted(_OUTSIDE))
def test_a_window_outside_the_input_traps(cuda, kernel):
    """A per-program base past the input's end makes the kernel trap, not
    read out of bounds (the plain version raises IndexError)."""
    script = ("import torch\n"
              "i = lambda v: torch.tensor(v, dtype=torch.int32, device='cuda')\n"
              + _OUTSIDE[kernel] +
              "run(2 if %r == 'strided_map' else 10)\n"
              "torch.cuda.synchronize()\n"
              "print('inside ok', flush=True)\n"
              "run(3 if %r == 'strided_map' else 11)\n"
              "torch.cuda.synchronize()\n"
              "print('outside read', flush=True)\n" % (kernel, kernel))
    p = subprocess.run([sys.executable, "-c", script], cwd=Path(__file__).resolve().parents[1],
                       capture_output=True, text=True, timeout=300)
    assert "inside ok" in p.stdout, p.stderr[-2000:]
    assert "outside read" not in p.stdout and p.returncode != 0
