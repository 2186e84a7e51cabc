#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Drives the port's main paths — the two-stage detect→crop→keypoints serving
path at the full width of YOLOv3-416 and RektNet, in bf16/f32 and in its
int8 configuration, on seeded random weights — and checks its hand-written
CUDA kernels:

1. device: requires CUDA (no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles ``csrc/*.cu`` with nvcc and prints the seconds;
3. kernels: K1 (ROI crop), K2 (soft-argmax) and K3 (threshold + top-k +
   NMS) against their plain PyTorch versions on the card, at the shapes
   the main path gives them, in f32 and bf16, with CUDA-event timings;
4. bf16 slice: the f32 pipeline on the card against the same port on CPU
   copies (plain path), then a bf16 ``TwoStageServer`` that warms up and
   answers requests — one of them a short batch that pads — while K1-K3's
   launch counters must grow;
5. int8: the int8 models are calibrated and quantized on the card; K4
   (fused entry block) against its plain version at the main path's
   (8, 208, 208, 128), bit for bit, with its registers and timings; the
   int8 pipeline on the card against CPU copies (K4's output bit-equal,
   masks equal); then an int8 ``TwoStageServer`` whose K1-K4 launch
   counters must all grow, with frames/s beside the bf16 server's.

Prints one JSON line of per-kernel results before the last line, which is
``{"ok": true, "device": {...}}``; each row's ``launches`` is counted over
the int8 server's requests. Any failure raises: exit code ≠ 0 and no
result line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_ROWS = {  # name → (source, TPU kernel it replaces)
    "roi_crop": ("mit_driverless_cv_traininginfra_tpu_torch/csrc/roi_crop.cu",
                 "mit_driverless_cv_traininginfra_tpu/ops/pallas_crop.py:173"),
    "softargmax": ("mit_driverless_cv_traininginfra_tpu_torch/csrc/softargmax.cu",
                   "mit_driverless_cv_traininginfra_tpu/ops/pallas_kernels.py:68"),
    "nms_topk": ("mit_driverless_cv_traininginfra_tpu_torch/csrc/nms_topk.cu",
                 "mit_driverless_cv_traininginfra_tpu/ops/pallas_kernels.py:209"),
    "entry_block": ("mit_driverless_cv_traininginfra_tpu_torch/csrc/entry_block.cu",
                    "mit_driverless_cv_traininginfra_tpu/ops/pallas_entry.py:337"),
}
B_SERVE, SIZE, MAX_DET = 8, 416, 16
CROP_N = 64                  # crops per kernel check: a served capacity at B=8
PTS_ATOL = {torch.float32: 1e-6, torch.bfloat16: 2e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters: int = 50, warm: int = 5) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls,
    timed with CUDA events after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two runs in the order
    plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# phase 1-2: device and build
# ---------------------------------------------------------------------------


def phase_device() -> str:
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {smi}")
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    _lib.lib()
    info = _lib.build_info
    log(f"build: {'compiled' if info.built else 'cached'} {info.path.name} "
        f"nvcc {info.seconds:.2f} s, load {time.perf_counter() - t0:.2f} s")
    for line in info.log.splitlines():
        if "Used" in line or "spill" in line:
            log(f"build: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version on the card
# ---------------------------------------------------------------------------


def crop_boxes(rng, n: int) -> np.ndarray:
    """n xyxy boxes in a SIZE² frame: edge-touching ones first, the last one
    non-finite (an overflowed decode)."""
    x0 = rng.uniform(0, SIZE - 40, n)
    y0 = rng.uniform(0, SIZE - 40, n)
    boxes = np.stack([x0, y0, np.minimum(x0 + rng.uniform(4, 300, n), SIZE),
                      np.minimum(y0 + rng.uniform(4, 300, n), SIZE)], 1)
    boxes[:6] = [[0, 0, 60, 90], [SIZE - 50, 0, SIZE, 40],
                 [0, SIZE - 70, 30, SIZE], [SIZE - 20, SIZE - 20, SIZE, SIZE],
                 [0, 0, SIZE, SIZE], [-10, -10, SIZE + 10, SIZE + 10]]
    boxes[-1] = [-np.inf, 12.0, np.inf, np.nan]
    return boxes.astype(np.float32)


def phase_k1(dev, rows: dict) -> None:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_crop import roi_crop
    from mit_driverless_cv_traininginfra_tpu_torch.ops.image import (
        roi_crop_bilinear_indexed,
    )

    rng = np.random.default_rng(1)
    frames32 = torch.from_numpy(rng.uniform(0, 1, (B_SERVE, SIZE, SIZE, 3))
                                .astype(np.float32)).to(dev)
    boxes = torch.from_numpy(crop_boxes(rng, CROP_N)).to(dev)
    fidx = torch.from_numpy(rng.integers(0, B_SERVE, CROP_N)).to(dev)
    finite = torch.isfinite(boxes).all(dim=1)
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        frames = frames32.to(dt)
        got = roi_crop(frames, boxes, fidx)
        ref = roi_crop_bilinear_indexed(frames, boxes, fidx)
        torch.cuda.synchronize()  # a fault of the non-finite box shows here
        err = max_abs(got[finite], ref[finite])
        n_diff = int((got[finite] != ref[finite]).sum())
        k_ms, p_ms = paired_ms(lambda: roi_crop(frames, boxes, fidx),
                               lambda: roi_crop_bilinear_indexed(frames, boxes, fidx))
        log(f"K1 roi_crop {str(dt)[6:]}: N={CROP_N} max|d|={err!r} "
            f"differing={n_diff}/{got[finite].numel()} kernel {k_ms!r} ms "
            f"plain {p_ms!r} ms")
        # bf16: the tap products are exact in f32, so both versions round
        # the same sums; f32: the plain GEMM may add the two taps in
        # another order (≤ 1 ulp of a [0, 1] pixel)
        check(err <= (0.0 if dt == torch.bfloat16 else 2 ** -23),
              f"K1 {dt} disagrees: {err}")
        errs.append(err)
        if dt == torch.bfloat16:
            rows["roi_crop"].update(ms=k_ms, plain_ms=p_ms)
    rows["roi_crop"]["max_abs_err"] = max(errs)


def phase_k2(dev, rows: dict) -> None:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
        _torch_softargmax,
        fused_softargmax,
    )

    rng = np.random.default_rng(2)
    m = 7 * CROP_N
    z32 = torch.from_numpy(rng.normal(0, 3, (m, 80, 80)).astype(np.float32)).to(dev)
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        z = z32.to(dt)
        pts, probs = fused_softargmax(z)
        pts_r, probs_r = _torch_softargmax(z)
        e_pts = max_abs(pts, pts_r)
        e_pr = max_abs(probs, probs_r)
        # probs: f32 within 1e-6; bf16 also within one bf16 ulp (2^-8
        # relative), where an f32 difference crosses a rounding boundary
        pr_ok = torch.allclose(probs.float(), probs_r.float(), atol=1e-6,
                               rtol=0.0 if dt == torch.float32 else 2 ** -8)
        k_ms, p_ms = paired_ms(lambda: fused_softargmax(z),
                               lambda: _torch_softargmax(z))
        log(f"K2 softargmax {str(dt)[6:]}: M={m} max|d pts|={e_pts!r} "
            f"max|d probs|={e_pr!r} kernel {k_ms!r} ms plain {p_ms!r} ms")
        check(e_pts <= PTS_ATOL[dt] and pr_ok, f"K2 {dt} disagrees")
        errs.append(e_pts)
        if dt == torch.bfloat16:
            rows["softargmax"].update(ms=k_ms, plain_ms=p_ms)
    rows["softargmax"]["max_abs_err"] = max(errs)


def nms_inputs(rng, B: int, N: int, conf: float):
    """Scores and boxes for B frames of N candidates: frame 1 has fewer than
    k above conf, frame 2 exact score ties, frame 3 none above conf, frame
    4 non-finite corners; boxes cluster so suppression happens."""
    centers = rng.uniform(20, SIZE - 20, (B, N // 8 + 1, 2))
    c = np.repeat(centers, 8, axis=1)[:, :N] + rng.normal(0, 4, (B, N, 2))
    wh = rng.uniform(8, 80, (B, N, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (B, N)).astype(np.float32)
    scores[1] = np.where(np.arange(N) % 2000 == 7, 0.95, 0.3)     # 6 > conf
    scores[2, rng.choice(N, 40, replace=False)] = 0.97            # ties
    scores[3] = np.minimum(scores[3], conf)                       # none
    boxes[4, :: 3, 2] = np.inf
    boxes[4, :: 5, 0] = -np.inf
    return torch.from_numpy(boxes), torch.from_numpy(scores)


def phase_k3(dev, rows: dict) -> None:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
        _cuda_nms_topk,
        _torch_nms_topk,
        nms_topk,
    )

    N = 3 * (13 * 13 + 26 * 26 + 52 * 52)  # 10647 candidates at 416²
    conf, ovl = 0.8, 0.25
    boxes, scores = nms_inputs(np.random.default_rng(3), B_SERVE, N, conf)
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        b, s = boxes.to(dev, dt), scores.to(dev, dt)
        got = nms_topk(b, s, conf, MAX_DET, ovl)
        _, _, idx, _ = _cuda_nms_topk(b, s, conf, MAX_DET, ovl)
        ref_b, ref_s, ref_i, ref_k = _torch_nms_topk(b, s, conf, MAX_DET, ovl)
        same = (torch.equal(got[2], ref_k) and torch.equal(idx.long(), ref_i)
                and torch.equal(got[1], ref_s)
                and bool(((got[0] == ref_b) | (got[0].isnan() & ref_b.isnan())).all()))
        fin = torch.isfinite(ref_b)
        err = max(max_abs(got[0][fin], ref_b[fin]),
                  max_abs(got[1][torch.isfinite(ref_s)], ref_s[torch.isfinite(ref_s)]))
        k_ms, p_ms = paired_ms(lambda: nms_topk(b, s, conf, MAX_DET, ovl),
                               lambda: _torch_nms_topk(b, s, conf, MAX_DET, ovl))
        log(f"K3 nms_topk {str(dt)[6:]} inputs: B={B_SERVE} N={N} k={MAX_DET} "
            f"slots_equal={same} kept/frame={ref_k.sum(1).tolist()} "
            f"kernel {k_ms!r} ms plain {p_ms!r} ms")
        check(same, f"K3 {dt}: slots differ from the plain version")
        errs.append(err)
        if dt == torch.float32:
            rows["nms_topk"].update(ms=k_ms, plain_ms=p_ms)
    rows["nms_topk"]["max_abs_err"] = max(errs)


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


def seeded_folded(dev):
    """The seeded YOLOv3-416 (heads sliced to one class) and RektNet-16,
    BN folded, f32 on ``dev``: ``(spec, darknet folded, rektnet folded)``."""
    from mit_driverless_cv_traininginfra_tpu.config.flagship import flagship_spec
    from mit_driverless_cv_traininginfra_tpu_torch import convert
    from mit_driverless_cv_traininginfra_tpu_torch.models import (
        darknet,
        rektnet,
        stem_opt,
    )

    spec = flagship_spec(SIZE)
    rng = np.random.default_rng(0)
    yp, ys = convert.init_darknet_np(spec, rng)
    rp, rs = convert.init_rektnet_np(rng)
    folded = darknet.fold_bn(convert.from_jax(yp, dev), convert.from_jax(ys, dev),
                             spec)
    spec1, folded1 = stem_opt.slice_preyolo(spec, folded)
    return spec1, folded1, rektnet.fold_bn(convert.from_jax(rp, dev),
                                           convert.from_jax(rs, dev))


def build_models(dev, dtype):
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, rektnet

    spec1, folded1, rfolded = seeded_folded(dev)
    yolo = darknet.Darknet(spec1, folded1).to(dtype=dtype)
    rekt = rektnet.RektNet(rfolded).to(dtype=dtype)
    return yolo.eval(), rekt.eval()


def pick_conf_thresh(dets, max_det: int) -> float:
    """bench.py's operating point: 0.8 if it fires 1..5·max_det candidates
    per frame, else the threshold giving ~12 per frame — then moved to the
    middle of the gap between the two neighbouring confidences, so an
    f32 rounding difference cannot flip a candidate across it."""
    conf = dets[..., 4].float().cpu().numpy()
    if 1.0 <= (conf > 0.8).sum(axis=1).mean() <= 5 * max_det:
        thresh = 0.8
    else:
        thresh = float(np.quantile(conf, 1.0 - 12 / conf.shape[1]))
        thresh = min(max(thresh, 0.05), 0.95)
    flat = np.sort(conf.ravel())
    i = int(np.searchsorted(flat, thresh))
    lo, hi = flat[max(i - 1, 0)], flat[min(i, flat.size - 1)]
    return float((lo + hi) / 2) if lo < hi else thresh


def phase_slice_f32(dev, frames_np):
    from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
        two_stage_pipeline,
    )

    yolo, rekt = build_models(dev, torch.float32)
    frames = torch.from_numpy(frames_np).to(dev)
    with torch.inference_mode():
        thresh = pick_conf_thresh(yolo.detections(frames, with_classes=False),
                                  MAX_DET)
    kw = dict(conf_thresh=thresh, max_det=MAX_DET, crop_capacity=16)
    out = two_stage_pipeline(yolo, rekt, frames[:2], **kw)
    yolo_c, rekt_c = yolo.to("cpu"), rekt.to("cpu")
    ref = two_stage_pipeline(yolo_c, rekt_c, frames[:2].cpu(), **kw)
    mask_eq = torch.equal(out.mask.cpu(), ref.mask)
    m = ref.mask
    pairs = {"box": (out.boxes.cpu()[m], ref.boxes[m]),
             "kpt": (out.keypoints.cpu()[m], ref.keypoints[m]),
             "score": (out.scores.cpu()[m], ref.scores[m])}
    errs = {k: (max_abs(a, b), float(((a - b).abs() / b.abs().clamp(min=1.0)).max()))
            for k, (a, b) in pairs.items()}
    log(f"slice f32 card vs CPU plain (B=2, capacity 16): conf_thresh "
        f"{thresh!r} detections {int(m.sum())} masks_equal={mask_eq} "
        f"(max abs, max rel) {errs}")
    check(mask_eq, "f32 slice: detection masks differ between card and CPU")
    check(int(m.sum()) > 0, "f32 slice: no detection reached the keypoints")
    # 75 f32 convolutions summed in other orders (cuDNN vs oneDNN) differ
    # by ~1e-6 relative; the exp() of the box decode and the crop resample
    # carry that into pixel coordinates, relative to the box size.
    check(all(torch.allclose(a, b, rtol=1e-4, atol=1e-2)
              for a, b in pairs.values()),
          "f32 slice: boxes / keypoints / scores beyond rtol 1e-4, atol 1e-2")
    return thresh


def kernel_wrappers() -> dict:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_crop import roi_crop
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
        fused_softargmax,
        nms_topk,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.ops.entry import (
        fused_entry_block,
    )

    return {"roi_crop": roi_crop, "softargmax": fused_softargmax,
            "nms_topk": nms_topk, "entry_block": fused_entry_block}


def serve(label: str, yolo, rekt, frames, thresh, smi, n_full: int = 63):
    """A ``TwoStageServer`` at B=8 that warms buckets of 16 up to 112 (<
    B·max_det = 128, so every bucket runs the compacted path), then answers
    a short batch of 6 that pads and ``n_full`` full batches. Every kernel
    counter is set to 0 just before the requests and read just after.
    Returns ``(launches, frames/s)``."""
    from mit_driverless_cv_traininginfra_tpu_torch import _shared
    from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import (
        TwoStageServer,
    )

    policy = _shared.capacity().AdaptiveCapacity(floor=64, quantum=16,
                                                 warmup_capacity=96)
    server = TwoStageServer(yolo, rekt, conf_thresh=thresh, max_det=MAX_DET,
                            policy=policy)
    server.warmup([B_SERVE], capacities=[64, 80, 96, 112])
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [server(frames[:6])]
    outs += [server(frames) for _ in range(n_full)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    n_frames = 6 + n_full * B_SERVE
    check(outs[0].mask.shape[0] == 6, "short batch was not sliced back")
    kept = 0
    for o in outs:
        m = o.mask
        kept += int(m.sum())
        check(bool(torch.isfinite(o.boxes[m]).all()
                   and torch.isfinite(o.keypoints[m]).all()),
              f"{label} serve: non-finite output on a kept slot")
    stats = server.stats()
    fps = n_frames / wall
    log(f"serve {label} stats: {json.dumps(stats, default=str)}")
    log(f"serve {label}: {len(outs)} requests, {n_frames} frames in {wall!r} s "
        f"= {fps!r} frames/s, kept detections {kept}, "
        f"launches {launches} on {smi}")
    check(kept > 0, f"{label} serve: no detection kept")
    check(stats["batch_pads"] >= 1, f"{label} serve: the short batch did not pad")
    return launches, fps


def phase_serve_bf16(dev, frames_np, thresh, smi):
    torch.backends.cudnn.benchmark = True
    yolo, rekt = build_models(dev, torch.bfloat16)
    yolo.to(memory_format=torch.channels_last)
    rekt.to(memory_format=torch.channels_last)
    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    launches, fps = serve("bf16", yolo, rekt, frames, thresh, smi)
    path = ("roi_crop", "softargmax", "nms_topk")
    check(all(launches[k] > 0 for k in path),
          f"a kernel of the bf16 path never launched while serving: {launches}")
    check(launches["entry_block"] == 0, "the bf16 path launched K4")
    return fps


# ---------------------------------------------------------------------------
# phase 5: int8
# ---------------------------------------------------------------------------

SLOPE = 0.1  # YOLOv3's leaky slope (flagship_spec)


def quantize_on_card(dev, frames_np):
    """Calibrate and quantize the seeded models as bench.py does: the f32
    folded Darknet on the 8 frames, RektNet on 32 synthetic cone crops.
    Returns ``(spec, yolo_q, entry_q, rekt_q)``, tensors on ``dev``."""
    from mit_driverless_cv_traininginfra_tpu_torch import _shared
    from mit_driverless_cv_traininginfra_tpu_torch.models import quantize
    from mit_driverless_cv_traininginfra_tpu_torch.ops import entry

    spec1, folded1, rfolded = seeded_folded(dev)
    check(entry.entry_block_applicable(spec1), "YOLOv3-416 takes no fused entry")
    amax = quantize.calibrate(spec1, folded1, torch.from_numpy(frames_np).to(dev))
    crops, _ = _shared.synthetic().rektnet_batch(np.random.default_rng(3), 32)
    ramax = quantize.calibrate_rektnet(rfolded, np.asarray(crops, np.float32))
    return (spec1, quantize.quantize_params(spec1, folded1, amax),
            entry.quantize_entry(folded1, amax),
            quantize.quantize_rektnet_params(rfolded, ramax))


def tree_to(tree, dev):
    if torch.is_tensor(tree):
        return tree.to(dev)
    return {k: tree_to(v, dev) for k, v in tree.items()}


def int8_models(bundles, dev):
    from mit_driverless_cv_traininginfra_tpu_torch.models import quantize

    spec1, yolo_q, entry_q, rekt_q = bundles
    yolo = quantize.Int8Darknet(spec1, yolo_q, entry_q).to(dev)
    return yolo.eval(), quantize.Int8RektNet(rekt_q).to(dev).eval()


def ptxas_lines(kernel: str) -> list[str]:
    """nvcc's register / spill lines (-Xptxas -v) of one kernel."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib

    out, current = [], ""
    for line in _lib.build_info.log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?$",
                      line.strip())
        if m:
            current = m.group(1)
        elif kernel in current and ("Used" in line or "spill" in line):
            out.append(line.strip())
    return out


def phase_k4(dev, rows: dict, entry_q, frames_np) -> None:
    """K4 against its plain version at the main path's shape, both on the
    bundle as a model packs it; the times are the wrappers' calls."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops import entry

    ep = entry.pack_entry(entry_q)
    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    hq = entry.conv1_4x4_q8(frames, ep, SLOPE)
    check(tuple(hq.shape) == (B_SERVE, SIZE // 2, SIZE // 2, 128), f"hq {hq.shape}")
    got = entry.fused_entry_block(hq, ep, SLOPE)
    ref = entry._entry_rest(hq, ep, SLOPE)
    torch.cuda.synchronize()
    n_diff = int((got != ref).sum())
    # extreme values on every border row and column: the conv2p pad (top
    # and left) and the 3×3's zeros outside the frame
    rng = np.random.default_rng(4)
    edge = hq.clone()
    sign = torch.from_numpy(rng.choice([-127, 127], (4, B_SERVE, SIZE // 2, 128))
                            .astype(np.int8)).to(dev)
    edge[:, 0], edge[:, -1], edge[:, :, 0], edge[:, :, -1] = sign
    got_e = entry.fused_entry_block(edge, ep, SLOPE)
    ref_e = entry._entry_rest(edge, ep, SLOPE)
    torch.cuda.synchronize()
    n_diff_e = int((got_e != ref_e).sum())
    k_ms, p_ms = paired_ms(lambda: entry.fused_entry_block(hq, ep, SLOPE),
                           lambda: entry._entry_rest(hq, ep, SLOPE))
    for line in ptxas_lines("entry_block"):
        log(f"K4 ptxas: {line}")
    log(f"K4 entry_block int8: hq {tuple(hq.shape)} → {tuple(got.shape)} "
        f"differing={n_diff}/{got.numel()} (edges ±127: {n_diff_e}) "
        f"kernel {k_ms!r} ms plain {p_ms!r} ms")
    check(n_diff == 0 and n_diff_e == 0, "K4 differs from its plain version")
    rows["entry_block"].update(ms=k_ms, plain_ms=p_ms,
                               max_abs_err=max(max_abs(got, ref), max_abs(got_e, ref_e)))


def phase_slice_int8(dev, frames_np, bundles):
    """The int8 pipeline on the card against the same port on CPU copies
    at B=2: K4's output bit-equal, masks equal at a gap-centred threshold,
    boxes, scores and keypoints within stated bounds. Returns the card
    models and the threshold."""
    from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
        two_stage_pipeline_int8,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.ops import entry

    yolo, rekt = int8_models(bundles, dev)
    cpu = (bundles[0], *(tree_to(b, "cpu") for b in bundles[1:]))
    yolo_c, rekt_c = int8_models(cpu, "cpu")
    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    with torch.inference_mode():
        thresh = pick_conf_thresh(yolo.detections(frames, with_classes=False),
                                  MAX_DET)
        resq = entry.entry_forward_int8(yolo.entry.as_dict(), frames[:2], SLOPE)
        resq_c = entry.entry_forward_int8(yolo_c.entry.as_dict(),
                                          frames[:2].cpu(), SLOPE)
    resq_eq = torch.equal(resq.cpu(), resq_c)
    kw = dict(conf_thresh=thresh, max_det=MAX_DET, crop_capacity=16)
    out = two_stage_pipeline_int8(yolo, rekt, frames[:2], **kw)
    t0 = time.perf_counter()
    ref = two_stage_pipeline_int8(yolo_c, rekt_c, frames[:2].cpu(), **kw)
    cpu_s = time.perf_counter() - t0
    mask_eq = torch.equal(out.mask.cpu(), ref.mask)
    m = ref.mask
    rbox = ref.boxes[m]
    size = (rbox[:, 2:] - rbox[:, :2]).amax(dim=1).clamp(min=1.0)

    def per_size(a, b):  # max |Δ| of each detection over its box size
        d = (a - b).abs().reshape(len(size), -1).amax(dim=1)
        return float((d / size).max()) if len(size) else 0.0

    box_err = per_size(out.boxes.cpu()[m], rbox)
    kpt_err = per_size(out.keypoints.cpu()[m], ref.keypoints[m])
    score_err = max_abs(out.scores.cpu()[m], ref.scores[m])
    log(f"slice int8 card vs CPU (B=2, capacity 16): conf_thresh {thresh!r} "
        f"detections {int(m.sum())} resq_equal={resq_eq} masks_equal={mask_eq} "
        f"max |d|/box size: boxes {box_err!r} keypoints {kpt_err!r}; "
        f"scores max |d| {score_err!r} (CPU run {cpu_s:.1f} s)")
    check(resq_eq, "int8 slice: K4's output differs between card and CPU")
    check(mask_eq, "int8 slice: detection masks differ between card and CPU")
    check(int(m.sum()) > 0, "int8 slice: no detection reached the keypoints")
    # the integer path and the f64-summed head are exact on both devices;
    # what differs is f32 exp/sigmoid in the decode (ulps), the f32 RektNet
    # head (summation order) and, through the box, the crop's samples
    check(box_err <= 1e-4 and score_err <= 1e-5 and kpt_err <= 1e-3,
          "int8 slice: boxes / scores / keypoints beyond their bounds")
    return yolo, rekt, thresh


def phase_serve_int8(yolo, rekt, frames_np, thresh, smi):
    frames = torch.from_numpy(frames_np).to(yolo.device, torch.bfloat16)
    launches, fps = serve("int8", yolo, rekt, frames, thresh, smi)
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the int8 path never launched while serving: {launches}")
    return launches, fps


def main() -> int:
    # the port first: without the repository around it, fail before any output
    from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device

    smi = phase_device()
    dev = resolve_device("cuda:0")
    # every f32 comparison below (kernel phases, the f32 slice) runs in
    # full f32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    rows = {name: {"name": name, "route": "cuda", "source": src,
                   "replaces": rep} for name, (src, rep) in KERNEL_ROWS.items()}
    phase_k1(dev, rows)
    phase_k2(dev, rows)
    phase_k3(dev, rows)

    from mit_driverless_cv_traininginfra_tpu_torch import _shared

    frames_np, _ = _shared.synthetic().yolo_batch(np.random.default_rng(42),
                                                  B_SERVE, SIZE)
    thresh = phase_slice_f32(dev, frames_np)
    fps_bf16 = phase_serve_bf16(dev, frames_np, thresh, smi)
    bundles = quantize_on_card(dev, frames_np)
    phase_k4(dev, rows, bundles[2], frames_np)
    yolo_q, rekt_q, thresh_q = phase_slice_int8(dev, frames_np, bundles)
    launches, fps_int8 = phase_serve_int8(yolo_q, rekt_q, frames_np, thresh_q, smi)
    log(f"served frames/s at B={B_SERVE}: int8 {fps_int8!r}, bf16 {fps_bf16!r}, "
        f"int8/bf16 {fps_int8 / fps_bf16!r} on {smi}")
    for name, row in rows.items():
        row["launches"] = launches[name]
    check("jax" not in sys.modules, "jax was imported")
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
