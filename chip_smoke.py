#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Drives the port's main paths — the two-stage detect→crop→keypoints serving
path at the full width of YOLOv3-416 and RektNet, in bf16/f32 and in its
int8 configuration; the int8 residual stage (K5) on the int8 forward's
26² activations; the Pallas probes of the repository's ``tools/`` on four
kernels, at the probes' sizes; RektNet training at full width (net_size
16, 80×80, 7 keypoints, B=32) — on seeded random weights, and checks its
hand-written CUDA kernels:

1. device: requires CUDA (no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles ``csrc/*.cu`` with nvcc and prints the seconds;
3. kernels: K1 (ROI crop), K2 (soft-argmax) and K3 (threshold + top-k +
   NMS) against their plain PyTorch versions on the card, at the shapes
   the main path gives them, in f32 and bf16, with CUDA-event timings,
   one device kernel a call and its device time (``torch.profiler``); K2
   at 448 and 784 rows (capacity 64 and 112), K3 at B=8 and B=1, and at
   conf −1 on scores of ±0 (+0 ranks above −0, as lax.top_k ranks it); K1
   also: the plain crop's coordinates on the card bit-equal to the CPU's,
   its bf16 crops bit-equal to the plain crop on the CPU, and the host
   microseconds of a call;
4. bf16 slice: the f32 pipeline on the card against the same port on CPU
   copies (plain path), then a bf16 ``TwoStageServer`` that warms up and
   answers requests — one of them a short batch that pads — while K1-K3's
   launch counters must grow;
5. int8: the int8 models are calibrated and quantized on the card; K4
   (fused entry block) against its plain version at the main path's
   (8, 208, 208, 128), bit for bit, with its registers, the integer
   tensor-core instructions of its SASS (``cuobjdump``; none fails),
   kernels a call, device time and timings; the
   int8 pipeline on the card against CPU copies (K4's output bit-equal,
   masks equal); then an int8 ``TwoStageServer`` whose K1-K4 launch
   counters must all grow, with frames/s beside the bf16 server's;
6. K5: the int8 forward of the served frames up to the 26² stage (S=26,
   C=512, n=8, B=8), then K5 against its plain version, every int8 and
   bf16 equal, borders included; again at S=13 with ±127 at the borders;
   its device time, 2n = 16 kernels a call (SASS: integer tensor-core
   instructions, IMMA or IGMMA, > 0),
   and ``torch._int_mm`` on the same products as a yardstick;
7. probes: the ported Pallas probes of the repository's ``tools/``
   (``probes.PROBES``, 46, and P16 at 128× its rows) at their own sizes,
   each through the kernels ``tail_conv``, ``window_resample``,
   ``int8_contract`` and ``strided_map`` against its plain route (bits
   equal; block sums within their f32 tolerance), each one wrapper launch
   a call (``lane_subrange_write`` two); ``int8_contract``'s SASS holds
   integer tensor-core instructions (its and ``window_resample``'s
   registers printed); then ``tail_conv`` on
   the int8 RektNet's own ``res4.conv1`` — its input the activations that
   ``res[0..2]`` make of the K1 crops of the served frames, 64 crops —
   value-equal to ``relu(_qconv(h, res4.conv1))``, one kernel a call
   (SASS: IMMA or IGMMA > 0) with its device time; each of the four
   counted over this path, and timed on one of its shapes (device ms,
   kernels a call, host µs a call, the library call's device ms;
   ``int8_contract`` on P16×128 beside ``torch._int_mm`` with K padded to
   112, ``strided_map`` on Q17's sums with Q8's quantize and T15's
   transpose beside);
8. K2 backward against its plain version at (224, 80, 80), f32 and bf16,
   with and without a probabilities' gradient, one device kernel a call,
   its registers and its device time, ``torch._softmax_backward_data`` on
   a precomputed ``gp`` beside it as a yardstick; again at 896 rows
   (B=128);
9. training: one f32 ``rektnet_train_step`` on the card against the CPU
   from the same seeded parameters and batch (loss, updated parameters,
   running stats); 20 bf16 and 20 f32 steps on the card (finite losses,
   K2 forward and backward launched, ms per step); two epochs of the
   training loop, whose ``.pt`` checkpoint is reloaded and compared.

Prints one JSON line of per-kernel results before the last line, which is
``{"ok": true, "device": {...}}``. Each row's ``launches`` is counted over
its own path's run (counters set to 0 just before it; the K1-K5, K2
backward and ``tail_conv`` rows also carry ``device_ms`` and
``kernels_per_call``): K1-K4 over the
int8 server's requests, K5 over its stage path, the four probe kernels
over the probe path, K2's backward over the training steps. ``bound_ms``
is the larger of the row's bytes over 3.35 TB/s and its operations over
the card's peak for their type. Any failure
raises: exit code ≠ 0 and no result line. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
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
    "res_stage": ("mit_driverless_cv_traininginfra_tpu_torch/csrc/res_stage.cu",
                  "mit_driverless_cv_traininginfra_tpu/ops/pallas_resstage.py:224"),
    "softargmax_bwd": ("mit_driverless_cv_traininginfra_tpu_torch/csrc/softargmax.cu",
                       "mit_driverless_cv_traininginfra_tpu/ops/pallas_kernels.py:295"),
    # the Pallas probes of the repository's tools/ (probes.PROBES), by kernel
    "tail_conv": ("mit_driverless_cv_traininginfra_tpu_torch/csrc/tail_conv.cu",
                  "tools/probe_tail_conv1.py:64"),
    "window_resample": ("mit_driverless_cv_traininginfra_tpu_torch/csrc/window_resample.cu",
                        "tools/probe_crop_kernel.py:125,156"),
    "int8_contract": ("mit_driverless_cv_traininginfra_tpu_torch/csrc/int8_contract.cu",
                      "tools/probe_mosaic.py:48,118,145; tools/probe_mosaic2.py:105,120; "
                      "tools/probe_mosaic3.py:84; tools/probe_mosaic4.py:70,86; "
                      "tools/probe_mosaic6.py:114; tools/reprobe.py:89"),
    "strided_map": ("mit_driverless_cv_traininginfra_tpu_torch/csrc/strided_map.cu",
                    "tools/probe_crop_dma.py:50; tools/probe_crop_kernel.py:77; "
                    "tools/probe_mosaic.py:61,72,83,103,129; "
                    "tools/probe_mosaic2.py:64,76,89,185; tools/probe_mosaic3.py:68,98,109,172; "
                    "tools/probe_mosaic5.py:70; tools/probe_mosaic6.py:96,126,142; "
                    "tools/probe_mosaic7.py:123; tools/reprobe.py:89,201"),
}
# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "f32": 67e12}
B_SERVE, SIZE, MAX_DET = 8, 416, 16
CROP_N = 64                  # crops per kernel check: a served capacity at B=8
PTS_ATOL = {torch.float32: 1e-6, torch.bfloat16: 2e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def bound(n_bytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def paired_ms(kernel, plain, iters: int = 50) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two runs in the order
    plain, kernel, kernel, plain."""
    p1, k1 = cuda_ms(plain, iters), cuda_ms(kernel, iters)
    k2, p2 = cuda_ms(kernel, iters), cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


# the host calls that put work on the card: kernel launches, copies, fills
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset")


def device_kernels(fn, calls: int) -> tuple[list[str], float, float]:
    """What ``calls`` calls of ``fn`` put on the card, by ``torch.profiler``:
    the names of the device activities recorded, the host's launch, copy
    and fill calls per call, and the device milliseconds per call (the mean
    recorded activity times the launches per call). The count comes from
    the host's calls because CUPTI now and then leaves device activities
    out of a session's record (K4: 19 of 20 in some processes; Q17's sums:
    most of the long partial passes once), so a session whose record falls
    short of the host's count is taken again, up to three times, and the
    fullest record kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        got = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        n_host = sum(e.name in LAUNCH_CALLS for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CPU)
        if best is None or len(got) > len(best[0]):
            best = (got, n_host)
        if got and len(got) >= n_host:
            break
    evs, host = best
    per_call = host / calls
    mean_ms = sum(e.time_range.elapsed_us() for e in evs) / max(len(evs), 1) / 1e3
    return [e.name for e in evs], per_call, mean_ms * per_call


def sass_count(kernel: str, opcodes=("IMMA", "IGMMA")) -> dict | None:
    """How many instructions of each opcode the built library's SASS holds
    in the functions whose name contains ``kernel`` (``cuobjdump -sass``);
    None where the toolkit has no cuobjdump."""
    from pathlib import Path

    from torch.utils.cpp_extension import CUDA_HOME

    from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(_lib.build())], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, current = dict.fromkeys(opcodes, 0), ""
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
        elif kernel in current:
            for op in opcodes:
                counts[op] += len(re.findall(rf"\b{op}\b", line))
    return counts


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn``, queued without a sync (the
    wrapper's Python and the launches it issues)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def int_mm_ms(shapes, repeat: int = 1, iters: int = 5) -> float:
    """CUDA-event ms of ``torch._int_mm`` on each (M, K)·(K, N) of
    ``shapes``, each ``repeat`` times, over seeded random int8 matrices (B
    column-major, its fast layout): a yardstick of a kernel's products
    alone, not a library call of the kernel's function."""
    g = torch.Generator(device="cuda").manual_seed(0)
    mats = [(torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8),
             torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8).t())
            for m, k, n in shapes]
    return cuda_ms(lambda: [torch._int_mm(a, b) for _ in range(repeat) for a, b in mats], iters)


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
    from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_crop import roi_crop
    from mit_driverless_cv_traininginfra_tpu_torch.ops.image import (
        _crop_coords,
        roi_crop_bilinear_indexed,
    )

    rng = np.random.default_rng(1)
    frames32 = torch.from_numpy(rng.uniform(0, 1, (B_SERVE, SIZE, SIZE, 3))
                                .astype(np.float32)).to(dev)
    boxes = torch.from_numpy(crop_boxes(rng, CROP_N)).to(dev)
    fidx = torch.from_numpy(rng.integers(0, B_SERVE, CROP_N)).to(dev)
    finite = torch.isfinite(boxes).all(dim=1)
    # the plain crop's coordinates on the card are the CPU's bits (K1
    # computes its own, as the CPU does)
    coords = [c.cpu() for c in _crop_coords(boxes, 80, 80, SIZE, SIZE)]
    coords_cpu = _crop_coords(boxes.cpu(), 80, 80, SIZE, SIZE)
    same = all(torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num().view(torch.int32), b.nan_to_num().view(torch.int32))
        for a, b in zip(coords, coords_cpu))
    log(f"K1 _crop_coords card vs CPU (N={CROP_N}, 80×80): bit-equal {same}")
    check(same, "the plain crop's coordinates differ between card and CPU")
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
        kernels, per_call, dev_ms = device_kernels(lambda: roi_crop(frames, boxes, fidx), 20)
        log(f"K1 roi_crop {str(dt)[6:]}: N={CROP_N} max|d|={err!r} "
            f"differing={n_diff}/{got[finite].numel()} kernel {k_ms!r} ms "
            f"(device {dev_ms!r} ms, {per_call!r} launches a call, {len(kernels)} "
            f"device activities recorded: {sorted(set(kernels))}) plain {p_ms!r} ms")
        # bf16: the tap products are exact in f32, so both versions round
        # the same sums; f32: the plain GEMM may add the two taps in
        # another order (≤ 1 ulp of a [0, 1] pixel)
        check(err <= (0.0 if dt == torch.bfloat16 else 2 ** -23),
              f"K1 {dt} disagrees: {err}")
        check(per_call == 1 and kernels and all("roi_crop" in k for k in kernels),
              f"K1 is not one device kernel a call: {per_call}, {kernels}")
        errs.append(err)
        if dt == torch.bfloat16:
            # and against the plain crop on the CPU: the same bits
            ref_cpu = roi_crop_bilinear_indexed(frames.cpu(), boxes.cpu(), fidx.cpu())
            n_cpu = int((got[finite].cpu() != ref_cpu[finite.cpu()]).sum())
            log(f"K1 bf16 vs the plain crop on the CPU: differing {n_cpu}")
            check(n_cpu == 0, "K1 differs from the plain crop on the CPU")
            # the host's cost of a call, and of what the wrapper no longer does
            ctx = torch.cuda.device(dev)

            def old_host():
                _crop_coords(boxes, 80, 80, SIZE, SIZE)
                fidx.to(torch.int32)
                with ctx:
                    _lib.stream_ptr(dev)

            log(f"K1 host µs a call: roi_crop {host_us(lambda: roi_crop(frames, boxes, fidx))!r}; "
                f"what it no longer does (coordinates, index cast, device "
                f"context) {host_us(old_host)!r}")
            # bilinear: 4 taps, 4 products and 3 sums per output value
            b = bound(nbytes(frames, boxes, fidx, got), 8 * got.numel(), "f32")
            rows["roi_crop"].update(ms=k_ms, plain_ms=p_ms, device_ms=dev_ms,
                                    kernels_per_call=per_call,
                                    library_ms=grid_sample_ms(frames, boxes, fidx), **b)
    rows["roi_crop"]["max_abs_err"] = max(errs)


def grid_sample_ms(frames, boxes, fidx, out: int = 80) -> float:
    """ms of one ``F.grid_sample`` call that resamples the same boxes
    bilinearly to out×out (its inputs — the crops' frames as NCHW and the
    sampling grid — made beforehand): the library yardstick of K1."""
    import torch.nn.functional as F

    finite = torch.isfinite(boxes).all(dim=1)
    bx = torch.where(finite[:, None], boxes, torch.zeros_like(boxes))
    H, W = frames.shape[1], frames.shape[2]
    t = (torch.arange(out, device=boxes.device, dtype=torch.float32) + 0.5) / out
    gx = (bx[:, 0:1] + t * (bx[:, 2:3] - bx[:, 0:1])) / W * 2 - 1
    gy = (bx[:, 1:2] + t * (bx[:, 3:4] - bx[:, 1:2])) / H * 2 - 1
    grid = torch.stack(torch.broadcast_tensors(gx[:, None, :], gy[:, :, None]), -1)
    inp = frames[fidx].permute(0, 3, 1, 2)
    grid = grid.to(frames.dtype)
    return cuda_ms(lambda: F.grid_sample(inp, grid, mode="bilinear",
                                         align_corners=False))


def phase_k2(dev, rows: dict) -> None:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
        _torch_softargmax,
        fused_softargmax,
    )

    rng = np.random.default_rng(2)
    # 7 keypoint maps per crop: capacity 64 (the kernel checks' CROP_N) and
    # 112, the serving capacity that tools/profile_serving.py profiles
    z_all = torch.from_numpy(rng.normal(0, 3, (7 * 112, 80, 80)).astype(np.float32)).to(dev)
    errs = []
    for m in (7 * CROP_N, 7 * 112):
        for dt in (torch.float32, torch.bfloat16):
            z = z_all[:m].to(dt)
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
            kernels, per_call, dev_ms = device_kernels(lambda: fused_softargmax(z), 20)
            log(f"K2 softargmax {str(dt)[6:]}: M={m} max|d pts|={e_pts!r} "
                f"max|d probs|={e_pr!r} kernel {k_ms!r} ms (device {dev_ms!r} ms, "
                f"{per_call!r} launches a call, {len(kernels)} device activities "
                f"recorded: {sorted(set(kernels))}) plain {p_ms!r} ms")
            check(e_pts <= PTS_ATOL[dt] and pr_ok, f"K2 {dt} M={m} disagrees")
            check(per_call == 1 and kernels and all("softargmax" in k for k in kernels),
                  f"K2 is not one device kernel a call: {per_call}, {kernels}")
            errs.append(e_pts)
            if dt == torch.bfloat16 and m == 7 * CROP_N:
                # max, exp, sum, divide, two products and two sums per value
                b = bound(nbytes(z, probs, pts), 8 * z.numel(), "f32")
                rows["softargmax"].update(ms=k_ms, plain_ms=p_ms, device_ms=dev_ms,
                                          kernels_per_call=per_call, library_ms=None, **b)
            elif dt == torch.bfloat16:
                rows["softargmax"]["device_ms_m784"] = dev_ms
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
    # the served batch and one frame (frame 2: ties), in both dtypes
    for B, dt in ((B_SERVE, torch.float32), (B_SERVE, torch.bfloat16), (1, torch.float32),
                  (1, torch.bfloat16)):
        pick = slice(0, B) if B == B_SERVE else slice(2, 3)
        b, s = boxes[pick].to(dev, dt), scores[pick].to(dev, dt)
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
        line = (f"K3 nms_topk {str(dt)[6:]} inputs: B={B} N={N} k={MAX_DET} "
                f"slots_equal={same} kept/frame={ref_k.sum(1).tolist()} "
                f"kernel {k_ms!r} ms plain {p_ms!r} ms")
        check(same, f"K3 {dt} B={B}: slots differ from the plain version")
        errs.append(err)
        if dt == torch.float32:  # bf16 inputs add the wrapper's casts
            kernels, per_call, dev_ms = device_kernels(
                lambda: nms_topk(b, s, conf, MAX_DET, ovl), 20)
            line += (f" (device {dev_ms!r} ms, {per_call!r} launches a call, "
                     f"{len(kernels)} device activities recorded: {sorted(set(kernels))})")
            check(per_call == 1 and kernels and all("nms_topk" in k for k in kernels),
                  f"K3 is not one device kernel a call: {per_call}, {kernels}")
        log(line)
        if dt == torch.float32 and B == B_SERVE:
            # a threshold compare per candidate, ~20 operations per IoU pair
            bd = bound(nbytes(b, s, *got, idx), B * N + 20 * B * MAX_DET ** 2, "f32")
            rows["nms_topk"].update(ms=k_ms, plain_ms=p_ms, device_ms=dev_ms,
                                    kernels_per_call=per_call, library_ms=None, **bd)
        elif dt == torch.float32:
            rows["nms_topk"]["device_ms_b1"] = dev_ms
    # conf < 0 on scores of ±0 and −0.5: +0 ranks above −0 (lax.top_k's
    # order), slots bit-equal to the plain version's
    rng = np.random.default_rng(31)
    zs = torch.from_numpy(rng.choice(np.float32([-0.0, 0.0, -0.5]), (B_SERVE, N)))
    b, s = boxes.to(dev), zs.to(dev)
    for k in (1, MAX_DET, 64):
        got = _cuda_nms_topk(b, s, -1.0, k, ovl)
        ref = _torch_nms_topk(b, s, -1.0, k, ovl)
        same = (torch.equal(got[2].long(), ref[2]) and torch.equal(got[3], ref[3])
                and torch.equal(got[1].view(torch.int32), ref[1].view(torch.int32)))
        first_plus = bool((ref[1][:, 0].view(torch.int32) == 0).all())
        log(f"K3 conf -1 on ±0 scores, k={k}: slots bit-equal {same}, +0 first {first_plus}")
        check(same and first_plus, f"K3 on signed zeros, k={k}: slots differ from the plain version")
    rows["nms_topk"]["max_abs_err"] = max(errs)


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


def seeded_folded(dev):
    """The seeded YOLOv3-416 (heads sliced to one class) and RektNet-16,
    BN folded, f32 on ``dev``: ``(spec, darknet folded, rektnet folded)``."""
    from mit_driverless_cv_traininginfra_tpu_torch import convert
    from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import (
        flagship_spec,
    )
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
    from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import (
        AdaptiveCapacity,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import (
        TwoStageServer,
    )

    policy = AdaptiveCapacity(floor=64, quantum=16,
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
    from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
    from mit_driverless_cv_traininginfra_tpu_torch.models import quantize
    from mit_driverless_cv_traininginfra_tpu_torch.ops import entry

    spec1, folded1, rfolded = seeded_folded(dev)
    check(entry.entry_block_applicable(spec1), "YOLOv3-416 takes no fused entry")
    amax = quantize.calibrate(spec1, folded1, torch.from_numpy(frames_np).to(dev))
    crops, _ = synthetic.rektnet_batch(np.random.default_rng(3), 32)
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
    kernels, per_call, dev_ms = device_kernels(
        lambda: entry.fused_entry_block(hq, ep, SLOPE), 20)
    for line in ptxas_lines("entry_block"):
        log(f"K4 ptxas: {line}")
    sass = sass_count("entry_block_kernel")
    log(f"K4 SASS integer tensor-core instructions: {sass}")
    log(f"K4 entry_block int8: hq {tuple(hq.shape)} → {tuple(got.shape)} "
        f"differing={n_diff}/{got.numel()} (edges ±127: {n_diff_e}) "
        f"kernel {k_ms!r} ms (device {dev_ms!r} ms, {per_call!r} launches a call, "
        f"{len(kernels)} device activities recorded) plain {p_ms!r} ms")
    check(n_diff == 0 and n_diff_e == 0, "K4 differs from its plain version")
    check(sass is None or sass["IMMA"] + sass["IGMMA"] > 0,
          "K4's SASS holds no integer tensor-core instruction")
    check(per_call == 1 and kernels and all("entry_block" in k for k in kernels),
          f"K4 is not one device kernel a call: {per_call}, {kernels}")
    # int8 multiply-adds per output position: conv2p 4·128·64, 1×1 64·32,
    # 3×3 9·32·64
    ops = 2 * B_SERVE * (SIZE // 2) ** 2 * (4 * 128 * 64 + 64 * 32 + 9 * 32 * 64)
    b = bound(nbytes(hq, got, ep["w2_tc"], ep["w1x1_tc"], ep["w3_tc"]), ops, "int8")
    log(f"K4 bound {b['bound_ms']!r} ms ({b['bound_by']}), "
        f"{ops / k_ms / 1e9:.1f} TOP/s a call, {ops / dev_ms / 1e9:.1f} TOP/s on the device")
    rows["entry_block"].update(ms=k_ms, plain_ms=p_ms, library_ms=None, **b,
                               device_ms=dev_ms, kernels_per_call=per_call,
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


# ---------------------------------------------------------------------------
# phase 6: K5, the int8 residual stage
# ---------------------------------------------------------------------------

K5_C = 512  # the 26² stage of YOLOv3-416: S=26, C=512, n=8


def k5_setup(spec1, yolo_q):
    """The C=512 stage's span and its packed bundle from the int8 leaves:
    ``(start, n_blocks, pk)``."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops import resstage

    start, nb, _ = next(sp for sp in resstage.res_stage_spans(spec1)
                        if sp[2] == K5_C)
    rs = resstage.quantize_res_stage(yolo_q, start, nb, start + 3 * nb)
    return start, nb, resstage.pack_res_stage(rs)


def k5_path(yolo, frames, start: int, nb: int, pk):
    """K5's main path (``tools/bench_resstage.py``): the int8 forward up to
    block ``start − 1``, then the stage. Returns ``(x, x_flat, yq, ybf)``."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops import resstage

    with torch.inference_mode():
        x = yolo.truncated_forward(frames, start - 1)
        xf = resstage.res_stage_pre(x)
        yq, ybf = resstage.fused_res_stage(xf, pk, x.shape[1], nb, SLOPE)
    return x, xf, yq, ybf


def bits_differ(a, b) -> int:
    """Elements whose bits differ (a bf16 −0 differs from +0)."""
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return int((a != b).sum())


def k5_compare(xf, pk, S: int, nb: int, got) -> tuple[int, int, bool]:
    """(yq differing, ybf differing, borders zero) of K5's ``got`` against
    the plain version on the same input."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops import resstage

    ref = resstage._res_stage_plain(xf, pk, S, nb, SLOPE)
    torch.cuda.synchronize()
    B = xf.shape[0] // ((S + 2) ** 2)
    zero = True
    for t in got:
        m = resstage.res_stage_post(t, B, S)
        zero &= all(bool((e == 0).all()) for e in (m[:, 0], m[:, -1], m[:, :, 0], m[:, :, -1]))
    return bits_differ(got[0], ref[0]), bits_differ(got[1], ref[1]), zero


def phase_k5(dev, rows: dict, bundles, yolo, frames_np) -> None:
    from mit_driverless_cv_traininginfra_tpu_torch.ops import resstage

    start, nb, pk = k5_setup(bundles[0], bundles[1])
    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    resstage.fused_res_stage.launches = 0
    x, xf, yq, ybf = k5_path(yolo, frames, start, nb, pk)
    torch.cuda.synchronize()
    launches = resstage.fused_res_stage.launches
    B, S, _, C = x.shape
    check((B, S, C, nb) == (B_SERVE, 26, K5_C, 8), f"K5 stage {(B, S, C, nb)}")
    dq, db, zero = k5_compare(xf, pk, S, nb, (yq, ybf))
    # another S (13: 169 positions, not a multiple of the 64-position
    # tile) with values quantizing to ±127 on every border row and column
    rng = np.random.default_rng(6)
    big = 2.0 * 127.0 / float(pk["sx1"][0])
    xe = torch.from_numpy(rng.normal(0, float(x.float().std()), (3, 13, 13, C))
                          .astype(np.float32)).to(dev)
    sign = torch.from_numpy(rng.choice([-big, big], (4, 3, 13, C)).astype(np.float32)).to(dev)
    xe[:, 0], xe[:, -1], xe[:, :, 0], xe[:, :, -1] = sign
    xef = resstage.res_stage_pre(xe)
    dq_e, db_e, zero_e = k5_compare(xef, pk, 13, nb,
                                    resstage.fused_res_stage(xef, pk, 13, nb, SLOPE))
    k_ms, p_ms = paired_ms(lambda: resstage.fused_res_stage(xf, pk, S, nb, SLOPE),
                           lambda: resstage._res_stage_plain(xf, pk, S, nb, SLOPE),
                           iters=10)
    kernels, per_call, dev_ms = device_kernels(
        lambda: resstage.fused_res_stage(xf, pk, S, nb, SLOPE), 10)
    sass = {k: sass_count(k) for k in ("conv1x1_kernel", "conv3x3_kernel")}
    for kern in sass:
        for line in ptxas_lines(kern):
            log(f"K5 ptxas {kern}: {line}")
    ops = 2 * B * S * S * nb * (C * (C // 2) + 9 * (C // 2) * C)
    b = bound(nbytes(xf, pk["w1_tc"], pk["w3_tc"], yq, ybf), ops, "int8")
    gemm_ms = int_mm_ms([(B * S * S, C, C // 2), (B * S * S, 9 * C // 2, C)], nb)
    log(f"K5 res_stage int8: stage input {tuple(x.shape)} (blocks {start}-"
        f"{start + 3 * nb - 1}), n={nb}: yq differing {dq}/{yq.numel()}, ybf "
        f"differing {db}/{ybf.numel()}, borders zero {zero}; S=13 with ±127 "
        f"borders: {dq_e}, {db_e}, {zero_e}; kernel {k_ms!r} ms (device {dev_ms!r} "
        f"ms, {per_call!r} launches a call) plain {p_ms!r} ms; {ops / 1e9:.1f} G "
        f"int8 ops = {ops / dev_ms / 1e9:.1f} TOP/s on the device; bound "
        f"{b['bound_ms']!r} ms ({b['bound_by']}); torch._int_mm on the same "
        f"products {gemm_ms!r} ms; SASS {sass}; launches {launches}")
    check(dq == db == dq_e == db_e == 0 and zero and zero_e,
          "K5 differs from its plain version")
    check(launches == 1, f"K5's path launched it {launches} times")
    check(all(c is None or c["IMMA"] + c["IGMMA"] > 0 for c in sass.values()),
          f"K5's SASS holds no integer tensor-core instruction: {sass}")
    check(per_call == 2 * nb and kernels
          and all("conv1x1_kernel" in k or "conv3x3_kernel" in k for k in kernels),
          f"K5 is not 2n tensor-core kernels a call: {per_call}, {sorted(set(kernels))}")
    rows["res_stage"].update(ms=k_ms, plain_ms=p_ms, max_abs_err=0.0, device_ms=dev_ms,
                             kernels_per_call=per_call, launches=launches,
                             library_ms=None, int_mm_ms=gemm_ms, **b)


# ---------------------------------------------------------------------------
# phase 7: the tools' Pallas probes on the four probe kernels
# ---------------------------------------------------------------------------

PROBE_KERNELS = ("tail_conv", "window_resample", "int8_contract", "strided_map")
# the shape each probe kernel's row is timed on (tail_conv: RektNet's res4)
TIMED_PROBE = {"window_resample": "P22", "int8_contract": "P16x128",
               "strided_map": "Q17"}
# probes timed beside a kernel's row, and the device kernels a call of each
# timed probe (Q17's sums: a partial and a final pass)
BESIDE = {"strided_map": ("Q8@mosaic3", "T15")}
KERNELS_A_CALL = {"P22": 1, "P16x128": 1, "Q17": 2, "Q8@mosaic3": 1, "T15": 1}


def served_crops(yolo, rekt, frames, thresh, capacity: int = 64):
    """The K1 crops the int8 server hands RektNet for ``frames``: the top
    ``capacity`` detections of the detector, cropped to 80×80."""
    from mit_driverless_cv_traininginfra_tpu_torch.infer import pipeline

    got = []

    def keep(crops):
        got.append(crops)
        return rekt(crops)[1]

    with torch.inference_mode():
        boxes, scores, mask = pipeline._postprocess(yolo(frames), thresh, 0.25, MAX_DET)
        pipeline._crops_and_keypoints(keep, frames, boxes, scores, mask, 80, capacity)
    return got[0]


def phase_probes(dev, rows: dict, yolo, rekt, frames_np, thresh, smi) -> None:
    """Every probe through the kernels against its plain route, then
    ``tail_conv`` on the int8 RektNet's ``res4.conv1``. The four counters
    are set to 0 just before the probes and read after the res4 call."""
    import torch.nn.functional as F

    from mit_driverless_cv_traininginfra_tpu_torch.models import quantize
    from mit_driverless_cv_traininginfra_tpu_torch.probes import BY_NAME, PLAIN, PROBES, WRAPPERS
    from mit_driverless_cv_traininginfra_tpu_torch.probes import tail_conv1
    from mit_driverless_cv_traininginfra_tpu_torch.probes.mosaic import DP4A
    from mit_driverless_cv_traininginfra_tpu_torch.probes.run import run_both

    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    crops = served_crops(yolo, rekt, frames, thresh)
    with torch.inference_mode():
        h = F.relu(quantize._qconv(crops, rekt.stem))
        for blk in rekt.res[:3]:
            h = blk(h)
    conv1 = rekt.res[3].conv1
    check(tuple(h.shape) == (64, 80, 80, 64) and conv1.out_channels == 128,
          f"res4.conv1 input {tuple(h.shape)}")
    err = {k: 0.0 for k in PROBE_KERNELS}
    timed = {}
    t0 = time.perf_counter()
    for fn in WRAPPERS.values():
        fn.launches = 0
    for probe in PROBES + [DP4A]:
        inp = probe.build(dev)
        res = run_both(probe, inp)
        log(f"probe {probe.name} ({probe.ref}) {probe.kernel}: differing "
            f"{res.differing}/{res.kernel_out.numel()} max|d| {res.max_abs_err!r} "
            f"launches {res.launches[probe.kernel]}")
        calls = 2 if probe.name == "lane_subrange_write" else 1
        check(res.ok and res.launches[probe.kernel] == calls
              and all(n in (0, calls) for n in res.launches.values()),
              f"probe {probe.name}: the kernel route differs or did not launch "
              f"{calls} time(s): {res.launches}")
        err[probe.kernel] = max(err[probe.kernel], res.max_abs_err)
        if probe.name in TIMED_PROBE.values():
            timed[probe.kernel] = (probe, inp, res.kernel_out)
    with torch.inference_mode():
        got = WRAPPERS["tail_conv"](h, conv1)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in WRAPPERS.items()}
        want = F.relu(quantize._qconv(h, conv1))
    n_diff = int((got != want).sum())
    log(f"probes: {len(PROBES) + 1} probes PASS in {time.perf_counter() - t0:.1f} s; "
        f"launches over the probe path {launches}")
    check(all(launches[k] > 0 for k in PROBE_KERNELS),
          f"a probe kernel never launched on the probe path: {launches}")
    for line in ptxas_lines("window_resample_kernel"):
        log(f"window_resample ptxas: {line}")
    sass_ic = sass_count("int8_contract_kernel")
    for line in ptxas_lines("int8_contract_kernel") + ptxas_lines("4mdcv2sm"):
        log(f"probe kernels ptxas: {line}")
    log(f"int8_contract SASS {sass_ic}")
    check(sass_ic is None or sass_ic["IMMA"] + sass_ic["IGMMA"] > 0,
          f"int8_contract's SASS holds no integer tensor-core instruction: {sass_ic}")
    with torch.inference_mode():
        k_ms, p_ms = paired_ms(lambda: WRAPPERS["tail_conv"](h, conv1),
                               lambda: PLAIN.tail_conv(h, conv1), iters=20)
        kernels, per_call, dev_ms = device_kernels(lambda: WRAPPERS["tail_conv"](h, conv1), 10)
    nb, ops, kind = tail_conv1.tail_work({"h": h, "q": conv1}, got)
    b = bound(nb, ops, kind)
    sass = sass_count("tail_conv_kernel")
    for line in ptxas_lines("tail_conv_kernel"):
        log(f"tail_conv ptxas: {line}")
    gemm_ms = int_mm_ms([(h.shape[0] * 80 * 80, 9 * h.shape[-1], conv1.out_channels)])
    log(f"tail_conv on Int8RektNet res4.conv1, {tuple(h.shape)} from K1 crops of "
        f"the served frames: differing {n_diff}/{got.numel()} (values), kernel "
        f"{k_ms!r} ms (device {dev_ms!r} ms, {per_call!r} launches a call, "
        f"{ops / dev_ms / 1e9:.1f} TOP/s) plain {p_ms!r} ms, bound "
        f"{b['bound_ms']!r} ms ({b['bound_by']}), torch._int_mm on the same "
        f"product {gemm_ms!r} ms, SASS {sass} on {smi}")
    check(n_diff == 0, "tail_conv differs from relu(_qconv(h, res4.conv1))")
    check(sass is None or sass["IMMA"] + sass["IGMMA"] > 0,
          f"tail_conv's SASS holds no integer tensor-core instruction: {sass}")
    check(per_call == 1 and kernels and all("tail_conv" in k for k in kernels),
          f"tail_conv is not one device kernel a call: {per_call}, {kernels}")
    rows["tail_conv"].update(ms=k_ms, plain_ms=p_ms, library_ms=None, device_ms=dev_ms,
                             kernels_per_call=per_call, int_mm_ms=gemm_ms,
                             max_abs_err=max(err["tail_conv"], max_abs(got, want)),
                             launches=launches["tail_conv"], **b)
    for kernel, (probe, inp, out) in timed.items():
        row = probe_timing(probe, inp, out, smi)
        if kernel == "int8_contract":  # _int_mm on P16x128's product, K padded to 112
            M = inp["a"].shape[0]
            row["int_mm_ms"] = int_mm_ms([(M, 112, inp["b"].shape[1])], iters=20)
            row["int_mm_device_ms"] = int_mm_device_ms(M, 112, inp["b"].shape[1])
            log(f"int8_contract: torch._int_mm on ({M}, 112)·(112, {inp['b'].shape[1]}) "
                f"{row['int_mm_ms']!r} ms (device {row['int_mm_device_ms']!r} ms)")
        del inp
        for name in BESIDE.get(kernel, ()):
            beside = BY_NAME[name]
            b_inp = beside.build(dev)
            b_res = run_both(beside, b_inp)
            check(b_res.ok, f"probe {name} differs")
            row[name] = probe_timing(beside, b_inp, b_res.kernel_out, smi)
            del b_inp, b_res
        rows[kernel].update(max_abs_err=err[kernel], launches=launches[kernel], **row)
        torch.cuda.empty_cache()


def int_mm_device_ms(m: int, k: int, n: int) -> float:
    """Device ms of one ``torch._int_mm`` on seeded (m, k)·(k, n) int8, B
    column-major (``torch.profiler``)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8).t()
    return device_kernels(lambda: torch._int_mm(a, b), 10)[2]


def probe_timing(probe, inp, out, smi) -> dict:
    """A probe's kernel route timed: call ms against the plain route's
    (paired), device ms and kernels a call (``torch.profiler``), host µs a
    call, the bound, and its library call's call and device ms."""
    from mit_driverless_cv_traininginfra_tpu_torch.probes import KERNEL, PLAIN

    fn = lambda: probe.run(inp, KERNEL)  # noqa: E731
    k_ms, p_ms = paired_ms(fn, lambda: probe.run(inp, PLAIN), iters=20)
    kernels, per_call, dev_ms = device_kernels(fn, 10)
    h_us = host_us(fn)
    lib_ms = lib_dev_ms = None
    if probe.library is not None:
        lib = probe.library(inp)
        lib_ms, lib_dev_ms = cuda_ms(lib, 20), device_kernels(lib, 10)[2]
    nb, ops, kind = probe.work(inp, out)
    b = bound(nb, ops, kind)
    rate = (f"{ops / dev_ms / 1e9:.1f} TOP/s" if kind == "int8"
            else f"{nb / dev_ms / 1e6:.1f} GB/s") + " on the device"
    log(f"{probe.kernel} on {probe.name}: kernel {k_ms!r} ms (device {dev_ms!r} ms, {rate}, "
        f"{per_call!r} kernels a call {sorted(set(kernels))}, host {h_us!r} us a call) plain "
        f"{p_ms!r} ms library {lib_ms!r} ms (device {lib_dev_ms!r} ms) bound "
        f"{b['bound_ms']!r} ms ({b['bound_by']}) on {smi}")
    check(per_call == KERNELS_A_CALL[probe.name] and kernels,
          f"{probe.name}: {per_call} device kernels a call, {sorted(set(kernels))}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, library_device_ms=lib_dev_ms,
                device_ms=dev_ms, kernels_per_call=per_call, host_us=h_us, **b)


# ---------------------------------------------------------------------------
# phase 8: K2's backward
# ---------------------------------------------------------------------------


def phase_k2_bwd(dev, rows: dict) -> None:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
        _coord_rows,
        _torch_softargmax,
        _torch_softargmax_bwd,
        softargmax_bwd,
    )

    rng = np.random.default_rng(7)
    m = 7 * 32  # a training batch of 32 crops
    z32 = torch.from_numpy(rng.normal(0, 3, (m, 80, 80)).astype(np.float32)).to(dev)
    g_pts = torch.from_numpy(rng.normal(0, 1, (m, 2)).astype(np.float32)).to(dev)
    g_pr32 = torch.from_numpy(rng.normal(0, 1e-2, (m, 80, 80)).astype(np.float32)).to(dev)
    for line in ptxas_lines("softargmax_bwd_kernel"):
        log(f"K2-bwd ptxas: {line}")

    def held(probs, g, g_probs=None) -> float:
        """K2-bwd against its plain version; the largest |difference|."""
        got = softargmax_bwd(probs, g, g_probs).float()
        ref = _torch_softargmax_bwd(probs, g, g_probs).float()
        d = (got - ref).abs()
        # dz = p·(gp − s): the row sum s is taken in another order
        # (a block reduction against torch's), which moves dz by p·Δs,
        # within 1e-5 of the row's largest |dz|; bf16 also rounds the
        # result, one bf16 ulp (2^-7 relative) where Δs crosses a
        # rounding boundary
        rtol = 0.0 if probs.dtype == torch.float32 else 2 ** -7
        log(f"K2-bwd softargmax_bwd {str(probs.dtype)[6:]} g_probs "
            f"{'given' if g_probs is not None else 'None'}: M={probs.shape[0]} max|d|="
            f"{float(d.max())!r} (max|dz| {float(ref.abs().max())!r})")
        check(bool((d <= 1e-5 * ref.abs().max() + rtol * ref.abs()).all()),
              f"K2-bwd {probs.dtype} disagrees at {probs.shape[0]} rows")
        return float(d.max())

    errs = []
    for dt in (torch.float32, torch.bfloat16):
        _, probs = _torch_softargmax(z32.to(dt))
        for g_probs in (g_pr32.to(dt), None):
            errs.append(held(probs, g_pts, g_probs))
        if dt == torch.bfloat16:  # the training path's case: bf16, no g_probs
            k_ms, p_ms = paired_ms(lambda: softargmax_bwd(probs, g_pts),
                                   lambda: _torch_softargmax_bwd(probs, g_pts))
            kernels, per_call, dev_ms = device_kernels(lambda: softargmax_bwd(probs, g_pts), 20)
            # a yardstick, not one call computing the same function: the
            # row reduction and the elementwise pass of dz on a gp computed
            # beforehand, in the probabilities' dtype
            xv, yv = _coord_rows(80, 80, dev)
            gp = (g_pts[:, :1] * xv + g_pts[:, 1:] * yv).to(dt).reshape(probs.shape)
            sbd = lambda: torch._softmax_backward_data(gp, probs, 2, dt)  # noqa: E731
            sbd_dev_ms = device_kernels(sbd, 20)[2]
            log(f"K2-bwd bf16: kernel {k_ms!r} ms (device {dev_ms!r} ms, {per_call!r} "
                f"launches a call, {sorted(set(kernels))}) plain {p_ms!r} ms; "
                f"torch._softmax_backward_data on a precomputed gp (a yardstick) "
                f"{cuda_ms(sbd)!r} ms (device {sbd_dev_ms!r} ms)")
            check(per_call == 1 and kernels and all("softargmax_bwd" in k for k in kernels),
                  f"K2-bwd is not one device kernel a call: {per_call}, {kernels}")
            b = bound(nbytes(probs, g_pts, probs), 8 * probs.numel(), "f32")
            rows["softargmax_bwd"].update(ms=k_ms, plain_ms=p_ms, library_ms=None,
                                          device_ms=dev_ms, kernels_per_call=per_call,
                                          softmax_backward_data_device_ms=sbd_dev_ms, **b)
    # B=128's batch: 896 rows, bf16, no g_probs
    z896 = torch.from_numpy(rng.normal(0, 3, (4 * m, 80, 80)).astype(np.float32)).to(dev)
    g896 = torch.from_numpy(rng.normal(0, 1, (4 * m, 2)).astype(np.float32)).to(dev)
    _, p896 = _torch_softargmax(z896.to(torch.bfloat16))
    errs.append(held(p896, g896))
    dev896 = device_kernels(lambda: softargmax_bwd(p896, g896), 20)[2]
    log(f"K2-bwd bf16 M={4 * m}: device {dev896!r} ms")
    rows["softargmax_bwd"].update(device_ms_896=dev896, max_abs_err=max(errs))


# ---------------------------------------------------------------------------
# phase 9: RektNet training
# ---------------------------------------------------------------------------

TRAIN_B = 32
TRAIN_KW = dict(loss_type="l1_softargmax", include_geo=True,
                geo_loss_gamma_horz=0.05, geo_loss_gamma_vert=0.05,
                synth_target_sigma=1.0)


def rekt_trees(seed: int = 1):
    from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet

    return rektnet.init(torch.Generator().manual_seed(seed))


def rekt_batch(dev, seed: int, n: int = TRAIN_B):
    """n synthetic cone crops and their keypoints on ``dev``."""
    from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic

    crops, pts = synthetic.rektnet_batch(np.random.default_rng(seed), n)
    return torch.from_numpy(crops).to(dev), torch.from_numpy(pts).to(dev)


def phase_train_agree(dev) -> None:
    """One f32 train step from the same seeded parameters and batch on the
    card and on the CPU. SGD, so the update is linear in the gradient
    (Adam's first step is lr·sign(g), and the pre-BN conv biases, whose
    true gradient is 0, carry gradients of rounding noise whose sign it
    would turn into ±lr)."""
    from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import KeypointNet
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import rektnet_train_step

    params, state = rekt_trees()
    out = {}
    for d in ("cpu", dev):
        model = KeypointNet(params, state).to(d)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = make_optimizer(model.parameters(), "SGD", lr=0.01, momentum=0.9)
        imgs, pts = rekt_batch(d, 8)
        t0 = time.perf_counter()
        total, loc, geo = rektnet_train_step(model, opt, imgs, None, pts,
                                             compute_dtype="float32", **TRAIN_KW)
        loss = float(total)
        log(f"train f32 step on {d}: loss {loss!r} (location {float(loc)!r}, geo "
            f"{float(geo)!r}) in {time.perf_counter() - t0:.2f} s")
        out[str(d)] = (loss, before, {k: v.cpu() for k, v in model.state_dict().items()})
    (l_cpu, before, sd_cpu), (l_card, _, sd_card) = out["cpu"], out[str(dev)]
    names = {n for n, _ in KeypointNet(params, state).named_parameters()}
    upd_cpu = {k: v - before[k] for k, v in sd_cpu.items() if k in names}
    scale = max(float(u.abs().max()) for u in upd_cpu.values())
    # the SGD update −lr·g: f32 gradients through five BN layers are
    # ill-conditioned sums (on the CPU both the port and the JAX package sit
    # up to ~5e-4 of the largest gradient from a float64 evaluation), so
    # each update is held to 1e-3 of the largest update of any parameter.
    # (The pre-BN conv biases have a true gradient of 0; theirs is noise.)
    worst_upd, worst_name = max(
        (float((sd_card[k] - before[k] - u).abs().max()) / scale, k)
        for k, u in upd_cpu.items())
    # batch statistics of f32 activations summed in other orders (cuDNN,
    # oneDNN): 1e-4 of each statistic's scale
    worst_stat = max(float((sd_card[k] - v).abs().max() / v.abs().max().clamp_min(1e-12))
                     for k, v in sd_cpu.items()
                     if k.endswith(("running_mean", "running_var")))
    log(f"train f32 card vs CPU: loss {l_card!r} vs {l_cpu!r}; worst update "
        f"{worst_upd!r} of the largest ({worst_name}), worst running stat "
        f"{worst_stat!r} of its scale")
    check(abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu), "train f32: loss differs")
    check(worst_upd <= 1e-3, "train f32: parameter updates differ")
    check(worst_stat <= 1e-4, "train f32: running stats differ")


def phase_train_card(dev, smi, rows: dict) -> dict:
    """20 bf16 and 20 f32 Adam steps at B=32 on the card. Counters are set
    to 0 just before the steps and read just after."""
    from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import KeypointNet
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
        fused_softargmax,
        softargmax_bwd,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import rektnet_train_step

    imgs, pts = rekt_batch(dev, 9)
    models = {}
    for dt in ("bfloat16", "float32"):
        model = KeypointNet(*rekt_trees()).to(dev)
        opt = make_optimizer(model.parameters(), "Adam", lr=1e-3)
        rektnet_train_step(model, opt, imgs, None, pts, compute_dtype=dt, **TRAIN_KW)
        models[dt] = (model, opt)  # one warm step each: cuDNN meets every shape
    torch.cuda.synchronize()
    fused_softargmax.launches = softargmax_bwd.launches = 0
    for dt, (model, opt) in models.items():
        losses = []
        t0 = time.perf_counter()
        for _ in range(20):
            losses.append(rektnet_train_step(model, opt, imgs, None, pts,
                                             compute_dtype=dt, **TRAIN_KW)[0])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 20
        losses = torch.stack(losses).cpu()
        log(f"train {dt} B={TRAIN_B}: 20 steps, {ms!r} ms/step = "
            f"{TRAIN_B * 1e3 / ms!r} crops/s, loss {float(losses[0])!r} → "
            f"{float(losses[-1])!r} on {smi}")
        check(bool(torch.isfinite(losses).all()), f"train {dt}: non-finite loss")
    launches = {"softargmax": fused_softargmax.launches,
                "softargmax_bwd": softargmax_bwd.launches}
    log(f"train launches over the 40 steps: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a K2 kernel never launched while training: {launches}")
    rows["softargmax_bwd"]["launches"] = launches["softargmax_bwd"]
    return launches


def phase_driver(dev) -> None:
    """Two epochs of the training loop over in-memory synthetic loaders;
    the ``.pt`` it writes is reloaded and compared."""
    import glob
    import tempfile

    from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
    from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import KeypointNet
    from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import (
        load_rektnet_pt,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra_tpu_torch.train.rektnet_driver import (
        train_rektnet,
    )

    def loader(seed: int, n_batches: int):
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(n_batches):
            crops, pts = synthetic.rektnet_batch(rng, TRAIN_B)
            out.append((crops, np.zeros((TRAIN_B, 7, 1, 1), np.float32), pts,
                        [f"crop{i}" for i in range(TRAIN_B)], [(80, 80, 3)] * TRAIN_B))
        return out

    train, val = loader(10, 3), loader(11, 1)
    model = KeypointNet(*rekt_trees(2)).to(dev)
    opt = make_optimizer(model.parameters(), "Adam", lr=1e-3)
    with tempfile.TemporaryDirectory() as tmp:
        best, best_epoch, last = train_rektnet(
            model, opt, train, val, device=dev, output_path=tmp, num_epochs=2,
            lr=1e-3, include_geo=True, geo_loss_gamma_horz=0.05,
            geo_loss_gamma_vert=0.05, mixed_precision=True, device_targets=True,
            checkpoint_interval=2, log_dir=tmp)
        pts_files = glob.glob(f"{tmp}/*.pt")
        check(len(pts_files) == 1, f"driver: expected one .pt, got {pts_files}")
        model2 = KeypointNet(*rekt_trees(3)).to(dev)
        opt2 = make_optimizer(model2.parameters(), "Adam", lr=1.0)
        epoch = load_rektnet_pt(pts_files[0], model2, opt2)
    same_model = all(torch.equal(v, model2.state_dict()[k])
                     for k, v in model.state_dict().items())
    s1, s2 = opt.state_dict(), opt2.state_dict()
    same_opt = (s1["param_groups"][0]["lr"] == s2["param_groups"][0]["lr"] and all(
        torch.equal(s1["state"][i][k].cpu(), s2["state"][i][k].cpu())
        for i in s1["state"] for k in ("exp_avg", "exp_avg_sq", "step")))
    log(f"driver: 2 epochs, best validation loss {best!r} at epoch {best_epoch}, "
        f"last epoch {last}; {pts_files[0].rsplit('/', 1)[-1]} reloaded: epoch "
        f"{epoch}, model equal {same_model}, Adam state equal {same_opt}")
    check(math.isfinite(best) and last == 1 and epoch == 1,
          "driver: the loop did not run its two epochs")
    check(same_model and same_opt, "driver: the reloaded checkpoint differs")


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

    from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic

    frames_np, _ = synthetic.yolo_batch(np.random.default_rng(42), B_SERVE, SIZE)
    thresh = phase_slice_f32(dev, frames_np)
    fps_bf16 = phase_serve_bf16(dev, frames_np, thresh, smi)
    bundles = quantize_on_card(dev, frames_np)
    phase_k4(dev, rows, bundles[2], frames_np)
    yolo_q, rekt_q, thresh_q = phase_slice_int8(dev, frames_np, bundles)
    launches, fps_int8 = phase_serve_int8(yolo_q, rekt_q, frames_np, thresh_q, smi)
    log(f"served frames/s at B={B_SERVE}: int8 {fps_int8!r}, bf16 {fps_bf16!r}, "
        f"int8/bf16 {fps_int8 / fps_bf16!r} on {smi}")
    for name, n in launches.items():
        rows[name]["launches"] = n
    phase_k5(dev, rows, bundles, yolo_q, frames_np)
    phase_probes(dev, rows, yolo_q, rekt_q, frames_np, thresh_q, smi)
    phase_k2_bwd(dev, rows)
    phase_train_agree(dev)
    phase_train_card(dev, smi, rows)
    phase_driver(dev)
    check("jax" not in sys.modules, "jax was imported")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    check(all(set(keys) <= set(r) for r in rows.values()),
          f"a kernel row lacks a key: {[sorted(r) for r in rows.values()]}")
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
