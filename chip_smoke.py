#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Drives the port's main paths — the two-stage detect→crop→keypoints serving
path at the full width of YOLOv3-416 and RektNet, in bf16/f32 and in its
int8 configuration; the int8 residual stage (K5) on the int8 forward's
26² activations; the Pallas probes of the repository's ``tools/`` on four
kernels, at the probes' sizes; RektNet training at full width (net_size
16, 80×80, 7 keypoints, B=32); YOLO training at full width (YOLOv3-416,
one class, B=8), and from disk at the repository's 800² training cfg —
on seeded random weights, and on the weights that YOLO training makes of
synthetic scenes, and checks its hand-written CUDA kernels:

1. device: requires CUDA (no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles ``csrc/*.cu`` with nvcc and prints the seconds;
3. kernels: K1 (ROI crop), K2 (soft-argmax) and K3 (threshold + top-k +
   NMS) against their plain PyTorch versions on the card, at the shapes
   the main path gives them, in f32 and bf16, with CUDA-event timings,
   one device kernel a call and its device time (``torch.profiler``); K2
   at 448 and 784 rows (capacity 64 and 112) and in bf16 at 1792 (the
   B=256 training batch), K3 at B=8 and B=1, and at
   conf −1 on scores of ±0 (+0 ranks above −0, as lax.top_k ranks it); K1
   also: the plain crop's coordinates on the card bit-equal to the CPU's,
   its bf16 crops bit-equal to the plain crop on the CPU, the host
   microseconds of a call, and 64 boxes past the TPU crop kernel's window
   (h > 240, w > 211 px, up to 0.82·416) bit-equal to the plain crop,
   timed beside its bound (the row's ``oversize`` entry);
4. bf16 slice: the f32 pipeline on the card against the same port on CPU
   copies (plain path), then a bf16 ``TwoStageServer`` that warms up and
   answers requests — one of them a short batch that pads —, once by CUDA
   graph replay (``torch.profiler`` must name K1-K3 once a replay) and
   once eagerly (K1-K3's launch counters must grow by one a request);
5. int8: the int8 models are calibrated and quantized on the card; K4
   (fused entry block) against its plain version at the main path's
   (8, 208, 208, 128), bit for bit, with its registers, the integer
   tensor-core instructions of its SASS (``cuobjdump``; none fails),
   kernels a call, device time and timings; the
   int8 pipeline on the card against CPU copies (K4's output bit-equal,
   masks equal); then an int8 ``TwoStageServer``, graphed and eager as
   in 4, for K1-K4, with frames/s beside the bf16 server's;
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
   (B=128), and at 1792 (B=256) in bf16 with and without the
   probabilities' gradient;
9. training: one f32 ``rektnet_train_step`` on the card against the CPU
   from the same seeded parameters and batch (loss, updated parameters,
   running stats); 20 bf16 and 20 f32 steps on the card (finite losses
   that fall by a tenth, K2 forward and backward launched, ms per step);
   two epochs of the
   training loop, whose ``.pt`` checkpoint is reloaded and compared;
10. YOLO training (``phase_yolo``, each part's seconds printed):
   ``build_targets`` on every head bit-equal card vs CPU and the loss
   within 1e-6, on a synthetic batch and on two boxes in one cell; one f32
   SGD step at B=2 card vs CPU, each also against a float64 evaluation of
   the step; 20 bf16 and 20 f32 Adam steps at B=8 (finite losses, ms per
   step, peak memory; no K1-K5 wrapper launches: the path is cuDNN and
   plain PyTorch); the gradient clip's two batched launches against one
   tensor at a time, alone and in the 80-class B=32 bf16 step; two epochs of ``train_yolo`` over in-memory scenes,
   its ``.weights`` and full state reloaded and compared, and a resume
   that runs epoch 3 only; 200 bf16 steps on a pool of 256 scenes (the
   loss must fall), ``validate_map`` on 32 held-out scenes, and the
   trained weights BN-folded into ``Darknet`` through the f32 pipeline on
   the card and on the CPU (detection masks equal);
11. YOLO training from disk (``phase_yolo_disk``, each part's seconds
   printed) at the repository's ``model_cfg/yolo_baseline.cfg`` as shipped
   (YOLOv3, 80 classes, 800²): 48 cone scenes at 1280×960 and 1600×1200
   written as .npy and PNG (PNG read only where the native core builds),
   ``cli/kmeans_csvs`` (9 anchors the cfg reads back, a scale per
   resolution), the host feed rate (items/s at 1 worker and at every
   core) beside the 800² step's (bf16, device-aug and f32 ms at B=8),
   ``cli/yolo_train`` with every host augmentation for 2 epochs (the
   ``.weights`` and state files reloaded equal), a resume for the third,
   an ``--evaluate`` run and a ``--device_aug --preload_device`` epoch
   (finite losses, an mAP line each), the device-aug f32 step card vs CPU
   and against float64; no K1-K5 wrapper count moves;
12. RektNet training from disk (``phase_rektnet_disk``, each part's seconds
   printed) at full width: the port's ``tools/make_synth_dataset.py``
   writes 512 training and 64 validation crops of 64-160 px as .npy, the
   host feed of ``ConeDataset`` (items/s at 1 worker and at every core)
   beside the B=32 bf16 step's crops/s, ``cli/rektnet_train`` for 2 epochs
   (K2's forward launches once a batch, 38, and its backward once a step,
   32), its ``.pt`` reloaded equal to the resume state, a ``--resume``
   that runs epoch 3 only, ``--evaluate_mode`` and ``--vis_upload_data``
   on 8 crops (8 well-formed JPEGs);
13. the evaluation entry points (``phase_eval_cli``) on what phases 11 and
   12 trained: ``cli/rektnet_detect`` card vs ``--device cpu`` (keypoints
   within 1e-4, K2 once), ``cli/pipeline`` on two 1280×960 frames at
   ``model_cfg/yolo_baseline.cfg`` card vs CPU (masks equal at a
   gap-picked threshold, K1, K2 and K3 once a frame; the boxes' and the
   letterboxed input's differences logged), ``cli/yolo_detect``, ``cli/yolo_validate`` and the tools
   ``eval_weights`` and ``eval_rektnet_weights`` (their JSON lines);
14. export, hyper-search and ``train_to_map`` (``phase_export_hyper``,
   each part's seconds printed): ``cli/yolo2onnx`` on phase 11's weights
   (YOLOv3 at ``model_cfg/yolo_baseline.cfg``, 80 classes, 320×800) and
   ``cli/pt_to_onnx`` on phase 12's ``.pt``, each file run by the numpy
   evaluator (``export/onnx_eval.py``) on a seeded input and held to the
   card's f32 eval forward within ``EXPORT_REL`` of each output's largest
   |value|; one epoch of ``cli/rektnet_train`` whose best-model ONNX
   equals ``cli/pt_to_onnx`` of those weights byte for byte (K2 and K2's
   backward counted), a ``cli/yolo_train`` epoch stopped by
   ``--val_tolerance 0`` whose ONNX parses; ``cli/rektnet_hyper`` with two
   one-epoch trials in a subprocess (two completed trials, finite scores,
   seconds a trial); ``tools/train_to_map.py`` for YOLO (150 bf16 steps at
   B=32, mAP at conf 0.8 of the f32 and int8 models on 64 scenes; no
   K1-K5) and RektNet (150 steps at B=256; K2 and its backward once a
   step; the held-out L2 under half the untrained model's), both JSON
   lines printed;
15. several devices (``phase_multi_device``, each part's seconds
   printed): the DP YOLOv3-416 (B=4) and RektNet-16 (B=32) steps, f32 SGD,
   five of each, at world size 1 over NCCL and at world size 2 over
   ``gloo`` with both ranks on this card (NCCL takes one rank a GPU;
   ``gloo`` stages each collective through the host), against the same
   steps in this process on the whole batch after steps 1 and 3 (losses,
   parameters, running stats, at ``DP_*``'s bounds, cuDNN off on both
   sides; a reordered batch in one process printed as the noise floor),
   step ms with cuDNN on and off; the bf16 and int8
   ``TwoStageServer(mesh=make_mesh(1))`` graphed against the server
   without a mesh, every output of one request sequence bit-equal,
   frames/s of both, and served eagerly, K1-K4 once a request by their
   wrappers;
   ``TwoStagePP`` with both stages here against the fused pipeline on two
   microbatches, one over capacity (masks, boxes, scores bit-equal,
   keypoints within 1e-3 px; K1-K3 once a microbatch); and ``python -m
   …parallel.dryrun --n_devices 1`` (eight OK lines). Nothing here runs
   on several GPUs: the card's machine has one;
16. tensor-parallel and spatial sharding (``phase_tp_spatial``, its
   seconds printed and held under ``TP_PHASE_S``): the TP × DP YOLOv3-416
   step (B=4, f32 SGD with momentum, two steps, cuDNN off) on a data 1 ×
   model 2 mesh over ``gloo`` with both ranks on this card, and on a 1 × 1
   mesh over NCCL, each against the one-process step at ``DP_*``'s
   bounds, its step ms and each rank's parameter and momentum MiB beside
   the one-process figures (``gloo`` on one card stages every collective
   through the host: a correctness path, not a speed); the spatially
   sharded 416² detections on two ``gloo`` ranks (frame rows 224 and 192)
   against one process (f32, no TF32, cuDNN off; ``SP_*``: the bounded
   columns within rtol 1e-5, atol 1e-4, every column no further from a
   float64 evaluation than twice one process's distance), the halo bytes
   a rank beside one whole activation; and ``python
   -m …parallel.dryrun --n_devices 4 --device cpu`` (ten OK lines). The
   one-process reference runs first, alone; the two launches, the dry run
   and the float64 evaluation then run at once, and the phase prints each
   part's seconds;
17. the last JAX configurations (``phase_stem_crop``, its seconds printed
   and held under ``STEM_PHASE_S``): YOLOv3-416 with the packed
   space-to-depth stem beside the plain one — the f32 B=8 pipelines'
   masks equal at a threshold in a common gap, boxes, scores and
   keypoints within ``phase_slice_f32``'s bounds; each bf16 stem and
   detector against an f32 evaluation of the same bf16 weights (the
   packed one within ``STEM_BF16_FLOOR`` times the plain one's error);
   the stems' device ms (``torch.profiler``), detect ms, graphed served
   frames/s in turns —;
   the bf16 pipeline at capacity 112 and padded to 128 for RektNet
   (``kpt_pad_multiple``: masks equal, keypoints within
   ``phase_slice_f32``'s bound; RektNet ms on 112 and 128 crops); int8
   with ``stem_q`` and no fused entry, card vs CPU at
   ``phase_slice_int8``'s bounds, its served frames/s in turns with the
   fused entry's; ``TwoStageServer.from_params`` from the card's bundles
   (entry and stem) bit-equal to the servers built from models; the
   serve CLI on ``synthetic:32 --syn_oversize_tail 16 --crop_kernel on
   --packed_stem`` (the four watch keys: active, no switch, no box
   counted; the served boxes past the TPU window counted from its CSV);
   K1-K4's wrapper counts over eager requests of the packed bf16,
   ``stem_q`` and ``from_params`` servers; and YOLOv3-416 training
   through the packed stem (bf16 B=8 step ms in turns; on three seeds,
   two SGD steps in float64 packed against plain and the first f32 step,
   with two faulty stems that must fail).

Prints one JSON line of per-kernel results before the last line, which is
``{"ok": true, "device": {...}}``. Each row's ``launches`` is counted over
its own path's run (counters set to 0 just before it; the K1-K5, K2
backward and ``tail_conv`` rows also carry ``device_ms`` and
``kernels_per_call``): K1-K4 over the
eager int8 server's requests (a replay calls no wrapper), K5 over its stage path, the four probe kernels
over the probe path, K2's backward over the training steps; K1-K4 and
K2's backward also carry ``launches_multi_device``, their counts on phase
15's paths (rank 0's wrappers in the DP steps, over the eager mesh
servers' requests and over ``TwoStagePP``), and K1-K4
``launches_stem_crop``, theirs on phase 17's. ``bound_ms``
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
RK_TTM_B = 256               # tools/train_to_map.py's RektNet batch
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


def bf16_brackets(got, ref32) -> bool:
    """Every value of the bf16 ``got`` is one of the two bf16 neighbours
    of the f32 ``ref32`` (its rounding down or up; the value itself where
    bf16 holds it exactly): what an f32 difference far below a bf16 step
    can make of a rounding, in either direction."""
    near = ref32.to(torch.bfloat16)
    bits = near.view(torch.int16)
    toward = torch.sign(ref32 - near.float()).to(torch.int16)  # 0 where exact
    other = bits + torch.where(bits < 0, -toward, toward)      # sign-magnitude bits
    g = got.view(torch.int16)
    return bool(((g == bits) | (g == other)).all())


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


# the TPU crop kernel's window at C=3 (ops/pallas_crop.py:crop_kernel_box_limits)
TPU_BOX_LIMITS = (240.0, 211.0)
OVERSIZE_MAX = 0.82   # the serve CLI's --syn_oversize_tail cones: up to 0.82·H


def oversize_boxes(rng, n: int) -> np.ndarray:
    """n xyxy boxes in a SIZE² frame, each past the TPU kernel's window on
    both axes (h > 240, w > 211 px), up to 0.82·SIZE."""
    top = OVERSIZE_MAX * SIZE
    wh = np.stack([rng.uniform(TPU_BOX_LIMITS[1] + 1, top, n),
                   rng.uniform(TPU_BOX_LIMITS[0] + 1, top, n)], 1)
    xy = rng.uniform(0, 1, (n, 2)) * (SIZE - wh)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def k1_oversize(dev, rows: dict, frames32, fidx) -> None:
    """K1 on CROP_N boxes past the TPU kernel's window: bit-equal to the
    plain crop in bf16 (f32 within 2^-23), timed against its plain version,
    its bound and ``F.grid_sample``; the K1 row's second shape."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_crop import roi_crop
    from mit_driverless_cv_traininginfra_tpu_torch.ops.image import (
        roi_crop_bilinear_indexed,
    )

    boxes = torch.from_numpy(oversize_boxes(np.random.default_rng(11), CROP_N)).to(dev)
    hw = (boxes[:, 3] - boxes[:, 1], boxes[:, 2] - boxes[:, 0])
    check(bool((hw[0] > TPU_BOX_LIMITS[0]).all() and (hw[1] > TPU_BOX_LIMITS[1]).all()),
          "K1 oversize: a box inside the TPU window")
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        frames = frames32.to(dt)
        got = roi_crop(frames, boxes, fidx)
        ref = roi_crop_bilinear_indexed(frames, boxes, fidx)
        errs[dt] = max_abs(got, ref)
        check(errs[dt] <= (0.0 if dt == torch.bfloat16 else 2 ** -23),
              f"K1 oversize {dt} disagrees: {errs[dt]}")
    k_ms, p_ms = paired_ms(lambda: roi_crop(frames, boxes, fidx),
                           lambda: roi_crop_bilinear_indexed(frames, boxes, fidx))
    _, per_call, dev_ms = device_kernels(lambda: roi_crop(frames, boxes, fidx), 20)
    b = bound(nbytes(frames, boxes, fidx, got), 8 * got.numel(), "f32")
    lib = grid_sample_ms(frames, boxes, fidx)
    rows["roi_crop"]["oversize"] = dict(
        shape=f"{CROP_N} crops of {B_SERVE}×{SIZE}²×3 bf16, boxes h 241–{OVERSIZE_MAX * SIZE:.0f},"
              f" w 212–{OVERSIZE_MAX * SIZE:.0f} px", max_abs_err=max(errs.values()),
        ms=k_ms, plain_ms=p_ms, device_ms=dev_ms, kernels_per_call=per_call,
        library_ms=lib, **b)
    log(f"K1 roi_crop oversize (boxes h {float(hw[0].min()):.1f}–{float(hw[0].max()):.1f}, "
        f"w {float(hw[1].min()):.1f}–{float(hw[1].max()):.1f} px, past the TPU window "
        f"{TPU_BOX_LIMITS}): max|d| f32 {errs[torch.float32]!r} bf16 "
        f"{errs[torch.bfloat16]!r}; kernel {k_ms!r} ms (device {dev_ms!r} ms, "
        f"{per_call!r} launches a call) plain {p_ms!r} bound {b['bound_ms']!r} "
        f"F.grid_sample {lib!r}")


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
    k1_oversize(dev, rows, frames32, fidx)


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
            # probs: f32 within 1e-6; bf16 a rounding, either way, of the
            # plain version's f32 probabilities (a bf16 step is 2^-8 to
            # 2^-7 of the value)
            pr_ok = (torch.allclose(probs, probs_r, atol=1e-6, rtol=0.0)
                     if dt == torch.float32 else
                     bf16_brackets(probs, _torch_softargmax(z.float())[1]))
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
    # train_to_map's RektNet batch: 256 crops, 1792 maps, bf16
    z = torch.from_numpy(rng.normal(0, 3, (7 * RK_TTM_B, 80, 80)).astype(np.float32)).to(
        dev, torch.bfloat16)
    pts, probs = fused_softargmax(z)
    pts_r, probs_r = _torch_softargmax(z)
    e_pts = max_abs(pts, pts_r)
    pr_ok = bf16_brackets(probs, _torch_softargmax(z.float())[1])
    log(f"K2 softargmax bfloat16: M={z.shape[0]} max|d pts|={e_pts!r} "
        f"max|d probs|={max_abs(probs, probs_r)!r}")
    check(e_pts <= PTS_ATOL[torch.bfloat16] and pr_ok, f"K2 bf16 M={z.shape[0]} disagrees")
    errs.append(e_pts)
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


SERVE_CAPS = [64, 80, 96, 112]  # < B·max_det = 128: every bucket compacts
PATH_KERNELS = {"bf16": ("roi_crop", "softargmax", "nms_topk"),
                "int8": ("roi_crop", "softargmax", "nms_topk", "entry_block")}


def make_server(yolo, rekt, thresh, graphs: bool = True, **kw):
    from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import (
        AdaptiveCapacity,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import (
        TwoStageServer,
    )

    kw.setdefault("policy", AdaptiveCapacity(floor=64, quantum=16, warmup_capacity=96))
    return TwoStageServer(yolo, rekt, conf_thresh=thresh, max_det=MAX_DET,
                          cuda_graphs=graphs, **kw)


def serve(label: str, yolo, rekt, frames, thresh, smi, n_full: int = 63,
          graphs: bool = True, n_profiled: int = 16):
    """A ``TwoStageServer`` at B=8 that warms buckets of 64 up to 112 for
    frames of ``frames.dtype`` (captured as CUDA graphs, or run eagerly
    with ``graphs=False``), then answers a short batch of 6 that pads and
    ``n_full`` full batches. Served eagerly, the wrappers launch: every
    kernel counter is set to 0 just before the requests and read just
    after, and each kernel of the path must have launched once a request.
    By replay no wrapper runs: ``n_profiled`` more requests are served
    under ``torch.profiler``, and each kernel of the path must be named in
    its record once a replay. Returns ``(launches, frames/s, server)``:
    the wrappers' counts, or the profiler's counts over the replays."""
    server = make_server(yolo, rekt, thresh, graphs)
    path = PATH_KERNELS[label]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # a capture empties the cache: count from empty
    reserved = torch.cuda.memory_reserved()
    warm_s = server.warmup([B_SERVE], capacities=SERVE_CAPS, frame_dtype=frames.dtype)
    reserved = (torch.cuda.memory_reserved() - reserved) / 2 ** 20
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
    want = {k: (0 if graphs or k not in path else len(outs)) for k in wrappers}
    check(launches == want, f"{label} serve: wrapper counts {launches}, expected {want}")
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
    mode = "graphed" if graphs else "eager"
    log(f"serve {label} {mode} stats: {json.dumps(stats, default=str)}")
    log(f"serve {label} {mode}: {len(outs)} requests, {n_frames} frames in {wall!r} s "
        f"= {fps!r} frames/s, kept detections {kept}, launches {launches}; warmup "
        f"{warm_s!r} s, {len(server.warmed)} buckets, {reserved!r} MiB reserved by it, "
        f"on {smi}")
    check(kept > 0, f"{label} serve: no detection kept")
    check(stats["batch_pads"] >= 1, f"{label} serve: the short batch did not pad")
    check(stats["compiles"] == 0, f"{label} serve: a bucket ran that warmup did not build")
    check(stats["replays"] == (len(outs) if graphs else 0) and
          stats["graphs"] == (len(SERVE_CAPS) if graphs else 0),
          f"{label} serve: {stats['replays']} replays of {stats['graphs']} graphs")
    if graphs:
        launches = profiled_launches(label, server, frames, n_profiled)
    return launches, fps, server


def bits_equal(a, b) -> bool:
    if a.dtype == torch.bool or a.dtype == torch.int8:
        return torch.equal(a, b)
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def phase_graphs(label: str, server, yolo, rekt, frames_np) -> None:
    """Every warmed bucket's graph, for both feeds (uint8 and the detector's
    frame dtype) and a full and a short batch: the replay bit-equal to
    ``two_stage_pipeline`` run eagerly on the same (zero-padded) frames,
    and no wrapper's counter moved by the replay (it calls none). Then
    replayed requests under ``torch.profiler`` name each path kernel once
    a replay."""
    from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
        two_stage_pipeline,
    )

    dev = yolo.device
    feeds = {"uint8": torch.from_numpy((frames_np * 255).astype(np.uint8)).to(dev),
             str(yolo.frame_dtype)[6:]: torch.from_numpy(frames_np).to(dev, yolo.frame_dtype)}
    server.warmup([B_SERVE], capacities=SERVE_CAPS, frame_dtype=torch.uint8)
    wrappers = kernel_wrappers()
    path = PATH_KERNELS[label]
    n_checked = 0
    for feed, frames in feeds.items():
        for B, cap in sorted(server.warmed):
            for B0 in (B, 6):
                before = {k: fn.launches for k, fn in wrappers.items()}
                out = server._dispatch(frames[:B0], B, cap)
                grown = {k: fn.launches - before[k] for k, fn in wrappers.items()}
                pad = frames.new_zeros((B - B0, *frames.shape[1:]))
                ref = two_stage_pipeline(yolo, rekt, torch.cat([frames[:B0], pad]),
                                         conf_thresh=server.conf_thresh,
                                         max_det=MAX_DET, crop_capacity=cap)
                torch.cuda.synchronize()
                same = all(bits_equal(a[:B0], b[:B0]) for a, b in zip(out, ref))
                check(same, f"{label} graph ({B}, {cap}) {feed} B0={B0}: replay "
                            "differs from the eager pipeline")
                check(not any(grown.values()),
                      f"{label} graph ({B}, {cap}) {feed}: a replay moved counters {grown}")
                n_checked += 1
    log(f"graphs {label}: {n_checked} replays ({len(server.warmed)} buckets × "
        f"{list(feeds)} × B0 8 and 6) bit-equal to the eager pipeline, no wrapper "
        f"counter moved; {server.stats()['graphs']} graphs captured")
    profiled_launches(label, server, feeds["uint8"], 2)


def profiled_launches(label: str, server, frames, n: int) -> dict:
    """Serve ``n`` requests of ``frames`` under ``torch.profiler`` and count,
    by name, the device launches of each kernel of ``label``'s path in its
    record; each must equal the replays those requests ran. Retaken up to
    three times (CUPTI's records come back short now and then). Returns
    the counts."""
    from torch.profiler import ProfilerActivity, profile

    path = PATH_KERNELS[label]
    server(frames)
    torch.cuda.synchronize()
    for _ in range(3):
        replays = server.replays
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                server(frames)
            torch.cuda.synchronize()
        replays = server.replays - replays
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        counts = {k: sum(k in name for name in names) for k in path}
        if all(c == replays for c in counts.values()):
            break
    log(f"graphs {label}: {n} requests ({replays} replays) under torch.profiler: "
        f"{len(names)} device activities, path kernels by name {counts}")
    check(replays == n and all(c == n for c in counts.values()),
          f"{label}: {replays} replays, path kernels recorded {counts}")
    return counts


def phase_latency(label: str, server, frames, smi) -> dict:
    """``measure_latency``: 100 fenced requests at B=8 after 3 warm runs."""
    st = server.measure_latency(frames, n=100, warm=3)
    log(f"measure_latency {label} B={B_SERVE}: {st['latency_samples']} fenced samples, "
        f"batch ms {st['latency_batch_ms']}, frame ms {st['latency_frame_ms']} on {smi}")
    check(st["latency_samples"] >= 100, f"{label}: fewer than 100 fenced samples")
    return st


def phase_serve_bf16(dev, frames_np, thresh, smi):
    torch.backends.cudnn.benchmark = True
    yolo, rekt = build_models(dev, torch.bfloat16)
    yolo.to(memory_format=torch.channels_last)
    rekt.to(memory_format=torch.channels_last)
    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    _, fps, server = serve("bf16", yolo, rekt, frames, thresh, smi)
    _, fps_eager, _ = serve("bf16", yolo, rekt, frames, thresh, smi, graphs=False)
    phase_graphs("bf16", server, yolo, rekt, frames_np)
    phase_latency("bf16", server, frames, smi)
    return fps, fps_eager


# ---------------------------------------------------------------------------
# phase 5: int8
# ---------------------------------------------------------------------------

SLOPE = 0.1  # YOLOv3's leaky slope (flagship_spec)


def quantize_on_card(dev, frames_np):
    """Calibrate and quantize the seeded models as bench.py does: the f32
    folded Darknet on the 8 frames, RektNet on 32 synthetic cone crops.
    Returns ``(spec, yolo_q, entry_q, rekt_q, amax)``, tensors on ``dev``;
    ``amax``: the two calibrations, ``{"yolo", "rekt"}``."""
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
            quantize.quantize_rektnet_params(rfolded, ramax),
            {"yolo": amax, "rekt": ramax})


def tree_to(tree, dev):
    if torch.is_tensor(tree):
        return tree.to(dev)
    return {k: tree_to(v, dev) for k, v in tree.items()}


def int8_models(bundles, dev):
    from mit_driverless_cv_traininginfra_tpu_torch.models import quantize

    spec1, yolo_q, entry_q, rekt_q = bundles[:4]
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
    from mit_driverless_cv_traininginfra_tpu_torch.ops import entry

    yolo, rekt = int8_models(bundles, dev)
    cpu = (bundles[0], *(tree_to(b, "cpu") for b in bundles[1:4]))
    yolo_c, rekt_c = int8_models(cpu, "cpu")
    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    with torch.inference_mode():
        thresh = pick_conf_thresh(yolo.detections(frames, with_classes=False),
                                  MAX_DET)
        resq = entry.entry_forward_int8(yolo.entry.as_dict(), frames[:2], SLOPE)
        resq_c = entry.entry_forward_int8(yolo_c.entry.as_dict(),
                                          frames[:2].cpu(), SLOPE)
    resq_eq = torch.equal(resq.cpu(), resq_c)
    log(f"slice int8: K4's output card vs CPU (B=2) resq_equal={resq_eq}")
    check(resq_eq, "int8 slice: K4's output differs between card and CPU")
    int8_card_vs_cpu("int8", yolo, rekt, yolo_c, rekt_c, frames, thresh)
    return yolo, rekt, thresh


def int8_card_vs_cpu(label: str, yolo, rekt, yolo_c, rekt_c, frames, thresh) -> None:
    """The int8 pipeline on the card against CPU copies of its models at
    B=2, capacity 16: masks equal at ``thresh``, boxes, scores and
    keypoints within stated bounds."""
    from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
        two_stage_pipeline_int8,
    )

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
    log(f"slice {label} card vs CPU (B=2, capacity 16): conf_thresh {thresh!r} "
        f"detections {int(m.sum())} masks_equal={mask_eq} "
        f"max |d|/box size: boxes {box_err!r} keypoints {kpt_err!r}; "
        f"scores max |d| {score_err!r} (CPU run {cpu_s:.1f} s)")
    check(mask_eq, f"{label} slice: detection masks differ between card and CPU")
    check(int(m.sum()) > 0, f"{label} slice: no detection reached the keypoints")
    # the integer path and the f64-summed head are exact on both devices;
    # what differs is f32 exp/sigmoid in the decode (ulps), the f32 RektNet
    # head (summation order) and, through the box, the crop's samples
    check(box_err <= 1e-4 and score_err <= 1e-5 and kpt_err <= 1e-3,
          f"{label} slice: boxes / scores / keypoints beyond their bounds")


def phase_serve_int8(yolo, rekt, frames_np, thresh, smi):
    frames = torch.from_numpy(frames_np).to(yolo.device, torch.bfloat16)
    _, fps, server = serve("int8", yolo, rekt, frames, thresh, smi)
    # the kernels line takes the launches of the run in which the wrappers
    # launch: the eager serve
    launches, fps_eager, _ = serve("int8", yolo, rekt, frames, thresh, smi,
                                   graphs=False)
    phase_graphs("int8", server, yolo, rekt, frames_np)
    phase_latency("int8", server, frames, smi)
    return launches, fps, fps_eager


def phase_repairs(dev, frames_np, bundles) -> None:
    """The card's quantized bundle against one quantized on the CPU from the
    same amax (the weight scales are IEEE quotients on both), and the
    card's uint8 normalise against the CPU's, all bit for bit."""
    from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import normalize_u8
    from mit_driverless_cv_traininginfra_tpu_torch.models import quantize
    from mit_driverless_cv_traininginfra_tpu_torch.ops import entry

    # the card's own folded weights, so that only the quantization differs
    spec1, folded1, rfolded = seeded_folded(dev)
    folded1, rfolded = tree_to(folded1, "cpu"), tree_to(rfolded, "cpu")
    amax = bundles[4]
    cpu = (quantize.quantize_params(spec1, folded1, amax["yolo"]),
           entry.quantize_entry(folded1, amax["yolo"]),
           quantize.quantize_rektnet_params(rfolded, amax["rekt"]))
    n_leaves = 0
    for name, card, ref in zip(("quantize_params", "quantize_entry",
                                "quantize_rektnet_params"), bundles[1:4], cpu):
        leaves = list(tree_pairs(card, ref))
        n_leaves += len(leaves)
        bad = [k for k, a, b in leaves
               if a.dtype != b.dtype or not torch.equal(a.cpu().reshape(-1).view(torch.uint8),
                                                        b.reshape(-1).view(torch.uint8))]
        check(not bad, f"{name} on the card differs from the CPU's at {bad[:5]}")
    u8 = torch.arange(256, dtype=torch.uint8)
    same_norm = bits_equal(normalize_u8(u8.to(dev)).cpu(), normalize_u8(u8))
    log(f"repairs: {n_leaves} quantized leaves quantized on the card bit-equal to the "
        f"CPU's from the same amax; uint8 normalise card vs CPU bit-equal {same_norm}")
    check(same_norm, "the card's uint8 normalise differs from the CPU's")


def tree_pairs(a, b, path=""):
    """``(path, leaf of a, leaf of b)`` over two trees of the same keys."""
    check(a.keys() == b.keys(), f"trees differ in keys at {path}")
    for k in a:
        if isinstance(a[k], dict):
            yield from tree_pairs(a[k], b[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", a[k], b[k]


def phase_microbatch(yolo, rekt, frames_np, thresh, smi) -> None:
    """Two threads submit single uint8 frames to a ``MicroBatcher`` over an
    int8 server warmed at B=1 and 2 (dense capacity, so a frame's result
    does not hang on its batch). Every future's result against the
    server's direct B=1 call on that frame: masks, boxes and scores
    bit-equal (the detector is integer and f64-summed), keypoints within
    1e-3 px (RektNet's f32 head sums in another order at another batch)."""
    import threading

    from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import (
        AdaptiveCapacity,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.infer.microbatch import MicroBatcher

    u8 = (frames_np * 255).astype(np.uint8)
    server = make_server(yolo, rekt, thresh,
                         policy=AdaptiveCapacity(floor=16, quantum=16, warmup_capacity=32))
    server.warmup([1, 2], capacities=[32], frame_dtype=torch.uint8)
    results = {}

    def client(c: int, mb):
        for i in range(c, 32, 2):
            results[i] = mb.submit(u8[i % B_SERVE]).result(timeout=120)

    with MicroBatcher(server, bucket_sizes=(1, 2), max_wait_ms=2.0) as mb:
        threads = [threading.Thread(target=client, args=(c, mb)) for c in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in threads), "a MicroBatcher client hung")
        st = mb.stats()
    check(len(results) == 32, f"{len(results)} of 32 futures resolved")
    direct = {}
    for i in range(B_SERVE):
        out = server(u8[i:i + 1])
        direct[i] = [x[0].cpu().numpy() for x in out]
    kpt_err = 0.0
    for i, r in results.items():
        boxes, scores, mask, kpts = direct[i % B_SERVE]
        check(np.array_equal(r["mask"], mask) and np.array_equal(r["boxes"], boxes)
              and np.array_equal(r["scores"], scores),
              f"MicroBatcher frame {i}: detections differ from the direct call")
        kpt_err = max(kpt_err, float(np.abs(r["keypoints"] - kpts).max()))
    log(f"microbatch: 32 frames from 2 threads, {st['batches']} batches "
        f"{st['bucket_histogram']}, request_ms {st['request_ms']}, detections "
        f"bit-equal to direct calls, keypoints max |d| {kpt_err!r} px on {smi}")
    check(kpt_err <= 1e-3, f"MicroBatcher keypoints {kpt_err} px off the direct call")


def phase_detect(dev, smi) -> None:
    """``detect_image`` on a 720×1280 uint8 frame with the f32 detector, on
    the card against the CPU: the kept detections equal in number and
    order, boxes within 1e-2 px + 1e-4 relative (f32 convolutions summed
    in other orders, as the f32 slice); then the plain ``nms`` on the
    frame's 10647 candidates at ``top_k`` 200, timed on the card."""
    from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
    from mit_driverless_cv_traininginfra_tpu_torch.infer.detect import detect_image
    from mit_driverless_cv_traininginfra_tpu_torch.ops.image import letterbox
    from mit_driverless_cv_traininginfra_tpu_torch.ops.nms import batched_nms

    yolo, _ = build_models(dev, torch.float32)
    scene, _ = synthetic.yolo_batch(np.random.default_rng(7), 1, 1280)
    img = (scene[0, :720] * 255).astype(np.uint8)
    boxed, _ = letterbox(torch.from_numpy(img).to(dev).float()[None] / 255.0,
                         SIZE, SIZE)
    with torch.inference_mode():
        dets = yolo.detections(boxed, with_classes=False)
    thresh = pick_conf_thresh(dets, MAX_DET)
    t0 = time.perf_counter()
    got_b, got_s = detect_image(yolo, img, conf_thresh=thresh, nms_thresh=0.25)
    card_s = time.perf_counter() - t0
    ref_b, ref_s = detect_image(yolo.to("cpu"), img, conf_thresh=thresh, nms_thresh=0.25)
    same_n = got_b.shape == ref_b.shape
    err = (float(np.abs(got_b - ref_b).max()) if same_n and len(ref_b) else 0.0)
    log(f"detect_image 720×1280 uint8, conf_thresh {thresh!r}: card {len(got_b)} "
        f"detections in {card_s!r} s, CPU {len(ref_b)}; boxes max |d| {err!r} px")
    check(same_n and len(ref_b) > 0, "detect_image: card and CPU keep different detections")
    check(np.allclose(got_b, ref_b, rtol=1e-4, atol=1e-2)
          and np.allclose(got_s, ref_s, rtol=1e-4, atol=1e-5),
          "detect_image: card boxes or scores beyond rtol 1e-4, atol 1e-2 / 1e-5")
    conf = dets[..., 4]
    xy, wh = dets[..., 0:2], dets[..., 2:4] / 2
    corner = torch.cat([xy - wh, xy + wh], dim=-1)
    scores = torch.where(conf > thresh, conf, torch.full_like(conf, -torch.inf))
    ms = cuda_ms(lambda: batched_nms(corner, scores, 0.25, 200), iters=10, warm=2)
    log(f"nms (plain torch, not the served path) B=1 N={conf.shape[1]} top_k 200: "
        f"{ms!r} ms a call on {smi}")


def write_cli_models(tmp: str) -> list:
    """A full-size YOLOv3-416 ``.weights`` (80-class heads, which the CLI
    slices to one class), its cfg and a RektNet ``.pt``, the seeded
    models, written by the port to ``tmp``; returns the serve CLI's
    arguments that name them."""
    from mit_driverless_cv_traininginfra_tpu_torch import convert
    from mit_driverless_cv_traininginfra_tpu_torch.config.cfg_factory import yolov3_cfg
    from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet
    from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import KeypointNet
    from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import save_rektnet_pt

    spec = flagship_spec(SIZE)
    rng = np.random.default_rng(0)     # seeded_folded's draws
    yp, ys = convert.init_darknet_np(spec, rng)
    rp, rs = convert.init_rektnet_np(rng)
    cfg = f"{tmp}/yolov3-416.cfg"
    with open(cfg, "w") as f:
        f.write(yolov3_cfg(width=SIZE, height=SIZE, classes=80))
    darknet.save_darknet_weights(spec, convert.from_jax(yp), convert.from_jax(ys),
                                 f"{tmp}/yolov3.weights")
    save_rektnet_pt(f"{tmp}/rektnet.pt", KeypointNet(convert.from_jax(rp),
                                                     convert.from_jax(rs)))
    return ["--model_cfg", cfg, "--vanilla_anchor", "--yolo_weights",
            f"{tmp}/yolov3.weights", "--rektnet_weights", f"{tmp}/rektnet.pt",
            "--assert_no_compiles"]


def serve_cli_summary(argv: list) -> tuple[int, dict, float]:
    """The serve CLI in this process: (exit code, its JSON summary, s)."""
    import contextlib
    import io

    from mit_driverless_cv_traininginfra_tpu_torch.cli import serve as cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), time.perf_counter() - t0


def phase_cli(dev, frames_np, thresh_bf16, thresh_int8, smi) -> None:
    """The serve CLI in-process on ``synthetic:64`` at int8 and bf16 and in
    latency mode, on the files of :func:`write_cli_models`; each must exit
    0 with ``--assert_no_compiles`` and print its JSON summary."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        common = ["--source", "synthetic:64"] + write_cli_models(tmp)
        runs = (("int8", ["--precision", "int8", "--conf_thres", repr(thresh_int8)]),
                ("bf16", ["--precision", "bf16", "--conf_thres", repr(thresh_bf16)]),
                ("bf16 latency", ["--precision", "bf16", "--conf_thres",
                                  repr(thresh_bf16), "--latency_mode"]))
        for label, extra in runs:
            rc, summary, secs = serve_cli_summary(common + extra)
            keys = ("mode", "frames", "fps", "e2e_batch_ms", "request_frame_ms",
                    "compiles", "calls", "graphs", "replays", "mean_load", "warmup_seconds")
            log(f"cli {label}: rc {rc} in {secs:.1f} s; "
                + json.dumps({k: summary.get(k) for k in keys}) + f" on {smi}")
            check(rc == 0 and summary["frames"] == 64 and summary["compiles"] == 0,
                  f"cli {label}: rc {rc}, {summary['frames']} frames, "
                  f"{summary['compiles']} compiles")
            check(summary["replays"] == summary["calls"] > 0,
                  f"cli {label}: {summary['replays']} replays of {summary['calls']} calls")


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
    # train_to_map's RektNet batch: 1792 rows, bf16, with and without g_probs
    m = 7 * RK_TTM_B
    z = torch.from_numpy(rng.normal(0, 3, (m, 80, 80)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(0, 1, (m, 2)).astype(np.float32)).to(dev)
    g_pr = torch.from_numpy(rng.normal(0, 1e-2, (m, 80, 80)).astype(np.float32)).to(dev)
    _, p_ttm = _torch_softargmax(z.to(torch.bfloat16))
    for g_probs in (g_pr.to(torch.bfloat16), None):
        errs.append(held(p_ttm, g, g_probs))
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
        # 20 steps on one batch: f32 and bf16 alike take a tenth off
        check(float(losses[-1]) < 0.9 * float(losses[0]), f"train {dt}: the loss did not fall")
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
        pts_files = glob.glob(f"{tmp}/*_loss_*.pt")
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


# ---------------------------------------------------------------------------
# phase 10: YOLO training
# ---------------------------------------------------------------------------

YOLO_B = 8
YOLO_KW = dict(xy_loss=2.0, wh_loss=1.6, object_loss=0.1, no_object_loss=25.0)


def yolo_spec():
    from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import (
        flagship_spec,
    )

    return flagship_spec(SIZE, classes=1)


def train_darknet(spec, dev, seed: int = 0):
    """A ``TrainDarknet`` of ``spec`` from ``init_params`` (seeded) on
    ``dev``."""
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet

    return darknet.TrainDarknet(spec, *darknet.init_params(
        spec, torch.Generator().manual_seed(seed))).to(dev)


def yolo_scenes(seed: int, n: int):
    """n synthetic SIZE² cone scenes and their (n, 10, 5) targets, numpy."""
    from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic

    return synthetic.yolo_batch(np.random.default_rng(seed), n, SIZE)


def training_launches() -> dict:
    """Every K1-K5 wrapper's count (K2's backward too)."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import softargmax_bwd
    from mit_driverless_cv_traininginfra_tpu_torch.ops.resstage import fused_res_stage

    fns = {**kernel_wrappers(), "softargmax_bwd": softargmax_bwd,
           "res_stage": fused_res_stage}
    return {k: f.launches for k, f in fns.items()}


def shared_cell_targets() -> np.ndarray:
    """Two boxes of frame 0 in one cell of the 13² head with one best
    anchor (other offsets, sizes, classes), a padded row between them and
    a box elsewhere after; frame 1 a box and padding."""
    t = np.zeros((2, 6, 5), np.float32)
    t[0, 0] = [0, 6.2 / 13, 6.3 / 13, 0.30, 0.32]
    t[0, 2] = [0, 6.7 / 13, 6.8 / 13, 0.31, 0.33]
    t[0, 3] = [0, 1.5 / 13, 1.5 / 13, 0.05, 0.08]
    t[1, 0] = [0, 2.5 / 13, 9.5 / 13, 0.05, 0.3]
    return t


def phase_yolo_targets(dev) -> None:
    """``build_targets`` on every head and ``yolo_loss`` on the card and
    on the CPU: a synthetic batch and a crafted one with two boxes in one
    cell. Targets bit-equal (floats compared as bits); loss and
    components within 1e-6 relative."""
    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import YoloBlock
    from mit_driverless_cv_traininginfra_tpu_torch.models.yolo_loss import (
        build_targets,
        scaled_anchors,
        yolo_loss,
    )

    spec = yolo_spec()
    heads_yb = [b for b in spec.blocks if isinstance(b, YoloBlock)]
    _, synth = yolo_scenes(20, YOLO_B)
    rng = np.random.default_rng(21)
    worst = 0.0
    for label, target in (("synthetic", synth), ("shared cell", shared_cell_targets())):
        n_b = target.shape[0]
        heads = [rng.normal(0, 2, (n_b, SIZE // s, SIZE // s, 18)).astype(np.float32)
                 for s in (32, 16, 8)]
        out = {}
        for d in ("cpu", dev):
            t = torch.from_numpy(target).to(d)
            tg = []
            for yb, h in zip(heads_yb, heads):
                tg.append(build_targets(t, scaled_anchors(yb.anchors, SIZE / h.shape[1],
                                                          torch.device(d)),
                                        1, h.shape[1], h.shape[2], 0.5))
            loss, comps = yolo_loss(spec, [torch.from_numpy(h).to(d) for h in heads], t,
                                    **YOLO_KW)
            out[str(d)] = (tg, torch.cat([loss.reshape(1), comps]).cpu())
        (t_cpu, l_cpu), (t_card, l_card) = out["cpu"], out[str(dev)]
        equal = all(bits_equal(a.cpu(), b) for x, y in zip(t_card, t_cpu)
                    for a, b in zip(x, y))
        n_obj = sum(int(x.mask.sum()) for x in t_cpu)
        rel = float(((l_card - l_cpu).abs() / l_cpu.abs().clamp_min(1e-12)).max())
        worst = max(worst, rel)
        log(f"yolo targets {label} (B={n_b}, 3 heads): card vs CPU bit-equal={equal} "
            f"({n_obj} object cells); loss {float(l_card[0])!r} vs {float(l_cpu[0])!r}, "
            f"worst relative difference of loss and 6 components {rel!r}")
        check(equal, f"yolo targets ({label}): build_targets differs card vs CPU")
        check(rel <= 1e-6, f"yolo targets ({label}): loss beyond 1e-6 relative")


def sgd_update_f64(spec, imgs, targets, dev, lr: float = 0.01) -> dict:
    """The first SGD step's update, −lr·g, of the seeded model on the same
    batch, with the forward, batch norm, loss and backward in float64 on
    ``dev``: the reference the f32 steps are measured against."""
    from mit_driverless_cv_traininginfra_tpu_torch.models.yolo_loss import yolo_loss

    model = train_darknet(spec, dev)
    heads = model.forward_features(imgs.to(dev, torch.float64), train=True,
                                   dtype=torch.float64)
    yolo_loss(spec, heads, targets.to(dev), **YOLO_KW)[0].backward()
    return {n: (-lr * p.grad.double()).cpu() for n, p in model.named_parameters()}


def pixel_corners(targets: np.ndarray, size: int) -> np.ndarray:
    """Normalised [c, cx, cy, w, h] targets → pixel-corner labels, zero
    rows kept (what ``ImageLabelDataset(device_aug=True)`` yields)."""
    px = np.zeros_like(targets)
    px[..., 0] = targets[..., 0]
    px[..., 1] = (targets[..., 1] - targets[..., 3] / 2) * size
    px[..., 2] = (targets[..., 2] - targets[..., 4] / 2) * size
    px[..., 3] = (targets[..., 1] + targets[..., 3] / 2) * size
    px[..., 4] = (targets[..., 2] + targets[..., 4] / 2) * size
    px[targets.sum(-1) == 0] = 0
    return px


def phase_yolo_train_agree(dev, device_aug: bool = False) -> None:
    """One f32 SGD step of YOLOv3-416 at B=2 from the same seeded trees on
    the card and on the CPU (SGD: see ``phase_train_agree``), each also
    measured against a float64 evaluation of the same step. ``device_aug``:
    the step is ``yolo_train_step_device_aug`` on pixel-corner labels, every
    augmentation on (affine, flip, jitter, noise) with the same draws on
    both devices (drawn on the card); the float64 step takes the card's
    augmented batch."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops import device_aug as aug
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import (
        yolo_train_step,
        yolo_train_step_device_aug,
    )

    spec = yolo_spec()
    imgs, targets = map(torch.from_numpy, yolo_scenes(22, 2))
    label = "device-aug step" if device_aug else "step"
    if device_aug:
        labels = torch.from_numpy(pixel_corners(targets.numpy(), SIZE))
        draws = aug.sample_draws(torch.Generator(device=dev).manual_seed(5), 2, SIZE,
                                 SIZE, 3, augment_affine=True, noise=True)

        def step(model, opt, d):
            return yolo_train_step_device_aug(
                model, opt, imgs.to(d), labels.to(d), {k: v.to(d) for k, v in draws.items()},
                compute_dtype="float32", **YOLO_KW)
    else:
        def step(model, opt, d):
            return yolo_train_step(model, opt, imgs.to(d), targets.to(d),
                                   compute_dtype="float32", **YOLO_KW)
    out = {}
    for d in ("cpu", dev):
        model = train_darknet(spec, d)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = make_optimizer(model.parameters(), "SGD", lr=0.01, momentum=0.9)
        t0 = time.perf_counter()
        loss, comps = step(model, opt, d)
        loss = float(loss)
        log(f"yolo f32 {label} on {d} (B=2): loss {loss!r} components "
            f"{comps.cpu().tolist()} in {time.perf_counter() - t0:.2f} s")
        out[str(d)] = (loss, before, {k: v.cpu() for k, v in model.state_dict().items()})
    (l_cpu, before, sd_cpu), (l_card, _, sd_card) = out["cpu"], out[str(dev)]
    if device_aug:
        with torch.no_grad():
            imgs, px = aug.apply(imgs.to(dev), labels.to(dev), draws)
            targets = aug.pixel_labels_to_targets(px, SIZE, SIZE)
    upd64 = sgd_update_f64(spec, imgs, targets, dev)
    scale = max(float(u.abs().max()) for u in upd64.values())

    def worst(sd, ref):
        return max((float((sd[k] - before[k] - u).abs().max()) / scale, k)
                   for k, u in ref.items())

    upd_cpu = {k: (sd_cpu[k] - before[k]).double() for k in upd64}
    worst_upd, worst_name = worst(sd_card, upd_cpu)
    (card64, card64_name), (cpu64, cpu64_name) = worst(sd_card, upd64), worst(sd_cpu, upd64)
    worst_stat = max(float((sd_card[k] - v).abs().max() / v.abs().max().clamp_min(1e-12))
                     for k, v in sd_cpu.items()
                     if k.endswith(("running_mean", "running_var")))
    log(f"yolo f32 {label} card vs CPU: loss {l_card!r} vs {l_cpu!r}; worst update "
        f"{worst_upd!r} of the largest ({worst_name}); from the float64 step: card "
        f"{card64!r} ({card64_name}), CPU {cpu64!r} ({cpu64_name}); worst running "
        f"stat {worst_stat!r} of its scale")
    # the bounds of the RektNet step (phase_train_agree) for the loss and the
    # running stats. The updates: 75 convolutions deep, the first conv's
    # weight gradient is the least certain. Measured on this step (NVIDIA
    # H100 80GB HBM3, 700.00 W): the card's f32 updates sit 6.8e-3 of the
    # largest update from the float64 step, the CPU's 6.5e-3 (both at
    # convs.0.weight), and the two 3.9e-3 from each other. So the card is
    # held to the CPU's own distance from the float64 step, which follows
    # the step's conditioning, with a quarter of it as room for cuDNN's
    # nondeterministic backward; the CPU (deterministic) within 1e-2 of
    # the float64 step, and the two within 1e-2 of each other.
    check(abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu), f"yolo f32 {label}: loss differs")
    check(worst_stat <= 1e-4, f"yolo f32 {label}: running stats differ")
    check(card64 <= 1.25 * cpu64,
          f"yolo f32 {label}: the card's update is further from the float64 step "
          "than the CPU's by more than a quarter")
    if not device_aug:
        check(cpu64 <= 1e-2, f"yolo f32 {label}: the CPU's update is off the float64 step")
        check(worst_upd <= 1e-2, f"yolo f32 {label}: parameter updates differ")
        return
    # on the augmented batch the CPU's f32 step is the least accurate of the
    # three: oneDNN's convolution backward puts convs.0.weight's update
    # 1.99e-2 of the largest from the float64 step (card's draws; 1.43e-2 on
    # a CPU rehearsal's, 4.3e-3 there with oneDNN off; jitter alone 1.46e-2),
    # while the card's sits 6.4e-3 away, as on the plain batch (6.8e-3). So
    # the card is held to the float64 step itself at the CPU's bound above,
    # 1e-2, and the card-vs-CPU difference, the sum of the two, is logged.
    check(card64 <= 1e-2, f"yolo f32 {label}: the card's update is off the float64 step")


def phase_yolo_train_card(dev, smi) -> None:
    """20 bf16 and 20 f32 Adam steps of YOLOv3-416 at B=8 on one batch:
    ms a step, frames/s, first and last loss, peak memory."""
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import yolo_train_step

    spec = yolo_spec()
    imgs, targets = yolo_scenes(23, YOLO_B)
    imgs, targets = torch.from_numpy(imgs).to(dev), torch.from_numpy(targets).to(dev)
    for dt in ("bfloat16", "float32"):
        model = train_darknet(spec, dev)
        opt = make_optimizer(model.parameters(), "Adam", lr=1e-4)
        yolo_train_step(model, opt, imgs, targets, compute_dtype=dt, **YOLO_KW)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses = []
        t0 = time.perf_counter()
        for _ in range(20):
            losses.append(yolo_train_step(model, opt, imgs, targets, compute_dtype=dt,
                                          **YOLO_KW)[0])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 20
        losses = torch.stack(losses).cpu()
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        log(f"yolo train {dt} B={YOLO_B}: 20 steps, {ms!r} ms/step = "
            f"{YOLO_B * 1e3 / ms!r} frames/s, loss {float(losses[0])!r} → "
            f"{float(losses[-1])!r}, max_memory_allocated {peak!r} MiB on {smi}")
        check(bool(torch.isfinite(losses).all()), f"yolo train {dt}: non-finite loss")
        del model, opt


def clip_loop(grads, max_norm: float) -> None:
    """The gradient clip one tensor at a time (a yardstick): four
    launches a tensor (divide, multiply, select, copy)."""
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import global_norm

    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def phase_clip_cost(dev, smi) -> None:
    """``train/optim.clip_by_global_norm`` (two batched launches) against
    :func:`clip_loop` on YOLOv3-416's 80-class gradients, as
    ``tools/train_to_map.py`` clips them at 10.0: the two forms' results
    compared, the clip alone (host clock, synchronised), and the bf16 B=32
    step with each, in the order batched, loop, loop, batched."""
    from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec
    from mit_driverless_cv_traininginfra_tpu_torch.data.synthetic import yolo_batch
    from mit_driverless_cv_traininginfra_tpu_torch.train import optim
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import yolo_train_step

    spec = flagship_spec(SIZE)
    imgs, targets = yolo_batch(np.random.default_rng(31), 32, size=SIZE, max_cones=8,
                               min_h=18, max_h=120, max_overlap=0.1)
    imgs, targets = torch.from_numpy(imgs).to(dev), torch.from_numpy(targets).to(dev)
    model = train_darknet(spec, dev)
    opt = optim.make_optimizer(model.parameters(), "Adam", lr=1e-4, grad_clip=10.0)
    yolo_train_step(model, opt, imgs, targets, compute_dtype="bfloat16")
    grads = [p.grad for p in model.parameters()]
    a, b = [g.clone() * 1e3 for g in grads], [g.clone() * 1e3 for g in grads]
    optim.clip_by_global_norm(a, 10.0)
    clip_loop(b, 10.0)
    same = all(torch.equal(x, y) for x, y in zip(a, b))

    def host_ms(fn, n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    forms = {"batched": optim.clip_by_global_norm, "loop": clip_loop}
    clip = {k: [] for k in forms}
    step = {k: [] for k in forms}
    for name in ("batched", "loop", "loop", "batched"):
        clip[name].append(host_ms(lambda: forms[name](a, 10.0), 50))
        optim.clip_by_global_norm = forms[name]  # what optimizer_step calls
        try:
            step[name].append(host_ms(lambda: yolo_train_step(
                model, opt, imgs, targets, compute_dtype="bfloat16"), 10))
        finally:
            optim.clip_by_global_norm = forms["batched"]
    log(f"gradient clip on {len(grads)} YOLOv3-416 gradients: batched equal to the loop "
        f"{same}; the clip alone, ms (host clock) {clip}; the bf16 B=32 step, ms {step} "
        f"on {smi}")
    check(all(math.isfinite(v) for v in clip["batched"] + step["batched"]),
          "clip: a time is not finite")
    del model, opt, grads, a, b


def trees_equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for _, x, y in tree_pairs(a, b))


def phase_yolo_driver(dev, smi) -> None:
    """``train_yolo`` for 2 epochs over in-memory synthetic loaders, its
    ``.weights`` and full state reloaded and compared, a resume; then 200
    bf16 steps on a pool of 256 scenes (the loss must fall), ``validate_map``
    on held-out scenes, and the trained weights BN-folded into ``Darknet``
    through the f32 two-stage pipeline on the card and on the CPU (masks
    equal)."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
        two_stage_pipeline,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, rektnet
    from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import (
        load_yolo_state,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import yolo_train_step
    from mit_driverless_cv_traininginfra_tpu_torch.train.yolo_driver import (
        train_yolo,
        validate_map,
    )

    spec = yolo_spec()

    def loader(seed: int, n_batches: int):
        imgs, targets = yolo_scenes(seed, n_batches * YOLO_B)
        return [([f"s{seed}_{i}" for i in range(YOLO_B)], imgs[i:i + YOLO_B],
                 targets[i:i + YOLO_B]) for i in range(0, len(imgs), YOLO_B)]

    train, val = loader(30, 2), loader(31, 1)
    model = train_darknet(spec, dev, seed=1)
    opt = make_optimizer(model.parameters(), "Adam", lr=5e-4)
    # flagship_spec's cfg text is config/cfg_factory.yolov3_cfg's
    kw = dict(device=dev, lr=5e-4, gamma=0.95, checkpoint_interval=1,
              val_tolerance=99, min_epochs=3, mixed_precision=True, model_cfg="yolov3.cfg")
    with tempfile.TemporaryDirectory() as tmp:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            best = train_yolo(model, opt, train, val, output_path=tmp, num_epochs=2,
                              log_dir=tmp, **kw)
        lines = text.getvalue().splitlines()
        for line in lines:
            if line.startswith(("train Epoch: 2, Batch: 2", "Average Validation", "mAP:")):
                log(f"yolo driver: {line}")
        params, state = model.trees()
        p0, s0 = darknet.init_params(spec, torch.Generator().manual_seed(9))
        # the file holds the one-class heads it was written with (the cfg's
        # start_weights_dim names a COCO file's 255 filters)
        wp, ws, _ = darknet.load_darknet_weights(spec, p0, s0, f"{tmp}/2.weights",
                                                 start_weights_dim=())
        same_weights = trees_equal(params, wp) and trees_equal(state, ws)
        model2 = train_darknet(spec, dev, seed=2)
        opt2 = make_optimizer(model2.parameters(), "Adam", lr=1.0)
        step, epoch = load_yolo_state(f"{tmp}/state_latest.pt", model2, opt2)
        same_model = all(torch.equal(v, model2.state_dict()[k])
                         for k, v in model.state_dict().items())
        s1, s2 = opt.state_dict(), opt2.state_dict()
        same_opt = (s1["param_groups"][0]["lr"] == s2["param_groups"][0]["lr"] and all(
            torch.equal(s1["state"][i][k].cpu(), s2["state"][i][k].cpu())
            for i in s1["state"] for k in ("exp_avg", "exp_avg_sq", "step")))
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            train_yolo(model2, opt2, train, val, output_path=tmp, num_epochs=3,
                       resume=True, log_dir=tmp, **kw)
        resumed = text.getvalue()
        resumed_ok = ("at epoch 2" in resumed and "train Epoch: 3," in resumed
                      and "train Epoch: 2," not in resumed)
    log(f"yolo driver: 2 epochs, best validation loss {best!r}; 2.weights reloaded "
        f"equal {same_weights}; state_latest.pt (step {step}, epoch {epoch}): model "
        f"equal {same_model}, Adam state equal {same_opt}; resume runs epoch 3 only "
        f"{resumed_ok}")
    check(math.isfinite(best) and epoch == 2 and step == 4,
          "yolo driver: the loop did not run its two epochs")
    check(same_weights and same_model and same_opt,
          "yolo driver: a reloaded checkpoint differs")
    check(resumed_ok, "yolo driver: the resume did not go on at epoch 3")

    # a short synthetic training run, as bench.py's _train_synthetic
    pool_i, pool_t = yolo_scenes(32, 256)
    pool_i, pool_t = torch.from_numpy(pool_i).to(dev), torch.from_numpy(pool_t).to(dev)
    model = train_darknet(spec, dev, seed=0)
    opt = make_optimizer(model.parameters(), "Adam", lr=5e-4)
    rng = np.random.default_rng(33)
    losses = []
    t0 = time.perf_counter()
    for _ in range(200):
        idx = torch.from_numpy(rng.integers(0, 256, YOLO_B)).to(dev)
        losses.append(yolo_train_step(model, opt, pool_i[idx], pool_t[idx],
                                      compute_dtype="bfloat16", **YOLO_KW)[0])
    losses = torch.stack(losses).cpu()
    secs = time.perf_counter() - t0
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    log(f"yolo synthetic training: 200 bf16 steps B={YOLO_B} in {secs:.2f} s; loss "
        f"every 25 steps {[round(float(x), 4) for x in losses[::25]]}; mean of the first "
        f"10 {first!r}, of the last 10 {last!r} on {smi}")
    check(bool(torch.isfinite(losses).all()) and last < first,
          "yolo synthetic training: the loss did not fall")
    held_out = loader(34, 4)
    yolo = darknet.Darknet(spec, model.folded()).eval()
    frames = torch.from_numpy(held_out[0][1]).to(dev)
    with torch.inference_mode():
        thresh = pick_conf_thresh(yolo.detections(frames, with_classes=False), MAX_DET)
        conf = torch.cat([model.detections(torch.from_numpy(b[1]).to(dev))[..., 4]
                          for b in held_out])
    # validate_map at the cfg's conf_thresh, then at the served threshold
    # picked below (bench.py's operating point)
    for t in (spec.net.conf_thresh, thresh):
        model.spec = dataclasses.replace(spec, net=dataclasses.replace(spec.net,
                                                                       conf_thresh=t))
        with contextlib.redirect_stdout(io.StringIO()):
            mAP, mR, mP, s_img = validate_map(data_loader=held_out, model=model,
                                              device=dev)
        per_frame = float((conf > t).sum(1).float().mean())
        log(f"yolo validate_map on 32 held-out scenes at conf {t!r}: mAP {mAP!r} "
            f"recall {mR!r} precision {mP!r}, {s_img!r} s a frame; {per_frame!r} "
            f"candidates a frame over the threshold")
    model.spec = spec

    # the trained weights served: BN folded, the f32 two-stage pipeline
    rp, rs = rekt_trees()
    rekt = rektnet.RektNet(rektnet.fold_bn(rp, rs)).to(dev).eval()
    kw = dict(conf_thresh=thresh, max_det=MAX_DET, crop_capacity=64)
    out = two_stage_pipeline(yolo, rekt, frames, **kw)
    ref = two_stage_pipeline(yolo.to("cpu"), rekt.to("cpu"), frames.cpu(), **kw)
    mask_eq = torch.equal(out.mask.cpu(), ref.mask)
    m = ref.mask
    errs = {k: max_abs(getattr(out, k).cpu()[m], getattr(ref, k)[m])
            for k in ("boxes", "scores", "keypoints")}
    log(f"yolo trained weights, f32 pipeline card vs CPU (B={YOLO_B}): conf_thresh "
        f"{thresh!r}, detections {int(m.sum())} ({int(m.sum()) / YOLO_B!r} a frame), "
        f"masks_equal={mask_eq}, max abs {errs}")
    check(mask_eq, "yolo trained weights: detection masks differ card vs CPU")
    check(int(m.sum()) > 0, "yolo trained weights: no detection")


# ---------------------------------------------------------------------------
# phase 11: YOLO training from disk
# ---------------------------------------------------------------------------

# scenes of 4 × 3 cone_scene tiles at two resolutions, each larger than one
# 800² patch; the higher one has bigger cones, as a closer camera would
DISK_RES = ((960, 1280, 320, 10, 85), (1200, 1600, 400, 12, 106))  # H, W, tile, cone h
DISK_SCENES = 48
DISK_B = 8
DISK_CFG = "model_cfg/yolo_baseline.cfg"  # YOLOv3, 80 classes, 800², as shipped
DISK_POOL = 64  # samples of the --preload_device pool
DISK_AUGS = ["--augment_affine", "--augment_hsv", "--augment_lr_flip", "--data_aug",
             "--augment_noise", "--augment_blur", "--augment_contrast", "--augment_sharpen"]


def render_disk_dataset(root: str) -> str:
    """DISK_SCENES cone scenes, half at each of DISK_RES, each from its own
    seed, written as .npy and PNG files; ``all.csv`` names the PNGs when the
    native core decodes them here, else the .npy files. Returns the CSV."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from mit_driverless_cv_traininginfra_tpu_torch.data import decode, encode, synthetic
    from mit_driverless_cv_traininginfra_tpu_torch.data.yolo_csv import (
        YoloCsvRow,
        write_yolo_csv,
    )

    def render(k: int):
        h, w, tile, lo, hi = DISK_RES[k % 2]
        rng = np.random.default_rng(1000 + k)
        img = np.zeros((h, w, 3), np.float32)
        boxes = []
        for y0 in range(0, h, tile):
            for x0 in range(0, w, tile):
                t, b = synthetic.cone_scene(rng, size=tile, min_h=lo, max_h=hi)
                img[y0:y0 + tile, x0:x0 + tile] = t
                boxes += [[x1 + x0, y1 + y0, y2 - y1, x2 - x1] for x1, y1, x2, y2 in b]
        rgb = (img * 255).round().astype(np.uint8)
        np.save(f"{root}/scene_{k:03d}.npy", rgb)
        with open(f"{root}/scene_{k:03d}.png", "wb") as f:
            f.write(encode.encode_png(rgb))
        return w, h, np.asarray(boxes, np.float32)

    with ThreadPoolExecutor(os.cpu_count()) as ex:
        scenes = list(ex.map(render, range(DISK_SCENES)))
    png = decode.native_core() is not None
    if png:  # the PNG route: the core's decode is the array written
        check(np.array_equal(decode.read_rgb(f"{root}/scene_000.png"),
                             np.load(f"{root}/scene_000.npy")),
              "yolo disk: the native core decoded another image than was written")
    ext = "png" if png else "npy"
    log(f"yolo disk: {DISK_SCENES} scenes at {[r[:2] for r in DISK_RES]} (H, W), "
        f"{sum(len(b) for _, _, b in scenes)} cones; decode route "
        f"{'native core, PNG' if png else '.npy (the native core does not build here)'}")
    rows = [YoloCsvRow(f"scene_{k:03d}.{ext}", w, h, 1.0, b)
            for k, (w, h, b) in enumerate(scenes)]
    write_yolo_csv(f"{root}/all.csv", rows)
    return f"{root}/all.csv"


def run_cli(main, argv, what: str) -> str:
    """``main(argv)`` with its standard output captured; it must return 0."""
    import contextlib
    import io

    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = main(argv)
    check(rc == 0, f"{what}: exit code {rc}")
    log(f"{what}: {time.perf_counter() - t0:.1f} s")
    return text.getvalue()


def train_lines(text: str):
    """(epoch, batch, Total) of each ``train Epoch`` log line."""
    rows = re.findall(r"^train Epoch: (\d+), Batch: (\d+)/\d+, Total:\s+([^,\s]+)", text,
                      re.M)
    return [(int(e), int(b), float(t)) for e, b, t in rows]


def log_run(what: str, text: str) -> None:
    for line in text.splitlines():
        if line.startswith(("Num train", "Num validate", "Device pool", "Resumed",
                            "Average Validation", "mAP:")):
            log(f"{what}: {line}")
    lines = train_lines(text)
    check(all(math.isfinite(t) for _, _, t in lines), f"{what}: a non-finite loss")
    if lines:
        log(f"{what}: {len(lines)} train steps, Total first {lines[0][2]!r} last "
            f"{lines[-1][2]!r}")


def feed_rate(dataset, workers: int, n: int) -> float:
    """Items a second of ``dataset`` through ``DataLoader`` at ``workers``
    threads, over the first n items (batches of DISK_B)."""
    from mit_driverless_cv_traininginfra_tpu_torch.data.loader import DataLoader

    sub = type("Sub", (), {"__len__": lambda self: n,
                           "__getitem__": lambda self, i: dataset[i]})()
    t0 = time.perf_counter()
    for _ in DataLoader(sub, DISK_B, shuffle=False, num_workers=workers):
        pass
    return n / (time.perf_counter() - t0)


def disk_step_times(spec, dev, smi) -> None:
    """The 800² step at B=DISK_B on the cfg's model: bf16 and f32 ms a step,
    and the device-aug step (flip, jitter, noise on the card) beside the
    plain bf16 step; frames/s and peak memory."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops.device_aug import sample_draws
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import (
        yolo_train_step,
        yolo_train_step_device_aug,
    )

    from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic

    size = spec.net.width
    imgs, targets = synthetic.yolo_batch(np.random.default_rng(40), DISK_B, size,
                                         min_h=10, max_h=110)
    imgs, targets = torch.from_numpy(imgs).to(dev), torch.from_numpy(targets).to(dev)
    px = torch.from_numpy(pixel_corners(targets.cpu().numpy(), size)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(41)
    for name, dt, aug in (("bf16", "bfloat16", False), ("bf16 device-aug", "bfloat16", True),
                          ("f32", "float32", False)):
        model = train_darknet(spec, dev)
        opt = make_optimizer(model.parameters(), "Adam", lr=1e-4)

        def step():
            if aug:
                draws = sample_draws(gen, *imgs.shape, noise=True)
                return yolo_train_step_device_aug(model, opt, imgs, px, draws,
                                                  compute_dtype=dt, **YOLO_KW)[0]
            return yolo_train_step(model, opt, imgs, targets, compute_dtype=dt, **YOLO_KW)[0]

        step()
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        losses = torch.stack([step() for _ in range(10)]).cpu()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e2
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        log(f"yolo disk step {size}² {name} B={DISK_B}: {ms!r} ms/step = "
            f"{DISK_B * 1e3 / ms!r} frames/s, max_memory_allocated {peak!r} MiB on {smi}")
        check(bool(torch.isfinite(losses).all()), f"yolo disk step {name}: non-finite loss")
        del model, opt


def phase_yolo_disk(dev, smi, root: str) -> dict:
    """YOLO training from disk at the repository's own training cfg
    (``model_cfg/yolo_baseline.cfg``: YOLOv3, 80 classes, 800²): cone scenes
    written to disk, ``cli/kmeans_csvs`` → CSVs with 9 anchors and a scale
    per resolution, then ``cli/yolo_train`` (every host augmentation, mixed
    precision ``auto``, a loader thread per core) for 2 epochs, a resume
    for a third, an ``--evaluate`` run, and a ``--device_aug
    --preload_device`` epoch; the ``.weights`` and state files reloaded
    equal; the host feed rate beside the step's; the device-aug step card
    vs CPU. Works in ``root``; returns the trained run's ``cfg``,
    ``weights`` (epoch 3) and ``frames`` (two 1280×960 scenes as .npy)."""
    import contextlib
    import os

    from mit_driverless_cv_traininginfra_tpu_torch.cli import kmeans_csvs, yolo_train
    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
        load_network_spec,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.data.yolo_csv import read_yolo_csv
    from mit_driverless_cv_traininginfra_tpu_torch.data.yolo_dataset import (
        ImageLabelDataset,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet
    from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import (
        load_yolo_state,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer

    cores = os.cpu_count()
    cwd = os.getcwd()
    cfg_src = os.path.join(os.path.dirname(os.path.abspath(__file__)), DISK_CFG)
    timings = {}
    # as `yolo_train` runs for a user: the serving phases turned cuDNN's
    # autotuner on, which would time each new 800² shape here
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    with contextlib.nullcontext(root) as tmp:
        t0 = time.perf_counter()
        all_csv = render_disk_dataset(tmp)
        timings["render"] = time.perf_counter() - t0
        run_cli(kmeans_csvs.main, ["--input_csvs", all_csv, "--dataset_path", tmp,
                                   "--output_path", f"{tmp}/csvs", "--split_up", "36-12-0",
                                   "--no_if_plot"], "yolo disk kmeans_csvs")
        table = read_yolo_csv(f"{tmp}/csvs/train.csv")
        scales = {(r.width, r.height): r.scale for r in read_yolo_csv(f"{tmp}/csvs/all.csv").rows}
        text = open(cfg_src).read()
        text = re.sub(r"^train_uri=.*$", f"train_uri={tmp}/csvs/train.csv", text, flags=re.M)
        text = re.sub(r"^validate_uri=.*$", f"validate_uri={tmp}/csvs/validate.csv", text,
                      flags=re.M)
        cfg = f"{tmp}/yolo_baseline.cfg"
        with open(cfg, "w") as f:
            f.write(text)
        spec = load_network_spec(cfg)
        log(f"yolo disk anchors (h, w) {table.anchors}; scale by (W, H) {scales}; "
            f"cfg {spec.net.width}x{spec.net.height}, {spec.net.num_classes} classes")
        check(len(table.anchors) == 9 and [tuple(a) for a in spec.anchors] == table.anchors,
              "yolo disk: the cfg does not read train.csv's 9 anchors")
        check(sorted(scales) == sorted((w, h) for h, w, *_ in DISK_RES),
              "yolo disk: not one scale per resolution")

        # the host's feed rate beside the step's
        ds = ImageLabelDataset(f"{tmp}/csvs/train.csv", tmp, spec.net.width, spec.net.height,
                               augment_affine=True, augment_hsv=True, lr_flip=True,
                               data_aug=True, blur=True, noise=True, contrast=True,
                               sharpen=True)
        ds.set_epoch(1)
        t0 = time.perf_counter()
        one, every = feed_rate(ds, 1, DISK_B), feed_rate(ds, cores, 6 * DISK_B)
        timings["feed"] = time.perf_counter() - t0
        log(f"yolo disk host feed (ImageLabelDataset, every host augmentation, "
            f"{spec.net.width}² patches): {one!r} items/s at 1 worker, {every!r} at "
            f"{cores} workers ({len(ds)} items an epoch) on {smi}")
        t0 = time.perf_counter()
        disk_step_times(spec, dev, smi)
        timings["steps"] = time.perf_counter() - t0

        os.chdir(tmp)  # the CLI writes logs/ where it runs
        try:
            base = ["--model_cfg", cfg, "--dataset_path", tmp, "--batch_size", str(DISK_B),
                    "--num_workers", str(cores), "--lr", "0.0005"]
            out = f"{tmp}/run"
            t0 = time.perf_counter()
            runs = {"2 epochs": run_cli(yolo_train.main, base + DISK_AUGS + [
                "--num_epochs", "2", "--output_path", out], "yolo disk yolo_train 2 epochs")}
            timings["train"] = time.perf_counter() - t0
            params, state = darknet.init_params(spec, torch.Generator().manual_seed(3))
            wp, ws, _ = darknet.load_darknet_weights(spec, params, state, f"{out}/2.weights")
            model = darknet.TrainDarknet(spec, params, state).to(dev)
            opt = make_optimizer(model.parameters(), "Adam", lr=1.0)
            step, epoch = load_yolo_state(f"{out}/state_latest.pt", model, opt)
            lp, ls = model.trees()
            same = trees_equal(wp, lp) and trees_equal(ws, ls)
            log(f"yolo disk: 2.weights and state_latest.pt (step {step}, epoch {epoch}) "
                f"reloaded equal {same}")
            check(same and epoch == 2 and step == 2 * -(-len(ds) // DISK_B),
                  "yolo disk: the .weights and the state file differ")
            del model, opt
            t0 = time.perf_counter()
            runs["resume"] = run_cli(yolo_train.main, base + DISK_AUGS + [
                "--num_epochs", "3", "--output_path", out, "--resume"],
                "yolo disk yolo_train --resume")
            timings["resume"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            runs["evaluate"] = run_cli(yolo_train.main, base + [
                "--evaluate", "--weights_path", f"{out}/3.weights", "--output_path",
                f"{tmp}/eval"], "yolo disk yolo_train --evaluate")
            timings["evaluate"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            runs["device_aug"] = run_cli(yolo_train.main, base + DISK_AUGS + [
                "--num_epochs", "1", "--device_aug", "--preload_device", "--preload_num",
                str(DISK_POOL), "--output_path", f"{tmp}/pool"],
                "yolo disk yolo_train --device_aug")
            timings["device_aug"] = time.perf_counter() - t0
            logged = open(f"logs/{os.path.basename(cfg)[:-4]}.log").read()
        finally:
            os.chdir(cwd)
            torch.backends.cudnn.benchmark = benchmark
    for name, text in runs.items():
        log_run(f"yolo disk {name}", text)
        check(text.count("mAP: ") >= 1, f"yolo disk {name}: no mAP line")
    epochs = {name: sorted({e for e, _, _ in train_lines(t)}) for name, t in runs.items()}
    log(f"yolo disk epochs trained by run: {epochs}")
    check(epochs["2 epochs"] == [1, 2] and epochs["resume"] == [3]
          and "at epoch 2" in runs["resume"], "yolo disk: the resume did not go on at epoch 3")
    check(epochs["evaluate"] == [] and "Model in train mode" not in runs["evaluate"],
          "yolo disk: --evaluate trained")
    check(f"Device pool: {DISK_POOL} samples" in runs["device_aug"]
          and epochs["device_aug"] == [1],
          "yolo disk: the device-aug epoch did not run from the pool")
    check("mAP: " in logged, "yolo disk: the CLI's log file holds no mAP line")
    t0 = time.perf_counter()
    phase_yolo_train_agree(dev, device_aug=True)
    timings["device_aug_agree"] = time.perf_counter() - t0
    log(f"yolo disk seconds by part: "
        f"{ {k: round(v, 1) for k, v in timings.items()} } on {smi}")
    return {"cfg": cfg, "weights": f"{root}/run/3.weights",
            "frames": [f"{root}/scene_{k:03d}.npy" for k in (0, 2)]}


def phase_yolo(dev, smi, root: str) -> dict:
    """The four YOLO training phases, each timed; no K1-K5 wrapper may
    launch while YOLO trains (its path is cuDNN and plain PyTorch).
    Returns ``phase_yolo_disk``'s trained run (in ``root``)."""
    before = training_launches()
    for name, fn in (("yolo_targets", lambda: phase_yolo_targets(dev)),
                     ("yolo_train_agree", lambda: phase_yolo_train_agree(dev)),
                     ("yolo_train_card", lambda: phase_yolo_train_card(dev, smi)),
                     ("clip_cost", lambda: phase_clip_cost(dev, smi))):
        t0 = time.perf_counter()
        fn()
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    after = training_launches()
    log(f"K1-K5 launches while YOLO trained: {after} (before: {before})")
    check(after == before, "a K1-K5 kernel launched on the YOLO training path")
    t0 = time.perf_counter()
    phase_yolo_driver(dev, smi)
    log(f"phase yolo_driver: {time.perf_counter() - t0:.1f} s")
    before = training_launches()
    t0 = time.perf_counter()
    run = phase_yolo_disk(dev, smi, root)
    log(f"phase yolo_disk: {time.perf_counter() - t0:.1f} s on {smi}")
    after = training_launches()
    log(f"K1-K5 launches while YOLO trained from disk: {after} (before: {before})")
    check(after == before, "a K1-K5 kernel launched on the YOLO disk training path")
    return run


# ---------------------------------------------------------------------------
# phase 12-13: RektNet from disk, the evaluation CLIs and tools
# ---------------------------------------------------------------------------

RK_TRAIN, RK_VAL = 512, 64  # crops of 64-160 px, written as .npy
RK_B = 32
# cli/pipeline card vs CPU, f32, model space: boxes and keypoints over the
# box's larger side (the 3-epoch detector's boxes reach ~5e4 px), scores;
# about 10x the readings on an H100 (7.43e-6, 4.20e-6, 1.26e-4)
PIPELINE_BOUNDS = {"box_rel": 1e-4, "score": 5e-5, "kpt_rel": 1e-3}


def port_tool(name: str):
    """A script of the port's ``tools/`` as a module."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "mit_driverless_cv_traininginfra_tpu_torch", "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_tools_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def k2_counts() -> dict:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
        fused_softargmax,
        softargmax_bwd,
    )

    return {"softargmax": fused_softargmax.launches, "softargmax_bwd": softargmax_bwd.launches}


def zero_counts() -> None:
    from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import softargmax_bwd

    for fn in list(kernel_wrappers().values()) + [softargmax_bwd]:
        fn.launches = 0


def rektnet_feed(dev, root: str, smi: str, ratio: float) -> None:
    """``ConeDataset`` items a second (host heatmaps, as the CLI trains)
    through ``DataLoader`` at 1 worker and at every core, beside the
    B=32 bf16 step's crops a second on the card."""
    import contextlib
    import io
    import os

    from mit_driverless_cv_traininginfra_tpu_torch.data.loader import DataLoader
    from mit_driverless_cv_traininginfra_tpu_torch.data.rektnet_data import (
        ConeDataset,
        collate_cones,
        load_train_csv_dataset,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import KeypointNet
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import rektnet_train_step

    cores = os.cpu_count()
    with contextlib.redirect_stdout(io.StringIO()):
        ti, tl, _, _ = load_train_csv_dataset(f"{root}/rektnet_label.csv", ratio,
                                              dataset_path=f"{root}/images")
    rates = {}
    for workers, n in ((1, 64), (cores, 256)):
        ds = ConeDataset(ti[:n], tl[:n], f"{root}/images")
        t0 = time.perf_counter()
        batches = list(DataLoader(ds, RK_B, shuffle=False, num_workers=workers,
                                  collate=collate_cones))
        rates[workers] = n / (time.perf_counter() - t0)
    imgs, hms, pts = (torch.from_numpy(a).to(dev) for a in batches[0][:3])
    model = KeypointNet(*rekt_trees(4)).to(dev)
    opt = make_optimizer(model.parameters(), "Adam", lr=1e-3)
    kw = dict(loss_type="l1_softargmax", include_geo=True, compute_dtype="bfloat16")
    rektnet_train_step(model, opt, imgs, hms, pts, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        rektnet_train_step(model, opt, imgs, hms, pts, **kw)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 100
    log(f"rektnet disk host feed (ConeDataset, host heatmaps, .npy crops of 64-160 px): "
        f"{rates[1]!r} items/s at 1 worker, {rates[cores]!r} at {cores} workers; the B={RK_B} "
        f"bf16 step {step_ms!r} ms = {RK_B * 1e3 / step_ms!r} crops/s on {smi}")


def phase_rektnet_disk(dev, smi, root: str) -> str:
    """RektNet training from disk at full width (net_size 16, 80², 7
    keypoints, B=32): the port's dataset tool writes 512 training and 64
    validation crops as .npy; the host feed beside the step; ``cli/
    rektnet_train`` for 2 epochs on the card (mixed precision ``auto``),
    its ``.pt`` reloaded equal with the Adam state of 2 epochs, K2's
    forward and backward counted over the run; a ``--resume`` from that
    ``.pt`` that runs epoch 3 only;
    ``--evaluate_mode``; ``--vis_upload_data`` on 8 crops (JPEG markers).
    Returns the trained ``.pt``."""
    import glob
    import json
    import os

    from mit_driverless_cv_traininginfra_tpu_torch.cli import rektnet_train
    from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import KeypointNet
    from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import load_rektnet_pt
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer

    rk = f"{root}/rk"
    timings = {}
    t0 = time.perf_counter()
    run_cli(port_tool("make_synth_dataset").main,
            ["--out", rk, "--family", "rektnet", "--train", str(RK_TRAIN), "--val", str(RK_VAL),
             "--format", "npy"], "rektnet disk make_synth_dataset")
    timings["render"] = time.perf_counter() - t0
    ratio = json.load(open(f"{rk}/meta.json"))["validation_ratio"]
    t0 = time.perf_counter()
    rektnet_feed(dev, rk, smi, ratio)
    timings["feed"] = time.perf_counter() - t0

    cwd = os.getcwd()
    os.chdir(root)  # the CLI writes logs/ where it runs
    try:
        base = ["--train_dataset_uri", f"{rk}/rektnet_label.csv", "--dataset_path",
                f"{rk}/images", "--validation_ratio", repr(ratio), "--batch_size", str(RK_B),
                "--lr", "1e-3", "--checkpoint_interval", "2", "--num_workers", "1"]
        out = f"{rk}/run"
        zero_counts()
        t0 = time.perf_counter()
        text = run_cli(rektnet_train.main, base + ["--num_epochs", "2", "--output_path", out],
                       "rektnet disk rektnet_train 2 epochs")
        timings["train"] = time.perf_counter() - t0
        counts = k2_counts()
        steps = 2 * -(-(RK_TRAIN) // RK_B)
        evals = 3 * -(-RK_VAL // RK_B)  # two validations and the closing distances
        log(f"rektnet disk: K2 launches over the 2 epochs {counts} ({steps} train steps, "
            f"{evals} eval batches)")
        check(counts == {"softargmax": steps + evals, "softargmax_bwd": steps},
              "rektnet disk: K2's launches do not follow the steps")
        losses = re.findall(r"Training: MSE/Geometric/Total Loss: \S+/\S+/(\S+)", text)
        log(f"rektnet disk: training Total by epoch {losses}; "
            + "; ".join(l.strip() for l in text.splitlines() if "Validation:" in l
                        or "Total distance" in l))
        check(len(losses) == 2 and all(math.isfinite(float(v)) for v in losses),
              "rektnet disk: the two epochs did not train")
        pt = glob.glob(f"{out}/1_loss_*.pt")
        check(len(pt) == 1, f"rektnet disk: expected one .pt, got {pt}")
        a = KeypointNet(*rekt_trees(5))
        opt = make_optimizer(a.parameters(), "Adam", lr=1.0)
        epoch = load_rektnet_pt(pt[0], a, opt)
        saved = torch.load(pt[0], map_location="cpu", weights_only=True)["model"]
        same = all(torch.equal(v, saved[k]) for k, v in a.state_dict().items())
        adam_steps = {int(st["step"]) for st in opt.state.values()}
        lr = opt.param_groups[0]["lr"]
        log(f"rektnet disk: {os.path.basename(pt[0])} (epoch {epoch}) reloaded equal {same}; "
            f"Adam steps {adam_steps}, lr {lr!r}")
        check(same and epoch == 1 and adam_steps == {steps}
              and abs(lr - 1e-3 * 0.999 ** 2) <= 1e-15,
              "rektnet disk: the .pt does not hold the model and Adam of 2 epochs")
        t0 = time.perf_counter()
        text = run_cli(rektnet_train.main, base + ["--num_epochs", "3", "--output_path", out,
                                                   "--resume"], "rektnet disk --resume")
        timings["resume"] = time.perf_counter() - t0
        check("at epoch 2" in text and re.findall(r"^EPOCH (\d+)", text, re.M) == ["2"],
              "rektnet disk: the resume did not run epoch 3 only")
        t0 = time.perf_counter()
        text = run_cli(rektnet_train.main, base + ["--evaluate_mode", "--checkpoint_path",
                                                   pt[0], "--output_path", f"{rk}/eval"],
                       "rektnet disk --evaluate_mode")
        timings["evaluate"] = time.perf_counter() - t0
        check("EPOCH" not in text and "Total distance error is" in text,
              "rektnet disk: --evaluate_mode trained")
        with open(f"{rk}/rektnet_label.csv") as f:
            lines = f.read().splitlines()
        with open(f"{rk}/vis8.csv", "w") as f:  # the header, 2 validation and 8 training rows
            f.write("\n".join(lines[:1] + lines[1:3] + lines[1 + RK_VAL:9 + RK_VAL]) + "\n")
        t0 = time.perf_counter()
        text = run_cli(rektnet_train.main, [
            "--train_dataset_uri", f"{rk}/vis8.csv", "--dataset_path", f"{rk}/images",
            "--validation_ratio", "0.25", "--vis_upload_data", "--output_path", f"{rk}/vis"],
            "rektnet disk --vis_upload_data")
        timings["vis"] = time.perf_counter() - t0
        files = sorted(glob.glob(f"{rk}/vis/visualization/*"))
        good = [open(p, "rb").read() for p in files]
        good = sum(d[:2] == b"\xff\xd8" and d[-2:] == b"\xff\xd9" for d in good)
        log(f"rektnet disk --vis_upload_data: {len(files)} renders, {good} well-formed JPEGs")
        check("visualized 8 dataset images" in text and len(files) == good == 8,
              "rektnet disk: the dataset render is not 8 JPEGs")
    finally:
        os.chdir(cwd)
    log(f"rektnet disk seconds by part: "
        f"{ {k: round(v, 1) for k, v in timings.items()} } on {smi}")
    return pt[0]


def phase_eval_cli(dev, smi, root: str, yolo_run: dict, rekt_pt: str) -> None:
    """The user-facing evaluation entry points on the card, each against a
    ``--device cpu`` run where it has one: ``cli/rektnet_detect`` with the
    trained ``.pt`` (keypoints within 1e-4; K2 once), ``cli/pipeline`` on
    two 1280×960 frames with ``phase_yolo_disk``'s trained ``.weights`` at
    ``model_cfg/yolo_baseline.cfg`` (K1, K2, K3 once a frame; at a
    gap-picked threshold the masks equal the CPU's, and boxes, scores and
    keypoints agree within ``PIPELINE_BOUNDS``),
    ``cli/yolo_detect`` on one frame, ``cli/yolo_validate`` on the
    validation CSV, and the tools ``eval_weights --n 32`` (at the trained
    cfg and that threshold: every mAP, recall and precision finite) and
    ``eval_rektnet_weights --n 64 --csv`` (its f32 L2 finite)."""
    import ast
    import json

    from mit_driverless_cv_traininginfra_tpu_torch.cli import (
        pipeline,
        rektnet_detect,
        yolo_detect,
        yolo_validate,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
        load_network_spec,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.data.decode import read_rgb
    from mit_driverless_cv_traininginfra_tpu_torch.infer import detect
    from mit_driverless_cv_traininginfra_tpu_torch.infer import pipeline as pl
    from mit_driverless_cv_traininginfra_tpu_torch.ops.image import letterbox

    timings = {}
    rk = f"{root}/rk"
    crop = f"{rk}/images/va_00001.npy"
    pts = {}
    for name in ("card", "cpu"):
        zero_counts()
        t0 = time.perf_counter()
        text = run_cli(rektnet_detect.main, ["--model", rekt_pt, "--img", crop, "--output",
                                             f"{root}/det_{name}"]
                       + (["--device", "cpu"] if name == "cpu" else []),
                       f"rektnet_detect on the {name}")
        timings[f"rektnet_detect {name}"] = time.perf_counter() - t0
        pts[name] = np.asarray(ast.literal_eval(text.split("keypoints: ")[1].strip()))
        if name == "card":
            k2 = k2_counts()["softargmax"]
    err = float(np.abs(pts["card"] - pts["cpu"]).max())
    log(f"rektnet_detect: keypoints card vs CPU within {err!r}; K2 launches {k2}")
    check(err <= 1e-4 and k2 == 1, "rektnet_detect: card and CPU differ, or K2 did not run once")

    cfg, weights, frames = yolo_run["cfg"], yolo_run["weights"], yolo_run["frames"]
    spec, yolo = detect.load_detector(load_network_spec(cfg), weights, dev)
    frame = torch.from_numpy(read_rgb(frames[0])).to(dev).float() / 255
    boxed, _ = letterbox(frame[None], spec.net.height, spec.net.width)
    thresh = pick_conf_thresh(yolo.detections(boxed, with_classes=False), MAX_DET)
    del yolo
    runs = {}
    real = pl.two_stage_pipeline
    for name in ("card", "cpu"):
        outs = []

        def recorded(*a, **k):
            out = real(*a, **k)
            outs.append(pl.PipelineOut(*(t.cpu() for t in out)))
            return out

        pl.two_stage_pipeline = recorded
        try:
            zero_counts()
            t0 = time.perf_counter()
            for f in frames:
                run_cli(pipeline.main, ["--target_path", f, "--model_cfg", cfg, "--yolo_weights",
                                        weights, "--rektnet_weights", rekt_pt, "--conf_thres",
                                        repr(thresh), "--output_path", f"{root}/pl_{name}"]
                        + (["--device", "cpu"] if name == "cpu" else []),
                        f"pipeline on the {name}")
            timings[f"pipeline {name}"] = time.perf_counter() - t0
            if name == "card":
                counts = {k: f.launches for k, f in kernel_wrappers().items()}
        finally:
            pl.two_stage_pipeline = real
        runs[name] = outs
    masks_equal = all(torch.equal(a.mask, b.mask) for a, b in zip(runs["card"], runs["cpu"]))
    n_boxes = [int(o.mask.sum()) for o in runs["card"]]
    err = dict.fromkeys(("box", "box_rel", "score", "kpt", "kpt_rel"), 0.0)
    for a, b in zip(runs["card"], runs["cpu"]):
        m = b.mask
        if not m.any():
            continue
        # in model space; boxes and keypoints over the CPU box's larger side
        size = (b.boxes[m][..., 2:] - b.boxes[m][..., :2]).amax(-1).clamp(min=1.0)
        d_box = (a.boxes - b.boxes)[m].abs().amax(-1)
        d_kpt = (a.keypoints - b.keypoints)[m].abs().flatten(1).amax(-1)
        for key, d, rel in (("box", d_box, True), ("kpt", d_kpt, True),
                            ("score", (a.scores - b.scores)[m].abs(), False)):
            err[key] = max(err[key], float(d.max()))
            if rel:
                err[key + "_rel"] = max(err[key + "_rel"], float((d / size).max()))
    # the letterboxed input itself, card vs CPU (the resize's weights and sums)
    x_cpu = letterbox(torch.from_numpy(read_rgb(frames[0])).float()[None] / 255,
                      spec.net.height, spec.net.width)[0]
    in_err = max_abs(boxed.cpu(), x_cpu)
    log(f"pipeline at {spec.net.width}² on {len(frames)} frames of 1280×960, conf "
        f"{thresh!r}: boxes per frame {n_boxes}, masks card = CPU {masks_equal}; card vs CPU "
        f"(model space): boxes within {err['box']!r} px, {err['box_rel']!r} of the box's "
        f"size; scores within {err['score']!r}; keypoints within {err['kpt']!r} px, "
        f"{err['kpt_rel']!r} of the box's size (bounds {PIPELINE_BOUNDS}); the letterboxed "
        f"frame within {in_err!r}; launches {counts}")
    check(masks_equal and sum(n_boxes) > 0, "pipeline: the card's masks differ from the CPU's")
    check(all(err[k] <= v for k, v in PIPELINE_BOUNDS.items()),
          f"pipeline: card and CPU differ beyond {PIPELINE_BOUNDS}: {err}")
    check(counts["roi_crop"] == counts["softargmax"] == counts["nms_topk"] == len(frames),
          f"pipeline: K1-K3 did not launch once a frame: {counts}")

    t0 = time.perf_counter()
    text = run_cli(yolo_detect.main, ["--target_path", frames[0], "--model_cfg", cfg,
                                      "--weights_path", weights, "--conf_thres", repr(thresh),
                                      "--output_path", f"{root}/yd"], "yolo_detect on the card")
    timings["yolo_detect"] = time.perf_counter() - t0
    log("yolo_detect: " + " | ".join(text.strip().splitlines()))
    t0 = time.perf_counter()
    text = run_cli(yolo_validate.main, ["--model_cfg", cfg, "--weights_path", weights,
                                        "--dataset_path", root, "--num_workers", "8"],
                   "yolo_validate on the card")
    timings["yolo_validate"] = time.perf_counter() - t0
    log("yolo_validate: " + " | ".join(text.strip().splitlines()[-2:]))
    check("seconds/image: " in text and "mAP: " in text, "yolo_validate: no mAP line")
    # eval_weights at the cfg the weights were trained at (its anchors, 800²) and at the
    # pipeline's threshold: these weights score no box above the tool's default 0.8
    for name, argv in (("eval_weights", ["--weights", weights, "--n", "32", "--model_cfg",
                                         cfg, "--conf", repr(thresh)]),
                       ("eval_rektnet_weights", ["--pt", rekt_pt, "--n", "64", "--csv",
                                                 f"{rk}/rektnet_label.csv", "--images",
                                                 f"{rk}/images", "--ratio",
                                                 repr(json.load(open(f"{rk}/meta.json"))
                                                      ["validation_ratio"])])):
        t0 = time.perf_counter()
        line = run_cli(port_tool(name).main, argv, f"tools/{name}").strip().splitlines()[-1]
        timings[name] = time.perf_counter() - t0
        log(f"tools/{name}: {line} on {smi}")
        got = json.loads(line)
        keys = ([f"{m}_{t}" for t in ("f32", "int8") for m in ("map", "recall", "precision")]
                if name == "eval_weights" else ["l2_f32", "l2_int8", "disk_val_l2_f32"])
        check(all(math.isfinite(got[k]) for k in keys)
              and (name != "eval_weights" or all(0 <= got[k] <= 1 for k in keys)),
              f"tools/{name}: {keys} not all finite (and in [0, 1] for mAP, R, P)")
    log(f"eval CLI seconds by part: {({k: round(v, 1) for k, v in timings.items()})} on {smi}")


# ---------------------------------------------------------------------------
# phase 14: export, the export hooks, hyper-search and train_to_map
# ---------------------------------------------------------------------------

# the numpy evaluator's graph against the card's f32 forward, each head's
# (map's) largest difference over its largest |value| (f32 sums of up to
# 9216 terms a conv, in other orders, through 75 layers)
EXPORT_REL = 1e-4
# 150 steps each: the checks ask a finite, in-range mAP and RektNet's
# held-out L2 under half the untrained model's, not a trained model
TTM_YOLO = ["--steps", "150", "--batch", "32", "--eval-n", "64"]
TTM_REKTNET = ["--family", "rektnet", "--steps", "150"]


def onnx_vs_card(path: str, inputs: dict, want: list, what: str) -> dict:
    """Parse the exported file and run it with ``onnx_eval.run_model`` on
    the host; hold each output to ``want`` (NCHW tensors on the card)
    within ``EXPORT_REL`` of its largest |value|."""
    from mit_driverless_cv_traininginfra_tpu_torch.export import onnx_writer
    from mit_driverless_cv_traininginfra_tpu_torch.export.onnx_eval import run_model

    t0 = time.perf_counter()
    with open(path, "rb") as f:
        parsed = onnx_writer.parse_model(f.read())
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = list(run_model(parsed, inputs).values())
    t_eval = time.perf_counter() - t0
    check(len(got) == len(want), f"{what}: {len(got)} outputs, expected {len(want)}")
    rel = []
    for g, w in zip(got, want):
        w = w.float().cpu()
        check(tuple(g.shape) == tuple(w.shape), f"{what}: output {g.shape} vs {tuple(w.shape)}")
        rel.append(max_abs(torch.from_numpy(g), w) / max(float(w.abs().max()), 1e-30))
    log(f"{what}: {len(parsed['nodes'])} nodes, {len(parsed['initializers'])} initializers; "
        f"parse {t_parse:.1f} s, onnx_eval {t_eval:.1f} s; outputs {[tuple(g.shape) for g in got]}"
        f" vs the card's f32 forward within {rel!r} of each one's max |value| "
        f"(bound {EXPORT_REL})")
    check(all(r <= EXPORT_REL for r in rel), f"{what}: the exported graph differs from the "
          f"card's forward by {rel} of its outputs' range")
    return {"parse_s": t_parse, "eval_s": t_eval, "outputs": parsed["outputs"]}


def untrained_rektnet_l2(dev) -> float:
    """The mean keypoint L2 that ``tools/train_to_map.py --family rektnet``
    reports, of its model before training: the folded f32 RektNet from
    its seed (1) on its 256 held-out crops (seed 999)."""
    from mit_driverless_cv_traininginfra_tpu_torch.data.synthetic import rektnet_batch
    from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet

    crops, pts = rektnet_batch(np.random.default_rng(999), 256)
    model = rektnet.RektNet(rektnet.fold_bn(*rekt_trees(1))).to(dev).eval()
    with torch.inference_mode():
        _, got = model(torch.from_numpy(crops).to(dev))
    return float(np.linalg.norm(got.float().cpu().numpy() - pts, axis=-1).mean())


def phase_export_hyper(dev, smi, root: str, yolo_run: dict, rekt_pt: str) -> None:
    """Export, hyper-search and ``train_to_map`` on what the earlier phases
    trained, each part's seconds printed: ``cli/yolo2onnx`` on
    ``phase_yolo_disk``'s ``.weights`` (YOLOv3 at ``model_cfg/
    yolo_baseline.cfg``, 80 classes, onnx_height 320 × 800), run by the
    numpy evaluator on one seeded frame against ``TrainDarknet`` in eval
    mode, f32 on the card; ``cli/pt_to_onnx`` on ``phase_rektnet_disk``'s
    ``.pt`` against ``KeypointNet``'s logits at (1, 3, 80, 80); the hooks:
    one epoch of ``cli/rektnet_train`` whose best-model ONNX equals
    ``cli/pt_to_onnx`` of the weights it exported, byte for byte (K2 and
    K2-bwd counted), and a ``cli/yolo_train`` epoch stopped by
    ``--val_tolerance 0`` whose ONNX parses; ``cli/rektnet_hyper`` with 2
    trials of 1 epoch in a subprocess (2 completed trials, finite scores);
    both families of ``tools/train_to_map.py`` (K2 and K2-bwd launched once
    a RektNet step; none of K1-K5 in the YOLO family)."""
    import json
    import os

    from mit_driverless_cv_traininginfra_tpu_torch.cli import (
        pt_to_onnx,
        rektnet_train,
        yolo2onnx,
        yolo_train,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
        load_network_spec,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.device import full_f32
    from mit_driverless_cv_traininginfra_tpu_torch.export import onnx_writer
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, rektnet
    from mit_driverless_cv_traininginfra_tpu_torch.train import rektnet_driver
    from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import save_rektnet_pt

    full_f32(dev)
    timings = {}
    rk = f"{root}/rk"
    ex = f"{root}/export"
    os.makedirs(ex, exist_ok=True)
    cfg, weights = yolo_run["cfg"], yolo_run["weights"]

    # 1. YOLOv3 at full width through the numpy evaluator
    spec = load_network_spec(cfg)
    t0 = time.perf_counter()
    text = run_cli(yolo2onnx.main, ["--cfg_name", cfg, "--weights_name", weights,
                                    "--output", f"{ex}/yolo.onnx"], "export cli/yolo2onnx")
    timings["yolo2onnx"] = time.perf_counter() - t0
    check(text.strip() == f"wrote {ex}/yolo.onnx", f"yolo2onnx printed {text!r}")
    h, w = spec.net.onnx_height, spec.net.width
    x = np.random.default_rng(15).uniform(0, 1, (1, 3, h, w)).astype(np.float32)
    params, state, _ = darknet.load_darknet_weights(
        spec, *darknet.init_params(spec, torch.Generator().manual_seed(0)), weights)
    model = darknet.TrainDarknet(spec, params, state).to(dev).eval()
    with torch.no_grad():
        heads = [t.permute(0, 3, 1, 2) for t in model.forward_features(
            torch.from_numpy(x).to(dev).permute(0, 2, 3, 1))]
    del model
    log(f"export: YOLOv3 {spec.net.num_classes} classes at {h}x{w}, "
        f"{os.path.getsize(f'{ex}/yolo.onnx') / 2**20:.1f} MiB of ONNX")
    got = onnx_vs_card(f"{ex}/yolo.onnx", {"000_net": x}, heads, "export YOLOv3 onnx_eval")
    timings.update({"yolo_parse": got["parse_s"], "yolo_onnx_eval": got["eval_s"]})
    yolo_outputs = got["outputs"]

    # 2. RektNet
    t0 = time.perf_counter()
    run_cli(pt_to_onnx.main, ["--model", rekt_pt, "--output", f"{ex}/rekt.onnx"],
            "export cli/pt_to_onnx")
    timings["pt_to_onnx"] = time.perf_counter() - t0
    xr = np.random.default_rng(16).uniform(0, 1, (1, 3, 80, 80)).astype(np.float32)
    kp = rektnet.KeypointNet(*rektnet.load_torch_checkpoint(rekt_pt)).to(dev).eval()
    with torch.no_grad():
        logits = kp.logits(torch.from_numpy(xr).to(dev).permute(0, 2, 3, 1))
    got = onnx_vs_card(f"{ex}/rekt.onnx", {"input": xr}, [logits], "export RektNet onnx_eval")
    timings["rektnet_onnx_eval"] = got["eval_s"]

    # 3. the hooks: RektNet's best model, YOLO's early stop
    ratio = json.load(open(f"{rk}/meta.json"))["validation_ratio"]
    exported = []
    real_export = rektnet_driver.export_rektnet_onnx

    def recorded(params, state, path, **kw):
        exported.append((params, state, path))
        return real_export(params, state, path, **kw)

    cwd = os.getcwd()
    os.chdir(root)  # the CLIs write logs/ where they run
    rektnet_driver.export_rektnet_onnx = recorded
    try:
        zero_counts()
        t0 = time.perf_counter()
        text = run_cli(rektnet_train.main, [
            "--train_dataset_uri", f"{rk}/rektnet_label.csv", "--dataset_path",
            f"{rk}/images", "--validation_ratio", repr(ratio), "--batch_size", str(RK_B),
            "--lr", "1e-3", "--num_epochs", "1", "--save_checkpoints", "--num_workers", "1",
            "--output_path", f"{ex}/hook"], "export hook: cli/rektnet_train 1 epoch")
        timings["rektnet_hook"] = time.perf_counter() - t0
        counts = k2_counts()
        t0 = time.perf_counter()
        run_cli(yolo_train.main, [
            "--model_cfg", cfg, "--dataset_path", root, "--batch_size", str(DISK_B),
            "--num_workers", str(os.cpu_count()), "--lr", "0.0005", "--num_epochs", "1",
            # within min_epochs (3) a check counts as a decrease: tolerance 0
            # stops at the first check whatever its loss
            "--num_steps", "4", "--val_tolerance", "0", "--weights_path", weights,
            "--output_path", f"{ex}/yolo_hook"],
            "export hook: cli/yolo_train --val_tolerance 0")
        timings["yolo_hook"] = time.perf_counter() - t0
    finally:
        rektnet_driver.export_rektnet_onnx = real_export
        os.chdir(cwd)
    onnx = f"{ex}/hook/best_keypoints_8080.onnx"
    steps = -(-RK_TRAIN // RK_B)
    evals = 2 * -(-RK_VAL // RK_B)  # the validation and the closing distances
    log(f"export hook: K2 launches over 1 epoch of cli/rektnet_train {counts} ({steps} steps, "
        f"{evals} eval batches); {len(exported)} ONNX export(s)")
    check(counts == {"softargmax": steps + evals, "softargmax_bwd": steps},
          "export hook: K2's launches do not follow the steps")
    check(len(exported) == 1 and exported[0][2] == onnx and f"Saving ONNX model to {onnx}" in text,
          f"export hook: expected one best-model export to {onnx}, got {len(exported)}")
    best = rektnet.KeypointNet(*exported[0][:2])
    save_rektnet_pt(f"{ex}/hook_best.pt", best)
    run_cli(pt_to_onnx.main, ["--model", f"{ex}/hook_best.pt"], "export hook: cli/pt_to_onnx")
    same = open(onnx, "rb").read() == open(f"{ex}/hook_best.onnx", "rb").read()
    log(f"export hook: best_keypoints_8080.onnx = pt_to_onnx of the best weights, byte for "
        f"byte: {same}")
    check(same, "export hook: the loop's ONNX differs from pt_to_onnx of its weights")
    yolo_onnx = f"{ex}/yolo_hook/{spec.net.onnx_name(cfg)}"
    check(os.path.exists(yolo_onnx), f"export hook: no {yolo_onnx} after the early stop")
    with open(yolo_onnx, "rb") as f:
        parsed = onnx_writer.parse_model(f.read())
    log(f"export hook: yolo_train's early stop wrote {os.path.basename(yolo_onnx)}: "
        f"{len(parsed['nodes'])} nodes, outputs {[o['shape'] for o in parsed['outputs']]}")
    check(parsed["outputs"] == yolo_outputs and parsed["inputs"][0]["shape"] == [1, 3, h, w],
          "export hook: the early stop's ONNX is not the cfg's graph")

    # 4. hyper-search: a user's study of 2 trials, each its own process
    hyper = f"{root}/hyper"
    os.makedirs(hyper, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mit_driverless_cv_traininginfra_tpu_torch.cli.rektnet_hyper",
         "--num_trials", "2", "--num_epochs", "1", "--geo_loss_study", "--train_dataset_uri",
         f"{rk}/rektnet_label.csv", "--dataset_path", f"{rk}/images"],
        cwd=hyper, env=env, capture_output=True, text=True, timeout=600)
    timings["hyper"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"rektnet_hyper: exit code {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    trials = json.load(open(f"{hyper}/studies/rektnet_study.json"))["trials"]
    log("hyper: " + "; ".join(
        f"trial {t['number']} {t['state']} value {t['value']!r} params {t['params']} "
        f"{t['duration']:.1f} s" for t in trials) + f" on {smi}")
    check(len(trials) == 2 and all(t["state"] == "COMPLETE" and math.isfinite(t["value"])
                                   for t in trials),
          "rektnet_hyper: the study does not hold 2 completed trials with finite scores")

    # 5. train_to_map, both families
    tool = port_tool("train_to_map")
    lines = {}
    for name, argv in (("yolo", TTM_YOLO), ("rektnet", TTM_REKTNET)):
        zero_counts()
        before = training_launches()
        t0 = time.perf_counter()
        text = run_cli(tool.main, argv, f"train_to_map --family {name}")
        timings[f"train_to_map {name}"] = time.perf_counter() - t0
        line = text.strip().splitlines()[-1]
        log(f"train_to_map {name}: {line} on {smi}")
        got = json.loads(line)
        lines[name] = got
        check(all(math.isfinite(v) for k, v in got.items() if k != "metric"),
              f"train_to_map {name}: a value is not finite")
        if name == "yolo":
            check(all(0 <= got[k] <= 1 for k in ("map_f32_conf08", "recall_f32",
                                                 "precision_f32", "map_int8_conf08")),
                  "train_to_map yolo: mAP, recall or precision outside [0, 1]")
            after = training_launches()
            check(after == before, f"train_to_map yolo: a K1-K5 kernel launched: {after}")
        else:
            counts = k2_counts()
            n = got["steps"]
            # each step once (the first, untimed, too), and K2's forward 3
            # times more in the evaluation: calibration, f32, int8
            log(f"train_to_map rektnet: K2 launches {counts} ({n} + 1 steps, 3 evaluation "
                f"forwards)")
            check(counts == {"softargmax": n + 1 + 3, "softargmax_bwd": n + 1},
                  f"train_to_map rektnet: K2 and K2-bwd did not launch once a step: {counts}")
            before = untrained_rektnet_l2(dev)
            log(f"train_to_map rektnet: held-out L2 {got['kpt_l2_f32']!r} after {n} steps, "
                f"{before!r} untrained (the tool's seed and crops)")
            check(got["kpt_l2_f32"] < 0.5 * before,
                  "train_to_map rektnet: the held-out L2 did not fall below half the "
                  "untrained model's")
    log(f"export/hyper seconds by part: {({k: round(v, 1) for k, v in timings.items()})} "
        f"on {smi}")


# ---------------------------------------------------------------------------
# phase 15: several devices (parallel/, infer/pp.py)
# ---------------------------------------------------------------------------

DP_STEPS = 5                 # compared after steps 1 and 3; timed over 3-5
DP_YOLO_B, DP_RK_B = 4, 32   # global batches (two ranks: 2 and 16 a rank)
# DP against one process on the whole batch, f32 SGD, cuDNN off on both
# sides (dp_drift): each step's loss and components within 5e-4 of the
# largest; each parameter within 2e-2 of the largest change the
# one-process run made by that step; each running stat within 5e-4 of its
# scale. On an NVIDIA H100 80GB HBM3 at 700 W this phase read at most
# 1.14e-4, 4.95e-3 and 9.1e-5 at world size 2 and 0 (bit-equal) at world
# size 1; the one-process run on the batch with its halves swapped reads
# 4.7e-5, 5.3e-3 and 6.1e-5. With cuDNN on, its algorithm picks depend on
# the batch size, so a rank's half batch sums in another algorithm: RektNet
# then parted by 1.1e-2 of the update after three steps at world size 2,
# so the cuDNN runs are timed and their drift printed, not held
DP_LOSS_RTOL, DP_PARAM_REL, DP_STAT_REL = 5e-4, 2e-2, 5e-4


def dp_jobs() -> list:
    """YOLOv3-416 (one class) and RektNet-16 training jobs for
    ``parallel.dryrun.run_jobs``: f32 SGD without momentum at lr 1e-4, small
    enough that three steps stay near the reordered batch's run (the
    printed floor), each with cuDNN off (held to one process) and on
    (timed). RektNet
    trains without the geometric term: on a random RektNet the soft-argmax
    points sit close together, and normalising their short edge vectors
    amplifies rounding. The cross-batch geometric loss under a mesh is held
    on the CPU to JAX's 2-device step and here by the dry run's one-step
    check."""
    from mit_driverless_cv_traininginfra_tpu_torch import convert
    from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic

    spec = yolo_spec()
    rng = np.random.default_rng(16)
    imgs, targets = synthetic.yolo_batch(rng, DP_YOLO_B, SIZE)
    crops, pts = synthetic.rektnet_batch(rng, DP_RK_B)
    base = [dict(family="yolo", spec=spec, trees=convert.init_darknet_np(spec, rng),
                 batch=(imgs, targets), step_kw=dict(YOLO_KW, compute_dtype="float32")),
            dict(family="rektnet", trees=convert.init_rektnet_np(rng),
                 batch=(crops, None, pts),
                 step_kw=dict(TRAIN_KW, include_geo=False, compute_dtype="float32"))]
    return [dict(job, lr=1e-4, steps=DP_STEPS, keep=(1, 3), cudnn=cudnn)
            for cudnn in (False, True) for job in base]


def dp_drift(got: dict, want: dict, before) -> dict:
    """How far one run of a job is from another: the worst loss difference
    over the steps relative to the largest |loss value| of that step, and
    after each kept step the worst parameter difference relative to the
    largest change the reference run made, the worst running-stat
    difference relative to its largest |value|."""
    def leaves(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v for k, t in tree.items() for k2, v in leaves(t, f"{path}/{k}").items()}
        return {path: np.asarray(tree, np.float64)}

    out = {"loss_rel": max(float(np.abs(g - w).max() / np.abs(w).max())
                           for g, w in zip(got["losses"], want["losses"]))}
    p0 = leaves(before[0])
    for step in sorted(want["trees"]):
        gp, wp = leaves(got["trees"][step][0]), leaves(want["trees"][step][0])
        upd = max(float(np.abs(wp[k] - p0[k]).max()) for k in wp)
        out[f"param_rel_{step}"] = max(float(np.abs(gp[k] - wp[k]).max()) for k in wp) / upd
        gs, ws = leaves(got["trees"][step][1]), leaves(want["trees"][step][1])
        out[f"stat_rel_{step}"] = max(float(np.abs(gs[k] - ws[k]).max())
                                      / max(float(np.abs(ws[k]).max()), 1e-12) for k in ws)
    return out


def dp_check(label: str, drift: dict) -> None:
    check(drift["loss_rel"] <= DP_LOSS_RTOL, f"dp {label}: losses differ")
    check(all(v <= DP_PARAM_REL for k, v in drift.items() if k.startswith("param")),
          f"dp {label}: parameters differ")
    check(all(v <= DP_STAT_REL for k, v in drift.items() if k.startswith("stat")),
          f"dp {label}: running stats differ")


def phase_dp_steps(dev, smi, launches: dict) -> None:
    """The DP YOLO and RektNet steps at world size 1 over NCCL and at world
    size 2 over gloo with both ranks on this card (NCCL takes one rank a
    GPU), each against the same steps in this process on the whole batch.
    Step times on the host clock, the device synchronised, over steps 3-5.
    The gloo run stages every collective through the host: a correctness
    path, not a speed figure of anything users run."""
    from mit_driverless_cv_traininginfra_tpu_torch.parallel.dryrun import run_jobs
    from mit_driverless_cv_traininginfra_tpu_torch.parallel.launch import launch

    jobs = dp_jobs()
    names = [f"{j['family']} cudnn {'on' if j['cudnn'] else 'off'}" for j in jobs]
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False   # as the ranks run
    t0 = time.perf_counter()
    one = run_jobs(None, jobs, dev)
    # the noise floor: the batch's halves swapped in one process, another
    # sum order, as DP's
    held = [i for i, j in enumerate(jobs) if not j["cudnn"]]
    swapped = run_jobs(None, [dict(jobs[i], batch=tuple(
        None if a is None else np.concatenate(np.split(np.asarray(a), 2)[::-1])
        for a in jobs[i]["batch"])) for i in held], dev)
    for i, run in zip(held, swapped):
        log(f"dp {names[i]} one process, batch halves swapped, against in order: "
            f"{json.dumps(dp_drift(run, one[i], jobs[i]['trees']))}")
    torch.backends.cudnn.benchmark = bench
    for name, (devices, backend) in {"nccl_ws1": ([dev], "nccl"),
                                     "gloo_ws2": ([dev, dev], "gloo")}.items():
        t1 = time.perf_counter()
        got = launch(run_jobs, devices, args=(jobs,), backend=backend)
        log(f"dp {name}: launch and {DP_STEPS} steps of each job in "
            f"{time.perf_counter() - t1:.1f} s")
        for label, job, g, w in zip(names, jobs, got, one):
            drift = dp_drift(g, w, job["trees"])
            log(f"dp {label} {name} against one process: {json.dumps(drift)}; step ms "
                f"(3-5) {g['ms'][2:]!r} against one process's {w['ms'][2:]!r} on {smi}")
            if not job["cudnn"]:
                dp_check(f"{label} {name}", drift)
            if job["family"] == "rektnet":
                check(all(v == DP_STEPS for v in g["launches"].values()),
                      f"dp {name}: K2 launches {g['launches']} in {DP_STEPS} steps")
                for k, v in g["launches"].items():
                    launches[k][f"dp_{name}_rank0"] = (
                        launches[k].get(f"dp_{name}_rank0", 0) + v)
    log(f"phase dp_steps: {time.perf_counter() - t0:.1f} s")


def phase_serve_mesh(dev, smi, frames_np, models: dict, launches: dict) -> None:
    """``TwoStageServer(mesh=make_mesh(1))``, bf16 and int8, graphed, against
    the server without a mesh: one request sequence (a short batch of 6,
    then full batches) to both, every output bit-equal, frames/s of each.
    Then the same mesh server served eagerly (``cuda_graphs=False``), its
    wrappers' counts set to 0 just before 8 requests and read just after:
    each path kernel once a request (a replay calls no wrapper, and on an
    H100 CUPTI's record of the replays came back one K4 launch short three
    takes running)."""
    from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import make_mesh

    for label, (yolo, rekt, thresh) in models.items():
        frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
        servers = {"no mesh": make_server(yolo, rekt, thresh),
                   "mesh 1": make_server(yolo, rekt, thresh, mesh=make_mesh(1))}
        for server in servers.values():
            server.warmup([B_SERVE], capacities=SERVE_CAPS, frame_dtype=frames.dtype)
        outs, fps = {}, {}
        for name, server in servers.items():
            outs[name] = [server(frames[:6])] + [server(frames) for _ in range(3)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(31):
                server(frames)
            torch.cuda.synchronize()
            fps[name] = 31 * B_SERVE / (time.perf_counter() - t0)
        same = all(bits_equal(a, b) for x, y in zip(outs["no mesh"], outs["mesh 1"])
                   for a, b in zip(x, y))
        log(f"serve mesh {label}: graphed frames/s, mesh of 1 {fps['mesh 1']!r} against "
            f"no mesh {fps['no mesh']!r}; {len(outs['mesh 1'])} requests bit-equal: {same}; "
            f"stats {json.dumps({k: servers['mesh 1'].stats()[k] for k in ('graphs', 'replays', 'compiles', 'batch_pads')})} on {smi}")
        check(same, f"serve mesh {label}: the mesh server differs from the server without one")
        eager = make_server(yolo, rekt, thresh, graphs=False, mesh=make_mesh(1))
        eager.warmup([B_SERVE], capacities=SERVE_CAPS, frame_dtype=frames.dtype)
        same = all(bits_equal(a, b) for a, b in zip(
            eager._dispatch(frames, B_SERVE, 96), servers["mesh 1"]._dispatch(frames, B_SERVE, 96)))
        torch.cuda.synchronize()
        zero_counts()
        for _ in range(8):
            eager(frames)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in kernel_wrappers().items()
                  if k in PATH_KERNELS[label]}
        log(f"serve mesh {label} eager: 8 requests, wrapper counts {counts}; bucket "
            f"(8, 96) bit-equal to the graphed mesh server's replay: {same}")
        check(same and all(v == 8 for v in counts.values()),
              f"serve mesh {label} eager: counts {counts}, bit-equal {same}")
        for k, v in counts.items():
            launches[k][f"serve_mesh1_{label}_eager"] = v


def phase_pp(dev, smi, yolo, rekt, frames_np, thresh, launches: dict) -> None:
    """``TwoStagePP`` with both stages on this card against the fused
    pipeline on two microbatches of 8 (the second the first flipped), at
    capacity 64, which the valid detections exceed in at least one:
    masks, boxes and scores bit-equal, keypoints within 1e-3 px; the
    wrappers' counts over the microbatches; both timed."""
    from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import two_stage_pipeline
    from mit_driverless_cv_traininginfra_tpu_torch.infer.pp import TwoStagePP

    cfg = dict(conf_thresh=thresh, max_det=MAX_DET, crop_capacity=64)
    x = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    micro = [x, x.flip(2).contiguous()]
    pp = TwoStagePP(yolo, rekt, dev, dev, **cfg)
    pp(micro)
    torch.cuda.synchronize()
    zero_counts()
    outs = pp(micro)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in kernel_wrappers().items() if k in PATH_KERNELS["bf16"]}
    check(all(v == len(micro) for v in counts.values()),
          f"pp: wrapper counts {counts} for {len(micro)} microbatches")
    for k, v in counts.items():
        launches[k]["pp"] = v
    worst, over = 0.0, 0
    for out, fr in zip(outs, micro):
        ref = two_stage_pipeline(yolo, rekt, fr, **cfg)
        check(all(bits_equal(a, b) for a, b in zip(out[:3], ref[:3])),
              "pp: masks, boxes or scores differ from the fused pipeline")
        worst = max(worst, max_abs(out.keypoints, ref.keypoints))
        over += int(ref.mask.sum()) > cfg["crop_capacity"]
    check(worst <= 1e-3, f"pp: keypoints {worst} px from the fused pipeline's")
    check(over >= 1, "pp: no microbatch's valid detections exceed the capacity")

    def rate(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return n * len(micro) * B_SERVE / (time.perf_counter() - t0)

    def fused():
        return [two_stage_pipeline(yolo, rekt, fr, **cfg) for fr in micro]

    # in turns (pp, fused, fused, pp): eager serving rates spread by ~10%
    fps = [rate(fn) for fn in (lambda: pp(micro), fused, fused, lambda: pp(micro))]
    log(f"pp on one card: {len(micro)} microbatches of {B_SERVE}, keypoints within {worst!r} "
        f"px, {over} over capacity; frames/s (eager) TwoStagePP {fps[0]!r}, {fps[3]!r} "
        f"against fused {fps[1]!r}, {fps[2]!r} on {smi}")


def phase_dryrun(smi) -> None:
    """``python -m …parallel.dryrun`` at world size 1 on this card, in a
    process of its own: every surface OK."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mit_driverless_cv_traininginfra_tpu_torch.parallel.dryrun",
         "--n_devices", "1"], capture_output=True, text=True, timeout=300)
    lines = proc.stdout.splitlines()
    for line in lines:
        log(line)
    check(proc.returncode == 0 and sum(ln.endswith(" OK") for ln in lines) == 8,
          f"dryrun failed (rc {proc.returncode}): {proc.stderr[-2000:]}")
    log(f"phase dryrun: {time.perf_counter() - t0:.1f} s on {smi}")


def phase_multi_device(dev, smi, rows: dict, frames_np, thresh, thresh_q, bundles) -> None:
    """Phase 15: the DP steps, the mesh servers, ``TwoStagePP`` and the dry
    run; each kernel row gains ``launches_multi_device``, its counts on
    these paths."""
    t0 = time.perf_counter()
    launches = {k: {} for k in ("roi_crop", "softargmax", "nms_topk", "entry_block",
                                "softargmax_bwd")}
    phase_dp_steps(dev, smi, launches)
    bf16 = build_models(dev, torch.bfloat16)
    phase_serve_mesh(dev, smi, frames_np, {"bf16": (*bf16, thresh),
                                           "int8": (*int8_models(bundles, dev), thresh_q)},
                     launches)
    phase_pp(dev, smi, *bf16, frames_np, thresh, launches)
    phase_dryrun(smi)
    for k, v in launches.items():
        check(v and all(n > 0 for n in v.values()), f"{k}: not launched on the "
              f"multi-device paths: {v}")
        rows[k]["launches_multi_device"] = v
    log(f"phase multi_device: {time.perf_counter() - t0:.1f} s on {smi}")


# ---------------------------------------------------------------------------
# phase 16: tensor-parallel and spatial sharding (parallel/mesh.py Mesh2D)
# ---------------------------------------------------------------------------

TP_STEPS = 2
TP_PHASE_S = 150
# the spatial forward against one process: box centres, confidences and
# class scores within rtol 1e-5, atol 1e-4 (centres reach 416, where the
# f32 ulp is 3.1e-5). The widths and heights are exp(t)·anchor and reach
# 3.7e4 px on these random weights, where one process itself sits 1.14e-5
# (relative) from the float64 evaluation and the spatial run 7.7e-6 (as
# this phase prints them on an NVIDIA H100 80GB HBM3 at 700 W), so every
# column is held to the float64 evaluation instead: the spatial run's
# largest relative error (over max(|value|, 1)) at most SP_FLOOR times one
# process's
SP_RTOL, SP_ATOL, SP_FLOOR = 1e-5, 1e-4, 2.0


def largest_activation_bytes(spec, B: int) -> int:
    """The largest f32 block output of ``spec`` on a whole B×SIZE² batch."""
    from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import block_strides

    return max(B * (SIZE // s) ** 2 * c * 4
               for s, c in zip(block_strides(spec), spec.out_channels[1:]))


def f64_detections(spec, trees, imgs, dev) -> np.ndarray:
    """The eval detections of ``trees`` with the network in float64 on the
    card, cuDNN off (``decode_head`` decodes in f32)."""
    from mit_driverless_cv_traininginfra_tpu_torch import convert
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet

    model = darknet.TrainDarknet(spec, convert.from_jax(trees[0], dev),
                                 convert.from_jax(trees[1], dev)).to(dev).double()
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=False):
        x = torch.from_numpy(imgs).to(dev, torch.float64)
        return model.detections(x, dtype=torch.float64).cpu().numpy()


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got − want| / max(|want|, 1)."""
    want = want.astype(np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())


def timed_launch(devices, backend: str, shape: tuple, jobs: list):
    """``launch(run_jobs, …)`` of ``jobs`` on a ``shape`` mesh; rank 0's
    results and the launch's wall seconds."""
    from mit_driverless_cv_traininginfra_tpu_torch.parallel.dryrun import run_jobs
    from mit_driverless_cv_traininginfra_tpu_torch.parallel.launch import launch

    t = time.perf_counter()
    got = launch(run_jobs, devices, args=(jobs,), backend=backend, mesh_shape=shape)
    return got, time.perf_counter() - t


def phase_tp_spatial(dev, smi) -> None:
    """Phase 16: the TP × DP YOLO step over ``model`` 2 (gloo, both ranks on
    this card, which also run the spatial forward) and 1 × 1 (NCCL)
    against one process, and the CPU dry run at N = 4 in a process of its
    own. The reference runs first, alone on the card; then the two
    launches and the dry run run at once (each launch spends most of its
    time starting its ranks and staging collectives through the host), the
    float64 evaluation beside them in this process."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from mit_driverless_cv_traininginfra_tpu_torch import convert
    from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
    from mit_driverless_cv_traininginfra_tpu_torch.parallel.dryrun import run_jobs

    t0 = time.perf_counter()
    secs = {}
    # the dry run's ranks take one thread each; its own process two
    dry = subprocess.Popen(
        [sys.executable, "-m", "mit_driverless_cv_traininginfra_tpu_torch.parallel.dryrun",
         "--n_devices", "4", "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(os.environ, OMP_NUM_THREADS="2"))

    def dry_wait():
        out = dry.communicate(timeout=300)
        secs["dry run"] = time.perf_counter() - t0
        return out

    try:
        spec = yolo_spec()
        rng = np.random.default_rng(17)
        imgs, targets = synthetic.yolo_batch(rng, DP_YOLO_B, SIZE)
        trees = convert.init_darknet_np(spec, rng)
        job = dict(family="yolo", spec=spec, trees=trees, batch=(imgs, targets),
                   step_kw=dict(YOLO_KW, compute_dtype="float32"), lr=1e-4, momentum=0.9,
                   steps=TP_STEPS, cudnn=False)
        sp_job = dict(family="spatial", spec=spec, trees=trees, batch=(imgs,), cudnn=False)
        t1 = time.perf_counter()
        bench = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False   # as the ranks run
        one, sp1 = run_jobs(None, [job, sp_job], dev)
        torch.backends.cudnn.benchmark = bench
        secs["one process"] = time.perf_counter() - t1
        runs = {"gloo_1x2": ([dev, dev], "gloo", (1, 2), [job, sp_job]),
                "nccl_1x1": ([dev], "nccl", (1, 1), [job])}
        with ThreadPoolExecutor(len(runs) + 1) as pool:
            pending = {name: pool.submit(timed_launch, *run) for name, run in runs.items()}
            dry_done = pool.submit(dry_wait)
            t1 = time.perf_counter()
            f64 = f64_detections(spec, trees, imgs, dev)
            secs["float64"] = time.perf_counter() - t1
            done = {name: f.result() for name, f in pending.items()}
            out, errs = dry_done.result()
        filters = spec.blocks[0].filters
        for name, (got, took) in done.items():
            shape = runs[name][2]
            secs[name] = took
            drift = dp_drift(got[0], one, trees)
            held = got[0]["parts"][0][0]["0"]["w"].shape[-1]
            log(f"tp {name}: launch, {TP_STEPS} steps"
                f"{' and the spatial forward' * (len(got) > 1)} in {took:.1f} s; against "
                f"one process {json.dumps(drift)}; step ms {got[0]['ms']!r} against one "
                f"process's {one['ms']!r}; parameter + momentum MiB a rank "
                f"{got[0]['mib']!r} against one process's {one['mib']!r}; conv 0 holds "
                f"{held} of {filters} out-channels; {len(got[0]['collectives'])} model-axis "
                f"collectives on rank 0 on {smi} (both launches ran at once on this card"
                + ("; gloo stages every collective through the host" if runs[name][1] == "gloo"
                   else "") + ": a correctness path, not a speed)")
            dp_check(f"tp {name}", drift)
            check(held == filters // shape[1], f"tp {name}: conv 0 holds {held} of "
                  f"{filters} out-channels after the update")
            check(all(np.isfinite(v).all() for v in got[0]["losses"]), f"tp {name}: loss")
        sp = done["gloo_1x2"][0][1]
        rows = [(r.start, r.stop) for r in sp["rows"]]
        det, det1 = sp["det"], sp1["det"]
        bounded = [0, 1] + list(range(4, det.shape[-1]))   # cx, cy, conf, classes
        close = np.allclose(det[..., bounded], det1[..., bounded], rtol=SP_RTOL, atol=SP_ATOL)
        err_sp, err_one = rel_err(det, f64), rel_err(det1, f64)
        halos = [b for kind, _, b in sp["collectives"] if kind == "halo"]
        gathers = [b for kind, _, b in sp["collectives"] if kind == "all_gather"]
        full = largest_activation_bytes(spec, DP_YOLO_B)
        log(f"spatial 416² B={DP_YOLO_B} on 2 gloo ranks (frame rows {rows}): detections "
            f"{det.shape}, max |Δ| against one process by column "
            f"{np.abs(det - det1).reshape(-1, det.shape[-1]).max(0).tolist()}, largest "
            f"|value| {np.abs(det1).reshape(-1, det.shape[-1]).max(0).tolist()}; cx, cy, "
            f"conf, classes within rtol {SP_RTOL}, atol {SP_ATOL}: {close}; relative error "
            f"against float64: spatial {err_sp!r}, one process {err_one!r} (at most "
            f"{SP_FLOOR}×); rank 0 sent {len(halos)} halos, {sum(halos)} bytes in all, the "
            f"largest {max(halos)}, against one whole activation of {full} bytes; gathered "
            f"the heads' maps in {sum(gathers)} bytes; forward ms {sp['ms']!r} against one "
            f"process's {sp1['ms']!r} on {smi} (gloo on one card, beside the other launch: "
            "a correctness path, not a speed)")
        check(rows == [(0, 224), (224, 416)], f"spatial: frame rows {rows}")
        check(close and np.isfinite(det).all(), "spatial: detections differ from one process's")
        check(err_sp <= SP_FLOOR * err_one, f"spatial: {err_sp} from float64, one process "
              f"{err_one}")
        check(halos and max(halos) <= full / 4, "spatial: a halo over 1/4 of an activation")
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    lines = out.splitlines()
    for line in lines:
        log(line)
    check(dry.returncode == 0 and sum(ln.endswith(" OK") for ln in lines) == 10,
          f"dryrun N=4 on the CPU failed (rc {dry.returncode}): {errs[-2000:]}")
    took = time.perf_counter() - t0
    log(f"tp_spatial seconds by part (the launches, the dry run and float64 at once; "
        f"the dry run's from the phase's start): "
        f"{({k: round(v, 1) for k, v in secs.items()})} on {smi}")
    log(f"phase tp_spatial: {took:.1f} s on {smi}")
    check(took < TP_PHASE_S, f"phase tp_spatial took {took:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: the packed stem, stem_q, from_params, oversize crops, kpt padding
# ---------------------------------------------------------------------------

STEM_PHASE_S = 90
KPT_CAP, KPT_PAD = 112, 128   # a served capacity, padded to the next 128
STEM_STEPS = 5                # bf16 steps a run; timed over steps 3-5
STEM_REQUESTS = 32            # graphed requests a served-frames/s sample
# the bf16 stems against an f32 evaluation of the same bf16 weights and
# frames: the packed stem's largest error (over the largest |value|) at
# most STEM_BF16_FLOOR times the plain stem's
STEM_BF16_FLOOR = 2.0
# two SGD steps of YOLOv3-416 through each stem. After the second step
# the f32 runs cannot be held to each other or to float64: on random
# weights each sits 3-48% of the largest update from float64, and which
# stem sits nearer changes with the seed (YOLOv3 at 64² on the CPU, seeds
# 0-2: packed over plain 0.90, 3.29, 1.73; at 416² on an NVIDIA H100 80GB
# HBM3 at 700 W, seed 0: 0.100 against 0.126), so that distance is the
# step's conditioning, not the stem. Held instead: the float64 packed
# steps against the float64 plain ones, the same function in two
# summation orders (1.6e-12 to 3.5e-12 of the largest update on the CPU,
# the faulty stems 0.90 and 1.51), within STEM_F64_EXACT; and the first
# f32 step within STEM_F32_FIRST. One f32 step is conditioned too: on the
# CPU at 64², seeds 0-2, the packed update sits 1.6e-3 to 1.5e-2 from
# float64 and 1.7e-3 to 1.8e-2 from the plain one (the plain 3.2e-4 to
# 9.6e-3 from float64), past phase_yolo_train_agree's 1e-2 as oneDNN's
# step on an augmented batch is (1.99e-2); the faulty stems sit at 0.91
# and 1.68
STEM_F64_EXACT = 1e-6
STEM_F32_FIRST = 5e-2
STEM_SEEDS = (0, 1, 2)        # weights and scenes of the f32/float64 steps


STEM_EAGER = 8                # eager requests a wrapper-count sample


def eager_counts(server, frames) -> dict:
    """``STEM_EAGER`` requests of ``frames`` to a ``TwoStageServer`` that
    serves eagerly (``cuda_graphs=False``: a replay calls no wrapper), every
    kernel counter set to 0 just before them and read just after."""
    server.warmup([B_SERVE], capacities=SERVE_CAPS, frame_dtype=frames.dtype)
    torch.cuda.synchronize()
    zero_counts()
    for _ in range(STEM_EAGER):
        server(frames)
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def served_fps(yolo, rekt, frames, thresh) -> float:
    """Graphed frames/s of a ``TwoStageServer`` with one warmed bucket
    (B=8, capacity 112) over ``STEM_REQUESTS`` requests of ``frames``."""
    server = make_server(yolo, rekt, thresh)
    server.warmup([B_SERVE], capacities=[KPT_CAP], frame_dtype=frames.dtype)
    server(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEM_REQUESTS):
        server(frames)
    torch.cuda.synchronize()
    fps = STEM_REQUESTS * B_SERVE / (time.perf_counter() - t0)
    st = server.stats()
    check(st["compiles"] == 0 and st["replays"] == STEM_REQUESTS + 1,
          f"served_fps: {st['compiles']} compiles, {st['replays']} replays")
    return fps


def common_gap_threshold(confs, lo: int = 6, hi: int = 20) -> float:
    """A confidence threshold in the middle of the widest gap between
    neighbouring values of all ``confs`` (each (B, N)) that passes between
    ``lo`` and ``hi`` candidates a frame of each: a rounding difference
    between the models cannot move a candidate across it."""
    flat = np.sort(np.concatenate([c.ravel() for c in confs]))
    per = len(confs) * confs[0].shape[0]
    cs = np.arange(lo * per, hi * per + 1)
    gaps = flat[-cs] - flat[-cs - 1]
    c = cs[int(np.argmax(gaps))]
    return float((flat[-c] + flat[-c - 1]) / 2)


def stem_serving(dev, smi, frames_np, folded, rfolded, launches: dict) -> tuple:
    """YOLOv3-416 with the packed stem beside the plain one. f32 (no TF32):
    the B=8 pipeline's masks equal at a threshold in a gap of both models'
    confidences, boxes, scores and keypoints within ``phase_slice_f32``'s
    bounds. bf16: each stem (blocks 0-1) and each whole detector against an
    f32 evaluation of the same bf16 weights and frames, the packed one
    within ``STEM_BF16_FLOOR`` times the plain one's error (the stem's
    largest, the detections' mean box and confidence errors); the bf16
    pipelines' masks compared and printed (bf16 roundings in two orders
    part over 75 random layers, as the JAX package's own f32 test of the
    packed detections allows 1e-2), and each bf16 pipeline's slots that
    differ from the f32 pipeline's at the f32 threshold; the packed bf16
    server's wrapper counts over eager requests (``launches``); the stem
    alone and the detector in device ms, and graphed served frames/s of
    each in turns. Returns the bf16 packed detector, the bf16 RektNet and
    the bf16 threshold."""
    import copy

    from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import two_stage_pipeline
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, rektnet, stem_opt

    spec1, tree = folded["spec"], folded["tree"]
    packed_tree = stem_opt.build_packed_stem(tree)
    models = {dt: (darknet.Darknet(spec1, tree).to(dtype=dt).eval(),
                   darknet.Darknet(spec1, tree, packed_tree).to(dtype=dt).eval(),
                   rektnet.RektNet(rfolded).to(dtype=dt).eval())
              for dt in (torch.float32, torch.bfloat16)}
    for m in models[torch.bfloat16]:
        m.to(memory_format=torch.channels_last)
    out = {}
    for dt, (plain, packed, rekt) in models.items():
        frames = torch.from_numpy(frames_np).to(dev, dt)
        with torch.inference_mode():
            confs = [m.detections(frames, with_classes=False)[..., 4].float().cpu().numpy()
                     for m in (plain, packed)]
        thresh = common_gap_threshold(confs)
        kw = dict(conf_thresh=thresh, max_det=MAX_DET, crop_capacity=KPT_CAP)
        out[dt] = (thresh, two_stage_pipeline(plain, rekt, frames, **kw),
                   two_stage_pipeline(packed, rekt, frames, **kw))
    thresh, ref, got = out[torch.float32]
    thresh32, ref32 = thresh, ref
    m = ref.mask
    mask_eq = torch.equal(got.mask, m)
    pairs = {"box": (got.boxes[m], ref.boxes[m]), "kpt": (got.keypoints[m], ref.keypoints[m]),
             "score": (got.scores[m], ref.scores[m])}
    errs = {k: max_abs(a, b) for k, (a, b) in pairs.items()}
    log(f"stem f32 pipeline packed vs plain (B={B_SERVE}, capacity {KPT_CAP}, conf_thresh "
        f"{thresh!r} in a common gap): detections {int(m.sum())}, masks_equal={mask_eq}, "
        f"max |d| {errs}")
    check(mask_eq and int(m.sum()) > 0, "packed stem f32: masks differ from the plain stem's")
    check(all(torch.allclose(a, b, rtol=1e-4, atol=1e-2) for a, b in pairs.values()),
          "packed stem f32: boxes / keypoints / scores beyond rtol 1e-4, atol 1e-2")
    plain, packed, rekt = models[torch.bfloat16]
    thresh, ref, got = out[torch.bfloat16]
    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    f32_of_bf16 = copy.deepcopy(plain).float()
    with torch.inference_mode():
        want = f32_of_bf16.truncated_forward(frames.float(), 1)
        scale = float(want.abs().max())
        stem_err = {name: max_abs(m.truncated_forward(frames, 1), want) / scale
                    for name, m in (("plain", plain), ("packed", packed))}
        want = f32_of_bf16.detections(frames.float(), with_classes=False)
        det_err, slots32 = {}, {}
        for name, m in (("plain", plain), ("packed", packed)):
            d = m.detections(frames, with_classes=False).float() - want
            det_err[name] = (float(d[..., :4].abs().mean() / want[..., :4].abs().mean()),
                             float(d[..., 4].abs().mean()))
            slots32[name] = int((two_stage_pipeline(
                m, rekt, frames, conf_thresh=thresh32, max_det=MAX_DET,
                crop_capacity=KPT_CAP).mask != ref32.mask).sum())
        stem = {}
        for name, m in (("plain", plain), ("packed", packed)):
            kernels, per_call, dev_ms = device_kernels(lambda m=m: m.truncated_forward(frames, 1),
                                                       10)
            stem[name] = (dev_ms, per_call)
        det_ms, det_plain_ms = paired_ms(lambda: packed(frames), lambda: plain(frames), 20)
    del f32_of_bf16
    n_diff = int((got.mask != ref.mask).sum())
    log(f"stem bf16 B={B_SERVE}: stem (blocks 0-1) against f32 on the same bf16 weights, "
        f"max |d| over max |value| {scale!r}: packed {stem_err['packed']!r} plain "
        f"{stem_err['plain']!r}; detections against f32 on the same bf16 weights, mean "
        f"box |d| over mean |box| and mean confidence |d|: packed {det_err['packed']!r} "
        f"plain {det_err['plain']!r}; pipelines (conf_thresh {thresh!r}): detections plain "
        f"{int(ref.mask.sum())} packed {int(got.mask.sum())}, {n_diff} of "
        f"{ref.mask.numel()} slots differ; at the f32 threshold {thresh32!r}, slots "
        f"differing from the f32 pipeline's ({int(ref32.mask.sum())} detections): bf16 "
        f"plain {slots32['plain']}, bf16 packed {slots32['packed']}")
    log(f"stem bf16 B={B_SERVE}: stem device ms packed {stem['packed'][0]!r} "
        f"({stem['packed'][1]!r} launches a call) plain {stem['plain'][0]!r} "
        f"({stem['plain'][1]!r}); detect ms packed {det_ms!r} plain {det_plain_ms!r} on {smi}")
    check(stem_err["packed"] <= STEM_BF16_FLOOR * stem_err["plain"]
          and all(a <= STEM_BF16_FLOOR * b for a, b in zip(det_err["packed"],
                                                            det_err["plain"])),
          f"packed stem bf16: stem {stem_err['packed']}, detections {det_err['packed']} "
          f"from f32, the plain stem {stem_err['plain']}, {det_err['plain']}")
    counts = eager_counts(make_server(packed, rekt, thresh, graphs=False), frames)
    log(f"stem bf16 packed server eager: {STEM_EAGER} requests, wrapper counts {counts}")
    for k in PATH_KERNELS["bf16"]:
        launches[k]["serve_packed_bf16_eager"] = counts[k]
    fps = {}
    for name, m in (("plain", plain), ("packed", packed), ("packed", packed),
                    ("plain", plain)):
        fps.setdefault(name, []).append(served_fps(m, rekt, frames, thresh))
    log(f"stem bf16 served frames/s (graphed, B={B_SERVE}, one bucket at {KPT_CAP}, order "
        f"plain, packed, packed, plain): packed {fps['packed']!r} plain {fps['plain']!r} on "
        f"{smi}")
    return packed, rekt, thresh


def stem_int8(dev, smi, frames, bundles, folded, entry_models, thresh_q, fps_int8,
              launches: dict) -> None:
    """int8 with ``stem_q`` and no ``entry_q``: the slice on the card against
    CPU copies, graphed served frames/s beside the fused entry's, the
    wrapper counts over eager requests (K4 never: the stem takes the
    entry's place); then ``TwoStageServer.from_params`` from the bundles,
    entry and stem alike, bit-equal to the server built from the models,
    and the entry one's wrapper counts over eager requests."""
    from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import TwoStageServer
    from mit_driverless_cv_traininginfra_tpu_torch.models import quantize, stem_opt

    spec1, yolo_q, entry_q, rekt_q, amax = bundles
    stem_q = quantize.quantize_packed_stem(stem_opt.build_packed_stem(folded["tree"]),
                                           amax["yolo"])
    yolo = quantize.Int8Darknet(spec1, yolo_q, stem_q=stem_q).to(dev).eval()
    rekt = quantize.Int8RektNet(rekt_q).to(dev).eval()
    cpu = [tree_to(t, "cpu") for t in (yolo_q, stem_q, rekt_q)]
    yolo_c = quantize.Int8Darknet(spec1, cpu[0], stem_q=cpu[1]).eval()
    rekt_c = quantize.Int8RektNet(cpu[2]).eval()
    fb = frames.to(torch.bfloat16)
    with torch.inference_mode():
        thresh = pick_conf_thresh(yolo.detections(fb, with_classes=False), MAX_DET)
    int8_card_vs_cpu("int8 stem_q", yolo, rekt, yolo_c, rekt_c, fb, thresh)
    fps = {}
    for name, pair, th in (("entry", entry_models, thresh_q), ("stem_q", (yolo, rekt), thresh),
                           ("stem_q", (yolo, rekt), thresh), ("entry", entry_models, thresh_q)):
        fps.setdefault(name, []).append(served_fps(*pair, fb, th))
    log(f"stem int8 served frames/s (graphed, B={B_SERVE}, one bucket, order entry, stem_q, "
        f"stem_q, entry): stem_q {fps['stem_q']!r}, fused entry {fps['entry']!r} (phase 5, "
        f"four buckets: {fps_int8!r}) on {smi}")
    counts = eager_counts(make_server(yolo, rekt, thresh, graphs=False), fb)
    log(f"stem int8 stem_q server eager: {STEM_EAGER} requests, wrapper counts {counts}")
    check(counts["entry_block"] == 0, f"stem_q server: K4 launched {counts}")
    for k in PATH_KERNELS["bf16"]:
        launches[k]["serve_stem_q_eager"] = counts[k]
    kw = dict(conf_thresh=thresh_q, max_det=MAX_DET, cuda_graphs=False)
    for label, ref_yolo, eq in (("stem_q", yolo, None), ("entry_q", entry_models[0], entry_q)):
        ref = make_server(ref_yolo, entry_models[1] if eq is not None else rekt, thresh_q,
                          graphs=False)
        fp = TwoStageServer.from_params(spec1, yolo_q, stem_q, rekt_q, entry_q=eq, **kw)
        same = all(bits_equal(a, b) for a, b in zip(fp._dispatch(fb, B_SERVE, KPT_CAP),
                                                    ref._dispatch(fb, B_SERVE, KPT_CAP)))
        log(f"from_params ({label}): outputs bit-equal to the server of models {same}")
        check(same and (fp.yolo.entry is None) == (eq is None),
              f"from_params ({label}) differs from the server built from models")
    counts = eager_counts(fp, fb)   # the entry_q server, built by from_params
    log(f"from_params (entry_q) server eager: {STEM_EAGER} requests, wrapper counts {counts}")
    for k in PATH_KERNELS["int8"]:
        launches[k]["from_params_entry_q_eager"] = counts[k]


def stem_oversize_cli(smi, thresh) -> None:
    """``cli/serve.py --source synthetic:32 --syn_oversize_tail 16
    --crop_kernel on --packed_stem`` at bf16, B=8: K1 under boxes past the
    TPU window; the summary's four watch keys, the kernel active, no
    switch."""
    import csv
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        argv = (["--source", "synthetic:32", "--syn_oversize_tail", "16", "--crop_kernel",
                 "on", "--packed_stem", "--precision", "bf16", "--batch_size", str(B_SERVE), "--conf_thres",
                 repr(thresh), "--observe_every", "1", "--output_csv", f"{tmp}/d.csv"]
                + write_cli_models(tmp))
        rc, summary, secs = serve_cli_summary(argv)
        with open(f"{tmp}/d.csv") as f:
            rows = [[float(v) for v in r[2:6]] for r in csv.reader(f) if r[0] != "frame"]
    past = sum((x2 - x1 > TPU_BOX_LIMITS[1]) or (y2 - y1 > TPU_BOX_LIMITS[0])
               for x1, y1, x2, y2 in rows)
    keys = ("oversize_boxes", "oversize_observed", "crop_kernel_active",
            "crop_kernel_switches")
    log(f"cli bf16 oversize tail: rc {rc} in {secs:.1f} s, fps {summary.get('fps')!r}, "
        f"{len(rows)} detections, {past} past the TPU window {TPU_BOX_LIMITS}; "
        + json.dumps({k: summary.get(k) for k in keys}) + f" on {smi}")
    check(rc == 0 and summary["frames"] == 32 and summary["compiles"] == 0,
          f"cli oversize: rc {rc}, {summary.get('frames')} frames")
    check(summary["crop_kernel_active"] is True and summary["crop_kernel_switches"] == 0
          and summary["oversize_boxes"] == 0 and summary["oversize_observed"] > 0,
          f"cli oversize: watch keys {[summary.get(k) for k in keys]}")


def stem_kpt_pad(smi, frames, yolo, rekt, thresh, launches: dict) -> None:
    """The bf16 pipeline at capacity 112 and at 112 padded to 128 for
    RektNet: masks equal, keypoints within ``phase_slice_f32``'s bound, the
    wrapper counts over the padded call; RektNet ms on 112 and 128 crops."""
    from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import two_stage_pipeline

    kw = dict(conf_thresh=thresh, max_det=MAX_DET, crop_capacity=KPT_CAP)
    # cuDNN's deterministic picks, so that the two batch sizes differ in as
    # few algorithms as it allows
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        a = two_stage_pipeline(yolo, rekt, frames, **kw)
        torch.cuda.synchronize()
        zero_counts()
        b = two_stage_pipeline(yolo, rekt, frames, kpt_pad_multiple=KPT_PAD, **kw)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in kernel_wrappers().items()}
    for k in PATH_KERNELS["bf16"]:
        launches[k]["kpt_pad_pipeline"] = counts[k]
    mask_eq = torch.equal(a.mask, b.mask)
    err = max_abs(a.keypoints, b.keypoints)
    crops = torch.rand((KPT_PAD, 80, 80, 3), generator=torch.Generator(
        device=frames.device).manual_seed(4), device=frames.device).to(torch.bfloat16)
    with torch.inference_mode():
        ms_pad, ms_cap = paired_ms(lambda: rekt(crops), lambda: rekt(crops[:KPT_CAP]), 20)
    log(f"kpt_pad_multiple bf16 B={B_SERVE}: capacity {KPT_CAP} vs padded to {KPT_PAD}: "
        f"masks_equal={mask_eq}, keypoints max |d| {err!r} px; RektNet ms {KPT_CAP} crops "
        f"{ms_cap!r}, {KPT_PAD} crops {ms_pad!r}; padded call's wrapper counts {counts} on "
        f"{smi}")
    check(mask_eq and torch.allclose(a.keypoints, b.keypoints, rtol=1e-4, atol=1e-2),
          "kpt_pad_multiple: masks or keypoints differ from the unpadded pipeline")


def sgd_steps(spec, trees, imgs, targets, dev, dtype, packed: bool):
    """Two SGD steps (lr 1e-4, momentum 0.9) of YOLOv3-416 from ``trees``:
    at f32 through ``yolo_train_step`` itself, at float64 as its
    evaluation (the same forward, loss and optimizer). Returns (the two
    losses, the state before, each state entry's change after each step)."""
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet
    from mit_driverless_cv_traininginfra_tpu_torch.models.yolo_loss import yolo_loss
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import yolo_train_step

    model = darknet.TrainDarknet(spec, *trees).to(dev, dtype)
    before = {k: v.double().clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model.parameters(), "SGD", lr=1e-4, momentum=0.9)
    losses, changes = [], []
    for _ in range(2):
        if dtype == torch.float32:
            loss = yolo_train_step(model, opt, imgs, targets, compute_dtype="float32",
                                   packed_stem=packed, **YOLO_KW)[0]
        else:
            opt.zero_grad(set_to_none=True)
            heads = model.forward_features(imgs.to(dtype), train=True, dtype=dtype,
                                           packed_stem=packed)
            loss = yolo_loss(spec, heads, targets.to(dtype), **YOLO_KW)[0]
            loss.backward()
            opt.step()
        losses.append(float(loss.detach()))
        changes.append({k: v.double() - before[k] for k, v in model.state_dict().items()})
    return losses, before, changes


def stem_controls():
    """Two faulty packed stems, each a replacement of ``darknet``'s
    ``pack_stem_weights``: ``w1_one_phase`` returns the same packed
    weights but lets ``w1``'s gradient through the first output phase
    only (a packed backward that drops three of the four slot sums);
    ``bf16_weights`` rounds the packed weights to bf16 (a lower-precision
    stem)."""
    from mit_driverless_cv_traininginfra_tpu_torch.models import stem_opt

    def w1_one_phase(w1, w2):
        w1p, w2p = stem_opt.pack_stem_weights(w1, w2)
        frozen = stem_opt.pack_stem_weights(w1.detach(), w2)[0]
        keep = torch.zeros((w1p.shape[0], 1, 1, 1), dtype=w1p.dtype, device=w1p.device)
        keep[:w1.shape[0]] = 1
        return w1p * keep + frozen * (1 - keep), w2p

    def bf16_weights(w1, w2):
        return tuple(w.to(torch.bfloat16).to(w.dtype)
                     for w in stem_opt.pack_stem_weights(w1, w2))

    return {"w1_one_phase": w1_one_phase, "bf16_weights": bf16_weights}


def stem_training(dev, smi) -> None:
    """YOLOv3-416 bf16 steps at B=8 with and without ``packed_stem`` (ms over
    steps 3-5, order plain, packed, packed, plain); then, on each of
    ``STEM_SEEDS`` (weights and scenes), two SGD steps (lr 1e-4, momentum
    0.9, B=2, cuDNN off) through each stem in f32 and in float64, from the
    same weights. Held: the float64 packed steps equal to the float64 plain
    ones within ``STEM_F64_EXACT`` of the largest update (the packed
    forward and backward are the plain ones' function); and the first f32
    step: the loss packed against plain within ``phase_yolo_train_agree``'s
    1e-5 and the running stats within its 1e-4 of their scale, the packed
    update within ``STEM_F32_FIRST`` of the largest float64 update from
    the float64 plain step and from the plain f32 update. After the second
    step the f32 runs are printed only (``STEM_F64_EXACT``'s comment). The
    two faults of ``stem_controls``, run on the
    first seed, must each fail a held limit."""
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet
    from mit_driverless_cv_traininginfra_tpu_torch.train.optim import make_optimizer
    from mit_driverless_cv_traininginfra_tpu_torch.train.steps import yolo_train_step

    spec = yolo_spec()
    trees = darknet.init_params(spec, torch.Generator().manual_seed(0))
    imgs, targets = (torch.from_numpy(a).to(dev) for a in yolo_scenes(23, YOLO_B))
    ms = {}
    for packed in (False, True, True, False):
        model = darknet.TrainDarknet(spec, *trees).to(dev)
        opt = make_optimizer(model.parameters(), "Adam", lr=1e-4)
        times = []
        for _ in range(STEM_STEPS):
            t0 = time.perf_counter()
            loss = yolo_train_step(model, opt, imgs, targets, compute_dtype="bfloat16",
                                   packed_stem=packed, **YOLO_KW)[0]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(loss)), f"packed stem {packed}: non-finite bf16 loss")
        ms.setdefault("packed" if packed else "plain", []).append(float(np.mean(times[2:])))
        del model, opt
    log(f"stem training bf16 B={YOLO_B} ms a step over steps 3-{STEM_STEPS} (order plain, "
        f"packed, packed, plain): packed {ms['packed']!r} plain {ms['plain']!r} on {smi}")

    def off(d, ref, keys, scale_of=None):
        """The largest distance of the changes ``d`` from ``ref``, over the
        largest of ``ref`` (or, per entry, of ``scale_of``'s)."""
        scale = max(float(ref[k].abs().max()) for k in keys)
        return max((float((d[k] - ref[k]).abs().max())
                    / (scale if scale_of is None else float(scale_of[k].abs().max())), k)
                   for k in keys)

    results = {}
    with torch.backends.cudnn.flags(enabled=False):
        for seed in STEM_SEEDS:
            trees = darknet.init_params(spec, torch.Generator().manual_seed(seed))
            imgs2, t2 = (torch.from_numpy(a).to(dev) for a in yolo_scenes(22 + seed, 2))
            runs = {(dt, packed): sgd_steps(spec, trees, imgs2, t2, dev, dt, packed)
                    for dt in (torch.float64, torch.float32) for packed in (False, True)}
            if seed == STEM_SEEDS[0]:
                real = darknet.pack_stem_weights
                for name, fault in stem_controls().items():
                    darknet.pack_stem_weights = fault
                    try:
                        runs[name] = tuple(sgd_steps(spec, trees, imgs2, t2, dev, dt, True)
                                           for dt in (torch.float64, torch.float32))
                    finally:
                        darknet.pack_stem_weights = real
            (l64, before, d64), (l0, _, d0) = (runs[torch.float64, False],
                                               runs[torch.float32, False])
            params = [k for k in before if k.endswith(("weight", "bias"))]
            stats = [k for k in before if k.endswith(("running_mean", "running_var"))]
            after0 = {k: before[k] + d0[0][k] for k in stats}

            def judge(p64, p32):
                """A packed pair's (float64 packed vs plain after two steps;
                first f32 step: its update from float64, from the plain f32
                update, its running stats from the plain f32 run's)."""
                return (off(p64[1], d64[1], params)[0], off(p32[0], d64[0], params)[0],
                        off(p32[0], d0[0], params)[0], off(p32[0], d0[0], stats, after0)[0])

            def held(r):
                return (r[0] <= STEM_F64_EXACT,
                        r[1] <= STEM_F32_FIRST and r[2] <= STEM_F32_FIRST and r[3] <= 1e-4)

            res = {"packed": judge(runs[torch.float64, True][2], runs[torch.float32, True][2])}
            for name in stem_controls():
                if name in runs:
                    res[name] = judge(runs[name][0][2], runs[name][1][2])
            l1 = runs[torch.float32, True][0]
            log(f"stem training seed {seed}, SGD (lr 1e-4, momentum 0.9, B=2, cuDNN off): "
                f"losses f32 packed {l1!r} plain {l0!r} float64 {l64!r}; first f32 step, "
                f"plain update from float64 {off(d0[0], d64[0], params)!r}; after two "
                f"steps, from float64, worst update over the largest: f32 packed "
                f"{off(runs[torch.float32, True][2][1], d64[1], params)!r} plain "
                f"{off(d0[1], d64[1], params)!r}")
            check(abs(l1[0] - l0[0]) <= 1e-5 * abs(l0[0]),
                  f"packed stem training seed {seed}: first loss {l1[0]} vs {l0[0]}")
            results[seed] = {name: (r, held(r)) for name, r in res.items()}
    log("stem training [float64 packed vs plain after two steps; first f32 step: update "
        "from float64, from the plain f32 update, running stats from the plain f32 run's] "
        f"(limits {STEM_F64_EXACT}, {STEM_F32_FIRST}, {STEM_F32_FIRST}, 1e-4) and (float64, "
        "f32) held: "
        + json.dumps({seed: {name: [[float(f"{v:.6g}") for v in r], h]
                             for name, (r, h) in res.items()}
                      for seed, res in results.items()}))
    check(all(all(res["packed"][1]) for res in results.values()),
          "packed stem training: off the plain stem's steps")
    check(all(not all(h) for name, (_, h) in results[STEM_SEEDS[0]].items()
              if name != "packed"),
          "packed stem training: a faulty packed stem passed the limits")


def phase_stem_crop(dev, smi, rows: dict, frames_np, bundles, entry_models, thresh_q,
                    fps_int8) -> None:
    """Phase 17: the packed space-to-depth stem in bf16 serving and in
    training, the int8 ``stem_q`` detector, ``from_params``, the serve CLI
    on oversize boxes, and ``kpt_pad_multiple``; its seconds held under
    ``STEM_PHASE_S``. No kernel is new: K1-K3 serve every path here, and
    K1's oversize case is phase 3's (``k1_oversize``). Each K1-K4 row gains
    ``launches_stem_crop``, its counts over the eager requests of the
    packed bf16, ``stem_q`` and ``from_params`` (entry) servers and over
    the padded pipeline call."""
    t0 = time.perf_counter()
    launches = {k: {} for k in PATH_KERNELS["int8"]}
    torch.backends.cudnn.benchmark = True
    spec1, folded1, rfolded = seeded_folded(dev)
    folded = {"spec": spec1, "tree": folded1}
    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    secs = {}
    t = time.perf_counter()
    yolo, rekt, thresh = stem_serving(dev, smi, frames_np, folded, rfolded, launches)
    secs["bf16 serving"] = time.perf_counter() - t
    t = time.perf_counter()
    stem_kpt_pad(smi, frames, yolo, rekt, thresh, launches)
    secs["kpt_pad"] = time.perf_counter() - t
    t = time.perf_counter()
    stem_int8(dev, smi, frames, bundles, folded, entry_models, thresh_q, fps_int8,
              launches)
    secs["int8, from_params"] = time.perf_counter() - t
    t = time.perf_counter()
    stem_oversize_cli(smi, thresh)
    secs["oversize cli"] = time.perf_counter() - t
    t = time.perf_counter()
    stem_training(dev, smi)
    secs["training"] = time.perf_counter() - t
    for k, v in launches.items():
        check(v and all(n == (1 if path == "kpt_pad_pipeline" else STEM_EAGER)
                        for path, n in v.items()),
              f"{k}: not launched once a request on the stem_crop paths: {v}")
        rows[k]["launches_stem_crop"] = v
    took = time.perf_counter() - t0
    log(f"stem_crop seconds by part: {({k: round(v, 1) for k, v in secs.items()})} on {smi}")
    log(f"phase stem_crop: {took:.1f} s on {smi}")
    check(took < STEM_PHASE_S, f"phase stem_crop took {took:.1f} s")


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
    fps_bf16, eager_bf16 = phase_serve_bf16(dev, frames_np, thresh, smi)
    bundles = quantize_on_card(dev, frames_np)
    phase_repairs(dev, frames_np, bundles)
    phase_k4(dev, rows, bundles[2], frames_np)
    yolo_q, rekt_q, thresh_q = phase_slice_int8(dev, frames_np, bundles)
    launches, fps_int8, eager_int8 = phase_serve_int8(yolo_q, rekt_q, frames_np,
                                                      thresh_q, smi)
    log(f"served frames/s at B={B_SERVE}, graphed (eager): int8 {fps_int8!r} "
        f"({eager_int8!r}), bf16 {fps_bf16!r} ({eager_bf16!r}); graphed/eager int8 "
        f"{fps_int8 / eager_int8!r}, bf16 {fps_bf16 / eager_bf16!r} on {smi}")
    phase_microbatch(yolo_q, rekt_q, frames_np, thresh_q, smi)
    phase_detect(dev, smi)
    phase_cli(dev, frames_np, thresh, thresh_q, smi)
    for name, n in launches.items():
        rows[name]["launches"] = n
    phase_k5(dev, rows, bundles, yolo_q, frames_np)
    phase_probes(dev, rows, yolo_q, rekt_q, frames_np, thresh_q, smi)
    phase_k2_bwd(dev, rows)
    phase_train_agree(dev)
    phase_train_card(dev, smi, rows)
    phase_driver(dev)
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        yolo_run = phase_yolo(dev, smi, root)
        t0 = time.perf_counter()
        rekt_pt = phase_rektnet_disk(dev, smi, root)
        log(f"phase rektnet_disk: {time.perf_counter() - t0:.1f} s on {smi}")
        t0 = time.perf_counter()
        phase_eval_cli(dev, smi, root, yolo_run, rekt_pt)
        log(f"phase eval_cli: {time.perf_counter() - t0:.1f} s on {smi}")
        t0 = time.perf_counter()
        phase_export_hyper(dev, smi, root, yolo_run, rekt_pt)
        log(f"phase export_hyper: {time.perf_counter() - t0:.1f} s on {smi}")
    phase_multi_device(dev, smi, rows, frames_np, thresh, thresh_q, bundles)
    phase_tp_spatial(dev, smi)
    phase_stem_crop(dev, smi, rows, frames_np, bundles, (yolo_q, rekt_q), thresh_q,
                    fps_int8)
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
