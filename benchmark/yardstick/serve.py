"""What every served cell shares: the set-up (scenes, weights, the
operating threshold, the program's server), the arrival schedule, the
sample of answers judged against the reference, and the detector's and
keypoint net's own timings. The traffic's runners
(``benchmark/runners/<runner>.py``) drive the window on top of it; each
reads its parameters from the traffic file.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from . import arch, judge, port, reference, scenes, weights


@contextlib.contextmanager
def no_gc():
    """The cyclic collector held off for a window: its passes over the
    benchmark's own records (every answer of the window) would stall the
    program's threads for tens of milliseconds at a time. Reference counting
    still frees what the window drops. Nested, the inner one does nothing:
    a traced window collects before its profiler starts."""
    if not gc.isenabled():
        yield
        return
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def render_pool(rng: np.random.Generator, n: int, size: int, **scene) -> np.ndarray:
    """n seeded cone scenes, (n, size, size, 3) uint8; ``scene``: the
    traffic's density and sizes (:func:`scenes.cone_scene`'s keywords)."""
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        img, _ = scenes.cone_scene(rng, size=size, **scene)
        out[i] = np.rint(img * 255.0).astype(np.uint8)
    return out


def make_trees(cfg: dict, seed: int, device):
    """The configuration's YOLOv3 and RektNet weight trees from ``seed``."""
    gen = weights.generator(seed, device)
    return (weights.darknet_trees(cfg["detector"], gen, device),
            weights.rektnet_trees(cfg["keypoints"], gen, device))


class Setup:
    """What every served cell builds before its window: the scenes, the
    weights, the operating threshold from the reference's f32 confidences,
    the program's models and server, warmed for the traffic's buckets.
    :attr:`threshold_s` is the seconds the reference's threshold pass took:
    the benchmark's own work, which the runners take out of ``setup_s``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, hooks=None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        det = cfg["detector"]
        self.rng = np.random.default_rng(seed)
        self.pool = render_pool(self.rng, traffic["pool"], det["input"],
                                **traffic.get("scenes", {}))
        self.dtrees, self.ktrees = make_trees(cfg, seed, device)
        calib = torch.from_numpy(self.pool[:8]).to(device).float() * (1.0 / 255.0)
        self.calib_frames = calib.cpu().numpy()
        self.calib_crops = port.calib_crops(self.calib_frames, self.rng,
                                            size=cfg["keypoints"]["crop"])
        weights.match_darknet_bn(det, *self.dtrees, calib)
        weights.match_rektnet_bn(*self.ktrees, torch.from_numpy(self.calib_crops).to(device))
        t_ref = time.perf_counter()
        with torch.no_grad():
            ref = reference.Detector(det, reference.fold_darknet(det, *self.dtrees),
                                     reference.Numerics("f32"))
            frames = torch.from_numpy(self.pool).to(device)
            dets = torch.cat([ref.decode(frames[i:i + 8].float() * (1.0 / 255.0))
                              for i in range(0, len(frames), 8)])
        sv, load = cfg["serving"], traffic["threshold"]
        self.conf_thresh = reference.pick_conf_thresh(
            dets, sv["nms_thresh"], sv["max_det"], load["group"], load["max_detections"])
        del ref, frames, dets
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        self.threshold_s = time.perf_counter() - t_ref
        yolo, rekt = port.serving_models(cfg, self.dtrees, self.ktrees, device,
                                         self.calib_frames, self.calib_crops)
        self.server = port.server(cfg, yolo, rekt, self.conf_thresh)
        if hooks and "server" in hooks:
            self.server = hooks["server"](self.server)
        self.server.warmup(traffic["buckets"], capacities=cfg["serving"]["capacities"],
                           frame_dtype=torch.uint8)

    def free_program(self):
        self.server = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def reference(self, numerics: str):
        return reference.build(self.cfg, *self.dtrees, *self.ktrees, numerics,
                               torch.from_numpy(self.calib_frames).to(self.device),
                               torch.from_numpy(self.calib_crops).to(self.device),
                               self.conf_thresh)


def arrivals(rng: np.random.Generator, spec: dict, rate: float, seconds: float,
             n_scenes: int):
    """Due times and scenes of ``rate`` frames/s over ``seconds``, by the
    traffic's ``arrivals`` entry: ``streams`` periodic cameras, each with
    the period ``P = streams * burst / rate``; stream s starts at
    ``s * P / streams`` (``phase`` ``even``) or uniformly in ``[0, P)``
    (``random``); each trigger is jittered by up to ``jitter * P`` either
    way and sends ``burst`` frames at once (several cars' frames together;
    1: single frames). Each frame's scene is drawn from the pool. Every
    seed gets the same number of frames up to the edges of the window.
    Returns ``(due (n,), scene (n,))`` sorted by due time."""
    n, burst = spec["streams"], int(spec.get("burst", 1))
    period = n * burst / rate
    k = int(np.ceil(seconds / period)) + 1
    phase = (np.arange(n) * period / n if spec.get("phase", "even") == "even"
             else rng.uniform(0.0, period, n))
    base = phase[:, None] + np.arange(k)[None, :] * period
    due = base + rng.uniform(-spec["jitter"], spec["jitter"], base.shape) * period
    due = np.repeat(due.ravel(), burst)
    due = np.sort(due[(due >= 0) & (due < seconds)])
    return due, rng.integers(0, n_scenes, due.size)


def sample(rng: np.random.Generator, n: int, k: int):
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist()) if n else []


def judge_answers(st: Setup, answers, numerics: str):
    """Build the reference in ``numerics`` and judge ``answers``."""
    pipe = st.reference(numerics)
    scenes_u8 = torch.from_numpy(st.pool).to(st.device)
    ref = judge.reference_dets(pipe, scenes_u8)
    return judge.judge(answers, ref, pipe, scenes_u8, st.device)


def detector_ms(st: Setup, yolo, B: int, iters: int = 20) -> float:
    """CUDA-event ms of the program's detector alone on B served frames."""
    frames = torch.from_numpy(st.pool[:B]).to(st.device).float() * (1.0 / 255.0)
    frames = frames.to(yolo.frame_dtype)
    return _cuda_ms(lambda: yolo(frames), iters)


def keypoint_ms(st: Setup, rekt, n: int, dtype, iters: int = 20) -> float:
    """CUDA-event ms of the program's keypoint net alone on n crops of
    ``dtype``."""
    size = st.cfg["keypoints"]["crop"]
    g = torch.Generator(device=st.device).manual_seed(1)
    crops = torch.rand((n, size, size, 3), generator=g, device=st.device).to(dtype)
    return _cuda_ms(lambda: rekt(crops), iters)


@torch.inference_mode()
def _cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def kept_crops(answer_list) -> int:
    return sum(int((a["keypoints"][a["mask"].astype(bool)] != 0).any(axis=(1, 2)).sum())
               for a in answer_list if a is not None)


def served_flops(cfg: dict, frames: int, crops: int) -> float:
    return (frames * arch.detector_flops(cfg["detector"], served_attrs=5)
            + crops * arch.rektnet_flops(cfg["keypoints"]))
