"""Serving wrapper: fused pipeline + adaptive crop capacity (counterpart of
the JAX package's ``infer/serving.py``, bf16/f32 weights).

The server owns what a serving process needs around
:func:`~.pipeline.two_stage_pipeline`:

- the ``AdaptiveCapacity`` policy (p99-margin crop capacity with shrink
  hysteresis, quantised into a few buckets), shared with the JAX package;
- ``warmup()``, which runs each (batch, capacity) bucket once before
  serving, so the kernels are built and cuDNN has met every shape;
- short batches padded up to a warmed batch size on the device and sliced
  back;
- load observation every ``observe_every`` batches, deferred by one cycle:
  the mask is copied to pinned host memory behind the batch and read only
  at the next observation, so the host waits for that batch alone and
  never drains the batches queued after it. Only the first observation
  (the policy's bootstrap) is fenced at once.

Not ported: the int8 configuration (ROADMAP Queue 1 item 7), the device
mesh, the fenced latency mode (``measure_latency``,
``defer_observation=False``), the compile-on-grow and no-pad switches, and
the windowed-crop oversize watch with its auto-degrade, which existed only
for the TPU crop kernel's window contract — the CUDA crop has no box-size
limit.

Usage::

    server = TwoStageServer(yolo, rekt, conf_thresh=0.8,
                            policy=AdaptiveCapacity(floor=64, quantum=16))
    server.warmup([8], capacities=[64, 80, 96, 112])
    out = server(frames)        # PipelineOut
    server.stats()
"""

from __future__ import annotations

import time
from collections import deque
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch import _shared
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
    PipelineOut,
    two_stage_pipeline,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import Darknet
from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import RektNet


class _Observation(NamedTuple):
    t0: float
    B0: int              # real (unpadded) batch size
    cap: int             # crop capacity the batch ran with
    mask: torch.Tensor   # (B, K) bool on the host (pinned when from CUDA)
    ready: Optional[torch.cuda.Event]  # recorded behind the copy


PAD_MAX_FACTOR = 4     # pad a short batch to at most 4× its size
LATENCY_WINDOW = 256   # timing samples kept per ring


class TwoStageServer:
    """Callable serving frontend over the fused detect→crop→keypoints
    pipeline with policy-driven crop capacity.

    After :meth:`warmup`, a policy want that was not warmed is mapped to
    the nearest warmed capacity ≥ the want (or the largest warmed one,
    counted in ``capacity_exhausted``), so serving only runs shapes that
    have run before."""

    def __init__(self, yolo: Darknet, rekt: RektNet, *,
                 conf_thresh: float = 0.8, nms_thresh: float = 0.25,
                 max_det: int = 16, policy=None, observe_every: int = 8,
                 yolo_q=None, stem_q=None, rekt_q=None, entry_q=None):
        if any(q is not None for q in (yolo_q, stem_q, rekt_q, entry_q)):
            raise NotImplementedError(
                "int8 serving is not ported yet: ROADMAP.md Queue 1 item 7 "
                "(hand-written int8 convolution, then kernels K4 and K5)")
        self.yolo, self.rekt = yolo, rekt
        self.spec = yolo.spec
        self.device = next(yolo.parameters()).device
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh
        self.max_det = max_det
        self.policy = policy or _shared.capacity().AdaptiveCapacity()
        self.observe_every = max(1, observe_every)
        self.calls = 0
        self.current_capacity: Optional[int] = None
        self.warmed: set[tuple[int, int]] = set()   # (batch, capacity)
        self.seen: set[tuple[int, int]] = set()     # buckets executed
        self.cold_calls = 0       # serving calls on a bucket never run
        self.bucket_clamps = 0    # wants redirected to a run bucket
        self.capacity_exhausted = 0  # wants ABOVE every run bucket
        self.batch_pads = 0       # short batches padded up to a warmed B
        self.pad_spurious = 0     # detections fired by zero pad frames
        self.warmup_seconds = 0.0
        # fenced samples (the bootstrap): true dispatch→complete batch
        # latency. Deferred samples: dispatch → read one observation cycle
        # later, a pipeline-depth statistic.
        self.latencies: deque[tuple[int, float]] = deque(maxlen=LATENCY_WINDOW)
        self.pipeline_walls: deque[tuple[int, float]] = deque(
            maxlen=LATENCY_WINDOW)
        self._pending: Optional[_Observation] = None

    # -- buckets --------------------------------------------------------------

    def warmup(self, batch_sizes: Iterable[int],
               capacities: Sequence[int]) -> float:
        """Run every (batch, capacity) bucket once on zero frames in the
        detector's dtype and wait for it. Returns the seconds spent (also
        accumulated in ``warmup_seconds``)."""
        size = self.spec.net.height
        dtype = next(self.yolo.parameters()).dtype
        t0 = time.perf_counter()
        for B in batch_sizes:
            frames = torch.zeros((B, size, size, self.spec.net.channels),
                                 dtype=dtype, device=self.device)
            for cap in capacities:
                cap = int(min(cap, B * self.max_det))
                self._run(frames, cap).scores.cpu()  # waits for the bucket
                self.warmed.add((B, cap))
                self.seen.add((B, cap))
        self.warmup_seconds += time.perf_counter() - t0
        return self.warmup_seconds

    def _pick_bucket(self, B: int, want: int) -> int:
        """Map the policy's want onto a bucket already run for this batch
        size: the nearest one ≥ want (``bucket_clamps``), else the largest
        (``capacity_exhausted``: extend the lattice with another
        :meth:`warmup`)."""
        run = sorted(c for (b, c) in (self.warmed | self.seen) if b == B)
        if not run:
            return want
        bigger = [c for c in run if c >= want]
        if bigger:
            if bigger[0] != want:
                self.bucket_clamps += 1
            return bigger[0]
        self.capacity_exhausted += 1
        self.bucket_clamps += 1
        return run[-1]

    # -- serving --------------------------------------------------------------

    def _pad_batch(self, frames):
        """Zero-pad a short batch on the device up to the smallest run
        batch size ≤ ``PAD_MAX_FACTOR``·B (``batch_pads``); returns
        ``(frames, real batch size)``. Zero frames may fire detections with
        untrained weights; those are counted in ``pad_spurious``."""
        B0 = int(frames.shape[0])
        run = sorted({b for (b, _) in (self.warmed | self.seen)})
        target = next((b for b in run
                       if B0 <= b <= PAD_MAX_FACTOR * B0), None)
        if target is None or target == B0:
            return frames, B0
        pad = torch.zeros((target - B0, *frames.shape[1:]),
                          dtype=frames.dtype, device=frames.device)
        self.batch_pads += 1
        return torch.cat([frames, pad]), B0

    def _run(self, frames, cap: int) -> PipelineOut:
        return two_stage_pipeline(
            self.yolo, self.rekt, frames, conf_thresh=self.conf_thresh,
            nms_thresh=self.nms_thresh, max_det=self.max_det,
            crop_capacity=cap)

    def __call__(self, frames) -> PipelineOut:
        frames = torch.as_tensor(frames).to(self.device, non_blocking=True)
        frames, B0 = self._pad_batch(frames)
        B = int(frames.shape[0])
        cap = self.policy.capacity(B, self.max_det)
        if self.warmed:
            cap = self._pick_bucket(B, cap)
        if (B, cap) not in self.seen:
            self.cold_calls += 1
            self.seen.add((B, cap))
        self.current_capacity = cap
        # the first observation is taken at once: the policy needs one
        # load sample before it can size capacity
        bootstrap = len(self.policy.loads) == 0 and self._pending is None
        observing = (self.calls + 1) % self.observe_every == 0 or bootstrap
        if observing:
            self._materialize_pending(on_cadence=True)
        t0 = time.perf_counter()
        full = self._run(frames, cap)
        self.calls += 1
        if observing:
            obs = self._stash(t0, B0, cap, full.mask)
            if bootstrap:
                self._observe(obs, ring=self.latencies)
            else:
                self._pending = obs
        return full if B == B0 else PipelineOut(*(x[:B0] for x in full))

    @staticmethod
    def _stash(t0: float, B0: int, cap: int, mask) -> _Observation:
        """Queue the mask's device→host copy behind the batch."""
        if not mask.is_cuda:
            return _Observation(t0, B0, cap, mask, None)
        host = torch.empty(mask.shape, dtype=torch.bool, pin_memory=True)
        with torch.inference_mode():
            host.copy_(mask, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(mask.device))
        return _Observation(t0, B0, cap, host, ready)

    def _materialize_pending(self, on_cadence: bool = False) -> None:
        """Read the stashed observation, if any. Only the dispatch-path call
        (``on_cadence``) records its wall time: a drain from ``stats()``
        would time the caller's schedule, not the server."""
        if self._pending is not None:
            pend, self._pending = self._pending, None
            self._observe(pend, ring=self.pipeline_walls if on_cadence
                          else None)

    def _observe(self, obs: _Observation,
                 ring: Optional[deque] = None) -> None:
        """Wait for the observed batch alone, then feed the policy (mask
        sum), the timing ring (if any) and pad_spurious."""
        if obs.ready is not None:
            obs.ready.synchronize()
        if ring is not None:
            ring.append((obs.B0, (time.perf_counter() - obs.t0) * 1000.0))
        mask = obs.mask.numpy().astype(bool)
        self.policy.observe(int(mask.sum()), obs.cap)
        if mask.shape[0] != obs.B0:
            self.pad_spurious += int(mask[obs.B0:].sum())

    # -- observability ----------------------------------------------------------

    @staticmethod
    def _pct(ring) -> dict:
        batch_ms = np.asarray([ms for _, ms in ring], np.float64)
        frame_ms = np.asarray([ms / max(1, b) for b, ms in ring], np.float64)

        def pct(a):
            return {p: float(np.percentile(a, p)) for p in (50, 95, 99)}

        return {"batch_ms": pct(batch_ms), "frame_ms": pct(frame_ms)}

    def latency_stats(self) -> dict:
        """p50/p95/p99 of the fenced latencies (``latency_*``: the
        bootstrap sample) and of the deferred pipeline walls
        (``pipeline_wall_ms``, a depth statistic, not a latency)."""
        self._materialize_pending()
        out = {"latency_samples": len(self.latencies),
               "latency_batch_ms": None, "latency_frame_ms": None,
               "pipeline_samples": len(self.pipeline_walls),
               "pipeline_wall_ms": None,
               "pipeline_depth": self.observe_every}
        if self.latencies:
            p = self._pct(self.latencies)
            out["latency_batch_ms"] = p["batch_ms"]
            out["latency_frame_ms"] = p["frame_ms"]
        if self.pipeline_walls:
            out["pipeline_wall_ms"] = self._pct(self.pipeline_walls)["batch_ms"]
        return out

    def stats(self) -> dict:
        """Serving counters; reads any stashed observation first."""
        self._materialize_pending()
        return {
            "calls": self.calls,
            "cold_calls": self.cold_calls,
            "bucket_clamps": self.bucket_clamps,
            "capacity_exhausted": self.capacity_exhausted,
            "batch_pads": self.batch_pads,
            "pad_spurious": self.pad_spurious,
            "warmed_buckets": sorted(self.warmed),
            "warmup_seconds": self.warmup_seconds,
            "overflows": self.policy.overflows,
            "observations": self.policy.observations,
            "grows": self.policy.grows,
            "shrinks": self.policy.shrinks,
            "current_capacity": self.current_capacity,
            "mean_load": (float(np.mean(self.policy.loads))
                          if self.policy.loads else None),
            **self.latency_stats(),
        }
