"""Serving wrapper: fused pipeline + adaptive crop capacity (counterpart of
the JAX package's ``infer/serving.py``).

The server serves the bf16/f32 configuration (``Darknet`` + ``RektNet``,
:func:`~.pipeline.two_stage_pipeline`) or the int8 one (``Int8Darknet`` +
``Int8RektNet``, ``two_stage_pipeline_int8``, the same function), as
the models it is given are, and owns what a serving process needs around
the pipeline:

- the ``AdaptiveCapacity`` policy (p99-margin crop capacity with shrink
  hysteresis, quantised into a few buckets), ``infer/capacity.py``;
- ``warmup()``, the bucket lattice built before serving. The JAX server
  compiles one XLA program per (batch, capacity) bucket there, so that a
  request is one dispatch. Here, on a CUDA device, each (batch, capacity,
  frame dtype) bucket runs once eagerly on a side stream (the kernels'
  build, K4's shared-memory attribute, cuDNN's autotune, cuBLAS's
  workspace, the per-device tables are all made then) and is then
  captured as a CUDA graph (``torch.cuda.CUDAGraph``) into a static frame
  buffer. A request on a captured bucket copies its frames into that
  buffer (zero-padding a short batch in place), replays the graph and
  returns fresh copies of the four outputs, never the static ones. A
  request whose (batch, capacity, frame shape, dtype) has no graph yet (a
  bucket not warmed, grown past the lattice with ``grow_past_warmed``, or
  a frame size or dtype that warmup did not see) is captured at its first
  use, as the JAX server compiles on first use, and counted in
  ``compiles``. A failed capture raises: a request is never served
  eagerly instead. On the CPU nothing is captured: every bucket runs
  eagerly, as it does on the card with ``cuda_graphs=False`` (the eager
  baseline that graphed serving is measured against). The graphs of a
  server share one memory pool and one capture stream: replays come one
  after another on the caller's stream, and the static outputs stay
  alive, so no replay writes over another's output, and each bucket's
  eager run before its capture reuses the blocks of the one before;
- short batches padded with zero frames up to a run batch size
  (``pad_to_batch``, at most ``pad_max_factor``× the batch) and sliced
  back;
- load observation every ``observe_every`` batches. Deferred by one cycle
  (``defer_observation=True``): the mask is copied to pinned host memory
  behind the batch and read at the next observation, so the host waits
  for that batch alone and never drains the batches queued after it; only
  the first observation (the policy's bootstrap) is fenced at once. With
  ``defer_observation=False`` every observation is fenced at once (the
  latency operating point), and :meth:`measure_latency` takes fenced
  samples at will.

Each kernel wrapper counts its launches (``fn.launches``) where it
launches its kernel. A replay calls no wrapper and moves no count: the
kernels a replay ran are counted by name from a profiler's record of the
device (``chip_smoke.py``: ``profiled_launches``).

Several devices (``mesh=``, a device mesh of ``parallel/mesh.py``): one
process drives every device of the mesh, as the JAX server is one
controller. A batch is padded to a run batch size that is a multiple of
the mesh size (with no usable one, to the next multiple of the mesh size)
and split into contiguous equal shards; each device runs detection, NMS
and the compacted crop path on its shard, from a copy of the models on it
(its own CUDA graph a bucket on the card). The crop compaction stays
batch-global: a shard's own top-C holds every slot of the global top-C
that lies in it, so the shards' keypoints are gathered to the lead device
(the mesh's first) with the (B, K) masks and scores, the global top-C is
taken there, and keypoints outside it are zeroed. Masks and boxes equal
the server's without a mesh, also when the valid detections exceed the
capacity; outputs come back on the lead device. A batch that does not
divide raises, as the JAX server does.

The server takes models: a ``Darknet`` (its packed stem built in, when
given ``packed_stem``) or an ``Int8Darknet``, and a ``RektNet`` or an
``Int8RektNet``. :meth:`TwoStageServer.from_params` builds the int8 pair
from the JAX server's bundles instead (``yolo_q``, ``stem_q``, ``rekt_q``,
``entry_q``: the port's ``models.quantize`` / ``ops.entry`` output, or the
JAX package's through ``convert.quantized_from_jax``).

The crop kernel's oversize watch (``crop_kernel``): where the JAX server
serves the TPU's windowed crop kernel, it counts the observed valid boxes
past the kernel's DMA window and, past a share of them, moves to its
exact crop for good. Here the crop is K1 either way, which has no window
and samples every box exactly (``ops/cuda_crop.py``), so no box is ever
past it. ``stats()`` carries the JAX server's four keys with their
meaning, derived: ``oversize_observed`` is the running sum of the observed
masks and ``oversize_boxes`` 0 (both None with ``crop_kernel`` off),
``crop_kernel_active`` is ``crop_kernel`` and ``crop_kernel_switches`` 0.

Usage::

    server = TwoStageServer(yolo, rekt, conf_thresh=0.8,
                            policy=AdaptiveCapacity(floor=64, quantum=16))
    server.warmup([8], capacities=[64, 80, 96, 112], frame_dtype=torch.uint8)
    out = server(frames)        # PipelineOut of fresh tensors
    server.stats()
"""

from __future__ import annotations

import functools
import time
from collections import deque
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import (
    AdaptiveCapacity,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
    PipelineOut,
    kept_slots,
    top_crop_slots,
    two_stage_pipeline,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import YoloHeads
from mit_driverless_cv_traininginfra_tpu_torch.models.quantize import (
    Int8Darknet,
    Int8RektNet,
)
from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import (
    batch_sharding,
    replicate,
)


class _Observation(NamedTuple):
    t0: float
    B0: int              # real (unpadded) batch size
    cap: int             # crop capacity the batch ran with
    mask: torch.Tensor   # (B, K) bool on the host (pinned when from CUDA)
    ready: Optional[torch.cuda.Event]  # recorded behind the copy


class _BucketGraph:
    """One bucket captured as a CUDA graph: the static frame buffer it
    reads and the static ``PipelineOut`` it writes."""

    def __init__(self, run, B: int, cap: int, frame_shape, dtype, device,
                 pool, stream):
        self.frames = torch.zeros((B, *frame_shape), dtype=dtype,
                                  device=device)
        # once per device or process, before capture: what the first run
        # builds, sets, tunes or copies to the device (a host→device copy
        # inside a capture is illegal). The same stream then captures, so
        # cuBLAS's workspace for it exists already.
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            run(self.frames, cap)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.out = run(self.frames, cap)

    def __call__(self, frames) -> PipelineOut:
        """Copy ``frames`` (B0 ≤ B of them, any device) into the static
        buffer, zero its rows past B0, replay, and return copies of the
        outputs."""
        B0 = frames.shape[0]
        self.frames[:B0].copy_(frames, non_blocking=True)
        if B0 < self.frames.shape[0]:
            self.frames[B0:].zero_()
        self.graph.replay()
        return PipelineOut(*(x.clone() for x in self.out))


class TwoStageServer:
    """Callable serving frontend over the fused detect→crop→keypoints
    pipeline with policy-driven crop capacity.

    After :meth:`warmup`, a policy want that was not warmed is mapped to
    the nearest run capacity ≥ the want (``bucket_clamps``), or, above
    every run one, to the largest (``capacity_exhausted``), or with
    ``grow_past_warmed`` to the want itself, a new bucket (counted in
    ``compiles``; on CUDA captured at that request).

    ``crop_kernel``: whether the crop is reported as the crop kernel, with
    its oversize watch (module docstring); None is on when the server's
    device is CUDA (the JAX server's "auto", the card in the TPU's
    place)."""

    def __init__(self, yolo: YoloHeads, rekt, *,
                 conf_thresh: float = 0.8, nms_thresh: float = 0.25,
                 max_det: int = 16, crop_size: int = 80,
                 policy: Optional[AdaptiveCapacity] = None,
                 observe_every: int = 8, crop_kernel: Optional[bool] = None,
                 grow_past_warmed: bool = False,
                 pad_to_batch: bool = True, pad_max_factor: int = 4,
                 latency_window: int = 256, defer_observation: bool = True,
                 cuda_graphs: bool = True, mesh=None):
        self.yolo, self.rekt = yolo, rekt
        self.spec = yolo.spec
        self.mesh = mesh
        if mesh is not None:
            if mesh.group is not None:
                raise ValueError("TwoStageServer takes a device mesh (make_mesh), "
                                 "not a process mesh")
            # (device, detector, keypoint net) a shard
            self._shards = list(zip(mesh.devices, replicate(mesh, yolo),
                                    replicate(mesh, rekt)))
        self.device = yolo.device if mesh is None else mesh.devices[0]
        self.frame_dtype = yolo.frame_dtype
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh
        self.max_det = max_det
        self.crop_size = crop_size
        self.policy = policy or AdaptiveCapacity()
        self.observe_every = max(1, observe_every)
        self.grow_past_warmed = grow_past_warmed
        self.pad_to_batch = pad_to_batch
        self.pad_max_factor = pad_max_factor
        self.defer_observation = defer_observation
        self.calls = 0
        self.current_capacity: Optional[int] = None
        self.warmed: set[tuple[int, int]] = set()   # (batch, capacity)
        self.seen: set[tuple[int, int]] = set()     # buckets executed
        self.compiles = 0         # serving calls on a bucket never run
        self.bucket_clamps = 0    # wants redirected to a run bucket
        self.capacity_exhausted = 0  # wants ABOVE every run bucket
        self.batch_pads = 0       # short batches padded up to a run B
        self.pad_spurious = 0     # detections fired by zero pad frames
        self.warmup_seconds = 0.0
        self.crop_kernel = (self.device.type == "cuda" if crop_kernel is None
                            else bool(crop_kernel))
        self.oversize_observed = 0   # valid boxes of the observed batches
        # CUDA graphs: the graph of each (shard, batch, capacity, frame
        # shape, dtype) (shard None without a mesh), and a pool and capture
        # stream a device
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self._graphs: dict[tuple, _BucketGraph] = {}
        self._capture: dict[torch.device, tuple] = {}
        self.replays = 0
        # fenced samples (defer_observation=False, the bootstrap,
        # measure_latency): dispatch → mask on the host, a true batch
        # latency. Deferred samples: dispatch → read one observation cycle
        # later, a pipeline-depth statistic.
        self.latencies: deque[tuple[int, float]] = deque(maxlen=latency_window)
        self.pipeline_walls: deque[tuple[int, float]] = deque(
            maxlen=latency_window)
        self._pending: Optional[_Observation] = None

    @classmethod
    def from_params(cls, spec, yolo_q, stem_q, rekt_q, entry_q=None, **kw):
        """The int8 server from the JAX server's bundles, in the port's
        layout: ``Int8Darknet(spec, yolo_q, entry_q=entry_q,
        stem_q=stem_q)`` and ``Int8RektNet(rekt_q)``, on the bundles'
        device. ``kw`` goes to the constructor."""
        yolo = Int8Darknet(spec, yolo_q, entry_q=entry_q, stem_q=stem_q)
        return cls(yolo.eval(), Int8RektNet(rekt_q).eval(), **kw)

    # -- buckets --------------------------------------------------------------

    def warmup(self, batch_sizes: Iterable[int],
               capacities: Optional[Sequence[int]] = None,
               frame_size: Optional[int] = None, frame_dtype=None,
               pad_sizes: Optional[Sequence[int]] = None) -> float:
        """Build the (batch, capacity) bucket lattice for frames of
        ``frame_size``² (default the spec's input) in ``frame_dtype``
        (default the detector's ``frame_dtype``; pass what requests will
        carry: uint8 for a wire feed normalised on the device; float frames
        are served in the detector's ``frame_dtype``). On CUDA
        each bucket is run once eagerly and captured; on the CPU it is run
        once. ``capacities`` defaults to every policy bucket from ``floor``
        to one quantum above the larger of the policy's want and its held
        bucket, read without ``policy.capacity()`` (which would advance
        the shrink hysteresis). ``pad_sizes`` runs the short-batch path
        once for each of those batch sizes. Returns the seconds spent (also
        accumulated in ``warmup_seconds``)."""
        size = frame_size or self.spec.net.height
        dtype = self._served_dtype(frame_dtype or self.frame_dtype)
        shape = (size, size, self.spec.net.channels)
        t0 = time.perf_counter()
        for B in batch_sizes:
            caps = capacities
            if caps is None:
                # cover the window's raw want and the held bucket: after a
                # burst the policy serves at its held bucket even when the
                # window's p99 has dipped
                want = (self.policy._want() if self.policy.loads
                        else self.policy.warmup_capacity)
                held = self.policy._current or 0
                top = (max(want, held, self.policy.floor)
                       + self.policy.quantum)
                caps = list(range(self.policy.floor, top + 1,
                                  self.policy.quantum))
            for cap in caps:
                cap = int(min(cap, B * self.max_det))
                if self.cuda_graphs:
                    for key in self._keys(B, cap, shape, dtype):
                        self._graph(key)
                else:
                    frames = torch.zeros((B, *shape), dtype=dtype,
                                         device=self.device)
                    self._dispatch(frames, B, cap).scores.cpu()
                self.warmed.add((B, cap))
                self.seen.add((B, cap))
        for ps in pad_sizes or ():
            ps = int(ps)
            B = self._pad_target(ps)
            if B != ps:
                self.batch_pads -= 1      # a warmup pad is not an event
            cap = next((c for (b, c) in sorted(self.warmed) if b == B), None)
            if cap is not None:
                short = torch.zeros((ps, *shape), dtype=dtype)
                self._dispatch(short, B, cap).scores[:ps].cpu()
        self.warmup_seconds += time.perf_counter() - t0
        return self.warmup_seconds

    def _graph(self, key: tuple) -> None:
        """Capture the CUDA graph of ``key``, (shard, batch, capacity, frame
        shape, dtype), unless it exists."""
        if key not in self._graphs:
            shard, *bucket = key
            dev = self.device if shard is None else self._shards[shard][0]
            run = self._run if shard is None else functools.partial(self._run,
                                                                    shard=shard)
            with torch.cuda.device(dev):
                if dev not in self._capture:
                    self._capture[dev] = (torch.cuda.graph_pool_handle(),
                                          torch.cuda.Stream(dev))
                self._graphs[key] = _BucketGraph(run, *bucket, dev,
                                                 *self._capture[dev])

    def _keys(self, B: int, cap: int, shape, dtype) -> list:
        """The graph keys a (B, cap) request of frames ``shape``/``dtype``
        runs: one, or one a shard of the mesh."""
        if self.mesh is None:
            return [(None, B, cap, tuple(shape), dtype)]
        return [(s, rows.stop - rows.start, cap, tuple(shape), dtype)
                for s, (_, rows) in enumerate(batch_sharding(self.mesh, B))]

    def _pick_bucket(self, B: int, want: int) -> int:
        """Map the policy's want onto a bucket already run for this batch
        size: the nearest one ≥ want (``bucket_clamps``); above every run
        one, the want itself with ``grow_past_warmed`` (a new bucket, to be
        captured), else the largest (``capacity_exhausted``: extend the
        lattice with another :meth:`warmup`)."""
        run = sorted(c for (b, c) in (self.warmed | self.seen) if b == B)
        if not run:
            return want
        bigger = [c for c in run if c >= want]
        if bigger:
            if bigger[0] != want:
                self.bucket_clamps += 1
            return bigger[0]
        if self.grow_past_warmed:
            return want
        self.capacity_exhausted += 1
        self.bucket_clamps += 1
        return run[-1]

    # -- serving --------------------------------------------------------------

    def _pad_target(self, B0: int) -> int:
        """The batch size a batch of ``B0`` runs at: with ``pad_to_batch``,
        the smallest run batch size in [B0, ``pad_max_factor``·B0]
        that is a multiple of the mesh size (``batch_pads`` counts a pad),
        else B0. Zero frames may fire detections with untrained weights;
        those are counted in ``pad_spurious``. A batch with no such size
        runs unpadded, a new bucket; under a mesh it is padded to the next
        multiple of the mesh size."""
        if not self.pad_to_batch:
            return B0
        n = 1 if self.mesh is None else self.mesh.size
        run = sorted({b for (b, _) in (self.warmed | self.seen) if b % n == 0})
        target = next((b for b in run
                       if B0 <= b <= self.pad_max_factor * B0), -(-B0 // n) * n)
        if target != B0:
            self.batch_pads += 1
        return target

    def _served_dtype(self, dtype):
        """Frames are served as uint8 (normalised on the device) or in the
        detector's ``frame_dtype``, to which other float frames are cast."""
        return torch.uint8 if dtype == torch.uint8 else self.frame_dtype

    def _run(self, frames, cap: int, shard=None) -> PipelineOut:
        yolo, rekt = ((self.yolo, self.rekt) if shard is None
                      else self._shards[shard][1:])
        return two_stage_pipeline(
            yolo, rekt, frames, conf_thresh=self.conf_thresh,
            nms_thresh=self.nms_thresh, max_det=self.max_det,
            crop_size=self.crop_size, crop_capacity=cap)

    def _dispatch(self, frames, B: int, cap: int) -> PipelineOut:
        """Run ``frames`` (B0 ≤ B of them, any device) as bucket (B, cap),
        padded with zero frames to B: by graph replay where this bucket,
        frame shape and dtype were captured, else eagerly; under a mesh,
        shard by shard, then merged (:meth:`_merge`)."""
        keys = self._keys(B, cap, frames.shape[1:], frames.dtype)
        if self.mesh is None:
            return self._dispatch_shard(keys[0], frames)
        if frames.shape[0] < B:
            pad = frames.new_zeros((B - frames.shape[0], *frames.shape[1:]))
            frames = torch.cat([frames, pad])
        return self._merge([self._dispatch_shard(key, frames[rows]) for key, (_, rows)
                            in zip(keys, batch_sharding(self.mesh, B))], cap)

    def _dispatch_shard(self, key: tuple, frames) -> PipelineOut:
        graph = self._graphs.get(key)
        if graph is not None:
            out = graph(frames)
            self.replays += 1
            return out
        shard, B = key[0], key[1]
        dev = self.device if shard is None else self._shards[shard][0]
        frames = frames.to(dev, non_blocking=True)
        if frames.shape[0] < B:
            pad = frames.new_zeros((B - frames.shape[0], *frames.shape[1:]))
            frames = torch.cat([frames, pad])
        return self._run(frames, key[2], shard=shard)

    def _merge(self, outs, cap: int) -> PipelineOut:
        """The shards' outputs on the lead device, with the batch-global
        crop compaction: each shard kept its own top ``cap`` slots, a
        superset of the global top ``cap`` within it (the order is the
        same, restricted to the shard), so keypoints outside the global
        top ``cap`` are zeroed."""
        boxes, scores, mask, kpts = (
            torch.cat([o[i].to(self.device, non_blocking=True) for o in outs])
            for i in range(4))
        if cap < mask.numel():
            kept = kept_slots(top_crop_slots(mask, scores, cap), mask)
            kpts = torch.where(kept[..., None, None], kpts,
                               torch.zeros((), device=kpts.device))
        return PipelineOut(boxes, scores, mask, kpts)

    def _as_frames(self, frames):
        frames = torch.as_tensor(frames)
        return frames.to(self._served_dtype(frames.dtype))

    def __call__(self, frames) -> PipelineOut:
        frames = self._as_frames(frames)
        B0 = int(frames.shape[0])
        B = self._pad_target(B0)
        cap = self.policy.capacity(B, self.max_det)
        if self.warmed:
            cap = self._pick_bucket(B, cap)
        fresh = (B, cap) not in self.seen
        for key in self._keys(B, cap, frames.shape[1:], frames.dtype):
            if self.cuda_graphs and key not in self._graphs:
                self._graph(key)  # a capture while serving is a compile
                fresh = True
        self.seen.add((B, cap))
        self.compiles += fresh
        self.current_capacity = cap
        # the first observation is taken at once: the policy needs one
        # load sample before it can size capacity
        bootstrap = len(self.policy.loads) == 0 and self._pending is None
        observing = (self.calls + 1) % self.observe_every == 0 or bootstrap
        if observing and self.defer_observation:
            self._materialize_pending(on_cadence=True)
        t0 = time.perf_counter()
        full = self._dispatch(frames, B, cap)
        self.calls += 1
        if observing:
            obs = self._stash(t0, B0, cap, full.mask)
            if self.defer_observation and not bootstrap:
                self._pending = obs
            else:
                self._observe(obs, ring=self.latencies)
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
        sum), the timing ring (if any), pad_spurious and
        ``oversize_observed``."""
        if obs.ready is not None:
            obs.ready.synchronize()
        if ring is not None:
            ring.append((obs.B0, (time.perf_counter() - obs.t0) * 1000.0))
        mask = obs.mask.numpy().astype(bool)
        n_valid = int(mask.sum())
        self.policy.observe(n_valid, obs.cap)
        self.oversize_observed += n_valid
        if mask.shape[0] != obs.B0:
            self.pad_spurious += int(mask[obs.B0:].sum())

    def measure_latency(self, frames, n: int = 32, warm: int = 3) -> dict:
        """Fenced batch and frame latency percentiles at the current
        operating point: serves ``n`` requests of ``frames`` with
        ``defer_observation=False`` and ``observe_every=1``, so each
        request is fenced through its observation's mask read — a
        dispatch → mask-on-the-host sample with no batch queued ahead —
        after ``warm`` untimed, uncounted runs of the same bucket. Samples
        go to ``latencies``; returns :meth:`latency_stats`. The
        throughput-mode settings are restored afterwards."""
        saved = (self.defer_observation, self.observe_every)
        self._materialize_pending()       # flush any stashed sample first
        self.defer_observation, self.observe_every = False, 1
        try:
            frames = self._as_frames(frames)
            B = int(frames.shape[0])
            for _ in range(max(0, warm)):
                out = self._dispatch(frames, B, self.current_capacity
                                     or self.policy.capacity(B, self.max_det))
            if warm:
                out.scores.cpu()          # fence the warm runs
            for _ in range(n):
                self(frames)
        finally:
            self.defer_observation, self.observe_every = saved
        return self.latency_stats()

    # -- observability ----------------------------------------------------------

    @staticmethod
    def _pct(ring) -> dict:
        batch_ms = np.asarray([ms for _, ms in ring], np.float64)
        frame_ms = np.asarray([ms / max(1, b) for b, ms in ring], np.float64)

        def pct(a):
            return {p: float(np.percentile(a, p)) for p in (50, 95, 99)}

        return {"batch_ms": pct(batch_ms), "frame_ms": pct(frame_ms)}

    def latency_stats(self) -> dict:
        """p50/p95/p99 of the fenced latencies (``latency_*``) and of the
        deferred pipeline walls (``pipeline_wall_ms``, a depth statistic,
        not a latency)."""
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
        """Serving counters under the JAX server's keys, and the CUDA
        graphs captured and replayed; reads any stashed observation
        first."""
        self._materialize_pending()
        return {
            "calls": self.calls,
            "compiles": self.compiles,
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
            # the oversize watch's keys (module docstring): K1 has no window
            "oversize_boxes": 0 if self.crop_kernel else None,
            "oversize_observed": (self.oversize_observed if self.crop_kernel
                                  else None),
            "crop_kernel_active": self.crop_kernel,
            "crop_kernel_switches": 0,
            "graphs": len(self._graphs),
            "replays": self.replays,
            **self.latency_stats(),
        }
