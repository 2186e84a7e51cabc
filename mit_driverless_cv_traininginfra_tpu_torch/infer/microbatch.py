"""Micro-batching request aggregator for the serving frontend (counterpart
of the JAX package's ``infer/microbatch.py``).

A frame served alone pays the batch's fixed cost; batching the vehicle's
camera streams shares it. ``MicroBatcher`` aggregates concurrent
``submit(frame)`` calls into the smallest warmed batch bucket, runs them
as one batched call of the runner (a warmed
:class:`~.serving.TwoStageServer`: one graph replay a batch on the card)
and fans the per-frame results back out.

Design, as the JAX package's:

- one collector thread; requests queue in; after the first pending
  request the collector waits up to ``max_wait_ms`` for co-arrivals;
- batch = the smallest bucket ≥ pending, padded by repeating the first
  frame (the padding rows are discarded);
- results resolve per-request ``Future``s after one fetch of all four
  outputs: on the card, non-blocking copies into pinned host memory and
  one event wait (the fence), so a completed future's arrays are host
  numpy arrays;
- a runner error fails the callers of that batch, never the thread.

Batching is result-transparent where every stage is per-frame: run the
server with a capacity ≥ bucket·max_det, or accept the batch-global crop
capacity's lowest-score drops that a batched server has anyway.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def to_host(out) -> list[np.ndarray]:
    """The four outputs of a ``PipelineOut`` as numpy arrays. CUDA tensors
    are copied into pinned host memory behind the batch, without blocking,
    and one event wait fences them all."""
    tensors = (out.boxes, out.scores, out.mask, out.keypoints)
    if not tensors[0].is_cuda:
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    with torch.inference_mode():
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensors[0].device))
    done.synchronize()
    return [h.numpy() for h in host]


class MicroBatcher:
    """Aggregate concurrent single-frame requests into batched calls.

    Args:
        runner: ``fn(frames (B, H, W, C) numpy) -> PipelineOut``, typically
            a warmed :class:`~.serving.TwoStageServer`. Called only with
            batch sizes from ``bucket_sizes``.
        bucket_sizes: the warmed batch buckets.
        max_wait_ms: co-arrival window after the first pending request.
    """

    def __init__(self, runner: Callable,
                 bucket_sizes: Sequence[int] = (1, 2, 4, 8),
                 max_wait_ms: float = 2.0):
        self.runner = runner
        self.buckets = sorted(bucket_sizes)
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._frame_spec: Optional[tuple] = None  # (shape, dtype) of frame 0
        self._spec_lock = threading.Lock()
        # serialises submit() against stop(): a submit past the started
        # check must not enqueue after stop()'s drain, or its Future would
        # never resolve
        self._lifecycle_lock = threading.Lock()
        self.batches = 0
        self.frames = 0
        self.padded_frames = 0
        self.batch_counts: Counter = Counter()
        # per-request submit → resolve wall (ms): the co-arrival wait, the
        # device's time and the fetch, the latency a client sees
        self.request_ms: deque = deque(maxlen=1024)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "MicroBatcher":
        with self._lifecycle_lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lifecycle_lock:
            if self._thread is None:
                return
            self._stop.set()
            self._q.put(None)  # wake the collector
            thread, self._thread = self._thread, None
        thread.join()
        # fail any stragglers rather than leave their futures hanging
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._resolve(item[1],
                              exc=RuntimeError("MicroBatcher stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API ---------------------------------------------------------

    def submit(self, frame) -> Future:
        """Enqueue one (H, W, C) frame; the Future resolves to a dict of
        that frame's ``boxes``/``scores``/``mask``/``keypoints`` numpy
        rows. Every frame must have the first frame's shape and dtype (the
        buckets were warmed for them): a mismatch raises here, in the
        caller, not in the collector thread."""
        arr = np.asarray(frame)
        spec = (arr.shape, arr.dtype)
        with self._spec_lock:
            if self._frame_spec is None:
                self._frame_spec = spec
        if spec != self._frame_spec:
            raise ValueError(
                f"frame {spec} does not match the batcher's first frame "
                f"{self._frame_spec}; all submissions must share one "
                "shape/dtype")
        fut: Future = Future()
        with self._lifecycle_lock:
            if self._thread is None:
                raise RuntimeError("MicroBatcher not started")
            self._q.put((arr, fut, time.perf_counter()))
        return fut

    # -- collector ----------------------------------------------------------

    def _collect(self):
        """Block for the first request, then gather co-arrivals up to the
        largest bucket or the end of the wait window."""
        first = self._q.get()
        if first is None:
            return None
        pending = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(pending) < self.buckets[-1]:
            budget = deadline - time.perf_counter()
            if budget <= 0:
                break
            try:
                item = self._q.get(timeout=budget)
            except queue.Empty:
                break
            if item is None:
                break
            pending.append(item)
        return pending

    @staticmethod
    def _resolve(fut: Future, result=None, exc=None):
        """Resolve one future without raising: a caller that gave up and
        cancelled its future must not kill the collector."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:  # noqa: BLE001 — cancelled or already resolved
            pass

    def _loop(self):
        while not self._stop.is_set():
            futs = []
            try:
                pending = self._collect()
                if not pending:
                    continue
                frames = [p[0] for p in pending]
                futs = [p[1] for p in pending]
                n = len(frames)
                bucket = next((b for b in self.buckets if b >= n),
                              self.buckets[-1])
                pad = bucket - n
                batch = np.stack(frames + [frames[0]] * pad)
                boxes, scores, mask, kpts = to_host(self.runner(batch))
            except Exception as e:  # noqa: BLE001 — fail the callers,
                for f in futs:      # never the collector thread itself
                    self._resolve(f, exc=e)
                continue
            self.batches += 1
            self.frames += n
            self.padded_frames += pad
            self.batch_counts[bucket] += 1
            done = time.perf_counter()
            for t in (p[2] for p in pending):
                self.request_ms.append((done - t) * 1000.0)
            for i, f in enumerate(futs):
                self._resolve(f, {"boxes": boxes[i], "scores": scores[i],
                                  "mask": mask[i], "keypoints": kpts[i]})

    def stats(self) -> dict:
        counts = self.batch_counts
        total = sum(counts.values())
        weighted = sum(b * c for b, c in counts.items())
        lat = np.asarray(self.request_ms, np.float64)
        return {
            "batches": self.batches,
            "frames": self.frames,
            "padded_frames": self.padded_frames,
            "mean_batch": (weighted / total if total else None),
            "bucket_histogram": {b: counts.get(b, 0) for b in self.buckets},
            "request_ms": ({p: float(np.percentile(lat, p))
                            for p in (50, 95, 99)} if lat.size else None),
        }
