"""Adaptive crop-capacity policy for the two-stage serving pipeline (the
port's own copy of the JAX package's numpy-only ``infer/capacity.py``).

The pipeline runs RektNet only on the top-``crop_capacity`` detections
across the batch (crop compaction, ``infer.pipeline``). A serving process
warms a few capacity buckets, so it wants a policy that tracks the
detection load, keeps enough headroom that overflow (dropped keypoints for
the lowest-score boxes) stays rare, and moves between a few buckets only.

``AdaptiveCapacity`` keeps a sliding window of observed batch loads and sets

    capacity = quantum · ceil(margin · p99(window) / quantum)

clamped to [floor, batch·max_det]. Growth is immediate; a shrink waits for
``shrink_patience`` consecutive lower wants. ``TwoStageServer`` maps the
want onto its warmed bucket lattice.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class AdaptiveCapacity:
    """Sliding-window p99 capacity controller.

    Args:
        floor: minimum capacity (compile-time lower bound).
        margin: multiplicative headroom over the p99 load.
        quantum: capacities are rounded up to multiples of this (keeps the
            RektNet batch MXU-tiled and bounds the number of recompiles).
        window: number of recent batch loads retained.
        warmup_capacity: returned until the first observation.
        shrink_patience: consecutive lower-bucket wants required before the
            policy actually shrinks (1 = shrink immediately).
    """

    def __init__(self, floor: int = 256, margin: float = 1.25,
                 quantum: int = 128, window: int = 64,
                 warmup_capacity: int | None = None,
                 shrink_patience: int = 32):
        # shrink_patience default 32: on the bursty-stream study
        # (tests/test_capacity.py) it cuts bucket switches 25 → 18 for a
        # ~2% mean-capacity cost, and delaying shrinks can never drop
        # keypoints — only delay a small throughput gain.
        if floor % quantum:
            floor = quantum * -(-floor // quantum)
        self.floor = floor
        self.margin = margin
        self.quantum = quantum
        self.loads: deque[int] = deque(maxlen=window)
        self.warmup_capacity = warmup_capacity if warmup_capacity else floor
        self.shrink_patience = max(1, shrink_patience)
        self.overflows = 0
        self.observations = 0
        self.grows = 0
        self.shrinks = 0
        self._current: int | None = None  # last bucket (pre-hard-cap)
        self._below = 0                   # consecutive lower-bucket wants

    def observe(self, n_valid: int, capacity: int | None = None) -> None:
        """Record one batch's total valid detections. ``capacity`` (the
        capacity that batch ran with) tracks overflow statistics."""
        self.loads.append(int(n_valid))
        self.observations += 1
        if capacity is not None and n_valid > capacity:
            self.overflows += 1

    def observe_mask(self, mask, capacity: int | None = None) -> None:
        """Convenience: observe from the pipeline's (B, K) validity mask.
        Forces a device→host read of one scalar — call every few batches
        in latency-sensitive serving."""
        self.observe(int(np.asarray(mask).sum()), capacity)

    def _want(self) -> int:
        """Raw bucket the window asks for (quantised, floor-clamped)."""
        p99 = float(np.quantile(np.asarray(self.loads, np.float64), 0.99))
        want = self.margin * p99
        cap = self.quantum * max(1, -(-int(np.ceil(want)) // self.quantum))
        return max(cap, self.floor)

    def capacity(self, batch: int, max_det: int) -> int:
        """Current capacity choice (multiple of ``quantum``). Grows
        immediately, shrinks only after ``shrink_patience`` consecutive
        lower wants."""
        hard_cap = batch * max_det
        if not self.loads:
            return int(min(self.warmup_capacity, hard_cap))
        want = self._want()
        if self._current is None:
            # first observation: adopt the want if it's at or above the
            # warmup level, but a want BELOW it must obey the same shrink
            # hysteresis as any other query — a quiet first sample must
            # not drop the configured warmup headroom in one step
            seed = max(int(self.warmup_capacity), self.floor)
            self._current = want if want >= seed else seed
        if want > self._current:
            self._current = want
            self._below = 0
            self.grows += 1
        elif want < self._current:
            self._below += 1
            if self._below >= self.shrink_patience:
                self._current = want
                self._below = 0
                self.shrinks += 1
        else:
            self._below = 0
        return int(min(self._current, hard_cap))
