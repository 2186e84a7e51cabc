"""Timing helpers (counterpart of the JAX package's
``utils/profiling.py``).

- :func:`fence`, :func:`time_ms`, :class:`StepTimer`: host-clock timing
  ended by a device fence. On the card the fence is
  ``torch.cuda.synchronize`` (CUDA work is asynchronous, and the JAX
  package's device→host read of a sum is not needed for that); on the CPU
  there is nothing to wait for.
- :func:`device_memory_stats`: the caching allocator's live, peak and
  reserved bytes per card (``torch.cuda.memory_stats``).
- :func:`conv_graph_flops`, :func:`rektnet_flops`: analytic forward FLOPs
  (2 per multiply-add) for achieved-TFLOP/s reports.
"""

from __future__ import annotations

import time
from typing import Optional

import torch


def _sync_devices(tensors) -> None:
    for d in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(d)


def fence(*outs) -> float:
    """Wait until the work that made ``outs`` (tensors) is done; returns
    the sum of their values, a cheap NaN or activity probe."""
    _sync_devices(outs)
    return sum(float(o.detach().float().sum()) for o in outs)


def time_ms(fn, fence_fn, iters: int = 32, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn()``: ``warmup`` calls, then ``iters``
    calls back to back between two fences. ``fence_fn(out)`` maps the
    call's output to a tensor, or a tuple of them, that depends on its
    work."""
    def wait(out):
        f = fence_fn(out)
        fence(*(f if isinstance(f, tuple) else (f,)))

    for _ in range(warmup):
        out = fn()
    wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    wait(out)
    return (time.perf_counter() - t0) * 1000 / iters


class StepTimer:
    """EMA of the step time, fenced only every ``sync_every`` steps so the
    card's queue stays full in between."""

    def __init__(self, sync_every: int = 50, ema: float = 0.9):
        self.sync_every = sync_every
        self.ema = ema
        self.step_time: Optional[float] = None
        self._count = 0
        self._t0 = time.perf_counter()

    def step(self, fence_value=None) -> Optional[float]:
        """Call once per step with any tensor of the step to fence on.
        Returns the EMA step time in seconds on a fenced step, else None
        (no fence)."""
        self._count += 1
        if self._count % self.sync_every:
            return None
        if fence_value is not None:
            _sync_devices([fence_value])
        t1 = time.perf_counter()
        dt = (t1 - self._t0) / self.sync_every
        self._t0 = t1
        self.step_time = dt if self.step_time is None else (
            self.ema * self.step_time + (1 - self.ema) * dt)
        return self.step_time


def device_memory_stats():
    """``{"cuda:<i>": {bytes_in_use, peak_bytes_in_use, bytes_reserved,
    bytes_limit}}`` for each visible card (empty without CUDA)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_reserved": stats.get("reserved_bytes.all.current"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


# ---------------------------------------------------------------------------
# analytic FLOP accounting
# ---------------------------------------------------------------------------


def conv_graph_flops(spec, height=None, width=None) -> int:
    """FLOPs (2 per multiply-add) of one forward through the conv graph
    of ``spec`` at the given input size (torch's conv and pool output
    arithmetic, the k=2, s=1 maxpool keeping the size)."""
    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
        ConvBlock,
        MaxPoolBlock,
        RouteBlock,
        UpsampleBlock,
    )

    cur = (height or spec.net.height, width or spec.net.width)
    chans = spec.out_channels
    res, flops = [], 0
    for i, b in enumerate(spec.blocks):
        if isinstance(b, ConvBlock):
            p = (b.size - 1) // 2
            cur = ((cur[0] + 2 * p - b.size) // b.stride + 1,
                   (cur[1] + 2 * p - b.size) // b.stride + 1)
            flops += 2 * cur[0] * cur[1] * b.size * b.size * chans[i] * b.filters
        elif isinstance(b, MaxPoolBlock) and not (b.size == 2 and b.stride == 1):
            p = (b.size - 1) // 2
            cur = ((cur[0] + 2 * p - b.size) // b.stride + 1,
                   (cur[1] + 2 * p - b.size) // b.stride + 1)
        elif isinstance(b, UpsampleBlock):
            cur = (cur[0] * b.stride, cur[1] * b.stride)
        elif isinstance(b, RouteBlock):
            cur = res[b.layers[0]]
        res.append(cur)
    return flops


def rektnet_flops(size: int = 80, net_size: int = 16, num_kpt: int = 7) -> int:
    """Forward FLOPs of one RektNet crop: 7×7 stem, four residual blocks
    (dilated 3×3, 3×3, 1×1 shortcut), 1×1 head, all at full resolution."""
    hw = size * size
    f = 2 * hw * 7 * 7 * 3 * net_size
    cin = net_size
    for mult in (1, 2, 4, 8):
        cout = net_size * mult
        f += 2 * hw * (9 * cin * cout + 9 * cout * cout + cin * cout)
        cin = cout
    return f + 2 * hw * cin * num_kpt
