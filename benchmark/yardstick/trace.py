"""A short profiled window and its reduction: device activities, the
union of their intervals, the idle gaps labelled by the benchmark's own
host span that was open when each began, and the busiest operations.

The idle share is ``1 - |union of device intervals| / window``: a plain sum
of kernel times counts twice what two streams run at once.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


@contextlib.contextmanager
def span(name: str, on: bool):
    """A benchmark span, recorded into the profiler's host record when
    tracing is ``on``."""
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield


class Traced:
    """Profile the code under ``with``; afterwards :attr:`device` holds
    ``(name, start_us, end_us)`` of every device activity, :attr:`host` the
    benchmark spans (names with a ``bench.`` prefix) and :attr:`window_s`
    the traced wall time."""

    def __init__(self):
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.window_s = 0.0
        self.t0_us = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        with torch.profiler.record_function("bench.window_start"):
            pass
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        with torch.profiler.record_function("bench.window_end"):
            pass
        self.window_s = time.perf_counter() - self._t
        self._prof.__exit__(*exc)
        self._collect()
        del self._prof
        return False

    def _collect(self):
        cuda = torch.autograd.DeviceType.CUDA
        marks = {}
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            t0 = e.start_ns() / 1e3
            t1 = t0 + e.duration_ns() / 1e3
            if name.startswith("bench."):
                # a span is recorded on the host and, as an annotation,
                # on the device's timeline too: only the host's counts
                if e.device_type() == cuda:
                    continue
                if name in ("bench.window_start", "bench.window_end"):
                    marks[name] = t0
                else:
                    self.host.append((name, t0, t1))
            elif e.device_type() == cuda:
                self.device.append((name, t0, t1))
        self.t0_us = marks.get("bench.window_start", 0.0)
        end = marks.get("bench.window_end")
        if end is not None and end > self.t0_us:
            self.window_s = (end - self.t0_us) / 1e6


def union_s(intervals: List[Tuple[float, float]]) -> float:
    """Seconds covered by the union of ``(start_us, end_us)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """The idle gaps ``(start_us, end_us)`` of the union of ``intervals``
    inside ``[lo, hi]``."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def reduce(t: Traced) -> Dict:
    """``{"busy_s", "window_s", "kernels": {name: (count, seconds)},
    "device_ops", "idle_gaps"}`` of a traced window: the ten operations
    that took most device time, and the ten longest idle gaps, each named
    by the innermost benchmark span open when it began (``host idle``
    where none was)."""
    lo = t.t0_us
    hi = lo + t.window_s * 1e6
    iv = [(max(s, lo), min(e, hi)) for _, s, e in t.device if e > lo and s < hi]
    busy = union_s(iv)
    per: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, s, e in t.device:
        per[name][0] += 1
        per[name][1] += (e - s) / 1e6
    ops = sorted(per.items(), key=lambda kv: -kv[1][1])[:10]
    idle = sorted(gaps(iv, lo, hi), key=lambda g: g[0] - g[1])[:10]
    host = sorted(t.host, key=lambda h: h[1])
    named = []
    for s, e in idle:
        label = "host idle"
        best = None
        for name, hs, he in host:
            if hs <= s < he and (best is None or hs >= best[1]):
                best = (name, hs)
        if best is not None:
            label = best[0][len("bench."):]
        named.append([label, (e - s) / 1e6])
    return {"busy_s": busy, "window_s": t.window_s,
            "kernels": {k: (v[0], v[1]) for k, v in per.items()},
            "device_ops": [[k, v[1]] for k, v in ops], "idle_gaps": named}
