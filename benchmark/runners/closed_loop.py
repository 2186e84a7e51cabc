"""Runner ``closed_loop``: one client that sends batches of ``batch``
uint8 frames from a pinned pool of seeded scenes and keeps ``inflight`` of
them dispatched before it fetches the oldest (the serve CLI's loop). Each
request's four outputs are copied to host memory before its frames count.

Traffic keys: ``batch``, ``inflight``, ``pool``, ``scenes``, ``threshold``,
``buckets``, ``trace_seconds``, ``judge_requests``.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from yardstick import arch, harness, port, serve, trace


class ClosedLoop:
    def __init__(self, st: serve.Setup):
        tr = st.traffic
        self.st, self.B, self.depth = st, tr["batch"], tr["inflight"]
        n = st.pool.shape[0] // self.B
        pool = torch.from_numpy(st.pool[:n * self.B].reshape(n, self.B, *st.pool.shape[1:]))
        self.batches = [pool[i].pin_memory() if st.device.type == "cuda" else pool[i]
                        for i in range(n)]
        self.order_rng = np.random.default_rng([st.seed, 1])
        self.order = deque()
        self.requests = []       # (batch id, cap, t_done, outputs)
        self.call_s = []

    def _next_batch(self) -> int:
        if not self.order:
            self.order.extend(self.order_rng.permutation(len(self.batches)).tolist())
        return self.order.popleft()

    def run(self, seconds: float, traced: bool = False):
        """Serve for ``seconds``; returns ``(t0, t_end)`` on the host clock.
        Requests still in flight at the end are fetched after it."""
        server = self.st.server
        inflight = deque()

        def finish(item):
            bid, cap, out = item
            with trace.span("bench.fetch", traced):
                host = port.to_host(out)
            self.requests.append((bid, cap, time.perf_counter(), host))

        if self.st.device.type == "cuda":
            torch.cuda.synchronize(self.st.device)
        with serve.no_gc():
            t0 = time.perf_counter()
            t_end = t0 + seconds
            while time.perf_counter() < t_end:
                bid = self._next_batch()
                c0 = time.perf_counter()
                with trace.span("bench.server_call", traced):
                    out = server(self.batches[bid])
                self.call_s.append(time.perf_counter() - c0)
                inflight.append((bid, server.current_capacity, out))
                while len(inflight) > self.depth:
                    finish(inflight.popleft())
            while inflight:
                finish(inflight.popleft())
        return t0, t_end

    def answers(self, idx):
        """The served answers of requests ``idx``, frame by frame; None for
        a frame that its request did not answer."""
        out = []
        for r in idx:
            bid, _, _, (boxes, scores, mask, kpts) = self.requests[r]
            for i in range(self.B):
                out.append({"scene": bid * self.B + i, "boxes": boxes[i],
                            "scores": scores[i], "mask": mask[i], "keypoints": kpts[i]}
                           if i < len(mask) else None)
        return out


def run(cfg, traffic, seed, seconds, traced, device, t_start, hooks=None):
    st = serve.Setup(cfg, traffic, seed, device, hooks)
    loop = ClosedLoop(st)
    stats0 = st.server.stats()
    setup_s = time.perf_counter() - t_start - st.threshold_s
    t0, t_end = loop.run(seconds)
    call_ms = 1e3 * float(np.mean(loop.call_s)) if loop.call_s else None
    stats1 = st.server.stats()
    memory_peak = harness.memory_peak(device)
    in_window = [r for r in loop.requests if r[2] <= t_end]
    B = loop.B
    frames = B * len(in_window)
    e2e = {"served_fps": frames / seconds, "setup_s": setup_s}
    kept = serve.kept_crops(loop.answers(range(len(in_window))))
    rec = {"kind": "closed_loop", "window_s": seconds, "precision": cfg["serving"]["precision"],
           "frames": frames, "requests": len(in_window), "kept_crops": kept,
           "cap_slots": sum(r[1] for r in in_window),
           "flops": serve.served_flops(cfg, frames, kept),
           "server_call_ms": call_ms, "threshold_s": st.threshold_s,
           "calls": stats1["calls"] - stats0["calls"],
           "replays": stats1["replays"] - stats0["replays"],
           "compiles": stats1["compiles"] - stats0["compiles"],
           "shape": {"B": B, "H": cfg["detector"]["input"], "C": 3,
                     "crop": cfg["keypoints"]["crop"], "num_kpt": cfg["keypoints"]["num_kpt"],
                     "N": arch.total_anchors(cfg["detector"]),
                     "max_det": cfg["serving"]["max_det"]}}
    if traced:
        n0 = len(loop.requests)
        with serve.no_gc(), trace.Traced() as t:
            loop.run(traffic["trace_seconds"], traced=True)
        rec["trace"] = harness.traced_record(t)
        rec["trace"]["caps"] = [r[1] for r in loop.requests[n0:]]
        yolo, rekt = st.server.yolo, st.server.rekt
        rec["detector_ms_per_frame"] = serve.detector_ms(st, yolo, B) / B
        cap = stats1["current_capacity"] or cfg["serving"]["capacities"][0]
        rec["keypoint_ms_per_crop"] = serve.keypoint_ms(st, rekt, cap, yolo.frame_dtype) / cap
    st.free_program()
    rng = np.random.default_rng([seed, 3])
    idx = serve.sample(rng, len(loop.requests), traffic["judge_requests"])
    numbers = serve.judge_answers(st, loop.answers(idx), cfg["reference"]["numerics"])
    return e2e, rec, numbers, B * len(loop.requests), 0, memory_peak


def control_sample(st: serve.Setup, seconds: float):
    """A short window at the cell's load: the served answers that a run
    would judge, and the requests ``[(scenes, capacity)]`` they answered,
    for the control to answer alike."""
    loop = ClosedLoop(st)
    loop.run(seconds)
    rng = np.random.default_rng([st.seed, 3])
    idx = serve.sample(rng, len(loop.requests), st.traffic["judge_requests"])
    reqs = [([loop.requests[r][0] * loop.B + i for i in range(loop.B)], loop.requests[r][1])
            for r in idx]
    return loop.answers(idx), reqs
