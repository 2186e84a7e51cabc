"""Runner ``camera_streams``: open-loop single frames through the
program's ``MicroBatcher`` in front of the server, offered at ``rate_fps``
by the arrival schedule of the traffic's ``arrivals`` entry
(:func:`yardstick.serve.arrivals`). Each frame is timed from when it was
due to when its outputs were in host memory; a frame that never comes
counts as infinitely late.

Traffic keys: ``rate_fps``, ``arrivals``, ``buckets``, ``max_wait_ms``,
``pool``, ``scenes``, ``threshold``, ``trace_seconds``, ``judge_frames``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from yardstick import harness, port, serve, trace


class CameraStreams:
    def __init__(self, st: serve.Setup):
        tr = st.traffic
        self.st = st
        self.mb = port.micro_batcher(st.server, tr["buckets"], tr["max_wait_ms"])
        self.mb.start()
        self.rng = np.random.default_rng([st.seed, 2])
        # the batcher's own path (stack, copy, replay, fetch) once per bucket
        for b in tr["buckets"]:
            futs = [self.mb.submit(st.pool[i]) for i in range(b)]
            for f in futs:
                f.result()
        self.frames = []          # (scene, due, submitted, done, result)

    def run(self, seconds: float, rate: float, traced: bool = False):
        """Offer ``rate`` frames/s for ``seconds``; wait up to a minute
        past the close for the last answers. Returns ``(t0, t_end,
        first, last)``: the window on the host clock and the indices of
        its frames in :attr:`frames`."""
        due, scene = serve.arrivals(self.rng, self.st.traffic["arrivals"], rate, seconds,
                                    self.st.pool.shape[0])
        first = len(self.frames)
        done = [None] * due.size
        lock = threading.Lock()

        def finished(i):
            def cb(_f):
                t = time.perf_counter()
                with lock:
                    done[i] = t
            return cb

        futs = []
        with serve.no_gc():
            t0 = time.perf_counter()
            for i, (d, s) in enumerate(zip(due, scene)):
                wait = t0 + d - time.perf_counter()
                if wait > 0:
                    with trace.span("bench.generator_sleep", traced):
                        time.sleep(wait)
                sub = time.perf_counter()
                f = self.mb.submit(self.st.pool[s])
                f.add_done_callback(finished(i))
                futs.append((int(s), t0 + d, sub, f))
            deadline = time.perf_counter() + 60.0
            results = []
            for *_, f in futs:
                try:
                    results.append(f.result(timeout=max(0.0, deadline - time.perf_counter())))
                except Exception:  # noqa: BLE001 - a failed or late answer is missed
                    results.append(None)
        for i, ((s, d, sub, _), res) in enumerate(zip(futs, results)):
            self.frames.append((s, d, sub, done[i] if res is not None else None, res))
        return t0, t0 + seconds, first, len(self.frames)

    def stop(self):
        self.mb.stop()

    def answers(self, idx):
        out = []
        for i in idx:
            s, _, _, _, res = self.frames[i]
            out.append(None if res is None else {"scene": s, **res})
        return out


def run(cfg, traffic, seed, seconds, traced, device, t_start, hooks=None):
    st = serve.Setup(cfg, traffic, seed, device, hooks)
    cam = CameraStreams(st)
    mb0 = cam.mb.stats()
    setup_s = time.perf_counter() - t_start - st.threshold_s
    try:
        t0, t_end, first, last = cam.run(seconds, traffic["rate_fps"])
        mb1 = cam.mb.stats()
        memory_peak = harness.memory_peak(device)
        lat, late, backlog = [], [], 0
        for s, due, sub, done, res in cam.frames[first:last]:
            lat.append(np.inf if done is None else (done - due) * 1e3)
            late.append((sub - due) * 1e3)
            if sub <= t_end and (done is None or done > t_end):
                backlog += 1
        lat = np.asarray(lat)
        failed = int(np.isinf(lat).sum())
        e2e = {"frame_p95_ms": float(np.percentile(lat, 95)) if lat.size else float("inf"),
               "setup_s": setup_s}
        rec = {"kind": "camera_streams", "window_s": seconds,
               "precision": cfg["serving"]["precision"], "threshold_s": st.threshold_s,
               "frames": int(lat.size), "batches": mb1["batches"] - mb0["batches"],
               "batched_frames": mb1["frames"] - mb0["frames"],
               "frame_p50_ms": float(np.percentile(lat, 50)) if lat.size else None,
               "lateness_ms": {"p50": float(np.percentile(late, 50)),
                               "p95": float(np.percentile(late, 95)),
                               "max": float(np.max(late))} if late else None,
               "backlog_at_close": backlog,
               "completed_in_window": int(sum(1 for f in cam.frames[first:last]
                                              if f[3] is not None and f[3] <= t_end))}
        if traced:
            with serve.no_gc(), trace.Traced() as t:
                cam.run(traffic["trace_seconds"], traffic["rate_fps"], traced=True)
            rec["trace"] = harness.traced_record(t)
    finally:
        cam.stop()
    st.free_program()
    rng = np.random.default_rng([seed, 3])
    idx = serve.sample(rng, last - first, traffic["judge_frames"])
    numbers = serve.judge_answers(st, cam.answers([first + i for i in idx]),
                                  cfg["reference"]["numerics"])
    return e2e, rec, numbers, last - first, failed, memory_peak


def control_sample(st: serve.Setup, seconds: float):
    """A short window at the cell's rate: the served answers that a run
    would judge, and the requests ``[(scenes, capacity)]`` they answered
    (one frame each), for the control to answer alike."""
    cam = CameraStreams(st)
    try:
        _, _, first, last = cam.run(seconds, st.traffic["rate_fps"])
    finally:
        cam.stop()
    rng = np.random.default_rng([st.seed, 3])
    idx = serve.sample(rng, last - first, st.traffic["judge_frames"])
    reqs = [([cam.frames[first + i][0]], st.cfg["serving"]["max_det"]) for i in idx]
    return cam.answers([first + i for i in idx]), reqs
