"""The port's ``MicroBatcher`` (``infer/microbatch.py``): the JAX package's
``tests/test_microbatch.py`` cases on the port, and the batcher's results
against the JAX pipeline on the same frames."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import gap_threshold, tiny_models
from mit_driverless_cv_traininginfra_tpu.infer.pipeline import (
    two_stage_pipeline as jax_pipeline,
)
from mit_driverless_cv_traininginfra_tpu.models.darknet import detections
from mit_driverless_cv_traininginfra_tpu_torch.infer.microbatch import (
    MicroBatcher,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
    PipelineOut,
    two_stage_pipeline,
)


@pytest.fixture(scope="module")
def models():
    (jspec, jyolo, jrekt), (yolo, rekt) = tiny_models(seed=4)
    rng = np.random.default_rng(9)
    frames = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    conf = np.asarray(detections(jspec, jyolo, {}, jnp.asarray(frames),
                                 with_classes=False)[..., 4])
    thresh = gap_threshold(conf, 3)

    def run(batch):
        return two_stage_pipeline(yolo, rekt, torch.as_tensor(batch),
                                  conf_thresh=thresh, max_det=4)

    def run_jax(batch):
        return jax_pipeline(jspec, jyolo, {}, jrekt, {}, jnp.asarray(batch),
                            conf_thresh=thresh, max_det=4)

    return run, run_jax, frames


def _zeros_runner(calls=None, release=None):
    def run(frames):
        if calls is not None:
            calls.append(frames.shape[0])
        if release is not None:
            release.wait(timeout=30)
        B = frames.shape[0]
        return PipelineOut(torch.zeros((B, 4, 4)), torch.zeros((B, 4)),
                           torch.zeros((B, 4), dtype=torch.bool),
                           torch.zeros((B, 4, 7, 2)))
    return run


def test_batched_results_match_single_frame(models):
    """Batching is result-transparent: a frame served in a padded batch
    returns what a B=1 call returns (dense capacity: every stage is
    per-frame). Equal within f32 summation order: a batch of 4 and a batch
    of 1 may take other convolution schedules on the CPU."""
    run, _, frames = models
    with MicroBatcher(run, bucket_sizes=(1, 2, 4), max_wait_ms=40) as mb:
        futs = [mb.submit(f) for f in frames[:3]]
        results = [f.result(timeout=120) for f in futs]
    for f, r in zip(frames, results):
        solo = run(f[None])
        np.testing.assert_allclose(r["boxes"], solo.boxes[0].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r["mask"], solo.mask[0].numpy())
        np.testing.assert_allclose(r["keypoints"], solo.keypoints[0].numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_results_match_the_jax_pipeline(models):
    """Every future's rows against the JAX pipeline on the same frames, in
    one batch: masks equal, boxes and keypoints within
    ``test_torch_pipeline.py``'s tolerances."""
    run, run_jax, frames = models
    with MicroBatcher(run, bucket_sizes=(4,), max_wait_ms=200) as mb:
        results = [f.result(timeout=120) for f in [mb.submit(x) for x in frames]]
    ref = run_jax(frames)
    for i, r in enumerate(results):
        m = np.asarray(ref.mask[i])
        np.testing.assert_array_equal(r["mask"], m)
        np.testing.assert_allclose(r["boxes"][m], np.asarray(ref.boxes[i])[m],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["keypoints"], np.asarray(ref.keypoints[i]),
                                   rtol=1e-4, atol=1e-3)


def test_coarrivals_aggregate_into_one_bucket():
    """Near-simultaneous submissions ride one batched call, padded up to
    the bucket."""
    calls = []
    frame = np.zeros((8, 8, 3), np.float32)
    with MicroBatcher(_zeros_runner(calls), bucket_sizes=(1, 2, 4),
                      max_wait_ms=150) as mb:
        futs = [mb.submit(frame), mb.submit(frame), mb.submit(frame)]
        for f in futs:
            f.result(timeout=30)
        st = mb.stats()
    assert calls == [4]                    # 3 co-arrivals → one 4-bucket
    assert st["batches"] == 1 and st["frames"] == 3
    assert st["padded_frames"] == 1
    assert st["bucket_histogram"][4] == 1


def test_spaced_arrivals_serve_individually():
    calls = []
    frame = np.zeros((8, 8, 3), np.float32)
    with MicroBatcher(_zeros_runner(calls), bucket_sizes=(1, 2, 4),
                      max_wait_ms=1) as mb:
        for _ in range(3):
            mb.submit(frame).result(timeout=30)
    assert calls == [1, 1, 1]


def test_runner_failure_fails_the_futures():
    def run(frames):
        raise RuntimeError("boom")

    frame = np.zeros((8, 8, 3), np.float32)
    with MicroBatcher(run, bucket_sizes=(1,), max_wait_ms=1) as mb:
        fut = mb.submit(frame)
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
        # the collector lives on
        mb.runner = _zeros_runner()
        assert mb.submit(frame).result(timeout=30)["boxes"].shape == (4, 4)


def test_shape_mismatch_raises_in_caller_not_collector():
    """A frame that cannot stack with the first one raises in submit() (the
    caller), never in the collector thread."""
    with MicroBatcher(_zeros_runner(), bucket_sizes=(1, 2),
                      max_wait_ms=1) as mb:
        mb.submit(np.zeros((8, 8, 3), np.float32)).result(timeout=30)
        with pytest.raises(ValueError):
            mb.submit(np.zeros((16, 16, 3), np.float32))
        r = mb.submit(np.zeros((8, 8, 3), np.float32)).result(timeout=30)
        assert r["boxes"].shape == (4, 4)


def test_cancelled_future_does_not_kill_collector():
    """A client that gives up and cancels its future must not crash the
    collector when it later resolves that future."""
    release = threading.Event()
    frame = np.zeros((8, 8, 3), np.float32)
    with MicroBatcher(_zeros_runner(release=release), bucket_sizes=(1,),
                      max_wait_ms=1) as mb:
        fut = mb.submit(frame)          # the runner blocks on `release`
        time.sleep(0.05)
        assert fut.cancel()
        release.set()
        r = mb.submit(frame).result(timeout=30)
        assert r["scores"].shape == (4,)


def test_concurrent_submitters_all_resolve():
    def run(frames):
        B = frames.shape[0]
        # each result row carries its frame's content, so routing shows
        s = torch.as_tensor(frames[:, 0, 0, 0])
        return PipelineOut(torch.zeros((B, 4, 4)), s[:, None].expand(B, 4),
                           torch.zeros((B, 4), dtype=torch.bool),
                           torch.zeros((B, 4, 7, 2)))

    results = {}

    def client(i, mb):
        frame = np.full((8, 8, 3), i / 10.0, np.float32)
        results[i] = mb.submit(frame).result(timeout=60)

    with MicroBatcher(run, bucket_sizes=(1, 2, 4, 8), max_wait_ms=30) as mb:
        threads = [threading.Thread(target=client, args=(i, mb))
                   for i in range(8)]
        for t in threads:
            t.start()
            time.sleep(0.002)
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        st = mb.stats()
    assert len(results) == 8
    for i, r in results.items():
        np.testing.assert_allclose(r["scores"], i / 10.0, atol=1e-6)
    assert st["frames"] == 8


def test_request_latency_percentiles(models):
    """Per-request submit → resolve latency, ring-buffered and reported as
    p50/p95/p99 by stats()."""
    run, _, frames = models
    with MicroBatcher(run, bucket_sizes=(1, 2, 4), max_wait_ms=5) as mb:
        for f in [mb.submit(x) for x in frames]:
            f.result(timeout=120)
        st = mb.stats()
    d = st["request_ms"]
    assert set(d) == {50, 95, 99}
    assert d[50] > 0 and d[99] >= d[50]
    assert len(mb.request_ms) == 4
