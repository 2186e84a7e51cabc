"""The port's ``TwoStageServer`` against the JAX package's, request by
request, on the tiny Darknet cfg and a narrow RektNet, f32 on the CPU.

Both servers get the same models (one numpy init), the same policy
settings and the same request sequence. After every request the outputs
are held as ``test_torch_pipeline.py`` holds them (masks equal; boxes,
scores and keypoints within its tolerances) and every counter the two
servers share must be equal; at the end, so must ``stats()``'s shared
keys, which are all of the JAX server's. On the CPU the port captures
nothing: every bucket runs eagerly.

The crop kernel's oversize watch: on the CPU both servers default to
``crop_kernel`` off and report its four keys alike. With it on, the port
counts every valid box of the observed batches and none past a window
(K1 has none: never degraded) while the JAX server, whose windowed crop
has no CPU counterpart here, serves its exact crop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import gap_threshold, tiny_models
from mit_driverless_cv_traininginfra_tpu.infer.capacity import (
    AdaptiveCapacity as JaxCapacity,
)
from mit_driverless_cv_traininginfra_tpu.infer.serving import (
    TwoStageServer as JaxServer,
)
from mit_driverless_cv_traininginfra_tpu.models.darknet import detections
from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import (
    AdaptiveCapacity,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
    normalize_u8,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import (
    TwoStageServer,
)

B, MAX_DET = 3, 4
POLICY = dict(floor=4, quantum=4, window=4, margin=1.0, warmup_capacity=4,
              shrink_patience=1)
# the counters both servers keep (attributes, and stats() keys)
COUNTERS = ("calls", "compiles", "bucket_clamps", "capacity_exhausted",
            "batch_pads", "pad_spurious", "current_capacity")
POLICY_COUNTERS = ("grows", "shrinks", "overflows", "observations")
SHARED_STATS = COUNTERS + POLICY_COUNTERS + (
    "warmed_buckets", "mean_load", "latency_samples", "pipeline_samples",
    "pipeline_depth", "oversize_boxes", "oversize_observed",
    "crop_kernel_active", "crop_kernel_switches")


@pytest.fixture(scope="module")
def setup():
    (jspec, jyolo, jrekt), (yolo, rekt) = tiny_models(seed=2)
    rng = np.random.default_rng(7)
    frames = rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)
    # a threshold in a gap of the confidences of these frames and of the
    # zero frames a short batch is padded with
    probe = np.concatenate([frames, np.zeros_like(frames[:1])])
    conf = np.asarray(detections(jspec, jyolo, {}, jnp.asarray(probe),
                                 with_classes=False)[..., 4])
    return jspec, jyolo, jrekt, yolo, rekt, frames, gap_threshold(conf, 5)


class Pair:
    """A port server and a JAX server over the same models and settings."""

    def __init__(self, setup, **kw):
        jspec, jyolo, jrekt, yolo, rekt, self.frames, thresh = setup
        common = dict(conf_thresh=thresh, max_det=MAX_DET, observe_every=2,
                      **kw)
        self.port = TwoStageServer(yolo, rekt,
                                   policy=AdaptiveCapacity(**POLICY), **common)
        self.jax = JaxServer(jspec, yolo_params=jyolo, rekt_params=jrekt,
                             policy=JaxCapacity(**POLICY), **common)

    def both(self, name, *args, **kw):
        """Call method ``name`` on both servers with the same arguments
        (frames as a torch tensor and a jnp array)."""
        conv = lambda f, a: f(a) if isinstance(a, np.ndarray) else a
        p = getattr(self.port, name)(*(conv(torch.from_numpy, a) for a in args), **kw)
        j = getattr(self.jax, name)(*(conv(jnp.asarray, a) for a in args), **kw)
        self.same_counters()
        return p, j

    def serve(self, frames):
        out, ref = self.both("__call__", frames)
        _assert_close(out, ref)
        return out, ref

    def same_counters(self):
        for k in COUNTERS:
            assert getattr(self.port, k) == getattr(self.jax, k), k
        for k in POLICY_COUNTERS:
            assert (getattr(self.port.policy, k)
                    == getattr(self.jax.policy, k)), k
        assert self.port.warmed == self.jax.warmed
        assert self.port.seen == self.jax.seen

    def same_stats(self):
        ps, js = self.port.stats(), self.jax.stats()
        for k in SHARED_STATS:
            assert ps[k] == js[k], (k, ps[k], js[k])
        # the port leaves out none of the JAX server's keys
        left_out = set()
        assert set(js) - set(ps) == left_out
        return ps


def _assert_close(out, ref):
    # as tests/test_torch_pipeline.py: masks exactly; boxes and scores f32
    # through a few CPU convs; keypoints in frame pixels
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    m = np.asarray(ref.mask)
    np.testing.assert_allclose(out.boxes.numpy()[m], np.asarray(ref.boxes)[m],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.scores.numpy()[m],
                               np.asarray(ref.scores)[m], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.keypoints.numpy(),
                               np.asarray(ref.keypoints), rtol=1e-4, atol=1e-3)


def test_default_lattice_and_steady_serving(setup):
    pair = Pair(setup)
    pair.both("warmup", [B])      # the default lattice, from the policy
    assert pair.port.warmed == {(B, 4), (B, 8)}
    for _ in range(5):
        pair.serve(pair.frames)
    assert pair.port.compiles == 0
    pair.same_stats()


@pytest.mark.parametrize("grow", [False, True], ids=["clamp", "grow"])
def test_want_above_the_lattice(setup, grow):
    pair = Pair(setup, grow_past_warmed=grow)
    pair.both("warmup", [B], capacities=[4])
    pair.serve(pair.frames)
    for srv in (pair.port, pair.jax):   # a burst: the policy wants 12
        for _ in range(4):
            srv.policy.observe(11)
    out, _ = pair.serve(pair.frames)
    if grow:
        assert pair.port.current_capacity == 12
        assert pair.port.compiles == 1 and (B, 12) in pair.port.seen
    else:
        assert pair.port.current_capacity == 4
        assert pair.port.capacity_exhausted == 1
    pair.serve(pair.frames)
    pair.same_stats()


@pytest.mark.parametrize("pad", [True, False], ids=["pad", "no_pad"])
def test_short_batch(setup, pad):
    pair = Pair(setup, pad_to_batch=pad)
    pair.both("warmup", [B], capacities=[4, 8])
    full, _ = pair.serve(pair.frames)
    short, _ = pair.serve(pair.frames[:2])
    assert short.mask.shape == (2, MAX_DET)
    if pad:   # zero-padded to the warmed B=3, sliced back
        assert pair.port.batch_pads == 1 and pair.port.compiles == 0
    else:     # a new bucket, B=2
        assert pair.port.batch_pads == 0 and pair.port.compiles == 1
    pair.serve(pair.frames[:2])
    pair.same_stats()


def test_pad_sizes_warm_the_short_batch_path(setup):
    pair = Pair(setup)
    pair.both("warmup", [B], capacities=[8], pad_sizes=[2])
    assert pair.port.batch_pads == 0      # a warmup pad is not an event
    pair.serve(pair.frames[:2])
    assert pair.port.batch_pads == 1 and pair.port.compiles == 0
    pair.same_stats()


def test_measure_latency(setup):
    pair = Pair(setup)
    pair.both("warmup", [B], capacities=[4, 8])
    pair.serve(pair.frames)
    p, j = pair.both("measure_latency", pair.frames, n=4, warm=2)
    assert p["latency_samples"] == j["latency_samples"] == 5  # + bootstrap
    assert set(p) == set(j)
    assert pair.port.defer_observation and pair.port.observe_every == 2
    pair.serve(pair.frames)
    pair.same_stats()


@pytest.mark.parametrize("defer", [True, False], ids=["deferred", "fenced"])
def test_observation_modes(setup, defer):
    pair = Pair(setup, defer_observation=defer)
    pair.both("warmup", [B], capacities=[4, 8])
    for _ in range(6):
        pair.serve(pair.frames)
    st = pair.same_stats()
    # fenced: every observation is a latency sample; deferred: only the
    # bootstrap, the rest are pipeline walls
    assert st["latency_samples"] == (1 if defer else 4)
    assert st["pipeline_samples"] == (2 if defer else 0)


def test_uint8_frames_serve_as_the_normalised_floats(setup):
    """A uint8 request is the float request of its normalised frames:
    ``x · fl(1/255)`` on the device, as the pipeline does it."""
    _, _, _, yolo, rekt, frames, thresh = setup
    server = TwoStageServer(yolo, rekt, conf_thresh=thresh, max_det=MAX_DET,
                            policy=AdaptiveCapacity(**POLICY))
    server.warmup([B], capacities=[8], frame_dtype=torch.uint8)
    u8 = torch.from_numpy((frames * 255).astype(np.uint8))
    a = server(u8)
    b = server(normalize_u8(u8))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert server.stats()["compiles"] == 0


def test_oversize_watch_with_k1_counts_no_box(setup):
    """``crop_kernel=True`` on the port (K1, limits infinite) beside the
    JAX server on its exact crop (``crop_kernel=False``): the same outputs
    and shared counters; the port observes every valid box of the observed
    batches, counts none oversize and keeps the kernel active, where the
    JAX server reports the watch off."""
    jspec, jyolo, jrekt, yolo, rekt, frames, thresh = setup
    common = dict(conf_thresh=thresh, max_det=MAX_DET, observe_every=2)
    port = TwoStageServer(yolo, rekt, policy=AdaptiveCapacity(**POLICY),
                          crop_kernel=True, **common)
    ref = JaxServer(jspec, yolo_params=jyolo, rekt_params=jrekt,
                    policy=JaxCapacity(**POLICY), crop_kernel=False, **common)
    assert TwoStageServer(yolo, rekt).crop_kernel is False  # auto: off on the CPU
    outs = {}
    for srv, x in ((port, torch.from_numpy(frames)), (ref, jnp.asarray(frames))):
        srv.warmup([B], capacities=[4, 8])
        outs[srv] = [srv(x) for _ in range(5)]
    for a, b in zip(outs[port], outs[ref]):
        _assert_close(a, b)
    ps, js = port.stats(), ref.stats()
    for k in COUNTERS + POLICY_COUNTERS:
        assert ps[k] == js[k], k
    assert ps["oversize_observed"] == sum(ref.policy.loads) > 0
    assert (ps["oversize_boxes"], ps["crop_kernel_active"], ps["crop_kernel_switches"]) \
        == (0, True, 0)
    assert (js["oversize_boxes"], js["oversize_observed"], js["crop_kernel_active"],
            js["crop_kernel_switches"]) == (None, None, False, 0)
