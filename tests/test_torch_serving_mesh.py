"""``TwoStageServer(mesh=)`` on a device mesh of two CPU entries against the
same server without a mesh, f32 and int8 (the tiny Darknet cfg, a narrow
RektNet; int8 quantized by the port, ``parallel.dryrun.serving_models``;
the fused int8 entry, K4, is held under a mesh on the card by
``chip_smoke.py``): one request
sequence to both, a full batch, a short batch padded to the mesh multiple
and a capacity that the valid detections exceed. Masks, boxes and scores
bit-equal; keypoints within 1e-4 px (the same crops through RektNet in
another batch). The JAX server's own mesh surface is
``tests/test_serving.py::test_server_mesh_sharded_matches_single_device``."""

import numpy as np
import pytest
import torch

from _torch_port import tiny_models, tiny_port_spec
from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import AdaptiveCapacity
from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import TwoStageServer
from mit_driverless_cv_traininginfra_tpu_torch.parallel.dryrun import serving_models
from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import make_mesh

B, MAX_DET = 4, 8
CPU2 = [torch.device("cpu")] * 2
POLICY = dict(floor=4, quantum=4, window=4, margin=1.0, warmup_capacity=4,
              shrink_patience=1)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(3)
    frames = rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)
    _, (yolo, rekt) = tiny_models(seed=1)
    int8 = serving_models(tiny_port_spec(), frames, torch.device("cpu"))["int8"]
    return {"f32": (yolo, rekt), "int8": int8}, frames


def _agree(a, b, n=None):
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x[:n], y[:n])
    torch.testing.assert_close(a.keypoints[:n].float(), b.keypoints[:n].float(),
                               rtol=0, atol=1e-4)


def _servers(yolo, rekt, **kw):
    cfg = dict(conf_thresh=0.0, max_det=MAX_DET, observe_every=1, **kw)
    return (TwoStageServer(yolo, rekt, policy=AdaptiveCapacity(**POLICY), **cfg),
            TwoStageServer(yolo, rekt, policy=AdaptiveCapacity(**POLICY),
                           mesh=make_mesh(2, devices=CPU2), **cfg))


@pytest.mark.parametrize("config", ["f32", "int8"])
def test_mesh_server_equals_one_device(models, config):
    """Warmed at B=4 with capacity 4, which the valid slots exceed (the
    batch-global compaction); a full batch and a short one of 3, padded to
    4 by both servers, then the same counters."""
    (yolo, rekt), frames = models[0][config], models[1]
    one, two = _servers(yolo, rekt)
    for s in (one, two):
        s.warmup([B], capacities=[4])
    x = torch.from_numpy(frames)
    for n in (B, 3):
        got, want = two(x[:n]), one(x[:n])
        _agree(got, want, n)
        if n == B:
            assert one.current_capacity == two.current_capacity == 4
            assert int(want.mask.sum()) > 4
            assert int((got.keypoints.abs().sum((-1, -2)) > 0).sum()) == 4
    st1, st2 = one.stats(), two.stats()
    for k in ("calls", "compiles", "batch_pads", "bucket_clamps", "current_capacity",
              "observations", "grows", "shrinks"):
        assert st1[k] == st2[k], k
    assert st2["batch_pads"] == 1


def test_mesh_pads_to_its_multiple_or_raises(models):
    """With no run bucket a short batch pads to the next multiple of the
    mesh size; unpadded, a batch that does not divide raises."""
    (yolo, rekt), frames = models[0]["f32"], models[1]
    x = torch.from_numpy(frames[:3])
    one, two = _servers(yolo, rekt)
    out = two(x)
    cap = two.current_capacity
    assert out.mask.shape[0] == 3 and two.batch_pads == 1 and two.seen == {(4, cap)}
    _agree(out, one._dispatch(x, 4, cap), 3)
    _, strict = _servers(yolo, rekt, pad_to_batch=False)
    with pytest.raises(ValueError, match="not divisible by the 2-device mesh"):
        strict(x)


def test_server_refuses_a_process_mesh(models):
    class ProcessMesh:
        group = object()

    (yolo, rekt), _ = models[0]["f32"], models[1]
    with pytest.raises(ValueError, match="device mesh"):
        TwoStageServer(yolo, rekt, mesh=ProcessMesh())
