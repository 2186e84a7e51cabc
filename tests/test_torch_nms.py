"""Kernel K3's plain version (threshold + top-k + greedy NMS) against the
JAX package's XLA twin, slot for slot, and its Pallas kernel (interpret
mode) on the valid slots; plus the IoU it is built on."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mit_driverless_cv_traininginfra_tpu.ops.boxes import (
    iou_no_plus_one_pairwise as jax_iou,
)
from mit_driverless_cv_traininginfra_tpu.ops.pallas_kernels import (
    _pallas_nms_topk,
    _xla_nms_topk,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.boxes import (
    iou_no_plus_one_pairwise,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    _topk_stable,
    _torch_nms_topk,
    nms_topk,
)

CONF, OVERLAP, K = 0.8, 0.25, 16


def _inputs(seed=0, B=4, N=300, finite=True):
    """Clustered boxes (so suppression happens); frame 1 has fewer than k
    candidates above conf, frame 2 exact score ties, frame 3 none."""
    rng = np.random.default_rng(seed)
    centers = np.repeat(rng.uniform(20, 200, (B, N // 6 + 1, 2)), 6, axis=1)[:, :N]
    c = centers + rng.normal(0, 3, (B, N, 2))
    wh = rng.uniform(8, 60, (B, N, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (B, N)).astype(np.float32)
    scores[1] = np.where(np.arange(N) % 60 == 5, 0.9, 0.5)
    scores[2, rng.choice(N, 30, replace=False)] = 0.95
    scores[3] = np.minimum(scores[3], CONF)
    if not finite:  # overflowed box decodes: ±inf corners, NaN IoUs
        boxes[0, ::3, 2] = np.inf
        boxes[0, ::4, 0] = -np.inf
    return boxes, scores


def test_topk_stable_breaks_ties_like_lax_top_k():
    x = np.asarray([0.1, -np.inf, 0.9, -np.inf, -np.inf, 0.9, 0.2], np.float32)
    _, idx = _topk_stable(torch.from_numpy(x), 5)
    assert idx.tolist() == [2, 5, 6, 0, 1]  # torch.topk gives [2,5,6,0,3]


def test_iou_matches_jax_bitwise_with_zero_union():
    rng = np.random.default_rng(1)
    b = rng.uniform(0, 50, (3, 10, 4)).astype(np.float32)
    b[..., 2:] = b[..., :2] + rng.uniform(0, 20, (3, 10, 2))
    b[0, 0] = b[0, 1] = [5, 5, 5, 9]  # zero-area boxes: union 0 → divide by 1
    got = iou_no_plus_one_pairwise(torch.from_numpy(b), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_iou(b, b)))


@pytest.mark.parametrize("finite", [True, False])
def test_plain_matches_xla_twin_slot_for_slot(finite):
    boxes, scores = _inputs(finite=finite)
    got = _torch_nms_topk(torch.from_numpy(boxes), torch.from_numpy(scores),
                          CONF, K, OVERLAP)
    ref = _xla_nms_topk(jnp.asarray(boxes), jnp.asarray(scores), CONF, K,
                        OVERLAP)
    # exact: same candidates in the same slots, same f32 IoU arithmetic
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    keep = got[3].numpy()
    assert keep[3].sum() == 0 and keep[1].sum() <= 5
    assert (got[1].numpy()[1] == -np.inf).sum() >= K - 5


def test_plain_matches_pallas_kernel_on_valid_slots():
    boxes, scores = _inputs(seed=2)
    got = _torch_nms_topk(torch.from_numpy(boxes), torch.from_numpy(scores),
                          CONF, K, OVERLAP)
    with pltpu.force_tpu_interpret_mode():
        ref = _pallas_nms_topk(jnp.asarray(boxes), jnp.asarray(scores), CONF,
                               K, OVERLAP)
    # below-conf slots differ by design: the Pallas kernel repeats index 0
    # there, the XLA twin (followed by the port) takes the lowest unchosen
    valid = np.isfinite(got[1].numpy())
    assert valid.sum() > K  # frames 0 and 2 fill all k slots
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy()[valid], np.asarray(r)[valid])


def test_wrapper_takes_plain_version_on_cpu():
    boxes, scores = _inputs(seed=3)
    before = nms_topk.launches
    b, s, keep = nms_topk(torch.from_numpy(boxes), torch.from_numpy(scores),
                          CONF, K, OVERLAP)
    rb, rs, _, rkeep = _torch_nms_topk(torch.from_numpy(boxes),
                                       torch.from_numpy(scores), CONF, K,
                                       OVERLAP)
    assert torch.equal(b, rb) and torch.equal(s, rs) and torch.equal(keep, rkeep)
    assert nms_topk.launches == before
