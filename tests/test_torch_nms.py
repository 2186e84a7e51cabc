"""Kernel K3's plain version (threshold + top-k + greedy NMS) against the
JAX package's XLA twin, slot for slot, and its Pallas kernel (interpret
mode) on the valid slots; plus the IoU it is built on, and the packed-key
merge that K3's CUDA kernel splits over a cluster of CTAs."""

import re
from pathlib import Path

import jax
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
from mit_driverless_cv_traininginfra_tpu_torch.ops import cuda_kernels
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    NMS_CTAS,
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


@pytest.mark.parametrize("k", [1, 5, 12])
def test_topk_stable_ranks_plus_zero_above_minus_zero_like_lax_top_k(k):
    """±0 (which compare equal), ties and −inf, in rows of both orders:
    ``_topk_stable`` gives ``lax.top_k``'s indices and values, bit for bit
    (+0 above −0; among equal values the lower index first)."""
    x = np.asarray([[-0.0, 0.0, -0.0, 0.0, 0.5, -np.inf, 0.5, -0.0, -np.inf, 0.0, -0.5, 0.5],
                    [0.0, -0.0, -np.inf, -0.0, 0.0, 0.25, -0.25, 0.0, 0.25, -np.inf, -0.0, 0.0]],
                   np.float32)
    vals, idx = _topk_stable(torch.from_numpy(x), k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy().view(np.int32), np.asarray(jvals).view(np.int32))
    assert idx[0, :min(k, 6)].tolist() == [4, 6, 11, 1, 3, 9][:k]


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


# ---------------------------------------------------------------------------
# K3's CUDA kernel takes the top k of each CTA's chunk of packed keys and
# merges the chunks' top k: a plain model of that merge
# ---------------------------------------------------------------------------


def _order_key(v):
    """``csrc/nms_topk.cu:order_key``: f32 → uint32 in the same order, +0
    above −0, −inf → 0x007fffff."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _packed_keys(masked):
    """``order_key(masked) << 32 | (0xffffffff − index)``: unique, larger
    for a higher score and, among ties, for the lower index."""
    idx = np.arange(masked.size, dtype=np.uint64)
    return (_order_key(masked).astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - idx)


def _select_top(cand, k):
    """The kernel's merge: a key's slot is the number of keys above it plus
    the equal ones before it (only the pad key 0 repeats)."""
    above = (cand[None, :] > cand[:, None]).sum(1)
    equal_before = np.tril(cand[None, :] == cand[:, None], -1).sum(1)
    rank = above + equal_before
    out = np.empty(k, np.uint64)
    out[rank[rank < k]] = cand[rank < k]
    return out


def _cluster_top_k(masked, k, ctas):
    """Chunks of ceil(N / ctas) keys, each one's top k padded with key 0,
    merged into the top k: the slots' indices."""
    keys = _packed_keys(masked)
    n = keys.size
    chunk = -(-n // ctas)
    parts = [_select_top(np.concatenate([keys[min(n, c * chunk):min(n, (c + 1) * chunk)],
                                         np.zeros(k, np.uint64)]), k)
             for c in range(ctas)]
    top = _select_top(np.concatenate(parts), k)
    assert (top >> np.uint64(32)).min() >= 0x007FFFFF  # no pad reaches a slot
    return (np.uint64(0xFFFFFFFF) - (top & np.uint64(0xFFFFFFFF))).astype(np.int64)


def _merge_case(case, k, ctas):
    """(scores, conf) of one case; scores from a few levels, so ties abound."""
    sizes = {"boundary_ties": 1000, "none_above": 500, "nan": 777, "ragged": 16 * 61 + 5,
             "short_chunks": max(k, ctas + 1), "signed_zeros": 300}
    rng = np.random.default_rng([list(sizes).index(case), k, ctas])
    n = sizes[case]
    scores = rng.choice(np.float32([0.1, 0.5, 0.85, 0.9, 0.95]), n)
    conf = 0.8
    if case == "boundary_ties":  # equal scores on both sides of every chunk edge
        chunk = -(-n // ctas)
        for c in range(1, ctas):
            scores[max(0, c * chunk - 2):c * chunk + 2] = 0.97
    elif case == "none_above":
        conf = 0.96
    elif case == "nan":
        scores[rng.choice(n, n // 5, replace=False)] = np.nan
    elif case == "signed_zeros":
        scores = rng.choice(np.float32([-0.0, 0.0, -0.5]), n)
        conf = -1.0
    return scores.astype(np.float32), conf


@pytest.mark.parametrize("ctas", [1, 8, 16])
@pytest.mark.parametrize("k", [1, 16, 64])
@pytest.mark.parametrize("case", ["boundary_ties", "none_above", "nan", "ragged",
                                  "short_chunks", "signed_zeros"])
def test_cluster_merge_of_packed_keys_equals_top_k(case, k, ctas):
    """The top k of the chunks' top k of unique packed keys is the top k of
    all: slot for slot the port's ``_topk_stable`` and ``lax.top_k`` on the
    masked scores (NaN → −inf by the threshold; pads of key 0 below −inf)."""
    scores, conf = _merge_case(case, k, ctas)
    masked = np.where(scores > conf, scores, -np.inf).astype(np.float32)
    got = _cluster_top_k(masked, k, ctas)
    vals, idx = _topk_stable(torch.from_numpy(masked), k)
    np.testing.assert_array_equal(got, idx.numpy())
    np.testing.assert_array_equal(masked[got], vals.numpy())
    if case == "none_above":
        assert np.isneginf(masked[got]).all() and got.tolist() == list(range(k))
    jvals, jidx = jax.lax.top_k(jnp.asarray(masked), k)
    np.testing.assert_array_equal(got, np.asarray(jidx))
    np.testing.assert_array_equal(masked[got].view(np.int32), np.asarray(jvals).view(np.int32))


def test_nms_cluster_splits_the_served_candidates():
    """``NMS_CTAS`` is the cluster size K3's source is built with, a portable
    one (at most 8 CTAs), and at 416² (N = 10647) each CTA's chunk fits one
    tile of its registers (1024 threads × 8 keys), so the kernel reads
    every score once."""
    src = (Path(cuda_kernels.__file__).parents[1] / "csrc" / "nms_topk.cu").read_text()
    built = re.findall(r"constexpr int kCtas = (\d+);", src)
    assert built == [str(NMS_CTAS)] and 1 <= NMS_CTAS <= 8
    n = 3 * (13 * 13 + 26 * 26 + 52 * 52)
    assert -(-n // NMS_CTAS) <= 1024 * 8
