"""Fixed-shape greedy NMS of the detection path (counterpart of the JAX
package's ``ops/nms.py``, which XLA compiles: no Pallas kernel, so plain
PyTorch here).

Score-descending greedy suppression as the reference's ``utils/nms.py``: a
candidate is dropped iff its IoU with an earlier *kept* box exceeds
``overlap``, IoU without the +1 pixel convention
(``ops.boxes.iou_no_plus_one_pairwise``). Candidates are the ``top_k``
best scores in ``lax.top_k`` order (``_topk_stable``: ties to the lower
index, +0 above −0); a non-finite score (``-inf`` for padded rows) is never
kept. Kept indices are compacted to the front, in kept order, and padded
with 0 past the count.

The served path does not run this: its NMS is kernel K3
(``ops.cuda_kernels.nms_topk``), which keeps ``max_det`` slots in place.
"""

from __future__ import annotations

import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops.boxes import (
    iou_no_plus_one_pairwise,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    _topk_stable,
)


def batched_nms(boxes, scores, overlap: float = 0.5, top_k: int = 200):
    """Greedy NMS of each image of a batch: boxes (B, N, 4) xyxy, scores
    (B, N) (``-inf`` for padded rows). Returns ``(keep_idx (B, top_k)
    int64, keep_mask (B, top_k) bool)``: indices into N in kept
    (score-descending) order, 0 past each image's count."""
    B, n = scores.shape
    k = min(top_k, n)
    top_scores, order = _topk_stable(scores, k)
    cand = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    iou = iou_no_plus_one_pairwise(cand, cand)  # (B, k, k)
    alive = torch.isfinite(top_scores)
    later = torch.arange(k, device=scores.device)
    kept = torch.zeros_like(alive)
    for i in range(k):
        is_kept = alive[:, i]
        kept[:, i] = is_kept
        alive = alive & ~((later > i) & (iou[:, i] > overlap) & is_kept[:, None])
    # compact the kept slots to the front, in score order; dropped ones go
    # to a spare slot past the end, which is cut off
    dest = torch.where(kept, torch.cumsum(kept.long(), dim=1) - 1,
                       torch.full_like(order, top_k))
    keep_idx = torch.zeros((B, top_k + 1), dtype=torch.int64,
                           device=scores.device)
    keep_mask = torch.zeros((B, top_k + 1), dtype=torch.bool,
                            device=scores.device)
    keep_idx.scatter_(1, dest, torch.where(kept, order, torch.zeros_like(order)))
    keep_mask.scatter_(1, dest, kept)
    return keep_idx[:, :top_k], keep_mask[:, :top_k]


def nms(boxes, scores, overlap: float = 0.5, top_k: int = 200):
    """Single-image greedy NMS: boxes (N, 4) xyxy, scores (N,). Returns
    ``(keep_idx (top_k,) int64, keep_mask (top_k,) bool)``, as
    :func:`batched_nms` for one image."""
    keep_idx, keep_mask = batched_nms(boxes[None], scores[None], overlap,
                                      top_k)
    return keep_idx[0], keep_mask[0]
