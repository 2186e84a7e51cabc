"""Cross-ratio keypoint loss (counterpart of the JAX package's
``models/cross_ratio_loss.py``; reference ``RektNet/cross_ratio_loss.py``).

The location term is squared error on points (``l2_softargmax``/``l2_sm``),
squared error on heatmaps (``l2_heatmap``/``l2_hm``) or absolute error on
points (``l1_softargmax``/``l1_sm``). The optional geometric prior asks the
cone's side edges (point chains 0-1-3-5, 0-2-4-6) to be straight and its
horizontal colour boundaries parallel.

Parity quirk kept: the reference takes its geometric dot products with
``torch.tensordot(a, b, dims=([1], [1]))`` on (B, 2) tensors, the full
(B, B) cross-batch matrix, and averages over all B² pairs. That is
``cross_batch=True`` (the default); ``cross_batch=False`` uses the
per-sample diagonal.
"""

from __future__ import annotations

import torch

_EPS = 1e-12  # F.normalize's default eps


def _normalize(v):
    """Row-normalise (B, 2) as ``F.normalize``: x / max(‖x‖, eps). The norm
    takes the double ``where``, so the gradient at an exactly zero vector is
    0, not the NaN of sqrt's backward at 0 (soft-argmax points that
    collapse to one spot at init make such vectors)."""
    sq = (v * v).sum(dim=-1, keepdim=True)
    pos = sq > 0
    n = torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))),
                    torch.zeros_like(sq))
    return v / torch.clamp_min(n, _EPS)


def cross_ratio_loss(heatmap, points, target_hm, target_points,
                     loss_type: str = "l1_softargmax", include_geo: bool = True,
                     geo_loss_gamma_horz: float = 0.0,
                     geo_loss_gamma_vert: float = 0.0, cross_batch: bool = True):
    """Returns ``(location_loss, geo_loss, total_loss)`` scalars. heatmap,
    target_hm (B, K, H, W); points, target_points (B, K, 2)."""
    if loss_type in ("l2_softargmax", "l2_sm"):
        location_loss = ((points - target_points) ** 2).sum(dim=(1, 2)).mean()
    elif loss_type in ("l2_heatmap", "l2_hm"):
        location_loss = ((heatmap - target_hm) ** 2).sum(dim=(1, 2, 3)).mean()
    elif loss_type in ("l1_softargmax", "l1_sm"):
        location_loss = (points - target_points).abs().sum(dim=(1, 2)).mean()
    else:
        raise ValueError(f"Unknown loss_type {loss_type!r}")

    if not include_geo:
        return location_loss, location_loss.new_zeros(()), location_loss

    def dot(a, b):
        if cross_batch:
            return torch.einsum("ic,jc->ij", a, b)  # the reference's (B, B)
        return torch.einsum("ic,ic->i", a, b)

    p = points
    v53 = _normalize(p[:, 5] - p[:, 3])
    v31 = _normalize(p[:, 3] - p[:, 1])
    v10 = _normalize(p[:, 1] - p[:, 0])
    v64 = _normalize(p[:, 6] - p[:, 4])
    v42 = _normalize(p[:, 4] - p[:, 2])
    v20 = _normalize(p[:, 2] - p[:, 0])
    vA = 1.0 - dot(v31, v53)
    vB = 1.0 - dot(v10, v31)
    vC = 1.0 - dot(v64, v42)
    vD = 1.0 - dot(v42, v20)

    h21 = _normalize(p[:, 2] - p[:, 1])
    h43 = _normalize(p[:, 4] - p[:, 3])
    h65 = _normalize(p[:, 6] - p[:, 5])
    hA = 1.0 - dot(h43, h21)
    hB = 1.0 - dot(h65, h43)

    geo_loss = (geo_loss_gamma_horz * (hA + hB).mean() / 2
                + geo_loss_gamma_vert * (vA + vB + vC + vD).mean() / 4)
    return location_loss, geo_loss, location_loss + geo_loss
