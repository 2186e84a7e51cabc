"""K2 (soft-argmax, forward and backward) and K3 (threshold + top-k +
NMS) — counterpart of the JAX package's ``ops/pallas_kernels.py``.

Each wrapper launches its CUDA kernel (``csrc/softargmax.cu``,
``csrc/nms_topk.cu``) for CUDA tensors and takes its plain PyTorch version
for CPU tensors; there is no fallback from one to the other. Each counts
its kernel launches in a plain ``launches`` int on the wrapper.
"""

from __future__ import annotations

import functools

import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib
from mit_driverless_cv_traininginfra_tpu_torch.ops.boxes import (
    iou_no_plus_one_pairwise,
)

# ---------------------------------------------------------------------------
# K2: fused flat softmax + soft-argmax (forward)
# ---------------------------------------------------------------------------


def _linspace_f32(stop: float, num: int):
    """``jnp.linspace(0, stop, num, dtype=float32)`` bit for bit, as XLA
    compiles it: its algebraic simplifier turns ``iota / (num−1)`` into
    ``iota · (1/(num−1))`` and folds the constants, so element i is
    ``i · fl(stop · fl(1/(num−1)))`` in f32, and the last one is ``stop``.
    ``torch.linspace`` and the textbook ``stop · i/(num−1)`` each differ
    from that by 1 ulp at some points (num = 13, 80, ...)."""
    stop_t = torch.tensor(stop, dtype=torch.float32)
    if num == 1:
        return torch.zeros(1, dtype=torch.float32)
    step = stop_t * (torch.tensor(1.0, dtype=torch.float32) / float(num - 1))
    return torch.cat([torch.arange(num - 1, dtype=torch.float32) * step,
                      stop_t[None]])


@functools.cache
def _coord_tables(h: int, w: int, device="cpu"):
    """The f32 grids (xs of w entries, ys of h) over
    ``linspace(0, (n−1)/n, n)`` that K2's kernels read:
    ``xv[i] = xs[i % w]``, ``yv[i] = ys[i // w]``. Built on the CPU and
    copied once per device, so the device's arithmetic never enters the
    grid and no call pays a host→device copy."""
    xs = _linspace_f32((w - 1.0) / w, w)
    ys = _linspace_f32((h - 1.0) / h, h)
    return xs.to(device), ys.to(device)


@functools.cache
def _coord_rows(h: int, w: int, device="cpu"):
    """(1, h·w) f32 coordinate rows (x, y), bit-equal to the JAX package's
    ``_coord_rows``: the tables of :func:`_coord_tables` laid along the
    flattened map (the plain versions read them)."""
    xs, ys = _coord_tables(h, w)
    yv = ys.repeat_interleave(w)  # y varies over rows of the map
    xv = xs.repeat(h)
    return xv[None, :].to(device), yv[None, :].to(device)


def _check_tables(h: int, w: int) -> None:
    """K2's kernels hold the w + h coordinate tables in the 48 KB of
    shared memory a launch gets unasked."""
    if h + w > 10240:
        raise ValueError(f"a {h}×{w} map's coordinate tables exceed the "
                         f"kernel's shared memory")


def _torch_softargmax(logits):
    """Plain version of K2, the twin of ``_xla_softargmax``: logits
    (M, H, W) → (points (M, 2) f32 in [0, 1) xy, probs (M, H, W) in the
    logits dtype)."""
    m, h, w = logits.shape
    z = logits.reshape(m, h * w).float()
    z = z - z.amax(dim=-1, keepdim=True)
    e = torch.exp(z)
    p = e / e.sum(dim=-1, keepdim=True)
    xv, yv = _coord_rows(h, w, logits.device)
    pts = torch.stack([(p * xv).sum(dim=1), (p * yv).sum(dim=1)], dim=1)
    return pts, p.reshape(m, h, w).to(logits.dtype)


def _cuda_softargmax(logits):
    """K2 forward launch: the outputs of :func:`_torch_softargmax`."""
    m, h, w = logits.shape
    code = _lib.dtype_code(logits.dtype)
    _check_tables(h, w)
    z = logits.contiguous()
    xs, ys = _coord_tables(h, w, logits.device)
    probs = torch.empty_like(z)
    pts = torch.empty((m, 2), dtype=torch.float32, device=logits.device)
    with _lib.on_device(logits.device):
        rc = _lib.lib().mdcv_softargmax(
            z.data_ptr(), xs.data_ptr(), ys.data_ptr(), probs.data_ptr(),
            pts.data_ptr(), m, h, w, code, _lib.stream_ptr(logits.device))
    _lib.check(rc, "softargmax")
    fused_softargmax.launches += 1
    return pts, probs


def _torch_softargmax_bwd(probs, g_pts, g_probs=None):
    """Plain version of K2's backward, the JAX package's ``_bwd``: with
    ``gp = g_probs + g_x·xv + g_y·yv`` per row of the saved ``probs``,
    ``dz = p·(gp − Σ gp·p)`` in f32, returned in the probs' dtype. A
    missing ``g_probs`` counts as zeros."""
    m, h, w = probs.shape
    p = probs.reshape(m, h * w).float()
    xv, yv = _coord_rows(h, w, probs.device)
    gp = g_pts[:, 0:1].float() * xv + g_pts[:, 1:2].float() * yv
    if g_probs is not None:
        gp = g_probs.reshape(m, h * w).float() + gp
    dz = p * (gp - (gp * p).sum(dim=1, keepdim=True))
    return dz.reshape(m, h, w).to(probs.dtype)


def softargmax_bwd(probs, g_pts, g_probs=None):
    """K2's backward: the logits' gradient from the saved ``probs`` (M, H,
    W), the points' gradient ``g_pts`` (M, 2) and the probabilities'
    gradient ``g_probs`` (M, H, W) or None. CUDA kernel for CUDA tensors,
    :func:`_torch_softargmax_bwd` for CPU ones."""
    if not probs.is_cuda:
        return _torch_softargmax_bwd(probs, g_pts, g_probs)
    m, h, w = probs.shape
    code = _lib.dtype_code(probs.dtype)
    p = probs.contiguous()
    gpts = g_pts.float().contiguous()
    gpr = None if g_probs is None else g_probs.to(p.dtype).contiguous()
    if gpts.shape != (m, 2) or (gpr is not None and gpr.shape != p.shape):
        raise ValueError(f"gradients {tuple(gpts.shape)}, "
                         f"{None if gpr is None else tuple(gpr.shape)} do not "
                         f"fit probs {tuple(p.shape)}")
    _check_tables(h, w)
    xs, ys = _coord_tables(h, w, probs.device)
    dz = torch.empty_like(p)
    if m == 0:
        return dz
    with _lib.on_device(probs.device):
        rc = _lib.lib().mdcv_softargmax_bwd(
            p.data_ptr(), None if gpr is None else gpr.data_ptr(),
            gpts.data_ptr(), xs.data_ptr(), ys.data_ptr(), dz.data_ptr(), m,
            h, w, code, _lib.stream_ptr(probs.device))
    _lib.check(rc, "softargmax_bwd")
    softargmax_bwd.launches += 1
    return dz


softargmax_bwd.launches = 0


class _SoftArgmax(torch.autograd.Function):
    """K2 with its gradient (the JAX package's custom VJP): the forward
    saves ``probs`` in the logits' dtype, the backward is
    :func:`softargmax_bwd` on both devices."""

    @staticmethod
    def forward(ctx, logits):
        pts, probs = (_cuda_softargmax(logits) if logits.is_cuda
                      else _torch_softargmax(logits))
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(probs)
        return pts, probs

    @staticmethod
    def backward(ctx, g_pts, g_probs):
        (probs,) = ctx.saved_tensors
        if g_pts is None:
            g_pts = probs.new_zeros((probs.shape[0], 2), dtype=torch.float32)
        return softargmax_bwd(probs, g_pts, g_probs)


def fused_softargmax(logits):
    """(M, H, W) heatmap logits → (points (M, 2) f32, probs (M, H, W)).
    CUDA kernel for CUDA tensors, :func:`_torch_softargmax` for CPU ones;
    where a gradient is wanted, through :class:`_SoftArgmax`, whose
    backward is :func:`softargmax_bwd`."""
    if torch.is_grad_enabled() and logits.requires_grad:
        return _SoftArgmax.apply(logits)
    if logits.is_cuda:
        return _cuda_softargmax(logits)
    return _torch_softargmax(logits)


fused_softargmax.launches = 0

# ---------------------------------------------------------------------------
# K3: fused conf threshold + top-k + greedy NMS
# ---------------------------------------------------------------------------


def _topk_stable(x, k: int):
    """``jax.lax.top_k`` of f32 ``x`` along the last axis: descending in
    XLA's total order of floats, so +0 above −0 (the two compare equal);
    ties to the lower index (``torch.topk`` orders ties differently). The
    sort key is the f32 bits as int32 with a negative value's magnitude
    bits flipped, which orders ints as that total order orders floats."""
    bits = x.float().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def _torch_nms_topk(boxes, scores, conf_thresh: float, k: int,
                    overlap: float):
    """Plain version of K3, the twin of ``_xla_nms_topk`` with its slot
    layout: boxes (B, N, 4), scores (B, N) → (boxes (B, k, 4) f32,
    scores (B, k) f32 with −inf below conf, idx (B, k) int64,
    keep (B, k) bool)."""
    scores = scores.float()
    masked = torch.where(scores > conf_thresh, scores,
                         torch.full_like(scores, -torch.inf))
    top_val, top_idx = _topk_stable(masked, k)
    cand = torch.gather(boxes.float(), 1,
                        top_idx[..., None].expand(-1, -1, 4))
    iou = iou_no_plus_one_pairwise(cand, cand)  # (B, k, k)
    alive = torch.isfinite(top_val)
    slot = torch.arange(k, device=scores.device)
    kept_cols = []
    for i in range(k):
        is_kept = alive[:, i]
        kept_cols.append(is_kept)
        later = slot[None, :] > i
        alive = alive & ~(later & (iou[:, i, :] > overlap) & is_kept[:, None])
    return cand, top_val, top_idx, torch.stack(kept_cols, dim=1)


# CTAs per image, as csrc/nms_topk.cu is built (kCtas): one thread-block
# cluster splits the N scores in chunks
NMS_CTAS = 8


def _cuda_nms_topk(boxes, scores, conf_thresh: float, k: int,
                   overlap: float):
    """K3 launch: same outputs as :func:`_torch_nms_topk` (idx int32)."""
    B, N, _ = boxes.shape
    if scores.shape != (B, N):
        raise ValueError(f"scores {tuple(scores.shape)} vs boxes "
                         f"{tuple(boxes.shape)}")
    if not 1 <= k <= min(N, 64):
        raise ValueError(f"k={k} must lie in [1, min(N={N}, 64)]")
    dev = boxes.device
    b = boxes.float().contiguous()
    s = scores.float().contiguous()
    out_b = torch.empty((B, k, 4), dtype=torch.float32, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_keep = torch.empty((B, k), dtype=torch.bool, device=dev)
    with _lib.on_device(dev):
        rc = _lib.lib().mdcv_nms_topk(
            b.data_ptr(), s.data_ptr(), out_b.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), out_keep.data_ptr(), B, N, k, conf_thresh,
            overlap, _lib.stream_ptr(dev))
    _lib.check(rc, "nms_topk")
    nms_topk.launches += 1
    return out_b, out_s, out_i, out_keep


def nms_topk(boxes, scores, conf_thresh: float, k: int = 16,
             overlap: float = 0.25):
    """Fused conf-filter + top-k + greedy NMS per image.

    Returns (boxes (B,k,4), scores (B,k), keep (B,k) bool), where slot i
    holds the i-th candidate in ``lax.top_k`` order; suppressed candidates
    keep their slot with keep=False and below-conf slots carry score −inf
    (the slot layout of the JAX package's ``_xla_nms_topk``). Greedy
    suppression at IoU > overlap, no +1 convention."""
    if boxes.is_cuda:
        out = _cuda_nms_topk(boxes, scores, conf_thresh, k, overlap)
    else:
        out = _torch_nms_topk(boxes, scores, conf_thresh, k, overlap)
    b, s, _, keep = out
    return b, s, keep


nms_topk.launches = 0
