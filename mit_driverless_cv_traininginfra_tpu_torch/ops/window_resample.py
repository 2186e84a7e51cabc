"""``window_resample``: a windowed gather plus a two-tap column resample —
counterpart of the JAX repository's crop probes
``tools/probe_crop_kernel.py`` P21/P22 (``kresample``).

For crop i, rows 0..rows-1 of the window at ``frames[fidx[i], r0[i]:,
l0[i]:]`` of (B, H, W·ch) frames are resampled along the columns::

    out[i, j, ch·m + c] = Σ_w bf16(hat(sx[i, m] − w)) · win[j, ch·w + c]
    hat(d) = clip(1 − |d|, 0, 1) in f32,   w ∈ [0, win_w)

summed in f32 and written in the frames' dtype (bf16). :func:`window_resample`
launches ``csrc/window_resample.cu`` for CUDA tensors and takes
:func:`window_resample_plain` (the (win_w, M) hat matrix and one batched
f32 product, as the probe's TPU kernel computes it) for CPU ones. At most
two taps are non-zero and each bf16·bf16 product is exact in f32, so the
two agree bit for bit. A window outside its frame is refused: the plain
version raises IndexError, the kernel traps (the launch fails, and the
error surfaces at the next synchronisation).
"""

from __future__ import annotations

import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib


def _windows(frames, fidx, r0, l0, rows: int, lanes: int):
    """(n, rows, lanes) window rows gathered from (B, H, WF) frames."""
    B, H, WF = frames.shape
    if fidx.numel():
        origins = torch.stack([fidx.long(), r0.long(), l0.long()])
        ends = torch.cat([origins.amin(1), origins.amax(1)]).tolist()  # one sync
        lo, hi = ends[:3], ends[3:]
        if min(lo) < 0 or hi[0] >= B or hi[1] + rows > H or hi[2] + lanes > WF:
            raise IndexError(f"a window of {rows} × {lanes} at frames {lo[0]}..{hi[0]}, "
                             f"rows {lo[1]}..{hi[1]}, lanes {lo[2]}..{hi[2]} leaves "
                             f"the ({B}, {H}, {WF}) frames")
    j = torch.arange(rows, device=frames.device)
    lane = torch.arange(lanes, device=frames.device)
    f = fidx.long()[:, None, None]
    r = r0.long()[:, None, None] + j[None, :, None]
    c = l0.long()[:, None, None] + lane[None, None, :]
    return frames[f, r, c]


def window_resample_plain(frames, fidx, r0, l0, sx, rows: int = 80,
                          win_w: int = 256, ch: int = 3):
    """Plain version: gather the windows' rows, build the hat matrix in f32
    and round it to bf16, one f32 batched product, cast to bf16."""
    n, M = sx.shape
    win = _windows(frames, fidx, r0, l0, rows, win_w * ch).float()
    win = win.reshape(n, rows, win_w, ch)
    w = torch.arange(win_w, device=sx.device, dtype=torch.float32)
    hat = torch.clamp(1.0 - (sx.float()[:, None, :] - w[None, :, None]).abs(),
                      0.0, 1.0)                               # (n, win_w, M)
    hat = hat.to(torch.bfloat16).float()
    out = torch.einsum("njwc,nwm->njmc", win, hat)
    return out.reshape(n, rows, M * ch).to(frames.dtype)


def window_resample(frames, fidx, r0, l0, sx, rows: int = 80,
                    win_w: int = 256, ch: int = 3):
    """frames (B, H, W·ch) bf16, fidx / r0 / l0 (n,) window origins (frame,
    row, lane), sx (n, M) f32 window columns → (n, rows, M·ch) bf16.
    CUDA kernel for CUDA tensors, :func:`window_resample_plain` for CPU
    ones."""
    if not frames.is_cuda:
        return window_resample_plain(frames, fidx, r0, l0, sx, rows, win_w, ch)
    B, H, WF = frames.shape
    n, M = sx.shape
    if frames.dtype != torch.bfloat16:
        raise TypeError(f"window_resample takes bf16 frames, got {frames.dtype}")
    if any(t.shape != (n,) for t in (fidx, r0, l0)):
        raise ValueError("fidx, r0 and l0 must each hold one value per crop")
    if any(t.device != frames.device for t in (fidx, r0, l0, sx)):
        raise ValueError("frames, indices and sx must share a device")
    f = frames.contiguous()
    idx = [t.to(torch.int32).contiguous() for t in (fidx, r0, l0)]
    s = sx.float().contiguous()
    out = torch.empty((n, rows, M * ch), dtype=f.dtype, device=f.device)
    with _lib.on_device(f.device):
        rc = _lib.lib().mdcv_window_resample(
            f.data_ptr(), idx[0].data_ptr(), idx[1].data_ptr(), idx[2].data_ptr(),
            s.data_ptr(), out.data_ptr(), n, B, H, WF, rows, M, win_w, ch,
            _lib.stream_ptr(f.device))
    _lib.check(rc, "window_resample")
    window_resample.launches += 1
    return out


window_resample.launches = 0
