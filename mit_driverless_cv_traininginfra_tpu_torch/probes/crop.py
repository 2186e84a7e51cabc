"""The crop probes (counterparts of the JAX repository's
``tools/probe_crop_kernel.py`` P20–P22 and ``tools/probe_crop_dma.py``
D1–D4): windowed gathers on ``strided_map`` and the two-tap column resample
on ``window_resample``, on the probes' seeded inputs (``default_rng(0)``,
in their draw order). P22 also times K1 (``roi_crop``), the port's current
crop, on the same 512 boxes, as the probe timed the JAX package's indexed
crop.
"""

from __future__ import annotations

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_crop import roi_crop
from mit_driverless_cv_traininginfra_tpu_torch.probes.base import (
    Probe,
    bf16_from,
    copy_work,
    indexed_copy,
    nbytes,
)

WIN, WINW = 256, 768                  # window rows, lanes (256 columns × 3)
ROWS, M, CH = 80, 80, 3               # resampled rows, columns, channels
N_SMALL = 16                          # P22's crops in the CPU tests


def _ints(rng, low, high, n, device, mult=1):
    return torch.from_numpy((rng.integers(low, high, n) * mult)
                            .astype(np.int32)).to(device)


def crop_kernel_arrays(device="cpu"):
    """probe_crop_kernel.py's arrays: frames (16, 416, 1248) bf16; P20/P21's
    fidx, r0, l0 (64,) and sx (64, 80); P22's fidx2, r02, l02 (512,) and
    sx2 (512, 80); frames4 (16, 416, 416, 3) bf16 and boxes (512, 4)."""
    rng = np.random.default_rng(0)
    B, H, WF, C, C2 = 16, 416, 1248, 64, 512
    d = {"frames": bf16_from(rng.random((B, H, WF)), device)}
    d["fidx"] = _ints(rng, 0, B, C, device)
    d["r0"] = _ints(rng, 0, H - WIN, C, device)
    d["l0"] = _ints(rng, 0, (WF - WINW) // 128, C, device, 128)
    d["sx"] = torch.from_numpy(rng.uniform(5, 250, (C, 80)).astype(np.float32)).to(device)
    d["fidx2"] = _ints(rng, 0, B, C2, device)
    d["r02"] = _ints(rng, 0, H - WIN, C2, device)
    d["l02"] = _ints(rng, 0, (WF - WINW) // 128, C2, device, 128)
    d["sx2"] = torch.from_numpy(rng.uniform(5, 250, (C2, 80)).astype(np.float32)).to(device)
    d["frames4"] = bf16_from(rng.random((B, H, 416, 3)), device)
    boxes = np.stack([rng.uniform(10, 200, C2), rng.uniform(10, 200, C2),
                      rng.uniform(210, 400, C2), rng.uniform(210, 400, C2)], axis=1)
    d["boxes"] = torch.from_numpy(boxes.astype(np.float32)).to(device)
    return d


def window_view(frames, n: int, rows: int, lanes: int):
    """n windows of rows × lanes of (B, H, WF) frames, as a view with a zero
    program stride: each program's origin comes from the index arrays."""
    return frames.as_strided((n, rows, lanes), (0, frames.shape[2], 1))


def window_index(frames, fidx, r0=None, l0=None):
    """The (index, stride) pairs of a window origin (frame, row, lane)."""
    _, H, WF = frames.shape
    index = [(fidx, H * WF)]
    if r0 is not None:
        index.append((r0, WF))
    if l0 is not None:
        index.append((l0, 1))
    return index


def _p20(device, small=False):
    d = crop_kernel_arrays(device)
    return {"x": window_view(d["frames"], 64, WIN, WINW),
            "index": window_index(d["frames"], d["fidx"], d["r0"], d["l0"])}


def _resample_inputs(suffix: str, n: int | None):
    def build(device, small=False):
        d = crop_kernel_arrays(device)
        k = slice(0, N_SMALL if small and n is None else None)
        out = {"frames": d["frames"], "fidx": d["fidx" + suffix][k],
               "r0": d["r0" + suffix][k], "l0": d["l0" + suffix][k],
               "sx": d["sx" + suffix][k]}
        if suffix:  # P22: K1 on the same boxes, timed beside
            out.update(frames4=d["frames4"], boxes=d["boxes"][k], fidx4=d["fidx2"][k])
        return out
    return build


def _resample(inp, ops):
    return ops.window_resample(inp["frames"], inp["fidx"], inp["r0"],
                               inp["l0"], inp["sx"], ROWS, WIN, CH)


def resample_work(inp, out):
    """Bytes: the window values the taps reach (each read once), sx, the
    output; operations: per output value two taps of ~8 f32 operations."""
    s = inp["sx"].float()
    w0 = torch.floor(s)
    taps = torch.cat([w0, w0 + 1], dim=1)
    taps = torch.where((taps >= 0) & (taps < WIN), taps, torch.full_like(taps, -1.0))
    reached = sum(int(torch.unique(row[row >= 0]).numel()) for row in taps)
    window_bytes = reached * ROWS * CH * inp["frames"].element_size()
    return window_bytes + nbytes(s, out), 16 * out.numel(), "f32"


def _k1_beside(inp):
    f, b, i = inp["frames4"], inp["boxes"], inp["fidx4"]
    return lambda: roi_crop(f, b, i)


def crop_dma_arrays(device="cpu"):
    """probe_crop_dma.py's frames (8, 416, 1248) bf16 and fidx, r0, l0 (8,)."""
    rng = np.random.default_rng(0)
    B, H, WF, C = 8, 416, 1248, 8
    frames = bf16_from(rng.random((B, H, WF)), device)
    return {"frames": frames, "fidx": _ints(rng, 0, B, C, device),
            "r0": _ints(rng, 0, H - WIN, C, device),
            "l0": _ints(rng, 0, (WF - WINW) // 128, C, device, 128)}


def _dma(which: str):
    """D1 frame only, D2 + row, D3 / D4 + row + lane: out (8, 64, 128)."""
    def build(device, small=False):
        d = crop_dma_arrays(device)
        f = d["frames"]
        r0 = d["r0"] if which != "D1" else None
        l0 = d["l0"] if which in ("D3", "D4") else None
        return {"x": window_view(f, 8, 64, 128),
                "index": window_index(f, d["fidx"], r0, l0)}
    return build


DMA50 = "tools/probe_crop_dma.py:50"

PROBES = [
    Probe("P20", "tools/probe_crop_kernel.py:77", "strided_map", _p20,
          indexed_copy, copy_work),
    Probe("P21", "tools/probe_crop_kernel.py:125", "window_resample",
          _resample_inputs("", 64), _resample, resample_work),
    Probe("P22", "tools/probe_crop_kernel.py:156", "window_resample",
          _resample_inputs("2", None), _resample, resample_work,
          beside=("K1 roi_crop, same 512 boxes", _k1_beside)),
    Probe("D1", DMA50, "strided_map", _dma("D1"), indexed_copy, copy_work),
    Probe("D2", DMA50, "strided_map", _dma("D2"), indexed_copy, copy_work),
    Probe("D3", DMA50, "strided_map", _dma("D3"), indexed_copy, copy_work),
    Probe("D4", DMA50, "strided_map", _dma("D4"), indexed_copy, copy_work),
]
