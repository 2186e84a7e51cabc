"""``window_resample``'s card kernel (``csrc/window_resample.cu``) modelled
in numpy, block by block, and held bit for bit to the plain version
(``window_resample_plain``) on the CPU.

The model follows the kernel's schedule: one block per (crop, band of
``KBAND`` rows); a tap table per block (the value the sum starts from, each
tap's window lane or −1 and its bf16-rounded hat) and the span of window
columns the taps reach; the window tested against its frame once a block;
each band row's span staged in 8-value chunks on the frames' 16-byte grid
(whole chunks as one 16-byte load, the unaligned head and tail element by
element, nothing read outside the span, the threads' walk over the
chunks); a thread per output column m
over the band's rows, each value ``base + hat0·v0 + hat1·v1`` in f32 from
the staged rows, into an output tile laid on the output's 16-byte grid;
the band's run written out of the tile in 8-value chunks (whole chunks as
one 16-byte store, head and tail element by element). ``frames_phase`` and
``out_phase`` are how many elements past a 16-byte boundary the two bases
lie.
"""

import functools

import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops.window_resample import (
    window_resample,
    window_resample_plain,
)
from mit_driverless_cv_traininginfra_tpu_torch.probes.crop import crop_kernel_arrays

KBAND, KTHREADS = 16, 256  # csrc/window_resample.cu: kBand, kThreads


def _bf16(x):
    """f32 → bf16 → f32, round to nearest even (as __float2bfloat16_rn)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _taps(s, win_w: int, ch: int):
    """Step 1 for one crop's M coordinates: (base, hat0, hat1, o0, o1, lo,
    hi); o is a tap's lane in a window row (column · ch) or −1."""
    s = s.astype(np.float32)
    w0 = np.floor(s)
    base = np.where(np.isnan(s), s, np.float32(0))
    hats, lanes, cols = [], [], []
    with np.errstate(invalid="ignore"):
        for t in (0, 1):
            wf = (w0 + np.float32(t)).astype(np.float32)
            inside = (wf >= 0) & (wf < win_w)
            hat = np.clip(np.float32(1) - np.abs(s - wf), 0, 1).astype(np.float32)
            hats.append(_bf16(np.where(inside, hat, np.float32(0))))
            col = np.where(inside, wf, -1).astype(np.int64)
            lanes.append(np.where(inside, col * ch, -1))
            cols.append(col[inside])
    reached = np.concatenate(cols)
    lo, hi = (int(reached.min()), int(reached.max())) if reached.size else (0, -1)
    return base, hats[0], hats[1], lanes[0], lanes[1], lo, hi


@functools.cache
def _walk(R, chunks):
    """The (row, chunk) pairs the threads stage for the band's R rows:
    one division a thread, then steps of KTHREADS."""
    djj, dq = divmod(KTHREADS, chunks)
    walked = []
    for tid in range(KTHREADS):
        jj, q = tid // chunks, tid % chunks
        while jj < R:
            if q >= chunks:
                q, jj = q - chunks, jj + 1
            if jj >= R:
                break
            walked.append((jj, q))
            jj, q = jj + djj, q + dq
    return tuple(walked)


def model(frames, fidx, r0, l0, sx, rows: int, win_w: int, ch: int,
          frames_phase: int = 0, out_phase: int = 0):
    """The kernel's output (n, rows, M·ch) as f32 values of bf16, with the
    counts of 16-byte loads and stores it issues."""
    B, H, WF = frames.shape
    flat = frames.reshape(-1).astype(np.float32)
    n, M = sx.shape
    lanes = M * ch
    stride = (win_w * ch + 7 + 7) // 8 * 8
    out = np.zeros(n * rows * lanes, np.float32)
    written = np.zeros(n * rows * lanes, np.int64)
    loads = stores = 0
    for i in range(n):
        f, r, l = int(fidx[i]), int(r0[i]), int(l0[i])
        for j0 in range(0, rows, KBAND):
            R = min(KBAND, rows - j0)
            # the block's one bounds test, before any read of the frames
            if f < 0 or f >= B or r < 0 or r > H - rows or l < 0 or l > WF - win_w * ch:
                raise IndexError(f"window {i} leaves the frames")
            base, h0, h1, o0, o1, lo, hi = _taps(sx[i], win_w, ch)
            span = (hi - lo + 1) * ch if hi >= lo else 0

            # 2. stage each band row's span at phase + k
            win = np.full((R, stride), np.nan, np.float32)  # unstaged: NaN
            chunks = (span + 14) >> 3
            # the threads' walk over (row, chunk): every chunk once
            assert sorted(_walk(R, chunks)) == [(a, b) for a in range(R) for b in range(chunks)]
            jj = np.arange(R)[:, None]
            src = ((f * H + r + j0 + jj) * WF + l) + lo * ch  # (R, 1) element index
            phase = ((frames_phase + src) % 8)[:, 0]
            k = 8 * np.arange(chunks)[None, :, None] - phase[:, None, None] + np.arange(8)
            k0 = k[:, :, 0]  # span element of each chunk's first lane
            whole = (k0 >= 0) & (k0 + 8 <= span)  # one 16-byte load each
            assert ((frames_phase + src + k0)[whole] % 8 == 0).all()  # on 16 bytes
            loads += int(whole.sum())
            inside = (k >= 0) & (k < span)  # all a chunk reads, head and tail too
            gidx = (src[:, :, None] + k)[inside]
            row_lo = (src - lo * ch)[:, :, None] + np.zeros_like(k)
            assert ((gidx >= row_lo[inside]) & (gidx < row_lo[inside] + win_w * ch)).all()
            slot = (8 * np.arange(chunks)[None, :, None] + np.arange(8)) + np.zeros_like(k)
            rows_of = np.zeros_like(k) + jj[:, :, None]
            win[rows_of[inside], slot[inside]] = flat[gidx]

            # 3. resample into the band's output tile, a thread a column m
            # over the rows g, g + groups, ...
            total = R * lanes
            run = (i * rows + j0) * lanes
            po = (out_phase + run) % 8
            tile = np.full(((total + 14) // 8 * 8,), np.nan, np.float32)
            groups = KTHREADS // M if M < KTHREADS else 1
            g, m = np.divmod(np.arange(groups * M), M)
            pairs = [(jj_, m_) for g_, m_ in zip(g, m) for jj_ in range(g_, R, groups)]
            jj, m = np.array(pairs).T.reshape(2, -1, 1)
            formed = np.zeros((R, M), np.int64)
            np.add.at(formed, (jj[:, 0], m[:, 0]), 1)
            assert (formed == 1).all()  # every (row, column) once
            cc = np.arange(ch)
            acc = np.broadcast_to(base[m], (jj.shape[0], ch)).astype(np.float32)
            for hat, o in ((h0, o0), (h1, o1)):
                ok = o[m] >= 0
                idx = np.where(ok, phase[jj] + o[m] - lo * ch + cc, 0)
                acc = np.where(ok, (acc + hat[m] * win[jj, idx]).astype(np.float32), acc)
            tile[po + jj * lanes + m * ch + cc] = acc

            # 4. the run out of the tile in 8-value chunks
            e0 = 8 * np.arange((po + total + 7) >> 3) - po
            whole = (e0 >= 0) & (e0 + 8 <= total)  # one 16-byte store each
            assert ((out_phase + run + e0[whole]) % 8 == 0).all()  # on 16 bytes
            stores += int(whole.sum())
            e = (e0[:, None] + np.arange(8)).reshape(-1)
            e = e[(e >= 0) & (e < total)]
            out[run + e] = tile[po + e]
            np.add.at(written, run + e, 1)
    assert (written == 1).all()  # every output written once
    return _bf16(out).reshape(n, rows, lanes), loads, stores


def _same_bits(got, want):
    """Bit for bit; a NaN only has to be a NaN."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _plain(frames, fidx, r0, l0, sx, rows, win_w, ch):
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    return window_resample_plain(t(frames).to(torch.bfloat16), t(fidx), t(r0), t(l0), t(sx),
                                 rows, win_w, ch).float().numpy()


def test_model_equals_plain_on_p21_draws():
    """P21's 64 crops (80 rows, 80 columns of 3 channels, a 256-column
    window at lanes that are multiples of 128) from the probe's draws:
    every row's span staged in whole 16-byte chunks but its ends, every
    output run in whole chunks."""
    d = crop_kernel_arrays("cpu")
    frames = d["frames"].float().numpy()
    args = (d["fidx"].numpy(), d["r0"].numpy(), d["l0"].numpy(), d["sx"].numpy(), 80, 256, 3)
    got, loads, stores = model(frames, *args)
    _same_bits(got, _plain(frames, *args))
    assert stores == 64 * 80 * 240 // 8  # 240 lanes: runs of whole chunks only
    assert loads > 64 * 80 * 80  # most of each row's ~720-lane span


@pytest.mark.parametrize("ch,M", [(1, 13), (3, 13), (4, 11), (3, 80)])
@pytest.mark.parametrize("frames_phase,out_phase", [(0, 0), (3, 0), (1, 5), (7, 2)])
def test_model_equals_plain_on_unaligned_shapes(ch, M, frames_phase, out_phase):
    """Rows of 90 lanes, odd lane origins, M·ch lanes not a multiple of 8
    (but for 80 × 3), 50 rows (not a multiple of the band), bases off 16
    bytes; taps at the window's edges, between them, outside it, ±inf, NaN,
    and a crop whose taps all lie outside."""
    rng = np.random.default_rng(20 + ch)
    frames = _bf16(rng.random((3, 120, 90)).astype(np.float32))
    win_w = 20 if ch < 4 else 15
    fidx = np.array([2, 0, 1, 2, 1], np.int32)
    r0 = np.array([0, 17, 40, 33, 70], np.int32)
    l0 = np.array([0, 3, 11, 90 - win_w * ch, 7], np.int32)
    sx = (rng.random((5, M)) * (win_w + 4) - 2).astype(np.float32)
    sx[0, :8] = [0.0, win_w - 1.0, win_w - 0.5, -0.5, -3.0, np.nan, np.inf, -np.inf]
    sx[4] = -5.0
    args = (fidx, r0, l0, sx, 50, win_w, ch)
    got, _, stores = model(frames, *args, frames_phase=frames_phase, out_phase=out_phase)
    _same_bits(got, _plain(frames, *args))
    assert np.isnan(got[0, :, 5 * ch:6 * ch]).all() and (got[4] == 0).all()
    assert stores > 0


def test_model_and_plain_refuse_a_window_outside_the_frame():
    """A window one row past the frame: the model's per-block test (the
    kernel traps there) and the plain version both refuse it."""
    frames = np.zeros((2, 30, 24), np.float32)
    sx = np.zeros((2, 4), np.float32)
    args = (np.array([0, 1], np.int32), np.array([0, 11], np.int32),
            np.array([0, 6], np.int32), sx, 20, 6, 3)
    with pytest.raises(IndexError):
        model(frames, *args)
    with pytest.raises(IndexError):
        _plain(frames, *args)


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version and counts no
    launch."""
    d = crop_kernel_arrays("cpu")
    k = slice(0, 4)
    args = (d["frames"], d["fidx"][k], d["r0"][k], d["l0"][k], d["sx"][k], 80, 256, 3)
    before = window_resample.launches
    got = window_resample(*args)
    assert window_resample.launches == before
    assert torch.equal(got.view(torch.int16), window_resample_plain(*args).view(torch.int16))
