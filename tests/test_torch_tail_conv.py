"""``ops/tail_conv.py`` (RektNet's int8 ``res4.conv1`` with its relu)
against the JAX repository's probe ``tools/probe_tail_conv1.py`` on the
CPU, at C=2 crops of the probe's 80×80×64 input.

- The port's draws equal the probe's (``default_rng(0)``: h, w, bias).
- The plain version equals the probe's XLA twin (``xla_`` in its
  ``main``), recomputed op by op under ``jax.disable_jit()``, bit for bit.
- The probe's Pallas kernel ``tail_conv1`` runs in interpret mode; its
  pair-layout slab, read back as NHWC, is within one bf16 ulp of the plain
  version on at most 1e-5 of the values: the interpreted body contracts
  ``acc·scale + b`` into one FMA, the port rounds twice.
- The probe's arrays carried into a ``QConv``: its weight matrix is the
  probe's ``wim``. A quantized ``Int8RektNet``'s own ``res4.conv1`` leaves
  (the port's tiny width) laid out as the probe's arrays and carried over:
  the same convolution, held to the JAX package's int8 conv on the same
  leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu
from test_torch_entry import _lane_rows, _ldmatrix, _wgmma_b
from test_torch_probes import jax_tool

from mit_driverless_cv_traininginfra_tpu.models import quantize as jquantize
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.models import quantize, rektnet
from mit_driverless_cv_traininginfra_tpu_torch.ops import entry
from mit_driverless_cv_traininginfra_tpu_torch.ops.tail_conv import (
    pack_tail_conv,
    tail_conv,
    tail_conv_plain,
)
from mit_driverless_cv_traininginfra_tpu_torch.probes import tail_conv1

C, SX = 2, 2.0


def _jax_draws(C: int):
    """``main()``'s arrays of ``tools/probe_tail_conv1.py`` at C crops."""
    rng = np.random.default_rng(0)
    h = jnp.asarray(rng.standard_normal((C, 80, 80, 64)) * 0.5, jnp.bfloat16)
    w = rng.standard_normal((3, 3, 64, 128)).astype(np.float32) * 0.1
    s_w = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, 1e-12)
    wq = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
    scale = jnp.asarray((SX / 127.0) * s_w, jnp.float32).reshape(1, 128)
    bias = jnp.asarray(rng.standard_normal(128) * 0.1, jnp.float32).reshape(1, 128)
    sx_inv = jnp.asarray([[127.0 / SX]], jnp.float32)
    return {"h": h, "wq": wq, "wim": jnp.asarray(wq.reshape(576, 128), jnp.int8),
            "scale": scale, "bias": bias, "sx_inv": sx_inv}


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


@pytest.fixture(scope="module")
def case():
    """The JAX draws, the port's probe inputs and the plain output."""
    j = _jax_draws(C)
    inp = tail_conv1.probe_inputs(C)
    q = tail_conv1.qconv_from_probe(inp["wim"], inp["scale"], inp["bias"], inp["sx_inv"])
    return j, inp, q, tail_conv_plain(inp["h"], q)


def test_probe_inputs_are_the_probes_draws(case):
    j, inp, _, _ = case
    assert torch.equal(inp["h"].view(torch.int16), _bf16(j["h"]).view(torch.int16))
    for k in ("wim", "scale", "bias", "sx_inv"):
        np.testing.assert_array_equal(inp[k].numpy(), np.asarray(j[k]), err_msg=k)


def test_plain_equals_the_xla_twin_bit_for_bit(case):
    j, inp, _, got = case
    with jax.disable_jit():
        xq = jnp.clip(jnp.round(j["h"].astype(jnp.float32) * (127.0 / SX)),
                      -127, 127).astype(jnp.int8)
        acc = jax.lax.conv_general_dilated(
            xq, jnp.asarray(j["wq"]), (1, 1), [(2, 2), (2, 2)], rhs_dilation=(2, 2),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        y = acc.astype(jnp.float32) * j["scale"][0] + j["bias"][0]
        want = jnp.maximum(y.astype(jnp.bfloat16), 0)
    assert got.shape == (C, 80, 80, 128) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), _bf16(want).view(torch.int16))


def test_plain_within_one_ulp_of_the_interpret_mode_kernel(case, tmp_path):
    j, _, _, got = case
    with jax_tool("probe_tail_conv1.py", str(tmp_path)) as probe:
        xp = j["h"].reshape(C, 80, 40, 128).reshape(C, 3200, 128)
        with pltpu.force_tpu_interpret_mode():
            slab = probe.tail_conv1(xp, j["wim"], j["scale"], j["bias"], j["sx_inv"])
    assert slab.shape == (C, tail_conv1.NSLAB, 256)
    kern = tail_conv1.nhwc_from_slab(_bf16(slab)).float()
    ref = got.float()
    diff = kern != ref
    # one bf16 ulp at the larger magnitude: 2^(exponent − 7)
    mag = torch.maximum(kern.abs(), ref.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert int(diff.sum()) <= 1e-5 * ref.numel(), int(diff.sum())
    assert bool(((kern - ref).abs()[diff] <= ulp[diff]).all())


def test_nhwc_from_slab_reads_the_probes_positions():
    """The probe's own spot check: pixel (r, 2p+q) at slab row
    (r+2)·42 + p+1 − 85, lanes 128q…128q+127."""
    slab = torch.arange(tail_conv1.NSLAB * 256, dtype=torch.float32).reshape(
        1, tail_conv1.NSLAB, 256)
    nhwc = tail_conv1.nhwc_from_slab(slab)
    for ro, po in [(0, 0), (40, 20), (79, 39), (3, 38)]:
        pos = (ro + 2) * 42 + (po + 1) - tail_conv1.OFF
        for q in range(2):
            assert torch.equal(nhwc[0, ro, 2 * po + q], slab[0, pos, 128 * q:128 * q + 128])


def test_qconv_from_probe_keeps_the_probes_arrays(case):
    _, inp, q, _ = case
    assert (q.padding, q.dilation, q.stride, q.kh, q.kw) == (2, 2, 1, 3, 3)
    assert torch.equal(q.wmat, inp["wim"])  # (576, 128): row (dy·3 + dx)·64 + c
    assert torch.equal(q.scale, inp["scale"].reshape(128))
    assert torch.equal(q.b, inp["bias"].reshape(128))
    assert torch.equal(q.sx_inv, inp["sx_inv"].reshape(()))


def test_int8_rektnet_res4_conv1_carries_over():
    """A quantized ``Int8RektNet``'s ``res4.conv1`` leaves (tiny width, 16
    → 32 channels) laid out as the probe's arrays — ``wim`` the HWIO
    weights flattened to (9·16, 32), scale and bias (1, 32), sx_inv (1, 1)
    — carry over into the same convolution; on the activations its
    ``res[0..2]`` produce, ``tail_conv`` (its plain version on the CPU)
    equals ``relu(_qconv(h, res4.conv1))`` and the JAX package's int8 conv
    on the same leaves."""
    rng = np.random.default_rng(3)
    rp, rs = convert.init_rektnet_np(rng, net_size=4)
    folded = rektnet.fold_bn(convert.from_jax(rp), convert.from_jax(rs))
    crops = rng.uniform(0, 1, (2, 80, 80, 3)).astype(np.float32)
    rq = quantize.quantize_rektnet_params(folded,
                                          quantize.calibrate_rektnet(folded, crops))
    rekt = quantize.Int8RektNet(rq).eval()
    conv1, leaves = rekt.res[3].conv1, rq["res4"]["conv1"]
    n = conv1.out_channels
    carried = tail_conv1.qconv_from_probe(
        leaves["wq"].permute(2, 3, 1, 0).reshape(-1, n), leaves["scale"].reshape(1, n),
        leaves["b"].reshape(1, n), leaves["sx_inv"].reshape(1, 1))
    for k in ("wmat", "scale", "b", "sx_inv"):
        assert torch.equal(getattr(carried, k), getattr(conv1, k)), k
    with torch.inference_mode():
        h = F.relu(quantize._qconv(torch.from_numpy(crops), rekt.stem))
        for blk in rekt.res[:3]:
            h = blk(h)
        got = tail_conv(h, carried)
        want = F.relu(quantize._qconv(h, conv1))
    assert h.shape == (2, 80, 80, 16) and got.shape == (2, 80, 80, 32)
    assert torch.equal(got, want)
    jleaves = {"wq": jnp.asarray(leaves["wq"].permute(2, 3, 1, 0).numpy()),
               **{k: jnp.asarray(leaves[k].numpy()) for k in ("scale", "b", "sx_inv")}}
    with jax.disable_jit():
        jwant = jax.nn.relu(jquantize._qconv(jnp.asarray(h.float().numpy()), jleaves,
                                             1, 2, jnp.bfloat16, dilation=2))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jwant, np.float32))


# ---------------------------------------------------------------------------
# The card kernel's tile and fragment order, in numpy: a tile (crop, band of
# 4 output rows) stages its input as an int8 window of 8 rows × 84 columns
# (2 zero columns each side, rows outside the crop zero) with 16-byte chunks
# XOR-swizzled; a warpgroup takes 64 channels, its warp one output row (5
# m-tiles), A read by ldmatrix at each tap's offset, B from
# ``pack_tail_conv``'s wgmma tiles through the descriptor.
# ---------------------------------------------------------------------------

WIN_ROWS, WIN_COLS, BAND = 8, 84, 4


def _swz(pos, c, cin):
    """``csrc/tail_conv.cu:swz``."""
    return c ^ ((pos >> 1) & 3) if cin == 64 else c ^ ((pos >> 2) & 1)


def _tail_window(xq, band):
    """int8 crop (80, 80, Cin) → tile ``band``'s int8 window, the bytes as
    the kernel's shared memory holds them."""
    cin = xq.shape[-1]
    win = np.zeros((WIN_ROWS, WIN_COLS, cin), np.int8)
    for wy in range(WIN_ROWS):
        y = band * BAND - 2 + wy
        if 0 <= y < 80:
            win[wy, 2:82] = xq[y]
    flat = np.zeros(WIN_ROWS * WIN_COLS * cin, np.int8)
    pos = np.arange(WIN_ROWS * WIN_COLS)
    chunks = win.reshape(-1, cin // 16, 16)
    for c in range(cin // 16):
        dst = pos * cin + (_swz(pos, c, cin) << 4)
        flat[dst[:, None] + np.arange(16)] = chunks[:, c]
    return flat


def _emulate_tail_band(flat, tiles, cin, n):
    """The int32 sums of one band (320 positions, row-major, × n channels):
    warpgroup h takes channels 64h … 64h + 63, its warp oy output row oy,
    whose m-tile mi is positions 16·mi … + 15; per k-step, the warpgroup's
    ``wgmma.m64n64k32`` multiplies each warp's ldmatrix fragment by the 2
    wgmma tiles at (k-step, 2h) read through the descriptor."""
    arow, ahalf = _lane_rows()
    halves = cin // 32
    flat_b = tiles.reshape(tiles.shape[0], -1)  # (k-steps, N/32 KB)
    out = np.zeros((BAND * 80, n), np.int64)
    for warp in range(BAND * n // 64):
        h, oy = warp // BAND, warp % BAND
        for mi in range(5):
            base = oy * WIN_COLS + 16 * mi + arow
            acc = np.zeros((16, 64), np.int64)
            for s in range(9 * halves):
                tap, chunk = s // halves, (s % halves) * 2 + ahalf
                pos = base + (tap // 3) * 2 * WIN_COLS + (tap % 3) * 2
                a = _ldmatrix(flat, pos * cin + (_swz(pos, chunk, cin) << 4))
                acc += a @ _wgmma_b(flat_b[s, 2 * h * 1024:], 64)
            rows = 80 * oy + 16 * mi
            out[rows:rows + 16, 64 * h:64 * h + 64] = acc
    return out


@pytest.mark.parametrize("width", [(64, 128), (32, 64)])
def test_fragment_order_equals_int_conv(width):
    """Every band (first, inner, last) of one crop, contracted in the
    kernel's window, swizzle, ldmatrix and descriptor order over
    ``pack_tail_conv``'s weights, equals ``_int_conv``'s int32 sums; ±127
    on the crop's border rows and columns."""
    cin, n = width
    rng = np.random.default_rng(11)
    xq = rng.integers(-127, 128, (80, 80, cin), dtype=np.int8)
    xq[0], xq[-1], xq[:, 0], xq[:, -1] = 127, -127, -127, 127
    wq = torch.from_numpy(rng.integers(-127, 128, (n, cin, 3, 3), dtype=np.int8))
    q = quantize.QConv({"wq": wq, "scale": torch.ones(n), "b": torch.zeros(n),
                        "sx_inv": torch.tensor(1.0)}, padding=2, dilation=2)
    packed = pack_tail_conv(q).numpy()
    assert packed.shape == (9 * cin // 32, n // 32, 4, 2, 8, 16)
    want = quantize._int_conv(torch.from_numpy(xq[None]), q.wmat, n, 3, 3,
                              padding=2, dilation=2).numpy()[0]
    assert np.abs(want).max() > 2 ** 15
    for band in (0, 9, 19):
        got = _emulate_tail_band(_tail_window(xq, band), packed, cin, n)
        np.testing.assert_array_equal(got.reshape(BAND, 80, n),
                                      want[BAND * band:BAND * band + BAND])


def _quad_transpose(v):
    """``csrc/int8_mma.cuh:quad_transpose`` on (32 lanes, 4 words): stage
    b (1, then 2) trades, with lane t ^ b, the two words whose index has
    bit b unlike t's (sending them, storing the partner's at index ^ b)."""
    lane = np.arange(32)
    v = v.copy()
    for b in (1, 2):
        mine = (lane & b) != 0
        idx = [(j, j ^ b) for j in range(4) if not j & b]  # (kept if t&b, traded)
        new = v.copy()
        for lo, hi in idx:
            send = np.where(mine, v[:, lo], v[:, hi])      # the word unlike t's bit
            got = send[lane ^ b]
            new[:, lo] = np.where(mine, got, v[:, lo])
            new[:, hi] = np.where(mine, v[:, hi], got)
        v = new
    return v


def test_epilogue_quad_transpose_stores_eight_columns_in_order():
    """The epilogue's words: lane 4g + t holds columns 2t, 2t+1 of n-tiles
    j = 0..3 (the mma C fragment); after the quad transpose its four words
    are n-tile t's columns 0..7 in order, which it stores as 16 bytes at
    channel 8t."""
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    col = lambda j, c: 8 * j + c  # noqa: E731
    # a word names (row, first column): row·64 + column
    v = np.stack([g * 64 + col(j, 2 * t) for j in range(4)], 1)
    got = _quad_transpose(v)
    for lane in range(32):
        assert got[lane].tolist() == [g[lane] * 64 + 8 * t[lane] + 2 * e for e in range(4)]


def test_the_kernel_s_weights_are_packed_once_per_conv():
    """``tail_conv`` lays a ``QConv``'s weights out for the tensor cores
    once and keeps them while its weight matrix is unchanged."""
    from mit_driverless_cv_traininginfra_tpu_torch.ops import tail_conv as tc

    inp = tail_conv1.probe_inputs(1)
    q = tail_conv1.qconv_from_probe(inp["wim"], inp["scale"], inp["bias"], inp["sx_inv"])
    first = tc._packed(q)
    assert tc._packed(q) is first
    np.testing.assert_array_equal(first.numpy(), entry._pack_wgmma(q.wmat).numpy())
    q.wmat.add_(0)  # an in-place change: packed anew
    assert tc._packed(q) is not first
