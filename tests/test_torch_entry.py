"""The port's fused int8 entry (``ops/entry.py``) against the JAX package's
``ops/pallas_entry.py`` on the CPU: applicability, the conv1 rewrite and
the quantized bundle (bit-equal), and the plain version of kernel K4,
held to both the XLA twin and the Pallas kernel in interpret mode.

Tolerance of the int8 outputs: ±1 int8 step with ≥ 97% of values equal,
the bound the JAX package holds its own kernel to against its XLA twin
(XLA:CPU may contract ``acc·scale + b`` into one FMA, which moves a value
across a requant rounding boundary now and then)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import entry_specs, tiny_port_spec, tiny_spec, to_numpy
from mit_driverless_cv_traininginfra_tpu.config.flagship import (
    flagship_spec as jflagship_spec,
)
from mit_driverless_cv_traininginfra_tpu.ops import pallas_entry as jentry
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec
from mit_driverless_cv_traininginfra_tpu_torch.models import quantize
from mit_driverless_cv_traininginfra_tpu_torch.ops import entry

AMAX = {"0": 1.0, "1": 3.0, "2": 2.0, "3": 2.5, "5": 4.0}
SLOPE = 0.1


def _rand_folded(rng):
    """Folded blocks 0-3 in the JAX layout (HWIO), as the JAX package's
    tests/test_pallas_entry.py makes them."""
    def conv(shape):
        return {"w": rng.standard_normal(shape).astype(np.float32) * 0.1,
                "b": rng.standard_normal(shape[-1]).astype(np.float32) * 0.1}

    return {"0": conv((3, 3, 3, 32)), "1": conv((3, 3, 32, 64)),
            "2": conv((1, 1, 64, 32)), "3": conv((3, 3, 32, 64))}


@pytest.fixture(scope="module")
def bundles():
    """The same folded weights quantized by both packages, plus frames:
    ``(folded, JAX bundle, port bundle, port bundle packed, frames)``."""
    rng = np.random.default_rng(2)
    folded = _rand_folded(rng)
    jep = jentry.quantize_entry(folded, AMAX)
    tep = entry.quantize_entry(convert.from_jax(folded), AMAX)
    frames = rng.random((2, 64, 64, 3)).astype(np.float32)
    return folded, jep, tep, entry.pack_entry(tep), frames


def _within_one_step(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert float((got == want).mean()) >= 0.97


def test_applicability(tmp_path):
    assert entry.entry_block_applicable(flagship_spec(416))
    assert entry.entry_block_applicable(entry_specs(tmp_path)[1])
    assert not entry.entry_block_applicable(tiny_port_spec())  # maxpool stem
    # block 5 at stride 1 is not the conv the fused path hardcodes
    bad = tmp_path / "bad"
    bad.mkdir()
    spec = entry_specs(bad)[1]
    blocks = list(spec.blocks)
    blocks[5] = dataclasses.replace(blocks[5], stride=1)
    assert not entry.entry_block_applicable(
        dataclasses.replace(spec, blocks=tuple(blocks)))
    for s, js in ((flagship_spec(416), jflagship_spec(416)),
                  (tiny_port_spec(), tiny_spec())):
        assert (entry.entry_block_applicable(s)
                == jentry.entry_block_applicable(js))


def test_build_conv1_4x4_matches_jax(bundles):
    folded = bundles[0]
    want = jentry.build_conv1_4x4(folded)
    got = entry.build_conv1_4x4(convert.from_jax(folded))
    np.testing.assert_array_equal(got["w"].permute(2, 3, 1, 0).numpy(),
                                  want["w"])
    np.testing.assert_array_equal(got["b"].numpy(), want["b"])


def test_quantize_entry_leaves_bit_equal_to_jax(bundles):
    _, jep, tep, _, _ = bundles
    want = convert.quantized_from_jax(to_numpy(jep))
    assert sorted(tep) == sorted(want)
    for k in want:
        assert tep[k].dtype == want[k].dtype, k
        assert tep[k].shape == want[k].shape, k
        assert torch.equal(tep[k], want[k]), k


def test_conv1_4x4_q8_matches_jax(bundles):
    _, jep, _, tpk, frames = bundles
    fb = jnp.asarray(frames, jnp.bfloat16)
    want = jentry.conv1_4x4_q8(fb, jep, SLOPE)
    got = entry.conv1_4x4_q8(torch.from_numpy(frames).to(torch.bfloat16),
                             tpk, SLOPE)
    assert got.dtype == torch.int8 and got.shape == (2, 32, 32, 128)
    _within_one_step(got.numpy(), want)


@pytest.mark.parametrize("frames_dtype", ["f32", "bf16"])
def test_entry_rest_matches_xla_twin(bundles, frames_dtype):
    _, jep, _, tpk, frames = bundles
    jf, tf = jnp.asarray(frames), torch.from_numpy(frames)
    if frames_dtype == "bf16":
        jf, tf = jf.astype(jnp.bfloat16), tf.to(torch.bfloat16)
    want = jentry.entry_reference_int8(jep, jf, SLOPE)
    got = entry.entry_forward_int8(tpk, tf, SLOPE)
    assert got.dtype == torch.int8 and got.shape == (2, 32, 32, 64)
    _within_one_step(got.numpy(), want)


def test_entry_rest_matches_pallas_kernel_interpret(bundles):
    """The plain version against the TPU kernel itself, run in Pallas
    interpret mode on the CPU."""
    _, jep, _, tpk, frames = bundles
    want = jentry.entry_forward_int8(jep, jnp.asarray(frames), SLOPE,
                                     interpret=True)
    got = entry.entry_forward_int8(tpk, torch.from_numpy(frames), SLOPE)
    _within_one_step(got.numpy(), want)


def test_entry_rest_on_jax_hq_matches_interpret_kernel(bundles):
    """Both fed the very same int8 hq: only the conv2p/res1 chain differs."""
    _, jep, _, tpk, frames = bundles
    hq = jentry.conv1_4x4_q8(jnp.asarray(frames), jep, SLOPE)
    want = jentry._fused_entry_interpret(hq, jep, SLOPE)
    got = entry._entry_rest(torch.from_numpy(np.array(hq)), tpk, SLOPE)
    _within_one_step(got.numpy(), want)


def test_cpu_tensor_takes_the_plain_version(bundles):
    tpk = bundles[3]
    hq = torch.from_numpy(np.random.default_rng(3).integers(
        -127, 128, (1, 16, 32, 128), dtype=np.int8))
    before = entry.fused_entry_block.launches
    got = entry.fused_entry_block(hq, tpk, SLOPE)
    assert torch.equal(got, entry._entry_rest(hq, tpk, SLOPE))
    assert entry.fused_entry_block.launches == before  # no kernel launched


def test_zero_padding_at_frame_edges(bundles):
    """Extreme hq values on the border rows and columns: the conv2p pad is
    top/left only and the 3×3 reads zeros outside the frame. The plain
    version equals a float64 evaluation of the same chain, made from the
    unpacked weights."""
    _, _, tep, tpk, _ = bundles
    rng = np.random.default_rng(4)
    hq = rng.integers(0, 20, (1, 16, 16, 128), dtype=np.int8)
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        hq[edge] = rng.choice([-127, 127], hq[edge].shape).astype(np.int8)
    hq_t = torch.from_numpy(hq)
    got = entry._entry_rest(hq_t, tpk, SLOPE)

    def conv64(x, w, pads):
        x = torch.nn.functional.pad(x.double().permute(0, 3, 1, 2), pads)
        return torch.nn.functional.conv2d(x, w.double()).permute(0, 2, 3, 1)

    w2 = tep["w2"].reshape(2, 2, 128, 64).permute(3, 2, 0, 1)
    acc = conv64(hq_t, w2, (1, 0, 1, 0)).to(torch.int32)
    out2 = entry._deq_leaky(acc, tep["w2_scale"][0], tep["w2_b"][0], SLOPE)
    w1 = tep["w1x1"].t()[:, :, None, None]
    t = entry._deq_leaky(conv64(entry._q8(out2, tep["sx"][0, 0]), w1,
                                (0, 0, 0, 0)).to(torch.int32),
                         tep["w1x1_scale"][0], tep["w1x1_b"][0], SLOPE)
    w3 = tep["w3im"].reshape(3, 3, 32, 64).permute(3, 2, 0, 1)
    b3 = entry._deq_leaky(conv64(entry._q8(t, tep["sx"][0, 1]), w3,
                                 (1, 1, 1, 1)).to(torch.int32),
                          tep["w3_scale"][0], tep["w3_b"][0], SLOPE)
    assert torch.equal(got, entry._q8(b3 + out2, tep["sx"][0, 2]))


def _read_frag(packed):
    """Plain index map of K4's mma.sync B fragments (``m16n8k32``, one lane
    at a time): packed (K/32, N/32, 2, 32, 16) → the (K, N) matrix. Lane
    l = 4g + t holds, in pair q, register r of n-tile 2q + a in bytes
    8a + 4r + (0..3): rows 32s + 16r + 4t + (0..3) of column
    8(4h + 2q + a) + g."""
    S, NH = packed.shape[:2]
    p = packed.numpy()
    w = np.zeros((32 * S, 32 * NH), np.int8)
    for s in range(S):
        for h in range(NH):
            for q in range(2):
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for a in range(2):
                        for r in range(2):
                            for b in range(4):
                                w[32 * s + 16 * r + 4 * t + b,
                                  8 * (4 * h + 2 * q + a) + g] = \
                                    p[s, h, q, lane, 8 * a + 4 * r + b]
    return w


LBO, SBO = 128, 256  # the kernel's wgmma descriptor: K- and N-adjacent core matrices


def _wgmma_b(tile, n: int = 32):
    """The 32×n B that K4's shared-memory descriptor (K-major, no swizzle)
    names at ``tile``'s first byte: B[k, j] is the byte at
    (j // 8)·SBO + (k // 16)·LBO + (j % 8)·16 + k % 16. n = 32 reads one
    1 KB tile (m64n32k32), n = 64 the two halves of a k-step (m64n64k32)."""
    flat = tile.reshape(-1)
    b = np.zeros((32, n), np.int32)
    for k in range(32):
        for j in range(n):
            b[k, j] = flat[(j // 8) * SBO + (k // 16) * LBO + (j % 8) * 16 + k % 16]
    return b


def _read_wgmma(packed):
    """packed (K/32, N/32, 4, 2, 8, 16) → the (K, N) matrix, tile by tile."""
    S, NH = packed.shape[:2]
    p = packed.numpy()
    w = np.zeros((32 * S, 32 * NH), np.int8)
    for s, h in np.ndindex(S, NH):
        w[32 * s:32 * s + 32, 32 * h:32 * h + 32] = _wgmma_b(p[s, h])
    return w


def test_pack_entry_layouts(bundles):
    """Each packed weight holds the bundle's integers in its consumer's
    layout: column-major matrices for ``torch._int_mm``, tensor-core B
    tiles and fragments for K4, read back by a plain index map."""
    _, _, tep, tpk, _ = bundles
    assert not {"c1_wq", "w2", "w1x1", "w3im"} & set(tpk)
    assert not [k for k in tpk if k.endswith("_k4")]
    w2 = tep["w2"].reshape(512, 64)
    for key, want in (("w2_mat", w2), ("w1x1_mat", tep["w1x1"]),
                      ("w3_mat", tep["w3im"])):
        assert torch.equal(tpk[key], want) and tpk[key].stride() == (1, want.shape[0])
    assert torch.equal(tpk["c1_wmat"], quantize._weight_matrix(tep["c1_wq"]))
    for key, mat, shape, read in (
            ("w2_tc", "w2_mat", (16, 2, 4, 2, 8, 16), _read_wgmma),
            ("w1x1_tc", "w1x1_mat", (2, 1, 2, 32, 16), _read_frag),
            ("w3_tc", "w3_mat", (9, 2, 4, 2, 8, 16), _read_wgmma)):
        got = tpk[key]
        assert got.is_contiguous() and got.shape == shape
        np.testing.assert_array_equal(read(got), tpk[mat].numpy())
    for key in ("w2_scale", "w1x1_b", "sx", "c1_sx_inv", "hq_sx_inv"):
        assert tpk[key] is tep[key]


# ---------------------------------------------------------------------------
# K4's tile and fragment order, in numpy: the shared-memory layouts with
# their swizzles, the lanes' ldmatrix addresses, each warpgroup's and warp's
# rows, and the packed B (wgmma tiles through the descriptor, mma.sync
# fragments by lane), contracted in int32 as the kernel's products do.
# ---------------------------------------------------------------------------

HQ, MID, TILE = 19, 18, 16
RING = MID * MID


def _lane_rows():
    """ldmatrix.x4: lane l points at row (l & 7) + ((l >> 3) & 1)·8, 16-byte
    half l >> 4 of a 16×32 A tile."""
    lane = np.arange(32)
    return (lane & 7) + ((lane >> 3) & 1) * 8, lane >> 4


def _ldmatrix(smem, addr):
    """The 16×32 int8 A tile four 8×8 b16 matrices give, matrix i from the
    rows at lanes 8i..8i+7: (rows 0-7, 8-15) × (bytes 0-15, 16-31)."""
    rows = smem[addr[:, None] + np.arange(16)]  # (32 lanes, 16 bytes)
    a = np.zeros((16, 32), np.int32)
    a[0:8, 0:16], a[8:16, 0:16] = rows[0:8], rows[8:16]
    a[0:8, 16:32], a[8:16, 16:32] = rows[16:24], rows[24:32]
    return a


def _b_pair(packed, s, q):
    """(32 k, 16 n) mma.sync B of k-step s, n-tiles 2q and 2q + 1."""
    p = packed[s, 0, q].numpy().reshape(8, 4, 2, 2, 4)  # g, t, a, r, b
    return p.transpose(3, 1, 4, 2, 0).reshape(32, 16).astype(np.int32)


def _conv2p_jobs():
    """K4's conv2p jobs: (m64 tile, first column, columns) — job j of a
    warpgroup's share is m64 tile j // 2 against n-half j % 2."""
    for job in range(12):
        yield job // 2, 32 * (job % 2), 32


def _emulate_conv2p(hq, packed):
    """Every tile's ring sums (B, H/16, W/16, 324, 64) of conv2p, job by
    job (a warpgroup takes every fourth); warp wl of the group loads the 16
    rows of m-tile 4·m64 + wl."""
    B, H, W, _ = hq.shape
    arow, ahalf = _lane_rows()
    p = packed.numpy()
    b64 = {s: _wgmma_b(p[s], 64) for s in range(16)}  # both halves of k-step s
    out = np.zeros((B, H // TILE, W // TILE, RING, 64), np.int64)
    pad = np.zeros((B, H + 3, W + 3, 128), np.int8)
    pad[:, 2:H + 2, 2:W + 2] = hq
    for b, ty, tx in np.ndindex(B, H // TILE, W // TILE):
        win = pad[b, ty * TILE:ty * TILE + HQ, tx * TILE:tx * TILE + HQ]
        win = win.reshape(HQ * HQ, 8, 16)
        pos = np.arange(HQ * HQ)
        smem = np.zeros(HQ * HQ * 128, np.int8)  # chunk ^= pos & 7
        for c in range(8):
            smem[(pos * 128 + ((c ^ (pos & 7)) << 4))[:, None] + np.arange(16)] = win[:, c]
        for m64, n0, n in _conv2p_jobs():
            for wl in range(4):
                mt = m64 * 4 + wl
                pa = np.minimum(mt * 16 + arow, RING - 1)
                base = (pa // MID) * HQ + pa % MID
                acc = np.zeros((16, n), np.int64)
                for s in range(16):
                    tap = s >> 2
                    q = base + (tap >> 1) * HQ + (tap & 1)
                    chunk = (s & 3) * 2 + ahalf
                    bt = b64[s][:, n0:n0 + n]
                    acc += _ldmatrix(smem, q * 128 + ((chunk ^ (q & 7)) << 4)) @ bt
                rows = np.arange(mt * 16, mt * 16 + 16)
                keep = rows < RING
                out[b, ty, tx, rows[keep], n0:n0 + n] = acc[keep]
    return out


def _emulate_1x1(q2, packed):
    """(324, 64) int8 ring → (324, 32) sums, q8(out2) stored as the conv2p
    epilogue stores it (chunk ^= (p >> 1) & 3); a job is one m-tile against
    16 channels."""
    arow, ahalf = _lane_rows()
    smem = np.zeros(RING * 64, np.int8)
    p = np.arange(RING)
    for n in range(64):
        smem[p * 64 + (((n >> 4) ^ ((p >> 1) & 3)) << 4) + (n & 15)] = q2[:, n]
    out = np.zeros((RING, 32), np.int64)
    for job in range(42):
        mt, hb = divmod(job, 2)
        pa = np.minimum(mt * 16 + arow, RING - 1)
        acc = np.zeros((16, 16), np.int64)
        for s in range(2):
            chunk = s * 2 + ahalf
            a = _ldmatrix(smem, pa * 64 + ((chunk ^ ((pa >> 1) & 3)) << 4))
            acc += a @ _b_pair(packed, s, hb)
        rows = slice(mt * 16, min(mt * 16 + 16, RING))
        out[rows, 16 * hb:16 * hb + 16] = acc[:rows.stop - rows.start]
    return out


def _emulate_3x3(tq, packed):
    """(324, 32) int8 ring → (16, 16, 64) sums, q8(t) stored as the 1×1
    epilogue stores it (chunk ^= (p >> 2) & 1); job j is output rows
    4·(j // 2).. against n-half j % 2, its warp wl one row."""
    arow, ahalf = _lane_rows()
    p = packed.numpy()
    b64 = {s: _wgmma_b(p[s], 64) for s in range(9)}
    smem = np.zeros(RING * 32, np.int8)
    pos = np.arange(RING)
    for n in range(32):
        smem[pos * 32 + (((n >> 4) ^ ((pos >> 2) & 1)) << 4) + (n & 15)] = tq[:, n]
    out = np.zeros((TILE, TILE, 64), np.int64)
    for job, wl in np.ndindex(8, 4):
        iy, n0 = (job // 2) * 4 + wl, 32 * (job % 2)
        acc = np.zeros((16, 32), np.int64)
        for s in range(9):
            q = (iy + s // 3) * MID + arow + s % 3
            acc += _ldmatrix(smem, q * 32 + ((ahalf ^ ((q >> 2) & 1)) << 4)) @ b64[s][:, n0:n0 + 32]
        out[iy, :, n0:n0 + 32] = acc
    return out


def test_fragment_order_conv2p_equals_int_conv(bundles):
    """conv2p in K4's order over the packed weights equals ``_int_conv``'s
    sums at every ring position inside the frame, ±127 on the borders."""
    tpk = bundles[3]
    rng = np.random.default_rng(8)
    hq = rng.integers(-127, 128, (2, 32, 48, 128), dtype=np.int8)
    hq[:, 0], hq[:, :, -1] = 127, -127
    want = quantize._int_conv(torch.from_numpy(hq), tpk["w2_mat"], 64, 2, 2,
                              padding=((1, 0), (1, 0))).numpy()
    got = _emulate_conv2p(hq, tpk["w2_tc"])
    assert np.abs(want).max() > 2 ** 15  # sums well past int16
    for b, ty, tx in np.ndindex(got.shape[:3]):
        y = ty * TILE - 1 + np.arange(RING) // MID
        x = tx * TILE - 1 + np.arange(RING) % MID
        inside = (y >= 0) & (y < 32) & (x >= 0) & (x < 48)
        np.testing.assert_array_equal(got[b, ty, tx][inside],
                                      want[b, y[inside], x[inside]])


@pytest.mark.parametrize("conv", ["1x1", "3x3"])
def test_fragment_order_ring_convs_equal_int_conv(bundles, conv):
    """The 1×1 and the 3×3 in K4's order over the packed weights equal
    ``_int_conv``'s sums on one 18×18 ring of int8 values."""
    tpk = bundles[3]
    rng = np.random.default_rng(9)
    c_in = 64 if conv == "1x1" else 32
    ring = rng.integers(-127, 128, (MID, MID, c_in), dtype=np.int8)
    ring[0], ring[:, -1] = -127, 127
    x = torch.from_numpy(ring[None])
    if conv == "1x1":
        want = quantize._int_conv(x, tpk["w1x1_mat"], 32, 1, 1).numpy()[0]
        got = _emulate_1x1(ring.reshape(RING, 64), tpk["w1x1_tc"]).reshape(MID, MID, 32)
    else:
        want = quantize._int_conv(x, tpk["w3_mat"], 64, 3, 3).numpy()[0]
        got = _emulate_3x3(ring.reshape(RING, 32), tpk["w3_tc"])
    np.testing.assert_array_equal(got, want)
