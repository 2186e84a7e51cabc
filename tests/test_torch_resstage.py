"""Kernel K5's module (``ops/resstage.py``) against the JAX package's
``ops/pallas_resstage.py`` on the CPU: the stage spans, the quantized
bundle, and the plain version of K5 held to the XLA twin and to the Pallas
kernel in interpret mode, bit for bit on ``yq`` and ``ybf``.

The JAX side runs under ``jax.disable_jit()``: op by op it rounds
``acc·scale + b`` as two f32 roundings, as the port does; jitted, XLA:CPU
may contract it into one FMA (the finding of the fused entry's tests)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_entry import _lane_rows, _ldmatrix, _wgmma_b

from mit_driverless_cv_traininginfra_tpu.config.flagship import (
    flagship_spec as jflagship_spec,
)
from mit_driverless_cv_traininginfra_tpu.ops import pallas_resstage as jrs
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    ConvBlock,
    RouteBlock,
    ShortcutBlock,
)
from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, quantize, stem_opt
from mit_driverless_cv_traininginfra_tpu_torch.ops import entry
from mit_driverless_cv_traininginfra_tpu_torch.ops import resstage

S, C, NB, B, SLOPE = 8, 64, 3, 4, 0.1


def _qconv_params(rng, cin, cout, k):
    """One conv's int8 leaves in the JAX layout (HWIO), as the JAX
    package's tests/test_pallas_resstage.py makes them."""
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.2
    s_w = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, 1e-12)
    sx = 2.5
    return {"wq": np.clip(np.round(w / s_w), -127, 127).astype(np.int8),
            "scale": ((sx / 127.0) * s_w).astype(np.float32),
            "b": (rng.standard_normal(cout) * 0.1).astype(np.float32),
            "sx_inv": np.float32(127.0 / sx)}


@pytest.fixture(scope="module")
def stage():
    """The same int8 leaves in both packages, both stage bundles, the port's
    packed bundle and a (B, S, S, C) bf16 input: ``(JAX rs, port rs, pk,
    x as f32 numpy)``."""
    rng = np.random.default_rng(0)
    q = {}
    for i in range(NB):
        q[str(10 + 3 * i)] = _qconv_params(rng, C, C // 2, 1)
        q[str(10 + 3 * i + 1)] = _qconv_params(rng, C // 2, C, 3)
    q["99"] = _qconv_params(rng, C, C, 3)
    jq = jax.tree_util.tree_map(jnp.asarray, q)
    rs_j = jrs.quantize_res_stage(jq, 10, NB, 99)
    rs_t = resstage.quantize_res_stage(convert.quantized_from_jax(q), 10, NB, 99)
    x = np.asarray(jnp.asarray(rng.standard_normal((B, S, S, C)) * 0.5,
                               jnp.bfloat16), np.float32)
    return rs_j, rs_t, resstage.pack_res_stage(rs_t), x


def test_res_stage_spans_flagship():
    spans = resstage.res_stage_spans(flagship_spec(416))
    # Darknet-53 runs: 1×64, 2×128, 8×256, 8×512, 4×1024
    assert [(n, c) for _, n, c in spans] == [
        (1, 64), (2, 128), (8, 256), (8, 512), (4, 1024)]
    assert spans == jrs.res_stage_spans(jflagship_spec(416))


def test_res_stage_spans_terminates_when_first_triplet_routed():
    """The JAX package's regression: a run whose first triplet has a routed
    conv output must not spin forever or emit (start, 0, C) spans."""

    def triplet():
        return [ConvBlock(filters=32, size=1, stride=1, batch_normalize=True,
                          activation="leaky"),
                ConvBlock(filters=64, size=3, stride=1, batch_normalize=True,
                          activation="leaky"),
                ShortcutBlock(from_layer=-3)]

    spec = types.SimpleNamespace(blocks=triplet() + [RouteBlock(layers=(0,))])
    assert resstage.res_stage_spans(spec) == []
    spec2 = types.SimpleNamespace(
        blocks=triplet() + triplet() + [RouteBlock(layers=(3,))])
    assert resstage.res_stage_spans(spec2) == [(0, 1, 64)]


def test_quantize_res_stage_leaves_equal_jax(stage):
    rs_j, rs_t, _, _ = stage
    assert sorted(rs_t) == sorted(rs_j)
    # the JAX bundle's sx_out is a Python float made from an f32 leaf
    assert rs_t["sx_out"].dtype == torch.float32
    assert rs_t["sx_out"].item() == rs_j["sx_out"]
    for k in rs_j:
        if k == "sx_out":
            continue
        want = np.asarray(rs_j[k])
        got = rs_t[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_pack_res_stage_layouts(stage):
    """K5 reads row-major (N, K) matrices with K tap-major; their
    transposes are the column-major (K, N) matrices of ``torch._int_mm``."""
    _, rs_t, pk, _ = stage
    assert pk["w1_k"].shape == (NB, C // 2, C) and pk["w1_k"].is_contiguous()
    assert pk["w3_k"].shape == (NB, C, 9 * C // 2) and pk["w3_k"].is_contiguous()
    # w3_k[blk, n, tap·C/2 + c] is w3[blk, tap, c, n]
    assert pk["w3_k"][2, 7, 5 * (C // 2) + 3] == rs_t["w3"][2, 5, 3, 7]
    assert torch.equal(pk["w1_k"][1].t(), rs_t["w1"][1])
    assert pk["w3_k"][0].t().stride() == (1, 9 * C // 2)
    assert pk["sx_out"].shape == (1,) and pk["sx1"].shape == (NB,)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def test_reference_bit_equal_to_jax(stage):
    rs_j, _, pk, x = stage
    with jax.disable_jit():
        xr_j, yq_j = jrs.res_stage_reference(jnp.asarray(x, jnp.bfloat16), rs_j,
                                             NB, SLOPE)
    xr, yq = resstage.res_stage_reference(_bf16(x), pk, NB, SLOPE)
    assert yq.dtype == torch.int8 and xr.dtype == torch.bfloat16
    np.testing.assert_array_equal(yq.numpy(), np.asarray(yq_j))
    np.testing.assert_array_equal(xr.float().numpy(), np.asarray(xr_j, np.float32))


def test_plain_k5_bit_equal_to_pallas_interpret(stage):
    """The port's flat plain version against the TPU kernel itself, run in
    Pallas interpret mode (G=2) on the same flat zero-bordered input."""
    rs_j, _, pk, x = stage
    xj = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        yq_j, ybf_j = jrs.fused_res_stage(jrs.res_stage_pre(xj), jrs.stage_mask(S, 2),
                                          rs_j, S=S, G=2, n_blocks=NB,
                                          leaky_slope=SLOPE, interpret=True)
    xf = resstage.res_stage_pre(_bf16(x))
    np.testing.assert_array_equal(xf.float().numpy(),
                                  np.asarray(jrs.res_stage_pre(xj), np.float32))
    before = resstage.fused_res_stage.launches
    yq, ybf = resstage.fused_res_stage(xf, pk, S, NB, SLOPE)
    assert resstage.fused_res_stage.launches == before  # the plain version
    assert yq.shape == ybf.shape == (B * (S + 2) ** 2, C)
    np.testing.assert_array_equal(yq.numpy(), np.asarray(yq_j))
    np.testing.assert_array_equal(ybf.float().numpy(), np.asarray(ybf_j, np.float32))
    full = resstage.res_stage_post(yq, B, S)
    for edge in (full[:, 0], full[:, -1], full[:, :, 0], full[:, :, -1]):
        assert int(edge.abs().max()) == 0  # the next conv's zero padding


def test_stage_equals_the_int8_darknet_blocks():
    """On YOLOv3 at 64² (the 26² stage becomes 4²), K5's plain version on the
    int8 forward's stage input equals the int8 Darknet's own walk through
    the stage's blocks: ``ybf`` is the last shortcut's output and ``yq``
    that output quantized with the next conv's input scale."""
    spec = flagship_spec(64)
    rng = np.random.default_rng(3)
    yp, ys = convert.init_darknet_np(spec, rng)
    spec1, folded = stem_opt.slice_preyolo(
        spec, darknet.fold_bn(convert.from_jax(yp), convert.from_jax(ys), spec))
    frames = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    amax = quantize.calibrate(spec1, folded, frames)
    yolo_q = quantize.quantize_params(spec1, folded, amax)
    model = quantize.Int8Darknet(spec1, yolo_q, entry.quantize_entry(folded, amax))
    start, nb, c = next(s for s in resstage.res_stage_spans(spec1) if s[2] == 512)
    pk = resstage.pack_res_stage(
        resstage.quantize_res_stage(yolo_q, start, nb, start + 3 * nb))
    with torch.inference_mode():
        x = model.truncated_forward(frames.to(torch.bfloat16), start - 1)
        want = model.truncated_forward(frames.to(torch.bfloat16), start + 3 * nb - 1)
        s = x.shape[1]
        yq, ybf = resstage.fused_res_stage(resstage.res_stage_pre(x), pk, s, nb, SLOPE)
    assert x.shape == (2, 4, 4, c) and nb == 8
    inner = np.s_[:, 1:s + 1, 1:s + 1]
    assert torch.equal(resstage.res_stage_post(ybf, 2, s)[inner], want)
    assert torch.equal(resstage.res_stage_post(yq, 2, s)[inner],
                       quantize._q8(want, model.convs[str(start + 3 * nb)].sx_inv))
    with pytest.raises(ValueError, match="cannot stop"):
        model.truncated_forward(frames, 3)  # inside the fused entry


def test_truncated_forward_ends_the_walk_where_asked():
    """The last block of the flagship spec is a yolo head: the walk cut
    there returns the last pre-yolo map of ``forward_features``."""
    spec = flagship_spec(64)
    yp, ys = convert.init_darknet_np(spec, np.random.default_rng(4))
    model = darknet.Darknet(spec, darknet.fold_bn(convert.from_jax(yp),
                                                  convert.from_jax(ys), spec))
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        heads = model.forward_features(x)
        last = model.truncated_forward(x, len(spec.blocks) - 1)
    assert torch.equal(last, heads[-1])



# ---------------------------------------------------------------------------
# K5's card kernels in numpy: the shared-memory stages with their swizzle
# (64-byte rows, 16-byte chunk ^= (row >> 1) & 3), the lanes' ldmatrix
# addresses, each warp's rows and columns, and ``pack_res_stage``'s weights
# (the 1×1's mma.sync fragments, the 3×3's wgmma tiles), contracted in
# int32 chunk by chunk as the kernels' products do (``csrc/res_stage.cu``).
# ---------------------------------------------------------------------------

BM1, NB1, BM3, BN3 = 48, 256, 192, 128


def _a_off(r, c):
    """``csrc/res_stage.cu:a_off``: chunk c of row r in a 64-byte-row stage."""
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4)


def _frag_b(frag):
    """(32 lanes, 16 bytes) of one fragment pair → its (32 k, 16 n) B."""
    p = frag.reshape(8, 4, 2, 2, 4)  # g, t, a, r, b
    return p.transpose(3, 1, 4, 2, 0).reshape(32, 16).astype(np.int64)


def _emulate_1x1(xq, w1_tc, m0):
    """One block of the 1×1: rows m0 … m0 + 47 of the quantized carrier
    ``xq`` (M, C) staged once as [C/64][48][64] swizzled, then N in passes
    of 256 columns, warp w taking 32 of them, the weights' chunks as the
    kernel's B stages [k-step][group][pair][lane][16]. Returns (48, C/2)."""
    M, C = xq.shape
    cm = C // 2
    arow, ahalf = _lane_rows()
    sa = np.zeros((C // 64, BM1 * 64), np.int8)
    rows = np.arange(BM1)
    for kc, piece in np.ndindex(C // 64, 4):
        src = np.zeros((BM1, 16), np.int8)
        ok = m0 + rows < M
        src[ok] = xq[m0 + rows[ok], 64 * kc + 16 * piece:64 * kc + 16 * piece + 16]
        sa[kc][_a_off(rows, piece)[:, None] + np.arange(16)] = src
    out = np.zeros((BM1, cm), np.int64)
    for nb0 in range(0, cm, NB1):
        groups = min(NB1, cm - nb0) // 32
        for kc in range(C // 64):
            stage = np.zeros((2, NB1 // 32, 2, 32, 16), np.int8)
            stage[:, :groups] = w1_tc[2 * kc:2 * kc + 2, nb0 // 32:nb0 // 32 + groups]
            for warp, ks in np.ndindex(groups, 2):
                for mi in range(BM1 // 16):
                    a = _ldmatrix(sa[kc], _a_off(16 * mi + arow, 2 * ks + ahalf))
                    for q in range(2):
                        n = nb0 + 32 * warp + 16 * q
                        out[16 * mi:16 * mi + 16, n:n + 16] += a @ _frag_b(stage[ks, warp, q])
    return out


def _emulate_3x3(tq_pad, w3_tc, S, m0, n0):
    """One block of the 3×3: rows m0 … m0 + 191 × columns n0 … n0 + 127.
    A chunk kc's 16-byte piece j of row r is t at the row's padded position
    + the tap's offset, k = 64kc + 16j (zeros past 9·C/2 or past M); the B
    stage holds k-steps 2kc, 2kc + 1 as the block's 4 wgmma tiles each,
    read through the descriptor (LBO 128, SBO 256); warp w of the 3
    warpgroups takes rows 64·(w // 4) + 16·(w % 4) … + 15 × all 128 columns
    (``wgmma.m64n128k32``, A from its ldmatrix fragment). Returns (192, 128)."""
    W, cm = S + 2, tq_pad.shape[-1]
    flat = tq_pad.reshape(-1, cm)
    M, C, K = (flat.shape[0] // (W * W)) * S * S, w3_tc.shape[1] * 32, 9 * cm
    arow, ahalf = _lane_rows()
    rows = np.arange(BM3)
    m = m0 + rows
    base = ((m // (S * S)) * W + (m % (S * S)) // S) * W + (m % (S * S)) % S
    ok = m < M
    groups = min(BN3, C - n0) // 32
    out = np.zeros((BM3, BN3), np.int64)
    for kc in range(-(-K // 64)):
        sa = np.zeros(BM3 * 64, np.int8)
        for j in range(4):
            k = 64 * kc + 16 * j
            tap, c = divmod(k, cm)
            if k < K:
                src = flat[base[ok] + (tap // 3) * W + tap % 3, c:c + 16]
                sa[_a_off(rows[ok], j)[:, None] + np.arange(16)] = src
        stage = np.zeros((2, 4096), np.int8)
        for ks in range(2):
            tiles = w3_tc[2 * kc + ks, n0 // 32:n0 // 32 + groups].reshape(-1)
            stage[ks, :tiles.size] = tiles
        for warp, ks in np.ndindex(12, 2):
            r0 = 64 * (warp // 4) + 16 * (warp % 4)
            a = _ldmatrix(sa, _a_off(r0 + arow, 2 * ks + ahalf))
            out[r0:r0 + 16] += a @ _wgmma_b(stage[ks], BN3)
    return out


@pytest.mark.parametrize("c,s,b", [(64, 5, 2), (128, 5, 2), (64, 26, 1)])
def test_fragment_order_convs_equal_int_conv(c, s, b):
    """Both convolutions of a K5 block, contracted in the kernels' stage,
    swizzle, ldmatrix, fragment and descriptor order over
    ``pack_res_stage``'s weights, equal ``_int_conv``'s int32 sums at every
    interior position: S=5, B=2 (50 positions: a 1×1 block and the 3×3's
    block mostly past M), S=26 (676 positions: 4 ragged 3×3 blocks), C=64
    (a 3×3 K of 288 padded to 320, half the block's columns past N) and
    C=128; ±127 on the border rows and columns."""
    rng = np.random.default_rng(12)
    n = 1
    rs = {"w1": torch.from_numpy(rng.integers(-127, 128, (n, c, c // 2), dtype=np.int8)),
          "w3": torch.from_numpy(rng.integers(-127, 128, (n, 9, c // 2, c), dtype=np.int8)),
          **{k: torch.ones((n, 1, w)) for k, w in (("s1", c // 2), ("b1", c // 2),
                                                   ("s3", c), ("b3", c))},
          "sx1": torch.ones((1, n)), "sx3": torch.ones((1, n)), "sx_out": torch.tensor(1.0)}
    pk = resstage.pack_res_stage(rs)
    kp = -(-9 * (c // 2) // 64) * 64
    assert pk["w1_tc"].shape == (n, c // 32, c // 64, 2, 32, 16)
    assert pk["w3_tc"].shape == (n, kp // 32, c // 32, 4, 2, 8, 16)
    xq = rng.integers(-127, 128, (b, s, s, c), dtype=np.int8)
    xq[:, 0], xq[:, :, -1] = 127, -127
    want1 = quantize._int_conv(torch.from_numpy(xq), pk["w1_k"][0].t(), c // 2, 1, 1).numpy()
    flat = xq.reshape(-1, c)
    got1 = np.concatenate([_emulate_1x1(flat, pk["w1_tc"][0].numpy(), m0)
                           for m0 in range(0, flat.shape[0], BM1)])[:flat.shape[0]]
    np.testing.assert_array_equal(got1, want1.reshape(-1, c // 2))

    tq = rng.integers(-127, 128, (b, s, s, c // 2), dtype=np.int8)
    tq[:, -1], tq[:, :, 0] = -127, 127
    want3 = quantize._int_conv(torch.from_numpy(tq), pk["w3_k"][0].t(), c, 3, 3,
                               padding=1).numpy().reshape(-1, c)
    tq_pad = np.pad(tq, ((0, 0), (1, 1), (1, 1), (0, 0)))
    got3 = np.concatenate([
        np.concatenate([_emulate_3x3(tq_pad, pk["w3_tc"][0].numpy(), s, m0, n0)
                        for n0 in range(0, c, BN3)], 1)
        for m0 in range(0, b * s * s, BM3)])[:b * s * s, :c]
    assert np.abs(want3).max() > 2 ** 15
    np.testing.assert_array_equal(got3, want3)


def test_pack_res_stage_fragments_hold_the_plain_matrices():
    """``w1_tc`` / ``w3_tc`` read back by a plain index map are ``w1_k`` /
    ``w3_k`` transposed (the 3×3's K zero past 9·C/2)."""
    from test_torch_entry import _read_frag, _read_wgmma

    rng = np.random.default_rng(13)
    n, c = 2, 64
    rs = {"w1": torch.from_numpy(rng.integers(-127, 128, (n, c, c // 2), dtype=np.int8)),
          "w3": torch.from_numpy(rng.integers(-127, 128, (n, 9, c // 2, c), dtype=np.int8)),
          **{k: torch.ones((n, 1, w)) for k, w in (("s1", c // 2), ("b1", c // 2),
                                                   ("s3", c), ("b3", c))},
          "sx1": torch.ones((1, n)), "sx3": torch.ones((1, n)), "sx_out": torch.tensor(1.0)}
    pk = resstage.pack_res_stage(rs)
    for blk in range(n):
        np.testing.assert_array_equal(_read_frag(pk["w1_tc"][blk]), pk["w1_k"][blk].t().numpy())
        w3 = _read_wgmma(pk["w3_tc"][blk])
        np.testing.assert_array_equal(w3[:9 * c // 2], pk["w3_k"][blk].t().numpy())
        assert w3.shape == (320, c) and not w3[9 * c // 2:].any()


def test_1x1_epilogue_bytes_land_in_column_order():
    """The 1×1's epilogue word of n-tile j at lane 4g + t holds row g's
    columns 2t, 2t+1, then row g+8's; after the quad transpose, byte
    permutes 0x5410 / 0x7632 of words (0, 1) and (2, 3) give row g's and
    row g+8's eight columns of n-tile t in order (8-byte stores)."""
    from test_torch_tail_conv import _quad_transpose

    g, t = np.arange(32) >> 2, np.arange(32) & 3
    # a byte names its (row, column): row·32 + column, column = 8j + c
    bytes_ = lambda j, row: np.stack([row * 32 + 8 * j + 2 * t, row * 32 + 8 * j + 2 * t + 1], 1)  # noqa: E731
    v = np.stack([np.concatenate([bytes_(j, g), bytes_(j, g + 8)], 1) for j in range(4)], 1)
    got = np.stack([_quad_transpose(v[:, :, e]) for e in range(4)], 2)  # (lane, word, byte)
    perm = {0x5410: (0, 1, 4, 5), 0x7632: (2, 3, 6, 7)}
    for lane in range(32):
        for sel, row in ((0x5410, g[lane]), (0x7632, g[lane] + 8)):
            out = []
            for w0, w1 in ((0, 1), (2, 3)):
                pair = np.concatenate([got[lane, w0], got[lane, w1]])
                out += [pair[i] for i in perm[sel]]
            assert out == [row * 32 + 8 * t[lane] + e for e in range(8)]
