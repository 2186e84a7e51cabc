"""``int8_contract``'s card kernel (``csrc/int8_contract.cu``) modelled in
numpy: the staging of each operand into its K-contiguous, swizzled shared
tile (cp.async rows of 16 or 4 bytes with zero fill, 4×4 byte transposes
by ``__byte_perm``, byte gathers), the ``ldmatrix`` / ``mma.m16n8k32``
fragment order, the K chunks and their zero padding, and the epilogue
through shared memory, block by block and tile by tile as the kernel walks
them — equal to the plain contraction bit for bit. Also: which staging mode
each probe's operands take, and the plain version against the JAX probes'
XLA contraction. No card needed."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops.int8_contract import (
    GATHER,
    ROW4,
    ROW16,
    TRANS4,
    int8_contract,
    int8_contract_plain,
    staging_mode,
    staging_modes,
)

KBM, KEP, KEPH = 128, 40, 20  # csrc/int8_contract.cu kBM, kEP, kEPh


def swz(lin):
    return lin ^ (((lin >> 7) & 7) << 4)


def byte_perm(x: int, y: int, s: int) -> int:
    b = [(x >> 8 * i) & 0xFF for i in range(4)] + [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(s >> 4 * i) & 7] << 8 * i for i in range(4))


def transpose4x4(w):
    a, b = byte_perm(w[0], w[1], 0x5140), byte_perm(w[0], w[1], 0x7362)
    c, d = byte_perm(w[2], w[3], 0x5140), byte_perm(w[2], w[3], 0x7362)
    return [byte_perm(a, c, 0x5410), byte_perm(a, c, 0x7632),
            byte_perm(b, d, 0x5410), byte_perm(b, d, 0x7632)]


class Operand:
    """A strided int8 view into ``mem`` (uint8 storage): element (row, k)
    at ``base + row·rs + k·ks``."""

    def __init__(self, mem, base, rs, ks, rows):
        self.mem, self.base, self.rs, self.ks, self.rows = mem, base, rs, ks, rows
        self.mode = staging_mode(base, rs, ks)

    def byte(self, row, k, K):
        if row >= self.rows or k >= K:
            return 0
        return int(self.mem[self.base + row * self.rs + k * self.ks])

    def word(self, off):
        return int.from_bytes(bytes(self.mem[off:off + 4]), "little")


def put_word(s, off, w):
    s[off:off + 4] = np.frombuffer(int(w).to_bytes(4, "little"), np.uint8)


def stage(o: Operand, K, r0, nr, k0, kc, s):
    """The kernel's ``stage<KC, NR>``: rows r0.. of o, bytes k0..k0+kc−1,
    into the swizzled [nr][kc] tile s, as each mode writes it."""
    if o.mode in (ROW16, ROW4):
        w = 16 if o.mode == ROW16 else 4
        for u in range(nr * kc // w):
            r, k = u // (kc // w), k0 + (u % (kc // w)) * w
            row = r0 + r
            n = max(0, min(w, K - k)) if row < o.rows else 0
            piece = np.zeros(w, np.uint8)  # cp.async: src_bytes read, the rest zero
            src = o.base + row * o.rs + k
            piece[:n] = o.mem[src:src + n]
            d = swz(r * kc + k - k0)
            s[d:d + w] = piece
    elif o.mode == TRANS4:
        quads = nr // 4
        for u in range(quads * kc // 4):
            q, k = u % quads, k0 + 4 * (u // quads)
            row = r0 + 4 * q
            w = []
            for i in range(4):
                if k + i >= K or row >= o.rows:
                    w.append(0)
                elif row + 3 < o.rows:
                    w.append(o.word(o.base + row + (k + i) * o.ks))
                else:
                    w.append(sum(o.byte(row + j, k + i, K) << 8 * j for j in range(4)))
            for j, wj in enumerate(transpose4x4(w)):
                put_word(s, swz((4 * q + j) * kc + k - k0), wj)
    else:
        for u in range(nr * kc // 4):
            r, k = u % nr, k0 + 4 * (u // nr)
            put_word(s, swz(r * kc + k - k0),
                     sum(o.byte(r0 + r, k + i, K) << 8 * i for i in range(4)))


def ldmatrix_x4(s, addr):
    """addr[l]: the row lane l points at (matrix l // 8, row l % 8); lane
    l receives, of each matrix i, bytes 4·(l % 4).. of row l // 4."""
    regs = np.zeros((32, 4), np.int64)
    for lane in range(32):
        for i in range(4):
            a = addr[8 * i + lane // 4] + 4 * (lane % 4)
            regs[lane, i] = int.from_bytes(bytes(s[a:a + 4]), "little")
    return regs


def _bytes(word):
    return np.frombuffer(int(word).to_bytes(4, "little"), np.int8).astype(np.int64)


def mma_s8(acc, af, b0, b1):
    """D (16×8) += A (16×32) · B (32×8) from the m16n8k32 fragments: lane
    (g, t) = (l // 4, l % 4) holds a0 (g, 4t..), a1 (g + 8, 4t..), a2 (g,
    16 + 4t..), a3 (g + 8, 16 + 4t..); b0 (k 4t.., n g), b1 (k 16 + 4t..);
    c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8, ...)."""
    A, B = np.zeros((16, 32), np.int64), np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        A[g, 4 * t:4 * t + 4] = _bytes(af[lane, 0])
        A[g + 8, 4 * t:4 * t + 4] = _bytes(af[lane, 1])
        A[g, 16 + 4 * t:20 + 4 * t] = _bytes(af[lane, 2])
        A[g + 8, 16 + 4 * t:20 + 4 * t] = _bytes(af[lane, 3])
        B[4 * t:4 * t + 4, g] = _bytes(b0[lane])
        B[16 + 4 * t:20 + 4 * t, g] = _bytes(b1[lane])
    D = A @ B
    for lane in range(32):
        g, t = lane // 4, lane % 4
        acc[lane] += [D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]]


def bf16_bits(v):
    t = torch.tensor([v], dtype=torch.float32).to(torch.bfloat16)
    return int(t.view(torch.int16)[0]) & 0xFFFF


def epilogue(acc, m0, n0, M, N, scale, out):
    """A warp's 16 rows × NT n-tiles, 32 columns at a time, through its
    shared buffer: written from the C fragments, read back as rows."""
    NT = acc.shape[0]
    for q in range(NT // 4):
        e = np.zeros(16 * KEP, np.int64)
        for jj in range(4):
            j = 4 * q + jj
            for lane in range(32):
                g, t = lane // 4, lane % 4
                if scale is None:
                    for h in range(2):
                        e[(g + 8 * h) * KEP + 8 * jj + 2 * t] = acc[j, lane, 2 * h]
                        e[(g + 8 * h) * KEP + 8 * jj + 2 * t + 1] = acc[j, lane, 2 * h + 1]
                else:  # the warp's columns' scales, zero past N
                    s0, s1 = scale[8 * j + 2 * t], scale[8 * j + 2 * t + 1]
                    for h in range(2):
                        lo = bf16_bits(np.float32(acc[j, lane, 2 * h]) * np.float32(s0))
                        hi = bf16_bits(np.float32(acc[j, lane, 2 * h + 1]) * np.float32(s1))
                        e[(g + 8 * h) * KEPH + 4 * jj + t] = lo | (hi << 16)
        lanes, per, pitch = (8, 4, KEP) if scale is None else (4, 8, KEPH)
        for it in range(16 * lanes // 32):
            for lane in range(32):
                row, c = it * (32 // lanes) + lane // lanes, lane % lanes
                m, n = m0 + row, n0 + 32 * q + per * c
                words = e[row * pitch + 4 * c:row * pitch + 4 * c + 4]
                if scale is None:
                    vals = list(words)
                else:
                    vals = [(int(w) >> 16 * h) & 0xFFFF for w in words for h in range(2)]
                for i in range(per):
                    if m < M and n + i < N:
                        out[m, n + i] = vals[i]


def tile_shape(M, N, n_sm):
    """The kernel's by_tile: (WN, NT) — 8 warps as 8/WN row groups of 16
    by WN column groups of NT n-tiles — the tallest that gives each of
    n_sm SMs a block."""
    def blocks(bm, bn):
        return -(-M // bm) * -(-N // bn)
    if N > 64:
        for wn, nt in ((1, 16), (2, 8)):
            if blocks(128 // wn, 128) >= n_sm:
                return wn, nt
        return 4, 4
    return (1, 8) if blocks(128, 64) >= n_sm else (2, 4)


def emulate(A: Operand, B: Operand, M, N, K, scale=None, grid_x=1, n_sm=132):
    """The kernel, block by block: B's column tile staged once, then the
    (tile, chunk) items with a stride of the grid, two A buffers."""
    KS = 1 if K <= 32 else (2 if K <= 64 else 4)
    WN, NT = tile_shape(M, N, n_sm)
    KC, BM, BN = 32 * KS, 16 * (8 // WN), 8 * NT * WN
    nchunks = -(-K // KC)
    tiles = -(-M // BM)
    out = np.zeros((M, N), np.int64)
    for by in range(-(-N // BN)):
        n0 = by * BN
        sS = None
        if scale is not None:
            sS = np.array([scale[n0 + j] if n0 + j < N else 0.0 for j in range(BN)], np.float32)
        for bx in range(min(grid_x, tiles)):
            sB = [np.full(BN * KC, 0xAA, np.uint8) for _ in range(nchunks)]
            for c in range(nchunks):
                stage(B, K, n0, BN, c * KC, KC, sB[c])
            sA = [np.full(BM * KC, 0x55, np.uint8) for _ in range(2)]
            my_tiles = (tiles - 1 - bx) // grid_x + 1
            acc = np.zeros((8, NT, 32, 4), np.int64)  # warp, n-tile, lane, c
            for i in range(my_tiles * nchunks):
                tile, c = bx + (i // nchunks) * grid_x, i % nchunks
                stage(A, K, tile * BM, BM, c * KC, KC, sA[i & 1])
                if c == 0:
                    acc[:] = 0
                for warp in range(8):
                    wm, wn = warp // WN, warp % WN
                    for s in range(KS):
                        a_addr = [swz((16 * wm + (ln & 7) + ((ln >> 3) & 1) * 8) * KC
                                      + 32 * s + 16 * (ln >> 4)) for ln in range(32)]
                        af = ldmatrix_x4(sA[i & 1], a_addr)
                        for p in range(NT // 2):
                            b_addr = [swz((8 * NT * wn + 16 * p + (ln & 7) + ((ln >> 4) & 1) * 8)
                                          * KC + 32 * s + 16 * ((ln >> 3) & 1)) for ln in range(32)]
                            bf = ldmatrix_x4(sB[c], b_addr)
                            mma_s8(acc[warp, 2 * p], af, bf[:, 0], bf[:, 1])
                            mma_s8(acc[warp, 2 * p + 1], af, bf[:, 2], bf[:, 3])
                if c == nchunks - 1:
                    for warp in range(8):
                        wm, wn = warp // WN, warp % WN
                        epilogue(acc[warp], tile * BM + 16 * wm, n0 + 8 * NT * wn, M, N,
                                 None if sS is None else sS[8 * NT * wn:], out)
    return out


def _memory(rng, n):
    return rng.integers(0, 256, n).astype(np.uint8)


# (K, A's layout, B's layout, A's and B's base offsets, epilogue, grid_x,
# SMs, the modes the views take): layout "rows" is m- or n-major with unit
# k stride, "cols" unit row stride (A column-major, B N-major); 1 SM picks
# the 128-row tile, 3 the 64-row one (N = 80), 132 the shortest
CASES = {
    "P16_K108_rowA_NmajorB": (108, "rows", "cols", (0, 0), False, 1, 1, (ROW4, TRANS4)),
    "K16_colA_KmajorB_N40": (16, "cols", "rows", (0, 0), False, 2, 1, (TRANS4, ROW16)),
    "K48_rowA16_bf16": (48, "rows", "cols", (0, 0), True, 1, 3, (ROW16, TRANS4)),
    "K108_unaligned_gather": (108, "rows", "cols", (1, 3), False, 1, 132, (GATHER, GATHER)),
    "K200_two_chunks_colA": (200, "cols", "rows", (4, 8), False, 1, 3, (TRANS4, ROW4)),
    "K4_edge_N40": (4, "rows", "cols", (0, 0), True, 1, 132, (ROW4, TRANS4)),
    "K64_bf16_short_tiles": (64, "cols", "cols", (0, 0), True, 3, 132, (TRANS4, TRANS4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_staging_and_fragment_order_equal_the_plain_contraction(case):
    """The numpy model of the kernel — each operand's staging mode, the
    swizzle, ldmatrix and mma fragments, K zero-padded to its chunk (108 →
    128, 16 → 32, 200 → 256), the shared-memory epilogue — gives the plain
    contraction bit for bit, M and N not tile multiples, with each tile
shape (128, 64 or 32 rows by 128 or 64 columns)."""
    K, la, lb, (off_a, off_b), bf16, grid_x, n_sm, modes = CASES[case]
    rng = np.random.default_rng(K)
    M, N = 200, 40 if case.endswith("N40") else 80  # 40: 64-column tiles
    mem_a = _memory(rng, off_a + M * K + 16)
    mem_b = _memory(rng, off_b + N * K + 16)
    # rows: (row, k) at row·K + k; cols: at row + k·rows
    A = Operand(mem_a, off_a, K if la == "rows" else 1, 1 if la == "rows" else M, M)
    B = Operand(mem_b, off_b, K if lb == "rows" else 1, 1 if lb == "rows" else N, N)
    a = torch.from_numpy(mem_a.view(np.int8)).as_strided((M, K), (A.rs, A.ks), off_a)
    b = torch.from_numpy(mem_b.view(np.int8)).as_strided((K, N), (B.ks, B.rs), off_b)
    scale = rng.uniform(1e-4, 1e-2, N).astype(np.float32) if bf16 else None
    got = emulate(A, B, M, N, K, scale, grid_x, n_sm)
    if bf16:
        want = int8_contract_plain(a, b, torch.from_numpy(scale)).view(torch.int16).numpy()
        assert np.array_equal(got.astype(np.uint16), want.view(np.uint16))
    else:
        assert np.array_equal(got, int8_contract_plain(a, b).numpy())
    assert (A.mode, B.mode) == modes


def test_byte_transpose_moves_each_byte_once():
    words = [0x03020100, 0x13121110, 0x23222120, 0x33323130]  # byte j of w[i] = 0x(i)(j)
    assert transpose4x4(words) == [0x30201000, 0x31211101, 0x32221202, 0x33231303]


@pytest.mark.parametrize("kc", [32, 64, 128])
def test_swizzle_makes_ldmatrix_reads_conflict_free(kc):
    """Eight rows at one 16-byte column chunk land in eight distinct
    16-byte bank groups, for every chunk of every row band."""
    for r0 in range(0, 64, 8):
        for c in range(kc // 16):
            groups = {(swz((r0 + r) * kc + 16 * c) % 128) // 16 for r in range(8)}
            assert len(groups) == 8


def test_probe_operands_take_the_widest_copy():
    """Every probe's operands, as the wrapper sees them: P16's 108-byte rows
    by 4 bytes, 64- and 32-byte rows by 16, column-major A and every
    N-major B as transposed words."""
    from mit_driverless_cv_traininginfra_tpu_torch.probes import BY_NAME

    want = {"P1": (ROW16, TRANS4), "P5": (ROW16, TRANS4), "P7": (ROW16, TRANS4),
            "P10": (TRANS4, TRANS4), "P11": (TRANS4, TRANS4), "P13": (TRANS4, TRANS4),
            "P13b": (TRANS4, TRANS4), "P16": (ROW4, TRANS4),
            "rank3_dim0_contraction": (TRANS4, TRANS4),
            "rank3_minor_contraction": (ROW16, TRANS4)}
    for name, modes in want.items():
        inp = BY_NAME[name].build("cpu", small=True)
        assert staging_modes(inp["a"], inp["b"]) == modes, name


@pytest.mark.parametrize("K", [16, 108])
def test_plain_contraction_matches_xla(K):
    """The plain route against XLA's int8 dot_general into int32 (the TPU
    probes' reference), A column-major and B N-major, with the epilogue."""
    rng = np.random.default_rng(K + 1)
    a = rng.integers(-127, 127, (K, 37)).astype(np.int8).T
    b = rng.integers(-127, 127, (K, 29)).astype(np.int8)
    s = rng.uniform(1e-3, 1e-2, 29).astype(np.float32)
    want = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = int8_contract(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), np.asarray(want))
    want_bf16 = (want.astype(jnp.float32) * jnp.asarray(s)).astype(jnp.bfloat16)
    got_bf16 = int8_contract(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(s))
    assert np.array_equal(got_bf16.view(torch.int16).numpy(),
                          np.asarray(want_bf16).view(np.int16))
