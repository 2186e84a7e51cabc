"""Image encoding for the visualisations and the dataset tools (the
counterpart of ``data/decode.py``), in numpy and the standard library:
one route on every machine, where the JAX package writes through PIL and
OpenCV.

- :func:`encode_jpeg`: baseline JPEG (JFIF): YCbCr without subsampling
  (4:4:4) or one grey component, 8×8 DCT, the standard quantisation tables
  scaled to ``quality`` as libjpeg scales them, the standard Huffman
  tables of the JPEG specification (Annex K), entropy coding vectorised
  over all blocks.
- :func:`encode_png`: 8-bit grey or RGB PNG, filter 0 on every row, one
  zlib stream.
- :func:`write_image`: by the destination's extension (``.jpg``/``.jpeg``,
  ``.png``, else a ``.npy`` array), through a temporary name and a rename.

Quality defaults: PIL writes JPEGs at 75, ``cv2.imwrite`` at 95; each
caller passes the one of the library it stands in for.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PIL_QUALITY = 75
CV2_QUALITY = 95

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)

# the standard Huffman tables (JPEG Annex K.3): code counts by length 1-16, symbols
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"
))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"
))


def _zigzag() -> np.ndarray:
    """Natural (row-major) index of each zigzag position."""
    cells = sorted(((i, j) for i in range(8) for j in range(8)),
                   key=lambda c: (c[0] + c[1], c[0] if (c[0] + c[1]) % 2 else -c[0]))
    return np.array([i * 8 + j for i, j in cells], np.int64)


_ZIGZAG = _zigzag()
_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) / 2 * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _scaled_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` of a base table, natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huffman_codes(table):
    """(bits, symbols) → (code (256,), length (256,)) by symbol."""
    bits, symbols = table
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n_bits, count in enumerate(bits, start=1):
        for _ in range(count):
            code[symbols[k]], length[symbols[k]] = c, n_bits
            c, k = c + 1, k + 1
        c <<= 1
    return code, length


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (the JPEG size category; 0 for 0)."""
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) float plane, edge-padded to multiples of 8 → (rows·cols, 8, 8)."""
    h, w = plane.shape
    ph, pw = -h % 8, -w % 8
    p = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    hb, wb = p.shape[0] // 8, p.shape[1] // 8
    return p.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3).reshape(hb * wb, 8, 8)


def _entropy_code(coef: np.ndarray, comp: np.ndarray, table_of, tables) -> bytes:
    """Huffman-code quantised zigzag blocks (N, 64) in scan order: block i
    is of component ``comp[i]`` (its own DC predictor), coded with
    ``tables[table_of[comp[i]]]`` = (DC codes, AC codes). Returns the
    stuffed scan bytes."""
    n = coef.shape[0]
    dc = coef[:, 0]
    diff = dc.copy()
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        diff[idx[1:]] = dc[idx[1:]] - dc[idx[:-1]]
    comp = np.asarray(table_of)[comp]
    dc_code = np.stack([tables[c][0][0] for c in range(len(tables))])
    dc_len = np.stack([tables[c][0][1] for c in range(len(tables))])
    ac_code = np.stack([tables[c][1][0] for c in range(len(tables))])
    ac_len = np.stack([tables[c][1][1] for c in range(len(tables))])

    def field(code, clen, value, size):
        """A Huffman code followed by ``size`` extra bits of ``value`` (the
        ones' complement for a negative value)."""
        extra = np.where(value < 0, value + (1 << size) - 1, value) & ((1 << size) - 1)
        return (code << size) | extra, clen + size

    keys, vals, lens = [], [], []
    size = _bit_length(diff)
    v, ln = field(dc_code[comp, size], dc_len[comp, size], diff, size)
    keys.append(np.arange(n) * 200)
    vals.append(v)
    lens.append(ln)

    b, k = np.nonzero(coef[:, 1:])
    k = k + 1
    prev = np.zeros_like(k)
    same = np.zeros(len(k), bool)
    same[1:] = b[1:] == b[:-1]
    prev[1:] = np.where(same[1:], k[:-1], 0)
    run = k - prev - 1
    zrl = run // 16
    ac = coef[b, k]
    size = _bit_length(ac)
    sym = (run % 16) * 16 + size
    v, ln = field(ac_code[comp[b], sym], ac_len[comp[b], sym], ac, size)
    keys.append(b * 200 + 2 * k + 1)
    vals.append(v)
    lens.append(ln)
    # ZRL (16 zeros) before a coefficient that follows a longer run
    zb = np.repeat(b, zrl)
    keys.append(np.repeat(b * 200 + 2 * k, zrl))
    vals.append(ac_code[comp[zb], 0xF0])
    lens.append(ac_len[comp[zb], 0xF0])
    # EOB where a block's last coefficient is zero
    last = np.zeros(n, np.int64)
    last[b] = k  # nonzero() is ordered, so the last write of a block is its last k
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 200 + 199)
    vals.append(ac_code[comp[eob], 0x00])
    lens.append(ac_len[comp[eob], 0x00])

    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    owner = np.repeat(np.arange(len(lens)), lens)
    offset = np.arange(total) - starts[owner]
    bits = (vals[owner] >> (lens[owner] - 1 - offset)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)])  # pad with 1s
    data = np.packbits(bits.astype(np.uint8))
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()  # byte stuffing


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _dht(cls_id: int, table) -> bytes:
    bits, symbols = table
    return bytes([cls_id]) + bytes(bits) + bytes(symbols)


def encode_jpeg(img: np.ndarray, quality: int = PIL_QUALITY) -> bytes:
    """Baseline JPEG of a uint8 (H, W, 3) RGB or (H, W) grey image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                            and img.shape[2] != 3):
        raise ValueError(f"encode_jpeg: uint8 (H, W, 3) or (H, W), not {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    x = img.astype(np.float64)
    if img.ndim == 2:
        planes = [x]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    qtabs = [_scaled_table(_LUMA_Q, quality), _scaled_table(_CHROMA_Q, quality)]
    blocks = []
    for i, plane in enumerate(planes):
        blk = _blocks(np.clip(np.rint(plane), 0, 255) - 128.0)
        f = (_DCT @ blk @ _DCT.T).reshape(-1, 64)
        q = qtabs[min(i, 1)]
        blocks.append(np.rint(f / q)[:, _ZIGZAG].astype(np.int64))
    n = blocks[0].shape[0]
    coef = np.stack(blocks, 1).reshape(n * len(planes), 64)  # MCU order
    comp_of = np.tile(np.arange(len(planes)), n)
    codes = [(_huffman_codes(_DC_LUMA), _huffman_codes(_AC_LUMA)),
             (_huffman_codes(_DC_CHROMA), _huffman_codes(_AC_CHROMA))]
    scan = _entropy_code(coef, comp_of, [0, 1, 1], codes)

    nc = len(planes)
    out = [b"\xff\xd8",
           _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(min(nc, 2)):
        out.append(_segment(0xFFDB, bytes([t]) + bytes(qtabs[t][_ZIGZAG].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, h, w, nc)
    for c in range(nc):
        sof += bytes([c + 1, 0x11, min(c, 1)])
    out.append(_segment(0xFFC0, sof))
    out.append(_segment(0xFFC4, _dht(0x00, _DC_LUMA) + _dht(0x10, _AC_LUMA)
                        + (_dht(0x01, _DC_CHROMA) + _dht(0x11, _AC_CHROMA) if nc > 1
                           else b"")))
    sos = bytes([nc]) + b"".join(bytes([c + 1, 0x11 * min(c, 1)]) for c in range(nc))
    out.append(_segment(0xFFDA, sos + b"\x00\x3f\x00"))
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)


def encode_png(img: np.ndarray) -> bytes:
    """8-bit PNG of a uint8 (H, W, 3) RGB or (H, W) grey image: filter 0 on
    each row, one zlib stream."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                            and img.shape[2] != 3):
        raise ValueError(f"encode_png: uint8 (H, W, 3) or (H, W), not {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    row = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), row], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color = 0 if img.ndim == 2 else 2
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def write_image(path: str, img: np.ndarray, quality: int = PIL_QUALITY) -> str:
    """Write a uint8 RGB or grey image by ``path``'s extension — JPEG at
    ``quality``, PNG, or else the array itself (``np.save``) — to a
    temporary name beside it, then rename. Returns ``path``."""
    ext = os.path.splitext(path)[1].lower()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp" + (ext if ext in (".jpg", ".jpeg", ".png") else ".npy")
    if ext in (".jpg", ".jpeg"):
        data = encode_jpeg(img, quality)
    elif ext == ".png":
        data = encode_png(img)
    else:
        data = None
    if data is None:
        with open(tmp, "wb") as f:
            np.save(f, np.asarray(img))
    else:
        with open(tmp, "wb") as f:
            f.write(data)
    os.replace(tmp, path)
    return path
