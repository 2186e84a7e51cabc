"""The fused int8 entry of the serving Darknet: 4×4/s2 conv1 + kernel K4
(counterpart of the JAX package's ``ops/pallas_entry.py``).

    frames ─ int8 4×4/s2 conv1 (= packed conv1) ─ leaky ─ requant ─ hq
    hq (B, H/2, W/2, 128 int8) ─ K4: conv2p (2×2 taps) ─ leaky ─┐
        1×1 64→32 ─ leaky ─ requant ─ 3×3 32→64 ─ leaky ─ (+) ─ requant
    → resq (B, H/2, W/2, 64 int8), quantized with block 5's input scale

i.e. Darknet blocks 0-4 (conv s1 → conv s2 → 1×1 → 3×3 → shortcut). conv1
runs as an int8 convolution outside any kernel (``models.quantize``'s
im2col + ``torch._int_mm``), as the JAX package leaves it to XLA.
:func:`fused_entry_block` launches K4 (``csrc/entry_block.cu``) for a CUDA
tensor and takes its plain version, :func:`_entry_rest`, for a CPU one.
:func:`quantize_entry` makes the bundle in the JAX package's layouts;
:func:`pack_entry` lays its weights out once for their consumers, and
everything that runs the entry takes the packed bundle.

Rounding points, copied from the JAX package: int32 sums; ``acc.f32 ·
scale`` then ``+ b`` (two f32 roundings) → bf16; leaky with the slope
rounded to bf16; requant ``clip(round_half_even(x.f32 · sx_inv), −127,
127)``; the shortcut add in bf16. Every f32 scalar is a tensor, so none is
rounded twice and the kernel reads the very same values.
"""

from __future__ import annotations

from typing import Dict

import torch

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    ConvBlock,
    NetworkSpec,
    ShortcutBlock,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import (
    _leaky,
    _slope_in,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.quantize import (
    ACT_DTYPE,
    _int_conv,
    _q8,
    _quantize_conv,
    _weight_matrix,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.stem_opt import (
    build_packed_stem,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib

TILE = 16  # K4's output tile; hq's side must be a multiple of it


def entry_block_applicable(spec: NetworkSpec) -> bool:
    """True iff blocks 0-5 are the YOLOv3 entry pattern at an even input
    size — [conv3×3 s1 c32, conv3×3 s2 c64, conv1×1 c32, conv3×3 c64,
    shortcut from block 1, conv3×3 s2 (leaky, BN, not pre-yolo)] — and no
    later block routes to blocks 0-4 (the fused path fills their output
    slots with block 5's output)."""
    b = spec.blocks
    if len(b) < 6 or spec.net.width != spec.net.height:
        return False
    if spec.net.height % 32 != 0 or (spec.net.height // 2) % TILE != 0:
        return False
    want = [(3, 1, 32), (3, 2, 64), (1, 1, 32), (3, 1, 64)]
    for blk, w in zip(b[:4], want):
        if (not isinstance(blk, ConvBlock) or blk.size != w[0]
                or blk.stride != w[1] or blk.filters != w[2]
                or blk.activation != "leaky" or not blk.batch_normalize):
            return False
    if not isinstance(b[4], ShortcutBlock) or 4 + b[4].from_layer != 1:
        return False
    b5 = b[5]
    if (not isinstance(b5, ConvBlock) or b5.size != 3 or b5.stride != 2
            or b5.activation != "leaky" or not b5.batch_normalize
            or b5.is_preyolo):
        return False
    for i, blk in enumerate(b[5:], start=5):
        # routes: absolute indices when ≥ 0, relative when < 0
        layers = getattr(blk, "layers", None)
        if layers and any((li if li >= 0 else i + li) < 5 for li in layers):
            return False
        frm = getattr(blk, "from_layer", None)  # shortcuts: relative
        if frm is not None and i + frm < 5:
            return False
    return True


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def build_conv1_4x4(folded_params) -> Dict[str, torch.Tensor]:
    """Folded block-"0" weights (C1, C, 3, 3) → 4×4/s2 weights (4·C1, C, 4,
    4), output channel (a·2 + b)·C1 + co: packed conv1's phase (a, b) is
    the 3×3 conv at (2I + a, 2J + b), whose taps sit at (a + dy, b + dx) of
    the 4×4 patch at (2I − 1, 2J − 1)."""
    w1 = folded_params["0"]["w"].float()
    C1, C = w1.shape[0], w1.shape[1]
    w4 = w1.new_zeros((4 * C1, C, 4, 4))
    for a in range(2):
        for b in range(2):
            o = (a * 2 + b) * C1
            w4[o:o + C1, :, a:a + 3, b:b + 3] = w1
    return {"w": w4, "b": folded_params["0"]["b"].float().repeat(4)}


def quantize_entry(folded_params, amax: Dict[str, float]):
    """Quantized bundle of the fused entry (the JAX package's
    ``quantize_entry`` with ``conv1_dtype="int8"``); bit-equal leaves.

    ``amax``: :func:`models.quantize.calibrate` output; keys "0"-"3" are the
    input absmaxes of blocks 0-3, "5" block 5's (the scale of K4's output).
    K4's weights keep the JAX package's layouts: ``w2`` (4 taps, 128, 64)
    with tap = Dy·2 + Dx, ``w1x1`` (64, 32), ``w3im`` (288, 64) with row
    (dy·3 + dx)·32 + c."""
    sx = {k: max(float(amax[k]), 1e-12) / 127.0
          for k in ("0", "1", "2", "3", "5")}
    c4 = build_conv1_4x4(folded_params)
    c1 = _quantize_conv(c4["w"], c4["b"], amax["0"])
    ep = {"c1_wq": c1["wq"], "c1_scale": c1["scale"], "c1_b": c1["b"],
          "c1_sx_inv": c1["sx_inv"],
          "hq_sx_inv": torch.tensor(1.0 / sx["1"], dtype=torch.float32,
                                    device=c1["wq"].device)}

    def q(w, b, key):
        """OIHW → int8 (kh, kw, I, O) as in HWIO, scale and bias (1, O)."""
        p = _quantize_conv(w, b, amax[key])
        return (p["wq"].permute(2, 3, 1, 0), p["scale"].reshape(1, -1),
                p["b"].reshape(1, -1))

    packed = build_packed_stem({"0": folded_params["0"],
                                "1": folded_params["1"]})
    w2, ep["w2_scale"], ep["w2_b"] = q(packed["w2"], packed["b2"], "1")
    ep["w2"] = w2.reshape(4, 128, 64).contiguous()
    p2, p3 = folded_params["2"], folded_params["3"]
    w1x1, ep["w1x1_scale"], ep["w1x1_b"] = q(p2["w"], p2["b"], "2")
    ep["w1x1"] = w1x1.reshape(64, 32).contiguous()
    w3, ep["w3_scale"], ep["w3_b"] = q(p3["w"], p3["b"], "3")
    ep["w3im"] = w3.reshape(9 * 32, 64).contiguous()
    # requant scales: out2 → the 1×1's input, t → the 3×3's, res → block 5
    ep["sx"] = torch.tensor([1.0 / sx["2"], 1.0 / sx["3"], 1.0 / sx["5"]],
                            dtype=torch.float32,
                            device=c1["wq"].device).reshape(1, 3)
    return ep


def _pack_frag(w):
    """(K, N) int8, K and N multiples of 32 → (K/32, N/32, 2, 32, 16): the
    B fragments of ``mma.sync.m16n8k32`` in the order K4's lanes read them
    (its 1×1). For k-step s and 32-column group h, lane l = 4g + t loads 16
    bytes from pair q: the registers (b0, b1) of n-tile 2q, then of n-tile
    2q + 1, where register r of n-tile j holds the four k rows
    ``32s + 16r + 4t + (0..3)`` of column ``8(4h + j) + g``."""
    K, N = w.shape
    # w[k, n] with k = 32s + 16r + 4t + b and n = 32h + 16q + 8a + g
    return (w.reshape(K // 32, 2, 4, 4, N // 32, 2, 2, 8)
            .permute(0, 4, 5, 7, 2, 6, 1, 3)      # → [s, h, q, g, t, a, r, b]
            .reshape(K // 32, N // 32, 2, 32, 16).contiguous())


def _pack_wgmma(w):
    """(K, N) int8, K and N multiples of 32 → (K/32, N/32, 4, 2, 8, 16): one
    1 KB B tile of ``wgmma.m64n32k32`` per k-step s and 32-column half h,
    K-major without swizzle — 8×16-byte core matrices [n-group][k-chunk],
    row r of core matrix (ng, kc) holding the 16 k values ``32s + 16kc +
    (0..15)`` of column ``32h + 8ng + r`` (K4's conv2p and 3×3)."""
    K, N = w.shape
    # w[k, n] with k = 32s + 16kc + b and n = 32h + 8ng + r
    return (w.reshape(K // 32, 2, 16, N // 32, 4, 8)
            .permute(0, 3, 4, 1, 5, 2)            # → [s, h, ng, kc, r, b]
            .contiguous())


def _col_major(w):
    """(K, N) → the same matrix stored column-major, the layout
    ``torch._int_mm`` runs fastest on CUDA (``models.quantize._weight_matrix``;
    here K and N are multiples of 8 already)."""
    return w.t().contiguous().t()


def pack_entry(ep):
    """:func:`quantize_entry`'s bundle → the bundle the entry runs on, made
    once when a model is built: the same scales and biases; conv1's
    weights as a ``_weight_matrix`` (``c1_wmat``); K4's three weights
    column-major for the plain version (``w2_mat`` (512, 64), ``w1x1_mat``
    (64, 32), ``w3_mat`` (288, 64)) and as K4's tensor cores read them
    (``w2_tc``, ``w3_tc``: :func:`_pack_wgmma`; ``w1x1_tc``:
    :func:`_pack_frag`)."""
    out = {k: v for k, v in ep.items()
           if k not in ("c1_wq", "w2", "w1x1", "w3im")}
    w2 = ep["w2"].reshape(4 * 128, 64)
    out.update(c1_wmat=_weight_matrix(ep["c1_wq"]),
               w2_mat=_col_major(w2), w1x1_mat=_col_major(ep["w1x1"]),
               w3_mat=_col_major(ep["w3im"]),
               w2_tc=_pack_wgmma(w2), w1x1_tc=_pack_frag(ep["w1x1"]),
               w3_tc=_pack_wgmma(ep["w3im"]))
    return out


# ---------------------------------------------------------------------------
# conv1 and the plain version of K4
# ---------------------------------------------------------------------------


def conv1_4x4_q8(frames, ep, leaky_slope: float):
    """frames (B, H, W, 3) in [0, 1] → hq (B, H/2, W/2, 128) int8: the
    frames quantized on the fly, the int8 4×4/s2 conv, leaky, and the
    requant to conv2p's input scale. ``ep``: :func:`pack_entry`'s bundle."""
    xq = _q8(frames, ep["c1_sx_inv"])
    acc = _int_conv(xq, ep["c1_wmat"], 128, 4, 4, 2, 1)
    h = (acc.float() * ep["c1_scale"] + ep["c1_b"]).to(ACT_DTYPE)
    return _q8(_leaky(h, leaky_slope), ep["hq_sx_inv"])


def _deq_leaky(acc, scale, b, slope: float):
    """int32 → ``acc.f32 · scale + b`` → bf16 → leaky. The JAX package
    compares the f32 value and multiplies the bf16 one; rounding to bf16
    keeps the sign, so leaky on the bf16 value takes the same branch."""
    return _leaky((acc.float() * scale + b).to(ACT_DTYPE), slope)


def _entry_rest(hq, ep, leaky_slope: float):
    """Plain version of K4 (the JAX package's ``_entry_rest_xla``): hq
    (B, H, W, 128) int8 → resq (B, H, W, 64) int8; ``ep``: :func:`pack_entry`'s
    bundle."""
    acc = _int_conv(hq, ep["w2_mat"], 64, 2, 2, padding=((1, 0), (1, 0)))
    out2 = _deq_leaky(acc, ep["w2_scale"][0], ep["w2_b"][0], leaky_slope)
    tacc = _int_conv(_q8(out2, ep["sx"][0, 0]), ep["w1x1_mat"], 32, 1, 1)
    t = _deq_leaky(tacc, ep["w1x1_scale"][0], ep["w1x1_b"][0], leaky_slope)
    racc = _int_conv(_q8(t, ep["sx"][0, 1]), ep["w3_mat"], 64, 3, 3, padding=1)
    b3 = _deq_leaky(racc, ep["w3_scale"][0], ep["w3_b"][0], leaky_slope)
    return _q8(b3 + out2, ep["sx"][0, 2])


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


_K4_SHAPES = {"w2_tc": (16, 2, 4, 2, 8, 16), "w2_scale": (1, 64),
              "w2_b": (1, 64), "w1x1_tc": (2, 1, 2, 32, 16),
              "w1x1_scale": (1, 32), "w1x1_b": (1, 32),
              "w3_tc": (9, 2, 4, 2, 8, 16), "w3_scale": (1, 64),
              "w3_b": (1, 64), "sx": (1, 3)}


def _cuda_entry_block(hq, ep, leaky_slope: float):
    """K4 launch: same output as :func:`_entry_rest`, bit for bit. The
    weights come packed (:func:`pack_entry`): a call allocates the output
    and launches, nothing else on the card."""
    if hq.dim() != 4 or hq.shape[-1] != 128:
        raise ValueError(f"hq must be (B, H, W, 128), got {tuple(hq.shape)}")
    B, H, W, _ = hq.shape
    if H % TILE or W % TILE:
        raise ValueError(f"hq's H and W must be multiples of {TILE}: {H}×{W}")
    for k, shape in _K4_SHAPES.items():
        want = torch.int8 if k.endswith("_tc") else torch.float32
        v = ep[k]
        if (tuple(v.shape) != shape or v.dtype != want
                or v.device != hq.device or not v.is_contiguous()):
            raise ValueError(f"ep[{k!r}] must be a contiguous {shape} {want} "
                             f"on {hq.device}, got {tuple(v.shape)} {v.dtype} "
                             f"on {v.device}")
    code = _lib.dtype_code(hq.dtype)
    x = hq.contiguous()
    # cp.async copies 16-byte pieces of hq and of the packed weights
    if any(t.data_ptr() % 16 for t in (x, ep["w2_tc"], ep["w1x1_tc"],
                                       ep["w3_tc"])):
        raise ValueError("hq and the packed weights must be 16-byte aligned")
    out = torch.empty((B, H, W, 64), dtype=torch.int8, device=hq.device)
    with _lib.on_device(hq.device):
        rc = _lib.lib().mdcv_entry_block(
            x.data_ptr(), ep["w2_tc"].data_ptr(), ep["w2_scale"].data_ptr(),
            ep["w2_b"].data_ptr(), ep["w1x1_tc"].data_ptr(),
            ep["w1x1_scale"].data_ptr(), ep["w1x1_b"].data_ptr(),
            ep["w3_tc"].data_ptr(), ep["w3_scale"].data_ptr(),
            ep["w3_b"].data_ptr(), ep["sx"].data_ptr(), out.data_ptr(), B, H, W,
            _slope_in(leaky_slope, ACT_DTYPE), code,
            _lib.stream_ptr(hq.device))
    _lib.check(rc, "entry_block")
    fused_entry_block.launches += 1
    return out


def fused_entry_block(hq, ep, leaky_slope: float):
    """hq (B, H, W, 128) int8 → resq (B, H, W, 64) int8 (block 4's output,
    quantized with block 5's input scale). Kernel K4 for a CUDA tensor,
    :func:`_entry_rest` for a CPU one."""
    if hq.is_cuda:
        return _cuda_entry_block(hq, ep, leaky_slope)
    return _entry_rest(hq, ep, leaky_slope)


fused_entry_block.launches = 0


def entry_forward_int8(ep, frames, leaky_slope: float):
    """frames (B, H, W, 3) → resq (B, H/2, W/2, 64) int8: the int8 4×4
    conv1, then :func:`fused_entry_block`; ``ep``: :func:`pack_entry`'s
    bundle."""
    return fused_entry_block(conv1_4x4_q8(frames, ep, leaky_slope), ep,
                             leaky_slope)
