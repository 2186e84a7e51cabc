"""Post-training int8 quantization for the serving path (counterpart of the
JAX package's ``models/quantize.py``).

The recipe is the JAX package's, with its rounding points copied exactly:

- **weights**: per-output-channel symmetric int8, ``s_w[o] = max|w[o]| /
  127`` (OIHW here, so the max runs over dims 1, 2, 3);
- **activations**: per-tensor symmetric int8 from calibrated absolute
  maxima of every conv input, ``sx_inv = f32(1 / s_x)`` divided in double;
- **compute**: ``clip(round_half_even(x.f32 · sx_inv), −127, 127)`` →
  int8 × int8 convolution with exact int32 sums → ``acc.f32 · scale``
  then ``+ b`` (two f32 roundings) → bf16.

Eager PyTorch has no int8 convolution with an int32 result, so each one is
an im2col (zero pad + strided slices, which work for any dtype) followed by
``torch._int_mm``, a library int8 GEMM — the JAX package leaves these
convolutions to XLA too. On CUDA ``_int_mm`` wants K and N multiples of 8
and M > 16: weights are zero-padded once, rows per call.

Pre-yolo head convs stay bf16, as in the JAX package. The fused entry path
(blocks 0-4 as a 4×4/s2 conv1 plus kernel K4) lives in ``ops/entry.py``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    ConvBlock,
    NetworkSpec,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import (
    Darknet,
    YoloHeads,
    _leaky,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import (
    RektNet,
    soft_argmax_2d,
)

ACT_DTYPE = torch.bfloat16  # activations between the int8 convs
_ALIGN = 8                  # _int_mm on CUDA: K and N multiples of 8
_MIN_ROWS = 17              # _int_mm on CUDA: M > 16

# ---------------------------------------------------------------------------
# int8 convolution: im2col + torch._int_mm
# ---------------------------------------------------------------------------


def _q8(x, sx_inv):
    """Requantize: ``clip(round(x.f32 · sx_inv), −127, 127)`` as int8
    (``torch.round`` rounds half to even, as ``jnp.round``)."""
    return torch.clamp(torch.round(x.float() * sx_inv), -127, 127).to(torch.int8)


def _pairs(padding):
    """``p`` or ``((top, bottom), (left, right))`` → the pair form."""
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple(tuple(p) for p in padding)


def _weight_matrix(wq):
    """int8 OIHW (O, I, kh, kw) → (K, N) with row k = (dy·kw + dx)·I + c
    (the im2col order), zero-padded to multiples of 8. Column-major (the
    transpose of a contiguous (N, K)): cuBLASLt's int8 tensor-core GEMMs
    take that layout, and a row-major one falls back to a slower kernel."""
    o, i, kh, kw = wq.shape
    w = wq.permute(0, 2, 3, 1).reshape(o, kh * kw * i)
    return F.pad(w, (0, -w.shape[1] % _ALIGN, 0, -o % _ALIGN)).t()


def _im2col(x, kh: int, kw: int, stride: int, padding, dilation: int):
    """x (B, H, W, C) NHWC of any dtype → (B, Ho, Wo, kh·kw·C), taps
    outer and channels inner; zero padding ``((top, bottom), (left,
    right))``. int8 with C a multiple of 4 is copied as int32 words."""
    (pt, pb), (pl, pr) = _pairs(padding)
    B, H, W, C = x.shape
    ho = (H + pt + pb - dilation * (kh - 1) - 1) // stride + 1
    wo = (W + pl + pr - dilation * (kw - 1) - 1) // stride + 1
    if (kh, kw, stride) == (1, 1, 1) and (pt, pb, pl, pr) == (0, 0, 0, 0):
        return x
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    words = x.dtype == torch.int8 and C % 4 == 0
    if words:
        xp = xp.view(torch.int32)
    taps = [xp[:, dy * dilation:dy * dilation + stride * (ho - 1) + 1:stride,
               dx * dilation:dx * dilation + stride * (wo - 1) + 1:stride, :]
            for dy in range(kh) for dx in range(kw)]
    cols = torch.cat(taps, dim=-1)
    return cols.view(torch.int8) if words else cols


def _int_conv(xq, wmat, n_out: int, kh: int, kw: int, stride: int = 1,
              padding=0, dilation: int = 1):
    """int8 NHWC ``xq`` ⊛ int8 weights (``_weight_matrix`` form) → exact
    int32 (B, Ho, Wo, n_out)."""
    cols = _im2col(xq, kh, kw, stride, padding, dilation)
    B, ho, wo, k = cols.shape
    cols = cols.reshape(B * ho * wo, k)
    m = cols.shape[0]
    pad_k, pad_m = wmat.shape[0] - k, max(0, _MIN_ROWS - m)
    if pad_k or pad_m:
        cols = F.pad(cols, (0, pad_k, 0, pad_m))
    acc = torch._int_mm(cols, wmat)
    return acc[:m, :n_out].reshape(B, ho, wo, n_out)


class QConv(nn.Module):
    """One int8 convolution: weights as a ``_weight_matrix``, per-channel
    ``scale = s_x·s_w`` and bias in f32, the input scale ``sx_inv``."""

    def __init__(self, q, stride: int = 1, padding=0, dilation: int = 1):
        super().__init__()
        o, _, self.kh, self.kw = q["wq"].shape
        self.out_channels = o
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.register_buffer("wmat", _weight_matrix(q["wq"]))
        self.register_buffer("scale", q["scale"].float())
        self.register_buffer("b", q["b"].float())
        self.register_buffer("sx_inv", q["sx_inv"].float())


def _qconv(x, q: QConv):
    """Quantize the input on the fly → int8 conv → dequant + bias."""
    return _qconv_q8in(_q8(x, q.sx_inv), q)


def _qconv_q8in(xq, q: QConv):
    """:func:`_qconv` for an input already quantized with this conv's
    input scale (the fused entry's ``resq``)."""
    acc = _int_conv(xq, q.wmat, q.out_channels, q.kh, q.kw, q.stride,
                    q.padding, q.dilation)
    return (acc.float() * q.scale + q.b).to(ACT_DTYPE)


def _quantize_conv(w, b, amax_in: float):
    """OIHW f32 weights → ``{"wq" int8 OIHW, "scale" (O,), "b" (O,),
    "sx_inv" ()}``, bit-equal to the JAX package's leaves."""
    w = w.float()
    s_w = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    wq = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127)
    s_x = max(float(amax_in), 1e-12) / 127.0
    return {"wq": wq.to(torch.int8), "scale": s_w * s_x, "b": b.float(),
            "sx_inv": torch.tensor(1.0 / s_x, dtype=torch.float32,
                                   device=w.device)}


def _input_amax(modules: Dict[str, nn.Module]):
    """Forward pre-hooks that record ``max|input|`` of each named module;
    returns ``(amax dict, hook handles)``."""
    amax: Dict[str, float] = {}
    handles = [m.register_forward_pre_hook(
        lambda _m, inp, name=name: amax.__setitem__(
            name, float(inp[0].abs().max())))
        for name, m in modules.items()]
    return amax, handles


# ---------------------------------------------------------------------------
# Darknet
# ---------------------------------------------------------------------------


@torch.inference_mode()
def calibrate(spec: NetworkSpec, folded_params, frames) -> Dict[str, float]:
    """Run the folded f32 graph on calibration frames (B, H, W, 3) and
    record the absolute max of every conv input: ``{block index: amax}``."""
    model = Darknet(spec, folded_params).float()
    amax, handles = _input_amax(dict(model.convs.items()))
    try:
        model.forward_features(
            torch.as_tensor(frames, device=model.device).float())
    finally:
        for h in handles:
            h.remove()
    return amax


def quantize_params(spec: NetworkSpec, folded_params, amax: Dict[str, float]):
    """Folded OIHW params → int8 serving params: per conv block
    ``{"wq", "scale", "b", "sx_inv"}``; pre-yolo convs pass through as
    ``{"w", "b"}`` in bf16 (``ACT_DTYPE``)."""
    qparams: Dict[str, dict] = {}
    for i, b in enumerate(spec.blocks):
        if not isinstance(b, ConvBlock):
            continue
        p = folded_params[str(i)]
        if b.is_preyolo:
            qparams[str(i)] = {"w": p["w"].to(ACT_DTYPE),
                               "b": p["b"].to(ACT_DTYPE)}
            continue
        if str(i) not in amax:
            raise KeyError(f"calibration amax missing for conv block {i}; "
                           "re-run calibrate against this spec")
        qparams[str(i)] = _quantize_conv(p["w"], p["b"], amax[str(i)])
    return qparams


class _FloatConv(nn.Module):
    """A pre-yolo conv on NHWC activations: ``conv(x, w) + b`` in the
    weights' dtype (bf16), the bias added after the conv's own rounding.
    These are the port's numerics for the int8 heads: the conv sums in
    float64 — exact for bf16 products — and rounds once, so its result
    does not hang on a library's summation order and the card agrees with
    the CPU bit for bit (cuDNN and oneDNN bf16 convs differ by an ulp or
    two now and then, and one ulp of a logit moves a confidence by ~1e-3;
    ``tools/head_numerics.py`` compares the two). The heads are a few
    MFLOP."""

    def __init__(self, w, b, stride: int, padding: int):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.register_buffer("w", w)
        self.register_buffer("b", b)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2).double(), self.w.double(), None,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1).to(self.w.dtype) + self.b


class _Bundle(nn.Module):
    """A flat dict of tensors held as buffers, so ``.to()`` moves them."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in tensors.items():
            self.register_buffer(k, v)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers())


class Int8Darknet(YoloHeads):
    """int8 serving Darknet (the JAX package's ``forward_features_int8`` /
    ``detections_int8``) on :func:`quantize_params` output. Frames come in
    NHWC and are cast to bf16; activations stay NHWC.

    ``entry_q`` (``ops.entry.quantize_entry``) replaces blocks 0-4 with the
    fused entry: the 4×4/s2 int8 conv1, then kernel K4 on CUDA tensors (its
    plain version on CPU ones); block 5 takes K4's int8 output directly.
    It requires ``ops.entry.entry_block_applicable(spec)``; its weights are
    laid out for their consumers once, here (``ops.entry.pack_entry``)."""

    frame_dtype = ACT_DTYPE

    def __init__(self, spec: NetworkSpec, qparams, entry_q=None):
        super().__init__(spec)
        from mit_driverless_cv_traininginfra_tpu_torch.ops import entry

        self._entry_forward = entry.entry_forward_int8
        self.entry = None
        start = 0
        if entry_q is not None:
            if not entry.entry_block_applicable(spec):
                raise ValueError("entry_q given, but blocks 0-5 of this spec "
                                 "are not the YOLOv3 entry pattern")
            self.entry = _Bundle(entry.pack_entry(entry_q))
            start = 5
        convs = {}
        for i, b in list(enumerate(spec.blocks))[start:]:
            if not isinstance(b, ConvBlock):
                continue
            q, pad = qparams[str(i)], (b.size - 1) // 2
            convs[str(i)] = (QConv(q, b.stride, pad) if "wq" in q else
                             _FloatConv(q["w"], q["b"], b.stride, pad))
        self.convs = nn.ModuleDict(convs)

    def _enter(self, x):
        x = x.to(ACT_DTYPE)
        if self.entry is None:
            return x, []
        slope = self.spec.net.leaky_slope
        resq = self._entry_forward(self.entry.as_dict(), x, slope)
        x = _leaky(_qconv_q8in(resq, self.convs["5"]), slope)
        # blocks 0-4 are never routed to (entry_block_applicable): block
        # 5's output fills their slots, so absolute indices stay aligned
        return x, [x] * 6

    def _conv(self, i: int, x):
        conv = self.convs[str(i)]
        return _qconv(x, conv) if isinstance(conv, QConv) else conv(x)


# ---------------------------------------------------------------------------
# RektNet
# ---------------------------------------------------------------------------


@torch.inference_mode()
def calibrate_rektnet(folded, crops) -> Dict[str, float]:
    """Per-conv input amax of the BN-folded RektNet (``rektnet.fold_bn``)
    over calibration crops (N, H, W, 3); a shortcut conv shares its block's
    conv1 input, and ``"out"`` is the head's input."""
    model = RektNet(folded).float()
    named = {"stem": model.stem, "out": model.out}
    for i, blk in enumerate(model.res, start=1):
        named[f"res{i}.conv1"] = blk.conv1
        named[f"res{i}.conv2"] = blk.conv2
    amax, handles = _input_amax(named)
    try:
        model(torch.as_tensor(crops, device=model.stem.weight.device).float())
    finally:
        for h in handles:
            h.remove()
    for i in range(1, 5):
        amax[f"res{i}.shortcut_conv"] = amax[f"res{i}.conv1"]
    return amax


def quantize_rektnet_params(folded, amax: Dict[str, float]):
    """BN-folded RektNet → int8; the 1×1 output head stays f32."""
    q = {"stem": _quantize_conv(folded["stem"]["w"], folded["stem"]["b"],
                                amax["stem"]),
         "out": {"w": folded["out"]["w"].float(),
                 "b": folded["out"]["b"].float()}}
    for i in range(1, 5):
        p = folded[f"res{i}"]
        q[f"res{i}"] = {name: _quantize_conv(p[name]["w"], p[name]["b"],
                                             amax[f"res{i}.{name}"])
                        for name in ("conv1", "conv2", "shortcut_conv")}
    return q


class _Int8ResBlock(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.conv1 = QConv(p["conv1"], padding=2, dilation=2)
        self.conv2 = QConv(p["conv2"], padding=1)
        self.shortcut_conv = QConv(p["shortcut_conv"])

    def forward(self, h):
        b2 = _qconv(F.relu(_qconv(h, self.conv1)), self.conv2)
        return F.relu(_qconv(h, self.shortcut_conv) + b2)


class Int8RektNet(nn.Module):
    """int8 serving RektNet (the JAX package's ``apply_rektnet_int8``) on
    :func:`quantize_rektnet_params` output: int8 stem, convs and shortcuts
    with bf16 activations, an f32 1×1 head, then soft-argmax (kernel K2).
    ``forward(x (N, H, W, C))`` → (probs (N, 7, H, W), points (N, 7, 2))."""

    def __init__(self, q):
        super().__init__()
        self.stem = QConv(q["stem"], padding=3)
        self.res = nn.ModuleList(_Int8ResBlock(q[f"res{i}"])
                                 for i in range(1, 5))
        # the head as an f32 matmul (N·H·W, C) @ (C, K): cuBLAS runs it in
        # full f32 by default, where a cuDNN conv would take TF32
        self.register_buffer("out_w", q["out"]["w"][:, :, 0, 0].t().float())
        self.register_buffer("out_b", q["out"]["b"].float())

    def forward(self, x):
        h = F.relu(_qconv(x, self.stem))
        for blk in self.res:
            h = blk(h)
        logits = torch.matmul(h.float(), self.out_w) + self.out_b
        points, probs = soft_argmax_2d(logits.permute(0, 3, 1, 2))
        return probs, points
