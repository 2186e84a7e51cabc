"""Kernel K5: a whole int8 Darknet residual stage (counterpart of the JAX
package's ``ops/pallas_resstage.py``).

A stage is n × [1×1 C→C/2 leaky, 3×3 C/2→C leaky, shortcut add] on int8
convolutions with a bf16 residual carrier:

    x ─┬─ q8 ─ 1×1 ─ deq ─ leaky ─ q8 ─ 3×3 ─ deq ─ leaky ─ (+) ─ x'  (× n)
       └──────────────────────────────────────────────────────┘
    outputs: yq = q8(x_n) with the next conv's input scale, ybf = x_n

both zero-bordered ``(B, S+2, S+2, C)``, so the stride-2 conv after the
stage reads ``yq`` with padding 0 and a route reads ``ybf``'s interior.

:func:`fused_res_stage` launches K5 (``csrc/res_stage.cu``) for a CUDA
tensor and takes its plain version, :func:`_res_stage_plain` (built on
:func:`res_stage_reference`), for a CPU one. :func:`quantize_res_stage`
makes the stage's bundle in the JAX package's layouts from
``models.quantize.quantize_params`` leaves; :func:`pack_res_stage` lays it
out once for both consumers. The TPU kernel's group size ``G``, its
``interpret`` switch and its host-made interior mask have no counterpart:
the card kernel finds the interior from coordinates and the plain version
crops it.

Rounding points, copied from the JAX package: int32 sums; ``acc.f32 ·
scale`` then ``+ b`` (two f32 roundings) → bf16; leaky with the slope
rounded to bf16; requant ``clip(round_half_even(x.f32 · sx_inv), −127,
127)``; the shortcut add in bf16.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    ConvBlock,
    NetworkSpec,
    ShortcutBlock,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import _slope_in
from mit_driverless_cv_traininginfra_tpu_torch.models.quantize import (
    ACT_DTYPE,
    _int_conv,
    _q8,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib
from mit_driverless_cv_traininginfra_tpu_torch.ops.entry import (
    _deq_leaky,
    _pack_frag,
    _pack_wgmma,
)


def res_stage_spans(spec: NetworkSpec):
    """Maximal runs of [1×1 C→C/2, 3×3 C/2→C, shortcut(-3)] triplets.

    Returns [(start, n_blocks, C)]: ``start`` indexes the first 1×1 conv;
    the run covers spec blocks [start, start+3·n). Runs whose non-final
    outputs feed a route are cut (the final shortcut output may be routed —
    the stage emits it)."""
    b = spec.blocks
    routed = set()
    for j, blk in enumerate(b):
        layers = getattr(blk, "layers", None)
        if layers:
            routed.update(li if li >= 0 else j + li for li in layers)

    def is_triplet(i, c_half=None, c_full=None):
        if i + 2 >= len(b):
            return False
        c1, c3, sc = b[i], b[i + 1], b[i + 2]
        return (isinstance(c1, ConvBlock) and c1.size == 1 and c1.stride == 1
                and c1.activation == "leaky" and c1.batch_normalize
                and isinstance(c3, ConvBlock) and c3.size == 3
                and c3.stride == 1 and c3.filters == 2 * c1.filters
                and c3.activation == "leaky" and c3.batch_normalize
                and isinstance(sc, ShortcutBlock)
                and (i + 2) + sc.from_layer == i - 1
                and (c_half is None or c1.filters == c_half)
                and (c_full is None or c3.filters == c_full))

    spans = []
    i = 0
    while i < len(b):
        if is_triplet(i):
            start, c_half, c_full = i, b[i].filters, b[i + 1].filters
            n = 0
            while (is_triplet(i, c_half, c_full)
                   and not ({i, i + 1} & routed)
                   and (n == 0 or (i - 1) not in routed)):
                n += 1
                i += 3
            if n > 0:
                spans.append((start, n, c_full))
            else:
                # the run's first triplet is routed into: not fusable; step
                # past it, or the loop would enter the same branch forever
                i += 1
        else:
            i += 1
    return spans


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def quantize_res_stage(qparams, start: int, n_blocks: int,
                       next_conv_idx: int) -> Dict[str, torch.Tensor]:
    """The stage's int8 bundle in the JAX package's layouts, from
    ``models.quantize.quantize_params`` leaves (OIHW ``wq``): ``w1`` (n, C,
    C/2) and ``w3`` (n, 9, C/2, C) int8 with tap = dy·3 + dx; ``s1``,
    ``b1`` (n, 1, C/2) and ``s3``, ``b3`` (n, 1, C) f32; the input scales
    ``sx1`` and ``sx3`` (1, n) and ``sx_out`` (a 0-d f32 tensor, the input
    scale of the conv ``next_conv_idx`` that consumes the stage)."""
    w1, s1, b1, w3, s3, b3, sx1, sx3 = [], [], [], [], [], [], [], []
    for i in range(n_blocks):
        q1 = qparams[str(start + 3 * i)]
        q3 = qparams[str(start + 3 * i + 1)]
        c_half, c = q1["wq"].shape[0], q3["wq"].shape[0]
        w1.append(q1["wq"][:, :, 0, 0].t())                       # (C, C/2)
        w3.append(q3["wq"].permute(2, 3, 1, 0).reshape(9, c_half, c))
        s1.append(q1["scale"].reshape(1, c_half))
        b1.append(q1["b"].reshape(1, c_half))
        s3.append(q3["scale"].reshape(1, c))
        b3.append(q3["b"].reshape(1, c))
        sx1.append(q1["sx_inv"])
        sx3.append(q3["sx_inv"])
    return {
        "w1": torch.stack(w1), "s1": torch.stack(s1), "b1": torch.stack(b1),
        "w3": torch.stack(w3), "s3": torch.stack(s3), "b3": torch.stack(b3),
        "sx1": torch.stack(sx1).float().reshape(1, -1),
        "sx3": torch.stack(sx3).float().reshape(1, -1),
        "sx_out": qparams[str(next_conv_idx)]["sx_inv"].float(),
    }


def _k3_padded(c_half: int) -> int:
    """K of the 3×3, 9·C/2, rounded up to K5's 64-byte chunks."""
    return -(-9 * c_half // 64) * 64


def pack_res_stage(rs) -> Dict[str, torch.Tensor]:
    """:func:`quantize_res_stage`'s bundle → the bundle the stage runs on,
    made once: for the plain version each block's weights as a row-major
    (N, K) int8 matrix with K tap-major (``w1_k`` (n, C/2, C), ``w3_k`` (n,
    C, 9·C/2)), whose transpose is the column-major (K, N) matrix
    ``torch._int_mm`` takes; for K5's tensor cores the same (K, N) matrices
    as the 1×1's ``mma.sync`` B fragments (``ops.entry._pack_frag``):
    ``w1_tc`` (n, C/32, C/64, 2, 32, 16), and the 3×3's ``wgmma`` B tiles
    (``ops.entry._pack_wgmma``): ``w3_tc`` (n, Kp/32, C/32, 4, 2, 8, 16),
    its K zero-padded to Kp, a multiple of 64; flat scales and biases (n,
    C/2) / (n, C); ``sx1``, ``sx3`` (n,) and ``sx_out`` (1,)."""
    n, c, c_half = rs["w1"].shape
    w3 = rs["w3"].reshape(n, 9 * c_half, c)
    w3 = F.pad(w3, (0, 0, 0, _k3_padded(c_half) - 9 * c_half))
    return {
        "w1_k": rs["w1"].transpose(1, 2).contiguous(),
        "w3_k": rs["w3"].permute(0, 3, 1, 2).reshape(n, c, 9 * c_half)
                        .contiguous(),
        "w1_tc": torch.stack([_pack_frag(w) for w in rs["w1"]]),
        "w3_tc": torch.stack([_pack_wgmma(w) for w in w3]),
        "s1": rs["s1"].reshape(n, c_half).contiguous(),
        "b1": rs["b1"].reshape(n, c_half).contiguous(),
        "s3": rs["s3"].reshape(n, c).contiguous(),
        "b3": rs["b3"].reshape(n, c).contiguous(),
        "sx1": rs["sx1"].reshape(n).contiguous(),
        "sx3": rs["sx3"].reshape(n).contiguous(),
        "sx_out": rs["sx_out"].reshape(1).contiguous(),
    }


# ---------------------------------------------------------------------------
# layouts and the plain version of K5
# ---------------------------------------------------------------------------


def _bordered(x):
    """(B, S, S, C) → zero-bordered flat (B·(S+2)², C), dtype kept."""
    return F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(-1, x.shape[-1])


def res_stage_pre(x):
    """(B, S, S, C) activation → zero-bordered flat (B·(S+2)², C) bf16."""
    return _bordered(x.to(ACT_DTYPE))


def res_stage_post(y_flat, B: int, S: int):
    """Stage output → (B, S+2, S+2, C), zero-bordered NHWC: the stride-2
    conv after the stage reads ``yq`` so with padding 0; a route reads
    ``ybf[:, 1:S+1, 1:S+1]``."""
    return y_flat.reshape(B, S + 2, S + 2, y_flat.shape[-1])


def res_stage_reference(x, pk, n_blocks: int, leaky_slope: float):
    """The stage as plain int8 convolutions (the JAX package's
    ``res_stage_reference``): x (B, S, S, C) → (stage output bf16,
    quantized output int8), both (B, S, S, C). ``pk``: :func:`pack_res_stage`'s
    bundle."""
    x = x.to(ACT_DTYPE)
    c_half, c = pk["w1_k"].shape[1], pk["w3_k"].shape[1]
    for blk in range(n_blocks):
        acc = _int_conv(_q8(x, pk["sx1"][blk]), pk["w1_k"][blk].t(), c_half,
                        1, 1)
        t = _deq_leaky(acc, pk["s1"][blk], pk["b1"][blk], leaky_slope)
        acc3 = _int_conv(_q8(t, pk["sx3"][blk]), pk["w3_k"][blk].t(), c, 3, 3,
                         padding=1)
        x = _deq_leaky(acc3, pk["s3"][blk], pk["b3"][blk], leaky_slope) + x
    return x, _q8(x, pk["sx_out"][0])


def _res_stage_plain(x_flat, pk, S: int, n_blocks: int, leaky_slope: float):
    """Plain version of K5 on the flat zero-bordered layout: the interior
    through :func:`res_stage_reference`, borders 0. Returns (yq, ybf)."""
    B = x_flat.shape[0] // ((S + 2) * (S + 2))
    inner = res_stage_post(x_flat, B, S)[:, 1:S + 1, 1:S + 1]
    xr, yq = res_stage_reference(inner, pk, n_blocks, leaky_slope)
    return _bordered(yq), _bordered(xr)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

MAX_C = 1024  # the widest stage K5 is built for (Darknet-53's last)


def _cuda_res_stage(x_flat, pk, S: int, n_blocks: int, leaky_slope: float):
    """K5 launch: the same (yq, ybf) as :func:`_res_stage_plain`, bit for
    bit. One launch runs the whole stage (2n convolution kernels and
    nothing else, the host looping over the blocks inside the C entry
    point)."""
    P = (S + 2) * (S + 2)
    if x_flat.dim() != 2 or x_flat.shape[0] % P:
        raise ValueError(f"x must be (B·(S+2)², C) for S={S}, got "
                         f"{tuple(x_flat.shape)}")
    B, C = x_flat.shape[0] // P, x_flat.shape[1]
    if C % 64 or C > MAX_C:
        raise ValueError(f"C must be a multiple of 64 up to {MAX_C}, got {C}")
    kp = _k3_padded(C // 2)
    shapes = {"w1_tc": ((n_blocks, C // 32, C // 64, 2, 32, 16), torch.int8),
              "w3_tc": ((n_blocks, kp // 32, C // 32, 4, 2, 8, 16), torch.int8),
              "s1": ((n_blocks, C // 2), torch.float32),
              "b1": ((n_blocks, C // 2), torch.float32),
              "s3": ((n_blocks, C), torch.float32),
              "b3": ((n_blocks, C), torch.float32),
              "sx1": ((n_blocks,), torch.float32),
              "sx3": ((n_blocks,), torch.float32),
              "sx_out": ((1,), torch.float32)}
    for k, (shape, dtype) in shapes.items():
        v = pk[k]
        if (tuple(v.shape) != shape or v.dtype != dtype
                or v.device != x_flat.device or not v.is_contiguous()):
            raise ValueError(f"pk[{k!r}] must be a contiguous {shape} {dtype} "
                             f"on {x_flat.device}, got {tuple(v.shape)} "
                             f"{v.dtype} on {v.device}")
    code = _lib.dtype_code(x_flat.dtype)
    x = x_flat.contiguous()
    # K5 writes every element of the three, borders included
    ybf = torch.empty_like(x)
    yq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    tq = torch.empty((B * P, C // 2), dtype=torch.int8, device=x.device)
    with _lib.on_device(x.device):
        rc = _lib.lib().mdcv_res_stage(
            x.data_ptr(), pk["w1_tc"].data_ptr(), pk["s1"].data_ptr(),
            pk["b1"].data_ptr(), pk["w3_tc"].data_ptr(), pk["s3"].data_ptr(),
            pk["b3"].data_ptr(), pk["sx1"].data_ptr(), pk["sx3"].data_ptr(),
            pk["sx_out"].data_ptr(), ybf.data_ptr(), yq.data_ptr(),
            tq.data_ptr(), B, S, C, n_blocks, _slope_in(leaky_slope, ACT_DTYPE),
            code, _lib.stream_ptr(x.device))
    _lib.check(rc, "res_stage")
    fused_res_stage.launches += 1
    return yq, ybf


def fused_res_stage(x_flat, pk, S: int, n_blocks: int, leaky_slope: float):
    """x_flat (B·(S+2)², C) bf16, zero-bordered (:func:`res_stage_pre`) →
    (yq int8, ybf bf16), both (B·(S+2)², C) and zero-bordered: the stage
    output quantized with the next conv's input scale, and the bf16 stage
    output. Kernel K5 for a CUDA tensor, :func:`_res_stage_plain` for a CPU
    one. ``pk``: :func:`pack_res_stage`'s bundle."""
    if x_flat.is_cuda:
        return _cuda_res_stage(x_flat, pk, S, n_blocks, leaky_slope)
    return _res_stage_plain(x_flat, pk, S, n_blocks, leaky_slope)


fused_res_stage.launches = 0
