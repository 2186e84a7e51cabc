"""``tail_conv``: RektNet's int8 ``res4.conv1`` (3×3, dilation 2, padding
2) with its relu, as one kernel — counterpart of the JAX repository's probe
``tools/probe_tail_conv1.py:tail_conv1``.

:func:`tail_conv` launches ``csrc/tail_conv.cu`` for a CUDA tensor and
takes its plain version, ``F.relu(_qconv(h, q))`` — the very code
``Int8RektNet`` runs for ``res4.conv1`` — for a CPU one; there is no
fallback from one to the other. Input and output are NHWC; the probe's
pair-layout slab is only its TPU layout (``probes/tail_conv1.py`` maps it).
The kernel takes 80×80 crops, dilation 2, and Cin → N of 64 → 128 (the
served RektNet) or 32 → 64 (net_size 8); :func:`pack_tail_conv` lays its
weights out once per ``QConv`` as the kernel's tensor cores read them.
The kernel is not wired into ``Int8RektNet``: it runs behind the probe
tools and ``chip_smoke.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mit_driverless_cv_traininginfra_tpu_torch.models.quantize import (
    QConv,
    _qconv,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops import _lib
from mit_driverless_cv_traininginfra_tpu_torch.ops.entry import _pack_wgmma

SIZE, DILATION = 80, 2
WIDTHS = ((64, 128), (32, 64))  # the (Cin, N) the kernel is built for


def tail_conv_plain(h, q: QConv):
    """Plain version: quantize with ``q.sx_inv``, the int8 conv as im2col +
    ``torch._int_mm``, ``acc·scale`` then ``+b`` in f32, bf16, relu."""
    return F.relu(_qconv(h, q))


def pack_tail_conv(q: QConv):
    """``q``'s (9·Cin, N) weight matrix → the kernel's wgmma B tiles
    (9·Cin/32, N/32, 4, 2, 8, 16) int8 (``ops.entry._pack_wgmma``); 9·Cin
    is a multiple of 32, so ``q.wmat`` carries no K padding."""
    return _pack_wgmma(q.wmat[:, :q.out_channels])


def _packed(q: QConv):
    """:func:`pack_tail_conv` of ``q``, made once and kept on ``q`` while
    its weight matrix stays the same tensor, unchanged."""
    key = (id(q.wmat), q.wmat._version, q.wmat.device)
    cached = q.__dict__.get("_tail_conv_tiles")
    if cached is None or cached[0] != key:
        cached = (key, pack_tail_conv(q))
        q.__dict__["_tail_conv_tiles"] = cached
    return cached[1]


def _check(h, q: QConv):
    C, H, W, cin = h.shape
    k = q.wmat.shape[0]
    if ((q.kh, q.kw, q.stride) != (3, 3, 1) or q.padding != q.dilation
            or q.dilation != DILATION):
        raise ValueError("tail_conv takes a 3×3 stride-1 conv with padding "
                         f"and dilation {DILATION}, got {q.kh}×{q.kw} stride "
                         f"{q.stride} padding {q.padding} dilation {q.dilation}")
    if (cin, q.out_channels) not in WIDTHS or k != 9 * cin:
        raise ValueError(f"tail_conv takes Cin → N of {WIDTHS} with K = 9·Cin, "
                         f"got {cin} → {q.out_channels}, K={k}")
    if (H, W) != (SIZE, SIZE):
        raise ValueError(f"tail_conv takes {SIZE}×{SIZE} crops, got {H}×{W}")
    if h.dtype != torch.bfloat16:
        raise TypeError(f"tail_conv takes bf16 activations, got {h.dtype}")
    for name in ("wmat", "scale", "b", "sx_inv"):
        if getattr(q, name).device != h.device:
            raise ValueError(f"q.{name} is on {getattr(q, name).device}, "
                             f"h on {h.device}")


def tail_conv(h, q: QConv):
    """h (C, H, W, Cin) bf16 NHWC → relu(int8 conv) (C, H, W, N) bf16,
    value-equal to :func:`tail_conv_plain`. CUDA kernel for a CUDA tensor,
    the plain version for a CPU one."""
    if not h.is_cuda:
        return tail_conv_plain(h, q)
    _check(h, q)
    C, H, W, cin = h.shape
    n = q.out_channels
    x = h.contiguous()
    wtiles = _packed(q)
    scale, bias = q.scale.contiguous(), q.b.contiguous()
    sx_inv = q.sx_inv.reshape(1).contiguous()
    out = torch.empty((C, H, W, n), dtype=torch.bfloat16, device=h.device)
    with _lib.on_device(h.device):
        rc = _lib.lib().mdcv_tail_conv(
            x.data_ptr(), wtiles.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            sx_inv.data_ptr(), out.data_ptr(), C, H, W, cin, n, q.dilation,
            _lib.dtype_code(x.dtype), _lib.stream_ptr(h.device))
    _lib.check(rc, "tail_conv")
    tail_conv.launches += 1
    return out


tail_conv.launches = 0
