"""``tail_conv``: RektNet's int8 ``res4.conv1`` (3×3, dilation 2, padding
2) with its relu, as one kernel — counterpart of the JAX repository's probe
``tools/probe_tail_conv1.py:tail_conv1``.

:func:`tail_conv` launches ``csrc/tail_conv.cu`` for a CUDA tensor and
takes its plain version, ``F.relu(_qconv(h, q))`` — the very code
``Int8RektNet`` runs for ``res4.conv1`` — for a CPU one; there is no
fallback from one to the other. Input and output are NHWC; the probe's
pair-layout slab is only its TPU layout (``probes/tail_conv1.py`` maps it).
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


def tail_conv_plain(h, q: QConv):
    """Plain version: quantize with ``q.sx_inv``, the int8 conv as im2col +
    ``torch._int_mm``, ``acc·scale`` then ``+b`` in f32, bf16, relu."""
    return F.relu(_qconv(h, q))


def _check(h, q: QConv):
    C, H, W, cin = h.shape
    k = q.wmat.shape[0]
    if (q.kh, q.kw, q.stride) != (3, 3, 1) or q.padding != q.dilation:
        raise ValueError("tail_conv takes a 3×3 stride-1 conv whose padding "
                         f"equals its dilation, got {q.kh}×{q.kw} stride "
                         f"{q.stride} padding {q.padding} dilation {q.dilation}")
    if cin % 32 or k != 9 * cin:
        raise ValueError(f"input channels must be a multiple of 32 matching "
                         f"the weights' K={k}, got {cin}")
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
    # QConv keeps the column-major (K, N) matrix _int_mm takes, zero-padded
    # to multiples of 8: its transpose is the row-major (N, K) the kernel reads
    w_nk = q.wmat.t()[:n]
    if not w_nk.is_contiguous():
        w_nk = w_nk.contiguous()
    scale, bias = q.scale.contiguous(), q.b.contiguous()
    sx_inv = q.sx_inv.reshape(1).contiguous()
    out = torch.empty((C, H, W, n), dtype=torch.bfloat16, device=h.device)
    with torch.cuda.device(h.device):
        rc = _lib.lib().mdcv_tail_conv(
            x.data_ptr(), w_nk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            sx_inv.data_ptr(), out.data_ptr(), C, H, W, cin, n, q.dilation,
            _lib.dtype_code(x.dtype), _lib.stream_ptr(h.device))
    _lib.check(rc, "tail_conv")
    tail_conv.launches += 1
    return out


tail_conv.launches = 0
