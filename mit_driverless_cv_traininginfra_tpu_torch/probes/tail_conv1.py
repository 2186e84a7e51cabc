"""The tail-conv probe (counterpart of the JAX repository's
``tools/probe_tail_conv1.py``): RektNet's int8 ``res4.conv1`` at the served
width — bf16 (C, 80, 80, 64) → 3×3, dilation 2, padding 2, 64 → 128 → relu
— on the probe's seeded inputs.

- :func:`probe_inputs` draws the probe's arrays with numpy
  (``default_rng(0)``, in its draw order: ``h``, ``w``, ``bias``) and builds
  ``wim`` (576, 128) int8, ``scale`` and ``bias`` (1, 128) f32 and
  ``sx_inv`` (1, 1) f32 as the probe does.
- :func:`qconv_from_probe` carries those arrays into the port's ``QConv``
  (the module ``Int8RektNet`` runs).
- The probe's TPU kernel writes a flat "pair" slab (C, 3358, 256): row
  pitch P = 42 pairs, first interior position OFF = 85, pixel (r, 2p+q) at
  ``slab[(r+2)·42 + p+1 − 85, 128q : 128q+128]``; :func:`nhwc_from_slab`
  reads NHWC out of it (positions outside the interior are junk). Its input
  ``h.reshape(C, 3200, 128)`` is the NHWC array itself, reshaped.
"""

from __future__ import annotations

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.models.quantize import QConv
from mit_driverless_cv_traininginfra_tpu_torch.probes.base import Probe

SIZE, CIN, COUT = 80, 64, 128
P, OFF = 42, 2 * 42 + 1                 # pair pitch, first interior position
NSLAB = (81 * P + 40) - OFF + 1         # 3358
SX = 2.0                                # the probe's activation range


def probe_inputs(C: int = 512, device="cpu"):
    """The probe's inputs at C crops: ``{"h": (C, 80, 80, 64) bf16, "wim",
    "scale", "bias", "sx_inv"}`` on ``device``, drawn as the probe draws
    them (so its weights depend on C, as the probe's would)."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((C, SIZE, SIZE, CIN)) * 0.5
    w = rng.standard_normal((3, 3, CIN, COUT)).astype(np.float32) * 0.1
    s_w = np.maximum(np.abs(w).max(axis=(0, 1, 2)) / 127.0, 1e-12)
    wq = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
    scale = ((SX / 127.0) * s_w).astype(np.float32).reshape(1, COUT)
    bias = (rng.standard_normal(COUT) * 0.1).astype(np.float32).reshape(1, COUT)
    sx_inv = np.asarray([[127.0 / SX]], np.float32)
    h_t = torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16)
    del h
    return {"h": h_t.to(device),
            "wim": torch.from_numpy(wq.reshape(9 * CIN, COUT)).to(device),
            "scale": torch.from_numpy(scale).to(device),
            "bias": torch.from_numpy(bias).to(device),
            "sx_inv": torch.from_numpy(sx_inv).to(device)}


def qconv_from_probe(wim, scale, bias, sx_inv) -> QConv:
    """The probe's arrays → the port's ``QConv`` (padding 2, dilation 2):
    ``wim`` row k = (dy·3 + dx)·Cin + c is the HWIO weight flattened, so
    ``wq`` OIHW is its reshape and permute; ``QConv`` lays it out again as
    the same (K, N) matrix."""
    k, n = wim.shape
    cin = k // 9
    wq = wim.reshape(3, 3, cin, n).permute(3, 2, 0, 1).contiguous()
    return QConv({"wq": wq, "scale": scale.reshape(n), "b": bias.reshape(n),
                  "sx_inv": sx_inv.reshape(())}, padding=2, dilation=2)


def nhwc_from_slab(slab):
    """The probe's (C, NSLAB, 256) output slab → (C, 80, 80, 128) NHWC."""
    C = slab.shape[0]
    r = torch.arange(SIZE)[:, None]
    p = torch.arange(SIZE // 2)[None, :]
    pos = (r + 2) * P + p + 1 - OFF                       # (80, 40)
    pairs = slab[:, pos.reshape(-1)]                      # (C, 3200, 256)
    return pairs.reshape(C, SIZE, SIZE // 2, 2, COUT).reshape(C, SIZE, SIZE, COUT)


def _build(device, small=False):
    inp = probe_inputs(2 if small else 512, device)
    q = qconv_from_probe(inp["wim"], inp["scale"], inp["bias"], inp["sx_inv"])
    return {"h": inp["h"], "q": q.to(device)}


def tail_work(inp, out):
    """Bytes: h, the weights, the output; operations: 2·M·N·K int8."""
    h, q = inp["h"], inp["q"]
    M, K = h.numel() // h.shape[-1], 9 * h.shape[-1]
    return (h.numel() * h.element_size() + K * q.out_channels
            + out.numel() * out.element_size(), 2 * M * q.out_channels * K, "int8")


PROBE = Probe("tail", "tools/probe_tail_conv1.py:64", "tail_conv", _build,
              lambda inp, ops: ops.tail_conv(inp["h"], inp["q"]), tail_work,
              rule="values")
