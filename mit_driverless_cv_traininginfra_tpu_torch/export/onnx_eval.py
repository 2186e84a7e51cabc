"""Numpy evaluator for the exported ONNX op subset (the port's copy of the
JAX package's ``export/onnx_eval.py``).

The exports exist to be executed (TensorRT consumes them on the car), so
their numbers are their purpose. There is no ONNX runtime here, but the
emitted subset (Conv / BatchNormalization / LeakyRelu / Relu / Add /
Concat / Upsample / MaxPool / Pad) is small and unambiguous, so this
module runs a graph parsed by :func:`onnx_writer.parse_model` in numpy,
on the host. It is the port's check that an exported graph computes what
the torch forward computes: a transposed weight, a wrong pad or a bad
attribute, which the structure alone does not show, fails the comparison.

All tensors are NCHW, float32 (the exporters emit nothing else).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _conv(x, w, b, strides, pads, dilations):
    """ONNX Conv: x (N,C,H,W), w (O,I,kh,kw), pads [top,left,bottom,right]."""
    n, c, h, wd = x.shape
    o, i, kh, kw = w.shape
    assert i == c, f"Conv channel mismatch: input {c}, weight expects {i}"
    pt, pl, pb, pr = pads
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    sh, sw = strides
    dh, dw = dilations
    ho = (h + pt + pb - (dh * (kh - 1) + 1)) // sh + 1
    wo = (wd + pl + pr - (dw * (kw - 1) + 1)) // sw + 1
    cols = np.empty((n, c, kh, kw, ho, wo), x.dtype)
    for a in range(kh):
        for bb in range(kw):
            cols[:, :, a, bb] = xp[:, :, a * dh:a * dh + sh * ho:sh,
                                   bb * dw:bb * dw + sw * wo:sw]
    out = np.einsum("ncabhw,ocab->nohw", cols, w, optimize=True)
    if b is not None:
        out = out + b[None, :, None, None]
    return out.astype(np.float32)


def _maxpool(x, kernel, strides, pads):
    """ONNX MaxPool pads with -inf (the exporter emits an explicit zero
    Pad node where the trained graph zero-pads, darknet._maxpool)."""
    pt, pl, pb, pr = pads
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)),
                constant_values=-np.inf)
    kh, kw = kernel
    sh, sw = strides
    n, c, h, w = xp.shape
    ho = (h - kh) // sh + 1
    wo = (w - kw) // sw + 1
    out = np.full((n, c, ho, wo), -np.inf, x.dtype)
    for a in range(kh):
        for b in range(kw):
            out = np.maximum(out, xp[:, :, a:a + sh * ho:sh,
                                     b:b + sw * wo:sw])
    return out


def _pad(x, pads, value):
    """ONNX Pad (opset 9 attribute form): pads = begins then ends, one per
    dim (8 values for NCHW)."""
    nd = x.ndim
    assert len(pads) == 2 * nd, f"Pad expects {2 * nd} values, got {pads}"
    width = [(int(pads[d]), int(pads[nd + d])) for d in range(nd)]
    return np.pad(x, width, constant_values=np.float32(value))


def run_model(parsed: dict, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Execute a parsed model on named inputs; returns {output_name: array}.

    ``parsed`` is :func:`onnx_writer.parse_model` output. Unsupported op
    types raise — the evaluator exists to certify the exporters' emitted
    subset, not to be a general runtime.
    """
    t: Dict[str, np.ndarray] = {k: np.asarray(v, np.float32)
                                for k, v in parsed["initializers"].items()}
    for name, arr in inputs.items():
        t[name] = np.asarray(arr, np.float32)

    for node in parsed["nodes"]:
        op = node["op_type"]
        a = node["attrs"]
        x = [t[i] for i in node["inputs"]]
        if op == "Conv":
            out = _conv(x[0], x[1], x[2] if len(x) > 2 else None,
                        a["strides"], a["pads"], a.get("dilations", [1, 1]))
        elif op == "BatchNormalization":
            xx, scale, bias, mean, var = x
            eps = np.float32(a.get("epsilon", 1e-5))
            inv = scale / np.sqrt(var + eps)
            out = (xx - mean[None, :, None, None]) * inv[None, :, None, None] \
                + bias[None, :, None, None]
        elif op == "LeakyRelu":
            alpha = np.float32(a.get("alpha", 0.01))
            out = np.where(x[0] >= 0, x[0], x[0] * alpha)
        elif op == "Relu":
            out = np.maximum(x[0], 0)
        elif op == "Add":
            out = x[0] + x[1]
        elif op == "Concat":
            out = np.concatenate(x, axis=a["axis"])
        elif op == "Upsample":
            scales = np.asarray(x[1]).ravel()
            assert scales[0] == scales[1] == 1.0, f"Upsample scales {scales}"
            fh, fw = int(scales[2]), int(scales[3])
            assert fh == scales[2] and fw == scales[3], "fractional upsample"
            out = x[0].repeat(fh, axis=2).repeat(fw, axis=3)
        elif op == "MaxPool":
            out = _maxpool(x[0], a["kernel_shape"], a["strides"], a["pads"])
        elif op == "Pad":
            assert a.get("mode", "constant") == "constant"
            out = _pad(x[0], a["pads"], a.get("value", 0.0))
        else:
            raise NotImplementedError(f"op {op} not in the exported subset")
        t[node["outputs"][0]] = out.astype(np.float32)

    return {o["name"]: t[o["name"]] for o in parsed["outputs"]}
