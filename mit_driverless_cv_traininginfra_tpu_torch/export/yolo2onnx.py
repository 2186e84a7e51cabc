"""YOLO → ONNX export (the port's counterpart of the JAX package's
``export/yolo2onnx.py``; reference ``yolo2onnx.py``).

Walks the :class:`NetworkSpec` emitting Conv / BatchNormalization /
LeakyRelu / Add / Concat / Upsample / MaxPool nodes on NCHW tensors from
the port's ``(params, state)`` trees: ``TrainDarknet.trees()``, or those of
``init_params`` / ``load_darknet_weights``. The port keeps conv weights
OIHW, which is ONNX's layout, so they are written as they are, and the
file is byte-equal to the JAX package's on the same weights. As the
reference exporter does:

- the outputs are the raw pre-yolo maps (the anchor decode runs on the
  TensorRT side);
- batch 1 at ``onnx_height`` × the cfg's width;
- a 2×2 stride-1 max-pool gets an explicit zero ``Pad`` in front (the
  trained graph zero-pads before it; ONNX MaxPool pads with −inf);
- a route with one source emits no node;
- BN epsilon 1e-5, momentum 0.99, LeakyRelu ``alpha`` the cfg's slope,
  opset 9 (Upsample with scales).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    ConvBlock,
    MaxPoolBlock,
    NetworkSpec,
    RouteBlock,
    ShortcutBlock,
    UpsampleBlock,
    YoloBlock,
)
from mit_driverless_cv_traininginfra_tpu_torch.export import onnx_writer as ox


def host_f32(t) -> np.ndarray:
    """A tensor (any device) or array → an f32 numpy array on the host."""
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def export_yolo_onnx(spec: NetworkSpec, params, state, path: str, batch: int = 1,
                     height: Optional[int] = None, width: Optional[int] = None) -> str:
    """Write ``spec`` with the ``(params, state)`` trees (OIHW conv
    weights) as an ONNX model at ``path``; returns ``path``."""
    height = height or spec.net.onnx_height
    width = width or spec.net.width

    nodes: List[bytes] = []
    inits: List[bytes] = []
    outputs: List[bytes] = []

    input_name = "000_net"
    tensor_of: List[str] = []  # output tensor name per block
    prev = input_name
    cur_h, cur_w = height, width
    shapes: List = []

    for i, b in enumerate(spec.blocks):
        name = f"{i + 1:03d}_{type(b).__name__.replace('Block', '').lower()}"
        if isinstance(b, ConvBlock):
            p = params[str(i)]
            wname = name + "_weights"
            inits.append(ox.make_tensor(wname, host_f32(p["w"])))
            conv_inputs = [prev, wname]
            conv_out = name + ("_conv" if b.batch_normalize else "")
            if not b.batch_normalize:
                bname = name + "_bias"
                inits.append(ox.make_tensor(bname, host_f32(p["b"])))
                conv_inputs.append(bname)
            pad = (b.size - 1) // 2
            nodes.append(ox.make_node(
                "Conv", conv_inputs, [conv_out], name=name,
                kernel_shape=[b.size, b.size], strides=[b.stride, b.stride],
                pads=[pad, pad, pad, pad], dilations=[1, 1],
            ))
            out = conv_out
            if b.batch_normalize:
                s = state[str(i)]
                bn = p["bn"]
                for suffix, arr in [("_bn_scale", bn["scale"]), ("_bn_bias", bn["bias"]),
                                    ("_bn_mean", s["mean"]), ("_bn_var", s["var"])]:
                    inits.append(ox.make_tensor(name + suffix, host_f32(arr)))
                bn_out = name + "_bn"
                nodes.append(ox.make_node(
                    "BatchNormalization",
                    [out, name + "_bn_scale", name + "_bn_bias",
                     name + "_bn_mean", name + "_bn_var"],
                    [bn_out], name=name + "_bn", epsilon=1e-5, momentum=0.99,
                ))
                out = bn_out
            if b.activation == "leaky":
                act_out = name + "_lrelu"
                nodes.append(ox.make_node("LeakyRelu", [out], [act_out],
                                          name=name + "_lrelu",
                                          alpha=spec.net.leaky_slope))
                out = act_out
            elif b.activation == "ReLU":
                act_out = name + "_relu"
                nodes.append(ox.make_node("Relu", [out], [act_out],
                                          name=name + "_relu"))
                out = act_out
            cur_h, cur_w = cur_h // b.stride, cur_w // b.stride
        elif isinstance(b, MaxPoolBlock):
            out = name
            pad = (b.size - 1) // 2
            if b.size == 2 and b.stride == 1:
                # the trained graph zero-pads right and bottom before this
                # pool (models/darknet._maxpool); ONNX MaxPool pads with
                # −inf, so a constant-0 Pad keeps the edges the same
                pad_out = name + "_zeropad"
                nodes.append(ox.make_node(
                    "Pad", [prev], [pad_out], name=pad_out, mode="constant",
                    pads=[0, 0, 0, 0, 0, 0, 1, 1], value=0.0))
                nodes.append(ox.make_node("MaxPool", [pad_out], [out],
                                          name=name, kernel_shape=[2, 2],
                                          strides=[1, 1], pads=[0, 0, 0, 0]))
            else:
                nodes.append(ox.make_node("MaxPool", [prev], [out], name=name,
                                          kernel_shape=[b.size, b.size],
                                          strides=[b.stride, b.stride],
                                          pads=[pad, pad, pad, pad]))
            cur_h, cur_w = cur_h // b.stride, cur_w // b.stride
        elif isinstance(b, UpsampleBlock):
            out = name
            sname = name + "_scales"
            inits.append(ox.make_tensor(
                sname, np.asarray([1.0, 1.0, float(b.stride), float(b.stride)],
                                  np.float32)))
            nodes.append(ox.make_node("Upsample", [prev, sname], [out],
                                      name=name, mode="nearest"))
            cur_h, cur_w = cur_h * b.stride, cur_w * b.stride
        elif isinstance(b, RouteBlock):
            srcs = [tensor_of[li] for li in b.layers]
            if len(srcs) == 1:
                out = srcs[0]  # a pure re-route: no node
            else:
                out = name
                nodes.append(ox.make_node("Concat", srcs, [out], name=name, axis=1))
            cur_h, cur_w = shapes[b.layers[0]]
        elif isinstance(b, ShortcutBlock):
            out = name
            nodes.append(ox.make_node("Add", [tensor_of[-1], tensor_of[b.from_layer]],
                                      [out], name=name))
        elif isinstance(b, YoloBlock):
            out = prev  # the head's output is the previous conv's raw map
            outputs.append(ox.make_value_info(
                out, [batch, (spec.net.num_classes + 5) * len(b.mask),
                      cur_h, cur_w]))
        tensor_of.append(out)
        shapes.append((cur_h, cur_w))
        prev = out

    graph = ox.make_graph(
        "yolo", nodes,
        inputs=[ox.make_value_info(input_name,
                                   [batch, spec.net.channels, height, width])],
        outputs=outputs, initializers=inits,
    )
    ox.save_model(path, ox.make_model(graph, opset=9))
    return path
