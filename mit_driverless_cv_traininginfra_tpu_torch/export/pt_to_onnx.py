"""RektNet → ONNX export (the port's counterpart of the JAX package's
``export/pt_to_onnx.py``; reference ``pt_to_onnx.py`` and the best-model
export of ``train_eval.py``).

Writes the ``onnx_mode`` graph: raw heatmap logits, no softmax or
soft-argmax (those run on the TensorRT side), input (batch, 3, H, W) NCHW,
from the port's ``(params, state)`` trees (``KeypointNet.trees()`` or
``models/rektnet.load_torch_checkpoint``). Conv weights are OIHW in the
port and in ONNX, so they are written as they are, and the file is
byte-equal to the JAX package's on the same weights. BN momentum 0.9,
epsilon 1e-5; each residual block's ``conv1`` is the dilation-2 3×3 with
pad 2.
"""

from __future__ import annotations

from typing import List, Tuple

from mit_driverless_cv_traininginfra_tpu_torch.export import onnx_writer as ox
from mit_driverless_cv_traininginfra_tpu_torch.export.yolo2onnx import host_f32


def _conv(nodes, inits, name, src, p, pad, dilation=1):
    w = host_f32(p["w"])
    inits.append(ox.make_tensor(name + "_w", w))
    inits.append(ox.make_tensor(name + "_b", host_f32(p["b"])))
    k = w.shape[2]
    nodes.append(ox.make_node(
        "Conv", [src, name + "_w", name + "_b"], [name], name=name,
        kernel_shape=[k, k], strides=[1, 1], pads=[pad] * 4,
        dilations=[dilation, dilation],
    ))
    return name


def _bn(nodes, inits, name, src, bn_p, bn_s):
    for suffix, arr in [("_scale", bn_p["scale"]), ("_bias", bn_p["bias"]),
                        ("_mean", bn_s["mean"]), ("_var", bn_s["var"])]:
        inits.append(ox.make_tensor(name + suffix, host_f32(arr)))
    nodes.append(ox.make_node(
        "BatchNormalization",
        [src, name + "_scale", name + "_bias", name + "_mean", name + "_var"],
        [name], name=name, epsilon=1e-5, momentum=0.9,
    ))
    return name


def _relu(nodes, name, src):
    nodes.append(ox.make_node("Relu", [src], [name], name=name))
    return name


def export_rektnet_onnx(params, state, path: str,
                        input_size: Tuple[int, int] = (80, 80),
                        num_kpt: int = 7, batch: int = 1) -> str:
    """Write the RektNet of the ``(params, state)`` trees as an ONNX model
    at ``path``; returns ``path``."""
    nodes: List[bytes] = []
    inits: List[bytes] = []

    h = _conv(nodes, inits, "stem_conv", "input",
              {"w": params["stem"]["w"], "b": params["stem"]["b"]}, pad=3)
    h = _bn(nodes, inits, "stem_bn", h, params["stem"]["bn"], state["stem"])
    h = _relu(nodes, "stem_relu", h)

    for i in range(1, 5):
        p, s = params[f"res{i}"], state[f"res{i}"]
        c1 = _conv(nodes, inits, f"res{i}_conv1", h, p["conv1"], pad=2, dilation=2)
        b1 = _bn(nodes, inits, f"res{i}_bn1", c1, p["bn1"], s["bn1"])
        a1 = _relu(nodes, f"res{i}_relu1", b1)
        c2 = _conv(nodes, inits, f"res{i}_conv2", a1, p["conv2"], pad=1)
        b2 = _bn(nodes, inits, f"res{i}_bn2", c2, p["bn2"], s["bn2"])
        sc = _conv(nodes, inits, f"res{i}_shortcut_conv", h, p["shortcut_conv"], pad=0)
        sb = _bn(nodes, inits, f"res{i}_shortcut_bn", sc, p["shortcut_bn"],
                 s["shortcut_bn"])
        add = f"res{i}_add"
        nodes.append(ox.make_node("Add", [sb, b2], [add], name=add))
        h = _relu(nodes, f"res{i}_out", add)

    out = _conv(nodes, inits, "out", h, params["out"], pad=0)

    graph = ox.make_graph(
        "rektnet", nodes,
        inputs=[ox.make_value_info("input", [batch, 3, input_size[0], input_size[1]])],
        outputs=[ox.make_value_info(out, [batch, num_kpt, input_size[0], input_size[1]])],
        initializers=inits,
    )
    ox.save_model(path, ox.make_model(graph, opset=9))
    return path
