"""The port's ONNX export (``export/``, ``cli/yolo2onnx.py``,
``cli/pt_to_onnx.py`` and the export hooks of both training loops)
against the JAX package on the CPU.

Tolerances. Files: byte-equal to the JAX package's on the same weights
(its ``init_params`` / ``rektnet.init`` at a fixed key, carried into the
port by ``convert.from_jax``), and the parsed models equal field for
field. Numbers: the port's numpy evaluator (``onnx_eval.run_model``) on an
exported graph against the port's torch forward in eval mode, rtol = atol
= 1e-4, as ``tests/test_onnx_export.py`` holds the JAX package's (the two
sum each convolution in another order); one initializer transposed in
space must fail that comparison.
"""

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.cli import pt_to_onnx as jcli_pt
from mit_driverless_cv_traininginfra_tpu.cli import yolo2onnx as jcli_yolo
from mit_driverless_cv_traininginfra_tpu.export import onnx_writer as jox
from mit_driverless_cv_traininginfra_tpu.export.pt_to_onnx import (
    export_rektnet_onnx as jexport_rektnet,
)
from mit_driverless_cv_traininginfra_tpu.export.yolo2onnx import (
    export_yolo_onnx as jexport_yolo,
)
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.cli import pt_to_onnx, yolo2onnx
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.export import onnx_writer as ox
from mit_driverless_cv_traininginfra_tpu_torch.export.onnx_eval import run_model
from mit_driverless_cv_traininginfra_tpu_torch.export.pt_to_onnx import export_rektnet_onnx
from mit_driverless_cv_traininginfra_tpu_torch.export.yolo2onnx import export_yolo_onnx
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, rektnet
from mit_driverless_cv_traininginfra_tpu_torch.train import optim, rektnet_driver, yolo_driver
from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import save_rektnet_pt

from _torch_port import TINY_CFG, tiny_port_spec, tiny_spec

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_yolo_trees(seed=0):
    return _np(jdarknet.init_params(tiny_spec(), jax.random.PRNGKey(seed)))


def _jax_rektnet_trees(seed=1):
    return _np(jrektnet.init(jax.random.PRNGKey(seed)))  # net_size 16


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_yolo_export_bytes_equal_to_jax(tmp_path):
    jp, js = _jax_yolo_trees()
    jexport_yolo(tiny_spec(), jp, js, str(tmp_path / "jax.onnx"))
    export_yolo_onnx(tiny_port_spec(), convert.from_jax(jp), convert.from_jax(js),
                     str(tmp_path / "port.onnx"))
    want = _bytes(tmp_path / "jax.onnx")
    assert _bytes(tmp_path / "port.onnx") == want
    ops = {n["op_type"] for n in ox.parse_model(want)["nodes"]}
    # every block family of the tiny cfg, the zero Pad of its 2×2/1 pool too
    assert {"Conv", "BatchNormalization", "LeakyRelu", "Add", "Concat", "Upsample",
            "MaxPool", "Pad"} <= ops


def test_rektnet_export_bytes_equal_to_jax(tmp_path):
    jp, js = _jax_rektnet_trees()
    jexport_rektnet(jp, js, str(tmp_path / "jax.onnx"))
    export_rektnet_onnx(convert.from_jax(jp), convert.from_jax(js),
                        str(tmp_path / "port.onnx"))
    assert _bytes(tmp_path / "port.onnx") == _bytes(tmp_path / "jax.onnx")


def _same_parse(a, b):
    assert set(a) == set(b)
    for key in a:
        if key == "initializers":
            assert list(a[key]) == list(b[key])
            for name in a[key]:
                assert a[key][name].dtype == b[key][name].dtype
                np.testing.assert_array_equal(a[key][name], b[key][name])
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("family", ["yolo", "rektnet"])
def test_parser_round_trip_equals_jax(tmp_path, family):
    path = str(tmp_path / "m.onnx")
    if family == "yolo":
        export_yolo_onnx(tiny_port_spec(), *map(convert.from_jax, _jax_yolo_trees(2)), path)
    else:
        export_rektnet_onnx(*map(convert.from_jax, _jax_rektnet_trees(3)), path)
    data = _bytes(path)
    _same_parse(ox.parse_model(data), jox.parse_model(data))
    # the tensors' raw bytes come back as written
    parsed = ox.parse_model(data)
    for name, arr in parsed["initializers"].items():
        assert arr.dtype in (np.float32, np.int64), name


def _yolo_case(seed):
    """The tiny cfg with BN statistics away from (0, 1) (a seeded numpy
    init), its ONNX graph parsed, and a 1×3×onnx_height×width input."""
    spec = tiny_port_spec()
    params, state = map(convert.from_jax, convert.init_darknet_np(
        spec, np.random.default_rng(seed)))
    model = darknet.TrainDarknet(spec, params, state).eval()
    x = np.random.default_rng(seed + 1).uniform(
        0, 1, (1, 3, spec.net.onnx_height, spec.net.width)).astype(np.float32)
    with torch.no_grad():
        heads = model.forward_features(torch.from_numpy(x).permute(0, 2, 3, 1))
    return spec, model, x, [h.permute(0, 3, 1, 2).numpy() for h in heads]


def test_yolo_onnx_eval_matches_the_torch_forward(tmp_path):
    spec, model, x, want = _yolo_case(4)
    path = export_yolo_onnx(spec, *model.trees(), str(tmp_path / "y.onnx"))
    got = run_model(ox.parse_model(_bytes(path)), {"000_net": x})
    assert len(got) == len(want) == 2
    for (name, out), ref in zip(got.items(), want):
        assert out.shape == ref.shape, name
        np.testing.assert_allclose(out, ref, **TOL)


def test_yolo_onnx_eval_catches_a_transposed_weight(tmp_path):
    spec, model, x, want = _yolo_case(5)
    parsed = ox.parse_model(_bytes(export_yolo_onnx(spec, *model.trees(),
                                                    str(tmp_path / "y.onnx"))))
    w0 = parsed["initializers"]["001_conv_weights"]
    parsed["initializers"]["001_conv_weights"] = np.ascontiguousarray(w0.transpose(0, 1, 3, 2))
    got = list(run_model(parsed, {"000_net": x}).values())
    assert not np.allclose(got[0], want[0], **TOL)


def test_rektnet_onnx_eval_matches_the_torch_forward(tmp_path):
    model = rektnet.KeypointNet(*map(convert.from_jax, convert.init_rektnet_np(
        np.random.default_rng(6), net_size=16))).eval()
    x = np.random.default_rng(7).uniform(0, 1, (2, 3, 80, 80)).astype(np.float32)
    path = export_rektnet_onnx(*model.trees(), str(tmp_path / "r.onnx"), batch=2)
    parsed = ox.parse_model(_bytes(path))
    got = run_model(parsed, {"input": x})["out"]
    with torch.no_grad():
        want = model.logits(torch.from_numpy(x).permute(0, 2, 3, 1)).numpy()
    assert got.shape == (2, 7, 80, 80)
    np.testing.assert_allclose(got, want, **TOL)
    # and the forward's own outputs from those logits: probs and points
    with torch.no_grad():
        probs, pts = model(torch.from_numpy(x).permute(0, 2, 3, 1))
        p_onnx, pts_onnx = rektnet.soft_argmax_2d(torch.from_numpy(got))[::-1]
    np.testing.assert_allclose(p_onnx.numpy(), probs.numpy(), **TOL)
    np.testing.assert_allclose(pts_onnx.numpy(), pts.numpy(), **TOL)
    # a dilation-1 conv1 (the wrong padding for its 3×3) fails
    parsed["nodes"] = [dict(n, attrs=dict(n["attrs"], dilations=[1, 1], pads=[1] * 4))
                       if n["name"] == "res2_conv1" else n for n in parsed["nodes"]]
    assert not np.allclose(run_model(parsed, {"input": x})["out"], want, **TOL)


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        fn(*a, **k)
    return out.getvalue()


def test_train_rektnet_writes_the_best_model_as_onnx(tmp_path):
    """One epoch is the best epoch: its ONNX file is the exporter's on the
    weights the loop ends with."""
    rng = np.random.default_rng(8)

    def batches(n):
        out = []
        for _ in range(n):
            crops, pts = synthetic.rektnet_batch(rng, 4)
            out.append((crops, np.zeros((4, 7, 1, 1), np.float32), pts, ["c"] * 4,
                        [(80, 80, 3)] * 4))
        return out

    model = rektnet.KeypointNet(*map(convert.from_jax, convert.init_rektnet_np(
        np.random.default_rng(9), net_size=16)))
    opt = optim.make_optimizer(model.parameters(), "Adam", lr=1e-3)
    out = tmp_path / "out"
    text = _quiet(rektnet_driver.train_rektnet, model, opt, batches(2), batches(1),
                  device="cpu", output_path=str(out), num_epochs=1, device_targets=True,
                  log_dir=str(tmp_path / "logs"))
    path = out / "best_keypoints_8080.onnx"
    assert f"Saving ONNX model to {path}" in text
    assert "skipping export" not in text
    export_rektnet_onnx(*model.trees(), str(tmp_path / "want.onnx"))
    assert _bytes(path) == _bytes(tmp_path / "want.onnx")


def test_train_yolo_writes_onnx_at_the_early_stop(tmp_path):
    """``val_tolerance=0`` stops at the first check, as the JAX loop does
    (within ``min_epochs`` a check counts as a decrease, whatever its
    loss): the file is ``onnx_name(cfg)`` under the output path, the
    exporter's on the weights the loop ends with."""
    spec = tiny_port_spec()
    model = darknet.TrainDarknet(spec, *darknet.init_params(spec, torch.Generator().manual_seed(0)))
    opt = optim.make_optimizer(model.parameters(), "Adam", lr=1e-3)
    rng = np.random.default_rng(3)
    batches = []
    for k in range(2):
        imgs, targets = synthetic.yolo_batch(rng, 2, 64, min_h=8, max_h=30)
        batches.append(([f"s{k}_{i}" for i in range(2)], imgs, targets))
    out = tmp_path / "out"
    text = _quiet(yolo_driver.train_yolo, model, opt, batches[:1], batches[1:], device="cpu",
                  output_path=str(out), log_dir=str(tmp_path / "logs"), num_epochs=5,
                  val_tolerance=0, min_epochs=3, model_cfg=TINY_CFG)
    assert "creating onnx file" in text and "skipping export" not in text
    assert "Completed epoch:  2" not in text  # it stopped after epoch 1
    name = spec.net.onnx_name(TINY_CFG)
    assert name == f"tiny_test_{spec.net.width}{spec.net.onnx_height}.onnx"
    export_yolo_onnx(spec, *model.trees(), str(tmp_path / "want.onnx"))
    assert _bytes(out / name) == _bytes(tmp_path / "want.onnx")


def test_yolo2onnx_cli_bytes_equal_to_jax(tmp_path):
    spec = tiny_port_spec()
    params, state = darknet.init_params(spec, torch.Generator().manual_seed(4))
    weights = str(tmp_path / "w.weights")
    darknet.save_darknet_weights(spec, params, state, weights)
    outs = {}
    for name, main in (("jax", jcli_yolo.main), ("port", yolo2onnx.main)):
        outs[name] = str(tmp_path / f"{name}.onnx")
        text = _quiet(main, ["--cfg_name", TINY_CFG, "--weights_name", weights,
                             "--output", outs[name]])
        assert text.strip() == f"wrote {outs[name]}"
    assert _bytes(outs["port"]) == _bytes(outs["jax"])
    # the default output name, in the working directory
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        _quiet(yolo2onnx.main, ["--cfg_name", TINY_CFG, "--weights_name", weights])
    finally:
        os.chdir(cwd)
    assert _bytes(tmp_path / spec.net.onnx_name(TINY_CFG)) == _bytes(outs["jax"])


def test_pt_to_onnx_cli_bytes_equal_to_jax(tmp_path):
    model = rektnet.KeypointNet(*rektnet.init(torch.Generator().manual_seed(5)))
    pt = str(tmp_path / "m.pt")
    save_rektnet_pt(pt, model, epoch=3)
    jout = str(tmp_path / "jax.onnx")
    _quiet(jcli_pt.main, ["--model_path", pt, "--output", jout])
    text = _quiet(pt_to_onnx.main, ["--model", pt])  # the default: <model>.onnx
    assert text.strip() == f"wrote {tmp_path / 'm.onnx'}"
    assert _bytes(tmp_path / "m.onnx") == _bytes(jout)
