"""The port's evaluation entry points against the JAX package's on the
CPU, at ``tests/fixtures/tiny_test.cfg`` (64², two heads) from one
``.weights`` file: ``cli/pipeline.py``, ``cli/yolo_detect.py`` and
``cli/yolo_validate.py`` on rendered cone scenes, and the tools
``tools/eval_weights.py`` and ``tools/eval_rektnet_weights.py`` against
the repository's root tools.

Tolerances. Masks and box counts equal, boxes within 1e-3 px (the f32
forwards sum in other orders); the pipeline's keypoints within 1e-4 px
and its scores within 1e-6 in model space (measured 5.7e-6 px and
1.2e-7); the confidence threshold is set in a gap between neighbouring
confidences, so a 1-ulp difference cannot move a box across it. The validation's mAP, recall and precision equal. The
tools' f32 numbers within 1e-5; the port's RektNet tool calibrates int8
on BGR training crops from disk when given ``--csv`` (the repository's
tool calibrates on synthetic RGB crops, which its test here fails).
"""

import contextlib
import importlib.util
import io
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.cli import pipeline as jpipeline_cli
from mit_driverless_cv_traininginfra_tpu.cli import yolo_detect as jdetect_cli
from mit_driverless_cv_traininginfra_tpu.cli import yolo_validate as jvalidate_cli
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu_torch.cli import pipeline, yolo_detect, yolo_validate
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import load_network_spec
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.data.decode import read_rgb
from mit_driverless_cv_traininginfra_tpu_torch.data.rektnet_data import (
    ConeDataset,
    load_train_csv_dataset,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer.detect import load_detector
from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet
from mit_driverless_cv_traininginfra_tpu_torch.models.quantize import calibrate_rektnet
from mit_driverless_cv_traininginfra_tpu_torch.ops.image import letterbox
from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import save_rektnet_pt

from _torch_port import TINY_CFG, gap_threshold, tiny_spec, write_cone_dataset

REPO = Path(__file__).resolve().parents[1]
PORT_TOOLS = REPO / "mit_driverless_cv_traininginfra_tpu_torch" / "tools"


def load_tool(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(fn, *a, **k):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*a, **k)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Scenes on disk with their CSV, a tiny cfg that validates on them at
    a gap-picked threshold, a ``.weights`` of the JAX package's seeded init
    with its confidence columns raised (so boxes pass), and a RektNet
    ``.pt``. Returns ``(dir, cfg path, threshold)``."""
    d = tmp_path_factory.mktemp("eval")
    csv_path = write_cone_dataset(d, np.random.default_rng(2), [(96, 144)], per_size=3,
                                  tile=48)
    spec = tiny_spec()
    params, state = jdarknet.init_params(spec, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    for i, b in enumerate(spec.blocks):
        if getattr(b, "is_preyolo", False):
            bias = np.array(params[str(i)]["b"])
            bias[4::6] += 3.0  # each anchor's objectness logit
            params[str(i)]["b"] = bias
    jdarknet.save_darknet_weights(spec, params, state, str(d / "y.weights"))
    save_rektnet_pt(str(d / "r.pt"), rektnet.KeypointNet(
        *rektnet.init(torch.Generator().manual_seed(1))))
    # a threshold in a gap of the port's confidences on the first scene
    pspec, yolo = load_detector(load_network_spec(TINY_CFG), str(d / "y.weights"))
    frame = torch.from_numpy(read_rgb(str(d / "scene_000.png"))).float() / 255
    conf = yolo.detections(letterbox(frame[None], 64, 64)[0], with_classes=False)[..., 4]
    thresh = gap_threshold(conf.detach().numpy(), 5)
    text = open(TINY_CFG).read().replace("validate_uri=\n", f"validate_uri={csv_path}\n")
    text = text.replace("conf_thresh=0.8", f"conf_thresh={thresh!r}")
    (d / "tiny.cfg").write_text(text)
    return d, str(d / "tiny.cfg"), thresh


def _capture(monkeypatch, module, name, store):
    real = getattr(module, name)

    def wrapped(*a, **k):
        out = real(*a, **k)
        store.append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)


def test_pipeline_cli_equals_jax(scenes, tmp_path, monkeypatch):
    import mit_driverless_cv_traininginfra_tpu.infer.detect as jd
    import mit_driverless_cv_traininginfra_tpu.infer.pipeline as jp
    import mit_driverless_cv_traininginfra_tpu_torch.infer.detect as pd
    import mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline as pp

    d, cfg, thresh = scenes
    got = {"out": [], "boxes": []}
    want = {"out": [], "boxes": []}
    _capture(monkeypatch, pp, "two_stage_pipeline", got["out"])
    _capture(monkeypatch, pd, "unletterbox_boxes", got["boxes"])
    _capture(monkeypatch, jp, "two_stage_pipeline", want["out"])
    _capture(monkeypatch, jd, "unletterbox_boxes", want["boxes"])
    args = ["--target_path", str(d / "scene_001.png"), "--model_cfg", cfg, "--yolo_weights",
            str(d / "y.weights"), "--rektnet_weights", str(d / "r.pt"), "--conf_thres",
            repr(thresh), "--max_det", "8"]
    _, ptext = _run(pipeline.main, args + ["--output_path", str(tmp_path / "p"),
                                           "--device", "cpu"])
    _, jtext = _run(jpipeline_cli.main, args + ["--output_path", str(tmp_path / "j")])
    pm, jm = got["out"][0].mask[0].numpy(), np.asarray(want["out"][0].mask[0])
    assert pm.sum() > 0 and np.array_equal(pm, jm)
    np.testing.assert_allclose(got["boxes"][0].numpy()[pm], np.asarray(want["boxes"][0])[jm],
                               rtol=0, atol=1e-3)
    # model space (64²): keypoints measured 5.7e-6 px apart, scores 1.2e-7
    for key, tol in (("keypoints", 1e-4), ("scores", 1e-6)):
        np.testing.assert_allclose(getattr(got["out"][0], key)[0].numpy()[pm],
                                   np.asarray(getattr(want["out"][0], key)[0])[jm],
                                   rtol=0, atol=tol, err_msg=key)
    assert ptext.splitlines()[0].split(";")[0] == jtext.splitlines()[0].split(";")[0]
    assert os.listdir(tmp_path / "p") == ["pipeline_scene_001.png"]


def test_yolo_detect_cli_equals_jax(scenes, tmp_path, monkeypatch):
    import mit_driverless_cv_traininginfra_tpu.infer.detect as jd
    import mit_driverless_cv_traininginfra_tpu_torch.infer.detect as pd

    d, cfg, thresh = scenes
    got, want = [], []
    _capture(monkeypatch, pd, "detect_image", got)
    _capture(monkeypatch, jd, "detect_image", want)
    args = ["--target_path", str(d / "scene_002.png"), "--model_cfg", cfg, "--weights_path",
            str(d / "y.weights"), "--conf_thres", repr(thresh)]
    _run(yolo_detect.main, args + ["--output_path", str(tmp_path / "p"), "--device", "cpu"])
    _run(jdetect_cli.main, args + ["--output_path", str(tmp_path / "j")])
    (pb, ps), (jb, js) = got[0], want[0]
    assert len(pb) == len(jb) > 0
    np.testing.assert_allclose(pb, np.asarray(jb), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ps, np.asarray(js), rtol=0, atol=1e-6)
    assert os.listdir(tmp_path / "p") == os.listdir(tmp_path / "j") == ["scene_002.png"]


def test_yolo_validate_cli_equals_jax(scenes, monkeypatch):
    import mit_driverless_cv_traininginfra_tpu.train.yolo_driver as jdrv
    import mit_driverless_cv_traininginfra_tpu_torch.train.yolo_driver as pdrv

    d, cfg, _ = scenes
    monkeypatch.setattr("mit_driverless_cv_traininginfra_tpu.utils.jaxcache.enable_compile_cache",
                        lambda *a, **k: None)
    got, want = [], []
    _capture(monkeypatch, pdrv, "validate_map", got)
    _capture(monkeypatch, jdrv, "validate_map", want)
    args = ["--model_cfg", cfg, "--weights_path", str(d / "y.weights"), "--dataset_path",
            str(d), "--batch_size", "2", "--num_workers", "1"]
    _, ptext = _run(yolo_validate.main, args + ["--device", "cpu"])
    _run(jvalidate_cli.main, args)
    assert got[0][0] > 0 and got[0][:3] == tuple(float(v) for v in want[0][:3])
    assert "seconds/image: " in ptext


def test_eval_weights_tool_equals_the_repository_tool(scenes, monkeypatch, tmp_path):
    d, _, _ = scenes
    monkeypatch.setattr("mit_driverless_cv_traininginfra_tpu.utils.jaxcache.enable_compile_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr("mit_driverless_cv_traininginfra_tpu.config.flagship.flagship_spec",
                        lambda size, classes=80: tiny_spec())
    root = load_tool(REPO / "tools/eval_weights.py", "root_eval_weights")
    port = load_tool(PORT_TOOLS / "eval_weights.py", "port_eval_weights")
    args = ["--weights", str(d / "y.weights"), "--n", "16", "--size", "64", "--seed", "4"]
    _, jtext = _run(root.main, args)
    _, ptext = _run(port.main, args + ["--model_cfg", TINY_CFG, "--device", "cpu"])
    want, got = json.loads(jtext), json.loads(ptext)
    assert got["map_f32"] > 0
    for k in ("map_f32", "recall_f32", "precision_f32"):
        assert abs(got[k] - want[k]) <= 5e-5 + 1e-5, (k, got[k], want[k])  # root rounds to 4
    # the unrounded f32 numbers, from the root tool's own functions
    spec = tiny_spec()
    params, state = jdarknet.init_params(spec, jax.random.PRNGKey(0))
    params, state, _ = jdarknet.load_darknet_weights(spec, params, state, str(d / "y.weights"))
    folded = jdarknet.fold_bn(params, state, spec)
    imgs, targets = synthetic.yolo_batch(np.random.default_rng(4), 16, size=64, max_overlap=0.1)
    from mit_driverless_cv_traininginfra_tpu.ops.metrics import evaluate_image_batch

    ev = evaluate_image_batch(jdarknet.detections(spec, folded, {}, imgs, with_classes=False),
                              targets, 64, 64, conf_thresh=0.8, nms_thresh=0.25,
                              iou_thresh=0.5, top_k=32)
    v = np.asarray(ev.valid).astype(bool)
    assert abs(float(np.asarray(ev.ap)[v].mean()) - got["map_f32"]) <= 1e-5


def test_eval_rektnet_tool_equals_the_repository_tool(scenes, tmp_path, monkeypatch):
    d, _, _ = scenes
    tool = load_tool(REPO / "mit_driverless_cv_traininginfra_tpu_torch/tools/make_synth_dataset.py",
                     "port_make_synth")
    _run(tool.main, ["--out", str(tmp_path), "--family", "rektnet", "--train", "6", "--val",
                     "2", "--format", "png"])
    ratio = json.load(open(tmp_path / "meta.json"))["validation_ratio"]
    root = load_tool(REPO / "tools/eval_rektnet_weights.py", "root_eval_rektnet")
    port = load_tool(PORT_TOOLS / "eval_rektnet_weights.py", "port_eval_rektnet")
    # --n 2: the fresh crops in the disk split's batch shape (JAX compiles once)
    args = ["--pt", str(d / "r.pt"), "--n", "2", "--csv", str(tmp_path / "rektnet_label.csv"),
            "--images", str(tmp_path / "images"), "--ratio", repr(ratio)]
    _, jtext = _run(root.main, args)
    _, ptext = _run(port.main, args + ["--device", "cpu"])
    want, got = json.loads(jtext.splitlines()[-1]), json.loads(ptext.splitlines()[-1])
    assert got["disk_val_crops"] == want["disk_val_crops"] == 2
    for k in ("l2_f32", "disk_val_l2_f32"):
        assert abs(got[k] - want[k]) <= 5e-5 + 1e-5, (k, got[k], want[k])  # root rounds to 4
    # unrounded: the f32 half of the root tool's _l2 on the same crops
    jfolded = jrektnet.fold_bn(*jrektnet.load_torch_checkpoint(str(d / "r.pt")))
    ev_i, ev_p = synthetic.rektnet_batch(np.random.default_rng(424242), 2)
    p32 = np.asarray(jrektnet.apply_folded(jfolded, ev_i)[1], np.float32)
    assert abs(float(np.linalg.norm(p32 - ev_p, axis=-1).mean()) - got["l2_f32"]) <= 1e-5


def test_rektnet_tool_calibrates_on_bgr_training_crops_from_disk(scenes, tmp_path):
    """The int8 calibration of the port's tool with ``--csv``: the training
    split's BGR crops as ``ConeDataset`` reads them, not the synthetic RGB
    crops of the repository's tool."""
    d, _, _ = scenes
    tool = load_tool(REPO / "mit_driverless_cv_traininginfra_tpu_torch/tools/make_synth_dataset.py",
                     "port_make_synth")
    _run(tool.main, ["--out", str(tmp_path), "--family", "rektnet", "--train", "5", "--val",
                     "2", "--format", "png"])
    port = load_tool(PORT_TOOLS / "eval_rektnet_weights.py", "port_eval_rektnet")
    args = port.build_parser().parse_args(
        ["--pt", str(d / "r.pt"), "--csv", str(tmp_path / "rektnet_label.csv"), "--images",
         str(tmp_path / "images"), "--ratio", "0.3"])
    crops, _ = _run(port.calibration_crops, args)
    (ti, tl, _, _), _ = _run(load_train_csv_dataset, str(tmp_path / "rektnet_label.csv"), 0.3,
                             dataset_path=str(tmp_path / "images"))
    ds = ConeDataset(ti, tl, str(tmp_path / "images"), compute_heatmaps=False)
    want = np.stack([ds[i][0] for i in range(len(ds))])
    assert len(ti) == 5 and np.array_equal(crops, want)
    folded = rektnet.fold_bn(*rektnet.load_torch_checkpoint(str(d / "r.pt")))
    amax = calibrate_rektnet(folded, crops)
    synthetic_amax = calibrate_rektnet(folded, synthetic.rektnet_batch(
        np.random.default_rng(7), 64)[0])
    assert amax == calibrate_rektnet(folded, want) and amax != synthetic_amax


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a machine without CUDA")
def test_entry_points_run_on_the_card_by_default(scenes):
    """Without ``--device cpu`` each entry point asks for the card, and
    raises on a machine without one."""
    d, cfg, _ = scenes
    calls = [
        (pipeline.main, ["--target_path", "x.png", "--model_cfg", cfg, "--yolo_weights", "w",
                         "--rektnet_weights", "r"]),
        (yolo_detect.main, ["--target_path", "x.png", "--weights_path", "w"]),
        (yolo_validate.main, ["--weights_path", "w"]),
        (load_tool(PORT_TOOLS / "eval_weights.py", "port_eval_weights").main,
         ["--weights", "w"]),
        (load_tool(PORT_TOOLS / "eval_rektnet_weights.py", "port_eval_rektnet").main,
         ["--pt", "p"]),
    ]
    for main, argv in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
