"""The port's RektNet entry points from disk (``train/rektnet_driver.py:main``,
``cli/rektnet_train.py``, ``cli/rektnet_detect.py`` and the dataset tool
``tools/make_synth_dataset.py --family rektnet``) against the JAX package
on the CPU, at full width (net_size 16, 80², 7 keypoints) on a few crops.

Tolerances. Both drivers start from one ``.pt`` and train two epochs in
f32 with Adam (B=2, no shuffle, heatmaps made on the host): each printed
training and validation loss within 1e-5 relative (the losses print to 10
decimals). At lr 1e-6: Adam's first update is lr·sign(g), and the pre-BN
conv biases, whose true gradient is 0, carry gradients of rounding noise
whose sign differs between the packages, so at lr 1e-3 the first epoch's
losses already stood 3.3e-4 apart; at 1e-6 each update moves a loss by
less than the tolerance, and the test holds the data, the forward, the
losses and the loop.
The ``.pt`` the port writes reads back in the JAX package's
``load_torch_checkpoint`` equal to the port's own parameters. At lr 1e-3
(γ 0.5), the two epochs' update of all weight tensors, as one vector,
points the way JAX's does (cosine ≥ 0.9; measured 0.960) at its length
within 5% (measured 0.991; without the lr decay it reads 1.193, at γ 0.25
0.897): Adam's sign-normalised steps turn the packages' ill-conditioned
gradient sums (up to ~5e-4 of the largest apart, as
``test_torch_rektnet_train.py`` states) into the rest of the gap. A
``--resume`` from the epoch-1 ``.pt`` ends epoch 3 bit-equal to an
uninterrupted run (the model, Adam's moments and step, the decayed lr).
``rektnet_detect``'s keypoints within 1e-5 of the JAX CLI's (both decode
and resize bit-equal; the nets' f32 sums differ in order). The dataset
tool's CSV is the repository tool's, byte for byte, and its crops are the
JAX package's rendering; its recorded ratio splits off exactly the
validation rows (the repository tool's can split one short).
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.cli import rektnet_detect as jdetect
from mit_driverless_cv_traininginfra_tpu.data import synthetic as jsynthetic
from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu.train import rektnet_driver as jdriver
from mit_driverless_cv_traininginfra_tpu_torch.cli import rektnet_detect, rektnet_train
from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet
from mit_driverless_cv_traininginfra_tpu_torch.train import rektnet_driver
from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import save_rektnet_pt

REPO = Path(__file__).resolve().parents[1]
LOSS = re.compile(r"^\t(Training|Validation): MSE/Geometric/Total Loss: (\S+)/(\S+)/(\S+)$",
                  re.M)


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
def crops(tmp_path_factory):
    """The port's dataset tool: 8 training and 2 validation crops as PNG,
    and a seeded full-width ``.pt``."""
    d = tmp_path_factory.mktemp("rk")
    tool = load_tool(REPO / "mit_driverless_cv_traininginfra_tpu_torch/tools/make_synth_dataset.py",
                     "port_make_synth")
    _run(tool.main, ["--out", str(d), "--family", "rektnet", "--train", "8", "--val", "2",
                     "--format", "png", "--seed", "3"])
    model = rektnet.KeypointNet(*rektnet.init(torch.Generator().manual_seed(0)))
    save_rektnet_pt(str(d / "init.pt"), model)
    return d, json.load(open(d / "meta.json"))["validation_ratio"]


def test_dataset_tool_equals_the_repository_tool(tmp_path):
    port = load_tool(REPO / "mit_driverless_cv_traininginfra_tpu_torch/tools/make_synth_dataset.py",
                     "port_make_synth")
    root = load_tool(REPO / "tools/make_synth_dataset.py", "root_make_synth")
    _run(port.main, ["--out", str(tmp_path / "p"), "--family", "rektnet", "--train", "5",
                     "--val", "3", "--format", "npy"])
    _run(root.main, ["--out", str(tmp_path / "j"), "--family", "rektnet", "--train", "5",
                     "--val", "3"])
    want = open(tmp_path / "j" / "rektnet_label.csv").read()
    assert open(tmp_path / "p" / "rektnet_label.csv").read() == want.replace(".jpg,", ".npy,")
    rng = np.random.default_rng(5)
    for i in range(8):
        img, _ = jsynthetic.cone_crop(rng, size=int(rng.integers(64, 161)))
        name = f"{'va' if i < 3 else 'tr'}_{i:05d}.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "p" / "images" / name),
                                      (np.clip(img, 0, 1) * 255).astype(np.uint8))


def test_recorded_ratio_splits_off_exactly_the_validation_rows(tmp_path):
    port = load_tool(REPO / "mit_driverless_cv_traininginfra_tpu_torch/tools/make_synth_dataset.py",
                     "port_make_synth")
    # the advisor's case: 512 of 3840, where the rounded quotient floors to 511
    assert int(3840 * round(512 / 3840, 6)) == 511
    for train, val in [(3328, 512), (512, 64), (7, 3), (1000, 0), (1, 1)]:
        assert int((train + val) * port.validation_ratio(train, val)) == val
    from mit_driverless_cv_traininginfra_tpu_torch.data.rektnet_data import (
        load_train_csv_dataset,
    )

    _run(port.main, ["--out", str(tmp_path), "--family", "rektnet", "--train", "9", "--val",
                     "3", "--format", "npy"])
    meta = json.load(open(tmp_path / "meta.json"))
    (_, _, vi, _), _ = _run(load_train_csv_dataset, str(tmp_path / "rektnet_label.csv"),
                            meta["validation_ratio"], dataset_path=str(tmp_path / "images"))
    assert list(vi) == ["va_00000.npy", "va_00001.npy", "va_00002.npy"]


def _losses(text):
    return [(m[1], float(m[4])) for m in LOSS.finditer(text)]


def test_main_two_epochs_equal_jax(crops, tmp_path, monkeypatch):
    d, ratio = crops
    monkeypatch.chdir(tmp_path)
    common = dict(train_dataset_uri=str(d / "rektnet_label.csv"),
                  dataset_path=str(d / "images"), batch_size=2, num_epochs=2, lr=1e-6,
                  validation_ratio=ratio, checkpoint_interval=2, geo_loss_gamma_horz=0.05,
                  geo_loss_gamma_vert=0.05, checkpoint_path=str(d / "init.pt"))
    _, jtext = _run(jdriver.main, output_path=str(tmp_path / "j"), mixed_precision=False,
                    save_checkpoints=False, **common)
    _, ptext = _run(rektnet_driver.main, output_path=str(tmp_path / "p"), device="cpu",
                    mixed_precision="auto", num_workers=2, **common)
    got, want = _losses(ptext), _losses(jtext)
    assert [k for k, _ in got] == [k for k, _ in want] == ["Training", "Validation"] * 2
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b), (got, want)
    # each new best validation loss writes the best model as ONNX
    onnx = tmp_path / "p" / "best_keypoints_8080.onnx"
    assert f"Saving ONNX model to {onnx}" in ptext and onnx.exists()
    pt = [f for f in os.listdir(tmp_path / "p") if f.startswith("1_loss_")]
    assert len(pt) == 1
    jp, js = jrektnet.load_torch_checkpoint(str(tmp_path / "p" / pt[0]))
    pp, ps = rektnet.load_torch_checkpoint(str(tmp_path / "p" / pt[0]))
    import jax

    from mit_driverless_cv_traininginfra_tpu_torch import convert

    got = jax.tree_util.tree_leaves([convert.from_jax(jax.tree_util.tree_map(np.array, t))
                                     for t in (jp, js)])
    want = jax.tree_util.tree_leaves([pp, ps])
    assert len(got) == len(want) > 50
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the resume state: a third epoch only, then evaluate mode and the dataset render
    _, text = _run(rektnet_train.main, [
        "--train_dataset_uri", common["train_dataset_uri"], "--dataset_path",
        common["dataset_path"], "--output_path", str(tmp_path / "p"), "--batch_size", "2",
        "--num_epochs", "3", "--lr", "1e-3", "--validation_ratio", str(ratio), "--resume",
        "--device", "cpu"])
    assert "at epoch 2" in text and text.count("EPOCH") == 1 and "EPOCH 2" in text
    _, text = _run(rektnet_train.main, [
        "--train_dataset_uri", common["train_dataset_uri"], "--dataset_path",
        common["dataset_path"], "--output_path", str(tmp_path / "e"), "--evaluate_mode",
        "--checkpoint_path", str(tmp_path / "p" / pt[0]), "--validation_ratio", str(ratio),
        "--device", "cpu"])
    assert "EPOCH" not in text and "Total distance error is" in text
    assert len(open(tmp_path / "logs" / "rektnet_validation.txt").read().splitlines()) == 2
    _, text = _run(rektnet_train.main, [
        "--train_dataset_uri", common["train_dataset_uri"], "--dataset_path",
        common["dataset_path"], "--output_path", str(tmp_path / "v"), "--vis_upload_data",
        "--validation_ratio", str(ratio), "--device", "cpu"])
    assert "visualized 8 dataset images" in text
    for name in os.listdir(tmp_path / "v" / "visualization"):
        data = open(tmp_path / "v" / "visualization" / name, "rb").read()
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


def test_detect_cli_equals_jax(crops, tmp_path):
    d, _ = crops
    img = str(d / "images" / "va_00001.png")
    _, ptext = _run(rektnet_detect.main, ["--model", str(d / "init.pt"), "--img", img,
                                          "--output", str(tmp_path / "p"), "--device", "cpu"])
    _, jtext = _run(jdetect.main, ["--model", str(d / "init.pt"), "--img", img,
                                   "--output", str(tmp_path / "j")])
    got = np.asarray(ast.literal_eval(ptext.split("keypoints: ")[1].strip()))
    want = np.asarray(ast.literal_eval(jtext.split("keypoints: ")[1].strip()))
    assert got.shape == (7, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j")) == [
        "va_00001_hm.jpg", "va_00001_inference.jpg"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a machine without CUDA")
def test_entry_points_raise_without_a_card(crops):
    d, _ = crops
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rektnet_driver.main(train_dataset_uri=str(d / "rektnet_label.csv"),
                            dataset_path=str(d / "images"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rektnet_detect.main(["--model", str(d / "init.pt"), "--img", "x.png"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rektnet_driver.main(train_dataset_uri="x", dataset_path="y", n_devices=2)
    with pytest.raises(ValueError, match="n_devices must be ≥ 1"):
        rektnet_driver.main(train_dataset_uri="x", dataset_path="y", n_devices=0,
                            device="cpu")


def _pt_params(path):
    """A ``.pt``'s parameters as numpy, keyed by state-dict name."""
    sd = torch.load(path, map_location="cpu", weights_only=True)["model"]
    return {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def _epoch_pt(out, epoch: int):
    (name,) = [f for f in os.listdir(out) if f.startswith(f"{epoch}_loss_")]
    return _pt_params(out / name)


def test_main_updates_and_resume_equal_jax(crops, tmp_path, monkeypatch):
    d, ratio = crops
    monkeypatch.chdir(tmp_path)
    common = dict(train_dataset_uri=str(d / "rektnet_label.csv"),
                  dataset_path=str(d / "images"), batch_size=2, lr=1e-3, lr_gamma=0.5,
                  validation_ratio=ratio, checkpoint_interval=2,
                  checkpoint_path=str(d / "init.pt"))
    _run(jdriver.main, output_path=str(tmp_path / "j"), num_epochs=2, mixed_precision=False,
         **common)
    _run(rektnet_driver.main, output_path=str(tmp_path / "p"), num_epochs=2, device="cpu",
         **common)
    init, want, got = (_pt_params(d / "init.pt"), _epoch_pt(tmp_path / "j", 1),
                       _epoch_pt(tmp_path / "p", 1))
    assert sorted(got) == sorted(want)
    # every weight tensor's update over the two epochs, as one vector
    keys = [k for k in want if k.endswith(".weight")]
    dj, dp = (np.concatenate([(p[k] - init[k]).ravel() for k in keys]) for p in (want, got))
    cos = dj @ dp / (np.linalg.norm(dj) * np.linalg.norm(dp))
    ratio = np.linalg.norm(dp) / np.linalg.norm(dj)
    assert cos >= 0.9 and abs(ratio - 1) <= 0.05, (cos, ratio)
    # the resumed run is the uninterrupted one
    _run(rektnet_driver.main, output_path=str(tmp_path / "p"), num_epochs=4, resume=True,
         device="cpu", **common)
    _run(rektnet_driver.main, output_path=str(tmp_path / "c"), num_epochs=4, device="cpu",
         **common)
    resumed, straight = _epoch_pt(tmp_path / "p", 3), _epoch_pt(tmp_path / "c", 3)
    for k in straight:
        np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)
