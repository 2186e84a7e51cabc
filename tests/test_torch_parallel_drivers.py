"""The training entry points on two CPU ranks (``gloo``): ``cli/yolo_train
--n_devices 2 --device cpu`` and ``rektnet_driver.main(n_devices=2,
device="cpu")`` against the same run on one process, on the tiny disk
datasets of ``test_torch_yolo_cli.py`` and ``test_torch_rektnet_cli.py``
(batches that divide: no repeat padding, so the global batches are the
one-process run's).

Tolerances, YOLO (SGD, f32): every printed training and validation loss
within rtol 1e-4 (``test_torch_yolo_cli.py``'s bound for the port against
JAX), the mAP line equal, and the weights written after the epoch within
1e-4 of the largest change the one-process run made to any weight.
RektNet: see its test.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu_torch.cli import yolo_train
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import load_network_spec
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet
from mit_driverless_cv_traininginfra_tpu_torch.train import rektnet_driver
from test_torch_rektnet_cli import crops  # noqa: F401 (fixture)
from test_torch_yolo_cli import disk  # noqa: F401 (fixture)

LOSS = re.compile(r"^\t(Training|Validation): MSE/Geometric/Total Loss: (\S+)/(\S+)/(\S+)$",
                  re.M)
NUM = re.compile(r"Total:\s+([0-9.]+)|Loss:\s+([0-9.]+)|Loss: (\S+)/(\S+)/(\S+)")


def _numbers(text):
    """Every printed loss, in order."""
    return [float(x) for m in NUM.finditer(text) for x in m.groups() if x is not None]


def _weights_close(got, want, before):
    span = max(float((w - b).abs().max()) for w, b in zip(want, before))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * span)


def test_yolo_cli_on_two_ranks_equals_one_process(disk, tmp_path, monkeypatch):  # noqa: F811
    d, cfg = disk
    common = ["--model_cfg", cfg, "--dataset_path", str(d), "--weights_path",
              str(d / "init.weights"), "--optimizer_pick", "SGD", "--lr", "0.01",
              "--batch_size", "4", "--num_epochs", "1", "--num_workers", "0",
              "--no_mixed_precision", "--device", "cpu"]
    texts = {}
    for n in (1, 2):
        run = tmp_path / f"n{n}"
        run.mkdir()
        monkeypatch.chdir(run)
        with contextlib.redirect_stdout(io.StringIO()):
            assert yolo_train.main(common + ["--output_path", "out", "--n_devices",
                                             str(n)]) == 0
        texts[n] = open(run / "logs" / "tiny_disk.log").read()  # rank 0's tee
        assert sorted(os.listdir(run / "out")) == ["1.weights", "state_latest.meta",
                                                  "state_latest.pt"]
    one, two = _numbers(texts[1]), _numbers(texts[2])
    # 8 training steps, 4 validation batches, the validation mean
    assert len(one) == len(two) == 8 + 4 + 1
    np.testing.assert_allclose(two, one, rtol=1e-4)
    assert re.findall(r"mAP: .*", texts[1]) == re.findall(r"mAP: .*", texts[2])

    spec = load_network_spec(cfg)

    def weights(path):
        p, s = darknet.init_params(spec, torch.Generator().manual_seed(0))
        p, s, _ = darknet.load_darknet_weights(spec, p, s, str(path))
        return [t for tree in (p, s) for t in _flat(tree)]

    _weights_close(weights(tmp_path / "n2/out/1.weights"),
                   weights(tmp_path / "n1/out/1.weights"), weights(d / "init.weights"))


def _flat(tree):
    if torch.is_tensor(tree):
        return [tree]
    return [t for k in sorted(tree) for t in _flat(tree[k])]


def test_rektnet_main_on_two_ranks_equals_one_process(crops, tmp_path, capfd):  # noqa: F811
    """Adam at lr 1e-6, as ``test_torch_rektnet_cli.py`` holds the port to
    JAX: Adam's first steps are lr·sign(g), and the pre-BN conv biases'
    gradients are rounding noise whose signs differ with the order of any
    sum, so at lr 1e-3 two correct runs part by ~1% in two epochs; at 1e-6
    each update moves a loss by less than the tolerance. Each epoch's
    printed losses within rtol 1e-5, the best validation loss and the
    keypoint report's total within rtol 1e-5."""
    d, ratio = crops
    kw = dict(train_dataset_uri=str(d / "rektnet_label.csv"),
              dataset_path=str(d / "images"), batch_size=4, num_epochs=1, lr=1e-6,
              validation_ratio=ratio, device="cpu", mixed_precision=False, seed=0)
    losses, best, dist = {}, {}, {}
    for n in (None, 2):
        out, log = tmp_path / f"n{n}", tmp_path / f"logs{n}"
        best[n] = rektnet_driver.main(output_path=str(out), n_devices=n,
                                      log_dir=str(log), **kw)
        losses[n] = [float(x) for m in LOSS.finditer(capfd.readouterr().out)
                     for x in m.groups()[1:]]  # rank 0 prints (the others are quiet)
        assert sorted(os.listdir(log)) == ["rektnet.txt"]
        assert [p.suffix for p in out.iterdir()] == [".onnx"]  # epoch 0 writes no .pt
        dist[n] = float((log / "rektnet.txt").read_text())
    assert len(losses[2]) == len(losses[None]) == 2 * 3
    np.testing.assert_allclose(losses[2], losses[None], rtol=1e-5)
    assert best[2] == pytest.approx(best[None], rel=1e-5)
    assert dist[2] == pytest.approx(dist[None], rel=1e-5)
