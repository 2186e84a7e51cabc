"""The port's YOLO training entry points (``train/yolo_driver.py:main``,
``cli/yolo_train.py``, ``cli/kmeans_csvs.py``) against the JAX package on
the CPU: ``tests/fixtures/tiny_test.cfg`` at 64² on cone scenes written to
disk, the k-means CSVs named by a copy of the cfg.

Tolerances. Both drivers start from the same ``.weights`` file (written
from the JAX package's ``init_params``) and train one epoch with SGD in
f32, no augmentation, one loader thread, one device (the tests' JAX sees
eight): their per-batch losses (the log
line's ``Total``, printed to 6 decimals) agree within 1e-4 relative — one
step's f32 differences (PR 12's step bounds: loss 1e-5, updates 1e-3 of
the largest gradient) carried through the epoch's 8 steps — and so does
the validation loss. The command-line parsers give the same driver
arguments for the same flags (the port's own ``--device`` aside).
"""

import contextlib
import io
import os
import re
import sys

import jax
import numpy as np
import pytest

from mit_driverless_cv_traininginfra_tpu.cli import yolo_train as jcli
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu.train import yolo_driver as jdriver
from mit_driverless_cv_traininginfra_tpu_torch.cli import kmeans_csvs, yolo_train
from mit_driverless_cv_traininginfra_tpu_torch.data import yolo_csv
from mit_driverless_cv_traininginfra_tpu_torch.train import yolo_driver

from _torch_port import TINY_CFG, tiny_spec, write_cone_dataset

TRAIN_LINE = re.compile(r"^train Epoch: (\d+), Batch: (\d+)/(\d+), Total:\s+([0-9.]+)")


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """Scenes on disk, ``kmeans_csvs``' CSVs, a copy of the tiny cfg naming
    them and a ``.weights`` file of the JAX package's seeded init."""
    d = tmp_path_factory.mktemp("disk")
    csv_path = write_cone_dataset(d, np.random.default_rng(1), [(96, 144), (130, 90)],
                                  per_size=6, tile=48)
    with contextlib.redirect_stdout(io.StringIO()):
        assert kmeans_csvs.main(["--input_csvs", csv_path, "--dataset_path", str(d),
                                 "--output_path", str(d / "csvs"), "--num_clst", "6",
                                 "--max_cone_height", "24", "--min_cone_height", "6",
                                 "--split_up", "8-4-0", "--no_if_plot"]) == 0
    text = open(TINY_CFG).read()
    text = text.replace("validate_uri=\n", f"validate_uri={d / 'csvs' / 'validate.csv'}\n")
    text = text.replace("train_uri=\n", f"train_uri={d / 'csvs' / 'train.csv'}\n")
    cfg = d / "tiny_disk.cfg"
    cfg.write_text(text)
    spec = tiny_spec()
    params, state = jdarknet.init_params(spec, jax.random.PRNGKey(0))
    jdarknet.save_darknet_weights(spec, params, state, str(d / "init.weights"))
    return d, str(cfg)


def _losses(text):
    return [(int(m[1]), int(m[2]), float(m[4])) for m in map(TRAIN_LINE.match, text.splitlines())
            if m]


def test_kmeans_cli_writes_anchors_the_cfg_reads(disk):
    d, cfg = disk
    table = yolo_csv.read_yolo_csv(str(d / "csvs" / "train.csv"))
    assert len(table.anchors) == 6 and len(table.rows) > 0
    assert len({r.scale for r in table.rows}) == 2  # one scale a resolution
    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import load_network_spec
    assert [tuple(a) for a in load_network_spec(cfg).anchors] == table.anchors


def test_plot_without_matplotlib_says_so(disk, monkeypatch):
    d, _ = disk
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="no_if_plot"):
        with contextlib.redirect_stdout(io.StringIO()):
            kmeans_csvs.main(["--input_csvs", str(d / "all.csv"), "--dataset_path", str(d),
                              "--output_path", str(d / "plot"), "--if_plot"])


def test_main_first_epoch_losses_match_jax(disk, tmp_path, monkeypatch):
    d, cfg = disk
    monkeypatch.chdir(tmp_path)
    common = ["--model_cfg", cfg, "--dataset_path", str(d), "--weights_path",
              str(d / "init.weights"), "--optimizer_pick", "SGD", "--lr", "0.01",
              "--batch_size", "4", "--num_epochs", "1", "--num_workers", "0",
              "--no_mixed_precision", "--n_devices", "1"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert yolo_train.main(common + ["--output_path", "port", "--device", "cpu"]) == 0
    port_text = out.getvalue()
    kw = yolo_train.driver_kwargs(common + ["--output_path", "jax"])
    del kw["device"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jval = jdriver.main(**kw)
    jax_text = out.getvalue()
    got, want = _losses(port_text), _losses(jax_text)
    assert len(got) == len(want) > 5 and [g[:2] for g in got] == [w[:2] for w in want]
    for (_, i, a), (_, _, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-4), (i, a, b)
    pval = float(re.search(r"Average Validation Loss:\s+([0-9.]+)", port_text)[1])
    assert pval == pytest.approx(jval, rel=1e-4)
    # the CLI's tee: the log file holds the run, and stdout is back
    log = open(os.path.join("logs", "tiny_disk.log")).read()
    assert "mAP: " in log and "Average Validation Loss" in log
    assert sys.stdout is not None and not hasattr(sys.stdout, "log")
    assert sorted(os.listdir("port")) == ["1.weights", "state_latest.meta", "state_latest.pt"]


def test_resume_evaluate_and_device_aug_on_the_cpu(disk, tmp_path, monkeypatch):
    d, cfg = disk
    monkeypatch.chdir(tmp_path)
    kw = dict(model_cfg=cfg, weights_path=None, output_path="out", dataset_path=str(d),
              batch_size=4, num_workers=2, device="cpu", mixed_precision="auto",
              augment_affine=True, augment_hsv=True, lr_flip=True, data_aug=True,
              blur=True, noise=True, contrast=True, sharpen=True)
    runs = {}
    for name, extra in (("two", dict(num_epochs=2)),
                        ("resume", dict(num_epochs=3, resume=True)),
                        ("evaluate", dict(num_epochs=3, resume=True, evaluate=True)),
                        ("device_aug", dict(num_epochs=1, output_path="pool", device_aug=True,
                                            preload_device=True, preload_num=16))):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            yolo_driver.main(**{**kw, **extra})
        runs[name] = out.getvalue()
    assert [e for e, _, _ in _losses(runs["two"])][-1] == 2
    assert "at epoch 2" in runs["resume"] and {e for e, _, _ in _losses(runs["resume"])} == {3}
    assert "Model in train mode" not in runs["evaluate"] and runs["evaluate"].count("mAP:") == 1
    assert "Device pool: 16 samples" in runs["device_aug"]
    assert len(_losses(runs["device_aug"])) == 4
    for text in runs.values():
        assert all(np.isfinite(v) for _, _, v in _losses(text))


def test_parsers_give_the_same_driver_kwargs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    captured = {}
    monkeypatch.setattr(jdriver, "main", lambda **kw: captured.update(kw))
    monkeypatch.setattr("mit_driverless_cv_traininginfra_tpu.utils.jaxcache.enable_compile_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sys, "stdout", sys.stdout)  # the JAX CLI leaves its tee in place
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    every = ["--augment_affine", "--augment_hsv", "--augment_lr_flip", "--augment_ud_flip",
             "--data_aug", "--augment_blur", "--augment_salt", "--augment_noise",
             "--augment_contrast", "--augment_sharpen", "--no_ts", "--debug_mode",
             "--vanilla_anchor", "--upload_dataset", "--evaluate", "--resume",
             "--mixed_precision", "--device_aug", "--packed_stem", "--preload_device",
             "--preload_num", "5", "--preload_budget_gb", "1.5", "--batch_size", "3",
             "--optimizer_pick", "SGD", "--weights_path", "w", "--output_path", "o",
             "--dataset_path", "p", "--num_epochs", "4", "--num_steps", "9",
             "--checkpoint_interval", "2", "--val_tolerance", "5", "--min_epochs", "1",
             "--momentum", "0.8", "--gamma", "0.5", "--lr", "0.1", "--weight_decay", "0.01",
             "--xy_loss", "1", "--wh_loss", "2", "--no_object_loss", "3",
             "--object_loss", "4", "--grad_clip", "5", "--lr_warmup_steps", "6",
             "--val_batch_size", "2", "--vis_batch", "1", "--num_workers", "3",
             "--n_devices", "1", "--seed", "9", "--model_cfg", "x/y.cfg"]
    for argv in ([], ["--no_mixed_precision"], every):
        captured.clear()
        assert jcli.main(argv) == 0
        got = yolo_train.driver_kwargs(argv)
        assert got.pop("device") == "cuda"
        assert got == captured, argv
