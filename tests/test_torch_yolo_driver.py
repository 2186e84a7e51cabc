"""The port's YOLO training loop (``train/yolo_driver.py``), its YOLO
checkpoints, loader (``data/loader.py``), logger and profiling helpers,
against the JAX package on the CPU: ``tests/fixtures/tiny_test.cfg`` at
64², synthetic scenes, B=4.

Tolerances. The ``.weights`` file the port writes is read by the JAX
package's ``load_darknet_weights`` into the port's trees exactly.
``validate_map`` on the same weights and loader: the f32 forwards differ
by convolution summation order, so the confidence threshold is put in a
gap between neighbouring confidences (``gap_threshold``) and the two
packages keep the same detections; mAP, recall and precision within 1e-6.
The loader's shuffle order, the loss labels and the FLOP counts are
equal.
"""

import contextlib
import dataclasses
import io
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from mit_driverless_cv_traininginfra_tpu.data import loader as jloader
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu.train import yolo_driver as jdriver
from mit_driverless_cv_traininginfra_tpu.utils import profiling as jprofiling
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec
from mit_driverless_cv_traininginfra_tpu_torch.data import loader, synthetic
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet
from mit_driverless_cv_traininginfra_tpu_torch.train import optim, yolo_driver
from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import load_yolo_state
from mit_driverless_cv_traininginfra_tpu_torch.utils import logger, profiling

from _torch_port import TINY_CFG, gap_threshold, tiny_port_spec, tiny_spec, to_jnp

B = 4


def _batches(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        imgs, targets = synthetic.yolo_batch(rng, B, 64, min_h=8, max_h=30)
        out.append(([f"s{seed}_{k}_{i}" for i in range(B)], imgs, targets))
    return out


def _fresh(seed=0):
    tspec = tiny_port_spec()
    model = darknet.TrainDarknet(tspec, *darknet.init_params(
        tspec, torch.Generator().manual_seed(seed)))
    return model, optim.make_optimizer(model.parameters(), "Adam", lr=1e-3)


def _train(tmp, model, opt, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        val = yolo_driver.train_yolo(
            model, opt, _batches(1, 2), _batches(2, 1), device="cpu",
            output_path=str(tmp / "out"), model_cfg=TINY_CFG, log_dir=str(tmp / "logs"), lr=1e-3,
            gamma=0.95, checkpoint_interval=1, val_tolerance=99, min_epochs=3,
            **kw)
    return val, out.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("yolo_driver")
    model, opt = _fresh()
    val, text = _train(tmp, model, opt, num_epochs=2, lr_warmup_steps=3)
    return tmp, model, opt, val, text


def test_train_yolo_two_epochs(trained):
    tmp, model, _, val, text = trained
    out = tmp / "out"
    assert np.isfinite(val)
    assert os.path.exists(out / "1.weights") and os.path.exists(out / "2.weights")
    assert open(out / "state_latest.meta").read() == "2"
    assert float(open(tmp / "logs" / "result.txt").read()) == pytest.approx(val)
    assert "Completed epoch:  2" in text and "Average Validation Loss:" in text
    # the reference's per-batch line, its labels in the reference's order
    line = re.compile(r"train Epoch: 2, Batch: 2/2, Total: +[-\d.]+"
                      + "".join(rf",   {re.escape(l)}: +[-\d.]+%" for l in
                                jdriver.LOSS_LABELS[1:]))
    assert any(line.fullmatch(x) for x in text.splitlines()), text[:2000]
    assert text.count("mAP: ") == 2


def test_loss_labels_keep_the_reference_swap():
    assert yolo_driver.LOSS_LABELS == jdriver.LOSS_LABELS
    assert yolo_driver.LOSS_LABELS[5:] == ["L-noobj", "L-obj"]


def test_weights_file_read_by_jax(trained):
    """The ``.weights`` the port wrote at epoch 2 reads into the trained
    trees in the JAX package."""
    tmp, model, _, _, _ = trained
    spec = tiny_spec()
    jp, js = to_jnp(convert.init_darknet_np(tiny_port_spec(), np.random.default_rng(1)))
    jp, js, header = jdarknet.load_darknet_weights(spec, jp, js,
                                                   str(tmp / "out" / "2.weights"))
    params, state = model.trees()
    for got, want in ((jp, convert.to_jax(params)), (js, convert.to_jax(state))):
        for k in want:
            for leaf in want[k]:
                w = want[k][leaf]
                g = got[k][leaf]
                if isinstance(w, dict):
                    for kk in w:
                        np.testing.assert_array_equal(np.asarray(g[kk]), w[kk])
                else:
                    np.testing.assert_array_equal(np.asarray(g), w)
    assert list(header) == [0] * 5


def test_validate_map_matches_jax(trained):
    _, model, _, _, _ = trained
    val = _batches(3, 2)
    with torch.no_grad():
        conf = np.concatenate([model.detections(torch.from_numpy(v[1]))[..., 4].numpy()
                               for v in val])
    thresh = gap_threshold(conf, per_frame=8)
    spec, tspec = tiny_spec(), tiny_port_spec()
    spec = dataclasses.replace(spec, net=dataclasses.replace(spec.net, conf_thresh=thresh))
    model.spec = dataclasses.replace(tspec, net=dataclasses.replace(
        tspec.net, conf_thresh=thresh))
    params, state = model.trees()
    with contextlib.redirect_stdout(io.StringIO()):
        got = yolo_driver.validate_map(data_loader=val, model=model, device="cpu")
        want = jdriver.validate_map(data_loader=val, spec=spec,
                                    params=to_jnp(convert.to_jax(params)),
                                    model_state=to_jnp(convert.to_jax(state)), mesh=None)
    model.spec = tspec
    for g, w in zip(got[:3], want[:3]):
        assert g == pytest.approx(w, abs=1e-6)
    assert got[1] > 0  # some label was found


def test_resume_restores_the_state_and_goes_on(trained, tmp_path):
    tmp, model, opt, _, _ = trained
    model2, opt2 = _fresh(seed=5)
    step, epoch = load_yolo_state(str(tmp / "out" / "state_latest.pt"), model2, opt2)
    assert (step, epoch) == (4, 2)
    for (k, v), (_, v2) in zip(model.state_dict().items(), model2.state_dict().items()):
        assert torch.equal(v, v2), k
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["param_groups"][0]["lr"] == s2["param_groups"][0]["lr"]
    for i in s1["state"]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s1["state"][i][k], s2["state"][i][k])

    # the driver goes on at epoch 3 from what epoch 2 left
    shutil.copytree(tmp / "out", tmp_path / "out")
    model3, opt3 = _fresh(seed=6)
    val, text = _train(tmp_path, model3, opt3, num_epochs=3, resume=True)
    assert "at epoch 2" in text and "train Epoch: 3" in text
    assert "train Epoch: 1," not in text and "train Epoch: 2," not in text
    assert open(tmp_path / "out" / "state_latest.meta").read() == "3"
    assert os.path.exists(tmp_path / "out" / "3.weights") and np.isfinite(val)


def test_num_steps_and_evaluate(tmp_path):
    """``num_steps`` ends training at that global step, with a check;
    ``evaluate`` only validates."""
    model, opt = _fresh()
    val, text = _train(tmp_path, model, opt, num_epochs=5, num_steps=3)
    assert "train Epoch: 2, Batch: 1/2" in text and "train Epoch: 2, Batch: 2/2" not in text
    assert sorted(os.listdir(tmp_path / "out")) == ["1.weights", "2.weights",
                                                    "state_latest.meta", "state_latest.pt"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    val2, text2 = _train(tmp_path / "eval", model, opt, num_epochs=5, evaluate=True)
    assert val2 == 999.0 and "Model in train mode" not in text2
    assert text2.count("mAP: ") == 1
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())


def test_unported_modes_raise(tmp_path):
    """Every mode of the JAX package's ``yolo_driver.main`` is ported now;
    ``main`` refuses what JAX's refuses: ``packed_stem`` on a spec whose
    stem it does not fit (JAX's ``ValueError``; on the tiny cfg, which
    fits, ``main`` goes on to read its dataset), fewer than one device, or
    more ranks than CUDA devices (no fallback to fewer)."""
    kw = dict(model_cfg="tests/fixtures/tiny_test.cfg", weights_path=None,
              output_path=str(tmp_path), dataset_path=str(tmp_path), device="cpu")
    with open(TINY_CFG) as f:
        text = f.read()
    assert text.count("size=3\nstride=2") >= 1
    flat = tmp_path / "flat_stem.cfg"   # block 1 at stride 1: not packable
    flat.write_text(text.replace("size=3\nstride=2", "size=3\nstride=1", 1))
    with pytest.raises(ValueError, match="standard YOLOv3"):
        yolo_driver.main(**dict(kw, model_cfg=str(flat)), packed_stem=True)
    with pytest.raises(FileNotFoundError):   # past the check: the cfg's empty CSV
        yolo_driver.main(**kw, packed_stem=True)
    with pytest.raises(ValueError, match="n_devices must be ≥ 1"):
        yolo_driver.main(**kw, n_devices=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            yolo_driver.main(**dict(kw, device="cuda"), n_devices=4)


def test_train_yolo_through_the_packed_stem(tmp_path):
    """``train_yolo(packed_stem=True)``: one epoch through the packed stem
    from the same weights as a plain epoch. The first batch's loss (before
    any update) within 1e-5 relative of the plain run's, the rest of the
    epoch and its validation loss within 1e-2 (Adam's first steps are
    ±lr where a gradient is near zero, as the JAX package's
    ``test_packed_training_step_matches_plain`` notes); the same files."""
    runs = {}
    for packed in (False, True):
        model, opt = _fresh()
        runs[packed] = _train(tmp_path / str(packed), model, opt, num_epochs=1,
                              packed_stem=packed)
    totals = {k: [float(m) for m in re.findall(r"train Epoch: 1, Batch: \d/2, Total: +([-\d.]+)",
                                              text)] for k, (_, text) in runs.items()}
    assert len(totals[True]) == 2
    np.testing.assert_allclose(totals[True][0], totals[False][0], rtol=1e-5)
    np.testing.assert_allclose(totals[True], totals[False], rtol=1e-2)
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-2)
    assert (sorted(os.listdir(tmp_path / "True" / "out"))
            == sorted(os.listdir(tmp_path / "False" / "out")))


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == 13:
            raise ValueError("bad sample 13")
        return f"u{i}", np.full((2, 2, 3), i, np.float32), np.full((1, 5), i, np.float32)


def test_loader_order_matches_jax_and_prefetch_passes_on_cpu():
    for shuffle, drop_last in ((True, False), (False, True)):
        got = loader.DataLoader(_Items(11), 3, shuffle=shuffle, drop_last=drop_last,
                                num_workers=2, seed=5)
        want = jloader.DataLoader(_Items(11), 3, shuffle=shuffle, drop_last=drop_last,
                                  num_workers=2, seed=5)
        assert len(got) == len(want)
        for _ in range(2):  # the second epoch draws a new order, as JAX's
            for (gu, gi, gl), (wu, wi, wl) in zip(got, want):
                assert gu == wu
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gl, wl)
    batches = list(loader.prefetch_to_device(iter(loader.DataLoader(_Items(5), 2, num_workers=1)),
                                             "cpu"))
    assert all(torch.is_tensor(b[1]) and torch.is_tensor(b[2]) and isinstance(b[0], list)
               for b in batches)
    with pytest.raises(ValueError, match="bad sample 13"):
        for _ in loader.prefetch_to_device(iter(loader.DataLoader(_Items(16), 4,
                                                                  shuffle=False)), "cpu"):
            pass


def test_logger_and_score_file(tmp_path, capsys):
    log = logger.Logger(str(tmp_path / "a" / "run.log"))
    log.write("hello\n")
    log.flush()
    assert open(tmp_path / "a" / "run.log").read() == "hello\n"
    assert capsys.readouterr().out == "hello\n"
    assert logger.Logger(str(tmp_path / "run.error")).terminal is sys.stderr
    logger.write_score_file(str(tmp_path / "b" / "result.txt"), 1.25)
    assert open(tmp_path / "b" / "result.txt").read() == "1.25"


def test_flops_and_timers_match_jax():
    from mit_driverless_cv_traininginfra_tpu.config.flagship import (
        flagship_spec as jflagship_spec,
    )

    assert profiling.conv_graph_flops(tiny_port_spec()) == jprofiling.conv_graph_flops(
        tiny_spec())
    assert profiling.conv_graph_flops(flagship_spec(416, classes=1), 320, 320) == \
        jprofiling.conv_graph_flops(jflagship_spec(416, classes=1), 320, 320)
    assert profiling.rektnet_flops() == jprofiling.rektnet_flops()
    x = torch.ones(3)
    assert profiling.fence(x, 2 * x) == 9.0
    assert profiling.time_ms(lambda: x + 1, lambda out: out, iters=3) >= 0.0
    timer = profiling.StepTimer(sync_every=2)
    assert timer.step(x) is None and timer.step(x) > 0.0
    assert profiling.device_memory_stats() == {}  # no card here


def test_trees_round_trip_through_the_jax_layout():
    params, state = darknet.init_params(tiny_port_spec(), torch.Generator().manual_seed(2))
    back = convert.from_jax(convert.to_jax(params))
    for k in params:
        assert torch.equal(back[k]["w"], params[k]["w"])
    assert convert.to_jax(params)["0"]["w"].shape == (3, 3, 3, 8)  # HWIO
    assert torch.equal(convert.from_jax(convert.to_jax(state))["0"]["var"], state["0"]["var"])
