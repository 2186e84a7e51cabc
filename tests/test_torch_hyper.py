"""The port's hyperparameter search (``hyper/search.py``,
``cli/yolo_hyper.py``, ``cli/rektnet_hyper.py``) against the JAX package
on the CPU.

Tolerances: none. For one seed and one history of scores (numpy-made) the
two packages' ``TPESampler`` / ``Study`` propose bit-equal parameters,
the startup trials and the TPE ones; a study that the JAX package wrote
is joined and extended by the port's as the JAX package extends it; the
sweep CLIs build the JAX CLIs' trial commands but for the module and
``--device``. One real trial runs ``cli/rektnet_train`` in a subprocess
on the CPU.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from mit_driverless_cv_traininginfra_tpu.cli import rektnet_hyper as jrektnet_hyper
from mit_driverless_cv_traininginfra_tpu.cli import yolo_hyper as jyolo_hyper
from mit_driverless_cv_traininginfra_tpu.hyper import search as jsearch
from mit_driverless_cv_traininginfra_tpu_torch.cli import rektnet_hyper, yolo_hyper
from mit_driverless_cv_traininginfra_tpu_torch.hyper import search

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRIALS = 12  # 10 startup trials, then TPE
SCORES = np.random.default_rng(11).normal(1.0, 0.3, 64)


def _objective(trial):
    x = trial.suggest_uniform("x", -2.0, 3.0)
    y = trial.suggest_float("y", 0.0, 0.15)
    c = trial.suggest_categorical("c", ["a", "b", "c"])
    flag = trial.suggest_categorical("flag", [False, True])
    return (float(SCORES[trial.number]) + 0.01 * x * x + y + (0.05 if c == "b" else 0.0)
            + flag)


def _run(module, tmp, name, n, seed=7):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        study = module.create_study(name, storage_dir=str(tmp), seed=seed)
        study.optimize(_objective, n_trials=n)
    return study, out.getvalue()


def _params(study):
    return [(t["number"], t["state"], t["params"], t["value"]) for t in study.trials]


def test_tpe_study_proposes_bit_equal_parameters(tmp_path):
    port, text = _run(search, tmp_path / "port", "s", N_TRIALS)
    ref, _ = _run(jsearch, tmp_path / "jax", "s", N_TRIALS)
    assert text.startswith("Created study")
    assert _params(port) == _params(ref)  # floats compared exactly
    assert len(port.trials) == N_TRIALS and all(t["state"] == "COMPLETE" for t in port.trials)
    assert port.best_trial["number"] == ref.best_trial["number"]
    # past the startup trials the sampler leaves the uniform draws
    assert jsearch.TPESampler().n_startup == search.TPESampler().n_startup == 10
    # the same storage: the JSON files differ only in the trials' durations
    strip = lambda p: [{k: v for k, v in t.items() if k != "duration"}  # noqa: E731
                       for t in json.load(open(p))["trials"]]
    assert strip(tmp_path / "port" / "s.json") == strip(tmp_path / "jax" / "s.json")


def test_sampler_alone_bit_equal_on_a_numpy_history():
    rng = np.random.default_rng(5)
    history_f = [(float(v), float(s)) for v, s in zip(rng.uniform(0, 1, 30), rng.normal(size=30))]
    history_c = [(str(v), float(s)) for v, s in zip(rng.choice(list("pqr"), 30),
                                                     rng.normal(size=30))]
    a, b = search.TPESampler(seed=3), jsearch.TPESampler(seed=3)
    for n in range(0, 30, 2):  # below the startup count, then above it
        assert a.sample(search.FloatParam(0.0, 1.0), history_f[:n]) == \
            b.sample(jsearch.FloatParam(0.0, 1.0), history_f[:n])
        assert a.sample(search.CategoricalParam(list("pqr")), history_c[:n]) == \
            b.sample(jsearch.CategoricalParam(list("pqr")), history_c[:n])


def test_port_joins_and_extends_a_jax_study(tmp_path):
    _run(jsearch, tmp_path / "a", "shared", 5)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    port, text = _run(search, tmp_path / "a", "shared", N_TRIALS - 5)
    ref, _ = _run(jsearch, tmp_path / "b", "shared", N_TRIALS - 5)
    assert text.startswith("Joined existing study")
    assert [t["number"] for t in port.trials] == list(range(N_TRIALS))
    assert _params(port) == _params(ref)


def _recorded_arglists(monkeypatch, tmp_path, cli, pkg_search, argv, name):
    """Run ``cli.main(argv)`` with its trials recorded instead of run, on a
    seeded study stored under ``tmp_path/name``."""
    calls = []

    def record(arglist, score_file):
        calls.append((list(arglist), score_file))
        return float(SCORES[len(calls)])

    monkeypatch.setattr(cli, "run_cli_trial", record)
    monkeypatch.setattr(cli, "create_study", lambda study_name: pkg_search.create_study(
        study_name, storage_dir=str(tmp_path / name), seed=4))
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(argv) == 0
    return calls


CASES = {
    "yolo": (yolo_hyper, jyolo_hyper, "yolo_train",
             ["--model_cfg", "cfg/x.cfg", "--num_trials", str(N_TRIALS), "--loss_study",
              "--ts_study", "--optimizer_study", "--weights_path", "w.weights"]),
    "yolo_defaults": (yolo_hyper, jyolo_hyper, "yolo_train",
                      ["--model_cfg", "m.cfg", "--num_trials", "2"]),
    "rektnet": (rektnet_hyper, jrektnet_hyper, "rektnet_train",
                ["--num_trials", str(N_TRIALS), "--geo_loss_study", "--loss_type_study",
                 "--num_epochs", "3", "--study_name", "st"]),
    "rektnet_defaults": (rektnet_hyper, jrektnet_hyper, "rektnet_train", ["--num_trials", "2"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("device", [None, "cpu"])
def test_hyper_clis_build_the_jax_trial_commands(monkeypatch, tmp_path, case, device):
    cli, jcli, train, argv = CASES[case]
    got = _recorded_arglists(monkeypatch, tmp_path, cli, search,
                             argv + (["--device", device] if device else []), "port")
    want = _recorded_arglists(monkeypatch, tmp_path, jcli, jsearch, argv, "jax")
    assert len(got) == len(want) == int(argv[argv.index("--num_trials") + 1])
    for (g, g_score), (w, w_score) in zip(got, want):
        assert g_score == w_score
        assert [x.replace("mit_driverless_cv_traininginfra_tpu_torch.",
                          "mit_driverless_cv_traininginfra_tpu.") for x in g[:-1]] == w
        assert g[-1] == f"--device={device or 'cuda'}"
        assert f"mit_driverless_cv_traininginfra_tpu_torch.cli.{train}" in g


def _port_tool(name):
    path = os.path.join(ROOT, "mit_driverless_cv_traininginfra_tpu_torch", "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_tools_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_one_real_rektnet_trial_on_the_cpu(tmp_path):
    """``rektnet_hyper`` as a user runs it, in a subprocess, with one real
    ``cli/rektnet_train`` trial on 16 crops: the study holds one
    completed trial whose value is the score file's total distance."""
    data = tmp_path / "data"
    with contextlib.redirect_stdout(io.StringIO()):
        _port_tool("make_synth_dataset").main(
            ["--out", str(data), "--family", "rektnet", "--train", "13", "--val", "3",
             "--format", "npy"])
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "mit_driverless_cv_traininginfra_tpu_torch.cli.rektnet_hyper",
         "--num_trials", "1", "--num_epochs", "1", "--device", "cpu", "--study_name", "one",
         "--train_dataset_uri", str(data / "rektnet_label.csv"),
         "--dataset_path", str(data / "images")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "--device=cpu" in proc.stdout and "Trial 0 COMPLETE" in proc.stdout
    (trial,) = json.load(open(tmp_path / "studies" / "one.json"))["trials"]
    score = float(open(tmp_path / "logs" / "one.txt").read())
    assert trial["state"] == "COMPLETE" and math.isfinite(score) and trial["value"] == score
    assert list((tmp_path / "outputs").glob("*/best_keypoints_8080.onnx"))
