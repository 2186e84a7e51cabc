"""The PyTorch port never imports JAX: a fresh interpreter imports every
module of the port and serves the tiny slice on the CPU."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np, torch
import mit_driverless_cv_traininginfra_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from mit_driverless_cv_traininginfra_tpu.config import load_network_spec
from mit_driverless_cv_traininginfra_tpu_torch import _shared, convert
from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import TwoStageServer
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, rektnet, stem_opt

spec = load_network_spec("tests/fixtures/tiny_test.cfg", vanilla_anchor=True)
rng = np.random.default_rng(0)
yp, ys = convert.init_darknet_np(spec, rng)
rp, rs = convert.init_rektnet_np(rng, net_size=4)
spec1, folded = stem_opt.slice_preyolo(
    spec, darknet.fold_bn(convert.from_jax(yp), convert.from_jax(ys), spec))
yolo = darknet.Darknet(spec1, folded)
rekt = rektnet.RektNet(rektnet.fold_bn(convert.from_jax(rp), convert.from_jax(rs)))
frames, _ = _shared.synthetic().yolo_batch(rng, 2, 64, min_h=8, max_h=30)
policy = _shared.capacity().AdaptiveCapacity(floor=8, quantum=8)
server = TwoStageServer(yolo, rekt, conf_thresh=0.5, policy=policy)
server.warmup([2], capacities=[8])
out = server(frames)
assert out.keypoints.shape == (2, 16, 7, 2), out.keypoints.shape
assert server.stats()["calls"] == 1
assert "jax" not in sys.modules, "the port imported jax"
print("no-jax ok")
"""


def test_port_runs_without_importing_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax ok" in proc.stdout
