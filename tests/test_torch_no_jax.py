"""The PyTorch port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of the port, serves the tiny
slice on the CPU in f32 and in int8 (quantized by the port itself), serves
a frame through the ``MicroBatcher``, detects on an image of another size,
runs the serve CLI on weights the port writes, takes a RektNet training
step and a YOLO training step (a ``TrainDarknet``) and validates it,
runs the plain residual stage and the plain routes of probes on each
of the four probe kernels; then neither
``jax`` nor any ``mit_driverless_cv_traininginfra_tpu`` module may be in
``sys.modules``. An AST walk over the port's files and ``chip_smoke.py``
finds no import of the JAX package and no path into its directory."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "mit_driverless_cv_traininginfra_tpu"
PORT = Path(REPO) / "mit_driverless_cv_traininginfra_tpu_torch"

SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np, torch
import mit_driverless_cv_traininginfra_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import load_network_spec
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import AdaptiveCapacity
from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import TwoStageServer
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, quantize, rektnet, stem_opt
from mit_driverless_cv_traininginfra_tpu_torch.ops import resstage
from mit_driverless_cv_traininginfra_tpu_torch.train import optim, steps

spec = load_network_spec("tests/fixtures/tiny_test.cfg", vanilla_anchor=True)
rng = np.random.default_rng(0)
yp, ys = convert.init_darknet_np(spec, rng)
rp, rs = convert.init_rektnet_np(rng, net_size=4)
spec1, folded = stem_opt.slice_preyolo(
    spec, darknet.fold_bn(convert.from_jax(yp), convert.from_jax(ys), spec))
yolo = darknet.Darknet(spec1, folded)
rekt = rektnet.RektNet(rektnet.fold_bn(convert.from_jax(rp), convert.from_jax(rs)))
frames, ytargets = synthetic.yolo_batch(rng, 2, 64, min_h=8, max_h=30)
server = TwoStageServer(yolo, rekt, conf_thresh=0.5,
                        policy=AdaptiveCapacity(floor=8, quantum=8))
server.warmup([2], capacities=[8])
out = server(frames)
assert out.keypoints.shape == (2, 16, 7, 2), out.keypoints.shape
assert server.stats()["calls"] == 1

rfolded = rektnet.fold_bn(convert.from_jax(rp), convert.from_jax(rs))
amax = quantize.calibrate(spec1, folded, frames)
crops = rng.uniform(0, 1, (4, 80, 80, 3)).astype(np.float32)
rq = quantize.quantize_rektnet_params(rfolded,
                                      quantize.calibrate_rektnet(rfolded, crops))
yolo_q = quantize.Int8Darknet(spec1, quantize.quantize_params(spec1, folded, amax))
server = TwoStageServer(yolo_q, quantize.Int8RektNet(rq), conf_thresh=0.5,
                        policy=AdaptiveCapacity(floor=8, quantum=8))
server.warmup([2], capacities=[8])
out = server(torch.from_numpy((frames * 255).astype(np.uint8)))
assert out.keypoints.shape == (2, 16, 7, 2), out.keypoints.shape

model = rektnet.KeypointNet(*rektnet.init(torch.Generator().manual_seed(0), net_size=4))
opt = optim.make_optimizer(model.parameters(), "Adam", lr=1e-3)
imgs, pts = synthetic.rektnet_batch(rng, 2)
total, _, _ = steps.rektnet_train_step(model, opt, torch.from_numpy(imgs), None,
                                       torch.from_numpy(pts), synth_target_sigma=1.0)
assert torch.isfinite(total)

import contextlib, io
from mit_driverless_cv_traininginfra_tpu_torch.train.yolo_driver import validate_map
ymodel = darknet.TrainDarknet(spec, *darknet.init_params(spec, torch.Generator().manual_seed(0)))
yopt = optim.make_optimizer(ymodel.parameters(), "Adam", lr=1e-3)
loss, comps = steps.yolo_train_step(ymodel, yopt, torch.from_numpy(frames),
                                    torch.from_numpy(ytargets), compute_dtype="bfloat16")
assert torch.isfinite(loss) and comps.shape == (6,)
with contextlib.redirect_stdout(io.StringIO()):
    validate_map(data_loader=[(["a", "b"], frames, ytargets)], model=ymodel, device="cpu")

n, c, s = 2, 64, 5
pk = {"w1_k": torch.ones((n, c // 2, c), dtype=torch.int8),
      "w3_k": torch.ones((n, c, 9 * c // 2), dtype=torch.int8),
      "s1": torch.full((n, c // 2), 1e-3), "b1": torch.zeros((n, c // 2)),
      "s3": torch.full((n, c), 1e-4), "b3": torch.zeros((n, c)),
      "sx1": torch.full((n,), 20.0), "sx3": torch.full((n,), 20.0),
      "sx_out": torch.full((1,), 20.0)}
x = resstage.res_stage_pre(torch.randn(2, s, s, c))
yq, ybf = resstage.fused_res_stage(x, pk, s, n, 0.1)
assert yq.shape == ybf.shape == x.shape

# the serving runtime around the pipeline: a MicroBatcher over the server,
# the detection path, and the serve CLI on weights the port writes itself
from mit_driverless_cv_traininginfra_tpu_torch.infer.detect import detect_image
from mit_driverless_cv_traininginfra_tpu_torch.infer.microbatch import MicroBatcher
with MicroBatcher(server, bucket_sizes=(2,)) as mb:
    res = mb.submit((frames[0] * 255).astype(np.uint8)).result(timeout=120)
assert res["keypoints"].shape == (16, 7, 2), res["keypoints"].shape
boxes, scores = detect_image(yolo, rng.integers(0, 256, (48, 80, 3), dtype=np.uint8),
                             conf_thresh=0.5)
assert boxes.shape[1:] == (4,) and scores.shape == boxes.shape[:1]
import contextlib, io, json, tempfile
from mit_driverless_cv_traininginfra_tpu_torch.cli import serve
from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import save_rektnet_pt
with tempfile.TemporaryDirectory() as tmp:
    darknet.save_darknet_weights(spec, convert.from_jax(yp), convert.from_jax(ys),
                                 tmp + "/y.weights")
    save_rektnet_pt(tmp + "/r.pt", rektnet.KeypointNet(convert.from_jax(rp),
                                                      convert.from_jax(rs)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--source", "synthetic:3", "--model_cfg",
                         "tests/fixtures/tiny_test.cfg", "--vanilla_anchor",
                         "--yolo_weights", tmp + "/y.weights", "--rektnet_weights",
                         tmp + "/r.pt", "--precision", "int8", "--batch_size", "2",
                         "--calib_frames", "2", "--max_det", "4", "--capacities", "8",
                         "--device", "cpu", "--assert_no_compiles"])
    assert rc == 0 and json.loads(out.getvalue().splitlines()[-1])["frames"] == 3

from mit_driverless_cv_traininginfra_tpu_torch.probes import BY_NAME, PLAIN
for name in ("tail", "P22", "P16", "Q16", "D3", "P13c"):
    probe = BY_NAME[name]
    probe.run(probe.build("cpu", small=True), PLAIN)
for mod in ("ops.tail_conv", "ops.window_resample", "ops.int8_contract",
            "ops.strided_map", "probes.mosaic", "probes.crop", "probes.tail_conv1",
            "probes.run", "cli.serve", "infer.microbatch", "infer.detect",
            "ops.nms", "data.decode", "utils.logger", "models.yolo_loss",
            "ops.metrics", "data.loader", "train.yolo_driver", "utils.profiling"):
    assert "mit_driverless_cv_traininginfra_tpu_torch." + mod in sys.modules, mod

assert "jax" not in sys.modules, "the port imported jax"
jax_pkg = [m for m in sys.modules
           if m == "mit_driverless_cv_traininginfra_tpu"
           or m.startswith("mit_driverless_cv_traininginfra_tpu.")]
assert not jax_pkg, f"the port imported the JAX package: {jax_pkg}"
print("no-jax ok")
"""


def test_port_runs_without_importing_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax ok" in proc.stdout


# a file:line label of a TPU kernel (chip_smoke.py's "replaces" field) is a
# reference, not a path the program opens
_KERNEL_REF = re.compile(rf"{JAX_PKG}/[\w/]+\.py:\d+")


def _jax_package_uses(tree: ast.AST):
    """Imports of the JAX package, and string constants that name it or a
    path inside it (as ``importlib``, ``open`` or a ``Path`` would take
    them), in one parsed file."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == JAX_PKG or alias.name.startswith(JAX_PKG + "."):
                    yield node.lineno, f"import {alias.name}"
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module == JAX_PKG or node.module.startswith(JAX_PKG + "."):
                yield node.lineno, f"from {node.module} import ..."
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            v = node.value.strip()
            if (v in (JAX_PKG, JAX_PKG + "/")
                    or (v.startswith((JAX_PKG + ".", JAX_PKG + "/"))
                        and not _KERNEL_REF.fullmatch(v))):
                yield node.lineno, repr(v)


def _port_files():
    """The port's committed Python files (not its git-ignored ``build/``)
    and ``chip_smoke.py``."""
    files = [p for p in PORT.rglob("*.py") if "build" not in p.relative_to(PORT).parts]
    return sorted(files) + [Path(REPO) / "chip_smoke.py"]


def test_no_file_of_the_port_reaches_into_the_jax_package():
    files = _port_files()
    assert len(files) > 30 and Path(REPO, "chip_smoke.py") in files
    found = {str(p.relative_to(REPO)): hits for p in files
             if (hits := list(_jax_package_uses(ast.parse(p.read_text(), str(p)))))}
    assert not found, found


def test_the_walk_finds_what_it_looks_for():
    src = (f"import {JAX_PKG}.config\nfrom {JAX_PKG}.ops import x\n"
           f"p = root / '{JAX_PKG}'\nq = '{JAX_PKG}/data/synthetic.py'\n"
           f"r = '{JAX_PKG}/ops/pallas_crop.py:173'\n")
    assert sorted(line for line, _ in _jax_package_uses(ast.parse(src))) == [1, 2, 3, 4]
