"""The PyTorch port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of the port, serves the tiny
slice on the CPU in f32 and in int8 (quantized by the port itself), serves
a frame through the ``MicroBatcher``, detects on an image of another size,
runs the serve CLI on weights the port writes, takes a RektNet training
step and a YOLO training step (a ``TrainDarknet``) and validates it,
runs the plain residual stage and the plain routes of probes on each
of the four probe kernels; then neither
``jax`` nor any ``mit_driverless_cv_traininginfra_tpu`` module may be in
``sys.modules``. Another fresh interpreter reads items of the YOLO disk
dataset with every host augmentation (``.npy`` frames, k-means CSVs) and
takes a device-aug step from a device pool, with neither ``jax`` nor PIL
nor OpenCV in ``sys.modules``. A third, with ``jax``, PIL, OpenCV and
pandas blocked in ``sys.modules`` (an import of any raises), imports the
RektNet disk path, the visualisations, the evaluation CLIs, the port's
dataset and evaluation tools and ``chip_smoke.py``, reads ``.npy`` crops
through ``ConeDataset``, draws and writes a ``utils/vis`` render, trains
RektNet one epoch from disk, and runs the detect, pipeline and validate
CLIs and both evaluation tools on the CPU. A fourth, with ``jax``,
``optax``, PIL, OpenCV and pandas blocked, exports both models and their
CLIs' files, runs them through the numpy evaluator, runs a TPE study and
both sweep CLIs (trials recorded, not run) and both families of
``tools/train_to_map.py`` at tiny sizes. An AST walk over the port's files
and ``chip_smoke.py`` finds no import of ``jax``, ``optax`` or the JAX
package and no path into the JAX package's directory."""

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
            "ops.metrics", "data.loader", "train.yolo_driver", "utils.profiling",
            "data.uri", "data.yolo_csv", "data.raster", "data.augment",
            "data.yolo_dataset", "data.kmeans_anchors", "data.device_pool",
            "ops.patches", "ops.device_aug", "cli.yolo_train", "cli.kmeans_csvs",
            "parallel.mesh", "parallel.launch", "parallel.dryrun", "infer.pp"):
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


DISK_SCRIPT = r"""
import contextlib, io, os, sys, tempfile
import numpy as np, torch
from mit_driverless_cv_traininginfra_tpu_torch.cli import kmeans_csvs
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import load_network_spec
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.data.device_pool import DevicePool
from mit_driverless_cv_traininginfra_tpu_torch.data.yolo_csv import YoloCsvRow, write_yolo_csv
from mit_driverless_cv_traininginfra_tpu_torch.data.yolo_dataset import ImageLabelDataset
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet
from mit_driverless_cv_traininginfra_tpu_torch.ops.device_aug import sample_draws
from mit_driverless_cv_traininginfra_tpu_torch.train import optim, steps

rng = np.random.default_rng(0)
with tempfile.TemporaryDirectory() as tmp:
    rows = []
    for k in range(6):
        img, boxes = synthetic.cone_scene(rng, size=96, min_h=8, max_h=40)
        np.save(f"{tmp}/s{k}.npy", (img * 255).astype(np.uint8))
        xywh = np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 3] - boxes[:, 1],
                         boxes[:, 2] - boxes[:, 0]], 1)
        rows.append(YoloCsvRow(f"s{k}.npy", 96, 96, 1.0, xywh))
    write_yolo_csv(f"{tmp}/all.csv", rows)
    with contextlib.redirect_stdout(io.StringIO()):
        kmeans_csvs.main(["--input_csvs", f"{tmp}/all.csv", "--dataset_path", tmp,
                          "--output_path", tmp, "--num_clst", "4", "--split_up", "4-2-0",
                          "--no_if_plot"])
    kw = dict(augment_affine=True, augment_hsv=True, lr_flip=True, data_aug=True,
              blur=True, noise=True, contrast=True, sharpen=True)
    ds = ImageLabelDataset(f"{tmp}/train.csv", tmp, 64, 64, **kw)
    for i in range(len(ds)):
        uri, img, labels = ds[i]
        assert img.shape == (64, 64, 3) and np.isfinite(img).all(), img.shape
    pool = DevicePool.from_dataset(ImageLabelDataset(f"{tmp}/train.csv", tmp, 64, 64,
                                                     device_aug=True, augment_affine=True),
                                   device="cpu", dtype=torch.bfloat16)
    _, imgs, labels = next(iter(pool.loader(2, seed=1)))
    spec = load_network_spec("tests/fixtures/tiny_test.cfg", vanilla_anchor=True)
    model = darknet.TrainDarknet(spec, *darknet.init_params(spec, torch.Generator().manual_seed(0)))
    opt = optim.make_optimizer(model.parameters(), "Adam", lr=1e-3)
    draws = sample_draws(torch.Generator().manual_seed(2), *imgs.shape, noise=True)
    loss, comps = steps.yolo_train_step_device_aug(model, opt, imgs, torch.from_numpy(labels),
                                                   draws, compute_dtype="bfloat16")
    assert torch.isfinite(loss) and comps.shape == (6,)
found = [m for m in sys.modules if m.split(".")[0] in ("jax", "PIL", "cv2")
         or m.startswith("mit_driverless_cv_traininginfra_tpu.")]
assert not found, found
print("no-jax-pil-cv2 ok")
"""


def test_disk_dataset_and_device_aug_step_need_no_jax_pil_or_cv2():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", DISK_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax-pil-cv2 ok" in proc.stdout


BLOCKED_SCRIPT = r"""
import sys
for name in ("jax", "PIL", "cv2", "pandas"):
    sys.modules[name] = None  # an import of any of them raises ImportError
import contextlib, importlib.util, io, json, os, tempfile
import numpy as np, torch
import chip_smoke
from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.cli import (pipeline, rektnet_detect,
    rektnet_train, yolo_detect, yolo_validate)
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import load_network_spec
from mit_driverless_cv_traininginfra_tpu_torch.data import encode, raster, rektnet_data, synthetic
from mit_driverless_cv_traininginfra_tpu_torch.data.loader import DataLoader
from mit_driverless_cv_traininginfra_tpu_torch.data.yolo_csv import YoloCsvRow, write_yolo_csv
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, rektnet
from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import save_rektnet_pt
from mit_driverless_cv_traininginfra_tpu_torch.utils import draw, vis

def tool(name):
    spec = importlib.util.spec_from_file_location(
        name, f"{REPO}/mit_driverless_cv_traininginfra_tpu_torch/tools/{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m

cpu = ["--device", "cpu"]
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
    os.chdir(tmp)
    tool("make_synth_dataset").main(["--out", "rk", "--family", "rektnet", "--train", "4",
                                     "--val", "2", "--format", "npy"])
    ratio = str(json.load(open("rk/meta.json"))["validation_ratio"])
    ti, tl, vi, vl = rektnet_data.load_train_csv_dataset("rk/rektnet_label.csv", float(ratio),
                                                         dataset_path="rk/images")
    imgs, hms, pts, names, sizes = next(iter(DataLoader(
        rektnet_data.ConeDataset(ti, tl, "rk/images"), 4, shuffle=False, num_workers=2,
        collate=rektnet_data.collate_cones)))
    assert imgs.shape == (4, 80, 80, 3) and hms.shape == (4, 7, 80, 80) and len(vi) == 2
    assert vis.visualize_dataset(ti[:1], tl[:1], "rk/images", "vis") == 1
    assert open("vis/" + ti[0], "rb").read()[:2] == b"\xff\xd8"
    common = ["--train_dataset_uri", "rk/rektnet_label.csv", "--dataset_path", "rk/images",
              "--validation_ratio", ratio, "--batch_size", "2", "--lr", "1e-3"]
    rektnet_train.main(common + ["--num_epochs", "2", "--checkpoint_interval", "2",
                                 "--output_path", "run"] + cpu)
    pt = "run/" + [f for f in os.listdir("run") if f.startswith("1_loss")][0]
    rektnet_detect.main(["--model", pt, "--img", "rk/images/" + vi[0], "--output", "det"] + cpu)
    tool("eval_rektnet_weights").main(["--pt", pt, "--n", "2", "--csv", "rk/rektnet_label.csv",
                                       "--images", "rk/images", "--ratio", ratio] + cpu)
    rng = np.random.default_rng(0)
    rows = []
    for k in range(2):
        img, boxes = synthetic.cone_scene(rng, size=96, min_h=8, max_h=40)
        np.save(f"s{k}.npy", (img * 255).astype(np.uint8))
        rows.append(YoloCsvRow(f"s{k}.npy", 96, 96, 1.0, np.stack(
            [boxes[:, 0], boxes[:, 1], boxes[:, 3] - boxes[:, 1], boxes[:, 2] - boxes[:, 0]], 1)))
    write_yolo_csv("val.csv", rows)
    cfg = open(REPO + "/tests/fixtures/tiny_test.cfg").read().replace(
        "validate_uri=\n", "validate_uri=val.csv\n")
    open("tiny.cfg", "w").write(cfg)
    spec = load_network_spec("tiny.cfg", vanilla_anchor=True)
    yp, ys = convert.init_darknet_np(spec, rng)
    darknet.save_darknet_weights(spec, convert.from_jax(yp), convert.from_jax(ys), "y.weights")
    det = ["--model_cfg", "tiny.cfg", "--vanilla_anchor"]
    pipeline.main(det + ["--target_path", "s0.npy", "--yolo_weights", "y.weights",
                         "--rektnet_weights", pt, "--output_path", "pl", "--conf_thres",
                         "0.3"] + cpu)
    assert np.load("pl/pipeline_s0.npy").shape == (96, 96, 3)
    yolo_detect.main(det + ["--target_path", "s1.npy", "--weights_path", "y.weights",
                            "--output_path", "yd"] + cpu)
    yolo_validate.main(det + ["--weights_path", "y.weights", "--dataset_path", ".",
                              "--num_workers", "1"] + cpu)
    tool("eval_weights").main(["--weights", "y.weights", "--model_cfg", "tiny.cfg", "--n", "2"]
                              + cpu)
    os.chdir(REPO)
found = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "PIL", "cv2", "pandas")
    or m.startswith("mit_driverless_cv_traininginfra_tpu."))]
assert not found, found
print("blocked ok")
"""


def test_disk_rektnet_vis_and_eval_clis_need_no_jax_pil_cv2_or_pandas():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", f"REPO = {REPO!r}\n" + BLOCKED_SCRIPT],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "blocked ok" in proc.stdout


# a file:line label of a TPU kernel (chip_smoke.py's "replaces" field) is a
# reference, not a path the program opens
_KERNEL_REF = re.compile(rf"{JAX_PKG}/[\w/]+\.py:\d+")


FORBIDDEN_ROOTS = (JAX_PKG, "jax", "jaxlib", "optax")


def _jax_package_uses(tree: ast.AST):
    """Imports of the JAX package, ``jax``, ``jaxlib`` or ``optax``, and
    string constants that name the JAX package or a path inside it (as
    ``importlib``, ``open`` or a ``Path`` would take them), in one parsed
    file."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] in FORBIDDEN_ROOTS:
                    yield node.lineno, f"import {alias.name}"
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module.split(".")[0] in FORBIDDEN_ROOTS:
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
    names = {str(p.relative_to(PORT)) for p in files if PORT in p.parents}
    assert {"export/onnx_writer.py", "export/onnx_eval.py", "export/yolo2onnx.py",
            "export/pt_to_onnx.py", "hyper/search.py", "cli/yolo2onnx.py",
            "cli/pt_to_onnx.py", "cli/yolo_hyper.py", "cli/rektnet_hyper.py",
            "tools/train_to_map.py", "parallel/mesh.py", "parallel/launch.py",
            "parallel/dryrun.py", "infer/pp.py"} <= names
    found = {str(p.relative_to(REPO)): hits for p in files
             if (hits := list(_jax_package_uses(ast.parse(p.read_text(), str(p)))))}
    assert not found, found


def test_the_walk_finds_what_it_looks_for():
    src = (f"import {JAX_PKG}.config\nfrom {JAX_PKG}.ops import x\n"
           f"p = root / '{JAX_PKG}'\nq = '{JAX_PKG}/data/synthetic.py'\n"
           f"r = '{JAX_PKG}/ops/pallas_crop.py:173'\n"
           "import jax.numpy as jnp\nfrom optax import adam\nimport jaxlib\n"
           "import jaxtyping, optaxx\n")
    assert sorted(line for line, _ in _jax_package_uses(ast.parse(src))) == [1, 2, 3, 4, 6,
                                                                              7, 8]


EXPORT_HYPER_SCRIPT = r"""
import sys
for name in ("jax", "optax", "PIL", "cv2", "pandas"):
    sys.modules[name] = None  # an import of any of them raises ImportError
import contextlib, importlib.util, io, json, os, tempfile
import numpy as np, torch
from mit_driverless_cv_traininginfra_tpu_torch.cli import (pt_to_onnx, rektnet_hyper,
    yolo2onnx, yolo_hyper)
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import load_network_spec
from mit_driverless_cv_traininginfra_tpu_torch.export import onnx_writer
from mit_driverless_cv_traininginfra_tpu_torch.export.onnx_eval import run_model
from mit_driverless_cv_traininginfra_tpu_torch.hyper import search
from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, rektnet
from mit_driverless_cv_traininginfra_tpu_torch.train.checkpoints import save_rektnet_pt

spec = load_network_spec(REPO + "/tests/fixtures/tiny_test.cfg", vanilla_anchor=True)
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()), \
        contextlib.redirect_stderr(io.StringIO()):
    os.chdir(tmp)
    darknet.save_darknet_weights(spec, *darknet.init_params(spec, torch.Generator()), "y.weights")
    yolo2onnx.main(["--cfg_name", REPO + "/tests/fixtures/tiny_test.cfg",
                    "--weights_name", "y.weights", "--output", "y.onnx"])
    save_rektnet_pt("r.pt", rektnet.KeypointNet(*rektnet.init(torch.Generator(), net_size=4)))
    pt_to_onnx.main(["--model", "r.pt"])
    parsed = onnx_writer.parse_model(open("y.onnx", "rb").read())
    x = np.zeros((1, 3, spec.net.onnx_height, spec.net.width), np.float32)
    assert len(run_model(parsed, {"000_net": x})) == 2
    out = run_model(onnx_writer.parse_model(open("r.onnx", "rb").read()),
                    {"input": np.zeros((1, 3, 80, 80), np.float32)})["out"]
    assert out.shape == (1, 7, 80, 80)
    study = search.create_study("s", seed=0)
    study.optimize(lambda t: t.suggest_uniform("x", 0, 1), n_trials=2)
    assert len(study.trials) == 2
    for cli, argv in ((yolo_hyper, ["--model_cfg", "m.cfg", "--num_trials", "1"]),
                      (rektnet_hyper, ["--num_trials", "1"])):
        cli.run_cli_trial = lambda arglist, score_file: 1.0
        assert cli.main(argv + ["--device", "cpu"]) == 0
    spec_ = importlib.util.spec_from_file_location(
        "ttm", REPO + "/mit_driverless_cv_traininginfra_tpu_torch/tools/train_to_map.py")
    ttm = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(ttm)
    ttm.RK_POOL, ttm.RK_EVAL, ttm.RK_CALIB = 8, 4, 4
    assert ttm.main(["--steps", "1", "--size", "64", "--pool", "2", "--batch", "1",
                     "--eval-n", "2", "--device", "cpu"]) == 0
    assert ttm.main(["--family", "rektnet", "--steps", "3", "--batch", "2",
                     "--device", "cpu"]) == 0
    os.chdir(REPO)
for m in ("export.onnx_eval", "export.yolo2onnx", "export.pt_to_onnx", "hyper.search",
          "models.quantize", "train.steps"):
    assert "mit_driverless_cv_traininginfra_tpu_torch." + m in sys.modules, m
found = [m for m, v in sys.modules.items() if v is not None and (
    m.split(".")[0] in ("jax", "optax", "PIL", "cv2", "pandas")
    or m.startswith("mit_driverless_cv_traininginfra_tpu."))]
assert not found, found
print("export-hyper ok")
"""


def test_export_hyper_and_train_to_map_need_no_jax_or_optax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", f"REPO = {REPO!r}\n" + EXPORT_HYPER_SCRIPT],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "export-hyper ok" in proc.stdout

