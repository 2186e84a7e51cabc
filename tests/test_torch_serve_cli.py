"""The port's serve CLI (``cli/serve.py``) against the JAX package's, on
the CPU (``--device cpu``), f32, on the tiny Darknet cfg with a ``.weights``
and a ``.pt`` written by the JAX package's savers (as
``tests/test_serve_cli.py`` sets them up). The frames are model-sized, so
no resize enters the comparison: the CSV rows must match within the
pipeline's tolerance and %.2f rounding, and the JSON summary must carry the
JAX CLI's keys."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import TINY_CFG, gap_threshold
from mit_driverless_cv_traininginfra_tpu.cli import serve as jserve
from mit_driverless_cv_traininginfra_tpu.config import load_network_spec
from mit_driverless_cv_traininginfra_tpu.models import darknet as jdarknet
from mit_driverless_cv_traininginfra_tpu.models import rektnet as jrektnet
from mit_driverless_cv_traininginfra_tpu.models.stem_opt import slice_preyolo
from mit_driverless_cv_traininginfra_tpu.train.checkpoints import (
    save_rektnet_pt,
)
from mit_driverless_cv_traininginfra_tpu_torch.cli import serve
from mit_driverless_cv_traininginfra_tpu_torch.data.synthetic import yolo_batch

# the JAX summary keys the port leaves out: the TPU crop window's watch
LEFT_OUT = {"oversize_boxes", "oversize_observed", "crop_kernel_active",
            "crop_kernel_switches"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Weights, a directory of five 64×64 PNG frames, the same frames as
    ``.npy``, and for each source a confidence threshold in a gap of its
    frames' confidences."""
    d = tmp_path_factory.mktemp("serve_cli")
    spec = load_network_spec(TINY_CFG, vanilla_anchor=True)
    params, state = jdarknet.init_params(spec, jax.random.PRNGKey(0))
    jdarknet.save_darknet_weights(spec, params, state, str(d / "tiny.weights"))
    rp, rs = jrektnet.init(jax.random.PRNGKey(1))
    save_rektnet_pt(str(d / "rekt.pt"), rp, rs)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (5, 64, 64, 3), dtype=np.uint8)
    (d / "imgs").mkdir()
    (d / "npy").mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(d / "imgs" / f"f{i}.png")
        np.save(d / "npy" / f"f{i}.npy", f)
    sspec, folded = slice_preyolo(spec, jdarknet.fold_bn(params, state, spec))

    def thresh(u8):
        """A confidence threshold in a gap of these frames' confidences,
        ~3 candidates a frame."""
        conf = np.asarray(jdarknet.detections(
            sspec, folded, {}, jnp.asarray(u8, jnp.float32) / 255.0,
            with_classes=False)[..., 4])
        return gap_threshold(conf, 3)

    syn, _ = yolo_batch(np.random.default_rng(42), 6, size=64)
    return d, {"imgs": thresh(frames), "npy": thresh(frames),
               "synthetic:6": thresh((syn * 255).astype(np.uint8)),
               "synthetic:4": thresh((syn[:4] * 255).astype(np.uint8))}


def _args(files, source, csv, *extra):
    d, thresh = files
    return ["--source", source, "--model_cfg", TINY_CFG,
            "--yolo_weights", str(d / "tiny.weights"),
            "--rektnet_weights", str(d / "rekt.pt"),
            "--conf_thres", repr(thresh[source.rsplit("/", 1)[-1]]),
            "--max_det", "4",
            "--capacities", "8", "--vanilla_anchor", "--output_csv", str(csv),
            *extra]


def _run(main, args, capsys):
    assert main(args) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], {tuple(l.split(",")[:2]):
                      np.array([float(x) for x in l.split(",")[2:] if x != ""])
                      for l in lines[1:]}


def _same_csv(a, b):
    (ha, ra), (hb, rb) = _rows(a), _rows(b)
    assert ha == hb
    assert set(ra) == set(rb) and ra       # same (frame, det) detections
    for k in ra:
        assert ra[k].size == rb[k].size
        # f32 pipelines within 1e-3 px, printed with %.2f
        np.testing.assert_allclose(ra[k], rb[k], rtol=0, atol=0.02)


def _same_keys(port, ref):
    assert set(ref) - set(port) == LEFT_OUT
    assert set(port) - set(ref) == {"graphs", "replays"}


@pytest.mark.parametrize("source", ["imgs", "synthetic:6"])
def test_batched_stream_matches_jax(files, tmp_path, capsys, source):
    d, _ = files
    src = str(d / source) if source == "imgs" else source
    extra = ("--precision", "f32", "--batch_size", "4")
    port = _run(serve.main, _args(files, src, tmp_path / "p.csv", *extra,
                                  "--device", "cpu"), capsys)
    ref = _run(jserve.main, _args(files, src, tmp_path / "j.csv", *extra),
               capsys)
    _same_csv(tmp_path / "p.csv", tmp_path / "j.csv")
    _same_keys(port, ref)
    for k in ("frames", "calls", "compiles", "batch_pads", "observations",
              "warmed_buckets", "mean_load"):
        assert port[k] == ref[k], k
    assert port["batch_pads"] == 1 and port["compiles"] == 0


def test_latency_mode_matches_jax(files, tmp_path, capsys):
    d, _ = files
    extra = ("--precision", "f32", "--latency_mode", "--latency_buckets",
             "1,2", "--cameras", "2", "--assert_no_compiles")
    port = _run(serve.main, _args(files, str(d / "imgs"), tmp_path / "p.csv",
                                  *extra, "--device", "cpu"), capsys)
    ref = _run(jserve.main, _args(files, str(d / "imgs"), tmp_path / "j.csv",
                                  *extra), capsys)
    _same_csv(tmp_path / "p.csv", tmp_path / "j.csv")
    _same_keys(port, ref)
    assert port["mode"] == "latency" and port["frames"] == 5
    assert port["compiles"] == 0
    lat = port["request_frame_ms"]
    assert lat is not None and lat["99"] >= lat["50"] > 0
    assert port["microbatch"]["frames"] == 5
    assert set(port["microbatch"]) == set(ref["microbatch"])


def test_int8_device_cache_asserts_no_compiles(files, capsys, tmp_path):
    """int8 calibrated on the synthetic stream's lead frames, the scenes
    staged once and cycled three times, two batches in flight."""
    summary = _run(serve.main, _args(
        files, "synthetic:4", tmp_path / "p.csv", "--syn_repeat", "3",
        "--device_cache", "--inflight", "2", "--precision", "int8",
        "--batch_size", "2", "--calib_frames", "2", "--assert_no_compiles",
        "--device", "cpu"), capsys)
    assert summary["frames"] == 12 and summary["calls"] == 6
    assert summary["compiles"] == 0


def test_uint8_and_npy_feeds_match(files, tmp_path, capsys):
    """The uint8 wire feed (normalised as ``x · fl(1/255)``) against the
    host's f32 ``/ 255`` feed: the two differ by ≤ 1 ulp of a pixel, far
    inside %.2f, so the CSVs are equal; and ``.npy`` frames serve as the
    PNGs do."""
    d, _ = files
    out = {}
    for name, src, feed in (("u8", "imgs", "--feed_uint8"),
                            ("f32", "imgs", "--no_feed_uint8"),
                            ("npy", "npy", "--feed_uint8")):
        csv = tmp_path / f"{name}.csv"
        _run(serve.main, _args(files, str(d / src), csv, feed, "--precision",
                               "f32", "--batch_size", "2", "--device", "cpu"),
             capsys)
        out[name] = csv.read_text()
    assert out["u8"] == out["f32"] == out["npy"]


def test_device_defaults_to_cuda_and_left_out_flags_are_named(files, tmp_path):
    parser = serve._parser()
    assert parser.parse_args(["--source", "x", "--yolo_weights", "w",
                              "--rektnet_weights", "r"]).device == "cuda"
    for flag in ("--mesh", "--crop_kernel", "--syn_oversize_tail"):
        assert flag in parser.format_help()
    if not torch.cuda.is_available():   # no fallback to the CPU
        d, _ = files
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(_args(files, str(d / "imgs"), tmp_path / "p.csv"))
