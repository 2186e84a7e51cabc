"""The serving layer on the card: each warmed bucket's CUDA graph against
the eager pipeline, bit for bit, and the repairs' card side. Marked
``gpu``: without a CUDA device every test skips. This file imports no JAX,
so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_serving.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mit_driverless_cv_traininginfra_tpu_torch import convert
from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import (
    flagship_spec,
)
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic
from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import (
    AdaptiveCapacity,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (
    normalize_u8,
    two_stage_pipeline,
)
from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import (
    TwoStageServer,
)
from mit_driverless_cv_traininginfra_tpu_torch.models import (
    darknet,
    quantize,
    rektnet,
    stem_opt,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops import entry
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_crop import roi_crop
from mit_driverless_cv_traininginfra_tpu_torch.ops.cuda_kernels import (
    fused_softargmax,
    nms_topk,
)

pytestmark = pytest.mark.gpu

SIZE, B, MAX_DET = 64, 4, 16   # YOLOv3 at 64² takes the fused int8 entry


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _folded(seed: int = 0):
    spec = flagship_spec(SIZE, classes=1)
    rng = np.random.default_rng(seed)
    yp, ys = convert.init_darknet_np(spec, rng)
    rp, rs = convert.init_rektnet_np(rng, net_size=4)
    spec1, folded = stem_opt.slice_preyolo(
        spec, darknet.fold_bn(convert.from_jax(yp), convert.from_jax(ys), spec))
    return spec1, folded, rektnet.fold_bn(convert.from_jax(rp),
                                          convert.from_jax(rs))


def _amax(spec, folded, rfolded, frames):
    """One calibration, on the CPU, shared by both devices."""
    crops = np.random.default_rng(1).uniform(0, 1, (4, 80, 80, 3)).astype(
        np.float32)
    return (quantize.calibrate(spec, folded, frames),
            quantize.calibrate_rektnet(rfolded, crops))


def build_setups(cuda):
    """(yolo, rekt, frames u8) on the card for "bf16" and "int8"."""
    spec, folded, rfolded = _folded()
    imgs, _ = synthetic.yolo_batch(np.random.default_rng(2), B, SIZE)
    u8 = torch.from_numpy((imgs * 255).astype(np.uint8))
    out = {"bf16": (darknet.Darknet(spec, folded).to(cuda, torch.bfloat16),
                    rektnet.RektNet(rfolded).to(cuda, torch.bfloat16), u8)}
    amax, ramax = _amax(spec, folded, rfolded, normalize_u8(u8))
    yolo = quantize.Int8Darknet(spec, quantize.quantize_params(spec, folded, amax),
                                entry.quantize_entry(folded, amax))
    rekt = quantize.Int8RektNet(quantize.quantize_rektnet_params(rfolded, ramax))
    out["int8"] = (yolo.to(cuda), rekt.to(cuda), u8)
    return out


@pytest.fixture(scope="module")
def setups(cuda):
    return build_setups(cuda)


def _thresh(yolo, frames) -> float:
    """A confidence threshold passing ~6 a frame, mid-gap."""
    if frames.dtype == torch.uint8:
        frames = normalize_u8(frames)
    with torch.inference_mode():
        conf = yolo(frames.to(yolo.frame_dtype))[..., 4].flatten().sort().values
    i = conf.numel() - 6 * frames.shape[0]
    return float((conf[i - 1] + conf[i]) / 2)


def _server(yolo, rekt, frames, **kw):
    kw.setdefault("policy", AdaptiveCapacity(floor=8, quantum=8,
                                             warmup_capacity=16))
    return TwoStageServer(yolo, rekt, conf_thresh=_thresh(yolo, frames),
                          max_det=MAX_DET, observe_every=2, **kw)


def _same_bits(a, b) -> bool:
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("B0", [B, 3], ids=["full", "short"])
@pytest.mark.parametrize("feed", ["uint8", "frame_dtype"])
@pytest.mark.parametrize("config", ["bf16", "int8"])
def test_graph_replay_equals_eager(setups, config, feed, B0):
    yolo, rekt, u8 = setups[config]
    frames = (u8 if feed == "uint8" else normalize_u8(u8)).to(yolo.device)
    frames = frames.to(torch.uint8 if feed == "uint8" else yolo.frame_dtype)
    server = _server(yolo, rekt, frames)
    server.warmup([B], capacities=[8, 16, 64], frame_dtype=frames.dtype)
    assert server.stats()["graphs"] == 3
    for _ in range(3):   # bootstrap, then deferred observations
        out = server(frames[:B0])
    padded = torch.cat([frames[:B0], frames.new_zeros((B - B0, *frames.shape[1:]))])
    ref = two_stage_pipeline(yolo, rekt, padded, conf_thresh=server.conf_thresh,
                             max_det=MAX_DET,
                             crop_capacity=server.current_capacity)
    torch.cuda.synchronize()
    assert int(ref.mask.sum()) > 0
    for name, a, b in zip(out._fields, out, ref):
        assert a.shape[0] == B0
        assert _same_bits(a, b[:B0]), name
    st = server.stats()
    assert st["replays"] == 3 and st["compiles"] == 0
    assert st["batch_pads"] == (0 if B0 == B else 3)


def test_replays_return_distinct_tensors_and_count_launches(setups):
    yolo, rekt, u8 = setups["int8"]
    frames = u8.to(yolo.device)
    server = _server(yolo, rekt, frames)
    server.warmup([B], capacities=[16], frame_dtype=torch.uint8)
    wrappers = (roi_crop, fused_softargmax, nms_topk, entry.fused_entry_block)
    before = [fn.launches for fn in wrappers]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a = server(frames)
        kept = [x.clone() for x in a]
        b = server(frames.flip(0))
        torch.cuda.synchronize()
    # a replay calls no wrapper; the device ran each kernel once a replay
    assert [fn.launches - n for fn, n in zip(wrappers, before)] == [0, 0, 0, 0]
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [sum(k in n for n in names) for k in
            ("roi_crop", "softargmax", "nms_topk", "entry_block")] == [2, 2, 2, 2]
    assert server.stats()["replays"] == 2
    for x, y, z in zip(a, b, kept):
        assert x.data_ptr() != y.data_ptr()
        assert _same_bits(x, z)          # the second replay left a alone
    assert _same_bits(b.mask, a.mask.flip(0))


def test_grown_bucket_is_captured_at_first_use(setups):
    yolo, rekt, u8 = setups["bf16"]
    frames = u8.to(yolo.device)
    server = _server(yolo, rekt, frames, grow_past_warmed=True,
                     policy=AdaptiveCapacity(floor=8, quantum=8, margin=1.0,
                                             warmup_capacity=8))
    server.warmup([B], capacities=[8], frame_dtype=torch.uint8)
    server(frames)
    for _ in range(4):
        server.policy.observe(30)
    out = server(frames)
    st = server.stats()
    assert server.current_capacity == 32 and st["compiles"] == 1
    assert st["graphs"] == 2 and st["replays"] == 2
    ref = two_stage_pipeline(yolo, rekt, frames, conf_thresh=server.conf_thresh,
                             max_det=MAX_DET, crop_capacity=32)
    assert all(_same_bits(a, b) for a, b in zip(out, ref))


def test_unwarmed_frame_dtype_is_captured_and_counted(setups):
    """A request in a dtype that warmup did not see, on a warmed (batch,
    capacity), is captured at its first use and counted in ``compiles``;
    the next one replays."""
    yolo, rekt, u8 = setups["bf16"]
    server = _server(yolo, rekt, u8.to(yolo.device))
    # one bucket, the largest: every want maps onto it
    server.warmup([B], capacities=[B * MAX_DET], frame_dtype=torch.uint8)
    frames = normalize_u8(u8.to(yolo.device)).to(yolo.frame_dtype)
    server(frames)
    st = server.stats()
    assert st["compiles"] == 1 and st["graphs"] == 2 and st["replays"] == 1
    server(frames)
    st = server.stats()
    assert st["compiles"] == 1 and st["graphs"] == 2 and st["replays"] == 2


CAPTURE_FAILS = r"""
import sys
import torch
sys.path.insert(0, "tests")
import test_torch_cuda_serving as t

cuda = torch.device("cuda")
yolo, rekt, u8 = t.build_setups(cuda)["bf16"]
frames = u8.to(cuda)
server = t._server(yolo, rekt, frames)
run = server._run
server._run = lambda f, cap: (run(f, cap), f.sum().item())[0]  # a host read
# the policy's first want is 16: the request goes to the failed bucket
for call in (lambda: server.warmup([t.B], capacities=[16], frame_dtype=torch.uint8),
             lambda: server(frames)):
    try:
        call()
    except RuntimeError:
        pass
    else:
        raise SystemExit("a capture with a host read did not raise")
assert not server.warmed and server.replays == 0, (server.warmed, server.replays)
print("capture failures raised")
"""


def test_a_failed_capture_raises(cuda):
    """A bucket whose capture fails raises at warmup and again at its first
    request: it is never served eagerly. In a process of its own (a failed
    capture may leave the context unusable)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", CAPTURE_FAILS], cwd=repo,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "capture failures raised" in proc.stdout


def test_quantized_leaves_equal_the_cpus(cuda):
    """For one amax, ``quantize_params``, ``quantize_entry`` and
    ``quantize_rektnet_params`` on the card give the CPU's leaves bit for
    bit (the weight scales are IEEE quotients on both)."""
    spec, folded, rfolded = _folded(3)
    imgs, _ = synthetic.yolo_batch(np.random.default_rng(4), 2, SIZE)
    amax, ramax = _amax(spec, folded, rfolded, torch.from_numpy(imgs))
    to = lambda t: {k: to(v) if isinstance(v, dict) else v.to(cuda)
                    for k, v in t.items()}
    for fn, a, b in ((quantize.quantize_params, (spec, folded), amax),
                     (lambda f, a: entry.quantize_entry(f, a), (folded,), amax),
                     (quantize.quantize_rektnet_params, (rfolded,), ramax)):
        cpu = fn(*a, b)
        card = fn(*(to(x) if isinstance(x, dict) else x for x in a), b)
        _tree_equal(card, cpu)


def _tree_equal(card, cpu, path=""):
    assert card.keys() == cpu.keys(), path
    for k in cpu:
        if isinstance(cpu[k], dict):
            _tree_equal(card[k], cpu[k], f"{path}/{k}")
        else:
            a, b = card[k].cpu(), cpu[k]
            assert a.dtype == b.dtype and a.shape == b.shape, f"{path}/{k}"
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8)), f"{path}/{k}"


def test_normalise_on_the_card_equals_the_cpu(cuda):
    u8 = torch.arange(256, dtype=torch.uint8)
    assert _same_bits(normalize_u8(u8.to(cuda)).cpu(), normalize_u8(u8))
