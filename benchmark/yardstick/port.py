"""The system under test, built from the benchmark's own weights: the
only module of the benchmark that imports the program (the PyTorch port).

The weight trees come from :mod:`.weights`; the program folds, slices,
calibrates and quantizes them itself, through its own constructors, as its
serve CLI does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import arch


def spec(cfg: dict):
    """The program's network spec of the configuration's YOLOv3, checked
    block for block against the benchmark's own layout."""
    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import ConvBlock, YoloBlock
    from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec

    det = cfg["detector"]
    sp = flagship_spec(det["input"], classes=det["classes"])
    ours = arch.conv_shapes(det)
    theirs = [(i, b.filters, b.size, b.stride) for i, b in enumerate(sp.blocks)
              if isinstance(b, ConvBlock)]
    want = [(c["block"], c["cout"], c["size"], c["stride"]) for c in ours]
    if theirs != want or len(sp.blocks) != len(arch.yolov3_blocks(det)):
        raise RuntimeError("the program's YOLOv3 spec differs from the configuration")
    heads = [(np.asarray(b.anchors, float).tolist(), list(b.mask)) for b in sp.blocks
             if isinstance(b, YoloBlock)]
    want = [(np.asarray([det["anchors"][m] for m in mask], float).tolist(), list(mask))
            for mask in det["masks"]]
    if heads != want:
        raise RuntimeError(f"the program's yolo heads {heads} differ from the configuration")
    return sp


def calib_crops(frames: np.ndarray, rng: np.random.Generator, n: int = 32,
                size: int = 80) -> np.ndarray:
    """RektNet's calibration crops as the serve CLI takes them: random
    size x size windows of the calibration frames."""
    _, H, W, _ = frames.shape
    out = []
    for _ in range(n):
        f = frames[rng.integers(len(frames))]
        y = rng.integers(0, max(1, H - size))
        x = rng.integers(0, max(1, W - size))
        out.append(f[y:y + size, x:x + size])
    return np.stack(out).astype(np.float32)


def serving_models(cfg: dict, dtrees, ktrees, device, calib_frames=None, crops=None):
    """The served detector and keypoint net of the configuration, as the
    serve CLI builds them: BN folded, heads sliced to the cone class; bf16
    (channels-last, cuDNN autotuned) or int8 (calibrated on ``calib_frames``
    (B, H, W, 3) f32 and ``crops``, the fused entry where it applies)."""
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet, quantize, rektnet, stem_opt
    from mit_driverless_cv_traininginfra_tpu_torch.ops import entry

    sp = spec(cfg)
    sp1, folded = stem_opt.slice_preyolo(sp, darknet.fold_bn(*dtrees, sp))
    rfolded = rektnet.fold_bn(*ktrees)
    precision = cfg["serving"]["precision"]
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    if precision == "int8":
        frames = torch.as_tensor(calib_frames, device=device)
        amax = quantize.calibrate(sp1, folded, frames)
        rekt_q = quantize.quantize_rektnet_params(
            rfolded, quantize.calibrate_rektnet(rfolded, crops))
        entry_q = (entry.quantize_entry(folded, amax)
                   if entry.entry_block_applicable(sp1) else None)
        yolo = quantize.Int8Darknet(sp1, quantize.quantize_params(sp1, folded, amax), entry_q)
        rekt = quantize.Int8RektNet(rekt_q)
    else:
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[precision]
        yolo = darknet.Darknet(sp1, folded).to(dtype=dtype)
        rekt = rektnet.RektNet(rfolded).to(dtype=dtype)
        if device.type == "cuda":
            yolo.to(memory_format=torch.channels_last)
            rekt.to(memory_format=torch.channels_last)
    return yolo.to(device).eval(), rekt.to(device).eval()


def server(cfg: dict, yolo, rekt, conf_thresh: float):
    """A ``TwoStageServer`` with the configuration's serving settings."""
    from mit_driverless_cv_traininginfra_tpu_torch.infer.capacity import AdaptiveCapacity
    from mit_driverless_cv_traininginfra_tpu_torch.infer.serving import TwoStageServer

    sv = cfg["serving"]
    return TwoStageServer(yolo, rekt, conf_thresh=conf_thresh,
                          nms_thresh=sv["nms_thresh"], max_det=sv["max_det"],
                          crop_size=cfg["keypoints"]["crop"],
                          policy=AdaptiveCapacity(**sv["policy"]))


def micro_batcher(server_, buckets, max_wait_ms: float):
    from mit_driverless_cv_traininginfra_tpu_torch.infer.microbatch import MicroBatcher

    return MicroBatcher(server_, bucket_sizes=buckets, max_wait_ms=max_wait_ms)


def to_host(out):
    """The program's fetch of a request's four outputs into host memory."""
    from mit_driverless_cv_traininginfra_tpu_torch.infer.microbatch import to_host as th

    return th(out)


def build_info() -> dict:
    """Whether this process built the program's kernel library (nvcc ran,
    as on a checkout's first run) and the seconds that took."""
    import sys

    lib = sys.modules.get("mit_driverless_cv_traininginfra_tpu_torch.ops._lib")
    if lib is None:
        return {"nvcc_ran": False, "nvcc_s": 0.0}
    return {"nvcc_ran": bool(lib.build_info.built), "nvcc_s": float(lib.build_info.seconds)}
