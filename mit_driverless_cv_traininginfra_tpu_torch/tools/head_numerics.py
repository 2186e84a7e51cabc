#!/usr/bin/env python3
"""The int8 configuration's detection heads, card against CPU, in two
numerics.

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/head_numerics.py

The int8 Darknet keeps its pre-yolo convs in bf16 (``models.quantize.
_FloatConv``): they sum in float64, exactly for bf16 products, and round
once. This tool runs the int8 slice of ``chip_smoke.py`` (B=2, capacity
16, gap-centred threshold) on the card and on CPU copies of the same
models twice: with those heads ("f64"), and with the heads as a library
bf16 convolution ("bf16": cuDNN on the card, oneDNN on the CPU, as the
bf16 Darknet runs them). For each it prints how many head logits differ
and by how many bf16 ulps at most, whether the masks are equal, and every
kept slot whose box differs: the CPU slot of the same frame that holds
the card's box, if any, and the scores on both sides.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke as cs  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.data import synthetic  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import (  # noqa: E402
    two_stage_pipeline,
)
from mit_driverless_cv_traininginfra_tpu_torch.models import quantize as qz  # noqa: E402

F64_FORWARD = qz._FloatConv.forward


def bf16_forward(self, x):
    """The head as a library bf16 convolution, bias after its rounding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), self.w, None, self.stride, self.padding)
    return y.permute(0, 2, 3, 1) + self.b


def ulps(a, b) -> float:
    """max |a − b| in units of bf16's spacing at |b|."""
    a, b = a.float(), b.float()
    spacing = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=2 ** -126))) - 7)
    return float(((a - b).abs() / spacing).max())


def compare(label, yolo, rekt, yolo_c, rekt_c, frames) -> None:
    with torch.inference_mode():
        thresh = cs.pick_conf_thresh(yolo.detections(frames, with_classes=False),
                                     cs.MAX_DET)
        heads = yolo.forward_features(frames[:2])
        heads_c = yolo_c.forward_features(frames[:2].cpu())
    for i, (h, hc) in enumerate(zip(heads, heads_c)):
        h = h.cpu()
        print(f"{label} head {i}: {int((h != hc).sum())}/{h.numel()} logits "
              f"differ, max {ulps(h, hc)!r} bf16 ulps", flush=True)
    kw = dict(conf_thresh=thresh, max_det=cs.MAX_DET, crop_capacity=16)
    out = two_stage_pipeline(yolo, rekt, frames[:2], **kw)
    ref = two_stage_pipeline(yolo_c, rekt_c, frames[:2].cpu(), **kw)
    boxes, scores = out.boxes.cpu(), out.scores.cpu()
    print(f"{label}: conf_thresh {thresh!r} detections {int(ref.mask.sum())} "
          f"masks_equal={torch.equal(out.mask.cpu(), ref.mask)}", flush=True)
    for b, k in ref.mask.nonzero().tolist():
        size = float((ref.boxes[b, k, 2:] - ref.boxes[b, k, :2]).max().clamp(min=1))
        d = float((boxes[b, k] - ref.boxes[b, k]).abs().max()) / size
        if d <= 1e-4:
            continue
        near = (ref.boxes[b] - boxes[b, k]).abs().amax(dim=1) / size
        j = int(near.argmin())
        where = (f"= CPU slot {j} (score {float(ref.scores[b, j])!r})"
                 if float(near[j]) <= 1e-4 else "in no CPU slot")
        print(f"  {label} frame {b} slot {k}: |d box|/size {d!r}; card box "
              f"{where}; scores card {float(scores[b, k])!r} CPU "
              f"{float(ref.scores[b, k])!r}", flush=True)


def main() -> int:
    smi = cs.phase_device()
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    print(f"card: {smi}", flush=True)
    frames_np, _ = synthetic.yolo_batch(np.random.default_rng(42), cs.B_SERVE, cs.SIZE)
    bundles = cs.quantize_on_card(dev, frames_np)
    yolo, rekt = cs.int8_models(bundles, dev)
    cpu = (bundles[0], *(cs.tree_to(b, "cpu") for b in bundles[1:]))
    yolo_c, rekt_c = cs.int8_models(cpu, "cpu")
    frames = torch.from_numpy(frames_np).to(dev, torch.bfloat16)
    for label, forward in (("f64", F64_FORWARD), ("bf16", bf16_forward)):
        qz._FloatConv.forward = forward
        compare(label, yolo, rekt, yolo_c, rekt_c, frames)
    qz._FloatConv.forward = F64_FORWARD
    return 0


if __name__ == "__main__":
    sys.exit(main())
