#!/usr/bin/env python3
"""Evaluate a trained Darknet ``.weights`` file on freshly rendered cone
scenes, f32 and int8, at the serving operating point (conf 0.8, NMS 0.25,
IoU 0.5): the port's copy of the repository's ``tools/eval_weights.py``::

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/eval_weights.py \\
        --weights W.weights [--n 256] [--size 416] [--model_cfg CFG] [--conf 0.8] \\
        [--device cpu]

The detector is ``--model_cfg`` or else the flagship YOLOv3 at ``--size``
(80 classes), BN-folded; the int8 one is calibrated on the first 8 scenes
and quantized without the fused entry (``models.quantize``). Scenes come
from ``data/synthetic.yolo_batch`` (seed ``--seed``); mAP, recall and
precision are ``ops.metrics.evaluate_image_batch``'s, averaged over the
images with a target and a kept box (NaN when there is none; ``--conf``
lowers the threshold for weights that score no box above 0.8). Runs on
the card unless ``--device cpu``. Prints one JSON line, values
unrounded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (  # noqa: E402
    load_network_spec,
)
from mit_driverless_cv_traininginfra_tpu_torch.config.flagship import flagship_spec  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.data.synthetic import yolo_batch  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.device import full_f32, resolve_device  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.infer.detect import darknet_shape_trees  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import (  # noqa: E402
    Darknet,
    fold_bn,
    load_darknet_weights,
)
from mit_driverless_cv_traininginfra_tpu_torch.models.quantize import (  # noqa: E402
    Int8Darknet,
    calibrate,
    quantize_params,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.metrics import (  # noqa: E402
    evaluate_image_batch,
)

CHUNK = 16


def _agg(evs):
    ap, r, p, v = (np.concatenate([e[k] for e in evs]) for k in range(4))
    v = v.astype(bool)
    return float(ap[v].mean()), float(r[v].mean()), float(p[v].mean())


@torch.inference_mode()
def evaluate(spec, folded, images, targets, dev, conf: float = 0.8):
    """(f32 (mAP, R, P), int8 (mAP, R, P)) of the folded detector over
    ``images`` (N, S, S, 3) and their ``targets``."""
    size = spec.net.width
    folded = {k: {n: t.to(dev) for n, t in v.items()} for k, v in folded.items()}
    f32 = Darknet(spec, folded).eval()
    int8 = Int8Darknet(spec, quantize_params(
        spec, folded, calibrate(spec, folded, torch.from_numpy(images[:8]).to(dev)))).eval()
    evs32, evs8 = [], []
    for c0 in range(0, len(images), CHUNK):
        x = torch.from_numpy(images[c0:c0 + CHUNK]).to(dev)
        t = torch.from_numpy(targets[c0:c0 + CHUNK]).to(dev)
        for model, evs in ((f32, evs32), (int8, evs8)):
            dets = model.detections(x.to(model.frame_dtype), with_classes=False).float()
            ev = evaluate_image_batch(dets, t, size, size, conf_thresh=conf, nms_thresh=0.25,
                                      iou_thresh=0.5, top_k=32)
            evs.append([e.cpu().numpy() for e in ev])
    return _agg(evs32), _agg(evs8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", required=True)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--model_cfg", default=None,
                    help="a cfg instead of the flagship YOLOv3 at --size")
    ap.add_argument("--conf", type=float, default=0.8)
    ap.add_argument("--max-overlap", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=999)
    ap.add_argument("--json", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    full_f32(dev)
    spec = load_network_spec(args.model_cfg) if args.model_cfg else flagship_spec(args.size)
    size = spec.net.width
    params, mstate, _ = load_darknet_weights(spec, *darknet_shape_trees(spec), args.weights)
    folded = fold_bn(params, mstate, spec)
    ev_i, ev_t = yolo_batch(np.random.default_rng(args.seed), args.n, size=size,
                            max_overlap=None if args.max_overlap < 0 else args.max_overlap)
    t0 = time.perf_counter()
    (m32, r32, p32), (m8, r8, p8) = evaluate(spec, folded, ev_i, ev_t, dev, args.conf)
    out = {"weights": args.weights, "n_scenes": args.n, "size": size, "conf": args.conf,
           "map_f32": m32, "recall_f32": r32, "precision_f32": p32, "map_int8": m8,
           "recall_int8": r8, "precision_int8": p8, "eval_s": time.perf_counter() - t0}
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
