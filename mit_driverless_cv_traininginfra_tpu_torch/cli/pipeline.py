"""Detect → crop → keypoints on an image or a video from the command line
(the JAX package's ``cli/pipeline.py``)::

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.pipeline \\
        --target_path frame.png --yolo_weights W.weights --rektnet_weights R.pt

Each frame is letterboxed to the cfg's size and run through
``infer.pipeline.two_stage_pipeline`` on ``--device`` (the card unless
``cpu``: kernels K3, K1 and K2 there) with the BN-folded f32 detector
(heads sliced to one class) and RektNet; boxes and keypoints are mapped
back to the frame's pixels, drawn and printed. Images are read by
``data/decode.read_rgb`` (JPEG, PNG or ``.npy``) and written beside their
name as ``pipeline_<name>`` (an array for ``.npy``). Videos need OpenCV
(``cv2.VideoCapture``/``VideoWriter``) and raise without it. The JAX
package's CLI runs blocks 0-1 as the packed space-to-depth stem; this one
runs the plain stem, the same function and the faster of the two on the
card (PERF.md); ``Darknet(packed_stem=)`` runs the packed one.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.utils.logger import add_bool_arg

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv")


def require_cv2():
    """OpenCV for the video routes, or a RuntimeError that names it."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError("video input needs OpenCV (cv2.VideoCapture and "
                           "cv2.VideoWriter), which is not installed") from None
    return cv2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="detect→crop→keypoints pipeline")
    parser.add_argument("--target_path", type=str, required=True)
    parser.add_argument("--output_path", type=str, default="outputs/visualization/")
    parser.add_argument("--model_cfg", type=str, default="model_cfg/yolo_baseline.cfg")
    parser.add_argument("--yolo_weights", type=str, required=True)
    parser.add_argument("--rektnet_weights", type=str, required=True,
                        help="RektNet .pt checkpoint")
    parser.add_argument("--conf_thres", type=float, default=0.8)
    parser.add_argument("--nms_thres", type=float, default=0.25)
    parser.add_argument("--max_det", type=int, default=16)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    add_bool_arg(parser, "vanilla_anchor", False, "use the vanilla anchor list")
    opt = parser.parse_args(argv)

    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
        load_network_spec,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.data.decode import read_rgb
    from mit_driverless_cv_traininginfra_tpu_torch.data.encode import write_image
    from mit_driverless_cv_traininginfra_tpu_torch.device import full_f32, resolve_device
    from mit_driverless_cv_traininginfra_tpu_torch.infer.detect import (
        _div,
        load_detector,
        unletterbox_boxes,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.infer.pipeline import two_stage_pipeline
    from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet
    from mit_driverless_cv_traininginfra_tpu_torch.ops.boxes import calculate_padding
    from mit_driverless_cv_traininginfra_tpu_torch.ops.image import letterbox
    from mit_driverless_cv_traininginfra_tpu_torch.utils import draw
    from mit_driverless_cv_traininginfra_tpu_torch.utils.vis import KPT_COLORS

    dev = resolve_device(opt.device)
    full_f32(dev)
    spec, yolo = load_detector(load_network_spec(opt.model_cfg,
                                                 vanilla_anchor=opt.vanilla_anchor),
                               opt.yolo_weights, dev)
    rekt = rektnet.RektNet(rektnet.fold_bn(*rektnet.load_torch_checkpoint(
        opt.rektnet_weights))).to(dev).eval()
    H, W = spec.net.height, spec.net.width

    def run_frame(img_np):
        h, w = img_np.shape[:2]
        pad_h, pad_w, ratio = calculate_padding(h, w, H, W)
        x = _div(torch.as_tensor(np.asarray(img_np), dtype=torch.float32,
                                 device=dev)[None], 255.0)
        boxed, _ = letterbox(x, H, W)
        # K1 reads the frames as a contiguous (B, H, W, C) block
        out = two_stage_pipeline(yolo, rekt, boxed.contiguous(), conf_thresh=opt.conf_thres,
                                 nms_thresh=opt.nms_thres, max_det=opt.max_det)
        m = out.mask[0].cpu().numpy()
        boxes = unletterbox_boxes(out.boxes[0], pad_h, pad_w, ratio).cpu().numpy()[m]
        kpts = out.keypoints[0].cpu().numpy()[m]
        kpts = kpts / ratio - np.asarray([pad_w, pad_h])
        return boxes, kpts, out.scores[0].cpu().numpy()[m]

    os.makedirs(opt.output_path, exist_ok=True)
    ext = os.path.splitext(opt.target_path)[1].lower()
    if ext in VIDEO_EXTS:
        cv2 = require_cv2()
        cap = cv2.VideoCapture(opt.target_path)
        if not cap.isOpened():
            print(f"ERROR: cannot open video {opt.target_path}", file=sys.stderr)
            return 1
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        # always .mp4: the mp4v codec into other containers fails quietly
        base = os.path.splitext(os.path.basename(opt.target_path))[0]
        dest = os.path.join(opt.output_path, "pipeline_" + base + ".mp4")
        writer = cv2.VideoWriter(dest, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not writer.isOpened():
            print(f"ERROR: cannot open video writer for {dest}", file=sys.stderr)
            cap.release()
            return 1
        n = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            boxes, kpts, _ = run_frame(np.ascontiguousarray(frame[..., ::-1]))
            for b, ks in zip(boxes, kpts):
                draw.cv2_rectangle2(frame, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])),
                                    (0, 0, 255))
                for i, (x, y) in enumerate(ks):
                    # KPT_COLORS are RGB; the frames are BGR
                    draw.cv2_circle_filled(frame, (int(x), int(y)), 3,
                                           KPT_COLORS[i % len(KPT_COLORS)][::-1])
            writer.write(frame)
            n += 1
        cap.release()
        writer.release()
        print(f"{n} frames -> {dest}")
        return 0

    img = read_rgb(opt.target_path)
    boxes, kpts, scores = run_frame(img)
    img = img.copy()
    for b, ks in zip(boxes, kpts):
        draw.pil_rectangle(img, tuple(float(v) for v in b), (255, 0, 0), width=2)
        for i, (x, y) in enumerate(ks):
            draw.pil_dot(img, x, y, KPT_COLORS[i % len(KPT_COLORS)])
    dest = write_image(os.path.join(opt.output_path,
                                    "pipeline_" + os.path.basename(opt.target_path)), img)
    print(f"{len(boxes)} cones; keypoints drawn -> {dest}")
    for b, s, ks in zip(boxes, scores, kpts):
        print(f"  box={np.round(b, 1).tolist()} conf={s:.3f} "
              f"kpts={np.round(ks, 1).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
