"""YOLO detection on an image or a video from the command line (the
reference's ``detect.py``, the JAX package's ``cli/yolo_detect.py``)::

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.yolo_detect \\
        --target_path frame.png --weights_path W.weights

``infer.detect.detect_image`` on ``--device`` (the card unless ``cpu``)
with the BN-folded f32 detector; the kept boxes outlined in red, 1 px, on
the image, written to ``--output_path`` under the image's name (an array
for ``.npy``). Videos need OpenCV and raise without it; their frames get
2-pixel red boxes and are written as ``detected_<name>.mp4``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mit_driverless_cv_traininginfra_tpu_torch.cli.pipeline import VIDEO_EXTS, require_cv2
from mit_driverless_cv_traininginfra_tpu_torch.utils.logger import add_bool_arg


def single_img_detect(yolo, target_path: str, output_path: str, mode: str,
                      conf_thres: float, nms_thres: float) -> str:
    """Detect on one image and write it with its boxes; returns the path
    written (``output_path/<name>`` in ``image`` mode, else the image's
    own path)."""
    from mit_driverless_cv_traininginfra_tpu_torch.data.decode import read_rgb
    from mit_driverless_cv_traininginfra_tpu_torch.data.encode import write_image
    from mit_driverless_cv_traininginfra_tpu_torch.infer.detect import detect_image
    from mit_driverless_cv_traininginfra_tpu_torch.utils import draw

    img = read_rgb(target_path)
    boxes, _ = detect_image(yolo, img, conf_thresh=conf_thres, nms_thresh=nms_thres)
    out = img.copy()
    for b in boxes:
        draw.pil_rectangle(out, (float(b[0]), float(b[1]), float(b[2]), float(b[3])),
                           (255, 0, 0))
    dest = (os.path.join(output_path, os.path.basename(target_path)) if mode == "image"
            else target_path)
    print(f"{len(boxes)} detections")
    return write_image(dest, out)


def detect_video(yolo, target_path: str, output_path: str, conf_thres: float,
                 nms_thres: float) -> str:
    """Detect on every frame and re-encode at the video's frame rate as
    ``output_path/detected_<name>.mp4``."""
    from mit_driverless_cv_traininginfra_tpu_torch.infer.detect import detect_image
    from mit_driverless_cv_traininginfra_tpu_torch.utils import draw

    cv2 = require_cv2()
    cap = cv2.VideoCapture(target_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {target_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    os.makedirs(output_path, exist_ok=True)
    base = os.path.splitext(os.path.basename(target_path))[0]
    dest = os.path.join(output_path, "detected_" + base + ".mp4")
    writer = cv2.VideoWriter(dest, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        cap.release()
        raise RuntimeError(f"cannot open video writer for {dest}")
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        boxes, _ = detect_image(yolo, np.ascontiguousarray(frame[..., ::-1]),
                                conf_thresh=conf_thres, nms_thresh=nms_thres)
        for b in boxes:
            draw.cv2_rectangle2(frame, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])),
                                (0, 0, 255))
        writer.write(frame)
        n += 1
    cap.release()
    writer.release()
    print(f"{n} frames processed -> {dest}")
    return dest


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="YOLO detection (PyTorch)")
    parser.add_argument("--target_path", type=str, required=True,
                        help="image or video to run detection on")
    parser.add_argument("--output_path", type=str, default="outputs/visualization/")
    parser.add_argument("--weights_path", type=str, required=True)
    parser.add_argument("--model_cfg", type=str, default="model_cfg/yolo_baseline.cfg")
    parser.add_argument("--conf_thres", type=float, default=0.8)
    parser.add_argument("--nms_thres", type=float, default=0.25)
    parser.add_argument("--xy_loss", type=float, default=2.0)
    parser.add_argument("--wh_loss", type=float, default=1.6)
    parser.add_argument("--no_object_loss", type=float, default=25.0)
    parser.add_argument("--object_loss", type=float, default=0.1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    add_bool_arg(parser, "vanilla_anchor", False, "use the vanilla anchor list")
    opt = parser.parse_args(argv)

    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
        load_network_spec,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.device import full_f32, resolve_device
    from mit_driverless_cv_traininginfra_tpu_torch.infer.detect import load_detector

    dev = resolve_device(opt.device)
    full_f32(dev)
    _, yolo = load_detector(load_network_spec(opt.model_cfg,
                                              vanilla_anchor=opt.vanilla_anchor),
                            opt.weights_path, dev)
    os.makedirs(opt.output_path, exist_ok=True)
    if os.path.splitext(opt.target_path)[1].lower() in VIDEO_EXTS:
        detect_video(yolo, opt.target_path, opt.output_path, opt.conf_thres, opt.nms_thres)
    else:
        dest = single_img_detect(yolo, opt.target_path, opt.output_path, "image",
                                 opt.conf_thres, opt.nms_thres)
        print(f"Saved detection to {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
