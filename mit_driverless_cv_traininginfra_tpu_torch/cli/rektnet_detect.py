"""RektNet on one cone crop from the command line (the reference's
``RektNet/detect.py``, the JAX package's ``cli/rektnet_detect.py``)::

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.rektnet_detect \\
        --model outputs/<run>/<epoch>_loss_<val>.pt --img crop.png

Decodes the crop as BGR (``data/decode.imread_bgr``), resizes it to
``--img_size``² (``data/raster.resize_linear``, OpenCV's linear resize),
runs the ``KeypointNet`` in eval mode on ``--device`` (the card unless
``cpu``; its soft-argmax is kernel K2 there), writes the per-keypoint
heatmap strip ``<name>_hm.jpg`` and the keypoints drawn on the original
image ``<name>_inference.jpg`` to ``--output``, and prints the keypoints.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="RektNet detection (PyTorch)")
    parser.add_argument("--model", type=str, required=True, help=".pt checkpoint")
    parser.add_argument("--img", type=str, required=True)
    parser.add_argument("--img_size", type=int, default=80)
    parser.add_argument("--output", type=str, default="outputs/visualization/")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    opt = parser.parse_args(argv)

    from mit_driverless_cv_traininginfra_tpu_torch.data.decode import imread_bgr
    from mit_driverless_cv_traininginfra_tpu_torch.data.raster import resize_linear
    from mit_driverless_cv_traininginfra_tpu_torch.device import full_f32, resolve_device
    from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet
    from mit_driverless_cv_traininginfra_tpu_torch.utils.vis import (
        vis_hm_strip_and_save,
        vis_tensor_and_save,
    )

    dev = resolve_device(opt.device)
    full_f32(dev)
    model = rektnet.KeypointNet(*rektnet.load_torch_checkpoint(opt.model)).to(dev).eval()
    image = imread_bgr(opt.img)
    if image is None:
        raise FileNotFoundError(opt.img)
    h, w, _ = image.shape
    resized = resize_linear(image, (opt.img_size, opt.img_size))
    x = torch.from_numpy(resized[None].astype(np.float32) / 255.0).to(dev)
    with torch.inference_mode():
        hm, points = model(x)
    hm, points = hm[0].cpu().numpy(), points[0].cpu().numpy()

    os.makedirs(opt.output, exist_ok=True)
    name = os.path.basename(opt.img).split(".")[0]
    vis_hm_strip_and_save(hm, name, output_uri=opt.output)
    vis_tensor_and_save(image.copy(), h, w, points, name, opt.output)
    print(f"keypoints: {points.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
