"""A cfg and a Darknet ``.weights`` file → an ONNX model (the reference's
``yolo2onnx.py`` surface, the JAX package's ``cli/yolo2onnx.py``)::

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.yolo2onnx \\
        --cfg_name model_cfg/yolo_baseline.cfg --weights_name W.weights \\
        [--output OUT.onnx]

Raw pre-yolo outputs at the cfg's ``onnx_height`` × width; the output
defaults to ``<cfg stem>_<width><onnx_height>.onnx`` in the working
directory. Export is a host job: the trees are built on the CPU, with
``init_params`` on a seeded ``torch.Generator`` giving the shapes that
``load_darknet_weights`` fills.
"""

from __future__ import annotations

import argparse
import sys

import torch

from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import load_network_spec
from mit_driverless_cv_traininginfra_tpu_torch.export.yolo2onnx import export_yolo_onnx
from mit_driverless_cv_traininginfra_tpu_torch.models.darknet import (
    init_params,
    load_darknet_weights,
)
from mit_driverless_cv_traininginfra_tpu_torch.utils.logger import add_bool_arg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="YOLO cfg+weights → ONNX")
    parser.add_argument("--cfg_name", type=str, required=True)
    parser.add_argument("--weights_name", type=str, required=True)
    parser.add_argument("--output", type=str, default=None,
                        help="defaults to <cfg>_<width><onnx_height>.onnx")
    add_bool_arg(parser, "vanilla_anchor", True, "use the vanilla anchor list")
    opt = parser.parse_args(argv)

    spec = load_network_spec(opt.cfg_name, vanilla_anchor=opt.vanilla_anchor)
    params, state = init_params(spec, torch.Generator().manual_seed(0))
    params, state, _ = load_darknet_weights(spec, params, state, opt.weights_name)
    out = opt.output or spec.net.onnx_name(opt.cfg_name)
    export_yolo_onnx(spec, params, state, out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
