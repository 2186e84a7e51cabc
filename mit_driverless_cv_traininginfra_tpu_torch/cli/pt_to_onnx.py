"""A RektNet ``.pt`` checkpoint → the ``onnx_mode`` (raw heatmaps) ONNX
model (the reference's ``RektNet/pt_to_onnx.py`` surface, the JAX
package's ``cli/pt_to_onnx.py``)::

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.pt_to_onnx \\
        --model_path M.pt [--output OUT.onnx] [--img_size 80] [--num_kpt 7]

The output defaults to ``<model>.onnx``. Export runs on the host.
"""

from __future__ import annotations

import argparse
import sys

from mit_driverless_cv_traininginfra_tpu_torch.export.pt_to_onnx import export_rektnet_onnx
from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="RektNet .pt → ONNX")
    parser.add_argument("--model_path", "--model", dest="model_path", type=str,
                        required=True)
    parser.add_argument("--output", type=str, default=None,
                        help="defaults to <model>.onnx")
    parser.add_argument("--img_size", type=int, default=80)
    parser.add_argument("--num_kpt", type=int, default=7)
    opt = parser.parse_args(argv)

    params, state = rektnet.load_torch_checkpoint(opt.model_path)
    out = opt.output or opt.model_path.rsplit(".", 1)[0] + ".onnx"
    export_rektnet_onnx(params, state, out, input_size=(opt.img_size, opt.img_size),
                        num_kpt=opt.num_kpt)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
