"""YOLO validation from the command line (the reference's ``validate.py``,
the JAX package's ``cli/yolo_validate.py``): mAP, recall and precision
over the cfg's ``validate_uri`` CSV, and the seconds per image::

    python -m mit_driverless_cv_traininginfra_tpu_torch.cli.yolo_validate \\
        --model_cfg CFG --weights_path W.weights --dataset_path D

``ImageLabelDataset`` (tile-and-scale unless ``--no_ts``) through the
port's ``DataLoader`` into ``train.yolo_driver.validate_map`` on
``--device`` (the card unless ``cpu``). ``--debug_mode`` takes batch 1
and patch 0.
"""

from __future__ import annotations

import argparse
import sys

from mit_driverless_cv_traininginfra_tpu_torch.utils.logger import add_bool_arg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="YOLO validation (PyTorch)")
    parser.add_argument("--model_cfg", type=str, default="model_cfg/yolo_baseline.cfg")
    parser.add_argument("--weights_path", type=str, required=True)
    parser.add_argument("--dataset_path", type=str, default="dataset/YOLO_Dataset/")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--xy_loss", type=float, default=2.0)
    parser.add_argument("--wh_loss", type=float, default=1.6)
    parser.add_argument("--no_object_loss", type=float, default=25.0)
    parser.add_argument("--object_loss", type=float, default=0.1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on ('cuda' or 'cpu')")
    add_bool_arg(parser, "vanilla_anchor", False, "use the vanilla anchor list")
    add_bool_arg(parser, "ts", True, "tile-and-scale mode")
    add_bool_arg(parser, "debug_mode", False, "debug visualization mode")
    opt = parser.parse_args(argv)

    import torch

    from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
        load_network_spec,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.data.loader import DataLoader
    from mit_driverless_cv_traininginfra_tpu_torch.data.yolo_dataset import (
        ImageLabelDataset,
    )
    from mit_driverless_cv_traininginfra_tpu_torch.device import full_f32, resolve_device
    from mit_driverless_cv_traininginfra_tpu_torch.models import darknet
    from mit_driverless_cv_traininginfra_tpu_torch.train.yolo_driver import validate_map

    dev = resolve_device(opt.device)
    full_f32(dev)
    spec = load_network_spec(opt.model_cfg, vanilla_anchor=opt.vanilla_anchor)
    params, state = darknet.init_params(spec, torch.Generator().manual_seed(0))
    params, state, _ = darknet.load_darknet_weights(spec, params, state, opt.weights_path)
    model = darknet.TrainDarknet(spec, params, state).to(dev)

    ds = ImageLabelDataset(spec.net.validate_uri, dataset_path=opt.dataset_path,
                           width=spec.net.width, height=spec.net.height,
                           num_images=spec.net.num_validate_images, bw=spec.net.channels == 1,
                           ts=opt.ts, debug_mode=opt.debug_mode)
    loader = DataLoader(ds, 1 if opt.debug_mode else opt.batch_size, shuffle=False,
                        num_workers=opt.num_workers)
    _, _, _, latency = validate_map(data_loader=loader, model=model, device=dev)
    print(f"seconds/image: {latency:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
