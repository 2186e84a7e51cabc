"""Flagship model spec: the full YOLOv3 (Darknet-53 + FPN) at a square
resolution, from the cfg generator (counterpart of the JAX package's
``config/flagship.py``). The text is parsed in memory; no file is
written."""

from __future__ import annotations

from mit_driverless_cv_traininginfra_tpu_torch.config.cfg_factory import yolov3_cfg
from mit_driverless_cv_traininginfra_tpu_torch.config.darknet_cfg import (
    NetworkSpec,
    spec_from_text,
)


def flagship_spec(size: int = 416, classes: int = 80) -> NetworkSpec:
    return spec_from_text(yolov3_cfg(width=size, height=size, classes=classes),
                          vanilla_anchor=True, source="yolov3_cfg")
