"""Explicit device resolution: the port never picks a device on its own."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"``, ``"cuda:1"``, ``"cpu"`` or a ``torch.device`` → the device.

    Raises ``RuntimeError`` when a CUDA device is asked for and this
    process has none: a run that wants the card must not quietly fall
    back to the CPU.
    """
    if device is None:
        raise ValueError("pass a device explicitly ('cuda' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but CUDA is not "
                               "available in this process")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} asked for, but only "
                               f"{torch.cuda.device_count()} CUDA devices "
                               "are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev
