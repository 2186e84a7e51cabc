"""Running one probe through both routes and holding them to its rule."""

from __future__ import annotations

import dataclasses

import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import SUM_RTOL
from mit_driverless_cv_traininginfra_tpu_torch.probes.base import (
    KERNEL,
    PLAIN,
    WRAPPERS,
    Probe,
)


@dataclasses.dataclass
class Outcome:
    """Both routes' outputs, the kernel launches the kernel route made,
    how many values differ under the rule, and the largest |difference|."""

    kernel_out: torch.Tensor
    plain_out: torch.Tensor
    launches: dict
    differing: int
    max_abs_err: float

    @property
    def ok(self) -> bool:
        return self.differing == 0


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def differing(probe: Probe, inp, got, ref) -> int:
    """Values of ``got`` that break ``probe.rule`` against ``ref``:
    "equal" compares bits, "values" compares values (relu may keep −0.0
    on one side), "sum" holds each of the two to the float64 sum of the
    block within ``SUM_RTOL`` of the block's Σ|x|."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return max(got.numel(), ref.numel(), 1)
    if probe.rule == "equal":
        return int((_bits(got) != _bits(ref)).sum())
    if probe.rule == "values":
        return int((got != ref).sum())
    x = inp["x"].reshape(inp["x"].shape[0], -1)
    exact = x.double().sum(1)
    tol = SUM_RTOL * x.double().abs().sum(1)
    bad = ((got.double() - exact).abs() > tol) | ((ref.double() - exact).abs() > tol)
    return int(bad.sum())


def run_both(probe: Probe, inp) -> Outcome:
    """The kernel route, then the plain route, on the same inputs. The
    launch counters keep counting: ``launches`` is what the kernel route
    added to each (the plain route launches none)."""
    before = {k: fn.launches for k, fn in WRAPPERS.items()}
    got = probe.run(inp, KERNEL)
    if got.is_cuda:
        torch.cuda.synchronize()
    launches = {k: fn.launches - before[k] for k, fn in WRAPPERS.items()}
    ref = probe.run(inp, PLAIN)
    n = differing(probe, inp, got, ref)
    err = (float((got.double() - ref.double()).abs().max())
           if got.shape == ref.shape and got.numel() else 0.0)
    return Outcome(got, ref, launches, n, err)
