"""What every probe of the table holds, and the helpers their input
builders share.

A :class:`Probe` is one ``pl.pallas_call`` site of the JAX repository's
``tools/`` (or one probe of a site that serves several), ported onto one of
the four kernels. ``run(inp, ops)`` computes the probe's function through
``ops``: :data:`KERNEL` (the wrappers, which launch the CUDA kernels for
CUDA tensors) or :data:`PLAIN` (the plain PyTorch versions).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.ops.int8_contract import (
    int8_contract,
    int8_contract_plain,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.strided_map import (
    strided_map,
    strided_map_plain,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.tail_conv import (
    tail_conv,
    tail_conv_plain,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.window_resample import (
    window_resample,
    window_resample_plain,
)

KERNEL = SimpleNamespace(strided_map=strided_map, int8_contract=int8_contract,
                         window_resample=window_resample, tail_conv=tail_conv)
PLAIN = SimpleNamespace(strided_map=strided_map_plain,
                        int8_contract=int8_contract_plain,
                        window_resample=window_resample_plain,
                        tail_conv=tail_conv_plain)
WRAPPERS = {"tail_conv": tail_conv, "window_resample": window_resample,
            "int8_contract": int8_contract, "strided_map": strided_map}


@dataclasses.dataclass(frozen=True)
class Probe:
    """One probe: ``name`` as the JAX probe prints it, ``ref`` the file:line
    of its ``pl.pallas_call``, ``kernel`` the port's kernel, ``build(device,
    small)`` its seeded inputs (``small``: a cut batch for the CPU tests),
    ``run(inp, ops)`` its function, ``rule`` how kernel and plain are held
    ("equal": every bit; "values": every value; "sum": within
    ``ops.strided_map.SUM_RTOL`` — ``probes/run.py``), ``work(inp,
    out)`` the (bytes, operations, type) the bound counts, ``library(inp)``
    one PyTorch call computing the same function on the card, or None, and
    ``beside`` a (label, fn(inp)) timed next to it. ``last_block``: the TPU
    grid wrote every program into one output block, so the probe's own
    output is the last program's."""

    name: str
    ref: str
    kernel: str
    build: Callable
    run: Callable
    work: Callable
    rule: str = "equal"
    library: Optional[Callable] = None
    beside: Optional[tuple] = None
    last_block: bool = False


def int8_draw(rng, shape, device="cpu"):
    """``jnp.asarray(rng.integers(-127, 127, shape), jnp.int8)``: values in
    [−127, 126]."""
    return torch.from_numpy(rng.integers(-127, 127, shape).astype(np.int8)).to(device)


def bf16_from(a, device="cpu"):
    """``jnp.asarray(a, jnp.bfloat16)`` of a float64 numpy array."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).to(device)


def device_int8(shape, seed: int, device, low: int = -127, high: int = 127):
    """A large int8 array made on ``device`` from a seeded torch generator
    (the B=128 inputs of the stream probes: numpy would take gigabytes)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(low, high, shape, generator=g, device=device,
                         dtype=torch.int8)


def device_uniform_bf16(shape, seed: int, device):
    """``random((…))`` frames as bf16, made on ``device`` from a seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=g, device=device).to(torch.bfloat16)


def indexed_copy(inp, ops):
    """A window copy: ``inp["x"]`` read at each program's base from
    ``inp["index"]`` (a DMA window of the TPU probes)."""
    return ops.strided_map(inp["x"], index=inp["index"])


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def copy_work(inp, out):
    """A gather moves each output element once in and once out."""
    return 2 * nbytes(out), 0, "f32"


def map_work(per_element: int):
    def work(inp, out):
        return (out.numel() * inp["x"].element_size() + nbytes(out),
                per_element * out.numel(), "f32")
    return work


def sum_work(inp, out):
    return nbytes(inp["x"]) + nbytes(out), inp["x"].numel(), "f32"


def contract_work(inp, out):
    a, b = inp["a"], inp["b"]
    (M, K), N = a.shape, b.shape[1]
    return nbytes(a, b, out), 2 * M * N * K, "int8"
