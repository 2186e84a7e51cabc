"""Optimizers and learning-rate schedules with the reference's semantics
(counterpart of the JAX package's ``train/optim.py``).

- YOLO: Adam(lr, weight_decay) or SGD(lr, momentum, weight_decay),
  StepLR(step_size=1, gamma) stepped once per epoch.
- RektNet: Adam(lr) + ExponentialLR(gamma=0.999) per epoch.

Weight decay is L2 in the gradient (``torch.optim``'s ``weight_decay``),
which is where the JAX package's ``optax.add_decayed_weights`` puts it,
before Adam. The global-norm clip is ``optax.clip_by_global_norm``'s
formula in its order (:func:`clip_by_global_norm`). The schedules are
host-side scalars written into the param groups between epochs or steps
(:func:`set_lr`); :func:`linear_schedule`, :func:`cosine_decay_schedule`
and :func:`join_schedules` are optax's, evaluated in f32 on the host.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from typing import Callable, Sequence

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import (
    Mesh2D,
    all_sum_,
    all_sum_grads_,
)


def make_optimizer(params, kind: str = "Adam", lr: float = 1e-3,
                   momentum: float = 0.9, weight_decay: float = 0.0,
                   grad_clip: float = 0.0) -> torch.optim.Optimizer:
    """``torch.optim.Adam`` (β 0.9/0.999, eps 1e-8) or ``SGD`` over
    ``params``. ``grad_clip`` (global-norm clip, 0 = off) is kept on the
    optimizer as ``opt.grad_clip`` and applied by :func:`optimizer_step`
    before the update, as the JAX package chains ``clip_by_global_norm``
    in front of its optimizer."""
    kind_l = kind.lower()
    if kind_l == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=weight_decay)
    elif kind_l == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"Invalid optimizer name: {kind}")
    opt.grad_clip = grad_clip
    return opt


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: ``sqrt(Σ_leaves Σ g²)`` in f32, each leaf
    summed on its own and the leaf sums added in order from 0. Each leaf's
    own sum follows its backend's order (XLA's, torch's CPU or CUDA
    reduction), so the norm may differ from optax's in its last bits."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def split_global_norm(grads: Sequence[torch.Tensor], split, mesh) -> torch.Tensor:
    """:func:`global_norm` of a tree whose leaves with their ``split`` flag
    set are split over the ``model`` ``mesh`` (``grads`` holds this rank's
    blocks of them): their squares are summed over the mesh and the whole
    leaves' added once, which is optax's norm of the whole tree."""
    sq = [torch.sum(g * g) for g in grads]
    zero = torch.zeros_like(sq[0])
    blocks = all_sum_(sum((q for q, k in zip(sq, split) if k), zero), mesh)
    return torch.sqrt(blocks + sum((q for q, k in zip(sq, split) if not k), zero))


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        split=None, mesh=None) -> None:
    """``optax.clip_by_global_norm`` in place on ``grads``: only where
    ``norm ≥ max_norm`` (:func:`global_norm`; :func:`split_global_norm`
    given a ``model`` ``mesh`` and the ``split`` flags) each gradient
    becomes ``g / norm · max_norm``, divided, then multiplied. No host
    read: the test runs on the device and picks the
    divisor and the factor, which are 1 where the norm is below the limit
    (``g / 1 · 1`` is ``g``); two batched launches then scale every
    gradient."""
    if not grads:
        return
    norm = global_norm(grads) if mesh is None else split_global_norm(grads, split, mesh)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))


def optimizer_step(opt: torch.optim.Optimizer, mesh=None) -> None:
    """Under a process ``mesh``, sum the gradients over the ranks first
    (each rank's loss is its share of the global loss, so the sum is the
    whole batch's gradient, equal on every rank); clip their global norm
    to ``opt.grad_clip`` (when set; :func:`clip_by_global_norm`); then take
    the optimizer's step, which keeps the parameters and the optimizer
    state equal on every rank.

    On a :class:`Mesh2D` the sum runs over its ``data`` sub-mesh, and the
    clip's norm counts the parameters marked ``model_split`` (blocks of
    leaves split over ``model``, ``models/darknet.py``) over its ``model``
    sub-mesh; the optimizer state of a block has the block's shape."""
    params = [p for g in opt.param_groups for p in g["params"]]
    model = mesh.model if isinstance(mesh, Mesh2D) else None
    if mesh is not None:
        all_sum_grads_(params, mesh.data if model is not None else mesh)
    if getattr(opt, "grad_clip", 0.0):
        params = [p for p in params if p.grad is not None]
        grads = [p.grad for p in params]
        if model is None:
            clip_by_global_norm(grads, opt.grad_clip)
        else:
            clip_by_global_norm(grads, opt.grad_clip,
                                [getattr(p, "model_split", False) for p in params], model)
    opt.step()


def step_lr(base_lr: float, gamma: float, epoch: int, step_size: int = 1) -> float:
    """torch StepLR: lr = base · γ^(epoch // step_size). The reference
    steps it at the top of each epoch, so epoch 1 already trains at
    base·γ — pass the same epoch counter for parity."""
    return base_lr * (gamma ** (epoch // step_size))


def exponential_lr(base_lr: float, gamma: float, epoch: int) -> float:
    """torch ExponentialLR: lr = base · γ^epoch (stepped per epoch)."""
    return base_lr * (gamma ** epoch)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Write ``lr`` into every param group."""
    for group in opt.param_groups:
        group["lr"] = lr
    return opt


# ---------------------------------------------------------------------------
# optax's schedules on the host, in f32 (the step count is an int32 there)
# ---------------------------------------------------------------------------

Schedule = Callable[[int], float]
_f32 = np.float32
_libm = ctypes.CDLL(ctypes.util.find_library("m"))
_libm.cosf.restype = ctypes.c_float
_libm.cosf.argtypes = [ctypes.c_float]


def _cosf(x) -> np.float32:
    # XLA:CPU's f32 cosine is the C library's cosf; a cos in f64, rounded,
    # differs from it in the last bit on some arguments
    return _f32(_libm.cosf(float(x)))


def constant_schedule(value: float) -> Schedule:
    """``optax.constant_schedule``."""
    return lambda count: float(_f32(value))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: ``(I − E)·(1 − t/T) + E`` over the first
    ``T`` steps, then ``E``; each operation in f32 as optax's unjitted
    graph rounds it."""
    if transition_steps <= 0:
        return lambda count: float(init_value)

    def schedule(count: int) -> float:
        t = min(max(count, 0), transition_steps)
        frac = _f32(1) - _f32(t) / _f32(transition_steps)
        return float(_f32(init_value - end_value) * frac + _f32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule`` (alpha 0, exponent 1): ``I·½(1 +
    cos(π·t/T))``, ``t`` capped at ``T``, each operation in f32."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count: int) -> float:
        t = _f32(min(count, decay_steps))
        cd = _f32(0.5) * (_f32(1) + _cosf(_f32(math.pi) * t / _f32(decay_steps)))
        return float(_f32(init_value) * cd)

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """``optax.join_schedules``: past each boundary the next schedule runs,
    on the count since that boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out

    return schedule
