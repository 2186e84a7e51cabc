"""Optimizers and learning-rate schedules with the reference's semantics
(counterpart of the JAX package's ``train/optim.py``).

- YOLO: Adam(lr, weight_decay) or SGD(lr, momentum, weight_decay),
  StepLR(step_size=1, gamma) stepped once per epoch.
- RektNet: Adam(lr) + ExponentialLR(gamma=0.999) per epoch.

Weight decay is L2 in the gradient (``torch.optim``'s ``weight_decay``),
which is where the JAX package's ``optax.add_decayed_weights`` puts it,
before Adam. The schedules are host-side scalars written into the param
groups between epochs (:func:`set_lr`).
"""

from __future__ import annotations

import torch


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


def optimizer_step(opt: torch.optim.Optimizer) -> None:
    """Clip the gradients' global norm to ``opt.grad_clip`` (when set),
    then take the optimizer's step."""
    if getattr(opt, "grad_clip", 0.0):
        torch.nn.utils.clip_grad_norm_(
            [p for g in opt.param_groups for p in g["params"]], opt.grad_clip)
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
