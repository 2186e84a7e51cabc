"""RektNet checkpoints in the reference layout (counterpart of the JAX
package's ``train/checkpoints.py``).

A ``.pt`` file holds ``{epoch, model: KeypointNet state_dict, optimizer:
torch.optim state_dict}`` (the reference's ``train_eval.py``), so the
reference's tooling reads the port's runs and the port resumes from the
reference's. The optimizer slot is ``torch.optim.Adam.state_dict()``
itself; that file is the whole train state, so it also serves to resume
(the JAX package keeps a separate orbax tree for that).
"""

from __future__ import annotations

from typing import Optional

import torch

from mit_driverless_cv_traininginfra_tpu_torch.models.rektnet import KeypointNet


def rektnet_params_to_state_dict(params, state):
    """``(params, state)`` trees → the reference ``KeypointNet`` state_dict
    (``conv``/``bn``/``res{1..4}.{conv1,bn1,conv2,bn2,shortcut_conv,
    shortcut_bn}``/``out``), f32 CPU tensors, OIHW conv weights;
    ``num_batches_tracked`` is 0."""
    sd = {}

    def put_conv(prefix, p):
        sd[f"{prefix}.weight"] = p["w"].detach().float().cpu().clone()
        sd[f"{prefix}.bias"] = p["b"].detach().float().cpu().clone()

    def put_bn(prefix, bn_p, bn_s):
        sd[f"{prefix}.weight"] = bn_p["scale"].detach().float().cpu().clone()
        sd[f"{prefix}.bias"] = bn_p["bias"].detach().float().cpu().clone()
        sd[f"{prefix}.running_mean"] = bn_s["mean"].detach().float().cpu().clone()
        sd[f"{prefix}.running_var"] = bn_s["var"].detach().float().cpu().clone()
        sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    put_conv("conv", params["stem"])
    put_bn("bn", params["stem"]["bn"], state["stem"])
    for i in range(1, 5):
        p, s = params[f"res{i}"], state[f"res{i}"]
        for name in ("1", "2"):
            put_conv(f"res{i}.conv{name}", p[f"conv{name}"])
            put_bn(f"res{i}.bn{name}", p[f"bn{name}"], s[f"bn{name}"])
        put_conv(f"res{i}.shortcut_conv", p["shortcut_conv"])
        put_bn(f"res{i}.shortcut_bn", p["shortcut_bn"], s["shortcut_bn"])
    put_conv("out", params["out"])
    return sd


def save_rektnet_pt(path: str, model: KeypointNet, epoch: int = 0,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Write ``{epoch, model, optimizer}`` (tensors on the CPU)."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    opt_sd = {} if optimizer is None else _to_cpu(optimizer.state_dict())
    torch.save({"epoch": epoch, "model": sd, "optimizer": opt_sd}, path)


def load_rektnet_pt(path: str, model: KeypointNet,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Load a reference-layout ``.pt`` into ``model`` (and ``optimizer``,
    when given and the file holds an optimizer state); returns its epoch."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"])
    if optimizer is not None and ckpt.get("optimizer"):
        optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt.get("epoch", 0))


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree
