#!/usr/bin/env python3
"""RektNet's bf16 step with the soft-argmax points rounded to bf16 before
the loss (as the JAX package's step rounds them) and kept in f32 (as
``train/steps.rektnet_train_step`` keeps them), each against the f32
step, at ``tools/train_to_map.py --family rektnet``'s seed, pool and
batch::

    python3 mit_driverless_cv_traininginfra_tpu_torch/tools/rektnet_points_dtype.py \\
        [--batch 256] [--steps 150] [--device cpu]

For each variant: the first step's gradient (its global norm over the f32
step's, and its cosine with it; the pre-BN conv biases and the head's
bias, whose true gradient is 0, left out), the number of the geometric
loss's edge vectors that are exactly zero, then ``--steps`` Adam steps at
3e-3 (the loss every 10 steps) and the held-out keypoint L2 of the
trained net in eval mode (256 crops, seed 999). Runs on the card unless
``--device cpu``. Prints one JSON line, values unrounded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from mit_driverless_cv_traininginfra_tpu_torch.data.synthetic import rektnet_batch  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.models import rektnet  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.models.cross_ratio_loss import (  # noqa: E402
    cross_ratio_loss,
)
from mit_driverless_cv_traininginfra_tpu_torch.ops.heatmap import gaussian_heatmaps  # noqa: E402
from mit_driverless_cv_traininginfra_tpu_torch.train.optim import (  # noqa: E402
    make_optimizer,
    optimizer_step,
)

# the geometric loss's edges (models/cross_ratio_loss.py)
EDGES = ((5, 3), (3, 1), (1, 0), (6, 4), (4, 2), (2, 0), (2, 1), (4, 3), (6, 5))
VARIANTS = {"f32": (torch.float32, torch.float32),
            "bf16, points bf16": (torch.bfloat16, torch.bfloat16),
            "bf16, points f32": (torch.bfloat16, torch.float32)}


def step(model, opt, imgs, pts, dtype, points_dtype):
    """``rektnet_train_step``'s recipe (l1_softargmax, geo 0.05/0.05,
    Gaussian targets) with the points in ``points_dtype``."""
    opt.zero_grad(set_to_none=True)
    hm, kp = model(imgs, train=True, dtype=dtype, points_dtype=points_dtype)
    _, _, total = cross_ratio_loss(
        hm.float(), kp.float(), gaussian_heatmaps(pts, 80, 80, sigma=1.0), pts,
        loss_type="l1_softargmax", include_geo=True, geo_loss_gamma_horz=0.05,
        geo_loss_gamma_vert=0.05)
    total.backward()
    zeros = sum(int((kp[:, a] - kp[:, b]).abs().sum(-1).eq(0).sum()) for a, b in EDGES)
    return total.detach(), zeros


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    pool_i, pool_p = (torch.from_numpy(a).to(dev)
                      for a in rektnet_batch(np.random.default_rng(0), 2048))
    ev_i, ev_p = rektnet_batch(np.random.default_rng(999), 256)
    trees = rektnet.init(torch.Generator().manual_seed(1))
    out, grads = {}, {}
    for name, (dtype, points_dtype) in VARIANTS.items():
        model = rektnet.KeypointNet(*trees).to(dev)
        opt = make_optimizer(model.parameters(), "Adam", lr=3e-3)
        loss, zeros = step(model, opt, pool_i[:args.batch], pool_p[:args.batch], dtype,
                           points_dtype)
        grads[name] = torch.cat([p.grad.flatten().double() for n, p in model.named_parameters()
                                 if not (n.endswith(".bias") and ("conv" in n or n == "out.bias"))])
        g, g32 = grads[name], grads["f32"]
        row = {"zero_edges": zeros, "grad_norm_over_f32": float(g.norm() / g32.norm()),
               "grad_cos_f32": float(g @ g32 / (g.norm() * g32.norm()))}
        optimizer_step(opt)
        rng, losses = np.random.default_rng(5), [float(loss)]
        for s in range(1, args.steps):
            idx = torch.from_numpy(rng.integers(0, pool_i.shape[0], args.batch)).to(dev)
            loss, _ = step(model, opt, pool_i[idx], pool_p[idx], dtype, points_dtype)
            optimizer_step(opt)
            if s % 10 == 0:
                losses.append(float(loss))
        with torch.no_grad():
            _, kp = model.eval()(torch.from_numpy(ev_i).to(dev))
        row.update(losses_every_10=losses, heldout_l2=float(
            np.linalg.norm(kp.float().cpu().numpy() - ev_p, axis=-1).mean()))
        out[name] = row
    print(json.dumps({"batch": args.batch, "steps": args.steps, "device": str(dev), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
