"""Device meshes, batch placement and the port's collectives (counterpart of
the JAX package's ``parallel/mesh.py``).

The JAX package is single-controller SPMD: one ``jax.jit`` over a batch
sharded on the ``data`` axis, XLA inserting the collectives. The port has
two kinds of :class:`Mesh` for the same two jobs:

- a **device mesh** (:func:`make_mesh`): one process drives a list of
  devices, as the JAX server does. ``TwoStageServer(mesh=)`` splits each
  batch over it and ``TwoStagePP`` places its stages on its devices. On the
  CPU a mesh of N ``cpu`` entries runs the split, pad and gather logic for
  real;
- a **process mesh** (:func:`process_mesh`, made by ``parallel/launch.py``
  in each rank): one process per device in a ``torch.distributed`` group,
  ``nccl`` on the card and ``gloo`` on the CPU. Training runs here. Each
  rank holds its contiguous rows of the global batch (:func:`shard_batch`)
  and equal parameters (:func:`replicate`); each rank's loss is its share
  of the global loss, so the sum of the ranks' gradients is one device's
  gradient on the whole batch. The sums that make it so live here:
  :func:`all_sum` and :func:`all_gather` (autograd-aware), the global
  batch-norm statistics (:func:`batch_mean_var`), and the in-place
  reductions of counts, ignore cells, gradients and reported losses
  (:func:`all_sum_`, :func:`all_max_`, :func:`all_sum_grads_`).

``gloo`` handles CUDA tensors only in part (which collectives it takes on
the card depends on how PyTorch was built), so over ``gloo`` every CUDA
tensor of a collective is staged through the host: copied out, reduced or
gathered there, copied back. That is a property of ``gloo``, used where two
ranks share one card (NCCL refuses two ranks on one GPU); the ``nccl`` path
never stages.

Not ported yet: the tensor-parallel and spatial placements
(``shard_channels``, ``make_mesh_2d``, ``shard_spatial``), which in
PyTorch are model code (channel-split convolutions with gathers, halo
exchanges); ROADMAP.md lists them as the next slice.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device

DATA_AXIS = "data"


class Mesh:
    """Devices along the ``data`` axis. ``group`` is None for a device mesh
    (one process, every device) and the process group for a process mesh,
    where this process is ``rank`` and drives ``devices[rank]``."""

    def __init__(self, devices: Sequence, group=None, rank: int = 0):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.rank = rank
        self.stage_through_host = (group is not None
                                   and dist.get_backend(group) == "gloo")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's device (a device mesh: the lead device)."""
        return self.devices[self.rank]

    @property
    def is_lead(self) -> bool:
        """Rank 0 of a process mesh, or a device mesh's one process: the
        one that writes checkpoints, logs and exports."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        return batch_sharding(self, n)[self.rank][1]

    def __repr__(self) -> str:
        kind = "process" if self.group is not None else "device"
        return (f"Mesh({kind}, {DATA_AXIS}={self.size}, rank={self.rank}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A device mesh over ``devices`` (default: every CUDA device of this
    process), the first ``n_devices`` of them. Raises where fewer devices
    exist than asked (JAX's ``devices[:n]`` would take fewer)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: CUDA is not available in this "
                               "process; pass devices=['cpu', ...] for a CPU mesh")
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(f"make_mesh: n_devices must be ≥ 1, got {n_devices}")
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices asked, "
                             f"{len(devices)} available: {devices}")
        devices = devices[:n_devices]
    return Mesh(devices)


def process_mesh(devices: Sequence, group=None) -> Mesh:
    """This rank's mesh in an initialised process group (default: the
    world), ``devices[r]`` being rank r's device."""
    world = dist.get_world_size(group)
    if len(devices) != world:
        raise ValueError(f"process_mesh: {len(devices)} devices for a group "
                         f"of {world} ranks")
    return Mesh(devices, group=group or dist.group.WORLD,
                rank=dist.get_rank(group))


def batch_sharding(mesh: Mesh, n: int) -> list:
    """Where the rows of a batch of ``n`` live: one ``(device, slice)`` a
    mesh position, contiguous equal slices. ``n`` must divide
    (:func:`pad_batch_to_devices` makes it)."""
    if n % mesh.size:
        raise ValueError(f"batch {n} is not divisible by the {mesh.size}-device "
                         "mesh; pad the batch or resize the mesh")
    k = n // mesh.size
    return [(d, slice(i * k, (i + 1) * k)) for i, d in enumerate(mesh.devices)]


def replicated(mesh: Mesh) -> tuple:
    """The devices a replicated value lives on: this process's device on a
    process mesh, every device on a device mesh."""
    return (mesh.device,) if mesh.group is not None else mesh.devices


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def shard_batch(mesh: Mesh, tree) -> list:
    """The parts of a batch tree (tensors or arrays, leading axis the
    batch) that this process holds, each as tensors on its device: on a
    process mesh one part, this rank's rows; on a device mesh one part a
    device, in mesh order."""
    leaves = []
    _tree_map(leaves.append, tree)
    if not leaves:
        raise ValueError("shard_batch: the tree holds no array")
    placement = batch_sharding(mesh, leaves[0].shape[0])
    if mesh.group is not None:
        placement = [placement[mesh.rank]]

    def part(dev, rows):
        return _tree_map(lambda x: torch.as_tensor(x[rows]).to(dev, non_blocking=True),
                         tree)

    return [part(dev, rows) for dev, rows in placement]


def replicate(mesh: Mesh, obj):
    """Equal copies of a module (or a list of tensors). On a process mesh
    rank 0's values are broadcast into ``obj`` in place, which is returned.
    On a device mesh, one object a device: ``obj`` itself where it is on
    that device already, else a copy moved there."""
    if mesh.group is not None:
        tensors = (list(obj.parameters()) + list(obj.buffers())
                   if isinstance(obj, torch.nn.Module) else list(obj))
        with torch.no_grad():
            for t in tensors:
                _collective(t, lambda h: dist.broadcast(h, src=0, group=mesh.group),
                            mesh)
        return obj
    return [module_on(obj, dev) for dev in replicated(mesh)]


def module_on(module, dev: torch.device):
    """``module`` itself where its tensors are on ``dev``, else a copy moved
    there (the original stays where it is)."""
    here = next(iter(list(module.parameters()) + list(module.buffers()))).device
    if here == dev:
        return module
    return copy.deepcopy(module).to(dev)


def pad_batch_to_devices(arr, n_devices: int, mode: str = "repeat"):
    """Pad the leading axis to a multiple of the mesh size so the last
    partial batch keeps its shape. Returns ``(padded, n_real)``.

    ``mode="repeat"`` (default) wraps around onto real samples: zero
    padding would poison the YOLO loss (an all-zero target row decodes to
    a log(1e-16) wh target at cell (0, 0)); any other mode pads zeros.
    numpy arrays give numpy, tensors give tensors on their device."""
    n = arr.shape[0]
    rem = (-n) % n_devices
    if rem == 0:
        return arr, n
    idx = np.arange(rem) % n
    if torch.is_tensor(arr):
        pad = (arr[torch.from_numpy(idx).to(arr.device)] if mode == "repeat"
               else arr.new_zeros((rem,) + tuple(arr.shape[1:])))
        return torch.cat([arr, pad]), n
    arr = np.asarray(arr)
    pad = arr[idx] if mode == "repeat" else np.zeros((rem,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0), n


# ---------------------------------------------------------------------------
# collectives over a process mesh
# ---------------------------------------------------------------------------


def _collective(t: torch.Tensor, op, mesh: Mesh) -> torch.Tensor:
    """Run ``op`` (an in-place collective) on ``t``: on a contiguous copy
    where ``t`` is not contiguous, through the host where ``gloo`` would
    see a CUDA tensor. Returns ``t``, written in place."""
    if mesh.stage_through_host and t.is_cuda:
        host = t.cpu()
        op(host)
        t.copy_(host)
    elif not t.is_contiguous():
        work = t.contiguous()
        op(work)
        t.copy_(work)
    else:
        op(t)
    return t


def _reduce_(t: torch.Tensor, op, mesh: Mesh) -> torch.Tensor:
    return _collective(t, lambda x: dist.all_reduce(x, op, group=mesh.group), mesh)


def _fresh(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _AllSum(torch.autograd.Function):
    """Σ over ranks; the gradient of each rank's input is Σ over ranks of
    the incoming gradients (each rank's loss is its share, so every share
    that saw the sum sends its part back)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _reduce_(_fresh(x), dist.ReduceOp.SUM, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_(_fresh(grad), dist.ReduceOp.SUM, ctx.mesh), None


class _AllGather(torch.autograd.Function):
    """The ranks' equal-sized inputs concatenated in rank order; the
    gradient of this rank's rows is Σ over ranks of the incoming gradient's
    rows (``gloo`` has no reduce-scatter, so it is an all-reduce and a
    slice)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        x = x.contiguous()
        if mesh.stage_through_host and x.is_cuda:
            host = x.cpu()
            parts = [torch.empty_like(host) for _ in range(mesh.size)]
            dist.all_gather(parts, host, group=mesh.group)
            return torch.cat(parts).to(x.device)
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        g = _reduce_(_fresh(grad), dist.ReduceOp.SUM, ctx.mesh)
        r = ctx.mesh.rank
        return g[r * ctx.n:(r + 1) * ctx.n], None


def all_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ of ``x`` over the ranks, differentiable."""
    return _AllSum.apply(x, mesh)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along axis 0 in rank
    order: the global batch from the local rows. Differentiable."""
    return _AllGather.apply(x, mesh)


@torch.no_grad()
def all_sum_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In-place Σ over the ranks (counts, reported losses)."""
    return _reduce_(t, dist.ReduceOp.SUM, mesh)


@torch.no_grad()
def all_max_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In-place max over the ranks (the YOLO loss's batch-global ignore
    cells)."""
    return _reduce_(t, dist.ReduceOp.MAX, mesh)


def batch_mean_var(xf: torch.Tensor, dims, mesh: Mesh):
    """Batch norm's statistics over the global batch, in the single-device
    two-pass form: the mean of ``xf`` over ``dims`` first, then the mean of
    ``(xf − mean)²``, each a local sum all-summed over the ranks and
    divided by the global count, which is returned as the third value.
    Differentiable: the backward sums each share's gradient over the
    ranks."""
    shape = [1] * xf.ndim
    keep = [d for d in range(xf.ndim) if d not in dims]
    for d in keep:
        shape[d] = xf.shape[d]
    n = xf.numel() // int(np.prod([xf.shape[d] for d in keep])) * mesh.size
    mean = all_sum(xf.sum(dim=dims), mesh) / n
    var = all_sum(((xf - mean.reshape(shape)) ** 2).sum(dim=dims), mesh) / n
    return mean, var, n


@torch.no_grad()
def all_sum_grads_(params, mesh: Mesh) -> None:
    """Σ of the gradients over the ranks, in place, as one flat buffer (a
    parameter without a gradient counts as zeros)."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_sum_(flat, mesh)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        p.grad = g
        offset += n
