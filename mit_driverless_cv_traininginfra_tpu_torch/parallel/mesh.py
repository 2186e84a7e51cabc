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

The JAX package's two more axes run on a 2-D ``(data, model)`` process
mesh (:func:`make_mesh_2d`, :class:`Mesh2D`: a ``data`` and a ``model``
sub-mesh in each rank). Under GSPMD they are placements; in PyTorch they
are model code, and their pieces live here:

- **tensor parallel**: :func:`shard_channels` cuts this rank's block of
  out-channels from a JAX-layout tree by JAX's rule (:func:`channel_split`),
  :func:`gather_channels` puts the whole tree back. A split convolution
  (``models/darknet.py``) runs :func:`copy_to_model` on its input (identity
  forward, Σ over ``model`` backward), its weight block, and
  :func:`gather_blocks` on its output (all-gather forward, a slice
  backward); batch statistics and gradients are summed over ``data``;
- **spatial**: :func:`shard_spatial` gives each rank whole rows of the
  network's coarsest grid (:func:`spatial_rows`), each convolution takes
  its neighbours' boundary rows (:func:`halo_exchange`), and the pre-yolo
  maps are gathered on H (:func:`gather_blocks`, unequal blocks).

Each model-axis collective notes ``(kind, shape, bytes)`` in its mesh's
``collectives`` list, where a test or a runner reads what moved.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


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
        self.collectives: list = []  # (kind, shape, bytes) of model-axis ops

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


class Mesh2D:
    """A ``(data, model)`` mesh of ``n_data·n_model`` positions laid out
    data-major, as the JAX package reshapes its device list: position ``r =
    d·n_model + m`` drives ``devices[r]``. This process is position
    ``rank``; ``data`` is the 1-D :class:`Mesh` along its column (the
    positions holding other rows of the batch and the same blocks of
    channels or frame rows), ``model`` the one along its row (the same
    batch rows, the other blocks). On a process mesh each carries its own
    process group (``groups``: this rank's data group and model group); on
    a device mesh neither does, and ``rank`` only picks the position."""

    def __init__(self, n_data: int, n_model: int, devices: Sequence, rank: int = 0,
                 groups=(None, None)):
        if n_data < 1 or n_model < 1:
            raise ValueError(f"a mesh needs n_data, n_model ≥ 1, got {n_data}x{n_model}")
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.devices) != n_data * n_model:
            raise ValueError(f"mesh {n_data}x{n_model} takes {n_data * n_model} "
                             f"devices, got {len(self.devices)}")
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.rank = rank
        d, m = divmod(rank, n_model)
        self.data = Mesh(self.devices[m::n_model], group=groups[0], rank=d)
        self.model = Mesh(self.devices[d * n_model:(d + 1) * n_model],
                          group=groups[1], rank=m)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]


def make_mesh_2d(n_data: int, n_model: int, devices=None) -> Mesh2D:
    """A 2-D ``(data, model)`` mesh (the JAX package's ``make_mesh_2d``).

    In an initialised process group it is this rank's process mesh over
    the whole world (``devices[r]`` rank r's device, one entry a rank):
    every rank makes every sub-group, the ``data`` groups (one a model
    position) and then the ``model`` groups (one a data position), in that
    fixed order, as ``dist.new_group`` requires. Otherwise it is a device
    mesh over the first ``n_data·n_model`` of ``devices`` (default: every
    CUDA device). Raises where fewer devices exist than the mesh takes, as
    JAX's does, and where a process mesh would leave ranks out of it."""
    need = n_data * n_model
    if dist.is_initialized():
        world = dist.get_world_size()
        if devices is None or len(devices) != world:
            raise ValueError(f"make_mesh_2d: give one device a rank ({world} ranks)")
        if world != need:
            raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, "
                             f"the process group has {world} ranks")
        data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                       for m in range(n_model)]
        model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                        for d in range(n_data)]
        rank = dist.get_rank()
        d, m = divmod(rank, n_model)
        return Mesh2D(n_data, n_model, [resolve_device(x) for x in devices], rank,
                      (data_groups[m], model_groups[d]))
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if len(devices) < need:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, "
                         f"have {len(devices)}")
    return Mesh2D(n_data, n_model, [resolve_device(x) for x in devices[:need]])


def data_axis(mesh):
    """The mesh a data-parallel step sums over: a :class:`Mesh2D`'s ``data``
    sub-mesh, any other mesh (or None) itself."""
    return mesh.data if isinstance(mesh, Mesh2D) else mesh


# Leaf names whose last dim is out-channels in the JAX-layout trees: conv
# kernels HWIO ("w"), conv bias ("b"), BN scale/bias, BN running mean/var
# (and the optimizer moments, which mirror the parameter tree). Anything
# else (anchor tables, step counters) replicates.
CHANNEL_LEAF_NAMES = frozenset({"w", "b", "scale", "bias", "mean", "var"})


def _leaf_name(path) -> Optional[str]:
    """Innermost key of a tree path (the keys from the root), if any."""
    return str(path[-1]) if path else None


def channel_split(path, shape, mp: int, key_allow=CHANNEL_LEAF_NAMES) -> bool:
    """JAX's ``shard_channels`` rule for one leaf: split its last dim over
    ``mp`` model positions only when its innermost key is in ``key_allow``
    (None: any key), it has a dim, and that dim is at least ``mp`` and a
    multiple of it."""
    return ((key_allow is None or _leaf_name(path) in key_allow)
            and len(shape) >= 1 and shape[-1] >= mp and shape[-1] % mp == 0)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def shard_channels(mesh: Mesh2D, tree, key_allow=CHANNEL_LEAF_NAMES):
    """This position's part of a JAX-layout numpy tree (HWIO kernels, so
    the last dim is out-channels) under tensor parallelism: block ``m`` of
    ``mp`` (contiguous, as ``P(…, 'model')`` lays the blocks out) of every
    leaf :func:`channel_split` splits, the whole of every other leaf."""
    mp, m = mesh.shape[MODEL_AXIS], mesh.model.rank

    def place(path, x):
        x = np.asarray(x)
        if not channel_split(path, x.shape, mp, key_allow):
            return x
        k = x.shape[-1] // mp
        return np.ascontiguousarray(x[..., m * k:(m + 1) * k])

    return _map_with_path(place, tree)


def gather_channels(mesh: Mesh2D, tree, like, key_allow=CHANNEL_LEAF_NAMES):
    """The inverse of :func:`shard_channels` on a process mesh: this rank's
    JAX-layout tree → the whole tree as numpy, each leaf that was split
    (decided on the whole tree ``like``'s shapes, from which the parts were
    cut) all-gathered over ``model`` and joined on its last dim in rank
    order. Every rank of the model row must call it."""
    mp = mesh.shape[MODEL_AXIS]

    def join(path, x):
        whole = np.shape(_leaf(like, path))
        if not channel_split(path, whole, mp, key_allow):
            return np.asarray(x)
        t = torch.as_tensor(np.ascontiguousarray(x)).to(mesh.model.device)
        return _gather_equal(t, mesh.model, t.ndim - 1).cpu().numpy()

    return _map_with_path(join, tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def spatial_rows(height: int, stride: int, n_model: int) -> list:
    """Frame rows of each of ``n_model`` positions: H split in whole rows of
    the network's coarsest grid (``stride`` frame rows each), so every
    level of the network splits cleanly; earlier positions take the extra
    grid rows. 416 at stride 32 over 2 gives rows 0-224 and 224-416."""
    if height % stride:
        raise ValueError(f"height {height} is not a multiple of the coarsest "
                         f"stride {stride}")
    coarse = height // stride
    if n_model > coarse:
        raise ValueError(f"{n_model} model positions for {coarse} rows of the "
                         "coarsest grid: each needs at least one")
    q, r = divmod(coarse, n_model)
    ends = np.cumsum([0] + [q + (m < r) for m in range(n_model)]) * stride
    return [slice(int(a), int(b)) for a, b in zip(ends[:-1], ends[1:])]


def spatial_sharding(mesh: Mesh2D, shape, stride: int) -> list:
    """Where the blocks of an NHWC batch of ``shape`` live: one ``(device,
    batch rows, frame rows)`` a mesh position, data-major; the batch split
    over ``data`` (:func:`batch_sharding`), H over ``model``
    (:func:`spatial_rows`)."""
    nd, nm = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    batch = [rows for _, rows in batch_sharding(mesh.data, shape[0])]
    rows = spatial_rows(shape[1], stride, nm)
    return [(mesh.devices[d * nm + m], batch[d], rows[m])
            for d in range(nd) for m in range(nm)]


def shard_spatial(mesh: Mesh2D, images, stride: int) -> list:
    """The blocks of an NHWC batch (array or tensor) this process holds,
    each a tensor on its device: on a process mesh one, this rank's batch
    rows and frame rows; on a device mesh one a position, in mesh order."""
    placement = spatial_sharding(mesh, images.shape, stride)
    if mesh.model.group is not None:
        placement = [placement[mesh.rank]]
    return [torch.as_tensor(images[b, r]).to(dev) for dev, b, r in placement]


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
    device, in mesh order. A :class:`Mesh2D` splits the batch over its
    ``data`` axis (the ranks of one ``model`` row hold the same rows)."""
    mesh = data_axis(mesh)
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
    its rank 0's values are broadcast into ``obj`` in place, which is
    returned.
    On a device mesh, one object a device: ``obj`` itself where it is on
    that device already, else a copy moved there."""
    if mesh.group is not None:
        tensors = (list(obj.parameters()) + list(obj.buffers())
                   if isinstance(obj, torch.nn.Module) else list(obj))
        src = dist.get_global_rank(mesh.group, 0)
        with torch.no_grad():
            for t in tensors:
                _collective(t, lambda h: dist.broadcast(h, src=src, group=mesh.group),
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


# ---------------------------------------------------------------------------
# model-axis collectives (tensor-parallel and spatial)
# ---------------------------------------------------------------------------


def _note(mesh: Mesh, kind: str, t: torch.Tensor) -> None:
    mesh.collectives.append((kind, tuple(t.shape), t.numel() * t.element_size()))


def _gather_equal(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The ranks' equal-shaped ``x`` joined on ``dim`` in rank order."""
    x = x.contiguous()
    src = x.cpu() if mesh.stage_through_host and x.is_cuda else x
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim).to(x.device)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``model``
    (each position's block of out-channels sends back its part of the
    input's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        _note(ctx.mesh, "all_reduce", grad)
        return _reduce_(_fresh(grad), dist.ReduceOp.SUM, ctx.mesh), None


class _GatherBlocks(torch.autograd.Function):
    """The ranks' blocks joined on ``dim`` in rank order, rank r's block
    ``sizes[r]`` long there (``gloo``'s all-gather takes equal shapes, so
    each block is padded to the longest and trimmed after). The backward
    is this rank's slice of the gradient: every rank computes the same
    whole output from here on, so the slice is the whole gradient of its
    block, and no sum is taken."""

    @staticmethod
    def forward(ctx, x, mesh, dim, sizes):
        r, n = mesh.rank, max(sizes)
        if x.shape[dim] != sizes[r]:
            raise ValueError(f"rank {r}: a block of {x.shape[dim]} on dim {dim}, "
                             f"{sizes[r]} expected")
        ctx.mesh, ctx.dim, ctx.start, ctx.n = mesh, dim, sum(sizes[:r]), sizes[r]
        if n > sizes[r]:
            pad = list(x.shape)
            pad[dim] = n - sizes[r]
            x = torch.cat([x, x.new_zeros(pad)], dim)
        _note(mesh, "all_gather", x)
        parts = _gather_equal(x, mesh, dim).split(n, dim)
        return torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, sizes)], dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.n), None, None, None


def _p2p(mesh: Mesh, sends, recvs) -> None:
    """Point-to-point transfers within ``mesh``: ``sends`` and ``recvs`` are
    ``(rank in the mesh, tensor)`` pairs; every transfer is posted, then
    waited for, and each received tensor written in place."""
    stage = mesh.stage_through_host
    ops, back = [], []
    for op, pairs in ((dist.isend, sends), (dist.irecv, recvs)):
        for peer, t in pairs:
            buf = t.contiguous()
            if stage and buf.is_cuda:
                buf = buf.cpu()
            if op is dist.irecv and buf is not t:
                back.append((t, buf))
            ops.append(dist.P2POp(op, buf, dist.get_global_rank(mesh.group, peer),
                                  mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for t, buf in back:
        t.copy_(buf)


class _Halo(torch.autograd.Function):
    """``x`` with ``above`` boundary rows of the previous rank on ``dim``
    before it and ``below`` rows of the next rank after it; the first rank
    gets ``fill`` rows above, the last ``fill`` rows below (a convolution's
    own zero padding, or a pool's). The backward sends each halo's
    gradient back to the rank that owns the rows, where it adds to them."""

    @staticmethod
    def forward(ctx, x, mesh, dim, above, below, fill):
        r, last, n = mesh.rank, mesh.size - 1, x.shape[dim]
        if max(above, below) > n:
            raise ValueError(f"rank {r}: a halo of {above}/{below} rows from a "
                             f"block of {n}")
        ctx.mesh, ctx.dim, ctx.above, ctx.below = mesh, dim, above, below

        def rows(k):
            shape = list(x.shape)
            shape[dim] = k
            return x.new_full(shape, fill)

        top, bottom = rows(above), rows(below)
        sends, recvs = [], []
        if r > 0:
            sends.append((r - 1, x.narrow(dim, 0, below)))
            recvs.append((r - 1, top))
        if r < last:
            sends.append((r + 1, x.narrow(dim, n - above, above)))
            recvs.append((r + 1, bottom))
        _exchange(mesh, sends, recvs)
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, dim, above, below = ctx.mesh, ctx.dim, ctx.above, ctx.below
        r, last = mesh.rank, mesh.size - 1
        n = grad.shape[dim] - above - below
        g = grad.narrow(dim, above, n).clone()
        sends, recvs = [], []
        if r > 0:
            sends.append((r - 1, grad.narrow(dim, 0, above)))
            recvs.append((r - 1, torch.empty_like(g.narrow(dim, 0, below))))
        if r < last:
            sends.append((r + 1, grad.narrow(dim, above + n, below)))
            recvs.append((r + 1, torch.empty_like(g.narrow(dim, n - above, above))))
        _exchange(mesh, sends, recvs)
        if r > 0:
            g.narrow(dim, 0, below).add_(recvs[0][1])
        if r < last:
            g.narrow(dim, n - above, above).add_(recvs[-1][1])
        return g, None, None, None, None, None


def _exchange(mesh: Mesh, sends, recvs) -> None:
    """:func:`_p2p` of the non-empty halos, each send noted."""
    sends = [(p, t) for p, t in sends if t.numel()]
    for _, t in sends:
        _note(mesh, "halo", t)
    _p2p(mesh, sends, [(p, t) for p, t in recvs if t.numel()])


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` itself, its gradient summed over the ``model`` mesh: the
    input of a convolution whose out-channels are split over it."""
    return _CopyToModel.apply(x, mesh)


def gather_blocks(x: torch.Tensor, mesh: Mesh, dim: int, sizes=None) -> torch.Tensor:
    """The ``model`` ranks' blocks of a tensor joined on ``dim`` in rank
    order (``sizes``: each rank's length there, default all equal to this
    rank's). Differentiable, the backward a slice."""
    sizes = list(sizes) if sizes is not None else [x.shape[dim]] * mesh.size
    return _GatherBlocks.apply(x, mesh, dim, sizes)


def halo_exchange(x: torch.Tensor, mesh: Mesh, dim: int, above: int, below: int,
                  fill: float = 0.0) -> torch.Tensor:
    """This rank's rows of ``x`` on ``dim`` with ``above`` rows of the
    previous ``model`` rank and ``below`` of the next around them, ``fill``
    at the frame's edges. Differentiable."""
    return _Halo.apply(x, mesh, dim, above, below, fill)
