"""One process per device: the port's counterpart of the JAX package's
implicit device set.

:func:`launch` spawns one rank per entry of ``devices`` with
``torch.multiprocessing`` (``spawn``: each child imports the module of the
function it runs, so that module must not import JAX), joins them in a
``torch.distributed`` group and calls ``fn(mesh, *args)`` in each, ``mesh``
being the rank's :func:`~.mesh.process_mesh`, or with ``mesh_shape=(n_data,
n_model)`` its 2-D :func:`~.mesh.make_mesh_2d` over the same ranks. Rendezvous goes through a
``file://`` store in a fresh temporary directory, never a fixed TCP port,
so several launches may run at once on one host; a CPU rank runs one
intra-op thread. The arguments go to the ranks through a file in that
directory, not through the spawn pipe: a child reads its pipe only after
it has imported its modules, so a pickle larger than the pipe's buffer
held the parent at each child in turn and the ranks started one after
another. The backend is ``nccl``
when every rank has a CUDA device of its own and ``gloo`` otherwise (the
CPU, or ranks that share a card). A rank that raises ends the launch: the
others are stopped and the parent raises with that rank's traceback.
Returns rank 0's return value (pickled through a file in the same
directory).

:func:`rank_devices` turns ``(n, device)`` into the ranks' devices and
raises where fewer CUDA devices exist than ranks asked.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device
from mit_driverless_cv_traininginfra_tpu_torch.parallel.mesh import (
    make_mesh_2d,
    process_mesh,
)

ARGS, RESULT = "args.pkl", "rank0_result.pkl"


def rank_devices(n: int, device="cuda") -> list:
    """``n`` ranks' devices: ``cuda:0`` … ``cuda:n-1`` for ``"cuda"`` (raises
    where fewer are visible), ``n`` times ``cpu`` for ``"cpu"``."""
    if n < 1:
        raise ValueError(f"n_devices must be ≥ 1, got {n}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    have = torch.cuda.device_count()
    if n > have:
        raise RuntimeError(f"{n} ranks asked, but only {have} CUDA devices are "
                           "visible")
    return [torch.device("cuda", i) for i in range(n)]


def default_backend(devices: Sequence) -> str:
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def _rank_main(rank: int, fn, devices, backend: str, store: str,
               mesh_shape=None) -> None:
    with open(os.path.join(store, ARGS), "rb") as f:
        args = pickle.load(f)
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # N CPU ranks are N cores
    dist.init_process_group(backend, init_method=f"file://{store}/rendezvous",
                            world_size=len(devices), rank=rank)
    try:
        mesh = (make_mesh_2d(*mesh_shape, devices) if mesh_shape
                else process_mesh(devices))
        out = fn(mesh, *args)
        if rank == 0:
            with open(os.path.join(store, RESULT), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_on_rank(mesh, fn, kwargs):
    """``fn(**kwargs, mesh=mesh)``; ranks other than 0 print nothing (an
    entry point's ``main`` on each rank of ``launch``)."""
    if mesh.is_lead:
        return fn(**kwargs, mesh=mesh)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        return fn(**kwargs, mesh=mesh)


def launch(fn, devices: Sequence, args: tuple = (), backend: Optional[str] = None,
           mesh_shape: Optional[tuple] = None):
    """Run ``fn(mesh, *args)`` in one spawned rank per device; returns rank
    0's result. ``fn`` and ``args`` must pickle (a module-level function of
    a module that imports no JAX). ``mesh_shape=(n_data, n_model)`` gives
    each rank a 2-D mesh (their product must be the number of ranks)."""
    devices = [resolve_device(d) for d in devices]
    if mesh_shape and mesh_shape[0] * mesh_shape[1] != len(devices):
        raise ValueError(f"a {mesh_shape[0]}x{mesh_shape[1]} mesh over "
                         f"{len(devices)} ranks")
    backend = backend or default_backend(devices)
    if backend == "nccl" and len(set(devices)) != len(devices):
        raise ValueError("nccl takes one rank per GPU; use gloo for ranks that "
                         "share a card")
    with tempfile.TemporaryDirectory(prefix="mdcv_launch_") as store:
        with open(os.path.join(store, ARGS), "wb") as f:
            pickle.dump(args, f, protocol=pickle.HIGHEST_PROTOCOL)
        mp.start_processes(_rank_main, args=(fn, devices, backend, store, mesh_shape),
                           nprocs=len(devices), join=True, start_method="spawn")
        with open(os.path.join(store, RESULT), "rb") as f:
            return pickle.load(f)  # written by rank 0 of this launch
