"""A sample pool on the card, for hosts that cannot feed the step (the
port's copy of the JAX package's ``data/device_pool.py``).

The dataset is materialised once (one host pass), its images parked on
the device, and batches are sampled with a device gather: the host's work
a step is an index draw. The pool freezes one materialisation of each
sample (its patch choice and host affine warp are drawn once); pair it
with ``device_aug`` so the step's jitter, flips and noise stay fresh.

Under a process mesh (``parallel/mesh.py``) each rank holds the whole
pool on its device (replicated, as the JAX pool is over its mesh) and
draws the same indices; a batch's images are gathered for this rank's
rows only, its labels stay the global batch's (the driver counts targets
on them, then cuts them to the rank's rows).

The images cost ``N·H·W·C·itemsize`` bytes of device memory, and
``budget_bytes`` refuses a pool above it. A bf16 pool halves that (a bf16
step casts its images to bf16 anyway); it is filled item by item straight
into a bf16 tensor, never staged whole in f32.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device


class DevicePool:
    """Images on the device, labels in host numpy.

    Build with :meth:`from_dataset`, then iterate ``pool.loader(batch)``
    like a ``DataLoader``: it yields ``(uris, images, labels)`` with the
    images a device tensor and the labels host numpy (the driver counts
    targets on the host without a sync)."""

    def __init__(self, images: torch.Tensor, labels: np.ndarray,
                 uris: Optional[Sequence[str]] = None, mesh=None):
        self.images = images
        self.mesh = mesh
        self.labels = np.asarray(labels, np.float32)
        self.uris = list(uris) if uris is not None else [""] * len(labels)

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def nbytes(self) -> int:
        return self.images.numel() * self.images.element_size()

    @classmethod
    def from_dataset(cls, dataset, num: Optional[int] = None, device="cuda",
                     budget_bytes: float = 6e9,
                     dtype: torch.dtype = torch.float32,
                     num_workers: int = 1, mesh=None) -> "DevicePool":
        """Read ``dataset[i]`` once per sample, on ``num_workers`` threads
        (the items come in index order), and keep the images on ``device``
        in ``dtype``. ``num`` caps the pool's size; ``budget_bytes`` is the
        device-memory guard. ``mesh``: a process mesh whose ranks each hold
        this pool (``device`` is the rank's)."""
        dev = resolve_device(device)
        n = len(dataset) if num is None else min(num, len(dataset))
        if n == 0:
            raise ValueError("empty dataset")
        uri0, img0, lab0 = dataset[0]
        itemsize = torch.empty((), dtype=dtype).element_size()
        est = n * int(np.prod(np.asarray(img0).shape)) * itemsize
        if est > budget_bytes:
            raise ValueError(
                f"device pool would need {est/1e9:.2f} GB "
                f"(> budget {budget_bytes/1e9:.2f} GB); lower `num`, raise "
                "budget_bytes, or use dtype=bfloat16")
        images = torch.empty((n,) + np.asarray(img0).shape, dtype=dtype, device=dev)
        labels = np.empty((n,) + np.asarray(lab0).shape, np.float32)
        uris = []

        def put(i, item):
            u, im, lb = item
            # one item at a time, converted to `dtype` on its way in
            images[i] = torch.from_numpy(np.asarray(im, np.float32))
            labels[i] = lb
            uris.append(u)

        put(0, (uri0, img0, lab0))
        w = max(1, num_workers)
        with ThreadPoolExecutor(w) as ex:
            for c0 in range(1, n, 2 * w):  # at most 2·w items in flight
                chunk = range(c0, min(c0 + 2 * w, n))
                for i, f in zip(chunk, [ex.submit(dataset.__getitem__, i) for i in chunk]):
                    put(i, f.result())
        return cls(images, labels, uris, mesh=mesh)

    def sample(self, idx):
        """Device gather of a batch: ``(images on the device, labels host
        numpy)``; under a mesh the images of this rank's rows of ``idx``."""
        idx = np.asarray(idx, np.int64)
        mine = idx if self.mesh is None else idx[self.mesh.rows(len(idx))]
        return (self.images[torch.from_numpy(mine).to(self.images.device)],
                self.labels[idx])

    def loader(self, batch_size: int, shuffle: bool = True, seed: int = 17,
               steps_per_epoch: Optional[int] = None):
        """A ``DataLoader``-like epoch iterator of full batches (a tail that
        does not fill one is dropped)."""
        return _PoolLoader(self, batch_size, shuffle, seed, steps_per_epoch)


class _PoolLoader:
    def __init__(self, pool: DevicePool, batch_size: int, shuffle: bool,
                 seed: int, steps_per_epoch: Optional[int]):
        self.pool = pool
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        n_full = len(pool) // batch_size
        if n_full == 0 and steps_per_epoch is None:
            # a zero-step epoch would train nothing while the driver's
            # epochs advance and checkpoint the initial weights
            raise ValueError(
                f"pool of {len(pool)} samples cannot fill one batch of "
                f"{batch_size}; lower batch_size, raise the pool size, or "
                "pass steps_per_epoch to sample with replacement")
        self.steps = steps_per_epoch if steps_per_epoch is not None else n_full

    def __len__(self) -> int:
        return self.steps

    def __iter__(self):
        n = len(self.pool)
        bs = self.batch_size
        n_full = n // bs
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        for s in range(self.steps):
            if s < n_full:   # one shuffled pass without replacement
                idx = order[s * bs:(s + 1) * bs]
            else:            # beyond one pass: sampling with replacement
                idx = self._rng.integers(0, n, bs)
            imgs, labels = self.pool.sample(idx)
            yield [self.pool.uris[i] for i in idx], imgs, labels
