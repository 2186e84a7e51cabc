"""Host-parallel batched loader and its device prefetch (the port's copy of
the JAX package's ``data/loader.py``).

:class:`DataLoader` is the same code: a thread pool reads samples ahead of
the consumer, batches are stacked numpy, and a seed gives the same
shuffle order as the JAX package's. :func:`prefetch_to_device` keeps
``depth`` batches in flight to the card: a producer thread stages each
array in pinned host memory and copies it with ``non_blocking`` on a side
stream; the consumer's stream waits on the copy's event, and each tensor
is marked used on that stream (``record_stream``), so the allocator does
not hand its memory to the side stream's next copy before the consumer's
work on it is done.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence

import numpy as np
import torch

from mit_driverless_cv_traininginfra_tpu_torch.device import resolve_device


class DataLoader:
    """Map-style dataset → shuffled batches of stacked numpy arrays.

    Yields (uris: list[str], images: (B,H,W,C) f32, labels: (B,T,5) f32).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, drop_last: bool = False, seed: int = 17,
                 prefetch_batches: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch_batches = max(1, prefetch_batches)
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        batches: List[Sequence[int]] = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        def collate(futures):
            items = [f.result() for f in futures]
            uris = [it[0] for it in items]
            imgs = np.stack([it[1] for it in items]).astype(np.float32)
            labels = np.stack([it[2] for it in items]).astype(np.float32)
            return uris, imgs, labels

        with ThreadPoolExecutor(self.num_workers) as pool:
            # at most `prefetch_batches` batches of samples in flight ahead
            # of the consumer, so host memory stays bounded
            window = [
                [pool.submit(self.dataset.__getitem__, i) for i in b]
                for b in batches[: self.prefetch_batches]
            ]
            next_batch = self.prefetch_batches
            for _ in range(len(batches)):
                futures = window.pop(0)
                if next_batch < len(batches):
                    window.append([
                        pool.submit(self.dataset.__getitem__, i)
                        for i in batches[next_batch]
                    ])
                    next_batch += 1
                yield collate(futures)


def prefetch_to_device(iterator, device="cuda", depth: int = 2):
    """Wrap a batch iterator: each batch (a tuple) comes back with its
    numpy arrays (ndim > 0) as tensors on ``device``, ``depth`` batches
    copied ahead on a background thread; other fields pass through. On the
    CPU the arrays are wrapped in place. A producer's exception is raised
    in the consumer: a failing dataset ends the epoch with that error, not
    early and quietly. Leaving the loop early stops the producer."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for batch in iterator:
            yield tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) and x.ndim > 0
                        else x for x in batch)
        return

    side = torch.cuda.Stream(dev)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def copy(batch):
        out = []
        with torch.cuda.stream(side):
            for x in batch:
                if isinstance(x, np.ndarray) and x.ndim > 0:
                    host = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
                    x = host.to(dev, non_blocking=True)
                out.append(x)
            ready = torch.cuda.Event()
            ready.record(side)
        return tuple(out), ready

    def producer():
        try:
            with torch.cuda.device(dev):
                for batch in iterator:
                    if not put(copy(batch)):
                        return
            put(done)
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for x in batch:
                if torch.is_tensor(x):
                    x.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        t.join()
