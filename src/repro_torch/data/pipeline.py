"""Sharded host data pipeline: deterministic, prefetched, restart-exact.

Counterpart of ``repro.data.pipeline``. ``ShardedLoader`` wraps a
deterministic ``make_batch(seed, step)`` (a dict of numpy arrays, or any
tree of numpy arrays, tensors and ``GraphBatch``es) and puts each batch on
the device. With ``shardings`` (a tree matching the batch of
``(DeviceMesh, placements)`` pairs) each rank keeps only its own slice of
each array, as a ``DTensor`` (``dist.sharding.local_shard``): the
counterpart of ``jax.make_array_from_process_local_data``. The cursor
(seed, step) is checkpointable (``state()``), so a restart replays nothing.

``prefetch`` runs the loader in a host thread behind a bounded queue. On a
CUDA device the loader copies through pinned memory on a side stream: the
host build AND the host-to-device copy overlap the step. Before a staged
batch is handed over (``ShardedLoader.ready``), the consumer's stream waits
on the copy's event and every tensor of the batch is marked in use on that
stream (``record_stream``), so the caching allocator never gives its memory
back to the side stream while the step still reads it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.train.optim import tree_flatten

__all__ = ["ShardedLoader", "prefetch"]


class _Staged(NamedTuple):
    batch: Any
    step: int
    event: Optional[torch.cuda.Event]


class ShardedLoader:
    """Wraps a deterministic ``make_batch(seed, step)`` into a device
    iterator; ``start_step`` is the first step it makes."""

    def __init__(
        self,
        make_batch: Callable[[int, int], Any],
        seed: int,
        shardings: Optional[Any] = None,  # tree matching the batch
        start_step: int = 0,
        device="cuda",
    ):
        self.make_batch = make_batch
        self.seed = seed
        self.step = start_step  # the next step to build
        self.shardings = shardings
        self.device = resolve_device(device)
        self._consumed = start_step  # the step after the last batch handed over
        self._stream = None

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        return self.ready(self.stage())

    def _place(self, batch, pinned: bool):
        def move(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            if pinned:
                x = x.pin_memory()
            return x.to(self.device, non_blocking=pinned)

        leaves, rebuild = tree_flatten(batch)
        if self.shardings is not None:
            from repro_torch.dist.sharding import is_sharding, local_shard

            sh, _ = tree_flatten(self.shardings, is_leaf=is_sharding)
            if len(sh) != len(leaves):
                raise ValueError("shardings tree does not match the batch")
            return rebuild([local_shard(torch.as_tensor(x), *s) for x, s in zip(leaves, sh)])
        return rebuild([x.map_tensors(move) if isinstance(x, GraphBatch)
                        else move(x) if isinstance(x, (np.ndarray, torch.Tensor)) else x
                        for x in leaves])

    def stage(self) -> _Staged:
        """Build the next batch on the host and start its copy to the
        device (on the side stream when the device is a card)."""
        step = self.step
        batch = self.make_batch(self.seed, step)
        self.step += 1
        if self.device.type != "cuda":
            return _Staged(self._place(batch, pinned=False), step, None)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            moved = self._place(batch, pinned=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(moved, step, event)

    def ready(self, staged: _Staged):
        """The staged batch, safe to use on the current stream."""
        if staged.event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(staged.event)
            for t in _tensors(staged.batch):
                t.record_stream(current)
        self._consumed = staged.step + 1
        return staged.batch

    def state(self) -> dict:
        """Checkpointable cursor: the step after the last batch handed over
        (batches a prefetch thread built ahead are not counted)."""
        return {"seed": self.seed, "next_step": self._consumed}


def _tensors(batch):
    for leaf in tree_flatten(batch)[0]:
        if isinstance(leaf, GraphBatch):
            yield from (getattr(leaf, f.name) for f in dataclasses.fields(leaf)
                        if isinstance(getattr(leaf, f.name), torch.Tensor))
        elif isinstance(leaf, torch.Tensor):
            yield leaf.to_local() if hasattr(leaf, "to_local") else leaf


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Host-thread prefetcher: hides batch construction (and, for a
    ``ShardedLoader`` on a card, the copy to the device) behind the step.
    At most ``depth`` batches wait in the queue. An error in the thread is
    raised to the consumer; closing the generator stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    staged = isinstance(it, ShardedLoader)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            while not stop.is_set():
                if not put((True, it.stage() if staged else next(it))):
                    return
        except StopIteration:
            put((False, None))
        except BaseException as exc:  # handed to the consumer, which raises it
            put((False, exc))

    t = threading.Thread(target=worker, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            ok, item = q.get()
            if not ok:
                if item is None:
                    return
                raise item
            yield it.ready(item) if staged else item
    finally:
        stop.set()
        t.join()
        while not q.empty():
            q.get_nowait()
