"""Dataset iterators (↔ deeplearning4j_tpu/data/iterators.py): ``ArrayDataSetIterator``, ``AsyncDataSetIterator``.

``ArrayDataSetIterator`` yields ``DataSet`` minibatches of numpy arrays in
the JAX package's order: the shuffle permutation is a pure function of
(seed, epoch), so both packages see the same batches. ``AsyncDataSetIterator``
prefetches on a background thread and, given a device, copies each batch
there: on a card, from pinned host memory on a copy stream of its own,
which the consumer's stream waits on before it uses the batch (the
counterpart of the JAX package's ``jax.device_put`` ahead of the step).

Not ported yet (ROADMAP queue 1 items 8 and 12): ``ShardedDataSetIterator``,
``ShrinkPolicy``/``derive_shard``, ``TransformIterator``,
``maybe_auto_prefetch``, the recovery layer's ``epoch``/``set_epoch``
and the ``data.read`` fault-injection point.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.utils.pytree import tree_leaves, tree_map


class ArrayDataSetIterator:
    """In-memory (features, labels) → minibatch iterator
    (↔ ListDataSetIterator / ExistingDataSetIterator)."""

    def __init__(self, features, labels, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        if self.features.shape[0] != self.labels.shape[0]:
            raise ValueError(
                f"features and labels disagree on the number of examples "
                f"({self.features.shape[0]} vs {self.labels.shape[0]})")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0
        self._in_pass = False

    def __len__(self):
        n = self.features.shape[0]
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[DataSet]:
        self._in_pass = True
        n = self.features.shape[0]
        idx = np.arange(n)
        if self.shuffle:
            # a function of (seed, epoch): an aborted pass re-iterates in
            # the same order; the epoch advances on a completed pass or
            # reset()
            np.random.default_rng([self.seed, self._epoch]).shuffle(idx)
        end = n - (n % self.batch_size) if self.drop_last else n
        for i in range(0, end, self.batch_size):
            sel = idx[i:i + self.batch_size]
            yield DataSet(self.features[sel], self.labels[sel])
        self._epoch += 1
        self._in_pass = False

    def reset(self):
        # an abandoned pass (steps_per_epoch break, early stop) still
        # counts as an epoch: the next pass reshuffles
        if self._in_pass:
            self._epoch += 1
            self._in_pass = False


def _copy_to(item, device: torch.device):
    """A batch tree (DataSet, dict, tuple) of numpy arrays or tensors → the
    same tree of tensors on ``device``; None leaves stay None. On a card
    the host side is pinned and the copies are asynchronous."""
    def copy(a):
        if a is None:
            return None
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        if device.type != "cuda":
            return t.to(device)
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    return tree_map(copy, item)


class AsyncDataSetIterator:
    """Background-thread prefetch wrapper (↔ AsyncDataSetIterator): a
    bounded queue of ``prefetch`` batches. ``device_put_to`` (a device or
    its name), when given, is where each batch is copied ahead of its use.
    An exception of the base iterator is raised in the consumer."""

    def __init__(self, base: Iterable, prefetch: int = 2,
                 device_put_to=None):
        self.base = base
        self.prefetch = prefetch
        self.device_put_to = device_put_to

    def __iter__(self):
        device = (None if self.device_put_to is None
                  else torch.device(self.device_put_to))
        cuda = device is not None and device.type == "cuda"
        copy_stream = torch.cuda.Stream(device) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        err: list = []

        def put(item) -> bool:
            # gives up when the consumer abandoned the pass, so an early
            # break cannot leave this thread blocked holding device buffers
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in self.base:
                    ready = None
                    if cuda:
                        with torch.cuda.stream(copy_stream):
                            item = _copy_to(item, device)
                            ready = torch.cuda.Event()
                            ready.record(copy_stream)
                    elif device is not None:
                        item = _copy_to(item, device)
                    if not put((item, ready)):
                        return
            except BaseException as e:  # noqa: BLE001 — raised in the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True,
                             name="async-dataset-prefetch")
        t.start()
        try:
            while True:
                got = q.get()
                if got is sentinel:
                    if err:
                        raise err[0]
                    return
                item, ready = got
                if ready is not None:
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(ready)
                    # the allocator must not reuse a batch's memory before
                    # the consumer's stream is done with it
                    for leaf in tree_leaves(item):
                        if torch.is_tensor(leaf):
                            leaf.record_stream(stream)
                yield item
        finally:
            stop.set()
            t.join(timeout=10)

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __len__(self):
        return len(self.base)  # type: ignore[arg-type]
