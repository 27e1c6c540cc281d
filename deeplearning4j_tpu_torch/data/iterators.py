"""Dataset iterators (↔ deeplearning4j_tpu/data/iterators.py): ``ArrayDataSetIterator``, ``AsyncDataSetIterator``, ``ShardedDataSetIterator``.

``ArrayDataSetIterator`` yields ``DataSet`` minibatches of numpy arrays in
the JAX package's order: the shuffle permutation is a pure function of
(seed, epoch), so both packages see the same batches. ``AsyncDataSetIterator``
prefetches on a background thread and, given a device, copies each batch
there: on a card, from pinned host memory on a copy stream of its own,
which the consumer's stream waits on before it uses the batch (the
counterpart of the JAX package's ``jax.device_put`` ahead of the step).

``ShardedDataSetIterator`` feeds ``Trainer(mesh=...)``: each rank keeps its
row block of the global batch (``derive_shard`` under a ``ShrinkPolicy``)
and yields ``DTensor``s sharded on dim 0 over the mesh.

Not ported yet (ROADMAP queue 1 item 12): ``TransformIterator``,
``maybe_auto_prefetch``, the recovery layer's ``epoch``/``set_epoch``
and the ``data.read`` fault-injection point.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, as_batch_dict
from deeplearning4j_tpu_torch.runtime import distributed
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


# -- sharded input (↔ the JAX package's per-host input sharding) -------------

# the elastic supervisor arms these per generation, so that a relaunched
# worker re-derives its shard from the new (worker_id, num_workers)
ENV_SHRINK_POLICY = "DL4J_TPU_SHRINK_POLICY"
ENV_BASELINE_NUM_WORKERS = "DL4J_TPU_BASELINE_NUM_WORKERS"


class ShrinkPolicy:
    """How a shrunken cohort (N baseline workers, n < N survivors)
    re-divides the global batch:

    - ``PRESERVE_GLOBAL_BATCH``: the global batch stays whole; each
      survivor's share grows to ``rows / n`` (the default).
    - ``PRESERVE_PER_WORKER_BATCH``: each survivor keeps its baseline share
      ``rows / N``; the dead slots' rows are dropped, so the global batch
      shrinks to ``n * rows / N``.
    """

    PRESERVE_GLOBAL_BATCH = "preserve_global_batch"
    PRESERVE_PER_WORKER_BATCH = "preserve_per_worker_batch"
    ALL = (PRESERVE_GLOBAL_BATCH, PRESERVE_PER_WORKER_BATCH)

    @staticmethod
    def from_env(default: str = PRESERVE_GLOBAL_BATCH) -> str:
        """``DL4J_TPU_SHRINK_POLICY``, or ``default`` on junk or absence."""
        val = os.environ.get(ENV_SHRINK_POLICY, "").strip().lower()
        return val if val in ShrinkPolicy.ALL else default


def baseline_num_workers_from_env() -> Optional[int]:
    """The cohort's full size (``DL4J_TPU_BASELINE_NUM_WORKERS``); None
    when unset or not a positive integer."""
    raw = os.environ.get(ENV_BASELINE_NUM_WORKERS)
    try:
        n = int(raw) if raw else 0
    except ValueError:
        return None
    return n if n >= 1 else None


def derive_shard(n_rows: int, worker_id: int, num_workers: int, *,
                 baseline_num_workers: Optional[int] = None,
                 policy: Optional[str] = None) -> slice:
    """This worker's row block of a global batch of ``n_rows``, from the
    live ``(worker_id, num_workers)``: ``PRESERVE_GLOBAL_BATCH`` divides by
    ``num_workers``, ``PRESERVE_PER_WORKER_BATCH`` by
    ``baseline_num_workers``. The JAX package's errors."""
    policy = ShrinkPolicy.from_env() if policy is None else policy
    if policy not in ShrinkPolicy.ALL:
        raise ValueError(f"unknown shrink policy {policy!r}; expected one "
                         f"of {ShrinkPolicy.ALL}")
    if not 0 <= worker_id < num_workers:
        raise ValueError(f"worker_id {worker_id} out of range for "
                         f"num_workers={num_workers}")
    divisor = num_workers
    if policy == ShrinkPolicy.PRESERVE_PER_WORKER_BATCH:
        divisor = baseline_num_workers or num_workers
        if divisor < num_workers:
            raise ValueError(
                f"baseline_num_workers={divisor} smaller than the live "
                f"cohort ({num_workers}) — the baseline is the FULL size")
    per, rem = divmod(n_rows, divisor)
    if rem:
        raise ValueError(
            f"global batch {n_rows} not divisible by {divisor} "
            f"({'baseline ' if divisor != num_workers else ''}workers)")
    return slice(worker_id * per, (worker_id + 1) * per)


class ShardedDataSetIterator:
    """Per-rank input sharding for ``Trainer(mesh=...)``: batches emerge
    as dicts of global ``DTensor``s laid out by ``spec`` (a
    ``NamedSharding``, e.g. ``batch_sharding(mesh)``) over ``mesh``, each
    rank holding its rows on its device.

    - ``local=False`` (default): ``base`` yields the global batch on every
      rank; each keeps its contiguous row block (``derive_shard`` under
      ``shrink_policy`` / ``baseline_num_workers``, which default to the
      supervisor's environment).
    - ``local=True``: ``base`` yields this rank's rows only; rows
      concatenate in rank order.
    """

    def __init__(self, base: Iterable, mesh, spec, *, local: bool = False,
                 shrink_policy: Optional[str] = None,
                 baseline_num_workers: Optional[int] = None):
        self.base = base
        self.mesh = mesh
        self.spec = spec
        self.local = local
        self.shrink_policy = (ShrinkPolicy.from_env()
                              if shrink_policy is None else shrink_policy)
        if self.shrink_policy not in ShrinkPolicy.ALL:
            raise ValueError(
                f"unknown shrink policy {self.shrink_policy!r}; expected "
                f"one of {ShrinkPolicy.ALL}")
        self.baseline_num_workers = (
            baseline_num_workers_from_env()
            if baseline_num_workers is None else baseline_num_workers)
        if distributed.process_count() > 1:
            # row blocks go out in rank order; a mesh that interleaves the
            # ranks would scramble rows across them
            ranks = mesh.mesh.flatten().tolist()
            if ranks != sorted(ranks):
                raise ValueError(
                    "mesh device order interleaves processes; build the "
                    "mesh with runtime.distributed.global_mesh() (or any "
                    "process-grouped order) for per-host input sharding")

    def _proc_slice(self, arr):
        if self.local:
            return arr
        n = distributed.process_count()
        baseline = self.baseline_num_workers or n
        if n == 1 and baseline == 1:
            return arr
        return arr[derive_shard(arr.shape[0], distributed.process_index(), n,
                                baseline_num_workers=baseline,
                                policy=self.shrink_policy)]

    def __iter__(self):
        for batch in self.base:
            b = as_batch_dict(batch)
            locl = tree_map(lambda v: self._proc_slice(np.asarray(v)), b)
            yield distributed.host_local_to_global(locl, self.mesh,
                                                   self.spec)

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __len__(self):
        return len(self.base)
