"""Parallel inference (↔ deeplearning4j_tpu/parallel/inference.py).

One replica of the model per device and one daemon worker thread per
replica draining a shared request queue. ``mode="batched"`` coalesces
queued requests up to ``max_batch_size`` rows and zero-pads the coalesced
batch to a power-of-two bucket, as the JAX package does; under PyTorch the
bucket bounds the set of shapes the kernels see rather than a compile
count. The forward runs under ``torch.inference_mode()``.

Features are one array or a dict of arrays sharing the leading batch dim
(BERT's ``{token_ids, segment_ids, mask}``), as numpy arrays or CPU
tensors; results come back as numpy arrays, split per request.

Not yet ported: fault injection, tracing and worker respawn.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime.device import devices as _all_devices
from deeplearning4j_tpu_torch.utils.pytree import tree_leaves, tree_map


class InferenceQueueFull(RuntimeError):
    """Raised by ``output()`` when the request queue is at ``queue_limit``:
    the server is saturated and the caller should shed or retry."""


class InferenceShutdown(RuntimeError):
    """Raised by ``output()`` when the replica set is shut down."""


class InferenceDeadlineExpired(RuntimeError):
    """Delivered to a request whose deadline expired while it was still
    queued: the worker dropped it before dispatch."""


def _rows(inputs) -> int:
    return tree_leaves(inputs)[0].shape[0]


def _to_device(obj, device: torch.device):
    """One replica on ``device``: a module is copied unless it already
    lives there; tensors in a tree are moved; anything else is shared."""
    if isinstance(obj, torch.nn.Module):
        on_device = all(p.device == device for p in obj.parameters())
        return obj if on_device else copy.deepcopy(obj).to(device)
    return tree_map(
        lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, obj)


def _to_numpy(out):
    return tree_map(
        lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
        else np.asarray(a), out)


class _Request:
    __slots__ = ("inputs", "event", "result", "error", "cancelled",
                 "deadline")

    def __init__(self, inputs):
        self.inputs = inputs
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.cancelled = False
        self.deadline = None  # absolute monotonic instant, or None


class ParallelInference:
    """Replicated-model inference server (↔ DL4J's ParallelInference).

    ``forward(replica, features)`` computes outputs from one replica of
    ``variables`` (an ``nn.Module``, or a tree of tensors) and a features
    tree of tensors on that replica's device. ``devices=None`` means every
    CUDA card (``runtime.device.devices``). ``on_batch(n_requests, rows,
    bucket_rows, seconds)`` is called after every dispatch with the
    requests it served, their real (unpadded) rows, the padded bucket and
    the dispatch's wall seconds (the JAX package's hook); an exception it
    raises is dropped, so metrics never fail serving.

    Usage::

        pi = ParallelInference(lambda m, x: m(x), model, mode="batched")
        y = pi.output(x)          # thread-safe, blocking
        pi.shutdown()
    """

    def __init__(
        self,
        forward: Callable[[Any, Any], Any],
        variables: Any,
        *,
        devices: Optional[Sequence] = None,
        mode: str = "instant",
        max_batch_size: int = 32,
        queue_limit: int = 256,
        on_batch: Optional[Callable[[int, int, int, float], None]] = None,
    ):
        if mode not in ("instant", "batched"):
            raise ValueError(f"mode {mode!r}; valid: instant|batched")
        self._devices = ([torch.device(d) for d in devices]
                         if devices is not None else _all_devices())
        self._mode = mode
        self._max_batch = max_batch_size
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            queue_limit)
        self._state_lock = threading.Lock()  # orders enqueue vs shutdown
        self._on_batch = on_batch
        self._fn = forward
        self._replicas = [_to_device(variables, d) for d in self._devices]
        self._running = True
        self._workers: List[threading.Thread] = []
        for i, dev in enumerate(self._devices):
            th = threading.Thread(target=self._worker, args=(i, dev),
                                  daemon=True, name=f"parallel-inference-{i}")
            th.start()
            self._workers.append(th)

    # -- client API --------------------------------------------------------

    def output(self, features, timeout: Optional[float] = None,
               deadline: Optional[float] = None):
        """Blocking single-request inference (thread-safe).

        Raises :class:`InferenceQueueFull` when the queue is full,
        :class:`InferenceShutdown` when shut down, ``TimeoutError`` after
        ``timeout``. ``deadline`` (absolute ``time.monotonic()``, default
        now + ``timeout``) drops a request still queued past it with
        :class:`InferenceDeadlineExpired`."""
        try:
            _rows(features)
        except (IndexError, AttributeError, TypeError) as e:
            raise ValueError(
                "features must be a non-empty tree of arrays with a "
                f"leading batch dim, got {type(features).__name__}") from e
        req = _Request(features)
        if deadline is not None:
            req.deadline = deadline
        elif timeout is not None:
            req.deadline = time.monotonic() + timeout
        with self._state_lock:
            if not self._running:
                raise InferenceShutdown("ParallelInference is shut down")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                req = None
        if req is None:
            raise InferenceQueueFull(
                f"request queue full (queue_limit={self._queue.maxsize})")
        if not req.event.wait(timeout):
            req.cancelled = True
            raise TimeoutError("inference request timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def shutdown(self):
        """Stop accepting requests; queued requests are still served
        (sentinels go in behind them), then the workers exit."""
        with self._state_lock:
            if not self._running:
                return
            self._running = False
        for _ in self._workers:
            self._queue.put(None)
        for th in self._workers:
            th.join(timeout=30)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = InferenceShutdown(
                    "shut down before serving request")
                req.event.set()

    # -- workers -----------------------------------------------------------

    def _expire(self, r: _Request) -> bool:
        """True if ``r`` is dead: cancelled by its caller, or its deadline
        passed while it waited in the queue."""
        if r.cancelled:
            return True
        if r.deadline is not None and time.monotonic() >= r.deadline:
            r.error = InferenceDeadlineExpired(
                "deadline expired while queued; dropped before dispatch")
            r.event.set()
            return True
        return False

    def _take_batch(self, carry: Optional[_Request]):
        """Collect the next batch; ``carry`` is a request that overflowed
        the previous one. Returns (batch, next_carry); batch None means
        shutdown."""
        req = carry if carry is not None else self._queue.get()
        if req is None:
            return None, None
        batch = [req]
        if self._mode == "batched":
            rows = _rows(req.inputs)
            while rows < self._max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)  # keep the shutdown signal for peers
                    break
                if self._expire(nxt):
                    continue
                if rows + _rows(nxt.inputs) > self._max_batch:
                    return batch, nxt  # would overflow: starts the next batch
                batch.append(nxt)
                rows += _rows(nxt.inputs)
        return batch, None

    @staticmethod
    def _bucket(rows: int, cap: int) -> int:
        """Next power of two ≥ rows, clamped to the cap bucket when rows
        fit under it; an oversized batch still pads to a power of two."""
        b = 1
        while b < rows:
            b *= 2
        return min(b, cap) if rows <= cap else b

    def _worker(self, idx: int, device: torch.device):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        replica = self._replicas[idx]
        carry: Optional[_Request] = None
        while True:
            batch, carry = self._take_batch(carry)
            if batch is None:
                return
            batch = [r for r in batch if not self._expire(r)]
            if not batch:
                continue
            try:
                self._dispatch(batch, replica, device)
            except Exception as e:  # noqa: BLE001 — deliver to the callers
                for r in batch:
                    r.error = e
                    r.event.set()

    def _dispatch(self, batch: List[_Request], replica, device):
        sizes = [_rows(r.inputs) for r in batch]
        rows = sum(sizes)
        feats = tree_map(lambda *xs: torch.cat([torch.as_tensor(x)
                                                for x in xs]),
                         *[r.inputs for r in batch])
        bucket = rows
        if self._mode == "batched":
            bucket = self._bucket(rows, self._max_batch)
            if bucket > rows:
                feats = tree_map(lambda a: torch.cat(
                    [a, a.new_zeros((bucket - rows, *a.shape[1:]))]), feats)
        t0 = time.monotonic()
        with torch.inference_mode():
            out = _to_numpy(self._fn(
                replica, tree_map(lambda a: a.to(device), feats)))
        if self._on_batch is not None:
            try:
                self._on_batch(len(batch), rows, bucket,
                               time.monotonic() - t0)
            except Exception:  # noqa: BLE001 — metrics never fail serving
                pass
        offs = np.cumsum([0] + sizes)
        for r, lo, hi in zip(batch, offs[:-1], offs[1:]):
            r.result = tree_map(lambda a: a[int(lo):int(hi)], out)
        for r in batch:
            r.event.set()
