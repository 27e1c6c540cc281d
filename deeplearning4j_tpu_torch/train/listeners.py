"""Training listeners (↔ deeplearning4j_tpu/train/listeners.py).

Protocol (host side; metrics arrive as tensors on the device and are only
copied to the host when a listener reads them):

    on_fit_start(trainer, ts)
    on_epoch_start(epoch)
    on_iteration(epoch, step, ts, metrics) -> bool (True = stop training)
    on_epoch_end(epoch, ts) -> bool (True = stop)
    on_fit_end(trainer, ts)
"""

from __future__ import annotations

import json
import sys
import time
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.utils.pytree import tree_leaves


class TrainingListener:
    def on_fit_start(self, trainer, ts):
        pass

    def on_epoch_start(self, epoch: int):
        pass

    def on_iteration(self, epoch: int, step: int, ts, metrics) -> bool:
        return False

    def on_epoch_end(self, epoch: int, ts) -> bool:
        return False

    def on_fit_end(self, trainer, ts):
        pass


class ScoreIterationListener(TrainingListener):
    """↔ ScoreIterationListener — print loss every N iterations."""

    def __init__(self, every: int = 10, stream=None):
        self.every = every
        self.stream = stream or sys.stdout
        self.history: List[float] = []

    def on_iteration(self, epoch, step, ts, metrics):
        if step % self.every == 0:
            loss = float(metrics["total_loss"])
            self.history.append(loss)
            print(f"epoch {epoch} iter {step}: loss={loss:.6f}",
                  file=self.stream)
        return False


def _wait_for_device(ts):
    """The card's counterpart of ``jax.block_until_ready(ts.params)``."""
    leaves = tree_leaves(ts.params)
    if leaves and torch.is_tensor(leaves[0]) and leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)


class PerformanceListener(TrainingListener):
    """↔ PerformanceListener — throughput (samples/sec) every N iters.
    Batch size is read from the ``batch_size`` metric."""

    def __init__(self, every: int = 50, stream=None):
        self.every = every
        self.stream = stream or sys.stdout
        self._t0 = None
        self._count0 = 0
        self._samples = 0
        self.last_samples_per_sec: Optional[float] = None

    def on_epoch_start(self, epoch):
        self._t0 = None

    def on_iteration(self, epoch, step, ts, metrics):
        bs = metrics.get("batch_size")
        self._samples += int(bs) if bs is not None else 0
        if self._t0 is None:
            # the first step (kernel builds, allocator warm-up) is not timed
            _wait_for_device(ts)
            self._t0 = time.perf_counter()
            self._count0 = step
            self._samples = 0
            return False
        if (step - self._count0) % self.every == 0:
            _wait_for_device(ts)
            dt = time.perf_counter() - self._t0
            iters = step - self._count0
            msg = f"perf: {iters / dt:.2f} iter/sec"
            if self._samples:
                self.last_samples_per_sec = self._samples / dt
                msg += f", {self.last_samples_per_sec:.1f} samples/sec"
            print(msg, file=self.stream)
        return False


def metrics_record(epoch: int, step: int, metrics) -> dict:
    """Host-side JSONL record for one iteration's metrics."""
    rec = {"epoch": epoch, "step": step, "time": time.time()}
    for k, v in metrics.items():
        try:
            rec[k] = float(v)
        except (TypeError, ValueError, RuntimeError):
            pass
    return rec


class JsonlMetricsListener(TrainingListener):
    """Structured metrics to a JSONL file, one line every ``every`` steps."""

    def __init__(self, path: str, every: int = 1):
        self.path = path
        self.every = every
        self._fh = None

    def on_fit_start(self, trainer, ts):
        self._fh = open(self.path, "a")

    def on_iteration(self, epoch, step, ts, metrics):
        if step % self.every == 0 and self._fh:
            self._fh.write(json.dumps(metrics_record(epoch, step, metrics))
                           + "\n")
        return False

    def on_fit_end(self, trainer, ts):
        if self._fh:
            self._fh.close()
            self._fh = None


class CheckpointListener(TrainingListener):
    """↔ CheckpointListener — rotating checkpoint saves every N
    epochs/iterations (``serde.checkpoint.save_checkpoint``; synchronous:
    the JAX package's ``async_save`` is not ported)."""

    def __init__(self, directory: str, *, every_epochs: Optional[int] = 1,
                 every_iters: Optional[int] = None, keep_last: int = 3,
                 model=None):
        self.directory = directory
        self.every_epochs = every_epochs
        self.every_iters = every_iters
        self.keep_last = keep_last
        self.model = model

    def _save(self, ts, tag: str):
        from deeplearning4j_tpu_torch.serde.checkpoint import save_checkpoint

        save_checkpoint(self.directory, ts, model=self.model, tag=tag,
                        keep_last=self.keep_last)

    def on_iteration(self, epoch, step, ts, metrics):
        if self.every_iters and step % self.every_iters == 0:
            self._save(ts, f"iter{step}")
        return False

    def on_epoch_end(self, epoch, ts):
        if self.every_epochs and (epoch + 1) % self.every_epochs == 0:
            self._save(ts, f"epoch{epoch}")
        return False
