"""MNIST loader (↔ deeplearning4j_tpu/data/mnist.py, MnistDataSetIterator + MnistDataFetcher).

Reads the idx files (``train-images-idx3-ubyte`` …, optionally gzipped) or
a ``mnist.npz`` from the directory ``DL4J_MNIST_DIR`` names, else from
``~/.cache/mnist`` or ``~/.deeplearning4j/mnist``; nothing is downloaded.
Without them it falls back to the JAX package's deterministic synthetic
stand-in: MNIST's shapes, each class a fixed random 28×28 template seen
through noise, the same numpy arrays as the JAX package's for the same
sizes.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

ENV_DIR = "DL4J_MNIST_DIR"

_FILES = {
    "train_images": ["train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"],
    "train_labels": ["train-labels-idx1-ubyte", "train-labels-idx1-ubyte.gz"],
    "test_images": ["t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz"],
    "test_labels": ["t10k-labels-idx1-ubyte", "t10k-labels-idx1-ubyte.gz"],
}


def search_dirs() -> List[str]:
    dirs = [os.path.expanduser("~/.cache/mnist"),
            os.path.expanduser("~/.deeplearning4j/mnist")]
    if os.environ.get(ENV_DIR):
        dirs.insert(0, os.environ[ENV_DIR])
    return dirs


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_real() -> Optional[dict]:
    for d in search_dirs():
        dd = Path(d)
        if not dd.is_dir():
            continue
        found = {}
        for key, names in _FILES.items():
            for n in names:
                if (dd / n).exists():
                    found[key] = dd / n
                    break
        if len(found) == 4:
            return found
        npz = dd / "mnist.npz"
        if npz.exists():
            return {"npz": npz}
    return None


def _synthetic(n_train: int, n_test: int, seed: int = 7):
    """Deterministic learnable stand-in: each class is a fixed random 28×28
    template revealed through noise."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(0.0, 1.0, (10, 28, 28)).astype(np.float32)

    def make(n, seed2):
        r = np.random.default_rng(seed2)
        y = r.integers(0, 10, n)
        noise = r.normal(0.0, 1.0, (n, 28, 28)).astype(np.float32)
        x = 1.0 * templates[y] + 0.5 * noise
        x = (x - x.min()) / (x.max() - x.min())  # into [0,1] like pixel/255
        return (x * 255).astype(np.uint8), y.astype(np.int64)

    xtr, ytr = make(n_train, seed + 1)
    xte, yte = make(n_test, seed + 2)
    return (xtr, ytr), (xte, yte)


def load_mnist(
    *,
    n_train: Optional[int] = None,
    n_test: Optional[int] = None,
    normalize: bool = True,
    one_hot: bool = True,
    flat: bool = False,
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray], bool]:
    """Returns ((x_train, y_train), (x_test, y_test), is_real).

    Images are [N,28,28,1] float32 in [0,1] (NHWC; ``flat`` → [N,784]);
    labels one-hot [N,10] float32 (or int ids if one_hot=False).
    """
    real = _find_real()
    if real is not None:
        if "npz" in real:
            with np.load(real["npz"]) as z:
                xtr, ytr = z["x_train"], z["y_train"]
                xte, yte = z["x_test"], z["y_test"]
        else:
            xtr = _read_idx(real["train_images"])
            ytr = _read_idx(real["train_labels"])
            xte = _read_idx(real["test_images"])
            yte = _read_idx(real["test_labels"])
        is_real = True
    else:
        (xtr, ytr), (xte, yte) = _synthetic(n_train or 60000, n_test or 10000)
        is_real = False

    if n_train:
        xtr, ytr = xtr[:n_train], ytr[:n_train]
    if n_test:
        xte, yte = xte[:n_test], yte[:n_test]

    def prep(x, y):
        x = x.astype(np.float32)
        if normalize:
            x = x / 255.0
        x = (x.reshape(x.shape[0], -1) if flat
             else x.reshape(x.shape[0], 28, 28, 1))
        if one_hot:
            oh = np.zeros((y.shape[0], 10), np.float32)
            oh[np.arange(y.shape[0]), y] = 1.0
            y = oh
        return x, y

    return prep(xtr, ytr), prep(xte, yte), is_real
