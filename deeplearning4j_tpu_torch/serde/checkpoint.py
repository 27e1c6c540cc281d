"""Weights carried across from the JAX package (↔ deeplearning4j_tpu/serde/checkpoint.py).

The JAX package's checkpoint directory holds ``state.npz`` (every leaf
under its path name, ``params/layer_3/attention/Wq``), ``manifest.json``
(a SHA-256 per array) and ``meta.json``. The port reads it with numpy
alone and checks the digest of every array it loads. Names and layouts are
shared, so a tree moves into the port's modules name for name.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.pytree import (
    flatten_with_names,
    tree_map,
    unflatten,
)

_MANIFEST = "manifest.json"


def _array_sha256(a: np.ndarray) -> str:
    """Content digest of one array (dtype + shape + raw bytes), as the
    JAX package's manifest computes it."""
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(tuple(a.shape)).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def variables_from_numpy(tree: Any, device=None) -> Any:
    """A JAX ``{"params": ...}`` tree of numpy arrays → the same tree of
    torch tensors on ``device`` (``None`` keeps the CPU)."""
    def convert(a):
        t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
        return t if device is None else t.to(device)

    return tree_map(convert, tree)


def load_inference_variables(ckpt_dir, model) -> Dict[str, Any]:
    """Inference variables ``{"params", "state"}`` from a JAX-written
    checkpoint, shaped and typed like ``model.variables()``.

    Accepts both checkpoint flavours: a bare variables tree
    (``params/...``, ``state/...``) and a TrainState (``params/...``,
    ``model_state/...``); optimizer state, step and RNG are not read. Each
    array loaded must match its ``manifest.json`` SHA-256."""
    d = Path(ckpt_dir)
    manifest = json.loads((d / _MANIFEST).read_text())["arrays"]
    template = flatten_with_names(model.variables())
    out = []
    with np.load(d / "state.npz") as z:
        for name, tmpl in template:
            candidates = [name]
            if name.startswith("state/"):
                candidates.append("model_state/" + name[len("state/"):])
            hit = next((c for c in candidates if c in z.files), None)
            if hit is None:
                raise KeyError(f"checkpoint missing leaf '{name}' "
                               f"(tried {candidates})")
            arr = z[hit]
            want = manifest.get(hit, {}).get("sha256")
            if want is None:
                raise ValueError(f"checkpoint manifest has no digest for "
                                 f"'{hit}'")
            if _array_sha256(arr) != want:
                raise ValueError(f"checkpoint array '{hit}' does not match "
                                 "its manifest SHA-256")
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"{hit}: shape {arr.shape} != "
                                 f"{tuple(tmpl.shape)}")
            out.append((name, torch.from_numpy(arr).to(
                dtype=tmpl.dtype, device=tmpl.device)))
    variables = unflatten(out)
    variables.setdefault("state", {})
    return variables
