"""Checkpoint save/restore (↔ deeplearning4j_tpu/serde/checkpoint.py).

The JAX package's on-disk layout, written and read with numpy alone: a
directory per checkpoint holding

- ``state.npz``     — every leaf under its path name
  (``params/layer_3/attention/Wq``, ``opt_state/m/...``, ``step``,
  ``rng``), written to a tmp sibling and then ``os.replace``-d;
- ``manifest.json`` — a SHA-256 per array plus the whole-file digest and
  size of ``state.npz``;
- ``meta.json``     — step, tag, version, leaf list and the key leaves;
- ``config.json``   — the model config (``save_checkpoint`` with a model);

and beside them the rotation index ``checkpoint_index.json``. A
TrainState's ``rng`` is written as its key data (threefry2x32 or rbg) with
the ``key_paths``/``key_impls`` entries the JAX package writes, so a
checkpoint restores in both directions. Every array the port loads is
checked against its manifest digest.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import __version__
from deeplearning4j_tpu_torch.nn.config import config_to_json
from deeplearning4j_tpu_torch.utils.pytree import (
    flatten_with_names,
    tree_map,
    tree_map_with_names,
)

_INDEX = "checkpoint_index.json"
_MANIFEST = "manifest.json"


def _array_sha256(a: np.ndarray) -> str:
    """Content digest of one array (dtype + shape + raw bytes), as the
    JAX package's manifest computes it."""
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(tuple(a.shape)).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _file_sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _atomic_write_text(path: Path, text: str):
    """tmp sibling + ``os.replace``: readers never see a partial file."""
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def _is_key(leaf) -> bool:
    return hasattr(leaf, "key_data") and hasattr(leaf, "from_key_data")


def _snapshot_tree(tree: Any):
    """Device→host snapshot: (arrays by name, key paths, key impls).
    Tensors become numpy arrays, an int (``TrainState.step``) an int32
    scalar as the JAX package stores its step, a key its key data."""
    arrays: Dict[str, np.ndarray] = {}
    key_paths, key_impls = [], {}
    for name, leaf in flatten_with_names(tree):
        if _is_key(leaf):
            arrays[name] = leaf.key_data()
            key_paths.append(name)
            key_impls[name] = leaf.impl
        elif torch.is_tensor(leaf):
            arrays[name] = leaf.detach().cpu().numpy()
        elif isinstance(leaf, int):
            arrays[name] = np.asarray(leaf, np.int32)
        else:
            arrays[name] = np.asarray(leaf)
    return arrays, key_paths, key_impls


def save_state_tree(directory, tree: Any, extra_meta: Optional[dict] = None):
    """Save any tree (TrainState, variables dict, …) to ``directory``, in
    the JAX package's crash-consistent order: ``state.npz`` to a tmp
    sibling then ``os.replace``; then ``manifest.json``; then
    ``meta.json``. A caller indexes the directory only after this
    returns."""
    arrays, key_paths, key_impls = _snapshot_tree(tree)
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    npz, tmp = d / "state.npz", d / "state.npz.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        file_digest = _file_sha256(tmp)
        file_size = tmp.stat().st_size
        os.replace(tmp, npz)
    finally:
        tmp.unlink(missing_ok=True)
    manifest = {
        "state_npz": {"sha256": file_digest, "size": file_size},
        "arrays": {
            name: {"sha256": _array_sha256(a), "dtype": str(a.dtype),
                   "shape": list(a.shape)}
            for name, a in arrays.items()
        },
    }
    _atomic_write_text(d / _MANIFEST, json.dumps(manifest, indent=2))
    meta = {"version": __version__, "time": time.time(),
            "leaves": sorted(arrays), "key_paths": key_paths,
            "key_impls": key_impls}
    if extra_meta:
        meta.update(extra_meta)
    _atomic_write_text(d / "meta.json", json.dumps(meta, indent=2))


def load_state_tree(directory, template: Any, alias=None) -> Any:
    """Restore a tree saved by either package's ``save_state_tree`` into
    ``template``'s structure. Each leaf takes the template leaf's kind:
    a tensor its dtype and device, an int an int, a key (``RngKey``) the
    key data. ``alias``: optional ``name -> [candidate names]``; the first
    candidate present is loaded. Every array loaded must match its
    ``manifest.json`` SHA-256."""
    d = Path(directory)
    meta = json.loads((d / "meta.json").read_text())
    key_paths = set(meta.get("key_paths", []))
    key_impls = meta.get("key_impls", {})
    digests = json.loads((d / _MANIFEST).read_text())["arrays"]
    with np.load(d / "state.npz") as z:
        data = {k: z[k] for k in z.files}

    def restore(name, tmpl):
        candidates = [name] if alias is None else list(alias(name))
        hit = next((c for c in candidates if c in data), None)
        if hit is None:
            tried = f" (tried {candidates})" if len(candidates) > 1 else ""
            raise KeyError(f"checkpoint missing leaf '{name}'{tried}")
        arr = data[hit]
        if _array_sha256(arr) != digests.get(hit, {}).get("sha256"):
            raise ValueError(f"checkpoint array '{hit}' does not match its "
                             "manifest SHA-256")
        if _is_key(tmpl):
            if hit not in key_paths:
                raise ValueError(f"checkpoint leaf '{hit}' is not a key")
            return type(tmpl).from_key_data(arr, key_impls.get(hit))
        if isinstance(tmpl, int):
            return int(arr)
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{hit}: shape {arr.shape} != "
                             f"{tuple(tmpl.shape)}")
        return torch.from_numpy(np.array(arr)).to(dtype=tmpl.dtype,
                                                  device=tmpl.device)

    return tree_map_with_names(restore, template)


_index_lock = threading.Lock()


def _finalize_checkpoint(root: Path, name: str, step: int, tag: str,
                         keep_last: int, config_json: Optional[str]):
    """config.json + rotation-index update for a written checkpoint dir
    (the JAX package's index format; one writer per directory)."""
    ckpt_dir = root / name
    if config_json is not None:
        _atomic_write_text(ckpt_dir / "config.json", config_json)
    with _index_lock:
        idx_path = root / _INDEX
        index = (json.loads(idx_path.read_text()) if idx_path.exists()
                 else {"checkpoints": []})
        # a re-save of the same name replaces its entry
        index["checkpoints"] = [c for c in index["checkpoints"]
                                if c.get("name") != name]
        index["checkpoints"].append({"name": name, "step": step, "tag": tag,
                                     "time": time.time()})
        if keep_last and len(index["checkpoints"]) > keep_last:
            for old in index["checkpoints"][:-keep_last]:
                shutil.rmtree(root / old["name"], ignore_errors=True)
            index["checkpoints"] = index["checkpoints"][-keep_last:]
        _atomic_write_text(idx_path, json.dumps(index, indent=2))
    return str(ckpt_dir)


def save_checkpoint(directory, train_state, *, model=None, tag: str = "",
                    keep_last: int = 0, extra_meta: Optional[dict] = None):
    """Full training checkpoint: state + model config + rotation index
    → the checkpoint's directory, ``<directory>/checkpoint_<step>[_tag]``."""
    root = Path(directory)
    root.mkdir(parents=True, exist_ok=True)
    step = int(train_state.step)
    name = f"checkpoint_{step}" + (f"_{tag}" if tag else "")
    meta = {"step": step, "tag": tag}
    if extra_meta:
        meta.update(extra_meta)
    save_state_tree(root / name, train_state, meta)
    return _finalize_checkpoint(
        root, name, step, tag, keep_last,
        config_to_json(model.config) if model is not None else None)


def latest_checkpoint(directory) -> Optional[str]:
    """Newest indexed checkpoint whose directory still exists."""
    root = Path(directory)
    idx_path = root / _INDEX
    if not idx_path.exists():
        return None
    for entry in reversed(json.loads(idx_path.read_text()).get(
            "checkpoints", [])):
        d = root / str(entry.get("name", ""))
        if d.is_dir():
            return str(d)
    return None


def restore_checkpoint(ckpt_dir, train_state_template):
    """The TrainState saved in ``ckpt_dir`` (by either package), shaped,
    typed and placed like ``train_state_template``."""
    return load_state_tree(ckpt_dir, train_state_template)


def variables_from_numpy(tree: Any, device=None) -> Any:
    """A JAX ``{"params": ...}`` tree of numpy arrays → the same tree of
    torch tensors on ``device`` (``None`` keeps the CPU)."""
    def convert(a):
        t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
        return t if device is None else t.to(device)

    return tree_map(convert, tree)


def load_inference_variables(ckpt_dir, model) -> Dict[str, Any]:
    """Inference variables ``{"params", "state"}`` from a checkpoint of
    either package, shaped, typed and placed like the model's own: a
    module's ``variables()`` (``Bert``), else a template from ``init()``
    (``SequentialModel``, whose variables live outside it).

    Accepts both checkpoint flavours: a bare variables tree
    (``params/...``, ``state/...``) and a TrainState (``params/...``,
    ``model_state/...``); optimizer state, step and RNG are not read."""
    def alias(name):
        if name.startswith("state/"):
            return [name, "model_state/" + name[len("state/"):]]
        return [name]

    template = (model.variables() if isinstance(model, torch.nn.Module)
                else model.init())
    return load_state_tree(ckpt_dir, template, alias=alias)
