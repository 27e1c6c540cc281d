"""Gradient checking + op-validation coverage ledger (↔
deeplearning4j_tpu/autodiff/validation.py).

ref: org.nd4j.autodiff.validation.{OpValidation, GradCheckUtil}: central
finite differences in float64 against analytic gradients, with a ledger of
the ops that have gradient-check coverage.

The JAX package runs its checks in float64 on the CPU backend (a TPU has
no float64) under ``jax_enable_x64``. The card has float64 natively, so
here a check runs in float64 on the device the values live on (the
SameDiff's, or ``device=``), under ``samediff.enable_x64`` so the graph
keeps 64 bits; the analytic side is ``torch.autograd`` over the same
replay that ``output`` and ``fit`` run.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import enable_x64
from deeplearning4j_tpu_torch.runtime.device import resolve_device

# -- coverage ledger (↔ OpValidationSuite coverage tracking) ----------------

_VALIDATED_OPS: set = set()


def register_validated(op_name: str) -> None:
    _VALIDATED_OPS.add(op_name)


def validated_ops() -> set:
    return set(_VALIDATED_OPS)


def coverage_report() -> Dict[str, Any]:
    from deeplearning4j_tpu_torch.autodiff.samediff import OP_REGISTRY

    all_ops = set(OP_REGISTRY)
    done = _VALIDATED_OPS & all_ops
    return {
        "total_ops": len(all_ops),
        "validated": len(done),
        "fraction": len(done) / max(len(all_ops), 1),
        "missing": sorted(all_ops - done),
    }


def _float64(v, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                        else v.detach(), device=device)
    return t.to(torch.float64) if t.is_floating_point() else t


def check_gradients(
    fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    params: Dict[str, Any],
    *,
    eps: float = 1e-5,
    max_rel_error: float = 1e-4,
    min_abs_error: float = 1e-8,
    samples_per_param: Optional[int] = 64,
    seed: int = 0,
    op_name: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """Central-difference check of ``fn``'s gradient (↔
    GradCheckUtil.checkGradients).

    fn: params dict of float64 tensors -> scalar loss tensor.
    samples_per_param: indices sampled per parameter tensor (None = all);
    the same indices as the JAX package's check for the same seed.
    device: where the check runs; default the device of the first tensor
    in ``params``, else the card (``resolve_device``: it raises when there
    is none, so the CPU must be asked for).

    Returns a report dict; raises AssertionError on failure.
    """
    if device is None:
        device = next((v.device for v in params.values()
                       if isinstance(v, torch.Tensor)), None)
    device = resolve_device(device)
    with enable_x64():
        params64 = {k: _float64(v, device) for k, v in params.items()}
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params64.items()}
            names = list(leaves)
            grads = torch.autograd.grad(fn(leaves), [leaves[n] for n in names],
                                        allow_unused=True)
        analytic = {n: (g if g is not None else torch.zeros_like(leaves[n]))
                    .detach().cpu().numpy().reshape(-1)
                    for n, g in zip(names, grads)}

        def eval_loss():
            with torch.no_grad():
                return float(fn(params64))

        rng = np.random.RandomState(seed)
        worst = {"rel_error": 0.0, "param": None, "index": None}
        checked = 0
        for name, value in params64.items():
            flat = value.view(-1)
            n = flat.numel()
            idxs = (np.arange(n) if samples_per_param is None or n <= samples_per_param
                    else rng.choice(n, samples_per_param, replace=False))
            for i in idxs:
                i = int(i)
                orig = float(flat[i])
                flat[i] = orig + eps
                plus = eval_loss()
                flat[i] = orig - eps
                minus = eval_loss()
                flat[i] = orig
                numeric = (plus - minus) / (2 * eps)
                a = float(analytic[name][i])
                denom = max(abs(numeric), abs(a))
                err = 0.0 if denom == 0 else abs(numeric - a) / denom
                if abs(numeric - a) < min_abs_error:
                    err = 0.0
                checked += 1
                if err > worst["rel_error"]:
                    worst = {"rel_error": err, "param": name, "index": i,
                             "numeric": float(numeric), "analytic": a}

    report = {"checked": checked, "worst": worst, "passed": worst["rel_error"] <= max_rel_error}
    if not report["passed"]:
        raise AssertionError(
            f"gradient check failed: worst rel err {worst['rel_error']:.3e} at "
            f"{worst['param']}[{worst['index']}] "
            f"(numeric {worst.get('numeric')}, analytic {worst.get('analytic')})")
    if op_name:
        register_validated(op_name)
    return report


def check_samediff_gradients(sd, feeds: Dict[str, Any], loss: str,
                             wrt: Optional[Sequence[str]] = None, **kw) -> Dict[str, Any]:
    """Gradient-check a SameDiff graph's loss w.r.t. its VARIABLEs, in
    float64 on the graph's device: its floating variables, constants and
    feeds are all taken to float64 (the JAX package's check leaves a
    float32 constant or feed at float32)."""
    variables, constants, _ = sd._split_feeds({})
    wrt = list(wrt) if wrt is not None else sorted(variables)
    ph_names = tuple(sorted(feeds))
    fn = sd._build_fn((loss,), ph_names)
    dev = sd.device
    with enable_x64():
        var64 = {k: _float64(v, dev) for k, v in variables.items()}
        const64 = {k: _float64(v, dev) for k, v in constants.items()}
        feeds64 = {k: _float64(v, dev) for k, v in feeds.items()}

    def loss_of(p):
        merged = dict(var64)
        merged.update(p)
        return fn(merged, const64, feeds64)[loss]

    kw.setdefault("device", dev)
    return check_gradients(loss_of, {n: var64[n] for n in wrt}, **kw)
