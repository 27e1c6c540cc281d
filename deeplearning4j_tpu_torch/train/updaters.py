"""Gradient updaters (↔ deeplearning4j_tpu/train/updaters.py).

The eleven updaters of the JAX package — Sgd, Nesterovs, Adam, AdamW,
AMSGrad, Nadam, AdaMax, AdaGrad, AdaDelta, RmsProp, NoOp — as config
dataclasses with the same ``@class`` names and fields (configs round-trip
as JSON), whose ``make()`` returns a pure ``(init, update)`` pair over
trees of tensors:

    state = init(params)
    updates, state = update(grads, state, params, step)
    params = apply_updates(params, updates)     # params + updates

``update`` returns the delta to add, sign included. The state mirrors the
params tree under the JAX package's names (``{"m": params-tree, "v": ...}``,
so a checkpoint leaf is ``opt_state/m/embeddings/word`` in both packages).
Nothing is updated in place: every step builds new tensors, as the JAX
package's pure functions do. Scalars (rates, bias corrections) are
computed in numpy float32, as the JAX package computes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.config import register_config
from deeplearning4j_tpu_torch.train.schedules import resolve_schedule
from deeplearning4j_tpu_torch.utils.pytree import tree_map as map_

_f32 = np.float32


def apply_updates(params, updates):
    return map_(lambda p, u: p + u.to(p.dtype), params, updates)


def _zeros(params):
    return map_(torch.zeros_like, params)


def _t(step) -> np.float32:
    return _f32(step) + _f32(1.0)


def _bias_correction(beta, t) -> float:
    return float(_f32(1.0) - np.power(_f32(beta), t))


@register_config
@dataclass
class Sgd:
    """↔ org.nd4j.linalg.learning.config.Sgd."""

    lr: Any = 0.01

    def make(self):
        sched = resolve_schedule(self.lr)

        def init(params):
            return ()

        def update(grads, state, params, step):
            lr = sched(step)
            return map_(lambda g: -lr * g, grads), state

        return init, update


@register_config
@dataclass
class Nesterovs:
    """↔ Nesterovs: v' = m·v − lr·g; update = −m·v + (1+m)·v'."""

    lr: Any = 0.1
    momentum: float = 0.9

    def make(self):
        sched = resolve_schedule(self.lr)
        m = self.momentum

        def init(params):
            return {"v": _zeros(params)}

        def update(grads, state, params, step):
            lr = sched(step)
            v_new = map_(lambda v, g: m * v - lr * g, state["v"], grads)
            upd = map_(lambda v, vn: -m * v + (1.0 + m) * vn, state["v"],
                       v_new)
            return upd, {"v": v_new}

        return init, update


@register_config
@dataclass
class Adam:
    """↔ Adam (bias-corrected first/second moments)."""

    lr: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    def make(self):
        sched = resolve_schedule(self.lr)
        b1, b2, eps = self.beta1, self.beta2, self.eps

        def init(params):
            return {"m": _zeros(params), "v": _zeros(params)}

        def update(grads, state, params, step):
            t = _t(step)
            lr = sched(step)
            m = map_(lambda mm, g: b1 * mm + (1 - b1) * g, state["m"], grads)
            v = map_(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g),
                     state["v"], grads)
            bc1 = _bias_correction(b1, t)
            bc2 = _bias_correction(b2, t)
            upd = map_(lambda mm, vv: -lr * (mm / bc1)
                       / (torch.sqrt(vv / bc2) + eps), m, v)
            return upd, {"m": m, "v": v}

        return init, update


@register_config
@dataclass
class AdamW(Adam):
    """Adam with decoupled weight decay."""

    weight_decay: float = 0.01

    def make(self):
        base_init, base_update = Adam.make(self)
        sched = resolve_schedule(self.lr)
        wd = self.weight_decay

        def update(grads, state, params, step):
            upd, state2 = base_update(grads, state, params, step)
            lr = sched(step)
            decay = float(_f32(lr) * _f32(wd))
            return map_(lambda u, p: u - decay * p, upd, params), state2

        return base_init, update


@register_config
@dataclass
class AMSGrad:
    """↔ AMSGrad (Adam with max-of-v second moment)."""

    lr: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    def make(self):
        sched = resolve_schedule(self.lr)
        b1, b2, eps = self.beta1, self.beta2, self.eps

        def init(params):
            return {"m": _zeros(params), "v": _zeros(params),
                    "vhat": _zeros(params)}

        def update(grads, state, params, step):
            t = _t(step)
            lr = sched(step)
            m = map_(lambda mm, g: b1 * mm + (1 - b1) * g, state["m"], grads)
            v = map_(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g),
                     state["v"], grads)
            vhat = map_(torch.maximum, state["vhat"], v)
            bc1 = _bias_correction(b1, t)
            upd = map_(lambda mm, vh: -lr * (mm / bc1)
                       / (torch.sqrt(vh) + eps), m, vhat)
            return upd, {"m": m, "v": v, "vhat": vhat}

        return init, update


@register_config
@dataclass
class Nadam:
    """↔ Nadam (Adam + Nesterov momentum)."""

    lr: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    def make(self):
        sched = resolve_schedule(self.lr)
        b1, b2, eps = self.beta1, self.beta2, self.eps

        def init(params):
            return {"m": _zeros(params), "v": _zeros(params)}

        def update(grads, state, params, step):
            t = _t(step)
            lr = sched(step)
            m = map_(lambda mm, g: b1 * mm + (1 - b1) * g, state["m"], grads)
            v = map_(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g),
                     state["v"], grads)
            bc1 = _bias_correction(b1, t)
            bc2 = _bias_correction(b2, t)
            upd = map_(lambda mm, vv, g: -lr
                       * (b1 * mm / bc1 + (1 - b1) * g / bc1)
                       / (torch.sqrt(vv / bc2) + eps), m, v, grads)
            return upd, {"m": m, "v": v}

        return init, update


@register_config
@dataclass
class AdaMax:
    """↔ AdaMax (infinity-norm Adam)."""

    lr: Any = 2e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8

    def make(self):
        sched = resolve_schedule(self.lr)
        b1, b2, eps = self.beta1, self.beta2, self.eps

        def init(params):
            return {"m": _zeros(params), "u": _zeros(params)}

        def update(grads, state, params, step):
            t = _t(step)
            lr = sched(step)
            m = map_(lambda mm, g: b1 * mm + (1 - b1) * g, state["m"], grads)
            u = map_(lambda uu, g: torch.maximum(b2 * uu, torch.abs(g)),
                     state["u"], grads)
            bc1 = _bias_correction(b1, t)
            upd = map_(lambda mm, uu: -lr * (mm / bc1) / (uu + eps), m, u)
            return upd, {"m": m, "u": u}

        return init, update


@register_config
@dataclass
class AdaGrad:
    """↔ AdaGrad."""

    lr: Any = 0.01
    eps: float = 1e-6

    def make(self):
        sched = resolve_schedule(self.lr)
        eps = self.eps

        def init(params):
            return {"h": _zeros(params)}

        def update(grads, state, params, step):
            lr = sched(step)
            h = map_(lambda hh, g: hh + torch.square(g), state["h"], grads)
            upd = map_(lambda hh, g: -lr * g / (torch.sqrt(hh) + eps), h,
                       grads)
            return upd, {"h": h}

        return init, update


@register_config
@dataclass
class AdaDelta:
    """↔ AdaDelta (rho-averaged squared grads and updates; no lr)."""

    rho: float = 0.95
    eps: float = 1e-6

    def make(self):
        rho, eps = self.rho, self.eps

        def init(params):
            return {"eg": _zeros(params), "ex": _zeros(params)}

        def update(grads, state, params, step):
            eg = map_(lambda e, g: rho * e + (1 - rho) * torch.square(g),
                      state["eg"], grads)
            upd = map_(lambda g, e, x: -(torch.sqrt(x + eps)
                                         / torch.sqrt(e + eps)) * g,
                       grads, eg, state["ex"])
            ex = map_(lambda x, u: rho * x + (1 - rho) * torch.square(u),
                      state["ex"], upd)
            return upd, {"eg": eg, "ex": ex}

        return init, update


@register_config
@dataclass
class RmsProp:
    """↔ RmsProp."""

    lr: Any = 1e-3
    decay: float = 0.95
    eps: float = 1e-8

    def make(self):
        sched = resolve_schedule(self.lr)
        d, eps = self.decay, self.eps

        def init(params):
            return {"g2": _zeros(params)}

        def update(grads, state, params, step):
            lr = sched(step)
            g2 = map_(lambda e, g: d * e + (1 - d) * torch.square(g),
                      state["g2"], grads)
            upd = map_(lambda e, g: -lr * g / (torch.sqrt(e) + eps), g2,
                       grads)
            return upd, {"g2": g2}

        return init, update


@register_config
@dataclass
class NoOp:
    """↔ NoOp updater (frozen training / evaluation-only)."""

    def make(self):
        def init(params):
            return ()

        def update(grads, state, params, step):
            return map_(torch.zeros_like, grads), state

        return init, update


_BY_NAME = {
    "sgd": Sgd, "nesterovs": Nesterovs, "adam": Adam, "adamw": AdamW,
    "amsgrad": AMSGrad, "nadam": Nadam, "adamax": AdaMax, "adagrad": AdaGrad,
    "adadelta": AdaDelta, "rmsprop": RmsProp, "noop": NoOp,
}


def resolve_updater(cfg, **kwargs):
    """None → Sgd(0.01); updater configs pass through; a string name builds
    from the registry (``learning_rate``/``lr`` kwargs accepted)."""
    if cfg is None:
        return Sgd(0.01)
    if isinstance(cfg, str):
        cls = _BY_NAME[cfg.lower()]
        if "learning_rate" in kwargs:
            kwargs["lr"] = kwargs.pop("learning_rate")
        return cls(**kwargs)
    return cfg
