"""Learning-rate schedules (↔ deeplearning4j_tpu/train/schedules.py).

A schedule is a config dataclass (same ``@class`` names and fields as the
JAX package, so configs round-trip as JSON) called with the step, an int,
returning the rate as a Python float. The arithmetic runs in numpy
float32, the precision the JAX package's traced schedules compute in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict

import numpy as np

from deeplearning4j_tpu_torch.nn.config import register_config

_f32 = np.float32


@register_config
@dataclass
class FixedSchedule:
    value: float = 0.01

    def __call__(self, step: int) -> float:
        return float(_f32(self.value))


@register_config
@dataclass
class ExponentialSchedule:
    """lr = initial * gamma^step (ref: ExponentialSchedule)."""

    initial: float = 0.01
    gamma: float = 0.99

    def __call__(self, step: int) -> float:
        return float(_f32(self.initial) * np.power(_f32(self.gamma),
                                                   _f32(step)))


@register_config
@dataclass
class InverseSchedule:
    """lr = initial / (1 + gamma*step)^power (ref: InverseSchedule)."""

    initial: float = 0.01
    gamma: float = 0.001
    power: float = 1.0

    def __call__(self, step: int) -> float:
        base = _f32(1.0) + _f32(self.gamma) * _f32(step)
        return float(_f32(self.initial) / np.power(base, _f32(self.power)))


@register_config
@dataclass
class PolySchedule:
    """lr = initial * (1 - step/max_steps)^power (ref: PolySchedule)."""

    initial: float = 0.01
    power: float = 1.0
    max_steps: int = 10000

    def __call__(self, step: int) -> float:
        frac = np.clip(_f32(step) / _f32(self.max_steps), _f32(0), _f32(1))
        return float(_f32(self.initial) * np.power(_f32(1.0) - frac,
                                                   _f32(self.power)))


@register_config
@dataclass
class SigmoidSchedule:
    """lr = initial / (1 + exp(gamma*(step - step_center)))
    (ref: SigmoidSchedule)."""

    initial: float = 0.01
    gamma: float = 0.01
    step_center: int = 1000

    def __call__(self, step: int) -> float:
        z = _f32(self.gamma) * _f32(step - self.step_center)
        return float(_f32(self.initial) / (_f32(1.0) + np.exp(z)))


@register_config
@dataclass
class StepSchedule:
    """lr = initial * decay^floor(step/step_size) (ref: StepSchedule)."""

    initial: float = 0.01
    decay: float = 0.1
    step_size: int = 1000

    def __call__(self, step: int) -> float:
        n = np.floor(_f32(step) / _f32(self.step_size))
        return float(_f32(self.initial) * np.power(_f32(self.decay), n))


@register_config
@dataclass
class MapSchedule:
    """Piecewise-constant from {step: lr} breakpoints (ref: MapSchedule)."""

    values: Dict[int, float] = field(default_factory=dict)
    initial: float = 0.01

    def __call__(self, step: int) -> float:
        lr = _f32(self.initial)
        for s in sorted(self.values, key=int):
            if step >= int(s):
                lr = _f32(self.values[s])
        return float(lr)


@register_config
@dataclass
class WarmupCosineSchedule:
    """Linear warmup → cosine decay."""

    peak: float = 1e-3
    warmup_steps: int = 1000
    total_steps: int = 100000
    end_value: float = 0.0

    def __call__(self, step: int) -> float:
        stepf = _f32(step)
        if stepf < self.warmup_steps:
            return float(_f32(self.peak) * stepf
                         / _f32(max(self.warmup_steps, 1)))
        frac = np.clip((stepf - _f32(self.warmup_steps))
                       / _f32(max(self.total_steps - self.warmup_steps, 1)),
                       _f32(0), _f32(1))
        cos = _f32(self.end_value) + _f32(0.5) * _f32(
            self.peak - self.end_value) * (_f32(1) + np.cos(_f32(math.pi)
                                                           * frac))
        return float(cos)


def resolve_schedule(lr) -> Callable[[int], float]:
    """float → FixedSchedule; schedule objects pass through."""
    if callable(lr):
        return lr
    return FixedSchedule(float(lr))
