"""Parallel execution (↔ deeplearning4j_tpu.parallel). Inference so far."""

from deeplearning4j_tpu_torch.parallel.inference import (
    InferenceDeadlineExpired,
    InferenceQueueFull,
    InferenceShutdown,
    ParallelInference,
)

__all__ = ["InferenceDeadlineExpired", "InferenceQueueFull",
           "InferenceShutdown", "ParallelInference"]
