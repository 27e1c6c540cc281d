"""Model serving (↔ deeplearning4j_tpu.serving): the predict and generate paths.

``ModelServer`` (HTTP) → ``ModelRegistry``/``ModelEntry`` →
``parallel.ParallelInference`` (one worker per card, batched buckets),
and ``:generate`` → ``GenerationEngine`` (continuous batching over KV
slabs), with ``warmup`` and the typed ``errors`` shared with
``ServingClient``.
"""

from deeplearning4j_tpu_torch.serving.client import ServingClient
from deeplearning4j_tpu_torch.serving.errors import (
    BadRequestError,
    ConnectionFailedError,
    DeadlineExceededError,
    DeadlineExpiredError,
    ModelNotFoundError,
    NotReadyError,
    QueueFullError,
    ServingError,
    SlotPreemptedError,
)
from deeplearning4j_tpu_torch.serving.generation import (
    GenerationEngine,
    GenerationStream,
)
from deeplearning4j_tpu_torch.serving.registry import ModelEntry, ModelRegistry
from deeplearning4j_tpu_torch.serving.server import ModelServer
from deeplearning4j_tpu_torch.serving.warmup import (
    Spec,
    bucket_sizes,
    spec,
    warmup_inference,
    zeros_batch,
)

__all__ = [
    "BadRequestError", "ConnectionFailedError", "DeadlineExceededError",
    "DeadlineExpiredError", "GenerationEngine", "GenerationStream",
    "ModelEntry", "ModelNotFoundError", "ModelRegistry", "ModelServer",
    "NotReadyError", "QueueFullError", "ServingClient", "ServingError",
    "SlotPreemptedError", "Spec", "bucket_sizes", "spec",
    "warmup_inference", "zeros_batch",
]
