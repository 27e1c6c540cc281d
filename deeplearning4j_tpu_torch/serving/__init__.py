"""Model serving (↔ deeplearning4j_tpu.serving): the predict path.

``ModelServer`` (HTTP) → ``ModelRegistry``/``ModelEntry`` →
``parallel.ParallelInference`` (one worker per card, batched buckets),
with ``warmup`` and the typed ``errors`` shared with ``ServingClient``.
"""

from deeplearning4j_tpu_torch.serving.client import ServingClient
from deeplearning4j_tpu_torch.serving.errors import (
    BadRequestError,
    DeadlineExceededError,
    DeadlineExpiredError,
    ModelNotFoundError,
    NotReadyError,
    QueueFullError,
    ServingError,
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
    "BadRequestError", "DeadlineExceededError", "DeadlineExpiredError",
    "ModelEntry", "ModelNotFoundError", "ModelRegistry", "ModelServer",
    "NotReadyError", "QueueFullError", "ServingClient", "ServingError",
    "Spec", "bucket_sizes", "spec", "warmup_inference", "zeros_batch",
]
