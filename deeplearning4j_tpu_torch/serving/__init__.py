"""Model serving (↔ deeplearning4j_tpu.serving): the predict and generate paths.

``ModelServer`` (HTTP) → ``ModelRegistry``/``ModelEntry`` →
``parallel.ParallelInference`` (one worker per card, batched buckets),
and ``:generate`` → ``GenerationEngine`` (continuous batching over KV
slabs, prefix-KV reuse through ``prefixkv``), with ``warmup``,
``warmstart`` (traffic-derived warmup manifests), ``metrics`` (the
serving bundle behind ``GET /metrics``) and the typed ``errors`` shared
with ``ServingClient``.

Environment (read as the JAX package reads them):

- ``DL4J_TPU_PREFIX_CACHE`` (1/true/yes/on): a ``GenerationEngine`` given
  ``prefix_cache=None`` builds a ``PrefixKVStore``;
- ``DL4J_TPU_PREFIX_CACHE_MAX_BYTES``: that store's byte bound (default
  256 MiB);
- ``DL4J_TPU_WARMUP_MANIFEST``: the manifest path of a ``ModelServer``
  given ``warmup_manifest=None``.
"""

from deeplearning4j_tpu_torch.serving.cache import CacheMetrics
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
from deeplearning4j_tpu_torch.serving.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    ServingMetrics,
)
from deeplearning4j_tpu_torch.serving.prefixkv import (
    PrefixKVStore,
    resolve_prefix_store,
)
from deeplearning4j_tpu_torch.serving.registry import ModelEntry, ModelRegistry
from deeplearning4j_tpu_torch.serving.server import ModelServer
from deeplearning4j_tpu_torch.serving.warmstart import (
    WarmupManifest,
    WarmupProgress,
    resolve_warmup_manifest,
)
from deeplearning4j_tpu_torch.serving.warmup import (
    Spec,
    bucket_sizes,
    spec,
    warmup_inference,
    zeros_batch,
)

__all__ = [
    "BadRequestError", "CacheMetrics", "ConnectionFailedError", "Counter",
    "DeadlineExceededError", "DeadlineExpiredError", "Gauge",
    "GenerationEngine", "GenerationStream", "Histogram", "MetricsRegistry",
    "ModelEntry", "ModelNotFoundError", "ModelRegistry", "ModelServer",
    "NotReadyError", "PrefixKVStore", "QueueFullError", "ServingClient",
    "ServingError", "ServingMetrics", "SlotPreemptedError", "Spec",
    "WarmupManifest", "WarmupProgress", "bucket_sizes",
    "resolve_prefix_store", "resolve_warmup_manifest", "spec",
    "warmup_inference", "zeros_batch",
]
