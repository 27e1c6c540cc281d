"""Training (↔ deeplearning4j_tpu.train): the Trainer, updaters,
listeners, schedules and transfer learning. The JAX package's early
stopping and layer-wise pretraining are not ported (ROADMAP queue 1
item 10)."""

from deeplearning4j_tpu_torch.train import listeners, schedules, updaters  # noqa: F401
from deeplearning4j_tpu_torch.train.trainer import Trainer, TrainState
from deeplearning4j_tpu_torch.train.transfer import (
    FineTuneConfiguration,
    GraphTransferLearning,
    TransferLearning,
    TransferLearningHelper,
)
from deeplearning4j_tpu_torch.train.updaters import (
    AMSGrad,
    AdaDelta,
    AdaGrad,
    AdaMax,
    Adam,
    AdamW,
    Nadam,
    Nesterovs,
    NoOp,
    RmsProp,
    Sgd,
)

__all__ = [
    "GraphTransferLearning",
    "listeners", "schedules", "updaters", "TrainState", "Trainer",
    "Sgd", "Adam", "AdamW", "AMSGrad", "Nadam", "AdaMax", "AdaGrad",
    "AdaDelta", "RmsProp", "Nesterovs", "NoOp",
    "TransferLearning", "TransferLearningHelper", "FineTuneConfiguration",
]
