"""Graph autodiff layer (↔ deeplearning4j_tpu/autodiff).

- samediff: define-by-run graph building on one device, replay, grad,
  training, save/load in the JAX package's zip format.
- validation: finite-difference gradient checking in float64 + op
  coverage ledger (↔ OpValidation/GradCheckUtil).
"""

from deeplearning4j_tpu_torch.autodiff.samediff import (
    OP_REGISTRY,
    OpNode,
    SameDiff,
    SDVariable,
    TrainingConfig,
    VariableType,
    enable_x64,
    register_op,
)
from deeplearning4j_tpu_torch.autodiff.validation import (
    check_gradients,
    check_samediff_gradients,
    coverage_report,
    register_validated,
)

__all__ = [
    "SameDiff",
    "SDVariable",
    "VariableType",
    "TrainingConfig",
    "OpNode",
    "OP_REGISTRY",
    "register_op",
    "enable_x64",
    "check_gradients",
    "check_samediff_gradients",
    "coverage_report",
    "register_validated",
]
