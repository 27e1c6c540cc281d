"""Evaluation (↔ deeplearning4j_tpu.evaluation): classification so far.

Not ported yet (ROADMAP queue 1 item 10): ``EvaluationBinary``, ROC,
regression and calibration evaluation, and the evaluative listeners.
"""

from deeplearning4j_tpu_torch.evaluation.classification import (
    Evaluation,
    evaluate_model,
)

__all__ = ["Evaluation", "evaluate_model"]
