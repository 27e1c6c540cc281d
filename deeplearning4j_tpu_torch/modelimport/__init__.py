"""Model import layer (↔ deeplearning4j_tpu/modelimport).

- tf: frozen TF GraphDef → autodiff SameDiff program (the BERT path), TF
  control flow included (TF1 frames, functional While/If, TensorList
  loops); read with the port's own wire codec (tf_proto), no TensorFlow or
  protobuf needed. ``import_tf_saved_model`` and ``freeze_tf_function``
  import TensorFlow inside the call.

Keras h5 and ONNX import wait for the next slices (ROADMAP queue 1 item
11).
"""

from deeplearning4j_tpu_torch.modelimport.tf import (
    TFImportError,
    freeze_tf_function,
    import_tf_graph,
    import_tf_saved_model,
)

__all__ = [
    "import_tf_graph",
    "import_tf_saved_model",
    "freeze_tf_function",
    "TFImportError",
]
