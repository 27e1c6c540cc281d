"""Model import layer (↔ deeplearning4j_tpu/modelimport).

- tf: frozen TF GraphDef → autodiff SameDiff program (the BERT path),
  straight-line graphs; read with the port's own wire codec (tf_proto),
  no TensorFlow or protobuf needed.

Keras h5, ONNX, SavedModel and TF control flow wait for the next slices
(ROADMAP queue 1 item 11).
"""

from deeplearning4j_tpu_torch.modelimport.tf import (
    TFImportError,
    import_tf_graph,
)

__all__ = [
    "import_tf_graph",
    "TFImportError",
]
