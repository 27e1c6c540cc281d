"""Model import layer (↔ deeplearning4j_tpu/modelimport).

- tf: frozen TF GraphDef → autodiff SameDiff program (the BERT path), TF
  control flow included (TF1 frames, functional While/If, TensorList
  loops); read with the port's own wire codec (tf_proto), no TensorFlow or
  protobuf needed. ``import_tf_saved_model`` and ``freeze_tf_function``
  import TensorFlow inside the call.
- onnx: ONNX ModelProto → SameDiff program (the JAX package's mappers,
  If/Loop/Scan on SameDiff's control flow, LSTM and GRU nodes through the
  hand sweeps); read and written with the port's own wire codec
  (onnx_proto: ``struct`` and ``numpy`` only).

Keras h5 import waits for a later slice (ROADMAP queue 1 item 11.4): it
first needs the port's own reader of the HDF5 subset Keras writes.
"""

from deeplearning4j_tpu_torch.modelimport.onnx import (
    ONNXImportError,
    import_onnx_model,
)
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
    "import_onnx_model",
    "ONNXImportError",
]
