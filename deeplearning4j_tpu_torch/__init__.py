"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

A second package beside the JAX one, with the same module paths and names
(``models/bert.py`` ↔ ``models/bert.py``), written in PyTorch for NVIDIA
Hopper (sm_90a). Every Pallas TPU kernel of the JAX package becomes a
kernel written by hand for the card (``kernels/csrc/``); each keeps a plain
PyTorch version beside it, which is what a tensor on the CPU runs.

Entry points run on the card (``runtime.device.default_device()``) unless
the caller names another device. The package imports ``torch`` and never
``jax`` nor anything of ``deeplearning4j_tpu``.

Ported so far: the BERT serving path — ``models/bert.py`` behind
``serving.ModelServer`` → ``serving.ModelRegistry`` →
``parallel.ParallelInference``, through the flash-attention forward kernel
— and BERT training — ``train.trainer.Trainer.fit`` with the JAX
package's updaters, schedules, listeners and checkpoint format, through
the flash-attention backward kernels; the GravesLSTM char-RNN and a
char-level GRU, trained and served through the LSTM and GRU scan kernels;
the gradient codecs with the bitmap encoder; and LeNet-5 and ResNet-50
(``SequentialModel`` and ``GraphModel`` of conv, pooling and BatchNorm
layers), trained through ``Trainer.fit`` over the MNIST and prefetch
iterators, scored by ``evaluation.evaluate_model`` and served, their
convolutions in cuDNN.
"""

__version__ = "0.4.0"

__all__ = ["__version__"]
