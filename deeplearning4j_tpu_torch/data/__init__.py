"""Data layer (↔ deeplearning4j_tpu.data): minibatch containers, the
array and prefetch iterators, and the MNIST loader."""

from deeplearning4j_tpu_torch.data.dataset import DataSet, as_batch_dict
from deeplearning4j_tpu_torch.data.iterators import (
    ArrayDataSetIterator,
    AsyncDataSetIterator,
)
from deeplearning4j_tpu_torch.data.mnist import load_mnist

__all__ = ["ArrayDataSetIterator", "AsyncDataSetIterator", "DataSet",
           "as_batch_dict", "load_mnist"]
