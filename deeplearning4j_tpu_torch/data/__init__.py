"""Data layer (↔ deeplearning4j_tpu.data): minibatch containers, the
array, prefetch and sharded iterators, and the MNIST loader."""

from deeplearning4j_tpu_torch.data.dataset import DataSet, as_batch_dict
from deeplearning4j_tpu_torch.data.iterators import (
    ArrayDataSetIterator,
    AsyncDataSetIterator,
    ShardedDataSetIterator,
    ShrinkPolicy,
    derive_shard,
)
from deeplearning4j_tpu_torch.data.mnist import load_mnist

__all__ = ["ArrayDataSetIterator", "AsyncDataSetIterator", "DataSet",
           "ShardedDataSetIterator", "ShrinkPolicy", "as_batch_dict",
           "derive_shard", "load_mnist"]
