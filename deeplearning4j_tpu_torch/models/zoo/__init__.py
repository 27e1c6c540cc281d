"""Model zoo (↔ deeplearning4j_tpu.models.zoo): every entry of the JAX
package's registry, architecture builders only (weights come from
checkpoints through ``serde/``)."""

from __future__ import annotations

from typing import Callable, Dict

from deeplearning4j_tpu_torch.models.lenet import lenet, lenet_config
from deeplearning4j_tpu_torch.models.zoo.classic import (
    alexnet,
    alexnet_config,
    darknet19,
    darknet19_config,
    simplecnn,
    simplecnn_config,
    text_generation_lstm,
    text_generation_lstm_config,
    vgg16,
    vgg16_config,
    vgg19,
    vgg19_config,
)
from deeplearning4j_tpu_torch.models.zoo.graphs import (
    squeezenet,
    squeezenet_config,
    unet,
    unet_config,
    xception,
    xception_config,
)
from deeplearning4j_tpu_torch.models.zoo.resnet import (
    resnet50,
    resnet101,
    resnet152,
    resnet_config,
)
from deeplearning4j_tpu_torch.models.zoo.advanced import (
    inception_resnet_v1,
    inception_resnet_v1_config,
    nasnet,
    nasnet_config,
)
from deeplearning4j_tpu_torch.models.zoo.yolo import (
    Yolo2OutputLayer,
    decode_predictions,
    make_yolo_labels,
    non_max_suppression,
    tiny_yolo,
    tiny_yolo_config,
    yolo2,
    yolo2_config,
)

ZOO: Dict[str, Callable] = {
    "lenet": lenet,
    "alexnet": alexnet,
    "vgg16": vgg16,
    "vgg19": vgg19,
    "simplecnn": simplecnn,
    "darknet19": darknet19,
    "squeezenet": squeezenet,
    "unet": unet,
    "xception": xception,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "text_generation_lstm": text_generation_lstm,
    "tiny_yolo": tiny_yolo,
    "yolo2": yolo2,
    "inception_resnet_v1": inception_resnet_v1,
    "nasnet": nasnet,
}


def get_model(name: str, **kw):
    """↔ ZooModel lookup by name."""
    try:
        fn = ZOO[name.lower()]
    except KeyError:
        raise KeyError(f"unknown zoo model '{name}'; have {sorted(ZOO)}"
                       ) from None
    return fn(**kw)


__all__ = ["ZOO", "get_model"] + sorted(
    n for n in dir() if n.endswith("_config") or n in ZOO)
