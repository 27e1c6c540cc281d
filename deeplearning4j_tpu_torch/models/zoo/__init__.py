"""Model zoo (↔ deeplearning4j_tpu.models.zoo): the entries ported so far.

Not ported yet (ROADMAP queue 1 item 10): alexnet, vgg16/19, simplecnn,
darknet19, squeezenet, unet, xception, the YOLO models,
inception_resnet_v1 and nasnet.
"""

from __future__ import annotations

from typing import Callable, Dict

from deeplearning4j_tpu_torch.models.lenet import lenet, lenet_config
from deeplearning4j_tpu_torch.models.zoo.classic import (
    text_generation_lstm,
    text_generation_lstm_config,
)
from deeplearning4j_tpu_torch.models.zoo.resnet import (
    resnet50,
    resnet101,
    resnet152,
    resnet_config,
)

ZOO: Dict[str, Callable] = {
    "lenet": lenet,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "text_generation_lstm": text_generation_lstm,
}


def get_model(name: str, **kw):
    """↔ ZooModel lookup by name."""
    try:
        fn = ZOO[name.lower()]
    except KeyError:
        raise KeyError(f"unknown zoo model '{name}'; have {sorted(ZOO)}"
                       ) from None
    return fn(**kw)


__all__ = ["ZOO", "get_model", "lenet_config", "resnet_config",
           "text_generation_lstm_config", *ZOO]
