"""Build-time name validation in the port against the JAX package's, on the CPU.

Mirrors ``tests/test_layers.py::test_typod_names_fail_at_build_nested_and_recurrent``:
a typo'd activation (top level, in ``recurrent_activation``, inside a
``Bidirectional``) or loss name fails when ``SequentialModel`` or
``GraphModel`` is built, not at the first forward, with the layer's
name in front. Each config is the JAX package's, carried across as JSON;
an activation typo's message is the JAX package's word for word (the
registries hold the same names), a loss typo's up to the list of
available names.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.activations import ACTIVATIONS
from deeplearning4j_tpu.nn.config import GraphConfig as JaxGraphConfig
from deeplearning4j_tpu.nn.config import GraphVertex as JaxVertex
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JaxNet
from deeplearning4j_tpu.nn.config import SequentialConfig as JaxSeqConfig
from deeplearning4j_tpu.nn.model import GraphModel as JaxGraphModel
from deeplearning4j_tpu.nn.model import SequentialModel as JaxModel
from deeplearning4j_tpu_torch.nn import layers  # noqa: F401 (registers them)
from deeplearning4j_tpu_torch.nn.config import GraphConfig, SequentialConfig
from deeplearning4j_tpu_torch.nn.model import GraphModel, SequentialModel


def _head():
    return JL.OutputLayer(units=2, activation="softmax", loss="mcxent")


# (case id, input shape, layers, the message's start)
CASES = [
    ("dense_activation", (4,),
     [JL.Dense(units=3, activation="tanhh"), _head()],
     "unknown activation 'tanhh'"),
    ("bidirectional_lstm", (5, 4),
     [JL.Bidirectional(layer=JL.LSTM(units=4, activation="relUU")),
      JL.LastTimeStep(), _head()],
     "unknown activation 'relUU'"),
    ("convlstm_recurrent_activation", (4, 6, 6, 2),
     [JL.ConvLSTM2D(filters=3, kernel=(3, 3),
                    recurrent_activation="sigmoidd"), JL.Flatten(), _head()],
     "unknown activation 'sigmoidd'"),
    ("bidirectional_convlstm", (4, 6, 6, 2),
     [JL.Bidirectional(layer=JL.ConvLSTM2D(filters=3, activation="Tanh2")),
      JL.Flatten(), _head()],
     "unknown activation 'Tanh2'"),
    ("output_loss", (4,),
     [JL.Dense(units=3), JL.OutputLayer(units=2, loss="msee")],
     "unknown loss 'msee'"),
]


def _seq(shape, layers):
    return JaxSeqConfig(net=JaxNet(), input_shape=shape, layers=layers)


def _graph(shape, layers):
    names = [f"v{i}" for i in range(len(layers))]
    vertices = {n: JaxVertex(kind="layer", layer=l,
                             inputs=[names[i - 1] if i else "in"])
                for i, (n, l) in enumerate(zip(names, layers))}
    return JaxGraphConfig(net=JaxNet(), inputs=["in"],
                          input_shapes={"in": shape}, vertices=vertices,
                          outputs=[names[-1]])


KINDS = {"sequential": (_seq, JaxModel, SequentialConfig, SequentialModel),
         "graph": (_graph, JaxGraphModel, GraphConfig, GraphModel)}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_typod_names_fail_at_build_as_in_jax(kind, case):
    _, shape, layers, start = case
    make, jax_model, port_config, port_model = KINDS[kind]
    cfg = make(shape, layers)
    with pytest.raises(ValueError) as want:
        jax_model(cfg)
    with pytest.raises(ValueError) as got:
        port_model(port_config.from_json(cfg.to_json()), device="cpu")
    got, want = str(got.value), str(want.value)
    assert got.startswith("layer '") and start in got
    assert got.split("; available")[0] == want.split("; available")[0]
    if "activation" in start:
        assert got == want


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_registry_name_builds_in_any_case(kind):
    """Each of the 26 activation names (as written, and upper-cased) on
    a Dense, and ConvLSTM2D's two names, build in both packages."""
    make, jax_model, port_config, port_model = KINDS[kind]
    layers = [JL.Dense(units=3, activation=n) for n in sorted(ACTIVATIONS)]
    layers += [JL.Dense(units=3, activation=n.upper())
               for n in sorted(ACTIVATIONS)]
    layers.append(_head())
    cfg = make((4,), layers)
    jax_model(cfg)
    model = port_model(port_config.from_json(cfg.to_json()), device="cpu")
    assert len(model.named_layers()) == 2 * len(ACTIVATIONS) + 1
    conv = make((3, 6, 6, 1), [
        JL.ConvLSTM2D(filters=2, padding="SAME", activation="hardtanh",
                      recurrent_activation="hardsigmoid"),
        JL.Flatten(), _head()])
    jax_model(conv)
    port_model(port_config.from_json(conv.to_json()), device="cpu")


def test_a_typo_fails_before_any_weight_is_drawn():
    """The check runs in the constructor: nothing is initialised or run."""
    cfg = _seq((4,), [JL.Dense(units=3, activation="sigmoidd"), _head()])
    with pytest.raises(ValueError, match=r"^layer '0_dense': unknown "
                                         r"activation 'sigmoidd'"):
        SequentialModel(SequentialConfig.from_json(cfg.to_json()),
                        device="cpu")
    ok = SequentialModel(SequentialConfig.from_json(_seq(
        (4,), [JL.Dense(units=3, activation="sigmoid"), _head()]).to_json()),
        device="cpu")
    out = ok.output(ok.init(), np.zeros((2, 4), np.float32))
    assert tuple(out.shape) == (2, 2)
