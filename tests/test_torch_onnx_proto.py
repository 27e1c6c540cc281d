"""The port's ONNX wire codec against the JAX package's.

For the same messages (each TensorProto dtype and value field, each
attribute type with a graph-valued one, value infos with symbolic dims,
nodes with empty input names, a model with a Loop body and opset imports)
the two codecs write the same bytes, and each decodes the other's bytes
to the same fields. bfloat16 tensors decode to the JAX codec's values as
float32 (numpy has no bfloat16). ``chip_smoke.py``'s writers' models
round-trip byte for byte.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.modelimport import onnx_proto as jax_proto
from deeplearning4j_tpu_torch.modelimport import onnx_proto as port_proto

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _tensors(p):
    r = np.random.default_rng(0)  # the same values for both codecs
    return {
        "float32_raw": p.TensorProto.from_numpy(
            r.standard_normal((2, 3)).astype(np.float32), name="f"),
        "int64_raw": p.TensorProto.from_numpy(
            np.asarray([-(2 ** 40), -1, 0, 7], np.int64), name="i"),
        "bool_uint8_int8_int16_float16": [
            p.TensorProto.from_numpy(np.asarray(a), name=f"t{k}")
            for k, a in enumerate((
                [True, False], np.asarray([0, 255], np.uint8),
                np.asarray([-128, 5], np.int8),
                np.asarray([-300, 300], np.int16),
                np.asarray([0.5, -2.0], np.float16)))],
        "float_data": p.TensorProto(dims=[3], data_type=1,
                                    float_data=[1.5, -2.25, 3e-8]),
        "double_data": p.TensorProto(dims=[2], data_type=11,
                                     double_data=[1e-300, -7.0]),
        "int32_data_fp16_bits": p.TensorProto(
            dims=[3], data_type=10, int32_data=[15360, 49152, 14336]),
        "int64_data_negative": p.TensorProto(dims=[2], data_type=7,
                                             int64_data=[-5, 2 ** 62]),
        "bfloat16_raw": p.TensorProto(
            dims=[3], data_type=16,
            raw_data=np.asarray([0x3F80, 0xC040, 0x3E00], "<u2").tobytes()),
        "bfloat16_int32_data": p.TensorProto(dims=[2], data_type=16,
                                             int32_data=[0x3F80, 0xBF00]),
        "empty": p.TensorProto(dims=[0], data_type=1, name="e"),
    }


def _graph(p):
    vi = lambda n, e, s: p.ValueInfoProto(  # noqa: E731
        name=n, type=p.TypeProto(elem_type=e, shape=p.TensorShapeProto(s)))
    body = p.GraphProto(
        node=[p.NodeProto(input=["cond_in"], output=["cond_out"],
                          op_type="Identity")],
        name="body", input=[vi("i", 7, []), vi("cond_in", 9, [])],
        output=[vi("cond_out", 9, [])])
    attrs = [
        p.AttributeProto(name="f", type=p.ATTR_FLOAT, f=0.1),
        p.AttributeProto(name="i", type=p.ATTR_INT, i=-3),
        p.AttributeProto(name="s", type=p.ATTR_STRING, s=b"SAME_UPPER"),
        p.AttributeProto(name="t", type=p.ATTR_TENSOR,
                         t=p.TensorProto.from_numpy(np.asarray(
                             [1, 2], np.int64))),
        p.AttributeProto(name="g", type=p.ATTR_GRAPH, g=body),
        p.AttributeProto(name="fs", type=p.ATTR_FLOATS, floats=[1.0, -0.5]),
        p.AttributeProto(name="is", type=p.ATTR_INTS, ints=[0, -1, 2 ** 40]),
        p.AttributeProto(name="ss", type=p.ATTR_STRINGS,
                         strings=[b"Sigmoid", b"Tanh"]),
    ]
    node = p.NodeProto(input=["x", "", "w"], output=["y", ""], name="n",
                       op_type="Custom", attribute=attrs, domain="ai.onnx")
    return p.GraphProto(
        node=[node], name="g",
        initializer=[p.TensorProto.from_numpy(np.ones((2, 2), np.float32),
                                              name="w")],
        input=[vi("x", 1, ["batch", 3, 0]), vi("w", 1, [2, 2])],
        output=[vi("y", 1, [None, 3])],
        value_info=[vi("mid", 10, [4])])


def _model(p):
    return p.ModelProto(ir_version=8, producer_name="tests",
                        graph=_graph(p),
                        opset_import=[p.OperatorSetIdProto("", 17),
                                      p.OperatorSetIdProto("ai.onnx.ml", 3)])


def _encode(msg):
    return b"".join(m.encode() for m in msg) if isinstance(msg, list) \
        else msg.encode()


CASES = {**{f"tensor_{k}": (lambda p, k=k: _tensors(p)[k])
            for k in _tensors(port_proto)},
         "graph": _graph, "model": _model}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_bytes_and_cross_decode(name):
    port_msg, jax_msg = CASES[name](port_proto), CASES[name](jax_proto)
    blob = _encode(port_msg)
    assert blob == _encode(jax_msg)
    if isinstance(port_msg, list):
        return
    kind = type(port_msg).__name__
    from_jax = getattr(port_proto, kind).decode(_encode(jax_msg))
    from_port = getattr(jax_proto, kind).decode(blob)
    assert from_jax.encode() == blob and from_port.encode() == blob
    if kind == "TensorProto":
        want = jax_msg.to_numpy()
        got = from_jax.to_numpy()
        if jax_msg.data_type == 16:  # bfloat16: float32 values here
            assert got.dtype == np.float32
            want = want.astype(np.float32)
        else:
            assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_chip_smoke_writers_round_trip():
    """The card phases' models: decode → encode gives the same bytes, and
    the JAX codec reads the same graph."""
    params = chip_smoke.word_lm_params(40, 16, 16, 2, seed=1)
    blob = chip_smoke.word_lm_onnx(params, seq_len=4, batch=2)
    for _, graph_blob, *_ in chip_smoke.onnx_ops_graphs():
        for b in (blob, graph_blob):
            assert port_proto.ModelProto.decode(b).encode() == b
            assert jax_proto.ModelProto.decode(b).encode() == b
