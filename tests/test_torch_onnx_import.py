"""The port's ONNX importer against the JAX package's, graph by graph.

Each case writes one ONNX model with the port's codec (``onnx_proto``,
byte-equal to the JAX package's: ``tests/test_torch_onnx_proto.py``) and
imports the same bytes into both packages, the port's on the CPU. Every
output is held to the JAX package's: the same dtype and shape, values to
RTOL/ATOL unless the case states its own (exact for integers, booleans
and selections). The cases cover every mapper family of
``tests/test_onnx_import.py``, ``test_onnx_import_ext.py`` and
``test_onnx_control_flow.py`` and the trouble spots of a torch port:
asymmetric and SAME_UPPER padding, ``count_include_pad``, ``gather``
outside the range, ties in ``TopK``/``ArgMax``, ``Mod`` on negative
operands, the half-pixel linear resize, ``DepthToSpace`` modes,
``CumSum`` flags and 64-bit values (int32 out, as the JAX package's
x64-off rule gives). Control flow: If, a static Loop (the port's static
route: no condition read), a data-dependent Loop, Scan in every
direction, with gradients through the static loop and through an LSTM
node. Every strict refusal of the JAX package is a refusal here too,
with the same message.
"""

import io
import zlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport.onnx import ONNXImportError as JaxError
from deeplearning4j_tpu.modelimport.onnx import import_onnx_model as jax_import
from deeplearning4j_tpu_torch.autodiff import VariableType
from deeplearning4j_tpu_torch.autodiff import samediff as sdm
from deeplearning4j_tpu_torch.modelimport import (
    ONNXImportError,
    import_onnx_model,
)
from deeplearning4j_tpu_torch.modelimport.onnx_proto import (
    ATTR_FLOAT,
    ATTR_FLOATS,
    ATTR_GRAPH,
    ATTR_INT,
    ATTR_INTS,
    ATTR_STRING,
    ATTR_STRINGS,
    ATTR_TENSOR,
    AttributeProto,
    GraphProto,
    ModelProto,
    NodeProto,
    OperatorSetIdProto,
    TensorProto,
    TensorShapeProto,
    TypeProto,
    ValueInfoProto,
)

RTOL, ATOL = 1e-5, 1e-6
R = np.random.default_rng(0)  # reseeded per case (_seeded)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# --- fixture builders (the port's codec) -------------------------------------


def vi(name, shape, elem_type=1):
    return ValueInfoProto(name=name, type=TypeProto(
        elem_type=elem_type, shape=TensorShapeProto(list(shape))))


def attr(name, v):
    if isinstance(v, GraphProto):
        return AttributeProto(name=name, type=ATTR_GRAPH, g=v)
    if isinstance(v, float):
        return AttributeProto(name=name, type=ATTR_FLOAT, f=v)
    if isinstance(v, (bool, int)):
        return AttributeProto(name=name, type=ATTR_INT, i=int(v))
    if isinstance(v, str):
        return AttributeProto(name=name, type=ATTR_STRING, s=v.encode())
    if isinstance(v, np.ndarray):
        return AttributeProto(name=name, type=ATTR_TENSOR,
                              t=TensorProto.from_numpy(v))
    if isinstance(v, (list, tuple)) and v and isinstance(v[0], float):
        return AttributeProto(name=name, type=ATTR_FLOATS, floats=list(v))
    if isinstance(v, (list, tuple)) and v and isinstance(v[0], str):
        return AttributeProto(name=name, type=ATTR_STRINGS,
                              strings=[s.encode() for s in v])
    return AttributeProto(name=name, type=ATTR_INTS, ints=[int(x) for x in v])


def node(op_type, inputs, outputs, name="", **attrs):
    return NodeProto(input=list(inputs), output=list(outputs), name=name,
                     op_type=op_type,
                     attribute=[attr(k, v) for k, v in attrs.items()
                                if v is not None])


def model(nodes, inputs, outputs, inits=(), opset=17):
    g = GraphProto(node=list(nodes), name="g",
                   initializer=[TensorProto.from_numpy(a, name=n)
                                for n, a in inits],
                   input=list(inputs), output=list(outputs))
    return ModelProto(ir_version=8, producer_name="port-tests", graph=g,
                      opset_import=[OperatorSetIdProto("", opset)])


def _seeded(name):
    """Each case draws its data from a seed of its own name, so a case's
    inputs do not depend on which cases ran before it."""
    global R
    R = np.random.default_rng(zlib.crc32(name.encode()))


def f32(*shape, lo=-1.0, hi=1.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def one(op, x, out_shape=None, inits=(), extra=(), elem=1, **attrs):
    """A single-node graph: input 'x' (plus initializer inputs) → 'y'."""
    ins = ["x"] + [n for n, _ in inits] + list(extra)
    return (model([node(op, ins, ["y"], **attrs)], [vi("x", x.shape, elem)],
                  [vi("y", out_shape or x.shape)], inits), {"x": x})


# --- the comparison -----------------------------------------------------------


def _compare(blob, feeds, outputs=None, rtol=RTOL, atol=ATOL):
    sd_j, in_j, out_j = jax_import(blob, outputs=outputs)
    sd_t, in_t, out_t = import_onnx_model(blob, outputs=outputs,
                                          device="cpu")
    assert in_t == in_j and list(out_t) == list(out_j)
    names = list(out_j)
    want = sd_j.output(feeds, [out_j[n] for n in names])
    got = sd_t.output(feeds, [out_t[n] for n in names])
    for n in names:
        w = np.asarray(want[out_j[n]])
        g = got[out_t[n]]
        assert g.device.type == "cpu"
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (n, g.dtype,
                                                           w.dtype, g.shape,
                                                           w.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=n)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=n)
    return sd_t, in_t, out_t


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# -- core mappers ---------------------------------------------------------------


@case
def mlp_gemm_softmax():
    x = f32(4, 6)
    w1, b1, w2 = f32(8, 6), f32(8), f32(8, 3)
    m = model([node("Gemm", ["x", "w1", "b1"], ["h"], transB=1),
               node("Relu", ["h"], ["r"]),
               node("Gemm", ["r", "w2"], ["z"]),
               node("Softmax", ["z"], ["y"], axis=1)],
              [vi("x", (4, 6))], [vi("y", (4, 3))],
              [("w1", w1), ("b1", b1), ("w2", w2)])
    return m, {"x": x}


@case
def gemm_alpha_beta_trans_a():
    a, b, c = f32(5, 4), f32(5, 3), f32(4, 3)
    return one("Gemm", a, (4, 3), [("b", b), ("c", c)], alpha=0.5, beta=2.0,
               transA=1)


def _conv(x, w, out, **attrs):
    return one("Conv", x, out, [("w", w), ("b", f32(w.shape[0]))], **attrs)


@case
def conv_symmetric_pads():
    return _conv(f32(2, 3, 8, 8), f32(4, 3, 3, 3), (2, 4, 8, 8),
                 kernel_shape=[3, 3], pads=[1, 1, 1, 1])


@case
def conv_asymmetric_pads_stride2():
    return _conv(f32(2, 3, 9, 8), f32(4, 3, 3, 3), (2, 4, 5, 5),
                 kernel_shape=[3, 3], pads=[0, 1, 2, 1], strides=[2, 2])


@case
def conv_same_upper_stride2():
    return _conv(f32(1, 3, 7, 7), f32(4, 3, 3, 3), (1, 4, 4, 4),
                 kernel_shape=[3, 3], strides=[2, 2], auto_pad="SAME_UPPER")


@case
def conv_dilated_grouped():
    return _conv(f32(2, 4, 9, 9), f32(6, 2, 3, 3), (2, 6, 5, 5),
                 dilations=[2, 2], group=2)


@case
def conv1d_and_no_kernel_shape():
    return _conv(f32(2, 3, 11), f32(4, 3, 3), (2, 4, 11), pads=[1, 1])


@case
def conv3d():
    return _conv(f32(1, 2, 5, 5, 5), f32(3, 2, 3, 3, 3), (1, 3, 3, 3, 3),
                 kernel_shape=[3, 3, 3])


@case
def maxpool_asymmetric_pads():
    # all-negative input: a zero pad would win the window, -inf does not
    return one("MaxPool", f32(2, 3, 8, 8, hi=-0.1), (2, 3, 4, 4),
               kernel_shape=[3, 3], strides=[2, 2], pads=[0, 0, 1, 1])


@case
def maxpool_same_upper_default_strides():
    return one("MaxPool", f32(1, 2, 7, 7, hi=-0.1), (1, 2, 4, 4),
               kernel_shape=[2, 2], auto_pad="SAME_UPPER")


@case
def avgpool_exclude_pad():
    return one("AveragePool", f32(2, 3, 7, 7), (2, 3, 4, 4),
               kernel_shape=[3, 3], strides=[2, 2], pads=[1, 0, 1, 1],
               count_include_pad=0)


@case
def avgpool_include_pad():
    return one("AveragePool", f32(2, 3, 7, 7), (2, 3, 4, 4),
               kernel_shape=[3, 3], strides=[2, 2], pads=[1, 0, 1, 1],
               count_include_pad=1)


@case
def avgpool_same_upper_1d():
    return one("AveragePool", f32(2, 3, 9), (2, 3, 5), kernel_shape=[2],
               strides=[2], auto_pad="SAME_UPPER")


@case
def gap_lrn_global_max():
    x = f32(2, 6, 5, 5)
    m = model([node("LRN", ["x"], ["l"], size=3, alpha=1e-3, beta=0.6,
                    bias=1.5),
               node("GlobalAveragePool", ["l"], ["y"]),
               node("GlobalMaxPool", ["x"], ["z"])],
              [vi("x", x.shape)], [vi("y", (2, 6, 1, 1)),
                                   vi("z", (2, 6, 1, 1))])
    return m, {"x": x}


@case
def batchnorm_relu_flatten():
    x = f32(2, 4, 3, 3)
    inits = [("s", f32(4, lo=0.5)), ("b", f32(4)), ("m", f32(4)),
             ("v", f32(4, lo=0.5, hi=2.0))]
    m = model([node("BatchNormalization", ["x", "s", "b", "m", "v"], ["n"],
                    epsilon=1e-3),
               node("Relu", ["n"], ["r"]),
               node("Flatten", ["r"], ["y"], axis=-2)],
              [vi("x", x.shape)], [vi("y", (8, 9))], inits)
    return m, {"x": x}


@case
def layernorm_instance_group_norm():
    x = f32(2, 6, 3, 4)
    m = model([node("LayerNormalization", ["x", "ls", "lb"], ["a"], axis=-2,
                    epsilon=1e-5),
               node("InstanceNormalization", ["a", "is", "ib"], ["b"]),
               node("GroupNormalization", ["b", "gs", "gb"], ["y"],
                    num_groups=3)],
              [vi("x", x.shape)], [vi("y", x.shape)],
              [("ls", f32(3, 4)), ("lb", f32(3, 4)), ("is", f32(6)),
               ("ib", f32(6)), ("gs", f32(3)), ("gb", f32(3))], opset=18)
    return m, {"x": x}


@case
def structural_ops():
    x = f32(2, 3, 4)
    i64 = lambda *v: np.asarray(v, np.int64)  # noqa: E731
    m = model([
        node("Reshape", ["x", "shp"], ["r"]),
        node("Transpose", ["r"], ["t"], perm=[1, 0]),
        node("Concat", ["t", "t"], ["c"], axis=0),
        node("Slice", ["c", "st", "en", "ax", "sp"], ["s"]),
        node("Unsqueeze", ["s", "uax"], ["u"]),
        node("Squeeze", ["u", "uax"], ["q"]),
        node("Pad", ["q", "pads", "pv"], ["p"]),
        node("Pad", ["q", "pads"], ["pr"], mode="reflect"),
        node("Pad", ["q", "pads"], ["pe"], mode="edge"),
        node("Expand", ["b3", "eshape"], ["e"]),
        node("Tile", ["q", "reps"], ["tl"]),
    ], [vi("x", x.shape)],
        [vi(n, ()) for n in ("p", "pr", "pe", "e", "tl")],
        [("shp", i64(0, -1)), ("st", i64(-1, 0)),
         ("en", i64(-(2 ** 63) + 1, 2 ** 62)), ("ax", i64(0, 1)),
         ("sp", i64(-2, 1)), ("uax", i64(0, -1)), ("pads", i64(1, 1, 1, 0)),
         ("pv", np.asarray(0.5, np.float32)), ("b3", f32(3, 1)),
         ("eshape", i64(2, 1, 4)), ("reps", i64(2, 1))], opset=13)
    return m, {"x": x}


@case
def gather_negative_and_out_of_range():
    x = f32(5, 4)
    m = model([node("Gather", ["x", "i0"], ["a"]),
               node("Gather", ["x", "i1"], ["b"], axis=1)],
              [vi("x", x.shape)], [vi("a", ()), vi("b", ())],
              [("i0", np.asarray([[0, -1], [4, 5]], np.int64)),
               ("i1", np.asarray([-4, 3, -5, 2], np.int64))])
    return m, {"x": x}


@case
def elementwise_unary():
    x = np.asarray([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, 0.3, -0.7]],
                   np.float32)
    ops = ["Neg", "Abs", "Exp", "Sigmoid", "Tanh", "Softplus", "Erf",
           "Floor", "Ceil", "Round", "Sin", "Cos", "Sign", "Relu"]
    nodes = [node(op, ["x"], [op.lower()]) for op in ops]
    nodes += [node("Abs", ["x"], ["ax"]), node("Log", ["ax"], ["log"]),
              node("Sqrt", ["ax"], ["sqrt"])]
    outs = [op.lower() for op in ops] + ["log", "sqrt"]
    return model(nodes, [vi("x", x.shape)], [vi(o, ()) for o in outs]), \
        {"x": x}


@case
def elementwise_binary_and_compare():
    a, b = f32(3, 4, lo=0.2, hi=2.0), f32(1, 4, lo=0.2, hi=2.0)
    ops = ["Add", "Sub", "Mul", "Div", "Pow", "Min", "Max", "Equal",
           "Greater", "GreaterOrEqual", "Less", "LessOrEqual"]
    nodes = [node(op, ["a", "b"], [op.lower()]) for op in ops]
    nodes.append(node("Where", ["greater", "a", "b"], ["where"]))
    outs = [op.lower() for op in ops] + ["where"]
    return model(nodes, [vi("a", a.shape), vi("b", b.shape)],
                 [vi(o, ()) for o in outs]), {"a": a, "b": b}


@case
def activations():
    x = f32(3, 5, lo=-3.0, hi=3.0)
    nodes = [node("LeakyRelu", ["x"], ["lr"], alpha=0.2),
             node("Elu", ["x"], ["elu"], alpha=0.7),
             node("HardSigmoid", ["x"], ["hs"], alpha=0.3, beta=0.4),
             node("PRelu", ["x", "slope"], ["prelu"]),
             node("Clip", ["x", "lo", "hi"], ["clip"]),
             node("Gelu", ["x"], ["gelu"]),
             node("Gelu", ["x"], ["gelu_tanh"], approximate="tanh"),
             node("Selu", ["x"], ["selu"]),
             node("Softsign", ["x"], ["softsign"]),
             node("Mish", ["x"], ["mish"]),
             node("HardSwish", ["x"], ["hard_swish"]),
             node("Celu", ["x"], ["celu"], alpha=1.3),
             node("Shrink", ["x"], ["shrink"], bias=0.2, lambd=0.6),
             node("ThresholdedRelu", ["x"], ["tr"], alpha=0.9)]
    outs = ["lr", "elu", "hs", "prelu", "clip", "gelu", "gelu_tanh", "selu",
            "softsign", "mish", "hard_swish", "celu", "shrink", "tr"]
    return model(nodes, [vi("x", x.shape)], [vi(o, ()) for o in outs],
                 [("slope", f32(5)), ("lo", np.asarray(-0.5, np.float32)),
                  ("hi", np.asarray(1.25, np.float32))], opset=20), {"x": x}


@case
def trig_family_and_reciprocal():
    x = f32(3, 4, lo=0.2, hi=0.8)
    big = f32(3, 4, lo=1.1, hi=3.0)
    ops = ["Tan", "Asin", "Acos", "Atan", "Sinh", "Cosh", "Asinh", "Atanh",
           "Reciprocal"]
    nodes = [node(op, ["x"], [op.lower()]) for op in ops]
    nodes.append(node("Acosh", ["big"], ["acosh"]))
    outs = [op.lower() for op in ops] + ["acosh"]
    return model(nodes, [vi("x", x.shape), vi("big", big.shape)],
                 [vi(o, ()) for o in outs]), {"x": x, "big": big}


@case
def logical_and_special_values():
    x = np.asarray([1.0, -np.inf, np.nan, np.inf, 0.0, -2.0], np.float32)
    a = np.asarray([True, False, True, False, True, False])
    b = np.asarray([True, True, False, False, False, True])
    nodes = [node("Not", ["a"], ["not"]), node("And", ["a", "b"], ["and"]),
             node("Or", ["a", "b"], ["or"]), node("Xor", ["a", "b"], ["xor"]),
             node("IsNaN", ["x"], ["isnan"]), node("IsInf", ["x"], ["isinf"]),
             node("IsInf", ["x"], ["isposinf"], detect_negative=0),
             node("IsInf", ["x"], ["isneginf"], detect_positive=0),
             node("Sign", ["x"], ["sign"])]
    outs = ["not", "and", "or", "xor", "isnan", "isinf", "isposinf",
            "isneginf", "sign"]
    return model(nodes, [vi("x", x.shape), vi("a", a.shape, 9),
                         vi("b", b.shape, 9)], [vi(o, ()) for o in outs]), \
        {"x": x, "a": a, "b": b}


@case
def mod_negative_operands():
    ai = np.asarray([-7, 7, -7, 7, -3, 0], np.int32)
    bi = np.asarray([3, -3, -3, 3, 5, 2], np.int32)
    af = np.asarray([-7.5, 7.5, -7.5, 7.5, -0.25], np.float32)
    bf = np.asarray([2.0, -2.0, -2.0, 2.0, 3.0], np.float32)
    nodes = [node("Mod", ["ai", "bi"], ["floor_mod"]),
             node("Mod", ["ai", "bi"], ["c_mod"], fmod=1),
             node("Mod", ["af", "bf"], ["f_fmod"], fmod=1),
             node("Mod", ["af", "bf"], ["f_mod"])]
    return model(nodes, [vi("ai", ai.shape, 6), vi("bi", bi.shape, 6),
                         vi("af", af.shape), vi("bf", bf.shape)],
                 [vi(o, ()) for o in ("floor_mod", "c_mod", "f_fmod",
                                      "f_mod")]), \
        {"ai": ai, "bi": bi, "af": af, "bf": bf}


@case
def argmax_topk_ties():
    x = np.asarray([[3, 1, 3, 2, 1, 3], [0, 5, 5, 1, 5, 0],
                    [2, 2, 2, 2, 2, 2]], np.float32)
    nodes = [node("ArgMax", ["x"], ["amax"], axis=1),
             node("ArgMin", ["x"], ["amin"], axis=1, keepdims=0),
             node("ArgMax", ["x"], ["amax0"], axis=0, keepdims=0),
             node("TopK", ["x", "k"], ["tv", "ti"]),
             node("TopK", ["x", "k"], ["bv", "bi"], largest=0),
             node("TopK", ["x", "k2"], ["cv", "ci"], axis=0)]
    outs = ["amax", "amin", "amax0", "tv", "ti", "bv", "bi", "cv", "ci"]
    return model(nodes, [vi("x", x.shape)], [vi(o, ()) for o in outs],
                 [("k", np.asarray([4], np.int64)),
                  ("k2", np.asarray([2], np.int64))]), {"x": x}


@case
def reductions():
    x = f32(3, 4, 5, lo=0.1, hi=2.0)
    axes = np.asarray([0, 2], np.int64)
    nodes = []
    for op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
               "ReduceProd", "ReduceL1", "ReduceL2", "ReduceLogSum",
               "ReduceLogSumExp", "ReduceSumSquare"):
        nodes.append(node(op, ["x", "axes"], [op + "_k"]))
        nodes.append(node(op, ["x"], [op + "_all"], keepdims=0))
    nodes.append(node("ReduceSum", ["x", "none"], ["noop"],
                      noop_with_empty_axes=1))
    nodes.append(node("ReduceMean", ["xi"], ["int_mean"], keepdims=0))
    outs = [n.output[0] for n in nodes]
    xi = R.integers(-5, 5, (3, 4)).astype(np.int32)
    return model(nodes, [vi("x", x.shape), vi("xi", xi.shape, 6)],
                 [vi(o, ()) for o in outs],
                 [("axes", axes), ("none", np.zeros((0,), np.int64))],
                 opset=18), {"x": x, "xi": xi}


@case
def cumsum_flags():
    x = f32(3, 5)
    nodes = [node("CumSum", ["x", "ax"], [f"c{e}{r}"], exclusive=e,
                  reverse=r) for e in (0, 1) for r in (0, 1)]
    return model(nodes, [vi("x", x.shape)],
                 [vi(n.output[0], ()) for n in nodes],
                 [("ax", np.asarray(1, np.int64))]), {"x": x}


@case
def einsum_trilu_gather_elements():
    a, b = f32(2, 3, 4), f32(2, 4, 5)
    x = f32(4, 4)
    idx = np.asarray([[0, -1, 2, 1], [3, 3, -4, 0]], np.int64)
    nodes = [node("Einsum", ["a", "b"], ["e"], equation="bij,bjk->bik"),
             node("Trilu", ["x", "k1"], ["up"]),
             node("Trilu", ["x", "km1"], ["low"], upper=0),
             node("GatherElements", ["x", "idx"], ["ge"], axis=0)]
    return model(nodes, [vi("a", a.shape), vi("b", b.shape),
                         vi("x", x.shape)],
                 [vi(o, ()) for o in ("e", "up", "low", "ge")],
                 [("k1", np.asarray(1, np.int64)),
                  ("km1", np.asarray(-1, np.int64)), ("idx", idx)]), \
        {"a": a, "b": b, "x": x}


@case
def onehot_range_constant_of_shape():
    ids = np.asarray([[0, 3, -1], [2, -4, 1]], np.int64)
    nodes = [node("OneHot", ["ids", "depth", "vals"], ["oh"], axis=1),
             node("Range", ["s", "l", "d"], ["rg"]),
             node("ConstantOfShape", ["shp"], ["cs"],
                  value=np.asarray([2.5], np.float32)),
             node("ConstantOfShape", ["shp"], ["cz"])]
    return model(nodes, [vi("ids", ids.shape, 7)],
                 [vi(o, ()) for o in ("oh", "rg", "cs", "cz")],
                 [("depth", np.asarray([4], np.int64)),
                  ("vals", np.asarray([-1.0, 2.0], np.float32)),
                  ("s", np.asarray(1, np.int64)),
                  ("l", np.asarray(9, np.int64)),
                  ("d", np.asarray(3, np.int64)),
                  ("shp", np.asarray([2, 3], np.int64))]), {"ids": ids}


@case
def depth_space():
    x = f32(2, 8, 3, 3)
    nodes = [node("DepthToSpace", ["x"], ["dcr"], blocksize=2),
             node("DepthToSpace", ["x"], ["crd"], blocksize=2, mode="CRD"),
             node("SpaceToDepth", ["dcr"], ["back"], blocksize=2)]
    return model(nodes, [vi("x", x.shape)],
                 [vi(o, ()) for o in ("dcr", "crd", "back")]), {"x": x}


@case
def conv_transpose_pads():
    x, w = f32(2, 3, 5, 5), f32(3, 4, 3, 3)
    nodes = [node("ConvTranspose", ["x", "w", "b"], ["y1"], strides=[2, 2],
                  pads=[1, 1, 1, 1]),
             node("ConvTranspose", ["x", "w"], ["y0"], strides=[2, 2]),
             node("ConvTranspose", ["x", "w"], ["ya"], strides=[1, 1],
                  pads=[0, 2, 1, 0])]
    return model(nodes, [vi("x", x.shape)],
                 [vi(o, ()) for o in ("y1", "y0", "ya")],
                 [("w", w), ("b", f32(4))]), {"x": x}


@case
def split_sizes_and_uneven():
    x = f32(7, 4)
    nodes = [node("Split", ["x", "sizes"], ["s0", "s1", "s2"]),
             node("Split", ["x"], ["u0", "u1", "u2"], num_outputs=3)]
    return model(nodes, [vi("x", x.shape)],
                 [vi(o, ()) for o in ("s0", "s1", "s2", "u0", "u1", "u2")],
                 [("sizes", np.asarray([2, 4, 1], np.int64))], opset=18), \
        {"x": x}


@case
def resize_nearest_and_linear():
    x = f32(1, 2, 5, 4)
    roi = np.asarray([], np.float32)
    nodes = [node("Resize", ["x", "roi", "s2"], ["near"], mode="nearest",
                  coordinate_transformation_mode="asymmetric",
                  nearest_mode="floor"),
             node("Resize", ["x", "roi", "s2"], ["up"], mode="linear"),
             node("Resize", ["x", "roi", "", "down"], ["dn"], mode="linear"),
             node("Resize", ["x", "roi", "frac"], ["fr"], mode="linear"),
             node("Upsample", ["x", "s2"], ["ups"])]
    return model(nodes, [vi("x", x.shape)],
                 [vi(o, ()) for o in ("near", "up", "dn", "fr", "ups")],
                 [("roi", roi),
                  ("s2", np.asarray([1, 1, 2, 2], np.float32)),
                  ("down", np.asarray([1, 2, 3, 3], np.int64)),
                  ("frac", np.asarray([1, 1, 1.5, 1.5], np.float32))],
                 opset=13), {"x": x}


@case
def int64_shape_chain():
    x = f32(2, 3, 4)
    nodes = [node("Shape", ["x"], ["shp"]),
             node("Gather", ["shp", "zero"], ["n"]),
             node("Concat", ["n", "minus1"], ["target"], axis=0),
             node("Reshape", ["x", "target"], ["flat"]),
             node("Cast", ["x"], ["xi"], to=7),
             node("Cast", ["x"], ["xb"], to=9),
             node("Cast", ["xi"], ["xd"], to=11),
             node("Identity", ["shp"], ["shp_out"]),
             node("Dropout", ["x"], ["drop"]),
             node("Constant", [], ["cf"], value_float=1.5),
             node("Constant", [], ["ci"], value_ints=[3, -4]),
             node("Constant", [], ["ct"],
                  value=np.asarray([[1, 2]], np.int64)),
             node("Add", ["ct", "ci"], ["cadd"])]
    outs = ["flat", "xi", "xb", "xd", "shp_out", "drop", "cf", "cadd"]
    return model(nodes, [vi("x", x.shape)], [vi(o, ()) for o in outs],
                 [("zero", np.asarray([0], np.int64)),
                  ("minus1", np.asarray([-1], np.int64))], opset=13), \
        {"x": 3.0 * x}


@case
def fp16_int32_data_and_matmul():
    bits = np.asarray([15360, 49152, 14336, 0], np.int32)  # 1, -2, .5, 0
    t = TensorProto(dims=[4], data_type=10, int32_data=list(bits), name="h")
    m = model([node("Cast", ["h"], ["hf"], to=1),
               node("MatMul", ["x", "w"], ["mm"]),
               node("Mul", ["mm", "hf"], ["y"])],
              [vi("x", (3, 5))], [vi("y", ()), vi("hf", ())],
              [("w", f32(5, 4))])
    m.graph.initializer.append(t)
    return m, {"x": f32(3, 5)}


@case
def bfloat16_initializer():
    bits = np.asarray([0x3F80, 0xC040, 0x3E00, 0x4110], "<u2")  # 1, -3, ...
    t = TensorProto(dims=[4], data_type=16, raw_data=bits.tobytes(),
                    name="h")
    m = model([node("Cast", ["h"], ["hf"], to=1),
               node("Mul", ["x", "hf"], ["y"])],
              [vi("x", (3, 4))], [vi("y", ())])
    m.graph.initializer.append(t)
    return m, {"x": f32(3, 4)}


# -- recurrent nodes: the hand sweeps' plain versions here --------------------


def _rnn(op, t, n, i, h, direction, with_b=True, with_state=True, gates=4):
    d = 2 if direction == "bidirectional" else 1
    x = f32(t, n, i)
    inits = [("w", 0.4 * f32(d, gates * h, i)),
             ("r", 0.4 * f32(d, gates * h, h))]
    ins = ["x", "w", "r"]
    if with_b:
        b = 0.2 * f32(d, 2 * gates * h)
        if op == "GRU":
            b[:, 5 * h:] = 0.0  # Rb_h zero (the JAX op's restriction)
        inits.append(("b", b))
        ins.append("b")
    else:
        ins.append("")
    feeds = {"x": x}
    graph_in = [vi("x", x.shape)]
    if with_state:
        ins += ["", "h0"]
        feeds["h0"] = f32(d, n, h)
        graph_in.append(vi("h0", (d, n, h)))
        if op == "LSTM":
            ins.append("c0")
            feeds["c0"] = f32(d, n, h)
            graph_in.append(vi("c0", (d, n, h)))
    outs = ["y", "yh"] + (["yc"] if op == "LSTM" else [])
    m = model([node(op, ins, outs, hidden_size=h, direction=direction)],
              graph_in, [vi(o, ()) for o in outs], inits)
    return m, feeds


@case
def lstm_forward_bias_and_state():
    return _rnn("LSTM", 5, 3, 4, 6, "forward")


@case
def lstm_reverse_no_state():
    return _rnn("LSTM", 5, 3, 4, 6, "reverse", with_state=False)


@case
def lstm_bidirectional_no_bias():
    return _rnn("LSTM", 4, 2, 3, 5, "bidirectional", with_b=False)


@case
def gru_forward_bias_and_state():
    return _rnn("GRU", 5, 3, 4, 6, "forward", gates=3)


@case
def gru_bidirectional():
    return _rnn("GRU", 4, 2, 3, 5, "bidirectional", gates=3,
                with_state=False)


# -- control flow ----------------------------------------------------------------


def _if_model(passthrough=False):
    then_g = GraphProto(node=[node("Mul", ["x", "two"], ["y"])], name="then",
                        initializer=[TensorProto.from_numpy(
                            np.asarray(2.0, np.float32), name="two")],
                        output=[vi("y", (2, 3))])
    if passthrough:
        else_g = GraphProto(name="else", output=[vi("x", (2, 3))])
    else:
        else_g = GraphProto(node=[node("Sub", ["x", "w"], ["y"])],
                            name="else", output=[vi("y", (2, 3))])
    return model([node("If", ["p"], ["out"], then_branch=then_g,
                       else_branch=else_g)],
                 [vi("p", (), 9), vi("x", (2, 3))], [vi("out", (2, 3))],
                 [("w", f32(2, 3))])


@case
def if_true_branch():
    return _if_model(), {"p": np.asarray(True), "x": f32(2, 3)}


@case
def if_false_branch_captures_initializer():
    return _if_model(), {"p": np.asarray(False), "x": f32(2, 3)}


@case
def if_passthrough_branch_output():
    return _if_model(True), {"p": np.asarray(False), "x": f32(2, 3)}


def _loop_model(with_scan=True, trip=5):
    body_nodes = [node("Identity", ["cond_in"], ["cond_out"]),
                  node("Add", ["v_in", "w"], ["v_out"])]
    body_out = [vi("cond_out", (), 9), vi("v_out", (2,))]
    if with_scan:
        body_nodes.append(node("Mul", ["v_out", "v_out"], ["scan"]))
        body_out.append(vi("scan", (2,)))
    body = GraphProto(node=body_nodes, name="body",
                      input=[vi("iter", (), 7), vi("cond_in", (), 9),
                             vi("v_in", (2,))], output=body_out)
    outs = ["v_final"] + (["scans"] if with_scan else [])
    return model([node("Loop", ["M", "", "v0"], outs, body=body)],
                 [vi("v0", (2,))], [vi(o, ()) for o in outs],
                 [("M", np.asarray(trip, np.int64)),
                  ("w", np.asarray([1.0, 10.0], np.float32))])


@case
def loop_static_with_scan_outputs():
    return _loop_model(True), {"v0": f32(2)}


@case
def loop_static_without_scan():
    return _loop_model(False), {"v0": f32(2)}


def _early_exit_model():
    body = GraphProto(
        node=[node("Mul", ["v_in", "two"], ["v_out"]),
              node("ReduceSum", ["v_out"], ["s"], keepdims=0),
              node("Less", ["s", "hundred"], ["cond_out"])],
        name="body", input=[vi("iter", (), 7), vi("cond_in", (), 9),
                            vi("v_in", (2,))],
        output=[vi("cond_out", (), 9), vi("v_out", (2,))])
    return model([node("Loop", ["M", "c0", "v0"], ["v_final"], body=body)],
                 [vi("v0", (2,))], [vi("v_final", (2,))],
                 [("M", np.asarray(100, np.int64)), ("c0", np.asarray(True)),
                  ("two", np.asarray(2.0, np.float32)),
                  ("hundred", np.asarray(100.0, np.float32))])


@case
def loop_data_dependent_exit():
    return _early_exit_model(), {"v0": np.asarray([1.0, 2.0], np.float32)}


@case
def loop_var_default_initializer_not_shadowed():
    body = GraphProto(
        node=[node("Identity", ["cond_in"], ["cond_out"]),
              node("Add", ["v_in", "v_in"], ["v_out"])],
        name="body", initializer=[TensorProto.from_numpy(
            np.zeros(2, np.float32), name="v_in")],
        input=[vi("iter", (), 7), vi("cond_in", (), 9), vi("v_in", (2,))],
        output=[vi("cond_out", (), 9), vi("v_out", (2,))])
    return model([node("Loop", ["M", "", "v0"], ["v_final"], body=body)],
                 [vi("v0", (2,))], [vi("v_final", (2,))],
                 [("M", np.asarray(3, np.int64))]), {"v0": f32(2)}


@case
def loop_with_nested_if_capture():
    # the If inside the body reads `w` from the outermost scope: a capture
    # through both levels
    then_g = GraphProto(node=[node("Add", ["v_in", "w"], ["y"])], name="t",
                        output=[vi("y", (2,))])
    else_g = GraphProto(node=[node("Sub", ["v_in", "w"], ["y"])], name="e",
                        output=[vi("y", (2,))])
    body = GraphProto(
        node=[node("Identity", ["cond_in"], ["cond_out"]),
              node("ReduceSum", ["v_in"], ["s"], keepdims=0),
              node("Greater", ["s", "zero"], ["p"]),
              node("If", ["p"], ["v_out"], then_branch=then_g,
                   else_branch=else_g)],
        name="body", input=[vi("iter", (), 7), vi("cond_in", (), 9),
                            vi("v_in", (2,))],
        output=[vi("cond_out", (), 9), vi("v_out", (2,))])
    return model([node("Loop", ["M", "", "v0"], ["v_final"], body=body)],
                 [vi("v0", (2,)), vi("w", (2,))], [vi("v_final", (2,))],
                 [("M", np.asarray(4, np.int64)),
                  ("zero", np.asarray(0.0, np.float32))]), \
        {"v0": np.asarray([0.5, -0.2], np.float32),
         "w": np.asarray([-0.4, 0.1], np.float32)}


def _scan_model(rev_in, rev_out):
    body = GraphProto(
        node=[node("Add", ["s_in", "x_elem"], ["s_out"]),
              node("Mul", ["s_out", "two"], ["y_elem"])],
        name="body", input=[vi("s_in", (3,)), vi("x_elem", (3,))],
        output=[vi("s_out", (3,)), vi("y_elem", (3,))])
    kw = {"body": body, "num_scan_inputs": 1}
    if rev_in:
        kw["scan_input_directions"] = [1]
    if rev_out:
        kw["scan_output_directions"] = [1]
    return model([node("Scan", ["s0", "xs"], ["s_final", "ys"], **kw)],
                 [vi("s0", (3,)), vi("xs", (4, 3))],
                 [vi("s_final", (3,)), vi("ys", (4, 3))],
                 [("two", np.asarray(2.0, np.float32))])


for _ri in (0, 1):
    for _ro in (0, 1):
        def _scan_case(ri=_ri, ro=_ro):
            return _scan_model(ri, ro), {"s0": f32(3), "xs": f32(4, 3)}
        CASES[f"scan_in{_ri}_out{_ro}"] = _scan_case


@pytest.mark.parametrize("name", sorted(CASES))
def test_import_matches_the_jax_package(name):
    _seeded(name)
    m, feeds = CASES[name]()
    _compare(m.encode(), feeds)


def test_loop_routes_static_and_data_dependent():
    """A Loop with a host-known trip count and a constant-true condition
    takes the static route (no condition read); one whose body computes
    its condition reads it once an iteration."""
    sd, ins, outs = import_onnx_model(_loop_model(True).encode(),
                                      device="cpu")
    sdm.reset_loop_stats()
    sd.output({"v0": f32(2)}, list(outs.values()))
    assert sdm.loop_stats()["static"] == {5: 1}
    assert sdm.loop_stats()["dynamic_loops"] == 0
    sd, ins, outs = import_onnx_model(_early_exit_model().encode(),
                                      device="cpu")
    sdm.reset_loop_stats()
    sd.output({"v0": np.asarray([1.0, 2.0], np.float32)},
              list(outs.values()))
    stats = sdm.loop_stats()
    assert stats["static"] == {} and stats["dynamic_loops"] == 1
    assert stats["dynamic_iterations"] == 6


def _promote(sd, name, value):
    """A placeholder made a VARIABLE holding ``value`` (gradients wrt an
    input)."""
    sd._vars[name].var_type = VariableType.VARIABLE
    sd._values[name] = value


def test_gradients_through_static_loop_and_lstm_node():
    """calculate_gradients through a static Loop with scan outputs (wrt its
    initial loop var) and through a bidirectional LSTM node (wrt the
    promoted weights: the sweeps' autograd function), the port's float32
    gradients against the JAX package's."""
    _seeded("gradients")
    loop = (_loop_model(True), {}, {"v0": f32(2)}, ())
    lstm_model, lstm_feeds = _rnn("LSTM", 5, 3, 4, 6, "bidirectional")
    lstm = (lstm_model, lstm_feeds, {}, ("w", "r", "b"))
    for m, feeds, inputs, weights in (loop, lstm):
        blob = m.encode()
        sd_j, _, out_j = jax_import(blob)
        sd_t, _, out_t = import_onnx_model(blob, device="cpu")
        for name, value in inputs.items():  # an input as a variable
            _promote(sd_t, name, torch.from_numpy(value))
            sd_j._vars[name].var_type = type(sd_j._vars[name].var_type)(
                "VARIABLE")
            sd_j._values[name] = value
        for name in weights:
            sd_t.convert_to_variable(name)
            sd_j.convert_to_variable(name)
        y_j = sd_j.get_variable(list(out_j.values())[-1])
        y_t = sd_t.get_variable(list(out_t.values())[-1])
        g_j = sd_j.calculate_gradients(feeds, (y_j * y_j).sum().name)
        g_t = sd_t.calculate_gradients(feeds, (y_t * y_t).sum().name)
        assert sorted(g_t) == sorted(g_j)
        for name in g_j:
            w = np.asarray(g_j[name])
            assert np.abs(w).max() > 0, name
            np.testing.assert_allclose(g_t[name].numpy(), w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)


# -- strict refusals ---------------------------------------------------------------


REFUSALS = {}


def refusal(fn):
    REFUSALS[fn.__name__] = fn
    return fn


X4 = np.zeros((2, 3, 4, 4), np.float32)


@refusal
def unmapped_op():
    return one("NonMaxSuppression", X4)[0]


@refusal
def unknown_domain():
    m = one("Relu", X4)[0]
    m.graph.node[0].domain = "com.microsoft"
    return m


@refusal
def maxpool_ceil_mode():
    return one("MaxPool", X4, kernel_shape=[2, 2], ceil_mode=1)[0]


@refusal
def maxpool_indices_output():
    m = one("MaxPool", X4, kernel_shape=[2, 2])[0]
    m.graph.node[0].output.append("idx")
    return m


@refusal
def avgpool_ceil_mode():
    return one("AveragePool", X4, kernel_shape=[2, 2], ceil_mode=1)[0]


@refusal
def batchnorm_training_mode():
    c = np.ones(3, np.float32)
    return one("BatchNormalization", X4,
               inits=[("s", c), ("b", c), ("m", c), ("v", c)],
               training_mode=1)[0]


@refusal
def argmax_select_last_index():
    return one("ArgMax", X4, select_last_index=1)[0]


def _ct(**kw):
    return one("ConvTranspose", X4, inits=[("w", np.zeros((3, 2, 3, 3),
                                                           np.float32))],
               **kw)[0]


@refusal
def conv_transpose_auto_pad():
    return _ct(auto_pad="SAME_UPPER")


@refusal
def conv_transpose_output_padding():
    return _ct(output_padding=[1, 1], strides=[2, 2])


@refusal
def conv_transpose_output_shape():
    return _ct(output_shape=[8, 8])


@refusal
def conv_transpose_group():
    return _ct(group=3)


@refusal
def conv_transpose_dilations():
    return _ct(dilations=[2, 2])


def _resize(**kw):
    return one("Resize", X4, inits=[
        ("roi", np.asarray([], np.float32)),
        ("scales", np.asarray(kw.pop("scales", [1, 1, 2, 2]), np.float32))],
        **kw)[0]


@refusal
def resize_nearest_half_pixel():
    return _resize(mode="nearest",
                   coordinate_transformation_mode="align_corners")


@refusal
def resize_nearest_non_integer():
    return _resize(mode="nearest", scales=[1, 1, 1.5, 1.5],
                   coordinate_transformation_mode="asymmetric")


@refusal
def resize_nearest_mode_ceil():
    return _resize(mode="nearest", nearest_mode="ceil",
                   coordinate_transformation_mode="asymmetric")


@refusal
def resize_linear_asymmetric():
    return _resize(mode="linear", coordinate_transformation_mode="asymmetric")


@refusal
def resize_cubic():
    return _resize(mode="cubic")


@refusal
def resize_without_scales_or_sizes():
    return one("Resize", X4, inits=[("roi", np.asarray([], np.float32))],
               mode="linear")[0]


def _lstm_refusal(op="LSTM", gates=4, extra=(), b=None, **kw):
    seq = np.zeros((4, 2, 3), np.float32)
    inits = [("w", np.zeros((1, gates * 6, 3), np.float32)),
             ("r", np.zeros((1, gates * 6, 6), np.float32))]
    if b is not None:
        inits.append(("b", b))
    return one(op, seq, inits=inits, extra=extra, hidden_size=6, **kw)[0]


@refusal
def lstm_layout_1():
    return _lstm_refusal(layout=1)


@refusal
def lstm_activations():
    return _lstm_refusal(activations=["Relu", "Tanh", "Tanh"])


@refusal
def lstm_clip():
    return _lstm_refusal(clip=3.0)


@refusal
def lstm_sequence_lens():
    m = _lstm_refusal()
    m.graph.node[0].input[:] = ["x", "w", "r", "", "lens"]
    return m


@refusal
def lstm_input_forget():
    return _lstm_refusal(input_forget=1)


@refusal
def lstm_peepholes():
    m = _lstm_refusal()
    m.graph.node[0].input[:] = ["x", "w", "r", "", "", "", "", "p"]
    return m


@refusal
def lstm_direction():
    return _lstm_refusal(direction="sideways")


@refusal
def gru_linear_before_reset():
    return _lstm_refusal("GRU", 3, linear_before_reset=1)


@refusal
def gru_nonzero_rb_h():
    return _lstm_refusal("GRU", 3, b=np.ones((1, 36), np.float32))


@refusal
def gru_bias_not_an_initializer():
    m = _lstm_refusal("GRU", 3)
    m.graph.node[0].input[:] = ["x", "w", "r", "bias_in"]
    m.graph.input.append(vi("bias_in", (1, 36)))
    return m


@refusal
def dropout_mask_output():
    m = one("Dropout", X4)[0]
    m.graph.node[0].output.append("mask")
    return m


@refusal
def reshape_shape_not_host_known():
    m = one("Reshape", X4, extra=["shp"])[0]
    m.graph.input.append(vi("shp", (2,), 7))
    return m


@refusal
def unsqueeze_without_axes():
    return one("Unsqueeze", X4)[0]


@refusal
def split_too_many_outputs():
    m = one("Split", np.zeros((2, 3), np.float32), axis=1, num_outputs=4)[0]
    m.graph.node[0].output[:] = ["y0", "y1", "y2", "y3"]
    return m


@refusal
def shape_of_dynamic_input():
    m = one("Shape", X4)[0]
    m.graph.input[0] = vi("x", ("batch", 3, 4, 4))
    return m


@refusal
def graph_input_without_shape():
    m = one("Relu", X4)[0]
    m.graph.input[0] = ValueInfoProto(name="x")
    return m


@refusal
def if_branch_output_count_mismatch():
    then_g = GraphProto(node=[node("Add", ["x", "x"], ["y"])], name="t",
                        output=[vi("y", (2,))])
    else_g = GraphProto(node=[node("Add", ["x", "x"], ["y"]),
                              node("Mul", ["x", "x"], ["z"])], name="e",
                        output=[vi("y", (2,)), vi("z", (2,))])
    return model([node("If", ["p"], ["out"], then_branch=then_g,
                       else_branch=else_g)],
                 [vi("p", (), 9), vi("x", (2,))], [vi("out", (2,))])


@refusal
def loop_scan_with_computed_condition():
    body = GraphProto(
        node=[node("Add", ["v_in", "v_in"], ["v_out"]),
              node("ReduceSum", ["v_out"], ["s"], keepdims=0),
              node("Less", ["s", "hundred"], ["cond_out"]),
              node("Mul", ["v_out", "v_out"], ["scan"])],
        name="body", input=[vi("iter", (), 7), vi("cond_in", (), 9),
                            vi("v_in", (2,))],
        output=[vi("cond_out", (), 9), vi("v_out", (2,)), vi("scan", (2,))])
    return model([node("Loop", ["M", "", "v0"], ["v_final", "scans"],
                       body=body)],
                 [vi("v0", (2,))], [vi("v_final", (2,)), vi("scans", (4, 2))],
                 [("M", np.asarray(4, np.int64)),
                  ("hundred", np.asarray(100.0, np.float32))])


@refusal
def loop_scan_without_host_trip_count():
    m = _loop_model(True)
    m.graph.initializer[:] = [i for i in m.graph.initializer if i.name != "M"]
    m.graph.input.append(vi("M", (), 7))
    return m


@refusal
def scan_nonzero_axis():
    m = _scan_model(0, 0)
    m.graph.node[0].attribute.append(attr("scan_input_axes", [1]))
    return m


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_the_jax_package(name):
    _seeded(name)
    blob = REFUSALS[name]().encode()
    with pytest.raises(JaxError) as want:
        jax_import(blob)
    with pytest.raises(ONNXImportError) as got:
        import_onnx_model(blob, device="cpu")
    assert str(got.value) == str(want.value)


# -- real torch.onnx exports of a scripted loop -------------------------------


@pytest.fixture
def _onnxscript_merge_off():
    # the legacy exporter's last pass merges onnxscript functions and needs
    # the absent `onnx` package; it is a no-op for these modules
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, opsets: \
        model_bytes
    yield
    onnx_proto_utils._add_onnxscript_fn = orig


def test_scripted_loop_export_and_its_gradient(_onnxscript_merge_off):
    """torch.onnx.export of a scripted for loop (an ONNX Loop with M from
    Shape → Gather): the outputs equal the JAX package's import and
    torch's; the gradient through it (the static route) equals torch
    autograd's."""

    class LoopNet(torch.nn.Module):
        def forward(self, x):
            acc = torch.zeros_like(x[0])
            for i in range(x.size(0)):
                acc = torch.tanh(acc + x[i])
            return acc

    net = torch.jit.script(LoopNet())
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    buf = io.BytesIO()
    torch.onnx.export(net, (x,), buf, opset_version=13, dynamo=False,
                      input_names=["x"], output_names=["out"])
    net(x).sum().backward()
    blob = buf.getvalue()
    sd, ins, outs = _compare(blob, {"x": x.detach().numpy()})
    got = sd.output({"x": x.detach().numpy()}, [outs["out"]])[outs["out"]]
    np.testing.assert_allclose(got.numpy(), net(x).detach().numpy(),
                               rtol=2e-5, atol=1e-6)
    _promote(sd, ins["x"], x.detach().clone())
    sdm.reset_loop_stats()
    loss = sd.get_variable(outs["out"]).sum()
    g = sd.calculate_gradients({}, loss.name, [ins["x"]])[ins["x"]]
    assert sdm.loop_stats()["static"] == {5: 1}
    np.testing.assert_allclose(g.numpy(), x.grad.numpy(), rtol=2e-5,
                               atol=1e-6)


def test_entry_point_defaults_to_the_card():
    """With no device the import goes to the first CUDA card; without one
    it raises rather than fall back to the CPU."""
    blob = _loop_model(False).encode()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        import_onnx_model(blob)
