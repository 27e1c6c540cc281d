"""The port's GraphDef codec and TF importer against TensorFlow and the JAX package.

- The codec (``modelimport/tf_proto.py``): TensorFlow-written GraphDef
  bytes decode to the nodes, attrs and tensors TensorFlow's own parse
  holds; the port's encoding parses back in TensorFlow to an equal
  GraphDef; ``make_ndarray`` equals ``tf.make_ndarray`` on the value
  fields (a single value broadcast, a short list padded, fp16 and bf16
  in ``half_val``).
- The import: each straight-line graph of ``tests/test_modelimport.py``
  (``TestTFGraphImport``, ``TestTFGraphImportExt``) and
  ``tests/test_tf_frozen_models.py``, frozen once, goes through the JAX
  package's ``import_tf_graph`` and the port's; the outputs are held to
  each other and to TensorFlow at each case's tolerance (RTOL/ATOL unless
  the case states its own).
- A TF-frozen BERT (2 layers, width 64, 4 heads, the port's weights):
  the JAX import against the port import, outputs and the gradients of
  every promoted weight (each leaf to 1e-3 of its max, floored at 1e-4
  of the largest leaf's, ``chip_smoke._check_grads``' limit); and
  ``chip_smoke.bert_graph_def`` at the same size against TensorFlow's freeze of the same ``tf.function``: the same
  op histogram, the same outputs after import, and ``Bert.encode``'s.
- A graph with TF control flow the importer cannot raise raises
  ``TFImportError`` naming the op.
- The codec round trip of a GraphDef with a function library (a Keras GRU
  frozen with functional While, a loop with an If in it, and the lowered
  form) is byte-equal to TensorFlow's deterministic serialization of the
  parsed graph.
- ``chip_smoke``'s char-GRU writer and its ``tf_control_flow`` graphs
  against TensorFlow's freeze of the same programs: the same op multiset
  in the outer graph and in each function, and the same outputs.
"""

import collections
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu.modelimport import import_tf_graph as jax_import  # noqa: E402
from deeplearning4j_tpu.modelimport.tf import freeze_tf_function  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    TFImportError,
    import_tf_graph,
    tf_proto,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rs(seed):
    return np.random.RandomState(seed)


# -- the straight-line graphs: (fn, args, rtol, atol) ------------------------

def _mlp():
    w1 = tf.constant(_rs(0).randn(6, 8).astype(np.float32))
    b1 = tf.constant(np.zeros(8, np.float32))
    return (lambda x: tf.nn.relu(tf.matmul(x, w1) + b1),
            [_rs(1).randn(4, 6).astype(np.float32)])


def _layernorm():
    gamma = tf.constant(_rs(2).rand(8).astype(np.float32))
    beta = tf.constant(_rs(3).rand(8).astype(np.float32))

    def f(x):
        mean = tf.reduce_mean(x, axis=-1, keepdims=True)
        var = tf.reduce_mean(tf.math.squared_difference(x, mean), -1,
                             keepdims=True)
        return (x - mean) * tf.math.rsqrt(var + 1e-6) * gamma + beta

    return f, [_rs(4).randn(3, 8).astype(np.float32)]


def _gelu_erf():
    return (lambda x: 0.5 * x * (1.0 + tf.math.erf(
        x / np.sqrt(2.0).astype(np.float32))),
        [_rs(5).randn(4, 7).astype(np.float32)])


def _attention_core():
    rs = _rs(6)
    wq, wk, wv = (tf.constant(rs.randn(16, 16).astype(np.float32) * 0.2)
                  for _ in range(3))

    def f(x):
        q, k, v = tf.matmul(x, wq), tf.matmul(x, wk), tf.matmul(x, wv)
        p = tf.nn.softmax(tf.matmul(q, k, transpose_b=True) / 4.0, axis=-1)
        return tf.matmul(p, v)

    return f, [rs.randn(5, 16).astype(np.float32)]


def _multihead():
    rs = _rs(7)
    w = tf.constant(rs.randn(12, 12).astype(np.float32) * 0.3)

    def f(x):
        h = tf.transpose(tf.reshape(tf.matmul(x, w), [2, 4, 3, 4]),
                         [0, 2, 1, 3])
        o = tf.matmul(tf.nn.softmax(tf.matmul(h, h, transpose_b=True)), h)
        return tf.reshape(tf.transpose(o, [0, 2, 1, 3]), [8, 12])

    return f, [rs.randn(8, 12).astype(np.float32)]


def _conv_pool():
    rs = _rs(8)
    w = tf.constant(rs.randn(3, 3, 2, 4).astype(np.float32) * 0.2)

    def f(x):
        h = tf.nn.relu(tf.nn.conv2d(x, w, strides=1, padding="SAME"))
        return (tf.nn.max_pool2d(h, 2, 2, "VALID"),
                tf.nn.avg_pool2d(h, 3, 2, "SAME"),
                tf.nn.max_pool2d(h, 3, 2, "SAME"))

    return f, [rs.rand(2, 8, 8, 2).astype(np.float32)]


def _embedding_gather():
    rs = _rs(9)
    table = tf.constant(rs.randn(30, 6).astype(np.float32))
    return (lambda ids: tf.reduce_mean(tf.gather(table, ids), axis=1),
            [rs.randint(0, 30, (4, 5)).astype(np.int32)])


def _slice_concat_pad():
    def f(x):
        c = tf.concat([x[:, 3:], x[:, :3]], axis=1)
        return tf.pad(c, [[0, 0], [1, 1]])

    return f, [_rs(10).randn(3, 6).astype(np.float32)]


def _range_positions():
    rs = _rs(14)
    table = tf.constant(rs.randn(16, 4).astype(np.float32))
    return (lambda x: x + tf.gather(table, tf.range(8)),
            [rs.randn(8, 4).astype(np.float32)])


def _strided_slice_masks():
    # begin/end masks, shrink axes and negative strides
    return (lambda x: (x[::-1, 1:], x[:, -1:0:-2], x[2, ::-1], x[:-1],
                       x[1:, 3]),
            [_rs(15).randn(4, 6).astype(np.float32)])


def _einsum():
    rs = _rs(0)
    w = tf.constant(rs.randn(4, 6, 8).astype(np.float32))
    return (lambda x: tf.einsum("bth,thd->btd", x, w),
            [rs.randn(2, 4, 6).astype(np.float32)])


def _slice_splitv():
    def f(x):
        p1, p2, p3 = tf.split(x, [2, 3, -1], axis=1)
        return tf.slice(x, [0, 1], [2, -1]), p1, p2, p3

    return f, [_rs(1).randn(3, 8).astype(np.float32)]


def _unpack_argmax_cumsum():
    def f(x):
        rows = tf.unstack(x, axis=0)
        return (rows[0], rows[2], tf.cast(tf.argmax(x, axis=1), tf.float32),
                tf.cumsum(x, axis=1, exclusive=True, reverse=True))

    return f, [_rs(2).randn(3, 5).astype(np.float32)]


def _top_k():
    def f(x):
        v, i = tf.math.top_k(x, k=3)
        return v, tf.cast(i, tf.float32)

    return f, [_rs(3).randn(4, 9).astype(np.float32)]


def _resize():
    return (lambda x: (tf.image.resize(x, [8, 8], method="bilinear"),
                       tf.image.resize(x, [8, 8], method="nearest")),
            [_rs(4).rand(2, 4, 4, 3).astype(np.float32)], 1e-3, 1e-4)


def _conv2d_transpose():
    rs = _rs(5)
    w = tf.constant(rs.randn(3, 3, 5, 4).astype(np.float32) * 0.3)
    return (lambda x: tf.nn.conv2d_transpose(
        x, w, output_shape=[2, 8, 8, 5], strides=[1, 2, 2, 1],
        padding="SAME"), [rs.randn(2, 4, 4, 4).astype(np.float32)],
        1e-4, 1e-4)


def _mirror_pad():
    return (lambda x: (tf.pad(x, [[0, 0], [2, 1]], mode="REFLECT"),
                       tf.pad(x, [[1, 0], [0, 2]], mode="SYMMETRIC")),
            [_rs(6).randn(3, 6).astype(np.float32)])


def _keras(build, shape):
    keras = pytest.importorskip("tf_keras")
    model = build(keras)

    def f(x):
        return model(x, training=False)

    return f, [np.random.default_rng(0).normal(size=(2, *shape)).astype(
        np.float32)], 1e-4, 5e-6


def _small_cnn():
    return _keras(lambda keras: keras.Sequential([
        keras.layers.Input((16, 16, 3)),
        keras.layers.Conv2D(8, 3, padding="same", activation="relu"),
        keras.layers.BatchNormalization(),
        keras.layers.MaxPooling2D(),
        keras.layers.Conv2D(16, 3, strides=2, activation="relu"),
        keras.layers.Flatten(),
        keras.layers.Dense(5, activation="softmax")]), (16, 16, 3))


def _mobilenet():
    return _keras(lambda keras: keras.applications.MobileNet(
        weights=None, input_shape=(64, 64, 3), classes=7), (64, 64, 3))


CASES = {
    "mlp_matmul_bias_relu": _mlp, "layernorm_decomposition": _layernorm,
    "gelu_erf_form": _gelu_erf, "attention_core": _attention_core,
    "multihead_reshape_transpose": _multihead, "conv_pool": _conv_pool,
    "embedding_gather": _embedding_gather,
    "slice_concat_pad": _slice_concat_pad,
    "range_positions_int_gather": _range_positions,
    "strided_slice_masks": _strided_slice_masks, "einsum": _einsum,
    "slice_and_splitv": _slice_splitv,
    "unpack_argmax_cumsum": _unpack_argmax_cumsum, "top_k": _top_k,
    "resize_bilinear_and_nearest": _resize,
    "conv2d_transpose": _conv2d_transpose, "mirror_pad": _mirror_pad,
    "frozen_small_cnn": _small_cnn, "frozen_mobilenet": _mobilenet,
}


def _frozen(name):
    fn, args, *tol = CASES[name]()
    rtol, atol = tol or (RTOL, ATOL)
    gd, in_names, out_names = freeze_tf_function(
        fn, *[tf.constant(a) for a in args])
    want = fn(*[tf.constant(a) for a in args])
    want = [np.asarray(w) for w in
            (want if isinstance(want, (list, tuple)) else [want])]
    return gd, in_names, out_names, args, want, rtol, atol


@pytest.mark.parametrize("name", sorted(CASES))
def test_import_matches_jax_and_tf(name):
    gd, in_names, out_names, args, want, rtol, atol = _frozen(name)
    shapes = {n: tuple(a.shape) for n, a in zip(in_names, args)}
    jsd, jin, jout = jax_import(gd, inputs=shapes, outputs=out_names)
    tsd, tin, tout = import_tf_graph(gd, inputs=shapes, outputs=out_names,
                                     device="cpu")
    assert tin == jin and tout == jout
    feeds = {tin[n]: a for n, a in zip(in_names, args)}
    names = [tout[o] for o in out_names]
    jgot = jsd.output(feeds, names)
    tgot = tsd.output(feeds, names)
    for n, w in zip(names, want):
        got = tgot[n].numpy()
        assert got.dtype == jgot[n].dtype
        np.testing.assert_allclose(got, jgot[n], rtol=rtol, atol=atol)
        np.testing.assert_allclose(got, w, rtol=rtol, atol=atol)
    assert tsd.to_dict()["variables"] == jsd.to_dict()["variables"]


def test_strided_slice_fold_masks():
    """The host StridedSlice folder: begin/end masks and shrink_axis_mask
    (the exporter's `shape[0]` chase), on NodeDefs of the port's codec."""
    from deeplearning4j_tpu_torch.modelimport.tf import _tf_fold_strided_slice

    def node(**masks):
        return tf_proto.NodeDef(op="StridedSlice", attr={
            k: tf_proto.AttrValue("i", v) for k, v in masks.items()})

    x = np.asarray([2, 7, 64, 64])
    out = _tf_fold_strided_slice(node(shrink_axis_mask=1), [
        x, np.asarray([0]), np.asarray([1]), np.asarray([1])])
    assert out.shape == () and int(out) == 2
    np.testing.assert_array_equal(_tf_fold_strided_slice(node(), [
        x, np.asarray([1]), np.asarray([3]), np.asarray([1])]), [7, 64])
    np.testing.assert_array_equal(_tf_fold_strided_slice(node(end_mask=1), [
        x, np.asarray([2]), np.asarray([0]), np.asarray([1])]), [64, 64])
    np.testing.assert_array_equal(_tf_fold_strided_slice(node(begin_mask=1), [
        x, np.asarray([0]), np.asarray([-5]), np.asarray([-1])]),
        [64, 64, 7, 2])


# -- the codec against TensorFlow's own parse ----------------------------------

def _attr_equal(mine, theirs):
    kind = theirs.WhichOneof("value")
    assert mine.kind == kind
    v = mine.value
    if kind in ("i", "b", "type", "s", "placeholder"):
        assert v == getattr(theirs, kind)
    elif kind == "f":
        assert np.float32(v) == np.float32(theirs.f)
    elif kind == "shape":
        assert [d.size for d in v.dim] == [d.size for d in theirs.shape.dim]
        assert v.unknown_rank == theirs.shape.unknown_rank
    elif kind == "tensor":
        _tensor_equal(v, theirs.tensor)
    elif kind == "list":
        lst = theirs.list
        assert v.i == list(lst.i) and v.s == list(lst.s)
        assert v.type == list(lst.type) and v.b == list(lst.b)
        np.testing.assert_array_equal(np.float32(v.f), np.float32(lst.f))
        assert len(v.shape) == len(lst.shape)
    elif kind == "func":
        assert v.name == theirs.func.name


def _tensor_equal(mine, theirs):
    want = tf.make_ndarray(theirs)
    got = tf_proto.make_ndarray(mine)
    if isinstance(got, torch.Tensor):  # bfloat16
        got, want = got.float().numpy(), want.astype(np.float32)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


CODEC_CASES = ["conv_pool", "frozen_small_cnn", "strided_slice_masks",
               "top_k"]


@pytest.mark.parametrize("name", CODEC_CASES)
def test_tf_bytes_decode_like_tfs_own_parse(name):
    gd = _frozen(name)[0]
    blob = gd.SerializeToString()
    mine = tf_proto.GraphDef.decode(blob)
    assert [n.name for n in mine.node] == [n.name for n in gd.node]
    for m, t in zip(mine.node, gd.node):
        assert (m.op, m.input, m.device) == (t.op, list(t.input), t.device)
        assert sorted(m.attr) == sorted(t.attr)
        for key in t.attr:
            _attr_equal(m.attr[key], t.attr[key])
    # and the port's encoding parses back in TF to the same GraphDef
    again = tf.compat.v1.GraphDef.FromString(mine.encode())
    assert again == gd


def _tensor(**kw):
    from tensorflow.core.framework import tensor_pb2, tensor_shape_pb2

    shape = kw.pop("shape")
    return tensor_pb2.TensorProto(
        tensor_shape=tensor_shape_pb2.TensorShapeProto(
            dim=[tensor_shape_pb2.TensorShapeProto.Dim(size=d)
                 for d in shape]), **kw)


TENSORS = {
    "float_broadcast": dict(dtype=1, shape=[2, 3], float_val=[1.5]),
    "int_padded": dict(dtype=3, shape=[5], int_val=[1, -2, 3]),
    "int64": dict(dtype=9, shape=[2], int64_val=[-(2 ** 40), 7]),
    "bool": dict(dtype=10, shape=[3], bool_val=[True, False, True]),
    "double": dict(dtype=2, shape=[2, 2], double_val=[0.1, 0.2, 0.3, 0.4]),
    "half": dict(dtype=19, shape=[3], half_val=list(np.asarray(
        [1.5, -2.25, 65504.0], np.float16).view(np.uint16))),
    "bfloat16": dict(dtype=14, shape=[2], half_val=[0x3FC0, 0xC010]),
    "scalar": dict(dtype=1, shape=[], float_val=[3.25]),
    "empty_zeros": dict(dtype=3, shape=[2, 2]),
    "content": dict(dtype=1, shape=[2, 3], tensor_content=np.arange(
        6, dtype=np.float32).tobytes()),
}


@pytest.mark.parametrize("name", sorted(TENSORS))
def test_make_ndarray_matches_tf(name):
    t = _tensor(**TENSORS[name])
    mine = tf_proto.TensorProto.decode(t.SerializeToString())
    _tensor_equal(mine, t)
    again = type(t).FromString(b"".join(mine.writer().chunks))
    _tensor_equal(tf_proto.TensorProto.decode(again.SerializeToString()), t)


# -- a TF-frozen BERT, and chip_smoke's writer ----------------------------------

BERT_N, BERT_T = 2, 16


@pytest.fixture(scope="module")
def bert():
    from deeplearning4j_tpu_torch.models.bert import bert_tiny

    model = bert_tiny(device="cpu", hidden=64, num_layers=2, num_heads=4,
                      intermediate=128, vocab_size=97, max_position=32)
    return model, chip_smoke.bert_encoder_params(model)


def _tf_bert(params, num_heads, eps, n, t):
    """A tf.function that mirrors Bert.encode over tf.Variables of
    ``params``, frozen by convert_variables_to_constants_v2."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    v = {k: tf.Variable(a) for k, a in params.items()}
    width = params["embeddings/word"].shape[1]
    head = width // num_heads
    layers = sorted({k.split("/")[0] for k in params if k.startswith("layer_")})

    def ln(x, g, b):
        m = tf.reduce_mean(x, -1, keepdims=True)
        var = tf.reduce_mean(tf.math.squared_difference(x, m), -1,
                             keepdims=True)
        return (x - m) * tf.math.rsqrt(var + eps) * v[g] + v[b]

    def dense(x, w, b):
        return tf.matmul(x, v[w]) + v[b]

    def heads(x):
        return tf.transpose(tf.reshape(x, [n, t, num_heads, head]),
                            [0, 2, 1, 3])

    def encode(token_ids, segment_ids, mask):
        x = (tf.gather(v["embeddings/word"], token_ids)
             + tf.gather(v["embeddings/position"], tf.range(t)))
        x = x + tf.gather(v["embeddings/type"], segment_ids)
        x = ln(x, "embeddings/ln_gamma", "embeddings/ln_beta")
        bias = (1.0 - tf.reshape(mask, [n, 1, 1, t])) * \
            chip_smoke.BERT_MASK_BIAS
        for layer in layers:
            p = f"{layer}/attention/"
            q, k, vv = (heads(dense(x, p + w, p + b))
                        for w, b in (("Wq", "bq"), ("Wk", "bk"), ("Wv", "bv")))
            s = tf.matmul(q, k, transpose_b=True) * (head ** -0.5) + bias
            c = tf.reshape(tf.transpose(tf.matmul(tf.nn.softmax(s), vv),
                                        [0, 2, 1, 3]), [n, t, width])
            x = ln(x + dense(c, p + "Wo", p + "bo"), f"{layer}/ln1_gamma",
                   f"{layer}/ln1_beta")
            f = dense(tf.nn.gelu(dense(x, f"{layer}/W1", f"{layer}/b1"),
                                 approximate=True), f"{layer}/W2",
                      f"{layer}/b2")
            x = ln(x + f, f"{layer}/ln2_gamma", f"{layer}/ln2_beta")
        return x

    specs = [tf.TensorSpec([n, t], tf.int32, name="token_ids"),
             tf.TensorSpec([n, t], tf.int32, name="segment_ids"),
             tf.TensorSpec([n, t], tf.float32, name="mask")]
    frozen = convert_variables_to_constants_v2(
        tf.function(encode).get_concrete_function(*specs))
    return (frozen.graph.as_graph_def(),
            [t_.name.split(":")[0] for t_ in frozen.inputs],
            frozen.outputs[0].name.split(":")[0])


def _bert_feeds(vocab):
    r = np.random.default_rng(3)
    lengths = np.asarray([BERT_T, 5])
    pos = np.arange(BERT_T)[None, :]
    return {"token_ids": r.integers(0, vocab, (BERT_N, BERT_T)).astype(
                np.int32),
            "segment_ids": (pos >= lengths[:, None] // 2).astype(np.int32),
            "mask": (pos < lengths[:, None]).astype(np.float32)}


@pytest.fixture(scope="module")
def tf_bert(bert):
    model, params = bert
    c = model.config
    return _tf_bert(params, c.num_heads, c.eps, BERT_N, BERT_T)


def _promote_and_loss(sd, names, out, n, t, width):
    """Every weight constant promoted to a VARIABLE, and a scalar loss
    Σ hidden · c for a fixed cotangent c."""
    for name in names:
        sd.convert_to_variable(name)
    cot = np.random.default_rng(4).standard_normal((n, t, width)).astype(
        np.float32)
    return (sd.get_variable(out) * sd.constant("cotangent", cot)).sum().name


def test_tf_frozen_bert_jax_import_matches_port_import(bert, tf_bert):
    model, params = bert
    gd, in_names, out_name = tf_bert
    feeds = _bert_feeds(model.config.vocab_size)
    jsd, jin, jout = jax_import(gd, outputs=[out_name])
    tsd, tin, tout = import_tf_graph(gd, outputs=[out_name], device="cpu")
    hidden = tout[out_name]
    want = jsd.output({jin[k]: a for k, a in feeds.items()}, [hidden])[hidden]
    got = tsd.output({tin[k]: a for k, a in feeds.items()}, [hidden])[hidden]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # gradients of every weight (the frozen graph's Const names are TF's)
    weights = [v.name for v in tsd.variables()
               if v.var_type.value == "CONSTANT" and v.shape
               and np.prod(v.shape) > 1 and v.dtype == "float32"]
    width = model.config.hidden
    jl = _promote_and_loss(jsd, weights, hidden, BERT_N, BERT_T, width)
    tl = _promote_and_loss(tsd, weights, hidden, BERT_N, BERT_T, width)
    jf = {jin[k]: a for k, a in feeds.items()}
    jg = jsd.calculate_gradients(jf, jl)
    tg = tsd.calculate_gradients(jf, tl)
    assert sorted(tg) == sorted(jg) and len(tg) == len(params)
    # chip_smoke's _check_grads limit: each leaf to TOL_GRAD_FRAC of its
    # max, floored at TOL_GRAD_FLOOR of the largest (the key biases'
    # gradient is zero but for rounding)
    top = max(np.abs(w).max() for w in jg.values())
    for name, w in jg.items():
        limit = chip_smoke.TOL_GRAD_FRAC * max(
            np.abs(w).max(), chip_smoke.TOL_GRAD_FLOOR * top)
        assert np.abs(tg[name].numpy() - w).max() <= limit, name


def test_chip_smoke_writer_matches_tfs_freeze(bert, tf_bert):
    model, params = bert
    c = model.config
    gd, in_names, out_name = tf_bert
    blob = chip_smoke.bert_graph_def(params, num_heads=c.num_heads,
                                     eps=c.eps, batch=BERT_N, seq_len=BERT_T)
    mine = tf_proto.GraphDef.decode(blob)
    hist = collections.Counter(n.op for n in mine.node)
    assert hist == collections.Counter(n.op for n in gd.node)
    tf.compat.v1.GraphDef.FromString(blob)  # TF parses the writer's bytes
    feeds = _bert_feeds(c.vocab_size)
    sd_w, in_w, out_w = import_tf_graph(blob, device="cpu")
    sd_t, in_t, out_t = import_tf_graph(gd, outputs=[out_name], device="cpu")
    assert sorted(in_w) == sorted(in_t) == sorted(chip_smoke.BERT_GRAPH_INPUTS)
    h_w = out_w[chip_smoke.BERT_GRAPH_OUTPUT]
    got = sd_w.output({in_w[k]: a for k, a in feeds.items()}, [h_w])[h_w]
    want = sd_t.output({in_t[k]: a for k, a in feeds.items()},
                       [out_t[out_name]])[out_t[out_name]]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    with torch.inference_mode():
        native = model.encode({k: torch.from_numpy(a)
                               for k, a in feeds.items()})
    np.testing.assert_allclose(got.numpy(), native.numpy(), rtol=RTOL,
                               atol=ATOL)


# -- control flow, and what the importer refuses --------------------------------

def test_control_flow_graph_raises_naming_the_op():
    """A lowered (TF1-frame) loop imports and gives TensorFlow's output
    (tests/test_torch_tf_control_flow.py holds every control-flow form);
    a frame the importer cannot raise (a ref-typed RefEnter, which neither
    package maps) raises TFImportError naming the node it stops at."""
    def f(x):
        return tf.while_loop(lambda i, s: i < 3,
                             lambda i, s: (i + 1, s * 2.0),
                             [tf.constant(0), x])[1]

    x = np.arange(3, dtype=np.float32)
    gd, in_names, out_names = freeze_tf_function(
        f, tf.constant(np.ones(3, np.float32)))
    ops = {n.op for n in gd.node}
    assert {"Enter", "Merge", "Switch", "LoopCond"} <= ops
    sd, ins, outs = import_tf_graph(gd, inputs={in_names[0]: (3,)},
                                    outputs=out_names, device="cpu")
    got = sd.output({ins[in_names[0]]: x}, [outs[out_names[0]]])
    np.testing.assert_allclose(got[outs[out_names[0]]].numpy(),
                               f(tf.constant(x)).numpy(), rtol=RTOL)
    broken = tf_proto.as_graph_def(gd)
    next(n for n in broken.node if n.op == "Enter").op = "RefEnter"
    with pytest.raises(TFImportError) as e:
        import_tf_graph(broken, inputs={in_names[0]: (3,)},
                        outputs=out_names, device="cpu")
    # the message names the control-flow node (or op) the raise stops at
    assert any(f"{n.name}'" in str(e.value) or f" {n.op} " in str(e.value)
               for n in broken.node if n.op in ops | {"RefEnter"}
               and n.op not in ("Const", "Placeholder", "Identity", "NoOp"))


def test_unsupported_op_clear_error():
    def f(x):
        return tf.signal.fft(tf.cast(x, tf.complex64))

    gd, in_names, out_names = freeze_tf_function(
        f, tf.constant(np.ones(8, np.float32)))
    with pytest.raises(TFImportError, match="no mapper|unsupported TF dtype"):
        import_tf_graph(gd, inputs={in_names[0]: (8,)}, outputs=out_names,
                        device="cpu")


def test_conv2d_backprop_input_keeps_tfs_input_size():
    """An odd input size: TF's Conv2DBackpropInput gives [2, 7, 7, 5]; the
    port crops the transposed conv to input_sizes. The JAX package's
    lax.conv_transpose ignores input_sizes and gives [2, 8, 8, 5]
    (ROADMAP §3)."""
    rs = _rs(5)
    w = tf.constant(rs.randn(3, 3, 5, 4).astype(np.float32) * 0.3)

    def f(x):
        return tf.nn.conv2d_transpose(x, w, output_shape=[2, 7, 7, 5],
                                      strides=[1, 2, 2, 1], padding="SAME")

    x = rs.randn(2, 4, 4, 4).astype(np.float32)
    gd, in_names, out_names = freeze_tf_function(f, tf.constant(x))
    sd, ins, outs = import_tf_graph(gd, inputs={in_names[0]: x.shape},
                                    outputs=out_names, device="cpu")
    got = sd.output({ins[in_names[0]]: x}, [outs[out_names[0]]])[
        outs[out_names[0]]]
    want = f(tf.constant(x)).numpy()
    assert tuple(got.shape) == want.shape == (2, 7, 7, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    jsd, jin, jout = jax_import(gd, inputs={in_names[0]: x.shape},
                                outputs=out_names)
    assert jsd.output({jin[in_names[0]]: x}, [jout[out_names[0]]])[
        jout[out_names[0]]].shape == (2, 8, 8, 5)


# -- graphs with a function library: the codec and chip_smoke's writers --------

def _keras_chargru(vocab=11, embed=8, hidden=16, t=12, batch=2):
    """The tutorial's char-GRU at a small width, frozen by TensorFlow with
    functional control flow, and Keras' weights under chip_smoke's
    names."""
    from tensorflow import keras
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    keras.utils.set_random_seed(0)
    m = keras.Sequential([
        keras.layers.Input((t,), dtype="int32"),
        keras.layers.Embedding(vocab, embed),
        keras.layers.GRU(hidden, return_sequences=True, reset_after=True),
        keras.layers.Dense(vocab)])
    (emb,), (k, rk, b), (dk, db) = (layer.get_weights() for layer in m.layers)
    # a bias that is not zero, so both halves are exercised
    b = (0.1 * _rs(9).randn(*b.shape)).astype(np.float32)
    db = (0.1 * _rs(10).randn(*db.shape)).astype(np.float32)
    m.layers[1].set_weights([k, rk, b])
    m.layers[2].set_weights([dk, db])
    conc = tf.function(lambda x: m(x, training=False)).get_concrete_function(
        tf.TensorSpec((batch, t), tf.int32))
    gd = convert_variables_to_constants_v2(
        conc, lower_control_flow=False).graph.as_graph_def()
    params = {"embedding": emb, "kernel": k, "recurrent_kernel": rk,
              "bias": b, "dense_kernel": dk, "dense_bias": db}
    return m, gd, params


def _functions_by_role(gd):
    """{role: op multiset}: the outer graph, and each function under the
    attr that names it on its While/If (body, cond, then_branch, ...). The
    lowering's unread ``unused_control_flow_input`` placeholders are left
    out: their number changes from one TensorFlow freeze to the next (4 or
    5 for the same loop), and the importer skips them."""
    lib = {f.signature.name: f for f in gd.library.function} \
        if gd.library else {}
    roles = {"graph": collections.Counter(
        n.op for n in gd.node
        if not n.name.startswith("unused_control_flow_input"))}
    for n in gd.node:
        for key, a in n.attr.items():
            if a.kind == "func" if hasattr(a, "kind") else \
                    a.WhichOneof("value") == "func":
                name = a.value.name if hasattr(a, "kind") else a.func.name
                roles[f"{n.op}.{key}"] = collections.Counter(
                    nd.op for nd in lib[name].node_def)
    return roles


@pytest.mark.parametrize("program", ["keras_gru", "loop_with_if", "lowered"])
def test_codec_round_trip_with_function_library_is_byte_equal(program):
    """decode → encode of a GraphDef with a function library is TensorFlow's
    deterministic serialization of the parsed graph, byte for byte."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    if program == "keras_gru":
        gd = _keras_chargru()[1]
    else:
        def loop(x):
            return tf.while_loop(
                lambda i, a: i < 3,
                lambda i, a: (i + 1, tf.cond(tf.reduce_sum(a) > 0,
                                             lambda: a * 0.5,
                                             lambda: a + 1.0)),
                [tf.constant(0), x])[1]

        conc = tf.function(loop).get_concrete_function(
            tf.TensorSpec((2,), tf.float32))
        gd = convert_variables_to_constants_v2(
            conc, lower_control_flow=program == "lowered").graph.as_graph_def()
    assert (len(gd.library.function) > 0) == (program != "lowered")
    blob = gd.SerializeToString()
    mine = tf_proto.GraphDef.decode(blob)
    assert [f.signature.name for f in (mine.library or tf_proto.
            FunctionDefLibrary()).function] == [
        f.signature.name for f in gd.library.function]
    want = tf.compat.v1.GraphDef.FromString(blob).SerializeToString(
        deterministic=True)
    assert mine.encode() == want
    assert tf.compat.v1.GraphDef.FromString(mine.encode()) == gd


def test_chip_smoke_chargru_writer_matches_tfs_freeze():
    """chip_smoke.chargru_graph_def at vocab 11, embedding 8, GRU 16, T 12
    against TensorFlow's freeze of the same Keras model with the same
    weights: the same op multiset in the outer graph, the While's body and
    its cond; the same logits after import, and Keras' own."""
    m, gd, params = _keras_chargru()
    blob = chip_smoke.chargru_graph_def(params, batch=2, seq_len=12)
    tf.compat.v1.GraphDef.FromString(blob)  # TF parses the writer's bytes
    mine = tf_proto.GraphDef.decode(blob)
    assert _functions_by_role(mine) == _functions_by_role(gd)
    ids = _rs(11).randint(0, 11, (2, 12)).astype(np.int32)
    ids[0, 0] = -3  # the embedding's wrap of a negative id
    sd_w, in_w, out_w = import_tf_graph(blob, device="cpu")
    sd_t, in_t, out_t = import_tf_graph(gd, device="cpu")
    got = sd_w.output({in_w[chip_smoke.CHARGRU_INPUT]: ids},
                      [out_w[chip_smoke.CHARGRU_OUTPUT]])[
        out_w[chip_smoke.CHARGRU_OUTPUT]].numpy()
    (out_name,) = out_t
    want = sd_t.output({in_t["x"]: ids}, [out_t[out_name]])[
        out_t[out_name]].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.asarray(m(ids, training=False)),
                               rtol=2e-5, atol=2e-6)


def _tf_cf_program(name):
    """The TensorFlow program chip_smoke.tf_cf_graph_def writes."""
    if name == "lowered_loop":
        return (lambda x: tf.while_loop(
            lambda i, acc: i < 5, lambda i, acc: (i + 1, acc * 1.1 + 0.5),
            [tf.constant(0), x])[1]), True
    if name == "lowered_cond":
        return (lambda x: tf.cond(tf.reduce_sum(x) > 0.0,
                                  lambda: x * 2.0 + 1.0,
                                  lambda: x - 1.0)), True
    if name == "functional_if":
        return (lambda x: tf.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0,
                                  lambda: x - 1.0)), False
    return (lambda x: tf.while_loop(lambda acc: tf.reduce_sum(acc) < 100.0,
                                    lambda acc: (acc * 2.0,), [x])[0]), False


@pytest.mark.parametrize("name", ["lowered_loop", "lowered_cond",
                                  "functional_if", "dynamic_while"])
def test_chip_smoke_tf_control_flow_writer_matches_tfs_freeze(name):
    """chip_smoke.tf_cf_graph_def against TensorFlow's freeze of the same
    program: the same op multisets (outer graph and each function) and
    the same outputs after import, TensorFlow's and numpy's
    (chip_smoke.tf_cf_reference) for inputs that take each branch."""
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    fn, lower = _tf_cf_program(name)
    shape = (2, 3)
    conc = tf.function(fn).get_concrete_function(
        tf.TensorSpec(shape, tf.float32))
    frozen = convert_variables_to_constants_v2(conc, lower_control_flow=lower)
    gd = frozen.graph.as_graph_def()
    blob = chip_smoke.tf_cf_graph_def(name, shape)
    tf.compat.v1.GraphDef.FromString(blob)
    assert _functions_by_role(tf_proto.GraphDef.decode(blob)) == \
        _functions_by_role(gd)
    out_name = frozen.outputs[0].name.split(":")[0]
    sd_w, in_w, out_w = import_tf_graph(blob, device="cpu")
    sd_t, in_t, out_t = import_tf_graph(gd, outputs=[out_name], device="cpu")
    a = np.abs(_rs(12).randn(*shape)).astype(np.float32) * 0.1
    # each branch; the loop from two starts (a negative sum never ends it)
    for x in (a, 3 * a) if name == "dynamic_while" else (a, -a):
        got = sd_w.output({in_w[chip_smoke.TF_CF_INPUT]: x},
                          [out_w[chip_smoke.TF_CF_OUTPUT]])[
            out_w[chip_smoke.TF_CF_OUTPUT]].numpy()
        want = sd_t.output({in_t["x"]: x}, [out_t[out_name]])[
            out_t[out_name]].numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, fn(tf.constant(x)).numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(got, chip_smoke.tf_cf_reference(name, x),
                                   rtol=1e-6)
