"""The attention layers, the recurrent wrappers and the arg-taking graph vertices of the port against the JAX package, on the CPU.

Each layer is built from the JSON dict the JAX package writes for it
(``config_to_dict``), loaded by the port's ``config_from_dict`` and
written back equal; both packages then run it on the same inputs with the
same weights (the JAX package's init, every leaf moved off its initial
value, carried across by ``variables_from_numpy``): the six attention
layers (``SelfAttention``, ``LearnedSelfAttention``, ``CrossAttention``
with 1, 2 and 3 inputs, ``RecurrentAttention``,
``TransformerEncoderBlock``, ``PositionalEmbedding``), ``Bidirectional``
in every merge mode, ``LastTimeStep`` with and without a mask,
``SimpleRnn``, each ``_VERTEX_OPS`` kind, and ``ops/rnn``'s
``reverse_sequence``, ``simple_rnn`` and ``bidirectional_lstm``. The JAX
side attends through its XLA reference (its default off the TPU), the
port through its flash entry point, whose plain versions run on the CPU.
The head-size padding of the flash wrapper (``pad_head``) runs with the
plain attention in the kernels' place, at D = 16 and 48, forward and
gradients, against the unpadded plain attention and the JAX package.

Tolerances, float32 on both sides with sums in another order: outputs to
1e-5 of max(1, |JAX|); gradients of sum(y·w) for a random w, each leaf to
1e-4 of max(1, its max |JAX gradient|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import flash_attention as jax_fa
from deeplearning4j_tpu.nn import config as jax_config
from deeplearning4j_tpu.nn import layers as jax_layers
from deeplearning4j_tpu.nn.layers import attention as jax_att
from deeplearning4j_tpu.nn.model import GraphModel as JaxGraphModel
from deeplearning4j_tpu.ops import rnn as jax_rnn
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.nn import config as nnconfig
from deeplearning4j_tpu_torch.nn import layers  # noqa: F401 (registers them)
from deeplearning4j_tpu_torch.nn.model import GraphModel
from deeplearning4j_tpu_torch.ops import rnn as opsrnn
from deeplearning4j_tpu_torch.serde.checkpoint import variables_from_numpy
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names, tree_map

TOL = 1e-5
TOL_GRAD = 1e-4
N = 3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port_layer(jlayer):
    """The port's layer loaded from the JAX package's JSON dict of
    ``jlayer``, which it writes back equal."""
    d = jax_config.config_to_dict(jlayer)
    layer = nnconfig.config_from_dict(d)
    assert type(layer).__name__ == type(jlayer).__name__
    assert nnconfig.config_to_dict(layer) == d
    return layer


def _jax_params(jlayer, shapes, multi, seed=3):
    """The JAX init as numpy, each leaf moved off its initial value (the
    zero biases too), and the layer state."""
    key = jax.random.key(seed)
    if multi:
        p, s = jlayer.init_multi(key, shapes, jnp.float32)
    else:
        p, s = jlayer.init(key, shapes[0], jnp.float32)
    r = np.random.default_rng(seed + 1)
    p = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * r.standard_normal(a.shape)
                   ).astype(np.float32), p)
    return p, s


def _grads_close(got, want):
    assert got.keys() == want.keys()
    for name, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(got[name] - w).max())
        assert err <= TOL_GRAD * scale, (name, err, scale)


def _check_layer(jlayer, xs, *, multi=False, mask=None, grads=True):
    """One layer through both packages: output shapes, the forward, and
    the gradients of sum(y·w) with respect to every param and input."""
    layer = _port_layer(jlayer)
    shapes = [x.shape[1:] for x in xs]
    if multi:
        assert tuple(layer.output_shape_multi(shapes)) == tuple(
            jlayer.output_shape_multi(shapes))
    else:
        assert tuple(layer.output_shape(shapes[0])) == tuple(
            jlayer.output_shape(shapes[0]))
    jp, js = _jax_params(jlayer, shapes, multi)
    kw = {} if mask is None else {"mask": mask}

    def jfwd(p, xs):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        if multi:
            return jlayer.apply_multi(p, js, list(xs), **jkw)[0]
        return jlayer.apply(p, js, xs[0], **jkw)[0]

    want = np.asarray(jax.jit(jfwd)(jp, xs))
    params = tree_map(lambda a: a.requires_grad_(), variables_from_numpy(jp))
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    tkw = {k: torch.tensor(v) for k, v in kw.items()}
    state = variables_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    if multi:
        y, _ = layer.apply_multi(params, state, txs, **tkw)
    else:
        y, _ = layer.apply(params, state, txs[0], **tkw)
    assert tuple(y.shape) == want.shape
    assert tuple(y.shape[1:]) == tuple(
        layer.output_shape_multi(shapes) if multi
        else layer.output_shape(shapes[0]))
    err = float(np.abs(y.detach().numpy() - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err
    if not grads:
        return layer, jp
    w = _rand(11, *want.shape)
    jg_p, jg_x = jax.jit(jax.grad(
        lambda p, xs: jnp.sum(jfwd(p, xs) * w), argnums=(0, 1)))(jp, xs)
    leaves = [params_leaf for _, params_leaf in flatten_with_names(params)]
    got = torch.autograd.grad((y * torch.tensor(w)).sum(), leaves + txs,
                              allow_unused=True)
    names = [n for n, _ in flatten_with_names(params)]
    want_g = {n: np.asarray(a) for n, a in flatten_with_names(
        jax.tree_util.tree_map(np.asarray, jg_p))}
    want_g.update({f"x{i}": np.asarray(g) for i, g in enumerate(jg_x)})
    got_g = {n: (np.zeros_like(want_g[n]) if g is None else g.numpy())
             for n, g in zip(names + [f"x{i}" for i in range(len(xs))],
                             got)}
    _grads_close(got_g, want_g)
    return layer, jp


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)


# -- the attention layers -----------------------------------------------------

@pytest.mark.parametrize("kw,masked", [
    ({"num_heads": 4}, False),
    ({"num_heads": 2, "out_size": 24, "head_size": 5}, True),
    ({"num_heads": 4, "causal": True}, True),
    ({"num_heads": 2, "use_bias": False}, False),
])
def test_self_attention_matches_jax(kw, masked):
    x = _rand(0, N, 9, 16)
    _check_layer(jax_att.SelfAttention(**kw), [x],
                 mask=_mask([9, 5, 1], 9) if masked else None)


def test_sequence_parallel_names_are_checked_like_jax():
    for bad in ("sideways",):
        with pytest.raises(ValueError, match="sequence_parallel"):
            nnconfig.config_from_dict({"@class": "SelfAttention",
                                       "sequence_parallel": bad})
    layer = _port_layer(jax_att.SelfAttention(num_heads=2,
                                              sequence_parallel="ring"))
    assert layer.sequence_parallel == "ring"
    with pytest.raises(ValueError, match="sequence_parallel"):
        _port_layer(jax_att.LearnedSelfAttention(n_queries=2)).__class__(
            n_queries=2, sequence_parallel="ring")


@pytest.mark.parametrize("n_queries,masked", [(4, True), (1, False),
                                              (7, True)])
def test_learned_self_attention_matches_jax(n_queries, masked):
    x = _rand(1, N, 10, 16)
    layer, jp = _check_layer(
        jax_att.LearnedSelfAttention(num_heads=2, n_queries=n_queries), [x],
        mask=_mask([10, 4, 7], 10) if masked else None)
    assert "Q" in jp and "Wq" not in jp and "bq" not in jp


@pytest.mark.parametrize("case", ["one_input", "two_inputs", "three_inputs",
                                  "two_inputs_causal_masked",
                                  "no_projection"])
def test_cross_attention_matches_jax(case):
    q, kv = _rand(2, N, 6, 16), _rand(3, N, 10, 24)
    mask = None
    if case == "one_input":
        layer, xs = jax_att.CrossAttention(num_heads=4), [q]
    elif case == "two_inputs":
        layer = jax_att.CrossAttention(num_heads=4, out_size=32)
        xs = [q, kv]
    elif case == "three_inputs":
        layer = jax_att.CrossAttention(num_heads=2, head_size=6)
        xs = [q, kv, _rand(4, N, 10, 8)]
    elif case == "two_inputs_causal_masked":
        layer = jax_att.CrossAttention(num_heads=4, causal=True)
        xs, mask = [q, _rand(5, N, 6, 24)], _mask([6, 3, 5], 6)
    else:
        layer = jax_att.CrossAttention(num_heads=4, project_input=False)
        xs = [q, _rand(6, N, 10, 16)]
    _check_layer(layer, xs, multi=len(xs) > 1, mask=mask)


def test_cross_attention_refuses_what_jax_refuses():
    layer = _port_layer(jax_att.CrossAttention(num_heads=3,
                                               project_input=False))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="equal embed sizes"):
        layer.init_multi(gen, [(6, 12), (10, 9)], torch.float32)
    with pytest.raises(ValueError, match="must divide"):
        layer.init_multi(gen, [(6, 16), (10, 16)], torch.float32)
    with pytest.raises(ValueError, match="1-3 inputs"):
        layer.init_multi(gen, [(6, 12)] * 4, torch.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_recurrent_attention_matches_jax(masked):
    x = _rand(7, N, 8, 10)
    _check_layer(jax_att.RecurrentAttention(units=12, num_heads=3), [x],
                 mask=_mask([8, 3, 6], 8) if masked else None)


@pytest.mark.parametrize("kw,masked", [
    ({"num_heads": 2, "intermediate": 40}, True),
    ({"num_heads": 4, "causal": True, "post_ln": False}, False),
    ({"num_heads": 2, "remat": True}, True),
])
def test_transformer_encoder_block_matches_jax(kw, masked):
    x = _rand(8, N, 9, 16)
    _check_layer(jax_att.TransformerEncoderBlock(**kw), [x],
                 mask=_mask([9, 2, 6], 9) if masked else None)


def test_positional_embedding_matches_jax():
    layer, jp = _check_layer(jax_att.PositionalEmbedding(max_len=12),
                             [_rand(9, N, 10, 16)])
    assert jp["P"].shape == (12, 16)


# -- the recurrent layers -----------------------------------------------------

@pytest.mark.parametrize("merge", ["concat", "add", "mul", "average"])
def test_bidirectional_lstm_matches_jax_in_every_merge_mode(merge):
    layer, jp = _check_layer(jax_layers.Bidirectional(
        jax_layers.LSTM(units=8), merge=merge), [_rand(10, N, 7, 5)])
    assert set(jp) == {"fwd", "bwd"}


@pytest.mark.parametrize("inner", ["gru", "graves_last_step", "simple_rnn"])
def test_bidirectional_over_other_layers_matches_jax(inner):
    layer = {"gru": jax_layers.Bidirectional(jax_layers.GRU(units=6)),
             "graves_last_step": jax_layers.graves_bidirectional_lstm(
                 6, merge="add", return_sequences=False),
             "simple_rnn": jax_layers.Bidirectional(
                 jax_layers.SimpleRnn(units=5), merge="average")}[inner]
    _check_layer(layer, [_rand(12, N, 7, 5)])


def test_graves_bidirectional_lstm_composes_like_jax():
    from deeplearning4j_tpu_torch.nn.layers import graves_bidirectional_lstm

    # the backend named: the two packages' defaults differ by design
    got = graves_bidirectional_lstm(6, merge="mul", forget_bias=0.5,
                                    backend="xla")
    assert nnconfig.config_to_dict(got) == jax_config.config_to_dict(
        jax_layers.graves_bidirectional_lstm(6, merge="mul",
                                             forget_bias=0.5))


@pytest.mark.parametrize("masked", [False, True])
def test_last_time_step_matches_jax(masked):
    _check_layer(jax_layers.LastTimeStep(), [_rand(13, N, 6, 5)],
                 mask=_mask([6, 2, 0], 6) if masked else None)


@pytest.mark.parametrize("kw", [{"units": 7},
                                {"units": 5, "activation": "relu",
                                 "return_sequences": False}])
def test_simple_rnn_matches_jax(kw):
    _check_layer(jax_layers.SimpleRnn(**kw), [_rand(14, N, 6, 4)])


# -- ops/rnn ------------------------------------------------------------------

def test_reverse_sequence_matches_jax():
    x = _rand(15, 4, 6, 3)
    lengths = np.array([6, 3, 1, 0], np.int32)
    got = opsrnn.reverse_sequence(torch.tensor(x), torch.tensor(lengths))
    want = jax_rnn.reverse_sequence(jnp.asarray(x), jnp.asarray(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("reverse", [False, True])
def test_simple_rnn_op_matches_jax(reverse):
    x, wx, wh, b, h0 = (_rand(16, 3, 5, 4), _rand(17, 4, 6),
                        0.3 * _rand(18, 6, 6), _rand(19, 6), _rand(20, 3, 6))
    got, hT = opsrnn.simple_rnn(*map(torch.tensor, (x, wx, wh, b, h0)),
                                reverse=reverse)
    want, jhT = jax_rnn.simple_rnn(*map(jnp.asarray, (x, wx, wh, b, h0)),
                                   reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jhT), atol=TOL)


@pytest.mark.parametrize("merge", ["concat", "add", "mul", "average"])
def test_bidirectional_lstm_op_matches_jax(merge):
    x = _rand(21, 3, 6, 4)
    pf = (_rand(22, 4, 20), 0.3 * _rand(23, 5, 20), _rand(24, 20))
    pb = (_rand(25, 4, 20), 0.3 * _rand(26, 5, 20), _rand(27, 20))
    out, (sf, sb) = opsrnn.bidirectional_lstm(
        torch.tensor(x), [torch.tensor(a) for a in pf],
        [torch.tensor(a) for a in pb], merge=merge, forget_bias=1.0)
    jout, (jsf, jsb) = jax_rnn.bidirectional_lstm(
        jnp.asarray(x), [jnp.asarray(a) for a in pf],
        [jnp.asarray(a) for a in pb], merge=merge, forget_bias=1.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)
    for got, want in ((sf, jsf), (sb, jsb)):
        np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h),
                                   atol=TOL)
        np.testing.assert_allclose(got.c.numpy(), np.asarray(want.c),
                                   atol=TOL)


# -- the arg-taking vertices ----------------------------------------------------

# kind → (args, input shapes by name)
VERTEX_CASES = {
    "subset": ({"from": 1, "to": 3}, {"x": (6,)}),
    "stack": ({}, {"x": (5,), "y": (5,)}),
    "unstack": ({"from": 1, "of": 2}, {"x": (5,)}),
    "l2norm": ({"eps": 1e-6}, {"x": (4, 5)}),
    "scale": ({"factor": 2.5}, {"x": (5,)}),
    "shift": ({"shift": -0.5}, {"x": (5,)}),
    "reshape": ({"shape": [3, 2]}, {"x": (6,)}),
    "last_timestep": ({}, {"x": (4, 5)}),
    "last_timestep_masked": ({}, {"x": (4, 5), "m": (4,)}),
    "duplicate_to_timeseries": ({}, {"x": (5,), "s": (4, 3)}),
    "reverse_timeseries": ({}, {"x": (4, 5)}),
}


@pytest.mark.parametrize("case", sorted(VERTEX_CASES))
def test_vertex_kind_matches_jax(case):
    args, shapes = VERTEX_CASES[case]
    kind = case.replace("_masked", "")

    def cfg(pkg):
        v = {"a": pkg.GraphVertex(kind=kind, inputs=list(shapes),
                                  args=args)}
        return pkg.GraphConfig(net=pkg.NeuralNetConfiguration(seed=0),
                               inputs=list(shapes), input_shapes=shapes,
                               vertices=v, outputs=["a"])

    jm = JaxGraphModel(cfg(jax_config))
    pm = GraphModel(nnconfig.GraphConfig.from_json(jm.config.to_json()),
                    device="cpu")
    assert pm.shapes == {k: tuple(s) for k, s in jm.shapes.items()}
    xs = {k: _rand(30 + i, 4, *s) for i, (k, s) in enumerate(shapes.items())}
    if "m" in xs:
        xs["m"] = _mask([4, 2, 1, 0], 4)
    if case == "l2norm":
        xs["x"][0, 1] = 0.0  # a zero row: the safe norm's finite gradient
    feats = [k for k in xs if k != "m"]

    def jfwd(fx):
        return jm.apply({"params": {}, "state": {}}, {**xs, **fx})[0]["a"]

    want = np.asarray(jfwd({k: jnp.asarray(xs[k]) for k in feats}))
    t = {k: torch.tensor(a, requires_grad=k != "m") for k, a in xs.items()}
    got = pm.apply({"params": {}, "state": {}}, t)[0]["a"]
    assert tuple(got.shape) == want.shape
    assert tuple(got.shape[1:]) == pm.shapes["a"]
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL)
    w = _rand(40, *want.shape)
    jg = jax.grad(lambda fx: jnp.sum(jfwd(fx) * w))(
        {k: jnp.asarray(xs[k]) for k in feats})
    tg = torch.autograd.grad((got * torch.tensor(w)).sum(),
                             [t[k] for k in feats], allow_unused=True)
    for k, g in zip(feats, tg):
        g = torch.zeros_like(t[k]) if g is None else g  # shape-only input
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   atol=TOL_GRAD)


def test_multi_input_protocol_is_all_or_nothing():
    class Half(nnconfig.LayerConfig):
        def apply_multi(self, *a, **k):
            raise AssertionError

    v = {"a": nnconfig.GraphVertex(kind="layer", inputs=["x", "y"],
                                   layer=Half())}
    cfg = nnconfig.GraphConfig(net=nnconfig.NeuralNetConfiguration(),
                               inputs=["x", "y"],
                               input_shapes={"x": (3,), "y": (3,)},
                               vertices=v, outputs=["a"])
    with pytest.raises(TypeError, match="all-or-nothing"):
        GraphModel(cfg, device="cpu")


# -- the flash wrapper's head-size padding ------------------------------------

def test_kernel_head_size_is_the_next_kernel_size():
    assert [fa.kernel_head_size(d) for d in (1, 16, 32, 33, 48, 64, 100,
                                             128)] == [32, 32, 32, 64, 64,
                                                       64, 128, 128]
    with pytest.raises(ValueError, match="limit of 128"):
        fa.kernel_head_size(160)


def _attention_inputs(d, seed=50):
    r = np.random.default_rng(seed)
    return [torch.tensor(r.standard_normal((2, 3, 10, d)).astype(
        np.float32), requires_grad=True) for _ in range(3)]


@pytest.mark.parametrize("d", [16, 48])
@pytest.mark.parametrize("causal,lengths", [(False, None),
                                            (True, [10, 6])])
@pytest.mark.parametrize("stand_in", ["reference_attention",
                                      "flash_autograd"])
def test_padded_head_matches_unpadded_plain_attention(d, causal, lengths,
                                                      stand_in):
    """``pad_head`` with the plain attention in the kernels' place (the
    plain forward, or the CPU route of the flash autograd function with
    its plain backward): the output and the gradients of q, k and v at D
    against the unpadded plain attention, and the output against the JAX
    package's attention at D (the scale of the original D)."""
    mask = (None if lengths is None
            else torch.tensor(_mask(lengths, 10)))

    def attend(q, k, v, scale):
        assert q.shape[-1] == fa.kernel_head_size(d) and q.is_contiguous()
        if stand_in == "reference_attention":
            return fa.reference_attention(q, k, v, causal=causal,
                                          key_mask=mask, scale=scale)
        return fa._FlashAttention.apply(q, k, v, mask, causal, scale)

    q, k, v = _attention_inputs(d)
    got = fa.pad_head(attend, q, k, v)
    want = fa.reference_attention(q, k, v, causal=causal, key_mask=mask)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(),
                               want.detach().numpy(), atol=TOL)
    jax_out = jax_fa.flash_attention(
        *(jnp.asarray(x.detach().numpy()) for x in (q, k, v)),
        causal=causal,
        key_mask=None if mask is None else jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jax_out),
                               atol=TOL)
    dout = torch.tensor(_rand(51, *got.shape))
    g_got = torch.autograd.grad(got, (q, k, v), dout)
    g_want = torch.autograd.grad(want, (q, k, v), dout)
    for a, b in zip(g_got, g_want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL_GRAD)


def test_a_head_size_the_kernels_have_is_not_padded():
    q, k, v = _attention_inputs(32)
    calls = []
    fa.pad_head(lambda *a: calls.append(a[0].shape) or a[0], q, k, v)
    assert calls == [q.shape]
