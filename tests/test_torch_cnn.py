"""The port's CNN ops and layers against the JAX package's, on the CPU.

``ops/cnn.py`` (conv2d, the pools, the global pools), the conv, pooling,
activation and BatchNorm layers, ``batch_norm_inference`` and the relu
initializers, each fed the same seeded numpy inputs as its JAX
counterpart (jitted). float32 on both sides, sums in another order:
outputs to 1e-5 of max(1, max |JAX|); bf16 BatchNorm outputs to 2^-6 of
their max (both round each result to bf16, at other points), its float32
statistics to 1e-5. The cases include XLA's asymmetric SAME padding at
ResNet-50's shapes: the 7×7/2 stem on 224 pads (2, 3), a 3×3/2 conv on 56
pads (0, 1), the 3×3/2 SAME max pool on 112 pads (0, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as jax_layers
from deeplearning4j_tpu.ops import cnn as jax_cnn
from deeplearning4j_tpu.ops import nn as jax_nn
from deeplearning4j_tpu_torch.nn import initializers
from deeplearning4j_tpu_torch.nn import layers
from deeplearning4j_tpu_torch.ops import cnn
from deeplearning4j_tpu_torch.ops import nn as opsnn

TOL = 1e-5
TOL_BF16 = 2.0 ** -6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rand(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale


# (N, H, W, Cin, Cout, kernel, stride, padding, dilation, groups)
CONV_CASES = [
    (2, 9, 9, 3, 4, 3, 1, "SAME", 1, 1),
    (2, 8, 8, 3, 4, 3, 1, "SAME", 1, 1),
    (2, 9, 8, 3, 5, 3, 2, "SAME", 1, 1),
    (2, 8, 9, 3, 5, 4, 2, "SAME", 1, 1),
    (2, 9, 9, 3, 4, 3, 1, "VALID", 1, 1),
    (2, 10, 9, 3, 4, 3, 2, "VALID", 1, 1),
    (2, 9, 9, 3, 4, 3, 1, 1, 1, 1),
    (2, 9, 10, 3, 4, (3, 5), (2, 1), (1, 2), 1, 1),
    (2, 11, 11, 3, 4, 3, 1, "SAME", 2, 1),
    (2, 11, 11, 3, 4, 3, 2, "VALID", (2, 1), 1),
    (2, 8, 8, 4, 6, 3, 1, "SAME", 1, 2),
    (2, 9, 9, 6, 6, 3, 2, "SAME", 1, 3),
    # ResNet-50's asymmetric SAME paddings, at full spatial size
    (1, 224, 224, 3, 4, 7, 2, "SAME", 1, 1),
    (1, 56, 56, 4, 4, 3, 2, "SAME", 1, 1),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv2d_matches_jax(case):
    n, h, w, cin, cout, k, s, pad, d, g = case
    kh, kw = (k, k) if isinstance(k, int) else k
    x = _rand(0, (n, h, w, cin))
    wt = _rand(1, (kh, kw, cin // g, cout)) / np.float32(
        np.sqrt(kh * kw * cin))
    b = _rand(2, (cout,))
    want = jax.jit(lambda x, wt, b: jax_cnn.conv2d(
        x, wt, b, stride=s, padding=pad, dilation=d,
        feature_group_count=g))(x, wt, b)
    got = cnn.conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                     torch.from_numpy(b), stride=s, padding=pad, dilation=d,
                     feature_group_count=g)
    _close(got, want)


def test_conv2d_nchw_and_the_stem_gradient_match_jax():
    """NCHW layout, and the gradients through the stem's asymmetric
    padding (the padded copy must route them back to the input)."""
    x = _rand(3, (2, 3, 16, 16))
    wt = _rand(4, (7, 7, 3, 4)) / 12
    want = jax.jit(lambda x, wt: jax_cnn.conv2d(
        x, wt, stride=2, padding="SAME", data_format="NCHW"))(x, wt)
    _close(cnn.conv2d(torch.from_numpy(x), torch.from_numpy(wt), stride=2,
                      padding="SAME", data_format="NCHW"), want)

    xh = _rand(5, (2, 16, 16, 3))
    dy = _rand(6, (2, 8, 8, 4))
    jgx, jgw = jax.jit(jax.grad(lambda x, wt: jnp.sum(jax_cnn.conv2d(
        x, wt, stride=2, padding="SAME") * dy), argnums=(0, 1)))(xh, wt)
    tx = torch.from_numpy(xh).requires_grad_()
    tw = torch.from_numpy(wt).requires_grad_()
    y = cnn.conv2d(tx, tw, stride=2, padding="SAME")
    gx, gw = torch.autograd.grad(torch.sum(y * torch.from_numpy(dy)),
                                 [tx, tw])
    _close(gx, jgx)
    _close(gw, jgw)


@pytest.mark.parametrize("size,k,s,want", [
    (224, 7, 2, (2, 3)),   # the stem conv
    (56, 3, 2, (0, 1)),    # a stage's first 3×3/2
    (112, 3, 2, (0, 1)),   # the stem max pool
    (28, 5, 1, (2, 2)),    # LeNet's convs
    (7, 3, 1, (1, 1)),
    (8, 1, 2, (0, 0)),
])
def test_same_padding_is_xlas(size, k, s, want):
    assert cnn._same_pads(size, k, s, 1) == want
    lo, hi = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert (lo, hi) == want


# (N, H, W, C, window, stride, padding)
POOL_CASES = [
    (2, 8, 8, 3, 2, None, "VALID"),
    (2, 9, 9, 3, 2, None, "VALID"),
    (2, 9, 9, 3, 3, 2, "VALID"),
    (2, 8, 8, 3, 3, 2, "SAME"),
    (2, 9, 9, 3, 3, 2, "SAME"),
    (2, 9, 8, 3, (3, 2), (2, 1), "SAME"),
    (2, 7, 7, 3, 2, 1, "SAME"),
    (2, 9, 9, 3, 3, 1, 1),
    (2, 10, 9, 3, (3, 2), 2, (1, 1)),
    (1, 112, 112, 2, 3, 2, "SAME"),
]


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_pooling_matches_jax(kind, case):
    n, h, w, c, win, s, pad = case
    x = _rand(7, (n, h, w, c))
    jl = jax_layers.Pooling2D(pool_type=kind, window=win, stride=s,
                              padding=pad)
    pl = layers.Pooling2D(pool_type=kind, window=win, stride=s, padding=pad)
    want = jax.jit(lambda x: jl.apply({}, {}, x)[0])(x)
    got, _ = pl.apply({}, {}, torch.from_numpy(x))
    _close(got, want)
    assert pl.output_shape((h, w, c)) == jl.output_shape((h, w, c)) \
        == tuple(got.shape[1:])


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_avg_pool_counts_only_real_elements_like_jax(fmt):
    x = _rand(8, (2, 9, 9, 3) if fmt == "NHWC" else (2, 3, 9, 9))
    want = jax.jit(lambda x: jax_cnn.avg_pool2d(
        x, 3, 2, "SAME", data_format=fmt))(x)
    got = cnn.avg_pool2d(torch.from_numpy(x), 3, 2, "SAME", data_format=fmt)
    _close(got, want)
    # a corner window of a constant image averages to the constant
    ones = cnn.avg_pool2d(torch.ones(1, 9, 9, 1), 3, 2, "SAME")
    assert torch.allclose(ones, torch.ones_like(ones))


@pytest.mark.parametrize("kind", ["avg", "max", "sum"])
@pytest.mark.parametrize("keepdims", [False, True])
def test_global_pooling_matches_jax(kind, keepdims):
    x = _rand(9, (2, 5, 6, 4))
    jl = jax_layers.GlobalPooling(pool_type=kind, keepdims=keepdims)
    pl = layers.GlobalPooling(pool_type=kind, keepdims=keepdims)
    _close(pl.apply({}, {}, torch.from_numpy(x))[0],
           jl.apply({}, {}, x)[0])
    assert pl.output_shape((5, 6, 4)) == jl.output_shape((5, 6, 4))
    if kind != "sum":
        fn = cnn.global_avg_pool if kind == "avg" else cnn.global_max_pool
        jfn = (jax_cnn.global_avg_pool if kind == "avg"
               else jax_cnn.global_max_pool)
        _close(fn(torch.from_numpy(x), keepdims=keepdims),
               jfn(x, keepdims=keepdims))


@pytest.mark.parametrize("cfg", [
    dict(filters=5, kernel=3, stride=2, padding="SAME"),
    dict(filters=5, kernel=(3, 1), stride=(1, 2), padding="VALID",
         activation="relu"),
    dict(filters=6, kernel=3, padding=(1, 2), dilation=2, groups=3,
         use_bias=False),
], ids=str)
def test_conv2d_layer_matches_jax(cfg):
    jl, pl = jax_layers.Conv2D(**cfg), layers.Conv2D(**cfg)
    in_shape = (10, 11, 6)
    assert pl.output_shape(in_shape) == jl.output_shape(in_shape)
    jp, _ = jl.init(jax.random.key(0), in_shape, jnp.float32)
    pp, _ = pl.init(torch.Generator().manual_seed(0), in_shape,
                    torch.float32)
    assert {k: v.shape for k, v in jp.items()} == {
        k: tuple(v.shape) for k, v in pp.items()}
    params = {k: np.array(v) for k, v in jp.items()}
    if "b" in params:
        params["b"] = _rand(10, params["b"].shape)
    x = _rand(11, (2, *in_shape))
    want = jax.jit(lambda p, x: jl.apply(p, {}, x)[0])(params, x)
    got, _ = pl.apply({k: torch.from_numpy(v) for k, v in params.items()},
                      {}, torch.from_numpy(x))
    _close(got, want)
    assert tuple(got.shape[1:]) == pl.output_shape(in_shape)


@pytest.mark.parametrize("act,alpha", [("relu", None), ("tanh", None),
                                       ("leakyrelu", 0.2), ("elu", 0.5),
                                       ("thresholdedrelu", 0.3)])
def test_activation_layer_matches_jax(act, alpha):
    x = _rand(12, (3, 4, 5))
    want = jax_layers.ActivationLayer(activation=act, alpha=alpha).apply(
        {}, {}, x)[0]
    got, _ = layers.ActivationLayer(activation=act, alpha=alpha).apply(
        {}, {}, torch.from_numpy(x))
    _close(got, want)


def _bn_case(dtype, seed):
    x = (3.0 + 2.0 * _rand(seed, (4, 5, 6, 8)))
    params = {"gamma": 1.0 + 0.1 * _rand(seed + 1, (8,)),
              "beta": 0.1 * _rand(seed + 2, (8,))}
    state = {"mean": 0.5 * _rand(seed + 3, (8,)),
             "var": 1.0 + np.abs(_rand(seed + 4, (8,)))}
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jx = jnp.asarray(x).astype(jd)
    jp = {k: jnp.asarray(v).astype(jd) for k, v in params.items()}
    tx = torch.from_numpy(x).to(td)
    tp = {k: torch.from_numpy(v).to(td) for k, v in params.items()}
    ts = {k: torch.from_numpy(v) for k, v in state.items()}
    return (jx, jp, state), (tx, tp, ts)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(dtype, train):
    """Training: one-pass float32 statistics, the biased variance and the
    decay update of the running state (float32 whatever the compute
    dtype); inference: ``batch_norm_inference`` on the running state."""
    (jx, jp, jst), (tx, tp, tst) = _bn_case(dtype, 20)
    jl = jax_layers.BatchNorm(momentum=0.9, activation="relu")
    pl = layers.BatchNorm(momentum=0.9, activation="relu")
    jy, jnew = jax.jit(lambda p, s, x: jl.apply(p, s, x, train=train))(
        jp, jst, jx)
    ty, tnew = pl.apply(tp, tst, tx, train=train)
    assert ty.dtype == tx.dtype
    _close(ty, np.asarray(jy, np.float32),
           TOL if dtype == "fp32" else TOL_BF16)
    for k in ("mean", "var"):
        assert tnew[k].dtype == torch.float32
        _close(tnew[k], jnew[k])
    if train:
        xf = tx.float().reshape(-1, 8)
        want_var = 0.9 * tst["var"] + 0.1 * xf.var(0, unbiased=False)
        assert torch.allclose(tnew["var"], want_var, rtol=1e-5)
    else:
        assert tnew is tst


def test_batchnorm_init_and_inference_op_match_jax():
    jp, js = jax_layers.BatchNorm().init(jax.random.key(0), (3, 3, 4),
                                         jnp.float32)
    tp, ts = layers.BatchNorm().init(None, (3, 3, 4), torch.float32)
    for j, t in ((jp, tp), (js, ts)):
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    x, m, v = _rand(30, (2, 3, 4)), _rand(31, (4,)), 1 + np.abs(
        _rand(32, (4,)))
    g, b = _rand(33, (4,)), _rand(34, (4,))
    t = [torch.from_numpy(a) for a in (x, m, v, g, b)]
    _close(opsnn.batch_norm_inference(*t, eps=1e-3),
           jax_nn.batch_norm_inference(x, m, v, g, b, eps=1e-3))
    _close(opsnn.batch_norm_inference(t[0], t[1], t[2], None, None),
           jax_nn.batch_norm_inference(x, m, v, None, None))


@pytest.mark.parametrize("name,std", [("relu", np.sqrt(2 / 72)),
                                      ("relu_uniform", np.sqrt(2 / 72)),
                                      ("he_normal", np.sqrt(2 / 72))])
def test_relu_initializers_draw_he_scaled_weights(name, std):
    """He init over fan_in = kh·kw·Cin (HWIO): normal N(0, 2/fan_in),
    uniform U(±sqrt(6/fan_in)), whose std is the same."""
    w = initializers.get_initializer(name)(
        (3, 3, 8, 4096), torch.Generator().manual_seed(0), torch.float32)
    assert w.shape == (3, 3, 8, 4096) and w.dtype == torch.float32
    assert abs(float(w.std()) / std - 1) < 0.02
    if name == "relu_uniform":
        assert float(w.abs().max()) <= np.sqrt(6 / 72)
