"""The rest of the port's CNN ops and layers against the JAX package's, on the CPU.

Every op ``ops/cnn.py`` gained (conv1d/3d, the transposed convs, the
patches, depthwise and separable convs, the 3-D pools, upsampling and the
space/batch reshuffles), ``ops/nn.lrn``, the new losses, every layer of
``nn/layers/conv.py`` the port lacked, ``LayerNorm``,
``LocalResponseNormalization``, ``Dropout``, the loss layers and
``PixelOutput``: each fed the same seeded numpy inputs as its JAX
counterpart (jitted), a layer with the JAX package's variables (every
leaf drawn from the seed, biases and scales included) carried across.
float32 on both sides, sums in another order: outputs to 1e-5 of the
output's max (the reshuffles, ``im2col`` and the patches bit for bit or to
1e-6); input and param gradients of Σ y·c for a random cotangent c to
1e-4 of each leaf's max; losses to 1e-5 relative. The transposed convs
over kernel 1–4, stride 1–3, SAME and VALID and odd sizes (the JAX
kernel is not flipped). Dropout's random kinds are checked by their
statistics over 10^5 draws (jax and torch draw other numbers).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import pixel as jax_pixel
from deeplearning4j_tpu.nn import layers as jax_layers
from deeplearning4j_tpu.ops import cnn as jax_cnn
from deeplearning4j_tpu.ops import loss as jax_loss
from deeplearning4j_tpu.ops import nn as jax_nn
from deeplearning4j_tpu_torch.models.zoo import pixel
from deeplearning4j_tpu_torch.nn import config as nnconfig
from deeplearning4j_tpu_torch.nn import layers
from deeplearning4j_tpu_torch.ops import cnn
from deeplearning4j_tpu_torch.ops import loss
from deeplearning4j_tpu_torch.ops import nn as opsnn

TOL = 1e-5
TOL_GRAD = 1e-4
TOL_EXACT = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(float(np.abs(want).max()),
                                                 1e-30)


# --- ops -----------------------------------------------------------------

DECONV_GRID = list(itertools.product((1, 2, 3, 4), (1, 2, 3),
                                     ("SAME", "VALID")))


@pytest.mark.parametrize("k,s,padding", DECONV_GRID)
def test_deconv2d_is_lax_conv_transpose_unflipped(k, s, padding):
    x = _rand(1, (2, 5, 7, 3))
    w = _rand(2, (k, k + 1, 3, 4))
    b = _rand(3, (4,))
    want = jax.jit(lambda x, w, b: jax_cnn.deconv2d(
        x, w, b, stride=s, padding=padding))(x, w, b)
    _close(cnn.deconv2d(_t(x), _t(w), _t(b), stride=s, padding=padding),
           want)
    want = jax_cnn.deconv2d(x.transpose(0, 3, 1, 2), w, None, stride=(s, 1),
                            padding=padding, data_format="NCHW")
    _close(cnn.deconv2d(_t(x.transpose(0, 3, 1, 2)), _t(w), None,
                        stride=(s, 1), padding=padding, data_format="NCHW"),
           want)


@pytest.mark.parametrize("k,s,padding", DECONV_GRID)
def test_deconv3d_is_lax_conv_transpose_unflipped(k, s, padding):
    x = _rand(4, (1, 3, 5, 4, 2))
    w = _rand(5, (k, 2, k, 2, 3))
    b = _rand(6, (3,))
    want = jax.jit(lambda x, w, b: jax_cnn.deconv3d(
        x, w, b, stride=(s, 1, s), padding=padding))(x, w, b)
    _close(cnn.deconv3d(_t(x), _t(w), _t(b), stride=(s, 1, s),
                        padding=padding), want)


def test_deconv_orientation_and_explicit_padding():
    """A one-hot input shows the kernel unflipped (JAX [[3, 2], [1, 0]]
    around the centre, where F.conv_transpose2d gives [[0, 1], [2, 3]]);
    explicit padding pads the dilated input as it is."""
    x = np.zeros((1, 3, 3, 1), np.float32)
    x[0, 1, 1, 0] = 1.0
    w = np.arange(4, dtype=np.float32).reshape(2, 2, 1, 1)
    got = cnn.deconv2d(_t(x), _t(w), stride=1, padding="VALID")
    np.testing.assert_array_equal(got[0, 1:3, 1:3, 0].numpy(),
                                  [[3, 2], [1, 0]])
    _close(got, jax_cnn.deconv2d(x, w, stride=1, padding="VALID"))
    x = _rand(7, (2, 4, 5, 3))
    w = _rand(8, (3, 3, 3, 2))
    for p in (0, 1, 2, (2, 0)):
        _close(cnn.deconv2d(_t(x), _t(w), stride=2, padding=p),
               jax_cnn.deconv2d(x, w, stride=2, padding=p))


def test_deconv_layers_valid_shape_gap_is_the_jax_packages():
    """Deconv2D/Deconv3D keep the JAX output_shape: (h − 1)·s + k under
    VALID, while the transposed conv computes h·s + max(k − s, 0). With h
    = 5, k = 1, s = 2 the layer declares 9 and computes 10 in both
    packages; k >= s agrees."""
    for pkg_layers, run in ((jax_layers, lambda l, p, x: np.asarray(
            l.apply(p, {}, x)[0])), (layers, lambda l, p, x: l.apply(
            {n: _t(a) for n, a in p.items()}, {}, _t(x))[0].numpy())):
        for cls, shape in ((pkg_layers.Deconv2D, (5, 5, 2)),
                           (pkg_layers.Deconv3D, (5, 5, 5, 2))):
            layer = cls(filters=3, kernel=1, stride=2, padding="VALID")
            assert layer.output_shape(shape)[:-1] == (9,) * (len(shape) - 1)
            x = _rand(9, (1, *shape))
            p = {"W": _rand(10, (*(1,) * (len(shape) - 1), 2, 3)),
                 "b": np.zeros(3, np.float32)}
            assert run(layer, p, x).shape[1:-1] == (10,) * (len(shape) - 1)
            agree = cls(filters=3, kernel=3, stride=2, padding="VALID")
            p["W"] = _rand(11, (*(3,) * (len(shape) - 1), 2, 3))
            assert run(agree, p, x).shape[1:] == agree.output_shape(shape)


CONV1D_CASES = [(3, 1, "SAME", 1), (3, 2, "SAME", 2), (4, 2, "VALID", 1),
                (3, 1, 2, 2), (1, 3, "SAME", 1)]


@pytest.mark.parametrize("k,s,padding,d", CONV1D_CASES)
def test_conv1d_matches_jax(k, s, padding, d):
    x, w, b = _rand(12, (2, 11, 3)), _rand(13, (k, 3, 5)), _rand(14, (5,))
    want = jax.jit(lambda x, w, b: jax_cnn.conv1d(
        x, w, b, stride=s, padding=padding, dilation=d))(x, w, b)
    _close(cnn.conv1d(_t(x), _t(w), _t(b), stride=s, padding=padding,
                      dilation=d), want)


CONV3D_CASES = [((3, 3, 3), 1, "SAME", 1), ((2, 3, 1), (1, 2, 2), "SAME", 1),
                ((3, 2, 3), 2, "VALID", 1), ((3, 3, 3), 1, 1, 2),
                ((2, 2, 2), (2, 1, 2), (1, 0, 1), 1)]


@pytest.mark.parametrize("k,s,padding,d", CONV3D_CASES)
def test_conv3d_matches_jax(k, s, padding, d):
    x, w = _rand(15, (2, 5, 6, 7, 3)), _rand(16, (*k, 3, 4))
    b = _rand(17, (4,))
    want = jax.jit(lambda x, w, b: jax_cnn.conv3d(
        x, w, b, stride=s, padding=padding, dilation=d))(x, w, b)
    _close(cnn.conv3d(_t(x), _t(w), _t(b), stride=s, padding=padding,
                      dilation=d), want)


PATCH_CASES = [(3, 1, "VALID", 1), (3, 2, "SAME", 1), (2, 2, "SAME", 1),
               (3, 1, 1, 2), ((2, 3), (1, 2), "VALID", 1),
               (3, 2, "SAME", 2)]


@pytest.mark.parametrize("k,s,padding,d", PATCH_CASES)
def test_extract_patches2d_matches_jax(k, s, padding, d):
    x = _rand(18, (2, 7, 9, 3))
    want = jax.jit(lambda x: jax_cnn.extract_patches2d(
        x, k, stride=s, padding=padding, dilation=d))(x)
    _close(cnn.extract_patches2d(_t(x), k, stride=s, padding=padding,
                                 dilation=d), want, TOL_EXACT)


@pytest.mark.parametrize("k,s,p,d", [(3, 1, 0, 1), (2, 2, 1, 1),
                                     ((3, 2), (2, 1), (1, 0), 2)])
def test_im2col_is_kernel_position_major_like_jax(k, s, p, d):
    x = _rand(19, (2, 7, 8, 3))
    got = cnn.im2col(_t(x), k, s, p, d)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_cnn.im2col(x, k, s, p, d)))
    # the same patches as extract_patches2d, in the other channel order
    if p == 0:
        kh, kw = cnn._pair(k)
        cm = cnn.extract_patches2d(_t(x), k, stride=s, dilation=d)
        n, oh, ow, _ = cm.shape
        np.testing.assert_array_equal(
            cm.reshape(n, oh, ow, 3, kh * kw).transpose(-1, -2).reshape(
                n, oh, ow, -1).numpy(), got.numpy())


@pytest.mark.parametrize("k,s,padding,mult", [
    (3, 1, "SAME", 1), (3, 2, "SAME", 2), (5, 2, "VALID", 3),
    (1, 1, "SAME", 2)])
def test_depthwise_and_separable_convs_match_jax(k, s, padding, mult):
    x = _rand(20, (2, 9, 8, 4))
    dw, b = _rand(21, (k, k, 4, mult)), _rand(22, (4 * mult,))
    pw, pb = _rand(23, (1, 1, 4 * mult, 6)), _rand(24, (6,))
    want = jax.jit(lambda x, w, b: jax_cnn.depthwise_conv2d(
        x, w, b, stride=s, padding=padding))(x, dw, b)
    _close(cnn.depthwise_conv2d(_t(x), _t(dw), _t(b), stride=s,
                                padding=padding), want)
    want = jax.jit(lambda x, dw, pw, b: jax_cnn.separable_conv2d(
        x, dw, pw, b, stride=s, padding=padding))(x, dw, pw, pb)
    _close(cnn.separable_conv2d(_t(x), _t(dw), _t(pw), _t(pb), stride=s,
                                padding=padding), want)
    with pytest.raises(ValueError, match="channel dim"):
        cnn.depthwise_conv2d(_t(x), _t(_rand(25, (k, k, 3, mult))))


@pytest.mark.parametrize("op", ["max_pool3d", "avg_pool3d"])
@pytest.mark.parametrize("window,stride,padding", [
    (2, None, "VALID"), (3, 2, "SAME"), ((2, 3, 2), (1, 2, 2), "SAME"),
    (3, 1, 1)])
def test_3d_pools_match_jax(op, window, stride, padding):
    """avg_pool3d divides by the whole window under SAME and explicit
    padding too, as the JAX package's does."""
    x = _rand(26, (2, 5, 6, 7, 3))
    want = jax.jit(lambda x: getattr(jax_cnn, op)(
        x, window, stride, padding))(x)
    _close(getattr(cnn, op)(_t(x), window, stride, padding), want,
           TOL_EXACT)


def test_avg_pool3d_same_divides_by_the_whole_window():
    x = np.ones((1, 3, 3, 3, 1), np.float32)
    got = cnn.avg_pool3d(_t(x), 2, 2, "SAME").numpy()
    # the last window of each dim holds one real element: corner 1/8
    assert got[0, 1, 1, 1, 0] == pytest.approx(1 / 8)
    np.testing.assert_array_equal(
        got, np.asarray(jax_cnn.avg_pool3d(x, 2, 2, "SAME")))


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_upsampling2d_matches_jax(fmt):
    x = _rand(27, (2, 3, 4, 5))
    np.testing.assert_array_equal(
        cnn.upsampling2d(_t(x), (2, 3), fmt).numpy(),
        np.asarray(jax_cnn.upsampling2d(x, (2, 3), fmt)))


@pytest.mark.parametrize("b", [2, 3])
def test_space_to_depth_round_trips_and_matches_jax(b):
    """The packed channel is (bh, bw, c), as in the JAX package, which is
    not F.pixel_unshuffle's (c, bh, bw)."""
    x = _rand(28, (2, 6 * b // 2, 4 * b, 5))
    packed = cnn.space_to_depth(_t(x), b)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jax_cnn.space_to_depth(x, b)))
    np.testing.assert_array_equal(cnn.depth_to_space(packed, b).numpy(), x)
    np.testing.assert_array_equal(
        cnn.depth_to_space(_t(np.asarray(packed)), b).numpy(),
        np.asarray(jax_cnn.depth_to_space(np.asarray(packed), b)))
    assert packed[0, 0, 0, 1].item() == x[0, 0, 0, 1]  # c first
    assert packed[0, 0, 0, 5].item() == x[0, 0, 1, 0]  # then bw


@pytest.mark.parametrize("pads", [((0, 0), (0, 0)), ((1, 1), (0, 2)),
                                  ((2, 0), (1, 1))])
def test_space_to_batch_round_trips_and_matches_jax(pads):
    x = _rand(29, (2, 6, 4, 3))
    got = cnn.space_to_batch(_t(x), 2, pads)
    want = np.asarray(jax_cnn.space_to_batch(x, 2, pads))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cnn.batch_to_space(got, 2, pads).numpy(),
                                  x)
    np.testing.assert_array_equal(
        cnn.batch_to_space(got, 2, pads).numpy(),
        np.asarray(jax_cnn.batch_to_space(want, 2, pads)))


@pytest.mark.parametrize("radius,bias,alpha,beta", [
    (5, 1.0, 1e-4, 0.75),   # AlexNet's LocalResponseNormalization
    (2, 2.0, 0.5, 0.5), (5, 1.0, 1.0, 0.5)])
def test_lrn_matches_jax(radius, bias, alpha, beta):
    x = 3.0 * _rand(30, (2, 4, 5, 16))
    want = jax.jit(lambda x: jax_nn.lrn(x, radius, bias, alpha, beta))(x)
    _close(opsnn.lrn(_t(x), radius, bias, alpha, beta), want, TOL_EXACT)


@pytest.mark.parametrize("name", ["xent", "binary_cross_entropy",
                                  "binary_cross_entropy_probs", "mse"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses_match_jax(name, reduction):
    r = np.random.default_rng(31)
    pred = 4.0 * _rand(32, (6, 5))
    if name == "binary_cross_entropy_probs":
        pred = 1.0 / (1.0 + np.exp(-pred))
    labels = (r.random((6, 5)) < 0.4).astype(np.float32)
    w = r.random(6).astype(np.float32)
    for weights in (None, w):
        want = jax_loss.get_loss(name)(pred, labels, weights=weights,
                                       reduction=reduction)
        got = loss.get_loss(name)(_t(pred), _t(labels),
                                  weights=None if weights is None else
                                  _t(weights), reduction=reduction)
        _close(got, want)


def test_bce_gradient_at_a_zero_logit():
    """A difference by design: at a logit of exactly 0 the port's binary
    cross-entropy has the gradient σ(0) − y = 0.5 − y
    (``F.binary_cross_entropy_with_logits``); the JAX package's
    max(l, 0) − l·y + log1p(exp(−|l|)) differentiates to −y there
    (``maximum``'s tie gives 0.5, ``abs``'s 1). Elsewhere both are
    σ(l) − y, and the values agree everywhere."""
    labels = np.array([[0.0], [1.0], [0.0], [1.0]], np.float32)
    logits = np.array([[0.0], [0.0], [0.7], [-1.3]], np.float32)
    jg = np.asarray(jax.grad(lambda l: jax_loss.binary_cross_entropy(
        l, labels, reduction="sum"))(logits))
    tl = _t(logits).requires_grad_()
    value = loss.binary_cross_entropy(tl, _t(labels), reduction="sum")
    value.backward()
    sig = 1.0 / (1.0 + np.exp(-logits))
    np.testing.assert_allclose(tl.grad.numpy(), sig - labels, atol=1e-7)
    np.testing.assert_allclose(jg[:2], -labels[:2])
    np.testing.assert_allclose(jg[2:], (sig - labels)[2:], atol=1e-7)
    assert float(value.detach()) == pytest.approx(float(
        jax_loss.binary_cross_entropy(logits, labels, reduction="sum")),
        rel=TOL)


# --- layers --------------------------------------------------------------

# (class name, kwargs, batchless input shape)
LAYER_CASES = [
    ("Conv1D", dict(filters=4, kernel=3, stride=2, activation="tanh"),
     (9, 3)),
    ("Conv1D", dict(filters=4, kernel=3, padding=1, dilation=2), (9, 3)),
    ("Conv3D", dict(filters=4, kernel=(2, 3, 2), stride=(1, 2, 1)),
     (4, 5, 6, 3)),
    ("Conv3D", dict(filters=3, kernel=3, padding="VALID",
                    activation="relu"), (4, 5, 6, 2)),
    ("Deconv2D", dict(filters=4, kernel=3, stride=2), (5, 6, 3)),
    ("Deconv2D", dict(filters=4, kernel=3, stride=2, padding="VALID",
                      activation="tanh"), (5, 6, 3)),
    ("DepthwiseConv2D", dict(depth_multiplier=2, kernel=3, stride=2),
     (7, 7, 3)),
    ("SeparableConv2D", dict(filters=5, kernel=3, stride=2,
                             depth_multiplier=2), (7, 8, 3)),
    ("SeparableConv2D", dict(filters=6, kernel=3, use_bias=False),
     (6, 5, 4)),
    ("Upsampling2D", dict(scale=(2, 3)), (3, 4, 2)),
    ("ZeroPadding2D", dict(padding=(1, 2, 0, 3)), (3, 4, 2)),
    ("Cropping2D", dict(cropping=(1, 0, 2, 1)), (5, 6, 2)),
    ("SpaceToDepth", dict(block_size=2), (4, 6, 3)),
    ("Pooling1D", dict(pool_type="max", window=3, stride=2,
                       padding="SAME"), (9, 3)),
    ("Pooling1D", dict(pool_type="avg", window=2), (9, 3)),
    ("ZeroPadding1D", dict(padding=(1, 2)), (7, 3)),
    ("Cropping1D", dict(cropping=(1, 2)), (7, 3)),
    ("Upsampling1D", dict(size=3), (7, 3)),
    ("Deconv3D", dict(filters=3, kernel=2, stride=2), (3, 4, 5, 2)),
    ("Deconv3D", dict(filters=3, kernel=3, stride=(2, 1, 2),
                      padding="VALID"), (3, 4, 5, 2)),
    ("Pooling3D", dict(pool_type="max", window=2, padding="SAME"),
     (5, 4, 3, 2)),
    ("Pooling3D", dict(pool_type="avg", window=(2, 1, 2), stride=1,
                       padding="SAME"), (5, 4, 3, 2)),
    ("Upsampling3D", dict(scale=(1, 2, 3)), (2, 3, 4, 2)),
    ("ZeroPadding3D", dict(padding=(1, 0, 2, 1, 0, 1)), (2, 3, 4, 2)),
    ("Cropping3D", dict(cropping=(1, 0, 0, 1, 1, 0)), (4, 4, 5, 2)),
    ("DepthToSpace", dict(block_size=2), (3, 4, 8)),
    ("LocallyConnected2D", dict(filters=4, kernel=3), (6, 7, 3)),
    ("LocallyConnected2D", dict(filters=4, kernel=(2, 3), stride=2,
                                padding="SAME", activation="relu"),
     (6, 7, 3)),
    ("LocallyConnected1D", dict(filters=4, kernel=3, stride=2), (9, 3)),
    ("LocallyConnected1D", dict(filters=2, kernel=2, use_bias=False),
     (6, 3)),
    ("LayerNorm", dict(), (5, 6)),
    ("LayerNorm", dict(use_gamma_beta=False, eps=1e-3), (3, 4, 6)),
    ("LocalResponseNormalization", dict(), (3, 4, 16)),
    ("LocalResponseNormalization", dict(depth_radius=2, alpha=0.5,
                                        beta=0.5, bias=2.0), (3, 4, 6)),
    ("Dropout", dict(rate=0.5), (4, 5)),
    ("PixelOutput", dict(num_classes=1), (5, 6, 3)),
    ("PixelOutput", dict(num_classes=3), (5, 6, 3)),
]


def _case_id(case):
    return f"{case[0]}-{'-'.join(f'{k}={v}' for k, v in case[1].items())}"


def _layer_pair(name, kw):
    if name == "PixelOutput":
        return jax_pixel.PixelOutput(**kw), pixel.PixelOutput(**kw)
    return getattr(jax_layers, name)(**kw), getattr(layers, name)(**kw)


def _variables(jlayer, shape, seed):
    """The JAX init's tree with every leaf redrawn from the seed (real
    biases, scales and unshared weights)."""
    params, state = jlayer.init(jax.random.key(0), shape, jnp.float32)
    r = np.random.default_rng(seed)
    params = {n: (0.5 * r.standard_normal(np.shape(a))).astype(np.float32)
              for n, a in params.items()}
    return params, state


@pytest.mark.parametrize("case", LAYER_CASES, ids=_case_id)
def test_layer_forward_and_gradients_match_jax(case):
    name, kw, shape = case
    jlayer, layer = _layer_pair(name, kw)
    out_shape = jlayer.output_shape(shape)
    assert tuple(layer.output_shape(shape)) == tuple(out_shape)
    params, state = _variables(jlayer, shape, 33)
    tp, _ = layer.init(torch.Generator().manual_seed(0), shape,
                       torch.float32)
    assert {n: tuple(a.shape) for n, a in tp.items()} == {
        n: a.shape for n, a in params.items()}
    x = _rand(34, (2, *shape))
    ct = _rand(35, (2, *out_shape))

    def jf(p, x):
        y, _ = jlayer.apply(p, state, x, train=False)
        return jnp.sum(y * ct), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(params, x)
    tp = {n: _t(a).requires_grad_() for n, a in params.items()}
    tx = _t(x).requires_grad_()
    y, _ = layer.apply(tp, {}, tx, train=False)
    _close(y, jy)
    (y * _t(ct)).sum().backward()
    _close(tx.grad, jgx, TOL_GRAD)
    for n in params:
        _close(tp[n].grad, jgp[n], TOL_GRAD)


def test_layer_configs_cross_as_json():
    """Each new layer's config JSON loads in the other package to the same
    fields."""
    from deeplearning4j_tpu.nn import config as jax_config

    for name, kw, _ in LAYER_CASES:
        jlayer, layer = _layer_pair(name, kw)
        back = nnconfig.config_from_json(jax_config.config_to_json(jlayer))
        assert nnconfig.config_to_dict(back) == nnconfig.config_to_dict(
            layer), name
        there = jax_config.config_from_json(nnconfig.config_to_json(layer))
        assert jax_config.config_to_dict(there) == \
            jax_config.config_to_dict(jlayer), name


def test_locally_connected_init_is_conv_scaled_and_laid_out_by_position():
    layer = layers.LocallyConnected2D(filters=8, kernel=3)
    p, _ = layer.init(torch.Generator().manual_seed(1), (12, 12, 16),
                      torch.float32)
    assert tuple(p["W"].shape) == (10, 10, 144, 8)
    assert tuple(p["b"].shape) == (10, 10, 8)
    # He normal over the patch (fan-in 144), not over the positions
    assert abs(float(p["W"].std()) / np.sqrt(2 / 144) - 1) < 0.03


@pytest.mark.parametrize("cls", ["LossLayer", "RnnLossLayer",
                                 "CnnLossLayer"])
@pytest.mark.parametrize("loss_name,activation", [
    ("mcxent", "softmax"), ("mse", "identity"), ("xent", "sigmoid"),
    ("mse", "tanh")])
def test_loss_layers_match_jax(cls, loss_name, activation):
    shape = {"LossLayer": (5, 4), "RnnLossLayer": (3, 6, 4),
             "CnnLossLayer": (2, 3, 5, 4)}[cls]
    r = np.random.default_rng(36)
    x = _rand(37, shape)
    labels = (np.eye(4, dtype=np.float32)[r.integers(0, 4, shape[:-1])]
              if loss_name == "mcxent" else
              (r.random(shape) < 0.5).astype(np.float32))
    mask = (r.random(shape[:-1]) < 0.7).astype(np.float32)
    jlayer = getattr(jax_layers, cls)(activation=activation, loss=loss_name)
    layer = getattr(layers, cls)(activation=activation, loss=loss_name)
    assert layers.LossLayer().loss == "mse"
    _close(layer.apply({}, {}, _t(x))[0], jlayer.apply({}, {}, x)[0])
    for m in (None, mask):
        want = jax.jit(jax.value_and_grad(lambda x: jlayer.compute_loss(
            {}, {}, x, labels, mask=m)))(x)
        tx = _t(x).requires_grad_()
        got = layer.compute_loss({}, {}, tx, _t(labels),
                                 mask=None if m is None else _t(m))
        assert float(got.detach()) == pytest.approx(float(want[0]),
                                                    rel=TOL)
        got.backward()
        _close(tx.grad, want[1], TOL_GRAD)


@pytest.mark.parametrize("num_classes", [1, 3])
def test_pixel_output_masked_loss_matches_jax(num_classes):
    """The masked mean over the pixels a [N, H, W] mask keeps, and the
    plain mean; a [N, H, W] label for one class gains its channel."""
    r = np.random.default_rng(38)
    jlayer = jax_pixel.PixelOutput(num_classes=num_classes)
    layer = pixel.PixelOutput(num_classes=num_classes)
    params, _ = _variables(jlayer, (6, 7, 5), 39)
    x = _rand(40, (2, 6, 7, 5))
    if num_classes == 1:
        labels = (r.random((2, 6, 7)) < 0.3).astype(np.float32)
    else:
        labels = np.eye(3, dtype=np.float32)[r.integers(0, 3, (2, 6, 7))]
    mask = (r.random((2, 6, 7)) < 0.5).astype(np.float32)
    tp = {n: _t(a) for n, a in params.items()}
    for m in (None, mask):
        want = jlayer.compute_loss(params, {}, x, labels, mask=m)
        got = layer.compute_loss(tp, {}, _t(x), _t(labels),
                                 mask=None if m is None else _t(m))
        assert float(got) == pytest.approx(float(want), rel=TOL)
    masked = float(layer.compute_loss(tp, {}, _t(x), _t(labels),
                                      mask=_t(mask)))
    per = (layer.compute_loss(tp, {}, _t(x), _t(labels),
                              mask=torch.ones(2, 6, 7)))
    assert masked != pytest.approx(float(per), rel=1e-3)


# --- Dropout ---------------------------------------------------------------

DRAWS = 100_000


@pytest.mark.parametrize("kind,rate,stddev", [
    ("standard", 0.3, 1.0), ("alpha", 0.2, 1.0),
    ("gaussian_dropout", 0.3, 1.0), ("gaussian_noise", 0.5, 0.5)])
def test_dropout_is_the_identity_in_eval_and_without_a_generator(kind, rate,
                                                                 stddev):
    layer = layers.Dropout(rate=rate, kind=kind, stddev=stddev)
    x = _t(_rand(41, (3, 7)))
    assert layer.apply({}, {}, x, train=False,
                       generator=torch.Generator())[0] is x
    assert layer.apply({}, {}, x, train=True, generator=None)[0] is x
    jlayer = jax_layers.Dropout(rate=rate, kind=kind, stddev=stddev)
    np.testing.assert_array_equal(
        np.asarray(jlayer.apply({}, {}, x.numpy(), train=False)[0]),
        x.numpy())


@pytest.mark.parametrize("kind,rate,stddev", [
    ("standard", 0.3, 1.0), ("alpha", 0.2, 1.0),
    ("gaussian_dropout", 0.3, 1.0), ("gaussian_noise", 0.5, 0.5)])
def test_dropout_kinds_train_with_the_jax_packages_statistics(kind, rate,
                                                              stddev):
    """Over 10^5 draws each kind's mean and standard deviation match the
    JAX package's and the distribution's own, within 5 standard errors;
    standard dropout zeroes a ``rate`` share and scales the rest by
    1/keep."""
    x = (np.ones(DRAWS, np.float32) if kind != "alpha"
         else _rand(42, (DRAWS,)))
    layer = layers.Dropout(rate=rate, kind=kind, stddev=stddev)
    y = layer.apply({}, {}, _t(x), train=True,
                    generator=torch.Generator().manual_seed(3))[0].numpy()
    jy = np.asarray(jax_layers.Dropout(rate=rate, kind=kind,
                                       stddev=stddev).apply(
        {}, {}, x, train=True, rng=jax.random.key(3))[0])
    keep = 1.0 - rate
    want_mean, want_std = {
        "standard": (1.0, np.sqrt(rate / keep)),
        "alpha": (float(x.mean()), float(x.std())),
        "gaussian_dropout": (1.0, np.sqrt(rate / keep)),
        "gaussian_noise": (1.0, stddev)}[kind]
    se = want_std / np.sqrt(DRAWS)
    for out in (y, jy):
        assert abs(out.mean() - want_mean) < 5 * se + 1e-3, kind
        assert abs(out.std() - want_std) < 0.02 * want_std, kind
    if kind == "standard":
        assert abs((y == 0).mean() - rate) < 0.01
        np.testing.assert_allclose(y[y != 0], 1 / keep, rtol=1e-6)


def test_dropout_draws_the_same_mask_for_float32_and_float64():
    """The draws are float32 whatever the activation's dtype, so a float64
    copy of a model sees the float32 copy's mask from the same seed."""
    x = _rand(43, (64, 32))
    for kind in ("standard", "alpha", "gaussian_dropout", "gaussian_noise"):
        layer = layers.Dropout(rate=0.4, kind=kind, stddev=0.3)
        y32 = layer.apply({}, {}, _t(x), train=True,
                          generator=torch.Generator().manual_seed(5))[0]
        y64 = layer.apply({}, {}, _t(x).double(), train=True,
                          generator=torch.Generator().manual_seed(5))[0]
        assert y64.dtype == torch.float64
        np.testing.assert_allclose(y64.numpy(), y32.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_every_new_layer_is_registered_by_its_jax_class_name():
    from deeplearning4j_tpu.nn import config as jax_config

    new = {name for name, _, _ in LAYER_CASES} | {
        "LossLayer", "RnnLossLayer", "CnnLossLayer"}
    assert new <= set(nnconfig.CONFIG_REGISTRY)
    for name in new:
        jfields = {f.name for f in dataclasses.fields(
            jax_config.CONFIG_REGISTRY[name])}
        assert {f.name for f in dataclasses.fields(
            nnconfig.CONFIG_REGISTRY[name])} == jfields, name
