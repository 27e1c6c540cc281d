"""The port's activation registry against the JAX package's, on the CPU.

All 26 names of ``deeplearning4j_tpu/nn/activations.py`` resolve in the
port to ops of the same definition: values on a grid that holds every
kink (0, ±1, ±3, 6) to 1e-6 (relative past 1), and the gradient of
Σ f(x)·c for a random cotangent c at points 0.05 or more from any kink,
to 1e-5. ``softmax`` and ``log_softmax`` act over the last axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import activations as jax_activations
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.ops import nn as opsnn

NAMES = sorted(jax_activations.ACTIVATIONS)
KINKS = np.array([-6.0, -3.0, -1.0, 0.0, 1.0, 3.0, 6.0])
TOL = 1e-6
TOL_GRAD = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _grid():
    """[7, 33] float32: −8..8 by 0.5 with every kink and points 1e-3
    either side of each."""
    pts = np.concatenate([np.arange(-8.0, 8.25, 0.5), KINKS - 1e-3,
                          KINKS + 1e-3, KINKS])
    return np.resize(pts, (7, 33)).astype(np.float32)


def _away_from_kinks(seed, shape=(6, 20)):
    r = np.random.default_rng(seed)
    x = r.uniform(-7.0, 7.0, size=4 * int(np.prod(shape)))
    x = x[np.min(np.abs(x[:, None] - KINKS[None]), axis=1) >= 0.05]
    return x[:int(np.prod(shape))].reshape(shape).astype(np.float32)


def _assert_close(got, want, tol):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_the_registries_hold_the_same_names():
    assert sorted(activations.ACTIVATIONS) == NAMES
    assert len(NAMES) == 26


@pytest.mark.parametrize("name", NAMES)
def test_values_match_jax_on_a_grid_with_the_kinks(name):
    x = _grid()
    want = jax.jit(jax_activations.get_activation(name))(x)
    got = activations.get_activation(name)(torch.from_numpy(x))
    _assert_close(got, want, TOL)


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax_away_from_the_kinks(name):
    x = _away_from_kinks(1)
    c = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    fn = jax_activations.get_activation(name)
    want = jax.jit(jax.grad(lambda v: jnp.sum(fn(v) * c)))(x)
    xt = torch.from_numpy(x).requires_grad_()
    (activations.get_activation(name)(xt) * torch.from_numpy(c)).sum() \
        .backward()
    _assert_close(xt.grad, want, TOL_GRAD)


@pytest.mark.parametrize("name,x,want", [
    ("relu6", 0.0, 0.0), ("relu6", 6.0, 0.0), ("relu6", 3.0, 1.0),
    ("hardsigmoid", -3.0, 0.0), ("hardsigmoid", 3.0, 0.0),
    ("hardtanh", 1.0, 1.0), ("hardtanh", -1.0, 1.0),
    ("hardtanh", 1.5, 0.0), ("rectifiedtanh", 0.0, 0.5),
])
def test_gradients_at_the_kinks_are_the_jax_packages(name, x, want):
    """Where the JAX op defines its gradient at a kink (relu6's custom
    JVP, hard_tanh's ``where`` chain, ``maximum``'s split), the port's is
    the same."""
    fn = jax_activations.get_activation(name)
    assert float(jax.grad(fn)(x)) == want
    xt = torch.tensor(x, requires_grad=True)
    activations.get_activation(name)(xt).backward()
    assert float(xt.grad) == want


def test_hard_sigmoid_is_relu6_over_6_not_keras_2s_line():
    x = torch.tensor([-2.0, 0.0, 1.0, 2.5])
    got = activations.get_activation("hardsigmoid")(x)
    np.testing.assert_allclose(got.numpy(), [1 / 6, 0.5, 4 / 6, 5.5 / 6],
                               rtol=1e-7)
    assert not torch.allclose(got, torch.clamp(0.2 * x + 0.5, 0, 1))


def test_names_resolve_case_insensitively_and_unknown_ones_raise():
    assert activations.get_activation("ReLU6") is opsnn.relu6
    assert activations.get_activation("HardSigmoid") is opsnn.hard_sigmoid
    fn = lambda v: v  # noqa: E731
    assert activations.get_activation(fn) is fn
    with pytest.raises(ValueError) as got:
        activations.get_activation("relUU")
    with pytest.raises(ValueError) as want:
        jax_activations.get_activation("relUU")
    assert str(got.value) == str(want.value)
