"""rnnTimeStep and char-RNN sampling in the port against the JAX package, on the CPU.

Each recurrent layer's ``init_carry``/``step``, ``RnnTimeStepper`` over a
sequence split across calls, the stack checks of ``_split_stack`` and
greedy ``generate`` ids, for one-hot stacks of LSTM, GravesLSTM, GRU and
SimpleRnn (vocab 11, hidden 16–32, T = 8–13). The configs are the JAX
package's, carried across as JSON, and the variables its ``init`` (the
peepholes and the head made larger, so that the next-char distribution
has a clear top), as numpy. The JAX package runs its default backend,
as its own generation tests do; the port's layers run the plain versions
of their sweeps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.config import (
    NeuralNetConfiguration as JaxNet,
)
from deeplearning4j_tpu.nn.config import SequentialConfig as JaxSeqConfig
from deeplearning4j_tpu.nn.generation import RnnTimeStepper as JaxStepper
from deeplearning4j_tpu.nn.generation import _split_stack as jax_split_stack
from deeplearning4j_tpu.nn.generation import generate as jax_generate
from deeplearning4j_tpu.nn.model import SequentialModel as JaxModel
from deeplearning4j_tpu_torch.kernels import lstm_scan
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import (
    NeuralNetConfiguration,
    SequentialConfig,
)
from deeplearning4j_tpu_torch.nn.generation import (
    RnnTimeStepper,
    _split_stack,
    generate,
)
from deeplearning4j_tpu_torch.nn.model import SequentialModel
from deeplearning4j_tpu_torch.ops.rnn import LSTMState
from deeplearning4j_tpu_torch.serde.checkpoint import variables_from_numpy

V, HID, T, N = 11, 24, 10, 3
# float32 on both sides, sums in another order: hidden states and
# probabilities (all of order 1) to 1e-5 absolute.
TOL = 1e-5
KINDS = ("LSTM", "GravesLSTM", "GRU", "SimpleRnn")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_stack(kind, head=V, layers=2):
    recs = [getattr(JL, kind)(units=HID) for _ in range(layers)]
    return JaxModel(JaxSeqConfig(
        net=JaxNet(seed=1), input_shape=(T, V),
        layers=[*recs, JL.RnnOutputLayer(units=head, activation="softmax",
                                         loss="mcxent")]))


def _pair(kind, **kw):
    """(JAX model, port model from its JSON, numpy variables)."""
    jm = _jax_stack(kind, **kw)
    pm = SequentialModel(SequentialConfig.from_json(jm.config.to_json()),
                         device="cpu")
    v = jax.tree_util.tree_map(np.array, jm.init(seed=2))
    r = np.random.default_rng(3)
    for name, p in v["params"].items():
        for k in ("pI", "pF", "pO"):
            if k in p:
                p[k] = (0.3 * r.standard_normal(p[k].shape)).astype(
                    np.float32)
        if name.endswith("rnnoutputlayer"):
            p["W"] = (4.0 * p["W"]).astype(np.float32)
    return jm, pm, v


def _onehot(ids):
    return np.eye(V, dtype=np.float32)[ids]


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, V, shape)


def _close(got, want, tol=TOL, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    assert np.abs(got - want).max() <= tol, (msg, np.abs(got - want).max())


def _carry_arrays(c):
    return list(c) if isinstance(c, tuple) else [c]


@pytest.mark.parametrize("kind", KINDS)
def test_layer_step_and_init_carry_match_jax(kind):
    """One ``step`` of the layer from a random carry, and ``init_carry``'s
    zeros, against the JAX layer's."""
    jm, pm, v = _pair(kind)
    name = pm.layer_names[1]
    jlayer, layer = jm.layers[1], pm.layers[1]
    params = v["params"][name]
    r = np.random.default_rng(4)
    x_t = r.standard_normal((N, HID)).astype(np.float32)
    jcarry = jlayer.init_carry(params, N)
    carry = layer.init_carry(variables_from_numpy(params), N)
    assert type(carry) is (LSTMState if "LSTM" in kind else torch.Tensor)
    for a, b in zip(_carry_arrays(carry), _carry_arrays(jcarry)):
        assert a.dtype == torch.float32 and not a.any()
        _close(a, b, 0.0)
    rand = [np.tanh(r.standard_normal((N, HID))).astype(np.float32)
            for _ in _carry_arrays(jcarry)]
    if "LSTM" in kind:
        jcarry, carry = (type(jcarry)(*map(jnp.asarray, rand)),
                         LSTMState(*map(torch.from_numpy, rand)))
    else:
        jcarry, carry = jnp.asarray(rand[0]), torch.from_numpy(rand[0])
    jy, jnew = jlayer.step(params, jcarry, jnp.asarray(x_t))
    y, new = layer.step(variables_from_numpy(params), carry,
                        torch.from_numpy(x_t))
    _close(y, jy, msg="y")
    for a, b in zip(_carry_arrays(new), _carry_arrays(jnew)):
        _close(a, b, msg="carry")


@pytest.mark.parametrize("kind", KINDS)
def test_window_from_a_carry_equals_stepping(kind):
    """``apply_window`` from a carry (one sweep) computes what T calls of
    ``step`` compute: outputs and the final carry."""
    _, pm, v = _pair(kind)
    layer = pm.layers[0]
    params = variables_from_numpy(v["params"][pm.layer_names[0]])
    x = torch.from_numpy(_onehot(_ids(5, (N, 7))))
    # a non-zero carry: one step from zeros
    carry = layer.step(params, layer.init_carry(params, N), x[:, 0])[1]
    ys, c = [], carry
    for t in range(x.shape[1]):
        y, c = layer.step(params, c, x[:, t])
        ys.append(y)
    yw, _, cw = layer.apply_window(params, {}, x, carry)
    _close(yw, torch.stack(ys, 1), msg="outputs")
    for a, b in zip(_carry_arrays(cw), _carry_arrays(c)):
        _close(a, b, msg="carry")


@pytest.mark.parametrize("kind", KINDS)
def test_time_stepper_across_calls_matches_jax_and_the_full_forward(kind):
    """A sequence fed as [N,3,C], then one [N,C] step, then [N,6,C]: each
    call's output against the JAX stepper's, the last against the last
    step of a full ``output``; ``clear_state`` starts over."""
    jm, pm, v = _pair(kind)
    x = _onehot(_ids(6, (N, T)))
    jst = JaxStepper(jm, v)
    st = RnnTimeStepper(pm, variables_from_numpy(v))
    assert st.carries is None
    for chunk in (x[:, :3], x[:, 3], x[:, 4:]):
        got = st.time_step(torch.from_numpy(chunk))
        _close(got, jst.time_step(chunk), msg=str(chunk.shape))
    assert len(st.carries) == 2
    full = pm.output(variables_from_numpy(v), torch.from_numpy(x))
    _close(got, full[:, -1])
    st.clear_state()
    _close(st.time_step(torch.from_numpy(x[:, :3])), full[:, 2])


def test_time_stepper_prime_is_one_sweep_a_layer(monkeypatch):
    """Several steps at once run each LSTM layer's sweep once (one
    ``lstm_fwd`` launch on the card), not T cell steps; one step runs no
    sweep."""
    _, pm, v = _pair("GravesLSTM")
    calls = []
    sweep = lstm_scan.lstm

    def spy(x, *a, **k):
        calls.append(tuple(x.shape))
        return sweep(x, *a, **k)

    monkeypatch.setattr(lstm_scan, "lstm", spy)
    st = RnnTimeStepper(pm, variables_from_numpy(v))
    x = torch.from_numpy(_onehot(_ids(7, (N, 8))))
    st.time_step(x)
    assert calls == [(N, 8, V), (N, 8, HID)]
    st.time_step(x[:, 0])
    assert len(calls) == 2


def test_time_step_empty_time_axis_raises():
    jm, pm, v = _pair("LSTM")
    with pytest.raises(ValueError, match="empty time axis"):
        RnnTimeStepper(pm, variables_from_numpy(v)).time_step(
            torch.zeros((2, 0, V)))
    with pytest.raises(ValueError, match="empty time axis"):
        JaxStepper(jm, v).time_step(jnp.zeros((2, 0, V)))


def _split_error(split, layers_of, model_of, config, net, layers):
    model = model_of(config(net=net(seed=0), input_shape=(T, V),
                            layers=layers(layers_of)))
    with pytest.raises(ValueError) as err:
        split(model)
    return str(err.value)


STACK_ERRORS = {
    "recurrent_after_head": (
        lambda ly: [ly.Dense(units=HID), ly.LSTM(units=HID),
                    ly.RnnOutputLayer(units=V)], "appears after"),
    "bidirectional_head": (
        lambda ly: [ly.LSTM(units=HID),
                    ly.Bidirectional(layer=ly.LSTM(units=HID)),
                    ly.RnnOutputLayer(units=V)], "not step-capable"),
    "last_time_step_head": (
        lambda ly: [ly.GRU(units=HID), ly.LastTimeStep(),
                    ly.OutputLayer(units=V)], "not step-capable"),
    "no_recurrent_layer": (
        lambda ly: [ly.Dense(units=HID), ly.RnnOutputLayer(units=V)],
        "no recurrent"),
}


@pytest.mark.parametrize("case", sorted(STACK_ERRORS))
def test_split_stack_errors_match_jax(case):
    """The port refuses the stacks the JAX package refuses, with its
    message."""
    layers, match = STACK_ERRORS[case]
    got = _split_error(_split_stack, L,
                       lambda c: SequentialModel(c, device="cpu"),
                       SequentialConfig, NeuralNetConfiguration, layers)
    want = _split_error(jax_split_stack, JL, JaxModel, JaxSeqConfig, JaxNet,
                        layers)
    assert got == want and match in got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("prime", ["none", "1d", "2d"])
def test_greedy_generate_ids_match_jax(kind, prime):
    """temperature 0: every id equal to the JAX package's, with no prime
    (the stack starts from id 0), a 1-D prime broadcast over the batch and
    a [batch, T0] prime."""
    jm, pm, v = _pair(kind)
    primes = {"none": None, "1d": _ids(8, 5), "2d": _ids(9, (N, 4))}
    p = primes[prime]
    want = jax_generate(jm, v, n_steps=13, rng=jax.random.key(0),
                        prime=None if p is None else jnp.asarray(p),
                        temperature=0.0, batch_size=N)
    got = generate(pm, variables_from_numpy(v), n_steps=13, rng=0,
                   prime=None if p is None else torch.from_numpy(p),
                   temperature=0.0, batch_size=N)
    assert got.dtype == torch.int32 and got.shape == (N, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_generate_follows_the_full_forward():
    """Each greedy id is the argmax of the full forward over the prime
    and the ids before it (the function the stepped carries compute)."""
    _, pm, v = _pair("GravesLSTM")
    variables = variables_from_numpy(v)
    prime = _ids(10, 4)
    ids = generate(pm, variables, n_steps=6, rng=0, prime=prime,
                   temperature=0.0, batch_size=2)
    seq = np.broadcast_to(prime, (2, 4))
    for k in range(6):
        probs = pm.output(variables, torch.from_numpy(_onehot(seq)))
        want = torch.argmax(probs[:, -1], -1).to(torch.int32)
        assert torch.equal(ids[:, k], want), k
        seq = np.concatenate([seq, ids[:, k:k + 1].numpy()], axis=1)


def test_sampled_generate_follows_the_seed():
    _, pm, v = _pair("LSTM")
    variables = variables_from_numpy(v)

    def draw(rng):
        return generate(pm, variables, n_steps=20, rng=rng, prime=[1, 2],
                        temperature=0.8, batch_size=4)

    a = draw(5)
    assert torch.equal(a, draw(torch.Generator().manual_seed(5)))
    assert not torch.equal(a, draw(6))
    assert int(a.min()) >= 0 and int(a.max()) < V


def test_generate_prime_and_width_errors_match_jax():
    jm, pm, v = _pair("LSTM")
    pv = variables_from_numpy(v)
    with pytest.raises(ValueError, match="batch") as err:
        generate(pm, pv, n_steps=3, rng=0, prime=np.ones((4, 3), np.int32),
                 batch_size=1)
    with pytest.raises(ValueError) as jerr:
        jax_generate(jm, v, n_steps=3, rng=jax.random.key(0),
                     prime=jnp.ones((4, 3), jnp.int32), batch_size=1)
    assert str(err.value) == str(jerr.value)
    jm, pm, v = _pair("SimpleRnn", head=9)  # head 9 != one-hot 11
    with pytest.raises(ValueError, match="head width") as err:
        generate(pm, variables_from_numpy(v), n_steps=2, rng=0)
    with pytest.raises(ValueError) as jerr:
        jax_generate(jm, v, n_steps=2, rng=jax.random.key(0))
    assert str(err.value) == str(jerr.value)


def test_generate_refuses_an_embedding_stack():
    """The char-GRU of the TensorFlow tutorial starts with an Embedding:
    its GRU comes after a non-recurrent layer, so generation refuses it
    (as the JAX package does)."""
    pm = SequentialModel(SequentialConfig(
        net=NeuralNetConfiguration(seed=0), input_shape=(T,),
        layers=[L.Embedding(vocab_size=V, units=8), L.GRU(units=HID),
                L.RnnOutputLayer(units=V)]), device="cpu")
    with pytest.raises(ValueError, match="appears after non-recurrent"):
        generate(pm, pm.init(), n_steps=2, rng=0)
