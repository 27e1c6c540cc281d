"""LeNet-5, its data path and its evaluation in the port against the JAX package, on the CPU.

Full width (conv5×5×20 → pool → conv5×5×50 → pool → dense 500 → softmax
10 on 28×28×1), built in both packages from the same numpy variables (the
JAX package's init, carried with ``variables_from_numpy``) and fed the
same batches: the config's JSON, forward, loss, every gradient and two
Adam steps of the Trainer (JAX jitted). Then the data path: the synthetic
MNIST arrays bit-equal to the JAX package's, the same shuffle order, the
prefetch iterator, and the mirror of ``tests/test_lenet_e2e.py``; and
``Evaluation``'s numbers equal to the JAX package's on the same
predictions. Tolerances: float32 on both sides, sums in another order —
the loss to 1e-5 relative, outputs to 1e-5, each gradient leaf to 1e-4 of
its max |gradient|, params after Adam steps as in the char-RNN tests.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import data as jax_data
from deeplearning4j_tpu.evaluation import classification as jax_eval
from deeplearning4j_tpu.models.lenet import lenet as jax_lenet
from deeplearning4j_tpu.nn import config as jax_config
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.data import (
    ArrayDataSetIterator,
    AsyncDataSetIterator,
    DataSet,
    load_mnist,
)
from deeplearning4j_tpu_torch.data import mnist
from deeplearning4j_tpu_torch.evaluation import Evaluation, evaluate_model
from deeplearning4j_tpu_torch.models.lenet import lenet
from deeplearning4j_tpu_torch.nn import config as nnconfig
from deeplearning4j_tpu_torch.serde.checkpoint import variables_from_numpy
from deeplearning4j_tpu_torch.train.listeners import ScoreIterationListener
from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

N = 8
LR = 1e-3
TOL_LOSS = 1e-5
TOL_OUT = 1e-5
TOL_GRAD = 1e-4
NAMES = {"0_conv2d/W", "0_conv2d/b", "2_conv2d/W", "2_conv2d/b",
         "5_dense/W", "5_dense/b", "6_outputlayer/W", "6_outputlayer/b"}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_injected_faults():
    """The JAX package's data iterators, the references here, consult its
    process-wide fault injector (``data.read``); a plan that another test
    file left armed in the same worker process would fail them. Each test
    runs with an empty injector and gets back the one that was there."""
    from deeplearning4j_tpu.resilience.faults import (
        FaultInjector,
        get_fault_injector,
        set_fault_injector,
    )

    before = get_fault_injector()
    set_fault_injector(FaultInjector())
    yield
    set_fault_injector(before)


def _batch(seed, n=N):
    r = np.random.default_rng(seed)
    return {"features": r.random((n, 28, 28, 1), dtype=np.float32),
            "labels": np.eye(10, dtype=np.float32)[r.integers(0, 10, n)]}


def _np(tree):
    return {n: np.asarray(a.detach() if torch.is_tensor(a) else a)
            for n, a in flatten_with_names(tree)}


@pytest.fixture(scope="module")
def jax_model():
    return jax_lenet(updater=JaxAdam(LR))


@pytest.fixture(scope="module")
def variables(jax_model):
    """The JAX package's init as numpy, with non-zero biases."""
    v = jax.tree_util.tree_map(np.array, jax.jit(
        lambda: jax_model.init(seed=3))())
    r = np.random.default_rng(4)
    for layer in v["params"].values():
        layer["b"] = (0.05 * r.standard_normal(layer["b"].shape)).astype(
            np.float32)
    return v


def test_config_json_names_and_shapes_cross_both_ways(jax_model):
    model = lenet(device="cpu", updater=Adam(LR))
    assert model.layer_names == jax_model.layer_names
    assert model.shapes == [tuple(s) for s in jax_model.shapes] == [
        (28, 28, 1), (28, 28, 20), (14, 14, 20), (14, 14, 50), (7, 7, 50),
        (2450,), (500,), (10,)]
    back = nnconfig.SequentialConfig.from_json(jax_model.config.to_json())
    assert nnconfig.config_to_dict(back) == nnconfig.config_to_dict(
        model.config)
    jcfg = jax_config.SequentialConfig.from_json(model.config.to_json())
    assert jax_config.config_to_dict(jcfg) == jax_config.config_to_dict(
        jax_model.config)
    want = {n: a.shape for n, a in flatten_with_names(
        jax.eval_shape(jax_model.init))}
    v = model.init()
    assert {n: tuple(a.shape) for n, a in flatten_with_names(v)} == want
    assert set(_np(v["params"])) == NAMES
    assert model.num_params(v) == 1_256_080


def test_forward_loss_and_every_gradient_match_jax(jax_model, variables):
    model = lenet(device="cpu")
    batch = _batch(5)
    params = variables_from_numpy(variables)
    want = np.asarray(jax_model.output(variables, batch["features"]))
    got = model.output(params, batch["features"])  # numpy in, moved
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_OUT)
    acts, _ = model.feed_forward(params, torch.from_numpy(
        batch["features"]))
    jacts, _ = jax_model.feed_forward(variables, batch["features"])
    for a, j in zip(acts, jacts):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=0,
                                   atol=TOL_OUT * max(1, np.abs(j).max()))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model.loss_fn(p, {}, b), has_aux=True))(
        variables["params"], batch)
    loss, _, _, grads = Trainer(model)._grad_of(
        params["params"], {}, batch_to_device(batch, "cpu"), None)
    assert float(loss) == pytest.approx(float(jloss), rel=TOL_LOSS)
    got, want = _np(grads), _np(jgrads)
    assert got.keys() == want.keys() == NAMES
    for n, w in want.items():
        assert np.abs(got[n] - w).max() <= TOL_GRAD * np.abs(w).max(), n
    assert model.score(params, batch) == pytest.approx(
        float(jax_model.score(variables, batch)), rel=TOL_LOSS)


# as in the char-RNN tests: entries whose JAX gradient is under GRAD_FLOOR
# of their leaf's largest may move by up to lr·sign on a rounding-level
# difference; they are held to 2·lr per step, at most MAX_EXEMPT of all
GRAD_FLOOR = 1e-5
TOL_ADAM_PARAM = 1e-5
MAX_EXEMPT = 0.02


def test_two_adam_steps_match_the_jax_trainer(jax_model, variables):
    jtrainer = JaxTrainer(jax_model)
    jts = jtrainer.init_state(jax.tree_util.tree_map(jnp.asarray, variables))
    grad = jax.jit(jax.grad(lambda p, b: jax_model.loss_fn(p, {}, b)[0]))
    trainer = Trainer(lenet(device="cpu", updater=Adam(LR)))
    ts = trainer.init_state(variables)
    exempt = {}
    for k, b in enumerate((_batch(6), _batch(7))):
        jg = _np(jax.tree_util.tree_map(np.array, grad(jts.params, b)))
        jts, jm = jtrainer.train_step(jts, b)
        ts, m = trainer.train_step(ts, b)
        assert float(m["total_loss"]) == pytest.approx(
            float(jm["total_loss"]), rel=TOL_LOSS)
        got, want = _np(ts.params), _np(jax.tree_util.tree_map(
            np.array, jts.params))
        assert got.keys() == want.keys() == NAMES
        n_exempt = n_all = 0
        for n, w in want.items():
            g = np.abs(jg[n])
            exempt[n] = exempt.get(n, False) | ((g < GRAD_FLOOR * g.max())
                                                & (g > 0))
            err = np.abs(got[n] - w)
            assert err[~exempt[n]].max(initial=0) <= TOL_ADAM_PARAM, (k, n)
            assert err.max() <= 2 * (k + 1) * LR, (k, n)
            n_exempt += int(exempt[n].sum())
            n_all += w.size
        assert n_exempt <= MAX_EXEMPT * n_all, (k, n_exempt, n_all)
        assert ts.step == k + 1


@pytest.mark.parametrize("kw", [dict(n_train=300, n_test=100),
                                dict(n_train=64, n_test=32, one_hot=False,
                                     flat=True, normalize=False)], ids=str)
def test_synthetic_mnist_is_bit_equal_to_jax(kw, monkeypatch):
    monkeypatch.setattr(mnist, "_find_real", lambda: None)
    monkeypatch.setattr(jax_data.mnist, "_find_real", lambda: None)
    got, want = load_mnist(**kw), jax_data.load_mnist(**kw)
    assert got[2] is want[2] is False
    for g, w in zip(got[:2], want[:2]):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_idx_files_are_read(tmp_path, monkeypatch):
    """The idx readers: a directory named by DL4J_MNIST_DIR with the four
    files (gzipped) is loaded as the real set."""
    import gzip
    import struct

    r = np.random.default_rng(0)
    arrays = {"train-images-idx3-ubyte.gz": r.integers(0, 256, (6, 28, 28)),
              "train-labels-idx1-ubyte.gz": r.integers(0, 10, 6),
              "t10k-images-idx3-ubyte.gz": r.integers(0, 256, (4, 28, 28)),
              "t10k-labels-idx1-ubyte.gz": r.integers(0, 10, 4)}
    for name, a in arrays.items():
        a = a.astype(np.uint8)
        head = struct.pack(">I", 0x0800 | a.ndim) + struct.pack(
            ">" + "I" * a.ndim, *a.shape)
        with gzip.open(tmp_path / name, "wb") as f:
            f.write(head + a.tobytes())
    monkeypatch.setenv(mnist.ENV_DIR, str(tmp_path))
    (xtr, ytr), (xte, yte), real = load_mnist(one_hot=False)
    assert real is True and xtr.shape == (6, 28, 28, 1)
    np.testing.assert_array_equal(
        xtr[..., 0], arrays["train-images-idx3-ubyte.gz"].astype(
            np.float32) / np.float32(255))
    np.testing.assert_array_equal(yte, arrays["t10k-labels-idx1-ubyte.gz"])


def test_array_iterator_shuffles_like_jax():
    x = np.arange(50, dtype=np.float32).reshape(25, 2)
    y = np.arange(25)
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False),
               dict(shuffle=True, seed=1, drop_last=False)):
        it = ArrayDataSetIterator(x, y, 4, **kw)
        jit_ = jax_data.ArrayDataSetIterator(x, y, 4, **kw)
        assert len(it) == len(jit_)
        for _ in range(2):  # two epochs: the permutation follows (seed, epoch)
            got, want = list(it), list(jit_)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert isinstance(g, DataSet)
                np.testing.assert_array_equal(g.features, w.features)
                np.testing.assert_array_equal(g.labels, w.labels)


def test_async_iterator_copies_to_the_device_and_raises_like_jax():
    x = np.random.default_rng(0).random((10, 3), dtype=np.float32)
    base = ArrayDataSetIterator(x, np.arange(10), 4, shuffle=False)
    got = list(AsyncDataSetIterator(base, prefetch=1, device_put_to="cpu"))
    assert [type(b.features) for b in got] == [torch.Tensor] * 2
    assert got[0].labels_mask is None
    np.testing.assert_array_equal(got[1].features.numpy(), x[4:8])
    assert [b.features.shape for b in AsyncDataSetIterator(base)] == [
        (4, 3), (4, 3)]  # no device: the batches as the base gives them

    def broken():
        yield DataSet(x[:2], np.arange(2))
        raise IOError("read failed")

    for pkg in (AsyncDataSetIterator, jax_data.AsyncDataSetIterator):
        it = iter(pkg(broken()))
        next(it)
        with pytest.raises(IOError, match="read failed"):
            next(it)


def test_lenet_learns_and_evaluates():
    """The mirror of tests/test_lenet_e2e.py: fit through the iterators,
    the loss to below 0.7× its start, accuracy above 0.5."""
    (xtr, ytr), (xte, yte), _ = load_mnist(n_train=512, n_test=256)
    model = lenet(device="cpu", updater=Adam(3e-3))
    trainer = Trainer(model)
    ts = trainer.init_state()
    first = {"features": xtr[:64], "labels": ytr[:64]}
    score0 = model.score(trainer.variables(ts), first)
    it = ArrayDataSetIterator(xtr, ytr, batch_size=64, seed=0)
    listener = ScoreIterationListener(every=4, stream=io.StringIO())
    ts = trainer.fit(ts, AsyncDataSetIterator(it, device_put_to="cpu"),
                     epochs=6, listeners=[listener])
    assert ts.step == 48 and len(listener.history) == 12
    score1 = model.score(trainer.variables(ts), first)
    assert score1 < score0 * 0.7, (score0, score1)
    ev = evaluate_model(model, trainer.variables(ts), ArrayDataSetIterator(
        xte, yte, batch_size=64, shuffle=False), num_classes=10)
    assert ev.accuracy() > 0.5, ev.stats()
    assert int(ev.confusion().sum()) == 256


def test_evaluate_model_counts_like_jax(jax_model, variables):
    b = _batch(9, 40)
    ev = evaluate_model(lenet(device="cpu"), variables_from_numpy(variables),
                        ArrayDataSetIterator(b["features"], b["labels"], 16,
                                             shuffle=False, drop_last=False),
                        num_classes=10)
    jev = jax_eval.evaluate_model(
        jax_model, variables, jax_data.ArrayDataSetIterator(
            b["features"], b["labels"], 16, shuffle=False, drop_last=False),
        num_classes=10)
    np.testing.assert_array_equal(ev.confusion(), jev.confusion())


def _predictions(seed, shape, c=7):
    r = np.random.default_rng(seed)
    probs = r.random((*shape, c)).astype(np.float32)
    labels = r.integers(0, c - 1, shape)  # the last class never occurs
    return labels, probs


def test_evaluation_stats_equal_jax():
    """Confusion matrix, accuracy, macro and per-class precision/recall/F1,
    top-N, time series with a mask, merge and the stats text."""
    ev, jev = Evaluation(7, top_n=3), jax_eval.Evaluation(7, top_n=3)
    for seed, as_onehot in ((0, True), (1, False)):
        labels, probs = _predictions(seed, (30,))
        if as_onehot:
            labels = np.eye(7, dtype=np.float32)[labels]
        ev.eval(labels, probs)
        jev.eval(jnp.asarray(labels), jnp.asarray(probs))
    labels, probs = _predictions(2, (4, 5))
    mask = (np.random.default_rng(3).random((4, 5)) > 0.3).astype(np.float32)
    other, jother = Evaluation(7, top_n=3), jax_eval.Evaluation(7, top_n=3)
    other.eval_time_series(labels, probs, mask)
    jother.eval_time_series(labels, probs, mask)
    ev.merge(other)
    jev.merge(jother)
    np.testing.assert_array_equal(ev.confusion(), jev.confusion())
    assert ev.accuracy() == jev.accuracy()
    assert ev.top_n_accuracy() == pytest.approx(jev.top_n_accuracy(),
                                                rel=1e-6)
    for avg in ("macro", "micro"):
        assert ev.precision(average=avg) == jev.precision(average=avg)
        assert ev.recall(average=avg) == jev.recall(average=avg)
    assert ev.f1() == jev.f1()
    for c in range(7):
        assert (ev.precision(c), ev.recall(c), ev.f1(c)) == (
            jev.precision(c), jev.recall(c), jev.f1(c))
    assert ev.stats() == jev.stats()
    with pytest.raises(ValueError, match="top_n"):
        Evaluation(7).top_n_accuracy()


def test_top_n_ties_count_like_jax():
    """Equal scores rank the lower class first, as ``lax.top_k`` does:
    all-zero scores (labels 4, 0, 2 at top-2: only class 0 is a hit) and
    rows of saturated probabilities, in eval and eval_time_series."""
    scores = np.zeros((3, 5), np.float32)
    labels = np.array([4, 0, 2])
    ev, jev = Evaluation(5, top_n=2), jax_eval.Evaluation(5, top_n=2)
    ev.eval(labels, scores)
    jev.eval(jnp.asarray(labels), jnp.asarray(scores))
    assert ev.top_n_accuracy() == jev.top_n_accuracy() == pytest.approx(1 / 3)
    seq = np.array([[[0.5, 0.5, 0.0, 0.0, 0.0], [0.0, 1.0, 1.0, 1.0, 0.0]],
                    [[0.2, 0.2, 0.2, 0.2, 0.2], [1.0, 0.0, 0.0, 0.0, 1.0]]],
                   np.float32)
    seq_labels = np.array([[1, 3], [2, 4]])
    ev.eval_time_series(seq_labels, seq)
    jev.eval_time_series(jnp.asarray(seq_labels), jnp.asarray(seq))
    assert ev.top_n_accuracy() == pytest.approx(jev.top_n_accuracy(),
                                                rel=1e-6)
    np.testing.assert_array_equal(ev.confusion(), jev.confusion())


@pytest.mark.parametrize("bad", [-1, 4])
def test_out_of_range_labels_count_like_jax(bad, jax_model, variables):
    """A label outside [0, k) leaves the confusion matrix (the JAX
    package's ``segment_sum`` drops its index) and counts as a top-N miss
    in the total: eval, eval_time_series with a mask, and evaluate_model
    over integer labels."""
    r = np.random.default_rng(11)
    labels = np.array([0, 1, bad, 3, 2, 1])
    probs = r.random((6, 4)).astype(np.float32)
    ev, jev = Evaluation(4, top_n=2), jax_eval.Evaluation(4, top_n=2)
    ev.eval(labels, probs)
    jev.eval(jnp.asarray(labels), jnp.asarray(probs))
    seq_labels = np.array([[bad, 2, 3], [1, 0, bad]])
    seq = r.random((2, 3, 4)).astype(np.float32)
    mask = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    ev.eval_time_series(seq_labels, seq, mask)
    jev.eval_time_series(jnp.asarray(seq_labels), jnp.asarray(seq),
                         jnp.asarray(mask))
    np.testing.assert_array_equal(ev.confusion(), jev.confusion())
    assert int(ev.confusion().sum()) == 8
    assert ev.accuracy() == jev.accuracy()
    assert ev.top_n_accuracy() == pytest.approx(jev.top_n_accuracy(),
                                                rel=1e-6)
    b = _batch(12, 20)
    ids = b["labels"].argmax(-1)
    ids[[3, 17]] = -1 if bad < 0 else 10
    ev = evaluate_model(lenet(device="cpu"), variables_from_numpy(variables),
                        ArrayDataSetIterator(b["features"], ids, 8,
                                             shuffle=False, drop_last=False),
                        num_classes=10)
    jev = jax_eval.evaluate_model(
        jax_model, variables, jax_data.ArrayDataSetIterator(
            b["features"], ids, 8, shuffle=False, drop_last=False),
        num_classes=10)
    np.testing.assert_array_equal(ev.confusion(), jev.confusion())
    assert int(ev.confusion().sum()) == 18
