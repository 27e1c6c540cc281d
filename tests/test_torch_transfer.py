"""The port's transfer learning, center loss, ``l2_normalize`` and frozen-name check against the JAX package's, on the CPU.

Every builder method of ``TransferLearning`` (LeNet-5) and
``GraphTransferLearning`` (a small conv/BatchNorm/dense graph and the
FaceNet recipe on a small Inception-ResNet-v1) runs the same surgery in
both packages on the same variables (the JAX package's ``init`` as
numpy): the frozen lists, the new config (through JSON), which vertices
carry their old leaves (bit-equal) and which re-initialize, and the
error messages are held equal. ``TransferLearningHelper``'s features
and tail to TOL of their max. ``CenterLossOutputLayer``: loss to TOL
relative and every gradient leaf to TOL of the largest, with and
without a mask or weights, on the fused-logit and the plain path, and
with bf16 params and features (the mixed-precision step) to TOL_BF16
relative. ``l2_normalize``: value and gradient at 0, near 0 and away
from it, to TOL. The FaceNet recipe's fine-tune step: frozen params
bit-equal, the frozen BatchNorm state moved as in the JAX package. The
recipe's loss and gradients are held at variables drawn as the zoo tests
draw them (``test_torch_zoo_cnn._variables``).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.models.lenet import lenet as jax_lenet
from deeplearning4j_tpu.nn import config as jax_config
from deeplearning4j_tpu.nn import layers as jax_layers
from deeplearning4j_tpu.nn.model import GraphModel as JaxGraphModel
from deeplearning4j_tpu.ops import nn as jax_opsnn
from deeplearning4j_tpu.train import transfer as jax_transfer
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu.train.updaters import Adam as JaxAdam
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.lenet import lenet
from deeplearning4j_tpu_torch.nn import config as nnconfig
from deeplearning4j_tpu_torch.nn import layers
from deeplearning4j_tpu_torch.nn.model import GraphModel
from deeplearning4j_tpu_torch.ops import nn as opsnn
from deeplearning4j_tpu_torch.serde import checkpoint as ckpt
from deeplearning4j_tpu_torch.train import transfer
from deeplearning4j_tpu_torch.train.trainer import Trainer, batch_to_device
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names
from test_torch_zoo_cnn import _variables

TOL = 1e-5
TOL_BF16 = 1e-2
LR = 1e-3

JAX = SimpleNamespace(cfg=jax_config, L=jax_layers, tl=jax_transfer,
                      Adam=JaxAdam)
PORT = SimpleNamespace(cfg=nnconfig, L=layers, tl=transfer, Adam=Adam)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return {n: np.asarray(a.detach() if torch.is_tensor(a) else a,
                          np.float32)
            for n, a in flatten_with_names(tree)}


def _jax_vars(jmodel, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jmodel.init(seed=seed)))


def _same_config(model, jmodel):
    assert nnconfig.config_to_dict(model.config) == nnconfig.config_to_dict(
        nnconfig.config_from_json(jmodel.config.to_json()))


def _carried(new_vars, old_vars):
    """{part/name: True when every leaf is bit-equal to the old one}."""
    out = {}
    for part in ("params", "state"):
        for name, tree in new_vars[part].items():
            if name not in old_vars.get(part, {}):
                out[f"{part}/{name}"] = False
                continue
            new, old = _np(tree), _np(old_vars[part][name])
            out[f"{part}/{name}"] = new.keys() == old.keys() and all(
                new[k].shape == old[k].shape and np.array_equal(new[k], old[k])
                for k in new)
    return out


def _shapes(tree):
    return {n: a.shape for n, a in _np(tree).items()}


def _both(fn):
    """``fn(ns)`` in each package → (port's result, JAX's result); an
    exception comes back as its message."""
    out = []
    for ns in (PORT, JAX):
        try:
            out.append(fn(ns))
        except (ValueError, KeyError) as e:
            out.append(("raised", type(e).__name__, str(e)))
    return out


# --- TransferLearning (SequentialModel) ---------------------------------


@pytest.fixture(scope="module")
def lenets():
    jmodel = jax_lenet()
    jv = _jax_vars(jmodel, 1)
    model = lenet(device="cpu")
    _same_config(model, jmodel)
    return (model, ckpt.variables_from_numpy(jv)), (jmodel, jv)


def _seq_surgery(ns, lenets, edit):
    model, v = lenets[0] if ns is PORT else lenets[1]
    return edit(ns, ns.tl.TransferLearning(model, v)), v


SEQ_EDITS = {
    "replace_head": lambda ns, tl: (
        tl.fine_tune_configuration(ns.tl.FineTuneConfiguration(
            updater=ns.Adam(1e-2), l2=1e-4))
        .set_feature_extractor("5_dense")
        .remove_last_layers(1)
        .add_layer(ns.L.OutputLayer(units=5, activation="softmax",
                                    loss="mcxent"))),
    "n_out_replace_by_index": lambda ns, tl: (
        tl.set_feature_extractor(1).n_out_replace(6, 3,
                                                  weight_init="relu")),
    "n_out_replace_and_add": lambda ns, tl: (
        tl.n_out_replace("6_outputlayer", 6)
        .add_layer(ns.L.ActivationLayer(activation="tanh"))),
    "freeze_only": lambda ns, tl: tl.set_feature_extractor("2_conv2d"),
}


@pytest.mark.parametrize("edit", list(SEQ_EDITS))
def test_sequential_surgery_matches_jax(lenets, edit):
    (port, pv), (jax_out, jv) = _both(
        lambda ns: _seq_surgery(ns, lenets, SEQ_EDITS[edit]))
    model, v, frozen = port.build(seed=7)
    jmodel, jnew, jfrozen = jax_out.build(seed=7)
    _same_config(model, jmodel)
    assert model.layer_names == jmodel.layer_names
    assert frozen == jfrozen
    assert _shapes(v) == _shapes(jnew)
    assert _carried(v, pv) == _carried(jnew, jv)
    out = model.output(v, np.zeros((2, 28, 28, 1), np.float32))
    assert tuple(out.shape) == (2, model.shapes[-1][-1])


SEQ_ERRORS = {
    "unknown_layer": lambda ns, tl: tl.set_feature_extractor("9_dense"),
    "unknown_n_out": lambda ns, tl: tl.n_out_replace("9_dense", 3),
    "remove_too_many": lambda ns, tl: tl.remove_last_layers(9),
    "no_width": lambda ns, tl: tl.n_out_replace("1_pooling2d", 3),
    "no_layers": lambda ns, tl: tl.remove_last_layers(7).build(),
}


@pytest.mark.parametrize("edit", list(SEQ_ERRORS))
def test_sequential_surgery_errors_are_the_jax_packages(lenets, edit):
    port, jax_out = _both(lambda ns: _seq_surgery(ns, lenets,
                                                  SEQ_ERRORS[edit]))
    assert port[0] == "raised"
    assert port == jax_out


def test_fine_tune_configuration_overrides_only_what_it_sets():
    net = nnconfig.NeuralNetConfiguration(seed=3, l1=0.5)
    jnet = jax_config.NeuralNetConfiguration(seed=3, l1=0.5)
    got = transfer.FineTuneConfiguration(updater=Adam(1e-4), seed=9,
                                         mixed_precision=True).apply(net)
    want = jax_transfer.FineTuneConfiguration(
        updater=JaxAdam(1e-4), seed=9, mixed_precision=True).apply(jnet)
    assert nnconfig.config_to_dict(got) == nnconfig.config_to_dict(
        nnconfig.config_from_json(jax_config.config_to_json(want)))
    assert got.l1 == 0.5 and got.seed == 9 and net.seed == 3


def test_transfer_learning_helper_matches_jax(lenets):
    (model, v), (jmodel, jv) = lenets
    x = np.random.default_rng(2).standard_normal((3, 28, 28, 1)).astype(
        np.float32)
    helper = transfer.TransferLearningHelper(model, v, "2_conv2d")
    jhelper = jax_transfer.TransferLearningHelper(jmodel, jv, "2_conv2d")
    feats = helper.featurize(x)
    jfeats = np.asarray(jhelper.featurize(x))
    assert not feats.requires_grad
    assert np.abs(feats.numpy() - jfeats).max() <= TOL * np.abs(jfeats).max()
    tail, tv = helper.unfrozen_graph()
    jtail, jtv = jhelper.unfrozen_graph()
    _same_config(tail, jtail)
    assert tail.layer_names == jtail.layer_names
    got, want = _np(tv), _np(jtv)
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    got = tail.output(tv, feats).numpy()
    want = np.asarray(jtail.output(jtv, jfeats))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    full = model.output(v, x).numpy()
    assert np.abs(got - full).max() <= TOL * np.abs(full).max()


# --- GraphTransferLearning ----------------------------------------------


def _tiny_graph_config():
    """input → conv → bn → pool → dense → output, and a side branch
    dense2 on pool (a second path for removals)."""
    L, C = jax_layers, jax_config
    v = {
        "conv": C.GraphVertex(kind="layer", inputs=["input"],
                              layer=L.Conv2D(filters=4, kernel=3)),
        "bn": C.GraphVertex(kind="layer", inputs=["conv"],
                            layer=L.BatchNorm(activation="relu")),
        "pool": C.GraphVertex(kind="layer", inputs=["bn"],
                              layer=L.GlobalPooling()),
        "dense": C.GraphVertex(kind="layer", inputs=["pool"],
                               layer=L.Dense(units=8, activation="relu")),
        "dense2": C.GraphVertex(kind="layer", inputs=["pool"],
                                layer=L.Dense(units=6, activation="tanh")),
        "cat": C.GraphVertex(kind="merge", inputs=["dense", "dense2"]),
        "output": C.GraphVertex(kind="layer", inputs=["cat"],
                                layer=L.OutputLayer(units=10)),
    }
    return C.GraphConfig(net=C.NeuralNetConfiguration(seed=0),
                         inputs=["input"], input_shapes={"input": (8, 8, 3)},
                         vertices=v, outputs=["output"])


@pytest.fixture(scope="module")
def tiny_graphs():
    jcfg = _tiny_graph_config()
    jmodel = JaxGraphModel(jcfg)
    jv = _jax_vars(jmodel)
    # running state off its initial values, so carrying it shows
    jv["state"]["bn"] = {k: a + 0.25 for k, a in jv["state"]["bn"].items()}
    model = GraphModel(nnconfig.config_from_json(jcfg.to_json()),
                       device="cpu")
    return (model, ckpt.variables_from_numpy(jv)), (jmodel, jv)


def _graph_surgery(ns, graphs, edit):
    model, v = graphs[0] if ns is PORT else graphs[1]
    return edit(ns, ns.tl.GraphTransferLearning(model, v)), v


def _head(ns, units, inputs):
    return ns.cfg.GraphVertex(kind="layer", inputs=list(inputs),
                              layer=ns.L.OutputLayer(units=units))


GRAPH_EDITS = {
    "freeze_and_new_head": lambda ns, g: (
        g.fine_tune_configuration(ns.tl.FineTuneConfiguration(
            updater=ns.Adam(1e-3)))
        .set_feature_extractor("dense").n_out_replace("output", 5)),
    "freeze_two_frontiers": lambda ns, g: g.set_feature_extractor(
        "dense", "dense2"),
    "n_out_replace_midgraph": lambda ns, g: g.n_out_replace(
        "dense", 16, weight_init="relu").set_feature_extractor("cat"),
    "n_out_replace_conv": lambda ns, g: g.n_out_replace(
        "conv", 6).set_feature_extractor("dense"),
    "remove_branch_and_re_head": lambda ns, g: (
        g.remove_vertex("dense2")
        .add_vertex("head", _head(ns, 3, ["dense"]))
        .set_outputs("head").set_feature_extractor("dense")),
    "remove_only_a_leaf": lambda ns, g: (
        g.remove_vertex("output", and_descendants=False)
        .set_outputs("cat")),
    "two_outputs": lambda ns, g: (
        g.add_vertex("aux", _head(ns, 2, ["dense2"]))
        .set_outputs("output", "aux")),
}


@pytest.mark.parametrize("edit", list(GRAPH_EDITS))
def test_graph_surgery_matches_jax(tiny_graphs, edit):
    (port, pv), (jax_out, jv) = _both(
        lambda ns: _graph_surgery(ns, tiny_graphs, GRAPH_EDITS[edit]))
    model, v, frozen = port.build(seed=3)
    jmodel, jnew, jfrozen = jax_out.build(seed=3)
    _same_config(model, jmodel)
    assert model.order == jmodel.order
    assert frozen == jfrozen
    assert _shapes(v) == _shapes(jnew)
    assert _carried(v, pv) == _carried(jnew, jv)
    out = model.output(v, np.zeros((2, 8, 8, 3), np.float32))
    assert {k: tuple(a.shape) for k, a in out.items()} == {
        k: tuple(a.shape) for k, a in jmodel.output(
            jnew, np.zeros((2, 8, 8, 3), np.float32)).items()}


GRAPH_ERRORS = {
    "unknown_frontier": lambda ns, g: g.set_feature_extractor("nope"),
    "unknown_n_out": lambda ns, g: g.n_out_replace("nope", 3),
    "n_out_of_a_merge": lambda ns, g: g.n_out_replace("cat", 3),
    "n_out_of_a_pool": lambda ns, g: g.n_out_replace("pool", 3),
    "dangling_removal": lambda ns, g: g.remove_vertex(
        "dense", and_descendants=False),
    "unknown_removal": lambda ns, g: g.remove_vertex("nope"),
    "duplicate_vertex": lambda ns, g: g.add_vertex(
        "dense", _head(ns, 2, ["pool"])),
    "missing_input": lambda ns, g: g.add_vertex(
        "head", _head(ns, 2, ["nope"])),
    "unknown_output": lambda ns, g: g.set_outputs("nope"),
    "no_outputs": lambda ns, g: g.remove_vertex("dense").build(),
}


@pytest.mark.parametrize("edit", list(GRAPH_ERRORS))
def test_graph_surgery_errors_are_the_jax_packages(tiny_graphs, edit):
    port, jax_out = _both(lambda ns: _graph_surgery(ns, tiny_graphs,
                                                    GRAPH_ERRORS[edit]))
    assert port[0] == "raised"
    assert port == jax_out


def test_a_refused_removal_leaves_the_builder_intact(tiny_graphs):
    def edit(ns, g):
        with pytest.raises(ValueError, match="missing inputs"):
            g.remove_vertex("pool", and_descendants=False)
        return g.n_out_replace("output", 2)

    (port, pv), (jax_out, jv) = _both(
        lambda ns: _graph_surgery(ns, tiny_graphs, edit))
    model, v, frozen = port.build()
    jmodel, jnew, jfrozen = jax_out.build()
    assert model.order == jmodel.order and "pool" in model.order
    assert frozen == jfrozen == []
    assert _carried(v, pv) == _carried(jnew, jv)
    assert tuple(v["params"]["output"]["W"].shape) == (14, 2)


# --- the FaceNet recipe on a small Inception-ResNet-v1 --------------------

FACENET = dict(width=8, blocks_a=1, blocks_b=1, input_shape=(64, 64, 3),
               embedding=16, dropout=0.0)


def _facenet_head(ns, g, classes):
    """l2norm embeddings on the bottleneck, a center-loss head on them."""
    return (g.add_vertex("embeddings", ns.cfg.GraphVertex(
                kind="l2norm", inputs=["bottleneck"]))
            .add_vertex("loss", ns.cfg.GraphVertex(
                kind="layer", inputs=["embeddings"],
                layer=ns.L.CenterLossOutputLayer(units=classes,
                                                 lambda_=0.1)))
            .set_outputs("loss"))


@pytest.fixture(scope="module")
def facenets():
    jmodel = jax_zoo.inception_resnet_v1(**FACENET)
    jv = _jax_vars(jmodel, 2)
    model = zoo.inception_resnet_v1(device="cpu", **FACENET)
    _same_config(model, jmodel)
    out = []
    for ns, m, v in ((PORT, model, ckpt.variables_from_numpy(jv)),
                     (JAX, jmodel, jv)):
        out.append(_facenet_head(ns, ns.tl.GraphTransferLearning(m, v),
                                 6).build(seed=5) + (v,))
    return out


def _identity_batch(n, classes, seed):
    r = np.random.default_rng(seed)
    ids = r.integers(0, classes, n)
    templates = np.random.default_rng(99).standard_normal(
        (classes, 64, 64, 3))
    x = templates[ids] + 0.5 * r.standard_normal((n, 64, 64, 3))
    return {"features": x.astype(np.float32),
            "labels": np.eye(classes, dtype=np.float32)[ids]}


def test_facenet_head_surgery_loss_and_gradients_match_jax(facenets):
    (model, v, frozen, old), (jmodel, jv, jfrozen, jold) = facenets
    _same_config(model, jmodel)
    assert frozen == jfrozen == []
    assert _carried(v, old) == _carried(jv, jold)
    assert not any(k.endswith("/loss") and c
                   for k, c in _carried(v, old).items())
    assert tuple(v["params"]["loss"]["centers"].shape) == (6, 16)
    assert not v["params"]["loss"]["centers"].any()
    # the loss and gradients at variables drawn as the zoo tests draw them
    # (biases, BatchNorm state and centers off their initial values): at
    # the init (gamma 1, beta 0) the stem's gradients of both packages lie
    # 5e-4–1e-3 of the largest from the port's float64 copy
    jv = _variables(jmodel, 1)
    tv = ckpt.variables_from_numpy(jv)
    batch = _identity_batch(4, 6, 1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, s, b: jmodel.loss_fn(p, s, b), has_aux=True))(
        jv["params"], jv["state"], batch)
    loss, _, _, grads = Trainer(model)._grad_of(
        tv["params"], tv["state"], batch_to_device(batch, "cpu"), None)
    assert float(loss) == pytest.approx(float(jloss), rel=TOL)
    got, want = _np(grads), _np(jgrads)
    top = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        assert np.abs(got[n] - w).max() <= TOL * top, n
    assert np.abs(want["loss/centers"]).max() > 0


def test_facenet_fine_tune_freezes_the_backbone_like_jax(facenets):
    """``set_feature_extractor("red_a_cat").n_out_replace("loss", 3)``: the
    same frozen list; one Adam step of each package's Trainer leaves the
    frozen params bit-equal and moves the frozen vertices' BatchNorm
    running state (the JAX package masks gradients and updates, it does
    not switch frozen layers to inference) by the same amounts."""
    (model, v, _, _), (jmodel, jv, _, _) = facenets

    def edit(ns, g):
        return (g.fine_tune_configuration(ns.tl.FineTuneConfiguration(
                    updater=ns.Adam(LR)))
                .set_feature_extractor("red_a_cat").n_out_replace("loss", 3))

    port = edit(PORT, transfer.GraphTransferLearning(model, v)).build(seed=1)
    jout = edit(JAX, jax_transfer.GraphTransferLearning(jmodel, jv)).build(
        seed=1)
    ft, fv, frozen = port
    jft, jfv, jfrozen = jout
    assert frozen == jfrozen
    assert "stem1_c" in frozen and "red_a_c_c" in frozen
    assert "b0_up" not in frozen and "loss" not in frozen
    assert _carried(fv, v) == _carried(jfv, jv)
    fv = ckpt.variables_from_numpy(jax.tree_util.tree_map(np.asarray, jfv))
    batch = _identity_batch(4, 3, 8)
    trainer = Trainer(ft, frozen_layers=frozen)
    ts0 = trainer.init_state(fv)
    ts, m = trainer.train_step(ts0, batch)
    jtrainer = JaxTrainer(jft, frozen_layers=jfrozen)
    jts, jm = jtrainer.train_step(
        jtrainer.init_state(jax.tree_util.tree_map(jnp.asarray, jfv)), batch)
    assert float(m["total_loss"]) == pytest.approx(float(jm["total_loss"]),
                                                   rel=TOL)
    before, after = _np(fv["params"]), _np(ts.params)
    for n in after:
        if n.split("/")[0] in frozen:
            np.testing.assert_array_equal(after[n], before[n], err_msg=n)
    assert any(not np.array_equal(after[n], before[n]) for n in after
               if n.startswith("loss/"))
    s0, s1 = _np(fv["state"]), _np(ts.model_state)
    js1 = _np(jax.device_get(jts.model_state))
    moved = [n for n in s1 if n.split("/")[0] in frozen
             and not np.array_equal(s1[n], s0[n])]
    assert moved
    for n in s1:
        assert np.abs(s1[n] - js1[n]).max() <= TOL * max(
            1.0, np.abs(js1[n]).max()), n


def test_facenet_stripped_head_serves_unit_embeddings_like_jax(facenets):
    (model, v, _, _), (jmodel, jv, _, _) = facenets
    port = (transfer.GraphTransferLearning(model, v).remove_vertex("loss")
            .set_outputs("embeddings").build())
    jout = (jax_transfer.GraphTransferLearning(jmodel, jv)
            .remove_vertex("loss").set_outputs("embeddings").build())
    emb, ev, frozen = port
    jemb, jev, jfrozen = jout
    _same_config(emb, jemb)
    assert frozen == jfrozen == []
    assert "loss" not in ev["params"] and "loss" not in jev["params"]
    assert _carried(ev, v) == _carried(jev, jv)
    assert all(_carried(ev, v).values())
    x = _identity_batch(5, 6, 3)["features"]
    got = emb.output_single(ev, x).numpy()
    want = np.asarray(jemb.output_single(jev, x))
    assert got.shape == want.shape == (5, 16)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(np.linalg.norm(got, axis=-1) - 1).max() <= TOL


# --- CenterLossOutputLayer ------------------------------------------------


CENTER_CASES = {
    "fused": dict(),
    "fused_masked": dict(mask=True),
    "fused_weighted": dict(weights=True),
    "plain": dict(loss="mse", activation="tanh"),
    "plain_masked": dict(loss="mse", activation="tanh", mask=True),
    "plain_weighted": dict(loss="mse", activation="tanh", weights=True),
}


def _center_inputs(seed=0, n=6, f=5, c=3):
    r = np.random.default_rng(seed)
    params = {"W": r.standard_normal((f, c)).astype(np.float32),
              "b": r.standard_normal(c).astype(np.float32) * 0.1,
              "centers": r.standard_normal((c, f)).astype(np.float32)}
    x = r.standard_normal((n, f)).astype(np.float32)
    labels = np.eye(c, dtype=np.float32)[r.integers(0, c, n)]
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    weights = r.uniform(0.2, 2.0, n).astype(np.float32)
    return params, x, labels, mask, weights


@pytest.mark.parametrize("case", list(CENTER_CASES))
def test_center_loss_and_gradients_match_jax(case):
    kw = dict(CENTER_CASES[case])
    use_mask, use_weights = kw.pop("mask", False), kw.pop("weights", False)
    params, x, labels, mask, weights = _center_inputs()
    extra = {}
    if use_mask:
        extra["mask"] = mask
    if use_weights:
        extra["weights"] = weights
    jlayer = jax_layers.CenterLossOutputLayer(units=3, lambda_=0.3, **kw)
    layer = layers.CenterLossOutputLayer(units=3, lambda_=0.3, **kw)
    jloss, jgrads = jax.value_and_grad(
        lambda p, x: jlayer.compute_loss(p, {}, x, labels, **extra),
        argnums=(0, 1))(params, x)
    tp = {k: torch.tensor(a, requires_grad=True) for k, a in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    loss = layer.compute_loss(tp, {}, tx, torch.tensor(labels), **{
        k: torch.tensor(a) for k, a in extra.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=TOL)
    got = {**{k: t.grad.numpy() for k, t in tp.items()}, "x": tx.grad.numpy()}
    want = {**{k: np.asarray(a) for k, a in jgrads[0].items()},
            "x": np.asarray(jgrads[1])}
    top = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        assert np.abs(got[n] - w).max() <= TOL * top, n
    if use_mask:   # a masked row pulls no center
        rows = labels[mask == 0].argmax(-1)
        only = set(rows) - set(labels[mask == 1].argmax(-1))
        for c in only:
            assert not got["centers"][c].any()


def test_center_loss_init_json_and_mixed_precision_match_jax():
    jlayer = jax_layers.CenterLossOutputLayer(units=4)
    layer = nnconfig.config_from_json(jax_config.config_to_json(jlayer))
    assert isinstance(layer, layers.CenterLossOutputLayer)
    assert (layer.alpha, layer.lambda_) == (0.05, 2e-4)
    assert nnconfig.config_to_dict(layer) == nnconfig.config_to_dict(
        layers.CenterLossOutputLayer(units=4))
    p, s = layer.init(torch.Generator().manual_seed(0), (7,), torch.float32)
    jp, _ = jlayer.init(jax.random.key(0), (7,), jnp.float32)
    assert {k: tuple(a.shape) for k, a in p.items()} == {
        k: tuple(a.shape) for k, a in jp.items()}
    assert not p["centers"].any() and s == {}
    # the mixed-precision step: bf16 params and features, float32 labels
    # and mask (JAX promotes c_y to float32; the guard max(Σ w, 1) with a
    # mask of one surviving row)
    params, x, labels, mask, _ = _center_inputs(1)
    mask = np.array([0, 0, 0, 1, 0, 0], np.float32)
    jl = jax_layers.CenterLossOutputLayer(units=3, lambda_=0.5)
    jb = {k: jnp.asarray(a, jnp.bfloat16) for k, a in params.items()}
    want = float(jl.compute_loss(jb, {}, jnp.asarray(x, jnp.bfloat16),
                                 labels, mask=mask))
    l = layers.CenterLossOutputLayer(units=3, lambda_=0.5)
    tb = {k: torch.tensor(a).to(torch.bfloat16) for k, a in params.items()}
    got = l.compute_loss(tb, {}, torch.tensor(x).to(torch.bfloat16),
                         torch.tensor(labels), mask=torch.tensor(mask))
    assert float(got) == pytest.approx(want, rel=TOL_BF16)


# --- l2_normalize ---------------------------------------------------------


@pytest.mark.parametrize("scale", [0.0, 1e-7, 1e-3, 1.0])
def test_l2_normalize_value_and_gradient_match_jax(scale):
    r = np.random.default_rng(3)
    x = (scale * r.standard_normal((4, 6))).astype(np.float32)
    x[1] = 0.0  # a zero row at every scale
    cot = r.standard_normal((4, 6)).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda x: jnp.sum(jax_opsnn.l2_normalize(x) * cot))(x)
    jy = np.asarray(jax_opsnn.l2_normalize(x))
    tx = torch.tensor(x, requires_grad=True)
    y = opsnn.l2_normalize(tx)
    torch.sum(y * torch.tensor(cot)).backward()
    assert np.abs(y.detach().numpy() - jy).max() <= TOL * max(
        1.0, np.abs(jy).max())
    g, jg = tx.grad.numpy(), np.asarray(jgrad)
    assert np.all(np.isfinite(g))
    assert np.abs(g - jg).max() <= TOL * np.abs(jg).max()
    # at 0 the gradient is rsqrt(eps) · the cotangent
    np.testing.assert_allclose(g[1], cot[1] * 1e6, rtol=TOL)


def test_l2_normalize_is_not_the_l2norm_vertex():
    """eps 1e-12 inside the max (the op) against the vertex's safe norm
    (Σ x² clamped at (1e-8)²): a row of 1e-9s has Σ x² = 4e-18, below
    both, so the op scales it by 1e6 and the vertex by 1e8."""
    x = torch.full((1, 4), 1e-9)
    op = opsnn.l2_normalize(x)
    vertex = x * torch.rsqrt(opsnn.safe_sq_norm(x))
    assert float(op.norm()) == pytest.approx(2e-3, rel=1e-5)
    assert float(vertex.norm()) == pytest.approx(0.2, rel=1e-5)


# --- the frozen-name check ------------------------------------------------


def test_unknown_frozen_layer_names_raise_like_jax(lenets):
    (model, _), (jmodel, _) = lenets
    with pytest.raises(ValueError) as te:
        Trainer(model, frozen_layers=["0_conv2d", "9_dense", "nope"])
    with pytest.raises(ValueError) as je:
        JaxTrainer(jmodel, frozen_layers=["0_conv2d", "9_dense", "nope"])
    assert str(te.value) == str(je.value) == \
        "frozen_layers not in model: ['9_dense', 'nope']"
    assert Trainer(model, frozen_layers=["0_conv2d"]).frozen_layers == {
        "0_conv2d"}


def test_graph_frozen_names_are_not_checked_like_jax(tiny_graphs):
    (model, _), (jmodel, _) = tiny_graphs
    assert Trainer(model, frozen_layers=["nope"]).frozen_layers == {"nope"}
    assert JaxTrainer(jmodel, frozen_layers=["nope"]).frozen_layers == {
        "nope"}
