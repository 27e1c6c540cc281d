"""Data-parallel and FSDP training of the port (``Trainer(mesh=...)``) against the single-device step on the global batch, on the CPU.

Ranks run as processes over gloo (``tests/_torch_dist_worker.py``; a
``FileStore`` in the test's directory, one job a module-scoped fixture,
each under a hard timeout). The model is ``test_torch_resnet.py``'s small
ResNet (``resnet_config(blocks=(1, 1), input_shape=(32, 32, 3),
num_classes=10)``) from the JAX package's variables. Every trained case is
held, at the JAX package's tolerance for its own sharded-vs-single tests
(rtol 2e-5 / atol 1e-6 on every param leaf, optimizer moment, BatchNorm
state and the loss), to

- the port's single-process step on the global batch (the contract of
  ``tests/test_parallel.py``'s ``test_dp_matches_single_device``), and
- the JAX package's single-device Trainer on the global batch, run in this
  process under ``jax.enable_x64`` on float64 copies: the JAX package's
  float32 step is not accurate enough to be held to that tolerance here
  (on batch ``b0`` its gradient of ``s1b0_a_bn/beta`` lies 2.1e-3, 11% of
  the leaf's largest entry, from float64, where the port's float32 lies
  within 2e-7). Under ``grad_accum`` even the x64 step keeps BatchNorm's
  statistics in float32 (its ``x.astype(jnp.float32)``) and lies up to
  8.8e-5 from the float64 function, 1.9e-5 in float32, while the port's
  float32 lies within 1e-7 of the port's float64 step: that case is held
  to the port's float64 single-process step at this tolerance, and to the
  JAX package's float32 step at a looser one that still parts a rank
  taking its microbatches from its own contiguous block of the batch
  (each leaf's max |difference| over its largest entry, and the loss).
  Measured, world size 2: the data-parallel step 4.7e-3 of the worst
  leaf's max (``s1b0_c_bn/beta``) and the loss 4e-7 relative from the
  JAX float32 step (2.7e-2 from its x64 step, which lies as far from its
  own float32 step); that fault 1.10 (``s1b0_a_bn/beta``) and 4.5e-3.

The cases: one SGD step, two Adam steps, ``grad_accum=2``,
``clip_l2_global``, ``frozen_layers``, a masked loss whose ranks' rows
weigh differently (``loss_weight``) and an LSTM trained by truncated BPTT
through ``fit`` (two windows and a tail) at world size 2; DP and FSDP at
world size 4 (``MeshSpec(data=2, fsdp=2)``). BatchNorm with ``axis_name``,
and batches from ``ShardedDataSetIterator``, give the global-batch step
bit for bit.

Adam's ε is 1e-3 here: at 1e-8 an entry whose gradient is rounding noise
moves by ±lr (``test_torch_resnet.py`` holds that case), and ε = 1e-3 keeps
the update Lipschitz in the gradient. Every rank's state is held
bit-identical to every other's.
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_worker as W
from deeplearning4j_tpu.evaluation import classification as jax_eval
from deeplearning4j_tpu.models.zoo import resnet as jax_resnet
from deeplearning4j_tpu.nn import config as jax_config
from deeplearning4j_tpu.nn.layers import (
    LSTM,
    BatchNorm,
    Dense,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu.nn.model import GraphModel as JaxGraphModel
from deeplearning4j_tpu.nn.model import SequentialModel as JaxSequential
from deeplearning4j_tpu.parallel import specs as jax_specs
from deeplearning4j_tpu.runtime import device as jax_device
from deeplearning4j_tpu.serde import checkpoint as jax_ckpt
from deeplearning4j_tpu.train import updaters as ju
from deeplearning4j_tpu.train.trainer import Trainer as JaxTrainer
from deeplearning4j_tpu_torch.parallel import specs
from deeplearning4j_tpu_torch.train.trainer import Trainer
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names, tree_map

SMALL = dict(blocks=(1, 1), input_shape=(32, 32, 3), num_classes=10)
RTOL, ATOL = 2e-5, 1e-6
N = 8
JOB_TIMEOUT_S = 300
SGD = ju.Sgd(0.1)
ADAM = ju.Adam(1e-3, eps=1e-3)
FROZEN = ["stem_conv", "stem_bn", "s0b0_a_conv"]


def _resnet_json(updater, **net):
    cfg = jax_resnet.resnet_config(**SMALL, updater=updater)
    for k, v in net.items():
        setattr(cfg.net, k, v)
    return cfg.to_json()


def _mlp_json():
    return jax_config.SequentialConfig(
        net=jax_config.NeuralNetConfiguration(seed=3, updater=SGD),
        input_shape=(16,),
        layers=[Dense(units=32, activation="relu"), BatchNorm(),
                OutputLayer(units=4, activation="softmax", loss="mcxent")],
    ).to_json()


def _axis_name_json():
    """The small ResNet with every BatchNorm's ``axis_name`` "data"."""
    cfg = json.loads(_resnet_json(SGD))
    for v in cfg["vertices"].values():
        layer = v.get("layer") or {}
        if layer.get("@class") == "BatchNorm":
            layer["axis_name"] = "data"
    return json.dumps(cfg)


def _rnn_json():
    """An LSTM under truncated BPTT: 7 steps in windows of 3 (two windows
    and a tail of one)."""
    return jax_config.SequentialConfig(
        net=jax_config.NeuralNetConfiguration(
            seed=5, updater=ADAM, backprop_type="tbptt", tbptt_length=3),
        input_shape=(7, 5),
        layers=[LSTM(units=8),
                RnnOutputLayer(units=4, activation="softmax",
                               loss="mcxent")],
    ).to_json()


def _images(seed, n):
    r = np.random.default_rng(seed)
    return {"features": r.standard_normal((n, 32, 32, 3), dtype=np.float32),
            "labels": np.eye(10, dtype=np.float32)[r.integers(0, 10, n)]}


@functools.lru_cache(maxsize=None)
def _inputs():
    jm = JaxGraphModel(jax_config.GraphConfig.from_json(_resnet_json(SGD)))
    v = jax.tree_util.tree_map(np.array, jax.jit(
        lambda: jm.init(seed=1))())
    r = np.random.default_rng(2)
    for s in v["state"].values():
        s["mean"] = (0.1 * r.standard_normal(s["mean"].shape)).astype(
            np.float32)
        s["var"] = (1.0 + r.random(s["var"].shape)).astype(np.float32)
    mlp = JaxSequential(jax_config.SequentialConfig.from_json(_mlp_json()))
    mv = jax.tree_util.tree_map(np.array, mlp.init(seed=3))
    rnn = JaxSequential(jax_config.SequentialConfig.from_json(_rnn_json()))
    rv = jax.tree_util.tree_map(np.array, rnn.init(seed=5))
    r = np.random.default_rng(4)
    masked = {"features": r.standard_normal((N, 16), dtype=np.float32),
              "labels": np.eye(4, dtype=np.float32)[r.integers(0, 4, N)],
              # rank 0's rows weigh 3, rank 1's 1 (world size 2)
              "mask": np.array([1, 1, 1, 0, 1, 0, 0, 0], np.float32)}
    r = np.random.default_rng(6)
    seq = {"features": r.standard_normal((N, 7, 5), dtype=np.float32),
           "labels": np.eye(4, dtype=np.float32)[r.integers(0, 4, (N, 7))]}
    # "a0": two microbatches of N rows each under grad_accum=2
    a0 = _images(12, 2 * N)
    # a0's rows in the order a grad_accum=2 step over 2 ranks takes them
    # when each rank splits its own contiguous block into microbatches
    blocks = np.r_[0:N // 2, N:N + N // 2, N // 2:N, N + N // 2:2 * N]
    batches = {"b0": _images(10, N), "b1": _images(11, N), "s0": seq,
               "a0": a0, "a0_blocks": {k: a[blocks] for k, a in a0.items()},
               "m0": masked,
               "e0": _images(20, N), "e1": _images(21, N),
               "e2": _images(22, 5)}
    arrays = {f"resnet/{n}": a for n, a in flatten_with_names(v)}
    arrays.update({f"mlp/{n}": a for n, a in flatten_with_names(mv)})
    arrays.update({f"rnn/{n}": a for n, a in flatten_with_names(rv)})
    for b, tree in batches.items():
        arrays.update({f"batch/{b}/{n}": a
                       for n, a in flatten_with_names(tree)})
    return arrays, v, mv, batches


def _case(config, batches, **kw):
    return dict(kind="graph", config=config, variables="resnet",
                batches=batches, **kw)


CASES = {
    "w2": {  # MeshSpec(data=-1) over 2 ranks
        "sgd": _case(_resnet_json(SGD), ["b0"], mesh=[2, 1]),
        "adam": _case(_resnet_json(ADAM), ["b0", "b1"], mesh=[2, 1]),
        "accum": _case(_resnet_json(SGD), ["a0"], mesh=[2, 1],
                       grad_accum=2),
        "clip": _case(_resnet_json(SGD, gradient_normalization=
                                   "clip_l2_global",
                                   gradient_normalization_threshold=0.5),
                      ["b0"], mesh=[2, 1]),
        "frozen": _case(_resnet_json(ADAM), ["b0"], mesh=[2, 1],
                        frozen=FROZEN),
        "masked": dict(kind="weighted", config=_mlp_json(),
                       variables="mlp", batches=["m0"], mesh=[2, 1]),
        "tbptt": dict(kind="sequential", config=_rnn_json(),
                      variables="rnn", batches=["s0"], mesh=[2, 1],
                      fit=True),
        "axis_name": _case(_axis_name_json(), ["b0"], mesh=[2, 1]),
        "iterator": _case(_resnet_json(SGD), ["b0"], mesh=[2, 1],
                          iterator=True),
        "iterator_accum": _case(_resnet_json(SGD), ["a0"], mesh=[2, 1],
                                grad_accum=2, iterator=True),
        "eval": _case(_resnet_json(SGD), ["e0", "e1", "e2"], mesh=[2, 1],
                      eval=10),
        # 5 rows over 2 ranks
        "ragged": _case(_resnet_json(SGD), ["e2"], mesh=[2, 1],
                        refused=True),
    },
    "w4": {  # MeshSpec(data=2, fsdp=2)
        "dp_sgd": _case(_resnet_json(SGD), ["b0"], mesh=[2, 2]),
        "dp_adam": _case(_resnet_json(ADAM), ["b0", "b1"], mesh=[2, 2]),
        "fsdp_sgd": _case(_resnet_json(SGD), ["b0"], mesh=[2, 2],
                          plan="fsdp"),
        "fsdp_clip": _case(_resnet_json(SGD, gradient_normalization=
                                        "clip_l2_global",
                                        gradient_normalization_threshold=0.5),
                           ["b0"], mesh=[2, 2], plan="fsdp"),
        "fsdp_adam": _case(_resnet_json(ADAM), ["b0", "b1"], mesh=[2, 2],
                           plan="fsdp", save="ckpt4"),
    },
    "r2": {  # the world-4 FSDP checkpoint restored at world size 2
        "restore_dp2": _case(_resnet_json(ADAM), [], mesh=[2, 1],
                             restore="ckpt4/checkpoint_2"),
        "restore_fsdp2": _case(_resnet_json(ADAM), [], mesh=[1, 2],
                               plan="fsdp", restore="ckpt4/checkpoint_2"),
        # the same state after a round trip through the JAX package
        "restore_jax_fsdp2": _case(_resnet_json(ADAM), [], mesh=[1, 2],
                                   plan="fsdp",
                                   restore="ckptj/checkpoint_2"),
    },
    "r1": {
        "restore_1": _case(_resnet_json(ADAM), [], mesh=[1, 1],
                           restore="ckpt4/checkpoint_2"),
    },
}
WORLD = {"w2": 2, "w4": 4, "r2": 2, "r1": 1}
# held to the port's float64 single-process step, not the JAX x64 one
FLOAT64_PORT = {"accum"}
# grad_accum against the JAX float32 step: each leaf's max |difference|
# over its largest entry, the loss relative (measured: 4.7e-3 and 4e-7;
# a rank splitting its own block: 1.10 and 4.5e-3)
ACCUM_LEAF_FRAC, ACCUM_LOSS_REL = 5e-2, 5e-5
# each compared case → (its job, the JAX reference's case)
TRAINED = {"sgd": "w2", "adam": "w2", "accum": "w2", "clip": "w2",
           "frozen": "w2", "masked": "w2", "tbptt": "w2",
           "dp_sgd": "w4", "dp_adam": "w4",
           "fsdp_sgd": "w4", "fsdp_clip": "w4", "fsdp_adam": "w4"}


def _jax_reference(spec, arrays, x64=True):
    """The JAX Trainer's steps on the global batches, in float64 (float32
    when not ``x64``) → (state as numpy by name, losses)."""
    if spec["kind"] == "graph":
        model = JaxGraphModel(jax_config.GraphConfig.from_json(
            spec["config"]))
    else:
        model = JaxSequential(jax_config.SequentialConfig.from_json(
            spec["config"]))

    def f64(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64 if x64 else jnp.float32),
            tree)

    with jax.enable_x64(x64):
        trainer = JaxTrainer(model, grad_accum=spec.get("grad_accum", 1),
                             frozen_layers=spec.get("frozen"))
        v = W._tree(arrays, spec["variables"])
        v.setdefault("state", {})  # a tree of no state has no leaves
        ts = trainer.init_state(f64(v))
        losses = []
        for b in spec["batches"]:
            batch = f64(W._tree(arrays, f"batch/{b}"))
            if spec.get("fit"):
                seen = []
                ts = trainer.fit(ts, [batch], listeners=[W._Losses(seen)])
                losses.append(seen)
                continue
            ts, m = trainer.train_step(ts, batch)
            losses.append(float(m["total_loss"]))
        got = {n: np.asarray(a) for n, a in flatten_with_names(
            {"params": ts.params, "model_state": ts.model_state,
             "opt_state": ts.opt_state})}
    return got, losses


def _port_reference(spec, arrays, dtype=np.float32):
    """The port's single-process Trainer on the global batches → (state
    as numpy by name, losses)."""
    import torch

    def cast(tree):
        return tree_map(lambda a: torch.from_numpy(np.asarray(a, dtype)),
                        tree)

    trainer = Trainer(W._model(spec), grad_accum=spec.get("grad_accum", 1),
                      frozen_layers=spec.get("frozen"))
    ts = trainer.init_state(cast(W._tree(arrays, spec["variables"])))
    losses = []
    for b in spec["batches"]:
        batch = cast(W._tree(arrays, f"batch/{b}"))
        if spec.get("fit"):
            seen = []
            ts = trainer.fit(ts, [batch], listeners=[W._Losses(seen)])
            losses.append(seen)
            continue
        ts, m = trainer.train_step(ts, batch)
        losses.append(float(m["total_loss"]))
    got = {n: a.numpy() for n, a in flatten_with_names(
        {"params": ts.params, "model_state": ts.model_state,
         "opt_state": ts.opt_state})}
    return got, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job's ranks' results and the JAX references: the world-2
    and world-4 jobs run while the JAX steps compute here, then the
    restores of the world-4 checkpoint."""
    wd = tmp_path_factory.mktemp("dp")
    arrays, *_ = _inputs()
    np.savez(wd / "inputs.npz", **arrays)
    (wd / "cases.json").write_text(json.dumps(CASES))
    first = [(job, W.launch(job, WORLD[job], wd)) for job in ("w4", "w2")]
    refs = {name: (_port_reference(CASES[job][name], arrays, np.float64)
                   if name in FLOAT64_PORT else
                   _jax_reference(CASES[job][name], arrays))
            for name, job in TRAINED.items()}
    single = {name: _port_reference(CASES[job][name], arrays)
              for name, job in TRAINED.items()}
    accum = CASES["w2"]["accum"]
    jax32_accum = _jax_reference(accum, arrays, x64=False)
    split_blocks = _port_reference(dict(accum, batches=["a0_blocks"]),
                                   arrays)
    for _, procs in first:
        W.collect(procs, JOB_TIMEOUT_S)
    spec = CASES["w4"]["fsdp_adam"]
    jmodel = JaxGraphModel(jax_config.GraphConfig.from_json(spec["config"]))
    jtrainer = JaxTrainer(jmodel)
    jts = jax_ckpt.restore_checkpoint(
        wd / "ckpt4" / "checkpoint_2", jtrainer.init_state(
            jax.tree_util.tree_map(jnp.asarray, W._tree(arrays, "resnet"))))
    jax_ckpt.save_checkpoint(wd / "ckptj", jts, model=jmodel)
    last = [W.launch(job, WORLD[job], wd) for job in ("r2", "r1")]
    for procs in last:
        W.collect(procs, JOB_TIMEOUT_S)

    def load(case, rank):
        with np.load(wd / f"{case}.rank{rank}.npz") as z:
            return {k: z[k] for k in z.files}

    got = {case: [load(case, r) for r in range(WORLD[job])]
           for job, cases in CASES.items() for case in cases
           if not cases[case].get("refused")}
    return types.SimpleNamespace(dir=wd, arrays=arrays, refs=refs,
                                 single=single, got=got,
                                 jax32_accum=jax32_accum,
                                 split_blocks=split_blocks)


def _held(got, ref, case):
    want, losses = ref
    for i, loss in enumerate(losses):
        np.testing.assert_allclose(got[f"out/loss{i}"], loss, rtol=RTOL)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case}: {n}")


@pytest.mark.parametrize("case", sorted(TRAINED))
def test_step_is_the_ports_single_process_step(runs, case):
    _held(runs.got[case][0], runs.single[case], case)


@pytest.mark.parametrize("case", sorted(TRAINED))
def test_step_matches_the_jax_single_device_step(runs, case):
    _held(runs.got[case][0], runs.refs[case], case)


def _accum_errors(got, ref):
    """(worst leaf's max |difference| over its largest entry, that leaf,
    the loss's relative difference) of a grad_accum step against ``ref``."""
    want, (loss,) = ref
    fracs = {n: float(np.abs(got[n] - w).max())
             / max(float(np.abs(w).max()), 1e-30)
             for n, w in want.items()}
    worst = max(fracs, key=fracs.get)
    return (fracs[worst], worst,
            abs(float(got["out/loss0"]) - loss) / abs(loss))


@pytest.mark.parametrize("case", ["accum", "iterator_accum"])
def test_grad_accum_matches_the_jax_float32_step(runs, case):
    frac, leaf, loss_rel = _accum_errors(runs.got[case][0],
                                         runs.jax32_accum)
    assert frac <= ACCUM_LEAF_FRAC, (leaf, frac)
    assert loss_rel <= ACCUM_LOSS_REL, loss_rel


def test_grad_accum_check_parts_a_rank_splitting_its_own_block(runs):
    """Rank r's rows of global microbatch j are its share of that
    microbatch; a rank that took its contiguous block of the batch and
    split it reads far outside the check above."""
    want, losses = runs.split_blocks
    fault = dict(want, **{"out/loss0": losses[0]})
    frac, leaf, loss_rel = _accum_errors(fault, runs.jax32_accum)
    assert frac > 10 * ACCUM_LEAF_FRAC, (leaf, frac)
    assert loss_rel > 10 * ACCUM_LOSS_REL, loss_rel


@pytest.mark.parametrize("case", sorted(TRAINED) + [
    "iterator", "iterator_accum", "axis_name"])
def test_every_rank_holds_the_same_state(runs, case):
    ranks = runs.got[case]
    for other in ranks[1:]:
        for n, a in ranks[0].items():
            if n != "out/local_bytes":
                np.testing.assert_array_equal(other[n], a, err_msg=n)


@pytest.mark.parametrize("case,base", [("iterator", "sgd"),
                                       ("iterator_accum", "accum"),
                                       ("axis_name", "sgd")])
def test_sharded_iterator_batches_give_the_global_batch_step(runs, case,
                                                             base):
    got, want = runs.got[case][0], runs.got[base][0]
    for n, a in want.items():
        if n != "out/local_bytes":
            np.testing.assert_array_equal(got[n], a, err_msg=n)


@pytest.mark.parametrize("case", ["fsdp_sgd", "fsdp_adam", "fsdp_clip"])
def test_fsdp_ranks_hold_shards(runs, case):
    full = sum(a.size for n, a in runs.got[case][0].items()
               if n.startswith("params/"))
    dp = int(runs.got["dp_sgd"][0]["out/local_bytes"])
    local = int(runs.got[case][0]["out/local_bytes"])
    assert dp == full
    assert local < 0.6 * full  # most of the small ResNet's params split


def test_a_batch_the_ranks_do_not_divide_is_refused(runs):
    for r in range(2):
        msg = (runs.dir / f"ragged.rank{r}.txt").read_text()
        assert "global batch 5 not divisible by the 2 ranks" in msg


def test_masked_ranks_weigh_differently():
    """The masked case is a test of weighting only if its ranks' rows
    carry different loss weight."""
    mask = _inputs()[3]["m0"]["mask"]
    assert mask[:N // 2].sum() != mask[N // 2:].sum()


def test_sharded_evaluation_counts_every_row_once(runs):
    _, v, _, batches = _inputs()
    cms = [g["cm"] for g in runs.got["eval"]]
    for cm in cms[1:]:
        np.testing.assert_array_equal(cm, cms[0])
    model = JaxGraphModel(jax_config.GraphConfig.from_json(
        _resnet_json(SGD)))
    jev = jax_eval.evaluate_model(
        model, jax.tree_util.tree_map(jnp.asarray, v),
        [batches[b] for b in ("e0", "e1", "e2")], 10)
    np.testing.assert_array_equal(cms[0], np.asarray(jev.cm))
    assert cms[0].sum() == 2 * N + 5


@pytest.mark.parametrize("case", ["restore_1", "restore_dp2",
                                  "restore_fsdp2", "restore_jax_fsdp2"])
def test_fsdp_checkpoint_restores_bit_equal_at_any_world_size(runs, case):
    saved = runs.got["fsdp_adam"][0]
    for rank in runs.got[case]:
        for n, a in saved.items():
            if n.startswith(("params/", "model_state/", "opt_state/")):
                np.testing.assert_array_equal(rank[n], a, err_msg=n)
        assert int(rank["step"]) == 2
    assert bool(runs.got["restore_fsdp2"][0]["out/sharded"])
    assert not bool(runs.got["restore_dp2"][0]["out/sharded"])


def test_fsdp_checkpoint_restores_in_the_jax_package(runs):
    spec = CASES["w4"]["fsdp_adam"]
    model = JaxGraphModel(jax_config.GraphConfig.from_json(spec["config"]))
    trainer = JaxTrainer(model)
    v = W._tree(runs.arrays, "resnet")
    tmpl = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, v))
    ts = jax_ckpt.restore_checkpoint(runs.dir / "ckpt4" / "checkpoint_2",
                                     tmpl)
    saved = runs.got["fsdp_adam"][0]
    got = {n: np.asarray(a) for n, a in flatten_with_names(
        {"params": ts.params, "model_state": ts.model_state,
         "opt_state": ts.opt_state})}
    assert got.keys() == {n for n in saved if n.startswith(
        ("params/", "model_state/", "opt_state/"))}
    for n, a in got.items():
        np.testing.assert_array_equal(a, saved[n], err_msg=n)
    assert int(ts.step) == 2


# -- plans, in this process --------------------------------------------------


def _fake_mesh(fsdp):
    """What ``fsdp_plan`` reads of a mesh: its axis names and shape."""
    return types.SimpleNamespace(mesh_dim_names=("data", "fsdp"),
                                 mesh=np.zeros((8 // fsdp, fsdp)))


def _shape_templates():
    small = JaxGraphModel(jax_resnet.resnet_config(**SMALL))
    full = jax_resnet.resnet50(num_classes=1000)
    return {"small": jax.eval_shape(small.init)["params"],
            "resnet50": jax.eval_shape(full.init)["params"]}


@pytest.mark.parametrize("fsdp", [2, 4, 8])
@pytest.mark.parametrize("which", ["small", "resnet50"])
def test_fsdp_plan_picks_the_jax_packages_dim_for_every_leaf(which, fsdp):
    import torch

    tmpl = _shape_templates()[which]
    mesh = jax_device.build_mesh(
        jax_device.MeshSpec(data=8 // fsdp, fsdp=fsdp),
        devices_=jax.devices()[:8])
    jax_sh, _ = jax_specs.fsdp_plan(mesh, tmpl)
    meta = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), tmpl)
    port_sh, batch = specs.fsdp_plan(_fake_mesh(fsdp), meta)
    want = {n: tuple(s.spec) for n, s in flatten_with_names(jax_sh)}
    got = {n: tuple(s.spec) for n, s in flatten_with_names(port_sh)}
    assert got == want
    assert tuple(batch.spec) == (("data", "fsdp"),)
    assert sum(s != () for s in got.values()) > 0


def test_train_state_sharding_mirrors_params_into_the_optimizer_state():
    from deeplearning4j_tpu_torch.train.trainer import RngKey, TrainState

    mesh = _fake_mesh(2)
    params = {"a": {"W": np.zeros((64, 32))}, "b": {"b": np.zeros(3)}}
    ps, _ = specs.fsdp_plan(mesh, params, min_shard_elems=16)
    ts = TrainState(params=params, model_state={"bn": {"mean": np.zeros(3)}},
                    opt_state={"m": params, "v": params}, step=0,
                    rng=RngKey(0))
    sh = specs.train_state_sharding(mesh, ts, ps)
    assert tuple(sh.params["a"]["W"].spec) == ("fsdp", None)
    assert sh.opt_state["m"]["a"]["W"] == sh.params["a"]["W"]
    assert tuple(sh.opt_state["v"]["b"]["b"].spec) == ()
    assert tuple(sh.model_state["bn"]["mean"].spec) == ()
    assert specs.train_state_sharding(mesh, ts) == specs.replicated(mesh)
