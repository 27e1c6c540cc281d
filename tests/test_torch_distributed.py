"""The port's runtime for several processes (``runtime/device.py`` meshes, ``runtime/distributed.py``, the sharded iterator) against the JAX package, on the CPU.

Pure functions (``MeshSpec.resolve``, ``derive_shard``, ``ShrinkPolicy``,
the iterator's row blocks, the cluster trace ids) are held to the JAX
package's on a grid of cases, errors included. The host collectives run in
two gloo processes over a ``FileStore`` (``tests/_torch_dist_worker.py``,
under a hard timeout): a broadcast, a barrier, and a barrier one rank never
comes to, which must raise ``CollectiveTimeout`` at its 2 s deadline. A
world-size-1 mesh in this process runs ``examples/data_parallel_mesh.py``'s
user code with the port's imports.
"""

import json
import types

import jax
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from deeplearning4j_tpu.data import iterators as jax_iterators
from deeplearning4j_tpu.runtime import device as jax_device
from deeplearning4j_tpu.runtime import distributed as jax_distributed
from deeplearning4j_tpu_torch.data import iterators
from deeplearning4j_tpu_torch.runtime import device, distributed


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


MESH_SPECS = [dict(), dict(data=2), dict(data=-1, fsdp=2),
              dict(data=2, fsdp=2), dict(data=3, fsdp=3), dict(fsdp=-1),
              dict(data=-1, fsdp=-1), dict(data=-1, model=2),
              dict(data=1, fsdp=8), dict(data=2, fsdp=3, model=1),
              dict(data=-1, fsdp=3), dict(data=4, stage=2, seq=1)]


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("kw", MESH_SPECS, ids=str)
def test_mesh_spec_resolves_as_the_jax_package(kw, n):
    want = _outcome(lambda: jax_device.MeshSpec(**kw).resolve(n))
    got = _outcome(lambda: device.MeshSpec(**kw).resolve(n))
    assert got == want


def test_mesh_spec_counts_the_ranks_by_default():
    assert device.MeshSpec().resolve() == {"data": 1, "fsdp": 1,
                                           "model": 1, "seq": 1,
                                           "stage": 1, "expert": 1}


@pytest.mark.parametrize("kw", [dict(data=1, model=2), dict(seq=2),
                                dict(stage=2, data=-1),
                                dict(data=1, expert=2)], ids=str)
def test_meshes_with_unported_axes_raise_naming_the_roadmap_item(kw):
    with pytest.raises(NotImplementedError, match="item 8"):
        device.build_mesh(device.MeshSpec(**kw), devices_=[0, 1])


SHARD_CASES = [
    (8, 0, 2, None, "preserve_global_batch"),
    (8, 1, 2, None, "preserve_global_batch"),
    (9, 1, 3, None, "preserve_global_batch"),
    (8, 1, 3, None, "preserve_global_batch"),
    (8, 2, 2, None, "preserve_global_batch"),
    (8, -1, 2, None, "preserve_global_batch"),
    (12, 1, 3, 4, "preserve_per_worker_batch"),
    (12, 2, 3, 4, "preserve_per_worker_batch"),
    (12, 0, 4, 3, "preserve_per_worker_batch"),
    (10, 0, 3, 4, "preserve_per_worker_batch"),
    (12, 0, 3, None, "preserve_per_worker_batch"),
    (8, 0, 2, None, "no_such_policy"),
]


@pytest.mark.parametrize("case", SHARD_CASES, ids=str)
def test_derive_shard_is_the_jax_packages(case):
    n, wid, nw, base, policy = case
    kw = dict(baseline_num_workers=base, policy=policy)
    assert _outcome(lambda: iterators.derive_shard(n, wid, nw, **kw)) == \
        _outcome(lambda: jax_iterators.derive_shard(n, wid, nw, **kw))


@pytest.mark.parametrize("env", [None, "preserve_per_worker_batch",
                                 " PRESERVE_GLOBAL_BATCH ", "junk", ""])
def test_shrink_policy_and_baseline_from_env(monkeypatch, env):
    for name in (iterators.ENV_SHRINK_POLICY,
                 iterators.ENV_BASELINE_NUM_WORKERS):
        monkeypatch.delenv(name, raising=False)
    if env is not None:
        monkeypatch.setenv(iterators.ENV_SHRINK_POLICY, env)
    assert iterators.ShrinkPolicy.from_env() == \
        jax_iterators.ShrinkPolicy.from_env()
    assert iterators.ShrinkPolicy.ALL == jax_iterators.ShrinkPolicy.ALL
    for raw in (None, "4", "0", "x", "-2"):
        if raw is None:
            monkeypatch.delenv(iterators.ENV_BASELINE_NUM_WORKERS,
                               raising=False)
        else:
            monkeypatch.setenv(iterators.ENV_BASELINE_NUM_WORKERS, raw)
        assert iterators.baseline_num_workers_from_env() == \
            jax_iterators.baseline_num_workers_from_env()


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("index,count,baseline,policy", [
    (0, 1, None, None), (1, 2, None, None), (2, 4, None, None),
    (1, 3, 4, "preserve_per_worker_batch"), (2, 3, 4,
                                              "preserve_global_batch")])
def test_sharded_iterator_rows_are_the_jax_packages(monkeypatch, local, index,
                                                    count, baseline, policy):
    monkeypatch.setattr(jax_iterators.jax, "process_count", lambda: count)
    monkeypatch.setattr(jax_iterators.jax, "process_index", lambda: index)
    monkeypatch.setattr(distributed, "process_count", lambda: count)
    monkeypatch.setattr(distributed, "process_index", lambda: index)
    jmesh = jax_device.build_mesh(jax_device.MeshSpec(data=-1),
                                  devices_=jax.devices()[:1])
    mesh = types.SimpleNamespace(mesh=torch.arange(count))
    kw = dict(local=local, shrink_policy=policy,
              baseline_num_workers=baseline)
    rows = np.arange(24 * 3).reshape(24, 3)
    want = jax_iterators.ShardedDataSetIterator(
        [], jmesh, None, **kw)._proc_slice(rows)
    got = iterators.ShardedDataSetIterator([], mesh, None,
                                           **kw)._proc_slice(rows)
    np.testing.assert_array_equal(got, want)


def test_sharded_iterator_refuses_a_mesh_that_interleaves_ranks(monkeypatch):
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    mesh = types.SimpleNamespace(mesh=torch.tensor([[1], [0]]))
    with pytest.raises(ValueError, match="interleaves"):
        iterators.ShardedDataSetIterator([], mesh, None)
    with pytest.raises(ValueError, match="shrink policy"):
        iterators.ShardedDataSetIterator([], types.SimpleNamespace(
            mesh=torch.arange(2)), None, shrink_policy="bogus")


@pytest.mark.parametrize("step", [0, 1, 77, 2 ** 32 + 5])
def test_step_trace_ids_are_the_jax_packages(monkeypatch, step):
    cid = "0123456789abcdef"
    monkeypatch.setattr(jax_distributed, "_CLUSTER_TRACE_ID", cid)
    monkeypatch.setattr(distributed, "_CLUSTER_TRACE_ID", cid)
    assert distributed.step_trace_id(step) == \
        jax_distributed.step_trace_id(step)
    assert distributed.step_root_span_id(step) == \
        jax_distributed.step_root_span_id(step)
    monkeypatch.setattr(jax_distributed, "_CURRENT_STEP", 0)
    monkeypatch.setattr(distributed, "_CURRENT_STEP", 0)
    distributed.note_step(step)
    jax_distributed.note_step(step)
    assert distributed.current_step() == jax_distributed.current_step()
    assert distributed.step_trace_id() == jax_distributed.step_trace_id()
    distributed.reset_cluster_trace()
    assert distributed.step_trace_id(step) is None
    assert distributed.cluster_trace_id() is None


def test_one_process_host_collectives_are_local():
    assert not distributed.is_multiprocess()
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    distributed.barrier(timeout_s=0.1)
    distributed.checkpoint_sync(timeout_s=0.1)
    assert distributed.broadcast_host_data({"a": 1}) == {"a": 1}
    tid = distributed.establish_cluster_trace()
    assert len(tid) == 16 and distributed.establish_cluster_trace() == tid
    distributed.reset_cluster_trace()


def test_initialize_reads_its_arguments_and_the_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              distributed.ENV_COORDINATOR_ADDRESS,
              distributed.ENV_COORDINATOR_PORT, "DL4J_TPU_NUM_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()  # nothing set: one process, nothing joined
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=2, process_id=0)
    monkeypatch.setenv("DL4J_TPU_NUM_WORKERS", "3")
    with pytest.raises(RuntimeError, match="DL4J_TPU_COORDINATOR"):
        distributed.initialize_from_env()
    monkeypatch.setenv(distributed.ENV_COORDINATOR_PORT, "1234")
    assert distributed._coordinator_from_env() == "127.0.0.1:1234"
    monkeypatch.setenv(distributed.ENV_COLLECTIVE_TIMEOUT, "0")
    assert distributed.default_collective_timeout_s() is None
    monkeypatch.setenv(distributed.ENV_COLLECTIVE_TIMEOUT, "junk")
    assert distributed.default_collective_timeout_s() == 300.0


def test_collective_timeout_carries_what_the_jax_packages_does():
    from deeplearning4j_tpu.resilience.cluster import CollectiveTimeout

    want = CollectiveTimeout("m", op="barrier:x", timeout_s=2.0, dead=[1])
    got = distributed.CollectiveTimeout("m", op="barrier:x", timeout_s=2.0,
                                        dead=[1])
    assert isinstance(got, RuntimeError)
    assert vars(got) == vars(want)


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    wd = tmp_path_factory.mktemp("collectives")
    W.collect(W.launch("collectives", 2, wd), 120)
    return [json.loads((wd / f"collectives.rank{r}.json").read_text())
            for r in range(2)]


def test_ranks_agree_on_the_trace_id_and_the_broadcast(collectives):
    a, b = collectives
    assert a["trace"] == b["trace"] and len(a["trace"]) == 16
    assert a["value"] == b["value"] == {"rank": 0, "x": [0, 7]}


def test_a_barrier_with_a_rank_absent_times_out(collectives):
    t = collectives[0]["timeout"]
    assert t is not None, "the barrier returned with a rank absent"
    assert t["op"] == "barrier:alone" and t["timeout_s"] == 2.0
    assert 2.0 <= t["seconds"] < 5.0


def test_data_parallel_mesh_example_runs_in_the_port():
    """``examples/data_parallel_mesh.py``'s ``main(quick=True)`` with the
    port's imports, on a world-size-1 gloo mesh (``device="cpu"`` where the
    port would take the card): the mesh trainer's params equal the plain
    trainer's."""
    from deeplearning4j_tpu_torch.data import ArrayDataSetIterator, load_mnist
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.parallel.specs import data_parallel_plan
    from deeplearning4j_tpu_torch.runtime.device import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.train.trainer import Trainer
    from deeplearning4j_tpu_torch.train.updaters import Adam
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    try:
        mesh = build_mesh(MeshSpec(data=-1), device="cpu")
        state_sh, batch_sh = data_parallel_plan(mesh)
        (xtr, ytr), _, _ = load_mnist(n_train=1024, n_test=64)
        model = lenet(updater=Adam(3e-3), device="cpu")
        trainer = Trainer(model, mesh=mesh, state_sharding=state_sh,
                          batch_sharding=batch_sh)
        ts = trainer.init_state()
        it = ArrayDataSetIterator(xtr, ytr, batch_size=256, drop_last=True)
        ts = trainer.fit(ts, it, epochs=1)
        single = Trainer(lenet(updater=Adam(3e-3), device="cpu"))
        ts1 = single.fit(single.init_state(), ArrayDataSetIterator(
            xtr, ytr, batch_size=256, drop_last=True), epochs=1)
        assert ts.step == ts1.step == 4
        for a, b in zip(tree_leaves(trainer.variables(ts)["params"]),
                        tree_leaves(single.variables(ts1)["params"])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert distributed.process_count() == 1
    finally:
        distributed.shutdown()


def test_batchnorm_axis_name_is_bound_only_in_a_data_parallel_step():
    """As an unbound axis name raises in JAX: a training forward of
    ``BatchNorm(axis_name=...)`` outside ``Trainer(mesh=...)`` raises;
    inference reads no replicas."""
    from deeplearning4j_tpu_torch.nn.layers.norm import BatchNorm

    bn = BatchNorm(axis_name="data")
    params, state = bn.init(None, (4,), torch.float32)
    x = torch.randn(3, 4)
    with pytest.raises(ValueError, match="axis name 'data'"):
        bn.apply(params, state, x, train=True)
    y, same = bn.apply(params, state, x, train=False)
    assert y.shape == x.shape and same is state
