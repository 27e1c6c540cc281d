"""One rank of the port's multi-process CPU tests (``tests/test_torch_parallel.py``, ``tests/test_torch_distributed.py``).

    python tests/_torch_dist_worker.py JOB RANK WORLD WORKDIR

joins a gloo process group over a ``FileStore`` in WORKDIR (no TCP port),
runs JOB's cases on the CPU with torch held to 2 threads, and writes what
each case computed to ``WORKDIR/<case>.rank<r>.npz``. The cases are given
by the parent in ``WORKDIR/cases.json`` (model config JSON, plan, mesh,
batches by name) and the arrays in ``WORKDIR/inputs.npz``. The parent
imports this module for :func:`launch` and :func:`collect`; the port is
imported only inside the rank process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def launch(job: str, world: int, workdir: Path):
    """Start the job's ``world`` rank processes. ``MKL_CBWR=COMPATIBLE``
    pins MKL to one code path: without it ``torch.sqrt`` on the CPU (MKL
    VML) returned, for the same float32 input, values 2e-4 apart in about
    one run of four on a loaded machine, which parted the ranks' Adam
    updates though their gradients were bit-identical."""
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_CBWR="COMPATIBLE",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(world), str(workdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def collect(procs, timeout_s: float):
    """Wait for every rank under one hard deadline; kill them all and
    raise when it passes; raise with the output of a rank that failed."""
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"ranks still running after {timeout_s} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{out[-4000:]}")
    return outs


# -- inside a rank ---------------------------------------------------------------


def _tree(arrays, prefix):
    from deeplearning4j_tpu_torch.utils.pytree import unflatten

    cut = len(prefix) + 1
    return unflatten((k[cut:], arrays[k]) for k in arrays
                     if k.startswith(prefix + "/"))


def _model(spec):
    import torch

    from deeplearning4j_tpu_torch.nn import config as nnconfig
    from deeplearning4j_tpu_torch.nn import layers  # noqa: F401 registry
    from deeplearning4j_tpu_torch.nn.model import GraphModel, SequentialModel
    from deeplearning4j_tpu_torch.train import updaters  # noqa: F401

    class WeightedSequential(SequentialModel):
        def loss_weight(self, batch):
            return torch.sum(batch["mask"])

    if spec["kind"] == "graph":
        return GraphModel(nnconfig.GraphConfig.from_json(spec["config"]),
                          device="cpu")
    cls = WeightedSequential if spec["kind"] == "weighted" else \
        SequentialModel
    return cls(nnconfig.SequentialConfig.from_json(spec["config"]),
               device="cpu")


def _save(path, tree):
    import torch

    from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

    np.savez(path, **{n: (a.detach().cpu().numpy() if torch.is_tensor(a)
                          else np.asarray(a))
                      for n, a in flatten_with_names(tree)})


def _trainer(spec, model, variables, mesh):
    from deeplearning4j_tpu_torch.parallel.specs import (
        data_parallel_plan,
        fsdp_plan,
        train_state_sharding,
    )
    from deeplearning4j_tpu_torch.train.trainer import Trainer

    kw = dict(grad_accum=spec.get("grad_accum", 1),
              frozen_layers=spec.get("frozen"))
    if spec.get("plan") == "fsdp":
        ts0 = Trainer(model, **kw).init_state(variables)
        params_sh, batch_sh = fsdp_plan(mesh, ts0.params)
        state_sh = train_state_sharding(mesh, ts0, params_sh)
    else:
        state_sh, batch_sh = data_parallel_plan(mesh)
    return Trainer(model, mesh=mesh, state_sharding=state_sh,
                   batch_sharding=batch_sh, **kw), batch_sh


def _run(name, spec, arrays, workdir: Path, rank: int, meshes: dict):
    from torch.distributed.tensor import DTensor

    from deeplearning4j_tpu_torch.data.iterators import ShardedDataSetIterator
    from deeplearning4j_tpu_torch.evaluation import evaluate_model
    from deeplearning4j_tpu_torch.runtime.device import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.serde import checkpoint as ckpt

    shape = tuple(spec["mesh"])
    if shape not in meshes:
        meshes[shape] = build_mesh(MeshSpec(data=shape[0], fsdp=shape[1]),
                                   device="cpu")
    mesh = meshes[shape]
    model = _model(spec)
    variables = _tree(arrays, spec["variables"])
    out = {}
    if spec.get("eval"):
        batches = [_tree(arrays, f"batch/{b}") for b in spec["batches"]]
        ev = evaluate_model(model, ckpt.variables_from_numpy(variables),
                            batches, spec["eval"], mesh=mesh)
        np.savez(workdir / f"{name}.rank{rank}.npz", cm=ev.cm.numpy())
        return
    trainer, batch_sh = _trainer(spec, model, variables, mesh)
    ts = trainer.init_state(variables)
    if spec.get("restore"):
        ts = ckpt.restore_checkpoint(workdir / spec["restore"], ts)
        out["sharded"] = np.asarray(any(isinstance(x, DTensor) for x in
                                        _leaves(ts.params)))
    for i, b in enumerate(spec["batches"]):
        batch = _tree(arrays, f"batch/{b}")
        if spec.get("refused"):
            try:
                trainer.train_step(ts, batch)
            except ValueError as e:
                (workdir / f"{name}.rank{rank}.txt").write_text(str(e))
            return
        if spec.get("fit"):
            seen = []
            ts = trainer.fit(ts, [batch], listeners=[_Losses(seen)])
            out[f"loss{i}"] = np.asarray(seen, np.float64)
            continue
        if spec.get("iterator"):
            seen = []
            ts = trainer.fit(ts, ShardedDataSetIterator([batch], mesh,
                                                        batch_sh),
                             listeners=[_Losses(seen)])
            out[f"loss{i}"] = np.asarray(seen[0], np.float64)
        else:
            ts, m = trainer.train_step(ts, batch)
            out[f"loss{i}"] = np.asarray(float(m["total_loss"]))
    if spec.get("save"):
        ckpt.save_checkpoint(workdir / spec["save"], ts, model=model)
    full = {"params": trainer.variables(ts)["params"],
            "model_state": ts.model_state,
            "opt_state": trainer._dp.full(ts.opt_state),
            "step": np.asarray(ts.step)}
    out["local_bytes"] = np.asarray(sum(
        x.to_local().numel() if isinstance(x, DTensor) else x.numel()
        for x in _leaves(ts.params)))
    _save(workdir / f"{name}.rank{rank}.npz", {**full, "out": out})


def _leaves(tree):
    from deeplearning4j_tpu_torch.utils.pytree import tree_leaves

    return tree_leaves(tree)


class _Losses:
    """A ``fit`` listener that keeps every iteration's loss."""

    def __init__(self, seen):
        self.seen = seen

    def on_fit_start(self, trainer, ts):
        pass

    def on_epoch_start(self, epoch):
        pass

    def on_iteration(self, epoch, step, ts, metrics):
        self.seen.append(float(metrics["total_loss"]))
        return False

    def on_epoch_end(self, epoch, ts):
        return False

    def on_fit_end(self, trainer, ts):
        pass


def _collectives(rank: int, world: int, workdir: Path):
    """The host collectives: a trace id, a broadcast, a barrier, then a
    barrier that rank 1 never comes to."""
    from deeplearning4j_tpu_torch.runtime import distributed

    res = {"trace": distributed.establish_cluster_trace(timeout_s=30),
           "value": distributed.broadcast_host_data(
               {"rank": rank, "x": [rank, 7]}, timeout_s=30)}
    distributed.barrier("ready", timeout_s=30)
    if rank == 0:
        t0 = time.monotonic()
        try:
            distributed.barrier("alone", timeout_s=2.0)
            res["timeout"] = None
        except distributed.CollectiveTimeout as e:
            res["timeout"] = {"op": e.op, "timeout_s": e.timeout_s,
                              "seconds": time.monotonic() - t0}
    else:
        time.sleep(3.0)
    (workdir / f"collectives.rank{rank}.json").write_text(json.dumps(res))


def main(job: str, rank: int, world: int, workdir: str):
    import torch

    torch.set_num_threads(2)
    from deeplearning4j_tpu_torch.runtime import distributed

    workdir = Path(workdir)
    distributed.initialize(f"file://{workdir}/store.{job}",
                           num_processes=world, process_id=rank,
                           device="cpu")
    try:
        if job == "collectives":
            _collectives(rank, world, workdir)
            return
        cases = json.loads((workdir / "cases.json").read_text())[job]
        with np.load(workdir / "inputs.npz") as z:
            arrays = {k: z[k] for k in z.files}
        meshes: dict = {}
        for name, spec in cases.items():
            _run(name, spec, arrays, workdir, rank, meshes)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
