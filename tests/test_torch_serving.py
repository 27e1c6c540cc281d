"""The port's serving path on the CPU, against the JAX package's forward.

``ModelServer`` → ``ModelRegistry`` → ``ParallelInference`` with a small
BERT (weights initialised by the JAX package and carried across) behind an
NSP-softmax forward, driven over HTTP by ``ServingClient``.
"""

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.bert import bert_tiny as jax_bert_tiny
from deeplearning4j_tpu_torch.models.bert import bert_tiny
from deeplearning4j_tpu_torch.parallel.inference import (
    InferenceQueueFull,
    ParallelInference,
)
from deeplearning4j_tpu_torch.serde.checkpoint import variables_from_numpy
from deeplearning4j_tpu_torch.serving import (
    BadRequestError,
    ModelNotFoundError,
    ModelRegistry,
    ModelServer,
    ServingClient,
    bucket_sizes,
    spec,
)

T, VOCAB, MAX_BATCH = 16, 1000, 4
# fp32 throughout; coalescing and padding change the matmul shapes, hence
# their blocking and summation order: ~1e-7 on the probabilities, bound 1e-5.
ATOL = 1e-5


def _nsp_softmax(model, x):
    return torch.softmax(model.nsp_logits(model(x)), dim=-1)


def _request(seed):
    r = np.random.default_rng(seed)
    rows = 1 + seed % 3
    lengths = r.integers(1, T + 1, rows)
    return {
        "token_ids": r.integers(0, VOCAB, (rows, T)).astype(np.int32),
        "segment_ids": r.integers(0, 2, (rows, T)).astype(np.int32),
        "mask": (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32),
    }


@pytest.fixture(scope="module")
def served():
    jm = jax_bert_tiny()
    jv = jax.tree_util.tree_map(np.asarray, jm.init(seed=11))
    model = bert_tiny(device="cpu")
    model.load_variables(variables_from_numpy(jv))
    reg = ModelRegistry()
    reg.register(
        "bert", _nsp_softmax, model,
        input_spec={"token_ids": spec((T,), np.int32, high=VOCAB),
                    "segment_ids": spec((T,), np.int32, high=2),
                    "mask": spec((T,), np.float32)},
        mode="batched", max_batch_size=MAX_BATCH, devices=["cpu"])
    srv = ModelServer(reg, port=0)
    srv.start(warm=True)
    yield srv, jm, jv
    srv.stop()


def test_warm_start_covers_every_bucket_then_ready(served):
    srv, _, _ = served
    entry = srv.registry.get("bert")
    assert entry.warmed
    assert entry.batch_stats()["batches"] >= len(bucket_sizes(MAX_BATCH))
    body = ServingClient(srv.url).ready()
    assert body == {"ready": True, "draining": False, "models": {"bert": True}}


def test_concurrent_predicts_match_jax_forward(served):
    srv, jm, jv = served
    client = ServingClient(srv.url)
    results, errors = {}, []

    def call(i):
        try:
            results[i] = client.predict("bert", _request(i))
        except Exception as e:  # noqa: BLE001 — collected, asserted below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(10)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors and len(results) == 10
    for i, resp in results.items():
        feats = {k: jnp.asarray(v) for k, v in _request(i).items()}
        hidden = jm.encode(jv["params"], feats)
        want = np.asarray(jax.nn.softmax(jm.nsp_logits(jv["params"], hidden)))
        assert resp["model"] == "bert" and resp["version"] == "v1"
        np.testing.assert_allclose(np.asarray(resp["outputs"]), want,
                                   atol=ATOL)


def test_models_and_health(served):
    srv, _, _ = served
    client = ServingClient(srv.url)
    with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as r:
        assert json.loads(r.read()) == {"status": "ok"}
    (desc,) = client.models()
    assert desc["name"] == "bert" and desc["warmed"]


def test_unknown_model_is_404(served):
    srv, _, _ = served
    with pytest.raises(ModelNotFoundError):
        ServingClient(srv.url).predict("nope", _request(0))


@pytest.mark.parametrize("bad", ["oversized", "out_of_vocab", "missing_key"])
def test_bad_requests_are_400(served, bad):
    srv, _, _ = served
    feats = _request(2)
    if bad == "oversized":
        feats = {k: np.concatenate([v, v]) for k, v in feats.items()}
        assert feats["mask"].shape[0] > MAX_BATCH
    elif bad == "out_of_vocab":
        feats["token_ids"][0, 3] = VOCAB
    else:
        del feats["mask"]
    with pytest.raises(BadRequestError):
        ServingClient(srv.url).predict("bert", feats)


def test_stop_drains_in_flight_requests():
    gate = threading.Event()

    def slow(variables, x):
        gate.wait(10)
        return x * variables["scale"]

    reg = ModelRegistry()
    reg.register("slow", slow, {"scale": torch.tensor(2.0)},
                 input_spec=spec((3,)), mode="instant", devices=["cpu"])
    srv = ModelServer(reg, port=0).start(warm=False)
    got = {}
    th = threading.Thread(target=lambda: got.update(
        r=ServingClient(srv.url).predict("slow", [[1.0, 2.0, 3.0]])))
    th.start()
    deadline = time.monotonic() + 10
    while srv._in_flight == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    stopped = {}
    stopper = threading.Thread(target=lambda: stopped.update(ok=srv.stop()))
    stopper.start()
    time.sleep(0.2)
    assert stopper.is_alive() and srv.draining  # waiting on the request
    gate.set()
    stopper.join(timeout=10)
    th.join(timeout=10)
    assert not stopper.is_alive() and not th.is_alive()
    assert stopped == {"ok": True}
    assert got["r"]["outputs"] == [[2.0, 4.0, 6.0]]


@pytest.mark.parametrize("rows,cap,bucket", [
    (1, 8, 1), (2, 8, 2), (3, 8, 4), (5, 8, 8), (8, 8, 8), (5, 6, 6),
    (9, 8, 16),
])
def test_bucket(rows, cap, bucket):
    assert ParallelInference._bucket(rows, cap) == bucket


def test_queue_limit_sheds_instead_of_blocking():
    entered, gate = threading.Event(), threading.Event()
    pi = ParallelInference(lambda v, x: (entered.set(), gate.wait(10), x)[2],
                           {}, devices=["cpu"], queue_limit=1)
    try:
        held = threading.Thread(target=pi.output, args=(np.zeros((1, 2)),))
        held.start()
        assert entered.wait(10)  # the worker holds it, blocked on the gate
        deadline = time.monotonic() + 10
        queued = threading.Thread(target=pi.output, args=(np.zeros((1, 2)),))
        queued.start()  # fills the one queue slot
        while not pi._queue.qsize() and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(InferenceQueueFull):
            pi.output(np.zeros((1, 2)))
    finally:
        gate.set()
        pi.shutdown()
    held.join(timeout=10)
    queued.join(timeout=10)
    assert not held.is_alive() and not queued.is_alive()
