"""Two whole ONNX models end to end, at narrow width: ``chip_smoke.py``'s
writers against torch.onnx.export, the port's import against the JAX
package's and against the source models.

- The word language model of PyTorch's ``examples/word_language_model``
  (``RNNModel``, LSTM, 2 layers, width 32, vocabulary 50, T = 5, batch
  3): ``chip_smoke.word_lm_onnx`` writes the node list (op types in order,
  attributes, Constant values) and initializer shapes that
  ``torch.onnx.export`` writes for the same module; the port's import on
  the CPU gives the module's log-probabilities and final states (1e-5)
  and the JAX package's (1e-5), and ``calculate_gradients`` of the
  next-token NLL through both LSTM nodes equals the JAX package's and the
  module's autograd gradients (each leaf to 1e-4 of its max).
- The zoo's ResNet at blocks (1, 1), 10 classes: at 33² its SAME padding
  is symmetric, so it is torchvision's ResNet; ``chip_smoke.resnet_onnx``
  writes the node list and initializer shapes torch.onnx.export writes for
  that torchvision-style module with BatchNorm kept (``TrainingMode.
  PRESERVE``), and the import's logits equal the module's, the zoo
  model's and the JAX import's (1e-5 of their max). At 32² (asymmetric
  SAME pads at stride 2) the import still equals the zoo model.
- ``chip_smoke.onnx_ops_graphs`` (the card phase's small graphs) on the
  CPU: each output against its numpy reference, each loop's route.
"""

import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from deeplearning4j_tpu.modelimport.onnx import import_onnx_model as jax_import
from deeplearning4j_tpu_torch.autodiff import samediff as sdm
from deeplearning4j_tpu_torch.modelimport import import_onnx_model
from deeplearning4j_tpu_torch.modelimport.onnx_proto import ModelProto
from deeplearning4j_tpu_torch.models.zoo.resnet import resnet_config
from deeplearning4j_tpu_torch.nn.model import GraphModel
from deeplearning4j_tpu_torch.ops.nn import linear

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TOL = 1e-5  # of the output's max
VOCAB, WIDTH, LAYERS, T, N = 50, 32, 2, 5, 3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def _exporter():
    # the TorchScript exporter's last pass merges onnxscript functions and
    # needs the absent `onnx` package; it is a no-op for these modules
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, opsets: \
        model_bytes
    yield
    onnx_proto_utils._add_onnxscript_fn = orig


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _layout(blob):
    """(op type, attributes, Constant values) of each node in order, and
    the initializer shapes in order."""
    g = ModelProto.decode(blob).graph
    nodes = []
    for nd in g.node:
        attrs = {}
        for a in nd.attribute:
            v = a.value()
            if a.type == 4:  # a tensor: its dtype, shape and values
                v = (v.data_type, list(v.dims), v.to_numpy().tolist())
            attrs[a.name] = v
        nodes.append((nd.op_type, attrs, len(nd.input), len(nd.output)))
    return nodes, [list(t.dims) for t in g.initializer]


# -- the word language model ---------------------------------------------------


class RNNModel(nn.Module):
    """examples/word_language_model/model.py's RNNModel, LSTM, untied."""

    def __init__(self, ntoken, ninp, nhid, nlayers, dropout=0.5):
        super().__init__()
        self.ntoken = ntoken
        self.drop = nn.Dropout(dropout)
        self.encoder = nn.Embedding(ntoken, ninp)
        self.rnn = nn.LSTM(ninp, nhid, nlayers, dropout=dropout)
        self.decoder = nn.Linear(nhid, ntoken)

    def forward(self, input, hidden):  # noqa: A002 - the example's name
        emb = self.drop(self.encoder(input))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        decoded = self.decoder(output).view(-1, self.ntoken)
        return F.log_softmax(decoded, dim=1), hidden


@pytest.fixture(scope="module")
def word_lm():
    params = chip_smoke.word_lm_params(VOCAB, WIDTH, WIDTH, LAYERS, seed=3)
    module = RNNModel(VOCAB, WIDTH, WIDTH, LAYERS).eval()
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in params.items()})
    r = np.random.default_rng(4)
    ids = r.integers(0, VOCAB, (T + 1, N))
    h0, c0 = (r.uniform(-0.5, 0.5, (LAYERS, N, WIDTH)).astype(np.float32)
              for _ in range(2))
    feeds = {"input": ids[:-1], "h0": h0, "c0": c0}
    blob = chip_smoke.word_lm_onnx(params, seq_len=T, batch=N)
    return module, params, feeds, ids[1:].reshape(-1), blob


def test_word_lm_writer_is_the_exporters_layout(word_lm, _exporter):
    module, _, feeds, _, blob = word_lm
    buf = io.BytesIO()
    args = (torch.from_numpy(feeds["input"]),
            (torch.from_numpy(feeds["h0"]), torch.from_numpy(feeds["c0"])))
    torch.onnx.export(module, args, buf, opset_version=13, dynamo=False)
    want_nodes, want_inits = _layout(buf.getvalue())
    got_nodes, got_inits = _layout(blob)
    assert [n[0] for n in got_nodes] == [n[0] for n in want_nodes]
    assert got_nodes == want_nodes
    assert got_inits == want_inits


def test_word_lm_import_matches_module_and_jax(word_lm):
    module, _, feeds, _, blob = word_lm
    sd, ins, outs = import_onnx_model(blob, device="cpu")
    names = ["log_probs", "hn", "cn"]
    got = sd.output(feeds, [outs[k] for k in names])
    with torch.no_grad():
        logp, (hn, cn) = module(torch.from_numpy(feeds["input"]),
                                (torch.from_numpy(feeds["h0"]),
                                 torch.from_numpy(feeds["c0"])))
    sd_j, _, outs_j = jax_import(blob)
    got_j = sd_j.output(feeds, [outs_j[k] for k in names])
    for k, want in zip(names, (logp, hn, cn)):
        g = got[outs[k]].numpy()
        assert g.shape == tuple(want.shape)
        assert _rel(g, want.numpy()) < TOL, k
        assert _rel(g, got_j[outs_j[k]]) < TOL, k


def test_word_lm_gradients_through_the_lstm_nodes(word_lm):
    """The next-token NLL's gradients wrt every initializer: the port's
    (the sweeps' autograd function on the CPU) against the JAX package's
    and against the module's autograd."""
    module, _, feeds, targets, blob = word_lm
    train = dict(feeds, labels=targets.astype(np.int32))
    grads = []
    for importer, kw in ((import_onnx_model, {"device": "cpu"}),
                         (jax_import, {})):
        sd, _, outs = importer(blob, **kw)
        for t in ModelProto.decode(blob).graph.initializer:
            sd.convert_to_variable(t.name)
        lab = sd.placeholder("labels", (T * N,), "int32")
        loss = sd.loss.sparse_softmax_cross_entropy(
            sd.get_variable(outs["log_probs"]), lab)
        g = sd.calculate_gradients(train, loss.name)
        grads.append({k: np.asarray(v) for k, v in g.items()})
    port, jax_g = grads
    logp, _ = module(torch.from_numpy(feeds["input"]),
                     (torch.from_numpy(feeds["h0"]),
                      torch.from_numpy(feeds["c0"])))
    F.nll_loss(logp, torch.from_numpy(targets)).backward()
    w_dec = module.decoder.weight.grad.numpy()
    assert sorted(port) == sorted(jax_g)
    for k in port:
        scale = max(np.abs(jax_g[k]).max(), 1e-12)
        assert np.abs(port[k] - jax_g[k]).max() <= 1e-4 * scale, k
    # the decoder's weight is written transposed for its MatMul
    (dec,) = [k for k in port if k.startswith("onnx::MatMul")]
    assert np.abs(port[dec].T - w_dec).max() <= 1e-4 * np.abs(w_dec).max()
    emb = module.encoder.weight.grad.numpy()
    assert np.abs(port["encoder.weight"] - emb).max() <= \
        1e-4 * np.abs(emb).max()


def test_word_lm_float64_replay_is_float64(word_lm):
    """``chip_smoke._sd_float64(sd, "cpu")`` (the card phase's reference):
    the graph's values in float64 on the CPU, where the LSTM sweeps' plain
    versions keep float64, so it equals the module in float64 to ~1e-12,
    and its gradients come out in float64."""
    from deeplearning4j_tpu_torch.autodiff import enable_x64

    module, _, feeds, _, blob = word_lm
    sd, ins, outs = import_onnx_model(blob, device="cpu")
    sd64 = chip_smoke._sd_float64(sd, "cpu")
    feeds64 = chip_smoke._on_cpu64({k: torch.from_numpy(v)
                                    for k, v in feeds.items()})
    with enable_x64():
        got = sd64.output(feeds64, [outs["log_probs"]])[outs["log_probs"]]
        w = "onnx::LSTM_0"
        sd64.convert_to_variable(w)
        loss = sd64.get_variable(outs["log_probs"]).sum()
        g = sd64.calculate_gradients(feeds64, loss.name, [w])[w]
    m64 = RNNModel(VOCAB, WIDTH, WIDTH, LAYERS).eval().double()
    m64.load_state_dict(module.state_dict())
    with torch.no_grad():
        want, _ = m64(torch.from_numpy(feeds["input"]),
                      (feeds64["h0"], feeds64["c0"]))
    assert got.dtype == torch.float64 and g.dtype == torch.float64
    assert _rel(got.numpy(), want.numpy()) < 1e-12


# -- the zoo's ResNet --------------------------------------------------------------


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (stride on the 3×3, the v1.5 placement)."""

    def __init__(self, cin, f, stride, project):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, f, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(f)
        self.conv2 = nn.Conv2d(f, f, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(f)
        self.conv3 = nn.Conv2d(f, 4 * f, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * f)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, 4 * f, 1, stride, bias=False),
            nn.BatchNorm2d(4 * f)) if project else None

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        out += identity
        return self.relu(out)


class ResNet(nn.Module):
    """torchvision's ResNet layout with one bottleneck a stage."""

    def __init__(self, stages, classes):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for s in range(stages):
            f = 64 * 2 ** s
            setattr(self, f"layer{s + 1}", nn.Sequential(
                Bottleneck(cin, f, 2 if s else 1, True)))
            cin = 4 * f
        self.stages = stages
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(cin, classes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for s in range(self.stages):
            x = getattr(self, f"layer{s + 1}")(x)
        return self.fc(torch.flatten(self.avgpool(x), 1))


def _load_zoo(module, variables):
    """The zoo model's variables into the torchvision-style module."""
    p, st = variables["params"], variables["state"]
    sd = {}

    def conv_bn(vert, conv, bn):
        sd[f"{conv}.weight"] = p[f"{vert}_conv"]["W"].permute(3, 2, 0, 1)
        sd[f"{bn}.weight"] = p[f"{vert}_bn"]["gamma"]
        sd[f"{bn}.bias"] = p[f"{vert}_bn"]["beta"]
        sd[f"{bn}.running_mean"] = st[f"{vert}_bn"]["mean"]
        sd[f"{bn}.running_var"] = st[f"{vert}_bn"]["var"]

    conv_bn("stem", "conv1", "bn1")
    for s in range(module.stages):
        m = f"layer{s + 1}.0"
        for part, k in (("a", 1), ("b", 2), ("c", 3)):
            conv_bn(f"s{s}b0_{part}", f"{m}.conv{k}", f"{m}.bn{k}")
        conv_bn(f"s{s}b0_proj", f"{m}.downsample.0", f"{m}.downsample.1")
    sd["fc.weight"] = p["output"]["W"].t()
    sd["fc.bias"] = p["output"]["b"]
    missing = module.load_state_dict(
        {k: v.contiguous() for k, v in sd.items()}, strict=False)
    assert not missing.unexpected_keys
    assert all(k.endswith("num_batches_tracked")
               for k in missing.missing_keys)
    return module.eval()


def _zoo(size):
    config = resnet_config(blocks=(1, 1), input_shape=(size, size, 3),
                           num_classes=10)
    model = GraphModel(config, device="cpu")
    variables = chip_smoke._random_bn_state(model.init(5), seed=6)
    return config, model, variables


def _zoo_logits(model, variables, x_nchw):
    with torch.inference_mode():
        values, _ = model.feed_forward(
            variables, torch.from_numpy(x_nchw).permute(0, 2, 3, 1))
        p = variables["params"]["output"]
        return linear(values["avgpool"], p["W"], p["b"]).numpy()


def test_resnet_writer_is_the_exporters_layout(_exporter):
    config, model, variables = _zoo(33)
    module = _load_zoo(ResNet(2, 10), variables)
    x = np.random.default_rng(7).standard_normal((2, 3, 33, 33)).astype(
        np.float32)
    buf = io.BytesIO()
    with torch.no_grad():
        want = module(torch.from_numpy(x)).numpy()
        torch.onnx.export(module, (torch.from_numpy(x),), buf,
                          opset_version=13, dynamo=False,
                          training=torch.onnx.TrainingMode.PRESERVE)
    blob = chip_smoke.resnet_onnx(config, variables, batch=2)
    want_nodes, want_inits = _layout(buf.getvalue())
    got_nodes, got_inits = _layout(blob)
    assert [n[0] for n in got_nodes] == [n[0] for n in want_nodes]
    assert got_nodes == want_nodes
    assert got_inits == want_inits
    sd, ins, outs = import_onnx_model(blob, device="cpu")
    got = sd.output({"input": x}, [outs["logits"]])[outs["logits"]].numpy()
    assert _rel(got, want) < TOL
    assert _rel(got, _zoo_logits(model, variables, x)) < TOL


def test_resnet_import_matches_zoo_model_and_jax():
    """At 32² the zoo's SAME padding is asymmetric at stride 2 (the stem's
    conv, the max pool, the second stage): the import still computes the
    zoo model, and the JAX package's import of the same bytes agrees."""
    config, model, variables = _zoo(32)
    blob = chip_smoke.resnet_onnx(config, variables, batch="batch")
    g = ModelProto.decode(blob).graph
    pads = {nd.name: nd.attrs()["pads"] for nd in g.node
            if nd.op_type in ("Conv", "MaxPool")}
    assert pads["/conv1/Conv"] == [2, 2, 3, 3]
    assert pads["/maxpool/MaxPool"] == [0, 0, 1, 1]
    x = np.random.default_rng(8).standard_normal((3, 3, 32, 32)).astype(
        np.float32)
    sd, ins, outs = import_onnx_model(blob, device="cpu")
    got = sd.output({"input": x}, [outs["logits"]])[outs["logits"]].numpy()
    assert _rel(got, _zoo_logits(model, variables, x)) < TOL
    probs = model.output_single(variables, torch.from_numpy(x).permute(
        0, 2, 3, 1)).numpy()
    assert np.abs(torch.softmax(torch.from_numpy(got), -1).numpy()
                  - probs).max() < TOL
    sd_j, _, outs_j = jax_import(blob)
    want_j = sd_j.output({"input": x}, [outs_j["logits"]])[outs_j["logits"]]
    assert _rel(got, want_j) < TOL


# -- the card phase's small graphs, here on the CPU ----------------------------


ONNX_OPS = ("conv_pool_norm_gemm", "ties_mod_gather_cumsum_d2s", "if_True",
            "if_False", "loop_static", "loop_data_dependent",
            "scan_reversed", "lstm_bidirectional", "gru_forward")


@pytest.mark.parametrize("index", range(len(ONNX_OPS)))
def test_onnx_ops_graphs_against_numpy(index):
    graphs = chip_smoke.onnx_ops_graphs()
    assert tuple(g[0] for g in graphs) == ONNX_OPS
    name, blob, feeds, ref, routes, _ = graphs[index]
    sd, _, outs = import_onnx_model(blob, device="cpu")
    sdm.reset_loop_stats()
    got = sd.output(feeds, list(outs.values()))
    stats = sdm.loop_stats()
    if routes == "cond":
        assert stats["cond"] == 1
    elif routes is not None:
        assert all(stats[k] == v for k, v in routes.items()), (name, stats)
    if ref is None:
        sd_j, _, outs_j = jax_import(blob)
        ref = {k: sd_j.output(feeds, [outs_j[k]])[outs_j[k]] for k in outs}
    for k, name_k in outs.items():
        g = got[name_k]
        want = np.asarray(ref[k])
        if g.is_floating_point():
            assert _rel(g.numpy(), want) < TOL, (name, k)
        else:
            np.testing.assert_array_equal(g.numpy(), want, err_msg=name)
