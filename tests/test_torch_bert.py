"""The port's BERT against the JAX package's, on the CPU.

A small BERT (2 layers, width 128, 2 heads, vocab 1000) is initialised by
the JAX package, carried across as numpy (``variables_from_numpy``) and
both forwards run on the same padded features, made from a seed.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.bert import BertConfig as JaxBertConfig
from deeplearning4j_tpu.models.bert import bert_tiny as jax_bert_tiny
from deeplearning4j_tpu.nn.config import config_from_json as jax_from_json
from deeplearning4j_tpu.nn.config import config_to_json as jax_to_json
from deeplearning4j_tpu.nn.layers import (
    TransformerEncoderBlock as JaxEncoderBlock,
)
from deeplearning4j_tpu.serde.checkpoint import save_state_tree
from deeplearning4j_tpu_torch.models.bert import BertConfig, bert_tiny
from deeplearning4j_tpu_torch.nn.config import config_from_json, config_to_json
from deeplearning4j_tpu_torch.nn.layers import TransformerEncoderBlockModule
from deeplearning4j_tpu_torch.serde.checkpoint import (
    load_inference_variables,
    variables_from_numpy,
)
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names

# fp32 on both sides; matmuls and layer norms sum in another order, and two
# post-LN layers pass the differences on: ~1e-6 measured, bound 1e-5.
ATOL = 1e-5


def _features(n=4, t=16, vocab=1000, lengths=(16, 9, 12, 1), seed=0):
    r = np.random.default_rng(seed)
    return {
        "token_ids": r.integers(0, vocab, (n, t)).astype(np.int32),
        "segment_ids": r.integers(0, 2, (n, t)).astype(np.int32),
        "mask": (np.arange(t)[None, :] < np.asarray(lengths)[:, None]
                 ).astype(np.float32),
    }


@pytest.fixture(scope="module")
def pair():
    jm = jax_bert_tiny()
    jv = jax.tree_util.tree_map(np.asarray, jm.init(seed=3))
    tm = bert_tiny(device="cpu")
    tm.load_variables(variables_from_numpy(jv))
    return jm, jv, tm


def _jax_forward(jm, jv, feats):
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    hidden = jm.encode(jv["params"], jf)
    return (np.asarray(hidden), np.asarray(jm.mlm_logits(jv["params"], hidden)),
            np.asarray(jm.nsp_logits(jv["params"], hidden)))


def _torch_forward(tm, feats):
    with torch.inference_mode():
        hidden = tm.encode({k: torch.from_numpy(v) for k, v in feats.items()})
        return (hidden.numpy(), tm.mlm_logits(hidden).numpy(),
                tm.nsp_logits(hidden).numpy())


def test_variable_names_and_shapes_match(pair):
    _, jv, tm = pair
    jax_names = {n: a.shape for n, a in flatten_with_names(jv["params"])}
    port_names = {n: tuple(t.shape)
                  for n, t in flatten_with_names(tm.variables()["params"])}
    assert port_names == jax_names


@pytest.mark.parametrize("output", ["hidden", "mlm", "nsp"])
def test_forward_matches_jax(pair, output):
    jm, jv, tm = pair
    feats = _features()
    idx = ["hidden", "mlm", "nsp"].index(output)
    want = _jax_forward(jm, jv, feats)[idx]
    got = _torch_forward(tm, feats)[idx]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_apply_is_functional_over_variables(pair):
    jm, jv, tm = pair
    feats = _features(seed=1)
    other = bert_tiny(device="cpu")  # fresh torch init, then jv's weights
    with torch.inference_mode():
        hidden, state = other.apply(
            variables_from_numpy(jv),
            {k: torch.from_numpy(v) for k, v in feats.items()})
    assert state == {}
    np.testing.assert_allclose(hidden.numpy(), _jax_forward(jm, jv, feats)[0],
                               atol=ATOL)


def test_pre_ln_causal_block_matches_jax():
    e, t = 64, 12
    jblk = JaxEncoderBlock(num_heads=2, intermediate=96, causal=True,
                           post_ln=False)
    jp, _ = jblk.init(jax.random.key(5), (t, e), jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    blk = TransformerEncoderBlockModule(e, 2, intermediate=96, causal=True,
                                        post_ln=False)
    flat = dict(flatten_with_names(jp))
    assert {n.replace(".", "/") for n, _ in blk.named_parameters()} \
        == set(flat)
    with torch.no_grad():
        for n, p in blk.named_parameters():
            p.copy_(torch.tensor(flat[n.replace(".", "/")]))
    r = np.random.default_rng(2)
    x = r.standard_normal((3, t, e)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([[12], [7], [10]])).astype(
        np.float32)
    want, _ = jblk.apply(jp, {}, jnp.asarray(x), mask=jnp.asarray(mask))
    with torch.inference_mode():
        got = blk(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bert_config_json_crosses_both_ways():
    jcfg = JaxBertConfig(hidden=64, num_layers=1, num_heads=2,
                         vocab_size=100)
    cfg = config_from_json(jax_to_json(jcfg))
    assert isinstance(cfg, BertConfig)
    assert cfg.hidden == 64 and cfg.vocab_size == 100
    assert cfg.net.updater.lr == 1e-4
    assert json.loads(config_to_json(cfg)) == json.loads(jax_to_json(jcfg))
    back = jax_from_json(config_to_json(BertConfig(num_layers=3)))
    assert isinstance(back, JaxBertConfig) and back.num_layers == 3


@pytest.mark.parametrize("flavour", ["variables", "train_state"])
def test_jax_checkpoint_serves_same_outputs(pair, tmp_path, flavour):
    jm, jv, _ = pair
    tree = (jv if flavour == "variables" else
            {"params": jv["params"], "model_state": {},
             "step": np.asarray(7, np.int32)})
    save_state_tree(tmp_path, tree)
    model = bert_tiny(device="cpu")
    model.load_variables(load_inference_variables(tmp_path, model))
    feats = _features(seed=4)
    for got, want in zip(_torch_forward(model, feats),
                         _jax_forward(jm, jv, feats)):
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_checkpoint_digest_mismatch_is_refused(pair, tmp_path):
    _, jv, _ = pair
    save_state_tree(tmp_path, jv)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    manifest["arrays"]["params/nsp/b"]["sha256"] = "0" * 64
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="params/nsp/b"):
        load_inference_variables(tmp_path, bert_tiny(device="cpu"))


def test_out_of_vocab_id_raises(pair):
    _, _, tm = pair
    feats = {k: torch.from_numpy(v) for k, v in _features().items()}
    feats["token_ids"][0, 0] = 1000
    with pytest.raises(IndexError, match="0, 1000"):
        tm.encode(feats)



@pytest.mark.parametrize("bad", [-1, 7], ids=["minus_one", "num_classes"])
def test_out_of_range_class_id_raises(bad):
    """``sparse_softmax_cross_entropy`` raises on a class id outside [0, C)
    (here C = 7) on the CPU tensors it is given, instead of reading
    another row's log-probability."""
    from deeplearning4j_tpu_torch.ops.loss import sparse_softmax_cross_entropy

    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((3, 7)).astype(np.float32))
    ids = torch.tensor([0, 6, bad])
    assert torch.isfinite(sparse_softmax_cross_entropy(logits, ids[:2]))
    with pytest.raises(RuntimeError, match="out of bounds"):
        sparse_softmax_cross_entropy(logits, ids)
