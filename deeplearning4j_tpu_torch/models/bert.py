"""BERT encoder with MLM/NSP pretraining heads (↔ deeplearning4j_tpu/models/bert.py).

``Bert`` is an ``nn.Module`` whose parameter names are the JAX package's
variable names with ``.`` for ``/`` (``embeddings.word`` ↔
``params/embeddings/word``, ``layer_3.attention.Wq`` ↔
``params/layer_3/attention/Wq``), with the same shapes and layouts, so
``load_variables``/``variables`` move a variables tree across unchanged.

Batch convention as in the JAX package:
    features = {"token_ids": [N,T] int, "segment_ids": [N,T] int,
                "mask": [N,T] 1/0 float}
    labels   = {"mlm_labels": [N,T] int, "mlm_mask": [N,T] 1/0 float,
                "nsp": [N] int}                      (dense MLM head), or
               {"mlm_labels": [N,P] int, "mlm_positions": [N,P] int,
                "mlm_weights": [N,P] float, "nsp": [N] int}  (gathered)
Token ids are widened to int64 for indexing; an id outside the vocab
raises (the JAX package's ``jnp.take`` clamps it).

The model is built on ``device`` (default: the first CUDA card, see
``runtime.device.default_device``) with weights drawn from
``config.net.seed``; ``init(seed)`` redraws them. Its parameters are
trainable; serving runs under ``torch.inference_mode()``, so it builds no
graph. ``loss_fn(params, state, batch, generator)`` is the JAX package's
pure loss over a params tree (what ``Trainer`` differentiates): the tree's
tensors stand in for the module's parameters for that call
(``torch.func.functional_call``), and dropout draws from ``generator``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.config import (
    NeuralNetConfiguration,
    register_config,
    torch_dtype,
)
from deeplearning4j_tpu_torch.nn.initializers import truncated_normal
from deeplearning4j_tpu_torch.nn.layers.attention import (
    TransformerEncoderBlockModule,
)
from deeplearning4j_tpu_torch.ops import loss as losses
from deeplearning4j_tpu_torch.ops import nn as opsnn
from deeplearning4j_tpu_torch.runtime.device import resolve_device
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.utils.pytree import flatten_with_names, unflatten


@register_config
@dataclass
class BertConfig:
    """Architecture config; same ``@class`` name and fields as the JAX
    package's, so its JSON round-trips between the two."""

    vocab_size: int = 30522
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    type_vocab: int = 2
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation: str = "gelu"
    eps: float = 1e-12
    use_nsp: bool = True
    initializer_range: float = 0.02
    remat: bool = False
    net: NeuralNetConfiguration = field(
        default_factory=lambda: NeuralNetConfiguration(updater=Adam(1e-4))
    )


class ParamGroup(nn.Module):
    """Parameters under the JAX package's leaf names, reached by item
    (``emb["type"]``): one of those names, ``type``, is shadowed by
    ``nn.Module.type`` for attribute access and registration."""

    def __init__(self, shapes: Dict[str, tuple], dtype):
        super().__init__()
        for name, shape in shapes.items():
            self._parameters[name] = nn.Parameter(
                torch.empty(shape, dtype=dtype))

    def __getitem__(self, name: str) -> nn.Parameter:
        return self._parameters[name]

    def items(self):
        return self._parameters.items()


def flat_params(params) -> Dict[str, Any]:
    """A params tree under the JAX package's names → the module's dotted
    parameter names (what ``torch.func.functional_call`` takes)."""
    return {n.replace("/", "."): t for n, t in flatten_with_names(params)}


class TreeModule(nn.Module):
    """A model whose parameters carry the JAX package's variable names
    (``.`` for ``/``): its variables tree moves across unchanged."""

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def net(self) -> NeuralNetConfiguration:
        return self.config.net

    def variables(self) -> Dict[str, Any]:
        """``{"params": nested dict of tensors, "state": {}}`` with the JAX
        package's names (views of this module's parameters)."""
        params = unflatten((n.replace(".", "/"), p.detach())
                           for n, p in self.named_parameters())
        return {"params": params, "state": {}}

    @torch.no_grad()
    def load_variables(self, variables: Dict[str, Any]):
        """Copy a ``{"params": ...}`` tree (tensors or numpy arrays, JAX
        names) into this module's parameters; names and shapes must match
        exactly."""
        given = dict(flatten_with_names(variables["params"]))
        own = {n.replace(".", "/"): p for n, p in self.named_parameters()}
        missing, extra = sorted(set(own) - set(given)), sorted(
            set(given) - set(own))
        if missing or extra:
            raise KeyError(f"variables do not match the model: missing "
                           f"{missing[:5]}, unexpected {extra[:5]}")
        for name, p in own.items():
            src = torch.as_tensor(given[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(dtype=p.dtype, device=p.device))
        return self

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class Bert(TreeModule):
    """BERT encoder + MLM/NSP heads; ``forward(features)`` = ``encode``."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = self.config = config
        device = resolve_device(device)
        dtype = torch_dtype(config.net.dtype)
        e = c.hidden
        self.embeddings = ParamGroup({
            "word": (c.vocab_size, e), "position": (c.max_position, e),
            "type": (c.type_vocab, e), "ln_gamma": (e,), "ln_beta": (e,),
        }, dtype)
        # the decoder shares the word embedding; only a bias is learned
        self.mlm = ParamGroup({
            "W": (e, e), "b": (e,), "ln_gamma": (e,), "ln_beta": (e,),
            "out_b": (c.vocab_size,),
        }, dtype)
        if c.use_nsp:
            self.pooler = ParamGroup({"W": (e, e), "b": (e,)}, dtype)
            self.nsp = ParamGroup({"W": (e, 2), "b": (2,)}, dtype)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderBlockModule(
                e, c.num_heads, intermediate=c.intermediate,
                activation=c.activation, dropout=c.dropout,
                attention_dropout=c.attention_dropout, post_ln=True,
                eps=c.eps, remat=c.remat, dtype=dtype))
        self._act = get_activation(c.activation)
        self.init()
        self.to(device)

    # -- construction ------------------------------------------------------

    @torch.no_grad()
    def init(self, seed: Optional[int] = None) -> Dict[str, Any]:
        """Redraw every parameter from ``seed`` (default ``config.net.seed``)
        and return :meth:`variables`. Draws run on a CPU generator, so a
        seed gives the same weights on every device."""
        c = self.config
        gen = torch.Generator().manual_seed(
            self.config.net.seed if seed is None else seed)
        std = c.initializer_range

        def trunc(p):
            p.copy_(truncated_normal(tuple(p.shape), gen, std, p.dtype))

        emb = self.embeddings
        for name in ("word", "position", "type"):
            trunc(emb[name])
        trunc(self.mlm["W"])
        heads = [emb, self.mlm]
        if c.use_nsp:
            trunc(self.pooler["W"])
            trunc(self.nsp["W"])
            heads += [self.pooler, self.nsp]
        for group in heads:
            for name, p in group.items():
                if name == "ln_gamma":
                    p.fill_(1.0)
                elif name in ("b", "ln_beta", "out_b"):
                    p.zero_()
        for i in range(c.num_layers):
            getattr(self, f"layer_{i}").reset_parameters(gen)
        return self.variables()

    # -- forward -----------------------------------------------------------

    def encode(self, features, *, train=False, generator=None):
        """Token/segment ids → contextual embeddings [N,T,H]. With
        ``train`` and a ``generator`` (on the model's device), dropout is
        applied as in the JAX package: after the embedding LayerNorm and in
        every block."""
        c = self.config
        ids = features["token_ids"]
        seg = features.get("segment_ids")
        mask = features.get("mask")
        t = ids.shape[1]
        emb = self.embeddings
        x = opsnn.embedding_lookup(emb["word"], ids)
        x = x + emb["position"][:t][None, :, :]
        if seg is not None:
            x = x + opsnn.embedding_lookup(emb["type"], seg)
        x = opsnn.layer_norm(x, emb["ln_gamma"], emb["ln_beta"], eps=c.eps)
        if train and c.dropout > 0.0 and generator is not None:
            x = opsnn.dropout(x, c.dropout, generator)
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask, train=train,
                                            generator=generator)
        return x

    def forward(self, features, *, train=False, generator=None, head=None):
        """:meth:`encode`, then ``head(hidden)`` when given (``loss_fn``
        runs its heads there, inside the parameter substitution)."""
        hidden = self.encode(features, train=train, generator=generator)
        return hidden if head is None else head(hidden)

    def apply(self, variables, features):
        """The JAX package's functional protocol: (hidden [N,T,H], state)
        computed with ``variables`` in place of this module's parameters."""
        hidden = torch.func.functional_call(
            self, flat_params(variables["params"]), (features,))
        return hidden, variables.get("state", {})

    def mlm_logits(self, hidden):
        m = self.mlm
        h = self._act(opsnn.linear(hidden, m["W"], m["b"]))
        h = opsnn.layer_norm(h, m["ln_gamma"], m["ln_beta"],
                             eps=self.config.eps)
        return opsnn.linear(h, self.embeddings["word"].t(), m["out_b"])

    def nsp_logits(self, hidden):
        pooled = torch.tanh(opsnn.linear(hidden[:, 0, :], self.pooler["W"],
                                         self.pooler["b"]))
        return opsnn.linear(pooled, self.nsp["W"], self.nsp["b"])

    def loss_fn(self, params, state, batch, generator=None):
        """MLM (+ NSP) pretraining loss of ``batch`` with ``params`` (a
        tree under the JAX package's names) standing in for the module's
        parameters → ``(loss, (state, metrics))``, the JAX return
        structure. The MLM head is the gathered one when the labels carry
        ``mlm_positions`` (decoder over the P masked slots only), else the
        dense one weighted by ``mlm_mask``. Dropout runs when a
        ``generator`` is given."""
        labels = batch["labels"]
        total, metrics = torch.func.functional_call(
            self, flat_params(params), (batch["features"],),
            {"train": True, "generator": generator,
             "head": lambda hidden: self._pretrain_loss(hidden, labels)})
        return total, (state, metrics)

    def _pretrain_loss(self, hidden, labels):
        if "mlm_positions" in labels:
            # Gathered head: decoder GEMM over the P masked slots only.
            pos = labels["mlm_positions"].long()  # [N,P]
            gathered = torch.gather(
                hidden, 1, pos[:, :, None].expand(-1, -1, hidden.shape[-1]))
            logits = self.mlm_logits(gathered)  # [N,P,V]
            mlm_mask = labels["mlm_weights"].float()
        else:
            logits = self.mlm_logits(hidden)  # [N,T,V]
            mlm_mask = labels["mlm_mask"].float()
        per_tok = losses.sparse_softmax_cross_entropy(
            logits, labels["mlm_labels"], reduction="none")
        denom = torch.clamp(torch.sum(mlm_mask), min=1.0)
        mlm_loss = torch.sum(per_tok * mlm_mask) / denom
        metrics = {"mlm_loss": mlm_loss.detach()}
        total = mlm_loss
        if self.config.use_nsp and "nsp" in labels:
            nsp = losses.sparse_softmax_cross_entropy(
                self.nsp_logits(hidden), labels["nsp"])
            metrics["nsp_loss"] = nsp.detach()
            total = total + nsp
        metrics["loss"] = total.detach()
        return total, metrics



def bert_base(device=None, **kw) -> Bert:
    """BERT-base-uncased dims (12L/768H/12A) — north-star config #4."""
    return Bert(BertConfig(**kw), device=device)


def bert_tiny(device=None, **kw) -> Bert:
    """2L/128H/2A toy config for tests and CPU dry-runs."""
    kw.setdefault("hidden", 128)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("intermediate", 512)
    kw.setdefault("vocab_size", 1000)
    kw.setdefault("max_position", 128)
    return Bert(BertConfig(**kw), device=device)


def make_mlm_batch(rng, batch_size, seq_len, vocab_size, *, mask_frac=0.15,
                   mask_id=103, pad_frac=0.0, max_predictions=None):
    """Host-side synthetic MLM batch (numpy only), draw for draw the JAX
    package's ``make_mlm_batch``: the same seed gives the same batch.

    ``max_predictions``: when set, the batch uses the gathered layout —
    ``mlm_positions``/``mlm_weights``/[N,P] ``mlm_labels`` with P =
    max_predictions (masked slots beyond P are unmasked again so the dense
    and gathered views of the same batch stay semantically identical).
    """
    r = np.random.default_rng(rng)
    ids = r.integers(5, vocab_size, (batch_size, seq_len)).astype(np.int32)
    mlm_mask = (r.random((batch_size, seq_len)) < mask_frac).astype(np.float32)
    attn = np.ones((batch_size, seq_len), np.float32)
    if pad_frac > 0:
        lens = r.integers(int(seq_len * (1 - pad_frac)), seq_len + 1,
                          batch_size)
        attn = (np.arange(seq_len)[None, :] < lens[:, None]).astype(
            np.float32)
        mlm_mask = mlm_mask * attn
    seg = np.zeros((batch_size, seq_len), np.int32)
    nsp = r.integers(0, 2, batch_size).astype(np.int32)

    labels: Dict[str, Any]
    if max_predictions is not None:
        p = int(max_predictions)
        if p <= 0:
            raise ValueError(f"max_predictions must be >= 1, got {p}")
        positions = np.zeros((batch_size, p), np.int32)
        weights = np.zeros((batch_size, p), np.float32)
        plabels = np.zeros((batch_size, p), np.int32)
        for n in range(batch_size):
            idx = np.flatnonzero(mlm_mask[n])
            if len(idx) > p:       # drop overflow AND unmask it
                mlm_mask[n, idx[p:]] = 0.0
                idx = idx[:p]
            positions[n, :len(idx)] = idx
            weights[n, :len(idx)] = 1.0
            plabels[n, :len(idx)] = ids[n, idx]
        labels = {"mlm_labels": plabels, "mlm_positions": positions,
                  "mlm_weights": weights, "nsp": nsp}
    else:
        labels = {"mlm_labels": ids, "mlm_mask": mlm_mask, "nsp": nsp}
    inp = np.where(mlm_mask > 0, mask_id, ids).astype(np.int32)
    return {
        "features": {"token_ids": inp, "segment_ids": seg, "mask": attn},
        "labels": labels,
    }
