"""BERT encoder with MLM/NSP heads (↔ deeplearning4j_tpu/models/bert.py), forward only.

``Bert`` is an ``nn.Module`` whose parameter names are the JAX package's
variable names with ``.`` for ``/`` (``embeddings.word`` ↔
``params/embeddings/word``, ``layer_3.attention.Wq`` ↔
``params/layer_3/attention/Wq``), with the same shapes and layouts, so
``load_variables``/``variables`` move a variables tree across unchanged.

Batch convention as in the JAX package:
    features = {"token_ids": [N,T] int, "segment_ids": [N,T] int,
                "mask": [N,T] 1/0 float}
Token ids are widened to int64 for indexing; an id outside the vocab
raises (the JAX package's ``jnp.take`` clamps it).

The model is built on ``device`` (default: the first CUDA card, see
``runtime.device.default_device``) with weights drawn from
``config.net.seed``; ``init(seed)`` redraws them. Dropout is not applied:
this slice serves. ``loss_fn`` comes with the Trainer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

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
    TransformerEncoderBlock,
)
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


def _param(shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)


class ParamGroup(nn.Module):
    """Parameters under the JAX package's leaf names, reached by item
    (``emb["type"]``): one of those names, ``type``, is shadowed by
    ``nn.Module.type`` for attribute access and registration."""

    def __init__(self, shapes: Dict[str, tuple], dtype):
        super().__init__()
        for name, shape in shapes.items():
            self._parameters[name] = _param(shape, dtype)

    def __getitem__(self, name: str) -> nn.Parameter:
        return self._parameters[name]

    def items(self):
        return self._parameters.items()


class Bert(nn.Module):
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
            self.add_module(f"layer_{i}", TransformerEncoderBlock(
                e, c.num_heads, intermediate=c.intermediate,
                activation=c.activation, post_ln=True, eps=c.eps,
                dtype=dtype))
        self._act = get_activation(c.activation)
        self.init()
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.embeddings["word"].device

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

    def variables(self) -> Dict[str, Any]:
        """``{"params": nested dict of tensors, "state": {}}`` with the JAX
        package's names (views of this module's parameters)."""
        params = unflatten((n.replace(".", "/"), p.detach())
                           for n, p in self.named_parameters())
        return {"params": params, "state": {}}

    @torch.no_grad()
    def load_variables(self, variables: Dict[str, Any]) -> "Bert":
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

    # -- forward -----------------------------------------------------------

    def encode(self, features) -> torch.Tensor:
        """Token/segment ids → contextual embeddings [N,T,H]."""
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
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x

    forward = encode

    def apply(self, variables, features):
        """The JAX package's functional protocol: (hidden [N,T,H], state)
        computed with ``variables`` in place of this module's parameters."""
        params = {n.replace("/", "."): t
                  for n, t in flatten_with_names(variables["params"])}
        hidden = torch.func.functional_call(self, params, (features,))
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

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


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
