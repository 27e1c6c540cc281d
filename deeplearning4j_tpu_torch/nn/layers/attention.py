"""Attention layers (↔ deeplearning4j_tpu/nn/layers/attention.py).

``SelfAttention`` and ``TransformerEncoderBlock`` as ``nn.Module``s whose
parameters carry the JAX package's names and layouts (``Wq`` [E, proj],
``Wo`` [proj, out], ``ln1_gamma``, …), so a variables tree moves across
name for name. Sequences are [N, T, E]; heads split as
[N,T,E] → [N,T,h,hd] → [N,h,T,hd]. Attention goes through
``kernels.flash_attention.flash_attention``: the hand kernels on the card
(forward, and under grad the two backward kernels), the plain versions on
the CPU.

Train mode (``train=True`` with a ``torch.Generator``) applies the JAX
package's dropouts: ``SelfAttention.dropout`` after merging heads, before
the O-projection (``_attend_tail``), and the block's two residual
dropouts. ``remat`` recomputes a block in backward
(``torch.utils.checkpoint``, ↔ ``jax.checkpoint``); the recomputation
replays the generator from the state it had in the forward, so it draws
the same dropout masks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.kernels.flash_attention import flash_attention
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.initializers import get_initializer
from deeplearning4j_tpu_torch.ops import nn as opsnn


def _split_heads(x, num_heads):
    n, t, e = x.shape
    return x.reshape(n, t, num_heads, e // num_heads).permute(0, 2, 1, 3)


def _merge_heads(x):
    n, h, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(n, t, h * d)


def _attend_tail(y_heads, wo, bo, *, dropout, train, generator):
    """Shared post-attention pipeline: merge heads, dropout, O-projection."""
    y = _merge_heads(y_heads)
    if train and dropout > 0.0 and generator is not None:
        y = opsnn.dropout(y, dropout, generator)
    return opsnn.linear(y, wo, bo)


class SelfAttention(nn.Module):
    """↔ SelfAttention: multi-head self-attention with learned Q/K/V/O
    projections, ``embed`` wide in and out (the JAX layer's default
    ``out_size`` and ``head_size``), with biases."""

    def __init__(self, embed: int, num_heads: int = 1, *,
                 causal: bool = False, dropout: float = 0.0,
                 weight_init: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.dropout = dropout
        self.weight_init = weight_init or "xavier"
        for name in ("Wq", "Wk", "Wv", "Wo"):
            setattr(self, name,
                    nn.Parameter(torch.empty(embed, embed, dtype=dtype)))
        for name in ("bq", "bk", "bv", "bo"):
            setattr(self, name, nn.Parameter(torch.zeros(embed, dtype=dtype)))
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        w_init = get_initializer(self.weight_init)
        for w in (self.Wq, self.Wk, self.Wv, self.Wo):
            w.copy_(w_init(tuple(w.shape), generator, w.dtype))
        for b in (self.bq, self.bk, self.bv, self.bo):
            b.zero_()

    PARAMS = ("Wq", "Wk", "Wv", "Wo", "bq", "bk", "bv", "bo")

    def forward(self, x, mask=None, *, train=False, generator=None):
        return self.attend({n: getattr(self, n) for n in self.PARAMS}, x,
                           mask, train=train, generator=generator)

    def attend(self, p, x, mask=None, *, train=False, generator=None):
        """The forward with the weights given as ``p`` (by name)."""
        h = self.num_heads
        q = _split_heads(opsnn.linear(x, p["Wq"], p["bq"]), h)
        k = _split_heads(opsnn.linear(x, p["Wk"], p["bk"]), h)
        v = _split_heads(opsnn.linear(x, p["Wv"], p["bv"]), h)
        y = flash_attention(q, k, v, causal=self.causal, key_mask=mask)
        return _attend_tail(y, p["Wo"], p["bo"], dropout=self.dropout,
                            train=train, generator=generator)


class TransformerEncoderBlock(nn.Module):
    """↔ TransformerEncoderBlock: MHA + residual + LN, then
    FFN(intermediate, activation) + residual + LN. ``post_ln=True`` is
    original BERT; ``post_ln=False`` is pre-LN (with ``causal`` for GPT).
    ``dropout`` is the two residual dropouts, ``attention_dropout`` the
    attention's; ``remat`` recomputes the block in backward."""

    def __init__(self, embed: int, num_heads: int = 8, *,
                 intermediate: int = 0, activation: str = "gelu",
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 causal: bool = False, post_ln: bool = True,
                 eps: float = 1e-12, weight_init: Optional[str] = None,
                 remat: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        inter = intermediate or 4 * embed
        self.post_ln = post_ln
        self.eps = eps
        self.dropout = dropout
        self.remat = remat
        self.activation = get_activation(activation)
        self.weight_init = weight_init or "xavier"
        generator = generator or torch.Generator().manual_seed(0)
        self.attention = SelfAttention(embed, num_heads, causal=causal,
                                       dropout=attention_dropout,
                                       weight_init=weight_init,
                                       generator=generator, dtype=dtype)

        def param(fill, *shape):
            return nn.Parameter(fill(shape, dtype=dtype))

        self.W1 = param(torch.empty, embed, inter)
        self.b1 = param(torch.zeros, inter)
        self.W2 = param(torch.empty, inter, embed)
        self.b2 = param(torch.zeros, embed)
        self.ln1_gamma = param(torch.ones, embed)
        self.ln1_beta = param(torch.zeros, embed)
        self.ln2_gamma = param(torch.ones, embed)
        self.ln2_beta = param(torch.zeros, embed)
        self._reset_own(generator)

    @torch.no_grad()
    def _reset_own(self, generator: torch.Generator):
        w_init = get_initializer(self.weight_init)
        for w in (self.W1, self.W2):
            w.copy_(w_init(tuple(w.shape), generator, w.dtype))
        for b in (self.b1, self.b2, self.ln1_beta, self.ln2_beta):
            b.zero_()
        self.ln1_gamma.fill_(1.0)
        self.ln2_gamma.fill_(1.0)

    def reset_parameters(self, generator: torch.Generator):
        self.attention.reset_parameters(generator)
        self._reset_own(generator)

    OWN_PARAMS = ("W1", "b1", "W2", "b2", "ln1_gamma", "ln1_beta",
                  "ln2_gamma", "ln2_beta")

    def forward(self, x, mask=None, *, train=False, generator=None):
        # The weights as bound now: under torch.func.functional_call
        # (Bert.loss_fn) these are the call's tensors, which a remat
        # recomputation in backward, after the call, must still use.
        p = {n: getattr(self, n) for n in self.OWN_PARAMS}
        p["attention"] = {n: getattr(self.attention, n)
                          for n in SelfAttention.PARAMS}
        if not (self.remat and torch.is_grad_enabled()):
            return self._forward(p, x, mask, train, generator)
        state = generator.get_state() if generator is not None else None

        def run(h):
            if state is not None:  # the recomputation redraws the masks
                generator.set_state(state)
            return self._forward(p, h, mask, train, generator)

        return checkpoint(run, x, use_reentrant=False,
                          preserve_rng_state=False)

    def _forward(self, p, x, mask, train, generator):
        def ln(h, which):
            return opsnn.layer_norm(h, p[f"{which}_gamma"],
                                    p[f"{which}_beta"], eps=self.eps)

        def ffn(h):
            f = self.activation(opsnn.linear(h, p["W1"], p["b1"]))
            return opsnn.linear(f, p["W2"], p["b2"])

        def drop(h):
            if train and self.dropout > 0.0 and generator is not None:
                return opsnn.dropout(h, self.dropout, generator)
            return h

        def attend(h):
            return self.attention.attend(p["attention"], h, mask,
                                         train=train, generator=generator)

        if self.post_ln:  # original-BERT residual order
            x = ln(x + drop(attend(x)), "ln1")
            return ln(x + drop(ffn(x)), "ln2")
        x = x + drop(attend(ln(x, "ln1")))
        return x + drop(ffn(ln(x, "ln2")))
