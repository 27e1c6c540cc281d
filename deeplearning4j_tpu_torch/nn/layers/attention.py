"""Attention layers (↔ deeplearning4j_tpu/nn/layers/attention.py), forward only.

``SelfAttention`` and ``TransformerEncoderBlock`` as ``nn.Module``s whose
parameters carry the JAX package's names and layouts (``Wq`` [E, proj],
``Wo`` [proj, out], ``ln1_gamma``, …), so a variables tree moves across
name for name. Sequences are [N, T, E]; heads split as
[N,T,E] → [N,T,h,hd] → [N,h,T,hd]. Attention goes through
``kernels.flash_attention.flash_attention``: the hand kernel on the card,
the plain version on the CPU.

Dropout is not applied: the port serves (inference) so far; training
comes with the Trainer.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

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


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class SelfAttention(nn.Module):
    """↔ SelfAttention: multi-head self-attention with learned Q/K/V/O
    projections, ``embed`` wide in and out (the JAX layer's default
    ``out_size`` and ``head_size``), with biases."""

    def __init__(self, embed: int, num_heads: int = 1, *,
                 causal: bool = False, weight_init: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.weight_init = weight_init or "xavier"
        for name in ("Wq", "Wk", "Wv", "Wo"):
            setattr(self, name, _param(torch.empty(embed, embed, dtype=dtype)))
        for name in ("bq", "bk", "bv", "bo"):
            setattr(self, name, _param(torch.zeros(embed, dtype=dtype)))
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        w_init = get_initializer(self.weight_init)
        for w in (self.Wq, self.Wk, self.Wv, self.Wo):
            w.copy_(w_init(tuple(w.shape), generator, w.dtype))
        for b in (self.bq, self.bk, self.bv, self.bo):
            b.zero_()

    def forward(self, x, mask=None):
        h = self.num_heads
        q = _split_heads(opsnn.linear(x, self.Wq, self.bq), h)
        k = _split_heads(opsnn.linear(x, self.Wk, self.bk), h)
        v = _split_heads(opsnn.linear(x, self.Wv, self.bv), h)
        y = flash_attention(q, k, v, causal=self.causal, key_mask=mask)
        return opsnn.linear(_merge_heads(y), self.Wo, self.bo)


class TransformerEncoderBlock(nn.Module):
    """↔ TransformerEncoderBlock: MHA + residual + LN, then
    FFN(intermediate, activation) + residual + LN. ``post_ln=True`` is
    original BERT; ``post_ln=False`` is pre-LN (with ``causal`` for GPT)."""

    def __init__(self, embed: int, num_heads: int = 8, *,
                 intermediate: int = 0, activation: str = "gelu",
                 causal: bool = False, post_ln: bool = True,
                 eps: float = 1e-12, weight_init: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        inter = intermediate or 4 * embed
        self.post_ln = post_ln
        self.eps = eps
        self.activation = get_activation(activation)
        self.weight_init = weight_init or "xavier"
        generator = generator or torch.Generator().manual_seed(0)
        self.attention = SelfAttention(embed, num_heads, causal=causal,
                                       weight_init=weight_init,
                                       generator=generator, dtype=dtype)
        self.W1 = _param(torch.empty(embed, inter, dtype=dtype))
        self.b1 = _param(torch.zeros(inter, dtype=dtype))
        self.W2 = _param(torch.empty(inter, embed, dtype=dtype))
        self.b2 = _param(torch.zeros(embed, dtype=dtype))
        self.ln1_gamma = _param(torch.ones(embed, dtype=dtype))
        self.ln1_beta = _param(torch.zeros(embed, dtype=dtype))
        self.ln2_gamma = _param(torch.ones(embed, dtype=dtype))
        self.ln2_beta = _param(torch.zeros(embed, dtype=dtype))
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

    def _ln(self, h, which):
        return opsnn.layer_norm(h, getattr(self, f"{which}_gamma"),
                                getattr(self, f"{which}_beta"), eps=self.eps)

    def _ffn(self, x):
        f = self.activation(opsnn.linear(x, self.W1, self.b1))
        return opsnn.linear(f, self.W2, self.b2)

    def forward(self, x, mask=None):
        if self.post_ln:  # original-BERT residual order
            x = self._ln(x + self.attention(x, mask), "ln1")
            return self._ln(x + self._ffn(x), "ln2")
        x = x + self.attention(self._ln(x, "ln1"), mask)
        return x + self._ffn(self._ln(x, "ln2"))
