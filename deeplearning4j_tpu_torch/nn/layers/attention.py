"""Attention layers (↔ deeplearning4j_tpu/nn/layers/attention.py).

The JAX package's six attention layer configs, registered under its
names so its config JSON loads here: ``SelfAttention``,
``LearnedSelfAttention``, ``CrossAttention`` (the multi-input
AttentionVertex: ``init_multi``/``apply_multi``/``output_shape_multi``),
``RecurrentAttention``, ``TransformerEncoderBlock`` and
``PositionalEmbedding``. Their parameters carry the JAX package's names
and layouts (``Wq`` [E, proj], ``Wo`` [proj, out], ``ln1_gamma``, …), so a
variables tree moves across name for name. Sequences are [N, T, E]; heads
split as [N,T,E] → [N,T,h,hd] → [N,h,T,hd].

Attention goes through ``kernels.flash_attention.flash_attention``: the
hand kernels on the card (forward, and under grad the three backward
kernels; a head size below 128 that the kernels lack runs zero-padded),
the plain versions on the CPU. ``RecurrentAttention`` attends from one
query a step, as the JAX package's einsums do, in plain torch on both
devices: no Pallas kernel lies under it.

``SelfAttentionModule`` and ``TransformerEncoderBlockModule`` are the
same attention and block as ``nn.Module``s, the form BERT and GPT build;
they share the forward functions with the configs.

Train mode (``train=True`` with a ``torch.Generator``) applies the JAX
package's dropouts: the attention's after merging heads, before the
O-projection (``_attend_tail``), and the block's two residual dropouts.
``remat`` recomputes a block in backward (``torch.utils.checkpoint``, ↔
``jax.checkpoint``); the recomputation replays the generator from the
state it had in the forward, so it draws the same dropout masks.

``sequence_parallel`` ("ring" or "ulysses") is validated as in the JAX
package, whose layers fall back to the flash kernel when no sequence mesh
is active; the port has no sequence mesh yet (ROADMAP queue 1 item 8), so
they always attend through the flash kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.kernels.flash_attention import flash_attention
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_config
from deeplearning4j_tpu_torch.nn.initializers import get_initializer
from deeplearning4j_tpu_torch.ops import nn as opsnn

VALID_SP_IMPLS = ("ring", "ulysses")


def _split_heads(x, num_heads):
    n, t, e = x.shape
    return x.reshape(n, t, num_heads, e // num_heads).permute(0, 2, 1, 3)


def _merge_heads(x):
    n, h, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(n, t, h * d)


def _init_qkv(generator, embeds, proj, out, dtype, w_init, use_bias):
    """Shared Q/K/V/O projection init. embeds = (eq, ek, ev)."""
    eq, ek, ev = embeds
    params = {
        "Wq": w_init((eq, proj), generator, dtype),
        "Wk": w_init((ek, proj), generator, dtype),
        "Wv": w_init((ev, proj), generator, dtype),
        "Wo": w_init((proj, out), generator, dtype),
    }
    if use_bias:
        for name, size in (("bq", proj), ("bk", proj), ("bv", proj),
                           ("bo", out)):
            params[name] = torch.zeros((size,), dtype=dtype)
    return params


def _attend_tail(y_heads, wo, bo, *, dropout, train, generator,
                 project=True):
    """Shared post-attention pipeline: merge heads, dropout, O-projection."""
    y = _merge_heads(y_heads)
    if train and dropout > 0.0 and generator is not None:
        y = opsnn.dropout(y, dropout, generator)
    if project:
        y = opsnn.linear(y, wo, bo)
    return y


def _self_attend(p, x, mask, *, num_heads, causal, dropout, train,
                 generator):
    """Multi-head self-attention with the weights ``p`` (by name; the
    biases optional)."""
    q = _split_heads(opsnn.linear(x, p["Wq"], p.get("bq")), num_heads)
    k = _split_heads(opsnn.linear(x, p["Wk"], p.get("bk")), num_heads)
    v = _split_heads(opsnn.linear(x, p["Wv"], p.get("bv")), num_heads)
    y = flash_attention(q, k, v, causal=causal, key_mask=mask)
    return _attend_tail(y, p["Wo"], p.get("bo"), dropout=dropout,
                        train=train, generator=generator)


def _check_sp(impl):
    if impl is not None and impl not in VALID_SP_IMPLS:
        raise ValueError(f"sequence_parallel={impl!r}; valid: "
                         f"{VALID_SP_IMPLS}")


@register_config
@dataclass
class SelfAttention(LayerConfig):
    """↔ SelfAttention (SelfAttentionLayer): multi-head dot-product
    self-attention with learned Q/K/V/O projections. ``out_size`` 0 is the
    input's embed size; ``head_size`` defaults to out/num_heads;
    ``causal`` adds the autoregressive triangle."""

    num_heads: int = 1
    out_size: int = 0  # nOut; 0 → same as input embed size
    head_size: Optional[int] = None
    causal: bool = False
    dropout: float = 0.0
    weight_init: Optional[str] = None
    use_bias: bool = True
    sequence_parallel: Optional[str] = None

    def __post_init__(self):
        _check_sp(self.sequence_parallel)

    def _dims(self, e):
        out = self.out_size or e
        hd = self.head_size or out // self.num_heads
        return out, hd

    def output_shape(self, input_shape):
        t, e = input_shape
        out, _ = self._dims(e)
        return (t, out)

    def init(self, generator, input_shape, dtype):
        e = input_shape[-1]
        out, hd = self._dims(e)
        w_init = get_initializer(self.weight_init or "xavier")
        return _init_qkv(generator, (e, e, e), self.num_heads * hd, out,
                         dtype, w_init, self.use_bias), {}

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        return _self_attend(params, x, mask, num_heads=self.num_heads,
                            causal=self.causal, dropout=self.dropout,
                            train=train, generator=generator), state


@register_config
@dataclass
class LearnedSelfAttention(SelfAttention):
    """↔ LearnedSelfAttentionLayer: attention from ``n_queries`` learned
    query vectors ``Q`` [n_queries, proj] (no ``Wq``/``bq``); the output
    is [N, n_queries, out] whatever T. On the card the forward kernel runs
    at T = n_queries, however small."""

    n_queries: int = 1

    def __post_init__(self):
        if self.sequence_parallel is not None:
            raise ValueError(
                "LearnedSelfAttention does not support sequence_parallel "
                "(queries are learned, not sequence-sharded)")

    def output_shape(self, input_shape):
        t, e = input_shape
        out, _ = self._dims(e)
        return (self.n_queries, out)

    def init(self, generator, input_shape, dtype):
        params, state = SelfAttention.init(self, generator, input_shape,
                                           dtype)
        _, hd = self._dims(input_shape[-1])
        params["Q"] = get_initializer(self.weight_init or "xavier")(
            (self.n_queries, self.num_heads * hd), generator, dtype)
        del params["Wq"]
        params.pop("bq", None)
        return params, state

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        n = x.shape[0]
        h = self.num_heads
        q = params["Q"].expand(n, *params["Q"].shape)
        k = opsnn.linear(x, params["Wk"], params.get("bk"))
        v = opsnn.linear(x, params["Wv"], params.get("bv"))
        y = flash_attention(_split_heads(q, h), _split_heads(k, h),
                            _split_heads(v, h), key_mask=mask)
        return _attend_tail(y, params["Wo"], params.get("bo"),
                            dropout=self.dropout, train=train,
                            generator=generator), state


@register_config
@dataclass
class CrossAttention(LayerConfig):
    """↔ CrossAttention (AttentionVertex): multi-head attention whose
    queries, keys and values come from different graph inputs. 1 input:
    q = k = v; 2: (queries, kv); 3: (queries, keys, values).
    ``project_input=False`` skips the Q/K/V/O projections; then the
    inputs share one embed size that ``num_heads`` divides."""

    num_heads: int = 1
    out_size: int = 0  # nOut; 0 → query embed size
    head_size: Optional[int] = None
    project_input: bool = True
    causal: bool = False
    dropout: float = 0.0
    weight_init: Optional[str] = None
    use_bias: bool = True

    def _dims(self, eq):
        out = self.out_size or eq
        hd = self.head_size or out // self.num_heads
        return out, hd

    def output_shape_multi(self, in_shapes):
        tq, eq = in_shapes[0]
        if not self.project_input:
            return (tq, eq)
        out, _ = self._dims(eq)
        return (tq, out)

    # single-input fallbacks, so the layer also works in SequentialModel
    def output_shape(self, input_shape):
        return self.output_shape_multi([input_shape])

    def init(self, generator, input_shape, dtype):
        return self.init_multi(generator, [input_shape], dtype)

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        return self.apply_multi(params, state, [x], train=train,
                                generator=generator, mask=mask)

    @staticmethod
    def _resolve(xs):
        if len(xs) == 1:
            return xs[0], xs[0], xs[0]
        if len(xs) == 2:
            return xs[0], xs[1], xs[1]
        if len(xs) == 3:
            return xs[0], xs[1], xs[2]
        raise ValueError(
            f"CrossAttention takes 1-3 inputs (q[,k[,v]]), got {len(xs)}")

    def init_multi(self, generator, in_shapes, dtype):
        q_shape, k_shape, v_shape = self._resolve(list(in_shapes))
        eq, ek, ev = q_shape[-1], k_shape[-1], v_shape[-1]
        if not self.project_input:
            if not eq == ek == ev:
                raise ValueError(
                    "project_input=False requires equal embed sizes, got "
                    f"{(eq, ek, ev)}")
            if eq % self.num_heads:
                raise ValueError(
                    f"num_heads={self.num_heads} must divide embed {eq} "
                    "when project_input=False")
            return {}, {}
        out, hd = self._dims(eq)
        w_init = get_initializer(self.weight_init or "xavier")
        return _init_qkv(generator, (eq, ek, ev), self.num_heads * hd, out,
                         dtype, w_init, self.use_bias), {}

    def apply_multi(self, params, state, xs, *, train=False, generator=None,
                    mask=None):
        q, k, v = self._resolve(list(xs))
        if self.project_input:
            q = opsnn.linear(q, params["Wq"], params.get("bq"))
            k = opsnn.linear(k, params["Wk"], params.get("bk"))
            v = opsnn.linear(v, params["Wv"], params.get("bv"))
        h = self.num_heads
        y = flash_attention(_split_heads(q, h), _split_heads(k, h),
                            _split_heads(v, h), causal=self.causal,
                            key_mask=mask)
        return _attend_tail(y, params.get("Wo"), params.get("bo"),
                            dropout=self.dropout, train=train,
                            generator=generator,
                            project=self.project_input), state


@register_config
@dataclass
class RecurrentAttention(LayerConfig):
    """↔ RecurrentAttentionLayer: an RNN whose step attends over the whole
    input sequence from its previous hidden state,

        a_t = MHA(q = h_{t-1}·Wq, K = X·Wk, V = X·Wv)·Wo
        h_t = act(x_t·W + b + a_t·R).

    K, V and x·W + b are projected once for the whole sequence; then a
    loop over T of single-query attention (scores masked with -1e9 where
    ``mask`` is 0), in plain torch as the JAX package's einsums."""

    units: int = 0  # nOut (required)
    num_heads: int = 1
    head_size: Optional[int] = None
    activation: str = "tanh"
    weight_init: Optional[str] = None

    def _proj(self):
        hd = self.head_size or self.units // self.num_heads
        return self.num_heads * hd

    def output_shape(self, input_shape):
        t, _ = input_shape
        return (t, self.units)

    def init(self, generator, input_shape, dtype):
        if self.units <= 0:
            raise ValueError("RecurrentAttention requires units > 0")
        e, u = input_shape[-1], self.units
        proj = self._proj()
        w_init = get_initializer(self.weight_init or "xavier")
        params = {name: w_init(shape, generator, dtype) for name, shape in (
            ("Wq", (u, proj)), ("Wk", (e, proj)), ("Wv", (e, proj)),
            ("Wo", (proj, u)), ("W", (e, u)), ("R", (u, u)))}
        params["b"] = torch.zeros((u,), dtype=dtype)
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        n, t, _ = x.shape
        heads = self.num_heads
        hd = self._proj() // heads
        k = _split_heads(opsnn.linear(x, params["Wk"]), heads)  # [N,H,T,D]
        v = _split_heads(opsnn.linear(x, params["Wv"]), heads)
        scale = hd ** -0.5
        xw = opsnn.linear(x, params["W"]) + params["b"]  # [N,T,units]
        act = get_activation(self.activation)
        dtype = torch.promote_types(x.dtype, params["W"].dtype)
        h = torch.zeros((n, self.units), dtype=dtype, device=x.device)
        ys = []
        for step in range(t):
            q = opsnn.linear(h, params["Wq"]).reshape(n, heads, hd)
            scores = torch.einsum("nhd,nhtd->nht", q, k) * scale
            if mask is not None:
                scores = scores.masked_fill(mask[:, None, :] <= 0, -1e9)
            w = torch.softmax(scores, dim=-1)
            a = torch.einsum("nht,nhtd->nhd", w, v).reshape(n, heads * hd)
            a = opsnn.linear(a, params["Wo"])
            h = act(xw[:, step] + a @ params["R"])
            ys.append(h)
        return torch.stack(ys, dim=1), state


def _block_forward(p, x, mask, *, num_heads, causal, attention_dropout,
                   activation, dropout, post_ln, eps, train, generator):
    """The encoder block with the weights ``p`` (``p["attention"]`` the
    attention's): post-LN (original BERT) or pre-LN."""
    def ln(h, which):
        return opsnn.layer_norm(h, p[f"{which}_gamma"], p[f"{which}_beta"],
                                eps=eps)

    def ffn(h):
        f = activation(opsnn.linear(h, p["W1"], p["b1"]))
        return opsnn.linear(f, p["W2"], p["b2"])

    def drop(h):
        if train and dropout > 0.0 and generator is not None:
            return opsnn.dropout(h, dropout, generator)
        return h

    def attend(h):
        return _self_attend(p["attention"], h, mask, num_heads=num_heads,
                            causal=causal, dropout=attention_dropout,
                            train=train, generator=generator)

    if post_ln:  # original-BERT residual order
        x = ln(x + drop(attend(x)), "ln1")
        return ln(x + drop(ffn(x)), "ln2")
    x = x + drop(attend(ln(x, "ln1")))
    return x + drop(ffn(ln(x, "ln2")))


def _remat(forward, x, generator):
    """``forward(x)`` recomputed in backward (``torch.utils.checkpoint``);
    the recomputation first puts the generator back in the state it had,
    so it redraws the same dropout masks."""
    state = generator.get_state() if generator is not None else None

    def run(h):
        if state is not None:
            generator.set_state(state)
        return forward(h)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


@register_config
@dataclass
class TransformerEncoderBlock(LayerConfig):
    """↔ TransformerEncoderBlock: MHA + residual + LN, then
    FFN(intermediate, activation) + residual + LN. ``post_ln=True`` is
    original BERT; ``post_ln=False`` pre-LN. Params: ``attention``
    (SelfAttention's), ``W1``/``b1``, ``W2``/``b2``, ``ln1_*``,
    ``ln2_*``."""

    num_heads: int = 8
    intermediate: int = 0  # FFN hidden; 0 → 4×embed
    activation: str = "gelu"
    dropout: float = 0.0
    attention_dropout: float = 0.0
    causal: bool = False
    post_ln: bool = True
    eps: float = 1e-12
    weight_init: Optional[str] = None
    sequence_parallel: Optional[str] = None  # threaded to the attention
    remat: bool = False

    def __post_init__(self):
        _check_sp(self.sequence_parallel)

    def output_shape(self, input_shape):
        return tuple(input_shape)

    def init(self, generator, input_shape, dtype):
        e = input_shape[-1]
        inter = self.intermediate or 4 * e
        w_init = get_initializer(self.weight_init or "xavier")
        att_p, _ = SelfAttention(
            num_heads=self.num_heads, weight_init=self.weight_init).init(
                generator, input_shape, dtype)
        params = {
            "attention": att_p,
            "W1": w_init((e, inter), generator, dtype),
            "b1": torch.zeros((inter,), dtype=dtype),
            "W2": w_init((inter, e), generator, dtype),
            "b2": torch.zeros((e,), dtype=dtype),
        }
        for which in ("ln1", "ln2"):
            params[f"{which}_gamma"] = torch.ones((e,), dtype=dtype)
            params[f"{which}_beta"] = torch.zeros((e,), dtype=dtype)
        return params, {}

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        def forward(h):
            return _block_forward(
                params, h, mask, num_heads=self.num_heads,
                causal=self.causal,
                attention_dropout=self.attention_dropout,
                activation=get_activation(self.activation),
                dropout=self.dropout, post_ln=self.post_ln, eps=self.eps,
                train=train, generator=generator)

        if self.remat and torch.is_grad_enabled():
            return _remat(forward, x, generator), state
        return forward(x), state


@register_config
@dataclass
class PositionalEmbedding(LayerConfig):
    """↔ PositionalEmbedding: learned absolute positions ``P`` [max_len,
    E], the first T rows added to an [N,T,E] input."""

    max_len: int = 512

    def output_shape(self, input_shape):
        return tuple(input_shape)

    def init(self, generator, input_shape, dtype):
        e = input_shape[-1]
        return {"P": 0.02 * torch.randn((self.max_len, e),
                                        generator=generator, dtype=dtype)}, {}

    def apply(self, params, state, x, *, train=False, generator=None):
        return x + params["P"][:x.shape[1]][None, :, :], state


# -- the nn.Module forms that BERT and GPT build --------------------------------

class SelfAttentionModule(nn.Module):
    """``SelfAttention`` as an ``nn.Module``: ``embed`` wide in and out
    (the config's default ``out_size`` and ``head_size``), with biases."""

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
        return _self_attend(p, x, mask, num_heads=self.num_heads,
                            causal=self.causal, dropout=self.dropout,
                            train=train, generator=generator)


class TransformerEncoderBlockModule(nn.Module):
    """``TransformerEncoderBlock`` as an ``nn.Module``. ``dropout`` is the
    two residual dropouts, ``attention_dropout`` the attention's;
    ``remat`` recomputes the block in backward."""

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
        self.attention = SelfAttentionModule(
            embed, num_heads, causal=causal, dropout=attention_dropout,
            weight_init=weight_init, generator=generator, dtype=dtype)

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
                          for n in SelfAttentionModule.PARAMS}
        att = self.attention

        def forward(h):
            return _block_forward(
                p, h, mask, num_heads=att.num_heads, causal=att.causal,
                attention_dropout=att.dropout, activation=self.activation,
                dropout=self.dropout, post_ln=self.post_ln, eps=self.eps,
                train=train, generator=generator)

        if self.remat and torch.is_grad_enabled():
            return _remat(forward, x, generator)
        return forward(x)
