"""Decoder-only causal language model, GPT family (↔ deeplearning4j_tpu/models/gpt.py).

``Gpt`` is an ``nn.Module`` whose parameter names are the JAX package's
variable names with ``.`` for ``/`` (``embeddings.word``,
``final.out_b``, ``layer_3.attention.Wq``), so a variables tree moves
across unchanged. Training runs the pre-LN causal
``TransformerEncoderBlockModule``: on the card its attention is the causal
flash kernels (``flash_fwd``, and under grad ``flash_bwd_dkv`` and
``flash_bwd_dq``). The head is tied to ``embeddings/word``; only its bias
``final/out_b`` is its own.

The KV-cache decoder (``decode_step``, ``decode_step_slots``,
``prefill_chunk``) re-implements the block over a params tree with plain
``torch.matmul`` and the JAX package's ``finfo.min`` masks, as the JAX
package computes it outside any Pallas kernel; it launches no hand
kernel. Its decode steps write the new K/V column into the caches they
are given, in place, and return them. ``generate`` and ``beam_search``
run their loops eagerly, one step at a time, where the JAX package
compiles each loop into one program (a CUDA-graph capture is ROADMAP
work).

Not ported: ``gpt_long``'s sequence parallelism (ring or Ulysses
attention on a ``seq`` mesh, ROADMAP queue 1 item 8); a config that sets
``sequence_parallel`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.models.bert import (
    ParamGroup,
    TreeModule,
    flat_params,
)
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.config import (
    NeuralNetConfiguration,
    register_config,
    torch_dtype,
)
from deeplearning4j_tpu_torch.nn.generation import categorical
from deeplearning4j_tpu_torch.nn.initializers import truncated_normal
from deeplearning4j_tpu_torch.nn.layers.attention import (
    TransformerEncoderBlockModule,
)
from deeplearning4j_tpu_torch.ops import loss as losses
from deeplearning4j_tpu_torch.ops import nn as opsnn
from deeplearning4j_tpu_torch.runtime.device import resolve_device
from deeplearning4j_tpu_torch.train.updaters import Adam


@register_config
@dataclass
class GptConfig:
    """Architecture config; same ``@class`` name and fields as the JAX
    package's, so its JSON round-trips between the two."""

    vocab_size: int = 50257
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate: int = 3072
    max_position: int = 1024
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation: str = "gelu"
    eps: float = 1e-5
    initializer_range: float = 0.02
    remat: bool = False
    # "ring" | "ulysses" | None in the JAX package; the port runs None only
    sequence_parallel: Optional[str] = None
    net: NeuralNetConfiguration = field(
        default_factory=lambda: NeuralNetConfiguration(updater=Adam(3e-4))
    )


def _as_ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device).long()


class Gpt(TreeModule):
    """Causal transformer LM: Trainer-compatible (``init``, ``apply``,
    ``loss_fn``, ``loss_weight``) plus a KV-cache decoder;
    ``forward(ids, mask)`` = ``encode``."""

    def __init__(self, config: GptConfig, device=None):
        super().__init__()
        c = self.config = config
        if c.sequence_parallel is not None:
            raise NotImplementedError(
                f"sequence_parallel={c.sequence_parallel!r}: ring and "
                "Ulysses attention on a seq mesh are not ported yet "
                "(ROADMAP queue 1 item 8)")
        device = resolve_device(device)
        dtype = torch_dtype(c.net.dtype)
        e = c.hidden
        self.embeddings = ParamGroup({
            "word": (c.vocab_size, e), "position": (c.max_position, e)},
            dtype)
        # final pre-head LayerNorm (GPT-2 style); the decoder weight is
        # tied to the word embedding, only a bias is learned
        self.final = ParamGroup({
            "ln_gamma": (e,), "ln_beta": (e,), "out_b": (c.vocab_size,)},
            dtype)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderBlockModule(
                e, c.num_heads, intermediate=c.intermediate,
                activation=c.activation, dropout=c.dropout,
                attention_dropout=c.attention_dropout, causal=True,
                post_ln=False, eps=c.eps, remat=c.remat, dtype=dtype))
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
            c.net.seed if seed is None else seed)
        for name in ("word", "position"):
            p = self.embeddings[name]
            p.copy_(truncated_normal(tuple(p.shape), gen,
                                     c.initializer_range, p.dtype))
        self.final["ln_gamma"].fill_(1.0)
        self.final["ln_beta"].zero_()
        self.final["out_b"].zero_()
        for i in range(c.num_layers):
            getattr(self, f"layer_{i}").reset_parameters(gen)
        return self.variables()

    # -- forward -----------------------------------------------------------

    def encode(self, ids, mask=None, *, train=False, generator=None):
        """[N,T] int ids → hidden [N,T,H] (the pre-head LayerNorm
        applied). ``mask`` [N,T] 1/0 excludes padded keys from attention.
        With ``train`` and a ``generator`` (on the model's device),
        dropout is applied as in the JAX package: after the position
        embedding and in every block."""
        c = self.config
        ids = _as_ids(ids, self.device)
        emb = self.embeddings
        x = opsnn.embedding_lookup(emb["word"], ids)
        x = x + emb["position"][:ids.shape[1]][None, :, :]
        if train and c.dropout > 0.0 and generator is not None:
            x = opsnn.dropout(x, c.dropout, generator)
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask, train=train,
                                            generator=generator)
        f = self.final
        return opsnn.layer_norm(x, f["ln_gamma"], f["ln_beta"], eps=c.eps)

    def forward(self, ids, mask=None, *, train=False, generator=None,
                head=None):
        """:meth:`encode`, then ``head(hidden)`` when given (``apply`` and
        ``loss_fn`` run their heads there, inside the parameter
        substitution)."""
        hidden = self.encode(ids, mask, train=train, generator=generator)
        return hidden if head is None else head(hidden)

    def logits(self, hidden):
        """hidden [..., H] → logits [..., V] through the tied word
        embedding plus ``final/out_b``."""
        return opsnn.linear(hidden, self.embeddings["word"].t(),
                            self.final["out_b"])

    @staticmethod
    def _split(features):
        if isinstance(features, dict):
            return features["token_ids"], features.get("mask")
        return features, None

    def apply(self, variables, features):
        """The JAX package's functional protocol: (logits [N,T,V], state)
        computed with ``variables`` in place of this module's parameters.
        ``features``: ids [N,T], or ``{"token_ids", "mask"}``."""
        ids, mask = self._split(features)
        logits = torch.func.functional_call(
            self, flat_params(variables["params"]), (ids, mask),
            {"head": self.logits})
        return logits, variables.get("state", {})

    def loss_fn(self, params, state, batch, generator=None):
        """Next-token cross entropy of ``batch`` with ``params`` standing in
        for the module's parameters → ``(loss, (state, metrics))``.
        ``batch["features"]["token_ids"]`` [N,T]; an optional
        ``features["mask"]`` [N,T] excludes padding from the loss and from
        attention; an optional ``batch["labels"]`` [N,T-1] overrides the
        shifted ids. Dropout runs when a ``generator`` is given."""
        ids, mask = self._split(batch["features"])
        labels = batch.get("labels")
        if labels is None:
            labels = _as_ids(ids, self.device)[:, 1:]
        loss = torch.func.functional_call(
            self, flat_params(params), (ids, mask),
            {"train": True, "generator": generator,
             "head": lambda hidden: self._lm_loss(hidden, labels, mask)})
        return loss, (state, {"loss": loss.detach()})

    def _lm_loss(self, hidden, labels, mask):
        # logits of the positions that predict a token (all but the last)
        lg = self.logits(hidden[:, :-1])
        w = (torch.ones(labels.shape, dtype=torch.float32,
                        device=lg.device) if mask is None
             else mask[:, 1:].float())
        per_tok = losses.sparse_softmax_cross_entropy(lg, labels,
                                                      reduction="none")
        return torch.sum(per_tok * w) / torch.clamp(torch.sum(w), min=1.0)

    def loss_weight(self, batch):
        """Total loss weight of ``batch``: its non-padding next-token
        positions. Deliberately unclamped (unlike ``loss_fn``'s
        max(Σw, 1)): a fully padded microbatch has loss 0 and weighs 0
        when the trainer combines microbatches."""
        ids, mask = self._split(batch["features"])
        if mask is None:
            n, t = ids.shape
            return torch.tensor(float(n * (t - 1)))
        return torch.sum(torch.as_tensor(mask)[:, 1:].float())

    # -- KV-cache decoding (over a params tree) -----------------------------

    def init_cache(self, batch_size: int, max_len: int,
                   dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
        """Per-layer K/V buffers [N, heads, max_len, head_dim], zeroed, on
        the model's device."""
        c = self.config
        shape = (batch_size, c.num_heads, max_len, c.hidden // c.num_heads)
        return [{"k": torch.zeros(shape, dtype=dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=dtype, device=self.device)}
                for _ in range(c.num_layers)]

    def _ln(self, p, x, which):
        return opsnn.layer_norm(x, p[f"{which}_gamma"], p[f"{which}_beta"],
                                eps=self.config.eps)

    def _qkv(self, p, x):
        """Pre-LN Q/K/V projections of x [..., E] → three [..., h, hd]
        (feature layout head-major, as the block splits heads)."""
        ap = p["attention"]
        a_in = self._ln(p, x, "ln1")
        h = self.config.num_heads
        return tuple(
            opsnn.linear(a_in, ap[f"W{n}"], ap[f"b{n}"]).unflatten(
                -1, (h, -1)) for n in "qkv")

    def _block_tail(self, p, x, y):
        """The block after attention: O-projection of the merged heads
        ``y`` [..., E], residual, then the pre-LN FFN and its residual."""
        ap = p["attention"]
        x = x + opsnn.linear(y, ap["Wo"], ap["bo"])
        f = self._act(opsnn.linear(self._ln(p, x, "ln2"), p["W1"], p["b1"]))
        return x + opsnn.linear(f, p["W2"], p["b2"])

    @staticmethod
    def _attend(q, kc, vc, live):
        """softmax(q·Kᵀ/√hd) over the cached keys where ``live``,
        ``finfo.min`` elsewhere → weighted V. q [N,h,hd], kc/vc
        [N,h,L,hd], live broadcastable to [N,h,L]."""
        hd = q.shape[-1]
        scores = torch.matmul(kc, q[..., None])[..., 0] / (hd ** 0.5)
        scores = torch.where(live, scores, torch.finfo(scores.dtype).min)
        att = torch.softmax(scores, dim=-1)
        return torch.matmul(att[..., None, :], vc)[..., 0, :]

    def _final_logits(self, params, x):
        f = params["final"]
        h = opsnn.layer_norm(x, f["ln_gamma"], f["ln_beta"],
                             eps=self.config.eps)
        return opsnn.linear(h, params["embeddings"]["word"].t(), f["out_b"])

    def _block_step(self, p, cache, x_t, pos: int):
        """One token x_t [N,E] at position ``pos`` (an int) through one
        block, its K/V written into ``cache`` at ``pos``."""
        q, k, v = self._qkv(p, x_t)
        cache["k"][:, :, pos] = k
        cache["v"][:, :, pos] = v
        live = torch.arange(cache["k"].shape[2], device=x_t.device) <= pos
        y = self._attend(q, cache["k"], cache["v"], live)
        return self._block_tail(p, x_t, y.flatten(1)), cache

    def decode_step(self, params, caches, ids_t, pos: int):
        """One decode step: ids_t [N] at position ``pos`` (an int) →
        (logits [N,V], the caches with column ``pos`` written)."""
        emb = params["embeddings"]
        x = opsnn.embedding_lookup(emb["word"], _as_ids(ids_t, self.device))
        x = x + emb["position"][int(pos)]
        for i in range(self.config.num_layers):
            x, caches[i] = self._block_step(params[f"layer_{i}"], caches[i],
                                            x, int(pos))
        return self._final_logits(params, x), caches

    def _block_step_slots(self, p, cache, x_t, pos):
        """:meth:`_block_step` with per-row positions ``pos`` [N]: row i's
        K/V lands at its own ``pos[i]`` and it attends to columns
        <= ``pos[i]`` only."""
        q, k, v = self._qkv(p, x_t)
        rows = torch.arange(x_t.shape[0], device=x_t.device)
        cache["k"][rows, :, pos] = k
        cache["v"][rows, :, pos] = v
        live = (torch.arange(cache["k"].shape[2], device=x_t.device)[None, :]
                <= pos[:, None])[:, None, :]
        y = self._attend(q, cache["k"], cache["v"], live)
        return self._block_tail(p, x_t, y.flatten(1)), cache

    def decode_step_slots(self, params, caches, ids_t, pos):
        """One decode step over independent sequences (decode slots):
        ids_t [N], pos [N] (each row's own 0-based position) → (logits
        [N,V], the caches with each row's column ``pos[i]`` written). The
        core step of the continuous-batching engine."""
        emb = params["embeddings"]
        pos = _as_ids(pos, self.device)
        x = opsnn.embedding_lookup(emb["word"], _as_ids(ids_t, self.device))
        x = x + emb["position"][pos]
        for i in range(self.config.num_layers):
            x, caches[i] = self._block_step_slots(params[f"layer_{i}"],
                                                  caches[i], x, pos)
        return self._final_logits(params, x), caches

    def prefill_chunk(self, params, ids):
        """Whole-prompt prefill with full causal self-attention: ids [N,P]
        → (logits [N,P,V], per-layer ``{"k", "v"}`` [N,h,P,hd])."""
        c = self.config
        emb = params["embeddings"]
        ids = _as_ids(ids, self.device)
        n, pl = ids.shape
        x = opsnn.embedding_lookup(emb["word"], ids)
        x = x + emb["position"][:pl][None, :, :]
        causal = torch.ones((pl, pl), dtype=torch.bool,
                            device=ids.device).tril()
        kvs = []
        for i in range(c.num_layers):
            p = params[f"layer_{i}"]
            # [N,P,h,hd] -> [N,h,P,hd]
            q, k, v = (z.transpose(1, 2) for z in self._qkv(p, x))
            hd = q.shape[-1]
            scores = torch.matmul(q, k.transpose(-1, -2)) / (hd ** 0.5)
            scores = torch.where(causal, scores,
                                 torch.finfo(scores.dtype).min)
            y = torch.matmul(torch.softmax(scores, dim=-1), v)
            x = self._block_tail(p, x, y.transpose(1, 2).flatten(2))
            kvs.append({"k": k, "v": v})
        return self._final_logits(params, x), kvs

    # -- generation ----------------------------------------------------------

    def _check_lengths(self, t0, n_steps, max_len):
        total = max_len or (t0 + n_steps)
        if total < t0 + n_steps:
            raise ValueError(
                f"max_len {total} < prime {t0} + n_steps {n_steps}: the KV "
                "cache would have no column for the last tokens")
        if total > self.config.max_position:
            raise ValueError(
                f"generation length {total} exceeds max_position "
                f"{self.config.max_position}")
        return total

    @torch.inference_mode()
    def generate(self, variables, prime_ids, *, n_steps: int, rng=None,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 max_len: Optional[int] = None):
        """Sample ``n_steps`` continuation tokens after prime_ids [N,T0] →
        [N, n_steps] int32.

        The cached decoder runs over the prime (teacher forcing), then
        samples step by step: temperature=0 is the argmax; otherwise the
        logits are divided by ``temperature`` first, then ``top_k`` keeps
        the k most likely tokens and ``top_p`` the smallest set with
        cumulative probability >= p, and a token is drawn from ``rng`` (a
        ``torch.Generator`` on the model's device, or an int seed)."""
        t0 = int(torch.as_tensor(prime_ids).shape[1])
        total = self._check_lengths(t0, n_steps, max_len)
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k is not None and top_k >= self.config.vocab_size:
            top_k = None
        if top_p is not None and top_p >= 1.0:
            top_p = None
        if temperature != 0.0:
            if rng is None:
                raise ValueError("sampling (temperature != 0) needs rng")
            if not isinstance(rng, torch.Generator):
                rng = torch.Generator(self.device).manual_seed(int(rng))
        params = variables["params"]
        prime = _as_ids(prime_ids, self.device)
        caches, lg = _prefill(self, params, prime, total)
        toks = []
        for i in range(n_steps):
            if temperature == 0.0:
                tok = torch.argmax(lg, dim=-1)
            else:
                tok = categorical(_truncate_logits(lg / temperature, top_k,
                                                   top_p), rng)
            toks.append(tok)
            if i + 1 < n_steps:
                lg, caches = self.decode_step(params, caches, tok, t0 + i)
        return torch.stack(toks, dim=1).to(torch.int32)

    @torch.inference_mode()
    def beam_search(self, variables, prime_ids, *, n_steps: int,
                    beam_size: int = 4, length_penalty: float = 0.0,
                    eos_id: Optional[int] = None,
                    max_len: Optional[int] = None):
        """Beam-search ``n_steps`` continuation tokens after prime_ids
        [N,T0] → (sequences [N, beam_size, n_steps] int32, scores
        [N, beam_size] float32), best beam first. Scores are summed
        next-token log-probabilities; with ``length_penalty`` α > 0 they
        are GNMT-normalised by ((5 + len) / 6)^α. ``eos_id`` freezes a
        beam once it emits eos (it continues on eos at log-probability
        0). beam_size=1 is greedy decoding."""
        t0 = int(torch.as_tensor(prime_ids).shape[1])
        total = self._check_lengths(t0, n_steps, max_len)
        if beam_size < 1:
            raise ValueError(f"beam_size must be >= 1, got {beam_size}")
        if beam_size > self.config.vocab_size:
            raise ValueError(
                f"beam_size {beam_size} > vocab {self.config.vocab_size}")
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        if length_penalty < 0:
            raise ValueError(
                f"length_penalty must be >= 0, got {length_penalty}")
        return _beam_search(self, variables["params"],
                            _as_ids(prime_ids, self.device), t0, n_steps,
                            total, int(beam_size), float(length_penalty),
                            eos_id)


def _prefill(model: Gpt, params, prime, total: int):
    """The cached decoder over the prime (teacher forcing, one step a
    position) → (caches, last-position logits). Shared by generate and
    beam_search."""
    caches = model.init_cache(prime.shape[0], total,
                              dtype=params["embeddings"]["word"].dtype)
    lg = None
    for t in range(prime.shape[1]):
        lg, caches = model.decode_step(params, caches, prime[:, t], t)
    return caches, lg


def _truncate_logits(lg, top_k: Optional[int], top_p: Optional[float]):
    """Mask logits outside the top-k set and/or the nucleus (top-p) set to
    ``finfo.min``; vocab axis last. top-k filters first."""
    neg = torch.finfo(lg.dtype).min
    if top_k is not None and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, neg, lg)
    if top_p is not None and top_p < 1.0:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_lg, dim=-1), dim=-1)
        # keep tokens while the mass BEFORE them is < p (the first is
        # always kept); the threshold is the smallest kept logit
        before = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]],
                           dim=-1)
        thresh = torch.where(before < top_p, sorted_lg,
                             torch.inf).amin(dim=-1, keepdim=True)
        lg = torch.where(lg < thresh, neg, lg)
    return lg


def _top(x, k):
    """The k largest entries of each row, largest first, the lower index
    first among equals (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_search(model: Gpt, params, prime, t0, n_steps, total, B,
                 length_penalty, eos_id):
    neg = -1e30
    n = prime.shape[0]
    caches, last = _prefill(model, params, prime, total)
    v = last.shape[-1]
    logp0 = torch.log_softmax(last.float(), dim=-1)
    caches = [{k: x.repeat_interleave(B, dim=0) for k, x in c.items()}
              for c in caches]
    # the top-B tokens of the prime's next-token distribution seed the beams
    scores, tok = _top(logp0, B)                          # [N,B]
    tok0 = tok
    finished = (tok0 == eos_id) if eos_id is not None \
        else torch.zeros((n, B), dtype=torch.bool, device=prime.device)
    lengths = torch.ones((n, B), dtype=torch.int32, device=prime.device)
    vocab = torch.arange(v, device=prime.device)
    toks, parents = [], []
    # iteration i decodes the previous token (first: tok0 at slot t0) and
    # expands to the next one: n_steps - 1 expansions after tok0
    for i in range(n_steps - 1):
        lg, caches = model.decode_step(params, caches, tok.reshape(n * B),
                                       t0 + i)
        lp = torch.log_softmax(lg.reshape(n, B, v).float(), dim=-1)
        if eos_id is not None:
            eos_only = torch.where(vocab == eos_id, 0.0, neg)
            lp = torch.where(finished[..., None], eos_only, lp)
        scores, idx = _top((scores[..., None] + lp).reshape(n, B * v), B)
        parent = idx // v
        tok = idx % v
        rows = (torch.arange(n, device=prime.device)[:, None] * B
                + parent).reshape(-1)
        caches = [{k: x[rows] for k, x in c.items()} for c in caches]
        finished = torch.gather(finished, 1, parent)
        lengths = torch.gather(lengths, 1, parent) + (~finished).to(
            torch.int32)
        if eos_id is not None:
            finished = finished | (tok == eos_id)
        toks.append(tok)
        parents.append(parent)
    # backtrace the parent chain, newest step first
    beam_idx = torch.arange(B, device=prime.device)[None, :].expand(n, B)
    rev = []
    for tok_t, parent_t in zip(reversed(toks), reversed(parents)):
        rev.append(torch.gather(tok_t, 1, beam_idx))
        beam_idx = torch.gather(parent_t, 1, beam_idx)
    first = torch.gather(tok0, 1, beam_idx)
    seqs = torch.stack([first] + rev[::-1], dim=2)        # [N,B,n_steps]
    final = scores
    if length_penalty:
        final = final / (((5.0 + lengths.float()) / 6.0) ** length_penalty)
    order = torch.argsort(-final, dim=1, stable=True)
    seqs = torch.gather(seqs, 1, order[..., None].expand_as(seqs))
    return seqs.to(torch.int32), torch.gather(final, 1, order)


def gpt2_small(device=None, **kw) -> Gpt:
    """GPT-2 small dims (12L/768H/12A, 1024 ctx)."""
    return Gpt(GptConfig(**kw), device=device)


def gpt_tiny(device=None, **kw) -> Gpt:
    """2L/64H/2A toy config for tests and CPU runs."""
    kw.setdefault("hidden", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("intermediate", 128)
    kw.setdefault("vocab_size", 128)
    kw.setdefault("max_position", 64)
    kw.setdefault("dropout", 0.0)
    kw.setdefault("attention_dropout", 0.0)
    return Gpt(GptConfig(**kw), device=device)


def gpt_long(device=None, **kw) -> Gpt:
    """The JAX package's long-context config (ring-attention sequence
    parallelism + remat, 32768 positions): raises NotImplementedError
    until sequence parallelism is ported (ROADMAP queue 1 item 8)."""
    kw.setdefault("sequence_parallel", "ring")
    kw.setdefault("remat", True)
    kw.setdefault("max_position", 32768)
    return Gpt(GptConfig(**kw), device=device)
