"""Stateful RNN inference and autoregressive sampling (↔ deeplearning4j_tpu/nn/generation.py).

- :func:`sample_token` — the per-row temperature sampler that
  ``Gpt.generate``, the serving engine (``serving/generation.py``) and the
  char-RNN's :func:`generate` share. Draws come from an explicit
  ``torch.Generator`` on the logits' device, where the JAX package takes a
  key: the two packages draw different tokens from one seed, and agree
  exactly where the choice is greedy.
- :class:`RnnTimeStepper` (↔ MultiLayerNetwork.rnnTimeStep /
  rnnClearPreviousState) — holds each recurrent layer's carry between
  calls.
- :func:`generate` — the char-RNN sampling loop of
  GravesLSTMCharModellingExample: prime, then sample a char, feed it back
  one-hot, repeat.

Both take a ``SequentialModel`` shaped [recurrent layers..., per-step
head...] (``_split_stack``). A single step runs each recurrent layer's
``step`` (plain torch ops, as the JAX package's step is plain ``jnp``).
Several steps at once (a prime, ``time_step`` on [N, T, C]) run each
layer's ``apply_window`` from the held carries: one sweep a layer (one
``lstm_fwd`` or ``gru_fwd`` launch on the card) instead of T cell steps,
the same function as the JAX package's step loop; the head runs on the
last step's output. Where the JAX package compiles the loop into one
``lax.scan``, the port runs it eagerly under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
import torch.nn.functional as F


def categorical(logits, generator: torch.Generator):
    """One draw per row from softmax(``logits``) over the last axis, by
    the Gumbel-max rule ``jax.random.categorical`` uses: argmax of the
    logits plus Gumbel noise from ``generator``. Returns int64 ids."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def sample_token(logits, generator: torch.Generator, temperature):
    """Per-row temperature sampling: logits [N,V], temperature [N] →
    [N] int32. Rows with temperature <= 0 take the argmax (greedy), the
    rest draw from softmax(logits / temperature). Greedy and sampled rows
    share one batch: the choice is a ``torch.where``, not Python control
    flow, so a decode step's work does not depend on its request mix."""
    temperature = torch.as_tensor(temperature, device=logits.device).to(
        logits.dtype)
    greedy = torch.argmax(logits, dim=-1)
    tempered = logits / torch.clamp(temperature, min=1e-6)[:, None]
    drawn = categorical(tempered, generator)
    return torch.where(temperature <= 0.0, greedy, drawn).to(torch.int32)


# Layers that work on the time axis and have no step: in a per-step head
# they would read the [N, C] input's feature axis as time (Bidirectional's
# flip would flip features), so they are refused by name.
_SEQUENCE_HEADS = {"Bidirectional", "LastTimeStep", "MaskZero",
                   "TimeDistributed", "GlobalPooling1D", "RnnLossLayer"}


def _split_stack(model):
    """A SequentialModel → (recurrent prefix, head): [(name, layer)] of
    the leading layers with ``step``, then of the per-step layers after
    them."""
    rec, head = [], []
    for i, layer in enumerate(model.layers):
        if hasattr(layer, "step"):
            if head:
                raise ValueError(
                    f"recurrent layer {type(layer).__name__} at index {i} "
                    "appears after non-recurrent layers — generation "
                    "supports [recurrent..., head...] stacks")
            rec.append((model.layer_names[i], layer))
        else:
            if type(layer).__name__ in _SEQUENCE_HEADS:
                raise ValueError(
                    f"layer {type(layer).__name__} at index {i} operates on "
                    "the time axis and is not step-capable — it cannot be "
                    "part of the per-step generation head")
            head.append((model.layer_names[i], layer))
    if not rec:
        raise ValueError("model has no recurrent (step-capable) layers")
    return rec, head


def _apply_head(head, params, state, h):
    for name, layer in head:
        h, _ = layer.apply(params.get(name, {}), state.get(name, {}), h,
                           train=False)
    return h


def _make_one_step(rec, head):
    """(params, state, carries, x_t [N, C]) → (head output, new carries):
    one timestep through each recurrent layer's ``step``, then the
    head."""

    def one_step(params, state, carries, x_t):
        new_carries = []
        h = x_t
        for (name, layer), c in zip(rec, carries):
            h, c2 = layer.step(params.get(name, {}), c, h)
            new_carries.append(c2)
        return _apply_head(head, params, state, h), new_carries

    return one_step


def _make_window(rec, head):
    """(params, state, carries, x [N, T, C]) → (head output of the last
    step, new carries): each recurrent layer's ``apply_window`` from its
    carry, one sweep a layer, then the head on the last step."""

    def window(params, state, carries, x):
        new_carries = []
        h = x
        for (name, layer), c in zip(rec, carries):
            h, _, c2 = layer.apply_window(params.get(name, {}),
                                          state.get(name, {}), h, c)
            new_carries.append(c2)
        return _apply_head(head, params, state, h[:, -1]), new_carries

    return window


def _init_carries(rec, params, batch, dtype):
    return [layer.init_carry(params.get(name, {}), batch, dtype)
            for name, layer in rec]


class RnnTimeStepper:
    """↔ rnnTimeStep: stateful inference over calls.

    Holds the recurrent carries between calls (the reference's per-layer
    stateMap). ``time_step`` takes [N, C] (one step) or [N, T, C] (T
    steps, one sweep a layer) and returns the head output of the last
    step. ``variables`` may be replaced between calls (after more
    training); the carries stay.
    """

    def __init__(self, model, variables):
        self.model = model
        self.variables = variables
        self._rec, self._head = _split_stack(model)
        self._carries: Optional[List[Any]] = None
        self._one_step = _make_one_step(self._rec, self._head)
        self._window = _make_window(self._rec, self._head)

    def clear_state(self):
        """↔ rnnClearPreviousState."""
        self._carries = None

    @property
    def carries(self) -> Optional[List[Any]]:
        """Each recurrent layer's carry after the last call (None after
        ``clear_state``)."""
        return self._carries

    @torch.inference_mode()
    def time_step(self, x):
        """x: [N, C] or [N, T, C] → the head output of the last step
        [N, Out]."""
        params = self.variables["params"]
        state = self.variables["state"]
        x = torch.as_tensor(x).to(self.model.device)
        if x.ndim == 2:
            x = x[:, None, :]
        if x.shape[1] == 0:
            raise ValueError("time_step got an empty time axis")
        if self._carries is None:
            self._carries = _init_carries(self._rec, params, x.shape[0],
                                          x.dtype)
        if x.shape[1] == 1:
            out, self._carries = self._one_step(params, state,
                                                self._carries, x[:, 0])
        else:
            out, self._carries = self._window(params, state, self._carries,
                                              x)
        return out


def _build_generate_fn(model, n_steps: int, temperature: float):
    """(params, state, generator, prime_ids [N, T0]) → sampled ids [N,
    n_steps]: the prime through ``apply_window`` (teacher forced), then
    ``n_steps`` draws, each fed back one-hot through ``step``."""
    rec, head = _split_stack(model)
    vocab = model.shapes[0][-1]  # the input one-hot width
    out_width = model.shapes[-1][-1]
    if out_width != vocab:
        raise ValueError(
            f"generation feeds sampled head-output ids back as one-hot "
            f"input, so head width ({out_width}) must equal input one-hot "
            f"width ({vocab})")
    dtype = torch.float32
    one_step = _make_one_step(rec, head)
    window = _make_window(rec, head)

    def run(params, state, generator, prime_ids):
        batch = prime_ids.shape[0]
        carries = _init_carries(rec, params, batch, dtype)
        probs, carries = window(params, state, carries,
                                F.one_hot(prime_ids.long(), vocab).to(dtype))
        temp = torch.full((batch,), float(temperature), dtype=dtype,
                          device=prime_ids.device)
        ids = []
        for _ in range(n_steps):
            logits = torch.log(torch.clamp(probs, 1e-9, 1.0))
            tok = sample_token(logits, generator, temp)
            ids.append(tok)
            probs, carries = one_step(params, state, carries,
                                      F.one_hot(tok.long(), vocab).to(dtype))
        return torch.stack(ids, dim=1)

    return run


@torch.inference_mode()
def generate(model, variables, *, n_steps: int, rng,
             prime=None, temperature: float = 1.0, batch_size: int = 1):
    """Autoregressive sampling from a char-RNN-style model (one-hot
    inputs, a softmax head at every step) → sampled ids [batch_size,
    n_steps] int32, on the model's device.

    ``prime``: optional int ids fed through the network first to warm the
    carries (the reference example's initialization string); [T0]
    broadcasts over the batch, [batch_size, T0] must match ``batch_size``;
    without one the stack starts from id 0. ``rng``: a ``torch.Generator``
    on the model's device, or an int seed. ``temperature`` <= 0 takes the
    argmax at every step.
    """
    dev = model.device
    if prime is None:
        prime = torch.zeros((batch_size, 1), dtype=torch.int32, device=dev)
    else:
        prime = torch.as_tensor(prime).to(device=dev, dtype=torch.int32)
        if prime.ndim == 1:
            prime = prime[None, :].expand(batch_size, prime.shape[0])
        elif prime.shape[0] != batch_size:
            raise ValueError(
                f"prime batch dim {prime.shape[0]} != batch_size "
                f"{batch_size}")
    if not isinstance(rng, torch.Generator):
        rng = torch.Generator(dev).manual_seed(int(rng))
    run = _build_generate_fn(model, n_steps, temperature)
    return run(variables["params"], variables["state"], rng, prime)
