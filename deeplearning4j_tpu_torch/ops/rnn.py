"""RNN ops (↔ deeplearning4j_tpu/ops/rnn.py) — the LSTM and GRU of the char-RNN slices.

The plain PyTorch recurrence, gate math in the JAX package's order:

- :func:`lstm_cell` — a standard LSTM step, gate order i, f, g, o;
- :func:`graves_lstm_cell` — Graves (2013) peepholes: i and f read
  c_{t-1}, o reads c_t; the forget bias is added inside the sigmoid after
  the peephole term;
- :func:`lstm` — a full sequence: the input projection of every step is
  one product (``x·W``) hoisted out of a Python loop over time, where the
  JAX package runs ``lax.scan``. Autograd differentiates the loop.

- :func:`gru_cell` — one GRU step, gate order r, z, n; the candidate
  reads r ⊙ (h·RW_n), the reset applied after the recurrent product
  (cuDNN's and nd4j gruCell's variant);
- :func:`gru` — a full sequence, from an optional initial state, forwards
  or reversed in time.

- :func:`simple_rnn` — the Elman recurrence h_t = act(x_t·W + h·RW + b);
- :func:`reverse_sequence` — each sequence reversed up to its length;
- :func:`bidirectional_lstm` — an LSTM over the sequence and another over
  it reversed in time, their outputs merged (concat, add, mul,
  average). It runs the fused sweeps of ``kernels/lstm_scan.py`` in both
  directions (the reversed one on the time-flipped input), so on the
  card each direction is one ``lstm_fwd`` launch.

This is the recurrent layers' ``backend="plain"`` path. The fused sweeps
of ``kernels/lstm_scan.py`` and ``kernels/gru_scan.py`` (the ``"pallas"``
and ``"xla"`` path) compute the same functions; their own plain versions
live beside them there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LSTMState(NamedTuple):
    h: torch.Tensor  # hidden state [N, H]
    c: torch.Tensor  # cell state   [N, H]


def _gates(x_proj, h, w_h, b):
    """Input projection + recurrent projection + bias → [N, 4H]."""
    g = x_proj + torch.matmul(h, w_h)
    if b is not None:
        g = g + b
    return g


def lstm_cell(x_proj, state: LSTMState, w_h, b=None, *, forget_bias=0.0):
    """One LSTM step. x_proj: [N,4H] (precomputed x@w_x), gate order i,f,g,o."""
    z = _gates(x_proj, state.h, w_h, b)
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    g = torch.tanh(g)
    c = f * state.c + i * g
    o = torch.sigmoid(o)
    return LSTMState(o * torch.tanh(c), c)


def graves_lstm_cell(x_proj, state: LSTMState, w_h, b, peep_i, peep_f,
                     peep_o, *, forget_bias=0.0):
    """Graves-2013 peephole LSTM step; peep_*: [H] diagonal weights."""
    z = _gates(x_proj, state.h, w_h, b)
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    i = torch.sigmoid(i + peep_i * state.c)
    f = torch.sigmoid(f + peep_f * state.c + forget_bias)
    g = torch.tanh(g)
    c = f * state.c + i * g
    o = torch.sigmoid(o + peep_o * c)
    return LSTMState(o * torch.tanh(c), c)


def lstm(x, w_x, w_h, b=None, init_state: Optional[LSTMState] = None, *,
         peepholes=None, forget_bias: float = 0.0):
    """Full-sequence LSTM: x [N,T,In] → (outputs [N,T,H], final LSTMState).

    One hoisted input product, then a loop over time. ``peepholes`` is an
    optional (peep_i, peep_f, peep_o) triple enabling GravesLSTM math;
    ``init_state`` defaults to zeros."""
    n, t_len, _ = x.shape
    h_dim = w_h.shape[0]
    if init_state is None:
        zeros = torch.zeros((n, h_dim), dtype=x.dtype, device=x.device)
        init_state = LSTMState(zeros, zeros)
    x_proj = torch.matmul(x, w_x)  # [N,T,4H]
    state, hs = init_state, []
    for t in range(t_len):
        if peepholes is not None:
            state = graves_lstm_cell(x_proj[:, t], state, w_h, b, *peepholes,
                                     forget_bias=forget_bias)
        else:
            state = lstm_cell(x_proj[:, t], state, w_h, b,
                              forget_bias=forget_bias)
        hs.append(state.h)
    return torch.stack(hs, dim=1), state


def gru_cell(x_proj, h, w_h, b=None):
    """One GRU step. x_proj: [N,3H] (precomputed x@w_x), gate order r,z,n;
    the candidate uses r ⊙ (h @ w_hn)."""
    h_dim = h.shape[-1]
    w_rz, w_n = w_h[:, :2 * h_dim], w_h[:, 2 * h_dim:]
    rz = x_proj[:, :2 * h_dim] + torch.matmul(h, w_rz)
    if b is not None:
        rz = rz + b[:2 * h_dim]
    r, z = torch.chunk(torch.sigmoid(rz), 2, dim=-1)
    nx = x_proj[:, 2 * h_dim:] + r * torch.matmul(h, w_n)
    if b is not None:
        nx = nx + b[2 * h_dim:]
    n = torch.tanh(nx)
    return (1.0 - z) * n + z * h


def gru(x, w_x, w_h, b=None, init_h=None, *, reverse: bool = False):
    """Full-sequence GRU: x [N,T,In] → (outputs [N,T,H], final h [N,H]).

    One hoisted input product, then a loop over time (from the last step
    back with ``reverse``, outputs kept at their own time index, as
    ``lax.scan(reverse=True)``); ``init_h`` defaults to zeros."""
    n, t_len, _ = x.shape
    h_dim = w_h.shape[0]
    h = (torch.zeros((n, h_dim), dtype=x.dtype, device=x.device)
         if init_h is None else init_h)
    x_proj = torch.matmul(x, w_x)  # [N,T,3H]
    hs = [None] * t_len
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        h = gru_cell(x_proj[:, t], h, w_h, b)
        hs[t] = h
    return torch.stack(hs, dim=1), h


def simple_rnn(x, w_x, w_h, b=None, init_h=None, *, activation=torch.tanh,
               reverse: bool = False, unroll: int = 1):
    """Elman RNN: x [N,T,In] → (outputs [N,T,H], final h [N,H]), from
    ``init_h`` (zeros when None), reversed in time with ``reverse``
    (outputs kept at their own time index). ``unroll`` is the JAX
    package's scan argument; a Python loop has nothing to unroll."""
    n, t_len, _ = x.shape
    h = (torch.zeros((n, w_h.shape[0]), dtype=x.dtype, device=x.device)
         if init_h is None else init_h)
    x_proj = torch.matmul(x, w_x)  # [N,T,H]
    hs = [None] * t_len
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        pre = x_proj[:, t] + torch.matmul(h, w_h)
        if b is not None:
            pre = pre + b
        h = activation(pre)
        hs[t] = h
    return torch.stack(hs, dim=1), h


def reverse_sequence(x, lengths, time_axis=1, batch_axis=0):
    """↔ nd4j ReverseSequence: each sequence's first ``lengths[n]`` steps
    reversed, the steps beyond its length left in place. ``batch_axis``
    must be 0, as in the JAX package, which gathers along ``time_axis``
    with the lengths on the leading axis."""
    if batch_axis != 0:
        raise ValueError("reverse_sequence takes the batch on axis 0")
    t = x.shape[time_axis]
    idx = torch.arange(t, device=x.device)
    rev = lengths.to(idx.dtype)[:, None] - 1 - idx[None, :]
    rev = torch.where(rev >= 0, rev, idx[None, :])
    rev = rev.reshape(rev.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, time_axis, rev.expand(x.shape))


def merge_directions(out_f, out_b, merge: str):
    """The Bidirectional wrapper's merge of the two directions' outputs."""
    if merge == "concat":
        return torch.cat([out_f, out_b], dim=-1)
    if merge == "add":
        return out_f + out_b
    if merge == "mul":
        return out_f * out_b
    if merge == "average":
        return 0.5 * (out_f + out_b)
    raise ValueError(f"unknown merge mode {merge}")


def bidirectional_lstm(x, params_fwd, params_bwd, *, merge="concat",
                       init_state: Optional[LSTMState] = None,
                       peepholes=None, forget_bias: float = 0.0,
                       unroll: int = 1):
    """↔ the Bidirectional wrapper over an LSTM: ``params_*`` are (w_x,
    w_h, b) triples; the backward direction runs on the time-flipped input
    and its outputs are flipped back. Both directions run the fused sweeps
    (``kernels/lstm_scan.lstm``: ``lstm_fwd``/``lstm_bwd`` on the card).
    Returns (merged outputs, (final state forward, final state
    backward)); ``unroll`` is the JAX package's scan argument."""
    from deeplearning4j_tpu_torch.kernels import lstm_scan

    def run(inp, w_x, w_h, b=None):
        if b is None:
            b = torch.zeros((w_h.shape[1],), dtype=w_h.dtype,
                            device=w_h.device)
        return lstm_scan.lstm(inp, w_x, w_h, b, peepholes=peepholes,
                              forget_bias=forget_bias,
                              init_state=init_state)

    out_f, st_f = run(x, *params_fwd)
    out_b, st_b = run(torch.flip(x, dims=(1,)), *params_bwd)
    out_b = torch.flip(out_b, dims=(1,))
    return merge_directions(out_f, out_b, merge), (st_f, st_b)
