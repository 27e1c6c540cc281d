"""Recurrent layers (↔ deeplearning4j_tpu/nn/layers/recurrent.py): ``LSTM``, ``GravesLSTM``, ``GRU``, ``SimpleRnn``, ``Bidirectional``, ``LastTimeStep``, ``ConvLSTM2D``.

Sequence layout [N, T, C] (batch, time, features), as in the JAX package.
LSTM params: "W" input weights [in, 4H], "RW" recurrent weights [H, 4H],
"b" [4H], gate order i, f, g, o; ``GravesLSTM`` adds the peepholes "pI",
"pF", "pO" [H]. GRU params: "W" [in, 3H], "RW" [H, 3H], "b" [3H], gate
order r, z, n. ``backend="pallas"`` and ``backend="xla"`` (the JAX
package's two names, its default the latter) both run the port's fused
sweeps (``kernels/lstm_scan.lstm``, ``kernels/gru_scan.gru``: the CUDA
kernels on the card, their plain versions on the CPU), so a config JSON
written by the JAX package reaches the kernels. ``backend="plain"``, a
name of the port only, runs the eager loops of ``ops/rnn.lstm`` and
``ops/rnn.gru``: the reference path the tests and ``chip_smoke.py``
compare with. All compute the same function. ``unroll`` is kept for the
config's JSON; the port has no scan to unroll.

``SimpleRnn`` (params "W" [in, H], "RW" [H, H], "b" [H]) runs the eager
loop of ``ops/rnn.simple_rnn`` on both devices, as the JAX package runs
its scan: no Pallas kernel lies under it. ``Bidirectional`` wraps any of
them with params ``{"fwd": ..., "bwd": ...}``: the backward direction
runs the inner layer on the time-flipped input (so a ``Bidirectional``
LSTM launches ``lstm_fwd`` twice a forward on the card, and ``lstm_bwd``
twice a backward) and flips its output back when it has a time axis.
``LastTimeStep`` takes [N,T,C] to [N,C], each example's last unpadded
step under a mask. ``graves_bidirectional_lstm`` composes the two.

Stateful inference (rnnTimeStep, ``nn/generation.py``): ``LSTM``,
``GravesLSTM``, ``GRU`` and ``SimpleRnn`` have ``init_carry(params,
batch_size, dtype)`` (zeros: an ``LSTMState`` for the LSTMs, h [N, H]
for the others) and ``step(params, carry, x_t)`` → (y_t [N, H], new
carry), one timestep through the cells of ``ops/rnn.py`` in plain torch
ops, as the JAX package's step is plain ``jnp``. ``apply_window`` runs a
whole window from a carry and returns the final one (truncated BPTT,
and several steps of rnnTimeStep at once).

``ConvLSTM2D`` runs over [N, T, H, W, C] with conv gates (params "W"
[kh, kw, C, 4F], "RW" [kh, kw, F, 4F], "b" [4F], Keras gate order i, f,
c, o): the input-to-gate conv of all T steps is one ``ops/cnn.conv2d``
over the folded [N·T, H, W, C] batch, and the eager time loop carries
only the stride-1 SAME recurrent conv on h, as the JAX layer's
``lax.scan`` does; on the card both are cuDNN's convs, as the JAX package
leaves them to XLA (no Pallas kernel lies under it). It has ``apply`` and
``apply_window`` and, as in the JAX package, no ``init_carry``/``step``.
Under ``Bidirectional`` its [N, T, H, W, F] backward output is not
flipped back to forward time: the wrapper flips 3-D outputs only, in
both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.kernels import gru_scan, lstm_scan
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_config
from deeplearning4j_tpu_torch.nn.initializers import get_initializer
from deeplearning4j_tpu_torch.ops import cnn as opscnn
from deeplearning4j_tpu_torch.ops import nn as opsnn
from deeplearning4j_tpu_torch.ops import rnn as opsrnn

# The backend names that run the fused sweeps: the JAX package's two.
_SWEEPS = ("pallas", "xla")


@register_config
@dataclass
class LSTM(LayerConfig):
    """↔ LSTM layer (no peepholes)."""

    units: int = 0
    activation: str = "tanh"  # kept for config parity; the cell uses tanh/sigmoid
    weight_init: Optional[str] = None
    forget_bias: float = 1.0
    return_sequences: bool = True
    # 'pallas' and 'xla' (the JAX package's default, its compiled scan):
    # the lstm_fwd/lstm_bwd sweeps (the CUDA kernels on the card); 'plain':
    # the eager ops/rnn.lstm loop, the reference the tests and
    # chip_smoke.py compare with.
    backend: str = "pallas"
    unroll: int = 1

    def output_shape(self, input_shape):
        t, _ = input_shape
        return (t, self.units) if self.return_sequences else (self.units,)

    def init(self, generator, input_shape, dtype):
        c, h = input_shape[-1], self.units
        w_init = get_initializer(self.weight_init or "xavier")
        params = {
            "W": w_init((c, 4 * h), generator, dtype),
            "RW": w_init((h, 4 * h), generator, dtype),
            "b": torch.zeros((4 * h,), dtype=dtype),
        }
        return params, {}

    def _peepholes(self, params):
        return None

    # -- stateful single-step inference (↔ MultiLayerNetwork.rnnTimeStep) --

    def init_carry(self, params, batch_size: int, dtype=torch.float32):
        zeros = torch.zeros((batch_size, self.units), dtype=dtype,
                            device=params["RW"].device)
        return opsrnn.LSTMState(zeros, zeros)

    def step(self, params, carry, x_t):
        """One timestep: x_t [N, In] → (y_t [N, H], new ``LSTMState``)."""
        x_proj = torch.matmul(x_t, params["W"])
        peep = self._peepholes(params)
        if peep is not None:
            new = opsrnn.graves_lstm_cell(x_proj, carry, params["RW"],
                                          params["b"], *peep,
                                          forget_bias=self.forget_bias)
        else:
            new = opsrnn.lstm_cell(x_proj, carry, params["RW"], params["b"],
                                   forget_bias=self.forget_bias)
        return new.h, new

    def apply(self, params, state, x, *, train=False, generator=None,
              initial_state=None):
        y, state, _final = self.apply_window(params, state, x,
                                             initial_state, train=train,
                                             generator=generator)
        return y, state

    def apply_window(self, params, state, x, carry, *, train=False,
                     generator=None):
        """Forward from ``carry`` (an ``LSTMState``; None = zeros) →
        (y, new_state, final_carry)."""
        if self.backend in _SWEEPS:
            outputs, final = lstm_scan.lstm(
                x, params["W"], params["RW"], params["b"],
                peepholes=self._peepholes(params),
                forget_bias=self.forget_bias, init_state=carry)
        elif self.backend == "plain":
            outputs, final = opsrnn.lstm(
                x, params["W"], params["RW"], params["b"], init_state=carry,
                peepholes=self._peepholes(params),
                forget_bias=self.forget_bias)
        else:
            raise ValueError(f"unknown LSTM backend {self.backend!r}; "
                             "valid: 'pallas', 'xla', 'plain'")
        y = outputs if self.return_sequences else outputs[:, -1, :]
        return y, state, final


@register_config
@dataclass
class GravesLSTM(LSTM):
    """↔ GravesLSTM — LSTM with Graves-2013 peepholes (i, f from c_{t-1};
    o from c_t)."""

    def init(self, generator, input_shape, dtype):
        params, state = LSTM.init(self, generator, input_shape, dtype)
        for k in ("pI", "pF", "pO"):
            params[k] = torch.zeros((self.units,), dtype=dtype)
        return params, state

    def _peepholes(self, params):
        return (params["pI"], params["pF"], params["pO"])


@register_config
@dataclass
class GRU(LayerConfig):
    """↔ GRU layer (the libnd4j gruCell math: the reset gate applied after
    the recurrent product)."""

    units: int = 0
    weight_init: Optional[str] = None
    return_sequences: bool = True
    # 'pallas' and 'xla': the gru_fwd/gru_bwd sweeps (the CUDA kernels on
    # the card); 'plain': the eager ops/rnn.gru loop, the reference path.
    backend: str = "pallas"
    unroll: int = 1

    def output_shape(self, input_shape):
        t, _ = input_shape
        return (t, self.units) if self.return_sequences else (self.units,)

    def init(self, generator, input_shape, dtype):
        c, h = input_shape[-1], self.units
        w_init = get_initializer(self.weight_init or "xavier")
        params = {
            "W": w_init((c, 3 * h), generator, dtype),
            "RW": w_init((h, 3 * h), generator, dtype),
            "b": torch.zeros((3 * h,), dtype=dtype),
        }
        return params, {}

    def init_carry(self, params, batch_size: int, dtype=torch.float32):
        return torch.zeros((batch_size, self.units), dtype=dtype,
                           device=params["RW"].device)

    def step(self, params, carry, x_t):
        h = opsrnn.gru_cell(torch.matmul(x_t, params["W"]), carry,
                            params["RW"], params["b"])
        return h, h

    def apply(self, params, state, x, *, train=False, generator=None,
              initial_state=None):
        y, state, _final = self.apply_window(params, state, x,
                                             initial_state, train=train,
                                             generator=generator)
        return y, state

    def apply_window(self, params, state, x, carry, *, train=False,
                     generator=None):
        """Forward from hidden state ``carry`` [N, H] (None = zeros) →
        (y, new_state, final h)."""
        if self.backend in _SWEEPS:
            outputs, final = gru_scan.gru(x, params["W"], params["RW"],
                                          params["b"], init_h=carry)
        elif self.backend == "plain":
            outputs, final = opsrnn.gru(x, params["W"], params["RW"],
                                        params["b"], init_h=carry)
        else:
            raise ValueError(f"unknown GRU backend {self.backend!r}; "
                             "valid: 'pallas', 'xla', 'plain'")
        y = outputs if self.return_sequences else outputs[:, -1, :]
        return y, state, final


@register_config
@dataclass
class SimpleRnn(LayerConfig):
    """↔ SimpleRnn (Elman RNN: h_t = act(x_t·W + h_{t-1}·RW + b))."""

    units: int = 0
    activation: str = "tanh"
    weight_init: Optional[str] = None
    return_sequences: bool = True
    unroll: int = 1

    def output_shape(self, input_shape):
        t, _ = input_shape
        return (t, self.units) if self.return_sequences else (self.units,)

    def init(self, generator, input_shape, dtype):
        c, h = input_shape[-1], self.units
        w_init = get_initializer(self.weight_init or "xavier")
        return {"W": w_init((c, h), generator, dtype),
                "RW": w_init((h, h), generator, dtype),
                "b": torch.zeros((h,), dtype=dtype)}, {}

    def init_carry(self, params, batch_size: int, dtype=torch.float32):
        return torch.zeros((batch_size, self.units), dtype=dtype,
                           device=params["RW"].device)

    def step(self, params, carry, x_t):
        pre = torch.matmul(x_t, params["W"]) + torch.matmul(carry,
                                                            params["RW"])
        h = get_activation(self.activation)(pre + params["b"])
        return h, h

    def apply(self, params, state, x, *, train=False, generator=None,
              initial_state=None):
        y, state, _final = self.apply_window(params, state, x,
                                             initial_state, train=train,
                                             generator=generator)
        return y, state

    def apply_window(self, params, state, x, carry, *, train=False,
                     generator=None):
        """Forward from hidden state ``carry`` [N, H] (None = zeros) →
        (y, new_state, final h)."""
        outputs, final = opsrnn.simple_rnn(
            x, params["W"], params["RW"], params["b"], init_h=carry,
            activation=get_activation(self.activation))
        y = outputs if self.return_sequences else outputs[:, -1, :]
        return y, state, final


@register_config
@dataclass
class Bidirectional(LayerConfig):
    """↔ recurrent.Bidirectional (modes CONCAT/ADD/MUL/AVERAGE): the inner
    recurrent layer over the sequence (params "fwd") and over it reversed
    in time (params "bwd")."""

    layer: Any = None  # the inner recurrent LayerConfig
    merge: str = "concat"

    def output_shape(self, input_shape):
        inner = self.layer.output_shape(input_shape)
        if self.merge == "concat":
            return (*inner[:-1], inner[-1] * 2)
        return inner

    def init(self, generator, input_shape, dtype):
        pf, sf = self.layer.init(generator, input_shape, dtype)
        pb, sb = self.layer.init(generator, input_shape, dtype)
        return {"fwd": pf, "bwd": pb}, {"fwd": sf, "bwd": sb}

    def apply(self, params, state, x, *, train=False, generator=None):
        yf, sf = self.layer.apply(params["fwd"], state.get("fwd", {}), x,
                                  train=train, generator=generator)
        yb, sb = self.layer.apply(params["bwd"], state.get("bwd", {}),
                                  torch.flip(x, dims=(1,)), train=train,
                                  generator=generator)
        # back to forward time order; with return_sequences=False there is
        # no time axis to flip
        if yb.ndim == yf.ndim == 3:
            yb = torch.flip(yb, dims=(1,))
        return (opsrnn.merge_directions(yf, yb, self.merge),
                {"fwd": sf, "bwd": sb})


@register_config
@dataclass
class LastTimeStep(LayerConfig):
    """↔ LastTimeStep: [N,T,C] → [N,C], the last step, or under ``mask``
    [N,T] each example's last unpadded step."""

    def output_shape(self, input_shape):
        return (input_shape[-1],)

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        if mask is None:
            return x[:, -1, :], state
        idx = torch.clamp(torch.sum(mask.to(torch.int32), dim=1) - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device),
                 idx.long()], state


def graves_bidirectional_lstm(units: int, *, merge: str = "concat",
                              **lstm_kwargs) -> Bidirectional:
    """↔ GravesBidirectionalLSTM: a Bidirectional over the peephole
    LSTM."""
    return Bidirectional(layer=GravesLSTM(units=units, **lstm_kwargs),
                         merge=merge)


def _gate_activation(name):
    """A gate activation of ConvLSTM2D applied to an NCHW tensor: the
    activations act elementwise, but ``softmax``/``log_softmax`` act over
    the last axis, the channels of the JAX layer's NHWC gates."""
    fn = get_activation(name)
    if fn in (opsnn.softmax, opsnn.log_softmax):
        return lambda v: fn(v.movedim(1, -1)).movedim(-1, 1)
    return fn


@register_config
@dataclass
class ConvLSTM2D(LayerConfig):
    """↔ ConvLSTM2D: a convolutional LSTM over [N, T, H, W, C] (Shi et al.
    2015, Keras semantics)::

        i, f, g, o = split(conv(x_t, W, stride, padding)
                           + conv(h_{t-1}, RW, 1, SAME) + b)
        c_t = rec(f)·c_{t-1} + rec(i)·act(g);  h_t = rec(o)·act(c_t)

    with ``act`` = ``activation`` and ``rec`` = ``recurrent_activation``.
    With ``unit_forget_bias`` the f slice of "b" starts at 1."""

    filters: int = 0
    kernel: Any = 3  # int or (kh, kw)
    stride: Any = 1
    padding: str = "VALID"
    activation: str = "tanh"
    recurrent_activation: str = "sigmoid"
    weight_init: Optional[str] = None
    use_bias: bool = True
    unit_forget_bias: bool = True
    return_sequences: bool = True

    def _pairs(self):
        k = self.kernel if isinstance(self.kernel, (tuple, list)) \
            else (self.kernel, self.kernel)
        s = self.stride if isinstance(self.stride, (tuple, list)) \
            else (self.stride, self.stride)
        return tuple(k), tuple(s)

    def output_shape(self, input_shape):
        from deeplearning4j_tpu_torch.nn.layers.conv import _conv_out

        t, h, w, _ = input_shape
        (kh, kw), (sh, sw) = self._pairs()
        mode = self.padding.upper()
        out = (_conv_out(h, kh, sh, mode), _conv_out(w, kw, sw, mode),
               self.filters)
        return (t, *out) if self.return_sequences else out

    def init(self, generator, input_shape, dtype):
        c, f = input_shape[-1], self.filters
        (kh, kw), _ = self._pairs()
        w_init = get_initializer(self.weight_init or "xavier")
        params = {"W": w_init((kh, kw, c, 4 * f), generator, dtype),
                  "RW": w_init((kh, kw, f, 4 * f), generator, dtype)}
        if self.use_bias:
            b = torch.zeros((4 * f,), dtype=dtype)
            if self.unit_forget_bias:
                b[f:2 * f] = 1.0
            params["b"] = b
        return params, {}

    def _forward(self, params, x, initial_state):
        """→ (h of every step [N, T, OH, OW, F], (h_T, c_T))."""
        act = _gate_activation(self.activation)
        rec_act = _gate_activation(self.recurrent_activation)
        n, t, h, w, c = x.shape
        f = self.filters
        (kh, kw), (sh, sw) = self._pairs()
        # Inside, time-major NCHW: one copy of the input makes every step's
        # gates and the carry contiguous NCHW, the layout cuDNN's float32
        # convs take without a transform (an NHWC carry cost two layout
        # kernels a step), and unbinding the steps keeps each step's
        # gradient its own (indexing one [T, ...] tensor a step would
        # accumulate a zero-filled full-size gradient every step).
        xc = x.permute(1, 0, 4, 2, 3).reshape(t * n, c, h, w)
        # the input conv of all T steps at once
        xg = opscnn.conv2d(xc, params["W"], params.get("b"), stride=(sh, sw),
                           padding=self.padding, data_format="NCHW")
        oh, ow = xg.shape[2], xg.shape[3]
        steps = xg.reshape(t, n, 4 * f, oh, ow).unbind(0)
        if initial_state is not None:
            h_t, c_t = (s.permute(0, 3, 1, 2).contiguous()
                        for s in initial_state)
        else:
            h_t = torch.zeros((n, f, oh, ow), dtype=x.dtype, device=x.device)
            c_t = torch.zeros_like(h_t)
        rw = params["RW"].permute(3, 2, 0, 1).contiguous()  # OIHW, once
        pads = [opscnn._same_pads(oh, kh, 1, 1),
                opscnn._same_pads(ow, kw, 1, 1)]
        ys = []
        for xg_t in steps:
            gates = xg_t + opscnn._conv_nd(h_t, rw, None, (1, 1), pads,
                                           (1, 1))
            i, fg, g, o = torch.split(gates, f, dim=1)
            c_t = rec_act(fg) * c_t + rec_act(i) * act(g)
            h_t = rec_act(o) * act(c_t)
            ys.append(h_t)
        ys = torch.stack(ys, dim=1).permute(0, 1, 3, 4, 2).contiguous()
        return ys, (h_t.permute(0, 2, 3, 1), c_t.permute(0, 2, 3, 1))

    def apply(self, params, state, x, *, train=False, generator=None,
              initial_state=None):
        ys, (h_t, _) = self._forward(params, x, initial_state)
        return (ys if self.return_sequences else h_t), state

    def apply_window(self, params, state, x, carry, *, train=False,
                     generator=None):
        """Forward from ``carry`` ((h, c), each [N, OH, OW, F]; None =
        zeros) → (y, new_state, final (h, c))."""
        ys, final = self._forward(params, x, carry)
        return (ys if self.return_sequences else final[0]), state, final
