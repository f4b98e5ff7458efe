"""Recurrent layers (port of ``paddle_tpu/nn/layer/rnn.py``): the cells
``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``, the sequence runners
``RNN`` and ``BiRNN``, and the multi-layer ``SimpleRNN``, ``LSTM`` and
``GRU``.

The JAX package runs a layer and direction as one ``lax.scan``; the port
runs one time loop of torch ops, which a captured ``TrainStep`` records
into its CUDA graph (no host read inside). The input product ``x·W_ihᵀ``
(with the biases that add to it) is taken over every time step at once,
before the loop: the same arithmetic, rounded in another order. Inside
the loop each step is one ``addmm`` of the state against ``W_hh`` and the
gates' element-wise work:

- LSTM, gates i, f, c, o: ``c' = σ(f)·c + σ(i)·tanh(g)``, ``h' =
  σ(o)·tanh(c')``;
- GRU, gates r, z, c: ``r = σ(x_r + h_r)``, ``z = σ(x_z + h_z)``, the
  candidate ``tanh(x_c + r·(W_hc·h + b_hc))``, ``h' = (1 − z)·c + z·h``;
- SimpleRNN: ``tanh`` or ``relu`` of the sum.

With ``sequence_length`` the state freezes past each sequence's length, as
the JAX mask does (``m·new + (1 − m)·old``): the output there is the frozen
state, not zero, and a reverse run over a padded tail emits the initial
state there (cuDNN's packed sequences give zeros, so they are not this
function). The weights are ``[gates·H, in]`` in both packages, under the
JAX names: ``_runners.{i}.cell.weight_ih`` for one direction,
``_runners.{i}.cell_fw.*``/``cell_bw.*`` for two (a ``BiRNN`` holds its two
runners unregistered, so each tensor has one name, as in the JAX
``state_dict``). Dropout between layers draws from a generator the layer
holds from its construction (``layers.held_generator``), where JAX draws
from its global key. Initial states default to zeros in the input's
dtype."""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...device import DEFAULT_DEVICE
from .. import functional as F
from ..initializer import Uniform
from .container import LayerList
from .layers import Layer, building, held_generator

__all__ = ["BiRNN", "GRU", "GRUCell", "LSTM", "LSTMCell", "RNN",
           "RNNCellBase", "SimpleRNN", "SimpleRNNCell"]


def _std_init(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return Uniform(-k, k)


def _bias_sum(*biases):
    """The biases that are not None, summed (None when there is none)."""
    out = None
    for b in biases:
        if b is not None:
            out = b if out is None else out + b
    return out


class RNNCellBase(Layer):
    """A cell: ``forward(inputs, states)`` → ``(output, new_states)`` for
    one time step; :meth:`get_initial_states` gives its zero states."""

    def _make(self, gates, input_size, hidden_size, weight_ih_attr,
              weight_hh_attr, bias_ih_attr, bias_hh_attr):
        init = _std_init(hidden_size)
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], attr=weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], attr=weight_hh_attr,
            default_initializer=init)
        self.bias_ih = self.create_parameter(
            [gates * hidden_size], attr=bias_ih_attr, is_bias=True,
            default_initializer=init)
        self.bias_hh = self.create_parameter(
            [gates * hidden_size], attr=bias_hh_attr, is_bias=True,
            default_initializer=init)
        self.input_size, self.hidden_size = input_size, hidden_size

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States filled with ``init_value``, batched as ``batch_ref``'s
        axis ``batch_dim_idx``, on its device, in ``dtype`` (default: its
        dtype)."""
        from ...base.dtype import convert_dtype

        batch = batch_ref.shape[batch_dim_idx]
        dt = convert_dtype(dtype) if dtype is not None else batch_ref.dtype
        shapes = self.state_shape if shape is None else shape

        def full(s):
            return torch.full((batch,) + tuple(s), init_value, dtype=dt,
                              device=batch_ref.device)

        if isinstance(shapes, tuple):
            return tuple(full(s) for s in shapes)
        return full(shapes)

    def _weights(self):
        return self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh


class SimpleRNNCell(RNNCellBase):
    """``h' = act(W_ih·x + b_ih + W_hh·h + b_hh)``, ``act`` tanh or relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError("SimpleRNNCell activation must be tanh or relu")
        self.activation = activation
        with building(self, device, generator):
            self._make(1, input_size, hidden_size, weight_ih_attr,
                       weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return [self.hidden_size]

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        w_ih, w_hh, b_ih, b_hh = self._weights()
        h = _simple_step(self.activation, _input_product(
            inputs, w_ih, _bias_sum(b_ih, b_hh)), states, w_hh)
        return h, h


class LSTMCell(RNNCellBase):
    """The LSTM step, gates i, f, c, o. ``proj_size`` raises, as in
    JAX."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=0, name=None, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if proj_size:
            raise NotImplementedError(
                "LSTMCell proj_size is not supported yet; use a Linear "
                "projection on the output instead")
        with building(self, device, generator):
            self._make(4, input_size, hidden_size, weight_ih_attr,
                       weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return ([self.hidden_size], [self.hidden_size])

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        w_ih, w_hh, b_ih, b_hh = self._weights()
        h, c = _lstm_step(_input_product(inputs, w_ih, _bias_sum(b_ih, b_hh)),
                          states, w_hh)
        return h, (h, c)


class GRUCell(RNNCellBase):
    """The GRU step, gates r, z, c; the candidate takes ``r·(W_hc·h +
    b_hc)``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with building(self, device, generator):
            self._make(3, input_size, hidden_size, weight_ih_attr,
                       weight_hh_attr, bias_ih_attr, bias_hh_attr)

    @property
    def state_shape(self):
        return [self.hidden_size]

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        w_ih, w_hh, b_ih, b_hh = self._weights()
        h = _gru_step(_input_product(inputs, w_ih, b_ih), states, w_hh, b_hh)
        return h, h


# ------------------------------------------------------------ the steps

def _input_product(x, w_ih, bias):
    """``x·W_ihᵀ + bias`` over every leading axis at once."""
    out = torch.matmul(x, w_ih.t())
    return out if bias is None else out + bias


def _hidden_product(h, w_hh, bias=None):
    return (torch.mm(h, w_hh.t()) if bias is None
            else torch.addmm(bias, h, w_hh.t()))


def _simple_step(act, xw, h, w_hh):
    z = xw + _hidden_product(h, w_hh)
    return torch.tanh(z) if act == "tanh" else torch.relu(z)


def _lstm_step(xw, state, w_hh):
    h, c = state
    z = xw + _hidden_product(h, w_hh)
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _gru_step(xw, h, w_hh, b_hh):
    zh = _hidden_product(h, w_hh, b_hh)
    xr, xz, xc = xw.chunk(3, dim=-1)
    hr, hz, hc = zh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    c = torch.tanh(xc + r * hc)
    return (1.0 - z) * c + z * h


def _run(cell, x, state, *, reverse: bool, mask):
    """One layer and direction over time-major ``x`` ``[T, B, I]``: the
    outputs ``[T, B, H]`` and the final state. ``mask`` ``[T, B, 1]`` (1
    where valid) or None freezes the state past each length."""
    w_ih, w_hh, b_ih, b_hh = cell._weights()
    if isinstance(cell, GRUCell):
        xw = _input_product(x, w_ih, b_ih)

        def step(xt, st):
            return _gru_step(xt, st, w_hh, b_hh)
    elif isinstance(cell, LSTMCell):
        xw = _input_product(x, w_ih, _bias_sum(b_ih, b_hh))

        def step(xt, st):
            return _lstm_step(xt, st, w_hh)
    else:
        xw = _input_product(x, w_ih, _bias_sum(b_ih, b_hh))
        act = cell.activation

        def step(xt, st):
            return _simple_step(act, xt, st, w_hh)
    outs = [None] * x.shape[0]
    order = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    for t in order:
        new = step(xw[t], state)
        if mask is not None:
            m = mask[t]
            if isinstance(new, tuple):
                new = tuple(m * n + (1 - m) * o for n, o in zip(new, state))
            else:
                new = m * new + (1 - m) * state
        state = new
        outs[t] = new[0] if isinstance(new, tuple) else new
    return torch.stack(outs), state


class RNN(Layer):
    """A cell run over a whole sequence (``[B, T, I]``, or ``[T, B, I]``
    with ``time_major``), forward or, with ``is_reverse``, backward in
    time: ``(outputs, final_states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        cell = self.cell
        if initial_states is None:
            initial_states = cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        if isinstance(cell, LSTMCell):
            initial_states = tuple(initial_states)
        x = inputs if self.time_major else inputs.transpose(0, 1)
        mask = None
        if sequence_length is not None:
            lengths = torch.as_tensor(sequence_length, device=x.device)
            steps = torch.arange(x.shape[0], device=x.device)
            mask = (steps[:, None] < lengths[None, :]).to(x.dtype)[..., None]
        outs, final = _run(cell, x, initial_states, reverse=self.is_reverse,
                           mask=mask)
        return (outs if self.time_major else outs.transpose(0, 1)), final


class BiRNN(Layer):
    """Two cells, one run forward and one backward in time; the outputs
    concatenated on the last axis, the final states ``(fw, bw)``. The two
    runners (``rnn_fw``, ``rnn_bw``) are held unregistered: the cells are
    the parameters' one name, as in the JAX ``state_dict``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw, self.cell_bw = cell_fw, cell_bw
        object.__setattr__(self, "rnn_fw", RNN(cell_fw, False, time_major))
        object.__setattr__(self, "rnn_bw", RNN(cell_bw, True, time_major))
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = ((None, None) if initial_states is None
                        else initial_states)
        out_fw, fst_fw = self.rnn_fw(inputs, st_fw, sequence_length)
        out_bw, fst_bw = self.rnn_bw(inputs, st_bw, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (fst_fw, fst_bw)


class _RNNBase(Layer):
    """The multi-layer, optionally bidirectional runner of ``SimpleRNN``,
    ``LSTM`` and ``GRU``: one ``RNN`` or ``BiRNN`` a layer in
    ``_runners``, dropout ``p`` between layers while training. States are
    ``[num_layers · num_directions, B, H]`` (an ``(h, c)`` pair for the
    LSTM)."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if direction == "forward":
            self.num_directions = 1
        elif direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        else:
            raise ValueError(f"unknown direction {direction!r}")
        self.mode, self.input_size, self.hidden_size = (mode, input_size,
                                                        hidden_size)
        self.num_layers, self.time_major, self.dropout = (num_layers,
                                                          time_major, dropout)
        self.direction = direction
        self.state_components = 2 if mode == "LSTM" else 1
        self.generator = held_generator(dropout_generator,
                                        dropout > 0.0 and num_layers > 1)
        kw = dict(weight_ih_attr=weight_ih_attr, weight_hh_attr=weight_hh_attr,
                  bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr)

        def make_cell(in_sz):
            if mode == "LSTM":
                return LSTMCell(in_sz, hidden_size, **kw)
            if mode == "GRU":
                return GRUCell(in_sz, hidden_size, **kw)
            return SimpleRNNCell(in_sz, hidden_size, activation=activation,
                                 **kw)

        with building(self, device, generator):
            runners = []
            for i in range(num_layers):
                in_sz = (input_size if i == 0
                         else hidden_size * self.num_directions)
                if self.num_directions == 2:
                    runners.append(BiRNN(make_cell(in_sz), make_cell(in_sz),
                                         time_major=time_major))
                else:
                    runners.append(RNN(make_cell(in_sz),
                                       time_major=time_major))
            self._runners = LayerList(runners)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        finals = []
        for i, runner in enumerate(self._runners):
            st = (None if initial_states is None
                  else self._layer_states(initial_states, i))
            x, final = runner(x, st, sequence_length)
            finals.append(final)
            if self.dropout > 0.0 and i < self.num_layers - 1 \
                    and self.training:
                x = F.dropout(x, self.dropout, training=True,
                              generator=self.generator)
        return x, self._pack_states(finals)

    def _layer_states(self, initial_states, i):
        """Layer ``i``'s slice of ``[num_layers · num_directions, B, H]``
        states."""
        if self.mode == "LSTM":
            h, c = initial_states
            if self.num_directions == 2:
                return ((h[2 * i], c[2 * i]), (h[2 * i + 1], c[2 * i + 1]))
            return (h[i], c[i])
        h = initial_states
        if self.num_directions == 2:
            return (h[2 * i], h[2 * i + 1])
        return h[i]

    def _pack_states(self, finals):
        two = self.num_directions == 2
        if self.mode == "LSTM":
            hs, cs = [], []
            for f in finals:
                for h, c in (f if two else (f,)):
                    hs.append(h)
                    cs.append(c)
            return torch.stack(hs), torch.stack(cs)
        hs = []
        for f in finals:
            hs += list(f) if two else [f]
        return torch.stack(hs)

    def extra_repr(self) -> str:
        return (f"{self.input_size}, {self.hidden_size}, "
                f"num_layers={self.num_layers}, "
                f"direction={self.direction!r}, dropout={self.dropout}")


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__("RNN", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation, **kw)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0, **kw):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kw)
