"""Functional RNN ops on weight lists (port of
``paddle_tpu/ops/rnn_ops.py``): ``lstm``, ``gru``, ``gru_unit`` and
``rnn``, in the reference's op layouts (``wx`` ``[I, gates·H]``, ``wh``
``[H, gates·H]``). The layer classes of ``nn/layer/rnn.py`` are the
stateful API. As there, one time loop of torch ops runs each op, the input
product ``x·wx`` taken over every step at once before it. The JAX package
reaches these through its op registry only, so they are not exported at
the top level."""
from __future__ import annotations

import torch

__all__ = ["gru", "gru_unit", "lstm", "rnn"]


def _time_major(x, time_major):
    return x if time_major else x.transpose(0, 1)


def _zeros(x, wh, time_major):
    b = x.shape[1] if time_major else x.shape[0]
    return torch.zeros(b, wh.shape[0], dtype=x.dtype, device=x.device)


def _scan(step, xw, init, time_major):
    """``step(x_t, carry) -> (carry, y_t)`` over time-major ``xw``:
    ``(final carry, ys)`` with ``ys`` in the input's layout."""
    carry, ys = init, []
    for t in range(xw.shape[0]):
        carry, y = step(xw[t], carry)
        ys.append(y)
    out = torch.stack(ys)
    return carry, (out if time_major else out.transpose(0, 1))


def lstm(x, wx, wh, b, init_h=None, init_c=None, time_major=False,
         name=None):
    """One LSTM layer, gates i, f, c, o: ``(out, last_h, last_c)``."""
    xs = _time_major(x, time_major)
    h0 = init_h if init_h is not None else _zeros(x, wh, time_major)
    c0 = init_c if init_c is not None else _zeros(x, wh, time_major)
    xw = torch.matmul(xs, wx)

    def step(xt, carry):
        h, c = carry
        gates = xt + h @ wh + b
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h

    (h, c), ys = _scan(step, xw, (h0, c0), time_major)
    return ys, h, c


def gru(x, wx, wh, b, init_h=None, time_major=False, name=None):
    """One GRU layer, gates r, z, n, the bias on the input side:
    ``(out, last_h)``."""
    xs = _time_major(x, time_major)
    h0 = init_h if init_h is not None else _zeros(x, wh, time_major)
    xw = torch.matmul(xs, wx) + b

    def step(xg, h):
        xr, xz, xn = xg.chunk(3, dim=-1)
        hr, hz, hn = (h @ wh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        return h, h

    return _scan(step, xw, h0, time_major)[::-1]


_ACTS = {"tanh": torch.tanh, "relu": torch.relu, "sigmoid": torch.sigmoid,
         "identity": lambda a: a}


def gru_unit(input, hidden_prev, weight, bias=None, activation="tanh",
             gate_activation="sigmoid", name=None):
    """One GRU step in the reference's ``gru_unit`` layout: ``input``
    ``[B, 3H]`` is the input's projection, ``weight`` ``[H, 3H]`` packs the
    update and reset gates' ``[H, 2H]``, then the candidate's. Returns
    ``(h, gate, candidate)``, ``h = z·h_prev + (1 − z)·c``."""
    g_act, c_act = _ACTS[gate_activation], _ACTS[activation]
    h = hidden_prev.shape[-1]
    xg = input + bias if bias is not None else input
    rz = g_act(xg[:, :2 * h] + hidden_prev @ weight[:, :2 * h])
    r, z = rz[:, :h], rz[:, h:]
    c = c_act(xg[:, 2 * h:] + (r * hidden_prev) @ weight[:, 2 * h:])
    return z * hidden_prev + (1 - z) * c, rz, c


def rnn(x, wx, wh, b, init_h=None, activation="tanh", time_major=False,
        name=None):
    """One vanilla RNN layer, ``tanh`` or ``relu``: ``(out, last_h)``."""
    act = torch.tanh if activation == "tanh" else torch.relu
    xs = _time_major(x, time_major)
    h0 = init_h if init_h is not None else _zeros(x, wh, time_major)
    xw = torch.matmul(xs, wx)

    def step(xt, h):
        h = act(xt + h @ wh + b)
        return h, h

    return _scan(step, xw, h0, time_major)[::-1]
