"""The recurrent tier (``nn/layer/rnn.py``, ``ops/rnn_ops.py``) against the
JAX package on the CPU: ``LSTM``, ``GRU`` and ``SimpleRNN`` (tanh and
relu), one-way and bidirectional, one and two layers, batch- and
time-major, with and without ``initial_states`` and with and without
``sequence_length`` (padded tails included), from the JAX layer's weights
carried by ``load_jax_state``. Outputs and final states within 1e-5 relative; the
gradients of the input and of every weight (through random cotangents on
the outputs and final states) within 1e-4 of each tensor's largest
magnitude. The cells alone, the functional ops, and the state-dict names
(a ``BiRNN``'s tensors under one name each, as in the JAX ``state_dict``)
are held too."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.ops.rnn_ops as jrnn
import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch import nn
from paddle_tpu_torch.models.gpt import load_jax_state
from paddle_tpu_torch.ops import rnn_ops

RTOL = 1e-5
GRAD = 1e-4
B, T, I, H = 3, 6, 4, 4  # I = H: fewer shapes for JAX to compile
LENGTHS = np.array([6, 2, 4])  # a full row, padded tails of 4 and 2


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL, err_msg=what)


def _grad_close(got, want, what):
    got = got.detach().numpy()
    want = np.asarray(want.numpy())
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= GRAD * scale, what


def _layers(mode, layers, direction, time_major, act="tanh"):
    kw = dict(num_layers=layers, direction=direction, time_major=time_major)
    if mode == "SimpleRNN":
        kw["activation"] = act
    jp.seed(7)
    jl = getattr(jnn, mode)(I, H, **kw)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    pl = getattr(nn, mode)(I, H, device="cpu", **kw)
    assert list(pl.state_dict()) == list(state)
    load_jax_state(pl, state)
    return jl, pl


def _states(mode, n, rs):
    one = lambda: rs.randn(n, B, H).astype(np.float32)  # noqa: E731
    return (one(), one()) if mode == "LSTM" else one()


def _flat(states):
    return list(states) if isinstance(states, tuple) else [states]


def _run_both(jl, pl, mode, n, time_major, with_init, with_len, seed):
    rs = np.random.RandomState(seed)
    shape = (T, B, I) if time_major else (B, T, I)
    x = rs.randn(*shape).astype(np.float32)
    init = _states(mode, n, rs) if with_init else None
    lens = LENGTHS if with_len else None
    out_shape = (T, B, H * n // jl.num_layers) if time_major \
        else (B, T, H * n // jl.num_layers)
    g_out = rs.randn(*out_shape).astype(np.float32)
    g_st = [a for a in _flat(_states(mode, n, rs))]

    xj = jp.to_tensor(x, stop_gradient=False)
    init_j = None if init is None else (
        tuple(jp.to_tensor(a) for a in init) if mode == "LSTM"
        else jp.to_tensor(init))
    out_j, st_j = jl(xj, init_j, None if lens is None
                     else jp.to_tensor(lens))
    loss = (out_j * jp.to_tensor(g_out)).sum()
    for s, g in zip(_flat(st_j), g_st):
        loss = loss + (s * jp.to_tensor(g)).sum()
    loss.backward()

    xt = torch.from_numpy(x).requires_grad_()
    init_t = None if init is None else (
        tuple(torch.from_numpy(a) for a in init) if mode == "LSTM"
        else torch.from_numpy(init))
    out_t, st_t = pl(xt, init_t, None if lens is None
                     else torch.from_numpy(lens))
    loss_t = (out_t * torch.from_numpy(g_out)).sum()
    for s, g in zip(_flat(st_t), g_st):
        loss_t = loss_t + (s * torch.from_numpy(g)).sum()
    loss_t.backward()

    _close(out_t, out_j, "outputs")
    for i, (s, sj) in enumerate(zip(_flat(st_t), _flat(st_j))):
        _close(s, sj, f"final state {i}")
    _grad_close(xt.grad, xj.grad, "input gradient")
    jgrads = dict(jl.named_parameters())
    for name, p in pl.named_parameters():
        _grad_close(p.grad, jgrads[name].grad, name)


CASES = [
    # mode, layers, direction, time_major, activation, (initial states,
    # lengths): each mode runs with and without each of the two
    ("LSTM", 1, "bidirect", False, "tanh", (False, False)),
    ("LSTM", 2, "forward", True, "tanh", (True, True)),
    ("GRU", 2, "forward", True, "tanh", (True, False)),
    ("GRU", 1, "bidirect", False, "tanh", (False, True)),
    ("SimpleRNN", 2, "bidirect", True, "tanh", (True, True)),
    ("SimpleRNN", 1, "forward", False, "relu", (False, False)),
]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["-".join(map(str, c[:5])) for c in CASES])
def test_rnn_layers_match_jax(case):
    mode, layers, direction, time_major, act, (init, lens) = CASES[case]
    jl, pl = _layers(mode, layers, direction, time_major, act)
    n = layers * (2 if direction == "bidirect" else 1)
    _run_both(jl, pl, mode, n, time_major, init, lens, seed=case)


def test_padded_tail_holds_the_frozen_state():
    """Past a sequence's length a forward run repeats the last valid
    state, a reverse run emits its initial state: both as JAX."""
    _, pl = _layers("GRU", 1, "bidirect", False)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(B, T, I).astype(np.float32))
    init = torch.from_numpy(_states("GRU", 2, rs))
    out, _ = pl(x, init, torch.from_numpy(LENGTHS))
    fw, bw = out[..., :H], out[..., H:]
    assert torch.equal(fw[1, 2:], fw[1, 1:2].expand(T - 2, H))
    assert torch.equal(bw[1, 2:], init[1, 1:2].expand(T - 2, H))


@pytest.mark.parametrize("kind", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
def test_cells_match_jax(kind):
    jp.seed(3)
    jc = getattr(jnn, kind)(I, H)
    pc = getattr(nn, kind)(I, H, device="cpu")
    load_jax_state(pc, {k: np.asarray(v.numpy())
                        for k, v in jc.state_dict().items()})
    rs = np.random.RandomState(2)
    x = rs.randn(B, I).astype(np.float32)
    st = _states("LSTM", 1, rs) if kind == "LSTMCell" \
        else _states("GRU", 1, rs)
    st = tuple(a[0] for a in st) if kind == "LSTMCell" else st[0]
    j_in = (tuple(jp.to_tensor(a) for a in st) if kind == "LSTMCell"
            else jp.to_tensor(st))
    t_in = (tuple(torch.from_numpy(a) for a in st) if kind == "LSTMCell"
            else torch.from_numpy(st))
    xj = jp.to_tensor(x, stop_gradient=False)
    xt = torch.from_numpy(x).requires_grad_()
    (oj, sj), (ot, s_t) = jc(xj, j_in), pc(xt, t_in)
    _close(ot, oj, "output")
    for a, b in zip(_flat(s_t), _flat(sj)):
        _close(a, b, "state")
    sum(s.sum() for s in _flat(sj)).backward()
    sum(s.sum() for s in _flat(s_t)).backward()
    _grad_close(xt.grad, xj.grad, "input gradient")
    jgrads = dict(jc.named_parameters())
    for name, p in pc.named_parameters():
        _grad_close(p.grad, jgrads[name].grad, name)
    # no states: zeros in the input's dtype
    _close(pc(xt)[0], jc(xj)[0], "zero states")


def test_rnn_ops_match_jax():
    """Each op with and without its initial states, batch- or
    time-major in turn."""
    rs = np.random.RandomState(4)
    h0, c0 = (rs.randn(B, H).astype(np.float32) for _ in range(2))

    def w(*s):
        return (rs.randn(*s) * 0.3).astype(np.float32)

    def x(time_major):
        shape = (T, B, I) if time_major else (B, T, I)
        return rs.randn(*shape).astype(np.float32)

    cases = [
        ("lstm", False, [x(False), w(I, 4 * H), w(H, 4 * H), w(4 * H)],
         [h0, c0]),
        ("gru", True, [x(True), w(I, 3 * H), w(H, 3 * H), w(3 * H)], [h0]),
        ("rnn", False, [x(False), w(I, H), w(H, H), w(H)], [h0]),
    ]
    for name, time_major, args, init in cases:
        for states in ([], init):
            got = getattr(rnn_ops, name)(
                *[torch.from_numpy(a) for a in args],
                *[torch.from_numpy(a) for a in states], time_major=time_major)
            want = getattr(jrnn, name)(
                *[jp.to_tensor(a) for a in args],
                *[jp.to_tensor(a) for a in states], time_major=time_major)
            for g, wv in zip(got, want):
                _close(g, wv, name)
    xg, hp = rs.randn(B, 3 * H).astype(np.float32), h0
    args = [xg, hp, w(H, 3 * H), w(3 * H)]
    for act in ("tanh", "relu"):
        got = rnn_ops.gru_unit(*[torch.from_numpy(a) for a in args],
                               activation=act)
        want = jrnn.gru_unit(*[jp.to_tensor(a) for a in args], activation=act)
        for g, wv in zip(got, want):
            _close(g, wv, "gru_unit")


def test_lstm_dropout_draws_from_the_held_generator():
    """Between layers the dropout draws from the generator the layer holds
    from its construction; eval draws nothing."""
    gen = torch.Generator().manual_seed(0)
    pl = nn.LSTM(I, H, num_layers=2, dropout=0.5, device="cpu",
                 dropout_generator=gen)
    assert pl.generator is gen
    x = torch.randn(B, T, I)
    before = gen.get_state()
    pl(x)
    assert not torch.equal(gen.get_state(), before)
    pl.eval()
    before = gen.get_state()
    pl(x)
    assert torch.equal(gen.get_state(), before)
    assert nn.GRU(I, H, dropout=0.5, device="cpu").generator is None
