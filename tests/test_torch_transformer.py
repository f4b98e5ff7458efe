"""The transformer stack of the port (``nn.MultiHeadAttention``,
``nn.TransformerEncoder*``/``Decoder*``, ``nn.Transformer``) against the
JAX package's, and the user-written Transformer-base of ``chip_smoke.py``
phase 22 (``transformer_base``: one text, built by each package) at a
small size.

Each pair is built in both packages and the JAX weights carried into the
port (``models.gpt.load_jax_state``, ``Linear`` weights transposed), the
inputs drawn from a seed with numpy. Dropout is 0 for parity (the
packages' random streams differ; the JAX package on the CPU routes an
unmasked attention to its XLA composition where the port runs K1's plain
version). Tolerances: f32 outputs within 1e-5 (absolute, values of order
1), gradients within 1e-4 of each tensor's largest magnitude (at least
1e-8 absolute), the bf16 O2
training losses within one bf16 step (2^-7 of the value's power of two)
of JAX's.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as jnn
import paddle_tpu_torch as T
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch import nn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import load_jax_state

ROOT = Path(__file__).resolve().parent.parent
F32 = 1e-5
GRAD = 1e-4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """``set_device("cpu")`` for each test; the default comes back after."""
    monkeypatch.setattr(device_mod, "_chosen", None)
    T.set_device("cpu")
    yield


@pytest.fixture
def nan_inf_check_off():
    """The JAX package's ``check_nan_inf`` flag off for the test, as its
    default is: another test file may leave it on in the same worker
    (ROADMAP.md), and the recipe's causal mask is -inf in both packages."""
    old = P.get_flags("check_nan_inf")
    P.set_flags({"check_nan_inf": False})
    yield
    P.set_flags(old)


def _state(jlayer):
    return {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}


def _twin(jlayer, layer):
    """``layer`` (the port's) filled with ``jlayer``'s weights."""
    return load_jax_state(layer, _state(jlayer))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.numpy(), np.float32)


def _close(got, want, tol=F32):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = float(np.abs(g - w).max()) if g.size else 0.0
    assert err <= tol, err


def _x(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


# -------------------------------------------------------- MultiHeadAttention
MHA_CASES = ["no_mask", "bool_mask", "float_mask", "need_weights",
             "kv_longer"]


@pytest.mark.parametrize("case", MHA_CASES)
def test_multi_head_attention_matches_jax(case):
    rs = np.random.RandomState(0)
    P.seed(0)
    need = case == "need_weights"
    jm = jnn.MultiHeadAttention(16, 2, need_weights=need)
    m = _twin(jm, nn.MultiHeadAttention(16, 2, need_weights=need))
    q = _x(rs, 2, 5, 16)
    kv = _x(rs, 2, 7 if case == "kv_longer" else 5, 16)
    mask = None
    if case == "bool_mask":
        mask = rs.rand(2, 1, 5, 5) > 0.3
        mask[..., 0] = True
    elif case == "float_mask":
        mask = np.where(rs.rand(2, 2, 5, 5) > 0.3, 0.0, -1e4).astype(
            np.float32)
    jargs = [P.to_tensor(q), P.to_tensor(kv), P.to_tensor(kv),
             None if mask is None else P.to_tensor(mask)]
    args = [torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
            None if mask is None else torch.from_numpy(mask)]
    want, got = jm(*jargs), m(*args)
    if need:
        _close(got[1], want[1])
        want, got = want[0], got[0]
    _close(got, want)


def test_multi_head_attention_caches_match_jax():
    """``Cache`` (self-attention, extended a step at a time, returned and
    not mutated) and ``StaticCache`` (cross-attention memory) as JAX's."""
    rs = np.random.RandomState(1)
    P.seed(1)
    jm = jnn.MultiHeadAttention(16, 4)
    m = _twin(jm, nn.MultiHeadAttention(16, 4))
    mem = _x(rs, 2, 6, 16)
    jc = jm.gen_cache(P.to_tensor(mem), type=jnn.MultiHeadAttention.Cache)
    c = m.gen_cache(torch.from_numpy(mem), type=nn.MultiHeadAttention.Cache)
    assert tuple(c.k.shape) == (2, 0, 4, 4) and type(c) is \
        nn.MultiHeadAttention.Cache
    for step in range(3):
        x = _x(rs, 2, 1, 16)
        jout, jc = jm(P.to_tensor(x), cache=jc)
        first = c
        out, c = m(torch.from_numpy(x), cache=c)
        assert first.k.shape[1] == step  # the old cache is left as it was
        _close(out, jout)
        _close(c.k, jc.k)
        _close(c.v, jc.v)
    js = jm.gen_cache(P.to_tensor(mem), P.to_tensor(mem),
                      type=jnn.MultiHeadAttention.StaticCache)
    s = m.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem),
                    type=nn.MultiHeadAttention.StaticCache)
    x = _x(rs, 2, 3, 16)
    jout, js2 = jm(P.to_tensor(x), cache=js)
    out, s2 = m(torch.from_numpy(x), cache=s)
    _close(out, jout)
    assert s2 is s


# -------------------------------------------------------- encoder / decoder
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_matches_jax(normalize_before):
    rs = np.random.RandomState(2)
    P.seed(2)
    jlayer = jnn.TransformerEncoderLayer(16, 2, 32, dropout=0.0,
                                         normalize_before=normalize_before)
    jenc = jnn.TransformerEncoder(jlayer, 2, jnn.LayerNorm(16)
                                  if normalize_before else None)
    layer = nn.TransformerEncoderLayer(16, 2, 32, dropout=0.0,
                                       normalize_before=normalize_before)
    enc = _twin(jenc, nn.TransformerEncoder(
        layer, 2, nn.LayerNorm(16) if normalize_before else None))
    x = _x(rs, 2, 6, 16)
    mask = (rs.rand(2, 1, 6, 6) > 0.2)
    mask[..., 0] = True
    _close(enc(torch.from_numpy(x)), jenc(P.to_tensor(x)))
    _close(enc(torch.from_numpy(x), torch.from_numpy(mask)),
           jenc(P.to_tensor(x), P.to_tensor(mask)))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_matches_jax(normalize_before):
    rs = np.random.RandomState(3)
    P.seed(3)
    jlayer = jnn.TransformerDecoderLayer(16, 2, 32, dropout=0.0,
                                         normalize_before=normalize_before)
    jdec = jnn.TransformerDecoder(jlayer, 2, jnn.LayerNorm(16)
                                  if normalize_before else None)
    layer = nn.TransformerDecoderLayer(16, 2, 32, dropout=0.0,
                                       normalize_before=normalize_before)
    dec = _twin(jdec, nn.TransformerDecoder(
        layer, 2, nn.LayerNorm(16) if normalize_before else None))
    tgt, mem = _x(rs, 2, 5, 16), _x(rs, 2, 7, 16)
    jt = jnn.Transformer(16, 2, 1, 1, 32)
    mask = jt.generate_square_subsequent_mask(5)
    tmask = nn.Transformer(16, 2, 1, 1, 32).generate_square_subsequent_mask(5)
    assert np.array_equal(_np(tmask), _np(mask))
    assert float(tmask[0, 1]) == -math.inf and float(tmask[1, 0]) == 0.0
    _close(dec(torch.from_numpy(tgt), torch.from_numpy(mem), tmask),
           jdec(P.to_tensor(tgt), P.to_tensor(mem), mask))
    # the cached decode, one token a step, equals the masked full pass
    cache = dec.gen_cache(torch.from_numpy(mem))
    jcache = jdec.gen_cache(P.to_tensor(mem))
    for t in range(5):
        out, cache = dec(torch.from_numpy(tgt[:, t:t + 1]),
                         torch.from_numpy(mem), cache=cache)
        jout, jcache = jdec(P.to_tensor(tgt[:, t:t + 1]), P.to_tensor(mem),
                            cache=jcache)
        _close(out, jout)
    full = dec(torch.from_numpy(tgt), torch.from_numpy(mem), tmask)
    _close(out[:, 0], full[:, -1])


def test_layer_copies_are_fresh_parameters_bit_for_bit():
    layer = nn.TransformerEncoderLayer(8, 2, 16)
    layer.linear1.weight.optimize_attr["learning_rate"] = 0.5
    enc = nn.TransformerEncoder(layer, 3)
    first, *rest = enc.layers
    assert first is layer
    for other in rest:
        for (na, a), (nb, b) in zip(first.named_parameters(),
                                    other.named_parameters()):
            assert na == nb and a is not b
            assert type(b) is T.Parameter and torch.equal(a, b)
            assert a.data_ptr() != b.data_ptr()
            assert b.trainable and b.optimize_attr == a.optimize_attr
    assert rest[0].linear1.weight.optimize_attr is not \
        first.linear1.weight.optimize_attr
    # JAX's copies are bit for bit too
    P.seed(0)
    jenc = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(8, 2, 16), 3)
    ja, jb = jenc.layers[0].linear1.weight, jenc.layers[2].linear1.weight
    assert np.array_equal(ja.numpy(), jb.numpy())


def test_transformer_base_defaults_are_the_papers():
    for cls in (jnn.Transformer, nn.Transformer):
        import inspect

        d = inspect.signature(cls).parameters
        assert (d["d_model"].default, d["nhead"].default,
                d["num_encoder_layers"].default,
                d["num_decoder_layers"].default,
                d["dim_feedforward"].default, d["dropout"].default) == (
            512, 8, 6, 6, 2048, 0.1)


# -------------------------------------------------------- the recipe
SMALL = dict(vocab=64, d_model=32, nhead=2, layers=2, d_ff=64, max_len=16,
             dropout=0.0)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    src = rs.randint(1, 64, (4, 16)).astype(np.int64)
    full = rs.randint(1, 64, (4, 17)).astype(np.int64)
    return src, full[:, :-1], full[:, 1:]


def _recipes(amp):
    jm, jopt, jsched, jloss = cs.transformer_base(P, amp=amp, **SMALL)
    m, opt, sched, loss = cs.transformer_base(T, amp=amp, **SMALL)
    load_jax_state(m, _state(jm))
    return (jm, jopt, jsched, jloss), (m, opt, sched, loss)


def test_recipe_builds_the_same_model_in_both_packages():
    (jm, *_), (m, *_) = _recipes(False)
    assert isinstance(m, nn.Layer)
    assert list(m.state_dict()) == list(jm.state_dict())
    assert "position_table" not in m.state_dict()
    assert [n for n, _ in m.named_buffers()] == ["position_table"]
    # 1 + 2 x 16 + 2 x 26 tensors; 253 at Transformer-base's 6 + 6
    assert len(m.parameters()) == len(jm.parameters()) == 85
    assert all(type(p) is T.Parameter for p in m.parameters())
    w = m.embedding.weight
    assert float(w.detach()[0].abs().max()) == 0.0  # the padding row
    assert abs(float(w.detach()[1:].std()) - 32 ** -0.5) < 0.02


def test_recipe_logits_and_gradients_match_jax(nan_inf_check_off):
    (jm, _, _, jloss), (m, _, _, loss_fn) = _recipes(False)
    src, tgt, label = _batch()
    want = jm(P.to_tensor(src), P.to_tensor(tgt))
    got = m(torch.from_numpy(src), torch.from_numpy(tgt))
    _close(got, want)
    jl = jloss(P.to_tensor(src), P.to_tensor(tgt), P.to_tensor(label))
    jl.backward()
    loss = loss_fn(*(torch.from_numpy(a) for a in (src, tgt, label)))
    loss.backward()
    _close(loss, jl)
    jgrads = {n: p.grad for n, p in jm.named_parameters()}
    for name, p in m.named_parameters():
        g = p.grad.detach().numpy()
        jg = np.asarray(jgrads[name].numpy())
        if g.ndim == 2 and name != "embedding.weight":
            jg = jg.T  # the JAX Linear weight is [in, out]
        # k_proj's bias gets no gradient in exact arithmetic (the softmax
        # takes no notice of a shift shared by every key): both packages
        # give rounding noise of 1e-9 there, held to 1e-8 absolute
        scale = max(float(np.abs(jg).max()), 1e-4)
        assert float(np.abs(g - jg).max()) <= GRAD * scale, name


def test_recipe_trains_in_bf16_o2_as_jax(nan_inf_check_off):
    """3 ``TrainStep`` steps in bf16 O2 (scheduler stepped after each) in
    both packages from the same weights: the losses within one bf16
    step."""
    (jm, jopt, jsched, jloss), (m, opt, sched, loss_fn) = _recipes(True)
    assert m.embedding.weight.dtype == torch.bfloat16
    assert m.position_table.dtype == torch.float32  # not persistable
    jstep = JaxTrainStep(model=jm, optimizer=jopt, loss_fn=jloss)
    step = TrainStep(model=m, optimizer=opt, loss_fn=loss_fn)
    src, tgt, label = _batch()
    jbatch = [P.to_tensor(a) for a in (src, tgt, label)]
    batch = [torch.from_numpy(a) for a in (src, tgt, label)]
    wants, gots = [], []
    for _ in range(3):
        wants.append(jstep(*jbatch))
        gots.append(step(*batch))
        jsched.step()
        sched.step()
    for jl, loss in zip(wants, gots):
        want, got = float(_np(jl)), float(_np(loss))
        ulp = 2.0 ** (math.floor(math.log2(abs(want))) - 7)
        assert math.isfinite(got) and abs(got - want) <= ulp, (got, want)


def test_recipe_draws_dropout_from_the_dropout_generator():
    """At dropout 0.1 the eager steps draw from the process-wide dropout
    generator that ``paddle.seed`` reseeds: two runs from one seed agree
    bit for bit, and the layers hold that generator."""
    kw = dict(SMALL, dropout=0.1)
    src, tgt, label = (torch.from_numpy(a) for a in _batch())
    runs = []
    for _ in range(2):
        m, opt, sched, loss_fn = cs.transformer_base(T, amp=False, **kw)
        losses = []
        for _ in range(2):
            loss = loss_fn(src, tgt, label)
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            losses.append(float(loss.detach()))
        runs.append(losses)
        gen = T.base.global_state.dropout_generator("cpu")
        assert m.dropout.generator is gen
        assert m.transformer.decoder.layers[1].cross_attn.generator is gen
    assert runs[0] == runs[1]
    m.eval()
    a = m(src, tgt)
    assert torch.equal(a, m(src, tgt))


def test_skill_eager_recipe_trains_on_the_port():
    """``.claude/skills/verify/SKILL.md``'s eager training loop with the
    import renamed."""
    paddle = T
    nn_ = T.nn
    paddle.seed(7)
    rs = np.random.RandomState(7)
    X = rs.randn(256, 4).astype(np.float32)
    y = (X @ rs.randn(4, 1).astype(np.float32) > 0).astype(np.int32)
    y = y.reshape(-1)
    net = nn_.Sequential(nn_.Linear(4, 32), nn_.Tanh(), nn_.Linear(32, 2))
    for _ in range(60):
        loss = nn_.CrossEntropyLoss()(net(paddle.to_tensor(X)),
                                      paddle.to_tensor(y))
        loss.backward()
        with paddle.no_grad():
            for p in net.parameters():
                p.set_value(p.numpy() - 0.5 * p.grad.numpy())
                p.clear_grad()
    assert float(loss.numpy()) < 0.1
