"""The port's BERT/ERNIE against the JAX package's, on the CPU.

Every model test builds the same ``bert_tiny`` object in both packages,
carries the JAX weights across with ``load_jax_state`` and feeds the same
numpy inputs:

- the trunk's sequence and pooled outputs, with and without a 2-D keep
  mask, and both heads (classification; pretraining's tied MLM decoder and
  NSP), f32 within 1e-5;
- one backward's gradients of every parameter, f32 within 1e-5 times the
  tensor's largest gradient, or 1e-5 where that is below 1;
- 5 ``TrainStep`` steps of ``AdamW(1e-3)`` at O2 bf16 (``auto_cast``
  around the model, ``CrossEntropyLoss`` outside it, as ``bench.py`` runs
  its BERT arm), masked and not: the loss streams within one bf16 step
  (2^-7 of the loss) of each other. Both packages round to bf16 at the
  same ops (the gray sums after an f32 LayerNorm included), where their
  GEMMs and exp may differ by an ulp;
- ``embedding`` with a non-zero padding row (0 at padding positions, as
  JAX selects it, where torch's ``padding_idx`` would return the row), and
  ``gelu`` in both forms and ``tanh``, exactly as JAX within 1e-6;
- ``scaled_dot_product_attention`` with bool and float masks (the JAX
  ``_xla_attention`` route), causal and not, outputs and gradients, and
  ``flash_attention(return_softmax=True)``, within 1e-5; in bf16 the
  same route within one bf16 step of the output;
- the plain versions of K1–K3 (what the wrappers run for CPU tensors)
  non-causal at BERT's head dim and length (D=64, S=128), without and with
  dropout at the Pallas tiling, against ``_flash_fwd``/``_flash_bwd`` in
  interpret mode at ``tests/test_torch_flash_backward.py``'s tolerances
  (2e-4 on O and lse, 2e-3 on gradients).

Dropout is 0 throughout: the JAX ``jax.random.bernoulli`` stream cannot be
matched (ROADMAP.md, divergences).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.models.bert import BertForPretraining as JaxPretraining
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JaxClassifier
from paddle_tpu.models.bert import BertModel as JaxBertModel
from paddle_tpu.models.bert import bert_tiny as jax_bert_tiny
from paddle_tpu.ops.pallas.flash_attention import _flash_bwd, _flash_fwd
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW

B, S = 3, 24
MASK_LENGTHS = (24, 9, 17)  # the keep-mask's length per row


def _np(t):
    return np.asarray(t.numpy()).astype(np.float32)


def _jax_state(model):
    return {k: np.array(v.numpy(), copy=True)
            for k, v in model.state_dict().items()}


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 512, (B, S)).astype(np.int64)
    types = rs.randint(0, 2, (B, S)).astype(np.int64)
    mask = (np.arange(S)[None] < np.array(MASK_LENGTHS)[:, None]).astype(
        np.int64)
    labels = rs.randint(0, 2, (B,)).astype(np.int64)
    return ids, types, mask, labels


def _pair(jax_cls, port_cls, **kw):
    """The JAX model (seed 0) and the port's with its weights."""
    paddle.seed(0)
    ref = jax_cls(jax_bert_tiny(), **kw)
    model = port_cls(bert.bert_tiny(), device="cpu", **kw)
    bert.load_jax_state(model, _jax_state(ref))
    return ref, model


def _jt(a):
    return None if a is None else paddle.to_tensor(a)


def _tt(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("masked", [False, True])
def test_trunk_outputs_match_jax(masked):
    ids, types, mask, _ = _inputs()
    mask = mask if masked else None
    ref, model = _pair(JaxBertModel, bert.BertModel)
    ref.eval()
    model.eval()
    want_seq, want_pooled = ref(_jt(ids), _jt(types), None, _jt(mask))
    with torch.no_grad():
        seq, pooled = model(_tt(ids), _tt(types), None, _tt(mask))
    assert seq.shape == (B, S, 64) and pooled.shape == (B, 64)
    np.testing.assert_allclose(seq.numpy(), _np(want_seq), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), _np(want_pooled), rtol=1e-5,
                               atol=1e-5)
    if masked:
        # the mask does its work: row 1's first 9 tokens alone decide them
        with torch.no_grad():
            short, _ = model(_tt(ids[1:2, :9]), _tt(types[1:2, :9]))
        np.testing.assert_allclose(seq[1:2, :9].numpy(), short.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_heads_match_jax(masked):
    ids, types, mask, _ = _inputs(1)
    mask = mask if masked else None
    ref, model = _pair(JaxClassifier, bert.BertForSequenceClassification,
                       num_classes=3)
    want = ref(_jt(ids), _jt(types), None, _jt(mask))
    with torch.no_grad():
        got = model(_tt(ids), _tt(types), None, _tt(mask))
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)

    ref, model = _pair(JaxPretraining, bert.BertForPretraining)
    want_mlm, want_nsp = ref(_jt(ids), _jt(types), _jt(mask))
    with torch.no_grad():
        mlm, nsp = model(_tt(ids), _tt(types), _tt(mask))
    assert mlm.shape == (B, S, 512) and nsp.shape == (B, 2)
    np.testing.assert_allclose(mlm.numpy(), _np(want_mlm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nsp.numpy(), _np(want_nsp), rtol=1e-5,
                               atol=1e-5)


def test_gradients_match_jax():
    ids, types, mask, _ = _inputs(2)
    ref, model = _pair(JaxPretraining, bert.BertForPretraining)
    want_mlm, want_nsp = ref(_jt(ids), _jt(types), _jt(mask))
    (want_mlm.sum() * 0.01 + (want_nsp * want_nsp).sum()).backward()
    want = {name: np.asarray(p.grad.numpy())
            for name, p in ref.named_parameters()}
    mlm, nsp = model(_tt(ids), _tt(types), _tt(mask))
    (mlm.sum() * 0.01 + (nsp * nsp).sum()).backward()
    # the JAX gradients in the port's layout ([out, in] Linear weights)
    want = bert.port_state_from_jax(model, want)
    for name, p in model.named_parameters():
        scale = float(np.abs(want[name].numpy()).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5 * max(scale, 1.0),
                                   err_msg=name)


def _jax_losses(ids, mask, labels, steps):
    paddle.seed(0)
    model = JaxClassifier(jax_bert_tiny())
    state = _jax_state(model)
    crit = paddle.nn.CrossEntropyLoss()
    paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())

    def loss_fn(x, m, y):
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(x, attention_mask=m)
        return crit(logits, y)

    step = JaxTrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    args = (_jt(ids), _jt(mask), _jt(labels))
    return state, [float(_np(step(*args))) for _ in range(steps)]


def _port_losses(state, ids, mask, labels, steps):
    model = bert.BertForSequenceClassification(bert.bert_tiny(), device="cpu")
    bert.load_jax_state(model, state).train()
    crit = nn.CrossEntropyLoss()
    amp.decorate(model, level="O2", dtype="bfloat16", device="cpu")
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                device="cpu")

    def loss_fn(x, m, y):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(x, attention_mask=m)
        return crit(logits, y)

    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn,
                     device="cpu")
    args = (_tt(ids), _tt(mask), _tt(labels))
    return [float(step(*args)) for _ in range(steps)]


@pytest.mark.parametrize("masked", [False, True])
def test_o2_bf16_train_step_matches_jax(masked):
    ids, _, mask, labels = _inputs(3)
    mask = mask if masked else None
    state, want = _jax_losses(ids, mask, labels, 5)
    got = _port_losses(state, ids, mask, labels, 5)
    assert got[-1] < got[0]
    for a, b in zip(got, want):
        assert abs(a - b) <= 2.0 ** -7 * abs(b), (got, want)


def test_embedding_padding_row_is_zero_as_in_jax():
    rs = np.random.RandomState(4)
    w = rs.randn(10, 6).astype(np.float32)  # the padding row is not 0
    x = np.array([[1, 3, 0, 3], [3, 9, 3, 2]], np.int64)
    jw = paddle.to_tensor(w, stop_gradient=False)
    want = JF.embedding(paddle.to_tensor(x), jw, padding_idx=3)
    (want * want).sum().backward()
    tw = torch.from_numpy(w).requires_grad_(True)
    got = F.embedding(torch.from_numpy(x), tw, padding_idx=3)
    (got * got).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), _np(want))
    assert float(got.detach()[0, 1].abs().max()) == 0.0
    np.testing.assert_allclose(tw.grad.numpy(), _np(jw.grad), rtol=1e-6,
                               atol=1e-6)
    # torch's own padding_idx returns the row: the divergence held apart
    rows = torch.nn.functional.embedding(torch.from_numpy(x), tw.detach(),
                                         padding_idx=3)
    assert float(rows[0, 1].abs().max()) > 0
    # the layer normalizes a negative padding_idx, as the JAX layer does
    layer = nn.Embedding(10, 6, padding_idx=-7, device="cpu")
    assert layer.padding_idx == 3
    assert float(layer.weight.detach()[3].abs().max()) == 0.0


def test_gelu_forms_and_tanh_match_jax():
    x = np.linspace(-6, 6, 97).astype(np.float32)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    exact = F.gelu(tx)
    approx = F.gelu(tx, approximate=True)
    np.testing.assert_allclose(exact.numpy(), _np(JF.gelu(jx)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(approx.numpy(),
                               _np(JF.gelu(jx, approximate=True)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(F.tanh(tx).numpy(), _np(JF.tanh(jx)),
                               rtol=1e-6, atol=1e-6)
    # the two forms are not the same function: BERT's is the erf one
    assert float((exact - approx).abs().max()) > 1e-4


def _qkv(rs, b, sq, sk, h, d):
    return (rs.randn(b, sq, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32))


@pytest.mark.parametrize("kind,causal", [("bool", False), ("float", False),
                                         ("float", True), ("bert", False)])
def test_masked_sdpa_matches_jax(kind, causal):
    rs = np.random.RandomState(5)
    b, s, h, d = 2, 12, 3, 8
    q, k, v = _qkv(rs, b, s, s, h, d)
    g = rs.randn(b, s, h, d).astype(np.float32)
    if kind == "bool":
        mask = rs.rand(b, h, s, s) > 0.3
        mask[..., 0] = True  # no fully hidden row
    elif kind == "float":
        mask = rs.randn(b, 1, s, s).astype(np.float32)
    else:  # BERT's padding bias, [B, 1, 1, S]
        keep = np.arange(s)[None] < np.array([12, 5])[:, None]
        mask = ((1.0 - keep) * -1e4).astype(np.float32)[:, None, None, :]
    jq, jk, jv = (paddle.to_tensor(a, stop_gradient=False) for a in (q, k, v))
    want = JF.scaled_dot_product_attention(jq, jk, jv, paddle.to_tensor(mask),
                                           is_causal=causal)
    (want * paddle.to_tensor(g)).sum().backward()
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = F.scaled_dot_product_attention(tq, tk, tv, torch.from_numpy(mask),
                                         is_causal=causal)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5,
                               atol=1e-5)
    for name, tp, jp in (("q", tq, jq), ("k", tk, jk), ("v", tv, jv)):
        np.testing.assert_allclose(tp.grad.numpy(), _np(jp.grad), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_masked_sdpa_bf16_follows_jax_dtypes():
    """bf16 q, k, v with an f32 bias: the logits promote to f32, the
    softmax runs in f32, P is cast to bf16 before P·V, as in jnp."""
    rs = np.random.RandomState(6)
    b, s, h, d = 2, 16, 2, 8
    q, k, v = _qkv(rs, b, s, s, h, d)
    bias = rs.randn(b, 1, 1, s).astype(np.float32)
    jq, jk, jv = (paddle.to_tensor(a).astype("bfloat16") for a in (q, k, v))
    want = JF.scaled_dot_product_attention(jq, jk, jv, paddle.to_tensor(bias))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = F.scaled_dot_product_attention(tq, tk, tv, torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    assert (torch.einsum("bshd,bthd->bhst", tq, tk)
            + torch.from_numpy(bias)).dtype == torch.float32
    want = _np(want.astype("float32"))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_return_softmax_matches_jax(causal):
    rs = np.random.RandomState(7)
    q, k, v = _qkv(rs, 2, 10, 10, 2, 8)
    want, want_p = JF.flash_attention(
        *(paddle.to_tensor(a) for a in (q, k, v)), causal=causal,
        return_softmax=True)
    got, got_p = F.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, return_softmax=True)
    assert got_p.shape == (2, 2, 10, 10)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), _np(want_p), rtol=1e-5,
                               atol=1e-6)
    # unmasked and without return_softmax: K1's route, the same numbers
    plain, none = F.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal)
    assert none is None
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_masked_route_dropout_draws_from_the_generator():
    rs = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rs, 1, 8, 8, 2, 8))
    mask = torch.zeros(1, 1, 1, 8)
    runs = [F.scaled_dot_product_attention(
        q, k, v, mask, dropout_p=0.5,
        generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    dense = F.scaled_dot_product_attention(q, k, v, mask)
    assert not torch.equal(runs[0], dense)
    # without a generator the mask comes from the process-wide dropout
    # generator, which paddle.seed governs
    from paddle_tpu_torch.base import global_state
    drawn = []
    for _ in range(2):
        global_state.seed(5)
        drawn.append(F.scaled_dot_product_attention(q, k, v, mask,
                                                    dropout_p=0.5))
    assert torch.equal(drawn[0], drawn[1])
    assert not torch.equal(drawn[0], dense)
    # eval mode: no dropout, no generator needed
    assert torch.equal(F.scaled_dot_product_attention(
        q, k, v, mask, dropout_p=0.5, training=False), dense)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_noncausal_plain_kernels_match_pallas_at_bert_shape(dropout):
    rs = np.random.RandomState(9)
    b, s, h, d = 1, 128, 2, 64
    q, k, v = _qkv(rs, b, s, s, h, d)
    do = rs.randn(b, s, h, d).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    seed = 17
    jseed = jnp.asarray([seed], jnp.int32)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o_ref, lse_ref = _flash_fwd(jq, jk, jv, jseed, False, scale, dropout,
                                interpret=True)
    grads_ref = _flash_bwd(jq, jk, jv, o_ref, lse_ref, jdo, jseed, False,
                           scale, dropout, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tseed = torch.tensor([seed], dtype=torch.int32)
    o, lse = fa.flash_attention_fwd(tq, tk, tv, False, scale, dropout, tseed,
                                    device="cpu")
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=2e-4,
                               atol=2e-4)
    grads = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, tseed, False,
                                   scale, dropout, device="cpu")
    for name, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=2e-3, err_msg=name)


def test_presets_and_refusals():
    assert bert.ernie_base().vocab_size == 40000
    assert bert.ernie_base().type_vocab_size == 4
    assert bert.bert_large().hidden_size == 1024
    assert bert.bert_base().num_hidden_layers == 12
    assert bert.bert_tiny(num_hidden_layers=12).num_hidden_layers == 12
    # the tensor-parallel layout builds (a world of one: mp = 1)
    from paddle_tpu_torch.distributed.fleet import mpu
    tp = bert.BertModel(bert.bert_tiny(tensor_parallel=True), device="cpu")
    assert isinstance(tp.encoder[0].attention.qkv, mpu.ColumnParallelLinear)
    assert isinstance(tp.embeddings.word_embeddings,
                      mpu.VocabParallelEmbedding)
    a = bert.BertForSequenceClassification(
        bert.bert_tiny(), device="cpu",
        generator=torch.Generator().manual_seed(5))
    b = bert.BertForSequenceClassification(
        bert.bert_tiny(), device="cpu",
        generator=torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert a.bert.encoder[0].fc1.weight.std().item() == pytest.approx(
        0.02, rel=0.1)
    assert a.bert.pooler.dense.weight.param_name == "bert.pooler.dense.weight"
    # one dropout generator reaches every dropout of the model
    gens = {id(m.generator) for m in a.modules() if isinstance(m, nn.Dropout)}
    assert gens == {id(a.bert.dropout_generator)}
    # the JAX layout comes back out
    state = bert.jax_state_dict(a)
    assert tuple(state["bert.encoder.0.fc1.weight"].shape) == (64, 128)
