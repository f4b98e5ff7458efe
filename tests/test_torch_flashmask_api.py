"""The port's ``flashmask_attention`` and the rest of the flash-attention
API family against the JAX package.

- The entry point's forward and autograd gradients against ``jax.vjp`` of
  the Pallas ``flashmask_value`` in interpret mode, the function the JAX
  package runs on the TPU (2e-4 on the output, 2e-3 on the gradients, f32).
- Against the JAX package's public ``flashmask_attention``, which takes its
  XLA route on the CPU: equal where every row keeps a key column; on a fully
  masked row the port gives 0 (as the Pallas kernel does) and the XLA route
  the mean of v, a divergence this file pins.
- Without indices, AMP O2, the calls that raise, and the functions the JAX
  package computes in plain XLA (``flash_attn_qkvpacked``,
  ``flash_attn_unpadded``, ``flash_attn_varlen_qkvpacked``,
  ``calc_reduced_attn_scores``, ``fused_softmax_mask``,
  ``fused_softmax_mask_upper_triangle``).
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.ops.pallas.flashmask import flashmask_value as jax_value
from paddle_tpu_torch import amp
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch.nn import functional as F

# the module: the package binds the name flash_attention to the function
jfa = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
TOL_O, TOL_GRAD = 2e-4, 2e-3


def _qkv(b, sq, sk, h, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, sq, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sq, h, d).astype(np.float32))


def _doc_indices(b, s, ends, ncol=1):
    """Causal document mask: key columns of the document ending at ``end``
    hide rows from ``end`` on ([LTS], or [LTS, LTE = s])."""
    idx = np.empty((b, 1, s, ncol), np.int32)
    start = 0
    for end in ends:
        idx[:, :, start:end, 0] = end
        start = end
    if ncol == 2:
        idx[..., 1] = s
    return idx


def _window_indices(b, h, s, w):
    j = np.arange(s)
    one = np.stack([np.minimum(j + w, s), np.full(s, s), np.zeros(s),
                    np.maximum(j - w + 1, 0)], -1).astype(np.int32)
    return np.broadcast_to(one, (b, h, s, 4)).copy()


def _port(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


LAYOUTS = [
    ("doc_ncol1_hm1", 2, 64, 64, 2, True, lambda: _doc_indices(2, 64,
                                                              (20, 41, 64))),
    ("doc_ncol2_hm1", 1, 64, 64, 2, True,
     lambda: _doc_indices(1, 64, (30, 64), ncol=2)),
    ("window_ncol4_hm_h", 1, 48, 48, 3, False,
     lambda: _window_indices(1, 3, 48, 5)),
]


@pytest.mark.parametrize("name,b,sq,sk,h,causal,make", LAYOUTS,
                         ids=[c[0] for c in LAYOUTS])
def test_entry_point_matches_jax_vjp_of_the_pallas_kernel(name, b, sq, sk, h,
                                                          causal, make):
    d = 16
    q, k, v, do = _qkv(b, sq, sk, h, d)
    idx = make()
    scale = 1.0 / math.sqrt(d)
    want, vjp = jax.vjp(
        lambda q, k, v: jax_value(q, k, v, jnp.asarray(idx), causal, scale,
                                  True), *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))

    tq, tk, tv = _port(q, k, v, grad=True)
    out = F.flashmask_attention(tq, tk, tv, torch.from_numpy(idx),
                                causal=causal)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=TOL_O, atol=TOL_O)
    for label, t, g in zip("qkv", (tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=TOL_GRAD, atol=TOL_GRAD,
                                   err_msg=f"d{label}")
    assert IF.flashmask_attention is F.flashmask_attention


def test_entry_point_against_jax_public_xla_route():
    b, s, h, d = 1, 32, 2, 8
    q, k, v, _ = _qkv(b, s, s, h, d, seed=1)
    jq, jk, jv = (P.to_tensor(a) for a in (q, k, v))
    tq, tk, tv = _port(q, k, v)

    # every row keeps a key column: the two routes agree
    idx = _doc_indices(b, s, (12, 25, 32))
    want = jfa.flashmask_attention(jq, jk, jv, P.to_tensor(idx), causal=True)
    got = F.flashmask_attention(tq, tk, tv, torch.from_numpy(idx),
                                causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)

    # rows 8..11 see no key column: the port gives 0 there, as the Pallas
    # kernel does; the XLA route softmaxes a row of -1e30 biases into the
    # mean of v
    idx2 = np.stack([idx[..., 0], np.full_like(idx[..., 0], s)], -1)
    idx2[:, :, :12, 0] = np.minimum(idx2[:, :, :12, 0],
                                    np.maximum(8, np.arange(12)))
    idx2[:, :, :12, 1] = 12
    want = jfa.flashmask_attention(jq, jk, jv, P.to_tensor(idx2),
                                   causal=True).numpy()
    got = F.flashmask_attention(tq, tk, tv, torch.from_numpy(idx2),
                                causal=True).numpy()
    dead = np.zeros(s, bool)
    dead[8:12] = True
    assert (got[:, dead] == 0).all()
    np.testing.assert_allclose(want[:, dead],
                               np.broadcast_to(v.mean(1, keepdims=True),
                                               want[:, dead].shape),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, ~dead], want[:, ~dead], rtol=1e-5,
                               atol=1e-5)


def test_without_indices_and_under_o2():
    b, s, h, d = 2, 32, 2, 16
    q, k, v, _ = _qkv(b, s, s, h, d, seed=2)
    tq, tk, tv = _port(q, k, v)
    for causal in (True, False):
        got = F.flashmask_attention(tq, tk, tv, None, causal=causal)
        want = F.flash_attention(tq, tk, tv, causal=causal)[0]
        assert torch.equal(got, want)
    # window_size is ignored without indices, as in the JAX package
    assert torch.equal(F.flashmask_attention(tq, tk, tv, window_size=(4, 4)),
                       F.flash_attention(tq, tk, tv, causal=True)[0])

    # O2: q, k and v compute in bf16; the indices are not cast
    idx = torch.from_numpy(_doc_indices(b, s, (10, 32))).long()
    lq, lk, lv = _port(q, k, v, grad=True)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        out = F.flashmask_attention(lq, lk, lv, idx)
    assert out.dtype == torch.bfloat16 and idx.dtype == torch.int64
    want = F.flashmask_attention(*(t.to(torch.bfloat16) for t in (tq, tk, tv)),
                                 idx)
    assert torch.equal(out, want)
    out.float().sum().backward()
    for t in (lq, lk, lv):
        assert t.grad.dtype == torch.float32
        assert bool(torch.isfinite(t.grad).all()) and float(
            t.grad.abs().max()) > 0


def test_invalid_calls_raise():
    b, s, h, d = 1, 16, 2, 8
    q, k, v, _ = _qkv(b, s, s, h, d)
    tq, tk, tv = _port(q, k, v)
    for causal, ncol in ((False, 1), (False, 2), (True, 4), (True, 3)):
        idx = torch.full((b, 1, s, ncol), s, dtype=torch.int32)
        with pytest.raises(ValueError, match="not a documented layout"):
            F.flashmask_attention(tq, tk, tv, idx, causal=causal)
    idx = torch.from_numpy(_doc_indices(b, s, (8, 16)))
    with pytest.raises(NotImplementedError, match="window_size"):
        F.flashmask_attention(tq, tk, tv, idx, window_size=(4, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        F.flashmask_attention(tq, tk, tv, idx, dropout=0.1)
    for bad in (idx.expand(2, 1, s, 1), idx.expand(1, 3, s, 1), idx[:, :, :8],
                idx[0]):
        with pytest.raises(ValueError, match="startend_row_indices"):
            F.flashmask_attention(tq, tk, tv, bad)
    with pytest.raises(TypeError, match="integers"):
        F.flashmask_attention(tq, tk, tv, idx.float())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        F.flash_attn_unpadded(tq[0], tk[0], tv[0], torch.tensor([0, s]),
                              torch.tensor([0, s]), s, s, dropout=0.1)


def test_plain_xla_functions_match_jax():
    rs = np.random.RandomState(3)
    b, s, h, d = 2, 16, 2, 8
    qkv = rs.randn(b, s, 3, h, d).astype(np.float32)
    for causal in (True, False):
        want = jfa.flash_attn_qkvpacked(P.to_tensor(qkv), causal=causal)[0]
        got = F.flash_attn_qkvpacked(torch.from_numpy(qkv), causal=causal)[0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)

    # varlen: three sequences packed into 20 tokens
    packed = rs.randn(20, 3, h, d).astype(np.float32)
    cu = np.array([0, 5, 12, 20], np.int32)
    for causal in (True, False):
        want, wprobs = jfa.flash_attn_varlen_qkvpacked(
            P.to_tensor(packed), P.to_tensor(cu), P.to_tensor(cu), 8, 8,
            causal=causal, return_softmax=True)
        got, gprobs = F.flash_attn_varlen_qkvpacked(
            torch.from_numpy(packed), torch.from_numpy(cu),
            torch.from_numpy(cu), 8, 8, causal=causal, return_softmax=True)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(gprobs.numpy(), wprobs.numpy(), rtol=1e-5,
                                   atol=1e-6)
    q, k = packed[:, 0], packed[:, 1]
    cq, ck = np.array([0, 7, 20], np.int32), np.array([0, 9, 20], np.int32)
    want, none = jfa.flash_attn_unpadded(
        *(P.to_tensor(a) for a in (q, k, k, cq, ck)), 13, 11, scale=0.3)
    got, gnone = F.flash_attn_unpadded(
        *(torch.from_numpy(a) for a in (q, k, k, cq, ck)), 13, 11, scale=0.3)
    assert none is None and gnone is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)

    q4, k4 = qkv[:, :, 0], qkv[:, :, 1]
    want = jfa.calc_reduced_attn_scores(P.to_tensor(q4), P.to_tensor(k4))
    got = F.calc_reduced_attn_scores(torch.from_numpy(q4),
                                     torch.from_numpy(k4))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)

    x = rs.randn(b, h, s, s).astype(np.float32)
    mask = np.where(rs.rand(1, 1, s, s) < 0.3, -1e4, 0.0).astype(np.float32)
    for jfn, fn, args in (
            (jfa.fused_softmax_mask, IF.fused_softmax_mask, (x, mask)),
            (jfa.fused_softmax_mask_upper_triangle,
             IF.fused_softmax_mask_upper_triangle, (x,))):
        want = jfn(*(P.to_tensor(a) for a in args))
        got = fn(*(torch.from_numpy(a) for a in args))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert IF.fused_softmax_mask is F.fused_softmax_mask
