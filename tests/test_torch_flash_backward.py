"""The port's flash-attention forward and backward, and its dropout hash,
against the Pallas kernels.

The plain PyTorch versions (what the wrappers run for CPU tensors) are held
against ``_flash_fwd``/``_flash_bwd`` in interpret mode at the tolerances of
``tests/test_pallas_backward.py`` (2e-4 on O and lse, 2e-3 on gradients),
with dropout included, and the keep mask of ``dropout_keep`` against the
Pallas ``_dropout_mask`` bit for bit. The CUDA kernels are held against the
plain versions on the card (``tests/test_torch_cuda_backward.py``,
``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import (_blocks, _dropout_mask,
                                                   _flash_bwd, _flash_fwd)
from paddle_tpu_torch.ops.cuda import flash_attention as fa

TOL_O, TOL_GRAD = 2e-4, 2e-3


def _inputs(b, sq, sk, h, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, sq, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sq, h, d).astype(np.float32))


def _pallas_mask(seed, b, h, sq, sk, block_q, block_k, p):
    """The Pallas mask at global positions, tile by tile."""
    seed_arr = jnp.asarray([seed], jnp.int32)
    out = np.zeros((sq, sk), bool)
    for iq in range(sq // block_q):
        for ik in range(sk // block_k):
            ids = tuple(jnp.int32(i) for i in (b, h, iq, ik))
            tile = _dropout_mask(seed_arr, ids, (block_q, block_k), p)
            out[iq * block_q:(iq + 1) * block_q,
                ik * block_k:(ik + 1) * block_k] = np.asarray(tile)
    return out


def test_dropout_keep_matches_pallas_mask_bitwise():
    cases = [(21, 0, 1, 128, 128, 32, 64, 0.5),
             (7, 3, 11, 96, 160, 32, 32, 0.1),
             (2**31 - 2, 7, 2, 64, 64, 64, 64, 0.3)]
    for seed, b, h, sq, sk, bq, bk, p in cases:
        want = _pallas_mask(seed, b, h, sq, sk, bq, bk, p)
        got = fa.dropout_keep(torch.tensor([seed], dtype=torch.int32), b, h,
                              sq, sk, bq, bk, p)
        np.testing.assert_array_equal(got.numpy(), want)
        assert abs((1 - want.mean()) - p) < 0.05, (seed, p)
    # the broadcast form of the wrapper: one call for every (b, h)
    seed = torch.tensor([5], dtype=torch.int32)
    full = fa.dropout_keep(seed, torch.arange(2).view(2, 1, 1, 1),
                           torch.arange(3).view(1, 3, 1, 1), 64, 64, 32, 32,
                           0.25)
    assert full.shape == (2, 3, 64, 64)
    for b in range(2):
        for h in range(3):
            np.testing.assert_array_equal(
                full[b, h].numpy(), _pallas_mask(5, b, h, 64, 64, 32, 32,
                                                 0.25))
    assert fa.blocks(1000, 1000) == _blocks(1000, 1000, 256, 512)
    assert fa.blocks(100, 64, 32, 64) == _blocks(100, 64, 32, 64)


@pytest.mark.parametrize("sq,sk,causal,dropout,tiles", [
    (128, 128, True, 0.0, {}),
    (128, 128, False, 0.0, {}),
    (64, 128, True, 0.0, {}),  # top-left causal alignment
    # the mask spans 4 x 2 Pallas tiles
    (128, 128, True, 0.5, {"block_q": 32, "block_k": 64}),
])
def test_plain_fwd_bwd_match_pallas_interpret(sq, sk, causal, dropout, tiles):
    q, k, v, do = _inputs(1, sq, sk, 2, 16)
    scale = 1.0 / math.sqrt(16)
    seed = 21
    jseed = jnp.asarray([seed], jnp.int32)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o_ref, lse_ref = _flash_fwd(jq, jk, jv, jseed, causal, scale, dropout,
                                interpret=True, **tiles)
    dq_ref, dk_ref, dv_ref = _flash_bwd(jq, jk, jv, o_ref, lse_ref, jdo,
                                        jseed, causal, scale, dropout,
                                        interpret=True, **tiles)

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tseed = torch.tensor([seed], dtype=torch.int32)
    o, lse = fa.flash_attention_fwd(tq, tk, tv, causal, scale, dropout, tseed,
                                    device="cpu", **tiles)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=TOL_O,
                               atol=TOL_O)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=TOL_O,
                               atol=TOL_O)
    dq, dk, dv = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, tseed,
                                        causal, scale, dropout, device="cpu",
                                        **tiles)
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        assert got.shape == want.shape and got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_GRAD, atol=TOL_GRAD, err_msg=name)
    if sk > sq and causal:
        # keys no query sees get no gradient
        assert float(dk[:, sq:].abs().max()) == 0.0
        assert float(dv[:, sq:].abs().max()) == 0.0
