"""On-card tests of the port's CUDA kernels (marker ``cuda``).

They need an NVIDIA Hopper GPU and ``nvcc``, and skip on hosts without a
GPU. This file imports no JAX, so it also runs where only the port is
installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

The forward kernel is held against its plain PyTorch version on the same
card, with the tolerances ``chip_smoke.py`` states; the backward kernels
are in ``tests/test_torch_cuda_backward.py``.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed_qkv(b, sq, sk, h, d, dtype, card, seed=0):
    """q, k, v as the strided slices of packed [B, S, H, 3, D] tensors,
    the way the GPT attention hands them over."""
    rs = np.random.RandomState(seed)
    qp = torch.from_numpy(rs.randn(b, sq, h, 3, d).astype(np.float32))
    kp = torch.from_numpy(rs.randn(b, sk, h, 3, d).astype(np.float32))
    qp = qp.to(card, dtype)
    kp = kp.to(card, dtype)
    return qp[..., 0, :], kp[..., 1, :], kp[..., 2, :]


CASES = [
    (2, 100, 100, 3, 64, torch.float32, True),     # ragged S
    (1, 77, 130, 2, 32, torch.float32, False),     # Sq != Sk
    (1, 64, 128, 2, 16, torch.float32, True),      # top-left causal
    (2, 200, 200, 2, 128, torch.bfloat16, True),
    (1, 33, 33, 4, 64, torch.bfloat16, False),
]


def test_kernel_matches_plain(card):
    for case in CASES:
        b, sq, sk, h, d, dtype, causal = case
        q, k, v = _packed_qkv(b, sq, sk, h, d, dtype, card)
        scale = 1.0 / math.sqrt(d)
        before = fa.launches
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        assert fa.launches == before + 1, case
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
        assert o.dtype == dtype and o.shape == (b, sq, h, d), case
        assert lse.dtype == torch.float32 and lse.shape == (b, h, 1, sq), case
        tol_o, tol_lse = TOL[dtype]
        assert (o.float() - ro.float()).abs().max().item() <= tol_o, case
        assert (lse - rlse).abs().max().item() <= tol_lse, case


def _padding_leaves_real_rows_bitwise(dtype, card):
    q, k, v = _packed_qkv(2, 300, 300, 2, 64, dtype, card, seed=1)
    scale = 0.125
    o_pad, lse_pad = fa.flash_attention_fwd(q, k, v, True, scale)
    for n in (100, 200, 257):
        o, lse = fa.flash_attention_fwd(q[:, :n], k[:, :n], v[:, :n], True,
                                        scale)
        torch.cuda.synchronize()
        assert torch.equal(o, o_pad[:, :n]), n
        assert torch.equal(lse, lse_pad[..., :n]), n


def test_padding_leaves_real_rows_bitwise(card):
    """Causal rows below the real length do not change by a bit when the
    sequence is padded: the greedy batch-invariance contract."""
    _padding_leaves_real_rows_bitwise(torch.float32, card)


def test_padding_leaves_real_rows_bitwise_bf16(card):
    """The same contract for the tensor-core kernel (bf16): its tiles and
    k-tile order do not depend on S, and a wholly masked tile leaves a row
    unchanged."""
    _padding_leaves_real_rows_bitwise(torch.bfloat16, card)


def test_rejects_what_the_kernel_does_not_take(card):
    q, k, v = _packed_qkv(1, 16, 16, 1, 64, torch.float32, card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q[..., :8], k[..., :8], v[..., :8], True, 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q.half(), k.half(), v.half(), True, 1.0)
    with pytest.raises(ValueError, match="asked for"):
        fa.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu(), True, 1.0)
    with pytest.raises(ValueError, match="needs a seed"):
        fa.flash_attention_fwd(q, k, v, True, 1.0, dropout=0.1)


def test_f32_forward_matches_float64_and_repeats_bitwise(card):
    """The f32 forward kernel (3xTF32 on the tensor cores) holds O and lse
    within the f32 gate (1e-4) of the plain version computed in float64 at
    the same inputs, over D in {16, 64, 128}, causal and not, and a second
    call gives the same bits."""
    for d in (16, 64, 128):
        q, k, v = _packed_qkv(2, 130, 130, 3, d, torch.float32, card, seed=4)
        for causal in (True, False):
            scale = 1.0 / math.sqrt(d)
            o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
            o2, lse2 = fa.flash_attention_fwd(q, k, v, causal, scale)
            torch.cuda.synchronize()
            assert torch.equal(o, o2) and torch.equal(lse, lse2), (d, causal)
            ro, rlse = fa.flash_attention_fwd_reference(
                q.double(), k.double(), v.double(), causal, scale)
            assert float((o.double() - ro).abs().max()) <= 1e-4, (d, causal)
            assert float((lse.double() - rlse).abs().max()) <= 1e-4, (
                d, causal)
