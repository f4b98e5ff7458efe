"""On-card tests of the port's CUDA kernels (marker ``cuda``).

They need an NVIDIA Hopper GPU and ``nvcc``, and skip on hosts without a
GPU. This file imports no JAX, so it also runs where only the port is
installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

The forward kernel is held against its plain PyTorch version on the same
card, with the tolerances ``chip_smoke.py`` states; the backward kernels
are in ``tests/test_torch_cuda_backward.py``.
"""
import hashlib
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


def test_padding_leaves_real_rows_bitwise(card):
    """Causal rows below the real length do not change by a bit when the
    sequence is padded: the greedy batch-invariance contract."""
    q, k, v = _packed_qkv(2, 128, 128, 2, 64, torch.float32, card, seed=1)
    scale = 0.125
    o_pad, lse_pad = fa.flash_attention_fwd(q, k, v, True, scale)
    o, lse = fa.flash_attention_fwd(q[:, :100], k[:, :100], v[:, :100],
                                    True, scale)
    torch.cuda.synchronize()
    assert torch.equal(o, o_pad[:, :100])
    assert torch.equal(lse, lse_pad[..., :100])


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


#: sha256 (first 16 hex digits) of O and lse from the forward kernel as it
#: was before in-kernel dropout (commit 6d46396), on an H100, at the inputs
#: of :func:`forward_digests`
FORWARD_DIGESTS = {
    "float32/D=16/causal=1": "f707ea07faa3d0ec",
    "float32/D=16/causal=0": "3243ba35301de912",
    "float32/D=64/causal=1": "7573477046ddcf79",
    "float32/D=64/causal=0": "d646096308a2a661",
    "float32/D=128/causal=1": "6ca4ee632ca7bd78",
    "float32/D=128/causal=0": "3ffbd375e29c8a31",
    "bfloat16/D=16/causal=1": "b268b337c726d81a",
    "bfloat16/D=16/causal=0": "37d6bbabe4b7736c",
    "bfloat16/D=64/causal=1": "755eb72972702e18",
    "bfloat16/D=64/causal=0": "b475fad988ddfcae",
    "bfloat16/D=128/causal=1": "5e1342846bc9f336",
    "bfloat16/D=128/causal=0": "cbfcc6b8336f78f7",
}


def forward_digests(module, device):
    """Digests of the forward's outputs at fixed inputs, by (dtype, D,
    causal); ``module`` is the wrapper module to run."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64, 128):
            q, k, v = _packed_qkv(2, 130, 130, 3, d, dtype, device, seed=4)
            for causal in (True, False):
                o, lse = module.flash_attention_fwd(q, k, v, causal,
                                                    1.0 / math.sqrt(d))
                torch.cuda.synchronize()
                h = hashlib.sha256(o.float().cpu().numpy().tobytes()
                                   + lse.cpu().numpy().tobytes())
                out[f"{str(dtype)[6:]}/D={d}/causal={int(causal)}"] = \
                    h.hexdigest()[:16]
    return out


def test_forward_without_dropout_is_bitwise_unchanged(card):
    """In-kernel dropout is a template parameter of the forward kernel; the
    instantiation without it gives the same bits as the kernel before."""
    assert forward_digests(fa, card) == FORWARD_DIGESTS
