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


#: sha256 (first 16 hex digits) of O and lse from the f32 forward kernel as
#: it was before in-kernel dropout (commit 6d46396), on an H100, at the
#: inputs of :func:`forward_digests`. The bf16 digests of that kernel are
#: gone with its bf16 instantiation: bf16 runs on the tensor-core kernel,
#: which rounds P to bf16 and so gives other bits.
FORWARD_DIGESTS = {
    "float32/D=16/causal=1": "f707ea07faa3d0ec",
    "float32/D=16/causal=0": "3243ba35301de912",
    "float32/D=64/causal=1": "7573477046ddcf79",
    "float32/D=64/causal=0": "d646096308a2a661",
    "float32/D=128/causal=1": "6ca4ee632ca7bd78",
    "float32/D=128/causal=0": "3ffbd375e29c8a31",
}


def forward_digests(module, device):
    """Digests of the f32 forward's outputs at fixed inputs, by (D,
    causal); ``module`` is the wrapper module to run."""
    out = {}
    for dtype in (torch.float32,):
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
    """In-kernel dropout is a template parameter of the f32 forward kernel;
    the instantiation without it gives the same bits as the kernel before,
    and so does the f32 kernel now that bf16 has a kernel of its own. The
    six bf16 digests were dropped with the bf16 instantiation they pinned:
    the tensor-core kernel that replaced it rounds P to bf16."""
    assert forward_digests(fa, card) == FORWARD_DIGESTS
