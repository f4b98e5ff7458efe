"""The port's differentiable flash attention on the CPU.

``FlashAttentionFunction`` (forward through the K1 wrapper, backward
through the K2/K3 wrapper, plain versions for CPU tensors) against
torch.autograd through the plain forward, and the wrappers' checks of
seeds, shapes and launch counts. The plain versions themselves are held
against the Pallas kernels in ``tests/test_torch_flash_backward.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa


def _inputs(b, sq, sk, h, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, sq, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sq, h, d).astype(np.float32))


def test_autograd_function_matches_plain_autograd_on_cpu():
    """``FlashAttentionFunction`` (backward through the K2/K3 wrappers)
    gives the gradients torch.autograd finds through the plain forward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 48, 48, 3, 16, 3))
    seed = torch.tensor([9], dtype=torch.int32)
    for dropout in (0.0, 0.2):
        grads = []
        for use_function in (True, False):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            if use_function:
                out = fa.flash_attention_value(*leaves, True, 0.25, dropout,
                                               seed, block_q=16, block_k=32,
                                               device="cpu")
            else:
                out, _ = fa.flash_attention_fwd_reference(
                    *leaves, True, 0.25, dropout, seed, block_q=16,
                    block_k=32)
            (out * do).sum().backward()
            grads.append([t.grad for t in leaves])
        for name, got, want in zip(("dq", "dk", "dv"), *grads):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5,
                                       msg=f"{name} at dropout {dropout}")


def test_wrappers_check_seed_and_devices():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 1, 16))
    with pytest.raises(ValueError, match="needs a seed"):
        fa.flash_attention_fwd(q, k, v, True, 0.25, dropout=0.1,
                               device="cpu")
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention_value(q, k, v, True, 0.25, 0.1,
                                 torch.tensor([1]), device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        fa.flash_attention_fwd(q, k, v, True, 0.25, dropout=1.0,
                               seed=torch.zeros(1, dtype=torch.int32),
                               device="cpu")
    with pytest.raises(ValueError, match="must have q's shape"):
        fa.flash_attention_bwd(q, k, v, q[:, :8], None, do, None, True,
                               0.25, device="cpu")
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
    o, lse = fa.flash_attention_fwd(q, k, v, True, 0.25, device="cpu")
    fa.flash_attention_bwd(q, k, v, o, lse, do, None, True, 0.25,
                           device="cpu")
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == counts
