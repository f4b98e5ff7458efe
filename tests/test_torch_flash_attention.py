"""The port's flash-attention forward against the Pallas kernel.

The plain PyTorch version (what the wrapper runs for CPU tensors) is held
against ``_flash_fwd`` in interpret mode, for both O and lse, at the f32
tolerance of ``tests/test_pallas_backward.py`` (2e-4). The CUDA kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); the backward and the
dropout hash are in ``tests/test_torch_flash_backward.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _flash_fwd
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.cuda import flash_attention as fa

TOL = 2e-4


def _qkv(b, sq, sk, h, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, sq, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32))


@pytest.mark.parametrize("sq,sk,causal", [
    (128, 128, True), (128, 128, False),
    (64, 128, True),  # top-left causal alignment, as the kernel masks
])
def test_plain_matches_pallas_interpret(sq, sk, causal):
    for d in (16, 32):
        q, k, v = _qkv(2, sq, sk, 2, d)
        scale = 1.0 / math.sqrt(d)
        o_ref, lse_ref = _flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v),
                                    jnp.zeros((1,), jnp.int32), causal,
                                    scale, interpret=True)
        o, lse = fa.flash_attention_fwd(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal, scale, device="cpu")
        assert o.shape == (2, sq, 2, d) and o.dtype == torch.float32
        assert lse.shape == (2, 2, 1, sq) and lse.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=TOL,
                                   atol=TOL, err_msg=f"O at D={d}")
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"lse at D={d}")


def test_cpu_wrapper_counts_no_launch_and_rejects_dropout():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 16, 1, 16))
    fa.flash_attention_fwd(q, k, v, True, 0.25, device="cpu")
    # dropout runs on the CPU through the plain version, given its seed
    seed = torch.tensor([3], dtype=torch.int32)
    o, _ = fa.flash_attention_fwd(q, k, v, True, 0.25, dropout=0.5,
                                  seed=seed, device="cpu")
    assert bool(torch.isfinite(o).all()) and fa.launches == 0
    with pytest.raises(ValueError, match="needs a seed"):
        fa.flash_attention_fwd(q, k, v, True, 0.25, dropout=0.1,
                               device="cpu")
    with pytest.raises(ValueError, match="asked for"):
        fa.flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"),
                               True, 0.25, device="cpu")


def test_sdpa_matches_jax_functional():
    """``F.scaled_dot_product_attention`` of both packages (causal,
    Sq == Sk, the case the GPT attention reaches)."""
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF

    q, k, v = _qkv(2, 32, 32, 2, 16, seed=1)
    ref = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        is_causal=True, training=False)
    out = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=True, training=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.numpy()),
                               rtol=TOL, atol=TOL)
    # dropout applies only in training: in eval mode the JAX result holds
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    evaluated = TF.scaled_dot_product_attention(
        *args, dropout_p=0.1, is_causal=True, training=False)
    np.testing.assert_allclose(evaluated.numpy(), np.asarray(ref.numpy()),
                               rtol=TOL, atol=TOL)
    dropped = TF.scaled_dot_product_attention(
        *args, dropout_p=0.1, is_causal=True, training=True,
        generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(dropped).all())
    assert float((dropped - evaluated).abs().max()) > 1e-3
