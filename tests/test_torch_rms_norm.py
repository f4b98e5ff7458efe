"""The port's RMSNorm (K4's plain version, its gradient and the functional)
against the JAX package.

- K4's plain version, :func:`rms_norm_reference` (what the wrapper runs for
  CPU tensors), against the Pallas ``_rms_norm_fwd`` in interpret mode:
  f32 within 1e-5 of each row's largest output; bf16 within one bf16 step
  (2⁻⁷ of the value) plus 1e-3, since both round an f32 result once;
- ``RMSNormFunction``'s dx and dw against ``jax.vjp`` of the Pallas
  ``rms_norm_value`` (interpret mode): f32 within 1e-5 relative to each
  gradient's max;
- ``F.rms_norm`` under AMP O2: with a weight it is op ``pallas_rms_norm``
  (white list, bf16 out), as on the TPU; without one op ``rms_norm`` (black
  list, f32 out), the JAX fallback. The JAX side runs with the Pallas route
  forced (``rms_norm.available`` patched to True, so the kernel runs in
  interpret mode); values agree within the tolerances above.

The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_cuda_llama.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import rms_norm as jax_rms
from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import RMSNorm
from paddle_tpu_torch.ops.cuda import rms_norm as rms

EPS = 1e-5
# [..., d] shapes: the training rows at a narrow width, an odd d, a ragged
# row count, 3-D input, and Llama-2/3's width
SHAPES = [(64, 96), (7, 100), (3, 5, 33), (2, 4096)]


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 2).astype(np.float32)
    w = rs.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    return x, w


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    if dtype == "float32":
        top = np.abs(want).max(axis=-1, keepdims=True)
        return bool((err <= 1e-5 * top).all())
    return bool((err <= 2.0 ** -7 * np.abs(want) + 1e-3).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(dtype):
    for shape in SHAPES:
        x, w = _inputs(shape)
        want = jax_rms._rms_norm_fwd(jnp.asarray(x, dtype),
                                     jnp.asarray(w, dtype), eps=EPS,
                                     interpret=True)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        tw = torch.from_numpy(w).to(getattr(torch, dtype))
        got = rms.rms_norm_reference(tx, tw, EPS)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        assert _close(got.float().numpy(), np.asarray(want, np.float32),
                      dtype), (shape, dtype)


def test_gradient_matches_jax_vjp():
    for shape in SHAPES[:3]:
        x, w = _inputs(shape, seed=1)
        g = np.random.RandomState(2).randn(*shape).astype(np.float32)
        _, vjp = jax.vjp(lambda a, b: jax_rms.rms_norm_value(
            a, b, EPS, interpret=True), jnp.asarray(x), jnp.asarray(w))
        want_dx, want_dw = (np.asarray(t) for t in vjp(jnp.asarray(g)))
        tx = torch.from_numpy(x).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        rms.rms_norm_value(tx, tw, EPS, device="cpu").backward(
            torch.from_numpy(g))
        for got, want in ((tx.grad, want_dx), (tw.grad, want_dw)):
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (shape, err)
    # bf16 in, bf16 gradients out, as the JAX _bwd casts them
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    tw = torch.from_numpy(w).bfloat16().requires_grad_(True)
    rms.RMSNormFunction.apply(tx, tw, EPS).float().sum().backward()
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16


def test_cpu_wrapper_counts_no_launch_and_rejects_a_cuda_request():
    x, w = _inputs((4, 16))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    before = rms.launches
    out = rms.rms_norm_fwd(tx, tw, EPS, device="cpu")
    rms.rms_norm_value(tx.requires_grad_(True), tw, EPS,
                       device="cpu").sum().backward()
    assert rms.launches == before
    assert torch.equal(out, rms.rms_norm_reference(tx, tw, EPS))
    # CPU tensors with a CUDA request: no CUDA device here, and on a host
    # with one the tensors lie elsewhere; either way it raises
    for fn in (rms.rms_norm_fwd, rms.rms_norm_value):
        with pytest.raises((RuntimeError, ValueError)):
            fn(tx, tw, EPS, device="cuda")
    with pytest.raises(ValueError, match="w"):
        rms.rms_norm_fwd(tx, tw[:8], EPS, device="cpu")


def test_functional_op_names_under_o2(monkeypatch):
    monkeypatch.setattr(jax_rms, "available", lambda: True)
    x, w = _inputs((2, 6, 64), seed=3)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx, jw = paddle.to_tensor(x), paddle.to_tensor(w)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        got_w = F.rms_norm(tx, tw, EPS)
        got_n = F.rms_norm(tx, None, EPS)
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        want_w = paddle.nn.functional.rms_norm(jx, jw, EPS)
        want_n = paddle.nn.functional.rms_norm(jx, None, EPS)
    # with a weight: the kernel route, white-listed, bf16 in both packages
    assert got_w.dtype == torch.bfloat16
    assert str(want_w.numpy().dtype) == "bfloat16"
    assert _close(got_w.float().numpy(),
                  np.asarray(want_w.numpy(), np.float32), "bfloat16")
    # without: the black-listed fallback, f32 in both
    assert got_n.dtype == torch.float32
    assert want_n.numpy().dtype == np.float32
    assert _close(got_n.numpy(), want_n.numpy(), "float32")
    # outside AMP the result keeps x's dtype; the layer is the functional
    layer = RMSNorm(64, epsilon=EPS)
    assert torch.equal(layer.weight, torch.ones(64))
    out = layer(tx.bfloat16())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, F.rms_norm(tx.bfloat16(), torch.ones(64), EPS))
