"""The port's RMSNorm (K4's plain version, its gradient and the functional)
against the JAX package.

- K4's plain version, :func:`rms_norm_reference` (what the wrapper runs for
  CPU tensors), against the Pallas ``_rms_norm_fwd`` in interpret mode:
  f32 within 1e-5 of each row's largest output; bf16 within one bf16 step
  (2⁻⁷ of the value) plus 1e-3, since both round an f32 result once;
- ``RMSNormFunction``'s dx and dw against ``jax.vjp`` of the Pallas
  ``rms_norm_value`` (interpret mode): f32 within 1e-5 relative to each
  gradient's max;
- the backward kernel's plain version, :func:`rms_norm_bwd_reference`,
  against the same ``jax.vjp`` for f32 and bf16 x with f32 and bf16 w, a
  3-D x, an odd d and d = 4096: f32 within 1e-5 of each gradient's max,
  bf16 within one bf16 step (2⁻⁷ of the value) plus 1e-3;
- a torch emulation of the backward kernel's arithmetic (mean(g·w·xn) as
  inv·Σ(g·w·x)/d) and of its fixed order of summing dw (each warp over its
  rows, the 8 warps of a block in a tree, then the blocks' partials in a
  second launch) against the JAX vjp at 2048 × 768, within the card's f32
  gate of 1e-5 of each gradient's max;
- ``F.rms_norm`` under AMP O2: with a weight it is op ``pallas_rms_norm``
  (white list, bf16 out), as on the TPU; without one op ``rms_norm`` (black
  list, f32 out), the JAX fallback. The JAX side runs with the Pallas route
  forced (``rms_norm.available`` patched to True, so the kernel runs in
  interpret mode); values agree within the tolerances above.

The CUDA kernels themselves are held against the plain versions on the
card (``tests/test_torch_cuda_llama.py``, ``chip_smoke.py``).
"""
import math

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


# (shape, x dtype, w dtype): each pairing of types, a 3-D x with an odd d,
# and Llama-2/3's width at a few rows
BWD_CASES = [((64, 96), "float32", "float32"),
             ((64, 96), "bfloat16", "bfloat16"),
             ((7, 100), "float32", "bfloat16"),
             ((7, 100), "bfloat16", "float32"),
             ((3, 5, 33), "float32", "float32"),
             ((3, 5, 33), "bfloat16", "bfloat16"),
             ((3, 4096), "float32", "float32"),
             ((3, 4096), "bfloat16", "bfloat16")]


def _jax_vjp(x, w, g, x_dtype, w_dtype):
    """dx, dw of the Pallas ``rms_norm_value`` (interpret mode), as f32
    numpy arrays, with the inputs rounded to their dtypes."""
    jx = jnp.asarray(x, x_dtype)
    jw = jnp.asarray(w, w_dtype)
    _, vjp = jax.vjp(lambda a, b: jax_rms.rms_norm_value(
        a, b, EPS, interpret=True), jx, jw)
    dx, dw = vjp(jnp.asarray(g, x_dtype))
    assert dx.dtype == jx.dtype and dw.dtype == jw.dtype
    return np.asarray(dx, np.float32), np.asarray(dw, np.float32)


def _grad_close(got, want, dtype):
    """f32 within 1e-5 of the gradient's max; bf16 within one bf16 step
    plus 1e-3."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    if dtype == "float32":
        return bool((err <= 1e-5 * np.abs(want).max()).all())
    return bool((err <= 2.0 ** -7 * np.abs(want) + 1e-3).all())


@pytest.mark.parametrize("shape,x_dtype,w_dtype", BWD_CASES)
def test_bwd_plain_version_matches_jax_vjp(shape, x_dtype, w_dtype):
    x, w = _inputs(shape, seed=4)
    g = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want_dx, want_dw = _jax_vjp(x, w, g, x_dtype, w_dtype)
    tx, tg = (torch.from_numpy(a).to(getattr(torch, x_dtype)) for a in (x, g))
    tw = torch.from_numpy(w).to(getattr(torch, w_dtype))
    dx, dw = rms.rms_norm_bwd_reference(tx, tw, tg, EPS)
    assert dx.dtype == tx.dtype and dx.shape == tx.shape
    assert dw.dtype == tw.dtype and dw.shape == tw.shape
    assert _grad_close(dx.float().numpy(), want_dx, x_dtype), shape
    assert _grad_close(dw.float().numpy(), want_dw, w_dtype), shape
    # the CPU wrapper is the plain version
    for got, want in zip(rms.rms_norm_bwd(tx, tw, tg, EPS, device="cpu"),
                         (dx, dw)):
        assert torch.equal(got, want)


def _balanced_grid(groups, cap):
    if groups <= cap:
        return groups
    per = -(-groups // cap)
    return -(-groups // per)


def _kernel_bwd_emulation(x, w, g, eps, sm_count, blocks_per_sm=2, warps=8,
                          dw_warps=32):
    """dx and dw as the backward kernel computes them on the warp-a-row
    path, in f32 torch: the row sums Σx² and Σ(g·w·x), mean(g·w·xn) as
    inv·Σ(g·w·x)/d; dw summed in the kernel's order — warp j of the grid
    takes rows j, j + W, j + 2W, ... (W warps in all) in order, the 8
    warps of a block meet in the tree w0+w4, w1+w5, w2+w6, w3+w7, w0+w2,
    w1+w3, w0+w1, and the second launch's warp k sums blocks k, k + 32,
    ... in order before the 32 warp sums are added in order."""
    d = x.shape[-1]
    xf, gf = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    wf = w.float()
    rows = xf.shape[0]
    inv = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / d + eps)
    m = inv * (gf * wf * xf).sum(-1, keepdim=True) / d
    xn = xf * inv
    dx = inv * (gf * wf - xn * m)
    blocks = _balanced_grid(-(-rows // warps),
                            min(rows, blocks_per_sm * sm_count))
    n_warps = blocks * warps
    acc = torch.zeros(n_warps, d)
    for r0 in range(0, rows, n_warps):
        chunk = gf[r0:r0 + n_warps] * xn[r0:r0 + n_warps]
        acc[:chunk.shape[0]] = acc[:chunk.shape[0]] + chunk
    acc = acc.view(blocks, warps, d)
    half = warps // 2
    while half:
        acc[:, :half] = acc[:, :half] + acc[:, half:2 * half]
        half //= 2
    partial = acc[:, 0]
    sums = torch.zeros(dw_warps, d)
    for b0 in range(0, blocks, dw_warps):
        chunk = partial[b0:b0 + dw_warps]
        sums[:chunk.shape[0]] = sums[:chunk.shape[0]] + chunk
    dw = torch.zeros(d)
    for k in range(dw_warps):
        dw = dw + sums[k]
    return dx.to(x.dtype).reshape(x.shape), dw.to(w.dtype), blocks


@pytest.mark.parametrize("sm_count", [132, 16])
def test_kernel_dw_order_emulation_matches_jax_vjp(sm_count):
    """132 SMs (the H100 SXM): 256 blocks, a row a warp; 16 SMs: 32 blocks,
    8 rows a warp."""
    shape = (2048, 768)
    x, w = _inputs(shape, seed=6)
    g = np.random.RandomState(7).randn(*shape).astype(np.float32)
    want_dx, want_dw = _jax_vjp(x, w, g, "float32", "float32")
    dx, dw, blocks = _kernel_bwd_emulation(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g), EPS,
        sm_count)
    assert blocks == {132: 256, 16: 32}[sm_count]
    assert math.isfinite(float(dw.abs().max()))
    assert _grad_close(dx.numpy(), want_dx, "float32")
    assert _grad_close(dw.numpy(), want_dw, "float32")


def test_cpu_bwd_wrapper_counts_no_launch_and_rejects_a_cuda_request():
    x, w = _inputs((4, 16))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tg = torch.ones_like(tx)
    before = rms.bwd_launches
    rms.rms_norm_bwd(tx, tw, tg, EPS, device="cpu")
    rms.rms_norm_value(tx.clone().requires_grad_(True), tw, EPS,
                       device="cpu").sum().backward()
    assert rms.bwd_launches == before
    with pytest.raises((RuntimeError, ValueError)):
        rms.rms_norm_bwd(tx, tw, tg, EPS, device="cuda")
    with pytest.raises(ValueError, match="g must"):
        rms.rms_norm_bwd(tx, tw, tg[:2], EPS, device="cpu")
