"""The port's AMP O1 and float16 against the JAX package's, on the CPU.

- O1 op classes: every op name the port's functionals pass to
  ``cast_inputs`` computes in the AMP dtype exactly where JAX's
  ``white_list()`` has it, in f32 where ``black_list()`` has it, and in its
  inputs' dtype otherwise; custom lists move an op as in JAX.
- ``gpt_tiny`` under ``auto_cast(level="O1", dtype="float16")`` (f32
  parameters): the loss within 5e-3 relative of JAX's, whose fp16 matmuls
  and attention round at other places.
- ``GradScaler``: JAX's ``test_grad_scaler_skips_inf_step`` case, and a
  10-step stream with forced overflows through SGD, Momentum (snapshot and
  select) and AdamW (the skip inside the AdamW update), f32 and bf16
  parameters: parameters bit for bit (f32 SGD and Momentum within 1e-6
  relative), and the scale, good and bad counts equal after every step;
  ``state_dict`` round trip; the unscaled gradients f32, as jnp promotes
  them; ``check_finite_and_unscale`` and ``update_loss_scaling`` against
  JAX's.
- The float16 plain versions of K1–K3 (what the wrappers run for CPU
  tensors) against the Pallas kernels in interpret mode on fp16 inputs,
  within 2e-3 absolute plus 2^-9 of the value: the Pallas kernels round P
  to fp16 before P·V, the plain versions keep f32, and fp16's step is
  2^-10 of the value.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.amp import amp_lists as jax_lists
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.ops.pallas.flash_attention import _flash_bwd, _flash_fwd
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.amp.auto_cast import AmpState
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         load_jax_state)
from paddle_tpu_torch.ops.cuda import flash_attention as fa

# the op names the port's functionals cast under (grep cast_inputs)
PORT_OPS = ("linear", "layer_norm", "pallas_rms_norm", "rms_norm",
            "cross_entropy", "swiglu", "fused_rope", "flash_attention",
            "sdpa_flash", "flash_attn_unpadded", "flashmask_attention",
            "calc_reduced_attn_scores", "fused_softmax_mask",
            "fused_softmax_mask_upper_triangle", "embedding", "gelu", "tanh",
            "sdpa_xla", "flash_attention_xla", "add", "subtract", "relu",
            "conv1d", "conv2d", "conv3d", "max_pool2d", "avg_pool2d",
            "adaptive_avg_pool2d", "batch_norm", "batch_norm_infer",
            "concat", "stack", "reshape", "transpose", "mean", "max",
            "multiply", "sigmoid", "silu", "softplus", "relu6",
            "interpolate", "adaptive_avg_pool1d", "adaptive_avg_pool3d",
            "adaptive_max_pool1d", "adaptive_max_pool2d",
            "adaptive_max_pool3d", "bce_with_logits")


@pytest.mark.parametrize("op", PORT_OPS)
def test_o1_op_class_matches_jax_lists(op):
    white, black = jax_lists.white_list(), jax_lists.black_list()
    want = ("white" if op in white else "black" if op in black else "gray")
    state = AmpState("O1", "float16")
    got = {torch.float16: "white", torch.float32: "black",
           None: "gray"}[state.target(op)]
    assert got == want
    # O2: everything but the black list in the AMP dtype
    o2 = AmpState("O2", "bfloat16").target(op)
    assert o2 == (torch.float32 if want == "black" else torch.bfloat16)


def test_o1_casts_custom_lists_and_state():
    x = torch.ones(2, 3)
    h = x.half()
    with amp.auto_cast(level="O1", dtype="float16"):
        assert amp.is_auto_cast_enabled()
        assert amp.get_amp_dtype() == "float16"
        from paddle_tpu_torch.amp.auto_cast import cast_inputs
        assert cast_inputs("linear", x)[0].dtype == torch.float16
        assert cast_inputs("layer_norm", h)[0].dtype == torch.float32
        assert cast_inputs("swiglu", x)[0].dtype == torch.float32
        assert cast_inputs("swiglu", h)[0].dtype == torch.float16
        assert cast_inputs("dropout", x)[0] is x
    assert not amp.is_auto_cast_enabled() and amp.get_amp_dtype() == "float32"
    with amp.auto_cast(level="O1", dtype="float16",
                       custom_white_list={"swiglu"},
                       custom_black_list={"linear"}):
        from paddle_tpu_torch.amp.auto_cast import cast_inputs
        assert cast_inputs("swiglu", x)[0].dtype == torch.float16
        assert cast_inputs("linear", h)[0].dtype == torch.float32
    with pytest.raises(ValueError, match="level"):
        with amp.auto_cast(level="O3"):
            pass
    with pytest.raises(ValueError, match="dtype"):
        AmpState("O1", "float64")
    # O2 decorate in float16
    model = torch.nn.Linear(3, 2)
    assert amp.decorate(model, level="O2", dtype="float16",
                        device="cpu") is model
    assert model.weight.dtype == torch.float16
    # O1 decorate leaves the parameters f32
    other = torch.nn.Linear(3, 2)
    amp.decorate(other, level="O1", dtype="float16", device="cpu")
    assert other.weight.dtype == torch.float32


def test_gpt_tiny_o1_float16_loss_matches_jax():
    ids = np.random.RandomState(1).randint(0, 512, (2, 16)).astype(np.int64)
    paddle.seed(0)
    cfg = jax_gpt_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    jmodel = JaxGPT(cfg)
    state = {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}
    # the criterion inside the region: cross_entropy is black, f32
    with paddle.amp.auto_cast(level="O1", dtype="float16"):
        jlogits = jmodel(paddle.to_tensor(ids))
        jloss = JaxCriterion(cfg)(jlogits, paddle.to_tensor(ids))
    want = float(np.asarray(jloss.numpy()))
    pcfg = gpt_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model = GPTForCausalLM(pcfg, device="cpu")
    load_jax_state(model, state)
    with amp.auto_cast(level="O1", dtype="float16"):
        logits = model(torch.from_numpy(ids))
        loss = GPTPretrainingCriterion(pcfg)(logits, torch.from_numpy(ids))
    assert logits.dtype == torch.float16  # the head is a white linear
    assert str(np.asarray(jlogits.numpy()).dtype) == "float16"
    assert loss.dtype == torch.float32
    assert str(np.asarray(jloss.numpy()).dtype) == "float32"
    assert float(loss.detach()) == pytest.approx(want, rel=5e-3)


# ------------------------------------------------------------ GradScaler
def test_grad_scaler_skips_inf_step_as_jax():
    """``tests/test_jit_amp.py::test_grad_scaler_skips_inf_step``."""
    p = torch.nn.Parameter(torch.ones(2))
    o = optimizer.SGD(0.1, parameters=[p], device="cpu")
    scaler = amp.GradScaler(init_loss_scaling=4.0, decr_every_n_nan_or_inf=1,
                            device="cpu")
    p.grad = torch.tensor([math.inf, 1.0])
    scaler.step(o)
    scaler.update()
    np.testing.assert_allclose(p.detach().numpy(), [1.0, 1.0])
    assert float(scaler.get_loss_scaling()) == pytest.approx(2.0)
    scaler.update()  # idempotent between steps
    assert float(scaler.get_loss_scaling()) == pytest.approx(2.0)
    assert int(o._step_tensor) == 0  # the step count reverted too


STREAM = 10
OVERFLOW_AT = {1, 2, 6}


def _stream_inputs():
    rs = np.random.RandomState(4)
    w0 = [rs.randn(5, 3).astype(np.float32), rs.randn(4).astype(np.float32)]
    grads = []
    for i in range(STREAM):
        gs = [(rs.randn(*w.shape) * 8).astype(np.float32) for w in w0]
        if i in OVERFLOW_AT:
            gs[i % 2].flat[i] = np.inf if i != 6 else np.nan
        grads.append(gs)
    return w0, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("opt_name,kw", [
    ("SGD", {}), ("Momentum", dict(momentum=0.9)),
    ("AdamW", dict(weight_decay=0.1, amsgrad=True))],
    ids=["SGD", "Momentum", "AdamW"])
def test_grad_scaler_stream_matches_jax(opt_name, kw, dtype):
    w0, grads = _stream_inputs()
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    sk = dict(init_loss_scaling=8.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    jps = [JaxParameter(jnp.asarray(w, jd)) for w in w0]
    jopt = getattr(paddle.optimizer, opt_name)(learning_rate=0.01,
                                               parameters=jps, **kw)
    jscaler = paddle.amp.GradScaler(**sk)
    tps = [torch.nn.Parameter(torch.from_numpy(w.copy()).to(dtype))
           for w in w0]
    topt = getattr(optimizer, opt_name)(learning_rate=0.01, parameters=tps,
                                        device="cpu", **kw)
    tscaler = amp.GradScaler(**sk, device="cpu")
    for i, gs in enumerate(grads):
        for jp, tp, g in zip(jps, tps, gs):
            jp._grad = paddle.Tensor(jnp.asarray(g, jd))
            tp.grad = torch.from_numpy(g).to(dtype)
        jopt._lr_override = jnp.asarray(0.01, jnp.float32)
        jscaler.step(jopt)
        jopt._lr_override = None
        tscaler.step(topt)
        if i == 0:
            # the unscaled gradients are f32 whatever the parameter's dtype
            assert all(topt._grad_of(p).dtype == torch.float32 for p in tps)
        jscaler.update()
        tscaler.update()
        jopt.clear_grad()
        topt.clear_grad()
        assert bool(tscaler._found_inf) == (i in OVERFLOW_AT)
        for name in ("_scale", "_good_steps", "_bad_steps"):
            assert float(getattr(tscaler, name)) == float(np.asarray(
                getattr(jscaler, name).numpy())), (i, name)
        assert int(topt._step_tensor) == int(np.asarray(
            jopt._step_tensor.numpy())), i
        for jp, tp in zip(jps, tps):
            got = tp.detach().float().numpy()
            want = np.asarray(jp._value.astype(jnp.float32))
            if dtype == torch.float32 and opt_name != "AdamW":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            else:
                np.testing.assert_array_equal(got, want, err_msg=str(i))
    state = tscaler.state_dict()
    fresh = amp.GradScaler(device="cpu")
    fresh.load_state_dict(state)
    for name in ("_scale", "_good_steps", "_bad_steps"):
        assert torch.equal(getattr(fresh, name), getattr(tscaler, name))


def test_check_finite_and_update_loss_scaling_match_jax():
    xs = [np.array([1.0, 2.0], np.float32), np.array([np.inf], np.float32)]
    jouts, jfound = paddle.amp.grad_scaler.check_finite_and_unscale(
        [paddle.to_tensor(x) for x in xs], paddle.to_tensor(np.float32(4.0)))
    outs, found = amp.check_finite_and_unscale(
        [torch.from_numpy(x) for x in xs], torch.tensor(4.0))
    assert bool(found) and bool(np.asarray(jfound.numpy())[0])
    for o, jo in zip(outs, jouts):
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo.numpy()))
    for flag in (True, False):
        args = ([torch.ones(2)], torch.tensor([flag]), torch.tensor([8.0]),
                torch.tensor([1], dtype=torch.int32),
                torch.tensor([1], dtype=torch.int32))
        jargs = ([paddle.to_tensor(np.ones(2, np.float32))],
                 paddle.to_tensor(np.array([flag])),
                 paddle.to_tensor(np.array([8.0], np.float32)),
                 paddle.to_tensor(np.array([1], np.int32)),
                 paddle.to_tensor(np.array([1], np.int32)))
        kw = dict(incr_every_n_steps=2, decr_every_n_nan_or_inf=2)
        got = amp.update_loss_scaling(*args, **kw)
        want = paddle.amp.grad_scaler.update_loss_scaling(*jargs, **kw)
        np.testing.assert_array_equal(got[0][0].numpy(),
                                      np.asarray(want[0][0].numpy()))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w.numpy()))


# ------------------------------------------------ K1-K3 plain, float16
@pytest.mark.parametrize("causal,dropout", [(True, 0.0), (False, 0.0),
                                            (True, 0.3)])
def test_fp16_plain_k1_k3_match_pallas_interpret(causal, dropout):
    rs = np.random.RandomState(2)
    b, s, h, d = 1, 128, 2, 32
    q, k, v, do = (rs.randn(b, s, h, d).astype(np.float16) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    tiles = {"block_q": 64, "block_k": 64}
    jseed = jnp.asarray([9], jnp.int32)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o_ref, lse_ref = _flash_fwd(jq, jk, jv, jseed, causal, scale, dropout,
                                interpret=True, **tiles)
    assert o_ref.dtype == jnp.float16
    grads_ref = _flash_bwd(jq, jk, jv, o_ref, lse_ref, jdo, jseed, causal,
                           scale, dropout, interpret=True, **tiles)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tseed = torch.tensor([9], dtype=torch.int32)
    o, lse = fa.flash_attention_fwd(tq, tk, tv, causal, scale, dropout, tseed,
                                    device="cpu", **tiles)
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    tol = dict(rtol=2.0 ** -9, atol=2e-3)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_ref).astype(np.float32), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=1e-5,
                               atol=1e-5)
    got = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, tseed, causal,
                                 scale, dropout, device="cpu", **tiles)
    for name, g, w in zip(("dq", "dk", "dv"), got, grads_ref):
        assert g.dtype == torch.float16, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w).astype(np.float32),
                                   err_msg=name, **tol)
