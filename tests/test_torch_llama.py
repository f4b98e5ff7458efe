"""The port's Llama against the JAX package's, on the CPU.

- RoPE (neox and interleaved, built or given sin/cos, with and without
  ``position_ids``) and swiglu (split-in-half and (x, y)) against the JAX
  functions: f32 within 1e-5 (the two packages' sin/cos may differ in the
  last ulp at angles up to S radians);
- ``llama_tiny`` logits with the JAX weights carried across by
  ``load_jax_state``: GQA, MHA and MQA, tied and untied LM heads, f32 within
  1e-4, against both JAX RMSNorm routes (the XLA fallback and the Pallas
  kernel in interpret mode), whose math is the same in f32;
- ``TrainStep`` + ``AdamW(1e-3)`` + ``LlamaPretrainingCriterion``, 3 steps
  on one fixed 4 × 32 batch: in f32 (the JAX default route) the losses and
  the parameters after the steps within ``rtol=1e-4, atol=1e-5``, as
  ``tests/test_torch_train.py`` holds GPT; in bf16 O2 (``amp.decorate`` +
  ``auto_cast`` around the model, the criterion outside it, as
  ``bench.py``'s ``bench_llama`` runs it) with the JAX Pallas RMSNorm route
  forced — the route the port matches — within 2e-2, relative for the
  losses (both round parameters and activations to bf16, at places that
  differ by an ulp). The f32 carve-out of ``test_torch_train.py`` for
  first gradients under 100× Adam's epsilon applies here too;
- the parallel layouts the port does not build raise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.ops import activation as jax_act
from paddle_tpu.ops import fused_ops as jax_fused
from paddle_tpu.ops.pallas import rms_norm as jax_rms
from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_tiny, load_jax_state)
from paddle_tpu_torch.ops.activation import swiglu
from paddle_tpu_torch.ops.fused_ops import fused_rotary_position_embedding
from paddle_tpu_torch.optimizer import AdamW

STEPS, LR = 3, 1e-3


def _np(t):
    return np.asarray(t.numpy()).astype(np.float32)


def _jax_state(model):
    # copies: the JAX step donates (and overwrites) the parameter buffers
    return {k: np.array(v.numpy(), copy=True)
            for k, v in model.state_dict().items()}


def test_rope_and_swiglu_match_jax():
    rs = np.random.RandomState(0)
    b, s, d = 2, 16, 8
    q = rs.randn(b, s, 4, d).astype(np.float32)
    k = rs.randn(b, s, 2, d).astype(np.float32)
    pos = np.stack([rs.permutation(s) for _ in range(b)]).astype(np.int64)
    ang = rs.uniform(0, 6, (s, d)).astype(np.float32)
    sin, cos = np.sin(ang), np.cos(ang)
    cases = [dict(), dict(position_ids=pos), dict(sin=sin, cos=cos),
             dict(sin=sin, cos=cos, position_ids=pos)]
    for neox in (True, False):
        for kw in cases:
            want = jax_fused.fused_rotary_position_embedding(
                paddle.to_tensor(q), paddle.to_tensor(k), None,
                use_neox_rotary_style=neox, rotary_emb_base=500.0,
                **{n: paddle.to_tensor(v) for n, v in kw.items()})
            got = fused_rotary_position_embedding(
                torch.from_numpy(q), torch.from_numpy(k), None,
                use_neox_rotary_style=neox, rotary_emb_base=500.0,
                **{n: torch.from_numpy(v) for n, v in kw.items()})
            assert got[2] is None and want[2] is None
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5,
                                           atol=1e-5, err_msg=str((neox, kw)))
    # under O2 RoPE is gray: bf16 out
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        (q16, _, _) = fused_rotary_position_embedding(torch.from_numpy(q))
    assert q16.dtype == torch.bfloat16
    x = rs.randn(3, 10).astype(np.float32)
    y = rs.randn(3, 5).astype(np.float32)
    np.testing.assert_allclose(swiglu(torch.from_numpy(x)).numpy(),
                               _np(jax_act.swiglu(paddle.to_tensor(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        swiglu(torch.from_numpy(x[:, :5]), torch.from_numpy(y)).numpy(),
        _np(jax_act.swiglu(paddle.to_tensor(x[:, :5]), paddle.to_tensor(y))),
        rtol=1e-6, atol=1e-6)


def test_logits_match_jax(monkeypatch):
    ids = np.random.RandomState(0).randint(0, 512, (2, 24))
    # GQA (2 KV heads), MHA (4) and MQA (1), tied and untied
    for kv, tied in ((2, False), (2, True), (4, False), (4, True),
                     (1, True)):
        cfg = dict(num_key_value_heads=kv, tie_word_embeddings=tied)
        paddle.seed(0)
        ref = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny(**cfg))
        ref.eval()
        model = LlamaForCausalLM(llama_tiny(**cfg), device="cpu")
        load_jax_state(model, _jax_state(ref)).eval()
        with torch.no_grad():
            got = model(torch.from_numpy(ids)).numpy()
        assert got.shape == (2, 24, 512)
        jids = paddle.to_tensor(ids.astype(np.int64))
        for pallas in (False, True):
            monkeypatch.setattr(jax_rms, "available", lambda p=pallas: p)
            want = _np(ref(jids))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=str((cfg, pallas)))


def _jax_run(o2, ids):
    paddle.seed(0)
    cfg = jax_llama.llama_tiny()
    model = jax_llama.LlamaForCausalLM(cfg)
    state = _jax_state(model)
    crit = jax_llama.LlamaPretrainingCriterion(cfg)
    if o2:
        paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters())

    def loss_fn(x):
        if o2:
            with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
                logits = model(x)
        else:
            logits = model(x)
        return crit(logits, x)

    step = JaxTrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    x = paddle.Tensor(ids, stop_gradient=True)
    losses = [float(_np(step(x))) for _ in range(STEPS)]
    params = {k: _np(v) for k, v in model.state_dict().items()}
    return state, losses, params


def _port_run(o2, ids, state):
    cfg = llama_tiny()
    model = LlamaForCausalLM(cfg, device="cpu")
    load_jax_state(model, state).train()
    crit = LlamaPretrainingCriterion(cfg)
    if o2:
        amp.decorate(model, level="O2", dtype="bfloat16", device="cpu")
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                device="cpu")

    def loss_fn(x):
        if o2:
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                logits = model(x)
        else:
            logits = model(x)
        return crit(logits, x)

    x = torch.from_numpy(ids)
    loss_fn(x).backward()
    first_grads = {n: p.grad.detach().float().clone()
                   for n, p in model.named_parameters()}
    opt.clear_grad()
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn,
                     device="cpu")
    losses = [float(step(x).float()) for _ in range(STEPS)]
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}

    def as_jax(name, t):
        return (t.t() if name in linear else t).numpy()

    params = {n: as_jax(n, p.detach().float())
              for n, p in model.named_parameters()}
    tiny = {n: as_jax(n, (g != 0) & (g.abs() < 100 * 1e-8))
            for n, g in first_grads.items()}
    return losses, params, tiny


@pytest.mark.parametrize("o2", [False, True])
def test_train_step_matches_jax(o2, monkeypatch):
    if o2:
        monkeypatch.setattr(jax_rms, "available", lambda: True)
    ids = np.random.RandomState(0).randint(0, 512, (4, 32)).astype(np.int64)
    state, jax_losses, jax_params = _jax_run(o2, ids)
    losses, params, tiny = _port_run(o2, ids, state)
    rtol, atol = (2e-2, 2e-2) if o2 else (1e-4, 1e-5)
    np.testing.assert_allclose(losses, jax_losses, rtol=rtol,
                               atol=0 if o2 else atol)
    assert losses[-1] < losses[0]
    assert sorted(params) == sorted(jax_params)
    n_loose = 0
    for name, want in jax_params.items():
        diff = np.abs(params[name] - want)
        loose = diff > atol + rtol * np.abs(want)
        if not o2:
            n_loose += int(loose.sum())
            loose &= ~(tiny[name] & (diff <= STEPS * LR))
        assert not loose.any(), (name, float(diff.max()))
    assert n_loose <= 1e-4 * sum(p.size for p in params.values())
    # the same tensors moved in both (in bf16 the RMSNorm weights, 1.0,
    # cannot take a 1e-3 step: there is no f32 master copy in either)
    start = {n: v.astype(np.float32) for n, v in state.items()}
    moved = sorted(n for n in params if not np.array_equal(params[n],
                                                           start[n]))
    assert moved == sorted(n for n in jax_params
                           if not np.array_equal(jax_params[n], start[n]))
    assert len(moved) == len(params) if not o2 else len(moved) > 0


def test_parallel_layouts_raise_and_init_is_seeded():
    # the tensor-, context- and pipeline-parallel layouts build (a world
    # of one; the pipelined model draws the serial one's weights from the
    # same generator); sequence parallelism needs tensor parallelism; a
    # tensor-parallel rank needs whole KV heads
    for flags in ({"tensor_parallel": True}, {"context_parallel": "ulysses"},
                  {"tensor_parallel": True, "sequence_parallel": True},
                  {"pipeline_parallel": True}):
        LlamaForCausalLM(llama_tiny(**flags), device="cpu")
        LlamaPretrainingCriterion(llama_tiny(**flags))
    with pytest.raises(ValueError, match="tensor_parallel"):
        llama_tiny(sequence_parallel=True)
    pp = LlamaForCausalLM(llama_tiny(pipeline_parallel=True), device="cpu",
                          generator=torch.Generator().manual_seed(5))
    serial = LlamaForCausalLM(llama_tiny(), device="cpu",
                              generator=torch.Generator().manual_seed(5))
    ids = torch.arange(16).reshape(2, 8)
    assert torch.equal(pp(ids), serial(ids))
    cfg = llama_tiny(num_hidden_layers=8)
    a = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    b = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    blk = a.llama.layers[0]
    assert blk.self_attn.qkv_proj.weight.std().item() == pytest.approx(
        0.02, rel=0.1)
    # out_proj and down_proj are scaled by 1/sqrt(2 * layers) = 1/4
    assert blk.mlp.down_proj.weight.std().item() == pytest.approx(0.005,
                                                                  rel=0.1)
    assert blk.self_attn.out_proj.weight.std().item() == pytest.approx(
        0.005, rel=0.1)
    assert torch.equal(blk.input_layernorm.weight, torch.ones(64))
    assert all(m.bias is None for m in a.modules()
               if isinstance(m, torch.nn.Linear))
