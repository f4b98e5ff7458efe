"""The port's GPT against the JAX GPT: JAX ``gpt_tiny`` weights carried
across with ``load_jax_state`` give the same logits within 1e-4 (f32,
CPU), for tied and untied LM heads."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_tiny,
                                         load_jax_state)


def _jax_state(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("tied", [True, False])
def test_logits_match_jax(tied):
    paddle.seed(0)
    ref = JaxGPT(jax_gpt_tiny(tie_word_embeddings=tied))
    ref.eval()
    model = GPTForCausalLM(gpt_tiny(tie_word_embeddings=tied), device="cpu")
    load_jax_state(model, _jax_state(ref)).eval()
    ids = np.random.RandomState(0).randint(0, 512, (2, 24))
    want = np.asarray(ref(paddle.to_tensor(ids.astype(np.int64))).numpy())
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 24, 512)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_load_jax_state_checks_names_and_shapes():
    paddle.seed(0)
    state = _jax_state(JaxGPT(jax_gpt_tiny()))
    model = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(KeyError, match="missing"):
        load_jax_state(model, {k: v for k, v in state.items()
                               if not k.startswith("gpt.ln_f")})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_state(model, {**state, "lm_head.weight": state[
            "gpt.embeddings.word_embeddings.weight"].T})
    bad = dict(state)
    bad["gpt.h.0.attn.out_proj.weight"] = np.zeros((64, 65), np.float32)
    with pytest.raises(ValueError, match="out_proj"):
        load_jax_state(model, bad)


def test_random_init_from_explicit_generator():
    cfg = gpt_tiny(num_hidden_layers=8)
    a = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    b = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    blk = a.gpt.h[0]
    assert blk.attn.qkv_proj.weight.std().item() == pytest.approx(0.02,
                                                                  rel=0.1)
    # out_proj and fc2 are scaled by 1/sqrt(2 * layers) = 1/4
    assert blk.mlp.fc2.weight.std().item() == pytest.approx(0.005, rel=0.1)
    assert torch.count_nonzero(blk.attn.qkv_proj.bias) == 0
    assert torch.equal(blk.ln_1.weight, torch.ones(64))


def test_parallel_layouts_raise():
    """The tensor-, context- and pipeline-parallel layouts build (here a
    world of one, where the pipelined model is bit for bit the serial one
    from the same generator); sequence parallelism needs tensor
    parallelism, and the decode engines refuse every parallel layout."""
    from paddle_tpu_torch.models.gpt import check_single_device

    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 8)))
    pp, serial = (GPTForCausalLM(gpt_tiny(**flags), device="cpu",
                                 generator=torch.Generator().manual_seed(3))
                  for flags in ({"pipeline_parallel": True}, {}))
    assert torch.equal(pp(ids), serial(ids))
    assert pp.gpt.h.stack_attn__qkv_proj__weight.shape == (2, 192, 64)
    for flags in ({"tensor_parallel": True}, {"context_parallel": "ring"},
                  {"tensor_parallel": True, "sequence_parallel": True},
                  {"pipeline_parallel": True}):
        cfg = gpt_tiny(**flags)
        GPTForCausalLM(cfg, device="cpu")
        with pytest.raises(ValueError, match="single-device"):
            check_single_device(cfg)
    with pytest.raises(ValueError, match="tensor_parallel"):
        gpt_tiny(sequence_parallel=True)
    with pytest.raises(ValueError, match="'ring', 'ulysses'"):
        gpt_tiny(context_parallel="zigzag")
