"""Llama decoder-only LM (port of ``paddle_tpu/models/llama.py``), single
device: grouped-query attention, rotary embeddings, RMSNorm and SwiGLU.

Same config, presets, module tree and parameter names as the JAX model,
so ``state_dict`` keys match name for name and :func:`load_jax_state`
carries JAX weights across. No layer has a bias.

- RMSNorm (``nn.layer.RMSNorm``) runs ``F.rms_norm`` with its weight, so
  on the GPU the hand-written K4 forward and backward kernels
  (``ops/cuda/csrc/rms_norm.cu``);
- attention: one packed ``[q | k | v]`` projection (column blocks, not
  GPT's ``[H, 3, D]``), RoPE on q and k (``ops.fused_ops``), the KV heads
  repeated ``group`` times along the head axis (``repeat_interleave``, a
  copy), then ``F.scaled_dot_product_attention``: K1 forward, K2/K3
  backward;
- the MLP: one ``gate_up_proj``, ``swiglu``, ``down_proj``.

Randomness is explicit, as in ``models/gpt.py``: weights are normal with
std ``initializer_range`` (``/sqrt(2·layers)`` for ``out_proj`` and
``down_proj``) from a ``torch.Generator`` on the CPU; dropout draws from
the model's own generator on its device. The tensor, sequence, pipeline
and context-parallel layouts of the JAX model raise here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..nn import functional as F
from ..nn.layer import Linear, RMSNorm
from ..ops.activation import swiglu
from ..ops.fused_ops import fused_rotary_position_embedding
from .gpt import (GPTPretrainingCriterion, check_single_device,
                  load_jax_state, name_parameters)

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "LlamaPretrainingCriterion",
           "load_jax_state", "llama_tiny", "llama2_7b", "llama3_8b",
           "llama_124m_gqa", "llama_flops_per_step"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 0  # 0 → MHA (= num_attention_heads)
    intermediate_size: int = 0  # 0 → LLaMA's 8/3 rule rounded to 256
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    hidden_dropout_prob: float = 0.0
    attention_dropout_prob: float = 0.0
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    use_flash_attention: bool = True
    context_parallel: str = ""  # "", "ring", "ulysses"
    pipeline_parallel: bool = False
    virtual_pp_degree: int = 1
    pp_num_microbatches: int = 0

    def __post_init__(self):
        if self.num_key_value_heads == 0:
            self.num_key_value_heads = self.num_attention_heads
        if self.intermediate_size == 0:
            ffn = int(self.hidden_size * 8 / 3)
            self.intermediate_size = 256 * ((ffn + 255) // 256)
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                "num_key_value_heads must divide num_attention_heads")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class LlamaAttention(nn.Module):
    """GQA self-attention with rotary embeddings; attention dropout draws
    its seed from ``generator``."""

    def __init__(self, config: LlamaConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.generator = generator
        h, d = config.hidden_size, config.head_dim
        kv_out = config.num_key_value_heads * d
        self.qkv_proj = Linear(h, h + 2 * kv_out, bias=False)
        self.out_proj = Linear(h, h, bias=False)

    def forward(self, x):
        cfg = self.config
        b, s = x.shape[0], x.shape[1]
        d, hq, hkv = (cfg.head_dim, cfg.num_attention_heads,
                      cfg.num_key_value_heads)
        qkv = self.qkv_proj(x)
        q = qkv[..., :hq * d].unflatten(-1, (hq, d))
        k = qkv[..., hq * d:(hq + hkv) * d].unflatten(-1, (hkv, d))
        v = qkv[..., (hq + hkv) * d:].unflatten(-1, (hkv, d))
        q, k, _ = fused_rotary_position_embedding(
            q, k, None, rotary_emb_base=cfg.rope_theta,
            use_neox_rotary_style=True)
        group = hq // hkv
        if group > 1:
            # KV groups expanded to full heads, as the JAX model does
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=cfg.attention_dropout_prob,
            training=self.training, generator=self.generator)
        return self.out_proj(out.reshape(b, s, hq * d))


class LlamaMLP(nn.Module):
    """SwiGLU MLP: one ``[gate | up]`` projection, silu gate, down."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        self.gate_up_proj = Linear(h, 2 * ffn, bias=False)
        self.down_proj = Linear(ffn, h, bias=False)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    """Pre-norm block; hidden dropout draws from ``generator``."""

    def __init__(self, config: LlamaConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.generator = generator
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, epsilon=eps)
        self.self_attn = LlamaAttention(config, generator)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                epsilon=eps)
        self.mlp = LlamaMLP(config)

    def forward(self, x):
        p, gen = self.config.hidden_dropout_prob, self.generator
        h = self.self_attn(self.input_layernorm(x))
        x = x + F.dropout(h, p, self.training, gen)
        h = self.mlp(self.post_attention_layernorm(x))
        return x + F.dropout(h, p, self.training, gen)


class LlamaModel(nn.Module):
    """Trunk: token embeddings → N decoder blocks → final RMSNorm."""

    def __init__(self, config: LlamaConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, generator)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps)

    def forward(self, input_ids):
        x = self.embed_tokens(input_ids)
        for block in self.layers:
            x = block(x)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Trunk + LM head (untied by default; with ``tie_word_embeddings``
    the head reuses the embedding matrix). Built on ``device`` (default
    CUDA; raises when CUDA is absent and the caller did not ask for the
    CPU) with weights drawn on the CPU from ``generator`` (default: a
    generator seeded 0), so one seed gives the same weights on every
    device. Dropout draws from ``dropout_generator``, a ``torch.Generator``
    on ``device`` seeded with ``dropout_seed``."""

    def __init__(self, config: LlamaConfig, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        check_single_device(config)
        self.config = config
        self.dropout_generator = torch.Generator(device=dev).manual_seed(
            int(dropout_seed))
        # built without storage, so torch's own initializers neither run
        # nor draw from the global generator
        with torch.device("meta"):
            self.llama = LlamaModel(config, self.dropout_generator)
            if not config.tie_word_embeddings:
                self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                      bias=False)
        self.to_empty(device="cpu")
        self._init_weights(generator if generator is not None
                           else torch.Generator().manual_seed(0))
        self.to(dev)
        name_parameters(self)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        cfg = self.config
        std = cfg.initializer_range
        scaled = std / math.sqrt(2.0 * cfg.num_hidden_layers)
        for name, mod in self.named_modules():
            if isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                s = scaled if name.endswith(("out_proj", "down_proj")) else std
                mod.weight.normal_(0.0, s, generator=gen)

    def forward(self, input_ids):
        x = self.llama(input_ids)
        if self.config.tie_word_embeddings:
            return F.linear(x, self.llama.embed_tokens.weight)
        return self.lm_head(x)


class LlamaPretrainingCriterion(GPTPretrainingCriterion):
    """Shifted causal-LM cross entropy, the GPT criterion's contract: the
    logits at position i are scored against token i+1, mean over the
    ``B·(S−1)`` positions."""


def llama_flops_per_step(batch: int, seq: int, cfg: LlamaConfig) -> float:
    """Training FLOPs of one step, the port's copy of ``bench.py``'s
    ``_llama_flops_per_step``: 3 × the forward, whose matmuls are 2 ·
    tokens · the matmul parameters (GQA's narrower k/v, SwiGLU's three
    projections, the LM head) plus attention's 4·B·S²·h per layer."""
    h = cfg.hidden_size
    d = h // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * d
    ffn = cfg.intermediate_size
    per_layer = h * (h + 2 * kv) + h * h + 3 * h * ffn
    matmul_params = cfg.num_hidden_layers * per_layer + h * cfg.vocab_size
    tokens = batch * seq
    fwd = (2.0 * tokens * matmul_params
           + cfg.num_hidden_layers * 4.0 * batch * seq * seq * h)
    return 3.0 * fwd


# ---------------------------------------------------------------- presets

def llama_tiny(**overrides) -> LlamaConfig:
    """Test/CI scale with GQA exercised."""
    base = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2,
                intermediate_size=128, max_position_embeddings=128)
    base.update(overrides)
    return LlamaConfig(**base)


def llama2_7b(**overrides) -> LlamaConfig:
    base = dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=32,
                intermediate_size=11008, max_position_embeddings=4096)
    base.update(overrides)
    return LlamaConfig(**base)


def llama3_8b(**overrides) -> LlamaConfig:
    base = dict(vocab_size=128256, hidden_size=4096, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=8,
                intermediate_size=14336, max_position_embeddings=8192,
                rope_theta=500000.0)
    base.update(overrides)
    return LlamaConfig(**base)


def llama_124m_gqa(**overrides) -> LlamaConfig:
    """The accelerator arm of ``bench.py``'s ``bench_llama``: 12 layers,
    hidden 768, 12 heads over 4 KV heads (GQA, group 3), SwiGLU width
    2048, vocab 32000, trained at B=4 × S=2048."""
    base = dict(vocab_size=32000, hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, num_key_value_heads=4,
                intermediate_size=2048, max_position_embeddings=2048)
    base.update(overrides)
    return LlamaConfig(**base)
