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
the model's own generator on its device.

The parallel layouts are GPT's (``models/gpt.py``), with Llama's packed
projections cut block by block: under ``tensor_parallel`` rank ``r`` holds
``[q_r | k_r | v_r]`` of ``qkv_proj`` and ``[gate_r | up_r]`` of
``gate_up_proj`` (a contiguous cut would give rank 0 only q heads), which
needs ``num_key_value_heads`` divisible by the ``mp`` degree. The untied
``lm_head`` is column-parallel and gathers the whole logits, as the JAX
model's ``P("dp", None, None)`` does. Under ``context_parallel`` RoPE
takes the rows of the whole sequence's table at this rank's global
positions. Under ``pipeline_parallel`` the decoder blocks are a
``fleet`` ``PipelinedStack`` (``LlamaModel.layers``), as GPT's; the
config has no ``pp_schedule``, as the JAX one has none, so the stack runs
``"rotation"`` unless a ``forward_backward_pipeline_*`` call swaps it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..base.global_state import build_generator
from ..device import DEFAULT_DEVICE, resolve_device
from ..nn import functional as F
from ..nn.layer import Layer, Linear, RMSNorm
from ..ops.activation import swiglu
from ..ops.fused_ops import _rope_table, fused_rotary_position_embedding
from . import _parallel
from .gpt import (GPTPretrainingCriterion, attend, check_layout,
                  lm_head_input, load_jax_state, name_parameters)

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
        check_layout(self)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class LlamaAttention(Layer):
    """GQA self-attention with rotary embeddings; attention dropout draws
    its seed from ``generator`` (under ``tensor_parallel``: the rank's own
    stream)."""

    def __init__(self, config: LlamaConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.generator = generator
        h, d = config.hidden_size, config.head_dim
        kv_out = config.num_key_value_heads * d
        if config.tensor_parallel:
            n = _parallel.mp_degree()
            if config.num_key_value_heads % n:
                raise ValueError(
                    f"tensor_parallel: num_key_value_heads "
                    f"{config.num_key_value_heads} must be divisible by the "
                    f"mp degree {n} (each rank holds whole KV heads)")
            col, row = _parallel.linears(config)
            self.qkv_proj = col(h, h + 2 * kv_out, has_bias=False,
                                gather_output=False,
                                segments=(h, kv_out, kv_out))
            self.out_proj = row(h, h, has_bias=False, input_is_parallel=True)
        else:
            self.qkv_proj = Linear(h, h + 2 * kv_out, bias_attr=False)
            self.out_proj = Linear(h, h, bias_attr=False)

    def _rope(self, q, k):
        cfg = self.config
        n, r = _parallel.sep_place(cfg)
        if n == 1:
            return fused_rotary_position_embedding(
                q, k, None, rotary_emb_base=cfg.rope_theta,
                use_neox_rotary_style=True)
        # this rank's rows of the whole sequence's table: global positions
        s, d = q.shape[1], q.shape[3]
        sin, cos = (_parallel.seq_part(t, n, r, dim=1) for t in _rope_table(
            n * s, d, float(cfg.rope_theta), True, q.device))
        return fused_rotary_position_embedding(
            q, k, None, sin=sin, cos=cos, rotary_emb_base=cfg.rope_theta,
            use_neox_rotary_style=True)

    def forward(self, x):
        cfg = self.config
        d = cfg.head_dim
        group = cfg.num_attention_heads // cfg.num_key_value_heads
        qkv = self.qkv_proj(x)
        b, s = qkv.shape[0], qkv.shape[1]
        # this rank's head counts (all of them on one device)
        hq = (qkv.shape[-1] // d) * group // (group + 2)
        hkv = hq // group
        q = qkv[..., :hq * d].unflatten(-1, (hq, d))
        k = qkv[..., hq * d:(hq + hkv) * d].unflatten(-1, (hkv, d))
        v = qkv[..., (hq + hkv) * d:].unflatten(-1, (hkv, d))
        q, k, _ = self._rope(q, k)
        if group > 1:
            # KV groups expanded to full heads, as the JAX model does
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        out = attend(cfg, q, k, v, cfg.attention_dropout_prob,
                     self.training, self.generator)
        return self.out_proj(out.reshape(b, s, hq * d))


class LlamaMLP(Layer):
    """SwiGLU MLP: one ``[gate | up]`` projection, silu gate, down."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        if config.tensor_parallel:
            col, row = _parallel.linears(config)
            self.gate_up_proj = col(h, 2 * ffn, has_bias=False,
                                    gather_output=False, segments=(ffn, ffn))
            self.down_proj = row(ffn, h, has_bias=False,
                                 input_is_parallel=True)
        else:
            self.gate_up_proj = Linear(h, 2 * ffn, bias_attr=False)
            self.down_proj = Linear(ffn, h, bias_attr=False)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_up_proj(x)))


class LlamaDecoderLayer(Layer):
    """Pre-norm block; hidden dropout draws from ``generator`` (under
    ``sequence_parallel``, from ``local_generator``)."""

    def __init__(self, config: LlamaConfig,
                 generator: Optional[torch.Generator] = None,
                 local_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.generator = (local_generator if config.sequence_parallel
                          else generator)
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, epsilon=eps)
        self.self_attn = LlamaAttention(
            config, local_generator if config.tensor_parallel else generator)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                epsilon=eps)
        self.mlp = LlamaMLP(config)
        _parallel.mark_sequence_parallel(config, self.input_layernorm,
                                         self.post_attention_layernorm)

    def forward(self, x):
        p, gen = self.config.hidden_dropout_prob, self.generator
        h = self.self_attn(self.input_layernorm(x))
        x = x + F.dropout(h, p, training=self.training, generator=gen)
        h = self.mlp(self.post_attention_layernorm(x))
        return x + F.dropout(h, p, training=self.training, generator=gen)


class LlamaModel(Layer):
    """Trunk: token embeddings → N decoder blocks → final RMSNorm; the
    parallel layouts as ``GPTModel``'s."""

    def __init__(self, config: LlamaConfig,
                 generator: Optional[torch.Generator] = None,
                 local_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        if config.tensor_parallel:
            self.embed_tokens = _parallel.vocab_embedding(
                config.vocab_size, config.hidden_size)
        else:
            self.embed_tokens = nn.Embedding(config.vocab_size,
                                             config.hidden_size)
        self.layers = _parallel.blocks(config, lambda: LlamaDecoderLayer(
            config, generator, local_generator))
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps)
        _parallel.mark_sequence_parallel(config, self.norm)

    def forward(self, input_ids):
        n, r = _parallel.sep_place(self.config)
        if n > 1:
            input_ids = _parallel.seq_part(input_ids, n, r)
        x = self.embed_tokens(input_ids)
        if self.config.sequence_parallel:
            from ..distributed.fleet.sequence_parallel import ScatterOp

            x = ScatterOp.apply(x)
        return self.norm(_parallel.run_blocks(self.config, self.layers, x))


class LlamaForCausalLM(Layer):
    """Trunk + LM head (untied by default; with ``tie_word_embeddings``
    the head reuses the embedding matrix). Built on ``device`` (default
    CUDA; raises when CUDA is absent and the caller did not ask for the
    CPU) with weights drawn on the CPU from ``generator`` (default: the
    build generator that ``paddle.seed`` seeds), so one seed gives the
    same weights on every device. Dropout draws from
    ``dropout_generator``, a ``torch.Generator`` on ``device`` seeded with
    ``dropout_seed``. Under ``tensor_parallel`` the logits are gathered
    whole over ``mp``."""

    def __init__(self, config: LlamaConfig, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        check_layout(config)
        self.config = config
        self.dropout_generator = torch.Generator(device=dev).manual_seed(
            int(dropout_seed))
        local = (_parallel.local_generator(dev) if config.tensor_parallel
                 else None)
        # built without storage, so torch's own initializers neither run
        # nor draw from the global generator
        with torch.device("meta"):
            self.llama = LlamaModel(config, self.dropout_generator, local)
            if not config.tie_word_embeddings:
                if config.tensor_parallel:
                    col, _ = _parallel.linears(config)
                    self.lm_head = col(config.hidden_size, config.vocab_size,
                                       has_bias=False, gather_output=True)
                else:
                    self.lm_head = Linear(config.hidden_size,
                                          config.vocab_size, bias_attr=False)
        self.to_empty(device="cpu")
        self._init_weights(generator if generator is not None
                           else build_generator())
        self.to(dev)
        name_parameters(self)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        cfg = self.config
        std = cfg.initializer_range
        scaled = std / math.sqrt(2.0 * cfg.num_hidden_layers)

        def init(name, mod):
            if isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                s = scaled if name.endswith(("out_proj", "down_proj")) else std
                _parallel.normal_(mod, "weight", s, gen)

        _parallel.init_modules(self, init)

    def forward(self, input_ids):
        cfg = self.config
        x = self.llama(input_ids)
        if not cfg.tie_word_embeddings:
            return self.lm_head(x)
        if not cfg.tensor_parallel:
            return F.linear(x, self.llama.embed_tokens.weight)
        from ..distributed.fleet import mpu

        logits = F.linear(lm_head_input(cfg, x),
                          self.llama.embed_tokens.weight)
        return mpu.gather_from_model_parallel(logits)


class LlamaPretrainingCriterion(GPTPretrainingCriterion):
    """Shifted causal-LM cross entropy, the GPT criterion's contract: the
    logits at position i are scored against token i+1, mean over the
    ``B·(S−1)`` positions (under ``context_parallel``, over every ``sep``
    rank's). Llama's logits are whole over ``mp``."""

    logits_are_vocab_parts = False


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
