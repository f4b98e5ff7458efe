"""GPT decoder-only LM (port of ``paddle_tpu/models/gpt.py``), single device.

Same config, presets, module tree and parameter names as the JAX model,
so ``state_dict`` keys match name for name. Attention runs through
``nn.functional.scaled_dot_product_attention`` and so through the
hand-written flash-attention kernels on the GPU: K1 forward, K2/K3
backward. q, k and v reach them as strided slices of the packed
``qkv [B, S, H, 3, D]``, without a copy; their gradients flow back into
``qkv`` through those views. ``Linear`` and ``LayerNorm`` follow the AMP
state (``amp/``). The tensor, pipeline, sequence and context-parallel
layouts of the JAX model raise here.

Randomness is explicit. Weights are random from a ``torch.Generator``
(normal, std ``initializer_range``, scaled by ``1/sqrt(2·layers)`` for
``out_proj`` and ``fc2``), or carried over from a JAX model with
:func:`load_jax_state`. Dropout draws from the model's own generator on
its device, seeded by ``dropout_seed``: the hidden-dropout masks and the
per-call attention-dropout seed, never torch's global generator.
``torch.nn.Linear`` keeps its weight as ``[out, in]``; the JAX ``Linear``
keeps ``[in, out]``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..nn import functional as F
from ..nn.layer import LayerNorm, Linear

__all__ = ["GPTConfig", "GPTAttention", "GPTMLP", "GPTDecoderLayer",
           "GPTEmbeddings", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "jax_state_dict", "load_jax_state",
           "port_state_from_jax", "gpt_tiny",
           "gpt2_small", "gpt2_medium", "gpt_1p3b"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 0  # 0 → 4*hidden
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    use_flash_attention: bool = True
    context_parallel: str = ""
    pipeline_parallel: bool = False
    virtual_pp_degree: int = 1
    pp_num_microbatches: int = 0
    pp_schedule: str = "rotation"

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide num_attention_heads")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def check_single_device(cfg) -> None:
    """Raise for a GPT or Llama config that asks for a parallel layout."""
    if (cfg.tensor_parallel or cfg.pipeline_parallel
            or cfg.sequence_parallel or cfg.context_parallel):
        raise ValueError(
            "the port builds single-device models; tensor/pipeline/"
            "sequence/context-parallel configs are training layouts not "
            "ported yet (ROADMAP.md, queue 7)")


class GPTAttention(nn.Module):
    """Causal self-attention: fused qkv projection → flash attention →
    output projection. Attention dropout draws its seed from
    ``generator``."""

    def __init__(self, config: GPTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.generator = generator
        h = config.hidden_size
        self.qkv_proj = Linear(h, 3 * h)
        self.out_proj = Linear(h, h)

    def forward(self, x):
        cfg = self.config
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).view(b, s, cfg.num_attention_heads, 3,
                                    cfg.head_dim)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=cfg.attention_dropout_prob,
            training=self.training, generator=self.generator)
        return self.out_proj(out.reshape(b, s, cfg.hidden_size))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.fc1 = Linear(config.hidden_size, config.intermediate_size)
        self.fc2 = Linear(config.intermediate_size, config.hidden_size)

    def forward(self, x):
        return self.fc2(TF.gelu(self.fc1(x), approximate="tanh"))


class GPTDecoderLayer(nn.Module):
    """Pre-LN transformer block; hidden dropout draws from ``generator``."""

    def __init__(self, config: GPTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.generator = generator
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, eps=eps)
        self.attn = GPTAttention(config, generator)
        self.ln_2 = LayerNorm(config.hidden_size, eps=eps)
        self.mlp = GPTMLP(config)

    def forward(self, x):
        p, gen = self.config.hidden_dropout_prob, self.generator
        x = x + F.dropout(self.attn(self.ln_1(x)), p, self.training, gen)
        return x + F.dropout(self.mlp(self.ln_2(x)), p, self.training, gen)


class GPTEmbeddings(nn.Module):
    def __init__(self, config: GPTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.generator = generator
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)[None]
        x = self.word_embeddings(input_ids) + self.position_embeddings(
            position_ids)
        return F.dropout(x, self.config.hidden_dropout_prob, self.training,
                         self.generator)


class GPTModel(nn.Module):
    """Transformer trunk: embeddings → N decoder blocks → final LN."""

    def __init__(self, config: GPTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, generator)
        self.h = nn.ModuleList(
            [GPTDecoderLayer(config, generator)
             for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              eps=config.layer_norm_epsilon)

    def forward(self, input_ids, position_ids=None):
        x = self.embeddings(input_ids, position_ids)
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """Trunk + LM head; with ``tie_word_embeddings`` the head reuses the
    word-embedding matrix. Built on ``device`` (default CUDA; raises when
    CUDA is absent and the caller did not ask for the CPU) with weights
    drawn on the CPU from ``generator`` (default: a generator seeded 0),
    so one seed gives the same weights on every device. Dropout draws from
    ``dropout_generator``, a ``torch.Generator`` on ``device`` seeded with
    ``dropout_seed``; the model stays on that device."""

    def __init__(self, config: GPTConfig, *, device=DEFAULT_DEVICE,
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
            self.gpt = GPTModel(config, self.dropout_generator)
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
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                s = scaled if name.endswith(("out_proj", "fc2")) else std
                mod.weight.normal_(0.0, s, generator=gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()

    def forward(self, input_ids, position_ids=None):
        x = self.gpt(input_ids, position_ids)
        if self.config.tie_word_embeddings:
            return F.linear(x, self.gpt.embeddings.word_embeddings.weight)
        return self.lm_head(x)


class GPTPretrainingCriterion(nn.Module):
    """Next-token cross entropy: logits at position i are scored against
    token i+1 (the shift happens here, so callers pass the raw ids as
    labels), mean over the ``B·(S−1)`` positions."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        check_single_device(config)
        self.config = config

    def forward(self, logits, labels):
        v = logits.shape[-1]
        flat = logits[:, :-1, :].reshape(-1, v)
        return F.cross_entropy(flat, labels[:, 1:].reshape(-1),
                               reduction="mean")


def name_parameters(model: nn.Module) -> None:
    """Give each parameter a ``param_name``, its qualified state-dict key,
    which AdamW passes to ``apply_decay_param_fun`` where the JAX package
    passes ``p.name`` (a process-wide counter there, which cannot be
    matched; torch reserves ``Tensor.name``)."""
    for name, p in model.named_parameters():
        p.param_name = name


def _linear_weights(model: nn.Module) -> set:
    return {f"{name}.weight" for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear)}


def port_state_from_jax(model: nn.Module,
                        state: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """``state`` (the JAX model's ``state_dict()`` under the JAX names, as
    numpy arrays or tensors) in the port's layout for ``model``: each JAX
    ``Linear`` weight ``[in, out]`` transposed into torch's ``[out, in]``
    (a view), every other tensor as it is. Every parameter must be given,
    and nothing else, each at the parameter's shape; ``model`` is not
    touched."""
    linear = _linear_weights(model)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"load_jax_state: missing {missing}, "
                       f"unexpected {unexpected}")
    out = {}
    for name, param in params.items():
        value = state[name]
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(np.asarray(value))
        if name in linear:
            value = value.t()
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"load_jax_state: {name} is "
                             f"{tuple(value.shape)}, the port expects "
                             f"{tuple(param.shape)}")
        out[name] = value
    return out


@torch.no_grad()
def load_jax_state(model: nn.Module,
                   state: Mapping[str, object]) -> nn.Module:
    """Fill ``model`` (the port's GPT or Llama) from the JAX model's
    ``state_dict()`` given under the JAX names, which the port's parameter
    names match name for name. With :func:`jax_state_dict`, the one place
    that knows both layouts: a JAX ``Linear`` weight is ``[in, out]`` and
    is transposed into torch's ``[out, in]``; every other tensor copies as
    it is. Every parameter must be given, and nothing else."""
    params = dict(model.named_parameters())
    for name, value in port_state_from_jax(model, state).items():
        params[name].copy_(value)
    return model


def jax_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`load_jax_state`: ``model``'s parameters under
    the JAX names in the JAX layout, each ``Linear`` weight as ``[in,
    out]``. The tensors are views of the model's storage (no copy); a
    checkpoint written from them (``save_sharded``) is in the reference's
    layout, whichever package wrote it."""
    linear = _linear_weights(model)
    return {name: p.detach().t() if name in linear else p.detach()
            for name, p in model.named_parameters()}


# ---------------------------------------------------------------- presets

def gpt_tiny(**overrides) -> GPTConfig:
    """Test/CI scale."""
    base = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128,
                hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    base.update(overrides)
    return GPTConfig(**base)


def gpt2_small(**overrides) -> GPTConfig:
    base = dict(vocab_size=50304, hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, max_position_embeddings=1024)
    base.update(overrides)
    return GPTConfig(**base)


def gpt2_medium(**overrides) -> GPTConfig:
    base = dict(vocab_size=50304, hidden_size=1024, num_hidden_layers=24,
                num_attention_heads=16, max_position_embeddings=1024)
    base.update(overrides)
    return GPTConfig(**base)


def gpt_1p3b(**overrides) -> GPTConfig:
    base = dict(vocab_size=50304, hidden_size=2048, num_hidden_layers=24,
                num_attention_heads=16, max_position_embeddings=2048)
    base.update(overrides)
    return GPTConfig(**base)
