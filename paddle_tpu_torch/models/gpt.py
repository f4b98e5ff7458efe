"""GPT decoder-only LM (port of ``paddle_tpu/models/gpt.py``).

Same config, presets, module tree and parameter names as the JAX model,
so ``state_dict`` keys match name for name. Attention runs through
``nn.functional.scaled_dot_product_attention`` and so through the
hand-written flash-attention kernels on the GPU: K1 forward, K2/K3
backward. q, k and v reach them as strided slices of the packed
``qkv [B, S, H, 3, D]``, without a copy; their gradients flow back into
``qkv`` through those views. ``Linear`` and ``LayerNorm`` follow the AMP
state (``amp/``).

The parallel layouts of the JAX model, one process a rank
(``distributed.fleet``; the config's degrees are the mesh's):

- ``tensor_parallel``: ``qkv_proj``/``fc1`` column-parallel and
  ``out_proj``/``fc2`` row-parallel over ``mp``; the packed qkv is
  ``[H, 3, D]``-major, so a contiguous cut of its columns gives each rank
  whole heads. The word embeddings are vocab-parallel, the tied head runs
  against them and returns this rank's vocab part of the logits
  (divergence: JAX returns the whole logits), which the criterion feeds to
  ``ParallelCrossEntropy`` without a gather, as JAX's does.
- ``sequence_parallel`` (with ``tensor_parallel``): the residual stream
  between the blocks is cut over ``mp`` along the sequence; the norms'
  and the row-parallel biases' gradients are then partial sums, which
  ``fleet.distributed_model``'s hooks all-reduce.
- ``context_parallel`` (``"ring"`` or ``"ulysses"``): the model takes the
  whole ``[B, S]`` ids, as JAX's does, and each ``sep`` rank runs its part
  of the sequence, positions counted globally; attention goes through
  ``fleet.context_parallel``. The logits are this rank's part of the
  sequence (divergence), and the criterion shifts the labels over the
  whole sequence before cutting and takes the mean over every ``sep``
  rank's tokens.
- ``pipeline_parallel``: the decoder blocks are a ``fleet``
  ``PipelinedStack`` (``GPTModel.h``) over the ``pp`` ranks, one process a
  stage, run by ``pp_schedule`` (``"rotation"``, ``"1f1b"``,
  ``"eager_1f1b"``, ``"zb"``) with ``pp_num_microbatches`` (0: ``2·pp``)
  and ``virtual_pp_degree`` chunks a stage; the embeddings, ``ln_f`` and
  the head are whole on every ``pp`` rank, and the stack's output and its
  input gradient are whole there too. It composes with the other layouts:
  the template block is built with the mpu layers, so a stacked weight is
  cut over ``pp`` on its layer dim and over ``mp`` as the block's is.

Randomness is explicit. Weights are random from a ``torch.Generator``
(normal, std ``initializer_range``, scaled by ``1/sqrt(2·layers)`` for
``out_proj`` and ``fc2``; a tensor-parallel rank keeps its part of the
weights a single-device model draws), or carried over from a JAX model
with :func:`load_jax_state`. Dropout draws from the model's own generator
on its device, seeded by ``dropout_seed``: the hidden-dropout masks and
the per-call attention-dropout seed, never torch's global generator.
Under ``tensor_parallel`` the attention dropout on a rank's own heads,
and under ``sequence_parallel`` the hidden dropout on its sequence part,
draw from the RNG tracker's ``model_parallel_rng``, seeded per ``mp``
rank. ``torch.nn.Linear`` keeps its weight as ``[out, in]``; the JAX
``Linear`` keeps ``[in, out]``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as TF
from torch import nn

from ..base.global_state import build_generator
from ..core.tensor import plain
from ..device import DEFAULT_DEVICE, resolve_device
from ..nn import functional as F
from ..nn.layer import LayerNorm, Linear
from ..nn.layer.layers import Layer, name_parameters
from . import _parallel

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
        check_layout(self)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def check_layout(cfg) -> None:
    """Raise for a GPT or Llama layout the port does not build: sequence
    parallelism without tensor parallelism (it rides on the ``mp``
    groups), an unknown ``context_parallel``."""
    if cfg.context_parallel not in ("", "ring", "ulysses"):
        raise ValueError(f"context_parallel {cfg.context_parallel!r}: "
                         f"'ring', 'ulysses' or ''")
    if cfg.sequence_parallel and not cfg.tensor_parallel:
        raise ValueError("sequence_parallel cuts the activations over the "
                         "tensor-parallel mp groups: set tensor_parallel "
                         "too")


def check_single_device(cfg) -> None:
    """Raise for a GPT or Llama config that asks for a parallel layout:
    the decode engines serve single-device models."""
    if (cfg.tensor_parallel or cfg.pipeline_parallel
            or cfg.sequence_parallel or cfg.context_parallel):
        raise ValueError(
            "the decode engines serve single-device models; tensor/"
            "pipeline/sequence/context-parallel configs are training "
            "layouts")


def attend(config, q, k, v, dropout: float, training: bool,
           generator: Optional[torch.Generator]):
    """Causal attention over ``[B, S, H, D]``: ``fleet``'s ring or Ulysses
    attention over ``sep`` under ``context_parallel`` (no dropout, as in
    JAX), else ``scaled_dot_product_attention``."""
    if config.context_parallel:
        from ..distributed.fleet import context_parallel as cp

        fn = (cp.ring_attention if config.context_parallel == "ring"
              else cp.ulysses_attention)
        return plain(fn(q, k, v, causal=True))
    return F.scaled_dot_product_attention(
        q, k, v, is_causal=True, dropout_p=dropout, training=training,
        generator=generator)


class GPTAttention(Layer):
    """Causal self-attention: fused qkv projection → flash attention →
    output projection. Attention dropout draws its seed from
    ``generator`` (under ``tensor_parallel``: the rank's own stream)."""

    def __init__(self, config: GPTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.generator = generator
        h = config.hidden_size
        if config.tensor_parallel:
            col, row = _parallel.linears(config)
            self.qkv_proj = col(h, 3 * h, has_bias=True, gather_output=False)
            self.out_proj = row(h, h, has_bias=True, input_is_parallel=True)
        else:
            self.qkv_proj = Linear(h, 3 * h)
            self.out_proj = Linear(h, h)

    def forward(self, x):
        cfg = self.config
        qkv = self.qkv_proj(x)
        # [B, S, 3H] -> [B, S, H_local, 3, D]; under mp the heads are cut
        b, s = qkv.shape[0], qkv.shape[1]
        heads = qkv.shape[-1] // (3 * cfg.head_dim)
        qkv = qkv.view(b, s, heads, 3, cfg.head_dim)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        out = attend(cfg, q, k, v, cfg.attention_dropout_prob,
                     self.training, self.generator)
        return self.out_proj(out.reshape(b, s, heads * cfg.head_dim))


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        if config.tensor_parallel:
            col, row = _parallel.linears(config)
            self.fc1 = col(h, ffn, has_bias=True, gather_output=False)
            self.fc2 = row(ffn, h, has_bias=True, input_is_parallel=True)
        else:
            self.fc1 = Linear(h, ffn)
            self.fc2 = Linear(ffn, h)

    def forward(self, x):
        return self.fc2(TF.gelu(self.fc1(x), approximate="tanh"))


class GPTDecoderLayer(Layer):
    """Pre-LN transformer block; hidden dropout draws from ``generator``
    (under ``sequence_parallel``, from ``local_generator``: each rank
    holds its own part of the sequence)."""

    def __init__(self, config: GPTConfig,
                 generator: Optional[torch.Generator] = None,
                 local_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.generator = (local_generator if config.sequence_parallel
                          else generator)
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, eps=eps)
        self.attn = GPTAttention(config, local_generator
                                 if config.tensor_parallel else generator)
        self.ln_2 = LayerNorm(config.hidden_size, eps=eps)
        self.mlp = GPTMLP(config)
        _parallel.mark_sequence_parallel(config, self.ln_1, self.ln_2)

    def forward(self, x):
        p, gen = self.config.hidden_dropout_prob, self.generator
        x = x + F.dropout(self.attn(self.ln_1(x)), p,
                          training=self.training, generator=gen)
        return x + F.dropout(self.mlp(self.ln_2(x)), p,
                             training=self.training, generator=gen)


class GPTEmbeddings(Layer):
    def __init__(self, config: GPTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.generator = generator
        if config.tensor_parallel:
            self.word_embeddings = _parallel.vocab_embedding(
                config.vocab_size, config.hidden_size)
        else:
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
        return F.dropout(x, self.config.hidden_dropout_prob,
                         training=self.training, generator=self.generator)


class GPTModel(Layer):
    """Transformer trunk: embeddings → N decoder blocks → final LN. Under
    ``context_parallel`` it takes the whole sequence and runs this rank's
    part of it (positions global); under ``sequence_parallel`` it returns
    this rank's part of the sequence dim over ``mp``."""

    def __init__(self, config: GPTConfig,
                 generator: Optional[torch.Generator] = None,
                 local_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, generator)
        self.h = _parallel.blocks(config, lambda: GPTDecoderLayer(
            config, generator, local_generator))
        self.ln_f = LayerNorm(config.hidden_size,
                              eps=config.layer_norm_epsilon)
        _parallel.mark_sequence_parallel(config, self.ln_f)

    def forward(self, input_ids, position_ids=None):
        n, r = _parallel.sep_place(self.config)
        if n > 1:
            if position_ids is None:
                part = input_ids.shape[-1] // n
                position_ids = torch.arange(r * part, (r + 1) * part,
                                            device=input_ids.device)[None]
            else:
                position_ids = _parallel.seq_part(position_ids, n, r)
            input_ids = _parallel.seq_part(input_ids, n, r)
        x = self.embeddings(input_ids, position_ids)
        if self.config.sequence_parallel:
            from ..distributed.fleet.sequence_parallel import ScatterOp

            x = ScatterOp.apply(x)
        return self.ln_f(_parallel.run_blocks(self.config, self.h, x))


def lm_head_input(config, x):
    """The trunk's output as a tensor-parallel head takes it: the whole
    sequence gathered over ``mp`` under ``sequence_parallel`` (its gradient
    reduce-scattered), else marked for the gradient's all-reduce."""
    from ..distributed.fleet import mpu

    if config.sequence_parallel:
        return mpu.all_gather_sequence(x)
    return mpu.copy_to_model_parallel(x)


class GPTForCausalLM(Layer):
    """Trunk + LM head; with ``tie_word_embeddings`` the head reuses the
    word-embedding matrix (under ``tensor_parallel`` this rank's vocab
    rows: the logits are its vocab part). Built on ``device`` (default
    CUDA; raises when CUDA is absent and the caller did not ask for the
    CPU) with weights drawn on the CPU from ``generator`` (default: the
    build generator that ``paddle.seed`` seeds, ``base.global_state``), so
    one seed gives the same weights on every device. Dropout draws from
    ``dropout_generator``, a ``torch.Generator`` on ``device`` seeded with
    ``dropout_seed``; the model stays on that device."""

    def __init__(self, config: GPTConfig, *, device=DEFAULT_DEVICE,
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
            self.gpt = GPTModel(config, self.dropout_generator, local)
            if not config.tie_word_embeddings:
                if config.tensor_parallel:
                    col, _ = _parallel.linears(config)
                    self.lm_head = col(config.hidden_size, config.vocab_size,
                                       has_bias=False, gather_output=False)
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
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Embedding)):
                s = scaled if name.endswith(("out_proj", "fc2")) else std
                _parallel.normal_(mod, "weight", s, gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()

        _parallel.init_modules(self, init)

    def forward(self, input_ids, position_ids=None):
        cfg = self.config
        x = self.gpt(input_ids, position_ids)
        if not cfg.tie_word_embeddings:
            return self.lm_head(x)
        if cfg.tensor_parallel:
            x = lm_head_input(cfg, x)
        return F.linear(x, self.gpt.embeddings.word_embeddings.weight)


class GPTPretrainingCriterion(Layer):
    """Next-token cross entropy: logits at position i are scored against
    token i+1 (the shift happens here, so callers pass the raw ids as
    labels), mean over the ``B·(S−1)`` positions. A tensor-parallel GPT's
    logits are vocab parts, scored by ``ParallelCrossEntropy``. Under
    ``context_parallel`` the logits are this rank's part of the sequence
    and ``labels`` the whole ``[B, S]``: the shifted labels are cut like
    the logits, and the loss is the mean over every ``sep`` rank's tokens
    (an all-reduce of the summed terms whose gradient is each rank's
    own)."""

    # a tensor-parallel GPT's logits are vocab parts (its head is
    # column-parallel without a gather); a subclass whose model gathers
    # them says False
    logits_are_vocab_parts = True

    def __init__(self, config: GPTConfig):
        super().__init__()
        check_layout(config)
        self.config = config
        self.vocab_parallel = (self.logits_are_vocab_parts
                               and config.tensor_parallel)

    def _terms(self, logits, labels):
        flat = logits.reshape(-1, logits.shape[-1])
        if self.vocab_parallel:
            from ..distributed.fleet.mpu import ParallelCrossEntropy

            return ParallelCrossEntropy()(flat, labels.reshape(-1))
        return F.cross_entropy(flat, labels.reshape(-1), reduction="none")

    def forward(self, logits, labels):
        n, r = _parallel.sep_place(self.config)
        if n > 1:
            from ..distributed.fleet import mpu

            b, s = labels.shape
            shifted = torch.cat([labels[:, 1:], labels.new_full((b, 1),
                                                                -100)], 1)
            total = self._terms(logits,
                                _parallel.seq_part(shifted, n, r)).sum()
            return mpu.reduce_from_model_parallel(total, axis="sep") / (
                b * (s - 1))
        if self.vocab_parallel:
            return self._terms(logits[:, :-1, :], labels[:, 1:]).mean()
        v = logits.shape[-1]
        flat = logits[:, :-1, :].reshape(-1, v)
        return F.cross_entropy(flat, labels[:, 1:].reshape(-1),
                               reduction="mean")


def _linear_weights(model: nn.Module) -> set:
    """The weights kept ``[out, in]`` here and ``[in, out]`` in JAX: every
    ``Linear``'s, and a pipelined stack's stacked ones (``[L, out, in]``
    against ``[L, in, out]``)."""
    out = set()
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            out.add(f"{name}.weight" if name else "weight")
        stacked = getattr(mod, "linear_weights", None)
        if callable(stacked):
            out.update(f"{name}.{n}" if name else n for n in stacked())
    return out


def _pp_stacks(model: nn.Module) -> Dict[str, nn.Module]:
    """The stacked parameters of ``model``'s pipelined stacks (each rank
    holds its block of the JAX stack's layer dim), by name, to their
    stack."""
    out = {}
    for name, mod in model.named_modules():
        if getattr(mod, "init_stacked", None) is not None:
            for sn in mod._stacked_names:
                out[f"{name}.{sn}" if name else sn] = mod
    return out


def _state_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    """What the JAX ``state_dict()`` holds: every parameter and every
    persistent buffer (BatchNorm's ``_mean`` and ``_variance``), by
    name."""
    out = dict(model.named_parameters())
    keys = model.state_dict().keys()
    out.update((n, b) for n, b in model.named_buffers() if n in keys)
    return out


def port_state_from_jax(model: nn.Module,
                        state: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """``state`` (the JAX model's ``state_dict()`` under the JAX names, as
    numpy arrays, bf16 ones included, or tensors) in the port's layout for ``model``: each JAX
    ``Linear`` weight ``[in, out]`` transposed into torch's ``[out, in]``
    (a view), every other tensor as it is; a pipelined stack's stacked
    weight (the JAX global ``[L, ...]``, in ``chunk_permutation`` order)
    cut to this rank's block of its layer dim; a parameter that ``model``
    cuts over ``mp`` (a tensor-parallel layout) cut to this rank's part,
    block by block for a packed projection. Every parameter and persistent
    buffer must be given, and nothing else, each at its shape; ``model`` is
    not touched."""
    linear = _linear_weights(model)
    params = _state_tensors(model)
    cut = _parallel.shard_specs(model)
    stacks = _pp_stacks(model)
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"load_jax_state: missing {missing}, "
                       f"unexpected {unexpected}")
    out = {}
    for name, param in params.items():
        value = state[name]
        if not isinstance(value, torch.Tensor):
            arr = np.asarray(value)
            value = (torch.from_numpy(arr.astype(np.float32)).to(
                torch.bfloat16) if arr.dtype.name == "bfloat16"
                else torch.tensor(arr))
        if name in stacks:
            lo, hi = stacks[name].block
            value = value[lo:hi]
        if name in linear:
            value = value.transpose(-1, -2)
        if name in cut:
            from ..distributed.fleet.mpu import shard_of

            value = shard_of(value, cut[name])
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"load_jax_state: {name} is "
                             f"{tuple(value.shape)}, the port expects "
                             f"{tuple(param.shape)}")
        out[name] = value
    return out


@torch.no_grad()
def load_jax_state(model: nn.Module,
                   state: Mapping[str, object]) -> nn.Module:
    """Fill ``model`` (the port's GPT, Llama, BERT or ResNet) from the JAX
    model's ``state_dict()`` given under the JAX names, which the port's
    parameter and buffer names match name for name. With
    :func:`jax_state_dict`, the one place that knows both layouts: a JAX
    ``Linear`` weight is ``[in, out]`` and is transposed into torch's
    ``[out, in]``; every other tensor copies as it is, into the port
    tensor's dtype. Every parameter and persistent buffer must be given,
    and nothing else."""
    params = _state_tensors(model)
    for name, value in port_state_from_jax(model, state).items():
        params[name].copy_(value)
    return model


def jax_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`load_jax_state`: ``model``'s parameters and
    persistent buffers under the JAX names in the JAX layout, each
    ``Linear`` weight as ``[in, out]``. The tensors are views of the
    model's storage (no copy), except the parameters a tensor-parallel
    model cuts over ``mp``, which are all-gathered whole (every ``mp`` rank
    must call it), and a pipelined stack's stacked ones, all-gathered
    along their layer dim over ``pp`` (every ``pp`` rank must call it); a
    checkpoint written from them (``save_sharded``) is in the reference's
    layout, whichever package wrote it."""
    linear = _linear_weights(model)
    cut = _parallel.shard_specs(model)
    stacks = _pp_stacks(model)
    out = {}
    for name, p in _state_tensors(model).items():
        value = p.detach()
        if name in cut:
            from ..distributed.fleet.mpu import gather_param

            value = gather_param(value, cut[name])
        if name in stacks and stacks[name].num_stages > 1:
            from ..distributed import communication

            value = communication._all_gather(
                value.contiguous(), stacks[name]._comm).flatten(0, 1)
        out[name] = value.transpose(-1, -2) if name in linear else value
    return out


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
