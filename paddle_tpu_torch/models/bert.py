"""BERT/ERNIE encoders (port of ``paddle_tpu/models/bert.py``), single
device: the fine-tuning family of ``bench.py``'s BERT arm.

Same config, presets, module tree and parameter names as the JAX models,
so ``state_dict`` keys match name for name and :func:`load_jax_state`
carries JAX weights across (each ``Linear`` weight transposed from the JAX
``[in, out]`` to torch's ``[out, in]``; :func:`jax_state_dict` is the
inverse). ERNIE is a preset of the same trunk.

- Embeddings: word, position and token-type rows summed, LayerNorm at
  ``layer_norm_eps`` (1e-12), dropout.
- Attention: one fused qkv projection viewed as ``[B, S, H, 3, D]`` (heads
  outermost, then q/k/v), so q, k and v are strided views of it, without a
  copy; then ``F.scaled_dot_product_attention``, non-causal: K1 forward and
  K2/K3 backward on the GPU without a mask. A padding mask takes the JAX
  route for masks, the torch composition of ``_xla_attention``.
- Post-LN blocks (LayerNorm after each residual sum), the MLP's GELU in its
  exact (erf) form; the pooler is ``tanh(dense(h[:, 0]))``.
- ``BertModel`` turns a 2-D ``[B, S]`` keep-mask (1 keeps) into the
  additive bias ``(1 − m)·−1e4`` of shape ``[B, 1, 1, S]``.

Under AMP the sums, the GELU, the tanh and the mask's arithmetic are gray
ops, as in the JAX package: O2 computes them in the AMP dtype, so a
LayerNorm's f32 output meets the bf16 branch in bf16 (``ops.math.add``).

Randomness is explicit, as in ``models/gpt.py``: weights are normal with
std ``initializer_range`` from a ``torch.Generator`` on the CPU (biases
0, LayerNorms 1 and 0), dropout draws from the model's own generator on
its device, seeded by ``dropout_seed``.

``tensor_parallel`` (JAX ``models/bert.py:50-130``, one process a rank over
``distributed.fleet``): ``qkv``/``fc1`` column-parallel and ``out``/``fc2``
row-parallel over ``mp``, the qkv ``[heads, 3, D]``-major as in GPT, so
each rank holds whole heads; the word embeddings vocab-parallel. The
pretraining head's tied decoder gathers the whole logits. Attention
dropout on a rank's own heads draws from the RNG tracker's
``model_parallel_rng``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..amp.auto_cast import cast_inputs
from ..device import DEFAULT_DEVICE, resolve_device
from ..nn import functional as F
from ..nn.layer import Dropout, Embedding, LayerNorm, Linear
from ..nn.layer.layers import Layer, building
from ..ops.math import add
from . import _parallel
from .gpt import jax_state_dict, load_jax_state, port_state_from_jax

__all__ = ["BertConfig", "BertEmbeddings", "BertSelfAttention", "BertLayer",
           "BertPooler", "BertModel", "BertForSequenceClassification",
           "BertForPretraining", "jax_state_dict", "load_jax_state",
           "port_state_from_jax", "bert_tiny", "bert_base", "bert_large",
           "ernie_base"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    tensor_parallel: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class BertEmbeddings(Layer):
    def __init__(self, config: BertConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        if config.tensor_parallel:
            self.word_embeddings = _parallel.vocab_embedding(
                config.vocab_size, h)
        else:
            self.word_embeddings = Embedding(config.vocab_size, h)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h)
        self.layer_norm = LayerNorm(h, eps=config.layer_norm_eps)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape[0], input_ids.shape[-1]
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(s, device=dev).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros(b, s, dtype=torch.int64, device=dev)
        x = add(add(self.word_embeddings(input_ids),
                      self.position_embeddings(position_ids)),
                 self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(Layer):
    """Fused-qkv bidirectional attention with an optional additive mask;
    attention dropout draws from ``generator`` (under ``tensor_parallel``
    the rank's own stream)."""

    def __init__(self, config: BertConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.generator = generator
        h = config.hidden_size
        if config.tensor_parallel:
            col, row = _parallel.linears(config)
            self.qkv = col(h, 3 * h, has_bias=True, gather_output=False)
            self.out = row(h, h, has_bias=True, input_is_parallel=True)
        else:
            self.qkv = Linear(h, 3 * h)
            self.out = Linear(h, h)

    def forward(self, x, attention_mask=None):
        cfg = self.config
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv(x)
        heads = qkv.shape[-1] // (3 * cfg.head_dim)
        qkv = qkv.reshape(b, s, heads, 3, cfg.head_dim)
        q, k, v = qkv[:, :, :, 0, :], qkv[:, :, :, 1, :], qkv[:, :, :, 2, :]
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attention_mask, is_causal=False,
            dropout_p=cfg.attention_probs_dropout_prob,
            training=self.training, generator=self.generator)
        return self.out(out.reshape(b, s, heads * cfg.head_dim))


class BertLayer(Layer):
    """Post-LN block (original BERT ordering)."""

    def __init__(self, config: BertConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        ffn = config.intermediate_size
        self.attention = BertSelfAttention(config, attention_generator(
            config, generator))
        self.attn_norm = LayerNorm(h, eps=eps)
        if config.tensor_parallel:
            col, row = _parallel.linears(config)
            self.fc1 = col(h, ffn, has_bias=True, gather_output=False)
            self.fc2 = row(ffn, h, has_bias=True, input_is_parallel=True)
        else:
            self.fc1 = Linear(h, ffn)
            self.fc2 = Linear(ffn, h)
        self.ffn_norm = LayerNorm(h, eps=eps)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=generator)

    def forward(self, x, attention_mask=None):
        h = self.attention(x, attention_mask)
        x = self.attn_norm(add(x, self.dropout(h)))
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.ffn_norm(add(x, self.dropout(h)))


class BertPooler(Layer):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size)

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


def _model_device(config: BertConfig, device) -> torch.device:
    return resolve_device(device)


def attention_generator(config: BertConfig,
                        generator: Optional[torch.Generator]):
    """The attention dropout's stream: the model's, or under
    ``tensor_parallel`` the tracker's per-rank one on its device."""
    if not config.tensor_parallel or generator is None:
        return generator
    return _parallel.local_generator(generator.device)


def _building(model: nn.Module, config: BertConfig, device: torch.device,
              generator: Optional[torch.Generator]):
    """``nn.layer.layers.building`` with BERT's initializers: the
    outermost model under construction draws its weights from
    ``generator``, moves to ``device`` and names its parameters."""
    return building(model, device, generator,
                    lambda m, gen: _init_weights(m, config, gen))


@torch.no_grad()
def _init_weights(model: nn.Module, config: BertConfig,
                  gen: torch.Generator) -> None:
    """Normal(0, ``initializer_range``) for every Linear and Embedding
    weight, 0 for biases, 1 and 0 for LayerNorms, as the JAX models."""
    for mod in model.modules():
        if isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Embedding)):
            _parallel.normal_(mod, "weight", config.initializer_range, gen)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
    if isinstance(getattr(model, "decoder_bias", None), nn.Parameter):
        model.decoder_bias.zero_()


class BertModel(Layer):
    """Trunk: embeddings → post-LN encoder stack → pooler; returns
    ``(sequence_output, pooled_output)``. Built on ``device`` (default
    CUDA; raises when CUDA is absent and the caller did not ask for the
    CPU), weights from ``generator``, dropout from ``dropout_generator``, a
    generator on ``device`` seeded ``dropout_seed``."""

    def __init__(self, config: BertConfig, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        dev = _model_device(config, device)
        self.config = config
        self.dropout_generator = torch.Generator(device=dev).manual_seed(
            int(dropout_seed))
        with _building(self, config, dev, generator):
            self.embeddings = BertEmbeddings(config, self.dropout_generator)
            self.encoder = nn.ModuleList(
                [BertLayer(config, self.dropout_generator)
                 for _ in range(config.num_hidden_layers)])
            self.pooler = BertPooler(config)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.ndim == 2:
            # [B, S] 1 = keep → additive [B, 1, 1, S] over heads and queries
            (m,) = cast_inputs("subtract",
                               attention_mask[:, None, None, :].float())
            attention_mask = (1.0 - m) * -1e4
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            x = layer(x, attention_mask)
        return x, self.pooler(x)


class BertForSequenceClassification(Layer):
    """The trunk's pooled output → dropout → a ``num_classes`` Linear.
    ``device``, ``generator`` and ``dropout_seed`` as :class:`BertModel`."""

    def __init__(self, config: BertConfig, num_classes: int = 2, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        dev = _model_device(config, device)
        self.config = config
        with _building(self, config, dev, generator):
            self.bert = BertModel(config, device=dev,
                                  dropout_seed=dropout_seed)
            self.dropout = Dropout(config.hidden_dropout_prob,
                                   generator=self.bert.dropout_generator)
            self.classifier = Linear(config.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))


class BertForPretraining(Layer):
    """MLM head, its decoder tied to the word embeddings
    (``linear(h, Wᵀ) + decoder_bias``), and the NSP head. ``device``,
    ``generator`` and ``dropout_seed`` as :class:`BertModel`."""

    def __init__(self, config: BertConfig, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        dev = _model_device(config, device)
        self.config = config
        h = config.hidden_size
        with _building(self, config, dev, generator):
            self.bert = BertModel(config, device=dev,
                                  dropout_seed=dropout_seed)
            self.transform = Linear(h, h)
            self.transform_norm = LayerNorm(h, eps=config.layer_norm_eps)
            self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size))
            self.nsp = Linear(h, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, None,
                                attention_mask)
        h = self.transform_norm(F.gelu(self.transform(seq)))
        # the word embeddings [V, H] are the tied decoder's [out, in] weight
        w = self.bert.embeddings.word_embeddings.weight
        if self.config.tensor_parallel:
            from ..distributed.fleet import mpu

            logits = mpu.gather_from_model_parallel(
                F.linear(mpu.copy_to_model_parallel(h), w))
        else:
            logits = F.linear(h, w)
        return add(logits, self.decoder_bias), self.nsp(pooled)


# ---------------------------------------------------------------- presets

def bert_tiny(**overrides) -> BertConfig:
    base = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=128,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    base.update(overrides)
    return BertConfig(**base)


def bert_base(**overrides) -> BertConfig:
    return BertConfig(**overrides)


def bert_large(**overrides) -> BertConfig:
    base = dict(hidden_size=1024, num_hidden_layers=24,
                num_attention_heads=16, intermediate_size=4096)
    base.update(overrides)
    return BertConfig(**base)


def ernie_base(**overrides) -> BertConfig:
    """ERNIE-3.0-base: BERT-base's trunk with ERNIE's vocab and type
    sizes."""
    base = dict(vocab_size=40000, type_vocab_size=4)
    base.update(overrides)
    return BertConfig(**base)
