"""The transformer stack (port of ``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention`` (with incremental-decode caches),
``TransformerEncoderLayer``/``TransformerEncoder``,
``TransformerDecoderLayer``/``TransformerDecoder`` and ``Transformer``.

Attention runs through ``F.scaled_dot_product_attention`` with the mask
and ``dropout_p``, never ``is_causal``, as the JAX layers call it: an
unmasked call (encoder self-attention without ``src_mask``, decoder
cross-attention without ``memory_mask``, a cached decode step) runs the
hand-written flash-attention kernels K1–K3 on the GPU, dropout by their
in-kernel hash; a masked one (decoder self-attention under
``generate_square_subsequent_mask``) the ``_xla_attention`` composition.
``need_weights`` takes the explicit-softmax path. Caches are returned, not
mutated. Dropout draws from the process-wide dropout generator of the
default device, which each layer holds from its construction
(``layers.held_generator``), so a captured step registers it and a
snapshot saves it.

The encoder and decoder copy their layer with ``copy.deepcopy``, as in
JAX: every copy starts bit for bit the template's, with fresh
``Parameter`` s. Parameters are built as the layers' own are (on the
default device, from the build generator, in construction order).
"""
from __future__ import annotations

import collections
import copy

import torch

from ...core.tensor import plain, wrap
from ...device import DEFAULT_DEVICE, resolve_device
from ...ops.activation import softmax
from ...ops.math import matmul
from .. import functional as F
from .common import Dropout, LayerNorm, Linear
from .container import LayerList
from .layers import Layer, held_generator

__all__ = ["MultiHeadAttention", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask (True keeps) as an additive mask in ``dtype``: 0 where
    kept, -1e9 elsewhere; a float mask cast to ``dtype``."""
    if attn_mask is None:
        return None
    m = plain(attn_mask)
    if m.dtype == torch.bool:
        return torch.where(m, torch.zeros((), dtype=dtype, device=m.device),
                           torch.full((), -1e9, dtype=dtype, device=m.device))
    return m.to(dtype)


class MultiHeadAttention(Layer):
    """Attention over ``[batch, seq, embed_dim]`` inputs in ``num_heads``
    heads. With a ``cache`` the forward returns ``(out, new_cache)`` (and
    the weights between them with ``need_weights``)."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.dropout = dropout
        self.need_weights = need_weights
        self.generator = held_generator(None, dropout > 0.0)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """``type=StaticCache`` (or a ``value``): the projected keys and
        values of ``key``/``value`` (cross-attention memory); else an
        empty ``Cache`` ``[B, 0, H, D]`` pair that decoding extends."""
        key = plain(key)
        if type == MultiHeadAttention.StaticCache or value is not None:
            value = key if value is None else plain(value)
            return MultiHeadAttention.StaticCache(
                self._split_heads(self.k_proj(key)),
                self._split_heads(self.v_proj(value)))
        empty = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                            dtype=key.dtype, device=key.device)
        return MultiHeadAttention.Cache(empty, empty)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        query = plain(query)
        key = query if key is None else plain(key)
        value = key if value is None else plain(value)
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = MultiHeadAttention.Cache(k, v)
        mask = _convert_attention_mask(attn_mask, torch.float32)
        weights = None
        if self.need_weights:
            # the explicit softmax (the kernels never form the weights):
            # [B, S, H, D] -> [B, H, S, T] scores
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            product = matmul(qt, kt, transpose_y=True) * self.head_dim ** -0.5
            if mask is not None:
                product = product + mask
            weights = softmax(product)
            dropped = F.dropout(weights, self.dropout,
                                training=self.training,
                                generator=self.generator)
            out = matmul(dropped, vt).transpose(1, 2)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=self.dropout,
                training=self.training, generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if cache is not None:
            outs.append(cache)
        return outs[0] if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(Layer):
    """Self-attention then a feed-forward block, each with dropout and a
    residual, LayerNorm after each (before with ``normalize_before``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        src = plain(src)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself), then ``norm`` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = plain(src)
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over ``memory``, then a
    feed-forward block, each with dropout, a residual and a LayerNorm."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        tgt, memory = plain(tgt), plain(memory)
        self_cache, static_cache = cache if cache is not None else (None,
                                                                    None)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if self_cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, self_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             self_cache)
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if static_cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, static_cache)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (self_cache, static_cache))

    def gen_cache(self, memory):
        self_cache = self.self_attn.gen_cache(memory,
                                              type=MultiHeadAttention.Cache)
        static_cache = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return self_cache, static_cache


class TransformerDecoder(Layer):
    """``num_layers`` copies of ``decoder_layer`` (the first is the layer
    itself), then ``norm`` if given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = plain(tgt)
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask,
                                  cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            caches = list(zip(*caches))
        return caches


class Transformer(Layer):
    """The encoder-decoder; its defaults are Transformer-base (d_model
    512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            encoder_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            encoder_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(encoder_layer,
                                              num_encoder_layers,
                                              encoder_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            decoder_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            decoder_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(decoder_layer,
                                              num_decoder_layers,
                                              decoder_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """``[length, length]`` f32: 0 on and below the diagonal, -inf
        above, on the layer's device."""
        p = next(iter(self.parameters()), None)
        dev = p.device if p is not None else resolve_device(DEFAULT_DEVICE)
        keep = torch.ones(length, length, dtype=torch.bool, device=dev).tril()
        return wrap(torch.where(keep, 0.0, float("-inf")).float())
