"""Continuous-batching GPT decode (port of ``paddle_tpu/serving/decode.py``).

- :class:`DecodePrograms` — the slot family: prefill and decode-step
  programs written straight over the engine's own copy of a
  ``models.gpt.GPTForCausalLM``'s parameters against a
  :class:`~.kv_cache.KVSlotPool`, one full ``max_seq`` row per request.
  Greedy only: the oracle the paged family is held against.
- :class:`PagedDecodePrograms` — the same programs over a
  :class:`~.kv_cache.KVPagePool` through per-request block tables, with
  sampled decoding (temperature, top-k, top-p, a per-request seed; drawn
  as ``jax.random.categorical`` draws, see :mod:`.sampling`) and, with
  ``speculate_k > 0``, self-speculative decoding: a ``draft`` program
  runs ``speculate_k`` steps through the first ``draft_layers`` blocks,
  a ``verify`` program scores all ``k + 1`` positions with the full
  model, and the committed tokens always come from ``verify``.
- :class:`DecodeEngine` — the serving front door: admission control,
  tenants, circuit breakers, the telemetry exporter, retries, weight
  hot-swap (:meth:`DecodeEngine.swap_weights`), and a scheduler thread
  running the join/leave loop.

Each program family is a ``jit.functionalize.CompiledFunction`` whose
signatures are the rungs: ``("prefill", b, s)``, ``("decode", b)`` or
``("decode", b, t)``, and ``("draft", b, t)``/``("verify", b, t)``. On
CUDA, :meth:`DecodePrograms.warmup` calls every rung twice: the first
call runs eagerly, the second captures it as a CUDA graph in a memory
pool the engine's graphs share. Every later call is a replay, and a
signature met after warmup counts in ``compiles_after_warmup``. The
programs close over the weights and the pool; only the small per-call
tensors (tokens, lengths, slots or tables, positions, sampling
arguments) are arguments, and the pool is updated in place inside the
graph. On the CPU every call runs eagerly.

The engine owns its weights. :class:`DecodePrograms` copies the model's
parameters once, at construction, onto the pool's device, and every
family and every graph runs on that copy, as the JAX engine keeps the
immutable arrays it extracted: what the model's owner later does to the
model (an optimizer step, ``load_jax_state``) never reaches the engine.
The graphs hold the copy's addresses, so ``self.params`` and its tensors
are never rebound: a weight swap copies new values into that storage,
under the programs lock that every call holds from launch to its tokens'
copy to the host, on the stream the replays use, and waits for the copy
before the next call: it lands between two calls.

Prefill attention goes through ``nn.functional.scaled_dot_product_attention``
and so through the hand-written flash-attention forward kernel, one
launch per layer. The decode step's single-query attention and the
sampling draw are plain PyTorch, as they are plain jnp in the JAX
package.

A request's tokens are the same alone or in a full batch and in either
KV mode, and with or without speculation — exactly on the CPU; on the
GPU up to near-ties, since cuBLAS may round differently at another
width.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as TF

from ..base.flags import get_flag
from ..device import DEFAULT_DEVICE, resolve_device
from ..distributed.checkpoint.sharded import load_sharded_like
from ..jit.bucketing import powers_of_two_buckets, table_ladder
from ..jit.functionalize import CompiledFunction
from ..models.gpt import (check_single_device, jax_state_dict,
                          port_state_from_jax)
from ..nn.functional import scaled_dot_product_attention
from ..observability.locks import named_lock
from ..observability.metrics import registry
from ..ops.cuda import flash_attention
from ..reliability.policy import RetryPolicy
from . import kv_cache as kvc
from . import sampling
from .engine import EngineBase
from .kv_cache import KVPagePool, KVSlotPool
from .request_queue import DecodeRequest
from .scheduler import DecodeScheduler, PagedDecodeScheduler

__all__ = ["DecodeEngine", "DecodePrograms", "PagedDecodePrograms"]

_MASK32 = 0xFFFFFFFF


def _param_tree(cfg, get) -> dict:
    """The programs' parameter dict for a GPT of config ``cfg``, each
    tensor ``get(name)`` under the port's parameter name. Linear weights
    are ``[out, in]`` for ``F.linear``."""
    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"gpt.h.{i}."
        blocks.append({
            "ln1_w": get(p + "ln_1.weight"), "ln1_b": get(p + "ln_1.bias"),
            "qkv_w": get(p + "attn.qkv_proj.weight"),
            "qkv_b": get(p + "attn.qkv_proj.bias"),
            "out_w": get(p + "attn.out_proj.weight"),
            "out_b": get(p + "attn.out_proj.bias"),
            "ln2_w": get(p + "ln_2.weight"), "ln2_b": get(p + "ln_2.bias"),
            "fc1_w": get(p + "mlp.fc1.weight"),
            "fc1_b": get(p + "mlp.fc1.bias"),
            "fc2_w": get(p + "mlp.fc2.weight"),
            "fc2_b": get(p + "mlp.fc2.bias"),
        })
    params = {
        "wte": get("gpt.embeddings.word_embeddings.weight"),
        "wpe": get("gpt.embeddings.position_embeddings.weight"),
        "lnf_w": get("gpt.ln_f.weight"),
        "lnf_b": get("gpt.ln_f.bias"),
        "blocks": blocks,
    }
    if not cfg.tie_word_embeddings:
        params["head_w"] = get("lm_head.weight")
    return params


def _extract_gpt(model):
    """The model's parameters as the programs' dict (views of the model's
    own storage, no copy) plus its config. Only the single-device GPT
    serves here."""
    cfg = model.config
    check_single_device(cfg)
    named = dict(model.named_parameters())
    return _param_tree(cfg, lambda name: named[name].detach()), cfg


def _map_tree(fn, params: dict) -> dict:
    """``params`` with ``fn`` applied to each tensor."""
    out = {k: fn(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: fn(v) for k, v in b.items()}
                     for b in params["blocks"]]
    return out


def _flatten(params: dict):
    """The tensors of a parameter dict in a fixed order, and its structure
    (keys and block count)."""
    leaves, spec = [], []
    for key in sorted(params):
        if key == "blocks":
            blocks = params[key]
            spec.append((key, tuple(tuple(sorted(b)) for b in blocks)))
            leaves += [b[k] for b in blocks for k in sorted(b)]
        else:
            spec.append(key)
            leaves.append(params[key])
    return leaves, tuple(spec)


def _ln(x, w, b, eps):
    return TF.layer_norm(x, (x.shape[-1],), w, b, eps)


class DecodePrograms:
    """The decode tier's programs over one GPT's weights and a slot pool.

    - ``prefill``: ``[B, S]`` prompt tokens → every layer's K/V written
      into the lanes' slots (rows ``:S``) and the first generated token
      per lane (greedy), from its last real position.
    - ``decode``: ``[B]`` last tokens at ``[B]`` positions → K/V written
      at ``(slot, position)``, one attention step per lane over its slot's
      rows (columns ≤ position), the next token per lane (greedy).

    Padding lanes name the pool's pad slot. The public calls take host
    integer arrays padded to their rungs and return the chosen tokens as
    a host array. ``traces`` counts the signatures the program families
    met; on CUDA each is captured as a CUDA graph at warmup.

    ``params`` is the programs' own copy of the model's parameters, made
    at construction on the pool's device; :meth:`swap_params` copies new
    values into it between two calls.
    """

    FAMILIES = ("prefill", "decode")

    def __init__(self, model, pool, *,
                 seq_ladder: Sequence[int],
                 prefill_batch_rungs: Sequence[int],
                 decode_rungs: Sequence[int]):
        params, cfg = _extract_gpt(model)
        self.pool = pool
        self.device = pool.device
        # the engine's own weights: one copy, never rebound (the graphs
        # hold its addresses; a swap copies into it)
        self.params = self._stage(params, copy=True)
        self._lock = named_lock("serving.decode.programs")
        # a slot's rows; the paged family sets its own after this
        self.max_seq = getattr(pool, "max_seq", None)
        self.seq_ladder = sorted(int(s) for s in seq_ladder)
        self.prefill_batch_rungs = sorted(int(b) for b in prefill_batch_rungs)
        self.decode_rungs = sorted(int(b) for b in decode_rungs)
        self._heads = cfg.num_attention_heads
        self._head_dim = cfg.head_dim
        self._hidden = cfg.hidden_size
        self._max_pos = int(cfg.max_position_embeddings)
        self._eps = float(cfg.layer_norm_epsilon)
        self._tied = bool(cfg.tie_word_embeddings)
        self._scale = 1.0 / math.sqrt(cfg.head_dim)
        self.warmed: List[tuple] = []
        # one memory pool and one capture stream for every graph of the
        # engine: one rung runs at a time and its outputs are cloned before
        # the next
        cuda = self.device.type == "cuda"
        self.graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        stream = torch.cuda.Stream(self.device) if cuda else None
        # the stream every call replays (and every swap copies) on
        self.replay_stream = (torch.cuda.default_stream(self.device)
                              if cuda else None)
        self._compiled = {
            family: CompiledFunction(self._program(family),
                                     name=f"serving.{family}",
                                     device=self.device,
                                     pool=self.graph_pool, stream=stream)
            for family in self.FAMILIES}

    def _program(self, family: str):
        """The family's program over the live parameters and pool: only
        the per-call tensors are arguments, so a replay copies nothing
        large."""
        fn = getattr(self, f"_{family}_fn")

        def program(*args):
            return fn(self._call_params(family), *args)

        program.__name__ = f"{family}_program"
        return program

    def _call_params(self, family: str) -> dict:
        """The parameter dict a family runs against (the paged family's
        draft runs against the truncated-layer view)."""
        return self.params

    # ------------------------------------------------------------ programs
    def _logits_head(self, params, x):
        return TF.linear(x, params["wte"] if self._tied else params["head_w"])

    def _block_mlp(self, blk, x):
        h2 = _ln(x, blk["ln2_w"], blk["ln2_b"], self._eps)
        h2 = TF.gelu(TF.linear(h2, blk["fc1_w"], blk["fc1_b"]),
                     approximate="tanh")
        return x + TF.linear(h2, blk["fc2_w"], blk["fc2_b"])

    def _qkv(self, blk, x, shape):
        h = _ln(x, blk["ln1_w"], blk["ln1_b"], self._eps)
        qkv = TF.linear(h, blk["qkv_w"], blk["qkv_b"]).view(
            *shape, self._heads, 3, self._head_dim)
        return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]

    def _attend_step(self, blk, x, q, keys, vals, mask):
        """One decode step's attention and MLP for ``[B]`` single-query
        lanes over gathered ``[B, cols, heads, head_dim]`` K/V."""
        B = x.shape[0]
        keys, vals = keys.to(x.dtype), vals.to(x.dtype)
        logits = torch.einsum("bhd,bthd->bht", q, keys) * self._scale
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        att = torch.einsum("bht,bthd->bhd", probs, vals).reshape(
            B, self._hidden)
        x = x + TF.linear(att, blk["out_w"], blk["out_b"])
        return self._block_mlp(blk, x)

    def _prefill_trunk(self, params, tokens, lengths):
        """``[B, S]`` prompt tokens → per-lane head logits at the last
        real position plus the stacked K/V rows ``[layers, B, S, heads,
        head_dim]``. Rows past a lane's prompt are garbage and are never
        attended by its real rows (causal)."""
        B, S = tokens.shape
        x = params["wte"][tokens] + params["wpe"][:S][None]
        ks, vs = [], []
        for blk in params["blocks"]:
            q, k, v = self._qkv(blk, x, (B, S))
            ks.append(k)
            vs.append(v)
            att = scaled_dot_product_attention(q, k, v, is_causal=True,
                                               training=False)
            x = x + TF.linear(att.reshape(B, S, self._hidden),
                              blk["out_w"], blk["out_b"])
            x = self._block_mlp(blk, x)
        x_last = x[torch.arange(B, device=x.device), lengths - 1]
        hfin = _ln(x_last, params["lnf_w"], params["lnf_b"], self._eps)
        return (self._logits_head(params, hfin), torch.stack(ks),
                torch.stack(vs))

    def _prefill_fn(self, params, tokens, lengths, slot_ids):
        head, krows, vrows = self._prefill_trunk(params, tokens, lengths)
        kvc.write_prompt_batch(self.pool.k, slot_ids, krows)
        kvc.write_prompt_batch(self.pool.v, slot_ids, vrows)
        return torch.argmax(head, dim=-1)

    def _decode_fn(self, params, tokens, slot_ids, positions):
        ck, cv = self.pool.k, self.pool.v
        x = params["wte"][tokens] + params["wpe"][positions]
        col = torch.arange(self.pool.max_seq, device=x.device)
        mask = col[None, None, :] <= positions[:, None, None]
        for li, blk in enumerate(params["blocks"]):
            q, k, v = self._qkv(blk, x, (tokens.shape[0],))
            # write this token's K/V at (layer, slot, position), then
            # attend over the slot's rows 0..position inclusive
            kvc.append_token(ck, li, slot_ids, positions, k)
            kvc.append_token(cv, li, slot_ids, positions, v)
            x = self._attend_step(blk, x, q, ck[li][slot_ids],
                                  cv[li][slot_ids], mask)
        hfin = _ln(x, params["lnf_w"], params["lnf_b"], self._eps)
        return torch.argmax(self._logits_head(params, hfin), dim=-1)

    # -------------------------------------------------------------- rungs
    @property
    def rungs(self) -> List[tuple]:
        """Every signature warmup arms: ``("decode", b)`` per batch rung
        plus ``("prefill", b, s)`` over the (batch × seq) grid."""
        out = [("decode", b) for b in self.decode_rungs]
        out += [("prefill", b, s) for b in self.prefill_batch_rungs
                for s in self.seq_ladder]
        return out

    def _zero_args(self, key):
        pad = self.pool.pad_slot
        if key[0] == "decode":
            b = key[1]
            return (np.zeros(b, np.int64), np.full(b, pad, np.int64),
                    np.zeros(b, np.int64))
        _, b, s = key
        return (np.zeros((b, s), np.int64), np.ones(b, np.int64),
                np.full(b, pad, np.int64))

    def warmup(self) -> List[tuple]:
        """Arm every rung against the pad slot or page: build the kernels
        (on CUDA), then call each rung once eagerly and, on CUDA, once
        more, which captures its graph. Idempotent per rung."""
        if self.device.type == "cuda":
            flash_attention.build()
        for key in self.rungs:
            if key in self.warmed:
                continue
            call = getattr(self, key[0])
            args = self._zero_args(key)
            call(*args)
            if self.device.type == "cuda":
                call(*args)
            self.warmed.append(key)
        return list(self.warmed)

    # ---------------------------------------------------------- accounting
    def graph_report(self) -> dict:
        """Per family: signatures met, graphs captured, calls replayed and
        calls run eagerly (pure reads)."""
        out = {}
        for family, fn in self._compiled.items():
            audit = fn.audit_report()
            out[family] = {"signatures": audit["n_cache_keys"],
                           "captures": audit["total_captures"],
                           "replays": audit["stats"]["compiled_steps"],
                           "eager": audit["stats"]["eager_steps"]}
        return out

    @property
    def traces(self) -> int:
        """Signatures the program families met: one per rung at warmup.
        On CUDA each is captured there, so this equals the captures."""
        return sum(r["signatures"] for r in self.graph_report().values())

    # -------------------------------------------------------------- calls
    def _tensor(self, a):
        a = np.asarray(a)
        dtype = np.float32 if a.dtype.kind == "f" else np.int64
        return torch.as_tensor(a.astype(dtype, copy=False),
                               device=self.device)

    @contextlib.contextmanager
    def _guard(self):
        """The programs lock and, on CUDA, the pool's card and the replay
        stream: every call holds it from its launch to its tokens' copy to
        the host, and every swap from its first copy to the stream's
        synchronize, so a swap lands between two calls."""
        with self._lock:
            if self.device.type != "cuda":
                yield
                return
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.replay_stream):
                yield

    @torch.inference_mode()
    def _call(self, family: str, *arrays) -> np.ndarray:
        with self._guard():
            out = self._compiled[family](*(self._tensor(a) for a in arrays))
            return out.cpu().numpy()

    @torch.inference_mode()
    def run_eager(self, family: str, *arrays) -> np.ndarray:
        """The family's program run eagerly on the same host arrays,
        outside its cache and graphs: the reference a replay is held to."""
        with self._guard():
            out = getattr(self, f"_{family}_fn")(
                self._call_params(family),
                *(self._tensor(a) for a in arrays))
            return out.cpu().numpy()

    # ------------------------------------------------------------ hot swap
    def _stage(self, params: dict, copy: bool) -> dict:
        """``params`` on the pool's device (copied when ``copy``, else
        moved only where it lies elsewhere): the host or card work of a
        swap, finished before the programs lock is taken."""
        out = _map_tree(lambda t: t.detach().to(self.device, copy=copy),
                        params)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def _flip_params(self, staged: dict) -> None:
        """The copy a hot swap commits: ``staged`` (on the pool's device)
        into the programs' own weights, under the programs lock, on the
        replay stream, which is synchronized before the lock is released.
        ``self.params`` is never rebound (the graphs hold its addresses),
        and the draft view shares its tensors, so every family, the
        draft's included, runs with the new weights from the next call
        on."""
        with torch.no_grad(), self._guard():
            for dst, src in zip(_flatten(self.params)[0],
                                _flatten(staged)[0]):
                dst.copy_(src)
            if self.device.type == "cuda":
                self.replay_stream.synchronize()

    def _swap_tree(self, params: dict, copy: bool = True) -> int:
        """Hot-swap ``params`` (the programs' dict of a twin model) into
        the programs between two calls; returns the number of tensors
        swapped. The structure, each shape and each dtype must be the
        serving ones (``ValueError``), so every captured graph keeps
        replaying. ``params`` is staged on the card first, outside the
        lock (a copy when ``copy``), then :meth:`_flip_params` copies it
        in."""
        old_leaves, old_spec = _flatten(self.params)
        new_leaves, new_spec = _flatten(params)
        if old_spec != new_spec:
            raise ValueError(
                "swap_params: the new model's parameter tree differs "
                "structurally from the serving one — a decode hot swap "
                "must carry the same architecture")
        for i, (o, n) in enumerate(zip(old_leaves, new_leaves)):
            if tuple(o.shape) != tuple(n.shape) or o.dtype != n.dtype:
                raise ValueError(
                    f"swap_params: leaf {i} is {tuple(n.shape)}/{n.dtype}, "
                    f"decode programs expect {tuple(o.shape)}/{o.dtype}")
        self._flip_params(self._stage(params, copy))
        return len(new_leaves)

    def swap_params(self, model) -> int:
        """Hot-swap ``model``'s weights (a live twin of the serving model,
        on any device) into the programs between two calls; ``model`` is
        read, never changed. Returns the number of tensors swapped."""
        params, _cfg = _extract_gpt(model)
        return self._swap_tree(params, copy=True)

    def prefill(self, tokens, lengths, slot_ids) -> np.ndarray:
        return self._call("prefill", tokens, lengths, slot_ids)

    def decode(self, tokens, slot_ids, positions) -> np.ndarray:
        return self._call("decode", tokens, slot_ids, positions)


class PagedDecodePrograms(DecodePrograms):
    """The decode programs over a :class:`~.kv_cache.KVPagePool`.

    - K/V is indexed through per-request block tables, a ``[B, T]``
      integer tensor naming each lane's pages in order; page churn never
      meets a new signature.
    - decode rungs key on (batch rung × table rung): ``("decode", b,
      t)``, so a short context pays a short gather.
    - sampling rides as per-lane tensors (temperature, top-k, top-p and
      the raw key ``[seed, token_index]``); ``temp == 0`` lanes take the
      argmax, the greedy mode the slot family is held against.

    With ``speculate_k > 0``, ``draft`` (k steps through the first
    ``draft_layers`` blocks, the same weights, unrolled into one program)
    and ``verify`` (one full-model pass over the last committed token and
    the k proposals, a token chosen at each position with the key the
    plain stream would use) join the same (batch × table) grid.
    """

    FAMILIES = ("prefill", "decode", "draft", "verify")

    def __init__(self, model, pool: KVPagePool, *,
                 seq_ladder: Sequence[int],
                 prefill_batch_rungs: Sequence[int],
                 decode_rungs: Sequence[int],
                 max_seq: int,
                 speculate_k: int = 0,
                 draft_layers: Optional[int] = None):
        self.speculate_k = max(int(speculate_k), 0)
        n_layers = int(model.config.num_hidden_layers)
        dl = int(get_flag("serving_spec_draft_layers")
                 if draft_layers is None else draft_layers)
        # clamp, never reject: a 1-layer model drafts with its one block
        self.draft_layers = max(1, min(dl, n_layers))
        super().__init__(model, pool, seq_ladder=seq_ladder,
                         prefill_batch_rungs=prefill_batch_rungs,
                         decode_rungs=decode_rungs)
        self.max_seq = int(max_seq)
        self.table_rungs = table_ladder(self.max_seq, pool.page_size)
        self.draft_params = (self._draft_view(self.params)
                             if self.speculate_k else None)

    # -------------------------------------------------------- draft params
    def _draft_view(self, params: dict) -> dict:
        """The draft's parameter view: the first ``draft_layers`` blocks
        and the shared embedding, final LayerNorm and head (the same
        tensors, no copy, so a swap into ``params`` flips the draft too).
        Truncation drops the top of the stack, so the draft's K/V of those
        layers is what the full model computes, and verify overwrites it
        in place."""
        view = {k: v for k, v in params.items() if k != "blocks"}
        view["blocks"] = list(params["blocks"][:self.draft_layers])
        return view

    def _call_params(self, family: str) -> dict:
        return self.draft_params if family == "draft" else self.params

    # ----------------------------------------------------------- sampling
    @staticmethod
    def _choose_tokens(head, temps, top_ks, top_ps, rkeys):
        """Per-lane next token from head logits ``[B, V]``
        (:func:`.sampling.choose_tokens`)."""
        return sampling.choose_tokens(head, temps, top_ks, top_ps, rkeys)

    @staticmethod
    def _shift_keys(rkeys, j: int):
        """The key of the j-th token of a speculation round: host keys are
        ``[seed, len(generated)]`` at the round's start, so the counter
        word plus j is the key the plain stream uses for that token."""
        if j == 0:
            return rkeys
        return torch.stack([rkeys[:, 0], (rkeys[:, 1] + j) & _MASK32], dim=1)

    # ----------------------------------------------------------- programs
    def _prefill_fn(self, params, tokens, lengths, tables,
                    temps, top_ks, top_ps, rkeys):
        head, krows, vrows = self._prefill_trunk(params, tokens, lengths)
        next_tok = self._choose_tokens(head, temps, top_ks, top_ps, rkeys)
        # pad the prompt rows up to whole pages; the surplus rows route
        # through table entries past the lane's real pages (pad page 0)
        S = krows.shape[2]
        want = tables.shape[1] * self.pool.page_size
        if want > S:
            krows = TF.pad(krows, (0, 0, 0, 0, 0, want - S))
            vrows = TF.pad(vrows, (0, 0, 0, 0, 0, want - S))
        kvc.write_prompt_pages(self.pool.k, tables, krows)
        kvc.write_prompt_pages(self.pool.v, tables, vrows)
        return next_tok

    def _paged_step_trunk(self, params, tokens, tables, positions, *,
                          bounded=False):
        """One paged decode step's transformer body: ``[B]`` tokens at
        ``[B]`` positions → head logits ``[B, V]``, K/V appended through
        the block tables.

        ``bounded=True`` (the draft's steps) keeps a lane whose position
        runs past ``max_seq`` or the position table from touching a live
        page: its writes go to the pad page and its ``wpe`` row is
        clamped. Its proposals are garbage, and never committed."""
        B, T = tables.shape
        ps = self.pool.page_size
        ck, cv = self.pool.k, self.pool.v
        wpe_at = (positions.clamp_max(self._max_pos - 1) if bounded
                  else positions)
        x = params["wte"][tokens] + params["wpe"][wpe_at]
        # column j of the gathered view is position j
        col = torch.arange(T * ps, device=x.device)
        page_idx = positions // ps
        if bounded:
            page_idx = page_idx.clamp_max(T - 1)
        pages = tables.gather(1, page_idx[:, None])[:, 0]
        if bounded:
            pages = torch.where(positions < self.max_seq, pages, 0)
        offsets = positions % ps
        mask = col[None, None, :] <= positions[:, None, None]
        for li, blk in enumerate(params["blocks"]):
            q, k, v = self._qkv(blk, x, (B,))
            kvc.append_token_paged(ck, li, pages, offsets, k)
            kvc.append_token_paged(cv, li, pages, offsets, v)
            x = self._attend_step(blk, x, q, kvc.gather_pages(ck, li, tables),
                                  kvc.gather_pages(cv, li, tables), mask)
        hfin = _ln(x, params["lnf_w"], params["lnf_b"], self._eps)
        return self._logits_head(params, hfin)

    def _decode_fn(self, params, tokens, tables, positions,
                   temps, top_ks, top_ps, rkeys):
        head = self._paged_step_trunk(params, tokens, tables, positions)
        return self._choose_tokens(head, temps, top_ks, top_ps, rkeys)

    def _draft_fn(self, params, tokens, tables, positions,
                  temps, top_ks, top_ps, rkeys):
        """``speculate_k`` decode steps through the truncated-layer view,
        unrolled into one program: the draft layers' K/V written along the
        way, the proposals ``[B, k]`` returned."""
        tok, pos, drafts = tokens, positions, []
        for j in range(self.speculate_k):
            head = self._paged_step_trunk(params, tok, tables, pos,
                                          bounded=True)
            tok = self._choose_tokens(head, temps, top_ks, top_ps,
                                      self._shift_keys(rkeys, j))
            drafts.append(tok)
            pos = pos + 1
        return torch.stack(drafts, dim=1)

    def _verify_fn(self, params, tokens, tables, positions,
                   temps, top_ks, top_ps, rkeys):
        """One full-model pass over all ``k + 1`` positions:
        ``tokens[:, 0]`` is each lane's last committed token at its write
        position p, ``tokens[:, 1:]`` the proposals at p+1..p+k. Every
        layer's K/V is written at all k+1 positions before the gather,
        masked causally per query, and a token is chosen at each position
        with the shifted key: the j-th is the token the plain decode
        program would emit after committing tokens 0..j-1."""
        B, K1 = tokens.shape
        T = tables.shape[1]
        ps = self.pool.page_size
        ck, cv = self.pool.k, self.pool.v
        pos = positions[:, None] + torch.arange(K1, device=tokens.device)[None]
        x = (params["wte"][tokens]
             + params["wpe"][pos.clamp_max(self._max_pos - 1)])
        col = torch.arange(T * ps, device=x.device)
        pages = tables.gather(1, (pos // ps).clamp_max(T - 1))
        pages = torch.where(pos < self.max_seq, pages, 0)  # pad-page spill
        offsets = pos % ps
        # [B, heads, K1 queries, T*ps cols]: query j sees cols <= p+j
        mask = col[None, None, None, :] <= pos[:, None, :, None]
        for li, blk in enumerate(params["blocks"]):
            q, k, v = self._qkv(blk, x, (B, K1))
            kvc.append_token_paged(ck, li, pages, offsets, k)
            kvc.append_token_paged(cv, li, pages, offsets, v)
            keys = kvc.gather_pages(ck, li, tables).to(x.dtype)
            vals = kvc.gather_pages(cv, li, tables).to(x.dtype)
            logits = torch.einsum("bshd,bthd->bhst", q, keys) * self._scale
            logits = torch.where(mask, logits, -1e30)
            probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
            att = torch.einsum("bhst,bthd->bshd", probs, vals).reshape(
                B, K1, self._hidden)
            x = x + TF.linear(att, blk["out_w"], blk["out_b"])
            x = self._block_mlp(blk, x)
        hfin = _ln(x, params["lnf_w"], params["lnf_b"], self._eps)
        head = self._logits_head(params, hfin)  # [B, K1, V]
        return torch.stack(
            [self._choose_tokens(head[:, j], temps, top_ks, top_ps,
                                 self._shift_keys(rkeys, j))
             for j in range(K1)], dim=1)

    # -------------------------------------------------------------- rungs
    def prefill_table_cols(self, seq_rung: int) -> int:
        return -(-int(seq_rung) // self.pool.page_size)

    @property
    def rungs(self) -> List[tuple]:
        """``("decode", b, t)`` over (batch × table) rungs, with
        speculation ``("draft", b, t)`` and ``("verify", b, t)`` over the
        same grid, plus ``("prefill", b, s)`` over (batch × seq); the
        prefill table width follows from the seq rung."""
        grid = [(b, t) for b in self.decode_rungs for t in self.table_rungs]
        out = [("decode", b, t) for b, t in grid]
        if self.speculate_k:
            out += [("draft", b, t) for b, t in grid]
            out += [("verify", b, t) for b, t in grid]
        out += [("prefill", b, s) for b in self.prefill_batch_rungs
                for s in self.seq_ladder]
        return out

    def _zero_args(self, key):
        def sample_args(b):
            return (np.zeros(b, np.float32), np.zeros(b, np.int64),
                    np.ones(b, np.float32), np.zeros((b, 2), np.int64))

        family, b = key[0], key[1]
        if family == "prefill":
            s = key[2]
            return (np.zeros((b, s), np.int64), np.ones(b, np.int64),
                    np.zeros((b, self.prefill_table_cols(s)), np.int64),
                    *sample_args(b))
        t = key[2]
        width = (b, self.speculate_k + 1) if family == "verify" else b
        return (np.zeros(width, np.int64),
                np.zeros((b, t), np.int64),  # tables -> pad page
                np.zeros(b, np.int64), *sample_args(b))

    # -------------------------------------------------------------- calls
    def prefill(self, tokens, lengths, tables,
                temps, top_ks, top_ps, rkeys) -> np.ndarray:
        return self._call("prefill", tokens, lengths, tables,
                          temps, top_ks, top_ps, rkeys)

    def decode(self, tokens, tables, positions,
               temps, top_ks, top_ps, rkeys) -> np.ndarray:
        return self._call("decode", tokens, tables, positions,
                          temps, top_ks, top_ps, rkeys)

    def draft(self, tokens, tables, positions,
              temps, top_ks, top_ps, rkeys) -> np.ndarray:
        """One draft call: k truncated-layer steps, proposals ``[B, k]``."""
        return self._call("draft", tokens, tables, positions,
                          temps, top_ks, top_ps, rkeys)

    def verify(self, tokens, tables, positions,
               temps, top_ks, top_ps, rkeys) -> np.ndarray:
        """One verify call: full-model tokens at all k+1 positions."""
        return self._call("verify", tokens, tables, positions,
                          temps, top_ks, top_ps, rkeys)


class DecodeEngine(EngineBase):
    """GPT decode serving with continuous batching.

    ``model`` is a ``models.gpt.GPTForCausalLM`` on ``device`` (default
    CUDA; raises when CUDA is absent and the caller did not ask for the
    CPU). Requests (:meth:`submit`) join the running batch at the next
    step boundary and leave the step they finish; the scheduler runs one
    program call per step against the rungs armed at :meth:`warmup`, so
    ``compiles_after_warmup`` stays 0 under any traffic.

    Two KV residency modes (``kv_mode``), each ``kv_dtype`` ``"float32"``
    or ``"bfloat16"``:

    - ``"paged"`` (default): a :class:`~.kv_cache.KVPagePool`; a request
      owns only the pages its live tokens fill. Sampled decoding
      (``temperature``/``top_k``/``top_p``/``seed`` on :meth:`submit`)
      and self-speculative decoding (``speculate_k`` > 0,
      ``spec_draft_layers``, ``spec_min_accept``) run here.
    - ``"slots"``: a :class:`~.kv_cache.KVSlotPool`, one full ``max_seq``
      row per request; greedy only, the oracle the paged mode is held
      against.

    The operational tier is the JAX engine's: ``serve_telemetry_port``
    (or ``FLAGS_telemetry_port``) starts a telemetry exporter at warmup
    (``/metrics``, ``/healthz`` with :meth:`telemetry_health`,
    ``/snapshot.json``, ``/trace.json``); each program call is retried on
    a transient fault (``RetryPolicy("serving.decode_step")``); each
    tenant has a circuit breaker (``self.breakers``) that sheds it at
    admission once its calls keep failing; :meth:`swap_weights` rolls new
    weights in between two steps.
    """

    def __init__(self, model, *,
                 max_slots: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 prefill_max_batch: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 kv_dtype: str = "float32",
                 kv_mode: str = "paged",
                 page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 speculate_k: Optional[int] = None,
                 spec_draft_layers: Optional[int] = None,
                 spec_min_accept: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 request_ttl_ms: Optional[float] = None,
                 serve_telemetry_port: Optional[int] = None,
                 stats=None,
                 device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        if kv_mode not in ("paged", "slots"):
            raise ValueError(f"kv_mode must be 'paged' or 'slots', "
                             f"got {kv_mode!r}")
        weights_on = next(model.parameters()).device
        if weights_on.type != dev.type or (
                dev.type == "cuda" and weights_on != dev):
            raise ValueError(f"the model's weights lie on {weights_on}, "
                             f"the engine was asked to serve on {dev}")
        super().__init__(max_queue=max_queue, tenant_quota=tenant_quota,
                         request_ttl_ms=request_ttl_ms,
                         serve_telemetry_port=serve_telemetry_port,
                         stats=stats)
        cfg = model.config
        max_slots = int(get_flag("serving_max_slots")
                        if max_slots is None else max_slots)
        flag_seq = int(get_flag("serving_max_seq"))
        max_seq = int(max_seq if max_seq is not None
                      else (flag_seq or cfg.max_position_embeddings))
        if max_seq > cfg.max_position_embeddings:
            raise ValueError(
                f"max_seq {max_seq} exceeds the model's position table "
                f"({cfg.max_position_embeddings})")
        prefill_max = int(get_flag("serving_prefill_max_batch")
                          if prefill_max_batch is None else prefill_max_batch)
        prefill_max = min(prefill_max, max_slots)
        if seq_buckets is None:
            seq_min = min(int(get_flag("serving_seq_bucket_min")), max_seq)
            seq_buckets = sorted({min(s, max_seq) for s in
                                  powers_of_two_buckets(seq_min, max_seq)})
        seq_buckets = sorted(int(s) for s in seq_buckets)
        if seq_buckets[-1] > max_seq:
            raise ValueError(f"seq bucket {seq_buckets[-1]} exceeds "
                             f"max_seq {max_seq}")
        spec_k = max(int(get_flag("serving_spec_k")
                         if speculate_k is None else speculate_k), 0)
        if kv_mode == "slots" and spec_k > 0:
            raise ValueError(
                "self-speculative decoding rides the paged block tables; "
                "the slots-mode engine is the greedy oracle — use "
                "kv_mode='paged' for speculate_k > 0")
        self.kv_mode = kv_mode
        self.max_slots = max_slots  # max concurrent lanes in either mode
        self.eos_id = eos_id
        self.speculate_k = spec_k
        self.device = dev
        self._model = model  # the weight source a checkpoint swap reads
        retry = RetryPolicy("serving.decode_step")
        batch_rungs = dict(
            seq_ladder=seq_buckets,
            prefill_batch_rungs=powers_of_two_buckets(1, prefill_max),
            decode_rungs=powers_of_two_buckets(1, max_slots))
        if kv_mode == "slots":
            self.kv_pool = KVSlotPool(
                cfg.num_hidden_layers, max_slots, max_seq,
                cfg.num_attention_heads, cfg.head_dim, dtype=kv_dtype,
                device=dev)
            self.programs = DecodePrograms(model, self.kv_pool,
                                           **batch_rungs)
            self._scheduler = DecodeScheduler(
                self.queue, self.programs, self.kv_pool,
                prefill_max_batch=prefill_max, eos_id=eos_id,
                stats=self.stats, retry=retry, breakers=self.breakers)
        else:
            ps = int(get_flag("serving_page_size")
                     if page_size is None else page_size)
            n_pages = int(get_flag("serving_pool_pages")
                          if pool_pages is None else pool_pages)
            if n_pages <= 0:
                # equal bytes: the token capacity of max_slots full rows
                n_pages = -(-max_slots * max_seq // ps)
            self.kv_pool = KVPagePool(
                cfg.num_hidden_layers, n_pages, ps, cfg.num_attention_heads,
                cfg.head_dim, dtype=kv_dtype, device=dev)
            self.programs = PagedDecodePrograms(
                model, self.kv_pool, max_seq=max_seq, speculate_k=spec_k,
                draft_layers=spec_draft_layers, **batch_rungs)
            self._scheduler = PagedDecodeScheduler(
                self.queue, self.programs, self.kv_pool,
                max_lanes=max_slots, prefill_max_batch=prefill_max,
                eos_id=eos_id, stats=self.stats, retry=retry,
                breakers=self.breakers, speculate_k=spec_k,
                spec_min_accept=spec_min_accept)

    # ------------------------------------------------------------ lifecycle
    def warmup(self) -> "DecodeEngine":
        """Arm every rung (on CUDA: capture its graph), freeze the KV pool
        footprint baseline, start the decode loop."""
        self.programs.warmup()
        self.kv_pool.mark_warm()
        self._start_serving()
        return self

    # ------------------------------------------------------------- serving
    def submit(self, tenant: str, prompt, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: int = 0,
               speculate: Optional[bool] = None) -> DecodeRequest:
        """Enqueue one generation request; returns the future. The prompt
        must fit the seq ladder; generation stops at ``max_new_tokens``,
        the engine's ``eos_id`` or ``max_seq``.

        ``temperature == 0`` (default) decodes greedily. A positive
        temperature samples after the optional top-k / top-p filters from
        the request's own key stream (``seed``): the same per seed, and
        independent of the batch. A slots-mode engine serves greedy only.

        ``speculate`` opts the request in or out of self-speculative
        decoding (``None``: on when the engine was built with
        ``speculate_k > 0``). It never changes the stream, only how many
        tokens commit per full-model call."""
        if self.kv_mode == "slots" and temperature > 0:
            raise ValueError("sampled decoding needs kv_mode='paged'; "
                             "the slot-pool engine is the greedy oracle")
        if speculate and not self.speculate_k:
            raise ValueError(
                "speculate=True needs an engine built with speculate_k > 0 "
                "(or FLAGS_serving_spec_k): the draft/verify programs are "
                "families armed at warmup, not a per-request switch")
        if not self._started:
            raise RuntimeError("engine not started: call warmup() first")
        spec = bool(self.speculate_k) if speculate is None else bool(speculate)
        req = DecodeRequest(tenant, prompt, max_new_tokens,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p, seed=seed, speculate=spec)
        top = self.programs.seq_ladder[-1]
        if req.prompt.size > top:
            raise ValueError(
                f"prompt of {req.prompt.size} tokens exceeds the largest "
                f"seq bucket ({top})")
        if self.kv_mode == "paged":
            need = -(-int(req.prompt.size) // self.kv_pool.page_size)
            if need > self.kv_pool.num_pages:
                raise ValueError(
                    f"prompt needs {need} KV pages but the pool holds "
                    f"{self.kv_pool.num_pages} total; it could never be "
                    "admitted")
        self.tenant(tenant)
        return self.queue.submit(req)

    def generate(self, tenant: str, prompt, max_new_tokens: int = 16,
                 timeout: Optional[float] = 120.0) -> np.ndarray:
        """submit + block: returns the generated token ids."""
        return self.submit(tenant, prompt, max_new_tokens).result(timeout)

    def active_requests(self) -> int:
        return self._scheduler.active_count()

    def set_speculation(self, enabled: bool) -> bool:
        """Turn self-speculative decoding on or off, safe mid-flight: the
        scheduler picks plain decode or draft + verify per step, and both
        families were armed at warmup. Needs an engine built with
        ``speculate_k > 0``. Returns the previous setting."""
        if not self.speculate_k:
            raise ValueError("engine was built without speculation "
                             "(speculate_k == 0); nothing to toggle")
        prev = self._scheduler.spec_enabled
        self._scheduler.spec_enabled = bool(enabled)
        return prev

    # ------------------------------------------------------------ hot swap
    def swap_weights(self, source) -> dict:
        """Roll new weights into the live decode loop between two steps:
        KV state intact, no new signature, no dropped request. ``source``
        is a sharded checkpoint directory in the reference's layout
        (``save_sharded(jax_state_dict(model))``, or a JAX package's save
        of its GPT; its tensor names must be the serving model's, a
        missing one raises ``KeyError``, a shape ``ValueError``; floats
        cast to the serving dtype) or a live ``GPTForCausalLM`` twin of
        the serving model (a structure, shape or dtype mismatch raises
        ``ValueError``).

        Running lanes keep their KV state: tokens already cached attend
        unchanged, and every call after the swap runs with the new
        weights, the draft's included. Neither the source nor the model
        handed to the constructor is changed; a live-model source becomes
        the engine's weight source for later checkpoint swaps. Returns
        ``{"n_leaves", "seconds", "compiles_after_warmup",
        "kv_slots_in_use"}`` and ticks ``serving.weight_swaps``."""
        t0 = time.perf_counter()
        if isinstance(source, (str, os.PathLike)):
            model = self._model
            new = load_sharded_like(str(source), jax_state_dict(model))
            state = port_state_from_jax(model, new)
            n_leaves = self.programs._swap_tree(
                _param_tree(model.config, state.__getitem__), copy=False)
        else:
            n_leaves = self.programs.swap_params(source)
            self._model = source
        registry.counter(
            "serving.weight_swaps",
            "weight hot-swaps committed into live serving engines").inc()
        return {
            "n_leaves": n_leaves,
            "seconds": round(time.perf_counter() - t0, 4),
            "compiles_after_warmup": self.compiles_after_warmup,
            "kv_slots_in_use": self.kv_pool.in_use(),
        }

    # ---------------------------------------------------------- accounting
    @property
    def compile_count(self) -> int:
        return self.programs.traces

    def telemetry_health(self) -> dict:
        """The ``/healthz`` payload: the chassis's, plus the lanes, the
        active requests and the KV pool's occupancy."""
        health = super().telemetry_health()
        health.update(kv_slots=self.max_slots,
                      active_requests=self.active_requests())
        if self.kv_mode == "paged":
            health.update(kv_mode="paged",
                          kv_pages=self.kv_pool.num_pages,
                          kv_page_size=self.kv_pool.page_size,
                          kv_pages_in_use=self.kv_pool.in_use())
        else:
            health.update(kv_mode="slots",
                          kv_slots_in_use=self.kv_pool.in_use())
        return health

    def serving_report(self) -> dict:
        """Stats summary plus the pool's accounting and the warmup proof."""
        report = self.stats.summary()
        report.update(
            n_tenants=len(self._tenants),
            seq_buckets=list(self.programs.seq_ladder),
            decode_rungs=list(self.programs.decode_rungs),
            prefill_batch_rungs=list(self.programs.prefill_batch_rungs),
            compiled_rungs=len(self.programs.warmed),
            compiles_after_warmup=self.compiles_after_warmup,
            kv_mode=self.kv_mode,
            kv_slots=self.max_slots,
            kv_dtype=str(self.kv_pool.k.dtype).replace("torch.", ""),
            kv_pool_bytes=self.kv_pool.device_bytes(),
            kv_pool_bytes_constant=(
                self.kv_pool.bytes_at_warmup is None
                or self.kv_pool.device_bytes() == self.kv_pool.bytes_at_warmup),
        )
        if self.kv_mode == "paged":
            util = self.kv_pool.utilization_report()
            report.update(
                table_rungs=list(self.programs.table_rungs),
                kv_pages=self.kv_pool.num_pages,
                kv_page_size=self.kv_pool.page_size,
                kv_pages_in_use=self.kv_pool.in_use(),
                kv_pool_utilization=util["mean"],
                kv_shed_requests=self._scheduler.shed_count,
            )
            if self.speculate_k:
                report.update(
                    speculate_k=self.speculate_k,
                    spec_draft_layers=self.programs.draft_layers,
                    spec_enabled=self._scheduler.spec_enabled,
                )
        else:
            report.update(kv_slots_in_use=self.kv_pool.in_use(),
                          kv_slots_peak=self.kv_pool.occupancy_peak)
        return report
