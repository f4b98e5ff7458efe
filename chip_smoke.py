#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which fails the run on any error:

1. card   — ``nvidia-smi`` name and power limit;
2. build  — compile the port's CUDA kernels from ``paddle_tpu_torch/ops/
   cuda/csrc``, one ``nvcc`` per source, all at once; print each kernel's
   registers and spills (none allowed in a tensor-core kernel at D = 64
   without dropout, nor in a FlashMask one at D = 128, nor in any
   instantiation of an f32 3×TF32 one, dropout included, nor in any
   instantiation of the RMSNorm forward (K4) and backward kernels, nor in
   the AdamW kernel, which must keep no stack frame either), and check with
   ``cuobjdump -sass`` that every attention kernel (bf16 K1, K2, K3, K5,
   K6 and K7; fp16 K1, K2 and K3, the same sources instantiated for
   __half; f32 K1, K2, K3, K5, K6 and K7 in 3×TF32, all on the tensor
   cores) holds wgmma (HGMMA) and TMA load (UTMALDG) instructions;
3. kernel — the flash-attention forward kernel (K1: bf16 and f32 3×TF32,
   both on the tensor cores) against its plain PyTorch version on the card
   at the GPT-2-small serving shapes (B in {1, 4}, S in {128, 1024}, H=12,
   D=64, f32 and bf16, causal and not), the f32 kernel also against the
   plain version computed in float64 (the f32 plain version's own error
   printed beside it), timed beside the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only:
   the port never calls it);
4. model  — GPT-2-small with seeded random weights: logits on the card
   (kernel path) against the same weights on the CPU (plain path);
5. serve  — ``DecodeEngine`` (gpt2_small f32, paged: 8 lanes,
   ``max_seq`` 1024, 16-token pages, prefill batch <= 4). Warmup runs every
   rung once eagerly and captures it as a CUDA graph (rungs, captures,
   warmup seconds and peak memory printed). 8 requests from 2 tenants
   answered together, then each alone, greedy; then at temperature 0.8,
   top-k 50, top-p 0.95 with seeds 0-7, together, alone and alone again.
   Checked: no signature, capture or eager call after warmup and every
   program call a replay; the kernel's launch count (12 a prefill call,
   through the replays); greedy streams equal together and alone, and
   first tokens equal the forward argmax, except near-ties (top-2 logit
   margin under ``NEAR_TIE``); sampled streams equal together and alone
   except near-ties of the draw (the margin of the filtered logits plus
   the key's Gumbel noise), and bit for bit alone twice; the page pool;
   a replayed prefill and decode call bit for bit the program run eagerly
   on the same inputs and pool state; the card's threefry bits for an
   [8, 50304] draw bit for bit a numpy threefry's. Timed: a decode call
   at rung (8, 64) replayed and eager (host ms, device kernels and device
   ms from ``torch.profiler``) and the draw alone. The (batch, seq) shape
   of every prefill call of the traffic is recorded;
5b. serve modes — the slot engine (``kv_mode="slots"``), the speculating
   engine (``speculate_k=4``, 6 draft layers, acceptance floor 0) and the
   bf16-KV engine, each warmed and checked as in phase 5 (each engine shut
   down before the next warms): slot streams equal the paged engine's,
   speculating streams (greedy and sampled, together and alone) equal the
   plain engine's, except near-ties, with speculation rounds in place of
   every plain decode step and a draft and a verify replay bit for bit
   their eager programs; the bf16 pool holds exactly half the f32 pool's
   bytes, its first tokens alone equal the f32 engine's bit for bit
   (prefill reads no pool) and its streams are well formed;
5c. operate — the paged f32 engine of phase 5 with its telemetry exporter
   on an ephemeral port (``serve_telemetry_port=0``), the span tracer on
   and 6 retry attempts, every rung captured at warmup: (a) the model's
   parameters negated in place after warmup leave the streams (phase 5's
   prompts, greedy, each alone) bit for bit phase 5's; (b) two client
   threads stream requests while the main thread swaps A -> B from a
   sharded checkpoint that ``save_sharded(jax_state_dict(model_b))`` wrote
   for a second gpt2_small (seed 1), then B -> A from the live model: no
   request fails, no signature or capture after warmup, every call a
   replay; the streams of requests admitted after the first swap returned
   (and done before the second) equal a cold engine's warmed on B, except
   near-ties; after the swap back the streams alone are bit for bit phase
   5's; the swap's wall ms and bytes, the steady p99 and the p99 of the
   requests completed inside each swap window are printed; (c) ``/healthz``,
   ``/metrics`` (the serving counters, the weight swaps under
   ``paddle_serving_weight_swaps_total``), ``/snapshot.json`` and
   ``/trace.json`` (``serving.decode`` spans) fetched over HTTP, each
   fetch's ms printed; (d) transient faults at rate 0.3 on
   ``serving.decode_step`` (seed 5) retried with the streams bit for bit
   phase 5's, fatal ones at rate 0.3 losing no request and leaving no page
   in use, and a breaker of threshold 2 on a victim tenant: ``/healthz``
   reads ``degraded`` and lists it, its submits are refused with
   ``reason="circuit"``, a healthy tenant is served. Then a prefill and a
   decode replay after a swap to B equal the programs run eagerly on B bit
   for bit. The first swap again on the speculating engine (k = 4, 6
   draft layers) under two clients' traffic: no request fails, the draft
   view shares the swapped storage, and a draft and a verify replay equal
   their eager programs on B bit for bit;
5d. batch serve — the batch serving tier on the model of phase 4:
   ``jit.save`` with ``InputSpec([None, None], "int64")`` (a
   ``torch.export`` program whose attention is 12 nodes of the registered
   K1 operator ``paddle_tpu_torch::flash_attention_fwd``, no plain
   attention), loaded on the card by ``inference.Predictor``, served by
   ``serving.ServingEngine`` from the [1, 2, 4, 8] x [128, 256, 512,
   1024] grid, a CUDA graph a rung captured at warmup. 3 tenant threads
   send 16 requests each, blocking, rows cycling (1, 2, 4), (2, 3, 8) and
   (1, 5, 7) (``bench.py:532``), lengths 16-1024 from
   ``RandomState(tenant)``. Checked: 16 rungs at warmup and no rung,
   capture or eager call after it, every batch a replay, K1 12 launches a
   call through the replays (and in the profile), every request's rows
   bit for bit its batch replayed again at the same rung and within
   ``LOGITS_TOL`` of the program run alone (argmax equal except
   near-ties), two requests within ``LOGITS_TOL`` of a CPU ``Predictor``
   loaded from the same files; a swap A -> B from a sharded checkpoint of
   a seed-1 gpt2_small, written in the reference's layout
   (``save_sharded(jax_state_dict(model_b))``, as phase 5c writes it), and
   back from a dict under two clients fails no
   request, captures nothing, serves B's logits, and restores the first
   bits; ``serving.execute`` faults at rate 0.3 retried (6 attempts) to
   the fault-free bits. Printed: save, load and warmup seconds,
   requests/s, samples/s, latency p50/p99, batches and fill, peak memory,
   a replayed call at rung (8, 1024) (host ms, device ms, kernels, K1's
   share), the swaps' ms and bytes and the p99 of requests done inside
   the swap windows against outside;
6. kernel at the serve shapes — the kernel against its plain version
   again (f32 also against float64), at each prefill shape phase 5
   recorded (packed-qkv strided inputs, H=12, D=64, causal, f32 and bf16).
   These launches come after the launch count was read, so they do not
   count;
7. backward kernels — K1 with dropout, K2 (dQ) and K3 (dK/dV) against
   their plain versions at B=8 and B=1 with S=1024 and at a ragged S=1000
   (H=12, D=64, causal, f32 and bf16, dropout 0 and 0.1; K2 and K3 must
   launch once each, and the count of gradient elements equal to the plain
   version's bit for bit is printed); in f32 all three also against the
   plain versions computed in float64 from the same inputs (the f32 plain
   version's own error printed beside). The dropped positions of all three
   are checked to be exactly the plain version's, in f32 and in bf16;
   each kernel is timed beside its bound (f32 at 495/3 TFLOP/s, with the
   67 TFLOP/s CUDA-core figure beside it in the text), its plain version
   and the SDPA forward or backward (a yardstick only). Then fp16 K1–K3
   against their plain versions (``TOL``/``BWD_TOL`` float16) at the GPT
   (8, 1024, 12, 64), Llama (4, 2048, 12, 64, k and v from 4 KV heads)
   and D=128 (1, 512, 32, 128) shapes, causal and not, dropout 0 and 0.1,
   each output also against the plain version computed in float64 (the
   fp16 plain version's own error beside it), timed causal beside their
   bounds (989 TFLOP/s dense fp16) and SDPA's fp16 forward and backward;
8. gradients — every gradient of gpt2_small (f32, dropout 0, B=1, S=256)
   on the card, through K1–K3, against the CPU plain path;
9. train — ``bench.py``'s GPT arm on the port: gpt2_small in bf16 O2 under
   ``TrainStep`` with ``AdamW(1e-4)`` on one batch of 8 x 1024 ids. The
   same 12 steps first run eagerly by hand (loss, backward, step,
   clear_grad) as the reference; then the ``TrainStep`` takes 2 warmup
   steps (the eager call, then the CUDA-graph capture and its first
   replay) and 10 timed ones, every one a replay (``stats``), and its 12
   losses and final parameters must equal the reference's bit for bit
   (tokens/s, step ms, MFU, losses, launches exactly 12 per step for each
   kernel and one AdamW launch per 64 parameters, counted through the
   replays, a profiler breakdown of 2 more steps after a warmup step, the
   card idle 0.25 s inside each end of the window, whose launches of
   K1-K4 and AdamW must equal the launch counters'); then 4 graphed steps
   at gpt2_small's default dropout (0.1), B=2, run twice from one seed,
   which must agree bitwise with each other and with the eager sequence;
10. Llama kernel shapes — the RMSNorm kernel (K4) against its plain
    version at rows x d = 8192 x 768 (the training shape), 4 x 768,
    1000 x 768, 256 x 4096 (llama2_7b / llama3_8b's width) and 8 x 100 (odd
    d), f32 and bf16, timed at the training shape beside its bound, its
    plain version, ``torch.nn.functional.rms_norm`` (a yardstick only;
    K4 and it in turns, the least of 5 trials each with their spread) and a
    bare copy of x (``clone``, the card's practical rate for the same
    bytes); the
    RMSNorm backward kernel (no Pallas counterpart: XLA fuses the jnp
    ``_bwd``) against its plain version at the same shapes (dx and dw; f32
    also against the plain version computed in float64, the f32 plain
    version's own error printed beside it), two calls bitwise equal, timed
    at the training shape beside its bound, the plain chain and the
    autograd backward of ``torch.nn.functional.rms_norm`` (a yardstick
    only; kernel and it in turns, least of 5 trials each with spreads);
    K1–K3 against their plain versions at the Llama training shape (B=4,
    S=2048, H=12, D=64, bf16, causal, k and v expanded from 4 KV heads by
    ``repeat_interleave``), timed there beside their bounds and SDPA, and
    at D=128 (B=1, S=512, H=32, bf16 and f32, causal; f32 also against the
    float64 plain versions);
11. Llama model — ``llama3_8b(num_hidden_layers=2)`` at full width (hidden
    4096, 32 heads over 8 KV heads, D=128, vocab 128256) with seeded random
    weights: f32 logits on the card (K1 at D=128, K4 at d=4096) against the
    CPU; then every gradient of ``llama_124m_gqa`` (f32, B=1, S=256) on the
    card (K1–K4 and the RMSNorm backward kernel, two launches a call)
    against the CPU;
12. train Llama — ``bench.py``'s ``bench_llama`` accelerator arm on the
    port: ``llama_124m_gqa`` in bf16 O2 under ``TrainStep`` with
    ``AdamW(1e-4)`` on one batch of 4 x 2048 ids, graphed and held bit for
    bit to the eager sequence as in phase 9 (tokens/s, step ms, MFU, peak
    memory, losses, launches exactly 12 per step for each of K1–K3, 25
    for K4, 25 calls of the RMSNorm backward (50 launches) and one AdamW
    launch per 64 parameters), a profiler breakdown of 2 more steps after
    a warmup step (launches checked as in phase 9, the backward's two
    kernels included) with K3's share and the rows of K4 and of the
    backward;
13. FlashMask kernels — K5 (forward), K6 (dQ) and K7 (dK/dV) against
    their plain versions over the documented index layouts: causal
    documents, causal share-question (ncol 2), causal with fully masked
    rows (O and dQ exactly 0 there), bidirectional documents and sliding
    windows (ncol 4), Hm = 1 and Hm = H, Sq != Sk, a ragged S; each at
    D = 64 and 128, f32 and bf16, each kernel launched once; the f32 K5's
    O and lse and K6/K7's gradients also against the plain versions
    computed in float64, their error printed beside the f32 plain
    version's;
14. FlashMask path — ``flashmask_attention`` forward and autograd backward
    at llama3_8b's attention width: B=1, S=8192, 32 heads (k and v
    expanded from 8 KV heads by ``repeat_interleave``), D=128, causal
    packed documents of 256–4096 tokens from ``np.random.RandomState(0)``,
    bf16 then f32: exactly one launch each of K5–K7 and none of K1–K3, the
    tiles K5, K6 (k tiles) and K7 (q tiles) computed in each dtype beside
    those within the causal bound, outputs and gradients against the
    plain versions 4 heads at a time (f32 also against the plain versions
    computed in float64 on the first 4 heads, within 1e-4), forward and
    forward+backward ms, TFLOP/s over the allowed pairs, peak memory, each
    kernel beside its bound (counted over the allowed pairs; the f32 ones
    at 495/3 TFLOP/s with the 67 TFLOP/s figure beside it), its plain
    version and SDPA with the equivalent dense boolean mask (a yardstick
    only);
15. AdamW kernel — the multi-tensor AdamW kernel (no Pallas counterpart:
    XLA fuses the JAX update) against its plain version, bit for bit, on
    every gpt2_small parameter in bf16 with seeded gradients and moments,
    timed beside its bound, the plain chain and
    ``torch.optim.AdamW(fused=True)`` (a yardstick only: its moments are
    bf16); then bit for bit in the modes the training-step API uses:
    per-tensor LR factors (two groups, ``lr_ratio``) and a decay mask,
    ``found_inf`` unset and set (set: nothing changes), ``amsgrad``, with
    bf16, fp16 and f32 parameters and f32 gradients beside bf16 and fp16
    ones, one launch per 64 tensors of one dtype pair;
16. trainer — the training-step API on gpt2_small at full width and depth
    (dropout 0), every run held bit for bit to eager steps on a twin from
    the same seed: (a) a pretraining recipe in bf16 O2 at 8 x 1024:
    ``LinearWarmup(CosineAnnealingDecay(6e-4, T_max=12, eta_min=6e-5),
    warmup_steps=4)`` stepped after every step, AdamW(beta2=0.95,
    weight_decay=0.1) with no decay on biases, LayerNorm weights and
    embeddings, the embeddings a group at half the LR,
    ``ClipGradByGlobalNorm(1.0)``; 12 ``TrainStep`` steps (every one after
    the capture a replay), the pre-clip global norms printed (the clip
    must engage), launches counted through the replays and in a profile
    beside phase 9's, step p50, tokens/s, MFU and the idle share; (b)
    fp16 O1 with dynamic loss scaling (f32 parameters, 8 x 1024,
    ``AdamW(1e-4)``, ``GradScaler(init 2^26, incr every 2, decr every
    1)``): 12 eager steps under ``torch.cuda.set_sync_debug_mode("error")``
    (no host read in the scaler or the optimizer), every skipped step
    leaving parameters, moments and the step count bit for bit, the scale
    stream equal to a host replay of JAX's ``update_loss_scaling`` rule;
    the kernels' and the plain versions' K2/K3 overflow on the same inputs
    at the largest scale without overflow, the least with, and the first;
    the same step function captured by ``jit.functionalize.
    CompiledFunction`` bit for bit the eager steps, fp16 K1–K3 launches
    counted through the replays and in the profile; (c) SGD, Momentum
    (Nesterov), Adagrad, RMSProp (centered, momentum 0.9), Adadelta,
    Adamax, Lamb and AdamW (``amsgrad``, ``lr_ratio``) in bf16 O2 at 2 x
    1024 (the batch cut for time), 3 eager then 3 ``TrainStep`` steps each,
    each graph freed before the next.

The serve (5, 5b, 5c, 5d), train (9), train Llama (12), FlashMask path
(14) and trainer (16) phases are the main paths: the launch counts are set to 0 just before each
serving engine's traffic and each of the other paths and read just after,
and no operand may have been copied for TMA there (``tma_copies`` stays
0). The serving and training paths run as CUDA-graph replays, and the
counters count the replays' kernels. The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout, the script prints no result
and exits non-zero.

f32 matmuls run in full f32: TF32 is switched off for cuBLAS and cuDNN.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

# forward against the plain version: (O absolute, O relative, lse). bf16
# O rounds once to bf16, whose step is 2^-7 of the value, so its gate has
# that relative part beside the absolute one; the lse gate is absolute
TOL = {"float32": (1e-4, 0.0, 1e-4), "bfloat16": (2e-2, 2.0 ** -7, 1e-3),
       # float16's step is 2^-10 of the value, 8x finer than bf16's: its
       # gates are bf16's scaled by that 8, the lse gate (f32) the same
       "float16": (2.5e-3, 2.0 ** -10, 1e-3)}
# backward (and forward with dropout) against the plain version: f32
# absolute; bf16 absolute plus relative, since the outputs round once to
# bf16, whose step is at most 2^-7 of the value
BWD_TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 1e-2),
           "float16": (2.5e-3, 1.25e-3)}
BWD_SHAPES = ((8, 1024), (1, 1024), (1, 1000))
GRAD_REL_TOL = 1e-3  # card vs CPU gradients, relative to the tensor's max
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 10
LOGITS_TOL = 1e-3
NEAR_TIE = 1e-3  # top-2 logit gap under which argmax may flip on rounding
LAYERS, HEADS, HEAD_DIM = 12, 12, 64  # GPT-2 small
PROMPT_LENS = (16, 37, 64, 120, 250, 300, 500, 900)
NEW_TOKENS = 32
LLAMA_BATCH, LLAMA_SEQ = 4, 2048  # bench_llama's accelerator arm
# RMSNorm kernel against its plain version: f32 relative to the row's max;
# bf16 within one bf16 step (2^-7 of the value) plus 1e-3
RMS_TOL = {"float32": 1e-5, "bfloat16": (2.0 ** -7, 1e-3)}
RMS_SHAPES = ((8192, 768), (4, 768), (1000, 768), (256, 4096), (8, 100))
RMS_EPS = 1e-5  # LlamaConfig.rms_norm_eps
RETIME_TRIALS = 5  # K4 and F.rms_norm, timed in turns at the training shape
# RMSNorm backward kernel against its plain version: f32 dx and dw within
# 1e-5 of the gradient's max (and of the float64 plain version); bf16
# within one bf16 step (2^-7 of the value) plus 1e-3
RMS_BWD_TOL = {"float32": 1e-5, "bfloat16": (2.0 ** -7, 1e-3)}
# H100 SXM data-sheet peaks (dense): f32 on CUDA cores, bf16 on tensor
# cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
# the f32 kernels on the tensor cores do each product as three TF32
# products (495 TFLOP/s dense): f32 work at a third of that rate
PEAK_TF32X3 = 495e12 / 3
# the f32 K1–K3 passes, all in 3×TF32
TF32X3_PASSES = ("fwd", "dq", "dkv")
PEAK_BYTES = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    after ``warmup`` calls, by CUDA events. A ~25 ms spin on the stream
    first lets the host queue the calls before the first one runs, so a
    kernel shorter than its wrapper's host time (about 0.09 ms a call) is
    timed on the card, not on the host."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_bound(b, s, h, d, dtype: str, causal: bool, matmuls: int,
                 tensors: int, rows: int, pairs=None, extra_bytes: int = 0,
                 peak=None):
    """Least time (ms) the card could take for one attention kernel: the
    larger of the bytes it must move (``tensors`` [B, S, H, D] tensors,
    ``rows`` [B, H, S] f32 rows and ``extra_bytes``, each read or written
    once) over HBM bandwidth and its ``matmuls`` products over the (q, k)
    pairs the mask keeps (``pairs`` per (batch, head), by default the
    causal or full count), at ``peak`` FLOP/s (by default the peak rate
    for the input type)."""
    elem = 4 if dtype == "float32" else 2
    if pairs is None:
        pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2.0 * d * matmuls * pairs * b * h
    nbytes = (tensors * b * s * h * d * elem + rows * 4 * b * h * s
              + extra_bytes)
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def pass_peak(name: str, dtype: str):
    """The peak FLOP/s a K1–K3 pass (``"fwd"``, ``"dq"``, ``"dkv"``) is
    bound by: 3×TF32 for the f32 tensor-core kernels, else the input
    type's."""
    return PEAK_TF32X3 if dtype == "float32" and name in TF32X3_PASSES \
        else PEAK_FLOPS[dtype]


def attention_bound(b, s, h, d, dtype: str, causal: bool, peak=None):
    """K1: 2 matmuls; q, k, v read, o written, lse written."""
    return kernel_bound(b, s, h, d, dtype, causal, 2, 4, 1,
                        peak=peak or pass_peak("fwd", dtype))


# K2: 3 matmuls; q, k, v, dO read, dq written; lse, delta read.
# K3: 4 matmuls; q, k, v, dO read, dk, dv written; lse, delta read.
BWD_BOUND = {"dq": (3, 5, 2), "dkv": (4, 6, 2)}


def phase_card() -> None:
    print("== card", flush=True)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(out.strip().splitlines()[0], flush=True)


# the sources of the tensor-core kernels (bf16 K1, K2, K3, K5, K6 and K7;
# f32 K1, K2, K3, K5, K6 and K7 in 3×TF32): every attention kernel. Their
# SASS must hold wgmma (HGMMA) and TMA loads (UTMALDG)
TC_SOURCES = ("flash_attention_fwd_sm90", "flash_attention_dq_sm90",
              "flash_attention_dkv_sm90", "flashmask_fwd_sm90",
              "flashmask_dq_sm90", "flashmask_dkv_sm90",
              "flash_attention_fwd_tf32", "flash_attention_dq_tf32",
              "flash_attention_dkv_tf32", "flashmask_fwd_tf32",
              "flashmask_dq_tf32", "flashmask_dkv_tf32")
# a tensor-core kernel's mangled name: its kind (its suffix names its
# type: sm90 16-bit, tf32 f32), the element type of K1-K3's sm90 kernels
# (bf16 or fp16; K5-K7's are bf16 only), head dim and dropout flag
TC_KERNEL = re.compile(r"((?:flashmask_)?(?:fwd|dq|dkv)_(sm90|tf32))_kernelI"
                       r"(13__nv_bfloat16|6__half)?Li(\d+)E(?:Lb([01])E)?")
TC_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "fp16", None: "bf16"}


def check_tensor_core_sass(_build) -> None:
    """``cuobjdump -sass`` of each tensor-core library: every kernel in it
    holds HGMMA and UTMALDG instructions, so none compiled to scalar code."""
    tool = _build.toolkit_binary("cuobjdump")
    for name in TC_SOURCES:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        funcs = re.split(r"\n\s*Function : ", sass)[1:]
        check(len(funcs) > 0, f"cuobjdump found no kernel in {name}")
        rows = []
        for body in funcs:
            fn = body.split()[0]
            mma, tma = body.count("HGMMA"), body.count("UTMALDG")
            t = TC_KERNEL.search(fn)
            rows.append(f"{t.group(1)} {TC_TYPES[t.group(3)]} "
                        f"D={t.group(4)}"
                        f"{' dropout' if t.group(5) == '1' else ''}: "
                        f"{mma} HGMMA, {tma} UTMALDG" if t else
                        f"{fn}: {mma} HGMMA, {tma} UTMALDG")
            check(mma > 0 and tma > 0,
                  f"{fn} in {name} has {mma} HGMMA and {tma} UTMALDG "
                  f"instructions: not on the tensor cores through TMA")
        print(f"{name} (SASS): " + "; ".join(rows), flush=True)


def phase_build() -> float:
    from paddle_tpu_torch.ops.cuda import (_build, adamw, flash_attention,
                                           flashmask, rms_norm)

    print("== build (one nvcc per source, in parallel)", flush=True)
    t0 = time.perf_counter()
    _build.build_all([*TC_SOURCES, "rms_norm", "adamw"])
    flash_attention.build()
    rms_norm.build()
    flashmask.build()
    adamw.build()
    seconds = time.perf_counter() - t0
    for name, log in sorted(_build.ptxas_report.items()):
        # one "entry function" line, then its spill and register lines
        rows, entry, tc, opt, norm = [], None, None, None, None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry, spill, stack = m.group(1), "?", "?"
                tc = TC_KERNEL.search(entry)
                # the RMSNorm forward (K4) and backward kernels' <TX, TW,
                # VEC, TPR, NV>; S<n>_: the mangler's back-reference to the
                # first type
                r = re.search(r"rms_norm_(bwd_)?kernelI(13__nv_bfloat16|f)"
                              r"(13__nv_bfloat16|f|S\d*_)Li(\d+)ELi(\d+)E"
                              r"Li(\d+)E", entry)
                dw = re.search(r"rms_norm_dw_kernelI(13__nv_bfloat16|f)E",
                               entry)
                norm = "rms_norm" in entry
                # AdamW's <parameter type, gradient type>; S1_: the first
                opt = re.search(r"adamw_kernelI(13__nv_bfloat16|6__half|f)"
                                r"(f|S\d*_)E", entry)
                if tc:
                    kind = (TC_TYPES[tc.group(3)] if tc.group(2) == "sm90"
                            else "f32 3xTF32")
                    entry = (f"{tc.group(1)} {kind}/D={tc.group(4)}"
                             f"{' dropout' if tc.group(5) == '1' else ''}")
                elif r:
                    x, w = ("bf16" if g != "f" else "f32" for g in (
                        r.group(2), r.group(2) if r.group(3).startswith("S")
                        else r.group(3)))
                    nv = r.group(6)
                    entry = (f"rms_norm{' bwd' if r.group(1) else ''} x {x} "
                             f"w {w} vec {r.group(4)} threads/row "
                             f"{r.group(5)} "
                             + (f"vectors/thread {nv}" if nv != "0"
                                else "loop"))
                elif dw:
                    entry = ("rms_norm dw " + ("f32" if dw.group(1) == "f"
                                               else "bf16"))
                elif opt:
                    names = {"f": "f32", "13__nv_bfloat16": "bf16",
                             "6__half": "fp16"}
                    pt = names[opt.group(1)]
                    entry = (f"adamw p {pt} g "
                             f"{pt if opt.group(2) != 'f' else 'f32'}")
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m and entry:
                spill = m.group(1)
            m = re.search(r"(\d+) bytes stack frame", ln)
            if m and entry:
                stack = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            if m and entry:
                rows.append(f"{entry}: {m.group(1)} regs, {spill} B spilled")
                # the training paths' tensor-core kernels (D = 64), and
                # the FlashMask path's at D = 128 too, keep every value in
                # registers without dropout; the f32 3xTF32 ones in every
                # instantiation, dropout included
                if tc and (tc.group(2) == "tf32" or tc.group(5) != "1" and (
                        tc.group(4) == "64"
                        or tc.group(1).startswith("flashmask"))):
                    check(spill == "0", f"{entry} spills {spill} B")
                # every RMSNorm instantiation holds its row in registers
                # (or loops) without spilling
                if norm:
                    rows[-1] += f", {stack} B stack"
                    check(spill == "0", f"{entry} spills {spill} B")
                # the AdamW kernel indexes its __grid_constant__ tensor
                # list in the parameter space: no copy to a stack frame
                if opt:
                    rows[-1] += f", {stack} B stack"
                    check(spill == "0" and stack == "0",
                          f"{entry}: {spill} B spilled, {stack} B of stack")
                entry = None
        print(f"{name} (ptxas): " + "; ".join(rows), flush=True)
    print(f"built in {seconds:.1f} s", flush=True)
    check_tensor_core_sass(_build)
    return seconds


def packed_qkv(torch, rs, b, s, dtype):
    """q, k, v as the model gives them to the kernel: strided slices of
    one packed ``[B, S, H, 3, D]`` tensor (H=12, D=64), no copy."""
    qkv = torch.from_numpy(rs.randn(b, s, HEADS, 3, HEAD_DIM)
                           .astype(np.float32)).cuda().to(getattr(torch,
                                                                  dtype))
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def o_close(got, want, dtype) -> tuple:
    """(max abs error, within TOL's O gate: absolute plus relative)."""
    atol, rtol, _ = TOL[dtype]
    err = (got.float() - want.float()).abs()
    return float(err.max()), bool((err <= atol + rtol * want.float().abs())
                                  .all())


def float64_forward_errors(torch, fa, q, k, v, o, lse, causal, scale,
                           dropout=0.0, seed=None) -> str:
    """The f32 K1's (o, lse) and the f32 plain version's against the plain
    version computed in float64 from the same inputs: the kernel fails
    past the f32 gates (``TOL``: 1e-4 on O and lse), so its gate does not
    rest only on agreeing with an f32 version that may round as it does.
    Returns both errors per output as text."""
    exact = fa.flash_attention_fwd_reference(
        q.double(), k.double(), v.double(), causal, scale, dropout, seed)
    plain = fa.flash_attention_fwd_reference(q, k, v, causal, scale,
                                             dropout, seed)
    rows = []
    for name, got, ref, want, tol in zip(("o", "lse"), (o, lse), plain,
                                         exact, TOL["float32"][::2]):
        err = float((got.double() - want).abs().max())
        err_plain = float((ref.double() - want).abs().max())
        check(err <= tol, f"f32 K1 {name} vs the float64 plain version at "
              f"{tuple(q.shape)} causal={causal} dropout={dropout}: err "
              f"{err:.3g} (tol {tol})")
        rows.append(f"{name} {err:.2e} (plain f32 {err_plain:.2e})")
    return " ".join(rows)


def compare_kernel(torch, fa, q, k, v, dtype, causal) -> tuple:
    """Kernel against its plain version on the same card tensors, and in
    f32 against the float64 plain version too; fails past the stated
    tolerance. Returns (O error, lse error, the float64 errors as text or
    "")."""
    b, s = q.shape[:2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(o.float()).all()),
          f"kernel O not finite at {b, s, dtype, causal}")
    err_o, ok_o = o_close(o, ro, dtype)
    err_l = (lse - rlse).abs().max().item()
    tol_l = TOL[dtype][2]
    check(ok_o and err_l <= tol_l,
          f"kernel vs plain at B={b} S={s} {dtype} causal={causal}: O err "
          f"{err_o:.3g} (tol {TOL[dtype][:2]}), lse err {err_l:.3g} (tol "
          f"{tol_l})")
    exact = ""
    if dtype == "float32":
        exact = "  vs float64 " + float64_forward_errors(
            torch, fa, q, k, v, o, lse, causal, scale)
    return err_o, err_l, exact


def phase_kernel(torch) -> dict:
    """Kernel against plain version at the serving shapes; returns the
    record of the main-path shape (B=1, S=1024, f32, causal)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    import torch.nn.functional as TF

    print("== kernel: flash_attention_fwd vs plain vs SDPA "
          "(ms by CUDA events, mean of 20)", flush=True)
    h, d = HEADS, HEAD_DIM
    rs = np.random.RandomState(0)
    headline = None
    worst = {}
    for b in (1, 4):
        for s in (128, 1024):
            for dtype in ("float32", "bfloat16"):
                q, k, v = packed_qkv(torch, rs, b, s, dtype)
                for causal in (True, False):
                    scale = 1.0 / math.sqrt(d)
                    err_o, err_l, exact = compare_kernel(torch, fa, q, k, v,
                                                         dtype, causal)
                    worst[dtype] = max(worst.get(dtype, 0.0), err_o)
                    ms = cuda_time_ms(
                        lambda: fa.flash_attention_fwd(q, k, v, causal,
                                                       scale))
                    plain_ms = cuda_time_ms(
                        lambda: fa.flash_attention_fwd_reference(
                            q, k, v, causal, scale), iters=5)
                    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                    lib_ms = cuda_time_ms(
                        lambda: TF.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal))
                    bound_ms, bound_by = attention_bound(b, s, h, d, dtype,
                                                         causal)
                    bound = f"{bound_ms:.4f} ({bound_by})"
                    if dtype == "float32":
                        cores = attention_bound(b, s, h, d, dtype, causal,
                                                PEAK_FLOPS["float32"])
                        bound = (f"{bound} at 495/3 TFLOP/s, "
                                 f"{cores[0]:.4f} at 67 TFLOP/s")
                    print(f"B={b} S={s:4d} H={h} D={d} {dtype:8s} "
                          f"causal={int(causal)}  O err {err_o:.2e}  lse "
                          f"err {err_l:.2e}  kernel {ms:.4f}  plain "
                          f"{plain_ms:.4f}  sdpa {lib_ms:.4f}  bound "
                          f"{bound}{exact}", flush=True)
                    if (b, s, dtype, causal) == (1, 1024, "float32", True):
                        headline = {
                            "max_abs_err": err_o, "lse_max_abs_err": err_l,
                            "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": lib_ms,
                            "shape": "B=1 S=1024 H=12 D=64 float32 causal",
                        }
    print(f"worst O error: {worst}", flush=True)
    return headline


def phase_model(torch, model_cls, cfg_fn) -> object:
    print("== model: gpt2_small logits, card (kernel) vs CPU (plain)",
          flush=True)
    model = model_cls(cfg_fn(), generator=torch.Generator().manual_seed(0))
    model.eval()
    cpu = model_cls(cfg_fn(), device="cpu",
                    generator=torch.Generator().manual_seed(0))
    cpu.eval()
    ids = np.random.RandomState(1).randint(0, model.config.vocab_size,
                                           (2, 256))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).cuda()).float().cpu()
        want = cpu(torch.from_numpy(ids))
    check(got.shape == (2, 256, model.config.vocab_size),
          f"logits shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "card logits not finite")
    err = (got - want).abs().max().item()
    print(f"B=2 S=256 logits max abs err {err:.3e} (tol {LOGITS_TOL}); "
          f"logit std {want.std().item():.3f}", flush=True)
    check(err <= LOGITS_TOL, f"logits card vs CPU err {err} > {LOGITS_TOL}")
    return model


# the serving engines of phases 5 and 5b: gpt2_small f32, 8 lanes,
# max_seq 1024, 16-token pages (605 MB of KV), prefill batch <= 4
SERVE_ENGINE = dict(max_slots=8, max_seq=1024, page_size=16,
                    prefill_max_batch=4)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SPEC = dict(speculate_k=4, spec_draft_layers=6, spec_min_accept=0.0)
# the decode rung (batch, table pages) that phase 5 times and profiles:
# every lane, the whole 1024-token table
STEP_RUNG = (8, 64)
# the prefill rung (batch, seq) whose replay phase 5 holds to the eager
# program
PREFILL_RUNG = (4, 256)


def serve_prompts(vocab) -> list:
    rs = np.random.RandomState(2)
    return [rs.randint(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def numpy_threefry_bits(keys, n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,), uint32)`` for each raw ``[B, 2]``
    uint32 key, in numpy: threefry-2x32 (20 rounds) of the counters ``(0,
    i)``, the two words xored. Written apart from the port's torch
    version, which the card's draw is held to."""
    k1 = keys[:, :1].astype(np.uint32)
    k2 = keys[:, 1:].astype(np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x1 = np.zeros((1, n), np.uint32) + ks[0]
    x2 = np.arange(n, dtype=np.uint32)[None] + ks[1]
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rotations[i % 2]:
            x1 = x1 + x2
            x2 = ((x2 << np.uint32(r)) | (x2 >> np.uint32(32 - r))) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1 ^ x2


def draw_margin(torch, model, context, draw=None) -> tuple:
    """The choice at the end of ``context`` and its top-2 margin: of the
    logits (greedy), or for a draw ``(sampling kwargs, seed, token
    index)`` of the filtered logits plus the key's Gumbel noise."""
    from paddle_tpu_torch.serving import sampling

    with torch.inference_mode():
        logits = model(torch.as_tensor(np.asarray(context, np.int64)
                                       [None]).cuda())[0, -1].float()
        if draw is not None:
            kw, seed, index = draw
            dev = logits.device
            logits = (sampling.filtered_logits(
                logits[None],
                torch.tensor([kw["temperature"]], device=dev),
                torch.tensor([kw["top_k"]], device=dev),
                torch.tensor([kw["top_p"]], device=dev))
                + sampling.gumbel(torch.tensor([[seed, index]], device=dev),
                                  logits.shape[-1]))[0]
        top = torch.topk(logits, 2).values
    return int(logits.argmax().item()), float(top[0] - top[1])


def hold_streams(torch, model, prompts, got, want, what,
                 sample=None) -> list:
    """``got`` must equal ``want`` request by request, except where the
    two first part at a near-tie: the top-2 margin of the choice there
    (of the logits, or of a draw's filtered logits plus its Gumbel noise)
    under ``NEAR_TIE``. Returns the near-ties."""
    vocab = model.config.vocab_size
    near, same = [], 0
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        for out in (g, w):
            check(out.shape == (NEW_TOKENS,) and out.dtype == np.int32
                  and 0 <= int(out.min()) and int(out.max()) < vocab,
                  f"{what}: malformed stream {out}")
        if np.array_equal(g, w):
            same += 1
            continue
        at = int(np.argmax(g != w))
        draw = None if sample is None else (sample, i, at)
        _, gap = draw_margin(torch, model, np.concatenate([p, w[:at]]), draw)
        check(gap < NEAR_TIE, f"{what}: request {i} differs at token {at} "
              f"with a top-2 margin of {gap:.3g} >= {NEAR_TIE}")
        near.append((i, at, round(gap, 6)))
    print(f"{what}: {same}/{len(prompts)} streams equal; near-ties "
          f"(top-2 margin < {NEAR_TIE}): {len(near)} {near}", flush=True)
    return near


def warm_engine(torch, model, label, **kw):
    """A ``DecodeEngine`` over ``model`` at ``SERVE_ENGINE``, warmed: every
    rung run once eagerly and captured as a CUDA graph, and nothing else.
    Prints the rungs, the captures, the warmup seconds and the peak
    memory; returns the engine and its graph report after warmup."""
    from paddle_tpu_torch.serving import DecodeEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    engine = DecodeEngine(model, **SERVE_ENGINE, **kw)
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    report = engine.programs.graph_report()
    rungs = engine.programs.rungs
    captures = sum(r["captures"] for r in report.values())
    by_family = {f: r["captures"] for f, r in report.items() if r["captures"]}
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: warmup {warm_s:.2f} s, {len(rungs)} rungs, {captures} "
          f"CUDA graphs captured {by_family}, KV pool "
          f"{engine.kv_pool.device_bytes() / 2 ** 20:.1f} MiB, peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({(peak - before) / 2 ** 30:.2f} GiB "
          f"over the model), after warmup "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    check(captures == len(rungs) == engine.compile_count,
          f"{label}: {captures} captures, {engine.compile_count} signatures "
          f"for {len(rungs)} rungs")
    for family, row in report.items():
        n = sum(1 for key in rungs if key[0] == family)
        check(row["captures"] == row["signatures"] == row["eager"] == n,
              f"{label}: {family} warmed {row}, not once per rung ({n})")
    return engine, report


def serve(engine, prompts, together: bool, **kw) -> tuple:
    """The requests at once (``together``) or one after another, request
    i with seed i; returns the streams, the serving report and the wall
    seconds. The engine's stats start from 0."""
    engine.stats.reset()
    t0 = time.perf_counter()
    if together:
        futs = [engine.submit("alpha" if i % 2 else "beta", p,
                              max_new_tokens=NEW_TOKENS, seed=i, **kw)
                for i, p in enumerate(prompts)]
        outs = [f.result(600) for f in futs]
    else:
        outs = [engine.submit("alpha" if i % 2 else "beta", p,
                              max_new_tokens=NEW_TOKENS, seed=i,
                              **kw).result(600)
                for i, p in enumerate(prompts)]
    return outs, engine.serving_report(), time.perf_counter() - t0


def print_serving(name, rep, wall) -> None:
    dec = rep["decode"]
    line = (f"{name}: wall {wall:.3f} s, prefill calls "
            f"{dec['prefill_steps']} taking {dec['prefill_s']:.4f} s (p50 "
            f"{dec['prefill_p50_ms']:.3f} ms)")
    if dec["decode_steps"]:
        line += (f", decode steps {dec['decode_steps']} (p50 "
                 f"{dec['decode_p50_ms']:.3f} ms, p99 "
                 f"{dec['decode_p99_ms']:.3f} ms), decode tokens/s "
                 f"{dec['decode_tokens_per_sec']:.1f}")
    if dec.get("spec_rounds"):
        line += (f", speculation rounds {dec['spec_rounds']} (draft p50 "
                 f"{dec['draft_p50_ms']:.3f} ms, verify p50 "
                 f"{dec['verify_p50_ms']:.3f} ms), acceptance "
                 f"{dec['spec_accept_rate']:.4f}, "
                 f"{dec['spec_net_tokens_per_full_pass']:.3f} tokens per "
                 f"verify, round tokens/s {dec['spec_tokens_per_sec']:.1f}")
    print(line + f", all tokens/s {dec['tokens_per_sec']:.1f}, request p50 "
          f"{rep['p50_ms']:.1f} ms p99 {rep['p99_ms']:.1f} ms", flush=True)


def program_calls(reports) -> int:
    return sum(rep["decode"].get(f"{kind}_steps", 0) for rep in reports
               for kind in ("prefill", "decode", "draft", "verify"))


def check_replays(engine, label, warm, reports) -> None:
    """After traffic: no new signature, no new capture, no eager call;
    every program call was a replay."""
    now = engine.programs.graph_report()
    replays = sum(now[f]["replays"] - warm[f]["replays"] for f in now)
    calls = program_calls(reports)
    print(f"{label}: compiles after warmup "
          f"{engine.compiles_after_warmup}, {calls} program calls, "
          f"{replays} graph replays", flush=True)
    check(engine.compiles_after_warmup == 0,
          f"{label}: {engine.compiles_after_warmup} compiles after warmup")
    for family in now:
        check(now[family]["captures"] == warm[family]["captures"]
              and now[family]["eager"] == warm[family]["eager"],
              f"{label}: {family} captured or ran eagerly after warmup")
    check(calls > 0 and replays == calls,
          f"{label}: {replays} replays for {calls} program calls")


def check_prefill_launches(label, launches, copies, reports) -> None:
    calls = sum(rep["decode"]["prefill_steps"] for rep in reports)
    print(f"{label}: kernel launches {launches} over {calls} prefill calls "
          f"({LAYERS} layers each)", flush=True)
    check(calls > 0 and launches == LAYERS * calls,
          f"{label}: launches {launches} != {LAYERS} x {calls} prefill calls")
    check(copies == 0, f"{label}: {copies} operands were copied for TMA")


def call_inputs(engine, family, b, width, rs) -> tuple:
    """Host arrays for one call of ``family`` at rung ``(b, width)`` (seq
    rung for prefill, table pages otherwise) naming distinct pages that
    hold served K/V, half the lanes greedy and half sampled."""
    programs, pool = engine.programs, engine.kv_pool
    t = programs.prefill_table_cols(width) if family == "prefill" else width
    tables = rs.permutation(np.arange(1, pool.num_pages + 1))[:b * t]
    tables = tables.reshape(b, t)
    lanes = np.arange(b) % 2
    sample = (np.where(lanes, SAMPLED["temperature"], 0.0).astype(np.float32),
              np.where(lanes, SAMPLED["top_k"], 0).astype(np.int64),
              np.where(lanes, SAMPLED["top_p"], 1.0).astype(np.float32),
              rs.randint(0, 2 ** 31, (b, 2)).astype(np.int64))
    vocab = programs.params["wte"].shape[0]
    if family == "prefill":
        return (rs.randint(0, vocab, (b, width)),
                rs.randint(width // 2, width + 1, b), tables, *sample)
    k = programs.speculate_k
    positions = rs.randint(0, t * pool.page_size - k - 1, b)
    shape = (b, k + 1) if family == "verify" else b
    return (rs.randint(0, vocab, shape), tables, positions, *sample)


def check_replay_is_eager(torch, engine, label, family, args) -> None:
    """A replayed call of ``family`` against the same program run eagerly
    on the same inputs from the same pool state: tokens and pool bit for
    bit."""
    pool = engine.kv_pool
    k0, v0 = pool.k.clone(), pool.v.clone()
    replays = engine.programs.graph_report()[family]["replays"]
    got = getattr(engine.programs, family)(*args)
    check(engine.programs.graph_report()[family]["replays"] == replays + 1,
          f"{label}: the {family} call was not a replay")
    k1, v1 = pool.k.clone(), pool.v.clone()
    pool.k.copy_(k0)
    pool.v.copy_(v0)
    want = engine.programs.run_eager(family, *args)
    same_pool = torch.equal(k1, pool.k) and torch.equal(v1, pool.v)
    rung = np.shape(args[0 if family == "prefill" else 1])
    print(f"{label}: {family} replay at {rung} vs the eager program: tokens "
          f"equal {np.array_equal(got, want)}, pool equal {same_pool}",
          flush=True)
    check(np.array_equal(got, want) and same_pool,
          f"{label}: the {family} replay differs from the eager program")


def profile_calls(torch, fn, calls: int = 3) -> tuple:
    """Device kernels and device ms a call of ``fn`` (torch.profiler over
    ``calls`` calls after one warmup call, the card idle
    ``PROFILE_PAD_S`` inside each end of the window), and the rows (name,
    ms a call, count a call), longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls,
                                   repeat=1)) as prof:
        for i in range(calls + 1):
            if i == 1:
                time.sleep(PROFILE_PAD_S)
            fn()
            torch.cuda.synchronize()
            if i == calls:
                time.sleep(PROFILE_PAD_S)
            prof.step()
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / calls,
                    e.count / calls)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("ProfilerStep")),
                  key=lambda r: -r[1])
    check(len(rows) > 0, "the profiler recorded no device time")
    return sum(r[2] for r in rows), sum(r[1] for r in rows), rows


def time_decode_step(torch, engine) -> dict:
    """One decode call at ``STEP_RUNG`` (half the lanes sampled): host ms
    a call (arguments in, tokens out), replayed and eager in turns, the
    device kernels and device ms a call of each, and the draw's own
    (``sampling.choose_tokens`` at ``[8, vocab]``). Trashes the pages it
    names."""
    from paddle_tpu_torch.serving import sampling

    programs = engine.programs
    args = call_inputs(engine, "decode", *STEP_RUNG, np.random.RandomState(9))
    fns = {"graphed": lambda: programs.decode(*args),
           "eager": lambda: programs.run_eager("decode", *args)}
    host = {name: [] for name in fns}
    for name in ("eager", "graphed", "graphed", "eager"):
        fns[name]()
        t0 = time.perf_counter()
        for _ in range(10):
            fns[name]()
        host[name].append((time.perf_counter() - t0) / 10 * 1e3)
    out = {}
    for name, fn in fns.items():
        kernels, dev_ms, rows = profile_calls(torch, fn)
        out[name] = {"host_ms": min(host[name]), "kernels": kernels,
                     "device_ms": dev_ms, "rows": rows}
    b, vocab = STEP_RUNG[0], programs.params["wte"].shape[0]
    rs = np.random.RandomState(10)
    head = torch.from_numpy(rs.randn(b, vocab).astype(np.float32)).cuda()
    dev_args = [torch.from_numpy(a).cuda() for a in call_inputs(
        engine, "decode", *STEP_RUNG, rs)[3:]]

    def draw():
        with torch.inference_mode():
            return sampling.choose_tokens(head, *dev_args)

    kernels, dev_ms, _ = profile_calls(torch, draw)
    out["draw"] = {"kernels": kernels, "device_ms": dev_ms}
    print(f"decode call at rung {STEP_RUNG} ({b // 2} lanes sampled): graphed "
          f"{out['graphed']['host_ms']:.3f} ms host, "
          f"{out['graphed']['kernels']:.0f} kernels, "
          f"{out['graphed']['device_ms']:.3f} ms on the card; eager "
          f"{out['eager']['host_ms']:.3f} ms host, "
          f"{out['eager']['kernels']:.0f} kernels, "
          f"{out['eager']['device_ms']:.3f} ms on the card; the draw "
          f"(choose_tokens at [{b}, {vocab}]) {out['draw']['kernels']:.0f} "
          f"kernels, {out['draw']['device_ms']:.4f} ms on the card",
          flush=True)
    for key, ms, count in out["graphed"]["rows"][:10]:
        print(f"    {ms:8.4f} ms  x{count:<5.0f} {key[:100]}", flush=True)
    # a replay also copies each argument into its static buffer and clones
    # the output
    check(out["graphed"]["kernels"] == out["eager"]["kernels"] + len(args)
          + 1, "the replay ran another set of kernels than the eager call")
    return out


def check_threefry_on_card(torch) -> None:
    """The card's threefry bits for an [8, vocab] draw against numpy's."""
    from paddle_tpu_torch.serving import sampling

    keys = np.random.RandomState(4).randint(0, 2 ** 32, (8, 2),
                                            dtype=np.uint64)
    keys[0] = (0, 0)
    keys[1] = (0xFFFFFFFF, 0xFFFFFFFF)
    vocab = 50304
    want = numpy_threefry_bits(keys.astype(np.uint32), vocab)
    got = sampling.random_bits(torch.from_numpy(keys.astype(np.int64))
                               .cuda(), vocab).cpu().numpy()
    equal = int((got.astype(np.uint32) == want).sum())
    print(f"threefry bits on the card, [8, {vocab}]: {equal}/{want.size} "
          f"equal numpy's", flush=True)
    check(got.min() >= 0 and got.max() < 2 ** 32 and equal == want.size,
          "the card's threefry bits differ from numpy's")


def phase_serve(torch, model) -> dict:
    """Phase 5: the paged f32 engine, greedy then sampled, every call a
    graph replay."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    print("== serve: DecodeEngine(gpt2_small f32, paged), every rung a CUDA "
          "graph; 8 requests from 2 tenants together, then each alone; "
          "greedy, then sampled", flush=True)
    prompts = serve_prompts(model.config.vocab_size)
    engine, warm = warm_engine(torch, model, "paged f32")
    # record the (batch, seq) rung of every prefill call of the traffic
    prefill_shapes = set()
    prefill = engine.programs.prefill

    def recording_prefill(*args):
        prefill_shapes.add(tuple(np.shape(args[0])))
        return prefill(*args)

    engine.programs.prefill = recording_prefill
    try:
        # the main path's run: counts from 0, read right after it
        fa.launches = fa.tma_copies = 0
        batched, rep_batched, wall_batched = serve(engine, prompts, True)
        solo, rep_solo, wall_solo = serve(engine, prompts, False)
        sampled, rep_sampled, wall_sampled = serve(engine, prompts, True,
                                                   **SAMPLED)
        sampled_solo, rep_ss, wall_ss = serve(engine, prompts, False,
                                              **SAMPLED)
        again, rep_again, _ = serve(engine, prompts, False, **SAMPLED)
        launches, copies = fa.launches, fa.tma_copies
        reports = [rep_batched, rep_solo, rep_sampled, rep_ss, rep_again]
        check_replays(engine, "paged f32", warm, reports)
        free_pages = engine.kv_pool.free_count()
        active = engine.active_requests()
    finally:
        engine.shutdown(drain=False)
        engine.programs.prefill = prefill
    for name, rep, wall in (
            ("greedy together", rep_batched, wall_batched),
            ("greedy alone", rep_solo, wall_solo),
            ("sampled together", rep_sampled, wall_sampled),
            ("sampled alone", rep_ss, wall_ss)):
        print_serving(name, rep, wall)
    check_prefill_launches("paged f32", launches, copies, reports)

    hold_streams(torch, model, prompts, batched, solo,
                 "greedy, together vs alone")
    first_ties = []
    for i, (p, together, alone) in enumerate(zip(prompts, batched, solo)):
        want, gap = draw_margin(torch, model, p)
        for label, out in (("together", together), ("alone", alone)):
            if int(out[0]) != want:
                check(gap < NEAR_TIE,
                      f"request {i} ({label}): first token {int(out[0])} "
                      f"!= forward argmax {want}, top-2 gap {gap:.3g}")
                first_ties.append((i, label, gap))
    print(f"first tokens equal the forward argmax except near-ties: "
          f"{first_ties}", flush=True)
    hold_streams(torch, model, prompts, sampled, sampled_solo,
                 "sampled, together vs alone", sample=SAMPLED)
    check(all(np.array_equal(a, b) for a, b in zip(again, sampled_solo)),
          "sampled: the same seeds alone twice gave different streams")
    check(sum(not np.array_equal(a, b) for a, b in zip(sampled, batched))
          >= len(prompts) // 2, "sampled streams look greedy")
    print("sampled: the same seeds alone twice gave equal streams",
          flush=True)

    pool_pages = rep_again["kv_pages"]
    print(f"pages: {rep_again['kv_pages_in_use']} in use, {free_pages}/"
          f"{pool_pages} free after retire, active requests {active}, "
          f"pool bytes {rep_again['kv_pool_bytes']} constant "
          f"{rep_again['kv_pool_bytes_constant']}", flush=True)
    check(rep_again["kv_pages_in_use"] == 0 and free_pages == pool_pages
          and active == 0, "pages were not all returned after retire")
    check(all(rep["requests"] == len(prompts) for rep in reports),
          "not every request was answered")

    rs = np.random.RandomState(5)
    for family, b, width in (("prefill", *PREFILL_RUNG),
                             ("decode", *STEP_RUNG)):
        check_replay_is_eager(torch, engine, "paged f32", family,
                              call_inputs(engine, family, b, width, rs))
    check_threefry_on_card(torch)
    step = time_decode_step(torch, engine)
    print(f"prefill shapes (batch, seq): {sorted(prefill_shapes)}",
          flush=True)
    streams = {"greedy": (batched, solo), "sampled": (sampled, sampled_solo)}
    del engine, prefill, recording_prefill
    release_memory(torch)
    return {"launches": launches, "prefill_shapes": sorted(prefill_shapes),
            "streams": streams, "step": step}


def phase_serve_modes(torch, model, paged) -> int:
    """Phase 5b: the slot engine, the speculating engine and the bf16-KV
    engine against the paged f32 engine's streams of phase 5. Returns the
    flash-attention launches of their traffic."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    print("== serve modes: slot pool, self-speculation (k=4, 6 draft "
          "layers), bf16 KV pool; held to phase 5's streams", flush=True)
    prompts = serve_prompts(model.config.vocab_size)
    greedy, greedy_solo = paged["streams"]["greedy"]
    sampled, sampled_solo = paged["streams"]["sampled"]
    total = 0

    engine, warm = warm_engine(torch, model, "slots f32", kv_mode="slots")
    try:
        fa.launches = fa.tma_copies = 0
        together, rep_t, wall_t = serve(engine, prompts, True)
        alone, rep_a, _ = serve(engine, prompts, False)
        launches, copies = fa.launches, fa.tma_copies
        check_replays(engine, "slots f32", warm, [rep_t, rep_a])
        in_use = engine.kv_pool.in_use()
    finally:
        engine.shutdown(drain=False)
    del engine
    release_memory(torch)
    total += launches
    print_serving("slots, greedy together", rep_t, wall_t)
    check_prefill_launches("slots f32", launches, copies, [rep_t, rep_a])
    check(in_use == 0, f"slots: {in_use} slots still held after retire")
    hold_streams(torch, model, prompts, together, greedy,
                 "slots vs paged, together")
    hold_streams(torch, model, prompts, alone, greedy_solo,
                 "slots vs paged, alone")

    engine, warm = warm_engine(torch, model, "paged f32 speculating", **SPEC)
    try:
        fa.launches = fa.tma_copies = 0
        runs = [serve(engine, prompts, together, **kw)
                for kw in ({}, SAMPLED) for together in (True, False)]
        launches, copies = fa.launches, fa.tma_copies
        reports = [rep for _, rep, _ in runs]
        check_replays(engine, "speculating", warm, reports)
        in_use = engine.kv_pool.in_use()
    finally:
        engine.shutdown(drain=False)
    rs = np.random.RandomState(6)
    for family in ("draft", "verify"):
        check_replay_is_eager(torch, engine, "speculating", family,
                              call_inputs(engine, family, *STEP_RUNG, rs))
    del engine
    release_memory(torch)
    total += launches
    names = ("greedy together", "greedy alone", "sampled together",
             "sampled alone")
    for (_, rep, wall), name in zip(runs, names):
        print_serving(f"speculating, {name}", rep, wall)
        dec = rep["decode"]
        check(dec.get("spec_rounds", 0) > 0 and dec["decode_steps"] == 0,
              f"speculating, {name}: {dec.get('spec_rounds', 0)} "
              f"speculation rounds, {dec['decode_steps']} plain steps")
    check_prefill_launches("speculating", launches, copies, reports)
    check(in_use == 0, f"speculating: {in_use} pages held after retire")
    for (outs, _, _), want, name, sample in zip(
            runs, (greedy, greedy_solo, sampled, sampled_solo), names,
            (None, None, SAMPLED, SAMPLED)):
        hold_streams(torch, model, prompts, outs, want,
                     f"speculating vs plain, {name}", sample=sample)

    engine, warm = warm_engine(torch, model, "paged bf16 KV",
                               kv_dtype="bfloat16")
    try:
        fa.launches = fa.tma_copies = 0
        together, rep_t, wall_t = serve(engine, prompts, True)
        alone, rep_a, _ = serve(engine, prompts, False)
        launches, copies = fa.launches, fa.tma_copies
        check_replays(engine, "bf16 KV", warm, [rep_t, rep_a])
        half_bytes = engine.kv_pool.device_bytes()
    finally:
        engine.shutdown(drain=False)
    del engine
    release_memory(torch)
    total += launches
    print_serving("bf16 KV, greedy together", rep_t, wall_t)
    check_prefill_launches("bf16 KV", launches, copies, [rep_t, rep_a])
    f32_bytes = paged_pool_bytes(model)
    print(f"bf16 KV pool {half_bytes} bytes, f32 pool {f32_bytes} bytes",
          flush=True)
    check(2 * half_bytes == f32_bytes,
          "the bf16 pool is not half the f32 pool")
    check([int(s[0]) for s in alone] == [int(s[0]) for s in greedy_solo],
          "bf16 KV: the first tokens (prefill reads no pool) differ from "
          "the f32 engine's")
    for out in together + alone:
        check(out.shape == (NEW_TOKENS,) and out.dtype == np.int32
              and 0 <= int(out.min())
              and int(out.max()) < model.config.vocab_size,
              f"bf16 KV: malformed stream {out}")
    agree = sum(np.array_equal(a, b) for a, b in zip(alone, greedy_solo))
    print(f"bf16 KV: first tokens equal the f32 engine's alone; "
          f"{agree}/{len(prompts)} whole streams equal", flush=True)
    return total


# phase 5c: the operational tier, on the paged f32 engine of phase 5
FAULT_RATE = 0.3
# the transient schedule's seed: over the 256 program calls of the 8
# requests served alone (1 prefill + 31 decode calls each) it fires 92
# times, at most 3 in a row, inside the 6 attempts the engine is given
TRANSIENT_SEED = 5
FATAL_SEED = 0
RETRY_ATTEMPTS = 6


def fetch(url: str) -> tuple:
    """GET ``url`` (the engine's exporter on 127.0.0.1): status, body and
    milliseconds."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            status, body = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read().decode()
    return status, body, (time.perf_counter() - t0) * 1e3


def serve_alone(engine, prompts, tenant=None) -> list:
    """Greedy streams, one request after another (each call's rung is
    fixed by its request alone, so two runs on one card are bitwise
    equal); the engine's stats keep counting."""
    return [engine.submit(tenant or ("alpha" if i % 2 else "beta"), p,
                          max_new_tokens=NEW_TOKENS).result(600)
            for i, p in enumerate(prompts)]


def param_bytes(params) -> int:
    """The bytes of a decode engine's own weights."""
    tensors = [t for k, t in params.items() if k != "blocks"]
    tensors += [t for blk in params["blocks"] for t in blk.values()]
    return sum(t.numel() * t.element_size() for t in tensors)


def p99_line(latencies) -> str:
    if not latencies:
        return "none"
    return (f"p99 {np.percentile(latencies, 99) * 1e3:.1f} ms over "
            f"{len(latencies)}")


def swap_traffic(engine, prompts, sources) -> tuple:
    """Two client threads stream greedy requests (client c walks prompts
    c, c+2, ...) while the main thread swaps to each of ``sources`` in
    turn, after 4 completions and then 6 more after each swap. Returns
    the completed ``(prompt index, request)`` pairs, each swap's (start,
    end) perf_counter window and report."""
    done, failures = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client(c):
        i = c
        while not stop.is_set():
            idx = i % len(prompts)
            try:
                req = engine.submit(f"client{c}", prompts[idx],
                                    max_new_tokens=NEW_TOKENS)
                req.result(600)
            except Exception as e:  # noqa: BLE001 — the zero-drop gate
                with lock:
                    failures.append(repr(e))
                return
            with lock:
                done.append((idx, req))
            i += 2

    def wait_for(n):
        deadline = time.perf_counter() + 600
        while len(done) < n and not failures:
            check(time.perf_counter() < deadline, "swap traffic stalled")
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(c,)) for c in (0, 1)]
    for t in threads:
        t.start()
    windows, reports = [], []
    try:
        wait_for(4)
        for source in sources:
            t0 = time.perf_counter()
            reports.append(engine.swap_weights(source))
            windows.append((t0, time.perf_counter()))
            wait_for(len(done) + 6)
    finally:
        stop.set()
        for t in threads:
            t.join(600)
    check(failures == [], f"requests failed under the swaps: {failures[:3]}")
    check(not any(t.is_alive() for t in threads), "a client hung")
    return done, windows, reports


def check_health(url, what, **want) -> dict:
    status, body, ms = fetch(url + "/healthz")
    health = json.loads(body)
    print(f"{what}: GET /healthz {status} in {ms:.2f} ms: ok {health['ok']}, "
          f"health {health['health']}, open circuits "
          f"{health['open_circuits']}, worker alive "
          f"{health['worker_alive']}, compiles after warmup "
          f"{health['compiles_after_warmup']}, pages in use "
          f"{health['kv_pages_in_use']}/{health['kv_pages']}", flush=True)
    check(status == 200 and health["ok"] and health["worker_alive"]
          and health["compiles_after_warmup"] == 0, f"{what}: {health}")
    for key, value in want.items():
        check(health[key] == value, f"{what}: {key} {health[key]} != {value}")
    return health


def check_telemetry(url) -> None:
    """(c) Each endpoint of the running engine's exporter over HTTP."""
    check_health(url, "telemetry", kv_pages_in_use=0, health="ok")
    status, body, ms = fetch(url + "/metrics")
    lines = body.splitlines()
    samples = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
               for ln in lines if ln and not ln.startswith("#")}
    swaps = samples.get("paddle_serving_weight_swaps_total", 0)
    print(f"telemetry: GET /metrics {status} in {ms:.2f} ms, {len(lines)} "
          f"lines, {len(body)} bytes; weight swaps {swaps}, admitted "
          f"{sum(v for k, v in samples.items() if k.startswith('paddle_serving_admitted_total'))}",
          flush=True)
    check(status == 200 and swaps >= 2, "/metrics lacks the weight swaps")
    for name in ("paddle_serving_admitted_total",
                 "paddle_serving_kv_pages_in_use", "paddle_serving_requests",
                 "paddle_serving_decode_decode_steps", "paddle_process_info"):
        check(any(k.startswith(name) for k in samples),
              f"/metrics lacks {name}")
    status, body, ms = fetch(url + "/snapshot.json")
    snap = json.loads(body)
    print(f"telemetry: GET /snapshot.json {status} in {ms:.2f} ms, "
          f"{len(snap['metrics'])} metrics, {len(body)} bytes", flush=True)
    check(status == 200 and "serving.weight_swaps" in snap["metrics"],
          "/snapshot.json lacks the weight swaps")
    status, body, ms = fetch(url + "/trace.json")
    events = json.loads(body)["traceEvents"]
    spans = [e for e in events if e["name"] == "serving.decode"]
    kinds = sorted({e["args"]["kind"] for e in spans})
    print(f"telemetry: GET /trace.json {status} in {ms:.2f} ms, "
          f"{len(events)} events, {len(spans)} serving.decode spans {kinds}, "
          f"{len(body)} bytes", flush=True)
    check(status == 200 and {"prefill", "decode"} <= set(kinds),
          "/trace.json lacks serving.decode spans")


def check_faults(torch, engine, prompts, solo) -> None:
    """(d) Transient faults absorbed with equal streams, fatal ones losing
    no request and no page, a breaker shedding its tenant."""
    from paddle_tpu_torch import reliability as rel
    from paddle_tpu_torch.serving import AdmissionError

    url = engine.telemetry_url
    inj = rel.arm(rel.FaultInjector(seed=TRANSIENT_SEED).plan(
        "serving.decode_step", rate=FAULT_RATE))
    t0 = time.perf_counter()
    try:
        got = serve_alone(engine, prompts)
    finally:
        rel.disarm()
    fired = inj.summary()["total_injected"]
    same = sum(np.array_equal(a, b) for a, b in zip(got, solo))
    print(f"transient faults (rate {FAULT_RATE}, seed {TRANSIENT_SEED}, "
          f"{RETRY_ATTEMPTS} attempts): {fired} fired and retried in "
          f"{time.perf_counter() - t0:.2f} s; {same}/{len(prompts)} streams "
          "bit for bit phase 5's alone", flush=True)
    check(fired > 0 and same == len(prompts),
          "transient faults changed the streams")

    inj = rel.arm(rel.FaultInjector(seed=FATAL_SEED).plan(
        "serving.decode_step", rate=FAULT_RATE, transient=False))
    resolved = failed = 0
    try:
        futs = [engine.submit("chaos", p, max_new_tokens=NEW_TOKENS)
                for p in prompts]
        for f in futs:
            try:
                f.result(600)
                resolved += 1
            except rel.FaultInjection:
                failed += 1
    finally:
        rel.disarm()
    in_use, active = engine.kv_pool.in_use(), engine.active_requests()
    print(f"fatal faults (rate {FAULT_RATE}, seed {FATAL_SEED}): "
          f"{inj.summary()['total_injected']} fired; {resolved} resolved + "
          f"{failed} failed of {len(prompts)} submitted; pages in use "
          f"{in_use}, active requests {active}", flush=True)
    check(failed > 0 and resolved + failed == len(prompts),
          "fatal faults lost a request")
    check(in_use == 0 and active == 0, "fatal faults leaked pages")

    victim = engine.breakers.breaker("victim")
    victim.failure_threshold, victim.cooldown_s = 2, 600.0
    inj = rel.arm(rel.FaultInjector(seed=0).plan(
        "serving.decode_step", rate=1.0, transient=False))
    try:
        for _ in range(2):
            try:
                engine.submit("victim", prompts[0], max_new_tokens=4
                              ).result(600)
                check(False, "a victim request was served through a fault")
            except rel.FaultInjection:
                pass
    finally:
        rel.disarm()
    health = check_health(url, "breaker (threshold 2)", health="degraded")
    check("victim" in health["open_circuits"], "the victim is not listed")
    try:
        engine.submit("victim", prompts[0], max_new_tokens=4)
        refused = None
    except AdmissionError as e:
        refused = e.reason
    out = engine.submit("healthy", prompts[0], max_new_tokens=4).result(600)
    print(f"breaker: the victim's submit refused with reason {refused!r}; "
          f"a healthy tenant served {out.tolist()}", flush=True)
    check(refused == "circuit", f"the victim was not shed ({refused})")
    check(out.shape == (4,), "the healthy tenant was not served")


def operate_engine(torch, model, ckpt, prompts, solo) -> dict:
    """Phase 5c's paged f32 engine over ``model`` (A), its exporter on an
    ephemeral port and the span tracer on: (a) A changed in place after
    warmup, (b) swaps A -> B (``ckpt``) -> A (the live model) under two
    clients' traffic, (c) telemetry, (d) faults, then the counts and a
    replay of each of prefill and decode against the eager program on B.
    Returns the main path's kernel launches and the post-swap streams."""
    from paddle_tpu_torch.base.flags import set_flags
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    set_flags({"retry_max_attempts": RETRY_ATTEMPTS, "telemetry_trace": True})
    try:
        engine, warm = warm_engine(torch, model, "operate f32",
                                   serve_telemetry_port=0)
    finally:
        set_flags({"retry_max_attempts": 3})
    try:
        print(f"telemetry exporter at {engine.telemetry_url}; weights "
              f"{param_bytes(engine.programs.params)} bytes, the engine's "
              "own copy", flush=True)
        engine.stats.reset()
        fa.launches = fa.tma_copies = 0
        with torch.no_grad():
            for p in model.parameters():
                p.neg_()
        try:
            owned = serve_alone(engine, prompts)
        finally:
            with torch.no_grad():
                for p in model.parameters():
                    p.neg_()
        same = sum(np.array_equal(a, b) for a, b in zip(owned, solo))
        print(f"(a) the model negated in place after warmup: {same}/"
              f"{len(prompts)} streams bit for bit phase 5's alone",
              flush=True)
        check(same == len(prompts), "the engine served the model's change")

        done, windows, reports = swap_traffic(engine, prompts,
                                              (ckpt, model))
        nbytes = param_bytes(engine.programs.params)
        for (t0, t1), rep, name in zip(windows, reports,
                                       ("A -> B (checkpoint)",
                                        "B -> A (live model)")):
            inside = [r.t_complete - r.t_enqueue for _, r in done
                      if t0 <= r.t_complete <= t1]
            print(f"(b) swap {name}: {(t1 - t0) * 1e3:.1f} ms wall "
                  f"(report {rep['seconds'] * 1e3:.1f} ms), {nbytes} bytes, "
                  f"{rep['n_leaves']} tensors, {rep['kv_slots_in_use']} "
                  f"pages in use; requests completed inside: "
                  f"{p99_line(inside)}", flush=True)
            check(rep["compiles_after_warmup"] == 0,
                  f"swap {name}: {rep['compiles_after_warmup']} compiles")
        steady = [r.t_complete - r.t_enqueue for _, r in done
                  if all(r.t_complete < t0 or r.t_enqueue > t1
                         for t0, t1 in windows)]
        post = [(idx, r.result(0)) for idx, r in done
                if r.t_admit > windows[0][1]
                and r.t_complete < windows[1][0]]
        print(f"(b) {len(done)} requests served, none failed; steady "
              f"{p99_line(steady)}; {len(post)} admitted after the first "
              "swap returned and done before the second", flush=True)
        check(len(post) >= 2, "too few requests between the swaps")
        back = serve_alone(engine, prompts)
        same = sum(np.array_equal(a, b) for a, b in zip(back, solo))
        print(f"(b) after the swap back: {same}/{len(prompts)} streams bit "
              "for bit phase 5's alone", flush=True)
        check(same == len(prompts), "the swap back changed the streams")

        check_telemetry(engine.telemetry_url)
        check_faults(torch, engine, prompts, solo)

        launches, copies = fa.launches, fa.tma_copies
        report = engine.serving_report()
        check_replays(engine, "operate f32", warm, [report])
        check_prefill_launches("operate f32", launches, copies, [report])
        engine.swap_weights(ckpt)
        rs = np.random.RandomState(11)
        for family, b, width in (("prefill", *PREFILL_RUNG),
                                 ("decode", *STEP_RUNG)):
            check_replay_is_eager(torch, engine, "operate f32 on B", family,
                                  call_inputs(engine, family, b, width, rs))
        engine.swap_weights(model)
    finally:
        engine.shutdown(drain=False)
        set_flags({"telemetry_trace": False})
    del engine
    release_memory(torch)
    return {"launches": launches, "post": post}


def operate_speculating(torch, model, ckpt, prompts) -> int:
    """The first swap again, on the speculating engine under two clients'
    traffic; then a draft and a verify replay against their eager
    programs on the new weights. Returns the kernel launches of its
    traffic."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    engine, warm = warm_engine(torch, model, "operate f32 speculating",
                               **SPEC)
    try:
        engine.stats.reset()
        fa.launches = fa.tma_copies = 0
        done, windows, reports = swap_traffic(engine, prompts, (ckpt,))
        launches, copies = fa.launches, fa.tma_copies
        report = engine.serving_report()
        progs = engine.programs
        shared = all(progs.draft_params["blocks"][i][k]
                     is progs.params["blocks"][i][k]
                     for i in range(progs.draft_layers)
                     for k in progs.params["blocks"][i])
        (t0, t1), rep = windows[0], reports[0]
        print(f"speculating: swap A -> B (checkpoint) {(t1 - t0) * 1e3:.1f} "
              f"ms wall with {rep['kv_slots_in_use']} pages in use, "
              f"{len(done)} requests served, none failed, "
              f"{report['decode']['spec_rounds']} speculation rounds, "
              f"compiles after warmup {rep['compiles_after_warmup']}, the "
              f"draft view shares the swapped storage {shared}", flush=True)
        check(rep["compiles_after_warmup"] == 0 and shared,
              "speculating swap")
        check_replays(engine, "speculating swap", warm, [report])
        check_prefill_launches("speculating swap", launches, copies,
                               [report])
    finally:
        engine.shutdown(drain=False)
    rs = np.random.RandomState(12)
    for family in ("draft", "verify"):
        check_replay_is_eager(torch, engine, "speculating on B", family,
                              call_inputs(engine, family, *STEP_RUNG, rs))
    del engine
    release_memory(torch)
    return launches


def phase_operate(torch, model, paged) -> int:
    """Phase 5c: the operational tier on the paged f32 engine. Returns the
    flash-attention launches of its main-path traffic."""
    from paddle_tpu_torch.distributed.checkpoint.sharded import save_sharded
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt2_small,
                                             jax_state_dict)

    print("== operate: the engine owns its weights; hot swaps A -> B -> A "
          "under traffic; telemetry over HTTP; faults, retries, a breaker",
          flush=True)
    prompts = serve_prompts(model.config.vocab_size)
    solo = paged["streams"]["greedy"][1]
    model_b = GPTForCausalLM(gpt2_small(),
                             generator=torch.Generator().manual_seed(1))
    model_b.eval()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = os.path.join(tmp, "gpt2_small_b")
        t0 = time.perf_counter()
        rep = save_sharded(jax_state_dict(model_b), ckpt)
        print(f"GPT B (seed 1) saved as a sharded checkpoint in the "
              f"reference's layout: {rep['n_tensors']} tensors, "
              f"{rep['bytes']} bytes, {time.perf_counter() - t0:.2f} s",
              flush=True)
        operated = operate_engine(torch, model, ckpt, prompts, solo)
        launches = operated["launches"]
        cold, _ = warm_engine(torch, model_b, "cold f32 on B")
        try:
            want = [cold.submit("alpha", prompts[idx],
                                max_new_tokens=NEW_TOKENS).result(600)
                    for idx, _ in operated["post"]]
        finally:
            cold.shutdown(drain=False)
        del cold
        release_memory(torch)
        idxs = [idx for idx, _ in operated["post"]]
        hold_streams(torch, model_b, [prompts[i] for i in idxs],
                     [out for _, out in operated["post"]], want,
                     "served after the swap A -> B vs a cold engine on B")
        check(any(not np.array_equal(out, solo[i])
                  for i, out in operated["post"]),
              "the streams after the swap are A's")
        launches += operate_speculating(torch, model, ckpt, prompts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model_b
    release_memory(torch)
    return launches


# phase 5d: the batch serving tier, ServingEngine over a jit.save export
BATCH_LADDER = (1, 2, 4, 8)
SEQ_LADDER = (128, 256, 512, 1024)
BATCH_REQUESTS = 16  # a tenant, 3 tenants
# each tenant's request row counts, in turn (bench.py:532)
BATCH_ROWS = ((1, 2, 4), (2, 3, 8), (1, 5, 7))
BATCH_SEQ = (16, 1024)  # request lengths, inclusive
# the rung whose replayed call is timed and profiled
BATCH_RUNG = (8, 1024)
# the fault schedule's seed: over its first 300 visits of serving.execute
# at rate 0.3 it never fires 6 times in a row, so RETRY_ATTEMPTS absorb it
BATCH_FAULT_SEED = 0
BATCH_FAULT_REQUESTS = 8


def batch_requests(vocab) -> list:
    """Each tenant's requests: ``(tenant, ids [rows, seq])``, rows cycling
    through the tenant's counts, seq lengths from ``RandomState(tenant)``
    in ``BATCH_SEQ``, token ids uniform over the vocabulary."""
    out = []
    for t, rows in enumerate(BATCH_ROWS):
        rs = np.random.RandomState(t)
        for i in range(BATCH_REQUESTS):
            seq = int(rs.randint(BATCH_SEQ[0], BATCH_SEQ[1] + 1))
            out.append((f"tenant{t}", rs.randint(
                0, vocab, (rows[i % len(rows)], seq)).astype(np.int64)))
    return out


def run_tenants(engine, requests) -> tuple:
    """One client thread a tenant, each submitting its requests one after
    another and waiting for each; returns the outputs in request order
    and the wall seconds."""
    outs, failures = [None] * len(requests), []

    def client(tenant):
        for i, (t, ids) in enumerate(requests):
            if t != tenant:
                continue
            try:
                outs[i] = engine.run(t, ids, timeout=600)[0]
            except Exception as e:  # noqa: BLE001 — the zero-drop gate
                failures.append(repr(e))
                return

    tenants = sorted({t for t, _ in requests})
    threads = [threading.Thread(target=client, args=(t,)) for t in tenants]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t0
    check(failures == [], f"batch requests failed: {failures[:3]}")
    check(all(o is not None for o in outs), "a batch request went unserved")
    return outs, wall


def hold_batch_rows(torch, layer, vocab, requests, outs) -> tuple:
    """Every request's rows against the program run alone on them (eager,
    at the exact shape): within ``LOGITS_TOL`` and argmax equal except at
    near-ties (top-2 margin of the alone run under ``NEAR_TIE``). Returns
    the largest error and the near-ties."""
    worst, near = 0.0, 0
    with torch.inference_mode():
        for (_, ids), out in zip(requests, outs):
            check(out.shape == ids.shape + (vocab,)
                  and out.dtype == np.float32,
                  f"batch output shape {out.shape} for ids {ids.shape}")
            want = layer.module(torch.from_numpy(ids).cuda())
            got = torch.from_numpy(out).cuda()
            check(bool(torch.isfinite(got).all()), "batch logits not finite")
            worst = max(worst, (got - want).abs().max().item())
            off = got.argmax(-1) != want.argmax(-1)
            if bool(off.any()):
                top = torch.topk(want[off], 2, dim=-1).values
                gaps = (top[:, 0] - top[:, 1])
                check(bool((gaps < NEAR_TIE).all()),
                      f"batch argmax differs with a top-2 margin of "
                      f"{gaps.max().item():.3g} >= {NEAR_TIE}")
                near += int(off.sum())
            del want, got
    check(worst <= LOGITS_TOL, f"batch rows vs alone err {worst} > "
          f"{LOGITS_TOL}")
    return worst, near


def replay_batches(torch, engine, batches) -> int:
    """Each recorded batch replayed again at its rung: every request's
    rows bit for bit what it was served. Returns the batches replayed."""
    from paddle_tpu_torch.serving import stack_requests

    prog = engine.predictor._ensure_batch_program()
    for reqs, bucket, seq_bucket in batches:
        stacked = stack_requests(reqs, bucket, engine._dynamic_axes,
                                 engine._n_inputs, seq_axes=engine._seq_axes,
                                 seq_bucket=seq_bucket)
        out = prog(stacked, (bucket, seq_bucket))[0]
        off = 0
        for r in reqs:
            served = torch.from_numpy(r.result(0)[0]).cuda()
            check(torch.equal(out[off:off + r.n, :r.seq], served),
                  f"request {r.id} differs from its batch replayed at "
                  f"rung {(bucket, seq_bucket)}")
            off += r.n
        del out
    return len(batches)


def batch_swap_traffic(engine, probe, sources) -> tuple:
    """Two client threads stream small requests while the main thread
    swaps to each of ``sources`` in turn, after 4 completions and then 6
    more after each swap; the probe is served before the first swap and
    after each. Returns each completed request's (end, latency), each
    swap's window, report and probe output."""
    done, failures = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client(c):
        rs = np.random.RandomState(20 + c)
        while not stop.is_set():
            ids = rs.randint(0, 50304, (1 + c, int(rs.randint(64, 257))))
            try:
                req = engine.submit(f"swap{c}", ids.astype(np.int64))
                req.result(600)
            except Exception as e:  # noqa: BLE001 — the zero-drop gate
                with lock:
                    failures.append(repr(e))
                return
            with lock:
                done.append((req.t_complete, req.t_complete - req.t_enqueue))

    def wait_for(n):
        deadline = time.perf_counter() + 600
        while len(done) < n and not failures:
            check(time.perf_counter() < deadline, "swap traffic stalled")
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(c,)) for c in (0, 1)]
    for th in threads:
        th.start()
    windows, reports, probes = [], [], [engine.run("probe", probe)[0]]
    try:
        wait_for(4)
        for source in sources:
            t0 = time.perf_counter()
            reports.append(engine.swap_weights(source))
            windows.append((t0, time.perf_counter()))
            probes.append(engine.run("probe", probe)[0])
            wait_for(len(done) + 6)
    finally:
        stop.set()
        for th in threads:
            th.join(600)
    check(failures == [], f"requests failed under the swaps: {failures[:3]}")
    return done, windows, reports, probes


def phase_batch_serve(torch, model) -> dict:
    """Phase 5d: the batch serving tier. Returns K1's launches in the
    main-path traffic and the (batch, seq) rungs the phase ran (warmup
    runs every rung of the grid)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.base.flags import set_flags
    from paddle_tpu_torch.distributed.checkpoint.sharded import save_sharded
    from paddle_tpu_torch.inference import Config, Predictor
    from paddle_tpu_torch.jit.bucketing import bucket_for
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt2_small,
                                             jax_state_dict)
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.profiler.pipeline import ServingStats
    from paddle_tpu_torch import reliability as rel
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.static import InputSpec

    print("== batch serve: jit.save(gpt2_small f32) -> torch.export -> "
          "Predictor on the card -> ServingEngine, a CUDA graph a (batch, "
          "seq) rung of [1, 2, 4, 8] x [128, 256, 512, 1024]; 3 tenants x "
          "16 requests", flush=True)
    layers = model.config.num_hidden_layers
    tmp = tempfile.mkdtemp(prefix="chip_smoke_batch_")
    engine = None
    try:
        prefix = os.path.join(tmp, "gpt2_small")
        t0 = time.perf_counter()
        jit.save(model, prefix, input_spec=[InputSpec([None, None], "int64")])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = Predictor(Config(prefix))
        load_s = time.perf_counter() - t0
        layer = pred._layer
        ops = [str(n.target) for n in layer._exported.graph.nodes
               if n.op == "call_function"]
        n_op = sum("paddle_tpu_torch.flash_attention_fwd" in t for t in ops)
        plain = [t for t in ops if "tril" in t or "einsum" in t]
        print(f"saved in {save_s:.2f} s (.pdmodel "
              f"{os.path.getsize(prefix + '.pdmodel')} bytes), loaded on "
              f"the card in {load_s:.2f} s; exported graph: {len(ops)} "
              f"calls, {n_op} paddle_tpu_torch::flash_attention_fwd, "
              f"{len(plain)} tril/einsum; ranges "
              f"{sorted(str(r) for r in layer._exported.range_constraints.values())}",
              flush=True)
        check(n_op == layers and not plain,
              f"the export holds {n_op} K1 nodes (want {layers}) and "
              f"{len(plain)} plain-attention calls")
        check(not any(t.device.type == "cpu" for t in layer._params.values()),
              "a loaded parameter stayed on the CPU")
        set_flags({"retry_max_attempts": RETRY_ATTEMPTS,
                   "retry_base_delay_ms": 1.0})
        try:
            engine = ServingEngine(pred, buckets=BATCH_LADDER,
                                   seq_buckets=SEQ_LADDER,
                                   stats=ServingStats())
        finally:
            set_flags({"retry_max_attempts": 3, "retry_base_delay_ms": 20.0})
        prog = pred._ensure_batch_program()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm = prog.graph_report()
        rungs = len(BATCH_LADDER) * len(SEQ_LADDER)
        print(f"warmup {warm_s:.2f} s: {warm}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        check(engine.compile_count == rungs and warm["captures"] == rungs,
              f"warmup armed {warm}, want {rungs} rungs captured")
        rungs_run = prog.rungs

        # record each batch the scheduler runs, to replay it afterwards
        batches, execute = [], engine._scheduler.execute

        def recording(reqs, bucket):
            seq_bucket = bucket_for(max(r.seq for r in reqs), prog.seq_ladder)
            batches.append((list(reqs), bucket, seq_bucket))
            return execute(reqs, bucket)

        engine._scheduler.execute = recording
        requests = batch_requests(model.config.vocab_size)
        # the main path's run, traced for the card's busy time: counts
        # from 0, read right after it
        fa.launches = fa.tma_copies = 0
        (outs, wall), kernel_ms, copy_ms = trace_window(
            torch, lambda: run_tenants(engine, requests))
        launches, copies = fa.launches, fa.tma_copies
        engine._scheduler.execute = execute
        rep = engine.serving_report()
        now = prog.graph_report()
        calls = rep["batches"]
        print(f"traffic: {rep['requests']} requests, {rep['samples']} "
              f"samples in {wall:.3f} s: {rep['requests_per_sec']:.2f} "
              f"requests/s, {rep['samples_per_sec']:.2f} samples/s; "
              f"latency p50 {rep['p50_ms']:.1f} ms p99 {rep['p99_ms']:.1f} "
              f"ms (queue wait p50 {rep['queue_wait_p50_ms']:.1f} ms); "
              f"{calls} batches, row fill {rep['batch_fill']:.4f} "
              f"({rep['padded_slots']} of {rep['batch_slots']} rows "
              f"padding), token fill {rep['token_fill']:.4f} "
              f"({rep['padded_tokens']} of {rep['token_slots']} token "
              f"slots padding); in the window (torch.profiler over it) "
              f"kernels ran {kernel_ms:.1f} ms (SMs idle at least "
              f"{1 - kernel_ms / 1e3 / wall:.1%}) and copies "
              f"{copy_ms:.1f} ms (the card doing neither at least "
              f"{1 - (kernel_ms + copy_ms) / 1e3 / wall:.1%}); rungs run "
              f"{sorted({(b, s) for _, b, s in batches})}; compiles "
              f"after warmup "
              f"{engine.compiles_after_warmup}; {now}; K1 launches "
              f"{launches}; memory peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, in use "
              f"after {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        check(engine.compiles_after_warmup == 0
              and now["captures"] == warm["captures"]
              and now["eager"] == warm["eager"]
              and now["replays"] - warm["replays"] == calls,
              f"after warmup: {now} for {calls} batches (warmup {warm})")
        check(launches == layers * calls and copies == 0,
              f"K1 launched {launches} times in {calls} batch calls (want "
              f"{layers} a call), {copies} TMA copies")
        worst, near = hold_batch_rows(torch, layer, model.config.vocab_size,
                                      requests, outs)
        replayed = replay_batches(torch, engine, batches)
        print(f"every request's rows bit for bit its batch replayed at the "
              f"same rung ({replayed} batches); vs the program alone at the "
              f"exact shape max abs err {worst:.3e} (tol {LOGITS_TOL}), "
              f"argmax off at {near} near-tied positions", flush=True)
        order = sorted(range(len(requests)),
                       key=lambda i: requests[i][1].size)
        cpu = Predictor(Config(prefix, device="cpu"))
        for i in order[:2]:
            err = float(np.abs(cpu.run([requests[i][1]])[0] - outs[i]).max())
            print(f"CPU Predictor from the same files, request "
                  f"{requests[i][1].shape}: max abs err {err:.3e}",
                  flush=True)
            check(err <= LOGITS_TOL, f"card vs CPU Predictor err {err}")
        del cpu, outs
        gc.collect()

        # a replayed call at the largest rung, timed and profiled
        ids = np.random.RandomState(30).randint(
            0, model.config.vocab_size, BATCH_RUNG).astype(np.int64)

        def call():
            return prog([ids], BATCH_RUNG)

        host = []
        for _ in range(3):
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                call()
                torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) / 5 * 1e3)
        kernels, dev_ms, rows = profile_calls(torch, call)
        k1 = [r for r in rows if PROFILED_KERNELS["K1"].search(r[0])]
        k1_ms, k1_count = sum(r[1] for r in k1), sum(r[2] for r in k1)
        print(f"replayed call at rung {BATCH_RUNG}: {min(host):.3f} ms host "
              f"(inputs in, logits cloned on the card), {kernels:.0f} "
              f"kernels, {dev_ms:.3f} ms on the card; K1 {k1_count:.0f} "
              f"launches, {k1_ms:.3f} ms ({k1_ms / dev_ms:.1%})", flush=True)
        for key, ms, count in rows[:8]:
            print(f"    {ms:8.4f} ms  x{count:<5.0f} {key[:100]}", flush=True)
        check(k1_count == layers, f"the profile counts {k1_count} K1 "
              f"launches a call, the counters {layers}")

        # hot swaps under two clients: A -> B (checkpoint) -> A (dict)
        model_b = GPTForCausalLM(gpt2_small(),
                                 generator=torch.Generator().manual_seed(1))
        model_b.eval()
        ckpt = os.path.join(tmp, "gpt2_small_b")
        # the reference's layout, as phase 5c writes it for the decode tier
        save_sharded(jax_state_dict(model_b), ckpt)
        probe = np.random.RandomState(31).randint(
            0, model.config.vocab_size, (2, 300)).astype(np.int64)
        before = prog.graph_report()
        done, windows, reports, probes = batch_swap_traffic(
            engine, probe, [ckpt, dict(model.state_dict())])
        after = prog.graph_report()
        inside = [lat for end, lat in done
                  if any(a <= end <= b for a, b in windows)]
        outside = [lat for end, lat in done
                   if not any(a <= end <= b for a, b in windows)]
        with torch.inference_mode():
            want_b = model_b(torch.from_numpy(probe).cuda()).cpu().numpy()
        err_b = float(np.abs(probes[1] - want_b).max())
        print(f"swaps under 2 clients, {len(done)} requests: A -> B from "
              f"the checkpoint {reports[0]['seconds'] * 1e3:.1f} ms, "
              f"{reports[0]['bytes']} bytes; B -> A from a dict "
              f"{reports[1]['seconds'] * 1e3:.1f} ms; requests done "
              f"inside the windows {p99_line(inside)}, outside "
              f"{p99_line(outside)}; probe on B vs gpt2_small B "
              f"max abs err {err_b:.3e}; graphs {after}", flush=True)
        check(after["captures"] == before["captures"]
              and after["eager"] == before["eager"]
              and engine.compiles_after_warmup == 0,
              f"the swaps captured: {before} -> {after}")
        check(err_b <= LOGITS_TOL and not np.array_equal(probes[0], probes[1]),
              "after the swap to B the probe is not B's")
        check(np.array_equal(probes[2], probes[0]),
              "after the swap back the probe differs from before the swaps")
        del model_b

        # transient faults at serving.execute, retried to the same bits
        small = [requests[i] for i in order[:BATCH_FAULT_REQUESTS]]
        base = [engine.run(t, ids, timeout=600)[0] for t, ids in small]
        inj = rel.arm(rel.FaultInjector(seed=BATCH_FAULT_SEED).plan(
            "serving.execute", rate=FAULT_RATE))
        try:
            got = [engine.run(t, ids, timeout=600)[0] for t, ids in small]
        finally:
            rel.disarm()
        fired = inj.summary()["total_injected"]
        print(f"serving.execute faults at rate {FAULT_RATE} (seed "
              f"{BATCH_FAULT_SEED}, {RETRY_ATTEMPTS} attempts): {fired} "
              f"fired and retried over {len(small)} requests, each alone",
              flush=True)
        check(fired > 0, "no fault fired")
        check(all(np.array_equal(a, b) for a, b in zip(got, base)),
              "a retried request differs from its fault-free output")
        check(engine.compiles_after_warmup == 0, "the faults recompiled")
        del base, got
    finally:
        if engine is not None:
            engine.shutdown(drain=False)
        shutil.rmtree(tmp, ignore_errors=True)
    del engine
    release_memory(torch)
    return {"launches": launches, "rungs": [tuple(r) for r in rungs_run]}


def trace_window(torch, fn) -> tuple:
    """``fn()`` under torch.profiler; returns its result, the device ms
    of kernels and the device ms of copies and sets the trace holds (each
    summed: an overlap counts twice, so an idle share they give is a lower
    bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = sum(ms for key, ms in rows
                 if key.startswith(("Memcpy", "Memset")))
    kernels = sum(ms for _, ms in rows) - copies
    check(kernels > 0, "the trace of the window holds no kernel")
    return out, kernels, copies


def release_memory(torch) -> None:
    """Collect reference cycles, then return cached blocks to the card: a
    shut-down engine's programs hold themselves (and their graphs, pools
    and the model's weights) in a cycle, since each family's program
    closes over them."""
    gc.collect()
    torch.cuda.empty_cache()


def paged_pool_bytes(model) -> int:
    """The bytes of the f32 page pool at ``SERVE_ENGINE``: two buffers of
    [layers, pages + 1, page size, heads, head dim]."""
    cfg = model.config
    pages = -(-SERVE_ENGINE["max_slots"] * SERVE_ENGINE["max_seq"]
              // SERVE_ENGINE["page_size"])
    return (2 * cfg.num_hidden_layers * (pages + 1)
            * SERVE_ENGINE["page_size"] * cfg.num_attention_heads
            * cfg.head_dim * 4)


def phase_serve_shapes(torch, shapes) -> None:
    """The kernel against its plain version at every prefill shape the
    decode serve phase ran and every (batch, seq) rung the batch serve
    phase ran, as the model gives it its inputs."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    print("== kernel at the serve phases' shapes (decode prefills, batch "
          "rungs): flash_attention_fwd vs plain (H=12 D=64 causal, packed "
          "qkv)", flush=True)
    check(len(shapes) > 0, "the serve phases recorded no shape")
    rs = np.random.RandomState(3)
    for b, s in shapes:
        for dtype in ("float32", "bfloat16"):
            q, k, v = packed_qkv(torch, rs, b, s, dtype)
            err_o, err_l, exact = compare_kernel(torch, fa, q, k, v, dtype,
                                                 True)
            print(f"B={b} S={s:4d} {dtype:8s} causal=1  O err {err_o:.2e}  "
                  f"lse err {err_l:.2e}{exact}", flush=True)


def _close(torch, got, want, dtype) -> tuple:
    """(max abs error, within BWD_TOL)."""
    atol, rtol = BWD_TOL[dtype]
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return float(err.max()), ok


def equal_count(got, want) -> str:
    """How many elements of a kernel's output equal the plain version's
    bit for bit, of all."""
    return f"{int((got == want).sum())}/{got.numel()}"


def float64_backward_errors(torch, fa, q, k, v, o, lse, do, seed, dropout,
                            grads) -> str:
    """The f32 K2/K3's (dq, dk, dv) and the f32 plain version's against
    the plain backward computed in float64 from the same (o, lse); the
    kernels fail past ``BWD_TOL["float32"]`` of it. Returns both errors
    per gradient as text."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    exact = fa.flash_attention_bwd_reference(
        *(t.double() for t in (q, k, v, o, lse, do)), seed, True, scale,
        dropout)
    plain = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seed, True,
                                             scale, dropout)
    rows = []
    for name, got, ref, want in zip(("dq", "dk", "dv"), grads, plain, exact):
        err = float((got.double() - want).abs().max())
        err_plain = float((ref.double() - want).abs().max())
        check(err <= BWD_TOL["float32"][0],
              f"f32 {name} vs the float64 plain version at {tuple(q.shape)} "
              f"dropout={dropout}: err {err:.3g} (tol "
              f"{BWD_TOL['float32'][0]})")
        rows.append(f"{name} {err:.2e} (plain f32 {err_plain:.2e})")
    del exact, plain
    return " ".join(rows)


def compare_backward(torch, fa, q, k, v, do, seed, dtype, dropout,
                     causal=True) -> tuple:
    """K1 (with dropout) and K2/K3 against their plain versions on the
    same card tensors; K2/K3 are compared from the same (o, lse), so each
    kernel is judged alone, and each must have launched once, so no plain
    version stands in for it. In f32 all three are also held against the
    plain versions computed in float64. Returns the max abs error per
    output, per gradient the count of elements equal to the plain
    version's, and the float64 errors as text (f32) or ""."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, dropout, seed)
    before = (fa.dq_launches, fa.dkv_launches)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, seed, causal, scale,
                                   dropout)
    torch.cuda.synchronize()
    check((fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1),
          f"K2/K3 did not launch once each at {tuple(q.shape)} {dtype}")
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal, scale,
                                                dropout, seed)
    errs = {}
    for name, got, want in (("o", o, ro), ("lse", lse, rlse)):
        errs[name], ok = _close(torch, got, want, dtype)
        check(ok and bool(torch.isfinite(got.float()).all()),
              f"K1 {name} vs plain at {tuple(q.shape)} {dtype} dropout "
              f"{dropout}: err {errs[name]:.3g}")
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seed,
                                            causal, scale, dropout)
    equal = {}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        check(float(ref.float().abs().max()) > 0, f"plain {name} is all 0")
        errs[name], ok = _close(torch, got, ref, dtype)
        equal[name] = equal_count(got, ref)
        check(ok and bool(torch.isfinite(got.float()).all()),
              f"{name} vs plain at {tuple(q.shape)} {dtype} dropout "
              f"{dropout}: err {errs[name]:.3g}")
    del want
    exact = ""
    if dtype == "float32":
        exact = ("\n    vs float64 " + float64_forward_errors(
            torch, fa, q, k, v, o, lse, True, scale, dropout, seed) + " "
            + float64_backward_errors(torch, fa, q, k, v, o, lse, do, seed,
                                      dropout, grads))
        torch.cuda.empty_cache()
    return errs, equal, exact


def check_dropout_positions(torch, fa, b, s, seed, dtype,
                            dropout=0.1) -> int:
    """The dropped (q, k) positions of K1, K2 and K3 are exactly the plain
    version's, over the whole [B, H, S, S] mask, 64 columns at a time.
    With q = 0 every allowed probability is 1/(row + 1); a one-hot
    [B, S, H, D] operand over a window of 64 positions then reads one
    mask column per output column: v for K1 (o), k for K2 (dq, with
    dO·Vᵀ > 0 so a kept and a dropped position differ by at least the
    probability), dO for K3 (dv). In float32 a flipped position changes an
    output by at least 1/(0.9·S); the check allows 1e-2/S. In bfloat16,
    where the tensor-core K1 and K2 round P and dS, the check is on the
    positions alone: K2 then runs with O = 0, so Δ = 0 and dq is positive
    exactly where a position is kept. Returns the number of positions
    checked."""
    h, d = HEADS, HEAD_DIM
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    exact = dtype == "float32"
    scale = 1.0 / math.sqrt(d)
    zeros = torch.zeros(b, s, h, d, device=dev, dtype=dt)
    rs = np.random.RandomState(6)
    tol = 1e-2 / s
    vrow = torch.zeros(b, s, h, d, device=dev, dtype=dt)
    vrow[..., 0] = torch.from_numpy(rs.uniform(1, 2, (b, s, h)).astype(
        np.float32)).to(dev, dt)
    e0 = torch.zeros(b, s, h, d, device=dev, dtype=dt)
    e0[..., 0] = 1.0

    def window(w0):
        basis = torch.zeros(b, s, h, d, device=dev, dtype=dt)
        idx = torch.arange(w0, min(w0 + d, s), device=dev)
        basis[:, idx, :, idx - w0] = 1.0
        return basis

    for w0 in range(0, s, d):
        basis = window(w0)
        # K1: o[q, c] = keep(q, w0 + c) / (0.9 (q + 1))
        o, _ = fa.flash_attention_fwd(zeros, zeros, basis, True, scale,
                                      dropout, seed)
        ro, rlse = fa.flash_attention_fwd_reference(zeros, zeros, basis,
                                                    True, scale, dropout,
                                                    seed)
        check(torch.equal(o > 0, ro > 0)
              and (not exact or float((o - ro).abs().max()) <= tol),
              f"K1 dropped positions differ from the plain version's "
              f"({dtype} B={b} S={s}, columns {w0}..)")
        # K2: dq[q, c] = scale * p * (keep * u / 0.9 - delta) at k = w0 + c
        o2, lse2 = fa.flash_attention_fwd_reference(zeros, basis, vrow,
                                                    True, scale, dropout,
                                                    seed)
        if not exact:
            o2 = zeros  # delta = 0: dq > 0 exactly where kept
        dq, _, _ = fa.flash_attention_bwd(zeros, basis, vrow, o2, lse2, e0,
                                          seed, True, scale, dropout)
        rdq, _, _ = fa.flash_attention_bwd_reference(
            zeros, basis, vrow, o2, lse2, e0, seed, True, scale, dropout)
        check(float((dq - rdq).abs().max()) <= tol * scale if exact
              else torch.equal(dq > 0, rdq > 0),
              f"K2 dropped positions differ from the plain version's "
              f"({dtype} B={b} S={s}, columns {w0}..)")
        # K3: dv[k, c] = keep(w0 + c, k) / (0.9 (w0 + c + 1))
        _, _, dv = fa.flash_attention_bwd(zeros, zeros, zeros, ro, rlse,
                                          basis, seed, True, scale, dropout)
        _, _, rdv = fa.flash_attention_bwd_reference(
            zeros, zeros, zeros, ro, rlse, basis, seed, True, scale, dropout)
        check(torch.equal(dv > 0, rdv > 0)
              and (not exact or float((dv - rdv).abs().max()) <= tol),
              f"K3 dropped positions differ from the plain version's "
              f"({dtype} B={b} S={s}, rows {w0}..)")
    torch.cuda.synchronize()
    return b * h * s * s


def time_qkv_scatter(torch) -> float:
    """Device ms of what autograd does with K2/K3's dq, dk, dv in the GPT
    attention: back through ``qkv[..., i, :]`` into one packed qkv grad."""
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, HEADS, HEAD_DIM
    qkv = torch.zeros(b, s, h, 3, d, device="cuda", dtype=torch.bfloat16,
                      requires_grad=True)
    views = (qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :])
    grads = tuple(torch.randn(b, s, h, d, device="cuda",
                              dtype=torch.bfloat16) for _ in range(3))
    return cuda_time_ms(lambda: torch.autograd.grad(views, qkv, grads,
                                                    retain_graph=True))


def time_attention(torch, fa, q, k, v, do, seed, dtype, dropout) -> dict:
    """K1, K2 and K3 timed alone by CUDA events at the shape of q (k and v
    as they reach the kernels), beside their bounds, their plain versions
    and SDPA's forward and backward (a yardstick only)."""
    import torch.nn.functional as TF

    b, s, h, d = q.shape
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale, dropout, seed)
    args, keep = fa.bwd_launch_args(q, k, v, o, lse, do, seed, True, scale,
                                    dropout)
    ms = {
        "fwd": cuda_time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, True, scale, dropout, seed)),
        "dq": cuda_time_ms(lambda: fa.run_bwd_pass("bwd_dq", args, dev)),
        "dkv": cuda_time_ms(lambda: fa.run_bwd_pass("bwd_dkv", args, dev)),
    }
    plain = {
        "fwd": cuda_time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, True, scale, dropout, seed), iters=3),
        "bwd": cuda_time_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, o, lse, do, seed, True, scale, dropout), iters=3),
    }
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    lib_fwd = cuda_time_ms(lambda: TF.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    out = TF.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    del out, qt, kt, vt, keep
    shapes = {"fwd": (2, 4, 1), **BWD_BOUND}
    bounds = {name: kernel_bound(b, s, h, d, dtype, True, *shape,
                                 peak=pass_peak(name, dtype))
              for name, shape in shapes.items()}
    # the f32 tensor-core kernels' bounds at 495/3 TFLOP/s, with the
    # 67 TFLOP/s CUDA-core figure beside them
    cores = {name: kernel_bound(b, s, h, d, dtype, True, *shapes[name])[0]
             for name in TF32X3_PASSES} if dtype == "float32" else {}

    def bound(name):
        text = f"bound {bounds[name][0]:.4f} {bounds[name][1]}"
        if name in cores:
            text += f" at 495/3 TFLOP/s, {cores[name]:.4f} at 67 TFLOP/s"
        return text

    line = (f"K1 {ms['fwd']:.4f} ({bound('fwd')}, plain {plain['fwd']:.4f}, "
            f"sdpa fwd {lib_fwd:.4f})  K2 {ms['dq']:.4f} ({bound('dq')})  K3 "
            f"{ms['dkv']:.4f} ({bound('dkv')})  plain bwd "
            f"{plain['bwd']:.4f}  sdpa bwd {lib_bwd:.4f}")
    return {"ms": ms, "plain": plain, "lib_fwd": lib_fwd, "lib_bwd": lib_bwd,
            "bounds": bounds, "cores": cores, "line": line}


def attention_records(t, errs) -> dict:
    """K1–K3 records for the kernels line from :func:`time_attention`'s
    timings and :func:`compare_backward`'s errors."""
    return {name: {"max_abs_err": err, "ms": t["ms"][name],
                   "plain_ms": plain_ms, "bound_ms": t["bounds"][name][0],
                   "bound_by": t["bounds"][name][1], "library_ms": lib_ms}
            for name, err, plain_ms, lib_ms in (
                ("fwd", errs["o"], t["plain"]["fwd"], t["lib_fwd"]),
                ("dq", errs["dq"], t["plain"]["bwd"], t["lib_bwd"]),
                ("dkv", max(errs["dk"], errs["dv"]), t["plain"]["bwd"],
                 t["lib_bwd"]))}


def phase_backward(torch) -> dict:
    """K1 with dropout, K2 and K3 against their plain versions; timings at
    the training shape. Returns the record of each kernel at the main
    path's shape (B=8, S=1024, bf16, dropout 0)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    print("== backward kernels: K1 with dropout, K2 (dq), K3 (dk/dv) vs "
          "plain vs SDPA (H=12 D=64 causal, packed qkv; ms by CUDA events)",
          flush=True)
    h, d = HEADS, HEAD_DIM
    dev = torch.device("cuda")
    rs = np.random.RandomState(4)
    seed = torch.tensor([20241016], dtype=torch.int32, device=dev)
    records = {}
    for b, s in BWD_SHAPES:
        for dtype in ("float32", "bfloat16"):
            q, k, v = packed_qkv(torch, rs, b, s, dtype)
            do = torch.from_numpy(rs.randn(b, s, h, d).astype(
                np.float32)).to(dev, getattr(torch, dtype))
            for dropout in (0.0, 0.1):
                errs, equal, exact = compare_backward(
                    torch, fa, q, k, v, do, seed, dtype, dropout)
                line = (f"B={b} S={s:4d} {dtype:8s} dropout={dropout}  err "
                        + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
                        + "  bitwise equal " + " ".join(
                            f"{n} {c}" for n, c in equal.items()) + exact)
                if (b, s) == (8, 1024):
                    t = time_attention(torch, fa, q, k, v, do, seed, dtype,
                                       dropout)
                    line += "\n    " + t["line"]
                    shape = (f"B={b} S={s} H={h} D={d} {dtype} causal "
                             f"dropout={dropout}")
                    for name, rec in attention_records(t, errs).items():
                        records[(name, dtype, dropout)] = dict(rec,
                                                               shape=shape)
                print(line, flush=True)
    scatter_ms = time_qkv_scatter(torch)
    print(f"qkv gradient scatter at B=8 S=1024 bf16 (dq, dk, dv back through "
          f"the select views of the packed [B, S, H, 3, D] qkv): "
          f"{scatter_ms:.4f} ms per layer, {LAYERS * scatter_ms:.3f} ms per "
          f"step", flush=True)
    for b, s in ((8, 1024), (1, 1000)):
        for dtype in ("float32", "bfloat16"):
            n = check_dropout_positions(torch, fa, b, s, seed, dtype)
            print(f"dropout 0.1 at B={b} S={s} {dtype}: the dropped "
                  f"positions of K1, K2 and K3 equal the plain version's at "
                  f"all {n} (b, h, q, k)", flush=True)
    return records


def grad_check(model, crit, ids) -> tuple:
    """(loss, {name: grad}) of one forward and backward."""
    loss = crit(model(ids), ids)
    loss.backward()
    return loss.item(), {n: p.grad.detach().float().cpu()
                         for n, p in model.named_parameters()}


def compare_gradients(torch, model_cls, crit, cfg, ids) -> tuple:
    """Every gradient of ``model_cls(cfg)`` (seeded weights, training mode)
    on the card against the CPU plain path, within ``GRAD_REL_TOL`` of the
    tensor's max. Returns the card run's launches of K1, K2, K3, K4 and the
    RMSNorm backward kernel, and a summary line."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    card = model_cls(cfg, generator=torch.Generator().manual_seed(0))
    fa.launches = fa.dq_launches = fa.dkv_launches = rms.launches = 0
    rms.bwd_launches = 0
    loss_card, g_card = grad_check(card.train(), crit,
                                   torch.from_numpy(ids).cuda())
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches, rms.launches,
              rms.bwd_launches)
    del card
    torch.cuda.empty_cache()
    cpu = model_cls(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    loss_cpu, g_cpu = grad_check(cpu.train(), crit, torch.from_numpy(ids))
    worst, worst_name = 0.0, None
    for name, want in g_cpu.items():
        got = g_card[name]
        check(bool(torch.isfinite(got).all()), f"{name} grad not finite")
        top = float(want.abs().max())
        err = float((got - want).abs().max())
        check(top > 0 and err <= GRAD_REL_TOL * top,
              f"{name}: card vs CPU grad err {err:.3g} > {GRAD_REL_TOL} x "
              f"max {top:.3g}")
        if err / top > worst:
            worst, worst_name = err / top, name
    return counts, (f"loss card {loss_card:.6f} CPU {loss_cpu:.6f}; "
                    f"{len(g_cpu)} gradients within {GRAD_REL_TOL} of their "
                    f"max; worst {worst:.2e} ({worst_name}); launches "
                    f"K1/K2/K3/K4/K4-bwd {counts}")


def phase_gradients(torch, gpt) -> None:
    """Every gpt2_small gradient on the card (K1–K3) against the CPU."""
    print("== gradients: gpt2_small f32, dropout 0, B=1 S=256, card (K1-K3) "
          "vs CPU (plain)", flush=True)
    cfg = gpt.gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size, (1, 256))
    counts, line = compare_gradients(torch, gpt.GPTForCausalLM,
                                     gpt.GPTPretrainingCriterion(cfg), cfg,
                                     ids)
    check(counts == (LAYERS, LAYERS, LAYERS, 0, 0),
          f"K1/K2/K3/K4/K4-bwd launches {counts}, want {LAYERS} each of "
          f"K1-K3")
    print(line, flush=True)


def megatron_flops(batch, seq, layers, hidden, vocab) -> float:
    """Megatron-LM training-step FLOPs (fwd+bwd, no recompute), the
    formula of ``bench.py``: 96·B·s·l·h²·(1 + s/(6h) + V/(16·l·h))."""
    return (96.0 * batch * seq * layers * hidden * hidden
            * (1.0 + seq / (6.0 * hidden) + vocab / (16.0 * layers * hidden)))


def build_train_step(torch, model_cls, crit_cls, cfg, dropout_seed=0):
    """The model in bf16 O2 under ``TrainStep`` with ``AdamW(1e-4)``, the
    criterion outside ``auto_cast``, as ``bench.py`` builds its arms.
    Returns the model, the step, and the eager step by hand: ``loss_fn``,
    ``backward``, ``step``, ``clear_grad`` on the same model and
    optimizer."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    model = model_cls(cfg, generator=torch.Generator().manual_seed(0),
                      dropout_seed=dropout_seed).train()
    crit = crit_cls(cfg)
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())

    def loss_fn(ids):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(ids)
        return crit(logits, ids)

    def eager_step(ids):
        loss = loss_fn(ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    return (model, TrainStep(model=model, optimizer=opt, loss_fn=loss_fn),
            eager_step)


def eager_reference(torch, model_cls, crit_cls, cfg, ids, steps,
                    dropout_seed=0) -> tuple:
    """The graphed step's reference: ``steps`` eager steps by hand from the
    same seeds. Returns the losses and the parameters after them."""
    model, _, eager_step = build_train_step(torch, model_cls, crit_cls, cfg,
                                            dropout_seed)
    losses = [eager_step(ids) for _ in range(steps)]
    torch.cuda.synchronize()
    out = ([float(x) for x in losses],
           [p.detach().clone() for p in model.parameters()])
    del model, eager_step
    torch.cuda.empty_cache()
    return out


def check_against_eager(torch, what, losses, params, reference) -> None:
    """The graphed run's losses and parameters bit for bit the eager
    sequence's."""
    want_losses, want_params = reference
    same = [torch.equal(a, b) for a, b in zip(params, want_params)]
    print(f"{what}: {len(losses)} losses and {len(params)} parameters "
          f"against the eager sequence by hand: losses bitwise equal "
          f"{losses == want_losses}, parameters bitwise equal "
          f"{sum(same)}/{len(same)}", flush=True)
    check(losses == want_losses and all(same) and len(same) == len(
        want_params), f"{what}: the graphed steps differ from the eager "
        f"sequence (losses {losses} against {want_losses})")


def adamw_launches_per_step(model) -> int:
    """AdamW kernel launches one step makes: one per ``MAX_TENSORS``
    parameters of one dtype."""
    from paddle_tpu_torch.ops.cuda import adamw

    by_dtype = {}
    for p in model.parameters():
        by_dtype[p.dtype] = by_dtype.get(p.dtype, 0) + 1
    return sum(math.ceil(n / adamw.MAX_TENSORS) for n in by_dtype.values())


# eager first call, then the capture and its first replay
GRAPH_WARMUP = 2


def run_timed_steps(torch, step, ids) -> tuple:
    """``GRAPH_WARMUP`` warmup steps (the eager call, then the capture),
    then ``TRAIN_STEPS`` timed ones (host clock around each, ending in a
    synchronize), every one a graph replay, with every launch count set to
    0 just before them and read just after; fails if an operand was
    copied for TMA or a timed step did not replay. Returns (warmup losses,
    losses, step seconds, launches of K1, K2, K3, K4, AdamW, the RMSNorm
    backward)."""
    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    torch.cuda.reset_peak_memory_stats()
    first = [float(step(ids).float()) for _ in range(GRAPH_WARMUP)]
    torch.cuda.synchronize()
    stats = dict(step.stats)
    # the main path's run: counts from 0, read right after it
    fa.launches = fa.dq_launches = fa.dkv_launches = rms.launches = 0
    fa.tma_copies = adamw.launches = rms.bwd_launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches, rms.launches,
              adamw.launches, rms.bwd_launches)
    check(fa.tma_copies == 0, f"{fa.tma_copies} operands were copied for "
          f"TMA on the training path")
    print(f"operands copied for TMA: {fa.tma_copies}", flush=True)
    ran = {k: step.stats[k] - stats[k] for k in stats}
    report = step.audit_report()
    print(f"TrainStep: timed steps {ran}; captures "
          f"{report['total_captures']} over {report['n_cache_keys']} cache "
          f"key(s); all steps {report['stats']}", flush=True)
    check(ran == {"compiled_steps": TRAIN_STEPS, "eager_steps": 0},
          f"timed steps {ran}: not every timed step ran as a graph replay")
    check(report["total_captures"] == 1, f"{report['total_captures']} "
          f"captures of one signature")
    return first, [float(x.float()) for x in losses], times, counts


def report_steps(torch, first, losses, times, tokens, flops, formula) -> float:
    """Print the losses, step ms, tokens/s, model TFLOP/s and MFU (``flops``
    per step by ``formula``) and peak memory; check the losses are finite
    and fall. Returns the p50 step in seconds."""
    p50 = float(np.median(times))
    print("warmup losses " + " ".join(f"{x:.4f}" for x in first)
          + "; losses " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    print(f"step ms p50 {p50 * 1e3:.3f} (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}); tokens/s {tokens / p50:.1f}; model "
          f"TFLOP/s {flops / p50 / 1e12:.2f} ({formula} {flops / 1e12:.3f} "
          f"TFLOP per step); MFU {flops / p50 / PEAK_FLOPS['bfloat16']:.2%} "
          f"of 989 TFLOP/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return p50


# the port's kernels by their exact names in the profiler's rows (the
# demangled "void (anonymous namespace)::fwd_sm90_kernel<...>(...)"): K1,
# K2 and K3 in either dtype's kernel (fwd_sm90_kernel, fwd_tf32_kernel,
# dkv_tf32_kernel, ...), K4, the RMSNorm backward's two kernels and the
# AdamW kernel, whatever else is named *_kernel. K5's
# flashmask_fwd_sm90_kernel matches none of them, and K4's pattern none of
# the backward's
PROFILED_KERNELS = {
    "K1": re.compile(r"(?:^|[\s:])fwd(?:_sm90|_tf32)?_kernel<"),
    "K2": re.compile(r"(?:^|[\s:])dq(?:_sm90|_tf32)?_kernel<"),
    "K3": re.compile(r"(?:^|[\s:])dkv(?:_sm90|_tf32)?_kernel<"),
    "K4": re.compile(r"(?:^|[\s:])rms_norm_kernel<"),
    "K4 bwd": re.compile(r"(?:^|[\s:])rms_norm_(?:bwd|dw)_kernel<"),
    "AdamW": re.compile(r"(?:^|[\s:])adamw_kernel<"),
}
ATTENTION_KERNELS = re.compile(
    r"(?:^|[\s:])(?:fwd|dq|dkv)(?:_sm90|_tf32)?_kernel<")
RMS_NORM_KERNEL = PROFILED_KERNELS["K4"]
RMS_NORM_BWD_KERNEL = PROFILED_KERNELS["K4 bwd"]
# The profiler keeps only the device events whose timestamps fall inside
# its window, and the card's clock may read ahead of or behind the host's:
# a kernel launched just after the window opened was lost there (K1 and
# K4 of a step's first layer). The card idles this long at each end.
PROFILE_PAD_S = 0.25


def profile_steps(torch, step, ids, step_ms, steps=2) -> dict:
    """Device time by kernel over a few steps (torch.profiler), beside the
    timed step's p50: their gap is the time the card idles. One warmup step
    starts the tracer before the window, and the card idles
    ``PROFILE_PAD_S`` inside each end of the window, so that no kernel at
    its edges falls outside it; the profile's launches of K1–K4 per step
    must equal the launch counters over the same steps, and so must the
    RMSNorm backward's and the AdamW kernel's. Returns the ms per step of
    K1–K3 together, of K4, of the RMSNorm backward, of the element-wise
    rest, and of all device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    def counters():
        return {"K1": fa.launches, "K2": fa.dq_launches,
                "K3": fa.dkv_launches, "K4": rms.launches,
                "K4 bwd": rms.bwd_launches, "AdamW": adamw.launches}

    k5 = "void (anonymous namespace)::flashmask_fwd_sm90_kernel<128>(...)"
    check(not any(rx.search(k5) for rx in PROFILED_KERNELS.values()),
          "the profile would count K5 as one of K1-K4")
    for name in ("rms_norm_bwd_kernel", "rms_norm_dw_kernel"):
        row = f"void (anonymous namespace)::{name}<float, float, 4, 32, 6>(...)"
        check(not RMS_NORM_KERNEL.search(row)
              and RMS_NORM_BWD_KERNEL.search(row),
              f"the profile would count {name} as K4")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1)) as prof:
        for i in range(steps + 1):
            if i == 1:
                time.sleep(PROFILE_PAD_S)
                before = counters()
            step(ids)
            torch.cuda.synchronize()
            if i == steps:
                time.sleep(PROFILE_PAD_S)
            prof.step()
    after = counters()
    # device-side rows only: a CPU op's row repeats its kernels' time, and
    # the schedule's "ProfilerStep*" row spans a whole step
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    check(len(rows) > 0, "the profiler recorded no device time")
    profiled = {name: sum(r[2] for r in rows if rx.search(r[0]))
                for name, rx in PROFILED_KERNELS.items()}
    counted = {name: (after[name] - before[name]) / steps for name in after}
    print(f"launches per step, profile {profiled}, counters {counted}",
          flush=True)
    check(profiled == counted, f"the profile's launches per step {profiled} "
          f"differ from the launch counters' {counted}")
    total = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    ours = sum(r[1] for r in rows if ATTENTION_KERNELS.search(r[0]))
    k4 = [r for r in rows if RMS_NORM_KERNEL.search(r[0])]
    k4_ms = sum(r[1] for r in k4)
    k4_bwd = [r for r in rows if RMS_NORM_BWD_KERNEL.search(r[0])]
    k4_bwd_ms = sum(r[1] for r in k4_bwd)
    adamw_ms = sum(r[1] for r in rows
                   if PROFILED_KERNELS["AdamW"].search(r[0]))
    # cuBLAS's kernels by name; a row already counted as one of ours is not
    gemm = sum(r[1] for r in rows
               if re.search(r"nvjet|gemm|cutlass|sm90_xmma", r[0])
               and not any(rx.search(r[0])
                           for rx in PROFILED_KERNELS.values()))
    launches = sum(r[2] for r in rows)
    rest = total - ours - k4_ms - k4_bwd_ms - adamw_ms - gemm
    k3_ms = sum(r[1] for r in rows if PROFILED_KERNELS["K3"].search(r[0]))
    print(f"profile of {steps} steps: device busy {total:.3f} ms per step "
          f"({total / step_ms:.1%} of the {step_ms:.3f} ms p50 step; idle "
          f"{1 - total / step_ms:.1%}), {launches:.0f} kernel launches per "
          f"step; K1+K2+K3 {ours:.3f} ms ({ours / total:.1%} of device "
          f"time; K3 {k3_ms:.3f} ms, {k3_ms / total:.1%}), K4 {k4_ms:.3f} "
          f"ms ({k4_ms / total:.1%}) in {sum(r[2] for r in k4):.0f} "
          f"launches, K4's backward {k4_bwd_ms:.3f} ms "
          f"({k4_bwd_ms / total:.1%}) in {profiled['K4 bwd']:.0f} launches, "
          f"AdamW {adamw_ms:.3f} ms ({adamw_ms / total:.1%}) in "
          f"{profiled['AdamW']:.0f} launches, cuBLAS GEMMs {gemm:.3f} ms "
          f"({gemm / total:.1%}), the rest {rest:.3f} ms", flush=True)
    for key, ms, count in rows[:16]:
        print(f"    {ms:8.3f} ms  x{count:<6.0f} {key[:100]}", flush=True)
    for label, group in (("K4", k4), ("K4 bwd", k4_bwd)):
        for key, ms, count in group:
            print(f"    {label} row: {ms:8.3f} ms  x{count:<6.0f} "
                  f"{key[:100]}", flush=True)
    return {"launches": launches, "attention_ms": ours, "rms_norm_ms": k4_ms,
            "rms_norm_rows": len(k4), "rms_norm_bwd_ms": k4_bwd_ms,
            "rms_norm_bwd_rows": len(k4_bwd), "rest_ms": rest,
            "device_ms": total}


def phase_train(torch, gpt) -> dict:
    """bench_gpt's accelerator arm on the port, graphed, held bit for bit
    to the eager sequence; returns the launches and the profile."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    print(f"== train: gpt2_small bf16 O2, TrainStep (CUDA graph) + "
          f"AdamW(1e-4), {TRAIN_BATCH}x{TRAIN_SEQ} fixed batch, dropout 0",
          flush=True)
    cfg = gpt.gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)).cuda()
    reference = eager_reference(torch, gpt.GPTForCausalLM,
                                gpt.GPTPretrainingCriterion, cfg, ids,
                                GRAPH_WARMUP + TRAIN_STEPS)
    model, step, _ = build_train_step(torch, gpt.GPTForCausalLM,
                                      gpt.GPTPretrainingCriterion, cfg)
    first, losses, times, counts = run_timed_steps(torch, step, ids)
    check_against_eager(torch, "train", first + losses,
                        [p.detach() for p in model.parameters()], reference)
    del reference
    flops = megatron_flops(TRAIN_BATCH, TRAIN_SEQ, cfg.num_hidden_layers,
                           cfg.hidden_size, cfg.vocab_size)
    p50 = report_steps(torch, first, losses, times, TRAIN_BATCH * TRAIN_SEQ,
                       flops, "Megatron")
    per_step = adamw_launches_per_step(model)
    print(f"launches K1/K2/K3/K4/AdamW/K4-bwd {counts} over {TRAIN_STEPS} "
          f"steps", flush=True)
    want = LAYERS * TRAIN_STEPS
    check(counts == (want, want, want, 0, per_step * TRAIN_STEPS, 0),
          f"launches {counts}, want {want} each of K1-K3 ({LAYERS} per "
          f"step) and {per_step * TRAIN_STEPS} of AdamW ({per_step} per "
          f"step)")
    prof = profile_steps(torch, step, ids, p50 * 1e3)
    del model, step
    torch.cuda.empty_cache()

    steps = 4
    print(f"== train with dropout: gpt2_small defaults (0.1), B=2 S=1024, "
          f"{steps} steps graphed (eager, capture, replays), twice from one "
          f"seed, against the eager sequence", flush=True)
    cfg = gpt.gpt2_small()
    reference = eager_reference(torch, gpt.GPTForCausalLM,
                                gpt.GPTPretrainingCriterion, cfg, ids[:2],
                                steps, dropout_seed=7)
    runs = []
    for _ in range(2):
        model, step, _ = build_train_step(torch, gpt.GPTForCausalLM,
                                          gpt.GPTPretrainingCriterion, cfg,
                                          dropout_seed=7)
        fa.dropout_launches.update(fwd=0, bwd_dq=0, bwd_dkv=0)
        stream = [float(step(ids[:2]).float()) for _ in range(steps)]
        torch.cuda.synchronize()
        runs.append((stream, dict(fa.dropout_launches),
                     [p.detach().clone() for p in model.parameters()],
                     dict(step.stats)))
        del model, step
    (a, launched, pa, stats), (b, _, pb, _) = runs
    same = all(torch.equal(x, y) for x, y in zip(pa, pb))
    print(f"losses {a} and {b}; parameters after {steps} steps bitwise "
          f"equal: {same}; launches with dropout {launched}; steps {stats}",
          flush=True)
    check(a == b and same, "two dropout runs from one seed differ")
    check_against_eager(torch, "train with dropout", a, pa, reference)
    check(stats == {"compiled_steps": steps - 1, "eager_steps": 1},
          f"dropout steps {stats}: not graphed after the first")
    check(all(math.isfinite(x) for x in a), f"non-finite loss {a}")
    check(launched == {"fwd": steps * LAYERS, "bwd_dq": steps * LAYERS,
                       "bwd_dkv": steps * LAYERS},
          f"kernels did not run with dropout: {launched}")
    return {"fwd": counts[0], "dq": counts[1], "dkv": counts[2],
            "adamw": counts[4], "launches_per_step": prof["launches"]}


def device_time_ms(torch, fns, iters: int = 60) -> float:
    """Mean device time of one call, for kernels shorter than their
    wrapper's host time: a ~25 ms spin on the stream lets the host queue
    all ``iters`` launches before the first runs, so the events time the
    card alone. ``fns`` are called in turn, each on its own inputs, which
    together exceed the 50 MB L2 cache, so every launch reads from HBM as
    the training step's does."""
    for fn in fns:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rms_norm_bound(rows: int, d: int, dtype: str) -> tuple:
    """Least time (ms) for one K4 launch: x read and y written once (w is
    d elements) over HBM bandwidth, against its ~4 f32 operations per
    element (square-add, two multiplies) on the CUDA cores."""
    elem = 4 if dtype == "float32" else 2
    nbytes = (2 * rows + 1) * d * elem
    t_mem = nbytes / PEAK_BYTES * 1e3
    t_ops = 4.0 * rows * d / PEAK_FLOPS["float32"] * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


# f32 operations per element of the RMSNorm backward: x² and g·w·x into
# the row sums (fma, mul, fma), xn, g·xn into dw (fma), dx (mul, fma, mul)
RMS_BWD_OPS = 11


def rms_norm_bwd_bound(rows: int, d: int, dtype: str) -> tuple:
    """Least time (ms) for one backward call: x and g read and dx written
    once, w read and dw written once (d elements each), over HBM
    bandwidth, against its ``RMS_BWD_OPS`` f32 operations per element on
    the CUDA cores. The blocks' dw partials are the kernel's own scratch
    and are not counted."""
    elem = 4 if dtype == "float32" else 2
    nbytes = (3 * rows + 2) * d * elem
    t_mem = nbytes / PEAK_BYTES * 1e3
    t_ops = RMS_BWD_OPS * rows * d / PEAK_FLOPS["float32"] * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def _rms_bwd_within(torch, got, want, dtype) -> bool:
    err = (got.float() - want.float()).abs()
    if dtype == "float32":
        return bool((err <= RMS_BWD_TOL[dtype]
                     * want.float().abs().max()).all())
    rel, atol = RMS_BWD_TOL[dtype]
    return bool((err <= rel * want.float().abs() + atol).all())


def compare_rms_norm_bwd(torch, rms, x, w, g, dtype) -> dict:
    """The RMSNorm backward kernel against its plain version on the same
    card tensors (f32 also against the plain version computed in float64,
    beside the f32 plain version's own error there); two calls must give
    the same bits. Fails past ``RMS_BWD_TOL``. Returns the max abs errors
    of dx and dw (and, in f32, against float64)."""
    got = rms.rms_norm_bwd(x, w, g, RMS_EPS)
    again = rms.rms_norm_bwd(x, w, g, RMS_EPS)
    want = rms.rms_norm_bwd_reference(x, w, g, RMS_EPS)
    torch.cuda.synchronize()
    where = f"K4's backward vs plain at {tuple(x.shape)} {dtype}"
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{where}: two calls on the same inputs differ")
    errs = {}
    for name, a, b in zip(("dx", "dw"), got, want):
        check(a.shape == b.shape and a.dtype == b.dtype
              and bool(torch.isfinite(a.float()).all()),
              f"{where}: {name} {tuple(a.shape)} {a.dtype}, not finite or "
              f"not {tuple(b.shape)} {b.dtype}")
        errs[name] = float((a.float() - b.float()).abs().max())
        check(_rms_bwd_within(torch, a, b, dtype),
              f"{where}: {name} err {errs[name]:.3g}")
    if dtype == "float32":
        exact = rms.rms_norm_bwd_reference(x.double(), w.double(),
                                           g.double(), RMS_EPS)
        for name, a, plain, b in zip(("dx", "dw"), got, want, exact):
            errs[name + "_f64"] = float((a.double() - b).abs().max())
            errs[name + "_plain_f64"] = float((plain.double() - b).abs().max())
            check(_rms_bwd_within(torch, a, b, dtype),
                  f"{where}: {name} err {errs[name + '_f64']:.3g} against "
                  f"float64")
    return errs


def time_in_turns(torch, kernel_fns, lib_fns) -> tuple:
    """``RETIME_TRIALS`` trials each of the kernel's and the library's
    calls, in turns: the least time of each and its spread (largest -
    least)."""
    trials = {"kernel": [], "library": []}
    for _ in range(RETIME_TRIALS):
        trials["kernel"].append(device_time_ms(torch, kernel_fns))
        trials["library"].append(device_time_ms(torch, lib_fns))
    spread = {k: max(v) - min(v) for k, v in trials.items()}
    return min(trials["kernel"]), min(trials["library"]), spread


def compare_rms_norm(torch, rms, x, w, dtype) -> float:
    """K4 against its plain version on the same card tensors; fails past
    ``RMS_TOL``. Returns the max abs error."""
    got = rms.rms_norm_fwd(x, w, RMS_EPS)
    want = rms.rms_norm_reference(x, w, RMS_EPS)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if dtype == "float32":
        limit = RMS_TOL[dtype] * want.float().abs().amax(-1, keepdim=True)
    else:
        rel, atol = RMS_TOL[dtype]
        limit = rel * want.float().abs() + atol
    check(got.shape == x.shape and got.dtype == x.dtype
          and bool(torch.isfinite(got.float()).all())
          and bool((err <= limit).all()),
          f"K4 vs plain at {tuple(x.shape)} {dtype}: err "
          f"{float(err.max()):.3g}")
    return float(err.max())


def llama_qkv(torch, rs, b, s, h, hkv, d, dtype):
    """q, k, v as the Llama attention hands them to K1: k and v expanded
    from ``hkv`` KV heads by ``repeat_interleave`` along the head axis."""
    dev, dt = torch.device("cuda"), getattr(torch, dtype)

    def randn(heads):
        return torch.from_numpy(rs.randn(b, s, heads, d).astype(
            np.float32)).to(dev, dt)

    q = randn(h)
    k, v = (randn(hkv).repeat_interleave(h // hkv, dim=2) for _ in range(2))
    return q, k, v, randn(h)


def phase_llama_kernels(torch) -> dict:
    """K4 against its plain version at the Llama shapes, timed at the
    training shape; K1–K3 against theirs at the Llama training shape
    (timed) and at D=128. Returns the kernels' records."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms
    import torch.nn.functional as TF

    print("== Llama kernels: K4 (rms_norm) and its backward vs plain vs "
          "F.rms_norm; K1-K3 at the Llama shapes (ms by CUDA events)",
          flush=True)
    dev = torch.device("cuda")
    rs = np.random.RandomState(8)
    records = {}
    for rows, d in RMS_SHAPES:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x = torch.from_numpy(rs.randn(rows, d).astype(np.float32)
                                 * 3).to(dev, dt)
            w = torch.from_numpy(rs.uniform(0.5, 1.5, d).astype(
                np.float32)).to(dev, dt)
            g = torch.from_numpy(rs.randn(rows, d).astype(np.float32)).to(
                dev, dt)
            err = compare_rms_norm(torch, rms, x, w, dtype)
            berrs = compare_rms_norm_bwd(torch, rms, x, w, g, dtype)
            line = (f"K4 rows={rows:5d} d={d:4d} {dtype:8s} err {err:.2e}; "
                    f"backward err dx {berrs['dx']:.2e} dw {berrs['dw']:.2e}"
                    + (f" (float64: dx {berrs['dx_f64']:.2e}, plain "
                       f"{berrs['dx_plain_f64']:.2e}; dw {berrs['dw_f64']:.2e}"
                       f", plain {berrs['dw_plain_f64']:.2e})"
                       if dtype == "float32" else "")
                    + ", two calls bitwise equal")
            if (rows, d) == RMS_SHAPES[0]:
                # inputs enough to exceed L2, one launch on each in turn
                n = max(2, math.ceil(120e6 / x.numel() / x.element_size()))
                xs = [x] + [torch.randn_like(x) for _ in range(n - 1)]
                gs = [g] + [torch.randn_like(g) for _ in range(n - 1)]
                # K4 and F.rms_norm in turns
                ms, lib_ms, spread = time_in_turns(
                    torch, [lambda t=t: rms.rms_norm_fwd(t, w, RMS_EPS)
                            for t in xs],
                    [lambda t=t: TF.rms_norm(t, (d,), w, RMS_EPS)
                     for t in xs])
                plain_ms = device_time_ms(torch, [
                    lambda t=t: rms.rms_norm_reference(t, w, RMS_EPS)
                    for t in xs], iters=20)
                # the card's practical rate for these bytes: a bare copy
                # of x, its output allocated per call as K4's is
                copy_ms = device_time_ms(torch, [lambda t=t: t.clone()
                                                 for t in xs])
                bound_ms, bound_by = rms_norm_bound(rows, d, dtype)
                gap = ms - lib_ms
                line += (f"\n    K4: kernel {ms:.4f} (spread "
                         f"{spread['kernel']:.4f})  plain {plain_ms:.4f}  "
                         f"F.rms_norm {lib_ms:.4f} (spread "
                         f"{spread['library']:.4f}), least of "
                         f"{RETIME_TRIALS} trials each  bound {bound_ms:.4f} "
                         f"({bound_by}, {bound_ms / ms:.0%} of it)  x.clone() "
                         f"{copy_ms:.4f}\n    K4 "
                         f"{dtype} against F.rms_norm: {gap:+.4f} ms, "
                         + ("loses by more than the spread"
                            if gap > max(spread.values()) else
                            "level within the spread" if gap > 0 else
                            "faster"))
                records[("rms_norm", dtype)] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms, "ms_spread": spread["kernel"],
                    "library_spread": spread["library"], "copy_ms": copy_ms,
                    "shape": f"rows={rows} d={d} {dtype}"}
                # the backward kernel and F.rms_norm's autograd backward
                # (its graph kept, so each call runs the backward alone)
                lib_bwd = []
                for t, u in zip(xs, gs):
                    tx, tw = (a.detach().requires_grad_(True) for a in (t, w))
                    y = TF.rms_norm(tx, (d,), tw, RMS_EPS)
                    lib_bwd.append(lambda y=y, tx=tx, tw=tw, u=u:
                                   torch.autograd.grad(y, (tx, tw), u,
                                                       retain_graph=True))
                ms, lib_ms, spread = time_in_turns(
                    torch, [lambda t=t, u=u: rms.rms_norm_bwd(
                        t, w, u, RMS_EPS) for t, u in zip(xs, gs)], lib_bwd)
                plain_ms = device_time_ms(torch, [
                    lambda t=t, u=u: rms.rms_norm_bwd_reference(
                        t, w, u, RMS_EPS) for t, u in zip(xs, gs)], iters=20)
                bound_ms, bound_by = rms_norm_bwd_bound(rows, d, dtype)
                line += (f"\n    K4's backward ({rms.BWD_LAUNCHES_PER_CALL} "
                         f"launches): kernel {ms:.4f} (spread "
                         f"{spread['kernel']:.4f})  plain chain "
                         f"{plain_ms:.4f}  F.rms_norm's autograd backward "
                         f"{lib_ms:.4f} (spread {spread['library']:.4f}), "
                         f"least of {RETIME_TRIALS} trials each  bound "
                         f"{bound_ms:.4f} ({bound_by}, {bound_ms / ms:.0%} "
                         f"of it)")
                records[("rms_norm_bwd", dtype)] = {
                    "max_abs_err": max(berrs["dx"], berrs["dw"]), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms,
                    "ms_spread": spread["kernel"],
                    "library_spread": spread["library"],
                    "shape": f"rows={rows} d={d} {dtype}"}
                del xs, gs, lib_bwd
            print(line, flush=True)

    seed = torch.tensor([20241016], dtype=torch.int32, device=dev)
    for b, s, h, hkv, d, dtypes in (
            (LLAMA_BATCH, LLAMA_SEQ, 12, 4, 64, ("bfloat16",)),
            (1, 512, 32, 32, 128, ("bfloat16", "float32"))):
        for dtype in dtypes:
            q, k, v, do = llama_qkv(torch, rs, b, s, h, hkv, d, dtype)
            errs, equal, exact = compare_backward(torch, fa, q, k, v, do,
                                                  seed, dtype, 0.0)
            t = time_attention(torch, fa, q, k, v, do, seed, dtype, 0.0)
            print(f"K1-K3 B={b} S={s} H={h} (from {hkv} KV heads) D={d} "
                  f"{dtype} causal  err " + " ".join(
                      f"{n} {e:.2e}" for n, e in errs.items())
                  + "  bitwise equal " + " ".join(
                      f"{n} {c}" for n, c in equal.items()) + exact
                  + "\n    " + t["line"], flush=True)
            for name, rec in attention_records(t, errs).items():
                records[(name, dtype, d)] = dict(
                    rec, shape=f"B={b} S={s} H={h} D={d} {dtype} causal")
            del q, k, v, do
    torch.cuda.empty_cache()
    return records


def phase_llama_model(torch, llama) -> None:
    """llama3_8b's width (2 layers) logits, card vs CPU; every
    llama_124m_gqa gradient, card vs CPU."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    cfg = llama.llama3_8b(num_hidden_layers=2)
    print(f"== Llama model: llama3_8b(num_hidden_layers=2) f32 logits, B=1 "
          f"S=128, card (K1 at D={cfg.head_dim}, K4 at d={cfg.hidden_size}) "
          f"vs CPU (plain)", flush=True)
    ids = np.random.RandomState(7).randint(0, cfg.vocab_size, (1, 128))
    card = llama.LlamaForCausalLM(
        cfg, generator=torch.Generator().manual_seed(0)).eval()
    fa.launches = rms.launches = 0
    with torch.inference_mode():
        got = card(torch.from_numpy(ids).cuda()).float().cpu()
    counts = (fa.launches, rms.launches)
    del card
    torch.cuda.empty_cache()
    cpu = llama.LlamaForCausalLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode():
        want = cpu(torch.from_numpy(ids))
    del cpu
    check(got.shape == (1, 128, cfg.vocab_size),
          f"logits shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "card logits not finite")
    err = (got - want).abs().max().item()
    layers = cfg.num_hidden_layers
    print(f"logits max abs err {err:.3e} (tol {LOGITS_TOL}); logit std "
          f"{want.std().item():.3f}; launches K1/K4 {counts}", flush=True)
    check(err <= LOGITS_TOL, f"logits card vs CPU err {err} > {LOGITS_TOL}")
    check(counts == (layers, 2 * layers + 1),
          f"K1/K4 launches {counts}, want ({layers}, {2 * layers + 1})")

    print("== Llama gradients: llama_124m_gqa f32, B=1 S=256, card (K1-K4, "
          "K4's backward) vs CPU (plain)", flush=True)
    cfg = llama.llama_124m_gqa()
    ids = np.random.RandomState(9).randint(0, cfg.vocab_size, (1, 256))
    counts, line = compare_gradients(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion(cfg),
        cfg, ids)
    n = cfg.num_hidden_layers
    calls = 2 * n + 1  # two RMSNorms a layer and the final one
    want = (n, n, n, calls, calls * rms.BWD_LAUNCHES_PER_CALL)
    check(counts == want, f"K1/K2/K3/K4/K4-bwd launches {counts}, want "
          f"{want}")
    print(line, flush=True)


def phase_train_llama(torch, llama) -> dict:
    """bench_llama's accelerator arm on the port, graphed, held bit for
    bit to the eager sequence; returns the launches and the profile."""
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    cfg = llama.llama_124m_gqa()
    print(f"== train Llama: llama_124m_gqa bf16 O2, TrainStep (CUDA graph) + "
          f"AdamW(1e-4), {LLAMA_BATCH}x{LLAMA_SEQ} fixed batch", flush=True)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ)).astype(np.int64)).cuda()
    reference = eager_reference(torch, llama.LlamaForCausalLM,
                                llama.LlamaPretrainingCriterion, cfg, ids,
                                GRAPH_WARMUP + TRAIN_STEPS)
    model, step, _ = build_train_step(torch, llama.LlamaForCausalLM,
                                      llama.LlamaPretrainingCriterion, cfg)
    first, losses, times, counts = run_timed_steps(torch, step, ids)
    check_against_eager(torch, "train Llama", first + losses,
                        [p.detach() for p in model.parameters()], reference)
    del reference
    flops = llama.llama_flops_per_step(LLAMA_BATCH, LLAMA_SEQ, cfg)
    p50 = report_steps(torch, first, losses, times, LLAMA_BATCH * LLAMA_SEQ,
                       flops, "bench.py _llama_flops_per_step")
    n = cfg.num_hidden_layers
    per_step = adamw_launches_per_step(model)
    print(f"launches K1/K2/K3/K4/AdamW/K4-bwd {counts} over {TRAIN_STEPS} "
          f"steps", flush=True)
    want = n * TRAIN_STEPS
    calls = (2 * n + 1) * TRAIN_STEPS  # RMSNorm calls: 2 a layer + final
    check(counts == (want, want, want, calls, per_step * TRAIN_STEPS,
                     calls * rms.BWD_LAUNCHES_PER_CALL),
          f"launches {counts}, want {want} each of K1-K3 ({n} per step), "
          f"{calls} of K4 ({2 * n + 1} per step), "
          f"{per_step * TRAIN_STEPS} of AdamW ({per_step} per step) and "
          f"{calls * rms.BWD_LAUNCHES_PER_CALL} of K4's backward "
          f"({2 * n + 1} calls per step, {rms.BWD_LAUNCHES_PER_CALL} "
          f"launches a call)")
    prof = profile_steps(torch, step, ids, p50 * 1e3)
    check(prof["rms_norm_rows"] > 0, "K4 has no row in the profile")
    check(prof["rms_norm_bwd_rows"] > 0,
          "K4's backward has no row in the profile")
    del model, step
    torch.cuda.empty_cache()
    return {"fwd": counts[0], "dq": counts[1], "dkv": counts[2],
            "rms_norm": counts[3], "adamw": counts[4],
            "rms_norm_bwd": counts[5]}


def flashmask_indices(rs, kind, b, hm, sq, sk) -> np.ndarray:
    """``startend_row_indices`` ``[b, hm, sk, ncol]`` int32 of one phase-13
    layout (causal for the first three kinds, non-causal for the rest)."""
    j = np.arange(sk)
    if kind == "doc":  # [LTS]: random documents, each key hides later ones
        idx = np.empty((b, hm, sk, 1), np.int32)
        for i in range(b):
            cuts = np.sort(rs.choice(np.arange(1, sk), 5, replace=False))
            for start, end in zip(np.r_[0, cuts], np.r_[cuts, sk]):
                idx[i, :, start:end, 0] = end
        return idx
    if kind == "share_question":
        # [LTS, LTE], the DPO/RM packing of the FlashMask paper: a question,
        # three answers, padding; an answer's keys are hidden from the later
        # answers of its question
        group = sk - sk // 8
        bounds = np.linspace(sk // 4, group, 4).astype(int)
        idx = np.full((b, hm, sk, 2), group, np.int32)
        for start, end in zip(bounds[:-1], bounds[1:]):
            idx[:, :, start:end, 0] = end
        return idx
    if kind == "masked_rows":
        # [LTS, LTE] random per head; rows r0..r1 hidden from every key at
        # or below them, so they see no key at all
        lts = np.minimum(j + rs.randint(1, 200, (b, hm, sk)), sq)
        lte = np.minimum(lts + rs.randint(0, 300, (b, hm, sk)), sq)
        r0, r1 = sq // 3, sq // 3 + 40
        cols = j <= r1
        lts = np.where(cols, np.minimum(lts, np.maximum(r0, j)), lts)
        lte = np.where(cols, np.maximum(lte, r1 + 1), lte)
        return np.stack([lts, lte], -1).astype(np.int32)
    if kind == "bidir_doc":
        # [LTS, LTE, UTS, UTE] with Sq == Sk: a document's rows see all of
        # its keys, before and after them, and no other document's
        idx = np.empty((b, hm, sk, 4), np.int32)
        for i in range(b):
            cuts = np.sort(rs.choice(np.arange(1, sk), 4, replace=False))
            for start, end in zip(np.r_[0, cuts], np.r_[cuts, sk]):
                idx[i, :, start:end] = (end, sq, 0, start)
        return idx
    # "window", [LTS, LTE, UTS, UTE]: a sliding window of half-width 128,
    # key positions mapped onto the rows when Sq != Sk
    rows = j * sq // sk
    one = np.stack([np.minimum(rows + 128, sq), np.full(sk, sq),
                    np.zeros(sk, np.int64), np.maximum(rows - 127, 0)], -1)
    return np.broadcast_to(one, (b, hm, sk, 4)).astype(np.int32)


# name, kind, B, Sq, Sk, H, Hm: each at D = 64 and 128, f32 and bf16
FLASHMASK_CASES = (
    ("causal document, Hm=1", "doc", 2, 1024, 1024, 8, 1),
    ("causal share-question", "share_question", 2, 1024, 1024, 8, 1),
    ("causal, fully masked rows, Hm=H", "masked_rows", 1, 1024, 1024, 8, 8),
    ("bidirectional document", "bidir_doc", 2, 1024, 1024, 8, 1),
    ("sliding window, Hm=H", "window", 1, 1024, 1024, 8, 8),
    ("sliding window, Sq != Sk", "window", 1, 640, 1024, 8, 1),
    ("causal document, ragged S", "doc", 1, 1000, 1000, 8, 1),
)
FM_HEADS, FM_KV_HEADS, FM_HEAD_DIM = 32, 8, 128  # llama3_8b's attention
FM_SEQ, FM_DOCS = 8192, (256, 4096)  # packed documents of 256-4096 tokens
FM_HEAD_CHUNK = 4  # heads per plain-version call at the path shape
FM_ITERS = 5


def flashmask_errors(torch, fm, inputs, outputs, idx, causal, dtype, label,
                     heads_per_call=None) -> dict:
    """K5's (o, lse) and K6/K7's (dq, dk, dv) against the plain versions on
    the same card tensors, the backward from the kernel's own (o, lse) so
    each kernel is judged alone; ``heads_per_call`` heads at a time, to
    bound the plain version's [B, H, Sq, Sk] buffers. Fails past TOL (O,
    lse) or BWD_TOL (gradients), on a non-finite output, or where a fully
    masked row's O or dQ is not exactly 0. Returns the max abs error per
    output, per gradient the count of elements equal to the plain
    version's, and the count of fully masked (row, head) pairs."""
    q, k, v, do = inputs
    o, lse, dq, dk, dv = outputs
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    tidx = fm.prepare_indices(idx, q, k, causal)
    errs = dict.fromkeys(("o", "lse", "dq", "dk", "dv"), 0.0)
    equal = dict.fromkeys(("dq", "dk", "dv"), 0)
    dead_rows = 0
    step = heads_per_call or h
    for h0 in range(0, h, step):
        hs = slice(h0, min(h0 + step, h))
        cidx = tidx if tidx.shape[1] == 1 else tidx[:, hs]
        cq, ck, cv, cdo = (t[:, :, hs] for t in (q, k, v, do))
        ro, rlse = fm.flashmask_fwd_reference(cq, ck, cv, cidx, causal,
                                              scale)
        want = fm.flashmask_bwd_reference(cq, ck, cv, o[:, :, hs],
                                          lse[:, hs], cdo, cidx, causal,
                                          scale)
        err, ok = o_close(o[:, :, hs], ro, dtype)
        errs["o"] = max(errs["o"], err)
        check(ok and bool(torch.isfinite(o[:, :, hs].float()).all()),
              f"K5 o vs plain, {label}: err {err:.3g} (tol {TOL[dtype][:2]})")
        err = float((lse[:, hs] - rlse).abs().max())
        errs["lse"] = max(errs["lse"], err)
        check(err <= TOL[dtype][2] and bool(torch.isfinite(lse[:, hs]).all()),
              f"K5 lse vs plain, {label}: err {err:.3g} (tol "
              f"{TOL[dtype][2]})")
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            check(float(ref.float().abs().max()) > 0,
                  f"plain {name} is all 0, {label}")
            err, ok = _close(torch, got[:, :, hs], ref, dtype)
            errs[name] = max(errs[name], err)
            equal[name] += int((got[:, :, hs] == ref).sum())
            check(ok and bool(torch.isfinite(got.float()).all()),
                  f"{name} vs plain, {label}: err {err:.3g}")
        dead = fm.disallowed(cidx, sq, sk, causal).expand(
            b, hs.stop - h0, sq, sk).all(-1).transpose(1, 2)
        dead_rows += int(dead.sum())
        for name, got in (("O", o[:, :, hs]), ("dQ", dq[:, :, hs])):
            check(float(got[dead].float().abs().sum()) == 0.0,
                  f"{name} not exactly 0 on fully masked rows, {label}")
    return dict(errs, dead_rows=dead_rows,
                equal=" ".join(f"{n} {equal[n]}/{t.numel()}" for n, t in
                               (("dq", dq), ("dk", dk), ("dv", dv))))


def float64_errors(torch, fm, inputs, outputs, idx, causal, label,
                   heads=None) -> str:
    """The f32 K5's (o, lse), K6/K7's (dq, dk, dv) and the f32 plain
    versions' against the plain versions computed in float64 from the same
    inputs (the backward from the kernel's own o and lse), over the heads
    ``heads`` (a slice; all by default): the kernels fail past TOL and
    BWD_TOL["float32"] (1e-4) of them, so their gates do not rest only on
    agreeing with an f32 version that may round or sum as they do. lse is
    compared on the rows that see a key; on a fully masked row it must
    equal the f32 plain version's -1e30 + log(1e-30) exactly (float64
    holds -1e30 apart from float32's nearest value). Returns both errors
    per output as text."""
    hs = heads or slice(None)
    q, k, v, do = (t[:, :, hs] for t in inputs)
    o, lse, dq, dk, dv = outputs
    outputs = (o[:, :, hs], lse[:, hs], dq[:, :, hs], dk[:, :, hs],
               dv[:, :, hs])
    scale = 1.0 / math.sqrt(q.shape[-1])
    tidx = fm.prepare_indices(idx if idx.shape[1] == 1 else idx[:, hs], q,
                              k, causal)
    f64 = [t.double() for t in (q, k, v, outputs[0], outputs[1], do)]
    exact = (*fm.flashmask_fwd_reference(*f64[:3], tidx, causal, scale),
             *fm.flashmask_bwd_reference(*f64, tidx, causal, scale))
    plain = (*fm.flashmask_fwd_reference(q, k, v, tidx, causal, scale),
             *fm.flashmask_bwd_reference(q, k, v, *outputs[:2], do, tidx,
                                         causal, scale))
    rows = []
    for name, got, ref, want in zip(("o", "lse", "dq", "dk", "dv"), outputs,
                                    plain, exact):
        if name == "lse":
            seen = want > -1e29
            check(torch.equal(got[~seen], ref[~seen]),
                  f"f32 lse of the fully masked rows, {label}")
            got, ref, want = got[seen], ref[seen], want[seen]
        err = float((got.double() - want).abs().max())
        err_plain = float((ref.double() - want).abs().max())
        check(err <= BWD_TOL["float32"][0],
              f"f32 {name} vs the float64 plain version, {label}: err "
              f"{err:.3g} (tol {BWD_TOL['float32'][0]})")
        rows.append(f"{name} {err:.2e} (plain f32 {err_plain:.2e})")
    return " ".join(rows)


def phase_flashmask_kernels(torch) -> None:
    """K5, K6 and K7 against their plain versions over the documented
    layouts, f32 and bf16, D = 64 and 128."""
    from paddle_tpu_torch.ops.cuda import flashmask as fm

    print("== FlashMask kernels: K5 (fwd), K6 (dq), K7 (dk/dv) vs plain",
          flush=True)
    dev = torch.device("cuda")
    rs = np.random.RandomState(11)
    for name, kind, b, sq, sk, h, hm in FLASHMASK_CASES:
        causal = kind in ("doc", "share_question", "masked_rows")
        idx = torch.from_numpy(flashmask_indices(rs, kind, b, hm, sq, sk))
        for d in (64, 128):
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                q, do = (torch.from_numpy(rs.randn(b, sq, h, d).astype(
                    np.float32)).to(dev, dt) for _ in range(2))
                k, v = (torch.from_numpy(rs.randn(b, sk, h, d).astype(
                    np.float32)).to(dev, dt) for _ in range(2))
                scale = 1.0 / math.sqrt(d)
                before = (fm.fwd_launches, fm.dq_launches, fm.dkv_launches)
                o, lse = fm.flashmask_fwd(q, k, v, idx, causal, scale)
                grads = fm.flashmask_bwd(q, k, v, o, lse, do, idx, causal,
                                         scale)
                torch.cuda.synchronize()
                label = (f"{name}: B={b} Sq={sq} Sk={sk} H={h} Hm={hm} D={d} "
                         f"{dtype}")
                # each kernel launched once: no plain version stands in
                check((fm.fwd_launches, fm.dq_launches, fm.dkv_launches)
                      == tuple(c + 1 for c in before),
                      f"{label}: K5/K6/K7 did not launch once each")
                errs = flashmask_errors(torch, fm, (q, k, v, do),
                                        (o, lse, *grads), idx, causal, dtype,
                                        label)
                check((kind == "masked_rows") == (errs["dead_rows"] > 0),
                      f"{label}: {errs['dead_rows']} fully masked rows")
                exact = ""
                if dtype == "float32":
                    exact = "  vs float64 " + float64_errors(
                        torch, fm, (q, k, v, do), (o, lse, *grads), idx,
                        causal, label)
                print(f"{label}  err " + " ".join(
                    f"{n} {e:.2e}" for n, e in errs.items()
                    if n not in ("dead_rows", "equal"))
                      + f"  bitwise equal {errs['equal']}" + exact
                      + (f"  fully masked (row, head) pairs "
                         f"{errs['dead_rows']}: O = dQ = 0"
                         if errs["dead_rows"] else ""), flush=True)
    torch.cuda.empty_cache()


def document_lengths(seq, lo, hi, seed=0) -> list:
    """Lengths in [lo, hi] drawn from ``np.random.RandomState(seed)`` that
    sum to ``seq``: the last document takes what is left, and a draw that
    would leave less than ``lo`` is cut to leave exactly ``lo``."""
    rs = np.random.RandomState(seed)
    lengths, left = [], seq
    while left > 0:
        n = int(rs.randint(lo, hi + 1))
        if left <= hi and left - n < lo:
            n = left
        elif left - n < lo:
            n = left - lo
        lengths.append(n)
        left -= n
    return lengths


def phase_flashmask_path(torch) -> dict:
    """The FlashMask path at llama3_8b's attention width: forward and
    autograd backward of ``flashmask_attention`` over packed documents,
    counted, checked against the plain versions and timed beside the
    kernels' bounds and SDPA with the equivalent dense mask (a yardstick
    only). Returns the launches and the kernels' records."""
    from paddle_tpu_torch.nn.functional import flashmask_attention
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import flashmask as fm
    import torch.nn.functional as TF

    b, s, h, hkv, d = 1, FM_SEQ, FM_HEADS, FM_KV_HEADS, FM_HEAD_DIM
    lengths = document_lengths(s, *FM_DOCS)
    ends = np.repeat(np.cumsum(lengths), lengths)
    idx_np = ends.astype(np.int32).reshape(b, 1, s, 1)
    pairs = sum(n * (n + 1) // 2 for n in lengths)  # per (batch, head)
    print(f"== FlashMask path: flashmask_attention fwd + autograd bwd, B={b} "
          f"S={s} H={h} (k, v from {hkv} KV heads by repeat_interleave) "
          f"D={d}, causal documents {lengths} (Hm=1); {pairs} allowed "
          f"pairs per head, {s * (s + 1) // 2 / pairs:.2f}x fewer than "
          f"causal", flush=True)
    dev = torch.device("cuda")
    idx = torch.from_numpy(idx_np).to(dev)
    rs = np.random.RandomState(12)
    mask = ~fm.disallowed(idx, s, s, True)  # [1, 1, S, S], True = attend
    check(bool(mask.any(-1).all()), "the path mask hides a whole row")
    flops_fwd = 4.0 * d * pairs * b * h
    records, launched, path, tiles = {}, None, {}, {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)

        def randn(heads):
            return torch.from_numpy(rs.randn(b, s, heads, d).astype(
                np.float32)).to(dev, dt)

        q, k_kv, v_kv, do = randn(h), randn(hkv), randn(hkv), randn(h)
        for t in (q, k_kv, v_kv):
            t.requires_grad_(True)

        def fwd_bwd():
            k = k_kv.repeat_interleave(h // hkv, dim=2)
            v = v_kv.repeat_interleave(h // hkv, dim=2)
            k.retain_grad()
            v.retain_grad()
            out = flashmask_attention(q, k, v, idx)
            out.backward(do)
            return out, k, v

        # the main path's run: counts from 0, read right after it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fm.fwd_launches = fm.dq_launches = fm.dkv_launches = 0
        fa.launches = fa.dq_launches = fa.dkv_launches = fa.tma_copies = 0
        out, k, v = fwd_bwd()
        torch.cuda.synchronize()
        counts = (fm.fwd_launches, fm.dq_launches, fm.dkv_launches,
                  fa.launches, fa.dq_launches, fa.dkv_launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(counts == (1, 1, 1, 0, 0, 0) and fa.tma_copies == 0,
              f"launches K5/K6/K7/K1/K2/K3 {counts}, want (1, 1, 1, 0, 0, "
              f"0) per forward+backward; TMA copies {fa.tma_copies}")
        if launched is None:
            launched = {"fwd": counts[0], "dq": counts[1], "dkv": counts[2]}
        check(out.shape == q.shape and out.dtype == dt,
              f"output {tuple(out.shape)} {out.dtype}")
        # the expanded k and v, and their gradients: what K6/K7 wrote
        grads = (q.grad, k.grad, v.grad)
        qd, k, v, out = q.detach(), k.detach(), v.detach(), out.detach()
        scale = 1.0 / math.sqrt(d)
        o, lse = fm.flashmask_fwd(qd, k, v, idx, True, scale)
        check(torch.equal(o, out), "K5 is not deterministic")
        # the k tiles K5's and K6's blocks and the q tiles K7's blocks
        # computed, beside those within their causal bounds (one uncounted
        # launch of each kernel)
        kind = "bf16" if dtype == "bfloat16" else "f32"
        for name, (live, bound) in zip(("fwd", "dq", "dkv"), (
                fm.fwd_tiles(qd, k, v, idx, True, scale),
                *fm.bwd_tiles(qd, k, v, o, lse, do, idx, True, scale))):
            if dtype == "bfloat16":
                tiles[name] = {"computed": live, "causal": bound}
            else:
                tiles[name]["float32"] = {"computed": live, "causal": bound}
            print(f"{dict(fwd='K5', dq='K6', dkv='K7')[name]} ({kind}) "
                  f"{'q' if name == 'dkv' else 'k'} tiles computed {live} of "
                  f"the {bound} within the causal bound ({live / bound:.1%})"
                  + (f"; the mask allows {pairs / (s * (s + 1) // 2):.1%} of "
                     f"the causal pairs" if name == "fwd" else ""),
                  flush=True)
        label = f"path B={b} S={s} H={h} D={d} {dtype}"
        errs = flashmask_errors(torch, fm, (qd, k, v, do), (out, lse, *grads),
                                idx, True, dtype, label, FM_HEAD_CHUNK)
        exact = ""
        if dtype == "float32":
            # the 3xTF32 kernels' sums over 8k tokens, against float64
            exact = "; vs float64 (heads 0-3) " + float64_errors(
                torch, fm, (qd, k, v, do), (out, lse, *grads), idx, True,
                label, slice(0, FM_HEAD_CHUNK))
        del grads
        with torch.no_grad():
            fwd_ms = cuda_time_ms(lambda: flashmask_attention(qd, k, v, idx),
                                  iters=FM_ITERS, warmup=1)
        step_ms = cuda_time_ms(fwd_bwd, iters=FM_ITERS, warmup=1)
        tidx = fm.prepare_indices(idx, qd, k, True)
        args, keep = fm.bwd_launch_args(qd, k, v, o, lse, do, tidx, True,
                                        scale)
        ms = {"fwd": fwd_ms,
              "dq": cuda_time_ms(lambda: fm.run_bwd_pass("bwd_dq", args,
                                                         dev),
                                 iters=FM_ITERS, warmup=1),
              "dkv": cuda_time_ms(lambda: fm.run_bwd_pass("bwd_dkv", args,
                                                          dev),
                                  iters=FM_ITERS, warmup=1)}
        del args, keep
        chunks = [slice(h0, h0 + FM_HEAD_CHUNK)
                  for h0 in range(0, h, FM_HEAD_CHUNK)]
        plain = {
            "fwd": cuda_time_ms(lambda: [fm.flashmask_fwd_reference(
                qd[:, :, c], k[:, :, c], v[:, :, c], tidx, True, scale)
                for c in chunks], iters=1, warmup=1),
            "bwd": cuda_time_ms(lambda: [fm.flashmask_bwd_reference(
                qd[:, :, c], k[:, :, c], v[:, :, c], o[:, :, c], lse[:, c],
                do[:, :, c], tidx, True, scale) for c in chunks], iters=1,
                warmup=1)}
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (qd, k, v))
        lib_fwd = cuda_time_ms(lambda: TF.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), iters=FM_ITERS, warmup=1)
        ref = TF.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        dot = do.transpose(1, 2)
        lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
            ref, (qt, kt, vt), dot, retain_graph=True), iters=FM_ITERS,
            warmup=1)
        lib_err = float((ref.detach().transpose(1, 2).float()
                         - out.float()).abs().max())
        del ref, qt, kt, vt
        idx_bytes = idx.numel() * 4
        bounds = {"fwd": kernel_bound(b, s, h, d, dtype, True, 2, 4, 1,
                                      pairs, idx_bytes)}
        for name, (mm, tens, rows) in BWD_BOUND.items():
            bounds[name] = kernel_bound(b, s, h, d, dtype, True, mm, tens,
                                        rows, pairs, idx_bytes)
        text = {n: f"bound {t:.4f} {by}" for n, (t, by) in bounds.items()}
        if dtype == "float32":
            # the f32 kernels run in 3xTF32; the CUDA-core figure beside
            shapes = {"fwd": (2, 4, 1), **BWD_BOUND}
            for name, (t, _) in list(bounds.items()):
                bounds[name] = kernel_bound(b, s, h, d, dtype, True,
                                            *shapes[name], pairs, idx_bytes,
                                            PEAK_TF32X3)
                text[name] = (f"bound {bounds[name][0]:.4f} "
                              f"{bounds[name][1]} at 495/3 TFLOP/s, "
                              f"{t:.4f} at 67 TFLOP/s")
        print(f"{label}: launches K5/K6/K7/K1/K2/K3 {counts}; err "
              + " ".join(f"{n} {e:.2e}" for n, e in errs.items()
                         if n not in ("dead_rows", "equal"))
              + f"; bitwise equal {errs['equal']}" + exact
              + f"; SDPA vs kernel O {lib_err:.2e}\n"
              f"    forward {fwd_ms:.4f} ms ({flops_fwd / fwd_ms / 1e9:.2f} "
              f"TFLOP/s over the allowed pairs), forward+backward with the "
              f"GQA expansion {step_ms:.4f} ms "
              f"({3.5 * flops_fwd / step_ms / 1e9:.2f} TFLOP/s, backward "
              f"counted 2.5x forward); peak memory {peak:.2f} GiB\n"
              f"    K5 {ms['fwd']:.4f} ({text['fwd']}, plain "
              f"{plain['fwd']:.4f}, SDPA+mask fwd {lib_fwd:.4f})  K6 "
              f"{ms['dq']:.4f} ({text['dq']})  K7 {ms['dkv']:.4f} "
              f"({text['dkv']})  plain bwd {plain['bwd']:.4f}  SDPA+mask bwd "
              f"{lib_bwd:.4f}", flush=True)
        shape = (f"B={b} S={s} H={h} D={d} {dtype} causal documents, "
                 f"{pairs} pairs per head")
        for name, err, plain_ms, lib_ms in (
                ("fwd", errs["o"], plain["fwd"], lib_fwd),
                ("dq", errs["dq"], plain["bwd"], lib_bwd),
                ("dkv", max(errs["dk"], errs["dv"]), plain["bwd"], lib_bwd)):
            records[(name, dtype)] = {
                "max_abs_err": err, "ms": ms[name], "plain_ms": plain_ms,
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": lib_ms, "shape": shape}
        path[dtype] = {"forward_ms": fwd_ms, "forward_backward_ms": step_ms,
                       "forward_tflops": flops_fwd / fwd_ms / 1e9,
                       "forward_backward_tflops":
                           3.5 * flops_fwd / step_ms / 1e9,
                       "peak_memory_gib": peak}
        del q, k_kv, v_kv, do, out, k, v, o, lse
        torch.cuda.empty_cache()
    return {"launches": launched, "records": records, "path": path,
            "tiles": tiles}


# AdamW(1e-4) as the training phases run it (decoupled decay 0.01), at
# step 3 so both bias corrections are live
ADAMW_ARGS = dict(beta1=0.9, beta2=0.999, eps=1e-8, coeff=0.01)
# f32 operations per element: decay 1, m 3, v 4, the bias-corrected step 7
ADAMW_OPS = 15


def adamw_bound(numel: int, elem: int) -> tuple:
    """Least time (ms) for one AdamW pass: p read and written in its own
    type (``elem`` bytes), g read, f32 m and v read and written, over HBM
    bandwidth, against ``ADAMW_OPS`` f32 operations per element."""
    t_mem = numel * (3 * elem + 16) / PEAK_BYTES * 1e3
    t_ops = numel * ADAMW_OPS / PEAK_FLOPS["float32"] * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def phase_adamw(torch, gpt) -> dict:
    """The multi-tensor AdamW kernel against its plain version, bit for
    bit, on every gpt2_small parameter in bf16 (as O2 trains them), with
    seeded gradients and moments; timed beside the plain chain and
    ``torch.optim.AdamW(fused=True)`` (a yardstick only: it keeps its
    moments in the parameters' dtype, which is not the port's rule)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops.cuda import adamw

    print("== AdamW kernel: every gpt2_small parameter, bf16 (O2), kernel vs "
          "plain bitwise; ms by CUDA events", flush=True)
    dev = torch.device("cuda")
    model = gpt.GPTForCausalLM(gpt.gpt2_small(),
                               generator=torch.Generator().manual_seed(0))
    amp.decorate(model, level="O2", dtype="bfloat16")
    params = [p.detach() for p in model.parameters()]
    gen = torch.Generator(device=dev).manual_seed(11)
    grads = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
             for p in params]
    m0 = [torch.randn(p.shape, generator=gen, device=dev) * 1e-2
          for p in params]
    v0 = [torch.rand(p.shape, generator=gen, device=dev) * 1e-4
          for p in params]
    lr = torch.tensor(1e-4, device=dev)
    step = torch.tensor(3, dtype=torch.int32, device=dev)
    got, want = ([[t.clone() for t in ts] for ts in (params, m0, v0)]
                 for _ in range(2))
    del m0, v0
    adamw.launches = 0
    adamw.adamw_update(got[0], grads, got[1], got[2], lr, step, **ADAMW_ARGS)
    launched = adamw.launches
    adamw.adamw_reference(want[0], grads, want[1], want[2], lr, step,
                          **ADAMW_ARGS)
    torch.cuda.synchronize()
    pairs = [(a, b) for ga, gb in zip(got, want) for a, b in zip(ga, gb)]
    equal = sum(torch.equal(a, b) for a, b in pairs)
    err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    numel = sum(p.numel() for p in params)
    per_step = math.ceil(len(params) / adamw.MAX_TENSORS)
    print(f"{len(params)} parameters, {numel} elements; p, m, v bitwise "
          f"equal to the plain version: {equal}/{len(pairs)} (max abs err "
          f"{err:.3g}); {launched} launches", flush=True)
    check(equal == len(pairs), f"the AdamW kernel differs from its plain "
          f"version in {len(pairs) - equal} tensors (max abs err {err})")
    check(launched == per_step, f"{launched} AdamW launches, want {per_step}")
    ms = cuda_time_ms(lambda: adamw.adamw_update(
        got[0], grads, got[1], got[2], lr, step, **ADAMW_ARGS), iters=20)
    plain_ms = cuda_time_ms(lambda: adamw.adamw_reference(
        want[0], grads, want[1], want[2], lr, step, **ADAMW_ARGS),
        iters=5, warmup=1)
    del got, want
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    fused = torch.optim.AdamW(lib_params, lr=1e-4, weight_decay=0.01,
                              fused=True)
    lib_ms = cuda_time_ms(fused.step, iters=20)
    bound_ms, bound_by = adamw_bound(numel, 2)
    print(f"kernel {ms:.4f} ms ({numel * 22 / ms / 1e6:.1f} GB/s of 22 B "
          f"an element)  plain {plain_ms:.4f}  torch.optim.AdamW(fused=True) "
          f"{lib_ms:.4f} (bf16 moments)  bound {bound_ms:.4f} ({bound_by})",
          flush=True)
    shape = f"gpt2_small, {len(params)} bf16 tensors, {numel} elements"
    del model, params, grads, lib_params, fused
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "shape": shape}


# ---------------------------------------------------------------- float16
# fp16 K1-K3 at the GPT training shape, the Llama shape (k, v expanded from
# 4 KV heads) and D = 128
FP16_SHAPES = (("GPT", 8, 1024, 12, 64, None), ("Llama", 4, 2048, 12, 64, 4),
               ("D=128", 1, 512, 32, 128, None))


def float64_report(torch, fa, q, k, v, do, seed, causal, dropout, outs) -> str:
    """The fp16 kernels' (o, lse, dq, dk, dv) and the fp16 plain
    versions' against the plain versions computed in float64 from the
    same inputs, as text (``TOL`` gates the kernels against the fp16
    plain versions; this prints how far both sit from the exact)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    exact = fa.flash_attention_fwd_reference(q.double(), k.double(),
                                             v.double(), causal, scale,
                                             dropout, seed)
    plain = fa.flash_attention_fwd_reference(q, k, v, causal, scale, dropout,
                                             seed)
    e_o, e_lse = exact
    exact_b = fa.flash_attention_bwd_reference(
        q.double(), k.double(), v.double(), e_o, e_lse, do.double(), seed,
        causal, scale, dropout)
    plain_b = fa.flash_attention_bwd_reference(q, k, v, *plain, do, seed,
                                               causal, scale, dropout)
    rows = []
    for name, got, ref, want in zip(("o", "lse", "dq", "dk", "dv"), outs,
                                    (*plain, *plain_b), (*exact, *exact_b)):
        err = float((got.double() - want).abs().max())
        err_plain = float((ref.double() - want).abs().max())
        rows.append(f"{name} {err:.2e} (plain fp16 {err_plain:.2e})")
    del exact, plain, exact_b, plain_b
    torch.cuda.empty_cache()
    return " ".join(rows)


def phase_fp16_attention(torch) -> dict:
    """fp16 K1-K3 (the bf16 tensor-core kernels instantiated for __half)
    against their plain versions at the GPT, Llama and D=128 shapes,
    causal and not, with dropout 0 and 0.1 (``TOL``/``BWD_TOL`` float16),
    each output also against float64; timed (CUDA events) beside their
    bounds (989 TFLOP/s dense fp16), plain versions and SDPA's fp16
    forward and backward. Returns the GPT-shape records."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    print("== fp16 K1-K3: against the plain versions (and float64), timed "
          "beside bounds and SDPA fp16 (ms by CUDA events)", flush=True)
    dev = torch.device("cuda")
    seed = torch.tensor([20261017], dtype=torch.int32, device=dev)
    rs = np.random.RandomState(16)
    records = {}
    for label, b, s, h, d, hkv in FP16_SHAPES:
        if hkv:
            q, k, v, do = llama_qkv(torch, rs, b, s, h, hkv, d, "float16")
        else:
            qkv = torch.from_numpy(rs.randn(b, s, h, 3, d).astype(
                np.float32)).to(dev, torch.float16)
            q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
            do = torch.from_numpy(rs.randn(b, s, h, d).astype(
                np.float32)).to(dev, torch.float16)
        for causal in (True, False):
            for dropout in (0.0, 0.1):
                fa.tma_copies = 0
                errs, equal, _ = compare_backward(
                    torch, fa, q, k, v, do, seed, "float16", dropout,
                    causal=causal)
                check(fa.tma_copies == 0, f"fp16 {label}: an operand was "
                      f"copied for TMA")
                scale = 1.0 / math.sqrt(d)
                o, lse = fa.flash_attention_fwd(q, k, v, causal, scale,
                                                dropout, seed)
                grads = fa.flash_attention_bwd(q, k, v, o, lse, do, seed,
                                               causal, scale, dropout)
                exact = float64_report(torch, fa, q, k, v, do, seed, causal,
                                       dropout, (o, lse, *grads))
                del o, lse, grads
                print(f"fp16 {label} B={b} S={s} H={h} D={d} causal="
                      f"{int(causal)} dropout={dropout}  err "
                      + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
                      + "  bitwise equal " + " ".join(
                          f"{n} {c}" for n, c in equal.items())
                      + f"\n    vs float64 {exact}", flush=True)
                if causal and dropout == 0.0:
                    t = time_attention(torch, fa, q, k, v, do, seed,
                                       "float16", 0.0)
                    print("    " + t["line"], flush=True)
                    shape = (f"B={b} S={s} H={h} D={d} float16 causal "
                             f"dropout=0.0")
                    recs = attention_records(t, errs)
                    records[label] = {name: dict(rec, shape=shape)
                                      for name, rec in recs.items()}
                    records[label]["bwd_ms"] = t["ms"]["dq"] + t["ms"]["dkv"]
        del q, k, v, do
        torch.cuda.empty_cache()
    return records


# ------------------------------------------------------ AdamW, every mode
def phase_adamw_modes(torch, gpt) -> None:
    """The AdamW kernel against its plain version, bit for bit, in the
    modes this slice added, on every gpt2_small parameter: two parameter
    groups (embeddings at half the LR) with ``lr_ratio`` and no decay on
    biases and norms, ``found_inf`` unset and set (set: nothing changes),
    ``amsgrad``, and bf16, fp16 and f32 parameters (bf16 and fp16 also
    with the f32 gradients a GradScaler hands over). One launch per 64
    tensors of one parameter and gradient dtype."""
    from paddle_tpu_torch.ops.cuda import adamw

    print("== AdamW kernel modes: groups + lr_ratio + decay mask, found_inf, "
          "amsgrad, bf16/fp16/f32 parameters, f32 gradients; kernel vs "
          "plain bitwise", flush=True)
    dev = torch.device("cuda")
    model = gpt.GPTForCausalLM(gpt.gpt2_small(),
                               generator=torch.Generator().manual_seed(0))
    named = list(model.named_parameters())
    factors = [((0.5,) if "embeddings" in n else ())
               + ((0.8,) if p.dim() == 1 else ()) for n, p in named]
    coeffs = [0.1 if n.endswith(".weight") and "ln_" not in n else 0.0
              for n, _ in named]
    gen = torch.Generator(device=dev).manual_seed(12)
    lr = torch.tensor(3e-4, device=dev)
    step = torch.tensor(5, dtype=torch.int32, device=dev)
    for pdt, gdt in ((torch.bfloat16, torch.bfloat16),
                     (torch.float16, torch.float16),
                     (torch.float32, torch.float32),
                     (torch.bfloat16, torch.float32),
                     (torch.float16, torch.float32)):
        params = [p.detach().to(pdt) for _, p in named]
        grads = [torch.randn(p.shape, generator=gen, device=dev).to(gdt)
                 for p in params]
        m0 = [torch.randn(p.shape, generator=gen, device=dev) * 1e-2
              for p in params]
        v0 = [torch.rand(p.shape, generator=gen, device=dev) * 1e-4
              for p in params]
        x0 = [torch.rand(p.shape, generator=gen, device=dev) * 2e-4
              for p in params]
        for found in (None, False, True):
            for ams in (False, True):
                flag = (None if found is None
                        else torch.tensor(found, device=dev))
                runs = [[[t.clone() for t in ts] for ts in (params, m0, v0,
                                                            x0)]
                        for _ in range(2)]
                kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, coeff=coeffs,
                          lr_factors=factors, found_inf=flag)
                adamw.launches = 0
                got, want = runs
                adamw.adamw_update(got[0], grads, got[1], got[2], lr, step,
                                   max_exp_avg_sqs=got[3] if ams else None,
                                   **kw)
                launched = adamw.launches
                adamw.adamw_reference(want[0], grads, want[1], want[2], lr,
                                      step, max_exp_avg_sqs=want[3]
                                      if ams else None, **kw)
                torch.cuda.synchronize()
                pairs = [(a, b) for ga, gb in zip(got, want)
                         for a, b in zip(ga, gb)]
                equal = sum(torch.equal(a, b) for a, b in pairs)
                same = (all(torch.equal(a, b) for a, b in zip(got[0], params))
                        if found else None)
                per = math.ceil(len(params) / adamw.MAX_TENSORS)
                print(f"p {str(pdt)[6:]} g {str(gdt)[6:]} found_inf {found} "
                      f"amsgrad {ams}: {equal}/{len(pairs)} tensors bitwise "
                      f"equal, {launched} launches"
                      + ("" if same is None else
                         f", parameters unchanged {same}"), flush=True)
                check(equal == len(pairs) and launched == per
                      and same in (None, True),
                      f"AdamW kernel mode p {pdt} g {gdt} found {found} "
                      f"amsgrad {ams}: {equal}/{len(pairs)} equal, "
                      f"{launched} launches (want {per}), unchanged {same}")
                del runs, got, want, pairs
        del params, grads, m0, v0, x0
        torch.cuda.empty_cache()
    del model


# ------------------------------------------------------- phase 16, trainer
RECIPE_STEPS = 12
FP16_STEPS = 12
# 2^26: the first steps overflow fp16 (a weight gradient of the first
# layers passes 65504 near 2^22), halving each time, and growing again
# every 2 good steps
FP16_INIT_SCALE = 2.0 ** 26
OPTIMIZER_STEPS = 3
OPTIMIZER_BATCH = 2


def recipe_decays(name) -> bool:
    """No decay on biases, LayerNorm weights and embeddings."""
    return (name.endswith(".weight") and ".ln_" not in name
            and "embeddings" not in name)


def recipe_twin(torch, gpt, cfg):
    """gpt2_small bf16 O2 under the pretraining recipe: warmup then
    cosine LR, the embeddings a group at half the LR, global-norm clip
    1.0, AdamW(beta2=0.95, weight_decay=0.1) with no decay on biases,
    norms and embeddings. Returns (model, optimizer, scheduler, clip,
    loss_fn)."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.optimizer import AdamW, lr

    model = gpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        0)).train()
    crit = gpt.GPTPretrainingCriterion(cfg)
    amp.decorate(model, level="O2", dtype="bfloat16")
    sched = lr.LinearWarmup(
        lr.CosineAnnealingDecay(6e-4, T_max=RECIPE_STEPS, eta_min=6e-5),
        warmup_steps=4, start_lr=0.0, end_lr=6e-4)
    named = list(model.named_parameters())
    groups = [{"params": [p for n, p in named if "embeddings" not in n]},
              {"params": [p for n, p in named if "embeddings" in n],
               "learning_rate": 0.5}]
    clip = nn.ClipGradByGlobalNorm(1.0)
    opt = AdamW(learning_rate=sched, parameters=groups, beta2=0.95,
                weight_decay=0.1, apply_decay_param_fun=recipe_decays,
                grad_clip=clip)

    def loss_fn(ids):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(ids)
        return crit(logits, ids)

    return model, opt, sched, clip, loss_fn


def trainer_recipe(torch, gpt, ids, launches_9) -> dict:
    """(a) The recipe, eager then graphed on a twin: losses, parameters
    and the clip's norms bit for bit; the LR moves every step and every
    step after the capture is a replay."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    cfg = gpt.gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    print(f"-- (a) recipe: gpt2_small bf16 O2, {TRAIN_BATCH}x{TRAIN_SEQ}, "
          f"LinearWarmup(4) -> CosineAnnealingDecay(6e-4, T_max=12, "
          f"eta_min=6e-5), AdamW(beta2=0.95, wd 0.1, no decay on biases/"
          f"norms/embeddings), embeddings at LR x0.5, "
          f"ClipGradByGlobalNorm(1.0); {RECIPE_STEPS} eager steps, then "
          f"{RECIPE_STEPS} TrainStep steps", flush=True)
    model, opt, sched, clip, loss_fn = recipe_twin(torch, gpt, cfg)
    want_losses, want_norms, lrs = [], [], []
    for _ in range(RECIPE_STEPS):
        lrs.append(opt.get_lr())
        loss = loss_fn(ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        want_losses.append(loss.detach())
        want_norms.append(clip.last_norm)
    torch.cuda.synchronize()
    want_losses = [float(x) for x in want_losses]
    want_norms = [float(x) for x in want_norms]
    want_params = [p.detach().clone() for p in model.parameters()]
    del model, opt, loss_fn
    torch.cuda.empty_cache()

    model, opt, sched, clip, loss_fn = recipe_twin(torch, gpt, cfg)
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    losses, norms, times = [], [], []
    for i in range(RECIPE_STEPS):
        if i == GRAPH_WARMUP:
            stats = dict(step.stats)
            fa.launches = fa.dq_launches = fa.dkv_launches = 0
            fa.tma_copies = adamw.launches = rms.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(float(clip.last_norm))
        sched.step()
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches, rms.launches,
              adamw.launches)
    ran = {k: step.stats[k] - stats[k] for k in stats}
    replays = RECIPE_STEPS - GRAPH_WARMUP
    print(f"LR per step {[f'{x:.4g}' for x in lrs]}", flush=True)
    print(f"pre-clip global norm: step 0 {norms[0]:.6f}; per step "
          + " ".join(f"{x:.4f}" for x in norms), flush=True)
    check(len(set(lrs)) == RECIPE_STEPS, f"the LR did not move every step: "
          f"{lrs}")
    check(any(x > 1.0 for x in norms), f"the clip never engaged: norms "
          f"{norms}")
    check(norms == want_norms, f"graphed norms {norms} differ from eager "
          f"{want_norms}")
    check_against_eager(torch, "recipe", losses,
                        [p.detach() for p in model.parameters()],
                        (want_losses, want_params))
    check(ran == {"compiled_steps": replays, "eager_steps": 0},
          f"recipe steps {ran}: not every step after the capture replayed")
    per_step = adamw_launches_per_step(model)
    want = (LAYERS * replays,) * 3 + (0, per_step * replays)
    print(f"launches K1/K2/K3/K4/AdamW over {replays} replays {counts}; "
          f"operands copied for TMA {fa.tma_copies}", flush=True)
    check(counts == want and fa.tma_copies == 0,
          f"recipe launches {counts}, want {want}")
    times = times[GRAPH_WARMUP:]
    p50 = float(np.median(times))
    flops = megatron_flops(TRAIN_BATCH, TRAIN_SEQ, cfg.num_hidden_layers,
                           cfg.hidden_size, cfg.vocab_size)
    prof = profile_steps(torch, step, ids, p50 * 1e3)
    print(f"recipe: step ms p50 {p50 * 1e3:.3f} (min {min(times) * 1e3:.3f}"
          f", max {max(times) * 1e3:.3f}); tokens/s "
          f"{TRAIN_BATCH * TRAIN_SEQ / p50:.1f}; MFU "
          f"{flops / p50 / PEAK_FLOPS['bfloat16']:.2%}; idle "
          f"{1 - prof['device_ms'] / (p50 * 1e3):.1%}; launches per step "
          f"{prof['launches']:.0f} (phase 9: {launches_9:.0f})", flush=True)
    out = {"fwd": counts[0], "dq": counts[1], "dkv": counts[2],
           "adamw": counts[4], "p50_ms": p50 * 1e3}
    del model, opt, step, loss_fn, want_params
    release_memory(torch)
    return out


def host_loss_scaling(flags, init, incr_every, decr_every, incr_ratio=2.0,
                      decr_ratio=0.5) -> list:
    """The scale after each step, by the JAX package's update_loss_scaling
    rule (paddle_tpu/amp/grad_scaler.py:171-195), over the found_inf
    flags, on the host."""
    scale, good, bad, out = init, 0, 0, []
    for found in flags:
        bad_n = bad + 1 if found else 0
        good_n = 0 if found else good + 1
        scale_n = (max(scale * decr_ratio, 1.0)
                   if found and bad_n >= decr_every else scale)
        bad_n = 0 if bad_n >= decr_every else bad_n
        scale_n = (scale_n * incr_ratio
                   if not found and good_n >= incr_every else scale_n)
        good_n = 0 if good_n >= incr_every else good_n
        scale, good, bad = scale_n, good_n, bad_n
        out.append(scale)
    return out


def fp16_twin(torch, gpt, cfg):
    """gpt2_small with f32 parameters, AdamW(1e-4), a GradScaler, and the
    step function of an fp16 O1 loop: the loss under
    ``auto_cast(level="O1", dtype="float16")``, then ``scale(loss)
    .backward()``, ``step``, ``update``, ``clear_grad``."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW

    model = gpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        0)).train()
    crit = gpt.GPTPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=FP16_INIT_SCALE,
                            incr_every_n_steps=2, decr_every_n_nan_or_inf=1)

    def step_fn(ids):
        with amp.auto_cast(level="O1", dtype="float16"):
            loss = crit(model(ids), ids)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss.detach()

    return model, opt, scaler, crit, step_fn


def optimizer_cells(torch, model, opt) -> list:
    """Copies of every parameter, accumulator and the step count."""
    cells = [p.detach().clone() for p in model.parameters()]
    cells += [t.clone() for t in opt._state_cells()]
    return cells + [opt._step_tensor.clone()]


def attention_overflow_flags(torch, fa, model, crit, ids, scale) -> tuple:
    """One fp16 O1 forward and backward of ``model`` at loss scale
    ``scale``: for each K2/K3 call, whether the kernels' dq, dk, dv hold a
    non-finite value and whether the plain versions' do, on the same
    inputs; and whether any parameter's gradient does."""
    from paddle_tpu_torch import amp

    kernel_bwd, flags = fa.flash_attention_bwd, []

    def both(q, k, v, o, lse, do, seed, causal, scale_, dropout=0.0, **kw):
        got = kernel_bwd(q, k, v, o, lse, do, seed, causal, scale_, dropout,
                         **kw)
        kw.pop("device", None)
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seed,
                                               causal, scale_, dropout, **kw)
        flags.append((not all(bool(torch.isfinite(g).all()) for g in got),
                      not all(bool(torch.isfinite(g).all()) for g in ref)))
        del ref
        return got

    fa.flash_attention_bwd = both
    try:
        with amp.auto_cast(level="O1", dtype="float16"):
            loss = crit(model(ids), ids)
        (loss * scale).backward()
    finally:
        fa.flash_attention_bwd = kernel_bwd
    overflow = not all(bool(torch.isfinite(p.grad).all())
                       for p in model.parameters())
    model.zero_grad(set_to_none=True)
    return flags, overflow


def trainer_fp16(torch, gpt, ids) -> dict:
    """(b) fp16 O1 with dynamic loss scaling: the eager loop under
    ``set_sync_debug_mode("error")``, each skipped step leaving every
    parameter, moment and the step count bit for bit, the scales equal to
    the host replay of JAX's rule; the same step function captured by
    ``CompiledFunction`` bit for bit the eager steps; fp16 K1-K3 launches
    through the replays equal the counters and the profile; the kernels'
    and the plain versions' overflow flags on the same inputs at the
    largest scale without overflow and the first that overflows."""
    from paddle_tpu_torch.jit.api import _cuda_generators
    from paddle_tpu_torch.jit.functionalize import CompiledFunction
    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    cfg = gpt.gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    print(f"-- (b) fp16 O1: gpt2_small f32 parameters, "
          f"{TRAIN_BATCH}x{TRAIN_SEQ}, AdamW(1e-4), GradScaler(init "
          f"{FP16_INIT_SCALE:.0f}, incr every 2, decr every 1); "
          f"{FP16_STEPS} eager steps under set_sync_debug_mode('error'), "
          f"then {FP16_STEPS} CompiledFunction steps", flush=True)
    model, opt, scaler, crit, step_fn = fp16_twin(torch, gpt, cfg)
    flags, scales, used, want_losses, skipped = [], [], [], [], 0
    for i in range(FP16_STEPS):
        before = optimizer_cells(torch, model, opt)
        used.append(float(scaler.get_loss_scaling()))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss = step_fn(ids)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        found = bool(scaler._found_inf)
        flags.append(found)
        scales.append(float(scaler._scale))
        want_losses.append(float(loss))
        if found:
            skipped += 1
            after = optimizer_cells(torch, model, opt)
            # accumulators the skipped step made are zeros
            fresh = after[len(before) - 1:-1] if len(after) > len(before) \
                else []
            same = (all(torch.equal(a, b) for a, b in
                        zip(before[:-1], after[:len(before) - 1]))
                    and torch.equal(before[-1], after[-1])
                    and all(not t.any() for t in fresh))
            check(same, f"fp16 step {i} overflowed but changed a parameter, "
                  f"moment or the step count")
        del before
    want_params = [p.detach().clone() for p in model.parameters()]
    rule = host_loss_scaling(flags, FP16_INIT_SCALE, 2, 1)
    print(f"scale used per step {used}", flush=True)
    print(f"found_inf per step {flags}; scale after each {scales}; JAX's "
          f"rule on the host {rule}; skipped {skipped}", flush=True)
    check(skipped >= 1 and not all(flags), f"the stream has {skipped} "
          f"skipped steps of {FP16_STEPS}: choose another initial scale")
    check(scales == rule, "the scale stream differs from JAX's "
          "update_loss_scaling rule")
    # the kernels' and the plain versions' overflow on the same inputs
    good = max(s for s, f in zip(used, flags) if not f)
    bad = min(s for s, f in zip(used, flags) if f)
    for label, s in (("largest without overflow", good),
                     ("least that overflows", bad),
                     ("initial", FP16_INIT_SCALE)):
        pairs, overflow = attention_overflow_flags(torch, fa, model, crit,
                                                   ids, s)
        kern = [a for a, _ in pairs]
        plain = [b for _, b in pairs]
        print(f"scale {s:.0f} ({label} in the stream), on the last "
              f"parameters: a gradient non-finite {overflow}; K2/K3 "
              f"non-finite per layer {[int(x) for x in kern]}, plain "
              f"versions {[int(x) for x in plain]}", flush=True)
        check(kern == plain, f"at scale {s} the kernels' overflow "
              f"{kern} differs from the plain versions' {plain}")
    del model, opt, scaler, step_fn
    release_memory(torch)

    model, opt, scaler, crit, step_fn = fp16_twin(torch, gpt, cfg)
    compiled = CompiledFunction(step_fn, name="fp16_step", device="cuda",
                                generators=_cuda_generators(model))
    losses, got_scales, times = [], [], []
    for i in range(FP16_STEPS):
        if i == GRAPH_WARMUP:
            fa.launches = fa.dq_launches = fa.dkv_launches = 0
            adamw.launches = 0
            stats = dict(compiled.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = compiled(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        got_scales.append(float(scaler._scale))
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches, adamw.launches)
    replays = FP16_STEPS - GRAPH_WARMUP
    ran = {k: compiled.stats[k] - stats[k] for k in stats}
    check(ran == {"compiled_steps": replays, "eager_steps": 0},
          f"fp16 steps {ran}: not every step after the capture replayed")
    check(got_scales == scales, f"graphed scales {got_scales} differ from "
          f"eager {scales}")
    check_against_eager(torch, "fp16 O1", losses,
                        [p.detach() for p in model.parameters()],
                        (want_losses, want_params))
    per_step = adamw_launches_per_step(model)
    print(f"fp16 K1/K2/K3, AdamW (f32) launches over {replays} replays "
          f"{counts}", flush=True)
    check(counts == (LAYERS * replays,) * 3 + (per_step * replays,),
          f"fp16 launches {counts}")
    times = times[GRAPH_WARMUP:]
    p50 = float(np.median(times))
    prof = profile_steps(torch, compiled, ids, p50 * 1e3)
    flops = megatron_flops(TRAIN_BATCH, TRAIN_SEQ, cfg.num_hidden_layers,
                           cfg.hidden_size, cfg.vocab_size)
    print(f"fp16 O1: step ms p50 {p50 * 1e3:.3f} (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}); tokens/s "
          f"{TRAIN_BATCH * TRAIN_SEQ / p50:.1f}; MFU "
          f"{flops / p50 / PEAK_FLOPS['float16']:.2%}; idle "
          f"{1 - prof['device_ms'] / (p50 * 1e3):.1%}; launches per step "
          f"{prof['launches']:.0f}", flush=True)
    out = {"fwd": counts[0], "dq": counts[1], "dkv": counts[2],
           "adamw": counts[3], "p50_ms": p50 * 1e3, "skipped": skipped}
    del model, opt, scaler, step_fn, compiled, want_params
    release_memory(torch)
    return out


def optimizer_cases():
    """(c)'s optimizers: every one but Adam/AdamW's plain mode (phase 9)
    and LBFGS (no TrainStep)."""
    def ratio(p):
        return 0.5 if p.dim() == 1 else 1.0
    return (("SGD", dict(learning_rate=1e-3)),
            ("Momentum", dict(learning_rate=1e-3, momentum=0.9,
                              use_nesterov=True)),
            ("Adagrad", dict(learning_rate=1e-3)),
            ("RMSProp", dict(learning_rate=1e-4, centered=True,
                             momentum=0.9)),
            ("Adadelta", dict(learning_rate=1.0)),
            ("Adamax", dict(learning_rate=1e-3)),
            ("Lamb", dict(learning_rate=1e-3)),
            ("AdamW", dict(learning_rate=1e-4, amsgrad=True,
                           lr_ratio=ratio)))


def trainer_optimizers(torch, gpt, ids) -> dict:
    """(c) Every other optimizer on gpt2_small bf16 O2 at B=2:
    ``OPTIMIZER_STEPS`` eager steps, then as many ``TrainStep`` steps on a
    twin (eager, capture, replay), bit for bit; each graph freed before
    the next optimizer."""
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    cfg = gpt.gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    batch = ids[:OPTIMIZER_BATCH]
    print(f"-- (c) every other optimizer: gpt2_small bf16 O2, "
          f"{OPTIMIZER_BATCH}x{TRAIN_SEQ} (batch cut for time), "
          f"{OPTIMIZER_STEPS} eager then {OPTIMIZER_STEPS} TrainStep steps "
          f"each", flush=True)
    launched = {"fwd": 0, "dq": 0, "dkv": 0, "adamw": 0}
    for name, kw in optimizer_cases():
        def twin():
            model = gpt.GPTForCausalLM(
                cfg, generator=torch.Generator().manual_seed(0)).train()
            crit = gpt.GPTPretrainingCriterion(cfg)
            amp.decorate(model, level="O2", dtype="bfloat16")
            opt = getattr(optimizer, name)(parameters=model.parameters(),
                                           **kw)

            def loss_fn(x):
                with amp.auto_cast(level="O2", dtype="bfloat16"):
                    logits = model(x)
                return crit(logits, x)
            return model, opt, loss_fn

        model, opt, loss_fn = twin()
        want = []
        for _ in range(OPTIMIZER_STEPS):
            loss = loss_fn(batch)
            loss.backward()
            opt.step()
            opt.clear_grad()
            want.append(loss.detach())
        want = ([float(x) for x in want],
                [p.detach().clone() for p in model.parameters()])
        del model, opt, loss_fn
        model, opt, loss_fn = twin()
        step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
        before = (fa.launches, fa.dq_launches, fa.dkv_launches,
                  adamw.launches)
        got = [float(step(batch)) for _ in range(OPTIMIZER_STEPS)]
        after = (fa.launches, fa.dq_launches, fa.dkv_launches,
                 adamw.launches)
        for key, a, b in zip(launched, after, before):
            launched[key] += a - b
        check(step.stats == {"compiled_steps": OPTIMIZER_STEPS - 1,
                             "eager_steps": 1},
              f"{name}: steps {step.stats}")
        check_against_eager(torch, f"{name}", got,
                            [p.detach() for p in model.parameters()], want)
        del model, opt, loss_fn, step, want
        release_memory(torch)
    print(f"(c) launches K1/K2/K3/AdamW {launched}", flush=True)
    return launched


def phase_trainer(torch, gpt, launches_9) -> dict:
    """Phase 16: the training-step API on gpt2_small at full width and
    depth: (a) the pretraining recipe, (b) fp16 O1 with loss scaling, (c)
    every other optimizer. Returns the launches and times."""
    print("== trainer: LR schedulers, parameter groups, gradient clipping, "
          "the other optimizers, AMP O1 float16 with GradScaler; every run "
          "graphed and held bit for bit to eager steps on a twin",
          flush=True)
    cfg = gpt.gpt2_small()
    ids = torch.from_numpy(np.random.RandomState(16).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int64)).cuda()
    return {"recipe": trainer_recipe(torch, gpt, ids, launches_9),
            "fp16": trainer_fp16(torch, gpt, ids),
            "optimizers": trainer_optimizers(torch, gpt, ids)}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.models import gpt, llama
        from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_small
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        phase_card()
        phase_build()
        serve_record = phase_kernel(torch)
        model = phase_model(torch, GPTForCausalLM, gpt2_small)
        served = phase_serve(torch, model)
        served["launches"] += phase_serve_modes(torch, model, served)
        served["launches"] += phase_operate(torch, model, served)
        batch = phase_batch_serve(torch, model)
        phase_serve_shapes(torch, sorted(set(served["prefill_shapes"])
                                         | set(batch["rungs"])))
        del model
        release_memory(torch)
        records = phase_backward(torch)
        fp16_records = phase_fp16_attention(torch)
        phase_gradients(torch, gpt)
        trained = phase_train(torch, gpt)
        records.update(phase_llama_kernels(torch))
        phase_llama_model(torch, llama)
        trained_llama = phase_train_llama(torch, llama)
        phase_flashmask_kernels(torch)
        flashmask_path = phase_flashmask_path(torch)
        adamw_record = phase_adamw(torch, gpt)
        phase_adamw_modes(torch, gpt)
        trainer = phase_trainer(torch, gpt, trained["launches_per_step"])
    except Exception:  # noqa: BLE001 — report the failing phase, exit 1
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    source = "paddle_tpu_torch/ops/cuda/csrc/"
    replaces = "paddle_tpu/ops/pallas/flash_attention.py:"
    kernels = []
    # K1-K3 each have a bf16 kernel (the training paths) and an f32 one in
    # 3xTF32 (K1's on the f32 serving path)
    for name, key, src, src_f32, line in (
            ("flash_attention_fwd", "fwd", "flash_attention_fwd_sm90.cu",
             "flash_attention_fwd_tf32.cu", 266),
            ("flash_attention_bwd_dq", "dq", "flash_attention_dq_sm90.cu",
             "flash_attention_dq_tf32.cu", 310),
            ("flash_attention_bwd_dkv", "dkv", "flash_attention_dkv_sm90.cu",
             "flash_attention_dkv_tf32.cu", 347)):
        by_path = {"train": trained[key], "train_llama": trained_llama[key],
                   "trainer_recipe": trainer["recipe"][key],
                   "trainer_optimizers": trainer["optimizers"][key]}
        f32_by_path = ({"serve": served["launches"],
                        "batch_serve": batch["launches"]}
                       if key == "fwd" else {})
        entry = {"name": name, "route": "cuda", "source": source + src,
                 "replaces": replaces + str(line),
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 **records[(key, "bfloat16", 0.0)],
                 "with_dropout": {k: records[(key, "bfloat16", 0.1)][k]
                                  for k in ("ms", "max_abs_err")},
                 "float32": {"source": source + src_f32,
                             **{k: v for k, v in
                                records[(key, "float32", 0.0)].items()
                                if k in ("ms", "plain_ms", "bound_ms",
                                         "library_ms", "max_abs_err")},
                             "launches": sum(f32_by_path.values()),
                             "launches_by_path": f32_by_path}}
        # float16: the same source instantiated for __half (phase 16 (b))
        entry["float16"] = {
            "source": source + src,
            **{k: v for k, v in fp16_records["GPT"][key].items()
               if k in ("ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "max_abs_err")},
            "launches": trainer["fp16"][key],
            "launches_by_path": {"trainer_fp16": trainer["fp16"][key]},
            "llama_shape": fp16_records["Llama"][key],
            "head_dim_128": fp16_records["D=128"][key]}
        if key == "fwd":
            entry["serve_shape"] = serve_record
        entry["llama_shape"] = records[(key, "bfloat16", 64)]
        entry["head_dim_128"] = {dtype: records[(key, dtype, 128)]
                                 for dtype in ("bfloat16", "float32")}
        kernels.append(entry)
    kernels.append({
        "name": "rms_norm", "route": "cuda",
        "source": source + "rms_norm.cu",
        "replaces": "paddle_tpu/ops/pallas/rms_norm.py:46",
        "launches": trained_llama["rms_norm"],
        "launches_by_path": {"train_llama": trained_llama["rms_norm"]},
        **records[("rms_norm", "bfloat16")],
        "float32": {k: records[("rms_norm", "float32")][k]
                    for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                              "max_abs_err")}})
    # no Pallas counterpart: the jnp _bwd of the custom VJP, which XLA fuses
    kernels.append({
        "name": "rms_norm_bwd", "route": "cuda",
        "source": source + "rms_norm.cu",
        "replaces": "paddle_tpu/ops/pallas/rms_norm.py:84",
        "pallas_counterpart": False,
        "launches": trained_llama["rms_norm_bwd"],
        "launches_by_path": {"train_llama": trained_llama["rms_norm_bwd"]},
        **records[("rms_norm_bwd", "bfloat16")],
        "float32": {k: records[("rms_norm_bwd", "float32")][k]
                    for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                              "max_abs_err")}})
    fm_records = flashmask_path["records"]
    # K5-K7 each have a bf16 kernel and an f32 one in 3xTF32, all on the
    # tensor cores
    for name, key, src, src_f32, line in (
            ("flashmask_fwd", "fwd", "flashmask_fwd_sm90.cu",
             "flashmask_fwd_tf32.cu", 209),
            ("flashmask_bwd_dq", "dq", "flashmask_dq_sm90.cu",
             "flashmask_dq_tf32.cu", 251),
            ("flashmask_bwd_dkv", "dkv", "flashmask_dkv_sm90.cu",
             "flashmask_dkv_tf32.cu", 286)):
        count = flashmask_path["launches"][key]
        entry = {"name": name, "route": "cuda", "source": source + src,
                 "replaces": f"paddle_tpu/ops/pallas/flashmask.py:{line}",
                 "launches": count, "launches_by_path": {"flashmask": count},
                 **fm_records[(key, "bfloat16")],
                 "float32": {"source": source + src_f32,
                             **{k: fm_records[(key, "float32")][k]
                                for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms", "max_abs_err")}}}
        entry["tiles"] = flashmask_path["tiles"][key]
        if key == "fwd":
            entry["path"] = flashmask_path["path"]
        kernels.append(entry)
    # no Pallas counterpart: the jnp AdamW update that XLA fuses
    by_path = {"train": trained["adamw"], "train_llama": trained_llama["adamw"],
               "trainer_recipe": trainer["recipe"]["adamw"],
               "trainer_fp16": trainer["fp16"]["adamw"],
               "trainer_optimizers": trainer["optimizers"]["adamw"]}
    kernels.append({
        "name": "adamw", "route": "cuda", "source": source + "adamw.cu",
        "replaces": "paddle_tpu/optimizer/optimizers.py:90",
        "pallas_counterpart": False,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        **adamw_record})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
