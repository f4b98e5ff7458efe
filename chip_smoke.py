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
   K6 and K7; fp16 K1, K2, K3, K5, K6 and K7, the same sources
   instantiated for __half; f32 K1, K2, K3, K5, K6 and K7 in 3×TF32, all
   on the tensor cores) holds wgmma (HGMMA) and TMA load (UTMALDG)
   instructions;
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
    each graph freed before the next;
17. BERT fine-tune — (a) ``bench.py``'s ``bench_bert`` accelerator arm on
    the port, uncut: ``BertForSequenceClassification(ernie_base())``
    (dropout 0) in bf16 O2, ``AdamW(5e-5)``, ``CrossEntropyLoss`` outside
    ``auto_cast``, one 32 x 128 batch drawn as ``bench.py`` draws it, no
    mask; 12 eager steps by hand, then 2 warmup and 10 timed ``TrainStep``
    steps, losses and parameters bit for bit the eager ones, launches
    exactly 12 a step of each of K1-K3 (non-causal) and one AdamW launch
    per 64 parameters; step p50, tokens/s, samples/s, MFU by ``bench.py``'s
    ``_gpt_flops_per_step`` (and without its vocab term, a projection the
    classifier does not have), a profile of 2 steps (launches, idle
    share); (b) K1-K3 at BERT's shape (B=32, S=128, H=12, D=64,
    non-causal, q, k and v strided views of the packed qkv), bf16 and f32,
    against their plain versions (f32 also against float64), timed beside
    their bounds and SDPA's non-causal forward and backward, no operand
    copied for TMA; (c) ernie_base bf16 O2 under ``TrainStep(bucket_axes=
    {0: 1, 1: 1}, bucket_pad_values={0: 0, 1: 0}, bucket_range=(16, 128))``
    over 24 batches of 32 rows with keep-masks, lengths 9-128 from
    ``RandomState(1)``, six a rung: losses and parameters bit for bit the
    same padded batches stepped eagerly by hand, one capture a rung and
    none after its second call, no host sync in a replay
    (``torch.cuda.set_sync_debug_mode("error")``), no K1-K3 launch (the
    masked route), each rung's replay p50; then each batch's loss padded
    against its true length (f32, eager, ``bert_tiny``'s width at 12
    layers) within ``LOSS_PAD_TOL``;
18. ResNet train — (a) ``bench_resnet``'s accelerator arm uncut (resnet50,
    1000 classes, bf16 O2, ``Momentum(0.1, 0.9)``, one 32 x 3 x 224²
    batch): two eager runs compared bit for bit (else the graph = eager
    check under ``cudnn.deterministic``), the graphed ``TrainStep`` held
    to them (losses, parameters, running stats), step p50, images/s, a
    profile by kernel class; (b) the Momentum kernel bit for bit its plain
    version in every mode, timed beside its bound, the plain chain and
    fused SGD; (c) eval logits card vs CPU;
19. PP-LiteSeg train — (a) ``bench_liteseg``'s accelerator arm uncut
    (``pp_liteseg(num_classes=19, base=32)``, bf16 O2, ``Momentum(0.01,
    0.9)``, one 16 x 3 x 512² batch and labels in [0, 19) drawn as
    ``bench.py`` draws them, the per-pixel loss over 4,194,304 rows
    outside ``auto_cast``) held as phase 18 (a) holds ResNet; step p50,
    images/s, launches, idle share and a profile of 2 replayed steps by
    class (convolutions, depthwise ones apart, BatchNorm, element-wise,
    layout transposes, the resize contractions, the cross entropy and its
    transpose copy, Momentum; each kernel name classed by the op that
    launched it in an eager step); (b) ``interpolate`` forward and
    backward at the arm's resizes, a shrinking and a bicubic one, f32 and
    bf16, against float64 of the same contractions, two backward passes
    bit for bit; (c) eval logits card vs CPU; (d) PP-YOLOE (forward,
    decode, postprocess, loss and backward) and every ``small.py`` model's
    logits card vs CPU, checked, not timed;
20. fit Llama — the training loop: (a) ``Model.fit`` on llama_124m_gqa at
    ``bench_llama``'s width (bf16 O2 through a thin forward wrapper,
    ``LlamaPretrainingCriterion``, ``AdamW(1e-4)``) over a ``Dataset`` of
    16 seeded batches of 4 x 2048 tokens, 2 shuffled epochs, 2 worker
    processes, ``device_prefetch=2``, ``log_freq=4``, snapshots armed (so
    the epoch pins the shuffle): every step after the second a replay, the
    loss stream and the final parameters bit for bit the same batches fed
    straight to a ``TrainStep`` in the loader's order, one host sync a
    boundary and none in the steps between (run under
    ``set_sync_debug_mode("error")``); step p50 between boundaries,
    tokens/s, launches a step and the idle share from a profile of 4 fit
    steps, beside phase 12's bare step; (b) the same fit with
    ``snapshot_every=4`` raises SIGTERM at itself at step 20, snapshots at
    that boundary and stops; a fresh model ``fit(resume=True)``: losses
    and final parameters bit for bit (a)'s; one snapshot's bytes and save
    time; (c) ``evaluate`` (next-token top-1 ``Accuracy``) and ``predict``
    against the plain forward; (d) fp16: K4 and its backward against their
    plain versions at 8192 x 768 and timed beside ``F.rms_norm``, 4
    graphed llama_124m_gqa O1 fp16 steps with a ``GradScaler`` bit for bit
    their eager steps, fp16 K5-K7 on phase 14's path; (e) an ``io.h2d``
    fault in the prefetch thread reaches ``fit`` as an exception;
21. bench arms — ``bench.py``'s five training arms (``bench_gpt``,
    ``bench_llama``, ``bench_bert``, ``bench_resnet``, ``bench_liteseg``)
    read from its text with ``ast`` (never imported), each from its
    ``def`` through ``dt = time.perf_counter() - t0``, with only the
    import statements' ``paddle_tpu`` renamed ``paddle_tpu_torch``, run
    with ``on_tpu=True`` after ``paddle.set_device("gpu")`` at full width
    (gpt2_small 8 x 1024, llama_124m_gqa 4 x 2048, ernie_base 32 x 128,
    resnet50 32 x 3 x 224², pp_liteseg 16 x 3 x 512², all bf16 O2): the
    first step and the arm's own timed steps, every one after the first a
    replay; GPT's and Llama's last loss and every parameter bit for bit the
    hand-built ``TrainStep``'s (phases 9 and 12's construction) after as
    many steps, BERT's, ResNet's and PP-LiteSeg's first loss bit for bit
    phases 17-19's; a profiled replayed step of each arm launches what the
    hand-built one does; each arm's tokens/s or images/s from its own
    timing beside the hand-built phase's p50.

22. Transformer-base — a user-written ``nn.Layer`` in Paddle idiom
    (:func:`transformer_base`, the text the CPU test also builds with the
    JAX package): one ``nn.Embedding`` of 37,000 tokens shared by source,
    target and the tied pre-softmax projection, a sinusoidal position
    buffer (``persistable=False``), ``nn.Transformer()`` at its defaults
    (Transformer-base: 6 + 6 layers of d_model 512, 8 heads, FFN 2048,
    dropout 0.1), the causal target mask, cross entropy against
    ``label_smooth(one_hot(label), 0.1)`` outside ``auto_cast``, ``Adam``
    under ``NoamDecay(512, 4000)``, bf16 O2, one 16 x 256 batch a side:
    (a) built through the port's ``Layer``, ``ParamAttr`` and
    initializers; (b) 12 eager steps by hand, then 2 warmup and 10 timed
    ``TrainStep`` steps, every one after the first a replay, losses and
    every parameter bit for bit the eager ones (dropout in K1-K3's hash,
    the masked composition and the ``Dropout`` layers, all drawn from the
    registered dropout generator), launches 12 a step of each of K1-K3
    (encoder self-attention and decoder cross-attention; the masked
    decoder self-attention launches none) and 4 of AdamW (253 bf16
    tensors), no operand copied for TMA; K1-K3 at the path's shape (B=16,
    S=256, H=8, D=64, non-causal, dropout 0.1 and 0) against their plain
    versions, timed beside their bounds and SDPA; (c) step p50, target
    tokens/s, peak memory, launches a step, the idle share and device ms
    by class from a profile of 2 replayed steps, the masked composition
    and the 37,000-way loss each timed alone; (d) an incremental greedy
    decode of 8 tokens with ``TransformerDecoder.gen_cache`` on an f32
    twin: each step's decoder output within 1e-4 of the full-sequence
    decoder's at its position, and the tokens equal the full decoder's on
    the same prefix, except near-ties. About 10–20 s on the H100.

23. static mode and the op-interception tier (``core/hooks.py``'s one
    ``TorchDispatchMode``), on llama_124m_gqa with ``load_jax_state``
    weights drawn from numpy seed 23: (a) ``paddle.enable_static()``, the
    model built at full width (12 layers) in f32, called under
    ``program_guard`` on ``static.data("input_ids", [4, 1024], "int64")``:
    the program holds 12 K1 and 25 K4 registered operators;
    ``Executor.run`` 2 warmup runs (eager, capture) and 10 timed replays of
    one CUDA graph on fresh seeded ids (never the zero placeholder), each
    launching 12 K1 and 25 K4 by the counters and, over a profiled replay,
    by the profile; every replay's logits bit for bit the eager forward's
    on the card, the last within 1e-3 of the CPU plain path (row 0);
    ``save_inference_model`` → ``load_inference_model`` → run: the same
    bits, 12 K1 and 25 K4 launches; the host ms and device ms of a replay
    and the graph/eager replay counts printed; the kernels line counts the
    replays (warmup, timed, profiled) and, apart, the loaded program's run,
    not the eager forwards the replays are held to; (b) an eager bf16 O2
    step (forward and backward, 2 x 1024): the tensor checker in warn mode
    finds nothing over 3 steps (step p50 with the checker off and on
    printed); the operator stats over one step count K1's and K4's forward
    operators 12 and 25 times (and K2/K3's and K4's backward ones), equal
    to the launch counters; the kernels line counts these 7 checked steps,
    each launching what the stats' step did; a NaN written into ``llama.layers.0.mlp.down_proj.
    weight`` makes abort mode raise at the first op whose output holds it,
    the same op at the same position as the port's CPU run of the same
    step (after a CPU run that fills the first-use caches the card's warm
    steps hold: the RoPE table, the zero dropout seed), and
    ``FLAGS_check_nan_inf`` raises there too; (c) a
    ``register_op`` swish with a backward on a 4096 x 768 f32 tensor: one
    op in the stats, its gradient within 1e-6 of the plain rule's, recorded
    as the one node of a static program whose graph replays give the eager
    call's bits; (d) ``profiler.Profiler`` (scheduler ``(1, 2)``) over one
    eager step after a ``READY`` step: ``summary()`` lists the K1 and K4
    operators with calls equal to their launches, and its
    ``torch.profiler`` timeline holds as many K1 and K4 kernels.
    About 40 s on the H100.

24. the recurrent tier and the rest of ``nn`` and ``vision``: (a)
    Zaremba et al.'s "large" PTB LSTM language model (2014, §4.1), a
    user-written ``nn.Layer`` (:func:`ptb_lstm_lm`, the text the CPU test
    also builds with the JAX package) at its published width: 2 x
    ``nn.LSTM`` 1500 unrolled 35 steps, batch 20, 10,000 words, dropout
    0.65, ``Uniform(±0.04)``, SGD at 1 with a global-norm clip of 10, f32,
    the (h, c) state carried from window to window in non-persistable
    buffers written in place, over a seeded token stream (no corpus): the
    first window's eval loss card vs CPU within 1e-3; 12 eager steps by
    hand, then 12 ``TrainStep`` steps (one CUDA graph a step after the
    first) bit for bit them (losses, parameters, carried states, clip
    norms), no port kernel launched; a replay under
    ``set_sync_debug_mode("error")``; step p50 over the 10 timed steps,
    tokens/s, TFLOP/s against 67, launches a step and the idle share from
    a profile of 2 replays, device ms by class (recurrent products, input
    and decoder products, gates, weight-gradient accumulation, loss) from
    an eager step's ops, peak memory, and ``torch.nn.LSTM`` (cuDNN) beside
    the port's ``nn.LSTM`` at the same shape, a yardstick only; (b) a
    3-layer bidirectional ``nn.GRU`` of 1024 units over [16, 200, 161]
    frames with lengths 50-200, a ``Linear`` to 29 classes,
    ``log_softmax`` and ``ctc_loss`` (labels up to 60): outputs, final
    states, loss and input gradient card vs CPU within 1e-3 of each
    tensor's largest magnitude; (c) ``roi_align`` (256 x 200 x 304, 512
    boxes, 7 x 7, ratio 2, aligned), ``box_coder`` over SSD300's 8732
    priors, ``yolo_box`` over YOLOv3's three heads at 608², the 1-D/2-D/3-D
    pools with ``return_mask`` (the masks gathering the pooled values) and
    each new loss, card vs CPU within 1e-4; (d) ``DatasetFolder`` over 64
    seeded 256² ``.npy`` images (``loader=np.load``), ``Resize``,
    ``CenterCrop``, ``Normalize``, ``Transpose``, ``DataLoader`` (batch
    32, 2 worker processes), ``DeviceLoader``, resnet50's eval forward:
    every batch equal to the transforms run in-process, logits card vs CPU
    within 1e-3; a ``RandomCrop``/``RandomHorizontalFlip`` pipeline the
    same twice under one seed; (e) an eager llama_124m_gqa bf16 O2 AdamW
    step and a resnet50 bf16 O2 Momentum step, each from a fresh build,
    under the tensor checker with the operator stats, under
    ``FLAGS_check_nan_inf`` and under a recording ``profiler.Profiler``:
    parameters bit for bit the step without interception, and
    ``paddle_tpu_torch::adamw``/``::momentum`` and K1-K4's operators
    counted in the stats and the profiler's op events as the launch
    counters say.

25. the data-parallel tier: (a) ``init_parallel_env()`` in this process
    (NCCL, a world of one on its own store); every collective of
    ``distributed.communication`` on CUDA tensors against numpy; then
    ``DataParallel(llama_124m_gqa)`` with bench_llama's settings under
    ``TrainStep``, one CUDA graph a step with the bucketed NCCL
    all-reduces inside: its eager steps bit for bit the bare model's, the
    replays bit for bit its eager steps, a replay under
    ``set_sync_debug_mode("error")``, K1-K4 and AdamW launching phase 12's
    counts, one all-reduce a bucket a step; step p50 beside phase 12's,
    launches a step with NCCL's kernels apart, the all-reduce class's
    device ms, the idle share, the buckets and their bytes; the process
    group destroyed after. (b) two ranks on the one card through ``python
    -m paddle_tpu_torch.distributed.launch --nproc_per_node 2`` with
    ``PADDLE_DISTRI_BACKEND=gloo`` (this script's ``--data-parallel-rank``
    mode): the collectives on CUDA tensors against numpy on each rank;
    ``DataParallel(llama_124m_gqa)`` bf16 O2, eager, 3 AdamW steps, each
    rank on 2 of the 4 x 2048 rows, the ranks' parameters bit for bit equal
    after each step, the mean loss and the parameters within the bf16 gate
    of one process's steps over the 4 rows; a ``DistributedBatchSampler``
    epoch over the ranks covering the dataset once. (c) ResNet-50's stem
    and first stage converted by ``convert_sync_batchnorm``, one Momentum
    step over the ranks' 16 x 3 x 224² images each: the outputs, running
    stats and gradients against one process's BatchNorm over the 32 images
    in float64, within 4x that process's own f32 error.

The serve (5, 5b, 5c, 5d), train (9), train Llama (12), FlashMask path
(14), trainer (16), BERT (17 (a), (c)), ResNet (18 (a)), PP-LiteSeg
(19 (a)), fit (20 (a), (d)), bench-arm (21), Transformer-base (22 (b)),
static Llama (23 (a), (b), (d)), recurrent (24 (a), (e)) and data-parallel
(25 (a)) phases are the main paths:
the launch counts are set to 0 just before each
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

import contextlib
import gc
import io
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
RMS_TOL = {"float32": 1e-5, "bfloat16": (2.0 ** -7, 1e-3),
           # float16: bf16's gate divided by 8, as for fp16 K1-K3
           "float16": (2.0 ** -10, 1.25e-4)}
RMS_SHAPES = ((8192, 768), (4, 768), (1000, 768), (256, 4096), (8, 100))
RMS_EPS = 1e-5  # LlamaConfig.rms_norm_eps
RETIME_TRIALS = 5  # K4 and F.rms_norm, timed in turns at the training shape
# RMSNorm backward kernel against its plain version: f32 dx and dw within
# 1e-5 of the gradient's max (and of the float64 plain version); bf16
# within one bf16 step (2^-7 of the value) plus 1e-3
RMS_BWD_TOL = {"float32": 1e-5, "bfloat16": (2.0 ** -7, 1e-3),
               # float16: bf16's gate divided by 8, plus the f32 gate's
               # 1e-5 of the gradient's max, the room dw's f32 sums take
               # in their own order before the one rounding to fp16
               "float16": (2.0 ** -10, 1.25e-4, 1e-5)}
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


def card_label() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def phase_card() -> None:
    print("== card", flush=True)
    print(card_label(), flush=True)


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
# type: sm90 16-bit, tf32 f32), the element type of the sm90 kernels
# (bf16 or fp16), head dim and dropout flag
TC_KERNEL = re.compile(r"((?:flashmask_)?(?:fwd|dq|dkv)_(sm90|tf32))_kernelI"
                       r"(13__nv_bfloat16|6__half)?Li(\d+)E(?:Lb([01])E)?")
TC_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "fp16", None: "bf16"}
# a mangled element type's short name
ELEM_NAMES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "fp16"}


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


def print_serialized_wgmma(_build) -> None:
    """ptxas's C7514 advisories ("wgmma ... serialized"), by source, for
    every tensor-core kernel: printed, not checked."""
    for name in TC_SOURCES:
        notes = [ln.strip() for ln in _build.ptxas_report.get(name, "")
                 .splitlines() if "C7514" in ln]
        print(f"{name}: {len(notes)} C7514 advisories"
              + "".join(f"\n    {ln[:240]}" for ln in notes), flush=True)


def phase_build() -> float:
    from paddle_tpu_torch.ops.cuda import (_build, adamw, flash_attention,
                                           flashmask, momentum, rms_norm)

    print("== build (one nvcc per source, in parallel)", flush=True)
    t0 = time.perf_counter()
    _build.build_all([*TC_SOURCES, "rms_norm", "adamw", "momentum"])
    flash_attention.build()
    rms_norm.build()
    flashmask.build()
    adamw.build()
    momentum.build()
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
                r = re.search(r"rms_norm_(bwd_)?kernelI"
                              r"(13__nv_bfloat16|6__half|f)"
                              r"(13__nv_bfloat16|6__half|f|S\d*_)Li(\d+)E"
                              r"Li(\d+)ELi(\d+)E", entry)
                dw = re.search(r"rms_norm_dw_kernelI"
                               r"(13__nv_bfloat16|6__half|f)E", entry)
                norm = "rms_norm" in entry
                # AdamW's <parameter type, gradient type>; S1_: the first
                opt = re.search(r"(adamw|momentum)_kernelI"
                                r"(13__nv_bfloat16|6__half|f)(f|S\d*_)E",
                                entry)
                if tc:
                    kind = (TC_TYPES[tc.group(3)] if tc.group(2) == "sm90"
                            else "f32 3xTF32")
                    entry = (f"{tc.group(1)} {kind}/D={tc.group(4)}"
                             f"{' dropout' if tc.group(5) == '1' else ''}")
                elif r:
                    x, w = (ELEM_NAMES[g] for g in (
                        r.group(2), r.group(2) if r.group(3).startswith("S")
                        else r.group(3)))
                    nv = r.group(6)
                    entry = (f"rms_norm{' bwd' if r.group(1) else ''} x {x} "
                             f"w {w} vec {r.group(4)} threads/row "
                             f"{r.group(5)} "
                             + (f"vectors/thread {nv}" if nv != "0"
                                else "loop"))
                elif dw:
                    entry = "rms_norm dw " + ELEM_NAMES[dw.group(1)]
                elif opt:
                    pt = ELEM_NAMES[opt.group(2)]
                    entry = (f"{opt.group(1)} p {pt} g "
                             f"{pt if opt.group(3) != 'f' else 'f32'}")
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
                # the AdamW and Momentum kernels index their
                # __grid_constant__ tensor lists in the parameter space:
                # no copy to a stack frame
                if opt:
                    rows[-1] += f", {stack} B stack"
                    check(spill == "0" and stack == "0",
                          f"{entry}: {spill} B spilled, {stack} B of stack")
                entry = None
        print(f"{name} (ptxas): " + "; ".join(rows), flush=True)
    print(f"built in {seconds:.1f} s", flush=True)
    check_tensor_core_sass(_build)
    print_serialized_wgmma(_build)
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
                            grads, causal=True) -> str:
    """The f32 K2/K3's (dq, dk, dv) and the f32 plain version's against
    the plain backward computed in float64 from the same (o, lse); the
    kernels fail past ``BWD_TOL["float32"]`` of it. Returns both errors
    per gradient as text."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    exact = fa.flash_attention_bwd_reference(
        *(t.double() for t in (q, k, v, o, lse, do)), seed, causal, scale,
        dropout)
    plain = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seed,
                                             causal, scale, dropout)
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
            torch, fa, q, k, v, o, lse, causal, scale, dropout, seed) + " "
            + float64_backward_errors(torch, fa, q, k, v, o, lse, do, seed,
                                      dropout, grads, causal))
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


def time_attention(torch, fa, q, k, v, do, seed, dtype, dropout,
                   causal=True) -> dict:
    """K1, K2 and K3 timed alone by CUDA events at the shape of q (k and v
    as they reach the kernels), beside their bounds, their plain versions
    and SDPA's forward and backward (a yardstick only)."""
    import torch.nn.functional as TF

    b, s, h, d = q.shape
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, dropout, seed)
    args, keep = fa.bwd_launch_args(q, k, v, o, lse, do, seed, causal, scale,
                                    dropout)
    ms = {
        "fwd": cuda_time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, causal, scale, dropout, seed)),
        "dq": cuda_time_ms(lambda: fa.run_bwd_pass("bwd_dq", args, dev)),
        "dkv": cuda_time_ms(lambda: fa.run_bwd_pass("bwd_dkv", args, dev)),
    }
    plain = {
        "fwd": cuda_time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, causal, scale, dropout, seed), iters=3),
        "bwd": cuda_time_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, o, lse, do, seed, causal, scale, dropout), iters=3),
    }
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    lib_fwd = cuda_time_ms(lambda: TF.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    out = TF.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    del out, qt, kt, vt, keep
    shapes = {"fwd": (2, 4, 1), **BWD_BOUND}
    bounds = {name: kernel_bound(b, s, h, d, dtype, causal, *shape,
                                 peak=pass_peak(name, dtype))
              for name, shape in shapes.items()}
    # the f32 tensor-core kernels' bounds at 495/3 TFLOP/s, with the
    # 67 TFLOP/s CUDA-core figure beside them
    cores = {name: kernel_bound(b, s, h, d, dtype, causal, *shapes[name])[0]
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


def build_train_step(torch, model_cls, crit_cls, cfg, dropout_seed=0,
                     data_parallel=False, wrap=None, state=None):
    """The model in bf16 O2 under ``TrainStep`` with ``AdamW(1e-4)``, the
    criterion outside ``auto_cast``, as ``bench.py`` builds its arms
    (wrapped in ``DataParallel`` after ``decorate`` when
    ``data_parallel``, or by ``wrap``, such as ``fleet.distributed_model``;
    its weights from the JAX-layout ``state`` when given). Returns the
    model, the step, and the eager step by hand: ``loss_fn``,
    ``backward``, ``step``, ``clear_grad`` on the same model and
    optimizer."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import load_jax_state
    from paddle_tpu_torch.optimizer import AdamW

    model = model_cls(cfg, generator=torch.Generator().manual_seed(0),
                      dropout_seed=dropout_seed).train()
    if state is not None:
        load_jax_state(model, state)
    crit = crit_cls(cfg)
    amp.decorate(model, level="O2", dtype="bfloat16")
    if data_parallel:
        from paddle_tpu_torch import DataParallel

        model = DataParallel(model)
    if wrap is not None:
        model = wrap(model)
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
                    dropout_seed=0, state=None) -> tuple:
    """The graphed step's reference: ``steps`` eager steps by hand from the
    same seeds (or the JAX-layout ``state``). Returns the losses and the
    parameters after them."""
    model, _, eager_step = build_train_step(torch, model_cls, crit_cls, cfg,
                                            dropout_seed, state=state)
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


def run_timed_steps(torch, step, batch: tuple) -> tuple:
    """``GRAPH_WARMUP`` warmup steps (the eager call, then the capture),
    then ``TRAIN_STEPS`` timed ones (host clock around each, ending in a
    synchronize), every one a graph replay, with every launch count set to
    0 just before them and read just after; ``step(*batch)`` is one step.
    Fails if an operand was copied for TMA or a timed step did not replay.
    The Momentum kernel's count is zeroed with the others and left in
    ``momentum.launches``. Returns (warmup losses,
    losses, step seconds, launches of K1, K2, K3, K4, AdamW, the RMSNorm
    backward)."""
    from paddle_tpu_torch.ops.cuda import adamw, momentum
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    torch.cuda.reset_peak_memory_stats()
    first = [float(step(*batch).float()) for _ in range(GRAPH_WARMUP)]
    torch.cuda.synchronize()
    stats = dict(step.stats)
    # the main path's run: counts from 0, read right after it (the
    # Momentum kernel's by the caller, from momentum.launches)
    fa.launches = fa.dq_launches = fa.dkv_launches = rms.launches = 0
    fa.tma_copies = adamw.launches = rms.bwd_launches = 0
    momentum.launches = 0
    zero_collective_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*batch)
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


def profile_steps(torch, step, batch: tuple, step_ms, steps=2) -> dict:
    """Device time by kernel over a few steps (torch.profiler), beside the
    timed step's p50: their gap is the time the card idles. One warmup step
    starts the tracer before the window, and the card idles
    ``PROFILE_PAD_S`` inside each end of the window, so that no kernel at
    its edges falls outside it; the profile's launches of K1–K4 per step
    must equal the launch counters over the same steps, and so must the
    RMSNorm backward's and the AdamW kernel's; ``step(*batch)`` is one
    step. Returns the ms per step of
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
            step(*batch)
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
            "device_ms": total, "rows": rows}


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
    first, losses, times, counts = run_timed_steps(torch, step, (ids,))
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
    prof = profile_steps(torch, step, (ids,), p50 * 1e3)
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
            "adamw": counts[4], "launches_per_step": prof["launches"],
            "p50_ms": p50 * 1e3}


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
    rel, atol, *of_max = RMS_BWD_TOL[dtype]
    limit = rel * want.float().abs() + atol
    if of_max:
        limit = limit + of_max[0] * float(want.float().abs().max())
    return bool((err <= limit).all())


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


def rms_norm_timed(torch, rms, x, w, g, dtype, err, berrs) -> tuple:
    """K4 and its backward at ``x``'s ``[rows, d]`` timed by CUDA events
    beside their bounds, their plain chains, F.rms_norm and its autograd
    backward (in turns), on inputs enough to exceed L2; ``err`` and
    ``berrs`` are their errors against the plain versions. Returns the
    printed text and the two kernels' records."""
    import torch.nn.functional as TF

    rows, d = x.shape
    text = ""
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
    text += (f"\n    K4: kernel {ms:.4f} (spread "
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
    fwd_rec = {
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
    text += (f"\n    K4's backward ({rms.BWD_LAUNCHES_PER_CALL} "
             f"launches): kernel {ms:.4f} (spread "
             f"{spread['kernel']:.4f})  plain chain "
             f"{plain_ms:.4f}  F.rms_norm's autograd backward "
             f"{lib_ms:.4f} (spread {spread['library']:.4f}), "
             f"least of {RETIME_TRIALS} trials each  bound "
             f"{bound_ms:.4f} ({bound_by}, {bound_ms / ms:.0%} "
             f"of it)")
    bwd_rec = {
        "max_abs_err": max(berrs["dx"], berrs["dw"]), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms,
        "ms_spread": spread["kernel"],
        "library_spread": spread["library"],
        "shape": f"rows={rows} d={d} {dtype}"}
    del xs, gs, lib_bwd
    return text, fwd_rec, bwd_rec


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
                text, fwd_rec, bwd_rec = rms_norm_timed(
                    torch, rms, x, w, g, dtype, err, berrs)
                line += text
                records[("rms_norm", dtype)] = fwd_rec
                records[("rms_norm_bwd", dtype)] = bwd_rec
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
    first, losses, times, counts = run_timed_steps(torch, step, (ids,))
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
    prof = profile_steps(torch, step, (ids,), p50 * 1e3)
    check(prof["rms_norm_rows"] > 0, "K4 has no row in the profile")
    check(prof["rms_norm_bwd_rows"] > 0,
          "K4's backward has no row in the profile")
    del model, step
    torch.cuda.empty_cache()
    return {"fwd": counts[0], "dq": counts[1], "dkv": counts[2],
            "rms_norm": counts[3], "adamw": counts[4],
            "rms_norm_bwd": counts[5], "p50_ms": p50 * 1e3,
            "launches_per_step": prof["launches"]}


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


def phase_flashmask_path(torch, dtypes=("bfloat16", "float32")) -> dict:
    """The FlashMask path at llama3_8b's attention width: forward and
    autograd backward of ``flashmask_attention`` over packed documents in
    each of ``dtypes``, counted, checked against the plain versions and
    timed beside the kernels' bounds and SDPA with the equivalent dense
    mask (a yardstick only). Returns the first dtype's launches and the
    kernels' records."""
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
    for dtype in dtypes:
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
        kind = {"bfloat16": "bf16", "float16": "fp16"}.get(dtype, "f32")
        for name, (live, bound) in zip(("fwd", "dq", "dkv"), (
                fm.fwd_tiles(qd, k, v, idx, True, scale),
                *fm.bwd_tiles(qd, k, v, o, lse, do, idx, True, scale))):
            if dtype == "bfloat16":
                tiles[name] = {"computed": live, "causal": bound}
            else:
                tiles.setdefault(name, {})[dtype] = {"computed": live,
                                                     "causal": bound}
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
    prof = profile_steps(torch, step, (ids,), p50 * 1e3)
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
    prof = profile_steps(torch, compiled, (ids,), p50 * 1e3)
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
    from paddle_tpu_torch.ops.cuda import adamw, momentum
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    cfg = gpt.gpt2_small(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    batch = ids[:OPTIMIZER_BATCH]
    print(f"-- (c) every other optimizer: gpt2_small bf16 O2, "
          f"{OPTIMIZER_BATCH}x{TRAIN_SEQ} (batch cut for time), "
          f"{OPTIMIZER_STEPS} eager then {OPTIMIZER_STEPS} TrainStep steps "
          f"each", flush=True)
    launched = {"fwd": 0, "dq": 0, "dkv": 0, "adamw": 0, "momentum": 0}
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
                  adamw.launches, momentum.launches)
        got = [float(step(batch)) for _ in range(OPTIMIZER_STEPS)]
        after = (fa.launches, fa.dq_launches, fa.dkv_launches,
                 adamw.launches, momentum.launches)
        for key, a, b in zip(launched, after, before):
            launched[key] += a - b
        check(step.stats == {"compiled_steps": OPTIMIZER_STEPS - 1,
                             "eager_steps": 1},
              f"{name}: steps {step.stats}")
        check_against_eager(torch, f"{name}", got,
                            [p.detach() for p in model.parameters()], want)
        del model, opt, loss_fn, step, want
        release_memory(torch)
    print(f"(c) launches K1/K2/K3/AdamW/Momentum {launched}", flush=True)
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


BERT_BATCH, BERT_SEQ = 32, 128  # bench_bert's accelerator arm
BERT_LR = 5e-5
BUCKET_LADDER = (16, 32, 64, 128)
BUCKET_ROUNDS = 6  # every rung this many times: eager, capture, replays
LOSS_PAD_TOL = 1e-3  # a padded batch's loss against its true length's


def bert_twin(torch, bert, cfg, masked: bool):
    """``bench_bert``'s setup: ``BertForSequenceClassification(cfg)``
    (weights from a generator seeded 0) in bf16 O2, ``AdamW(5e-5)``,
    ``CrossEntropyLoss`` outside ``auto_cast``. Returns (model, optimizer,
    loss_fn): ``loss_fn(ids, labels)``, or with ``masked``
    ``loss_fn(ids, mask, labels)``."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.optimizer import AdamW

    model = bert.BertForSequenceClassification(
        cfg, generator=torch.Generator().manual_seed(0)).train()
    crit = nn.CrossEntropyLoss()
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=BERT_LR, parameters=model.parameters())

    def logits(ids, mask=None):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return model(ids, attention_mask=mask)

    if masked:
        return model, opt, lambda ids, mask, y: crit(logits(ids, mask), y)
    return model, opt, lambda ids, y: crit(logits(ids), y)


def eager_steps(torch, opt, loss_fn, batches) -> list:
    """One eager step by hand a batch (``loss_fn``, ``backward``, ``step``,
    ``clear_grad``); returns the losses as floats."""
    losses = []
    for batch in batches:
        loss = loss_fn(*batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    return [float(x) for x in losses]


def bert_bench_arm(torch, bert) -> dict:
    """(a) ``bench_bert`` uncut: ernie_base, dropout 0, one 32 x 128 batch
    as ``bench.py`` draws it, no mask; 12 eager steps, then 2 warmup and 10
    timed graphed steps bit for bit the eager ones, launches, a profile."""
    from paddle_tpu_torch.jit import TrainStep

    cfg = bert.ernie_base(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    print(f"-- (a) bench arm: ernie_base (vocab {cfg.vocab_size}, "
          f"{cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}) bf16 "
          f"O2, AdamW({BERT_LR}), CrossEntropyLoss outside auto_cast, one "
          f"{BERT_BATCH}x{BERT_SEQ} batch, no mask; "
          f"{GRAPH_WARMUP + TRAIN_STEPS} eager steps, then {GRAPH_WARMUP} "
          f"warmup and {TRAIN_STEPS} timed TrainStep steps", flush=True)
    rs = np.random.RandomState(0)  # as bench.py draws ids, then labels
    ids = rs.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ))
    labels = rs.randint(0, 2, (BERT_BATCH,))
    batch = tuple(torch.from_numpy(a.astype(np.int64)).cuda()
                  for a in (ids, labels))
    model, opt, loss_fn = bert_twin(torch, bert, cfg, masked=False)
    reference = (eager_steps(torch, opt, loss_fn,
                             [batch] * (GRAPH_WARMUP + TRAIN_STEPS)),
                 [p.detach().clone() for p in model.parameters()])
    del model, opt, loss_fn
    release_memory(torch)
    model, opt, loss_fn = bert_twin(torch, bert, cfg, masked=False)
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    first, losses, times, counts = run_timed_steps(torch, step, batch)
    check_against_eager(torch, "BERT bench arm", first + losses,
                        [p.detach() for p in model.parameters()], reference)
    flops = megatron_flops(BERT_BATCH, BERT_SEQ, cfg.num_hidden_layers,
                           cfg.hidden_size, cfg.vocab_size)
    p50 = report_steps(torch, first, losses, times, BERT_BATCH * BERT_SEQ,
                       flops, "bench.py _gpt_flops_per_step")
    # the formula's factor 1 + s/(6h) + V/(16·l·h): its last term is a
    # vocab projection the classifier does not have
    attn = 1.0 + BERT_SEQ / (6.0 * cfg.hidden_size)
    head = cfg.vocab_size / (16.0 * cfg.num_hidden_layers * cfg.hidden_size)
    no_head = flops * attn / (attn + head)
    print(f"samples/s {BERT_BATCH / p50:.1f}; the formula counts a "
          f"{cfg.vocab_size}-wide vocab projection the classifier does not "
          f"have (V/(16*l*h) = {head:.4f}, +{head / attn:.1%}); without it "
          f"{no_head / p50 / 1e12:.2f} TFLOP/s, MFU "
          f"{no_head / p50 / PEAK_FLOPS['bfloat16']:.2%}", flush=True)
    per_step = adamw_launches_per_step(model)
    layers = cfg.num_hidden_layers
    print(f"launches K1/K2/K3/K4/AdamW/K4-bwd {counts} over {TRAIN_STEPS} "
          f"steps", flush=True)
    want = layers * TRAIN_STEPS
    check(counts == (want, want, want, 0, per_step * TRAIN_STEPS, 0),
          f"BERT launches {counts}, want {want} each of K1-K3 ({layers} "
          f"per step, non-causal) and {per_step * TRAIN_STEPS} of AdamW")
    prof = profile_steps(torch, step, batch, p50 * 1e3)
    print(f"BERT bench arm: step ms p50 {p50 * 1e3:.3f}; "
          f"{prof['launches']:.0f} launches per step; idle "
          f"{1 - prof['device_ms'] / (p50 * 1e3):.1%}; K1+K2+K3 "
          f"{prof['attention_ms']:.3f} ms a step", flush=True)
    out = {"fwd": counts[0], "dq": counts[1], "dkv": counts[2],
           "adamw": counts[4], "p50_ms": p50 * 1e3, "first_loss": first[0],
           "launches": prof["launches"]}
    del model, opt, step, loss_fn, reference
    release_memory(torch)
    return out


def bert_attention_kernels(torch) -> dict:
    """(b) K1–K3 at BERT's shape (B=32, S=128, H=12, D=64, non-causal, q, k
    and v strided views of BERT's packed [B, S, H, 3, D] qkv), bf16 and
    f32: against their plain versions (K1 within ``TOL``, K1–K3 within
    ``BWD_TOL``; f32 also against float64), timed
    beside their bounds and SDPA's non-causal forward and backward, no
    operand copied for TMA. Returns the records by (kernel, dtype)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    print(f"-- (b) K1-K3 at BERT's shape B={BERT_BATCH} S={BERT_SEQ} "
          f"H={HEADS} D={HEAD_DIM}, non-causal, packed qkv (ms by CUDA "
          f"events)", flush=True)
    dev = torch.device("cuda")
    rs = np.random.RandomState(17)
    seed = torch.tensor([20241017], dtype=torch.int32, device=dev)
    records = {}
    for dtype in ("bfloat16", "float32"):
        q, k, v = packed_qkv(torch, rs, BERT_BATCH, BERT_SEQ, dtype)
        do = torch.from_numpy(rs.randn(*q.shape).astype(np.float32)).to(
            dev, getattr(torch, dtype))
        fa.tma_copies = 0
        err_o, err_l, fwd_exact = compare_kernel(torch, fa, q, k, v, dtype,
                                                 False)
        print(f"{dtype:8s} K1 against TOL: O err {err_o:.2e} lse err "
              f"{err_l:.2e}{fwd_exact}", flush=True)
        errs, equal, exact = compare_backward(torch, fa, q, k, v, do, seed,
                                              dtype, 0.0, causal=False)
        t = time_attention(torch, fa, q, k, v, do, seed, dtype, 0.0,
                           causal=False)
        check(fa.tma_copies == 0, f"{fa.tma_copies} BERT operands copied "
              f"for TMA ({dtype})")
        print(f"{dtype:8s} err " + " ".join(f"{n} {e:.2e}"
                                           for n, e in errs.items())
              + "  bitwise equal " + " ".join(f"{n} {c}"
                                              for n, c in equal.items())
              + exact + "\n    " + t["line"] + "  (tma copies 0)", flush=True)
        shape = (f"B={BERT_BATCH} S={BERT_SEQ} H={HEADS} D={HEAD_DIM} "
                 f"{dtype} non-causal")
        for name, rec in attention_records(t, errs).items():
            records[(name, dtype)] = dict(rec, shape=shape)
        del q, k, v, do
    torch.cuda.empty_cache()
    return records


def bucket_batches(torch, vocab: int) -> list:
    """``BUCKET_ROUNDS`` rounds of one batch a rung of ``BUCKET_LADDER`` in
    a shuffled order, from ``RandomState(1)``: a batch's length L lies
    within its rung (9-16, 17-32, 33-64, 65-128), its first row is L long
    and the others end at lengths from 1 to L (their keep-mask marks
    them). Returns (ids, mask, labels) on the card, int64."""
    rs = np.random.RandomState(1)
    batches = []
    for _ in range(BUCKET_ROUNDS):
        for rung in rs.permutation(BUCKET_LADDER):
            n = int(rs.randint(rung // 2 + 1, rung + 1))
            ids = rs.randint(1, vocab, (BERT_BATCH, n))
            ends = np.concatenate([[n], rs.randint(1, n + 1,
                                                   BERT_BATCH - 1)])
            mask = np.arange(n)[None] < ends[:, None]
            labels = rs.randint(0, 2, (BERT_BATCH,))
            batches.append(tuple(torch.from_numpy(a.astype(np.int64)).cuda()
                                 for a in (ids, mask, labels)))
    return batches


def check_mask_hides_padding(torch, bert, batches) -> float:
    """A padded batch's loss within ``LOSS_PAD_TOL`` of the same batch at
    its true length, eagerly in f32 on ``bert_tiny``'s width at full depth
    (12 layers): the keep-mask hides the rung's padding. Returns the
    largest difference."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.jit.bucketing import bucket_for, pad_to_bucket

    model = bert.BertForSequenceClassification(
        bert.bert_tiny(num_hidden_layers=12, vocab_size=40000),
        generator=torch.Generator().manual_seed(0))
    crit = nn.CrossEntropyLoss()
    worst = 0.0
    with torch.no_grad():
        for ids, mask, labels in batches:
            rung = bucket_for(ids.shape[1], BUCKET_LADDER)
            true = crit(model(ids, attention_mask=mask), labels)
            padded = crit(model(pad_to_bucket(ids, 1, rung),
                                attention_mask=pad_to_bucket(mask, 1, rung)),
                          labels)
            worst = max(worst, abs(float(padded) - float(true)))
    check(worst <= LOSS_PAD_TOL, f"a padded batch's loss differs from its "
          f"true length's by {worst:.3g} (tol {LOSS_PAD_TOL})")
    del model
    return worst


def bert_bucketed(torch, bert) -> dict:
    """(c) Variable-length fine-tuning: ernie_base bf16 O2 under
    ``TrainStep(bucket_axes={0: 1, 1: 1})``, a keep-mask a batch; held bit
    for bit to eager steps on the same padded batches, one capture a rung,
    no host sync in a replay, each rung's replay p50."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.jit.bucketing import bucket_for, pad_to_bucket
    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    cfg = bert.ernie_base(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    batches = bucket_batches(torch, cfg.vocab_size)
    rungs = [bucket_for(b[0].shape[1], BUCKET_LADDER) for b in batches]
    print(f"-- (c) bucketed fine-tune: ernie_base bf16 O2, TrainStep("
          f"bucket_axes={{0: 1, 1: 1}}, bucket_pad_values={{0: 0, 1: 0}}, "
          f"bucket_range=(16, 128)), B={BERT_BATCH}, {len(batches)} batches "
          f"of lengths {[int(b[0].shape[1]) for b in batches]} (rungs "
          f"{rungs}), each with its keep-mask", flush=True)
    model, opt, loss_fn = bert_twin(torch, bert, cfg, masked=True)
    padded = [(pad_to_bucket(ids, 1, r), pad_to_bucket(mask, 1, r), labels)
              for (ids, mask, labels), r in zip(batches, rungs)]
    reference = (eager_steps(torch, opt, loss_fn, padded),
                 [p.detach().clone() for p in model.parameters()])
    del model, opt, loss_fn, padded
    release_memory(torch)

    model, opt, loss_fn = bert_twin(torch, bert, cfg, masked=True)
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn,
                     bucket_axes={0: 1, 1: 1}, bucket_range=(16, 128),
                     bucket_pad_values={0: 0, 1: 0})
    fa.launches = fa.dq_launches = fa.dkv_launches = fa.tma_copies = 0
    adamw.launches = 0
    seen, losses, times, captured_late = {}, [], {}, []
    for batch, rung in zip(batches, rungs):
        calls = seen.get(rung, 0)
        seen[rung] = calls + 1
        before = step._compiled.graph_counts()["captures"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if calls >= 2:  # a replay: no host sync may happen in it
            torch.cuda.set_sync_debug_mode("error")
        try:
            loss = step(*batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if calls >= 2:
            times.setdefault(rung, []).append(time.perf_counter() - t0)
            if step._compiled.graph_counts()["captures"] != before:
                captured_late.append(rung)
        losses.append(loss)
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches, adamw.launches)
    check_against_eager(torch, "BERT bucketed", [float(x) for x in losses],
                        [p.detach() for p in model.parameters()], reference)
    graphs = step._compiled.graph_counts()
    report = step.audit_report()
    print(f"rungs {report['buckets']}; graph counts {graphs}; captured after "
          f"a rung's second call: {captured_late}", flush=True)
    check(graphs["signatures"] == graphs["captures"] == len(BUCKET_LADDER)
          and not captured_late, f"bucketed captures {graphs}, late "
          f"{captured_late}: want one a rung, none after its second call")
    check(step.stats == {"compiled_steps": len(batches) - len(BUCKET_LADDER),
                         "eager_steps": len(BUCKET_LADDER)},
          f"bucketed steps {step.stats}")
    per_step = adamw_launches_per_step(model)
    print(f"launches K1/K2/K3/AdamW {counts} over {len(batches)} steps (the "
          f"masked route runs no K1-K3)", flush=True)
    check(counts == (0, 0, 0, per_step * len(batches)),
          f"bucketed launches {counts}")
    print("step ms p50 by rung (replays, no host sync): " + ", ".join(
        f"{r}: {float(np.median(times[r])) * 1e3:.3f}"
        for r in BUCKET_LADDER), flush=True)
    del model, opt, step, loss_fn, reference
    release_memory(torch)
    worst = check_mask_hides_padding(torch, bert, batches)
    print(f"padded vs true-length loss (bert_tiny width, 12 layers, f32, "
          f"eager) over {len(batches)} batches: max diff {worst:.3g} (tol "
          f"{LOSS_PAD_TOL})", flush=True)
    return {"adamw": counts[3],
            "p50_ms": {r: float(np.median(times[r])) * 1e3
                       for r in BUCKET_LADDER}}


def phase_bert(torch, bert) -> dict:
    """Phase 17: BERT/ERNIE fine-tuning, (a) the bench arm, (b) K1-K3 at
    its shape, (c) bucketed variable-length batches with masks."""
    print("== BERT fine-tune: bench_bert's arm graphed, K1-K3 non-causal at "
          "its shape, bucketed variable-length batches with padding masks",
          flush=True)
    return {"arm": bert_bench_arm(torch, bert),
            "records": bert_attention_kernels(torch),
            "bucketed": bert_bucketed(torch, bert)}


# ------------------------------------------------------- phase 18, ResNet
RESNET_BATCH, RESNET_SIZE = 32, 224  # bench_resnet's accelerator arm
RESNET_CLASSES, RESNET_LR, RESNET_MOMENTUM = 1000, 0.1, 0.9
RESNET_GFLOP = 4.089  # bench.py: ResNet-50's forward GFLOP an image at 224²
RESNET_STEPS = GRAPH_WARMUP + TRAIN_STEPS
# when two eager runs differ (cuDNN's default algorithms not deterministic),
# the timed graphed run is held to an eager run within this share of each
# loss; the graph = eager check then runs under cudnn.deterministic
RESNET_NONDET_TOL = 5e-2
# eval logits, card (f32, TF32 off) against the CPU: within this share of
# the largest logit
RESNET_EVAL_TOL = 1e-3
RESNET_EVAL_BATCH = 4
# f32 operations per element of a Momentum update: v (mul, add), p (mul,
# sub), the L2 or Nesterov term at most one more
MOMENTUM_OPS = 5
# the profile's kernel classes, first match wins (cuDNN's convolution
# kernels name their pass: fprop, dgrad, wgrad)
RESNET_CLASSES_RX = (
    ("Momentum", re.compile(r"(?:^|[\s:])momentum_kernel<")),
    ("layout transposes", re.compile(r"nchwToNhwc|nhwcToNchw|[Tt]ranspose")),
    ("conv dgrad", re.compile(r"dgrad", re.I)),
    ("conv wgrad", re.compile(r"wgrad", re.I)),
    ("conv fwd", re.compile(r"fprop", re.I)),
    ("BatchNorm", re.compile(r"batch_norm|welford", re.I)),
    ("pooling", re.compile(r"pool", re.I)),
    ("element-wise (casts, relu, adds)", re.compile(r"elementwise", re.I)),
    ("reductions", re.compile(r"reduce", re.I)),
    # cuDNN runs some convolutions as GEMM kernels whose names do not say
    # the pass; the fc's three GEMMs land here too
    ("GEMM-named (cuDNN convs, fc)", re.compile(r"nvjet|gemm|cutlass|xmma",
                                                re.I)),
)
RESNET_CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def resnet_twin(torch, resnet):
    """``bench_resnet``'s setup: ``resnet50(num_classes=1000)`` (weights
    from a generator seeded 0) in bf16 O2, ``Momentum(0.1, 0.9)``,
    ``CrossEntropyLoss`` outside ``auto_cast``. Returns (model, optimizer,
    loss_fn(x, y))."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.optimizer import Momentum

    model = resnet.resnet50(num_classes=RESNET_CLASSES,
                            generator=torch.Generator().manual_seed(0))
    crit = nn.CrossEntropyLoss()
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
                   parameters=model.parameters())

    def loss_fn(x, y):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(x)
        return crit(logits, y)

    return model, opt, loss_fn


def state_of(model) -> list:
    """Every parameter and buffer (the BatchNorms' running stats)."""
    return list(model.parameters()) + list(model.buffers())


def same_bits(torch, a, b) -> bool:
    """``a`` and ``b`` hold the same bits (NaN included)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().view(ints[a.element_size()]),
                       b.contiguous().view(ints[b.element_size()]))


def eager_train(torch, make, batch, steps) -> tuple:
    """``steps`` eager steps by hand on a fresh twin ``make()`` returns
    (model, optimizer, loss_fn): the losses (float32 tensors) and every
    parameter and buffer after them."""
    model, opt, loss_fn = make()
    losses = []
    for _ in range(steps):
        loss = loss_fn(*batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach().float())
    torch.cuda.synchronize()
    out = (losses, [t.detach().clone() for t in state_of(model)])
    del model, opt, loss_fn
    release_memory(torch)
    return out


def train_equal(torch, a, b) -> tuple:
    """(losses bit for bit, tensors bit for bit, tensor count) of two
    runs."""
    (la, sa), (lb, sb) = a, b
    losses = len(la) == len(lb) and all(same_bits(torch, x, y)
                                        for x, y in zip(la, lb))
    same = sum(same_bits(torch, x, y) for x, y in zip(sa, sb))
    return losses, same, len(sa)


def first_running_mean(model):
    """The first BatchNorm's running mean."""
    return next(b for n, b in model.named_buffers() if n.endswith("._mean"))


def graphed_arm(torch, make, batch, steps, what) -> dict:
    """A bench arm's training path on the card: two eager runs of
    ``steps`` steps on twins from ``make()`` compared bit for bit; if they
    differ (cuDNN's default algorithms not deterministic here), a graphed
    run under ``cudnn.deterministic`` held bit for bit to an eager run
    under it. Then the timed graphed run (``run_timed_steps``) on a fresh
    twin, held bit for bit to the first eager run (losses, parameters and
    running stats), or, where the eager runs differed, its losses within
    ``RESNET_NONDET_TOL`` of the eager ones. Checks the launches (the
    Momentum kernel's ceil(tensors / 64) a step, no other kernel of the
    port) and that the running stats keep their storage and move in a
    replay. Returns the graphed run's record, its model, ``TrainStep``,
    optimizer and loss_fn."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.cuda import momentum

    reference = eager_train(torch, make, batch, steps)
    losses_eq, same, n = train_equal(
        torch, reference, eager_train(torch, make, batch, steps))
    deterministic = losses_eq and same == n
    print(f"two eager runs: losses bitwise equal {losses_eq}, parameters "
          f"and buffers bitwise equal {same}/{n}: cuDNN's default "
          f"algorithms {'are' if deterministic else 'are NOT'} "
          f"deterministic here", flush=True)
    if not deterministic:
        torch.backends.cudnn.deterministic = True
        try:
            want = eager_train(torch, make, batch, steps)
            model, opt, loss_fn = make()
            step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
            got = ([step(*batch).float() for _ in range(steps)],
                   [t.detach().clone() for t in state_of(model)])
            losses_eq, same, n = train_equal(torch, got, want)
            print(f"under cudnn.deterministic: graphed steps against eager "
                  f"steps: losses bitwise equal {losses_eq}, parameters "
                  f"and buffers {same}/{n}", flush=True)
            check(losses_eq and same == n, f"{what}: the graphed steps "
                  f"differ from the eager ones under cudnn.deterministic")
            del model, opt, loss_fn, step, got, want
            release_memory(torch)
        finally:
            torch.backends.cudnn.deterministic = False
    model, opt, loss_fn = make()
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    first, losses, times, counts = run_timed_steps(torch, step, batch)
    launched = momentum.launches
    stats = first_running_mean(model)
    stats_ptr = stats.data_ptr()
    got = ([torch.tensor(v, dtype=torch.float32) for v in first + losses],
           state_of(model))
    want_losses = [float(v) for v in reference[0]]
    if deterministic:
        losses_eq, same, n = train_equal(
            torch, ([v.cuda() for v in got[0]], got[1]), reference)
        print(f"graphed steps against the eager run: losses bitwise equal "
              f"{losses_eq}, parameters and buffers {same}/{n}", flush=True)
        check(losses_eq and same == n, f"{what}: the graphed steps differ "
              f"from the eager sequence")
    else:
        worst = max(abs(a - b) / max(abs(b), 1e-6)
                    for a, b in zip(first + losses, want_losses))
        print(f"graphed (timed) steps against the eager run: losses within "
              f"{worst:.3g} of each eager loss (tol {RESNET_NONDET_TOL})",
              flush=True)
        check(worst <= RESNET_NONDET_TOL, f"{what}: graphed losses stray "
              f"from the eager run")
    print("eager losses " + " ".join(f"{v:.4f}" for v in want_losses)
          + "\ngraphed losses " + " ".join(f"{v:.4f}"
                                            for v in first + losses),
          flush=True)
    check(all(math.isfinite(v) for v in first), f"non-finite first "
          f"losses {first}")
    stats = first_running_mean(model)
    check(stats.dtype == torch.float32 and stats.data_ptr() == stats_ptr,
          "the running stats were rebound during the replays")
    per_step = math.ceil(len(list(model.parameters())) / momentum.MAX_TENSORS)
    print(f"launches K1/K2/K3/K4/AdamW/K4-bwd {counts}, Momentum {launched} "
          f"over {TRAIN_STEPS} steps", flush=True)
    check(counts == (0,) * 6 and launched == per_step * TRAIN_STEPS,
          f"{what} launches {counts}, Momentum {launched}: want "
          f"{per_step * TRAIN_STEPS} of Momentum and none of the others")
    # the running stats move at every replay: one more replay changes them
    before = stats.clone()
    step(*batch)
    torch.cuda.synchronize()
    check(not torch.equal(before, stats), "the running stats did not move "
          "in a replay")
    del reference, got
    return {"model": model, "step": step, "opt": opt, "loss_fn": loss_fn,
            "first": first, "losses": losses, "times": times,
            "momentum": launched, "deterministic": deterministic,
            "p50": float(np.median(times))}


def profile_replayed(torch, step, batch, step_ms, classify, class_names,
                     steps=2) -> dict:
    """Device time by kernel class over ``steps`` replayed steps after a
    warmup step (``torch.profiler``, the card idle ``PROFILE_PAD_S`` inside
    each end of the window). ``classify(kernel name)`` returns
    ``{class: share}``, a name's time split over those classes by share;
    ``class_names`` orders the classes. The profile's Momentum launches
    per step must equal the counter's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from paddle_tpu_torch.ops.cuda import momentum

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1)) as prof:
        for i in range(steps + 1):
            if i == 1:
                time.sleep(PROFILE_PAD_S)
                before = momentum.launches
            step(*batch)
            torch.cuda.synchronize()
            if i == steps:
                time.sleep(PROFILE_PAD_S)
            prof.step()
    counted = (momentum.launches - before) / steps
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    check(len(rows) > 0, "the profiler recorded no device time")
    total = sum(r[1] for r in rows)
    classes = {name: [0.0, 0.0] for name in class_names}
    for key, ms, count in rows:
        split = classify(key)
        whole = sum(split.values())
        for cls, share in split.items():
            classes[cls][0] += ms * share / whole
            classes[cls][1] += count * share / whole
    launches = sum(r[2] for r in rows)
    print(f"launches per step, profile Momentum "
          f"{classes['Momentum'][1]:.0f}, counter {counted:.0f}", flush=True)
    check(round(classes["Momentum"][1]) == counted, f"the profile's "
          f"Momentum launches {classes['Momentum'][1]} differ from the "
          f"counter's {counted}")
    idle = 1 - total / step_ms
    print(f"profile of {steps} replayed steps: device busy {total:.3f} ms "
          f"per step ({total / step_ms:.1%} of the {step_ms:.3f} ms p50 "
          f"step; idle share {idle:.1%}), {launches:.0f} kernel launches "
          f"per step; " + "; ".join(f"{n} {ms:.3f} ms ({ms / total:.1%}, "
                                    f"x{c:.0f})" for n, (ms, c)
                                    in classes.items() if c), flush=True)
    rows.sort(key=lambda r: -r[1])
    for key, ms, count in rows[:24]:
        print(f"    {ms:8.3f} ms  x{count:<6.0f} {key[:110]}", flush=True)
    return {"device_ms": total, "launches": launches, "idle": idle,
            "classes": {n: ms for n, (ms, _) in classes.items()}}


def resnet_kernel_class(key) -> dict:
    """A kernel name's class by ``RESNET_CLASSES_RX``, first match wins."""
    return {next((n for n, rx in RESNET_CLASSES_RX if rx.search(key)),
                 "the rest"): 1.0}


def conv_passes(torch, loss_fn, opt, batch) -> dict:
    """Device ms of one eager forward and backward's convolution kernels by
    pass, from the op that launched each (``torch.profiler``; a replayed
    graph's kernels have no launching op): forward under
    ``aten::cudnn_convolution``, dgrad and wgrad under
    ``aten::convolution_backward`` by their names, the backward's kernels
    whose names do not say the pass apart, and the layout transposes of
    both."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss_fn(*batch).backward()
        torch.cuda.synchronize()
    opt.clear_grad()
    out = {"fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0, "bwd, pass unnamed": 0.0,
           "transposes": 0.0}
    for e in prof.events():
        if e.name not in RESNET_CONV_OPS:
            continue
        for k in e.kernels:
            ms = k.duration / 1e3
            if RESNET_CLASSES_RX[1][1].search(k.name):
                out["transposes"] += ms
            elif e.name == RESNET_CONV_OPS[0]:
                out["fwd"] += ms
            elif "dgrad" in k.name.lower():
                out["dgrad"] += ms
            elif "wgrad" in k.name.lower():
                out["wgrad"] += ms
            else:
                out["bwd, pass unnamed"] += ms
    check(out["fwd"] > 0, "the eager profile attributed no kernel to "
          "aten::cudnn_convolution")
    print("convolutions by pass in one eager forward and backward (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
          + f"; total {sum(out.values()):.3f}", flush=True)
    return out


def resnet_bench_arm(torch, resnet) -> dict:
    """(a) ``bench_resnet`` uncut: resnet50, 1000 classes, one 32 x 3 x
    224² batch as ``bench.py`` draws it, bf16 O2, ``Momentum(0.1, 0.9)``;
    two eager runs, the graphed run held to them, timed, profiled."""
    print(f"-- (a) bench arm: resnet50 ({RESNET_CLASSES} classes) bf16 O2, "
          f"Momentum({RESNET_LR}, {RESNET_MOMENTUM}), CrossEntropyLoss "
          f"outside auto_cast, one {RESNET_BATCH}x3x{RESNET_SIZE}x"
          f"{RESNET_SIZE} batch, labels in [0, 10); {RESNET_STEPS} eager "
          f"steps twice, then {GRAPH_WARMUP} warmup and {TRAIN_STEPS} timed "
          f"TrainStep steps", flush=True)
    rs = np.random.RandomState(0)  # as bench.py draws x, then y
    x = rs.randn(RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE).astype(
        np.float32)
    y = rs.randint(0, 10, (RESNET_BATCH,)).astype(np.int64)
    batch = (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    arm = graphed_arm(torch, lambda: resnet_twin(torch, resnet), batch,
                      RESNET_STEPS, "ResNet")
    p50, times = arm["p50"], arm["times"]
    flops = 3 * RESNET_GFLOP * 1e9 * RESNET_BATCH
    print(f"step ms p50 {p50 * 1e3:.3f} (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}); images/s {RESNET_BATCH / p50:.1f}; "
          f"TFLOP/s {flops / p50 / 1e12:.2f} (bench.py: 3 x {RESNET_GFLOP} "
          f"GFLOP x {RESNET_BATCH} a step); MFU "
          f"{flops / p50 / PEAK_FLOPS['bfloat16']:.2%} of 989 TFLOP/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    prof = profile_replayed(
        torch, arm["step"], batch, p50 * 1e3, resnet_kernel_class,
        [n for n, _ in RESNET_CLASSES_RX] + ["the rest"])
    prof["conv_passes"] = conv_passes(torch, arm["loss_fn"], arm["opt"],
                                      batch)
    out = {"momentum": arm["momentum"], "p50_ms": p50 * 1e3,
           "images_s": RESNET_BATCH / p50,
           "deterministic": arm["deterministic"], "profile": prof,
           "first_loss": arm["first"][0], "launches": prof["launches"]}
    model = arm["model"]
    del arm
    release_memory(torch)
    return out, model


def graph_time_ms(torch, fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` replayed from a CUDA graph (``fn`` run
    once on a side stream first, then captured): the card's time alone, for
    a call whose host work outlasts its kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_time_ms(graph.replay, iters=iters)
    del graph
    return ms


def momentum_bound(numel: int, elem: int, gelem: int) -> tuple:
    """Least time (ms) of one Momentum pass: p read and written (``elem``
    bytes), g read (``gelem``), the f32 velocity read and written, over
    HBM bandwidth, against ``MOMENTUM_OPS`` f32 operations an element."""
    t_mem = numel * (2 * elem + gelem + 8) / PEAK_BYTES * 1e3
    t_ops = numel * MOMENTUM_OPS / PEAK_FLOPS["float32"] * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def momentum_bitwise(torch, model, lr, mu, what, seed) -> dict:
    """``momentum_update`` against ``momentum_reference``, bit for bit,
    launches included, on ``model``'s parameters (O2: their AMP dtype)
    with random gradients and velocities from ``seed``, at learning rate
    ``lr`` and momentum ``mu``. Returns the tensors and the check's
    numbers."""
    from paddle_tpu_torch.ops.cuda import momentum

    dev = torch.device("cuda")
    named = [(n, p.detach()) for n, p in model.named_parameters()]
    params = [p for _, p in named]
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
             for p in params]
    vels = [torch.randn(p.shape, generator=gen, device=dev) * 1e-2
            for p in params]
    lr = torch.tensor(lr, device=dev)
    got, want = ([[t.clone() for t in ts] for ts in (params, vels)]
                 for _ in range(2))
    momentum.launches = 0
    momentum.momentum_update(got[0], grads, got[1], lr, momentum=mu)
    launched = momentum.launches
    momentum.momentum_reference(want[0], grads, want[1], lr, momentum=mu)
    torch.cuda.synchronize()
    pairs = [(a, b) for ga, gb in zip(got, want) for a, b in zip(ga, gb)]
    equal = sum(torch.equal(a, b) for a, b in pairs)
    err = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    numel = sum(p.numel() for p in params)
    per = math.ceil(len(params) / momentum.MAX_TENSORS)
    odd = sum(p.numel() % 4 != 0 for p in params)
    print(f"{what}: {len(params)} parameters ({odd} of a size not a "
          f"multiple of 4), {numel} elements; p, v bitwise equal to the "
          f"plain version: {equal}/{len(pairs)} (max abs err {err:.3g}); "
          f"{launched} launches", flush=True)
    check(equal == len(pairs) and launched == per, f"{what}: the Momentum "
          f"kernel differs from its plain version in {len(pairs) - equal} "
          f"tensors (max abs err {err}), or {launched} launches (want "
          f"{per})")
    return {"named": named, "params": params, "grads": grads, "vels": vels,
            "got": got, "want": want, "lr": lr, "err": err, "numel": numel,
            "per": per}


def resnet_momentum_kernel(torch, resnet) -> dict:
    """(b) The Momentum kernel against ``momentum_reference``, bit for bit:
    on resnet50's 161 bf16 tensors (timed beside its bound, the plain chain
    and torch's SGD with momentum), then in every mode: bf16, fp16 and f32
    parameters, f32 gradients, Nesterov, L2 on the conv weights, group LR
    factors, ``found_inf`` unset and set."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops.cuda import momentum

    print("-- (b) Momentum kernel: resnet50's parameters, kernel vs plain "
          "bitwise; ms by CUDA events", flush=True)
    dev = torch.device("cuda")
    model = resnet.resnet50(num_classes=RESNET_CLASSES,
                            generator=torch.Generator().manual_seed(0))
    amp.decorate(model, level="O2", dtype="bfloat16")
    run = momentum_bitwise(torch, model, RESNET_LR, RESNET_MOMENTUM,
                           "resnet50", 18)
    named, params, grads, vels = (run[k] for k in ("named", "params",
                                                   "grads", "vels"))
    got, want, lr, err, numel, per = (run[k] for k in (
        "got", "want", "lr", "err", "numel", "per"))
    del run
    kw = dict(momentum=RESNET_MOMENTUM)
    # the wrapper's host work (161 tensors packed into 3 launches) outlasts
    # its kernels, so the update is timed as a replayed graph, as TrainStep
    # runs it; one eager call is timed beside it
    ms = graph_time_ms(torch, lambda: momentum.momentum_update(
        got[0], grads, got[1], lr, **kw))
    eager_ms = cuda_time_ms(lambda: momentum.momentum_update(
        got[0], grads, got[1], lr, **kw), iters=20)
    plain_ms = graph_time_ms(torch, lambda: momentum.momentum_reference(
        want[0], grads, want[1], lr, **kw), iters=10)
    del got, want
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lib_params, grads):
        p.grad = g
    try:
        sgd = torch.optim.SGD(lib_params, lr=RESNET_LR,
                              momentum=RESNET_MOMENTUM, fused=True)
        lib_name = "torch.optim.SGD(momentum=0.9, fused=True)"
    except (TypeError, RuntimeError):
        sgd = torch.optim.SGD(lib_params, lr=RESNET_LR,
                              momentum=RESNET_MOMENTUM, foreach=True)
        lib_name = "torch.optim.SGD(momentum=0.9, foreach=True)"
    lib_ms = graph_time_ms(torch, sgd.step)
    bound_ms, bound_by = momentum_bound(numel, 2, 2)
    print(f"replayed in a CUDA graph: kernel {ms:.4f} ms "
          f"({numel * 14 / ms / 1e6:.1f} GB/s of 14 B an element), plain "
          f"chain {plain_ms:.4f}, {lib_name} {lib_ms:.4f} (a bf16 momentum "
          f"buffer), bound {bound_ms:.4f} ({bound_by}); one eager call of "
          f"the kernel's wrapper {eager_ms:.4f} (its host work)", flush=True)
    del lib_params, sgd
    # every mode
    factors = [((0.5,) if ".bn" in n or "downsample.1" in n else ())
               + ((2.0,) if n.startswith("fc.") else ()) for n, _ in named]
    wds = [1e-4 if n.endswith("weight") and p.dim() == 4 else None
           for n, p in named]
    modes = 0
    for pdt, gdt in ((torch.bfloat16, torch.bfloat16),
                     (torch.float16, torch.float16),
                     (torch.float32, torch.float32),
                     (torch.bfloat16, torch.float32),
                     (torch.float16, torch.float32)):
        ps = [p.to(pdt) for p in params]
        gs = [g.to(gdt) for g in grads]
        for nesterov in (False, True):
            for found in (None, False, True):
                flag = (None if found is None
                        else torch.tensor(found, device=dev))
                runs = [([p.clone() for p in ps], [v.clone() for v in vels])
                        for _ in range(2)]
                mkw = dict(momentum=RESNET_MOMENTUM, nesterov=nesterov,
                           weight_decay=wds, lr_factors=factors,
                           found_inf=flag)
                momentum.launches = 0
                momentum.momentum_update(runs[0][0], gs, runs[0][1], lr,
                                         **mkw)
                n_launch = momentum.launches
                momentum.momentum_reference(runs[1][0], gs, runs[1][1], lr,
                                            **mkw)
                torch.cuda.synchronize()
                eq = sum(torch.equal(a, b) for a, b in
                         zip(runs[0][0] + runs[0][1],
                             runs[1][0] + runs[1][1]))
                kept = (all(torch.equal(a, b) for a, b in
                            zip(runs[0][0], ps)) if found else None)
                check(eq == 2 * len(ps) and n_launch == per
                      and kept in (None, True),
                      f"Momentum mode p {pdt} g {gdt} nesterov {nesterov} "
                      f"found_inf {found}: {eq}/{2 * len(ps)} equal, "
                      f"{n_launch} launches, unchanged {kept}")
                modes += 1
                del runs
        del ps, gs
        torch.cuda.empty_cache()
    print(f"{modes} modes (p bf16/fp16/f32 with g of their dtype or f32; "
          f"Nesterov or not; found_inf none/unset/set), L2 on the conv "
          f"weights, LR factors on the BatchNorms and fc: every tensor "
          f"bitwise equal, {per} launches each", flush=True)
    del model, params, grads, vels
    release_memory(torch)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": lib_name, "eager_call_ms": eager_ms,
            "shape": f"resnet50, {len(named)} bf16 tensors, {numel} "
                     f"elements"}


def resnet_eval_logits(torch, resnet, trained) -> float:
    """(c) The trained resnet50 in eval mode (running stats from (a)): f32
    logits on the card against the same weights on the CPU, within
    ``RESNET_EVAL_TOL`` of the largest logit."""
    state = {k: v.detach().float().cpu()
             for k, v in trained.state_dict().items()}
    x = torch.from_numpy(np.random.RandomState(18).randn(
        RESNET_EVAL_BATCH, 3, RESNET_SIZE, RESNET_SIZE).astype(np.float32))
    out = []
    for dev in ("cuda", "cpu"):
        model = resnet.resnet50(num_classes=RESNET_CLASSES, device=dev)
        model.load_state_dict(state)
        model.eval()
        with torch.no_grad():
            out.append(model(x.to(dev)).float().cpu())
        del model
    card, cpu = out
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max())
    print(f"-- (c) trained resnet50, eval mode, f32, {RESNET_EVAL_BATCH} "
          f"images: logits card vs CPU max abs err {err:.3g} (largest "
          f"logit {scale:.4g}, tol {RESNET_EVAL_TOL} of it); argmax equal "
          f"{torch.equal(card.argmax(-1), cpu.argmax(-1))}", flush=True)
    check(math.isfinite(scale) and err <= RESNET_EVAL_TOL * max(scale, 1.0),
          f"ResNet eval logits card vs CPU: {err} (largest {scale})")
    release_memory(torch)
    return err


def phase_resnet(torch, resnet) -> dict:
    """Phase 18: ResNet-50 training, (a) the bench arm graphed, (b) the
    Momentum kernel, (c) eval logits card vs CPU."""
    print("== ResNet train: bench_resnet's arm graphed, the Momentum kernel, "
          "eval logits card vs CPU", flush=True)
    arm, model = resnet_bench_arm(torch, resnet)
    record = resnet_momentum_kernel(torch, resnet)
    record["eval_logits_err"] = resnet_eval_logits(torch, resnet, model)
    del model
    release_memory(torch)
    return {"arm": arm, "momentum": record}


# ------------------------------------------------------ phase 19, PP-LiteSeg
LITESEG_BATCH, LITESEG_SIZE = 16, 512  # bench_liteseg's accelerator arm
LITESEG_CLASSES, LITESEG_BASE = 19, 32
LITESEG_LR, LITESEG_MOMENTUM = 0.01, 0.9
LITESEG_STEPS = GRAPH_WARMUP + TRAIN_STEPS
LITESEG_EVAL_BATCH = 2
# interpolate on the card against float64 of the same contractions (the
# same weight matrices, in the input's dtype): f32 (TF32 off) within this
# share of the largest value; bf16 rounds the first axis's product and the
# output, each by at most 2^-9 of the largest, so within 2^-7 of it
INTERP_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# (what, input shape, output size, mode): the bench arm's resizes (SPPM's
# bins 1/2/4 to 16², UAFM 16² -> 32² and 32² -> 64², the head 64² ->
# 512²), a shrinking one and a bicubic one
INTERP_CARD_CASES = (
    ("SPPM bin 1", (16, 256, 1, 1), (16, 16), "bilinear"),
    ("SPPM bin 2", (16, 256, 2, 2), (16, 16), "bilinear"),
    ("SPPM bin 4", (16, 256, 4, 4), (16, 16), "bilinear"),
    ("UAFM 16->32", (16, 64, 16, 16), (32, 32), "bilinear"),
    ("UAFM 32->64", (16, 32, 32, 32), (64, 64), "bilinear"),
    ("head 64->512", (16, 19, 64, 64), (512, 512), "bilinear"),
    ("shrink 64->37x29", (16, 19, 64, 64), (37, 29), "bilinear"),
    ("bicubic 16->32", (16, 64, 16, 16), (32, 32), "bicubic"),
)
# PP-YOLOE at 2 x 3 x 320², eval mode: card (f32, TF32 off) against the CPU
YOLO_SIZE, YOLO_CLASSES = 320, 80
YOLO_GT = (np.array([[16.0, 24.0, 200.0, 180.0], [120.0, 100.0, 300.0,
                                                   310.0]], np.float32),
           np.array([3, 41]))
# small.py's constructors and their inputs, eval logits card vs CPU
SMALL_MODELS = (("LeNet", {}, (2, 1, 28, 28)),
                ("alexnet", {}, (1, 3, 224, 224)),
                ("vgg11", {}, (1, 3, 224, 224)),
                ("vgg13", dict(batch_norm=True), (1, 3, 224, 224)),
                ("vgg16", {}, (1, 3, 224, 224)),
                ("vgg19", dict(batch_norm=True), (1, 3, 224, 224)),
                ("mobilenet_v1", {}, (1, 3, 224, 224)),
                ("mobilenet_v2", {}, (1, 3, 224, 224)))
# the profile's kernel classes; an eager step attributes each kernel to the
# op that launched it (``liteseg_eager_split``) and the replayed kernels
# take those classes by name
LITESEG_CLASS_NAMES = (
    "convolutions", "depthwise convolutions", "BatchNorm",
    "element-wise, casts, pools, reductions", "NCHW<->NHWC transposes",
    "resize contractions", "cross entropy and its transpose copy",
    "Momentum", "the rest")
LITESEG_NAME_RX = (
    ("depthwise convolutions", re.compile(r"depthwise|dwconv", re.I)),
    ("convolutions", re.compile(r"fprop|dgrad|wgrad|conv", re.I)),
    ("BatchNorm", re.compile(r"batch_norm|welford", re.I)),
    ("cross entropy and its transpose copy",
     re.compile(r"softmax|nll_loss", re.I)),
    ("element-wise, casts, pools, reductions",
     re.compile(r"elementwise|reduce|pool", re.I)))
LITESEG_CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward",
                    "aten::_conv_depthwise2d", "aten::convolution",
                    "aten::_convolution")
LITESEG_CE_OPS = ("aten::log_softmax", "aten::_log_softmax",
                  "aten::_log_softmax_backward_data", "aten::nll_loss",
                  "aten::gather", "aten::scatter_add_", "aten::reshape")


def liteseg_twin(torch, segdet):
    """``bench_liteseg``'s setup: ``pp_liteseg(num_classes=19, base=32)``
    (weights from a generator seeded 0) in bf16 O2, ``Momentum(0.01,
    0.9)``, ``CrossEntropyLoss`` over ``reshape(transpose(logits, [0, 2,
    3, 1]), [-1, 19])`` outside ``auto_cast``. Returns (model, optimizer,
    loss_fn(x, y))."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.ops.manipulation import reshape, transpose
    from paddle_tpu_torch.optimizer import Momentum

    model = segdet.pp_liteseg(num_classes=LITESEG_CLASSES, base=LITESEG_BASE,
                              generator=torch.Generator().manual_seed(0))
    crit = nn.CrossEntropyLoss()
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = Momentum(learning_rate=LITESEG_LR, momentum=LITESEG_MOMENTUM,
                   parameters=model.parameters())

    def loss_fn(x, y):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(x)
        flat = reshape(transpose(logits, [0, 2, 3, 1]), [-1, LITESEG_CLASSES])
        return crit(flat, reshape(y, [-1]))

    return model, opt, loss_fn


def liteseg_kernel_class(event, kernel) -> str:
    """The class of ``kernel``, launched under the profiler's ``event``:
    by its name for Momentum and the layout transposes, else by the
    nearest enclosing op (a depthwise convolution's weight is [c, 1, k,
    k])."""
    if RESNET_CLASSES_RX[0][1].search(kernel):
        return "Momentum"
    if RESNET_CLASSES_RX[1][1].search(kernel):
        return "NCHW<->NHWC transposes"
    e = event
    while e is not None:
        name = e.name
        if name in ("aten::mm", "aten::bmm", "aten::matmul"):
            return "resize contractions"
        if name in LITESEG_CONV_OPS:
            depthwise = any(len(s) == 4 and s[1] == 1 and s[0] > 1
                            and s[2] == s[3] <= 7
                            for s in (e.input_shapes or ()))
            return "depthwise convolutions" if depthwise else "convolutions"
        if "batch_norm" in name or name == "aten::var_mean":
            return "BatchNorm"
        if name in LITESEG_CE_OPS:
            return "cross entropy and its transpose copy"
        e = e.cpu_parent
    if event is None:  # a name the eager step did not launch
        for cls, rx in LITESEG_NAME_RX:
            if rx.search(kernel):
                return cls
        return "the rest"
    return "element-wise, casts, pools, reductions"


def liteseg_eager_split(torch, loss_fn, opt, batch) -> tuple:
    """Device ms of one eager forward and backward by class, each kernel
    attributed to the op that launched it (``torch.profiler`` with shapes;
    a replayed graph's kernels have no launching op); also each kernel
    name's ms by class, which the replay profile splits by."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        loss_fn(*batch).backward()
        torch.cuda.synchronize()
    opt.clear_grad()
    out = {name: 0.0 for name in LITESEG_CLASS_NAMES}
    by_name = {}
    for e in prof.events():
        for k in e.kernels:
            cls = liteseg_kernel_class(e, k.name)
            ms = k.duration / 1e3
            out[cls] += ms
            by_name.setdefault(k.name, {}).setdefault(cls, 0.0)
            by_name[k.name][cls] += ms
    check(out["resize contractions"] > 0 and out["convolutions"] > 0,
          "the eager profile attributed no kernel to the resize or the "
          "convolutions")
    print("one eager forward and backward by launching op (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items() if v)
          + f"; total {sum(out.values()):.3f}", flush=True)
    return out, by_name


def liteseg_bench_arm(torch, segdet) -> tuple:
    """(a) ``bench_liteseg`` uncut: pp_liteseg(19, base=32), one 16 x 3 x
    512² batch and labels in [0, 19) as ``bench.py`` draws them, bf16 O2,
    ``Momentum(0.01, 0.9)``; two eager runs, the graphed run held to them,
    timed, profiled by class; then the Momentum kernel held bit for bit to
    its plain version on the model's parameters."""
    print(f"-- (a) bench arm: pp_liteseg({LITESEG_CLASSES} classes, base "
          f"{LITESEG_BASE}) bf16 O2, Momentum({LITESEG_LR}, "
          f"{LITESEG_MOMENTUM}), per-pixel CrossEntropyLoss outside "
          f"auto_cast, one {LITESEG_BATCH}x3x{LITESEG_SIZE}x{LITESEG_SIZE} "
          f"batch, labels in [0, {LITESEG_CLASSES}); {LITESEG_STEPS} eager "
          f"steps twice, then {GRAPH_WARMUP} warmup and {TRAIN_STEPS} timed "
          f"TrainStep steps", flush=True)
    rs = np.random.RandomState(0)  # as bench.py draws x, then y
    x = rs.randn(LITESEG_BATCH, 3, LITESEG_SIZE, LITESEG_SIZE).astype(
        np.float32)
    y = rs.randint(0, LITESEG_CLASSES, (LITESEG_BATCH, LITESEG_SIZE,
                                        LITESEG_SIZE)).astype(np.int64)
    batch = (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    arm = graphed_arm(torch, lambda: liteseg_twin(torch, segdet), batch,
                      LITESEG_STEPS, "PP-LiteSeg")
    p50, times = arm["p50"], arm["times"]
    print(f"step ms p50 {p50 * 1e3:.3f} (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}); images/s {LITESEG_BATCH / p50:.1f}; "
          f"Momentum launches {arm['momentum']} over {TRAIN_STEPS} steps; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB (bench.py reports no TFLOP/s for this arm)", flush=True)
    check(arm["losses"][-1] < arm["first"][0], f"the loss did not fall: "
          f"{arm['first'] + arm['losses']}")
    # the eager split last: its forward moves the running stats
    split, by_name = liteseg_eager_split(torch, arm["loss_fn"], arm["opt"],
                                         batch)
    # each kernel name's time split over the classes the eager step gave
    # it; a name the eager step did not launch classed on its name alone
    prof = profile_replayed(
        torch, arm["step"], batch, p50 * 1e3,
        lambda key: by_name.get(key) or {liteseg_kernel_class(None, key):
                                         1.0}, LITESEG_CLASS_NAMES)
    prof["eager_split"] = split
    # the kernel at this path's shapes: pp_liteseg's bf16 tensors include
    # sizes under 4 and not a multiple of 4, which resnet50's lack
    check_run = momentum_bitwise(torch, arm["model"], LITESEG_LR,
                                 LITESEG_MOMENTUM, "Momentum kernel on "
                                 "pp_liteseg's parameters", 19)
    out = {"momentum": arm["momentum"], "p50_ms": p50 * 1e3,
           "images_s": LITESEG_BATCH / p50,
           "deterministic": arm["deterministic"], "profile": prof,
           "momentum_err": check_run["err"], "first_loss": arm["first"][0],
           "launches": prof["launches"]}
    del check_run
    model = arm["model"]
    del arm
    release_memory(torch)
    return out, model


def interp_reference(torch, x, size, mode, g):
    """Float64 of the port's contractions: the same per-axis weights (in
    ``x``'s dtype), the output and the input gradient for ``g``."""
    from paddle_tpu_torch.nn.functional.common import resize_weights

    method = {"bilinear": "linear", "bicubic": "cubic"}[mode]
    ws = [resize_weights(x.shape[2 + i], size[i], method).to(x.dtype)
          .double().cuda() for i in range(2)]
    out = torch.einsum("nchw,hH,wW->ncHW", x.double(), *ws)
    grad = torch.einsum("ncHW,hH,wW->nchw", g.double(), *ws)
    return out, grad


def liteseg_interpolate(torch) -> dict:
    """(b) ``interpolate`` forward and backward on the card at the arm's
    shapes, a shrinking one and a bicubic one, f32 (TF32 off) and bf16,
    against float64 of the same contractions; two backward passes bit for
    bit equal."""
    from paddle_tpu_torch.nn import functional as F

    print("-- (b) interpolate (JAX's resize as per-axis contractions) on "
          "the card vs float64 of the same contractions; backward twice",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(19)
    worst = {}
    for what, shape, size, mode in INTERP_CARD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            x.requires_grad_(True)
            out = F.interpolate(x, size=list(size), mode=mode)
            g = torch.randn(out.shape, generator=gen, device="cuda").to(
                dtype)
            grads = []
            for _ in range(2):
                x.grad = None
                F.interpolate(x, size=list(size), mode=mode).backward(g)
                grads.append(x.grad.clone())
            torch.cuda.synchronize()
            want, want_grad = interp_reference(torch, x.detach(), size,
                                               mode, g)
            err = float((out.detach().double() - want).abs().max()
                        / want.abs().max())
            gerr = float((grads[0].double() - want_grad).abs().max()
                         / want_grad.abs().max())
            same = same_bits(torch, grads[0], grads[1])
            fwd_ms = cuda_time_ms(lambda: F.interpolate(
                x.detach(), size=list(size), mode=mode), iters=10)
            print(f"{what} {mode} {tuple(shape)} -> {size} {name}: out "
                  f"err {err:.3g}, grad err {gerr:.3g} of the largest (tol "
                  f"{INTERP_TOL[name]:.3g}); backward twice bitwise equal "
                  f"{same}; forward {fwd_ms:.4f} ms", flush=True)
            check(err <= INTERP_TOL[name] and gerr <= INTERP_TOL[name]
                  and same, f"interpolate {what} {name}: err {err}, grad "
                  f"err {gerr}, repeatable {same}")
            worst[name] = max(worst.get(name, 0.0), err, gerr)
            del x, out, g, grads, want, want_grad
    release_memory(torch)
    return worst


def card_vs_cpu(torch, make, state):
    """The same model on the card and the CPU: ``make(device)`` built
    there with ``state`` loaded, in eval mode."""
    out = []
    for dev in ("cuda", "cpu"):
        model = make(dev)
        model.load_state_dict(state)
        model.eval()
        out.append(model)
    return out


def rel_err(torch, got, want) -> float:
    """The largest difference over the largest value (at least 1)."""
    return float((got.detach().float().cpu() - want.detach().float()).abs()
                 .max() / max(float(want.detach().abs().max()), 1.0))


def liteseg_eval_logits(torch, segdet, trained) -> float:
    """(c) The trained pp_liteseg in eval mode (running stats from (a)): f32
    logits on the card against the same weights on the CPU, within
    ``RESNET_EVAL_TOL`` of the largest logit."""
    state = {k: v.detach().float().cpu()
             for k, v in trained.state_dict().items()}
    x = torch.from_numpy(np.random.RandomState(19).randn(
        LITESEG_EVAL_BATCH, 3, LITESEG_SIZE, LITESEG_SIZE).astype(
            np.float32))
    card, cpu = card_vs_cpu(torch, lambda dev: segdet.pp_liteseg(
        num_classes=LITESEG_CLASSES, base=LITESEG_BASE, device=dev), state)
    with torch.no_grad():
        want = cpu(x)
        err = rel_err(torch, card(x.cuda()), want)
    print(f"-- (c) trained pp_liteseg, eval mode, f32, {LITESEG_EVAL_BATCH} "
          f"images: logits card vs CPU within {err:.3g} of the largest "
          f"logit ({float(want.abs().max()):.4g}; tol {RESNET_EVAL_TOL})",
          flush=True)
    check(err <= RESNET_EVAL_TOL, f"PP-LiteSeg eval logits card vs CPU: "
          f"{err}")
    del card, cpu
    release_memory(torch)
    return err


def liteseg_other_models(torch, segdet, small) -> dict:
    """(d) PP-YOLOE (80 classes, base 32, 2 x 3 x 320², eval mode):
    forward, decode, postprocess and one loss + backward card vs CPU; each
    of small.py's constructors: eval logits card vs CPU. All f32 within
    ``RESNET_EVAL_TOL`` of the largest value. Checked, not timed."""
    print(f"-- (d) PP-YOLOE and small.py's models, eval mode, f32, card vs "
          f"CPU (tol {RESNET_EVAL_TOL} of the largest value)", flush=True)
    errs = {}
    made = segdet.pp_yoloe(num_classes=YOLO_CLASSES,
                           generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().cpu() for k, v in made.state_dict().items()}
    del made
    card, cpu = card_vs_cpu(torch, lambda dev: segdet.pp_yoloe(
        num_classes=YOLO_CLASSES, device=dev), state)
    x = torch.from_numpy(np.random.RandomState(20).randn(
        2, 3, YOLO_SIZE, YOLO_SIZE).astype(np.float32))
    shapes = [(YOLO_SIZE // s, YOLO_SIZE // s) for s in cpu.STRIDES]
    outs = [card(x.cuda()), cpu(x)]
    errs["forward"] = max(rel_err(torch, a, b) for oc, oh in zip(*outs)
                          for a, b in zip(oc, oh))
    decoded = [m.decode(o, shapes) for m, o in zip((card, cpu), outs)]
    errs["decode"] = max(rel_err(torch, a, b)
                         for a, b in zip(decoded[0], decoded[1]))
    kept = [m.postprocess(*d) for m, d in zip((card, cpu), decoded)]
    same_kept = (len(kept[0][0]) == len(kept[1][0])
                 and np.array_equal(kept[0][2], kept[1][2]))
    errs["postprocess"] = (float(np.abs(kept[0][0] - kept[1][0]).max()
                                 / max(np.abs(kept[1][0]).max(), 1.0))
                           if same_kept and len(kept[0][0]) else 0.0)
    losses = [m.loss(o, shapes, *YOLO_GT) for m, o in zip((card, cpu), outs)]
    for loss in losses:
        loss.backward()
    loss_values = [float(loss.detach()) for loss in losses]
    errs["loss"] = abs(loss_values[0] - loss_values[1]) / abs(loss_values[1])
    grads = dict(cpu.named_parameters())
    errs["gradients"] = max(rel_err(torch, p.grad, grads[n].grad)
                            for n, p in card.named_parameters())
    print(f"PP-YOLOE: forward {errs['forward']:.3g}, decode "
          f"{errs['decode']:.3g}, postprocess kept {len(kept[0][0])} boxes "
          f"(same classes {same_kept}; boxes {errs['postprocess']:.3g}), "
          f"loss {loss_values[0]:.5f} ({errs['loss']:.3g} relative), "
          f"gradients {errs['gradients']:.3g}", flush=True)
    check(same_kept and max(errs.values()) <= RESNET_EVAL_TOL,
          f"PP-YOLOE card vs CPU: {errs}, same kept {same_kept}")
    del card, cpu, outs, decoded, losses, grads
    release_memory(torch)
    for name, kw, shape in SMALL_MODELS:
        made = getattr(small, name)(
            generator=torch.Generator().manual_seed(0), **kw)
        state = {k: v.detach().cpu() for k, v in made.state_dict().items()}
        del made
        card, cpu = card_vs_cpu(
            torch, lambda dev: getattr(small, name)(device=dev, **kw), state)
        x = torch.from_numpy(np.random.RandomState(21).randn(*shape).astype(
            np.float32))
        with torch.no_grad():
            want = cpu(x)
            errs[name] = rel_err(torch, card(x.cuda()), want)
        print(f"{name}{kw or ''} {tuple(shape)}: logits {tuple(want.shape)} "
              f"card vs CPU {errs[name]:.3g}", flush=True)
        check(bool(torch.isfinite(want).all())
              and errs[name] <= RESNET_EVAL_TOL,
              f"{name} logits card vs CPU: {errs[name]}")
        del card, cpu
        release_memory(torch)
    return errs


def phase_liteseg(torch, segdet, small) -> dict:
    """Phase 19: PP-LiteSeg training, (a) the bench arm graphed, (b)
    interpolate on the card, (c) eval logits card vs CPU, (d) PP-YOLOE and
    small.py's models checked."""
    print("== PP-LiteSeg train: bench_liteseg's arm graphed, interpolate on "
          "the card, eval logits card vs CPU, PP-YOLOE and small.py",
          flush=True)
    arm, model = liteseg_bench_arm(torch, segdet)
    interp = liteseg_interpolate(torch)
    eval_err = liteseg_eval_logits(torch, segdet, model)
    del model
    release_memory(torch)
    others = liteseg_other_models(torch, segdet, small)
    return {"arm": arm, "interpolate": interp, "eval_logits_err": eval_err,
            "others": others}


# phase 20: the training loop. Each epoch is FIT_BATCHES batches of
# LLAMA_BATCH x LLAMA_SEQ tokens; the loss reaches the host every
# FIT_LOG_FREQ steps (a MetricBuffer boundary) and at each epoch's end
FIT_BATCHES, FIT_EPOCHS, FIT_LOG_FREQ = 16, 2, 4
FIT_WORKERS, FIT_PREFETCH = 2, 2
# (b): snapshots every FIT_SNAPSHOT_EVERY steps, SIGTERM raised at the
# boundary of global step FIT_PREEMPT_STEP (epoch 1, its batch 4)
FIT_SNAPSHOT_EVERY, FIT_PREEMPT_STEP = 4, 20
# (a)'s profile: the steps between the boundaries at these batches of
# epoch 1, both synced by their boundary's read
FIT_PROFILE = (8, 12)
# (d): graphed fp16 O1 llama_124m_gqa steps, after the eager and the
# capturing call, from a loss scale under which the first steps apply
FIT_FP16_STEPS, FIT_FP16_INIT_SCALE = 4, 2.0 ** 20


def fit_twin(torch, llama, cfg):
    """llama_124m_gqa (seed 0) in bf16 O2 behind a thin forward wrapper that
    runs it under ``auto_cast(level="O2", dtype="bfloat16")``, as
    ``bench_llama``'s ``loss_fn`` does, ``AdamW(1e-4)`` and the criterion
    (outside ``auto_cast``). Returns (network, optimizer, criterion)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW

    model = llama.LlamaForCausalLM(cfg, generator=torch.Generator()
                                   .manual_seed(0))
    amp.decorate(model, level="O2", dtype="bfloat16")

    class O2Forward(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, ids):
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                return self.inner(ids)

    net = O2Forward(model).train()
    opt = AdamW(learning_rate=1e-4, parameters=net.parameters())
    return net, opt, llama.LlamaPretrainingCriterion(cfg)


def recording_model(hapi):
    """``Model`` that also keeps each train step's loss tensor (a replay's
    clone, on the card, never read during the fit)."""

    class Recording(hapi.Model):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.stream = []

        def train_batch(self, inputs, labels=None, update=True, sync=True):
            out = super().train_batch(inputs, labels, update, sync)
            self.stream.append(out[0])
            return out

    return Recording


def fit_callbacks(torch, hapi):
    """(a)'s callbacks: the boundary clock, the no-sync guard between
    boundaries and the profile window."""
    from torch.profiler import ProfilerActivity, profile

    class Boundaries(hapi.Callback):
        """perf_counter at each boundary step's end (its loss read has
        synced the card), by epoch."""

        def __init__(self):
            super().__init__()
            self.stamps = {}
            self.epochs = []

        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch
            self.epochs.append(time.perf_counter())

        def on_epoch_end(self, epoch, logs=None):
            self.epochs[-1] = time.perf_counter() - self.epochs[-1]

        def on_train_batch_end(self, step, logs=None):
            if step % FIT_LOG_FREQ == 0:
                self.stamps.setdefault(self.epoch, []).append(
                    (step, time.perf_counter()))

    class NoSyncBetween(hapi.Callback):
        """``set_sync_debug_mode("error")`` over each step that is not a
        boundary, from the third step on (the first is eager, the second
        captures): a host sync there raises."""

        def __init__(self):
            super().__init__()
            self.seen = self.guarded = 0

        def on_train_batch_begin(self, step, logs=None):
            if self.seen >= 2 and step % FIT_LOG_FREQ:
                torch.cuda.set_sync_debug_mode("error")
                self.guarded += 1

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.set_sync_debug_mode(0)
            self.seen += 1

    class Window(hapi.Callback):
        """torch.profiler over epoch 1's steps between the boundaries at
        ``FIT_PROFILE``, with the host clock around them."""

        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch

        def on_train_batch_end(self, step, logs=None):
            if self.epoch != 1:
                return
            if step == FIT_PROFILE[0]:
                t = time.perf_counter()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
                self.overhead = self.t0 - t
            elif step == FIT_PROFILE[1]:
                torch.cuda.synchronize()
                t = time.perf_counter()
                self.seconds = t - self.t0
                self.prof.__exit__(None, None, None)
                self.overhead += time.perf_counter() - t

    return Boundaries(), NoSyncBetween(), Window()


def fit_profile(window) -> dict:
    """The device's busy time, idle share and kernel launches a step over
    the profiled window."""
    from torch.autograd import DeviceType

    steps = FIT_PROFILE[1] - FIT_PROFILE[0]
    rows = [e for e in window.prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    check(len(rows) > 0, "the fit profile recorded no device time")
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    wall_ms = window.seconds * 1e3
    return {"overhead_s": window.overhead,
            "busy_ms_per_step": busy_ms / steps,
            "wall_ms_per_step": wall_ms / steps,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "launches_per_step": sum(e.count for e in rows) / steps}


def fit_counts(fa, rms, adamw) -> tuple:
    return (fa.launches, fa.dq_launches, fa.dkv_launches, rms.launches,
            rms.bwd_launches, adamw.launches)


def zero_counts(fa, rms, adamw) -> None:
    fa.launches = fa.dq_launches = fa.dkv_launches = fa.tma_copies = 0
    rms.launches = rms.bwd_launches = adamw.launches = 0


def fit_arm(torch, llama, hapi, io, cfg, ds, tmp, bare_p50_ms) -> dict:
    """(a): ``Model.fit`` over the Dataset with worker processes and the
    device prefetch; the loss stream and the final parameters against the
    same batches fed straight to a ``TrainStep``."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms
    from paddle_tpu_torch.profiler.pipeline import pipeline_stats

    steps = FIT_EPOCHS * FIT_BATCHES
    net, opt, crit = fit_twin(torch, llama, cfg)
    model = recording_model(hapi)(net)
    model.prepare(opt, crit)
    clock, guard, window = fit_callbacks(torch, hapi)
    torch.cuda.synchronize()
    # the main path's run: counts from 0, read right after it
    zero_counts(fa, rms, adamw)
    pipeline_stats.reset()
    t0 = time.perf_counter()
    model.fit(ds, batch_size=LLAMA_BATCH, epochs=FIT_EPOCHS, shuffle=True,
              num_workers=FIT_WORKERS, device_prefetch=FIT_PREFETCH,
              log_freq=FIT_LOG_FREQ, verbose=0,
              snapshot_dir=os.path.join(tmp, "a"),
              callbacks=[clock, guard, window])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fit_counts(fa, rms, adamw)
    pipe = pipeline_stats.summary()
    check(fa.tma_copies == 0, f"{fa.tma_copies} operands copied for TMA")
    losses = [float(x) for x in model.stream]
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"fit ran {len(losses)} steps of {steps}, losses {losses}")
    stats, report = model._train_step.stats, model._train_step.audit_report()
    print(f"fit: {steps} steps in {wall:.2f} s; TrainStep {stats}, "
          f"{report['total_captures']} capture(s)", flush=True)
    check(stats == {"compiled_steps": steps - 1, "eager_steps": 1}
          and report["total_captures"] == 1,
          f"steps {stats}: not every step after the second a replay")
    # boundaries: FIT_BATCHES / FIT_LOG_FREQ a epoch, and its flush
    boundaries = FIT_EPOCHS * (FIT_BATCHES // FIT_LOG_FREQ + 1)
    print(f"host syncs {pipe['host_syncs']} at {boundaries} boundaries "
          f"(loss reads), none in the {guard.guarded} steps run under "
          f"set_sync_debug_mode('error'); pipeline {pipe}", flush=True)
    check(pipe["host_syncs"] == boundaries,
          f"{pipe['host_syncs']} host syncs, want one a boundary "
          f"({boundaries})")
    guarded = sum(1 for g in range(2, steps)
                  if g % FIT_BATCHES % FIT_LOG_FREQ)
    check(guard.guarded == guarded,
          f"{guard.guarded} steps guarded, want {guarded}")
    # step time: the spans between boundaries after the capture, those
    # in the profiled window left out
    spans = []
    for epoch, stamps in clock.stamps.items():
        for (s0, t_0), (s1, t_1) in zip(stamps, stamps[1:]):
            if s0 == 0 or (epoch == 1 and s0 == FIT_PROFILE[0]):
                continue
            spans.append((t_1 - t_0) / (s1 - s0))
    p50 = float(np.median(spans))
    prof = fit_profile(window)
    # the same batches, in the loader's order, fed straight to a TrainStep
    # built the same way
    ref_net, ref_opt, ref_crit = fit_twin(torch, llama, cfg)
    step = TrainStep(model=ref_net, optimizer=ref_opt,
                     loss_fn=lambda ids, y: ref_crit(ref_net(ids), y))
    rows = ds.tensors[0]
    want = []
    for epoch in range(FIT_EPOCHS):
        order = io.BatchSampler(ds, shuffle=True, batch_size=LLAMA_BATCH)
        order.set_epoch(epoch)
        for idx in order:
            ids = torch.from_numpy(rows[idx]).cuda()
            want.append(step(ids, ids))
    want = [float(x) for x in want]
    params = [p.detach() for p in net.parameters()]
    check_against_eager(torch, "fit vs TrainStep", losses, params,
                        (want, [p.detach() for p in ref_net.parameters()]))
    del step, ref_net, ref_opt
    release_memory(torch)
    tokens = LLAMA_BATCH * LLAMA_SEQ
    per_step = [c / steps for c in counts]
    print(f"fit: step p50 {p50 * 1e3:.3f} ms over {len(spans)} boundary "
          f"spans (phase 12's bare TrainStep step p50 "
          f"{bare_p50_ms:.3f} ms); tokens/s {tokens / p50:.1f}; "
          f"launches a step K1/K2/K3/K4/K4-bwd/AdamW "
          f"{[round(x, 2) for x in per_step]}; profile of "
          f"{FIT_PROFILE[1] - FIT_PROFILE[0]} fit steps: "
          f"device busy {prof['busy_ms_per_step']:.3f} ms of "
          f"{prof['wall_ms_per_step']:.3f} ms a step, idle "
          f"{prof['idle_share']:.1%}, {prof['launches_per_step']:.0f} "
          f"device events a step; loader {pipe['h2d_wait_us'] / 1e3:.3f} "
          f"ms waited and {pipe['h2d_issue_us'] / 1e3:.3f} ms issued a "
          f"step; fit wall {wall:.2f} s for {steps} steps, of which "
          f"{prof['overhead_s']:.2f} s starting and stopping the profiler "
          f"and {pipe['dispatch_us'] * steps / 1e6:.2f} s in train_batch "
          f"(the eager step and the capture included); epochs "
          f"{[round(t, 2) for t in clock.epochs]} s", flush=True)
    losses_ok = losses[-1] < losses[0]
    check(losses_ok, f"the fit's loss did not fall: {losses}")
    return {"model": model, "net": net, "opt": opt, "crit": crit,
            "losses": losses, "params": params, "counts": counts,
            "p50_ms": p50 * 1e3, "profile": prof, "pipeline": pipe}


def fit_preempt(torch, llama, hapi, reliability, cfg, ds, tmp, arm) -> dict:
    """(b): the same fit with snapshots, SIGTERM at a step's boundary, then
    a fresh model resumed from the snapshot: losses and final parameters
    bit for bit (a)'s."""
    import signal

    from paddle_tpu_torch.jit.api import model_generators

    snap_dir = os.path.join(tmp, "b")
    Recording = recording_model(hapi)
    net, opt, crit = fit_twin(torch, llama, cfg)
    model = Recording(net)
    model.prepare(opt, crit)

    class Preempt(hapi.Callback):
        def __init__(self):
            super().__init__()
            self.n = 0

        def on_train_batch_end(self, step, logs=None):
            self.n += 1
            if self.n == FIT_PREEMPT_STEP:
                signal.raise_signal(signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    model.fit(ds, batch_size=LLAMA_BATCH, epochs=FIT_EPOCHS, shuffle=True,
              num_workers=FIT_WORKERS, device_prefetch=FIT_PREFETCH,
              log_freq=FIT_LOG_FREQ, verbose=0, snapshot_dir=snap_dir,
              snapshot_every=FIT_SNAPSHOT_EVERY, callbacks=[Preempt()])
    first = [float(x) for x in model.stream]
    snaps = reliability.TrainSnapshotter(snap_dir).snapshots()
    check(len(first) == FIT_PREEMPT_STEP and model.stop_training
          and signal.getsignal(signal.SIGTERM) == prev,
          f"the preempted fit ran {len(first)} steps")
    check([s for s, _ in snaps] == [FIT_PREEMPT_STEP - FIT_SNAPSHOT_EVERY,
                                    FIT_PREEMPT_STEP],
          f"snapshots {snaps}")
    del model, net, opt
    release_memory(torch)
    net, opt, crit = fit_twin(torch, llama, cfg)
    model = Recording(net)
    model.prepare(opt, crit)
    model.fit(ds, batch_size=LLAMA_BATCH, epochs=FIT_EPOCHS, shuffle=True,
              num_workers=FIT_WORKERS, device_prefetch=FIT_PREFETCH,
              log_freq=FIT_LOG_FREQ, verbose=0, snapshot_dir=snap_dir,
              resume=True)
    rest = [float(x) for x in model.stream]
    print(f"preempted at step {FIT_PREEMPT_STEP} (snapshots "
          f"{[s for s, _ in snaps]}), resumed {len(rest)} steps", flush=True)
    check_against_eager(torch, "SIGTERM + resume vs uninterrupted",
                        first + rest, [p.detach() for p in net.parameters()],
                        (arm["losses"], arm["params"]))
    # one snapshot of the resumed model, timed
    snap = reliability.TrainSnapshotter(os.path.join(tmp, "timed"), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = snap.save(net, opt, step=FIT_EPOCHS * FIT_BATCHES,
                     epoch=FIT_EPOCHS, generators=model_generators(net))
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for root, _, files in os.walk(path) for f in files)
    print(f"snapshot: {nbytes} bytes ({nbytes / 2**20:.1f} MiB: parameters, "
          f"optimizer, generators, cursor), saved in {save_ms:.1f} ms with "
          f"fsync and the atomic rename", flush=True)
    del model, net, opt
    release_memory(torch)
    return {"bytes": nbytes, "save_ms": save_ms}


def fit_evaluate(torch, hapi, metric, io, arm, rows) -> None:
    """(c): ``evaluate`` with next-token top-1 ``Accuracy`` and ``predict``
    against the plain forward over the same batches."""

    class NextTokenAccuracy(metric.Accuracy):
        """Top-1 of the logits at position i against token i + 1."""

        def compute(self, pred, label, *args):
            v = pred.shape[-1]
            return super().compute(pred[:, :-1].reshape(-1, v),
                                   label[:, 1:].reshape(-1))

    model, net, crit = arm["model"], arm["net"], arm["crit"]
    model.prepare(arm["opt"], crit, metrics=NextTokenAccuracy())
    n_eval = 2 * LLAMA_BATCH
    logs = model.evaluate(io.TensorDataset([rows[:n_eval], rows[:n_eval]]),
                          batch_size=LLAMA_BATCH, verbose=0)
    losses, correct, total = [], 0, 0
    net.eval()
    with torch.no_grad():
        for b0 in range(0, n_eval, LLAMA_BATCH):
            ids = torch.from_numpy(rows[b0:b0 + LLAMA_BATCH]).cuda()
            logits = net(ids)
            losses.append(float(crit(logits, ids)))
            v = logits.shape[-1]
            top = torch.topk(logits[:, :-1].reshape(-1, v), 1,
                             dim=-1).indices[:, 0]
            correct += int((top == ids[:, 1:].reshape(-1)).sum())
            total += top.numel()
    want_loss = float(np.mean(losses))
    print(f"evaluate over {n_eval // LLAMA_BATCH} batches: {logs}; plain "
          f"forward loss {want_loss}, next-token top-1 {correct}/{total}",
          flush=True)
    check(logs["loss"] == want_loss, f"evaluate loss {logs['loss']} != "
          f"{want_loss}")
    check(abs(logs["acc"] * total - correct) < 0.5,
          f"evaluate accuracy {logs['acc']} != {correct}/{total}")
    outs = model.predict(io.TensorDataset([rows[:LLAMA_BATCH]]),
                         batch_size=LLAMA_BATCH)
    with torch.no_grad():
        want = net(torch.from_numpy(rows[:LLAMA_BATCH]).cuda()).float()
    got = outs[0][0]
    print(f"predict: {len(outs[0])} batch, logits {got.shape} {got.dtype}",
          flush=True)
    check(got.shape == (LLAMA_BATCH, LLAMA_SEQ, want.shape[-1])
          and np.array_equal(got, want.cpu().numpy()),
          f"predict's logits {got.shape} differ from the plain forward's")
    net.train()


def fit_h2d_fault(torch, reliability, io, arm, rows) -> None:
    """(e): a fault in the DeviceLoader's thread reaches ``fit``."""
    batch = torch.from_numpy(rows[:LLAMA_BATCH])
    reliability.arm(reliability.FaultInjector(seed=0).plan("io.h2d",
                                                           rate=1.0))
    t0 = time.perf_counter()
    try:
        arm["model"].fit(io.DeviceLoader([(batch, batch)] * 6, depth=2),
                         epochs=1, verbose=0, sync_every=1)
        raised = None
    except reliability.FaultInjection as e:
        raised = e
    finally:
        reliability.disarm()
    seconds = time.perf_counter() - t0
    print(f"io.h2d fault in the prefetch thread: fit raised "
          f"{type(raised).__name__}: {raised} after {seconds:.3f} s",
          flush=True)
    check(raised is not None and seconds < 30.0,
          "the io.h2d fault did not reach fit as an exception")


def fit_fp16_llama(torch, llama) -> dict:
    """(d): llama_124m_gqa (f32 parameters) under ``auto_cast(level="O1",
    dtype="float16")`` with a GradScaler, eager steps and the same step
    function captured by ``CompiledFunction``, bit for bit; fp16 K1-K4
    and K4's backward counted through the replays."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit.api import _cuda_generators
    from paddle_tpu_torch.jit.functionalize import CompiledFunction
    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama.llama_124m_gqa()
    ids = torch.from_numpy(np.random.RandomState(21).randint(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ)).astype(np.int64)).cuda()
    steps = GRAPH_WARMUP + FIT_FP16_STEPS

    def twin():
        model = llama.LlamaForCausalLM(cfg, generator=torch.Generator()
                                       .manual_seed(0)).train()
        crit = llama.LlamaPretrainingCriterion(cfg)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        scaler = amp.GradScaler(init_loss_scaling=FIT_FP16_INIT_SCALE,
                                incr_every_n_steps=2,
                                decr_every_n_nan_or_inf=1)

        def step_fn(x):
            with amp.auto_cast(level="O1", dtype="float16"):
                loss = crit(model(x), x)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            return loss.detach()

        return model, scaler, step_fn

    model, scaler, step_fn = twin()
    want, scales = [], []
    for _ in range(steps):
        want.append(float(step_fn(ids)))
        scales.append(float(scaler._scale))
    check(len(set(want)) > 1, f"every fp16 step was skipped: losses {want}, "
          f"scales {scales}")
    want_scales = scales[-1]
    want_params = [p.detach().clone() for p in model.parameters()]
    del model, scaler, step_fn
    release_memory(torch)
    model, scaler, step_fn = twin()
    compiled = CompiledFunction(step_fn, name="fp16_llama_step",
                                device="cuda",
                                generators=_cuda_generators(model))
    got = [float(compiled(ids)) for _ in range(GRAPH_WARMUP)]
    torch.cuda.synchronize()
    # the path's run: counts from 0, read right after it
    zero_counts(fa, rms, adamw)
    got += [float(compiled(ids)) for _ in range(FIT_FP16_STEPS)]
    counts = fit_counts(fa, rms, adamw)
    check(compiled.stats == {"compiled_steps": steps - 1, "eager_steps": 1},
          f"fp16 steps {compiled.stats}")
    check(float(scaler._scale) == want_scales, "graphed scale differs")
    check_against_eager(torch, "fp16 O1 llama_124m_gqa", got,
                        [p.detach() for p in model.parameters()],
                        (want, want_params))
    n = cfg.num_hidden_layers
    calls = (2 * n + 1) * FIT_FP16_STEPS
    check(counts[:5] == (n * FIT_FP16_STEPS,) * 3
          + (calls, calls * rms.BWD_LAUNCHES_PER_CALL),
          f"fp16 launches K1/K2/K3/K4/K4-bwd/AdamW {counts}")
    print(f"fp16 O1 llama_124m_gqa: losses {got}; scale after each step "
          f"{scales}; launches over "
          f"{FIT_FP16_STEPS} replays K1/K2/K3/K4/K4-bwd/AdamW {counts}",
          flush=True)
    del model, scaler, step_fn, compiled, want_params
    release_memory(torch)
    return {"fwd": counts[0], "dq": counts[1], "dkv": counts[2],
            "rms_norm": counts[3], "rms_norm_bwd": counts[4],
            "adamw": counts[5]}


def fit_fp16_kernels(torch) -> dict:
    """(d): fp16 K4 and its backward against their plain versions at
    8192 x 768, timed beside F.rms_norm in fp16 and their bounds."""
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    rows, d = RMS_SHAPES[0]
    rs = np.random.RandomState(22)
    dev = torch.device("cuda")
    x = torch.from_numpy(rs.randn(rows, d).astype(np.float32) * 3).to(
        dev, torch.float16)
    w = torch.from_numpy(rs.uniform(0.5, 1.5, d).astype(np.float32)).to(
        dev, torch.float16)
    g = torch.from_numpy(rs.randn(rows, d).astype(np.float32)).to(
        dev, torch.float16)
    err = compare_rms_norm(torch, rms, x, w, "float16")
    berrs = compare_rms_norm_bwd(torch, rms, x, w, g, "float16")
    text, fwd_rec, bwd_rec = rms_norm_timed(torch, rms, x, w, g, "float16",
                                            err, berrs)
    print(f"fp16 K4 rows={rows} d={d} err {err:.2e}; backward err dx "
          f"{berrs['dx']:.2e} dw {berrs['dw']:.2e}, two calls bitwise "
          f"equal" + text, flush=True)
    return {"rms_norm": fwd_rec, "rms_norm_bwd": bwd_rec}


def phase_fit(torch, llama, bare_p50_ms) -> dict:
    """The training loop on llama_124m_gqa: (a) fit, (b) SIGTERM and
    resume, (c) evaluate and predict, (d) fp16, (e) the io.h2d fault.
    Returns the launches and the fp16 records."""
    from paddle_tpu_torch import hapi, io, metric, reliability

    cfg = llama.llama_124m_gqa()
    print(f"== fit Llama: Model.fit on llama_124m_gqa bf16 O2 (AdamW(1e-4), "
          f"LlamaPretrainingCriterion), a Dataset of {FIT_BATCHES} batches "
          f"of {LLAMA_BATCH}x{LLAMA_SEQ} tokens, {FIT_EPOCHS} epochs, "
          f"shuffled, {FIT_WORKERS} worker processes, device_prefetch="
          f"{FIT_PREFETCH}, log_freq={FIT_LOG_FREQ}", flush=True)
    rows = np.random.RandomState(20).randint(
        0, cfg.vocab_size, (FIT_BATCHES * LLAMA_BATCH, LLAMA_SEQ)).astype(
        np.int64)
    ds = io.TensorDataset([rows, rows])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        print("-- (a) fit", flush=True)
        arm = fit_arm(torch, llama, hapi, io, cfg, ds, tmp, bare_p50_ms)
        print("-- (b) SIGTERM at a step boundary, then resume", flush=True)
        snap = fit_preempt(torch, llama, hapi, reliability, cfg, ds, tmp,
                           arm)
        print("-- (c) evaluate and predict", flush=True)
        fit_evaluate(torch, hapi, metric, io, arm, rows)
        print("-- (e) an io.h2d fault in the prefetch thread", flush=True)
        fit_h2d_fault(torch, reliability, io, arm, rows)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = arm["counts"]
    del arm
    release_memory(torch)
    print("-- (d) fp16: K4 and its backward, O1 steps, K5-K7 at the "
          "FlashMask path", flush=True)
    records = fit_fp16_kernels(torch)
    fp16_llama = fit_fp16_llama(torch, llama)
    fm16 = phase_flashmask_path(torch, dtypes=("float16",))
    return {"launches": dict(zip(("fwd", "dq", "dkv", "rms_norm",
                                  "rms_norm_bwd", "adamw"), counts)),
            "fp16_llama": fp16_llama, "rms16": records, "fm16": fm16,
            "snapshot": snap}


# ---------------------------------------------------------------- phase 21
# bench.py's five training arms, read as text and run on the port with only
# their imports renamed
BENCH_ARMS = ("bench_gpt", "bench_llama", "bench_bert", "bench_resnet",
              "bench_liteseg")
BENCH_ARM_END = "dt = time.perf_counter() - t0"
BENCH_HELPERS = ("_sync", "_gpt_flops_per_step")
_PADDLE_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)paddle_tpu(?=[\s.])")


def bench_text() -> str:
    """``bench.py`` beside this script, as text: it is never imported
    (it imports the JAX package)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bench.py")
    with open(path) as f:
        return f.read()


def bench_arm_source(name: str, text: str) -> tuple:
    """``bench.py``'s lines of the arm ``name`` from its ``def`` through
    ``BENCH_ARM_END``, and the same lines with each import statement's
    ``paddle_tpu`` renamed ``paddle_tpu_torch``; nothing else changes."""
    import ast

    fn = next(node for node in ast.parse(text).body
              if isinstance(node, ast.FunctionDef) and node.name == name)
    lines = text.splitlines()[fn.lineno - 1:fn.end_lineno]
    end = next(i for i, line in enumerate(lines)
               if line.strip() == BENCH_ARM_END)
    original = lines[:end + 1]
    return ("\n".join(original),
            "\n".join(_PADDLE_IMPORT.sub(r"\1paddle_tpu_torch", line)
                      for line in original))


def bench_namespace(text: str) -> dict:
    """A namespace with ``os``, ``time`` and ``bench.py``'s own
    ``_sync`` and ``_gpt_flops_per_step``, copied from its text."""
    import ast

    ns = {"os": os, "time": time}
    lines = text.splitlines()
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name in BENCH_HELPERS:
            exec("\n".join(lines[node.lineno - 1:node.end_lineno]), ns)
    return ns


class recorded_steps:
    """Inside the block, every ``jit.TrainStep`` call's loss is kept, in
    order, in ``losses``: the tensor the call returned (no host read, no
    launch)."""

    def __enter__(self):
        from paddle_tpu_torch.jit import api

        self.losses = []
        self._api, self._call = api, api.TrainStep.__call__
        losses, call = self.losses, self._call

        def record(step, *batch):
            out = call(step, *batch)
            losses.append(out)
            return out

        api.TrainStep.__call__ = record
        return self

    def __exit__(self, *exc):
        self._api.TrainStep.__call__ = self._call
        return False


def run_bench_arm(name: str, on_tpu: bool, text: str = None) -> tuple:
    """Run ``bench.py``'s arm ``name`` up to its timing's end on the
    port (imports renamed, nothing else): returns the arm's locals (its
    ``model``, ``step``, ``loss``, ``dt``, ...) and every step's loss."""
    text = bench_text() if text is None else text
    _, source = bench_arm_source(name, text)
    ns = bench_namespace(text)
    exec(compile(source + "\n    return locals()\n", f"bench.py:{name}",
                 "exec"), ns)
    with recorded_steps() as rec:
        local = ns[name](on_tpu)
    return local, rec.losses


def arm_counters() -> dict:
    """The launch counters of every kernel a training arm reaches."""
    from paddle_tpu_torch.ops.cuda import adamw, momentum
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    return {"fwd": fa.launches, "dq": fa.dq_launches,
            "dkv": fa.dkv_launches, "rms_norm": rms.launches,
            "rms_norm_bwd": rms.bwd_launches, "adamw": adamw.launches,
            "momentum": momentum.launches, "tma_copies": fa.tma_copies}


def zero_arm_counters() -> None:
    from paddle_tpu_torch.ops.cuda import adamw, momentum
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    fa.launches = fa.dq_launches = fa.dkv_launches = fa.tma_copies = 0
    rms.launches = rms.bwd_launches = adamw.launches = momentum.launches = 0


def arm_batch(local: dict) -> tuple:
    """The arm's batch as its step takes it."""
    if "ids" in local and "labels" in local:
        return (local["ids"], local["labels"])
    if "ids" in local:
        return (local["ids"],)
    return (local["x"], local["y"])


def hand_built_arm(torch, key, steps, batch):
    """The arm ``key``'s step as phases 9, 12 and 17–19 build it by hand
    (weights from a generator seeded 0, bf16 O2, the arm's optimizer and
    loss outside ``auto_cast``), run ``steps`` steps on ``batch``: returns
    the step, its losses and its parameters."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import bert, gpt, llama
    from paddle_tpu_torch.vision.models import resnet, segdet

    if key in ("gpt", "llama"):
        model_cls, crit_cls, cfg = (
            (gpt.GPTForCausalLM, gpt.GPTPretrainingCriterion,
             gpt.gpt2_small(hidden_dropout_prob=0.0,
                            attention_dropout_prob=0.0))
            if key == "gpt" else
            (llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion,
             llama.llama_124m_gqa()))
        model, step, _ = build_train_step(torch, model_cls, crit_cls, cfg)
    else:
        model, opt, loss_fn = {
            "bert": lambda: bert_twin(torch, bert, bert.ernie_base(
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
                masked=False),
            "resnet": lambda: resnet_twin(torch, resnet),
            "liteseg": lambda: liteseg_twin(torch, segdet)}[key]()
        step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    losses = [step(*batch) for _ in range(steps)]
    torch.cuda.synchronize()
    return step, losses, [p.detach() for p in model.parameters()]


ARM_KEYS = {"bench_gpt": "gpt", "bench_llama": "llama", "bench_bert": "bert",
            "bench_resnet": "resnet", "bench_liteseg": "liteseg"}


def phase_bench_arms(torch, hand: dict) -> dict:
    """Phase 21: each of ``bench.py``'s five training arms, read as text
    with only its imports renamed, run at full width on the card after
    ``paddle.set_device("gpu")``: its first step, then its own timed steps.
    Each is held to the hand-built ``TrainStep`` of its phase: GPT's and
    Llama's last loss and every parameter bit for bit that step's after as
    many steps (``hand_built_arm``); BERT's, ResNet-50's and PP-LiteSeg's
    first loss bit for bit the first loss phases 17–19 recorded; a profiled
    replayed step's launches equal to the launches of that phase's profiled
    step. ``hand`` holds each phase's record (phases 9, 12 and 17–19 (a));
    for an arm without one (phase 21 run alone) the hand-built step is
    built, run and profiled here. The launch counts are set to 0 just
    before each arm and read just after it. Returns the five arms' launches
    by kernel."""
    import paddle_tpu_torch as paddle

    t_phase = time.perf_counter()
    paddle.set_device("gpu")
    text = bench_text()
    for name in BENCH_ARMS:
        original, renamed = bench_arm_source(name, text)
        changed = [(a, b) for a, b in zip(original.splitlines(),
                                          renamed.splitlines()) if a != b]
        check(changed and all(_PADDLE_IMPORT.match(a) for a, _ in changed),
              f"{name}: the arm differs from bench.py beyond its imports")
    totals = {}
    print("== bench arms: bench.py's five training arms on the port, read "
          "as text, imports renamed paddle_tpu -> paddle_tpu_torch, "
          "on_tpu=True, set_device('gpu')", flush=True)
    for name in BENCH_ARMS:
        key = ARM_KEYS[name]
        t_arm = time.perf_counter()
        release_memory(torch)
        zero_arm_counters()
        local, losses = run_bench_arm(name, True, text)
        torch.cuda.synchronize()
        counts = arm_counters()
        check(counts.pop("tma_copies") == 0, f"{name}: operands copied for "
              f"TMA")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        steps, dt, step = local["steps"], local["dt"], local["step"]
        batch = tuple(t.as_subclass(torch.Tensor) for t in arm_batch(local))
        check(len(losses) == steps + 1, f"{name}: {len(losses)} steps ran, "
              f"want {steps + 1}")
        values = [float(x) for x in losses]
        check(all(math.isfinite(v) for v in values), f"{name}: non-finite "
              f"loss {values}")
        check(type(local["loss"]) is paddle.Tensor, f"{name}: the step "
              f"returned {type(local['loss'])}, not a paddle.Tensor")
        stats = dict(step.stats)
        check(stats == {"compiled_steps": steps, "eager_steps": 1},
              f"{name}: steps {stats}: not every step after the first ran "
              f"as a replay")
        units = ((local["batch"] * local["seq"], "tokens") if "seq" in local
                 else (local["batch"], "images"))
        rate, arm_ms = units[0] * steps / dt, dt / steps * 1e3
        lm = key in ("gpt", "llama")
        # the state after the arm's own steps, before the profile's
        params = ([p.detach().clone() for p in local["model"].parameters()]
                  if lm else [])
        last = local["loss"].as_subclass(torch.Tensor).clone()
        prof = profile_steps(torch, step, batch, arm_ms)
        del local, step, losses
        release_memory(torch)
        rec = hand.get(key)
        if lm or rec is None:
            hand_step, hand_losses, hand_params = hand_built_arm(
                torch, key, steps + 1 if lm else GRAPH_WARMUP + 1, batch)
            first = float(hand_losses[0])
        if lm:
            same = sum(torch.equal(a, b) for a, b in zip(params,
                                                          hand_params))
            print(f"{name}: last loss {float(last)!r}, hand-built "
                  f"{float(hand_losses[-1])!r}, bitwise equal "
                  f"{torch.equal(last, hand_losses[-1])}; parameters bitwise "
                  f"equal {same}/{len(hand_params)}", flush=True)
            check(torch.equal(last, hand_losses[-1]) and same == len(
                hand_params) and len(params) == len(hand_params),
                f"{name}: the arm's steps differ from the hand-built ones")
        else:
            first = rec["first_loss"] if rec is not None else first
            print(f"{name}: first loss {values[0]!r}, the hand-built step's "
                  f"{first!r}" + (" (its phase's record)" if rec else ""),
                  flush=True)
            check(values[0] == first, f"{name}: the arm's first loss "
                  f"differs from the hand-built step's")
        if rec is not None:
            want = rec["launches_per_step" if lm else "launches"]
        else:
            want = profile_steps(torch, hand_step, batch, arm_ms)["launches"]
        print(f"{name}: launches per replayed step {prof['launches']:.0f}, "
              f"the hand-built step's {want:.0f}; kernel launches over the "
              f"arm's {steps + 1} steps {counts}", flush=True)
        check(prof["launches"] == want, f"{name}: a replayed step launches "
              f"{prof['launches']}, the hand-built one {want}")
        p50 = rec["p50_ms"] if rec is not None else None
        print(f"{name}: {rate:.1f} {units[1]}/s from the arm's own timing "
              f"({steps} steps in {dt:.4f} s, {arm_ms:.3f} ms a step, the "
              f"capture among them); the hand-built phase's p50 "
              + (f"{p50:.3f} ms, {units[0] / p50 * 1e3:.1f} {units[1]}/s"
                 if p50 else "not measured in this run")
              + f"; the arm's checks took {time.perf_counter() - t_arm:.1f} s",
              flush=True)
        hand_step = hand_losses = hand_params = params = batch = None
        release_memory(torch)
    print(f"bench arms: phase 21 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return totals


# Transformer-base (Vaswani et al. 2017, Table 3 "base": N = 6, d_model 512,
# d_ff 2048, h 8, P_drop 0.1, eps_ls 0.1), a shared vocabulary of 37,000
# tokens (§5.1) and 16 x 256 tokens a side (about one GPU's share of §5.1's
# 25,000 source tokens over 8 GPUs)
TB_VOCAB, TB_BATCH, TB_SEQ = 37000, 16, 256
TB_LAYERS, TB_MODEL, TB_HEADS, TB_FFN = 6, 512, 8, 2048
TB_DROPOUT, TB_SMOOTHING, TB_WARMUP = 0.1, 0.1, 4000
TB_DECODE = 8  # greedy tokens decoded incrementally in (d)
# (d)'s f32 gate on each cached step's decoder output against the full
# decoder's at its position: TOL's f32 O gate, the TF32-free GEMMs and K1's
# 3xTF32 products each far inside it over 6 layers
DECODE_TOL = 1e-4


def transformer_base(paddle, vocab=TB_VOCAB, d_model=TB_MODEL,
                     nhead=TB_HEADS, layers=TB_LAYERS, d_ff=TB_FFN,
                     dropout=TB_DROPOUT, max_len=TB_SEQ,
                     smoothing=TB_SMOOTHING, amp=True, seed=0):
    """A user-written Transformer-base in Paddle idiom, built by the
    ``paddle`` module it is given (``paddle_tpu_torch`` here; the CPU test
    gives the JAX package the same text): one ``nn.Embedding`` shared by
    source, target and the pre-softmax projection (scaled by sqrt(d_model)
    on the way in, Vaswani et al. §3.4), a sinusoidal position table as a
    non-persistable buffer, ``nn.Transformer``, the causal target mask,
    the label-smoothed cross entropy computed outside ``auto_cast``, Adam
    (beta2 0.98, eps 1e-9) under ``NoamDecay(d_model, 4000)`` (§5.3), the
    model in bf16 O2 when ``amp``. Returns (model, optimizer, scheduler,
    loss_fn(src, tgt, label))."""
    nn = paddle.nn
    F = paddle.nn.functional
    paddle.seed(seed)

    class TransformerBase(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(
                vocab, d_model, padding_idx=0,
                weight_attr=nn.ParamAttr(
                    initializer=nn.initializer.Normal(0.0, d_model ** -0.5)))
            pos = np.arange(max_len, dtype=np.float64)[:, None]
            rate = np.power(10000.0, -np.arange(0, d_model, 2) / d_model)
            table = np.zeros((max_len, d_model), np.float32)
            table[:, 0::2] = np.sin(pos * rate)
            table[:, 1::2] = np.cos(pos * rate)
            self.register_buffer("position_table", paddle.to_tensor(table),
                                 persistable=False)
            self.dropout = nn.Dropout(dropout)
            self.transformer = nn.Transformer(
                d_model=d_model, nhead=nhead, num_encoder_layers=layers,
                num_decoder_layers=layers, dim_feedforward=d_ff,
                dropout=dropout)
            self.tgt_mask = self.transformer.generate_square_subsequent_mask(
                max_len)

        def embed(self, ids, start=0):
            x = self.embedding(ids) * d_model ** 0.5
            return self.dropout(
                x + self.position_table[start:start + ids.shape[1]])

        def forward(self, src, tgt):
            t = tgt.shape[1]
            out = self.transformer(self.embed(src), self.embed(tgt),
                                   tgt_mask=self.tgt_mask[:t, :t])
            return paddle.matmul(out, self.embedding.weight, transpose_y=True)

    model = TransformerBase()
    if amp:
        paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    scheduler = paddle.optimizer.lr.NoamDecay(d_model, TB_WARMUP)
    opt = paddle.optimizer.Adam(learning_rate=scheduler, beta1=0.9,
                                beta2=0.98, epsilon=1e-9,
                                parameters=model.parameters())

    def loss_fn(src, tgt, label):
        if amp:
            with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
                logits = model(src, tgt)
        else:
            logits = model(src, tgt)
        soft = F.label_smooth(F.one_hot(label, vocab), epsilon=smoothing)
        return F.cross_entropy(logits, soft, soft_label=True)

    return model, opt, scheduler, loss_fn


def transformer_batch(torch, vocab, batch, seq, seed=0) -> tuple:
    """(src, tgt, label) ids in [1, vocab) from ``RandomState(seed)``: the
    target read shifted by one (teacher forcing), on the card."""
    rs = np.random.RandomState(seed)
    src = rs.randint(1, vocab, (batch, seq)).astype(np.int64)
    full = rs.randint(1, vocab, (batch, seq + 1)).astype(np.int64)
    return tuple(torch.from_numpy(a).cuda()
                 for a in (src, full[:, :-1], full[:, 1:]))


class _SchedulerStepped:
    """A ``TrainStep`` whose scheduler steps after each call, as the
    recipe's loop steps it; ``stats`` and ``audit_report`` are the
    step's."""

    def __init__(self, step, scheduler):
        self.step, self.scheduler = step, scheduler

    def __call__(self, *batch):
        out = self.step(*batch)
        self.scheduler.step()
        return out

    @property
    def stats(self):
        return self.step.stats

    def audit_report(self):
        return self.step.audit_report()


def transformer_eager(torch, paddle, batch, steps) -> tuple:
    """``steps`` eager steps by hand of the recipe (loss, backward, step,
    clear_grad, scheduler step): the losses and every parameter after
    them."""
    model, opt, scheduler, loss_fn = transformer_base(paddle)
    losses = []
    for _ in range(steps):
        loss = loss_fn(*batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        scheduler.step()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    out = (losses, [p.detach().clone() for p in model.parameters()])
    del model, opt, loss_fn
    release_memory(torch)
    return out


# each kernel name's class in a replayed Transformer-base step, first match
# wins; the masked composition's two products fall among the GEMMs and its
# softmax among the softmaxes: (c) also times it alone
TRANSFORMER_CLASSES_RX = (
    ("K1-K3", ATTENTION_KERNELS),
    ("AdamW", PROFILED_KERNELS["AdamW"]),
    ("GEMM", re.compile(r"nvjet|gemm|cutlass|sm90_xmma")),
    ("softmax and loss", re.compile(r"softmax|nll|cross_entropy")),
    ("element-wise and the rest", re.compile(r"")),
)


def transformer_classes(torch, step, batch, p50_ms) -> dict:
    """Device ms a replayed step by kernel class: the profile of
    ``profile_steps`` (launches held to the counters), its rows classed by
    ``TRANSFORMER_CLASSES_RX``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile_steps(torch, step, batch, p50_ms)
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        step(*batch)
        torch.cuda.synchronize()
    classes = {name: 0.0 for name, _ in TRANSFORMER_CLASSES_RX}
    for e in trace.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        name = next(n for n, rx in TRANSFORMER_CLASSES_RX if rx.search(e.key))
        classes[name] += e.self_device_time_total / 1e3
    total = sum(classes.values())
    print("device ms of one replayed step by class: " + "; ".join(
        f"{n} {ms:.3f} ({ms / total:.1%})" for n, ms in classes.items())
        + f"; total {total:.3f}", flush=True)
    return {"profile": prof, "classes": classes}


def transformer_parts_ms(torch, batch) -> dict:
    """The masked composition (decoder self-attention, forward and
    backward, 6 layers' worth) and the 37,000-way label-smoothed loss
    (forward and backward) each timed alone at the path's shapes by CUDA
    events, in bf16 as the O2 step runs them."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.nn.functional.attention import _xla_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (TB_BATCH, TB_SEQ, TB_HEADS, TB_MODEL // TB_HEADS)
    q, k, v = (torch.randn(shape, device=dev, dtype=torch.bfloat16,
                           generator=gen).requires_grad_(True)
               for _ in range(3))
    mask = torch.full((TB_SEQ, TB_SEQ), float("-inf"), device=dev).triu(1)
    bias = mask.to(torch.bfloat16)
    scale = 1.0 / math.sqrt(shape[-1])

    def composition():
        out = _xla_attention(q, k, v, False, scale, bias, TB_DROPOUT, gen)[0]
        out.backward(torch.ones_like(out))

    logits = torch.randn(TB_BATCH, TB_SEQ, TB_VOCAB, device=dev,
                         dtype=torch.bfloat16,
                         generator=gen).requires_grad_(True)
    label = batch[2]

    def loss():
        soft = F.label_smooth(F.one_hot(label, TB_VOCAB),
                              epsilon=TB_SMOOTHING)
        F.cross_entropy(logits, soft, soft_label=True).backward()

    out = {"composition_ms": TB_LAYERS * cuda_time_ms(composition, iters=10),
           "loss_ms": cuda_time_ms(loss, iters=10)}
    print(f"timed alone: the masked composition (fwd+bwd, x{TB_LAYERS} "
          f"layers) {out['composition_ms']:.3f} ms; the label-smoothed "
          f"37,000-way loss (fwd+bwd) {out['loss_ms']:.3f} ms", flush=True)
    return out


def transformer_path_kernels(torch) -> dict:
    """K1–K3 at the path's shape (B=16, S=256, H=8, D=64, bf16, non-causal,
    contiguous q, k and v, dropout 0.1 as trained and 0) against their
    plain versions under ``TOL``/``BWD_TOL``, timed beside their bounds and
    SDPA, no operand copied for TMA. Returns the records by (kernel,
    dropout)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda")
    rs = np.random.RandomState(22)
    seed = torch.tensor([20261018], dtype=torch.int32, device=dev)
    shape = (TB_BATCH, TB_SEQ, TB_HEADS, TB_MODEL // TB_HEADS)
    q, k, v, do = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        dev, torch.bfloat16) for _ in range(4))
    fa.tma_copies = 0
    err_o, err_l, _ = compare_kernel(torch, fa, q, k, v, "bfloat16", False)
    print(f"K1 at the path's shape {shape} bf16 non-causal against TOL: O "
          f"err {err_o:.2e} lse err {err_l:.2e}", flush=True)
    records = {}
    for dropout in (TB_DROPOUT, 0.0):
        errs, equal, _ = compare_backward(torch, fa, q, k, v, do, seed,
                                          "bfloat16", dropout, causal=False)
        t = time_attention(torch, fa, q, k, v, do, seed, "bfloat16", dropout,
                           causal=False)
        print(f"dropout {dropout}: err " + " ".join(
            f"{n} {e:.2e}" for n, e in errs.items()) + "  bitwise equal "
            + " ".join(f"{n} {c}" for n, c in equal.items()) + "\n    "
            + t["line"], flush=True)
        for name, rec in attention_records(t, errs).items():
            records[(name, dropout)] = dict(
                rec, shape=f"B={shape[0]} S={shape[1]} H={shape[2]} "
                f"D={shape[3]} bfloat16 non-causal dropout {dropout}")
    check(fa.tma_copies == 0, f"{fa.tma_copies} operands copied for TMA at "
          f"the Transformer-base shape")
    return records


def transformer_decode(torch, paddle) -> int:
    """(d) Greedy decoding of ``TB_DECODE`` tokens from an f32 twin in eval
    mode: incrementally (``TransformerDecoder.gen_cache``, one token a
    call: K1 over the cached keys) and by the full-sequence decoder under
    the causal mask (the composition) on the same prefix. Each step's
    output must be the full decoder's at its position within
    ``DECODE_TOL`` (a stale, unextended or misordered cache moves it far
    more, whatever the tokens do), and the tokens must agree wherever the
    full decoder's top-2 margin is at least ``NEAR_TIE``. Returns the
    near-ties met."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    model = transformer_base(paddle, amp=False, seed=1)[0].eval()
    src = transformer_batch(torch, TB_VOCAB, 2, TB_SEQ, seed=3)[0]
    weight = model.embedding.weight
    with torch.no_grad():
        memory = model.transformer.encoder(model.embed(src))
        decoder = model.transformer.decoder
        cache = decoder.gen_cache(memory)
        ids = torch.ones(src.shape[0], 1, dtype=torch.int64, device="cuda")
        before = fa.launches
        steps = []
        for t in range(TB_DECODE):
            out, cache = decoder(model.embed(ids[:, -1:], start=t), memory,
                                 cache=cache)
            steps.append(out[:, 0])
            nxt = (out[:, 0] @ weight.t()).argmax(-1, keepdim=True)
            ids = torch.cat([ids, nxt], dim=1)
        launched = fa.launches - before
        full = decoder(model.embed(ids[:, :-1]), memory,
                       tgt_mask=model.tgt_mask[:TB_DECODE, :TB_DECODE])
        logits = full @ weight.t()
        out_err = float((torch.stack(steps, dim=1) - full).abs().max())
    top2 = logits.float().topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])
    agree = logits.argmax(-1) == ids[:, 1:]
    ties = int((~agree & (margin < NEAR_TIE)).sum())
    check(out_err <= DECODE_TOL, f"the incremental decoder's outputs are "
          f"{out_err:.3g} from the full decoder's, over {DECODE_TOL}")
    check(bool((agree | (margin < NEAR_TIE)).all()), "the incremental "
          "decode's tokens differ from the full decoder's")
    check(launched == 2 * TB_LAYERS * TB_DECODE, f"the cached decode "
          f"launched K1 {launched} times, want {2 * TB_LAYERS * TB_DECODE}")
    print(f"(d) incremental greedy decode of {TB_DECODE} tokens x "
          f"{src.shape[0]} rows (K1 {launched} launches) against the full "
          f"decoder: outputs within {out_err:.3g} (gate {DECODE_TOL}), "
          f"{int(agree.sum())}/{agree.numel()} tokens equal, "
          f"near-ties {ties}, least top-2 margin {float(margin.min()):.3g}; "
          f"tokens {ids[:, 1:].tolist()}", flush=True)
    del model, cache, memory
    release_memory(torch)
    return ties


def phase_transformer(torch) -> dict:
    """Phase 22: the user-written Transformer-base of
    :func:`transformer_base` at full width on the card. (a) Built from the
    recipe by ``paddle_tpu_torch``; (b) 12 eager steps by hand as the
    reference, then 2 warmup and 10 timed ``TrainStep`` steps, every one
    after the first a replay, the losses and every parameter bit for bit
    the eager ones (dropout 0.1 in K1-K3's hash, the composition and the
    Dropout layers, all from the registered dropout generator); launches
    12 a step of each of K1-K3 and one AdamW launch per 64 parameters, no
    operand copied for TMA; K1-K3 at the path's shape against their plain
    versions; (c) step p50, target tokens/s, peak memory, the idle share
    and device ms by class from a profile of 2 replayed steps, the masked
    composition and the loss timed alone; (d) the incremental decode.
    Returns the launches and the records."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    t_phase = time.perf_counter()
    paddle.set_device("gpu")
    print(f"== Transformer-base: a user-written nn.Layer around "
          f"nn.Transformer() ({TB_LAYERS}+{TB_LAYERS} x {TB_MODEL}, FFN "
          f"{TB_FFN}, {TB_HEADS} heads, dropout {TB_DROPOUT}), shared "
          f"{TB_VOCAB}-token embedding, label smoothing {TB_SMOOTHING}, "
          f"Adam + NoamDecay, bf16 O2, {TB_BATCH}x{TB_SEQ} tokens a side",
          flush=True)
    batch = transformer_batch(torch, TB_VOCAB, TB_BATCH, TB_SEQ)
    steps = GRAPH_WARMUP + TRAIN_STEPS
    reference = transformer_eager(torch, paddle, batch, steps)
    model, opt, scheduler, loss_fn = transformer_base(paddle)
    n_params = len(model.parameters())
    step = _SchedulerStepped(TrainStep(model=model, optimizer=opt,
                                       loss_fn=loss_fn), scheduler)
    first, losses, times, counts = run_timed_steps(torch, step, batch)
    check_against_eager(torch, "Transformer-base", first + losses,
                        [p.detach() for p in model.parameters()], reference)
    del reference
    p50 = float(np.median(times))
    tokens = TB_BATCH * TB_SEQ
    peak = torch.cuda.max_memory_allocated()
    per_step = adamw_launches_per_step(model)
    want = 2 * TB_LAYERS * TRAIN_STEPS
    print("warmup losses " + " ".join(f"{x:.4f}" for x in first)
          + "; losses " + " ".join(f"{x:.4f}" for x in losses), flush=True)
    print(f"step ms p50 {p50 * 1e3:.3f} (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}); target tokens/s {tokens / p50:.1f}; "
          f"peak memory {peak / 2**30:.2f} GiB (of which each of the "
          f"[{tokens}, {TB_VOCAB}] f32 one-hot, smoothed labels and f32 "
          f"logits takes {tokens * TB_VOCAB * 4 / 2**20:.0f} MiB); "
          f"{n_params} parameters", flush=True)
    print(f"launches K1/K2/K3/K4/AdamW/K4-bwd {counts} over {TRAIN_STEPS} "
          f"steps", flush=True)
    check(all(math.isfinite(x) for x in first + losses), "non-finite loss")
    check(counts == (want, want, want, 0, per_step * TRAIN_STEPS, 0),
          f"launches {counts}, want {want} each of K1-K3 "
          f"({2 * TB_LAYERS} a step) and {per_step * TRAIN_STEPS} of AdamW")
    parts = transformer_classes(torch, step, batch, p50 * 1e3)
    parts.update(transformer_parts_ms(torch, batch))
    prof = parts["profile"]
    print(f"(c) {torch.cuda.get_device_name(0)}: step p50 {p50 * 1e3:.3f} ms, "
          f"{tokens / p50:.1f} target tokens/s, "
          f"{prof['launches']:.0f} launches a step, idle share "
          f"{1 - prof['device_ms'] / (p50 * 1e3):.1%}", flush=True)
    del model, opt, loss_fn, step
    release_memory(torch)
    records = transformer_path_kernels(torch)
    ties = transformer_decode(torch, paddle)
    paddle.set_device("gpu")
    print(f"Transformer-base: phase 22 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"fwd": counts[0], "dq": counts[1], "dkv": counts[2],
            "adamw": counts[4], "records": records, "p50_ms": p50 * 1e3,
            "near_ties": ties}


# phase 23: static mode and the op-interception tier
STATIC_BATCH, STATIC_SEQ = 4, 1024
STATIC_REPLAYS = 10
DEBUG_BATCH, DEBUG_SEQ = 2, 1024
DEBUG_STEPS = 3
# where phase 23 (b) writes its NaN: one element of layer 0's MLP output
# projection
NAN_PARAM, NAN_AT = "llama.layers.0.mlp.down_proj.weight", (3, 5)


def seeded_llama_state(torch, llama, cfg, seed: int) -> dict:
    """A JAX-layout state dict of ``cfg``'s Llama drawn from numpy seed
    ``seed``: matrices normal with std 0.02, RMSNorm weights 1 + N(0, 0.1)."""
    from paddle_tpu_torch.models.gpt import jax_state_dict

    shapes = {k: tuple(v.shape) for k, v in jax_state_dict(
        llama.LlamaForCausalLM(cfg, device="cpu")).items()}
    rs = np.random.RandomState(seed)
    return {k: ((1.0 + 0.1 * rs.standard_normal(s)) if len(s) == 1
                else 0.02 * rs.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def llama_from_state(torch, llama, cfg, state, device="cuda"):
    model = llama.LlamaForCausalLM(cfg, device=device,
                                   generator=torch.Generator().manual_seed(0))
    return llama.load_jax_state(model, state)


def static_llama(torch, llama, state) -> dict:
    """Phase 23 (a): llama_124m_gqa at full width, all layers, f32,
    recorded in static mode and replayed by ``Executor.run``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    cfg = llama.llama_124m_gqa()
    n = cfg.num_hidden_layers
    b, s = STATIC_BATCH, STATIC_SEQ
    print(f"== static Llama: llama_124m_gqa f32 ({n} layers, hidden "
          f"{cfg.hidden_size}, {cfg.num_attention_heads} heads over "
          f"{cfg.num_key_value_heads} KV heads), weights from a seed by "
          f"load_jax_state, recorded under enable_static + program_guard on "
          f"static.data('input_ids', [{b}, {s}], 'int64'), Executor.run "
          f"{GRAPH_WARMUP} warmup + {STATIC_REPLAYS} timed replays",
          flush=True)
    paddle.enable_static()
    try:
        model = llama_from_state(torch, llama, cfg, state).eval()
        main = paddle.static.Program()
        t0 = time.perf_counter()
        with paddle.static.program_guard(main):
            ids = paddle.static.data("input_ids", [b, s], "int64")
            logits = model(ids)
        names = main.op_types()
        k1_nodes = names.count("paddle_tpu_torch::flash_attention_fwd")
        k4_nodes = names.count("paddle_tpu_torch::rms_norm_fwd")
        print(f"recorded {len(names)} ops in {time.perf_counter() - t0:.2f} "
              f"s ({k1_nodes} K1 and {k4_nodes} K4 operators), "
              f"{len(main.constants())} constants; K1/K4 nodes want "
              f"({n}, {2 * n + 1})", flush=True)
        check((k1_nodes, k4_nodes) == (n, 2 * n + 1),
              f"recorded K1/K4 operators {(k1_nodes, k4_nodes)}")
        exe = paddle.static.Executor()
        rs = np.random.RandomState(23)
        feeds = [rs.randint(1, cfg.vocab_size, (b, s)).astype(np.int64)
                 for _ in range(GRAPH_WARMUP + STATIC_REPLAYS)]

        def run(feed):
            return exe.run(main, feed={"input_ids": feed}, fetch_list=[logits],
                           return_numpy=False)[0]

        fa.launches = rms.launches = 0
        for feed in feeds[:GRAPH_WARMUP]:
            run(feed)
        outs, host_ms = [], []
        for feed in feeds[GRAPH_WARMUP:]:
            counts = (fa.launches, rms.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(run(feed))
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            got = (fa.launches - counts[0], rms.launches - counts[1])
            check(got == (n, 2 * n + 1),
                  f"K1/K4 launches of a replay {got}, want "
                  f"({n}, {2 * n + 1})")
        replays = exe.replay_counts()
        check(replays == {"graph": STATIC_REPLAYS + 1, "eager": 1},
              f"replay counts {replays}")
        p50 = float(np.median(host_ms))
        prof = profile_steps(torch, lambda: run(feeds[-1]), (), p50)
        # the replays alone: the warmup runs, the timed replays and
        # profile_steps' warmup and 2 profiled replays
        launches = {"fwd": fa.launches, "rms_norm": rms.launches}
        runs = GRAPH_WARMUP + STATIC_REPLAYS + 3
        check((launches["fwd"], launches["rms_norm"])
              == (runs * n, runs * (2 * n + 1)),
              f"K1/K4 launches over {runs} runs {launches}")
        paddle.disable_static()
        with torch.no_grad():
            same = [torch.equal(out, model(torch.from_numpy(feed).cuda()))
                    for out, feed in zip(outs, feeds[GRAPH_WARMUP:])]
        print(f"{STATIC_REPLAYS} replays on fresh feeds: logits bit for bit "
              f"the eager forward's {sum(same)}/{len(same)}; host ms of a "
              f"replay p50 {p50:.3f} (min {min(host_ms):.3f}, max "
              f"{max(host_ms):.3f}; feed copy in, graph replay, logits "
              f"clone out), device ms {prof['device_ms']:.3f}; replays "
              f"{replays}", flush=True)
        check(all(same), "a replay's logits differ from the eager forward's")
        check(not torch.equal(outs[0], outs[1]),
              "two feeds gave the same logits")

        with tempfile.TemporaryDirectory() as tmp:
            prefix = os.path.join(tmp, "llama_124m_gqa")
            t0 = time.perf_counter()
            paddle.static.save_inference_model(prefix, [ids], [logits], exe,
                                               program=main)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            prog, feed_names, _ = paddle.static.load_inference_model(
                prefix, exe)
            t_load = time.perf_counter() - t0
            size = os.path.getsize(prefix + ".pdmodel")
            counts = (fa.launches, rms.launches)
            (loaded,) = exe.run(prog, feed={"input_ids": feeds[-1]})
            loaded_counts = (fa.launches - counts[0],
                             rms.launches - counts[1])
        same_loaded = np.array_equal(loaded, outs[-1].cpu().numpy())
        print(f"save_inference_model {t_save:.1f} s ({size / 2**20:.0f} "
              f"MiB), load_inference_model {t_load:.1f} s, feeds "
              f"{feed_names}; the loaded program: K1/K4 launches "
              f"{loaded_counts}, logits bit for bit the replay's "
              f"{same_loaded}", flush=True)
        check(loaded_counts == (n, 2 * n + 1),
              f"the loaded program's K1/K4 launches {loaded_counts}")
        check(same_loaded, "the loaded program's logits differ")
        launches["loaded"] = dict(zip(("fwd", "rms_norm"), loaded_counts))
        last = outs[-1][:1].float().cpu()
        del outs, exe, main, prog, model, logits, ids
        release_memory(torch)

        cpu = llama_from_state(torch, llama, cfg, state, "cpu").eval()
        with torch.no_grad():
            want = cpu(torch.from_numpy(feeds[-1][:1]))
        del cpu
        err = (last - want).abs().max().item()
        print(f"replay logits (row 0) vs the CPU plain path: max abs err "
              f"{err:.3e} (tol {LOGITS_TOL})", flush=True)
        check(err <= LOGITS_TOL, f"static Llama vs CPU err {err}")
    finally:
        paddle.disable_static()
    return {"launches": launches, "host_ms": p50,
            "device_ms": prof["device_ms"], "replays": replays}


def debug_llama(torch, llama, cfg, state, device):
    """The bf16 O2 Llama of phase 23 (b) and (d) on ``device``, with its
    eager step (forward and backward; the gradients are dropped)."""
    from paddle_tpu_torch import amp

    model = llama_from_state(torch, llama, cfg, state, device)
    amp.decorate(model, level="O2", dtype="bfloat16", device=device)
    crit = llama.LlamaPretrainingCriterion(cfg)

    def step(ids):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(ids)
        loss = crit(logits, ids)
        loss.backward()
        for p in model.parameters():
            p.grad = None
        return loss.detach()

    return model, step


def first_nan_op(torch, hooks, step, ids, arm) -> tuple:
    """The names of the ops a step ran up to the one that raised, and its
    message, under ``arm`` (the checker, or FLAGS_check_nan_inf)."""
    from paddle_tpu_torch.base.enforce import PreconditionNotMetError

    names = []
    arm()
    inner = hooks.op_observer

    def observe(name, outs):
        names.append(name)
        if inner is not None:
            inner(name, outs)

    hooks.op_observer = observe
    try:
        step(ids)
    except PreconditionNotMetError as e:
        return names, str(e)
    finally:
        hooks.op_observer = None
    raise AssertionError("the NaN step did not raise")


def interception_tier(torch, llama, state) -> dict:
    """Phase 23 (b)-(d): the tensor checker, FLAGS_check_nan_inf and the
    operator stats on an eager llama_124m_gqa bf16 O2 step, a register_op
    op, and profiler.Profiler over one step."""
    from torch.autograd import DeviceType

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.amp import debugging as dbg
    from paddle_tpu_torch.base import flags
    from paddle_tpu_torch.core import hooks
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    cfg = llama.llama_124m_gqa()
    n = cfg.num_hidden_layers
    print(f"== interception tier: llama_124m_gqa bf16 O2 eager steps "
          f"(forward and backward), {DEBUG_BATCH}x{DEBUG_SEQ}", flush=True)
    model, step = debug_llama(torch, llama, cfg, state, "cuda")
    ids = torch.from_numpy(np.random.RandomState(31).randint(
        1, cfg.vocab_size, (DEBUG_BATCH, DEBUG_SEQ))).cuda()

    def timed_steps():
        times = []
        for _ in range(DEBUG_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(ids)
            dbg.advance_step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    def counters():
        return (fa.launches, rms.launches, fa.dq_launches, fa.dkv_launches,
                rms.bwd_launches)

    step(ids)
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    rms.launches = rms.bwd_launches = 0
    off_ms = timed_steps()
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        enable=True, debug_mode=dbg.DebugMode.CHECK_NAN_INF))
    try:
        on_ms = timed_steps()
    finally:
        dbg.disable_tensor_checker()
    found = dbg.tensor_checker_results()
    print(f"(b) step p50 {off_ms:.2f} ms with the checker off, {on_ms:.2f} "
          f"ms with it on (warn mode, {on_ms / off_ms:.1f}x); findings over "
          f"{DEBUG_STEPS} steps: {len(found)}", flush=True)
    check(not found, f"the checker found {found[:3]} on a clean model")

    counts = counters()
    with dbg.collect_operator_stats():
        step(ids)
        stats = dbg.get_operator_stats()
    torch.cuda.synchronize()
    step_counts = tuple(now - was for now, was in zip(counters(), counts))
    # the checked steps: checker off, checker on, the stats' step
    checked = counters()
    check(checked == tuple((2 * DEBUG_STEPS + 1) * c for c in step_counts),
          f"launches over the {2 * DEBUG_STEPS + 1} checked steps {checked}, "
          f"one step {step_counts}")
    ops = {name: stats.get(f"paddle_tpu_torch::{name}", {}) for name in (
        "flash_attention_fwd", "rms_norm_fwd", "flash_attention_bwd",
        "rms_norm_bwd")}
    print(f"(b) operator stats over one step: {ops}; launches K1/K4/K2/K3/"
          f"K4-bwd {step_counts}; {len(stats)} distinct ops, "
          f"{sum(sum(c.values()) for c in stats.values())} calls", flush=True)
    check(ops["flash_attention_fwd"] == {"bf16": n} == {"bf16": step_counts[0]}
          and ops["rms_norm_fwd"] == {"bf16": 2 * n + 1}
          == {"bf16": step_counts[1]},
          f"the stats' K1/K4 counts {ops} against the launches {step_counts}")
    check(ops["flash_attention_bwd"] == {"bf16": step_counts[2]}
          == {"bf16": step_counts[3]}
          and ops["rms_norm_bwd"] == {
              "bf16": step_counts[4] // rms.BWD_LAUNCHES_PER_CALL},
          f"the stats' backward counts {ops} against {step_counts}")

    # a NaN written into one parameter: the first op whose output holds it
    param = dict(model.named_parameters())[NAN_PARAM]
    kept = param.detach().clone()
    with torch.no_grad():
        param[NAN_AT] = float("nan")

    def checker():
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True))

    names_c, msg_c = first_nan_op(torch, hooks, step, ids, checker)
    dbg.disable_tensor_checker()
    names_f, msg_f = first_nan_op(torch, hooks, step, ids,
                                  flags.enable_check_nan_inf)
    flags.disable_check_nan_inf()
    with torch.no_grad():
        param.copy_(kept)
    cpu_model, cpu_step = debug_llama(torch, llama, cfg, state, "cpu")
    with torch.no_grad():
        dict(cpu_model.named_parameters())[NAN_PARAM][NAN_AT] = float("nan")
    # twice: the first CPU run fills the first-use caches the card's warm
    # steps already hold (the RoPE table, the zero dropout seed), which
    # would add their ops to its sequence
    for _ in range(2):
        names_cpu, msg_cpu = first_nan_op(torch, hooks, cpu_step, ids.cpu(),
                                          checker)
        dbg.disable_tensor_checker()
    del cpu_model, cpu_step
    print(f"(b) NaN at {NAN_PARAM}{list(NAN_AT)}: the checker raised at op "
          f"#{len(names_c)} {names_c[-1]!r} ({msg_c.split(']')[-1].strip()}"
          f"); FLAGS_check_nan_inf at op #{len(names_f) + 1} ({msg_f}); the "
          f"CPU run of the same step at op #{len(names_cpu)} "
          f"{names_cpu[-1]!r}", flush=True)
    differ = next((i for i, (a, b) in enumerate(zip(names_c, names_cpu))
                   if a != b), None)
    check(names_c == names_cpu, f"the card's first NaN op "
          f"#{len(names_c)} {names_c[-1]} differs from the CPU's "
          f"#{len(names_cpu)} {names_cpu[-1]}; first difference at op "
          f"#{differ}")
    check(names_f == names_c[:-1] and f"'{names_c[-1]}'" in msg_f,
          "FLAGS_check_nan_inf raised at another op than the checker")

    # (c) a user op with a torch body and a backward
    def swish(x):
        return x * torch.sigmoid(x)

    def swish_bwd(res, g):
        (x,), _ = res
        s = torch.sigmoid(x)
        return (g * (s + x * s * (1 - s)),)

    op = paddle.register_op("chip_swish", swish, backward=swish_bwd)
    x = torch.randn(4096, cfg.hidden_size, device="cuda", requires_grad=True)
    with dbg.collect_operator_stats():
        y = op(x)
        user_stats = dbg.get_operator_stats()
    y.backward(torch.ones_like(y))
    xr = x.detach().clone().requires_grad_()
    swish(xr).backward(torch.ones_like(xr))
    grad_err = (x.grad - xr.grad).abs().max().item()
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        xs = paddle.static.data("x", [4096, cfg.hidden_size], "float32")
        ys = paddle.run_custom_op("chip_swish", xs)
    exe = paddle.static.Executor()
    feed = np.random.RandomState(5).randn(4096, cfg.hidden_size).astype(
        np.float32)
    replays = [exe.run(main, feed={"x": feed}, fetch_list=[ys],
                       return_numpy=False)[0] for _ in range(3)]
    with torch.no_grad():
        eager = op(torch.from_numpy(feed).cuda())
    same = all(torch.equal(r, eager) for r in replays)
    name = "paddle_tpu_torch_custom::chip_swish"
    print(f"(c) register_op chip_swish: stats {user_stats}; gradient vs the "
          f"plain rule max abs err {grad_err:.3e}; static program "
          f"{main.op_types()}, replays {exe.replay_counts()} bit for bit the "
          f"eager call {same}", flush=True)
    # one call of the op; the body's own ops run inside it, unseen
    check(user_stats.get(name) == {"fp32": 1}
          and not any(k.startswith("aten::sigmoid") for k in user_stats),
          f"custom op stats {user_stats}")
    check(grad_err <= 1e-6, f"custom op gradient err {grad_err}")
    check(main.op_types() == [name] and same
          and exe.replay_counts() == {"graph": 2, "eager": 1},
          "the custom op's static program")
    del exe, main, replays

    # (d) profiler.Profiler over one eager step, after a READY step (the
    # scheduler (1, 2)) that warms the device trace up on the same work
    with paddle.profiler.Profiler(targets=[paddle.profiler.ProfilerTarget.CPU,
                                           paddle.profiler.ProfilerTarget.GPU],
                                  scheduler=(1, 2)) as prof:
        step(ids)
        prof.step()
        counts = (fa.launches, rms.launches)
        step(ids)
        torch.cuda.synchronize()
        launched = (fa.launches - counts[0], rms.launches - counts[1])
        prof.step()
        # read before the exit, which collects the next (empty) window
        with contextlib.redirect_stdout(io.StringIO()) as table:
            agg = prof.summary(time_unit="ms")
    rows = [line for line in table.getvalue().splitlines()
            if line.startswith(("Name", "paddle_tpu_torch::"))]
    calls = tuple(agg.get(f"paddle_tpu_torch::{k}", {}).get("calls", 0)
                  for k in ("flash_attention_fwd", "rms_norm_fwd"))
    kernel_rows = [(name, e.key[:90], e.count)
                   for e in prof.device_profile.key_averages()
                   for name in ("K1", "K4")
                   if e.device_type == DeviceType.CUDA
                   and PROFILED_KERNELS[name].search(e.key)]
    device_k = {name: sum(c for k, _, c in kernel_rows if k == name)
                for name in ("K1", "K4")}
    print(f"(d) Profiler over one step: summary K1/K4 op calls {calls}, "
          f"launches {launched}, device profile kernel rows {device_k}; "
          f"{len(agg)} op names, {sum(a['calls'] for a in agg.values())} "
          f"op events; the summary's rows of the port's operators:",
          flush=True)
    for line in rows:
        print(f"    {line}", flush=True)
    for name, key, count in kernel_rows:
        print(f"    device {name} x{count}: {key}", flush=True)
    check(calls == launched == (n, 2 * n + 1),
          f"the profiler's K1/K4 calls {calls} against launches {launched}")
    check((device_k["K1"], device_k["K4"]) == launched,
          f"the device timeline's K1/K4 kernels {device_k} against the "
          f"launches {launched}")
    out = {**dict(zip(("fwd", "rms_norm", "dq", "dkv", "rms_norm_bwd"),
                      checked)),
           "off_ms": off_ms, "on_ms": on_ms}
    del model, step, prof
    release_memory(torch)
    return out


def phase_static(torch, llama) -> dict:
    """Phase 23: static mode and the op-interception tier on
    llama_124m_gqa (see :func:`static_llama` and
    :func:`interception_tier`). Returns the launches by path and the
    figures."""
    state = seeded_llama_state(torch, llama, llama.llama_124m_gqa(), 23)
    static = static_llama(torch, llama, state)
    tier = interception_tier(torch, llama, state)
    return {"static": static, "debug": tier}


# ------------------------------------------------ phase 24, the recurrent tier
# Zaremba, Sutskever & Vinyals (2014) §4.1, the "large" network (TensorFlow
# ptb_word_lm.py LargeConfig): 2 LSTM layers of 1500 units unrolled 35
# steps, batch 20, 10,000 words, dropout 0.65 on the non-recurrent
# connections, weights uniform in ±0.04, SGD at 1 with the gradients'
# global norm clipped to 10. The loss is the per-word cross entropy summed
# over the unroll and averaged over the batch, as the paper's code sums it
PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS = 10000, 1500, 2
PTB_BATCH, PTB_UNROLL = 20, 35
PTB_DROPOUT, PTB_INIT, PTB_LR, PTB_CLIP = 0.65, 0.04, 1.0, 10.0
PTB_PROFILED = 2
# the first step's loss (eval mode, no dropout) on the card against the
# CPU's on the same weights, relative
PTB_FIRST_LOSS_TOL = 1e-3
# phase 24 (b): a DeepSpeech2-style recurrent stack over spectrogram frames
SEQ_BATCH, SEQ_FRAMES, SEQ_FEATURES = 16, 200, 161
SEQ_HIDDEN, SEQ_LAYERS, SEQ_CLASSES, SEQ_MAX_LABEL = 1024, 3, 29, 60
# card against CPU, each tensor within this share of its largest magnitude
SEQ_TOL = 1e-3
# phase 24 (c): card against CPU, relative to each output's largest value
VISION_OPS_TOL = 1e-4
# phase 24 (d): the input pipeline
PIPE_IMAGES, PIPE_SIZE, PIPE_BATCH, PIPE_WORKERS = 64, 256, 32, 2
PIPE_MEAN, PIPE_STD = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)


def ptb_flops(batch, unroll, hidden, layers, vocab) -> float:
    """Model FLOP of one training step: 2 FLOP a MAC, forward and backward
    three times the forward; each token's LSTM layer multiplies by
    ``W_ih`` and ``W_hh`` (8·H² MACs), the decoder by ``H·V``."""
    return 6.0 * batch * unroll * (layers * 8 * hidden ** 2 + hidden * vocab)


def ptb_lstm_lm(paddle, vocab=PTB_VOCAB, hidden=PTB_HIDDEN,
                layers=PTB_LAYERS, batch=PTB_BATCH, dropout=PTB_DROPOUT,
                init_scale=PTB_INIT, lr=PTB_LR, clip=PTB_CLIP, seed=0):
    """Zaremba et al.'s PTB language model as a user writes it in Paddle
    idiom, built by the ``paddle`` module it is given (``paddle_tpu_torch``
    here; the CPU test gives the JAX package the same text):
    ``nn.Embedding``, ``nn.Dropout`` on the embedding's and the LSTM's
    outputs, ``nn.LSTM(num_layers, dropout)``, ``nn.Linear`` to the
    vocabulary, every weight ``Uniform(±init_scale)``. Truncated
    backpropagation carries (h, c) from one window to the next in two
    non-persistable buffers, written in place at the end of the forward
    (``reset_state`` zeroes them at an epoch's start). Returns (model,
    optimizer, clip, loss_fn(ids, labels)): SGD with a global-norm clip;
    the loss is the mean cross entropy times the unroll."""
    nn = paddle.nn
    F = paddle.nn.functional
    paddle.seed(seed)

    def attr():
        return nn.ParamAttr(initializer=nn.initializer.Uniform(-init_scale,
                                                               init_scale))

    class PTBLanguageModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(vocab, hidden, weight_attr=attr())
            self.dropout = nn.Dropout(dropout)
            self.lstm = nn.LSTM(hidden, hidden, num_layers=layers,
                                dropout=dropout, weight_ih_attr=attr(),
                                weight_hh_attr=attr(), bias_ih_attr=attr(),
                                bias_hh_attr=attr())
            self.decoder = nn.Linear(hidden, vocab, weight_attr=attr(),
                                     bias_attr=attr())
            zeros = np.zeros((layers, batch, hidden), np.float32)
            self.register_buffer("h", paddle.to_tensor(zeros),
                                 persistable=False)
            self.register_buffer("c", paddle.to_tensor(zeros),
                                 persistable=False)

        def reset_state(self):
            paddle.assign(paddle.zeros_like(self.h), self.h)
            paddle.assign(paddle.zeros_like(self.c), self.c)

        def forward(self, ids):
            x = self.dropout(self.embedding(ids))
            out, (h, c) = self.lstm(x, (self.h.clone(), self.c.clone()))
            paddle.assign(h.detach(), self.h)
            paddle.assign(c.detach(), self.c)
            return self.decoder(self.dropout(out))

    model = PTBLanguageModel()
    clip_norm = nn.ClipGradByGlobalNorm(clip)
    opt = paddle.optimizer.SGD(learning_rate=lr,
                               parameters=model.parameters(),
                               grad_clip=clip_norm)

    def loss_fn(ids, labels):
        logits = model(ids)
        loss = F.cross_entropy(logits.reshape([-1, vocab]),
                               labels.reshape([-1]))
        return loss * ids.shape[1]

    return model, opt, clip_norm, loss_fn


def ptb_windows(vocab, batch, unroll, count, seed=24) -> list:
    """``count`` consecutive [batch, unroll] windows of a seeded token
    stream laid out as the paper's reader lays it (``batch`` rows of one
    stream), each with its labels, the next tokens: numpy int64."""
    rs = np.random.RandomState(seed)
    data = rs.randint(0, vocab, (batch, count * unroll + 1)).astype(np.int64)
    return [(data[:, i * unroll:(i + 1) * unroll],
             data[:, i * unroll + 1:(i + 1) * unroll + 1])
            for i in range(count)]


def zero_launch_counters() -> None:
    """Every kernel wrapper's launch count set to 0."""
    from paddle_tpu_torch.jit.functionalize import launch_counters

    for mod, attr, key in launch_counters():
        if key is None:
            setattr(mod, attr, 0)
        else:
            getattr(mod, attr)[key] = 0


def ptb_train(torch, paddle, windows, graphed: bool):
    """The large PTB model from seed 0 over ``windows`` (on the card): one
    eager step by hand a window, or one ``TrainStep`` call. Returns
    (records, model, step, clip): a record a step (loss, clip norm, h, c
    after it) and the step's host seconds."""
    from paddle_tpu_torch.jit import TrainStep

    model, opt, clip, loss_fn = ptb_lstm_lm(paddle)
    if graphed:
        step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    else:
        def step(ids, labels):
            loss = loss_fn(ids, labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
    records = []
    for ids, labels in windows:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, labels)
        torch.cuda.synchronize()
        # TrainStep returns a paddle.Tensor, whose methods take Paddle's
        # meaning: kept plain, as the eager step's loss is
        records.append({"loss": loss.detach().as_subclass(torch.Tensor)
                        .clone(),
                        "norm": clip.last_norm.detach().clone(),
                        "h": model.h.clone(), "c": model.c.clone(),
                        "s": time.perf_counter() - t0})
    return records, model, step, clip


PTB_CLASSES = ("recurrent h·W_hhᵀ products", "input and decoder products",
               "gate element-wise work", "weight-gradient accumulation",
               "loss", "the rest")
_GEMM_OPS = ("aten::mm", "aten::addmm", "aten::matmul", "aten::bmm",
             "aten::linear", "aten::baddbmm")


def ptb_class(name, shapes, batch, unroll, hidden) -> str:
    """The class of one op of the PTB step, by its name and input shapes:
    the GEMMs by the operand shapes of the recurrence (``[B, H]`` against
    ``[H, 4H]``), of a whole window (``B·T`` rows) and of a weight
    gradient (``[H, B]`` against ``[B, 4H]``, and the adds of ``[4H, H]``
    partials)."""
    dims = [tuple(s) for s in shapes if isinstance(s, (list, tuple)) and s]
    b, h = batch, hidden
    w_shapes = {(4 * h, h), (h, 4 * h)}
    if any(k in name for k in ("log_softmax", "nll_loss", "cross_entropy")):
        return "loss"
    if name in _GEMM_OPS:
        if any(len(s) == 3 for s in dims) or any(
                batch * unroll in s for s in dims):
            return "input and decoder products"
        if (b, h) in dims and w_shapes & set(dims) or (
                (b, 4 * h) in dims and (4 * h, h) in dims):
            return "recurrent h·W_hhᵀ products"
        if (h, b) in dims or (4 * h, b) in dims:
            return "weight-gradient accumulation"
        return "the rest"
    if w_shapes & set(dims):
        return "weight-gradient accumulation"
    if any(s in ((b, 4 * h), (b, h)) for s in dims):
        return "gate element-wise work"
    return "the rest"


def ptb_device_classes(torch, model_step, batch) -> dict:
    """Device ms of one eager step by :data:`PTB_CLASSES` (the same
    kernels a replay runs, attributed to the ops that launched them),
    from ``torch.profiler`` with the ops' input shapes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model_step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        model_step(*batch)
        torch.cuda.synchronize()
    classes = dict.fromkeys(PTB_CLASSES, 0.0)
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != DeviceType.CPU or e.self_device_time_total <= 0:
            continue
        shapes = list(e.input_shapes or [])
        cls = ptb_class(e.key, shapes, PTB_BATCH, PTB_UNROLL, PTB_HIDDEN)
        classes[cls] += e.self_device_time_total / 1e3
    return classes


def cudnn_lstm_ms(torch) -> tuple:
    """``torch.nn.LSTM`` (cuDNN's fused RNN) forward and backward at the
    PTB shape, train mode with its dropout, as a yardstick only (not on
    the port's path), beside the port's ``nn.LSTM`` layer alone, eager:
    (cuDNN ms, port ms), CUDA events over 10 calls after 3."""
    from paddle_tpu_torch import nn

    x = torch.randn(PTB_UNROLL, PTB_BATCH, PTB_HIDDEN, device="cuda",
                    requires_grad=True)
    g = torch.randn(PTB_UNROLL, PTB_BATCH, PTB_HIDDEN, device="cuda")
    cudnn = torch.nn.LSTM(PTB_HIDDEN, PTB_HIDDEN, PTB_LAYERS,
                          dropout=PTB_DROPOUT).cuda()
    port = nn.LSTM(PTB_HIDDEN, PTB_HIDDEN, PTB_LAYERS, time_major=True,
                   dropout=PTB_DROPOUT, device="cuda")

    def run(layer):
        def call():
            out, _ = layer(x)
            out.backward(g)
        return call

    out = []
    for fn in (run(cudnn), run(port)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / 10)
    del cudnn, port, x, g
    release_memory(torch)
    return tuple(out)


def ptb_first_loss(torch, paddle, window) -> tuple:
    """The freshly built model's loss on the first window in eval mode (no
    dropout) on the card and on the CPU, from the same weights."""
    losses = []
    state = None
    for dev in ("cuda", "cpu"):
        paddle.set_device("gpu" if dev == "cuda" else "cpu")
        model, _, _, loss_fn = ptb_lstm_lm(paddle)
        if state is None:
            state = {k: v.detach().cpu() for k, v in
                     model.state_dict().items()}
        else:
            model.set_state_dict(state)
        model.eval()
        with torch.no_grad():
            ids, labels = (torch.from_numpy(a).to(dev) for a in window)
            losses.append(float(loss_fn(ids, labels)))
        del model, loss_fn
    paddle.set_device("gpu")
    return tuple(losses)


def phase_ptb(torch) -> dict:
    """Phase 24 (a): Zaremba et al.'s large PTB LSTM language model, a
    user-written ``nn.Layer`` at its published width, trained on the card:
    12 eager steps by hand, then a ``TrainStep`` (one CUDA graph a step)
    over the same 12 windows (2 warmup, 10 timed), held bit for bit to
    them (losses, parameters, carried states, clip norms), then 2 profiled
    steps; a replayed step under the sync debug mode; the first loss
    against the CPU; step p50, tokens/s, TFLOP/s, launches a step, the
    idle share, device ms by class, peak memory, cuDNN's LSTM beside it."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.jit.functionalize import launch_counters

    t_phase = time.perf_counter()
    paddle.set_device("gpu")
    steps = GRAPH_WARMUP + TRAIN_STEPS
    flops = ptb_flops(PTB_BATCH, PTB_UNROLL, PTB_HIDDEN, PTB_LAYERS,
                      PTB_VOCAB)
    print(f"== PTB LSTM LM, large (Zaremba et al. 2014 §4.1): "
          f"{PTB_LAYERS} x LSTM {PTB_HIDDEN}, unroll {PTB_UNROLL}, batch "
          f"{PTB_BATCH}, vocab {PTB_VOCAB}, dropout {PTB_DROPOUT}, init "
          f"±{PTB_INIT}, SGD {PTB_LR} with global-norm clip {PTB_CLIP}, f32; "
          f"{flops / 1e9:.1f} GFLOP a step", flush=True)
    windows = [tuple(torch.from_numpy(a).cuda() for a in w)
               for w in ptb_windows(PTB_VOCAB, PTB_BATCH, PTB_UNROLL,
                                    steps + PTB_PROFILED + 2)]
    first = ptb_first_loss(torch, paddle, [a.cpu().numpy()
                                           for a in windows[0]])
    rel = abs(first[0] - first[1]) / abs(first[1])
    print(f"(a) first window, eval mode: loss on the card {first[0]:.6f}, "
          f"on the CPU {first[1]:.6f} (relative {rel:.2e}, tol "
          f"{PTB_FIRST_LOSS_TOL})", flush=True)
    check(rel <= PTB_FIRST_LOSS_TOL, f"PTB first loss card vs CPU {first}")

    eager, model, _, _ = ptb_train(torch, paddle, windows[:steps], False)
    eager_params = [p.detach().clone() for p in model.parameters()]
    n_params = sum(p.numel() for p in model.parameters())
    del model
    release_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counters()
    graphed, model, step, clip = ptb_train(torch, paddle, windows[:steps],
                                           True)
    launched = {k: v for k, v in launch_counters().items() if v}
    peak = torch.cuda.max_memory_allocated()
    fields = ("loss", "norm", "h", "c")
    same = {f: all(same_bits(torch, a[f], b[f]) for a, b in
                   zip(eager, graphed)) for f in fields}
    same_params = [same_bits(torch, a, b.detach()) for a, b in
                   zip(eager_params, model.parameters())]
    print(f"(a) {steps} graphed steps against {steps} eager steps by hand, "
          f"bit for bit: " + ", ".join(f"{f} {same[f]}" for f in fields)
          + f", parameters {sum(same_params)}/{len(same_params)}; steps "
          f"{step._compiled.stats}", flush=True)
    check(all(same.values()) and all(same_params),
          "the graphed PTB steps differ from the eager ones")
    check(step._compiled.stats == {"compiled_steps": steps - 1,
                                   "eager_steps": 1},
          f"PTB steps {step._compiled.stats}: not graphed after the first")
    check(launched == {}, f"the PTB path launched port kernels {launched}")
    losses = [float(r["loss"]) for r in graphed]
    norms = [float(r["norm"]) for r in graphed]
    check(all(math.isfinite(x) for x in losses + norms),
          f"non-finite PTB losses {losses} or norms {norms}")
    times = [r["s"] for r in graphed[GRAPH_WARMUP:]]
    p50 = float(np.median(times))
    tokens = PTB_BATCH * PTB_UNROLL
    print("(a) losses " + " ".join(f"{x:.4f}" for x in losses)
          + "; clip norms " + " ".join(f"{x:.3f}" for x in norms),
          flush=True)
    # a replayed step with any host synchronisation made an error
    ids, labels = windows[steps]
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(ids, labels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("(a) a replayed step under torch.cuda.set_sync_debug_mode('error')"
          ": no host synchronisation inside the step", flush=True)
    prof = profile_steps(torch, step, windows[steps + 1], p50 * 1e3,
                         steps=PTB_PROFILED)
    classes = ptb_device_classes(torch, step._compiled.fn,
                                 windows[steps + 1])
    del model, step, clip
    release_memory(torch)
    cudnn_ms, port_lstm_ms = cudnn_lstm_ms(torch)
    card = card_label()
    total = sum(classes.values())
    print(f"(a) {card}: step p50 {p50 * 1e3:.3f} ms (min "
          f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}); "
          f"{tokens / p50:.1f} tokens/s; model TFLOP/s "
          f"{flops / p50 / 1e12:.3f} against {PEAK_FLOPS['float32'] / 1e12:.0f}"
          f" f32 ({flops / p50 / PEAK_FLOPS['float32']:.2%}); floor "
          f"{flops / PEAK_FLOPS['float32'] * 1e3:.3f} ms; "
          f"{prof['launches']:.0f} launches a step; idle share "
          f"{1 - prof['device_ms'] / (p50 * 1e3):.1%}; peak memory "
          f"{peak / 2**30:.2f} GiB; {n_params / 1e6:.2f} M parameters",
          flush=True)
    print("(a) device ms of one step by class (an eager step's kernels, "
          "those a replay runs): " + "; ".join(
              f"{n} {ms:.3f} ({ms / total:.1%})" for n, ms in classes.items())
          + f"; total {total:.3f}", flush=True)
    print(f"(a) yardstick, not on the path: torch.nn.LSTM (cuDNN) forward + "
          f"backward at [{PTB_UNROLL}, {PTB_BATCH}, {PTB_HIDDEN}], "
          f"{PTB_LAYERS} layers, dropout {PTB_DROPOUT}: {cudnn_ms:.3f} ms; "
          f"the port's nn.LSTM alone, eager, the same: {port_lstm_ms:.3f} ms",
          flush=True)
    print(f"PTB LM: phase 24 (a) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"p50_ms": p50 * 1e3, "launches": prof["launches"],
            "classes": classes, "cudnn_ms": cudnn_ms,
            "port_lstm_ms": port_lstm_ms}


def rel_max_err(torch, got, want) -> float:
    """Largest absolute difference over ``want``'s largest magnitude."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def speech_inputs(torch) -> tuple:
    """Seeded [16, 200, 161] frames, lengths spread over 50-200 (one of
    200), labels of 29 classes (blank 0) up to 60 long and at most half
    their input's length (so every alignment exists)."""
    rs = np.random.RandomState(24)
    x = rs.randn(SEQ_BATCH, SEQ_FRAMES, SEQ_FEATURES).astype(np.float32)
    lens = rs.randint(50, SEQ_FRAMES + 1, SEQ_BATCH).astype(np.int64)
    lens[0] = SEQ_FRAMES
    lab_len = np.minimum(rs.randint(10, SEQ_MAX_LABEL + 1, SEQ_BATCH),
                         lens // 2).astype(np.int64)
    labels = rs.randint(1, SEQ_CLASSES, (SEQ_BATCH, SEQ_MAX_LABEL)).astype(
        np.int64)
    return x, lens, labels, lab_len


def phase_sequence(torch) -> None:
    """Phase 24 (b): a 3-layer bidirectional ``nn.GRU`` of 1024 units over
    [16, 200, 161] frames with ``sequence_length`` over 50-200, an
    ``nn.Linear`` to 29 classes, ``log_softmax`` into ``ctc_loss``: the
    outputs, final states, loss and input gradient on the card against the
    CPU on the same weights, each within ``SEQ_TOL`` of its largest
    magnitude."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    print(f"== (b) sequence pieces: GRU {SEQ_LAYERS} x bidirect "
          f"{SEQ_HIDDEN} over [{SEQ_BATCH}, {SEQ_FRAMES}, {SEQ_FEATURES}] "
          f"with lengths, Linear to {SEQ_CLASSES}, log_softmax, ctc_loss; "
          f"card against CPU", flush=True)
    x, lens, labels, lab_len = speech_inputs(torch)
    out = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        gen = torch.Generator().manual_seed(24)
        gru = nn.GRU(SEQ_FEATURES, SEQ_HIDDEN, num_layers=SEQ_LAYERS,
                     direction="bidirect", device=dev, generator=gen)
        proj = nn.Linear(2 * SEQ_HIDDEN, SEQ_CLASSES, device=dev,
                         generator=gen)
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        y, h = gru(xt, None, torch.from_numpy(lens).to(dev))
        lp = F.log_softmax(proj(y), -1).transpose(0, 1)
        loss = F.ctc_loss(lp, *(torch.from_numpy(a).to(dev)
                                for a in (labels, lens, lab_len)))
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = {"outputs": y, "final states": h, "loss": loss,
                    "input gradient": xt.grad}
        print(f"(b) {dev}: loss {float(loss):.6f} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    errs = {k: rel_max_err(torch, out["cuda"][k], out["cpu"][k])
            for k in out["cpu"]}
    print("(b) card against CPU, max abs error over the largest magnitude: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol {SEQ_TOL})", flush=True)
    check(all(math.isfinite(v) and v <= SEQ_TOL for v in errs.values()),
          f"sequence pieces card vs CPU {errs}")
    del out
    release_memory(torch)


def vision_cases(torch, rs) -> list:
    """(name, fn, inputs) of phase 24 (c): the detection ops at their
    models' sizes, the new pools and their masks, and each new loss."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.vision import ops

    def arr(*s, lo=None, hi=None):
        a = rs.randn(*s) if lo is None else rs.uniform(lo, hi, s)
        return torch.from_numpy(np.asarray(a, np.float32))

    # roi_align: a 256 x 200 x 304 map (an FPN P2 level of an 800 x 1216
    # image), 512 boxes
    xy = rs.uniform(0, 1100, (512, 2))
    wh = rs.uniform(16, 400, (512, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(
        np.float32))
    cases = [("roi_align", lambda f, b, n: ops.roi_align(
        f, b, n, 7, spatial_scale=0.25, sampling_ratio=2, aligned=True),
        [arr(1, 256, 200, 304), boxes, torch.tensor([512])])]
    # box_coder over SSD300's 8732 priors
    cxy = rs.uniform(0.05, 0.95, (8732, 2))
    pwh = rs.uniform(0.05, 0.6, (8732, 2))
    priors = np.concatenate([cxy - pwh / 2, cxy + pwh / 2], 1)
    txy = cxy + rs.uniform(-0.05, 0.05, (8732, 2))
    twh = pwh * rs.uniform(0.7, 1.4, (8732, 2))
    targets = np.concatenate([txy - twh / 2, txy + twh / 2], 1)
    var = [0.1, 0.1, 0.2, 0.2]
    cases += [
        ("box_coder encode", lambda p, t: ops.box_coder(p, var, t),
         [torch.from_numpy(priors.astype(np.float32)),
          torch.from_numpy(targets.astype(np.float32))]),
        ("box_coder decode", lambda p, t: ops.box_coder(
            p, var, t, "decode_center_size"),
         [torch.from_numpy(priors.astype(np.float32)), arr(8732, 4)])]
    # yolo_box: YOLOv3's three heads at 608 x 608
    masks = ([116, 90, 156, 198, 373, 326], [30, 61, 62, 45, 59, 119],
             [10, 13, 16, 30, 33, 23])
    for grid, anchors, ratio in zip((19, 38, 76), masks, (32, 16, 8)):
        cases.append((f"yolo_box {grid}x{grid}",
                      lambda x, s, a=anchors, r=ratio: ops.yolo_box(
                          x, s, a, 80, 0.01, r),
                      [arr(2, 3 * 85, grid, grid),
                       torch.tensor([[608, 608], [512, 640]])]))
    cases += [
        ("max_pool1d mask", lambda x: F.max_pool1d(x, 3, 2, 1,
                                                   return_mask=True),
         [arr(8, 64, 1000)]),
        ("avg_pool1d", lambda x: F.avg_pool1d(x, 4, 2, 1), [arr(8, 64, 1000)]),
        ("max_pool3d mask", lambda x: F.max_pool3d(x, 3, 2, 1,
                                                   return_mask=True),
         [arr(2, 32, 16, 56, 56)]),
        ("avg_pool3d", lambda x: F.avg_pool3d(x, 2, 2), [arr(2, 32, 16, 56,
                                                            56)]),
        ("max_pool2d mask", lambda x: F.max_pool2d(x, 3, 2, 1,
                                                   return_mask=True),
         [arr(4, 64, 112, 112)]),
    ]
    a, b, c = arr(512, 1000), arr(512, 1000), arr(512, 1000)
    prob, y01 = arr(512, 1000, lo=0.02, hi=0.98), (arr(512, 1000) > 0).float()
    pm1 = torch.where(arr(512, 1000) > 0, 1.0, -1.0)
    logp = torch.log_softmax(arr(512, 1000), -1)
    cls = torch.from_numpy(rs.randint(0, 1000, 512))
    cases += [
        ("mse_loss", F.mse_loss, [a, b]), ("l1_loss", F.l1_loss, [a, b]),
        ("smooth_l1_loss", F.smooth_l1_loss, [a, b]),
        ("square_error_cost", F.square_error_cost, [a, b]),
        ("log_loss", F.log_loss, [prob, y01]),
        ("binary_cross_entropy", F.binary_cross_entropy, [prob, y01]),
        ("nll_loss", F.nll_loss, [logp, cls]),
        ("kl_div", lambda x, t: F.kl_div(x, t, "batchmean"),
         [logp, torch.softmax(b, -1)]),
        ("margin_ranking_loss", F.margin_ranking_loss, [a, b, pm1]),
        ("hinge_embedding_loss", F.hinge_embedding_loss, [a, pm1]),
        ("triplet_margin_loss", F.triplet_margin_loss, [a, b, c]),
        ("sigmoid_focal_loss", F.sigmoid_focal_loss, [a, y01]),
    ]
    return cases


def phase_vision_ops(torch) -> None:
    """Phase 24 (c): each case of :func:`vision_cases` on the card against
    the CPU, every output within ``VISION_OPS_TOL`` of its largest value;
    the pools' masks equal, and gathering the pooled values."""
    print("== (c) vision ops and the new nn functions: card against CPU",
          flush=True)
    rs = np.random.RandomState(124)
    lines = []
    for name, fn, inputs in vision_cases(torch, rs):
        cpu = fn(*inputs)
        card = fn(*[t.cuda() for t in inputs])
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        card = card if isinstance(card, tuple) else (card,)
        errs = []
        for g, w in zip(card, cpu):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name}: card {g.shape} {g.dtype}, CPU {w.shape} "
                  f"{w.dtype}")
            if w.is_floating_point():
                errs.append(rel_max_err(torch, g, w))
            else:
                check(torch.equal(g.cpu(), w), f"{name}: the masks differ")
        if name.endswith("mask"):
            x, (pooled, mask) = inputs[0], cpu
            flat = x.flatten(2).gather(2, mask.flatten(2))
            check(torch.equal(flat.view_as(pooled), pooled),
                  f"{name}: the mask does not gather the pooled values")
        lines.append(f"{name} {max(errs):.1e}")
        check(all(math.isfinite(e) and e <= VISION_OPS_TOL for e in errs),
              f"{name}: card vs CPU {errs}")
    print("(c) max error over the largest value, card vs CPU: "
          + "; ".join(lines) + f" (tol {VISION_OPS_TOL})", flush=True)
    release_memory(torch)


def _pipeline(T, random_aug: bool):
    steps = [T.Resize(PIPE_SIZE)]
    steps += ([T.RandomCrop(224), T.RandomHorizontalFlip()] if random_aug
              else [T.CenterCrop(224)])
    return T.Compose(steps + [T.Normalize(PIPE_MEAN, PIPE_STD,
                                          data_format="HWC"),
                              T.Transpose()])


def phase_pipeline(torch, resnet) -> None:
    """Phase 24 (d): ``vision.datasets.DatasetFolder`` over 64 seeded
    256 x 256 x 3 uint8 ``.npy`` images (``loader=np.load``) in a temp
    dir, ``Compose([Resize, CenterCrop(224), Normalize, Transpose])``,
    ``io.DataLoader`` (batch 32, 2 worker processes), ``io.DeviceLoader``,
    resnet50's eval forward: each batch equal to the transforms run here,
    the logits within ``RESNET_EVAL_TOL`` of the CPU's (4 images); a
    ``RandomCrop``/``RandomHorizontalFlip`` pipeline gives the same batches
    twice under one seed."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io
    from paddle_tpu_torch.vision import datasets
    from paddle_tpu_torch.vision import transforms as T

    print(f"== (d) input pipeline: DatasetFolder over {PIPE_IMAGES} .npy "
          f"images, transforms, DataLoader ({PIPE_WORKERS} workers), "
          f"DeviceLoader, resnet50 eval", flush=True)
    t0 = time.perf_counter()
    rs = np.random.RandomState(240)
    with tempfile.TemporaryDirectory() as root:
        for i in range(PIPE_IMAGES):
            d = os.path.join(root, f"class_{i % 4}")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"{i:03d}.npy"), rs.randint(
                0, 256, (PIPE_SIZE, PIPE_SIZE, 3)).astype(np.uint8))
        ds = datasets.DatasetFolder(root, loader=np.load,
                                    extensions=(".npy",),
                                    transform=_pipeline(T, False))
        loader = io.DataLoader(ds, batch_size=PIPE_BATCH, shuffle=False,
                               num_workers=PIPE_WORKERS)
        model = resnet.resnet50(num_classes=RESNET_CLASSES, device="cuda",
                                generator=torch.Generator().manual_seed(24))
        model.eval()
        logits, n = [], 0
        for bi, (img, label) in enumerate(io.DeviceLoader(loader)):
            check(img.is_cuda and tuple(img.shape) == (PIPE_BATCH, 3, 224,
                                                       224),
                  f"batch {bi}: {img.device} {tuple(img.shape)}")
            want = np.stack([ds[bi * PIPE_BATCH + j][0]
                             for j in range(PIPE_BATCH)])
            check(np.array_equal(img.cpu().numpy(), want)
                  and np.array_equal(label.cpu().numpy(), [
                      ds.samples[bi * PIPE_BATCH + j][1]
                      for j in range(PIPE_BATCH)]),
                  f"batch {bi} differs from the transforms run here")
            with torch.no_grad():
                logits.append(model(img))
            n += 1
        check(n == PIPE_IMAGES // PIPE_BATCH, f"{n} batches")
        first = logits[0][:RESNET_EVAL_BATCH].float().cpu()
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        cpu_model = resnet.resnet50(num_classes=RESNET_CLASSES, device="cpu")
        cpu_model.load_state_dict(state)
        cpu_model.eval()
        x = torch.from_numpy(np.stack([ds[j][0]
                                       for j in range(RESNET_EVAL_BATCH)]))
        with torch.no_grad():
            want = cpu_model(x).float()
        err = float((first - want).abs().max())
        scale = float(want.abs().max())
        print(f"(d) {n} batches equal to the transforms run in-process; "
              f"resnet50 eval logits card vs CPU ({RESNET_EVAL_BATCH} "
              f"images) max abs err {err:.3g} (largest {scale:.4g})",
              flush=True)
        check(err <= RESNET_EVAL_TOL * max(scale, 1.0),
              f"pipeline logits card vs CPU {err}")
        del model, cpu_model, logits
        runs = []
        for _ in range(2):
            paddle.seed(24)
            ds_r = datasets.DatasetFolder(root, loader=np.load,
                                          extensions=(".npy",),
                                          transform=_pipeline(T, True))
            runs.append([b[0].numpy() for b in io.DataLoader(
                ds_r, batch_size=PIPE_BATCH, num_workers=PIPE_WORKERS)])
        same = all(np.array_equal(a, b) for a, b in zip(*runs))
        print(f"(d) RandomCrop + RandomHorizontalFlip under paddle.seed(24), "
              f"twice: batches equal {same}; {time.perf_counter() - t0:.1f} "
              f"s", flush=True)
        check(same and len(runs[0]) == n, "the random pipeline differs "
              "between two runs under one seed")
    release_memory(torch)


def optimizer_arms(torch, llama, resnet) -> dict:
    """Phase 24 (e)'s two eager steps, each a ``make()`` giving (model,
    step(), launches of its optimizer kernel a step): llama_124m_gqa bf16
    O2 with AdamW over 2 x 1024 tokens (the weights of phase 23, numpy seed
    23), and resnet50 bf16 O2 with Momentum over 8 images (cuDNN
    deterministic, so that two runs of a step agree)."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.optimizer import AdamW, Momentum

    cfg = llama.llama_124m_gqa()
    state = seeded_llama_state(torch, llama, cfg, 23)
    ids = torch.from_numpy(np.random.RandomState(31).randint(
        1, cfg.vocab_size, (DEBUG_BATCH, DEBUG_SEQ))).cuda()
    rs = np.random.RandomState(18)
    x = torch.from_numpy(rs.randn(8, 3, RESNET_SIZE, RESNET_SIZE).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rs.randint(0, RESNET_CLASSES, 8)).cuda()

    def make_llama():
        model = llama_from_state(torch, llama, cfg, state, "cuda")
        amp.decorate(model, level="O2", dtype="bfloat16")
        crit = llama.LlamaPretrainingCriterion(cfg)
        opt = AdamW(1e-4, parameters=model.parameters())

        def step():
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                loss = crit(model(ids), ids)
            loss.backward()
            opt.step()
            opt.clear_grad()

        return model, step, adamw_launches_per_step(model)

    def make_resnet():
        model = resnet.resnet50(num_classes=RESNET_CLASSES, device="cuda",
                                generator=torch.Generator().manual_seed(0))
        amp.decorate(model, level="O2", dtype="bfloat16")
        crit = nn.CrossEntropyLoss()
        opt = Momentum(RESNET_LR, RESNET_MOMENTUM,
                       parameters=model.parameters())

        def step():
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                logits = model(x)
            crit(logits, y).backward()
            opt.step()
            opt.clear_grad()

        # the Momentum kernel packs its launches as AdamW's does
        return model, step, adamw_launches_per_step(model)

    return {"adamw": make_llama, "momentum": make_resnet}


def phase_optimizer_ops(torch, llama, resnet) -> dict:
    """Phase 24 (e): the AdamW and Momentum kernels as registered
    operators. Each arm of :func:`optimizer_arms` steps once eagerly with
    no slot set, then once under each of the tensor checker (warn mode,
    with the operator stats), ``FLAGS_check_nan_inf`` and a recording
    ``profiler.Profiler``, each from a fresh build: every run's parameters
    bit for bit the first's; the stats and the profiler's op events count
    ``paddle_tpu_torch::adamw``/``::momentum`` once and K1-K4's operators
    as many times as the launch counters say. Returns the launches of the
    intercepted steps by kernel."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.amp import debugging as dbg
    from paddle_tpu_torch.base import flags
    from paddle_tpu_torch.core import hooks
    from paddle_tpu_torch.ops.cuda import adamw, momentum
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    print("== (e) the optimizer kernels as registered operators: an eager "
          "llama_124m_gqa bf16 O2 AdamW step and a resnet50 bf16 O2 "
          "Momentum step under the tensor checker, FLAGS_check_nan_inf and "
          "a recording profiler", flush=True)
    torch.backends.cudnn.deterministic = True
    paddle.set_device("gpu")

    def counters():
        return {"fwd": fa.launches, "dq": fa.dq_launches,
                "dkv": fa.dkv_launches, "rms_norm": rms.launches,
                "rms_norm_bwd": rms.bwd_launches, "adamw": adamw.launches,
                "momentum": momentum.launches}

    def checker_on():
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
            enable=True, debug_mode=dbg.DebugMode.CHECK_NAN_INF))
        dbg.enable_operator_stats_collection()

    def checker_off():
        stats = dbg.get_operator_stats()
        dbg.disable_operator_stats_collection()
        dbg.disable_tensor_checker()
        check(not dbg.tensor_checker_results(), "the checker found NaN/Inf")
        return stats

    total = dict.fromkeys(counters(), 0)
    for name, make in optimizer_arms(torch, llama, resnet).items():
        runs = {}
        for mode in ("plain", "checker", "flag", "profiler"):
            model, step, per_step = make()
            step()  # builds the optimizer state: the checked step is second
            torch.cuda.synchronize()
            zero_launch_counters()
            prof = None
            if mode == "checker":
                checker_on()
            elif mode == "flag":
                flags.enable_check_nan_inf()
            elif mode == "profiler":
                prof = paddle.profiler.Profiler(
                    targets=[paddle.profiler.ProfilerTarget.CPU])
                prof.start()
            step()
            torch.cuda.synchronize()
            seen = None
            if mode == "checker":
                seen = checker_off()
            elif mode == "flag":
                flags.disable_check_nan_inf()
            elif prof is not None:
                prof.stop()
                with contextlib.redirect_stdout(io.StringIO()):
                    agg = prof.summary()
                seen = {k: {"calls": v["calls"]} for k, v in agg.items()}
            check(not hooks.active(), f"{mode}: a slot stays set")
            launched = counters()
            check(launched[name] == per_step, f"{name} under {mode}: "
                  f"{launched[name]} launches, want {per_step}")
            if mode != "plain":
                for k in total:
                    total[k] += launched[k]
            runs[mode] = ([p.detach().clone() for p in model.parameters()],
                          launched, seen)
            del model, step
            release_memory(torch)
        plain, launched0, _ = runs["plain"]
        for mode in ("checker", "flag", "profiler"):
            params, launched, seen = runs[mode]
            same = sum(same_bits(torch, a, b) for a, b in zip(params, plain))
            check(same == len(plain) and launched == launched0,
                  f"{name} under {mode}: {same}/{len(plain)} parameters "
                  f"equal, launches {launched} against {launched0}")
            if seen is None:
                continue

            def calls(op):
                entry = seen.get(f"paddle_tpu_torch::{op}", {})
                return entry.get("calls", sum(entry.values()))

            got = {k: calls(k) for k in (
                name, "flash_attention_fwd", "flash_attention_bwd",
                "rms_norm_fwd", "rms_norm_bwd")}
            want = {name: 1 if launched[name] else 0,
                    "flash_attention_fwd": launched["fwd"],
                    "flash_attention_bwd": launched["dq"],
                    "rms_norm_fwd": launched["rms_norm"],
                    "rms_norm_bwd": launched["rms_norm_bwd"]
                    // rms.BWD_LAUNCHES_PER_CALL}
            print(f"(e) {name} step under {mode}: parameters bit for bit "
                  f"the plain step's ({same}/{len(plain)}); operator calls "
                  f"{got}; launches {launched}", flush=True)
            check(got == want and launched["dq"] == launched["dkv"]
                  and launched[name] > 0,
                  f"{name} under {mode}: operator calls {got}, want {want}")
        print(f"(e) {name} step under FLAGS_check_nan_inf: parameters bit "
              f"for bit the plain step's; launches {runs['flag'][1]}",
              flush=True)
    torch.backends.cudnn.deterministic = False
    return total


def phase_recurrent(torch, llama, resnet) -> dict:
    """Phase 24: the recurrent tier and the rest of ``nn`` and ``vision``
    (see :func:`phase_ptb`, :func:`phase_sequence`,
    :func:`phase_vision_ops`, :func:`phase_pipeline` and
    :func:`phase_optimizer_ops`). Returns the PTB figures and (e)'s
    launches."""
    t0 = time.perf_counter()
    ptb = phase_ptb(torch)
    phase_sequence(torch)
    phase_vision_ops(torch)
    phase_pipeline(torch, resnet)
    launches = phase_optimizer_ops(torch, llama, resnet)
    print(f"phase 24 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"ptb": ptb, "launches": launches}


# ------------------------------------------- phase 25, the data-parallel tier
DP_GLOO_RANKS = 2  # (b) and (c): two gloo ranks share the one card
DP_GLOO_STEPS = 3
SBN_IMAGES = 16  # (c): images a rank, 3 x 224 x 224
SBN_LR = 0.1
# (b): the DataParallel step over 2 x 2 rows against one process over the
# 4 rows, in bf16: PERF.md §2's bf16 gate, 2e-2 of the tensor's largest
# value plus one bf16 step of it
DP_BF16_TOL = 2e-2
# (c): SyncBatchNorm in f32 against float64, beside one process's f32
# BatchNorm against float64: within 4x its error, or 1e-5 of the largest
# float64 value
SBN_F64_RATIO, SBN_F64_FLOOR = 4.0, 1e-5
# the profile rows of the collectives (NCCL's kernels)
NCCL_ROW = re.compile(r"nccl|AllReduce", re.IGNORECASE)


def zero_collective_counts() -> None:
    """The collectives' issue counts set to 0."""
    from paddle_tpu_torch.distributed import communication

    for key in communication.launches:
        communication.launches[key] = 0


def collective_checks(torch, dist, what: str, dev=None) -> int:
    """Every collective of ``distributed.communication`` on CUDA tensors
    against numpy's answer, on this rank's own values (``r``: the rank,
    ``n``: the world): the process-level calls, then an ``spmd`` region
    and its gradient. A world of one refuses point to point (the JAX
    package's rule). Returns the number of checks."""
    from paddle_tpu_torch.distributed import P

    if dev is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    r, n = dist.get_rank(), dist.get_world_size()
    checks = []

    def want(name, got, expect):
        if isinstance(got, torch.Tensor):
            got = got.as_subclass(torch.Tensor).detach().cpu()
        ok = np.array_equal(np.asarray(got, dtype=np.float64),
                            np.asarray(expect, dtype=np.float64))
        checks.append(name)
        check(ok, f"{what}: {name} gave {got}, numpy says {expect}")

    def t(values, dtype=torch.float32):
        return torch.tensor(values, dtype=dtype, device=dev)

    ranks = np.arange(n)
    for dtype in (torch.float32, torch.bfloat16, torch.int64):
        x = t([r + 1.0, 2.0 * r], dtype)
        dist.all_reduce(x)
        want(f"all_reduce sum {dtype}", x.float(),
             [(ranks + 1).sum(), (2 * ranks).sum()])
    for name, fn in (("MAX", np.max), ("MIN", np.min), ("PROD", np.prod)):
        x = t([r + 1.0, 5.0 - r])
        dist.all_reduce(x, op=getattr(dist.ReduceOp, name))
        want(f"all_reduce {name}", x, [fn(ranks + 1.0), fn(5.0 - ranks)])
    x = t([r + 1.0])
    dist.all_reduce(x, op=dist.ReduceOp.AVG)
    want("all_reduce avg", x, [(ranks + 1.0).mean()])
    x = t([r * 10.0])
    dist.reduce(x, dst=0)
    want("reduce", x, [(ranks * 10.0).sum()])
    parts = []
    out = dist.all_gather(parts, t([r, r + 0.5]))
    want("all_gather", out, np.stack([ranks, ranks + 0.5], 1))
    want("all_gather list", torch.stack(parts), np.stack([ranks, ranks + 0.5],
                                                         1))
    parts = []
    dist.gather(t([3.0 * r]), parts, dst=0)
    want("gather", torch.stack(parts), (3.0 * ranks)[:, None])
    objs = []
    dist.all_gather_object(objs, {"rank": r, "pair": (r, 2 * r)})
    checks.append("all_gather_object")
    check(objs == [{"rank": j, "pair": [j, 2 * j]} for j in range(n)],
          f"{what}: all_gather_object gave {objs}")
    out = torch.zeros(2, device=dev)
    dist.reduce_scatter(out, t(np.arange(2 * n) * (r + 1.0)))
    want("reduce_scatter", out,
         (np.arange(2 * n) * (ranks + 1.0).sum())[2 * r:2 * r + 2])
    out = torch.zeros(1, device=dev)
    dist.reduce_scatter(out, [t([j + r]) for j in range(n)],
                        op=dist.ReduceOp.MAX)
    want("reduce_scatter list max", out, [r + n - 1.0])
    moved = []
    dist.alltoall([t([10.0 * r + j]) for j in range(n)], moved)
    want("alltoall", torch.cat(moved), 10.0 * ranks + r)
    got = dist.all_to_all([], [t([100.0 * r + j, j]) for j in range(n)])
    want("all_to_all", got, np.stack([100.0 * ranks + r, np.full(n, r)], 1))
    got = dist.all_to_all_single(None, t(np.arange(n) + 7.0 * r))
    want("all_to_all_single", got, r + 7.0 * ranks)
    x = t([r + 0.25])
    dist.broadcast(x, src=n - 1)
    want("broadcast", x, [n - 1 + 0.25])
    x = torch.zeros(2, device=dev)
    dist.scatter(x, [t([j, -j]) for j in range(n)] if r == 0 else None,
                 src=0)
    want("scatter", x, [r, -r])
    g = dist.new_group(axes=("dp",))
    want("shift", dist.shift(t([float(r)]), offset=1, group=g),
         [(r - 1) % n])
    if n == 1:
        for name, fn in (("send", dist.send), ("recv", dist.recv)):
            try:
                fn(t([1.0]), 0)
            except ValueError:
                checks.append(f"{name} to self refused")
            else:
                check(False, f"{what}: {name} to self on a world of one ran")
    else:
        x = t([r + 40.0])
        if r == 0:
            dist.send(x, dst=1)
        elif r == 1:
            dist.recv(x, src=0)
        want("send/recv", x, [40.0 if r < 2 else r + 40.0])
        x = torch.zeros(1, device=dev)
        if r == 0:
            dist.isend(t([9.0]), dst=1).wait()
        elif r == 1:
            dist.irecv(x, src=0).wait()
        want("isend/irecv", x, [9.0 if r == 1 else 0.0])
        x = torch.zeros(1, device=dev)
        dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t([float(r)]), peer=(r + 1) % n),
            dist.P2POp(dist.irecv, x, peer=(r - 1) % n)])
        want("batch_isend_irecv", x, [(r - 1) % n])
    dist.barrier()
    checks.append("barrier")

    @dist.spmd(in_specs=P("dp"), out_specs=P("dp"), axes=("dp",))
    def summed(v):
        dist.all_reduce(v, group=g)
        return v
    base = np.arange(2 * n, dtype=np.float32)
    want("spmd all_reduce", summed(t(base)),
         np.tile(base.reshape(n, 2).sum(0), n))

    @dist.spmd(in_specs=P("dp"), out_specs=P(), axes=("dp",))
    def loss_of(v):
        y = v * v
        dist.all_reduce(y, group=g)
        return y.sum()
    x = t(base).requires_grad_()
    loss_of(x).backward()
    want("spmd gradient", x.grad, 2 * base)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"{what}: {len(checks)} collective checks on CUDA tensors against "
          f"numpy passed ({', '.join(checks)})", flush=True)
    return len(checks)


def dp_graphed(torch, llama, bare: dict) -> dict:
    """(a) One rank over NCCL: ``init_parallel_env()`` in this process,
    then ``DataParallel(llama_124m_gqa)`` under ``TrainStep``, graphed,
    held bit for bit to its eager steps and to phase 12's bare eager
    steps; the collectives on CUDA tensors; the process group destroyed
    after."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import communication
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    cfg = llama.llama_124m_gqa()
    env = dist.init_parallel_env()
    print(f"-- (a) one rank over {env.backend} (world {dist.get_world_size()}"
          f", {dist.get_backend()}, device {env.device}): DataParallel("
          f"llama_124m_gqa) bf16 O2, TrainStep (one CUDA graph a step), "
          f"AdamW(1e-4), {LLAMA_BATCH}x{LLAMA_SEQ} fixed batch", flush=True)
    check(env.backend == "nccl", f"the CUDA world runs {env.backend}")
    n_checks = collective_checks(torch, dist, "(a) NCCL, world of one")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ)).astype(np.int64)).cuda()
    steps = GRAPH_WARMUP + TRAIN_STEPS
    bare_ref = eager_reference(torch, llama.LlamaForCausalLM,
                               llama.LlamaPretrainingCriterion, cfg, ids,
                               steps)
    model, _, eager_step = build_train_step(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion, cfg,
        data_parallel=True)
    dp_ref = ([float(eager_step(ids)) for _ in range(steps)],
              [p.detach().clone() for p in model.parameters()])
    del model, eager_step
    release_memory(torch)
    check(dp_ref[0] == bare_ref[0] and all(
        torch.equal(a, b) for a, b in zip(dp_ref[1], bare_ref[1])),
        "DataParallel's eager steps on one rank differ from the bare "
        "model's")
    print(f"DataParallel's {steps} eager steps: losses and parameters bit "
          f"for bit the bare model's eager steps", flush=True)
    del bare_ref
    model, step, _ = build_train_step(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion, cfg,
        data_parallel=True)
    sizes = model.bucket_sizes
    first, losses, times, counts = run_timed_steps(torch, step, (ids,))
    collectives = dict(communication.launches)
    check_against_eager(torch, "(a) DataParallel graphed", first + losses,
                        [p.detach() for p in model.parameters()], dp_ref)
    del dp_ref
    n = cfg.num_hidden_layers
    per_step = adamw_launches_per_step(model)
    want = n * TRAIN_STEPS
    calls = (2 * n + 1) * TRAIN_STEPS
    print(f"launches K1/K2/K3/K4/AdamW/K4-bwd {counts} over {TRAIN_STEPS} "
          f"replays; collectives issued {collectives} ({len(sizes)} "
          f"buckets a step)", flush=True)
    check(counts == (want, want, want, calls, per_step * TRAIN_STEPS,
                     calls * rms.BWD_LAUNCHES_PER_CALL),
          f"launches {counts}: phase 12 asserts ({want}, {want}, {want}, "
          f"{calls}, {per_step * TRAIN_STEPS}, "
          f"{calls * rms.BWD_LAUNCHES_PER_CALL})")
    check(collectives["all_reduce"] == len(sizes) * TRAIN_STEPS
          and sum(collectives.values()) == collectives["all_reduce"],
          f"collectives {collectives}: want {len(sizes)} all-reduces a step")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(ids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("a replay under set_sync_debug_mode('error'): no host sync",
          flush=True)
    p50 = float(np.median(times))
    flops = llama.llama_flops_per_step(LLAMA_BATCH, LLAMA_SEQ, cfg)
    prof = profile_steps(torch, step, (ids,), p50 * 1e3)
    nccl = [r for r in prof["rows"] if NCCL_ROW.search(r[0])]
    nccl_ms = sum(r[1] for r in nccl)
    nccl_launches = sum(r[2] for r in nccl)
    label = card_label()
    print(f"[{label}] (a) step ms p50 {p50 * 1e3:.3f} (phase 12's bare step "
          f"{bare['p50_ms']:.3f}; min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}); tokens/s "
          f"{LLAMA_BATCH * LLAMA_SEQ / p50:.1f}; MFU "
          f"{flops / p50 / PEAK_FLOPS['bfloat16']:.2%}; launches a step "
          f"{prof['launches']:.0f} (phase 12's {bare['launches_per_step']:.0f}"
          f"), NCCL kernels a step {nccl_launches:.0f} in "
          f"{nccl_ms:.3f} ms (all-reduce class); idle "
          f"{1 - prof['device_ms'] / (p50 * 1e3):.1%}; {len(sizes)} buckets "
          f"a step, {sum(sizes)} bytes ({', '.join(map(str, sizes))})",
          flush=True)
    for key, ms, count in nccl:
        print(f"    NCCL row: {ms:8.3f} ms  x{count:<6.0f} {key[:100]}",
              flush=True)
    del model, step
    release_memory(torch)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived (a)")
    return {"fwd": counts[0], "dq": counts[1], "dkv": counts[2],
            "rms_norm": counts[3], "adamw": counts[4],
            "rms_norm_bwd": counts[5], "p50_ms": p50 * 1e3,
            "nccl_ms": nccl_ms, "nccl_launches": nccl_launches,
            "buckets": len(sizes), "bucket_bytes": sum(sizes),
            "collective_checks": n_checks}


def dp_launched_ranks(torch, llama, backend="gloo",
                      nproc=DP_GLOO_RANKS) -> None:
    """(b) and (c): ``nproc`` ranks over ``backend`` started by the
    launcher (``python -m paddle_tpu_torch.distributed.launch
    --nproc_per_node nproc`` with ``PADDLE_DISTRI_BACKEND``) on this
    script's ``--data-parallel-rank`` mode; this process writes (b)'s
    single-process reference first. A rank's failure fails the launcher,
    and that fails the phase. Phase 25 runs two gloo ranks on the one
    card; on a host of several cards, one NCCL rank a card:

        python3 -c "import torch, chip_smoke as cs; cs.phase_build(); from paddle_tpu_torch.models import llama; cs.dp_launched_ranks(torch, llama, 'nccl', torch.cuda.device_count())"
    """
    cfg = llama.llama_124m_gqa()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ)).astype(np.int64)).cuda()
    losses, params = eager_reference(torch, llama.LlamaForCausalLM,
                                     llama.LlamaPretrainingCriterion, cfg,
                                     ids, DP_GLOO_STEPS)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"losses": losses, "params": [p.cpu() for p in params]},
                   os.path.join(tmp, "reference.pt"))
        del params
        release_memory(torch)
        env = dict(os.environ, PADDLE_DISTRI_BACKEND=backend,
                   PYTHONPATH=root)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", str(nproc), "--log_dir",
             os.path.join(tmp, "logs"), os.path.abspath(__file__),
             "--data-parallel-rank", tmp],
            env=env, cwd=root, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        for r in range(nproc):
            path = os.path.join(tmp, "logs", f"worker.{r}.log")
            text = open(path, errors="replace").read() if os.path.exists(
                path) else ""
            if r == 0 or res.returncode != 0:
                print(f"---- rank {r} of the launched job:\n"
                      + text[-12000:].rstrip(), flush=True)
        print(f"launcher exit {res.returncode} after {wall:.1f} s "
              f"{res.stderr[-2000:]}", flush=True)
        check(res.returncode == 0, f"the launched data-parallel job failed "
              f"(exit {res.returncode})")


def _rank_say(r):
    return (lambda *a: print(*a, flush=True)) if r == 0 else (lambda *a: None)


def _flat_by_dtype(torch, tensors) -> list:
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t.detach().reshape(-1))
    return [torch.cat(g) for g in groups.values()]


def bf16_gate(torch, got, want) -> float:
    """|got - want| over the gate (DP_BF16_TOL of the tensor's largest
    value plus one bf16 step of it): at most 1 passes."""
    want = want.float()
    top = float(want.abs().max())
    room = DP_BF16_TOL * top + 2.0 ** -7 * top
    err = float((got.float().cpu() - want.cpu()).abs().max())
    return err / room if room > 0 else (0.0 if err == 0 else math.inf)


def dp_rank_llama(torch, dist, llama, out_dir, say) -> None:
    """(b) DataParallel(llama_124m_gqa) bf16 O2 over the ranks (eager on
    gloo; on NCCL the first step eager, then captured and replayed), each
    rank on its rows of the 4 x 2048 batch: the ranks' parameters equal
    bit for bit after every step; the mean of their losses and the
    parameters within the bf16 gate of one process's steps over the 4
    rows (rank 0 checks)."""
    r, n = dist.get_rank(), dist.get_world_size()
    gloo = dist.get_backend() == "gloo"
    cfg = llama.llama_124m_gqa()
    model, step, _ = build_train_step(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion, cfg,
        data_parallel=True)
    mode = "eager on gloo" if gloo else "one CUDA graph a step"
    say(f"-- (b) {n} ranks over {dist.get_backend()}: DataParallel("
        f"llama_124m_gqa) bf16 O2, TrainStep ({mode}), AdamW(1e-4), "
        f"{LLAMA_BATCH // n}x{LLAMA_SEQ} rows a rank of the "
        f"{LLAMA_BATCH}x{LLAMA_SEQ} batch; {len(model.bucket_sizes)} "
        f"buckets, {sum(model.bucket_sizes)} bytes")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ)).astype(np.int64)).cuda()
    mine = dist.shard_batch(ids)
    losses, times = [], []
    for i in range(DP_GLOO_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(mine)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        mean = loss.as_subclass(torch.Tensor).detach().float().clone()
        dist.all_reduce(mean, op=dist.ReduceOp.AVG)
        losses.append(float(mean))
        for flat in _flat_by_dtype(torch, model.parameters()):
            theirs = flat.clone()
            dist.broadcast(theirs, src=0)
            check(torch.equal(flat, theirs), f"(b) rank {r}'s parameters "
                  f"differ from rank 0's after step {i + 1}")
    want = ({"compiled_steps": 0, "eager_steps": DP_GLOO_STEPS} if gloo
            else {"compiled_steps": DP_GLOO_STEPS - 1, "eager_steps": 1})
    check(step.stats == want, f"(b) steps {step.stats}, want {want}")
    if r == 0:
        ref = torch.load(os.path.join(out_dir, "reference.pt"))
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                           ref["losses"]))
        worst = max(bf16_gate(torch, p.detach(), q) for p, q in
                    zip(model.parameters(), ref["params"]))
        say(f"[{card_label()}] (b) mean losses {losses} against one "
            f"process's {ref['losses']} (largest relative gap "
            f"{loss_gap:.3g}, gate {DP_BF16_TOL}); parameters at "
            f"{worst:.3f} of the bf16 gate at worst; ranks equal bit for "
            f"bit after each of {DP_GLOO_STEPS} steps; step ms "
            f"{', '.join(f'{t * 1e3:.1f}' for t in times)}"
            + (" (host-bound by design: gloo stages every bucket through "
               "the host)" if gloo else ""))
        check(loss_gap <= DP_BF16_TOL and worst <= 1.0,
              f"(b) losses {losses} against {ref['losses']}, parameters at "
              f"{worst:.3f} of the gate")
    del model, step
    release_memory(torch)


def dp_rank_sampler(torch, dist, say) -> None:
    """(b) A ``DistributedBatchSampler`` epoch over the ranks covers the
    dataset once (padded to a multiple of the ranks)."""
    import paddle_tpu_torch as paddle

    rows = 37
    sampler = paddle.io.DistributedBatchSampler(
        paddle.io.TensorDataset([np.arange(rows)]), batch_size=4,
        shuffle=True)
    sampler.set_epoch(1)
    mine = [i for b in sampler for i in b]
    seen = []
    dist.all_gather_object(seen, mine)
    every = [i for part in seen for i in part]
    n = dist.get_world_size()
    padded = -(-rows // n) * n
    say(f"(b) DistributedBatchSampler over {n} ranks: {len(every)} indices "
        f"for {rows} rows ({sorted(set(every)) == list(range(rows))} that "
        f"every row came)")
    check(sorted(set(every)) == list(range(rows)) and len(every) == padded,
          f"(b) the sampler's epoch over the ranks {seen}")


def dp_rank_sync_batch_norm(torch, dist, resnet, say, dev="cuda",
                            size=224) -> None:
    """(c) ResNet-50's stem and first stage with every BatchNorm converted
    to ``SyncBatchNorm``, under ``DataParallel``, one Momentum train step
    over the ranks' 16 x 3 x 224² images each: the outputs, every running
    stat and every gradient against one process's BatchNorm over the 32
    images in float64, beside that process's own f32 run (rank 0
    checks)."""
    import copy

    from paddle_tpu_torch import DataParallel, nn
    from paddle_tpu_torch.optimizer import Momentum

    r, n = dist.get_rank(), dist.get_world_size()
    full = resnet.resnet50(generator=torch.Generator().manual_seed(25),
                           device=dev)
    stem = nn.Sequential(full.conv1, full.bn1, full.relu, full.maxpool,
                         full.layer1).train()
    del full
    twin = copy.deepcopy(stem)
    sync = nn.SyncBatchNorm.convert_sync_batchnorm(stem)
    n_sync = sum(isinstance(m, nn.SyncBatchNorm) for m in sync.modules())
    dp = DataParallel(sync)
    gen = torch.Generator().manual_seed(26)
    x_all = torch.randn(SBN_IMAGES * n, 3, size, size, generator=gen).to(dev)
    w_all = torch.randn(SBN_IMAGES * n, 256, size // 4, size // 4,
                        generator=gen).to(dev)
    x, w = dist.shard_batch(x_all), dist.shard_batch(w_all)
    opt = Momentum(learning_rate=SBN_LR, momentum=0.9,
                   parameters=dp.parameters(), device=dev)
    y = dp(x)
    (y * w).mean().backward()
    grads = [p.grad.detach().clone() for p in dp.parameters()]
    opt.step()
    opt.clear_grad()
    ys = dist.all_gather(None, y.detach()).as_subclass(torch.Tensor)
    ys = ys.reshape(x_all.shape[0], *y.shape[1:])
    stats = [b.detach().clone() for b in sync.buffers()]
    if r != 0:
        return

    def reference(net):
        out = net(x_all.to(net.parameters()[0].dtype))
        (out * w_all.to(out.dtype)).mean().backward()
        return (out.detach(), [p.grad.detach() for p in net.parameters()],
                [b.detach() for b in net.buffers()])

    exact = reference(copy.deepcopy(twin).double())
    single = reference(twin)

    def err(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    rows = []
    for name, got, one, want in (
            [("output", ys, single[0], exact[0])]
            + [(f"grad {i}", g, s, e) for i, (g, s, e) in
               enumerate(zip(grads, single[1], exact[1]))]
            + [(f"stat {i}", g, s, e) for i, (g, s, e) in
               enumerate(zip(stats, single[2], exact[2]))
               if e.is_floating_point()]):
        e_sync, e_one = err(got, want), err(one, want)
        rows.append((name, e_sync, e_one))
        check(e_sync <= max(SBN_F64_RATIO * e_one, SBN_F64_FLOOR),
              f"(c) {name}: SyncBatchNorm {e_sync:.3g} from float64, one "
              f"process's BatchNorm {e_one:.3g}")
    worst = max(rows, key=lambda t: t[1])
    say(f"[{card_label()}] (c) {n_sync} SyncBatchNorms over {n} ranks x "
        f"{SBN_IMAGES} images against one process's BatchNorm over "
        f"{SBN_IMAGES * n} in float64: {len(rows)} tensors (output, "
        f"{len(grads)} gradients, running stats), the largest relative "
        f"error {worst[1]:.3g} ({worst[0]}; one process's f32 run "
        f"{worst[2]:.3g} there); output {rows[0][1]:.3g} (one process "
        f"{rows[0][2]:.3g}); a Momentum step taken")


def dp_rank_main(out_dir: str) -> int:
    """One rank of phase 25 (b) and (c), started by the launcher."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.vision.models import resnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    r = dist.get_rank()
    say = _rank_say(r)
    t0 = time.perf_counter()
    asked = os.environ["PADDLE_DISTRI_BACKEND"]
    check(dist.get_backend() == asked, f"rank {r} runs "
          f"{dist.get_backend()}, the launch asked for {asked}")
    collective_checks(torch, dist, f"(b) {asked}, rank {r} of "
                      f"{dist.get_world_size()}")
    dp_rank_llama(torch, dist, llama, out_dir, say)
    dp_rank_sampler(torch, dist, say)
    dp_rank_sync_batch_norm(torch, dist, resnet, say)
    dist.barrier()
    say(f"ranks' work took {time.perf_counter() - t0:.1f} s")
    dist.destroy_process_group()
    return 0


def phase_data_parallel(torch, llama, bare: dict) -> dict:
    """Phase 25: (a) one NCCL rank in this process, graphed; (b) and (c)
    two gloo ranks on the card through the launcher. Returns (a)'s
    launches."""
    t0 = time.perf_counter()
    print(f"== data parallel [{card_label()}]", flush=True)
    out = dp_graphed(torch, llama, bare)
    dp_launched_ranks(torch, llama)
    print(f"phase 25 took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ------------------------ phase 26, the tensor-, sequence- and context-
# parallel tier
FLEET_RANKS = 2  # (b) and (c): two gloo ranks share the one card
FLEET_STEPS = 3
FLEET_SEED = 26  # the JAX-layout state every layout of (a) and (b) loads
# (b): llama_124m_gqa at full width in three layouts over the 2 ranks: the
# mesh's degrees and the config's flags
FLEET_LAYOUTS = (
    ("mp2_sp", {"mp": 2}, {"tensor_parallel": True,
                           "sequence_parallel": True}),
    ("sep2_ring", {"sep": 2}, {"context_parallel": "ring"}),
    ("sep2_ulysses", {"sep": 2}, {"context_parallel": "ulysses"}))
GPT_TP_BATCH, GPT_TP_SEQ = 4, 1024  # (c): gpt2_small at mp = 2
# the launch counters a fleet step reads: K1, K2, K3, K4, AdamW, K4's
# backward
FLEET_KEYS = ("fwd", "dq", "dkv", "rms_norm", "adamw", "rms_norm_bwd")


def fleet_init(fleet, degrees: dict):
    """``fleet.init`` with the mesh's ``degrees`` (every other one 1)."""
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": degrees.get("dp", 1),
                         "mp_degree": degrees.get("mp", 1),
                         "sep_degree": degrees.get("sep", 1)}
    fleet.init(is_collective=True, strategy=st)
    return fleet.get_hybrid_communicate_group()


def launch_counts() -> dict:
    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    return dict(zip(FLEET_KEYS, (fa.launches, fa.dq_launches,
                                 fa.dkv_launches, rms.launches,
                                 adamw.launches, rms.bwd_launches)))


def llama_fleet_counts(cfg, per_step_adamw: int, k1_blocks: int) -> dict:
    """The launches one Llama step makes on a rank: ``k1_blocks`` K1 (and
    K2, K3) a layer, K4 twice a layer and once at the end, its backward
    ``BWD_LAUNCHES_PER_CALL`` a call, AdamW ``per_step_adamw``."""
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    n = cfg.num_hidden_layers
    attn = n * k1_blocks
    calls = 2 * n + 1
    return dict(zip(FLEET_KEYS, (attn, attn, attn, calls, per_step_adamw,
                                 calls * rms.BWD_LAUNCHES_PER_CALL)))


def fleet_graphed(torch, llama, bare: dict) -> dict:
    """(a) A world of one over NCCL in this process: ``fleet.init`` with
    every degree 1, then ``fleet.distributed_model`` of llama_124m_gqa with
    ``tensor_parallel`` and ``sequence_parallel`` under ``TrainStep``,
    graphed (one CUDA graph a step, the mpu autograd ops inside), held bit
    for bit to its eager steps and to the bare model's eager steps, all
    from one ``load_jax_state``; the launches phase 12's; one replay under
    ``set_sync_debug_mode("error")``. The process group is destroyed
    after."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import communication, fleet
    from paddle_tpu_torch.distributed.fleet import mpu

    cfg = llama.llama_124m_gqa()
    tp_cfg = llama.llama_124m_gqa(tensor_parallel=True,
                                  sequence_parallel=True)
    hcg = fleet_init(fleet, {})
    backend = dist.get_backend()
    print(f"-- (a) fleet.init over {backend}, world "
          f"{dist.get_world_size()}, degrees dp/mp/pp/sharding/sep "
          f"{hcg.get_data_parallel_world_size()}/"
          f"{hcg.get_model_parallel_world_size()}/"
          f"{hcg.get_pipe_parallel_world_size()}/"
          f"{hcg.get_sharding_parallel_world_size()}/"
          f"{hcg.get_sep_parallel_world_size()}: fleet.distributed_model("
          f"llama_124m_gqa tensor_parallel + sequence_parallel) bf16 O2, "
          f"TrainStep, AdamW(1e-4), {LLAMA_BATCH}x{LLAMA_SEQ} fixed batch",
          flush=True)
    check(backend == "nccl", f"the CUDA world runs {backend}")
    state = seeded_llama_state(torch, llama, cfg, FLEET_SEED)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ)).astype(np.int64)).cuda()
    steps = GRAPH_WARMUP + TRAIN_STEPS
    bare_ref = eager_reference(torch, llama.LlamaForCausalLM,
                               llama.LlamaPretrainingCriterion, cfg, ids,
                               steps, state=state)

    def build():
        return build_train_step(
            torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion,
            tp_cfg, wrap=fleet.distributed_model, state=state)

    model, _, eager_step = build()
    check(isinstance(model.llama.layers[0].self_attn.qkv_proj,
                     mpu.ColumnParallelLinear), "(a) the model holds no "
          "tensor-parallel layer")
    tp_ref = ([float(eager_step(ids)) for _ in range(steps)],
              [p.detach().clone() for p in model.parameters()])
    del model, eager_step
    release_memory(torch)
    check(tp_ref[0] == bare_ref[0] and all(
        torch.equal(a, b) for a, b in zip(tp_ref[1], bare_ref[1])),
        "(a) the tensor-parallel model's eager steps on one rank differ "
        "from the bare model's")
    print(f"(a) the tensor-parallel model's {steps} eager steps: losses and "
          f"parameters bit for bit the bare model's eager steps", flush=True)
    del bare_ref
    model, step, _ = build()
    for key in mpu.op_calls:
        mpu.op_calls[key] = 0
    first, losses, times, counts = run_timed_steps(torch, step, (ids,))
    ops = {k: v for k, v in mpu.op_calls.items() if v}
    collectives = dict(communication.launches)
    check_against_eager(torch, "(a) tensor-parallel graphed", first + losses,
                        [p.detach() for p in model.parameters()], tp_ref)
    del tp_ref
    per_step = adamw_launches_per_step(model)
    want = llama_fleet_counts(cfg, per_step, 1)
    got = dict(zip(FLEET_KEYS, counts))
    print(f"(a) launches over {TRAIN_STEPS} replays {got}; mpu ops applied "
          f"in the eager call and the capture {ops}; collectives issued "
          f"{collectives} (a world of one: every mpu op is the identity)",
          flush=True)
    check(got == {k: v * TRAIN_STEPS for k, v in want.items()},
          f"(a) launches {got}: phase 12's are {want} a step")
    check(ops.get("copy", 0) + ops.get("all_gather_seq", 0) > 0
          and ops.get("reduce_scatter_seq", 0) > 0,
          f"(a) the step ran no mpu op: {ops}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(ids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("(a) a replay under set_sync_debug_mode('error'): no host sync",
          flush=True)
    p50 = float(np.median(times))
    prof = profile_steps(torch, step, (ids,), p50 * 1e3)
    print(f"[{card_label()}] (a) step ms p50 {p50 * 1e3:.3f} (phase 12's "
          f"bare step {bare['p50_ms']:.3f}; min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}); launches a step {prof['launches']:.0f} "
          f"(phase 12's {bare['launches_per_step']:.0f}); idle "
          f"{1 - prof['device_ms'] / (p50 * 1e3):.1%}", flush=True)
    del model, step
    release_memory(torch)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived (a)")
    return {**got, "p50_ms": p50 * 1e3, "launches_per_step":
            prof["launches"], "idle": 1 - prof["device_ms"] / (p50 * 1e3)}


def jax_layout_params(torch, model) -> dict:
    """``model``'s parameters whole (gathered over ``mp``; collective) in
    the JAX layout, on the CPU, by name."""
    from paddle_tpu_torch.models.gpt import jax_state_dict

    return {k: v.cpu() for k, v in jax_state_dict(model).items()}


def jax_layout_grads(torch, model) -> dict:
    """``model``'s gradients whole (gathered over ``mp``; collective) in the
    JAX layout, on the CPU, by name."""
    from paddle_tpu_torch.distributed.fleet import mpu

    cut = mpu.sharded_params(model)
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.detach()
        if name in cut:
            g = mpu.gather_param(g, cut[name])
        out[name] = (g.t() if name in linear else g).cpu()
    return out


def o2_loss(torch, kind, model, crit, ids):
    """bench.py's O2 forward (the model under ``auto_cast``, the criterion
    outside it): the logits (BERT: the MLM logits) and the loss (BERT: the
    MLM cross entropy against the ids plus the NSP one against the first
    id's parity)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F

    with amp.auto_cast(level="O2", dtype="bfloat16"):
        out = model(ids)
    if kind != "bert":
        return out, crit(out, ids)
    logits, nsp = out
    mlm = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          ids.reshape(-1))
    return logits, mlm + F.cross_entropy(nsp, ids[:, 0] % 2)


def other_model(torch, gpt, bert, kind, parallel: bool, state=None):
    """(c)'s models, bf16 O2, dropout 0: gpt2_small (its tied head
    vocab-parallel under ``parallel``) or ERNIE-base's
    ``BertForPretraining``; from the JAX-layout ``state`` when given."""
    from paddle_tpu_torch import amp

    flags = {"tensor_parallel": parallel}
    if kind == "gpt":
        cfg = gpt.gpt2_small(hidden_dropout_prob=0.0,
                             attention_dropout_prob=0.0, **flags)
        model = gpt.GPTForCausalLM(cfg,
                                   generator=torch.Generator().manual_seed(0))
        crit = gpt.GPTPretrainingCriterion(cfg)
    else:
        cfg = bert.ernie_base(hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0, **flags)
        model = bert.BertForPretraining(
            cfg, generator=torch.Generator().manual_seed(0))
        crit = None
    if state is not None:
        gpt.load_jax_state(model, state)
    amp.decorate(model.train(), level="O2", dtype="bfloat16")
    return model, crit


def other_ids(torch, kind):
    if kind == "gpt":
        shape, vocab = (GPT_TP_BATCH, GPT_TP_SEQ), 50304
    else:
        shape, vocab = (BERT_BATCH, BERT_SEQ), 40000
    return torch.from_numpy(np.random.RandomState(1).randint(
        0, vocab, shape).astype(np.int64)).cuda()


def fleet_references(torch, llama, gpt, bert, out_dir) -> None:
    """One process's references for (b) and (c), written to
    ``out_dir/reference.pt``: the JAX-layout llama state and
    ``FLEET_STEPS`` eager steps from it (losses, parameters); gpt2_small's
    and ERNIE's states and one forward/backward each (loss, logits,
    gradients)."""
    from paddle_tpu_torch.models.gpt import jax_state_dict

    cfg = llama.llama_124m_gqa()
    state = seeded_llama_state(torch, llama, cfg, FLEET_SEED)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ)).astype(np.int64)).cuda()
    model, _, eager_step = build_train_step(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion, cfg,
        state=state)
    ref = {"llama_state": state,
           "llama_losses": [float(eager_step(ids)) for _ in
                            range(FLEET_STEPS)],
           "llama_params": jax_layout_params(torch, model)}
    del model, eager_step
    release_memory(torch)
    for kind in ("gpt", "bert"):
        model, crit = other_model(torch, gpt, bert, kind, False)
        ref[f"{kind}_state"] = {k: v.float().cpu().numpy() for k, v in
                                jax_state_dict(model).items()}
        logits, loss = o2_loss(torch, kind, model, crit,
                               other_ids(torch, kind))
        loss.backward()
        ref[f"{kind}_loss"] = float(loss.detach())
        if kind == "bert":
            ref["bert_logits"] = logits.detach().cpu()
        ref[f"{kind}_grads"] = jax_layout_grads(torch, model)
        del model, logits, loss
        release_memory(torch)
    torch.save(ref, os.path.join(out_dir, "reference.pt"))


def fleet_rank_llama(torch, dist, fleet, llama, layout, ref, say) -> dict:
    """(b) One layout of llama_124m_gqa over the 2 ranks, bf16 O2, 3 eager
    AdamW steps of ``fleet.distributed_model(model)`` under ``TrainStep``
    (eager on gloo) from the reference's JAX-layout state, every rank on
    the whole 4 x 2048 batch (under ``sep`` the model cuts each row's 1024
    positions of the rank): after every step the replicated parameters
    bit-equal on the ranks and the loss equal; K1-K4 and AdamW launch what
    the layout predicts on this rank; the losses and the gathered
    parameters within the bf16 gate of one process's steps (rank 0
    checks). Returns this rank's launches over the steps."""
    from paddle_tpu_torch.distributed.fleet import context_parallel, mpu
    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    name, degrees, flags = layout
    hcg = fleet_init(fleet, degrees)
    r = dist.get_rank()
    cfg = llama.llama_124m_gqa(**flags)
    model, step, _ = build_train_step(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion, cfg,
        wrap=fleet.distributed_model, state=ref["llama_state"])
    inner = getattr(model, "_layers", model)
    cut = mpu.sharded_params(inner)
    replicated = [p for n, p in inner.named_parameters() if n not in cut]
    sep_rank = hcg.get_sep_parallel_rank()
    blocks = (len(context_parallel.ring_blocks(
        sep_rank, hcg.get_sep_parallel_world_size(), True))
        if flags.get("context_parallel") == "ring" else 1)
    want = llama_fleet_counts(cfg, adamw_launches_per_step(inner), blocks)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ)).astype(np.int64)).cuda()
    losses, times, total = [], [], dict.fromkeys(FLEET_KEYS, 0)
    for i in range(FLEET_STEPS):
        fa.launches = fa.dq_launches = fa.dkv_launches = rms.launches = 0
        adamw.launches = rms.bwd_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = launch_counts()
        check(got == want, f"(b) {name} rank {r} step {i + 1}: launches "
              f"{got}, the layout predicts {want}")
        for k in FLEET_KEYS:
            total[k] += got[k]
        value = loss.as_subclass(torch.Tensor).detach().float().reshape(1)
        theirs = value.clone()
        dist.broadcast(theirs, src=0)
        check(torch.equal(value, theirs), f"(b) {name} rank {r}'s loss "
              f"differs from rank 0's at step {i + 1}")
        losses.append(float(value))
        for flat in _flat_by_dtype(torch, replicated):
            theirs = flat.clone()
            dist.broadcast(theirs, src=0)
            check(torch.equal(flat, theirs), f"(b) {name} rank {r}'s "
                  f"replicated parameters differ from rank 0's after step "
                  f"{i + 1}")
    check(step.stats == {"compiled_steps": 0, "eager_steps": FLEET_STEPS},
          f"(b) {name} steps {step.stats}")
    params = jax_layout_params(torch, inner)
    if r == 0:
        want_losses = ref["llama_losses"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
        worst = max(bf16_gate(torch, params[k], v)
                    for k, v in ref["llama_params"].items())
        say(f"[{card_label()}] (b) {name}: {len(cut)} parameters cut over "
            f"mp, {len(replicated)} replicated (bit-equal on the ranks "
            f"after each step); losses {losses} against one process's "
            f"{want_losses} (largest relative gap {gap:.3g}, gate "
            f"{DP_BF16_TOL}); parameters at {worst:.3f} of the bf16 gate at "
            f"worst; launches a step on rank 0 {want}; step ms "
            f"{', '.join(f'{t * 1e3:.1f}' for t in times)} (eager on gloo, "
            f"host-bound by design)")
        check(gap <= DP_BF16_TOL and worst <= 1.0,
              f"(b) {name}: losses {losses} against {want_losses}, "
              f"parameters at {worst:.3f} of the gate")
    del model, step, inner, params
    release_memory(torch)
    return total


def fleet_rank_other(torch, dist, fleet, gpt, bert, ref, say) -> None:
    """(c) gpt2_small with its tied vocab-parallel head and
    ``ParallelCrossEntropy``, and ERNIE-base's ``BertForPretraining``, at
    mp = 2, bf16 O2: one forward/backward from the reference's state, the
    loss and every gathered gradient (and ERNIE's logits) within the bf16
    gate of one process's; then gpt2_small at hidden and attention dropout
    0.1: each block's output (the replicated residual stream) equal bit
    for bit on the two ranks."""
    fleet_init(fleet, {"mp": 2})
    r = dist.get_rank()
    for kind in ("gpt", "bert"):
        model, crit = other_model(torch, gpt, bert, kind, True,
                                  ref[f"{kind}_state"])
        model = fleet.distributed_model(model)
        logits, loss = o2_loss(torch, kind, model, crit,
                               other_ids(torch, kind))
        loss.backward()
        grads = jax_layout_grads(torch, model)
        if r == 0:
            value = float(loss.detach())
            gap = abs(value - ref[f"{kind}_loss"]) / abs(ref[f"{kind}_loss"])
            worst = max(bf16_gate(torch, grads[k], v)
                        for k, v in ref[f"{kind}_grads"].items())
            extra = ""
            if kind == "bert":
                at = bf16_gate(torch, logits.detach(), ref["bert_logits"])
                worst = max(worst, at)
                extra = f"; logits at {at:.3f} of the gate"
            say(f"[{card_label()}] (c) {kind} at mp = 2: loss "
                f"{value:.5f} against one process's "
                f"{ref[f'{kind}_loss']:.5f} (relative gap {gap:.3g}); "
                f"{len(grads)} gathered gradients at {worst:.3f} of the bf16 "
                f"gate at worst{extra}")
            check(gap <= DP_BF16_TOL and worst <= 1.0,
                  f"(c) {kind}: loss gap {gap:.3g}, gradients at "
                  f"{worst:.3f} of the gate")
        del model, logits, loss, grads
        release_memory(torch)
    cfg = gpt.gpt2_small(tensor_parallel=True, hidden_dropout_prob=0.1,
                         attention_dropout_prob=0.1)
    model = gpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(0),
                               dropout_seed=3).train()
    seen = []
    for block in model.gpt.h:
        block.register_forward_hook(
            lambda m, a, y: seen.append(y.detach().clone()))
    ids = other_ids(torch, "gpt")
    loss = gpt.GPTPretrainingCriterion(cfg)(model(ids), ids)
    loss.backward()
    equal = 0
    for t in seen + [loss.detach().reshape(1)]:
        theirs = t.clone()
        dist.broadcast(theirs, src=0)
        equal += int(torch.equal(t, theirs))
    say(f"(c) gpt2_small at dropout 0.1 over mp = 2: {equal} of "
        f"{len(seen) + 1} residual streams and the loss bit-equal on the "
        f"ranks")
    check(equal == len(seen) + 1, f"(c) rank {r}: {equal} of "
          f"{len(seen) + 1} replicated streams equal rank 0's at dropout 0.1")
    del model, loss, seen
    release_memory(torch)


def fleet_rank_main(out_dir: str) -> int:
    """One rank of phase 26 (b) and (c), started by the launcher; rank 0
    writes its launches by layout to ``out_dir/counts.json``."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import bert, gpt, llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    r = dist.get_rank()
    say = _rank_say(r)
    t0 = time.perf_counter()
    asked = os.environ["PADDLE_DISTRI_BACKEND"]
    check(dist.get_backend() == asked, f"rank {r} runs "
          f"{dist.get_backend()}, the launch asked for {asked}")
    ref = torch.load(os.path.join(out_dir, "reference.pt"),
                     weights_only=False)
    counts = {layout[0]: fleet_rank_llama(torch, dist, fleet, llama, layout,
                                          ref, say)
              for layout in FLEET_LAYOUTS}
    fleet_rank_other(torch, dist, fleet, gpt, bert, ref, say)
    if r == 0:
        with open(os.path.join(out_dir, "counts.json"), "w") as f:
            json.dump(counts, f)
    dist.barrier()
    say(f"ranks' work took {time.perf_counter() - t0:.1f} s")
    dist.destroy_process_group()
    return 0


def fleet_launched_ranks(torch, llama, gpt, bert) -> dict:
    """(b) and (c): two gloo ranks on the card started by the launcher
    (``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2``
    with ``PADDLE_DISTRI_BACKEND=gloo``) on this script's ``--fleet-rank``
    mode, after this process writes one process's references. A rank's
    failure fails the launcher, and that fails the phase. Returns rank 0's
    launches by layout."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fleet_references(torch, llama, gpt, bert, tmp)
        print(f"(b)/(c) one process's references took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        env = dict(os.environ, PADDLE_DISTRI_BACKEND="gloo", PYTHONPATH=root)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", str(FLEET_RANKS), "--log_dir",
             os.path.join(tmp, "logs"), os.path.abspath(__file__),
             "--fleet-rank", tmp],
            env=env, cwd=root, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        for r in range(FLEET_RANKS):
            path = os.path.join(tmp, "logs", f"worker.{r}.log")
            text = open(path, errors="replace").read() if os.path.exists(
                path) else ""
            if r == 0 or res.returncode != 0:
                print(f"---- rank {r} of the launched job:\n"
                      + text[-12000:].rstrip(), flush=True)
        print(f"launcher exit {res.returncode} after {wall:.1f} s "
              f"{res.stderr[-2000:]}", flush=True)
        check(res.returncode == 0, f"the launched fleet job failed (exit "
              f"{res.returncode})")
        with open(os.path.join(tmp, "counts.json")) as f:
            return json.load(f)


def phase_fleet(torch, llama, gpt, bert, bare: dict) -> dict:
    """Phase 26: (a) a world of one over NCCL in this process, graphed;
    (b) and (c) two gloo ranks on the card through the launcher. Returns
    the launches of K1-K4 and AdamW on the tensor-parallel path ((a)'s
    replays and rank 0's mp = 2 steps) and on the context-parallel path
    (rank 0's ring and Ulysses steps)."""
    t0 = time.perf_counter()
    print(f"== fleet: tensor, sequence and context parallel "
          f"[{card_label()}]", flush=True)
    graphed = fleet_graphed(torch, llama, bare)
    ranks = fleet_launched_ranks(torch, llama, gpt, bert)
    print(f"phase 26 took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"graphed": graphed,
            "tensor_parallel": {k: graphed[k] + ranks["mp2_sp"][k]
                                for k in FLEET_KEYS},
            "context_parallel": {k: ranks["sep2_ring"][k]
                                 + ranks["sep2_ulysses"][k]
                                 for k in FLEET_KEYS}}


# the four-card run of phase 26 (not part of the one-card run):
# python3 -c "import chip_smoke as cs; cs.fleet_four_cards()" on 4 cards
FOUR_TP_SEQ = 4096  # llama2_7b at mp = 4 with SP: 1 x 4096 tokens
FOUR_RING_SEQ = 16384  # llama_124m_gqa in a ring of sep = 4: 1 x 16384
FOUR_STEPS = 3


def nccl_rows(rows) -> dict:
    """The NCCL kernels' device ms and launches a step, by collective."""
    out = {}
    for key, ms, count in rows:
        if not NCCL_ROW.search(key) and "nccl" not in key.lower():
            continue
        kind = next((k for k in ("AllReduce", "AllGather", "ReduceScatter",
                                 "SendRecv", "Send", "Recv")
                     if k.lower() in key.lower()), "other")
        ms0, n0 = out.get(kind, (0.0, 0.0))
        out[kind] = (ms0 + ms, n0 + count)
    return out


def four_rank_tp(torch, dist, fleet, llama, say) -> None:
    """llama2_7b at full width, mp = 4 with sequence parallelism, graphed
    (one CUDA graph a step over NCCL), 1 x 4096 tokens: the step p50, the
    NCCL device ms by collective, the launches and the idle share."""
    fleet_init(fleet, {"mp": 4})
    layers = int(os.environ.get("FOUR_TP_LAYERS", "32"))
    cfg = llama.llama2_7b(tensor_parallel=True, sequence_parallel=True,
                          num_hidden_layers=layers)
    t0 = time.perf_counter()
    model, step, _ = build_train_step(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion, cfg,
        wrap=fleet.distributed_model)
    say(f"-- llama2_7b ({layers} layers, hidden 4096, 32 heads, SwiGLU "
        f"11008) at mp = 4 with SP over NCCL, bf16 O2, TrainStep, "
        f"AdamW(1e-4), 1x{FOUR_TP_SEQ}; built in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"parameters on this rank")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, FOUR_TP_SEQ)).astype(np.int64)).cuda()
    first = [float(step(ids)) for _ in range(GRAPH_WARMUP)]
    torch.cuda.synchronize()
    stats = dict(step.stats)
    times, losses = [], []
    for _ in range(FOUR_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(step(ids)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    ran = {k: step.stats[k] - stats[k] for k in stats}
    check(ran == {"compiled_steps": FOUR_STEPS, "eager_steps": 0},
          f"the timed steps {ran} did not all replay")
    p50 = float(np.median(times))
    prof = profile_steps(torch, step, (ids,), p50 * 1e3)
    nccl = nccl_rows(prof["rows"])
    flops = llama.llama_flops_per_step(1, FOUR_TP_SEQ, llama.llama2_7b(
        num_hidden_layers=layers))
    say(f"[{card_label()}] llama2_7b mp = 4 SP: losses {first + losses}; "
        f"step ms p50 {p50 * 1e3:.3f} (min {min(times) * 1e3:.3f}, max "
        f"{max(times) * 1e3:.3f}); tokens/s {FOUR_TP_SEQ / p50:.1f}; MFU "
        f"{flops / 4 / p50 / PEAK_FLOPS['bfloat16']:.2%} a card; launches "
        f"a step {prof['launches']:.0f}; idle "
        f"{1 - prof['device_ms'] / (p50 * 1e3):.1%}; NCCL by collective "
        f"(ms, launches a step) {nccl}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(all(math.isfinite(x) for x in first + losses), "non-finite loss")
    del model, step
    release_memory(torch)


def four_rank_ring(torch, dist, fleet, llama, say) -> None:
    """llama_124m_gqa in a ring of sep = 4 over 1 x 16384 tokens (4096 a
    rank), bf16 O2: ``GRAPH_WARMUP + FOUR_STEPS`` eager steps by hand, then
    as many under ``TrainStep`` on a second model from the same seed (one
    CUDA graph a step over NCCL, the ring's point-to-point exchanges and
    the ``("dp", "sep")`` all-reduce inside), its losses and parameters bit
    for bit the eager steps'; the eager and the graphed step p50, the NCCL
    device ms, K1's blocks a rank, the idle share."""
    from paddle_tpu_torch.distributed.fleet import context_parallel

    hcg = fleet_init(fleet, {"sep": 4})
    cfg = llama.llama_124m_gqa(context_parallel="ring",
                               max_position_embeddings=FOUR_RING_SEQ)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, FOUR_RING_SEQ)).astype(np.int64)).cuda()
    steps = GRAPH_WARMUP + FOUR_STEPS

    def run(one_step):
        losses, times = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(one_step(ids)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return losses, float(np.median(times[GRAPH_WARMUP:]))

    model, _, eager_step = build_train_step(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion, cfg,
        wrap=fleet.distributed_model)
    eager_losses, eager_p50 = run(eager_step)
    eager_params = [p.detach().clone() for p in model.parameters()]
    del model, eager_step
    release_memory(torch)
    model, step, _ = build_train_step(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion, cfg,
        wrap=fleet.distributed_model)
    stats = dict(step.stats)
    losses, p50 = run(step)
    ran = {k: step.stats[k] - stats[k] for k in stats}
    check(ran["compiled_steps"] >= FOUR_STEPS,
          f"the ring's steps {ran} were not graphed")
    same = [torch.equal(a, b) for a, b in zip(model.parameters(),
                                              eager_params)]
    prof = profile_steps(torch, step, (ids,), p50 * 1e3)
    blocks = len(context_parallel.ring_blocks(
        hcg.get_sep_parallel_rank(), 4, True))
    print(f"[{card_label()}] rank {dist.get_rank()} ring sep = 4: "
          f"{blocks} K1 blocks a layer; steps {ran}; losses {losses} "
          f"(eager {eager_losses}: bitwise equal {losses == eager_losses}; "
          f"parameters bitwise equal {sum(same)}/{len(same)}); graphed "
          f"step ms p50 {p50 * 1e3:.3f}, eager {eager_p50 * 1e3:.3f}; "
          f"device busy {prof['device_ms']:.3f} ms (idle "
          f"{1 - prof['device_ms'] / (p50 * 1e3):.1%}), K1-K3 "
          f"{prof['attention_ms']:.3f} ms; launches {prof['launches']:.0f}; NCCL "
          f"{nccl_rows(prof['rows'])}", flush=True)
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(losses == eager_losses and all(same) and len(same) == len(
        eager_params), "the graphed ring differs from its eager steps")
    del model, step
    release_memory(torch)


def four_rank_main() -> int:
    """One NCCL rank of the four-card run, one card a rank."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env()
    say = _rank_say(dist.get_rank())
    check(dist.get_backend() == "nccl", "the four-card run takes NCCL")
    four_rank_tp(torch, dist, fleet, llama, say)
    four_rank_ring(torch, dist, fleet, llama, say)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def fleet_four_cards() -> None:
    """The four-card run of phase 26 on a host of four cards, one NCCL
    rank a card: llama2_7b at mp = 4 with SP, graphed, and llama_124m_gqa
    in a ring of sep = 4. Every rank's log is printed."""
    phase_build()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "4", "--log_dir", os.path.join(tmp, "logs"),
             os.path.abspath(__file__), "--fleet-four-rank"],
            env=dict(os.environ, PYTHONPATH=root), cwd=root,
            capture_output=True, text=True, timeout=3000)
        for r in range(4):
            path = os.path.join(tmp, "logs", f"worker.{r}.log")
            if os.path.exists(path):
                print(f"---- rank {r}:\n"
                      + open(path, errors="replace").read()[-8000:],
                      flush=True)
        print(f"launcher exit {res.returncode} {res.stderr[-2000:]}",
              flush=True)
        check(res.returncode == 0, "the four-card run failed")


# ------------------------ phase 27, pipeline parallelism and recompute
PP_RANKS = 2  # (b): two gloo ranks share the one card, one a stage
PP_STEPS = 3
PP_SEED = 27  # the JAX-layout state every run of phase 27 loads
PP_MICRO = 4  # (b)'s microbatches a step
GPT_PP_BATCH, GPT_PP_SEQ = 8, 1024  # (b) and (a) 3: bench_gpt's batch
# (b): each layout's name, model, config flags and the fleet entry its
# stack runs through (None: the model's own forward)
PP_LAYOUTS = (
    ("llama_rotation", "llama", {}, None),
    ("llama_interleave", "llama", {"virtual_pp_degree": 2},
     "forward_backward_pipeline_interleave"),
    ("gpt_1f1b", "gpt", {"pp_schedule": "1f1b"}, None),
    ("gpt_zb", "gpt", {"pp_schedule": "zb"}, None))
# the four-card run (not part of the one-card run):
# python3 -c "import chip_smoke as cs; cs.pipeline_four_cards()" on 4 cards
PP_FOUR_SEQ, PP_FOUR_MICRO = 4096, 8  # llama2_7b: 8 microbatches of 1 x 4096


def pp_init(fleet, degrees: dict):
    """``fleet.init`` with the mesh's ``degrees``, ``pp`` among them."""
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {f"{ax}_degree": degrees.get(ax, 1)
                         for ax in ("dp", "mp", "pp", "sep")}
    fleet.init(is_collective=True, strategy=st)
    return fleet.get_hybrid_communicate_group()


def trainable_adamw_launches(model) -> int:
    """AdamW kernel launches one step makes on the parameters that take a
    gradient (a stack's template takes none)."""
    from paddle_tpu_torch.ops.cuda import adamw

    by_dtype = {}
    for p in model.parameters():
        if p.requires_grad:
            by_dtype[p.dtype] = by_dtype.get(p.dtype, 0) + 1
    return sum(math.ceil(n / adamw.MAX_TENSORS) for n in by_dtype.values())


def pp_predicted(schedule: str, p: int, v: int, m: int, d: int,
                 local_layers: int, rms_norms: bool, adamw: int) -> dict:
    """The launches one step of a pipelined stack makes on stage ``d``:
    every unit of the schedule runs each of its layers once, so with
    ``n = local_layers`` layers a stage, K1 runs once a layer for each
    forward unit, each forward the 1F1B backward runs again (not on the
    last stage, whose F feeds its own B) and each recompute (one a
    backward unit; ZB-H1's ``p − 1 − d`` drained microbatches recompute
    twice, for their input and their weight gradients), K2 and K3 once a
    layer for each backward pass; Llama's K4 twice a layer for every
    forward run plus the final norm's once, its backward twice a layer for
    every backward pass plus the final norm's, two launches a call."""
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    n = local_layers
    fwd = m * n
    rerun = m * n if schedule in ("1f1b", "zb") and d < p - 1 else 0
    drained = (p - 1 - d) if schedule == "zb" else 0
    recompute = (m + drained) * n
    back = (m + drained) * n
    k1 = fwd + rerun + recompute
    k4 = (2 * k1 + 1) if rms_norms else 0
    k4_bwd = (2 * back + 1) * rms.BWD_LAUNCHES_PER_CALL if rms_norms else 0
    return dict(zip(FLEET_KEYS, (k1, back, back, k4, adamw, k4_bwd)))


def recompute_blocks(fleet, blocks):
    """Each block of ``blocks`` run under ``fleet.recompute``."""
    for block in blocks:
        block.forward = (lambda f: lambda x: fleet.recompute(f, x))(
            block.forward)


def pp_graphed(torch, llama, bare: dict) -> dict:
    """(a) 1: a world of one over NCCL: ``fleet.distributed_model(
    LlamaForCausalLM(llama_124m_gqa(pipeline_parallel=True)))`` at pp = 1
    from the stacked JAX-layout state, graphed, held bit for bit to its
    eager steps and those to the bare model's eager steps from the serial
    state; the launches phase 12's (AdamW on the stacked tensors); one
    replay under ``set_sync_debug_mode("error")``. (a) 2: the bare model
    with ``fleet.recompute`` around each decoder block, graphed, bit for
    bit the bare model's eager steps; K1 and K4 twice a layer, K2 and K3
    once. The process group is destroyed after (a) 3."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import pipeline_schedules as ps
    from paddle_tpu_torch.models.gpt import jax_state_dict

    cfg = llama.llama_124m_gqa()
    pp_cfg = llama.llama_124m_gqa(pipeline_parallel=True)
    n = cfg.num_hidden_layers
    hcg = pp_init(fleet, {})
    check(hcg.get_pipe_parallel_world_size() == 1, "(a) pp is not 1")
    serial = seeded_llama_state(torch, llama, cfg, PP_SEED)
    stacked = ps.stacked_state(serial, "llama.layers", n, 1)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ)).astype(np.int64)).cuda()
    steps = GRAPH_WARMUP + TRAIN_STEPS
    print(f"-- (a) 1 fleet.distributed_model(llama_124m_gqa(pipeline_"
          f"parallel)) at pp = 1 over NCCL, bf16 O2, TrainStep, AdamW(1e-4),"
          f" {LLAMA_BATCH}x{LLAMA_SEQ}; {steps} steps", flush=True)

    def eager_run(c, state, wrap=None):
        model, _, eager_step = build_train_step(
            torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion,
            c, wrap=wrap, state=state)
        losses = [float(eager_step(ids)) for _ in range(steps)]
        params = [p.detach().clone() for p in model.parameters()]
        layout = {k: v.clone() for k, v in jax_state_dict(model).items()}
        del model, eager_step
        release_memory(torch)
        return losses, params, layout

    bare_losses, bare_params, bare_layout = eager_run(cfg, serial)
    pp_losses, pp_params, pp_layout = eager_run(
        pp_cfg, stacked, fleet.distributed_model)
    as_serial = ps.serial_state(pp_layout, "llama.layers", n, 1)
    same = [torch.equal(as_serial[k], v) for k, v in bare_layout.items()]
    check(pp_losses == bare_losses and all(same) and len(as_serial) == len(
        bare_layout), "(a) 1 the pipelined model's eager steps differ from "
        "the bare model's")
    print(f"(a) 1 the pipelined model's {steps} eager steps: losses and "
          f"{len(same)} parameters (unstacked) bit for bit the bare "
          f"model's", flush=True)
    del bare_layout, pp_layout, as_serial
    model, step, _ = build_train_step(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion,
        pp_cfg, wrap=fleet.distributed_model, state=stacked)
    check(type(model.llama.layers).__name__ == "PipelinedStack",
          "(a) 1 the model holds no PipelinedStack")
    first, losses, times, counts = run_timed_steps(torch, step, (ids,))
    peak_pp = torch.cuda.max_memory_allocated()
    check_against_eager(torch, "(a) 1 pp = 1 graphed", first + losses,
                        [p.detach() for p in model.parameters()],
                        (pp_losses, pp_params))
    adamw_step = trainable_adamw_launches(model)
    want = llama_fleet_counts(cfg, adamw_step, 1)
    got = dict(zip(FLEET_KEYS, counts))
    print(f"(a) 1 launches over {TRAIN_STEPS} replays {got} (AdamW on "
          f"{sum(p.requires_grad for p in model.parameters())} tensors, the "
          f"stacked ones among them)", flush=True)
    check(got == {k: v * TRAIN_STEPS for k, v in want.items()},
          f"(a) 1 launches {got}: phase 12's are {want} a step")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(ids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("(a) 1 a replay under set_sync_debug_mode('error'): no host sync",
          flush=True)
    p50 = float(np.median(times))
    prof = profile_steps(torch, step, (ids,), p50 * 1e3)
    print(f"[{card_label()}] (a) 1 step ms p50 {p50 * 1e3:.3f} (phase 12's "
          f"bare step {bare['p50_ms']:.3f}); launches a step "
          f"{prof['launches']:.0f} (phase 12's "
          f"{bare['launches_per_step']:.0f}); idle "
          f"{1 - prof['device_ms'] / (p50 * 1e3):.1%}; peak memory "
          f"{peak_pp / 2**30:.2f} GiB", flush=True)
    graphed = {"pp_p50_ms": p50 * 1e3, "pp_counts": got,
               "pp_peak": peak_pp}
    del model, step, pp_params
    release_memory(torch)

    # (a) 2: fleet.recompute around each block of the bare model
    print("-- (a) 2 llama_124m_gqa with fleet.recompute around each decoder "
          "block, graphed", flush=True)
    model, step, _ = build_train_step(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion, cfg,
        state=serial, wrap=lambda m: (recompute_blocks(fleet, m.llama.layers)
                                      or m))
    first, losses, times, counts = run_timed_steps(torch, step, (ids,))
    peak_rc = torch.cuda.max_memory_allocated()
    check_against_eager(torch, "(a) 2 recompute graphed", first + losses,
                        [p.detach() for p in model.parameters()],
                        (bare_losses, bare_params))
    got = dict(zip(FLEET_KEYS, counts))
    calls = 2 * n + 1
    want = dict(zip(FLEET_KEYS, (2 * n, n, n, 2 * (2 * n) + 1,
                                 trainable_adamw_launches(model), calls * 2)))
    print(f"(a) 2 launches over {TRAIN_STEPS} replays {got}: K1 and K4 "
          f"twice a layer (the forward and its recompute), K2 and K3 "
          f"once", flush=True)
    check(got == {k: v * TRAIN_STEPS for k, v in want.items()},
          f"(a) 2 launches {got}: want {want} a step")
    p50 = float(np.median(times))
    prof = profile_steps(torch, step, (ids,), p50 * 1e3)
    print(f"[{card_label()}] (a) 2 step ms p50 {p50 * 1e3:.3f} (phase 12's "
          f"bare step {bare['p50_ms']:.3f}); launches a step "
          f"{prof['launches']:.0f}; idle "
          f"{1 - prof['device_ms'] / (p50 * 1e3):.1%}; peak memory "
          f"{peak_rc / 2**30:.2f} GiB against {peak_pp / 2**30:.2f} GiB "
          f"without recompute ((a) 1, phase 12's step)", flush=True)
    graphed.update(rc_p50_ms=p50 * 1e3, rc_counts=got, rc_peak=peak_rc)
    del model, step, bare_params
    release_memory(torch)
    return graphed


def pp_recompute_dropout(torch, gpt) -> dict:
    """(a) 3: gpt2_small at hidden and attention dropout 0.1, bf16 O2, 8 x
    1024, with ``fleet.recompute`` on every block against the same model
    without, from the same seeds (weights and dropout generators): one
    eager forward and backward, every gradient bit for bit; then
    ``GRAPH_WARMUP + PP_STEPS`` ``TrainStep`` steps each (the eager call,
    the capture, replays), losses and parameters bit for bit after every
    step; K1 twice a layer in a recomputed replay, K2 once."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    cfg = gpt.gpt2_small()
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (GPT_PP_BATCH, GPT_PP_SEQ)).astype(
            np.int64)).cuda()
    print(f"-- (a) 3 gpt2_small at dropout {cfg.hidden_dropout_prob} "
          f"(hidden and attention), bf16 O2, {GPT_PP_BATCH}x{GPT_PP_SEQ}: "
          f"fleet.recompute on every block against none", flush=True)
    built = []
    for recomputed in (False, True):
        wrap = ((lambda m: recompute_blocks(fleet, m.gpt.h) or m)
                if recomputed else None)
        built.append(build_train_step(
            torch, gpt.GPTForCausalLM, gpt.GPTPretrainingCriterion, cfg,
            dropout_seed=PP_SEED, wrap=wrap))
    crit = gpt.GPTPretrainingCriterion(cfg)
    grads = []
    for model, _, _ in built:
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(ids)
        loss = crit(logits, ids)
        loss.backward()
        grads.append([loss.detach()] + [p.grad.clone()
                                        for p in model.parameters()])
        model.clear_gradients()
        del logits, loss
    same = [torch.equal(a, b) for a, b in zip(*grads)]
    print(f"(a) 3 eager: the loss and {len(same) - 1} gradients with "
          f"recompute bit for bit those without: {sum(same)}/{len(same)}",
          flush=True)
    check(all(same), "(a) 3 the recomputed gradients differ at dropout 0.1")
    del grads
    rows, times = [], [[], []]
    counts = [[0, 0, 0], [0, 0, 0]]  # K1/K2/K3 over each model's replays
    for i in range(GRAPH_WARMUP + PP_STEPS):
        out = []
        for j, (model, step, _) in enumerate(built):
            before = (fa.launches, fa.dq_launches, fa.dkv_launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(ids))
            torch.cuda.synchronize()
            times[j].append(time.perf_counter() - t0)
            out.append(loss)
            if i >= GRAPH_WARMUP:
                after = (fa.launches, fa.dq_launches, fa.dkv_launches)
                for c in range(3):
                    counts[j][c] += after[c] - before[c]
        params = [torch.equal(a, b) for a, b in zip(
            built[0][0].parameters(), built[1][0].parameters())]
        rows.append((out[0] == out[1], sum(params), len(params)))
        check(out[0] == out[1] and all(params),
              f"(a) 3 step {i + 1}: with recompute {out[1]}, without "
              f"{out[0]}, {sum(params)}/{len(params)} parameters equal")
    stats = [s.stats for _, s, _ in built]
    check(all(s == {"compiled_steps": GRAPH_WARMUP + PP_STEPS - 1,
                    "eager_steps": 1} for s in stats), f"(a) 3 steps {stats}")
    n = cfg.num_hidden_layers
    plain, rc = (tuple(c) for c in counts)
    print(f"(a) 3 {GRAPH_WARMUP + PP_STEPS} TrainStep steps each (eager, "
          f"capture, replays): losses and parameters bit for bit after "
          f"every step {rows}; replays' K1/K2/K3 recomputed {rc}, plain "
          f"{plain}; step ms p50 with recompute "
          f"{np.median(times[1][GRAPH_WARMUP:]) * 1e3:.3f}, without "
          f"{np.median(times[0][GRAPH_WARMUP:]) * 1e3:.3f} "
          f"[{card_label()}]", flush=True)
    check(rc == (2 * n * PP_STEPS, n * PP_STEPS, n * PP_STEPS)
          and plain == (n * PP_STEPS,) * 3,
          f"(a) 3 K1/K2/K3 launches {rc} recomputed, {plain} plain over "
          f"{PP_STEPS} replays")
    del built
    release_memory(torch)
    return dict(zip(("fwd", "dq", "dkv"), rc))


def pp_microbatch_kernels(torch) -> dict:
    """K1–K3 at (b)'s Llama microbatch, B=1 S=2048, 12 heads from 4 KV
    heads, D=64, bf16, causal: against their plain versions, timed beside
    their bounds and SDPA."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    rs = np.random.RandomState(27)
    dev = torch.device("cuda")
    seed = torch.tensor([20241027], dtype=torch.int32, device=dev)
    q, k, v, do = llama_qkv(torch, rs, 1, LLAMA_SEQ, 12, 4, 64, "bfloat16")
    errs, equal, _ = compare_backward(torch, fa, q, k, v, do, seed,
                                      "bfloat16", 0.0)
    t = time_attention(torch, fa, q, k, v, do, seed, "bfloat16", 0.0)
    print(f"[{card_label()}] K1-K3 at the pipeline microbatch B=1 "
          f"S={LLAMA_SEQ} H=12 (from 4 KV heads) D=64 bf16 causal  err "
          + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + "\n    " + t["line"], flush=True)
    del q, k, v, do
    return {name: dict(rec, shape=f"B=1 S={LLAMA_SEQ} H=12 D=64 bfloat16 "
                                  f"causal")
            for name, rec in attention_records(t, errs).items()}


def pp_references(torch, llama, gpt, out_dir) -> None:
    """One process's references for (b), written to
    ``out_dir/reference.pt``: the serial JAX-layout states of
    llama_124m_gqa and of gpt2_small at dropout 0, and ``PP_STEPS`` bare
    eager steps from each over the whole batch (losses, the JAX-layout
    parameters after them)."""
    from paddle_tpu_torch.models.gpt import jax_state_dict

    ref = {}
    for kind in ("llama", "gpt"):
        cfg, model_cls, crit_cls, ids = pp_model(torch, llama, gpt, kind)
        state = (seeded_llama_state(torch, llama, cfg, PP_SEED)
                 if kind == "llama" else seeded_gpt_state(torch, gpt, cfg))
        model, _, eager_step = build_train_step(
            torch, model_cls, crit_cls, cfg, state=state)
        ref[f"{kind}_serial"] = state
        ref[f"{kind}_losses"] = [float(eager_step(ids))
                                 for _ in range(PP_STEPS)]
        ref[f"{kind}_params"] = {k: v.detach().float().cpu() for k, v in
                                 jax_state_dict(model).items()}
        del model, eager_step
        release_memory(torch)
    torch.save(ref, os.path.join(out_dir, "reference.pt"))


def seeded_gpt_state(torch, gpt, cfg) -> dict:
    """A JAX-layout state of ``cfg``'s GPT drawn from numpy seed
    ``PP_SEED``: matrices normal with std 0.02, LayerNorm weights 1 +
    N(0, 0.1), biases N(0, 0.02). Every tensor has a scale: a bias that
    starts at 0 (the model's own init) and whose gradient is 0 in exact
    arithmetic (the key bias: softmax ignores a shift along a row) moves
    by ±LR a step by the sign of rounding noise, in one process as in a
    pipeline, which no gate relative to its own size can hold."""
    from paddle_tpu_torch.models.gpt import jax_state_dict

    shapes = {k: tuple(v.shape) for k, v in jax_state_dict(
        gpt.GPTForCausalLM(cfg, device="cpu")).items()}
    rs = np.random.RandomState(PP_SEED)
    return {k: ((1.0 + 0.1 * rs.standard_normal(s))
                if len(s) == 1 and k.endswith("weight")
                else 0.02 * rs.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def pp_model(torch, llama, gpt, kind, **flags):
    """(b)'s config of ``kind`` (gpt2_small at dropout 0), its classes and
    its batch."""
    if kind == "llama":
        cfg = llama.llama_124m_gqa(**flags)
        shape = (LLAMA_BATCH, LLAMA_SEQ)
        classes = (llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion)
    else:
        cfg = gpt.gpt2_small(hidden_dropout_prob=0.0,
                             attention_dropout_prob=0.0, **flags)
        shape = (GPT_PP_BATCH, GPT_PP_SEQ)
        classes = (gpt.GPTForCausalLM, gpt.GPTPretrainingCriterion)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, shape).astype(np.int64)).cuda()
    return (cfg,) + classes + (ids,)


def _through(fleet, model, entry):
    """``model``'s trunk run with its stack through the fleet entry
    ``entry`` (the Llama trunk's own steps: embedding, stack, norm)."""
    trunk = model.llama
    run = getattr(fleet, entry)
    trunk.forward = lambda ids: trunk.norm(run(trunk.layers,
                                               trunk.embed_tokens(ids)))


def pp_rank_layout(torch, dist, fleet, llama, gpt, layout, ref, say) -> dict:
    """(b) One layout over the 2 ranks at pp = 2, bf16 O2, ``PP_STEPS``
    eager AdamW steps of ``fleet.distributed_model(model)`` under
    ``TrainStep`` (eager on gloo) from the reference's serial state
    stacked (``stacked_state``), every rank on the whole batch: before
    the first step every original layer's weights (``layer_state_dict``,
    a collective) are the serial state's; after every step the edges
    (embedding, final norm, head) bit-equal on the ranks and the loss
    equal; each rank's K1-K4 and AdamW launches what its schedule predicts
    (:func:`pp_predicted`) and its most held chunk inputs within the
    schedule's bound; rank 0 holds the losses and the parameters
    (``jax_state_dict`` gathered over pp, unstacked) within the bf16 gate
    of one process's. Returns this rank's launches over the steps."""
    from paddle_tpu_torch.distributed.fleet import pipeline_schedules as ps
    from paddle_tpu_torch.models.gpt import jax_state_dict

    name, kind, flags, entry = layout
    hcg = pp_init(fleet, {"pp": PP_RANKS})
    r = dist.get_rank()
    p = hcg.get_pipe_parallel_world_size()
    cfg, model_cls, crit_cls, ids = pp_model(
        torch, llama, gpt, kind, pipeline_parallel=True,
        pp_num_microbatches=PP_MICRO, **flags)
    n, v = cfg.num_hidden_layers, cfg.virtual_pp_degree
    prefix = "llama.layers" if kind == "llama" else "gpt.h"
    serial = ref[f"{kind}_serial"]
    model, step, _ = build_train_step(
        torch, model_cls, crit_cls, cfg, wrap=fleet.distributed_model,
        state=ps.stacked_state(serial, prefix, n, p, v))
    if entry is not None:
        _through(fleet, model, entry)
    stack = model.get_submodule(prefix)
    d = stack.stage
    linear = {pn for pn in stack._param_names
              if "stack_" + pn.replace(".", "__") in stack.linear_weights()}
    for idx in range(n):
        for pname, value in stack.layer_state_dict(idx).items():
            want = torch.from_numpy(np.asarray(
                serial[f"{prefix}.{idx}.{pname}"]))
            if pname in linear:
                want = want.t()
            check(torch.equal(value.cpu(), want.to(value.dtype)),
                  f"(b) {name} rank {r}: layer {idx}'s {pname} from "
                  f"layer_state_dict differs from the serial state's")
    edges = [q for pn, q in model.named_parameters()
             if ".stack_" not in pn and ".template." not in pn]
    schedule = cfg.pp_schedule if kind == "gpt" else "rotation"
    want = pp_predicted(schedule, p, v, PP_MICRO, d, stack.local_layers,
                        kind == "llama", trainable_adamw_launches(model))
    bound = PP_MICRO * v if schedule == "rotation" else 2 * (p - 1 - d)
    losses, times, total = [], [], dict.fromkeys(FLEET_KEYS, 0)
    for i in range(PP_STEPS):
        zero_counts_fleet()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = launch_counts()
        check(got == want, f"(b) {name} rank {r} (stage {d}) step {i + 1}: "
              f"launches {got}, the schedule predicts {want}")
        for k in FLEET_KEYS:
            total[k] += got[k]
        check(stack.peak_saved <= bound and (
            schedule != "rotation" or stack.peak_saved == bound),
              f"(b) {name} rank {r}: {stack.peak_saved} chunk inputs held "
              f"at once, the bound is {bound}")
        value = loss.as_subclass(torch.Tensor).detach().float().reshape(1)
        theirs = value.clone()
        dist.broadcast(theirs, src=0)
        check(torch.equal(value, theirs), f"(b) {name} rank {r}'s loss "
              f"differs from rank 0's at step {i + 1}")
        losses.append(float(value))
        for flat in _flat_by_dtype(torch, edges):
            theirs = flat.clone()
            dist.broadcast(theirs, src=0)
            check(torch.equal(flat, theirs), f"(b) {name} rank {r}'s "
                  f"edge parameters differ from rank 0's after step "
                  f"{i + 1}")
    check(step.stats == {"compiled_steps": 0, "eager_steps": PP_STEPS},
          f"(b) {name} steps {step.stats}")
    params = ps.serial_state(jax_state_dict(model), prefix, n, p, v)
    print(f"(b) {name} rank {r} stage {d}: {stack.local_layers} layers "
          f"({v} chunk(s)), units a step {len(stack.trace)}, most chunk "
          f"inputs held {stack.peak_saved} (bound {bound}); launches a step "
          f"{want}", flush=True)
    if r == 0:
        want_losses = ref[f"{kind}_losses"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
        check(sorted(params) == sorted(ref[f"{kind}_params"]),
              f"(b) {name}: the unstacked names differ from the serial "
              f"model's")
        worst, worst_name = max((bf16_gate(torch, params[k], val), k)
                                for k, val in ref[f"{kind}_params"].items())
        say(f"[{card_label()}] (b) {name} ({schedule}"
            f"{', through ' + entry if entry else ''}): {len(edges)} edge "
            f"parameters bit-equal on the ranks after each step; losses "
            f"{losses} against one process's {want_losses} (largest "
            f"relative gap {gap:.3g}, gate {DP_BF16_TOL}); parameters at "
            f"{worst:.3f} of the bf16 gate at worst ({worst_name}); step ms "
            f"{', '.join(f'{t * 1e3:.1f}' for t in times)} (eager on gloo); "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB")
        check(gap <= DP_BF16_TOL and worst <= 1.0,
              f"(b) {name}: losses {losses} against {want_losses}, "
              f"parameters at {worst:.3f} of the gate ({worst_name})")
    del model, step, stack, params, edges
    release_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    return total


def zero_counts_fleet() -> None:
    from paddle_tpu_torch.ops.cuda import adamw
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    fa.launches = fa.dq_launches = fa.dkv_launches = rms.launches = 0
    adamw.launches = rms.bwd_launches = 0


def pp_rank_main(out_dir: str) -> int:
    """One rank of phase 27 (b), started by the launcher; rank 0 writes
    its launches by layout to ``out_dir/counts.json``."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt, llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    r = dist.get_rank()
    say = _rank_say(r)
    t0 = time.perf_counter()
    asked = os.environ["PADDLE_DISTRI_BACKEND"]
    check(dist.get_backend() == asked, f"rank {r} runs "
          f"{dist.get_backend()}, the launch asked for {asked}")
    ref = torch.load(os.path.join(out_dir, "reference.pt"),
                     weights_only=False)
    counts = {}
    for layout in PP_LAYOUTS:
        t1 = time.perf_counter()
        counts[layout[0]] = pp_rank_layout(torch, dist, fleet, llama, gpt,
                                           layout, ref, say)
        say(f"(b) {layout[0]} took {time.perf_counter() - t1:.1f} s")
    if r == 0:
        with open(os.path.join(out_dir, "counts.json"), "w") as f:
            json.dump(counts, f)
    dist.barrier()
    say(f"ranks' work took {time.perf_counter() - t0:.1f} s")
    dist.destroy_process_group()
    return 0


def pp_launched_ranks(torch, llama, gpt) -> dict:
    """(b): two gloo ranks on the card started by the launcher (``python
    -m paddle_tpu_torch.distributed.launch --nproc_per_node 2`` with
    ``PADDLE_DISTRI_BACKEND=gloo``) on this script's ``--pipeline-rank``
    mode, after this process writes one process's references. A rank's
    failure fails the launcher, and that fails the phase. Returns rank 0's
    launches by layout."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pp_references(torch, llama, gpt, tmp)
        print(f"(b) one process's references took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        env = dict(os.environ, PADDLE_DISTRI_BACKEND="gloo", PYTHONPATH=root)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", str(PP_RANKS), "--log_dir",
             os.path.join(tmp, "logs"), os.path.abspath(__file__),
             "--pipeline-rank", tmp],
            env=env, cwd=root, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        for r in range(PP_RANKS):
            path = os.path.join(tmp, "logs", f"worker.{r}.log")
            text = open(path, errors="replace").read() if os.path.exists(
                path) else ""
            if r == 0 or res.returncode != 0:
                print(f"---- rank {r} of the launched job:\n"
                      + text[-12000:].rstrip(), flush=True)
        print(f"launcher exit {res.returncode} after {wall:.1f} s "
              f"{res.stderr[-2000:]}", flush=True)
        check(res.returncode == 0, f"the launched pipeline job failed (exit "
              f"{res.returncode})")
        with open(os.path.join(tmp, "counts.json")) as f:
            return json.load(f)


def phase_pipeline_parallel(torch, llama, gpt, bare: dict) -> dict:
    """Phase 27: (a) a world of one over NCCL in this process, graphed:
    the pp = 1 stack, recompute on Llama, recompute at dropout on GPT; K1-K3
    at the pipeline microbatch; (b) two gloo ranks on the card through the
    launcher, one a stage. Returns the launches of K1-K4 and AdamW on the
    pipeline-parallel path ((a) 1's replays and rank 0's steps in (b)),
    on the recompute path ((a) 2's and (a) 3's recomputed replays), and
    K1-K3's records at the microbatch shape."""
    import paddle_tpu_torch.distributed as dist

    t0 = time.perf_counter()
    print(f"== pipeline parallel and recompute [{card_label()}]", flush=True)
    graphed = pp_graphed(torch, llama, bare)
    dropout = pp_recompute_dropout(torch, gpt)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived (a)")
    records = pp_microbatch_kernels(torch)
    ranks = pp_launched_ranks(torch, llama, gpt)
    print(f"phase 27 took {time.perf_counter() - t0:.1f} s", flush=True)
    pipeline = {k: graphed["pp_counts"][k] + sum(c[k] for c in
                                                 ranks.values())
                for k in FLEET_KEYS}
    recompute = {k: graphed["rc_counts"][k] + dropout.get(k, 0)
                 for k in FLEET_KEYS}
    print(f"phase 27 launches: pipeline parallel {pipeline}; recompute "
          f"{recompute}", flush=True)
    return {"pipeline_parallel": pipeline, "recompute": recompute,
            "records": records}


def pp_four_rank(torch, dist, fleet, llama, say) -> None:
    """llama2_7b at full width over pp = 4 (8 of its 32 layers a stage),
    ``PP_FOUR_MICRO`` microbatches of 1 x ``PP_FOUR_SEQ``, bf16 O2,
    graphed (one CUDA graph a step over NCCL, the point-to-point exchanges
    and the broadcasts inside): under ``"rotation"``, then with the stack
    run through ``forward_backward_pipeline_1f1b``, ``FOUR_STEPS`` timed
    replays each: the step p50, the NCCL device ms by kind, the idle share
    against (p−1)/(m+p−1), the peak memory."""
    pp_init(fleet, {"pp": 4})
    layers = int(os.environ.get("PP_FOUR_LAYERS", "32"))
    cfg = llama.llama2_7b(pipeline_parallel=True, num_hidden_layers=layers,
                          pp_num_microbatches=PP_FOUR_MICRO)
    t0 = time.perf_counter()
    model, step, _ = build_train_step(
        torch, llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion, cfg,
        wrap=fleet.distributed_model)
    stack = model.llama.layers
    say(f"-- llama2_7b ({layers} layers, {stack.local_layers} a stage) at "
        f"pp = 4 over NCCL, bf16 O2, TrainStep, AdamW(1e-4), "
        f"{PP_FOUR_MICRO} microbatches of 1x{PP_FOUR_SEQ}; built in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"parameters on this rank")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (PP_FOUR_MICRO, PP_FOUR_SEQ)).astype(
            np.int64)).cuda()
    bubble = 3 / (PP_FOUR_MICRO + 3)
    for label in ("rotation", "forward_backward_pipeline_1f1b"):
        if label != "rotation":
            del step
            release_memory(torch)
            _through(fleet, model, label)
            from paddle_tpu_torch.jit import TrainStep

            step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
        else:
            opt, loss_fn = step.optimizer, step.loss_fn
        torch.cuda.reset_peak_memory_stats()
        first = [float(step(ids)) for _ in range(GRAPH_WARMUP)]
        torch.cuda.synchronize()
        stats = dict(step.stats)
        times, losses = [], []
        for _ in range(FOUR_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(step(ids)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        ran = {k: step.stats[k] - stats[k] for k in stats}
        check(ran == {"compiled_steps": FOUR_STEPS, "eager_steps": 0},
              f"the timed steps {ran} did not all replay")
        peak = torch.cuda.max_memory_allocated()
        p50 = float(np.median(times))
        prof = profile_steps(torch, step, (ids,), p50 * 1e3)
        print(f"[{card_label()}] rank {dist.get_rank()} stage {stack.stage} "
              f"llama2_7b pp = 4 {label}: losses {first + losses}; step ms "
              f"p50 {p50 * 1e3:.3f} (min {min(times) * 1e3:.3f}, max "
              f"{max(times) * 1e3:.3f}); device busy "
              f"{prof['device_ms']:.3f} ms, idle "
              f"{1 - prof['device_ms'] / (p50 * 1e3):.1%} against the "
              f"bubble (p-1)/(m+p-1) = {bubble:.1%}; K1-K3 "
              f"{prof['attention_ms']:.3f} ms; launches a step "
              f"{prof['launches']:.0f}; NCCL by kind (ms, launches a step) "
              f"{nccl_rows(prof['rows'])}; most chunk inputs held "
              f"{stack.peak_saved}; peak memory {peak / 2**30:.2f} GiB",
              flush=True)
        check(all(math.isfinite(x) for x in first + losses),
              "non-finite loss")
    del model, step
    release_memory(torch)


def pp_four_rank_main() -> int:
    """One NCCL rank of phase 27's four-card run, one card a rank."""
    import torch

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env()
    say = _rank_say(dist.get_rank())
    check(dist.get_backend() == "nccl", "the four-card run takes NCCL")
    pp_four_rank(torch, dist, fleet, llama, say)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def pipeline_four_cards() -> None:
    """Phase 27's four-card run on a host of four cards, one NCCL rank a
    card and a stage: llama2_7b at pp = 4, graphed, under the rotation and
    1F1B. Every rank's log is printed."""
    phase_build()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", "4", "--log_dir", os.path.join(tmp, "logs"),
             os.path.abspath(__file__), "--pipeline-four-rank"],
            env=dict(os.environ, PYTHONPATH=root), cwd=root,
            capture_output=True, text=True, timeout=3000)
        for r in range(4):
            path = os.path.join(tmp, "logs", f"worker.{r}.log")
            if os.path.exists(path):
                print(f"---- rank {r}:\n"
                      + open(path, errors="replace").read()[-8000:],
                      flush=True)
        print(f"launcher exit {res.returncode} {res.stderr[-2000:]}",
              flush=True)
        check(res.returncode == 0, "the four-card run failed")


def timed(phase, *args):
    """``phase(*args)``, then its wall time printed."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"-- {phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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
        from paddle_tpu_torch.models import bert, gpt, llama
        from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_small
        from paddle_tpu_torch.vision.models import resnet, segdet, small
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        timed(phase_card)
        timed(phase_build)
        serve_record = timed(phase_kernel, torch)
        model = timed(phase_model, torch, GPTForCausalLM, gpt2_small)
        served = timed(phase_serve, torch, model)
        served["launches"] += timed(phase_serve_modes, torch, model, served)
        served["launches"] += timed(phase_operate, torch, model, served)
        batch = timed(phase_batch_serve, torch, model)
        timed(phase_serve_shapes, torch, sorted(
            set(served["prefill_shapes"]) | set(batch["rungs"])))
        del model
        release_memory(torch)
        records = timed(phase_backward, torch)
        fp16_records = timed(phase_fp16_attention, torch)
        timed(phase_gradients, torch, gpt)
        trained = timed(phase_train, torch, gpt)
        records.update(timed(phase_llama_kernels, torch))
        timed(phase_llama_model, torch, llama)
        trained_llama = timed(phase_train_llama, torch, llama)
        timed(phase_flashmask_kernels, torch)
        flashmask_path = timed(phase_flashmask_path, torch)
        adamw_record = timed(phase_adamw, torch, gpt)
        timed(phase_adamw_modes, torch, gpt)
        trainer = timed(phase_trainer, torch, gpt,
                        trained["launches_per_step"])
        bert_run = timed(phase_bert, torch, bert)
        resnet_run = timed(phase_resnet, torch, resnet)
        liteseg_run = timed(phase_liteseg, torch, segdet, small)
        fit_run = timed(phase_fit, torch, llama, trained_llama["p50_ms"])
        arms = timed(phase_bench_arms, torch, {
            "gpt": trained, "llama": trained_llama, "bert": bert_run["arm"],
            "resnet": resnet_run["arm"], "liteseg": liteseg_run["arm"]})
        transformer = timed(phase_transformer, torch)
        static = timed(phase_static, torch, llama)
        recurrent = timed(phase_recurrent, torch, llama, resnet)
        data_parallel = timed(phase_data_parallel, torch, llama,
                              trained_llama)
        fleet_run = timed(phase_fleet, torch, llama, gpt, bert,
                          trained_llama)
        pp_run = timed(phase_pipeline_parallel, torch, llama, gpt,
                       trained_llama)
    except Exception:  # noqa: BLE001 — report the failing phase, exit 1
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        # the DataLoader workers' fork server (phases 20 and 24 (d))
        from paddle_tpu_torch.io.dataloader import stop_fork_server

        stop_fork_server()
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
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
                   "trainer_optimizers": trainer["optimizers"][key],
                   "train_bert": bert_run["arm"][key],
                   "fit_llama": fit_run["launches"][key],
                   "bench_arms": arms[key],
                   "transformer_base": transformer[key],
                   "debug_llama": static["debug"][key],
                   "optimizer_interception":
                       recurrent["launches"][key],
                   "data_parallel": data_parallel[key],
                   "tensor_parallel": fleet_run["tensor_parallel"][key],
                   "context_parallel": fleet_run["context_parallel"][key],
                   "pipeline_parallel": pp_run["pipeline_parallel"][key],
                   "recompute": pp_run["recompute"][key]}
        f32_by_path = ({"serve": served["launches"],
                        "batch_serve": batch["launches"],
                        "static_llama": static["static"]["launches"]["fwd"],
                        "static_llama_loaded":
                            static["static"]["launches"]["loaded"]["fwd"]}
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
            "launches": trainer["fp16"][key] + fit_run["fp16_llama"][key],
            "launches_by_path": {"trainer_fp16": trainer["fp16"][key],
                                 "fit_fp16_llama":
                                     fit_run["fp16_llama"][key]},
            "llama_shape": fp16_records["Llama"][key],
            "head_dim_128": fp16_records["D=128"][key]}
        if key == "fwd":
            entry["serve_shape"] = serve_record
        entry["llama_shape"] = records[(key, "bfloat16", 64)]
        # B=1 S=2048 H=12 (from 4 KV heads) D=64 bf16: phase 27 (b)'s
        # Llama microbatch
        entry["pipeline_microbatch_shape"] = pp_run["records"][key]
        # non-causal, B=32 S=128 H=12 D=64 (phase 17 (b))
        entry["bert_shape"] = {dtype: bert_run["records"][(key, dtype)]
                               for dtype in ("bfloat16", "float32")}
        entry["head_dim_128"] = {dtype: records[(key, dtype, 128)]
                                 for dtype in ("bfloat16", "float32")}
        # non-causal, B=16 S=256 H=8 D=64 bf16, dropout 0.1 and 0 (phase 22)
        entry["transformer_base_shape"] = {
            f"dropout_{p}": transformer["records"][(key, p)]
            for p in (TB_DROPOUT, 0.0)}
        kernels.append(entry)
    # K4 and its backward: bf16 on the Llama training paths, f32 and fp16
    # beside (fp16 on phase 20 (d)'s O1 steps)
    for name, replaces, extra in (
            ("rms_norm", "paddle_tpu/ops/pallas/rms_norm.py:46", {}),
            # no Pallas counterpart: the jnp _bwd of the custom VJP, which
            # XLA fuses
            ("rms_norm_bwd", "paddle_tpu/ops/pallas/rms_norm.py:84",
             {"pallas_counterpart": False})):
        by_path = {"train_llama": trained_llama[name],
                   "fit_llama": fit_run["launches"][name],
                   "bench_arms": arms[name],
                   "debug_llama": static["debug"][name],
                   "optimizer_interception": recurrent["launches"][name],
                   "data_parallel": data_parallel[name],
                   "tensor_parallel": fleet_run["tensor_parallel"][name],
                   "context_parallel": fleet_run["context_parallel"][name],
                   "pipeline_parallel": pp_run["pipeline_parallel"][name],
                   "recompute": pp_run["recompute"][name]}
        f32_by_path = ({"static_llama":
                        static["static"]["launches"]["rms_norm"],
                        "static_llama_loaded":
                        static["static"]["launches"]["loaded"]["rms_norm"]}
                       if name == "rms_norm" else {})
        fp16 = fit_run["fp16_llama"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source + "rms_norm.cu",
            "replaces": replaces, **extra,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **records[(name, "bfloat16")],
            "float32": {**{k: records[(name, "float32")][k]
                           for k in ("ms", "plain_ms", "bound_ms",
                                     "library_ms", "max_abs_err")},
                        "launches": sum(f32_by_path.values()),
                        "launches_by_path": f32_by_path},
            "float16": {**{k: fit_run["rms16"][name][k]
                           for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "max_abs_err", "shape")},
                        "launches": fp16,
                        "launches_by_path": {"fit_fp16_llama": fp16}}})
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
        # float16: the same source instantiated for __half (phase 20 (d))
        fm16 = fit_run["fm16"]
        entry["float16"] = {
            "source": source + src,
            **{k: fm16["records"][(key, "float16")][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "max_abs_err", "shape")},
            "launches": fm16["launches"][key],
            "launches_by_path": {"flashmask_fp16": fm16["launches"][key]}}
        entry["tiles"] = flashmask_path["tiles"][key]
        if key == "fwd":
            entry["path"] = flashmask_path["path"]
        kernels.append(entry)
    # no Pallas counterpart: the jnp AdamW update that XLA fuses
    by_path = {"train": trained["adamw"], "train_llama": trained_llama["adamw"],
               "trainer_recipe": trainer["recipe"]["adamw"],
               "trainer_fp16": trainer["fp16"]["adamw"],
               "trainer_optimizers": trainer["optimizers"]["adamw"],
               "train_bert": bert_run["arm"]["adamw"],
               "train_bert_bucketed": bert_run["bucketed"]["adamw"],
               "fit_llama": fit_run["launches"]["adamw"],
               "fit_fp16_llama": fit_run["fp16_llama"]["adamw"],
               "bench_arms": arms["adamw"],
               "transformer_base": transformer["adamw"],
               "optimizer_interception": recurrent["launches"]["adamw"],
               "data_parallel": data_parallel["adamw"],
               "tensor_parallel": fleet_run["tensor_parallel"]["adamw"],
               "context_parallel": fleet_run["context_parallel"]["adamw"],
               "pipeline_parallel": pp_run["pipeline_parallel"]["adamw"],
               "recompute": pp_run["recompute"]["adamw"]}
    kernels.append({
        "name": "adamw", "route": "cuda", "source": source + "adamw.cu",
        "replaces": "paddle_tpu/optimizer/optimizers.py:90",
        "pallas_counterpart": False,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        **adamw_record})
    # no Pallas counterpart: the jnp Momentum update that XLA fuses
    by_path = {"train_resnet": resnet_run["arm"]["momentum"],
               "trainer_optimizers": trainer["optimizers"]["momentum"],
               "train_liteseg": liteseg_run["arm"]["momentum"],
               "bench_arms": arms["momentum"],
               "optimizer_interception": recurrent["launches"]["momentum"]}
    kernels.append({
        "name": "momentum", "route": "cuda",
        "source": source + "momentum.cu",
        "replaces": "paddle_tpu/optimizer/optimizers.py:23",
        "pallas_counterpart": False,
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        **resnet_run["momentum"],
        "max_abs_err": max(resnet_run["momentum"]["max_abs_err"],
                           liteseg_run["arm"]["momentum_err"])})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--data-parallel-rank"]:
        # one rank of phase 25 (b) and (c), started by the launcher
        sys.exit(dp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--fleet-rank"]:
        # one rank of phase 26 (b) and (c), started by the launcher
        sys.exit(fleet_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--fleet-four-rank"]:
        # one rank of the four-card run of phase 26
        sys.exit(four_rank_main())
    if sys.argv[1:2] == ["--pipeline-rank"]:
        # one rank of phase 27 (b), started by the launcher
        sys.exit(pp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--pipeline-four-rank"]:
        # one rank of the four-card run of phase 27
        sys.exit(pp_four_rank_main())
    sys.exit(main())
