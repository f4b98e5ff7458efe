"""On-card tests of the graphed ``TrainStep`` and the multi-tensor AdamW
kernel (marker ``cuda``).

They need an NVIDIA Hopper GPU and ``nvcc``, and skip on hosts without a
GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_train.py

All comparisons are bit for bit (tolerance 0):

- a graphed ``TrainStep`` (eager first call, capture at the second, replays
  after) against the same sequence run eagerly by hand — ``loss_fn``,
  ``backward``, ``step``, ``clear_grad`` — on ``gpt_tiny`` (with and
  without dropout 0.1) and ``llama_tiny``, f32 and bf16 O2, from one seed:
  the loss stream and every parameter after 5 steps, the LR changed with
  ``set_lr`` before the fourth step (after the capture), so the replay
  must read the new LR;
- a second batch shape captures a second graph; the launch counters count
  replays;
- the AdamW kernel against its plain version over 2 steps, at sizes 1, 7,
  4097 and 2**20 + 3 (not 16-byte multiples at their ends), in f32 and
  bf16, with AdamW's decay and Adam's L2 decay, and on views whose first
  element is not 16-byte aligned.

Last, a capture that cannot run (a host sync inside) raises, naming the
function, and leaves the calling thread on the stream it was on.

The training-step API (tolerance 0 again unless named): every optimizer
but LBFGS graphed against its eager steps on ``gpt_tiny`` bf16 O2, AdamW
under a pretraining recipe (warmup then cosine LR stepped every step,
parameter groups, global-norm clipping, a decay mask); fp16 O1 with a
``GradScaler`` whose first steps overflow, eager under
``set_sync_debug_mode("error")`` and captured by ``CompiledFunction``; the
AdamW kernel's per-tensor LR, decay and L2, ``amsgrad`` and ``found_inf``
in bf16, fp16 and f32 (fp16 also with f32 gradients); fp16 K1-K3 within
``chip_smoke.py``'s fp16 gates of their plain versions.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import CompiledFunction, TrainStep
from paddle_tpu_torch.models import gpt, llama
from paddle_tpu_torch.ops.cuda import adamw
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW

pytestmark = pytest.mark.cuda

STEPS = 5
NEW_LR_AT = 3  # set_lr before this step (0-based): after the capture


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _build(arch, o2, dropout):
    if arch == "gpt":
        cfg = gpt.gpt_tiny(hidden_dropout_prob=dropout,
                           attention_dropout_prob=dropout)
        model_cls, crit_cls = gpt.GPTForCausalLM, gpt.GPTPretrainingCriterion
    else:
        cfg = llama.llama_tiny()
        model_cls = llama.LlamaForCausalLM
        crit_cls = llama.LlamaPretrainingCriterion
    model = model_cls(cfg, generator=torch.Generator().manual_seed(0),
                      dropout_seed=5).train()
    crit = crit_cls(cfg)
    if o2:
        amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())

    def loss_fn(ids):
        if o2:
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                logits = model(ids)
        else:
            logits = model(ids)
        return crit(logits, ids)

    return cfg, model, opt, loss_fn


def _run(arch, o2, dropout, ids, graphed):
    cfg, model, opt, loss_fn = _build(arch, o2, dropout)
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    losses = []
    for i in range(STEPS):
        if i == NEW_LR_AT:
            opt.set_lr(5e-4)
        if graphed:
            loss = step(ids)
        else:
            loss = loss_fn(ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            loss = loss.detach()
        losses.append(loss)
    torch.cuda.synchronize()
    return ([float(x) for x in losses],
            [p.detach().clone() for p in model.parameters()], step)


@pytest.mark.parametrize("arch,o2,dropout", [
    ("gpt", False, 0.0), ("gpt", True, 0.0), ("gpt", True, 0.1),
    ("llama", False, 0.0), ("llama", True, 0.0)])
def test_graphed_train_step_is_the_eager_sequence(card, arch, o2, dropout):
    vocab = 512
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, vocab, (2, 64))).to(card)
    want_losses, want_params, _ = _run(arch, o2, dropout, ids, False)
    adamw.launches = 0
    losses, params, step = _run(arch, o2, dropout, ids, True)
    assert losses == want_losses
    assert all(torch.equal(a, b) for a, b in zip(params, want_params))
    assert step.stats == {"compiled_steps": STEPS - 1, "eager_steps": 1}
    report = step.audit_report()
    assert report["n_cache_keys"] == 1 and report["total_captures"] == 1
    assert report["keys"][0]["replays"] == STEPS - 1
    # one launch per step: every parameter of one dtype fits one launch
    assert adamw.launches == STEPS


def test_second_shape_captures_a_second_graph_and_counters_count_replays(
        card):
    cfg, model, opt, loss_fn = _build("gpt", True, 0.0)
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    rs = np.random.RandomState(1)
    a = torch.from_numpy(rs.randint(0, 512, (2, 64))).to(card)
    b = torch.from_numpy(rs.randint(0, 512, (4, 32))).to(card)
    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    adamw.launches = 0
    for x in (a, a, a, b, b, b, a):
        loss = step(x)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    report = step.audit_report()
    assert report["n_cache_keys"] == 2 and report["total_captures"] == 2
    assert [k["captures"] for k in report["keys"]] == [1, 1]
    assert [k["replays"] for k in report["keys"]] == [3, 2]
    assert step.stats == {"compiled_steps": 5, "eager_steps": 2}
    layers = cfg.num_hidden_layers
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (7 * layers,) * 3
    assert adamw.launches == 7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_kernel_is_its_plain_version(card, dtype):
    rs = np.random.RandomState(2)
    sizes = [1, 7, 4097, 2 ** 20 + 3]

    def tensors(offset):
        out = []
        for n in sizes:
            p = torch.from_numpy(rs.randn(n + offset).astype(np.float32))
            g = torch.from_numpy(rs.randn(n + offset).astype(np.float32))
            m = torch.from_numpy(rs.randn(n + offset).astype(np.float32))
            v = torch.from_numpy(rs.rand(n + offset).astype(np.float32))
            out.append([t.to(card)[offset:] for t in (p.to(dtype), g.to(dtype),
                                                     m * 0.1, v * 0.01)])
        return out

    for coeff, l2 in ((0.01, None), (0.0, 0.01), (0.0, None)):
        for offset in (0, 1):  # 1: no base pointer 16-byte aligned
            got = tensors(offset)
            want = [[t.clone() for t in group] for group in got]
            lr = torch.tensor(3e-3, device=card)
            launched = adamw.launches
            for k in (1, 2):
                step = torch.tensor(k, dtype=torch.int32, device=card)
                for groups, fn in ((got, adamw.adamw_update),
                                   (want, adamw.adamw_reference)):
                    fn(*[[g[j] for g in groups] for j in range(4)], lr, step,
                       beta1=0.9, beta2=0.999, eps=1e-8, coeff=coeff,
                       weight_decay=l2)
            torch.cuda.synchronize()
            assert adamw.launches == launched + 2
            for a, b in zip(got, want):
                for x, y, name in zip(a, b, "pgmv"):
                    assert torch.equal(x, y), (dtype, coeff, l2, offset,
                                               x.numel(), name)


def test_capture_that_cannot_run_raises(card):
    def sync_inside(x):
        return x * float(x.sum())  # a host sync: not capturable

    fn = CompiledFunction(sync_inside, name="sync_inside")
    x = torch.ones(4, device=card)
    fn(x)
    with pytest.raises(RuntimeError, match="capture of sync_inside failed"):
        fn(x)
    assert fn.stats == {"compiled_steps": 0, "eager_steps": 1}


def test_a_failed_capture_leaves_the_thread_on_its_stream(card):
    """A capture that cannot run (a host sync) raises; the calling thread
    must be back on the stream it was on, or its later copies race the
    replay stream (a batch's logits read before their clone finished)."""
    fn = CompiledFunction(lambda x: x * float(x.sum()), name="sync_inside")
    x = torch.ones(4, device=card)
    fn(x)
    before = torch.cuda.current_stream()
    with pytest.raises(RuntimeError, match="capture of sync_inside failed"):
        fn(x)
    assert torch.cuda.current_stream() == before


# --------------------------------------------- the training-step API
def _recipe_build(name, kw, recipe):
    """gpt_tiny bf16 O2 with optimizer ``name``; ``recipe``: a warmup then
    cosine scheduler, two parameter groups (embeddings at half the LR),
    global-norm clipping and no decay on biases, norms and embeddings."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.optimizer import lr

    cfg = gpt.gpt_tiny()
    model = gpt.GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        0)).train()
    crit = gpt.GPTPretrainingCriterion(cfg)
    amp.decorate(model, level="O2", dtype="bfloat16")
    sched = None
    if recipe:
        sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=STEPS),
                                warmup_steps=2, start_lr=0.0, end_lr=1e-3)
        named = list(model.named_parameters())
        params = [{"params": [p for n, p in named if "embeddings" not in n]},
                  {"params": [p for n, p in named if "embeddings" in n],
                   "learning_rate": 0.5}]
        kw = dict(kw, learning_rate=sched, grad_clip=nn.ClipGradByGlobalNorm(
            0.5), apply_decay_param_fun=lambda n: n.endswith(".weight")
            and ".ln_" not in n and "embeddings" not in n)
    else:
        params = model.parameters()
    opt = getattr(optimizer, name)(parameters=params, **kw)

    def loss_fn(ids):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(ids)
        return crit(logits, ids)

    return model, opt, sched, loss_fn


OPTIMIZERS = [
    ("AdamW", dict(weight_decay=0.1), True),
    ("SGD", dict(learning_rate=1e-2), False),
    ("Momentum", dict(learning_rate=1e-2, use_nesterov=True), False),
    ("Adagrad", dict(learning_rate=1e-2), False),
    ("RMSProp", dict(learning_rate=1e-3, centered=True, momentum=0.9),
     False),
    ("Adadelta", dict(learning_rate=1.0), False),
    ("Adamax", dict(learning_rate=1e-3), False),
    ("Lamb", dict(learning_rate=1e-3), False),
    ("AdamW", dict(learning_rate=1e-3, amsgrad=True,
                   lr_ratio=lambda p: 0.5 if p.dim() == 1 else 1.0), False),
]


@pytest.mark.parametrize("name,kw,recipe", OPTIMIZERS,
                         ids=[f"{n}{'-recipe' if r else ''}-{i}"
                              for i, (n, _, r) in enumerate(OPTIMIZERS)])
def test_every_optimizer_graphed_is_the_eager_sequence(card, name, kw,
                                                       recipe):
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, (2, 64))).to(card)
    runs = []
    for graphed in (False, True):
        model, opt, sched, loss_fn = _recipe_build(name, kw, recipe)
        step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
        losses = []
        for _ in range(STEPS):
            if graphed:
                losses.append(step(ids))
            else:
                loss = loss_fn(ids)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(loss.detach())
            if sched is not None:
                sched.step()
        torch.cuda.synchronize()
        runs.append(([float(x) for x in losses],
                     [p.detach().clone() for p in model.parameters()]))
        if graphed:
            assert step.stats == {"compiled_steps": STEPS - 1,
                                  "eager_steps": 1}
    (want, want_p), (got, got_p) = runs
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(got_p, want_p))


def test_fp16_o1_grad_scaler_graphed_is_the_eager_sequence(card):
    """fp16 O1 with dynamic loss scaling on gpt_tiny (f32 parameters):
    the eager loop runs under ``set_sync_debug_mode("error")`` and skips
    its overflowed steps without changing a parameter; the same step
    function captured by ``CompiledFunction`` gives the same losses,
    scales and parameters bit for bit."""
    from paddle_tpu_torch.optimizer import AdamW as _AdamW

    ids = torch.from_numpy(np.random.RandomState(4).randint(
        0, 512, (2, 64))).to(card)
    runs = []
    for graphed in (False, True):
        cfg = gpt.gpt_tiny()
        model = gpt.GPTForCausalLM(cfg, generator=torch.Generator()
                                   .manual_seed(0)).train()
        crit = gpt.GPTPretrainingCriterion(cfg)
        opt = _AdamW(learning_rate=1e-3, parameters=model.parameters())
        # 2^24 overflows gpt_tiny's fp16 weight gradients; halving each
        # step reaches scales that do not within the 12 steps
        scaler = amp.GradScaler(init_loss_scaling=2.0 ** 24,
                                incr_every_n_steps=2)

        def step_fn(x):
            with amp.auto_cast(level="O1", dtype="float16"):
                loss = crit(model(x), x)
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
            return loss.detach()

        fn = CompiledFunction(step_fn, name="fp16_step") if graphed \
            else step_fn
        losses, scales, flags = [], [], []
        for _ in range(12):
            before = [p.detach().clone() for p in model.parameters()]
            if not graphed:
                torch.cuda.set_sync_debug_mode("error")
            try:
                loss = fn(ids)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            losses.append(float(loss))
            flags.append(bool(scaler._found_inf))
            scales.append(float(scaler._scale))
            if flags[-1]:
                assert all(torch.equal(a, b.detach()) for a, b in
                           zip(before, model.parameters()))
        runs.append((losses, scales, flags,
                     [p.detach().clone() for p in model.parameters()]))
    (wl, ws, wf, wp), (gl, gs, gf, gp) = runs
    assert any(wf) and not all(wf)
    assert (gl, gs, gf) == (wl, ws, wf)
    assert all(torch.equal(a, b) for a, b in zip(gp, wp))


@pytest.mark.parametrize("pdt,gdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float16, torch.float16),
                                     (torch.float16, torch.float32),
                                     (torch.float32, torch.float32)])
def test_adamw_kernel_modes_are_its_plain_version(card, pdt, gdt):
    """Per-tensor LR factors and decay, L2, amsgrad and found_inf."""
    rs = np.random.RandomState(5)
    sizes = [1, 7, 4097, 2 ** 16 + 3] * 20  # two launches of 64 and 16
    n = len(sizes)

    def make():
        return [[torch.from_numpy(rs.randn(k).astype(np.float32)).to(card)
                 for k in sizes] for _ in range(5)]

    base = make()
    for found in (None, False, True):
        for ams in (False, True):
            got = [[t.clone() for t in ts] for ts in base]
            got[0] = [t.to(pdt) for t in got[0]]
            got[1] = [t.to(gdt) for t in got[1]]
            got[3] = [t.abs() for t in got[3]]
            got[4] = [t.abs() for t in got[4]]
            want = [[t.clone() for t in ts] for ts in got]
            kw = dict(beta1=0.9, beta2=0.95, eps=1e-8,
                      coeff=[0.1 * (i % 3 != 0) for i in range(n)],
                      weight_decay=[0.01 if i % 4 == 1 else None
                                    for i in range(n)],
                      lr_factors=[((0.5,) if i % 2 else ()) + (0.3,) * (i % 5
                                                                    == 0)
                                  for i in range(n)],
                      found_inf=None if found is None
                      else torch.tensor(found, device=card))
            lr = torch.tensor(2e-3, device=card)
            step = torch.tensor(3, dtype=torch.int32, device=card)
            launched = adamw.launches
            adamw.adamw_update(got[0], got[1], got[2], got[3], lr, step,
                               max_exp_avg_sqs=got[4] if ams else None, **kw)
            assert adamw.launches == launched + 2
            adamw.adamw_reference(want[0], want[1], want[2], want[3], lr,
                                  step, max_exp_avg_sqs=want[4] if ams
                                  else None, **kw)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert all(torch.equal(x, y) for x, y in zip(a, b)), (
                    found, ams)
            if found:
                assert all(torch.equal(x, y.to(pdt))
                           for x, y in zip(got[0], base[0]))


@pytest.mark.parametrize("b,s,h,d,causal,dropout", [
    (2, 256, 4, 64, True, 0.0), (2, 256, 4, 64, False, 0.1),
    (1, 300, 2, 128, True, 0.1), (1, 200, 2, 32, False, 0.0)])
def test_fp16_flash_kernels_are_their_plain_versions(card, b, s, h, d,
                                                     causal, dropout):
    """fp16 K1-K3 (the bf16 tensor-core kernels instantiated for __half)
    within chip_smoke's fp16 gates of their plain versions: 2.5e-3 plus
    2^-10 of the value on O, 2.5e-3 plus 1.25e-3 on the gradients, 1e-3
    on lse."""
    rs = np.random.RandomState(6)
    q, k, v, do = (torch.from_numpy(rs.randn(b, s, h, d).astype(np.float32))
                   .to(card, torch.float16) for _ in range(4))
    seed = torch.tensor([77], dtype=torch.int32, device=card)
    scale = d ** -0.5
    launched = (fa.launches, fa.dq_launches, fa.dkv_launches)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, dropout, seed)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, seed, causal, scale,
                                   dropout)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal, scale,
                                                dropout, seed)
    rgrads = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seed,
                                              causal, scale, dropout)
    torch.cuda.synchronize()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in launched)
    assert o.dtype == torch.float16
    err = (o.float() - ro.float()).abs()
    assert bool((err <= 2.5e-3 + 2.0 ** -10 * ro.float().abs()).all())
    assert float((lse - rlse).abs().max()) <= 1e-3
    for g, r in zip(grads, rgrads):
        assert g.dtype == torch.float16
        err = (g.float() - r.float()).abs()
        assert bool((err <= 2.5e-3 + 1.25e-3 * r.float().abs()).all())
