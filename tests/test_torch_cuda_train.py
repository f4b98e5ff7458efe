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
