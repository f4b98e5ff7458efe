"""``bench.py``'s five training arms on the port, with only their imports
renamed (``paddle_tpu`` → ``paddle_tpu_torch``).

The arms are read from ``bench.py`` as text, as ``chip_smoke.py`` phase 21
reads them (``bench_arm_source``): each from its ``def`` through the end
of its timing, ``dt = time.perf_counter() - t0``. The renamed text differs
from ``bench.py``'s only in import statements. With ``set_device("cpu")``
and ``on_tpu=False`` (bench's own CPU sizes: gpt_tiny and llama_tiny at
4 × 128, bert_tiny at 4 × 32, resnet18 at 2 × 3 × 32², pp_liteseg(base=16)
at 2 × 3 × 64²) each arm's loss stream (its first step and its timed ones)
is bit for bit that of the port's hand-built ``TrainStep(device="cpu")``
on the same seed and inputs; those hand-built steps are held against the
JAX package by ``test_torch_train.py``, ``test_torch_llama.py``,
``test_torch_bert.py``, ``test_torch_resnet.py`` and
``test_torch_segdet.py``. ``test_torch_cuda_bench_arms.py`` runs the GPT
arm at its CPU size on the card.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch import nn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert, gpt, llama
from paddle_tpu_torch.ops.manipulation import reshape, transpose
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.vision.models import pp_liteseg, resnet18

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


@pytest.fixture
def on_cpu(monkeypatch):
    """``set_device("cpu")`` for one test; the default comes back after."""
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")
    yield


def _gen():
    return torch.Generator().manual_seed(0)


def _lm(model_cls, crit_cls, cfg, rs):
    model = model_cls(cfg, device="cpu", generator=_gen())
    crit = crit_cls(cfg)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                device="cpu")
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (4, 128))
                           .astype(np.int64))
    return model, opt, lambda ids: crit(model(ids), ids), (ids,), 5


def _hand_built(name):
    """The arm's CPU setup built by hand on the port: (model, optimizer,
    loss_fn, batch, timed steps)."""
    rs = np.random.RandomState(0)
    if name == "bench_gpt":
        return _lm(gpt.GPTForCausalLM, gpt.GPTPretrainingCriterion,
                   gpt.gpt_tiny(), rs)
    if name == "bench_llama":
        return _lm(llama.LlamaForCausalLM, llama.LlamaPretrainingCriterion,
                   llama.llama_tiny(), rs)
    crit = nn.CrossEntropyLoss()
    if name == "bench_bert":
        cfg = bert.bert_tiny()
        model = bert.BertForSequenceClassification(
            cfg, num_classes=2, device="cpu", generator=_gen())
        opt = AdamW(learning_rate=5e-5, parameters=model.parameters(),
                    device="cpu")
        ids = rs.randint(0, cfg.vocab_size, (4, 32)).astype(np.int64)
        labels = rs.randint(0, 2, (4,)).astype(np.int64)
        batch = (torch.from_numpy(ids), torch.from_numpy(labels))
        return model, opt, lambda i, y: crit(model(i), y), batch, 5
    if name == "bench_resnet":
        model = resnet18(num_classes=10, device="cpu", generator=_gen())
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=model.parameters(), device="cpu")
        x = rs.randn(2, 3, 32, 32).astype(np.float32)
        y = rs.randint(0, 10, (2,)).astype(np.int64)
        batch = (torch.from_numpy(x), torch.from_numpy(y))
        return model, opt, lambda x, y: crit(model(x), y), batch, 3
    model = pp_liteseg(num_classes=4, base=16, device="cpu", generator=_gen())
    opt = Momentum(learning_rate=0.01, momentum=0.9,
                   parameters=model.parameters(), device="cpu")
    x = rs.randn(2, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 4, (2, 64, 64)).astype(np.int64)

    def loss_fn(x, y):
        flat = reshape(transpose(model(x), [0, 2, 3, 1]), [-1, 4])
        return crit(flat, reshape(y, [-1]))

    return model, opt, loss_fn, (torch.from_numpy(x), torch.from_numpy(y)), 3


@pytest.mark.parametrize("name", cs.BENCH_ARMS)
def test_arm_differs_from_bench_only_in_its_imports(name):
    text = (ROOT / "bench.py").read_text()
    original, renamed = cs.bench_arm_source(name, text)
    assert original in text
    assert original.splitlines()[0].startswith(f"def {name}(on_tpu)")
    assert original.splitlines()[-1].strip() == cs.BENCH_ARM_END
    a, b = original.splitlines(), renamed.splitlines()
    assert len(a) == len(b)
    changed = [(x, y) for x, y in zip(a, b) if x != y]
    assert changed, "no import was renamed"
    for x, y in changed:
        assert x.lstrip().startswith(("import paddle_tpu", "from paddle_tpu"))
        assert y == x.replace("paddle_tpu", "paddle_tpu_torch", 1)
    assert "paddle_tpu." not in renamed.replace("paddle_tpu_torch", "")
    assert not any("import paddle_tpu " in line or line.rstrip().endswith(
        "import paddle_tpu") for line in b)


@pytest.mark.parametrize("name", cs.BENCH_ARMS)
def test_arm_on_cpu_is_bit_for_bit_the_hand_built_step(name, on_cpu):
    local, losses = cs.run_bench_arm(name, on_tpu=False)
    model, opt, loss_fn, batch, steps = _hand_built(name)
    assert local["steps"] == steps and len(losses) == steps + 1
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn,
                     device="cpu")
    want = [step(*batch) for _ in range(steps + 1)]
    for got, exp in zip(losses, want):
        assert type(got) is paddle.Tensor
        assert torch.equal(got.as_subclass(torch.Tensor),
                           exp.as_subclass(torch.Tensor)), (losses, want)
    for p, q in zip(local["model"].parameters(), model.parameters()):
        assert torch.equal(p, q)
    # the arm's own read of the last loss
    assert local["loss"].numpy() == want[-1].numpy()
