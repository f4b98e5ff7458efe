#!/usr/bin/env python3
"""Host cost of one eager call of the port's attention, RMSNorm and
optimizer kernels, per tree, so that two versions of the wrappers can be
compared on one card.

    python3 tools/dispatch_cost.py                       # this tree
    python3 tools/dispatch_cost.py --tree OLD --tree . --tree . --tree OLD

Each ``--tree`` (a checkout's root; the default is the one this file is in)
is measured in a process of its own, in the order given, with the tree's
``paddle_tpu_torch`` on the path: K1 (``F.flash_attention``, causal), K4
(``F.rms_norm``) and K5 (``F.flashmask_attention`` over packed documents),
bf16, each called through the functional entry point a model calls

- without autograd (``fwd``),
- on inputs that require grad, forward only (``fwd, grad``: the autograd
  Function's forward),
- forward and backward (``fwd+bwd``);

and the multi-tensor AdamW and Momentum updates (``ops/cuda/adamw.py``
``adamw_update``, ``momentum.py`` ``momentum_update``) over 64 bf16
tensors of 256 x 256 with f32 gradients and moments (one launch a call)
(``update``).

For each, ``CALLS`` calls are issued back to back, ``REPEATS`` times:
``host_us`` is the host's time to issue one call (the shapes are small, so
the card keeps up and the host's time is the call's cost), ``wall_us`` the
time per call once the card has drained. Their medians are printed, and
the least host time (``host_us_min``: the host is shared, and other work
on it only adds), one table a measurement with a column a run, and
written as JSON to ``--out``.
K5 at ``chip_smoke.py`` phase 14's shape (B=1, S=8192, H=32, D=128) is
timed by CUDA events as well (``fwd_ms``). With ``--phases`` each run
also drives the tree's own ``chip_smoke.py`` phases 12 (Llama training,
one CUDA graph a step) and 18 (a) (the ResNet-50 bench arm, one CUDA
graph a step) and keeps their step p50s; their printout goes to standard
error. Kernels are built
from each tree's sources; a library one tree built is copied to the next
when its name, which holds the digest of its source and flags, is the
same.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

CALLS, REPEATS, WARMUP = 200, 5, 20
SOURCES = ("flash_attention_fwd_sm90", "flash_attention_dq_sm90",
           "flash_attention_dkv_sm90", "flashmask_fwd_sm90",
           "flashmask_dq_sm90", "flashmask_dkv_sm90", "rms_norm", "adamw",
           "momentum")
UPDATE_TENSORS, UPDATE_SIDE = 64, 256
BUILD = Path("paddle_tpu_torch/ops/cuda/build")


def _documents(torch, s: int, lengths) -> "torch.Tensor":
    """Causal FlashMask indices [1, 1, s, 1]: a key's rows end at its
    document's end."""
    ends, start = [], 0
    for n in lengths:
        ends += [start + n] * n
        start += n
    return torch.tensor(ends, dtype=torch.int32,
                        device="cuda").view(1, 1, s, 1)


def _calls(torch, F):
    """The measured calls: name -> (inputs, call)."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", dtype=torch.bfloat16,
                           generator=g)

    x, w = rand(2048, 768), rand(768)
    q, k, v = rand(2, 1024, 12, 64), rand(2, 1024, 12, 64), rand(2, 1024,
                                                                 12, 64)
    mq, mk, mv = (rand(1, 1024, 8, 128) for _ in range(3))
    idx = _documents(torch, 1024, (400, 300, 200, 124))
    return {
        "K1 flash_attention": ((q, k, v), lambda a, b, c: F.flash_attention(
            a, b, c, causal=True)[0]),
        "K4 rms_norm": ((x, w), lambda a, b: F.rms_norm(a, b, 1e-6)),
        "K5 flashmask_attention": ((mq, mk, mv), lambda a, b, c:
                                   F.flashmask_attention(a, b, c, idx,
                                                         causal=True)),
    }


def _time(torch, fn) -> dict:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / CALLS * 1e6)
        wall.append((t2 - t0) / CALLS * 1e6)
    host.sort()
    wall.sort()
    return {"host_us_min": host[0], "host_us": host[REPEATS // 2],
            "wall_us": wall[REPEATS // 2]}


def _updates(torch) -> dict:
    """The optimizer updates: name -> call, each one launch."""
    from paddle_tpu_torch.ops.cuda import adamw, momentum

    g = torch.Generator(device="cuda").manual_seed(2)
    shape = (UPDATE_SIDE, UPDATE_SIDE)

    def tensors(dtype):
        return [torch.randn(*shape, device="cuda", generator=g).to(dtype)
                for _ in range(UPDATE_TENSORS)]

    p, grads = tensors(torch.bfloat16), tensors(torch.float32)
    m, v = tensors(torch.float32), tensors(torch.float32)
    v = [t.abs() for t in v]
    lr = torch.tensor(1e-6, device="cuda")
    step = torch.tensor(1, device="cuda")
    return {
        "AdamW update": lambda: adamw.adamw_update(
            p, grads, m, v, lr, step, beta1=0.9, beta2=0.999, eps=1e-8,
            coeff=0.01),
        "Momentum update": lambda: momentum.momentum_update(
            p, grads, m, lr, momentum=0.9),
    }


def _phases(torch) -> dict:
    """The step p50s of the tree's chip_smoke.py phases 12 and 18 (a)."""
    import chip_smoke
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.vision.models import resnet

    with contextlib.redirect_stdout(sys.stderr):
        trained = chip_smoke.phase_train_llama(torch, llama)
        arm, model = chip_smoke.resnet_bench_arm(torch, resnet)
        del model
    return {("phase 12 Llama TrainStep", "p50_ms"): {"ms": trained["p50_ms"]},
            ("phase 18 ResNet-50 TrainStep", "p50_ms"): {"ms": arm["p50_ms"]}}


def child(phases: bool) -> dict:
    import torch

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all(SOURCES)
    out = {}
    for name, (inputs, call) in _calls(torch, F).items():
        with torch.no_grad():
            out[(name, "fwd")] = _time(torch, lambda: call(*inputs))
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out[(name, "fwd, grad")] = _time(torch, lambda: call(*leaves))
        y = call(*leaves)
        dy = torch.ones_like(y)

        def step():
            call(*leaves).backward(dy)

        out[(name, "fwd+bwd")] = _time(torch, step)
    for name, call in _updates(torch).items():
        out[(name, "update")] = _time(torch, call)
    # K5 at phase 14's shape, by CUDA events
    b, s, h, d = 1, 8192, 32, 128
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(b, s, h, d, device="cuda", dtype=torch.bfloat16,
                           generator=gen) for _ in range(3))
    idx = _documents(torch, s, (2988, 2863, 1909, 432))
    times = []
    with torch.no_grad():
        for i in range(13):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            F.flashmask_attention(q, k, v, idx, causal=True)
            end.record()
            end.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
    times.sort()
    out[("K5 flashmask_attention B=1 S=8192 H=32 D=128", "fwd_ms")] = {
        "ms": times[len(times) // 2]}
    if phases:
        out.update(_phases(torch))
    return {f"{a} | {b}": v for (a, b), v in out.items()}


def _share_builds(src: Path, trees) -> None:
    for tree in trees:
        dst = tree / BUILD
        if dst == src / BUILD or not (src / BUILD).is_dir():
            continue
        dst.mkdir(parents=True, exist_ok=True)
        for lib in (src / BUILD).glob("*.so"):
            if ".tmp." not in lib.name and not (dst / lib.name).exists():
                shutil.copy2(lib, dst / lib.name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", type=Path,
                    help="a checkout's root (repeat; measured in order)")
    ap.add_argument("--out", type=Path, help="write the results as JSON")
    ap.add_argument("--phases", action="store_true",
                    help="also run chip_smoke.py phases 14 and 12 per tree")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.phases)), flush=True)
        return 0
    trees = [t.resolve() for t in (args.tree
                                   or [Path(__file__).resolve().parent.parent])]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    runs = []
    for i, tree in enumerate(trees):
        env = dict(os.environ, PYTHONPATH=str(tree))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--child", *(["--phases"] * args.phases)],
                              cwd=tree, env=env, capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"run {i}: {tree}", flush=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.with_suffix(f".run{i}.log").write_text(proc.stderr)
        _share_builds(tree, trees)
    for key in runs[0]:
        for metric in runs[0][key]:
            cells = "  ".join(f"{r[key][metric]:10.3f}" for r in runs)
            print(f"{key:<60} {metric:>8}  {cells}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card,
                                        "trees": [str(t) for t in trees],
                                        "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
