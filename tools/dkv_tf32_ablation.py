#!/usr/bin/env python3
"""Where the float32 dK/dV kernels spend their time: each step of the block
in ``paddle_tpu_torch/ops/cuda/csrc/dkv_tf32.cuh`` cut out in turn.

    python3 tools/dkv_tf32_ablation.py     # on a machine with one H100

Builds ``flash_attention_dkv_tf32.cu`` (f32 K3) and ``flashmask_dkv_tf32.cu``
(f32 K7) from the tree's sources and from copies in which one step does
nothing: the split of the Q/dO tile (``split_qdo``), the Sᵀ and dPᵀ
products (``issue_sdp``), the dV and dK products (``add_products``), the
exchange of partial sums at D = 128 (``exchange_sdp``). Then it times each
build in turn on one card, the tree's first and last, by CUDA events: K3
at GPT-2-small's training shape (B=8, S=1024, H=12, D=64, causal, dropout
0 and 0.1) and at D=128 (B=1, S=512, H=32), K7 at ``chip_smoke.py``'s
FlashMask path (B=1, S=8192, H=32, D=128, causal documents). A cut
kernel's output is wrong, so the error against the plain version is
printed as a check that the cut took. The builds go under the
gitignored ``paddle_tpu_torch/ops/cuda/build/ablation/``.
"""
from __future__ import annotations

import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from paddle_tpu_torch.ops.cuda import _build  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops.cuda import flashmask as fm  # noqa: E402

SOURCES = ("flash_attention_dkv_tf32", "flashmask_dkv_tf32")
# cut name -> (a unique piece of dkv_tf32.cuh, what takes its place)
CUTS = {
    "no Q/dO split": (
        "  constexpr int kUnits = (L::kN / 8) * (DP / 2);\n",
        "  constexpr int kUnits = (L::kN / 8) * (DP / 2);\n"
        "  if (tid >= 0) return;\n"),
    "no S^T/dP^T products": (
        "  const int kk0 = L::kSplitD ? wg * L::kSlices : 0;\n",
        "  const int kk0 = L::kSplitD ? wg * L::kSlices : 0;\n"
        "  wgmma_commit();\n  if (wg >= 0) return;\n"),
    "no dV/dK products": (
        "  // Q^T hi, Q^T lo, dO^T hi, dO^T lo, kT apart",
        "  if (wg >= 0) return;\n  // Q^T hi, Q^T lo, dO^T hi, dO^T lo, kT apart"),
    "no exchange (D=128)": (
        "  if constexpr (L::kSplitD) {\n    constexpr int kR",
        "  if constexpr (false) {\n    constexpr int kR"),
}
DOCS = [2988, 2863, 1909, 432]  # chip_smoke.py's path documents


def cut(text: str, name: str) -> str:
    piece, replacement = CUTS[name]
    if text.count(piece) != 1:
        raise ValueError(f"{name}: dkv_tf32.cuh no longer holds {piece!r}")
    return text.replace(piece, replacement)


def cuda_ms(fn, iters):
    for _ in range(3):
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


def cases(dev):
    rs = np.random.RandomState(0)

    def randn(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dev)

    seed = torch.tensor([1234], dtype=torch.int32, device=dev)
    out = []
    for b, s, h, d, p in ((8, 1024, 12, 64, 0.0), (8, 1024, 12, 64, 0.1),
                          (1, 512, 32, 128, 0.0)):
        q, k, v, do = (randn(b, s, h, d) for _ in range(4))
        scale = 1 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd_reference(q, k, v, True, scale, p,
                                                  seed)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seed,
                                                True, scale, p)[1:]
        out.append((f"K3 B={b} S={s} H={h} D={d} dropout={p}", fa,
                    (q, k, v, o, lse, do, seed, True, scale, p), want, 20,
                    slice(None)))
    s, h, d = 8192, 32, 128
    ends = np.repeat(np.cumsum(DOCS), DOCS).astype(np.int32)
    q, k, v, do = (randn(1, s, h, d) for _ in range(4))
    idx = fm.prepare_indices(torch.from_numpy(ends.reshape(1, 1, s, 1)), q,
                             k, True)
    scale = 1 / math.sqrt(d)
    o, lse = fm.flashmask_fwd(q, k, v, idx, True, scale)
    heads = slice(0, 4)  # the plain version 4 heads at a time
    want = fm.flashmask_bwd_reference(
        q[:, :, heads], k[:, :, heads], v[:, :, heads], o[:, :, heads],
        lse[:, heads], do[:, :, heads], idx, True, scale)[1:]
    out.append(("K7 FlashMask path B=1 S=8192 H=32 D=128", fm,
                (q, k, v, o, lse, do, idx, True, scale), want, 5, heads))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    tree, tree_build = _build.CSRC_DIR, _build.BUILD_DIR
    root = tree_build / "ablation"
    builds = [("tree", tree, tree_build)]
    for i, name in enumerate(CUTS):
        src = root / f"cut{i}" / "csrc"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(tree, src)
        header = src / "dkv_tf32.cuh"
        header.write_text(cut(header.read_text(), name))
        builds.append((name, src, src.parent / "build"))
    builds.append(("tree again", tree, tree_build))
    dev = torch.device("cuda")
    work = cases(dev)
    for label, src, build in builds:
        _build.CSRC_DIR, _build.BUILD_DIR = src, build
        _build._libs.clear()
        fa._fns.clear()
        fm._fns.clear()
        _build.build_all(SOURCES)
        for name, mod, args, want, iters, heads in work:
            launch_args, keep = mod.bwd_launch_args(*args)
            ms = cuda_ms(lambda: mod.run_bwd_pass("bwd_dkv", launch_args,
                                                  dev), iters)
            err = max(float((got[:, :, heads] - ref).abs().max())
                      for got, ref in zip(keep[1:3], want))
            print(f"{label:22s} {name}: {ms:.4f} ms (error vs plain "
                  f"{err:.2e})", flush=True)
            del keep
    return 0


if __name__ == "__main__":
    sys.exit(main())
