"""On-card tests of the port's RMSNorm kernel and Llama (marker ``cuda``).

They need an NVIDIA Hopper GPU and ``nvcc``, and skip on hosts without a
GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_llama.py

K4 is held against its plain PyTorch version on the same card: f32 within
1e-5 of each row's largest output; bf16 within one bf16 step (2⁻⁷ of the
value) plus 1e-3. The backward kernel is held against its plain version
(``rms_norm_bwd_reference``): f32 dx and dw within 1e-5 of each gradient's
max, and within 1e-5 of the plain version computed in float64; bf16 within
one bf16 step plus 1e-3. Both run at ``chip_smoke.py``'s phase-10 shapes,
one with strided rows, and at widths that leave lanes masked; fp16 x
(with fp16 or f32 w) at the bf16 gates divided by 8, the backward with
the f32 gate's room for dw's sum order beside them. Two
backward calls on the same inputs, and a CUDA
graph of forward and backward replayed, give the eager call's bits.
``llama_tiny``'s gradients on the card (K1–K4 and the backward kernel) are
held against the CPU plain path within 1e-4, in f32 with TF32 off.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_tiny)
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import rms_norm as rms

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == torch.float32:
        top = want.abs().amax(dim=-1, keepdim=True)
        return bool((err <= 1e-5 * top).all())
    return bool((err <= 2.0 ** -7 * want.abs() + 1e-3).all())


CASES = [
    # shape, x dtype, w dtype, strided rows
    ((4, 2048, 768), torch.bfloat16, torch.bfloat16, False),
    ((1000, 768), torch.float32, torch.float32, False),   # ragged rows
    ((256, 4096), torch.bfloat16, torch.bfloat16, False),  # block per row
    ((8, 100), torch.float32, torch.float32, False),       # odd d
    ((9, 100), torch.bfloat16, torch.float32, False),      # mixed types
    ((5, 3000), torch.float32, torch.bfloat16, True),      # strided rows
]


def test_kernel_matches_plain(card):
    rs = np.random.RandomState(0)
    for shape, xt, wt, strided in CASES:
        d = shape[-1]
        x = torch.from_numpy(rs.randn(*shape).astype(np.float32) * 3)
        if strided:  # rows 2d apart: a view, no copy
            x = torch.cat([x, x], dim=-1)[..., :d]
        x = x.to(card, xt)
        w = torch.from_numpy(rs.uniform(0.5, 1.5, d).astype(np.float32)).to(
            card, wt)
        before = rms.launches
        got = rms.rms_norm_fwd(x, w, 1e-5)
        torch.cuda.synchronize()
        assert rms.launches == before + 1
        want = rms.rms_norm_reference(x, w, 1e-5)
        assert got.dtype == xt and got.shape == x.shape
        assert bool(torch.isfinite(got.float()).all())
        assert _close(got, want, xt), (shape, xt, wt)


# chip_smoke.py's RMS_SHAPES: Llama's training rows, a few rows, ragged
# rows, llama3_8b's width (a block a row) and an odd d (the general path)
RMS_SHAPES = ((8192, 768), (4, 768), (1000, 768), (256, 4096), (8, 100))
# widths whose vectors do not fill the last one a thread holds, so lanes
# are masked: llama_tiny's 64 (a warp a row), 1000 (a warp a row forward,
# a block backward) and 2560 (a block a row)
MASKED_SHAPES = ((300, 64), (50, 1000), (77, 2560))
EPS = 1e-5


def _rms_inputs(rows, d, dtype, seed, strided=False):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(rows, d).astype(np.float32) * 3)
    if strided:  # rows 2d apart: a view, no copy
        x = torch.cat([x, x], dim=-1)[:, :d]
    w = torch.from_numpy(rs.uniform(0.5, 1.5, d).astype(np.float32))
    g = torch.from_numpy(rs.randn(rows, d).astype(np.float32))
    dt = getattr(torch, dtype)
    return x.to("cuda", dt), w.to("cuda", dt), g.to("cuda", dt)


def _grad_close(got, want, dtype):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == "float32":
        return bool((err <= 1e-5 * want.abs().max()).all())
    return bool((err <= 2.0 ** -7 * want.abs() + 1e-3).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", RMS_SHAPES + MASKED_SHAPES)
def test_one_pass_forward_matches_plain_at_the_llama_shapes(card, rows, d,
                                                            dtype):
    for strided in (False, True):
        x, w, _ = _rms_inputs(rows, d, dtype, seed=rows + d, strided=strided)
        before = rms.launches
        got = rms.rms_norm_fwd(x, w, EPS)
        torch.cuda.synchronize()
        assert rms.launches == before + 1
        assert _close(got, rms.rms_norm_reference(x, w, EPS),
                      getattr(torch, dtype)), (rows, d, dtype, strided)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", RMS_SHAPES + MASKED_SHAPES)
def test_bwd_kernel_matches_plain(card, rows, d, dtype):
    for strided in (False, True):
        x, w, g = _rms_inputs(rows, d, dtype, seed=rows * d, strided=strided)
        before = rms.bwd_launches
        dx, dw = rms.rms_norm_bwd(x, w, g, EPS)
        torch.cuda.synchronize()
        assert rms.bwd_launches == before + rms.BWD_LAUNCHES_PER_CALL
        assert dx.dtype == x.dtype and dx.shape == x.shape
        assert dw.dtype == w.dtype and dw.shape == w.shape
        assert bool(torch.isfinite(dx.float()).all())
        assert bool(torch.isfinite(dw.float()).all())
        want_dx, want_dw = rms.rms_norm_bwd_reference(x, w, g, EPS)
        assert _grad_close(dx, want_dx, dtype), (rows, d, dtype, strided)
        assert _grad_close(dw, want_dw, dtype), (rows, d, dtype, strided)
        if dtype == "float32":
            ref_dx, ref_dw = rms.rms_norm_bwd_reference(
                x.double(), w.double(), g.double(), EPS)
            assert _grad_close(dx, ref_dx, dtype), (rows, d, strided)
            assert _grad_close(dw, ref_dw, dtype), (rows, d, strided)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_kernel_is_deterministic(card, dtype):
    for rows, d in RMS_SHAPES + MASKED_SHAPES:
        x, w, g = _rms_inputs(rows, d, dtype, seed=3)
        first = rms.rms_norm_bwd(x, w, g, EPS)
        second = rms.rms_norm_bwd(x, w, g, EPS)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), (
            rows, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_of_forward_and_backward_replays_the_eager_bits(card, dtype):
    x, w, g = _rms_inputs(8192, 768, dtype, seed=4)
    want = (rms.rms_norm_fwd(x, w, EPS), *rms.rms_norm_bwd(x, w, g, EPS))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rms.rms_norm_fwd(x, w, EPS)
        rms.rms_norm_bwd(x, w, g, EPS)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = (rms.rms_norm_fwd(x, w, EPS), *rms.rms_norm_bwd(x, w, g, EPS))
    for _ in range(2):
        for t in got:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# float16 against the plain version: the bf16 gates divided by 8 (fp16's
# step is 2^-10 of the value, bf16's 2^-7); the backward also keeps the
# f32 gate's 1e-5 of the gradient's max, the room the f32 sums of dw take
# in their own order before the one rounding to fp16
FP16_REL, FP16_ATOL, FP16_OF_MAX = 2.0 ** -10, 1.25e-4, 1e-5


def _fp16_close(got, want, of_max=0.0):
    got, want = got.float(), want.float()
    limit = (FP16_REL * want.abs() + FP16_ATOL
             + of_max * float(want.abs().max()))
    return bool(((got - want).abs() <= limit).all())


@pytest.mark.parametrize("w_dtype", ["float16", "float32"])
@pytest.mark.parametrize("rows,d", RMS_SHAPES + MASKED_SHAPES)
def test_kernels_take_float16(card, rows, d, w_dtype):
    """K4 and the RMSNorm backward kernel take float16 x (with fp16 or f32
    w, as AMP O1 and O2 give them): y and dx in x's dtype, dw in w's,
    against their plain versions, strided rows too, and two backward
    calls give the same bits. Before the fp16 codes both wrappers raised
    ``TypeError`` here."""
    for strided in (False, True):
        x, w, g = _rms_inputs(rows, d, "float16", seed=rows + 7 * d,
                              strided=strided)
        w = w.to(getattr(torch, w_dtype))
        case = (rows, d, w_dtype, strided)
        before = (rms.launches, rms.bwd_launches)
        y = rms.rms_norm_fwd(x, w, EPS)
        dx, dw = rms.rms_norm_bwd(x, w, g, EPS)
        again = rms.rms_norm_bwd(x, w, g, EPS)
        torch.cuda.synchronize()
        assert (rms.launches, rms.bwd_launches) == (
            before[0] + 1, before[1] + 2 * rms.BWD_LAUNCHES_PER_CALL), case
        assert y.dtype == dx.dtype == torch.float16 and dw.dtype == w.dtype
        assert all(bool(torch.isfinite(t.float()).all()) for t in (y, dx, dw))
        assert _fp16_close(y, rms.rms_norm_reference(x, w, EPS)), case
        want_dx, want_dw = rms.rms_norm_bwd_reference(x, w, g, EPS)
        assert _fp16_close(dx, want_dx, FP16_OF_MAX), case
        assert _fp16_close(dw, want_dw, FP16_OF_MAX), case
        assert torch.equal(dx, again[0]) and torch.equal(dw, again[1]), case


def _grads(model, ids):
    loss = LlamaPretrainingCriterion(model.config)(model(ids), ids)
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


def test_llama_tiny_gradients_match_cpu(card):
    """Training-mode Llama on the card differentiates through K1–K4 and
    the RMSNorm backward kernel; every gradient matches the CPU plain path
    within 1e-4."""
    cfg = llama_tiny(num_attention_heads=4, num_key_value_heads=2)
    gpu = LlamaForCausalLM(cfg, generator=torch.Generator().manual_seed(3))
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 100))
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches, rms.launches,
              rms.bwd_launches)
    loss_gpu, g_gpu = _grads(gpu.train(), torch.from_numpy(ids).to(card))
    torch.cuda.synchronize()
    layers = cfg.num_hidden_layers
    assert (fa.launches - counts[0], fa.dq_launches - counts[1],
            fa.dkv_launches - counts[2], rms.launches - counts[3],
            rms.bwd_launches - counts[4]) == (
                layers, layers, layers, 2 * layers + 1,
                (2 * layers + 1) * rms.BWD_LAUNCHES_PER_CALL)
    loss_cpu, g_cpu = _grads(cpu.train(), torch.from_numpy(ids))
    assert abs(loss_gpu.item() - loss_cpu.item()) <= 1e-4
    for name, want in g_cpu.items():
        got = g_gpu[name].cpu()
        assert float((got - want).abs().max()) <= 1e-4, name
