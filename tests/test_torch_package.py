"""Package boundaries of the PyTorch/CUDA port.

``paddle_tpu_torch`` and ``chip_smoke.py`` import neither JAX, the JAX
package nor ``ml_dtypes`` (which comes with JAX, and which a PyTorch
install need not have), and every entry point runs on the GPU unless
the caller asks for the CPU: without CUDA, the defaults raise instead of
falling back.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "paddle_tpu_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")


def test_no_jax_or_jax_package_import_in_source():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for module in ("ops/cuda/flashmask.py", "nn/functional/flash_attention.py",
                   "incubate/nn/functional.py"):
        assert PACKAGE / module in files, module
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []
    # the prefix check must not mistake the port for the JAX package
    assert not _forbidden("paddle_tpu_torch.serving")
    assert _forbidden("paddle_tpu.serving") and _forbidden("jax.numpy")
    assert _forbidden("ml_dtypes")


def test_gpt_presets_match_jax():
    from paddle_tpu.models import gpt as jax_gpt
    from paddle_tpu_torch.models import gpt as port_gpt

    for name in ("gpt_tiny", "gpt2_small", "gpt2_medium", "gpt_1p3b"):
        want = getattr(jax_gpt, name)()
        got = getattr(port_gpt, name)()
        assert vars(got) == vars(want), name
    assert port_gpt.gpt2_small().head_dim == 64


def test_llama_presets_match_jax():
    from paddle_tpu.models import llama as jax_llama
    from paddle_tpu_torch.models import llama as port_llama

    for name in ("llama_tiny", "llama2_7b", "llama3_8b"):
        want = getattr(jax_llama, name)()
        got = getattr(port_llama, name)()
        assert vars(got) == vars(want), name
    # the port's own preset is bench.py's bench_llama accelerator config
    want = jax_llama.LlamaConfig(
        vocab_size=32000, hidden_size=768, num_hidden_layers=12,
        num_attention_heads=12, num_key_value_heads=4,
        intermediate_size=2048, max_position_embeddings=2048)
    assert vars(port_llama.llama_124m_gqa()) == vars(want)
    assert port_llama.llama3_8b().head_dim == 128


def test_cpu_engine_runs_without_loading_jax():
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny\n"
        "from paddle_tpu_torch.serving import DecodeEngine\n"
        "model = GPTForCausalLM(gpt_tiny(num_hidden_layers=1), device='cpu')\n"
        "eng = DecodeEngine(model.eval(), device='cpu', max_slots=2,\n"
        "                   max_seq=64, page_size=16).warmup()\n"
        "out = eng.generate('t', [1, 2, 3, 4, 5], 4, timeout=60)\n"
        "eng.shutdown()\n"
        "assert out.shape == (4,), out\n"
        "import torch\n"
        "from paddle_tpu_torch.nn.functional import flashmask_attention\n"
        "q = torch.randn(1, 8, 1, 16)\n"
        "idx = torch.full((1, 1, 8, 1), 8, dtype=torch.int32)\n"
        "assert flashmask_attention(q, q, q, idx).shape == q.shape\n"
        "import tempfile, numpy as np\n"
        "from paddle_tpu_torch import jit\n"
        "from paddle_tpu_torch.serving import ServingEngine\n"
        "from paddle_tpu_torch.static import InputSpec\n"
        "prefix = tempfile.mkdtemp() + '/gpt'\n"
        "jit.save(model, prefix, input_spec=[InputSpec([None, None], 'int64')])\n"
        "assert jit.load(prefix, device='cpu')(np.ones((1, 3))).shape[1] == 3\n"
        "srv = ServingEngine(prefix, device='cpu', buckets=[1, 2],\n"
        "                    seq_buckets=[8]).warmup()\n"
        "logits, = srv.run('t', np.arange(10).reshape(2, 5), timeout=60)\n"
        "srv.shutdown()\n"
        "assert logits.shape == (2, 5, 512), logits.shape\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print('LOADED', loaded)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the default device on a host without CUDA")
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_fwd, flash_attention_value)
    from paddle_tpu_torch.ops.cuda.flashmask import (
        flashmask_bwd, flashmask_fwd, flashmask_value)
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.ops.cuda.rms_norm import (rms_norm_fwd,
                                                    rms_norm_value)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving import DecodeEngine, KVPagePool

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(gpt_tiny())
    model = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVPagePool(1, 4, 16, 1, 8)
    q = torch.zeros(1, 16, 1, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention_fwd(q, q, q, True, 0.25)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_attention_value(q, q, q, True, 0.25)
    idx = torch.full((1, 1, 16, 1), 16, dtype=torch.int32)
    for fn in (flashmask_fwd, flashmask_value):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(q, q, q, idx, True, 0.25)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flashmask_bwd(q, q, q, q, torch.zeros(1, 1, 1, 16), q, idx, True,
                      0.25)
    flashmask_value(q, q, q, idx, True, 0.25, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(llama_tiny())
    LlamaForCausalLM(llama_tiny(), device="cpu")
    x, w = torch.ones(2, 8), torch.ones(8)
    for fn in (rms_norm_fwd, rms_norm_value, fused_rms_norm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(x, w)
    out, residual = fused_rms_norm(x, w, residual=x, device="cpu")
    assert torch.equal(residual, 2 * x) and out.shape == x.shape
    with pytest.raises(RuntimeError, match="no CUDA device"):
        amp.decorate(model, level="O2", dtype="bfloat16")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdamW(parameters=model.parameters())
    opt = AdamW(parameters=model.parameters(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainStep(model=model, optimizer=opt, loss_fn=lambda x: x)
    TrainStep(model=model, optimizer=opt, loss_fn=lambda x: x, device="cpu")
    with pytest.raises(ValueError, match="use 'cuda' or 'cpu'"):
        resolve_device("meta")
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import Config, Predictor
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.static import InputSpec

    prefix = str(tmp_path / "gpt")
    jit.save(model, prefix, input_spec=[InputSpec([None, None], "int64")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jit.load(prefix)
    assert Config(prefix).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(Config(prefix))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(prefix)
    jit.load(prefix, device="cpu")
    Predictor(Config(prefix, device="cpu"))
    ServingEngine(prefix, device="cpu", buckets=[1], seq_buckets=[8])
