"""The port's export and inference tier against the JAX package's:
``static.InputSpec``, ``framework.io`` files read across packages, K1's
forward as the registered operator ``paddle_tpu_torch::flash_attention_fwd``,
``jit.save``/``jit.load`` over ``torch.export`` (the ``.pdmeta`` of both
packages, one custom-op node a layer, a load in a fresh process, one
export for every rung of the grid), ``inference.Config``/``Predictor``
(the ladder, the rung count, ``run_many`` against JAX's ``Predictor`` on
the [1, 2] x [8, 16] grid within 1e-4, weight swaps).

The models are the JAX serving tests' (``tests/test_serving.py``: a
16-32-8 MLP; ``tests/test_decode_serving.py``: ``gpt_tiny`` with 1 layer,
hidden 32, 2 heads, 64 positions), f32, on the CPU.
"""
import logging
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.checkpoint.sharded import \
    save_sharded as jax_save_sharded
from paddle_tpu.framework import io as jax_io
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.static import InputSpec as JaxInputSpec
from paddle_tpu_torch import jit
from paddle_tpu_torch.distributed.checkpoint.sharded import save_sharded
from paddle_tpu_torch.framework import io as port_io
from paddle_tpu_torch.inference import Config, Predictor
from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_tiny,
                                         jax_state_dict, load_jax_state)
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.static import InputSpec

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(num_hidden_layers=1, hidden_size=32, num_attention_heads=2,
            max_position_embeddings=64)
# the port's logits against JAX's, f32 on the CPU (tests/test_torch_gpt.py)
TOL = 1e-4


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                               torch.nn.Linear(32, 8)).eval()


def _gpt(layers=1):
    return GPTForCausalLM(gpt_tiny(**dict(TINY, num_hidden_layers=layers)),
                          device="cpu").eval()


def _cpu(prefix):
    return Predictor(Config(prefix, device="cpu"))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One tiny GPT exported by both packages: the JAX model and the port's
    copy of its weights (``load_jax_state``)."""
    d = tmp_path_factory.mktemp("pair")
    paddle.seed(0)
    ref = JaxGPT(jax_gpt_tiny(**TINY))
    ref.eval()
    paddle.jit.save(ref, str(d / "jax"),
                    input_spec=[JaxInputSpec([None, None], "int64")])
    model = _gpt()
    load_jax_state(model, {k: np.asarray(v.numpy())
                           for k, v in ref.state_dict().items()})
    jit.save(model, str(d / "port"),
             input_spec=[InputSpec([None, None], "int64")])
    return str(d / "jax"), str(d / "port"), model


# ---------------------------------------------------------------- InputSpec
@pytest.mark.parametrize("shape,dtype,want_shape,want_dtype", [
    ([None, 16], "float32", [None, 16], torch.float32),
    ([-1, -1], "int64", [None, None], torch.int64),
    ([4, 16], torch.bfloat16, [4, 16], torch.bfloat16),
    ([None, 8], np.int32, [None, 8], torch.int32),
])
def test_input_spec_dims_and_dtypes(shape, dtype, want_shape, want_dtype):
    spec = InputSpec(shape, dtype, name="x")
    assert spec.shape == want_shape and spec.dtype == want_dtype
    assert spec.shape == JaxInputSpec(shape, "float32").shape
    assert spec == InputSpec(shape, dtype, name="x")
    assert InputSpec.from_tensor(torch.zeros(2, 3, dtype=want_dtype)) == \
        InputSpec([2, 3], want_dtype)


# ------------------------------------------------------------- framework.io
@pytest.mark.parametrize("dtype", ["float32", "int32", "int64"])
def test_io_files_read_across_packages(tmp_path, dtype):
    rs = np.random.RandomState(0)
    arr = (rs.randn(3, 5) * 100).astype(dtype)
    port_io.save({"w": torch.from_numpy(arr), "n": [torch.from_numpy(arr)],
                  "step": 7}, str(tmp_path / "port.pdparams"))
    got = jax_io.load(str(tmp_path / "port.pdparams"))
    np.testing.assert_array_equal(got["w"].numpy(), arr)
    np.testing.assert_array_equal(got["n"][0].numpy(), arr)
    assert got["step"] == 7
    jax_io.save({"w": paddle.to_tensor(arr)}, str(tmp_path / "jax.pdparams"))
    back = port_io.load(str(tmp_path / "jax.pdparams"))
    assert isinstance(back["w"], torch.Tensor)
    np.testing.assert_array_equal(back["w"].numpy(),
                                  jax_io.load(str(tmp_path / "jax.pdparams"),
                                              return_numpy=True)["w"])


def test_io_bf16_round_trips_through_raw_words(tmp_path):
    t = torch.randn(4, 6).to(torch.bfloat16)
    port_io.save({"t": t}, str(tmp_path / "b.pdparams"))
    with open(tmp_path / "b.pdparams", "rb") as f:
        tag, arr, name = pickle.load(f)["t"]
    assert (tag, arr.dtype, name) == ("__tensor__", np.uint16, "bfloat16")
    assert torch.equal(port_io.load(str(tmp_path / "b.pdparams"))["t"], t)
    # a JAX bf16 file (an ml_dtypes array) reads through the same words
    jax_io.save({"t": paddle.to_tensor(t.float().numpy()).astype(
        "bfloat16")}, str(tmp_path / "j.pdparams"))
    assert torch.equal(port_io.load(str(tmp_path / "j.pdparams"))["t"], t)


# ---------------------------------------------------------------- custom op
@pytest.mark.parametrize("b,s,causal", [(1, 8, True), (2, 16, False)])
def test_k1_custom_op_cpu_and_fake(b, s, causal):
    rs = np.random.RandomState(b)
    q, k, v = (torch.from_numpy(rs.randn(b, s, 2, 16).astype(np.float32))
               for _ in range(3))
    o, lse = fa.flash_attention_fwd_op(q, k, v, None, causal, 0.25, 0.0,
                                       fa.BLOCK_Q, fa.BLOCK_K)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal, 0.25)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert lse.shape == (b, 2, 1, s) and lse.is_contiguous()
    torch.library.opcheck(fa.flash_attention_fwd_op,
                          (q, k, v, None, causal, 0.25, 0.0, fa.BLOCK_Q,
                           fa.BLOCK_K))


# ------------------------------------------------------------------ jit.save
def _jax_mlp():
    paddle.seed(0)
    net = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 8))
    net.eval()
    return net


@pytest.mark.parametrize("spec", [([None, None], "int64"),
                                  ([None, 16], "float32"),
                                  ([4, 16], "float32")])
def test_save_meta_keys_equal_jax(tmp_path, spec):
    shape, dtype = spec
    if shape == [None, None]:
        paddle.seed(0)
        jax_layer, port_layer = JaxGPT(jax_gpt_tiny(**TINY)), _gpt()
        jax_layer.eval()
    else:
        jax_layer, port_layer = _jax_mlp(), _mlp()
    paddle.jit.save(jax_layer, str(tmp_path / "j"),
                    input_spec=[JaxInputSpec(shape, dtype)])
    jit.save(port_layer, str(tmp_path / "p"),
             input_spec=[InputSpec(shape, dtype)])
    metas = [pickle.load(open(tmp_path / f"{w}.pdmeta", "rb"))
             for w in ("j", "p")]
    # the port adds one key: which parameters are Linear weights, the only
    # record of the layout left once the program holds no nn.Linear
    assert set(metas[0]) | {"linear_weights"} == set(metas[1])
    assert metas[1]["linear_weights"] == sorted(
        f"{n}.weight" for n, m in port_layer.named_modules()
        if isinstance(m, torch.nn.Linear))
    for key in ("has_program", "quantize", "n_inputs", "dynamic_axes",
                "dynamic_ranks"):
        assert metas[0][key] == metas[1][key], key
    # shapes equal; JAX narrows int64 to int32 on the device, torch keeps it
    assert [s for s, _ in metas[0]["input_shapes"]] == \
        [s for s, _ in metas[1]["input_shapes"]]
    assert metas[1]["input_shapes"][0][1] == dtype


@pytest.mark.parametrize("layers", [1, 2])
def test_exported_gpt_keeps_one_attention_node_a_layer(tmp_path, layers):
    jit.save(_gpt(layers), str(tmp_path / "g"),
             input_spec=[InputSpec([None, None], "int64")])
    ep = jit.load(str(tmp_path / "g"), device="cpu")._exported
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert sum("paddle_tpu_torch.flash_attention_fwd" in t
               for t in targets) == layers
    assert not any(w in t for t in targets for w in ("tril", "einsum"))
    # one export serves every rung: batch from 1 up, seq up to the
    # model's positions
    ranges = sorted((int(r.lower), str(r.upper))
                    for r in ep.range_constraints.values())
    assert ranges == [(1, "64"), (1, "int_oo")]


def test_load_in_a_fresh_process_without_jax(pair):
    _, port, _ = pair
    code = (
        "import sys, numpy as np\n"
        "from paddle_tpu_torch import jit\n"
        f"layer = jit.load({port!r}, device='cpu')\n"
        "out = layer(np.arange(10).reshape(2, 5))\n"
        "assert tuple(out.shape) == (2, 5, 512), out.shape\n"
        "print('HASH', layer._content_hash[:12])\n"
        "print('LOADED', sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout


def test_loaded_program_equals_the_model(pair):
    _, port, model = pair
    layer = jit.load(port, device="cpu")
    ids = np.random.RandomState(3).randint(0, 512, (3, 11))
    with torch.no_grad():
        want = model(torch.from_numpy(ids))
    assert torch.equal(layer(ids), want)
    assert len(layer._content_hash) == 64
    assert set(layer.state_dict()) == set(model.state_dict())


def test_params_only_save_and_quantize(tmp_path):
    net = _mlp()
    jit.save(net, str(tmp_path / "p"))
    state = jit.load(str(tmp_path / "p"), device="cpu")
    assert set(state) == set(net.state_dict())
    assert all(torch.equal(state[k], v) for k, v in net.state_dict().items())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jit.save(net, str(tmp_path / "q"),
                 input_spec=[InputSpec([None, 16])],
                 quantize="weight_only_int8")


# ------------------------------------------------------------------- Config
def test_config_setters_are_never_silent(caplog):
    cfg = Config("dummy")
    assert cfg.device == "cuda"
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch"):
        cfg.enable_memory_optim(False)
        cfg.switch_ir_optim(False)
        cfg.enable_tpu()
        cfg.set_optim_cache_dir("/nonexistent")
    for frag in ("enable_memory_optim", "switch_ir_optim", "enable_tpu",
                 "set_optim_cache_dir"):
        assert frag in caplog.text, frag
    cfg.disable_gpu()
    assert cfg.device == "cpu"
    cfg.enable_use_gpu(device_id=0)
    assert cfg.device == "cuda:0"
    threads = torch.get_num_threads()
    try:
        cfg.set_cpu_math_library_num_threads(2)
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(threads)
    assert Config("m.pdmodel").prog_file() == "m.pdmodel"


# ---------------------------------------------------------------- Predictor
@pytest.mark.parametrize("ids_shape", [(1, 8), (2, 11), (2, 16), (1, 3)])
def test_run_many_matches_jax_on_the_grid(pair, ids_shape):
    jax_prefix, port_prefix, _ = pair
    preds = [JaxPredictor(JaxConfig(jax_prefix)), _cpu(port_prefix)]
    for p in preds:
        p.set_batch_ladder([1, 2])
        p.set_seq_ladder([8, 16])
        p.warmup_ladder()
        assert p.compile_count == 4
    ids = np.random.RandomState(sum(ids_shape)).randint(
        0, 512, ids_shape).astype(np.int64)
    want, = preds[0].run_many([ids])
    got, = preds[1].run_many([ids])
    assert got.shape == want.shape == ids_shape + (512,)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert preds[1].compile_count == 4
    assert preds[1].restored_rungs == []


def test_predictor_ladder_and_rungs(pair):
    _, port, _ = pair
    p = _cpu(port)
    assert p.dynamic_batch and p.dynamic_seq
    assert (0, 0, 0) in p._dynamic_ranks and (0, 1, 1) in p._dynamic_ranks
    p.set_batch_ladder([1, 2])
    p.set_seq_ladder([8, 16])
    prog = p._ensure_batch_program()
    assert prog.rungs == [(1, 8), (1, 16), (2, 8), (2, 16)]
    assert prog.out_seq_axes == {0: 1}
    assert p.warmup_ladder() == prog.rungs
    assert prog.graph_report() == {"signatures": 4, "captures": 0,
                                   "replays": 0, "eager": 4}
    c = p.clone()
    assert c._layer is p._layer and c._batch_program is prog


def test_fixed_shape_export_keeps_a_single_rung(tmp_path):
    jit.save(_mlp(), str(tmp_path / "f"),
             input_spec=[InputSpec([4, 16], "float32")])
    pred = _cpu(str(tmp_path / "f"))
    assert not pred.dynamic_batch and pred.batch_ladder == [4]
    with pytest.raises(ValueError, match="pinned"):
        pred.set_batch_ladder([1, 2, 4])
    x = np.random.RandomState(4).randn(3, 16).astype(np.float32)
    out, = pred.run_many([x], n=3)
    want = pred.run([np.pad(x, [(0, 1), (0, 0)])])[0][:3]
    np.testing.assert_array_equal(out, want)
    assert pred.compile_count == 1


# ------------------------------------------------------------------ swaps
@pytest.fixture()
def swapped(tmp_path, pair):
    """A predictor on the pair's program and a second GPT's weights."""
    _, port, model = pair
    pred = _cpu(port)
    pred.set_batch_ladder([1, 2])
    pred.set_seq_ladder([8, 16])
    pred.warmup_ladder()
    other = GPTForCausalLM(gpt_tiny(**TINY), device="cpu",
                           generator=torch.Generator().manual_seed(1)).eval()
    return pred, model, other


@pytest.mark.parametrize("source", ["dict", "sharded"])
def test_swap_weights_from_dict_and_checkpoint(tmp_path, swapped, source):
    pred, model, other = swapped
    clone = pred.clone()
    ids = np.random.RandomState(5).randint(0, 512, (2, 9))
    before, = pred.run_many([ids])
    state = dict(other.state_dict())
    if source == "dict":
        src = {**{k: v.numpy() for k, v in state.items()},
               "extra.weight": np.zeros(3, np.float32)}
    else:
        # a checkpoint directory holds the reference's layout, as the JAX
        # package and the decode tier write it
        src = str(tmp_path / "ckpt")
        save_sharded(jax_state_dict(other), src)
    rep = pred.swap_weights(src)
    assert rep["n_tensors"] == len(state) and rep["compile_count"] == 4
    assert rep["ignored_extra_entries"] == (1 if source == "dict" else 0)
    with torch.no_grad():
        want = other(torch.from_numpy(ids)).numpy()
    got, = clone.run_many([ids])
    np.testing.assert_array_equal(got, pred.run_many([ids])[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert pred.compile_count == 4
    pred.swap_weights({k: v for k, v in model.state_dict().items()})
    np.testing.assert_array_equal(pred.run_many([ids])[0], before)


def test_swap_weights_reads_a_checkpoint_the_jax_package_wrote(tmp_path,
                                                              pair):
    """A seed-1 JAX gpt_tiny's state written by JAX's ``save_sharded``,
    swapped into the JAX ``Predictor`` and into the port's: the logits
    agree. ``out_proj.weight`` is square ([32, 32]): read untransposed it
    would pass every shape check and serve wrong logits."""
    jax_prefix, port_prefix, _ = pair
    paddle.seed(1)
    other = JaxGPT(jax_gpt_tiny(**TINY))
    state = {k: np.asarray(v.numpy()) for k, v in other.state_dict().items()}
    square = "gpt.h.0.attn.out_proj.weight"
    assert state[square].shape[0] == state[square].shape[1]
    ckpt = str(tmp_path / "jax_ckpt")
    jax_save_sharded(state, ckpt)
    ids = np.random.RandomState(7).randint(0, 512, (2, 9)).astype(np.int64)
    outs = []
    for pred in (JaxPredictor(JaxConfig(jax_prefix)), _cpu(port_prefix)):
        pred.set_batch_ladder([1, 2])
        pred.set_seq_ladder([8, 16])
        pred.warmup_ladder()
        pred.swap_weights(ckpt)
        outs.append(np.asarray(pred.run_many([ids])[0]))
    np.testing.assert_allclose(outs[1], outs[0], rtol=TOL, atol=TOL)


def test_load_refuses_a_meta_without_linear_weights(tmp_path, pair):
    """An export whose ``.pdmeta`` predates ``linear_weights`` is refused
    by name: the layout of a reference checkpoint cannot be guessed."""
    _, port_prefix, _ = pair
    old = str(tmp_path / "old")
    for ext in (".pdiparams", ".pdmodel"):
        Path(old + ext).write_bytes(Path(port_prefix + ext).read_bytes())
    meta = pickle.load(open(port_prefix + ".pdmeta", "rb"))
    del meta["linear_weights"]
    pickle.dump(meta, open(old + ".pdmeta", "wb"))
    with pytest.raises(ValueError, match="linear_weights"):
        jit.load(old, device="cpu")


def test_swap_weights_refusals(swapped):
    pred, model, _ = swapped
    state = {k: v.clone() for k, v in model.state_dict().items()}
    name = "gpt.ln_f.weight"
    with pytest.raises(KeyError, match="missing"):
        pred.swap_weights({k: v for k, v in state.items() if k != name})
    with pytest.raises(ValueError, match="only float"):
        pred.swap_weights({**state, name: state[name].to(torch.int32)})
    with pytest.raises(ValueError, match=name):
        pred.swap_weights({**state, name: torch.zeros(5)})
    # a float cast is allowed: f64 in, the serving f32 kept
    rep = pred.swap_weights({k: v.double() for k, v in state.items()})
    assert rep["n_tensors"] == len(state)
    assert pred._layer._params[name].dtype == torch.float32


def test_program_set_flip_checks_every_leaf_then_copies_in_place():
    """The hot swap's commit both serving tiers share: nothing is copied
    unless every name, shape and dtype matches; then the live tensors
    (whose addresses the graphs hold) take the new values in place."""
    from paddle_tpu_torch.jit.functionalize import ProgramSet

    progs = ProgramSet("test.programs", device="cpu")
    live = {"w": torch.zeros(2, 3), "b": torch.zeros(3)}
    ptrs = {k: v.data_ptr() for k, v in live.items()}
    new = {"w": torch.ones(2, 3), "b": torch.full((3,), 2.0)}
    for bad, match in (({"w": new["w"]}, "structurally"),
                       ({**new, "x": torch.zeros(1)}, "structurally"),
                       ({**new, "b": torch.zeros(4)}, "leaf 'b'"),
                       ({**new, "w": new["w"].double()}, "leaf 'w'")):
        with pytest.raises(ValueError, match=match):
            progs.flip(live, bad)
        assert not live["w"].any() and not live["b"].any()
    assert progs.flip(live, new) == 2
    assert {k: v.data_ptr() for k, v in live.items()} == ptrs
    assert torch.equal(live["w"], new["w"]) and torch.equal(live["b"],
                                                           new["b"])
    with progs.guard():
        assert progs.compile(lambda x: x + 1, "inc")(live["b"])[0] == 3.0


def test_values_like_holds_a_dict_to_the_checkpoint_rules():
    """A dict source passes the same checks and casts as a sharded
    checkpoint's (``load_sharded_like``)."""
    from paddle_tpu_torch.distributed.checkpoint.sharded import values_like

    targets = {"w": torch.zeros(2, 2), "n": torch.zeros(2, dtype=torch.int64)}
    got = values_like({"w": np.ones((2, 2)), "n": torch.arange(2),
                       "extra": 1.0}, targets)
    assert set(got) == {"w", "n"} and got["w"].dtype == torch.float32
    assert torch.equal(got["n"], torch.arange(2))
    with pytest.raises(KeyError, match="missing 1"):
        values_like({"w": torch.ones(2, 2)}, targets)
    with pytest.raises(ValueError, match="target expects"):
        values_like({"w": torch.ones(3), "n": torch.arange(2)}, targets)
    with pytest.raises(ValueError, match="refusing to convert 'n'"):
        values_like({"w": torch.ones(2, 2), "n": torch.ones(2)}, targets)
