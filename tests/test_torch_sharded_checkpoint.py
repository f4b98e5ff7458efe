"""The port's sharded checkpoint reader and writer
(``paddle_tpu_torch.distributed.checkpoint.sharded``) against the JAX
package's, on the CPU (conftest gives JAX 8 CPU devices, so its
dp-sharded saves are real).

- a JAX save across 8 devices (dp-sharded and replicated entries, f32,
  bf16 and int32, a nested dict, a scalar) reads in the port bit for bit,
  and the port's save reads in JAX's ``load_sharded`` bit for bit;
- the port's manifest passes JAX's ``verify_dir`` and JAX's passes the
  port's;
- the cast loads (f32 to bf16, bf16 to f32, a blanket ``dtype``) equal
  JAX's ``load_sharded_like`` / ``load_sharded``, and a non-float change
  is refused as JAX refuses it;
- a corrupt or truncated piece raises naming it, a missing one and an
  incomplete piece set raise, a tmp dir is not loadable, an existing
  target is refused, and an injected ``ckpt.write`` fault leaves the
  previous checkpoint intact;
- GPT-2-shaped state through ``jax_state_dict`` round-trips into
  ``load_jax_state``.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from paddle_tpu.distributed.checkpoint import sharded as jax_sc
from paddle_tpu_torch import reliability as rel
from paddle_tpu_torch.distributed.checkpoint import sharded as sc
from paddle_tpu_torch.distributed.checkpoint.sharded import manifest as mf
from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_tiny,
                                         jax_state_dict, load_jax_state)


def _mesh(n=8):
    return Mesh(np.array(jax.devices()[:n]).reshape(n), ("dp",))


def _jax_state():
    mesh = _mesh()
    rs = np.random.RandomState(0)
    w = rs.randn(64, 16).astype(np.float32)
    wb = rs.randn(32, 8).astype(np.float32)
    return {
        "w": jax.device_put(jnp.asarray(w), NamedSharding(mesh, P("dp"))),
        "wb": jax.device_put(jnp.asarray(wb, jnp.bfloat16),
                             NamedSharding(mesh, P(None, "dp"))),
        "rep": jax.device_put(jnp.asarray(rs.randn(5, 3), jnp.float32),
                              NamedSharding(mesh, P())),
        "ids": jnp.arange(11, dtype=jnp.int32),
        "nested": {"b": jnp.asarray(rs.randn(7), jnp.bfloat16),
                   "s": jnp.asarray(2.5, jnp.float32)},
    }


def _flat_jax(state, prefix=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flat_jax(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch tensor as numpy, bf16 through its bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bits(a) -> np.ndarray:
    """The raw bytes of an array (0-d included), for a bitwise compare."""
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def test_jax_save_across_8_devices_reads_bit_for_bit(tmp_path):
    state = _jax_state()
    jax_sc.save_sharded(state, str(tmp_path / "ck"))
    man = mf.read_manifest(str(tmp_path / "ck"))
    assert len(man["entries"]["w"]["pieces"]) == 8
    assert len(man["entries"]["wb"]["pieces"]) == 8
    assert man["entries"]["w"]["spec"] == ["dp"]
    got = sc.load_sharded(str(tmp_path / "ck"), device="cpu")
    want = _flat_jax(state)
    assert set(got) == set(want)
    for name, v in want.items():
        g = got[name]
        assert str(g.dtype).replace("torch.", "") == str(v.dtype), name
        assert tuple(g.shape) == tuple(v.shape), name
        assert np.array_equal(_bits(_as_numpy(g)), _bits(v)), name
    assert sc.verify_dir(str(tmp_path / "ck")) == []


def test_port_save_reads_in_jax_bit_for_bit(tmp_path):
    rs = np.random.RandomState(1)
    state = {"w": torch.from_numpy(rs.randn(6, 4).astype(np.float32)),
             "b": torch.from_numpy(rs.randn(9).astype(np.float32))
             .to(torch.bfloat16),
             "ids": torch.arange(5, dtype=torch.int32),
             "nested": {"s": torch.tensor(1.25), "flag": torch.tensor(True)}}
    rep = sc.save_sharded(state, str(tmp_path / "ck"))
    assert rep["n_tensors"] == rep["n_pieces"] == 5
    got = jax_sc.load_sharded(str(tmp_path / "ck"))
    assert jax_sc.verify_dir(str(tmp_path / "ck")) == []
    flat = {"w": state["w"], "b": state["b"], "ids": state["ids"],
            "nested.s": state["nested"]["s"],
            "nested.flag": state["nested"]["flag"]}
    assert set(got) == set(flat)
    for name, t in flat.items():
        assert str(got[name].dtype) == str(t.dtype).replace("torch.", "")
        assert np.array_equal(_bits(got[name]), _bits(_as_numpy(t))), name
    back = sc.load_sharded(str(tmp_path / "ck"), device="cpu")
    for name, t in flat.items():
        assert torch.equal(back[name], t), name


def test_cast_loads_equal_jax(tmp_path):
    state = _jax_state()
    ck = str(tmp_path / "ck")
    jax_sc.save_sharded(state, ck)
    # target-derived casts: f32 -> bf16 and bf16 -> f32
    jax_targets = {"w": jnp.zeros((64, 16), jnp.bfloat16),
                   "wb": jnp.zeros((32, 8), jnp.float32)}
    port_targets = {"w": torch.zeros(64, 16, dtype=torch.bfloat16),
                    "wb": torch.zeros(32, 8)}
    want = jax_sc.load_sharded_like(ck, jax_targets, require_all=False)
    got = sc.load_sharded_like(ck, port_targets, require_all=False)
    for name in want:
        assert got[name].dtype == port_targets[name].dtype
        assert np.array_equal(_bits(_as_numpy(got[name])), _bits(want[name]))
    assert port_targets["w"].abs().sum() == 0  # targets untouched
    # a blanket converting load leaves the int tensor alone
    want = jax_sc.load_sharded(ck, dtype="bfloat16")
    got = sc.load_sharded(ck, dtype="bfloat16", device="cpu")
    assert got["ids"].dtype == torch.int32
    for name in want:
        assert np.array_equal(_bits(_as_numpy(got[name])),
                              _bits(want[name])), name
    # a target-derived non-float change is refused in both
    with pytest.raises(ValueError, match="refusing to convert"):
        jax_sc.load_sharded_like(ck, {"ids": jnp.zeros(11, jnp.float32)},
                                 require_all=False)
    with pytest.raises(ValueError, match="refusing to convert"):
        sc.load_sharded_like(ck, {"ids": torch.zeros(11)}, require_all=False)
    with pytest.raises(KeyError, match="missing"):
        sc.load_sharded_like(ck, {"nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="target expects"):
        sc.load_sharded_like(ck, {"w": torch.zeros(64, 15)})


def _write(tmp_path):
    ck = str(tmp_path / "ck")
    sc.save_sharded({"w": torch.arange(24, dtype=torch.float32)
                     .reshape(4, 6), "b": torch.ones(3)}, ck)
    piece = os.path.join(ck, mf.read_manifest(ck)["entries"]["w"]
                         ["pieces"][0]["file"])
    return ck, piece


def test_corrupt_piece_raises_by_name(tmp_path):
    ck, piece = _write(tmp_path)
    data = bytearray(open(piece, "rb").read())
    data[3] ^= 0xFF
    open(piece, "wb").write(bytes(data))
    with pytest.raises(RuntimeError, match=os.path.basename(piece)):
        sc.load_sharded(ck, device="cpu")
    kinds = [p["kind"] for p in sc.verify_dir(ck)]
    assert kinds == [p["kind"] for p in jax_sc.verify_dir(ck)]
    assert kinds[0] == "corrupt"
    assert sc.load_sharded(ck, verify=False, device="cpu")["w"].shape == (4, 6)


def test_truncated_and_missing_pieces_raise(tmp_path):
    ck, piece = _write(tmp_path)
    data = open(piece, "rb").read()
    open(piece, "wb").write(data[:-4])
    with pytest.raises(RuntimeError, match="truncated"):
        sc.load_sharded(ck, device="cpu")
    os.remove(piece)
    with pytest.raises(RuntimeError, match="INCOMPLETE"):
        sc.load_sharded(ck, device="cpu")
    assert "missing" in [p["kind"] for p in sc.verify_dir(ck)]


def test_incomplete_piece_set_raises(tmp_path):
    state = _jax_state()
    ck = str(tmp_path / "ck")
    jax_sc.save_sharded(state, ck)
    mpath = os.path.join(ck, mf.MANIFEST_NAME)
    man = json.load(open(mpath))
    man["entries"]["w"]["pieces"] = man["entries"]["w"]["pieces"][:7]
    json.dump(man, open(mpath, "w"))
    with pytest.raises(RuntimeError, match="cover"):
        sc.load_sharded(ck, names=["w"], device="cpu")


def test_tmp_dir_and_existing_target_refused(tmp_path):
    ck, _ = _write(tmp_path)
    with pytest.raises(FileExistsError):
        sc.save_sharded({"w": torch.zeros(2)}, ck)
    tmp = str(tmp_path / (mf.TMP_PREFIX + "ck_dead"))
    os.makedirs(tmp)
    with pytest.raises(FileNotFoundError, match="not a committed"):
        sc.load_sharded(tmp, device="cpu")
    sc.save_sharded({"w": torch.zeros(2)}, ck, overwrite=True)
    assert list(sc.load_sharded(ck, device="cpu")) == ["w"]


def test_injected_commit_fault_keeps_the_previous_checkpoint(tmp_path):
    ck, _ = _write(tmp_path)
    rel.arm(rel.FaultInjector(seed=0).plan("ckpt.write", rate=1.0))
    try:
        with pytest.raises(rel.FaultInjection):
            sc.save_sharded({"w": torch.zeros(2)}, ck, overwrite=True)
    finally:
        rel.disarm()
    got = sc.load_sharded(ck, device="cpu")
    assert set(got) == {"w", "b"} and got["w"].shape == (4, 6)
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]


def test_gpt_state_round_trips_through_the_reference_layout(tmp_path):
    cfg = gpt_tiny(num_hidden_layers=2, hidden_size=16,
                   num_attention_heads=2)
    a = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    sc.save_sharded(jax_state_dict(a), str(tmp_path / "ck"))
    man = mf.read_manifest(str(tmp_path / "ck"))
    # Linear weights land as the reference's [in, out]
    assert man["entries"]["gpt.h.0.attn.qkv_proj.weight"]["shape"] == [16, 48]
    b = GPTForCausalLM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    load_jax_state(b, sc.load_sharded(str(tmp_path / "ck"), device="cpu"))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
