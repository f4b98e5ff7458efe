"""The port's ``DataParallel`` tier against the JAX package.

One launch of 2 gloo ranks (``torch_dist_cases.py``'s ``data_parallel``
suite, started once for the file, in the background while the JAX side
runs) holds:

- ``DataParallel`` + ``TrainStep`` on ``gpt_tiny`` and ``llama_tiny``, f32,
  5 ``AdamW(1e-3)`` steps on 5 batches of 4 x 16 ids, each rank on its 2
  rows (``shard_batch``), from the JAX models' weights: the mean of the
  ranks' losses and the parameters after the steps against the JAX
  package's ``replicate_layer`` + ``shard_batch`` + ``TrainStep`` on a
  2-device mesh (``bench.py``'s pattern), within ``tests/
  test_torch_train.py``'s f32 tolerance (``rtol=1e-4, atol=1e-5``, with
  its carve-out for Adam's near-zero gradients); both ranks' parameters
  equal bit for bit;
- the loss's reduction, both ways: a mean loss gives the JAX global-batch
  gradient; a sum loss gives it over the 2 ranks (the port averages, as
  upstream Paddle does; the JAX ``DataParallel`` keeps the global loss);
- ``SyncBatchNorm`` (converted from a ``BatchNorm2D``) over 2 x 2 of 4
  images: the output, the running stats and the parameters' gradients
  against the JAX ``BatchNorm2D`` over the 4 images within 1e-5; each
  rank's input gradient is that of the sum of the ranks' losses (the
  all-reduces carry ``psum``'s gradient), twice JAX's for the mean loss;
- ``DistributedBatchSampler`` from the environment (2 ranks) index for
  index the JAX sampler's at ``num_replicas=2``, ``DeviceLoader``'s rows;
- ``no_sync`` (two local backwards, then one that reduces all three) and
  ``find_unused_parameters`` (zeros reduced for a layer only rank 0 used;
  without it, a layer no rank used raises).
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu import io as jio
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed.parallel import replicate_layer, shard_batch
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.models import (GPTForCausalLM, GPTPretrainingCriterion,
                               LlamaForCausalLM, LlamaPretrainingCriterion,
                               gpt_tiny, llama_tiny)

import paddle_tpu_torch as T
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn
from paddle_tpu_torch.base.flags import set_flags
import torch_dist_cases as cases

N = 2
# tests/test_torch_train.py's carve-out: where a parameter's gradient is
# far below Adam's epsilon, the update g / (|g| + eps) turns the two
# packages' f32 summation-order noise into a difference of the update; an
# element there that misses the tolerance is held to the steps taken, and
# at most 1e-4 of the elements may
STEPS_LR = cases.DP_STEPS * cases.DP_LR


def _np(t):
    return np.array(np.asarray(t.numpy()), dtype=np.float32, copy=True)


def _jax_models():
    out = {}
    for kind, cls, crit, cfg in (
            ("gpt", GPTForCausalLM, GPTPretrainingCriterion, gpt_tiny()),
            ("llama", LlamaForCausalLM, LlamaPretrainingCriterion,
             llama_tiny())):
        jpaddle.seed(0)
        out[kind] = (cls(cfg), crit(cfg))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs written for the ranks, the JAX models they came from, and
    the launcher running the ranks."""
    out = tmp_path_factory.mktemp("data_parallel")
    models = _jax_models()
    inputs = {}
    for kind, (model, _) in models.items():
        for k, v in model.state_dict().items():
            inputs[f"{kind}/{k}"] = np.array(v.numpy(), copy=True)
    rs = np.random.RandomState(7)
    inputs["linear/weight"] = rs.randn(4, 3).astype(np.float32)
    inputs["linear/bias"] = rs.randn(3).astype(np.float32)
    inputs["linear/x"] = rs.randn(8, 4).astype(np.float32)
    inputs["sbn/weight"] = (rs.rand(3) + 0.5).astype(np.float32)
    inputs["sbn/bias"] = rs.randn(3).astype(np.float32)
    inputs["sbn/x"] = (rs.randn(*cases.SBN_SHAPE) * 2 + 1).astype(np.float32)
    inputs["sbn/w"] = rs.randn(*cases.SBN_SHAPE).astype(np.float32)
    inputs["nosync/x"] = rs.randn(3, 4, 4).astype(np.float32)
    np.savez(out / "inputs.npz", **inputs)
    proc = cases.start_ranks("data_parallel", N, out)
    try:
        yield inputs, models, proc
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=30)


def _jax_dp_train(model, crit):
    """bench.py's data-parallel pattern on a 2-device mesh."""
    env = jenv.instance()
    saved = (env.mesh, dict(env.axis_degrees))
    jmesh = env.build_mesh({"dp": N}, devices=jax.devices()[:N])
    try:
        replicate_layer(model, jmesh)
        opt = jpaddle.optimizer.AdamW(learning_rate=cases.DP_LR,
                                      parameters=model.parameters())
        step = JaxTrainStep(model=model, optimizer=opt,
                            loss_fn=lambda ids: crit(model(ids), ids))
        losses = []
        for b in cases.dp_batches():
            ids = jpaddle.Tensor(b, stop_gradient=True)
            shard_batch(ids, jmesh)
            losses.append(float(_np(step(ids))))
        return np.array(losses), {k: _np(v)
                                  for k, v in model.state_dict().items()}
    finally:
        env.mesh, env.axis_degrees = saved


@pytest.fixture(scope="module")
def jax_ref(setup):
    inputs, models, _ = setup
    ref = {}
    for kind, (model, crit) in models.items():
        ref[kind] = _jax_dp_train(model, crit)
    lin = jnn.Linear(4, 3)
    lin.weight.set_value(inputs["linear/weight"])
    lin.bias.set_value(inputs["linear/bias"])
    x = jpaddle.to_tensor(inputs["linear/x"])
    for loss_kind in ("mean", "sum"):
        y = lin(x)
        (y.mean() if loss_kind == "mean" else y.sum()).backward()
        ref[f"linear/{loss_kind}"] = (_np(lin.weight.grad),
                                      _np(lin.bias.grad))
        lin.clear_gradients()
    bn = jnn.BatchNorm2D(3)
    bn.weight.set_value(inputs["sbn/weight"])
    bn.bias.set_value(inputs["sbn/bias"])
    x = jpaddle.to_tensor(inputs["sbn/x"], stop_gradient=False)
    y = bn(x)
    (y * jpaddle.to_tensor(inputs["sbn/w"])).mean().backward()
    ref["sbn"] = {"y": _np(y), "x_grad": _np(x.grad),
                  "weight_grad": _np(bn.weight.grad),
                  "bias_grad": _np(bn.bias.grad), "mean": _np(bn._mean),
                  "variance": _np(bn._variance)}
    bn.eval()
    ref["sbn"]["eval_y"] = _np(bn(jpaddle.to_tensor(inputs["sbn/x"])))
    return ref


@pytest.fixture(scope="module")
def port(setup, jax_ref):
    return cases.collect(setup[2])


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_data_parallel_train_step_matches_jax(kind, port, jax_ref):
    jax_losses, jax_params = jax_ref[kind]
    got = port[0]
    np.testing.assert_allclose(got[f"{kind}/losses"], jax_losses, rtol=1e-4,
                               atol=1e-5)
    params = got[f"{kind}/params"]
    assert sorted(params) == sorted(jax_params)
    n_loose = 0
    for name, want in jax_params.items():
        diff = np.abs(params[name] - want)
        loose = diff > 1e-5 + 1e-4 * np.abs(want)
        n_loose += int(loose.sum())
        assert (diff[loose] <= STEPS_LR).all(), (name, float(diff.max()))
        np.testing.assert_array_equal(params[name],
                                      port[1][f"{kind}/params"][name])
    assert n_loose <= 1e-4 * sum(p.size for p in params.values())
    np.testing.assert_array_equal(got[f"{kind}/losses"],
                                  port[1][f"{kind}/losses"])
    # on gloo every step runs eagerly; the state dict is the inner model's
    assert got[f"{kind}/stats"] == {"compiled_steps": 0,
                                    "eager_steps": cases.DP_STEPS}
    assert got[f"{kind}/names"]


def test_loss_reduction_mean_is_jax_sum_is_jax_over_ranks(port, jax_ref):
    for res in port:
        for loss_kind, scale in (("mean", 1.0), ("sum", 1.0 / N)):
            w, b = jax_ref[f"linear/{loss_kind}"]
            np.testing.assert_allclose(
                res[f"linear/{loss_kind}/weight_grad"], w * scale,
                rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(res[f"linear/{loss_kind}/bias_grad"],
                                       b * scale, rtol=1e-6, atol=1e-6)


def test_sync_batch_norm_is_batch_norm_over_the_global_batch(port, jax_ref):
    want = jax_ref["sbn"]
    half = cases.SBN_SHAPE[0] // N
    for r, res in enumerate(port):
        assert res["sbn/converted"] == "SyncBatchNorm"
        tol = dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            res["sbn/y"].reshape(cases.SBN_SHAPE), want["y"], **tol)
        np.testing.assert_allclose(
            res["sbn/x_grad"].reshape(cases.SBN_SHAPE), N * want["x_grad"],
            **tol)
        for key in ("weight_grad", "bias_grad", "mean", "variance"):
            np.testing.assert_allclose(res[f"sbn/{key}"], want[key],
                                       err_msg=key, **tol)
        np.testing.assert_allclose(res["sbn/eval_y"],
                                   want["eval_y"][r * half:(r + 1) * half],
                                   **tol)


def test_distributed_batch_sampler_and_loader_per_rank(port):
    ds = jio.TensorDataset([np.arange(11)])
    covered = []
    for r, res in enumerate(port):
        nranks, rank, epochs = res["sampler"]
        assert (nranks, rank) == (N, r)
        want = jio.DistributedBatchSampler(ds, batch_size=2, num_replicas=N,
                                           rank=r, shuffle=True)
        for epoch, got in zip((0, 3), epochs):
            want.set_epoch(epoch)
            assert got == list(want)
        covered += [i for b in epochs[0] for i in b]
        first, second = res["loader"][0]
        np.testing.assert_array_equal(
            first, np.arange(8).reshape(4, 2)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(second, np.arange(3))
        np.testing.assert_array_equal(res["shard_numpy"],
                                      np.arange(6).reshape(6, 1)[3 * r:
                                                                 3 * r + 3])
    # one epoch over both ranks covers the dataset (padded to 12 rows)
    assert sorted(set(covered)) == list(range(11)) and len(covered) == 12


def test_no_sync_and_find_unused_parameters(port):
    mean_local = sum(res["nosync/local"] for res in port) / N
    for res in port:
        np.testing.assert_allclose(res["nosync/after"], mean_local,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(res["nosync/replicated"],
                                      port[0]["nosync/replicated"])
    assert not np.allclose(port[0]["nosync/inside"], port[1]["nosync/inside"])
    first = sum(res["unused/local_first"] for res in port) / N
    for res in port:
        np.testing.assert_allclose(res["unused/second_grad"],
                                   port[0]["unused/local_second"] / N,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res["unused/first_grad"], first,
                                   rtol=1e-6, atol=1e-6)
        assert "find_unused_parameters=True" in res["unused/strict"]
    assert np.abs(port[0]["unused/local_second"]).sum() > 0


def test_world_of_one_data_parallel_is_the_model():
    """Without ``init_parallel_env``: one rank, the gradients divided by 1
    (bit for bit the bare model's), the state passthroughs, the
    top-level name; ``SyncBatchNorm`` is ``BatchNorm``."""
    assert T.DataParallel is dist.DataParallel
    torch.manual_seed(0)
    bare = nn.Linear(4, 3, device="cpu")
    wrapped = nn.Linear(4, 3, device="cpu")
    wrapped.load_state_dict(bare.state_dict())
    dp = T.DataParallel(wrapped, comm_buffer_size=1e-5,
                        last_comm_buffer_size=1e-5)
    assert dp.bucket_sizes == [12, 48]  # reverse order, one tensor each
    x = torch.randn(5, 4)
    bare(x).square().mean().backward()
    dp(x).square().mean().backward()
    for a, b in zip(bare.parameters(), dp.parameters()):
        assert torch.equal(a.grad, b.grad)
    assert list(dp.state_dict()) == ["weight", "bias"]
    assert [n for n, _ in dp.named_parameters()] == ["weight", "bias"]
    dp.eval()
    assert not wrapped.training
    assert dist.shard_batch(x) is x
    # over two ranks (this process is rank 0) a Tensor is cut in place, a
    # plain tensor comes back cut and stays whole
    two = dist.Mesh(np.arange(2).reshape(1, 2, 1, 1, 1), dist.HYBRID_AXES)
    rows = torch.arange(8.0).reshape(4, 2)
    cut = dist.shard_batch(rows, mesh=two)
    assert rows.shape == (4, 2) and torch.equal(cut, rows[:2])
    ids = T.to_tensor(np.arange(8).reshape(4, 2), place=T.CPUPlace())
    assert dist.shard_batch(ids, mesh=two) is ids
    np.testing.assert_array_equal(ids.numpy(), np.arange(4).reshape(2, 2))
    bn = nn.BatchNorm2D(3, device="cpu")
    sbn = nn.SyncBatchNorm.convert_sync_batchnorm(
        nn.Sequential(nn.BatchNorm2D(3, device="cpu")))[0]
    assert isinstance(sbn, nn.SyncBatchNorm)
    x = torch.randn(2, 3, 4, 4)
    torch.testing.assert_close(sbn(x), bn(x), rtol=0, atol=0)


def test_quantized_data_parallel_raises_naming_queue_7():
    set_flags({"comm_quantize_dp_grads": True})
    try:
        with pytest.raises(NotImplementedError, match="queue 7"):
            T.DataParallel(nn.Linear(2, 2, device="cpu"))
    finally:
        set_flags({"comm_quantize_dp_grads": False})
