"""The port's collectives, ``spmd`` and ``Group`` against the JAX package.

One launch of 4 gloo ranks (``torch_dist_cases.py``'s ``collectives``
suite, started once for the file, in the background while the JAX side
runs) runs every case of ``torch_dist_cases.collective_cases`` on two
meshes: ``dp`` = 4, and ``dp`` = 2 x ``mp`` = 2, where a collective over
``dp`` spans 2 ranks (``mp`` left out of every spec, so the outputs'
cotangents divide by 2 and the inputs' sum over it) and one over both
axes spans 4. The JAX package runs the same text in this process over a
mesh of the same axes on 4 of its 8 CPU devices (the mesh put back after),
each body compiled whole (``jax_runner``). Every case, with the gradient
of a weighted sum of its outputs where the ops have one, must give JAX's
numbers within 1e-6 (they are integers in f32 here, so in practice
exactly), and every rank the same numbers bit for bit. The group over both
axes of the 2 x 2 mesh holds the 4 ranks in the order ``dp`` holds them on
the 4-rank mesh, so its cases must equal those bit for bit.

The process-level collectives (outside ``spmd``, where the JAX single
controller has one process) are held to numpy on the ranks' own values:
integer dtypes exactly, bool, PROD, point to point, ``all_gather_object``'s
JSON round trip, an all-reduce's gradient, the groups' ranks, and a
``new_group`` over a proper subset of ranks raising as JAX's does. A world of one that was never initialized is the identity, as
``tests/test_distributed_core.py`` pins it for JAX.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax

import jax.numpy as jnp
import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
from jax.sharding import PartitionSpec as JP
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import env as jenv

import paddle_tpu_torch.distributed as dist
import torch_dist_cases as cases

N = 4


@contextlib.contextmanager
def jax_mesh(degrees):
    """The JAX package's mesh over 4 devices, with ``degrees``; the mesh
    that was installed is put back after."""
    env = jenv.instance()
    saved = (env.mesh, dict(env.axis_degrees))
    env.build_mesh(degrees, devices=jax.devices()[:N])
    try:
        yield
    finally:
        env.mesh, env.axis_degrees = saved


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    proc = cases.start_ranks("collectives", N,
                             tmp_path_factory.mktemp("collectives"))
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=30)


def jax_runner(body, x, ins, outs, axes, grad=True):
    """A body through the JAX package's ``spmd``, compiled whole: its
    outputs, and ``jax.grad`` of their weighted sum (what the eager tape
    computes with ``jax.vjp`` of the region, at one compile a body instead
    of one an op and device)."""
    region = jdist.spmd(in_specs=ins, out_specs=outs, axes=axes)(body)

    def outputs(xv):
        return tuple(o._value for o in region(JTensor(xv)))

    x = jnp.asarray(x)
    if not grad:
        return tuple(np.asarray(o) for o in jax.jit(outputs)(x))

    def loss(xv):
        got = outputs(xv)
        return sum((o * cases._weights(o)).sum() for o in got), got

    (_, got), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(x)
    return tuple(np.asarray(o) for o in got) + (np.asarray(g),)


@pytest.fixture(scope="module")
def jax_results(ranks):
    out = {}
    for mesh_name, degrees in cases.MESHES.items():
        with jax_mesh(degrees):
            for name, case in cases.collective_cases(
                    jpaddle, jdist, JP, mesh_name, jax_runner).items():
                key = f"{mesh_name}/{name}"
                if key in JAX_CASES:
                    out[key] = tuple(np.asarray(a) for a in case())
    return out


@pytest.fixture(scope="module")
def port(ranks, jax_results):
    return cases.collect(ranks)


# the groups JAX holds the port to: dp over 4 ranks, and dp over 2 ranks
# with mp left out of every spec; a group over dp and mp on the 2 x 2 mesh
# spans the same 4 ranks in the same order as dp on the 4-rank mesh, and
# is held to that case of the port
JAX_CASES = [f"{m}/{c}" for m in cases.MESHES for c in cases.case_names(m)
             if not c.startswith("dpmp/")]
TWO_AXES = [c for c in cases.case_names("dp2mp2") if c.startswith("dpmp/")]


@pytest.mark.parametrize("key", JAX_CASES)
def test_collective_matches_jax(key, port, jax_results):
    want = jax_results[key]
    got = port[0]["cases"][key]
    assert len(got) == len(want), key
    for g, w in zip(got, want):
        assert g.shape == w.shape, (key, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=key)
    for r in range(1, N):
        for g, other in zip(got, port[r]["cases"][key]):
            np.testing.assert_array_equal(g, other, err_msg=f"{key} rank {r}")


@pytest.mark.parametrize("key", TWO_AXES)
def test_group_over_two_axes_matches_one_axis_of_four(key, port):
    got = port[0]["cases"]["dp2mp2/" + key]
    want = port[0]["cases"]["dp4/dp/" + key.split("/", 1)[1]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=key)
    for r in range(1, N):
        for g, other in zip(got, port[r]["cases"]["dp2mp2/" + key]):
            np.testing.assert_array_equal(g, other, err_msg=f"{key} {r}")


def test_process_level_collectives_against_numpy(port):
    n = N
    for r, res in enumerate(port):
        p = res["process"]
        for dtype in (torch.int64, torch.int32, torch.float32):
            dt = str(dtype)
            np.testing.assert_array_equal(
                p[f"all_reduce_sum_{dtype}"],
                np.arange(6).reshape(2, 3) * sum(range(1, n + 1)))
            np.testing.assert_array_equal(p[f"all_reduce_max_{dtype}"],
                                          np.arange(6) + n - 1)
            np.testing.assert_array_equal(p[f"all_reduce_prod_{dtype}"],
                                          np.full(3, 24))
            np.testing.assert_array_equal(
                p[f"all_gather_{dtype}"],
                np.repeat(np.arange(n)[:, None], 2, 1))
            np.testing.assert_array_equal(
                p[f"reduce_scatter_{dtype}"],
                (np.arange(2 * n) * sum(range(1, n + 1)))[2 * r:2 * r + 2])
            np.testing.assert_array_equal(p[f"broadcast_{dtype}"],
                                          np.full(3, 20))
            np.testing.assert_array_equal(p[f"all_to_all_single_{dtype}"],
                                          r + 10 * np.arange(n))
            assert p[f"all_gather_{dtype}"].dtype == \
                torch.empty(0, dtype=dtype).numpy().dtype, dt
        np.testing.assert_array_equal(p["all_reduce_bool"],
                                      [True, True, False])
        np.testing.assert_array_equal(
            p["all_reduce_strided"],
            np.arange(6.0).reshape(2, 3).T * sum(range(1, n + 1)))
        assert p["shift_bool"].dtype == np.bool_
        np.testing.assert_array_equal(p["shift_bool"],
                                      [(r - 1) % n % 2 == 0, True])
        np.testing.assert_array_equal(p["scatter"], np.full(3, float(r)))
        if r < 2:
            np.testing.assert_array_equal(p["send_recv"], [5.0, 5.0])
        np.testing.assert_array_equal(p["batch_isend_irecv"],
                                      np.full(2, float((r - 1) % n)))
        assert p["all_gather_object"] == [{"rank": j, "pair": [j, j * j]}
                                          for j in range(n)]
        np.testing.assert_array_equal(p["process_level_grad"],
                                      (r + 1) * n * np.arange(1.0, 5.0))
        assert "proper subset" in p["subgroup"]
        assert p["group_ranks"] == (r, n, r % 2, 2)
        assert p["backend"] == "gloo"


def test_world_of_one_is_the_identity():
    """Before ``init_parallel_env``, as ``test_distributed_core.py``'s
    ``test_eager_world1_collectives_identity``: one rank, no group."""
    assert not dist.is_initialized()
    assert dist.get_world_size() == 1 and dist.get_rank() == 0
    t = torch.tensor([1.0, 2.0])
    dist.all_reduce(t)
    np.testing.assert_array_equal(t.numpy(), [1.0, 2.0])
    out = dist.all_gather(None, t)
    assert out.shape == [1, 2]
    got = []
    dist.all_gather_object(got, {"a": (1, 2)})
    assert got == [{"a": (1, 2)}]
    dst = torch.zeros(2)
    dist.reduce_scatter(dst, torch.tensor([3.0, 4.0]))
    np.testing.assert_array_equal(dst.numpy(), [3.0, 4.0])
    with pytest.raises(ValueError, match="send to self"):
        dist.send(t, 0)
    with pytest.raises(ValueError, match="recv from self"):
        dist.recv(t, 0)
    assert dist.get_backend() is None
    assert dist.get_mesh().shape["dp"] == 1
    x = torch.arange(3.0, requires_grad=True)
    y = x * 2
    dist.all_reduce(y)
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [2.0, 2.0, 2.0])


def test_mesh_degrees_follow_jax_rules():
    env = dist.env.ParallelEnv()
    ranks = list(range(8))
    mesh = env.build_mesh({"dp": 4, "mp": 2}, devices=ranks)
    want = jenv.ParallelEnv().build_mesh({"dp": 4, "mp": 2})
    assert mesh.shape == dict(want.shape)
    assert env.build_mesh({"mp": 2, "dp": -1}, devices=ranks).shape["dp"] == 4
    assert mesh.members(5, ("dp",)) == [1, 3, 5, 7]
    assert mesh.members(5, ("mp",)) == [4, 5]
    assert mesh.coords(5) == {"pp": 0, "dp": 2, "sharding": 0, "sep": 0,
                              "mp": 1}
    with pytest.raises(ValueError, match="product"):
        env.build_mesh({"dp": 3}, devices=ranks)
    with pytest.raises(ValueError, match="divisible"):
        env.build_mesh({"mp": 3, "dp": -1}, devices=ranks)
    assert dist.HYBRID_AXES == jdist.HYBRID_AXES


def test_unported_names_raise_naming_queue_7():
    for name in ("auto_parallel", "ProcessMesh", "shard_tensor",
                 "reshard", "sharding", "ps", "rpc", "auto_tuner",
                 "moe_utils", "collective_opt"):
        with pytest.raises(NotImplementedError, match="queue 7"):
            getattr(dist, name)
    # fleet is ported, pipeline and recompute too; its sharded optimizer
    # waits for item 7.3
    for name in ("PipelineLayer", "LayerDesc", "recompute"):
        assert callable(getattr(dist.fleet, name))
    st = dist.fleet.DistributedStrategy()
    st.sharding = True
    with pytest.raises(NotImplementedError, match="queue 7 item 7.3"):
        dist.fleet.distributed_optimizer(object(), strategy=st)
    with pytest.raises(NotImplementedError, match="queue 7"):
        dist.all_reduce(torch.ones(2), quantized=True)
    assert dist.is_available()
    assert dist.TCPStore is torch.distributed.TCPStore


def test_watchdog_reports_a_hung_collective_and_the_collective_site():
    """The port's counterpart of ``test_reliability.py``'s
    ``test_watchdog_timeout_ticks_counter_and_fires_handler``: a hung
    collective (the ``comm.watchdog`` fault site, here through
    ``all_reduce``'s own registration) fires the handler once and ticks
    the counter; the ``collective`` site raises to the caller."""
    import time

    from paddle_tpu_torch import reliability as rel
    from paddle_tpu_torch.distributed.utils import watchdog
    from paddle_tpu_torch.observability.metrics import registry

    def total():
        inst = registry.snapshot()["metrics"].get("comm.watchdog_timeout")
        return sum(float(c.get("value", 0))
                   for c in (inst or {}).get("values", []))

    before = total()
    fired = []
    manager = watchdog.enable_comm_watchdog(
        timeout=30.0, on_timeout=lambda t, a: fired.append(t))
    try:
        manager.watch("done.collective", torch.ones(2))  # completes at once
        rel.arm(rel.FaultInjector(seed=0).plan("comm.watchdog", rate=1.0))
        try:
            dist.all_reduce(torch.ones(3))
        finally:
            rel.disarm()
        deadline = time.monotonic() + 5.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.6)  # a second poll reports nothing more
    finally:
        watchdog.disable_comm_watchdog()
    assert fired == ["all_reduce"]
    assert total() == before + 1
    rel.arm(rel.FaultInjector(seed=0).plan("collective", rate=1.0))
    try:
        with pytest.raises(rel.FaultInjection, match="collective"):
            dist.all_reduce(torch.ones(3))
    finally:
        rel.disarm()
