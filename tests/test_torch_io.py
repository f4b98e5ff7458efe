"""The port's ``io`` (datasets, samplers, ``DataLoader``, ``DeviceLoader``)
and ``bucket_collate`` against the JAX package's, on the CPU.

- Index orders equal JAX's for the same seed and epoch (both draw from
  ``np.random.default_rng``): ``RandomSampler`` (a seed, an epoch pinned by
  ``set_epoch``), ``BatchSampler`` with and without ``drop_last``,
  single-rank ``DistributedBatchSampler`` (shuffled, padded or dropped),
  ``random_split`` (integer and fractional lengths). A world size above 1
  raises.
- ``DataLoader`` batches equal JAX's, exactly (integer and f32 rows), with
  0 workers, thread workers and worker processes; ``iter_from(k)`` equals
  skipping k batches in every mode and fetches no sample of the skipped
  prefix; a worker's error reaches the loop.
- ``bucket_collate`` pads as JAX's does.
- ``DeviceLoader`` on the CPU passes the batches through, in order, from
  any cursor; ``device_prefetch=`` wraps a loader in it; the entry points
  that stage on the card default to CUDA and raise without it, and a mesh
  placement raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.io as jax_io
from paddle_tpu.jit.bucketing import bucket_collate as jax_bucket_collate
from paddle_tpu_torch import io
from paddle_tpu_torch.jit.bucketing import bucket_collate


class Rows(io.Dataset):
    """Row i: (an int64 vector of i's, f32 i); shared by both packages."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((3,), i, np.int64), np.float32(i) / 7


class JaxRows(jax_io.Dataset):
    def __init__(self, n=23):
        self.rows = Rows(n)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _batches(loader):
    return [tuple(_np(f) for f in b) for b in loader]


@pytest.mark.parametrize("seed,epoch", [(7, None), (None, 3), (None, 0)])
def test_random_sampler_order_matches_jax(seed, epoch):
    got = io.RandomSampler(Rows(), generator=seed)
    want = jax_io.RandomSampler(JaxRows(), generator=seed)
    if epoch is not None:
        got.set_epoch(epoch)
        want.set_epoch(epoch)
    assert list(got) == list(want)
    assert len(got) == len(want) == 23


@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler_matches_jax(drop_last):
    got = io.BatchSampler(Rows(), shuffle=True, batch_size=5,
                          drop_last=drop_last)
    want = jax_io.BatchSampler(JaxRows(), shuffle=True, batch_size=5,
                               drop_last=drop_last)
    got.set_epoch(2)
    want.set_epoch(2)
    assert list(got) == list(want)
    assert len(got) == len(want) == (4 if drop_last else 5)


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (True, True),
                                               (False, False)])
def test_single_rank_distributed_batch_sampler_matches_jax(shuffle,
                                                           drop_last):
    got = io.DistributedBatchSampler(Rows(), batch_size=4, shuffle=shuffle,
                                     drop_last=drop_last)
    want = jax_io.DistributedBatchSampler(JaxRows(), batch_size=4,
                                          num_replicas=1, rank=0,
                                          shuffle=shuffle,
                                          drop_last=drop_last)
    for epoch in (0, 5):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert list(got) == list(want)
    assert len(got) == len(want)
    # above one rank (the world is passed in here; the launched ranks take
    # it from the environment: tests/test_torch_data_parallel.py)
    for rank in range(2):
        got = io.DistributedBatchSampler(Rows(), batch_size=4, shuffle=shuffle,
                                         drop_last=drop_last, num_replicas=2,
                                         rank=rank)
        want = jax_io.DistributedBatchSampler(JaxRows(), batch_size=4,
                                              num_replicas=2, rank=rank,
                                              shuffle=shuffle,
                                              drop_last=drop_last)
        for epoch in (0, 5):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(got) == list(want)
        assert len(got) == len(want)


@pytest.mark.parametrize("lengths", [[10, 13], [0.5, 0.3, 0.2]])
def test_random_split_matches_jax(lengths):
    got = io.random_split(Rows(), lengths, generator=11)
    want = jax_io.random_split(JaxRows(), lengths, generator=11)
    assert [s.indices for s in got] == [s.indices for s in want]


def test_weighted_and_subset_samplers_draw_valid_indices():
    w = io.WeightedRandomSampler([0.0, 1.0, 0.0, 2.0], num_samples=20)
    assert len(list(w)) == 20 and set(w) <= {1, 3}
    s = io.SubsetRandomSampler([4, 8, 15])
    assert sorted(s) == [4, 8, 15]


def test_default_collate_gives_cpu_tensors():
    batch = [(np.ones(2, np.int64), 3, 0.5, {"a": torch.ones(2)})] * 2
    x, i, f, d = io.default_collate_fn(batch)
    assert (x.dtype, i.dtype, f.dtype) == (torch.int64, torch.int64,
                                           torch.float32)
    assert x.shape == (2, 2) and d["a"].shape == (2, 2)
    assert all(t.device.type == "cpu" for t in (x, i, f, d["a"]))
    conv = io.default_convert_fn((np.zeros(3), [np.ones(1)]))
    assert isinstance(conv[0], torch.Tensor)
    assert isinstance(conv[1][0], torch.Tensor)


def _jax_loader_batches(shuffle, epoch):
    loader = jax_io.DataLoader(JaxRows(), batch_size=5, shuffle=shuffle)
    loader.set_epoch(epoch)
    return _batches(loader)


MODES = [("thread", 0), ("thread", 3), ("process", 2)]


@pytest.mark.parametrize("mode,workers", MODES)
def test_dataloader_batches_and_cursor_match_jax(mode, workers):
    want = _jax_loader_batches(True, 4)
    ds = (io.TensorDataset([np.stack([Rows()[i][0] for i in range(23)]),
                            np.asarray([Rows()[i][1] for i in range(23)])])
          if mode == "process" else Rows())
    loader = io.DataLoader(ds, batch_size=5, shuffle=True,
                           num_workers=workers, worker_mode=mode)
    loader.set_epoch(4)
    got = _batches(loader)
    assert len(got) == len(want) == len(loader) == 5
    for g, w in zip(got, want):
        assert g[0].dtype == np.int64 and g[1].dtype == np.float32
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    # iter_from(k) equals skipping k batches
    skipped = _batches(loader.iter_from(3))
    assert len(skipped) == 2
    for g, w in zip(skipped, got[3:]):
        np.testing.assert_array_equal(g[0], w[0])


def test_iter_from_skips_at_the_index_level():
    fetched = []

    class Spy(io.Dataset):
        def __len__(self):
            return 12

        def __getitem__(self, i):
            fetched.append(i)
            return np.float32(i)

    for workers in (0, 2):
        fetched.clear()
        got = [_np(b).tolist() for b in io.DataLoader(
            Spy(), batch_size=2, num_workers=workers,
            worker_mode="thread").iter_from(4)]
        assert got == [[8.0, 9.0], [10.0, 11.0]]
        assert sorted(fetched) == [8, 9, 10, 11]


def test_thread_workers_see_their_worker_info():
    seen = set()

    class Who(io.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            info = io.get_worker_info()
            seen.add((info.id, info.num_workers))
            return np.float32(i)

    assert io.get_worker_info() is None
    out = [_np(b).tolist() for b in io.DataLoader(
        Who(), batch_size=2, num_workers=2, worker_mode="thread")]
    assert out == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    assert {w for _, w in seen} == {2} and {i for i, _ in seen} <= {0, 1}


def test_worker_errors_reach_the_loop():
    class Bad(io.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("no row 2")
            return np.float32(i)

    with pytest.raises(KeyError, match="no row 2"):
        list(io.DataLoader(Bad(), batch_size=1, num_workers=2,
                           worker_mode="thread"))


def test_bucket_collate_pads_as_jax():
    rs = np.random.RandomState(0)
    samples = [(rs.randint(0, 50, (n,)).astype(np.int64), np.int64(n))
               for n in (5, 17, 9)]
    got = bucket_collate(axis=0, min_len=4, max_len=64, pad_value=-1)(
        samples)
    want = jax_bucket_collate(axis=0, min_len=4, max_len=64, pad_value=-1)(
        samples)
    assert got[0].shape == (3, 32) and isinstance(got[0], torch.Tensor)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    ladder = bucket_collate(axis=0, buckets=[8, 24])(
        [np.ones(7, np.float32), np.ones(20, np.float32)])
    assert ladder.shape == (2, 24)


def test_device_loader_on_the_cpu_passes_batches_through():
    data = [(np.full((2, 2), i, np.float32),) for i in range(6)]
    dl = io.DeviceLoader(data, depth=2, device="cpu")
    assert len(dl) == 6
    got = [float(b[0][0, 0]) for b in dl]
    assert got == [float(i) for i in range(6)]
    assert [float(b[0][0, 0]) for b in dl.iter_from(4)] == [4.0, 5.0]
    dl.set_epoch(3)  # a list has no set_epoch: nothing happens
    loader = io.DataLoader(Rows(), batch_size=5, device_prefetch=2,
                           device="cpu")
    want = _batches(io.DataLoader(Rows(), batch_size=5))
    got = _batches(loader)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])


def test_card_entry_points_default_to_cuda_and_mesh_placement_raises():
    # the mesh placement is "auto" (the dp rows of each rank,
    # tests/test_torch_data_parallel.py); any other name raises
    with pytest.raises(ValueError, match="sharding"):
        io.DeviceLoader([], sharding="dp", device="cpu")
    if torch.cuda.is_available():
        return  # the defaults resolve on a card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        io.DeviceLoader([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        io.DataLoader(Rows(), device_prefetch=2)
    # no prefetch: the loader stays on the host and needs no card
    assert io.DataLoader(Rows(), batch_size=4).device is None
