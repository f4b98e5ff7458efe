"""``vision.transforms`` and ``vision.datasets`` against the JAX package on
the CPU, over arrays and files the tests write themselves (no download):
each transform on the same HWC arrays (the random ones given a
``random.Random`` seeded as the JAX ones' global ``random``), ``FakeData``,
``DatasetFolder`` and ``ImageFolder`` over ``.npy`` files with
``loader=np.load``, ``MNIST`` over IDX files and ``Cifar10`` over pickled
batches (a directory and a tar archive). Then the generators: the default
one is ``paddle.seed``'s host generator, and a ``DataLoader`` worker
process seeds its copy with the epoch's seed plus its id."""
import gzip
import os
import pickle
import queue
import random
import struct
import tarfile
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.vision.datasets as JD
import paddle_tpu.vision.transforms as JT
import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.base import global_state
from paddle_tpu_torch.io import dataloader
from paddle_tpu_torch.vision import datasets as D
from paddle_tpu_torch.vision import transforms as T


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


def _img(seed, h=37, w=29, dtype=np.uint8):
    rs = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return rs.rand(h, w, 3).astype(np.float32)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_deterministic_transforms_match_jax(dtype):
    img = _img(0, dtype=dtype)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    for make in (lambda m: m.Resize(20), lambda m: m.Resize((16, 40)),
                 lambda m: m.CenterCrop(15), lambda m: m.CenterCrop((40, 9)),
                 lambda m: m.Transpose(), lambda m: m.ToTensor(),
                 lambda m: m.Normalize(mean, std, data_format="HWC"),
                 lambda m: m.Compose([m.Resize(32), m.CenterCrop(24),
                                      m.Normalize(mean, std,
                                                  data_format="HWC"),
                                      m.Transpose()])):
        _equal(make(T)(img), make(JT)(img))
    _equal(T.Normalize(0.5, 2.0)(img.transpose(2, 0, 1)),
           JT.Normalize(0.5, 2.0)(img.transpose(2, 0, 1)))
    _equal(T.ToTensor()(img[:, :, 0]), JT.ToTensor()(img[:, :, 0]))


def test_random_transforms_match_jax_on_the_same_draws():
    img = _img(1)
    for make, kw in ((lambda m, **k: m.RandomCrop(20, **k), {}),
                     (lambda m, **k: m.RandomCrop(
                         (40, 33), padding=2, pad_if_needed=True, **k), {}),
                     (lambda m, **k: m.RandomHorizontalFlip(**k), {}),
                     (lambda m, **k: m.RandomVerticalFlip(0.7, **k), {})):
        gen = random.Random(5)
        ours = make(T, generator=gen)
        theirs = make(JT)
        random.seed(5)
        for _ in range(6):
            _equal(ours(img), theirs(img))
    # brightness: JAX draws from numpy's global stream; the factor's range
    out = T.BrightnessTransform(0.4, generator=random.Random(0))(img)
    ratio = out.astype(np.float64).sum() / img.astype(np.float64).sum()
    assert out.dtype == np.uint8 and 0.55 < ratio < 1.45
    assert T.BrightnessTransform(0)(img) is img


def test_default_generator_is_the_seeded_host_generator():
    crop = T.Compose([T.RandomCrop(16), T.RandomHorizontalFlip()])
    img = _img(2)
    paddle.seed(11)
    first = [crop(img) for _ in range(5)]
    paddle.seed(11)
    again = [crop(img) for _ in range(5)]
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert not all(np.array_equal(first[0], f) for f in first[1:])


def test_fake_data_matches_jax():
    for kw in (dict(num_samples=4, image_shape=(3, 8, 8), num_classes=10),
               dict(num_samples=3, image_shape=(5, 6, 3), num_classes=7,
                    transform=T.Transpose((2, 0, 1)))):
        ours = D.FakeData(**kw)
        theirs = JD.FakeData(**{k: (JT.Transpose((2, 0, 1)) if k ==
                                    "transform" else v)
                                for k, v in kw.items()})
        assert len(ours) == len(theirs)
        for i in range(len(ours)):
            (a, la), (b, lb) = ours[i], theirs[i]
            _equal(a, b)
            assert la == lb and isinstance(la, np.int64)


def _write_tree(root, classes=("cat", "dog", "eel"), per=3):
    for c, cls in enumerate(classes):
        os.makedirs(os.path.join(root, cls, "sub"), exist_ok=True)
        for i in range(per):
            where = os.path.join(root, cls, "sub" if i == 2 else "")
            np.save(os.path.join(where, f"{i}.npy"), _img(10 * c + i, 9, 7))
        open(os.path.join(root, cls, "notes.txt"), "w").write("skip me")


def test_folder_datasets_match_jax(tmp_path):
    root = str(tmp_path / "tree")
    _write_tree(root)
    tf = lambda m: m.Compose([m.Resize(5), m.Transpose()])  # noqa: E731
    ours = D.DatasetFolder(root, loader=np.load, extensions=(".npy",),
                           transform=tf(T))
    theirs = JD.DatasetFolder(root, loader=np.load, extensions=(".npy",),
                              transform=tf(JT))
    assert ours.classes == theirs.classes == ["cat", "dog", "eel"]
    assert ours.samples == theirs.samples and len(ours) == 9
    for i in range(len(ours)):
        _equal(ours[i][0], theirs[i][0])
        assert ours[i][1] == theirs[i][1]
    flat_ours = D.ImageFolder(root, loader=np.load,
                              is_valid_file=lambda p: p.endswith(".npy"))
    flat_theirs = JD.ImageFolder(root, loader=np.load,
                                 is_valid_file=lambda p: p.endswith(".npy"))
    assert flat_ours.samples == flat_theirs.samples
    _equal(flat_ours[4][0], flat_theirs[4][0])
    with pytest.raises(FileNotFoundError):
        D.DatasetFolder(root, loader=np.load, extensions=(".png",))


def test_mnist_and_cifar10_read_the_reference_formats(tmp_path):
    rs = np.random.RandomState(4)
    imgs = rs.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 5).astype(np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lab.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    ours, theirs = D.MNIST(ip, lp), JD.MNIST(ip, lp)
    assert len(ours) == len(theirs) == 5
    for i in (0, 4):
        _equal(ours[i][0], theirs[i][0])
        assert ours[i][1] == theirs[i][1] == labels[i]
    with pytest.raises(ValueError):
        D.MNIST()

    folder = tmp_path / "cifar-10-batches-py"
    folder.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rs.randint(0, 256, (2, 3072)).astype(np.uint8),
                 b"labels": list(rs.randint(0, 10, 2))}
        with open(folder / name, "wb") as f:
            pickle.dump(batch, f)
    archive = str(tmp_path / "cifar-10-python.tar.gz")
    with tarfile.open(archive, "w:gz") as tar:
        tar.add(str(folder), arcname="cifar-10-batches-py")
    for source in (str(folder), archive):
        for mode in ("train", "test"):
            ours = D.Cifar10(source, mode=mode)
            theirs = JD.Cifar10(source, mode=mode)
            assert len(ours) == len(theirs) == (10 if mode == "train" else 2)
            _equal(ours[1][0], theirs[1][0])
            assert ours[1][0].shape == (32, 32, 3)
            assert ours[1][1] == theirs[1][1]


def test_default_loader_names_pil_when_it_is_missing(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="PIL"):
        D.default_loader(str(tmp_path / "x.png"))


class _Crops:
    """A dataset of one image under a random crop, drawn from the default
    generator."""

    def __init__(self):
        self.crop = T.RandomCrop(8)
        self.img = _img(3, 32, 32)

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return self.crop(self.img)


def _worker_batches(host_seed, wid):
    out, stop = queue.Queue(), threading.Event()
    batches = [[0, 1], [2, 3]]
    dataloader._process_worker(_Crops(), dataloader.default_collate_fn,
                               batches, out, stop, wid, 2, None, host_seed)
    got = []
    while True:
        item = out.get()
        if item is None:
            return got
        got.append(pickle.loads(item[1]))


def test_worker_seeds_the_host_generator_by_epoch_and_id():
    """Worker w seeds its host generator with the epoch's seed plus w: the
    workers differ, and the same seed repeats them."""
    state = global_state.host_random().getstate()
    try:
        w0, w1 = _worker_batches(123, 0), _worker_batches(123, 1)
        again = _worker_batches(123, 0)
        same = lambda a, b: all(np.array_equal(x, y)  # noqa: E731
                                for x, y in zip(a, b))
        assert same(w0, again) and not same(w0, w1)
        assert same(_worker_batches(122, 1), w0)
    finally:
        global_state.host_random().setstate(state)
    paddle.seed(3)
    first = global_state.host_random().getrandbits(62)
    paddle.seed(3)
    assert global_state.host_random().getrandbits(62) == first
