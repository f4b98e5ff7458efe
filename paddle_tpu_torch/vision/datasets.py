"""Vision datasets (port of ``paddle_tpu/vision/datasets.py``): ``FakeData``,
``MNIST``, ``Cifar10``, ``DatasetFolder``, ``ImageFolder``, ``Flowers`` and
``VOC2012``, each reading local files in the reference's format and none
downloading. Images come out as numpy arrays (HWC for the transforms), the
labels as int64.

PIL is imported only when an image file is decoded (the default
``loader`` of the folder datasets, ``Flowers``' and ``VOC2012``'s JPEGs);
without it the call raises naming PIL. A caller without PIL passes
``loader=`` (``np.load`` over ``.npy`` files, say) to the folder datasets.
``Flowers`` reads its ``.mat`` files with scipy, imported when it is
built.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["Cifar10", "DatasetFolder", "FakeData", "Flowers",
           "IMG_EXTENSIONS", "ImageFolder", "MNIST", "VOC2012",
           "default_loader"]


def _pil_image():
    """PIL's ``Image`` module, imported at the first decode."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding an image file needs PIL (Pillow), which is not "
            "installed: pass loader= (e.g. np.load over .npy files)") from e
    return Image


class FakeData(Dataset):
    """Synthetic image classification dataset (deterministic per index)."""

    def __init__(self, num_samples=1000, image_shape=(3, 224, 224), num_classes=1000,
                 transform=None, dtype="float32"):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.dtype = dtype

    def __getitem__(self, idx):
        rs = np.random.RandomState(idx)
        img = rs.standard_normal(self.image_shape).astype(self.dtype)
        label = np.int64(rs.randint(0, self.num_classes))
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return self.num_samples


class MNIST(Dataset):
    """IDX-format MNIST (reference mnist.py). Pass image_path/label_path to the
    `train-images-idx3-ubyte.gz` / `train-labels-idx1-ubyte.gz` files."""

    def __init__(self, image_path=None, label_path=None, mode="train", transform=None,
                 backend=None):
        if image_path is None or label_path is None:
            raise ValueError(
                "no network egress: MNIST needs explicit image_path/label_path "
                "to locally available IDX files"
            )
        self.transform = transform
        with gzip.open(image_path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad MNIST image magic {magic}")
            self.images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)
        with gzip.open(label_path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"bad MNIST label magic {magic}")
            self.labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar10(Dataset):
    """python-pickle CIFAR-10 (reference cifar.py). data_file points at the
    `cifar-10-python.tar.gz` archive or an extracted batches directory."""

    def __init__(self, data_file=None, mode="train", transform=None, backend=None):
        if data_file is None:
            raise ValueError("no network egress: Cifar10 needs a local data_file")
        self.transform = transform
        names = (
            [f"data_batch_{i}" for i in range(1, 6)] if mode == "train" else ["test_batch"]
        )
        imgs, labels = [], []
        if os.path.isdir(data_file):
            for name in names:
                with open(os.path.join(data_file, name), "rb") as f:
                    batch = pickle.load(f, encoding="bytes")
                imgs.append(batch[b"data"])
                labels.extend(batch[b"labels"])
        else:
            with tarfile.open(data_file) as tf:
                for member in tf.getmembers():
                    if any(member.name.endswith(n) for n in names):
                        batch = pickle.load(tf.extractfile(member), encoding="bytes")
                        imgs.append(batch[b"data"])
                        labels.extend(batch[b"labels"])
        self.images = np.concatenate(imgs).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(labels, dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].transpose(1, 2, 0)  # HWC for transforms
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


# ---- folder-tree datasets (reference vision/datasets/folder.py) ------------

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def _pil_loader(path):
    with _pil_image().open(path) as img:
        return np.asarray(img.convert("RGB"))


def default_loader(path):
    """reference folder.py::default_loader — image file → HWC uint8 array."""
    return _pil_loader(path)


def _find_classes(root):
    classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
    if not classes:
        raise FileNotFoundError(f"no class folders under {root}")
    return classes, {c: i for i, c in enumerate(classes)}


def _make_samples(root, class_to_idx, extensions, is_valid_file):
    if extensions is not None and is_valid_file is not None:
        raise ValueError("pass either extensions or is_valid_file, not both")
    if is_valid_file is None:
        exts = tuple(e.lower() for e in (extensions or IMG_EXTENSIONS))

        def is_valid_file(p):
            return p.lower().endswith(exts)

    samples = []
    for cls in sorted(class_to_idx):
        d = os.path.join(root, cls)
        for sub, _, files in sorted(os.walk(d, followlinks=True)):
            for fname in sorted(files):
                p = os.path.join(sub, fname)
                if is_valid_file(p):
                    samples.append((p, class_to_idx[cls]))
    if not samples:
        raise FileNotFoundError(f"no valid files found under {root}")
    return samples


class DatasetFolder(Dataset):
    """class-per-subdirectory tree → (image, class_index) samples (reference
    vision/datasets/folder.py::DatasetFolder — how real users feed
    classification models from disk)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or default_loader
        self.transform = transform
        self.classes, self.class_to_idx = _find_classes(root)
        self.samples = _make_samples(root, self.class_to_idx, extensions,
                                     is_valid_file)
        self.targets = [t for _, t in self.samples]

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(target)

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat image list without labels (reference folder.py::ImageFolder —
    the inference-input counterpart of DatasetFolder)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or default_loader
        self.transform = transform
        if is_valid_file is None:
            exts = tuple(e.lower() for e in (extensions or IMG_EXTENSIONS))

            def is_valid_file(p):
                return p.lower().endswith(exts)

        self.samples = []
        for sub, _, files in sorted(os.walk(root, followlinks=True)):
            for fname in sorted(files):
                p = os.path.join(sub, fname)
                if is_valid_file(p):
                    self.samples.append(p)
        if not self.samples:
            raise FileNotFoundError(f"no valid files found under {root}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


def _worker_tar(ds, path):
    """Per-(process, thread) TarFile handle: a single shared handle's file
    offset races under thread workers and is duplicated (shared offset)
    across fork workers — each worker opens its own."""
    import threading

    tl = ds.__dict__.get("_tar_local")
    if tl is None:
        tl = ds.__dict__["_tar_local"] = threading.local()
    if getattr(tl, "pid", None) != os.getpid() or getattr(tl, "tar", None) is None:
        tl.tar = tarfile.open(path)
        tl.pid = os.getpid()
    return tl.tar


class Flowers(Dataset):
    """Oxford 102 Flowers (reference vision/datasets/flowers.py): pass the
    locally available `102flowers.tgz` (or extracted jpg dir), the
    `imagelabels.mat` and `setid.mat` files (no network egress here; the
    reference downloads the same three artifacts)."""

    MODE_KEYS = {"train": "trnid", "valid": "valid", "test": "tstid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, backend=None):
        if data_file is None or label_file is None or setid_file is None:
            raise ValueError(
                "no network egress: Flowers needs local data_file "
                "(102flowers.tgz or jpg dir), label_file (imagelabels.mat) "
                "and setid_file (setid.mat)")
        import scipy.io

        self.transform = transform
        labels = scipy.io.loadmat(label_file)["labels"].ravel()
        setid = scipy.io.loadmat(setid_file)
        key = self.MODE_KEYS.get(mode, mode)
        self.indexes = setid[key].ravel()  # 1-based image ids
        self.labels = labels
        if os.path.isdir(data_file):
            self._dir = data_file
            self._tar_path = None
        else:
            self._dir = None
            self._tar_path = data_file

    def _read_image(self, image_id):
        name = f"image_{image_id:05d}.jpg"
        if self._dir is not None:
            for cand in (os.path.join(self._dir, name),
                         os.path.join(self._dir, "jpg", name)):
                if os.path.exists(cand):
                    return _pil_loader(cand)
            raise FileNotFoundError(name)
        member = _worker_tar(self, self._tar_path).extractfile(f"jpg/{name}")
        with _pil_image().open(member) as img:
            return np.asarray(img.convert("RGB"))

    def __getitem__(self, idx):
        image_id = int(self.indexes[idx])
        img = self._read_image(image_id)
        label = np.int64(self.labels[image_id - 1])
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.indexes)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation pairs (reference
    vision/datasets/voc2012.py): data_file is the local VOCtrainval tar (or
    an extracted VOCdevkit/VOC2012 directory); yields (image, label mask)."""

    SETS = {"train": "train.txt", "valid": "val.txt", "trainval": "trainval.txt"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 backend=None):
        if data_file is None:
            raise ValueError("no network egress: VOC2012 needs a local "
                             "data_file (tar or extracted VOC2012 dir)")
        self.transform = transform
        listing = self.SETS.get(mode, self.SETS["train"])
        if os.path.isdir(data_file):
            self._root = data_file
            self._tar_path = None
            seg = os.path.join(data_file, "ImageSets", "Segmentation", listing)
            with open(seg) as f:
                self.names = [l.strip() for l in f if l.strip()]
        else:
            self._root = None
            self._tar_path = data_file
            # index once, then close: __getitem__ resolves members by NAME
            # through a per-worker handle (a shared TarFile's file offset is
            # unsafe under thread or fork DataLoader workers)
            with tarfile.open(data_file) as tar:
                names = tar.getnames()
                seg = next(n for n in names
                           if n.endswith(f"ImageSets/Segmentation/{listing}"))
                self.names = [l.strip() for l in
                              tar.extractfile(seg).read().decode().split("\n")
                              if l.strip()]
            self._prefix = seg.split("ImageSets")[0]

    def _load(self, rel, gray):
        Image = _pil_image()
        if self._root is not None:
            fh = os.path.join(self._root, rel)
            with Image.open(fh) as img:
                return np.asarray(img.convert("L" if gray else "RGB"))
        member = _worker_tar(self, self._tar_path).extractfile(self._prefix + rel)
        with Image.open(member) as img:
            return np.asarray(img.convert("L" if gray else "RGB"))

    def __getitem__(self, idx):
        name = self.names[idx]
        img = self._load(f"JPEGImages/{name}.jpg", gray=False)
        label = self._load(f"SegmentationClass/{name}.png", gray=True)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.names)
