"""Vision transforms (port of ``paddle_tpu/vision/transforms.py``) on HWC
numpy arrays, uint8 or float, with the JAX package's own bilinear
``_resize`` (no cv2 or PIL): ``Compose``, ``Resize``, ``CenterCrop``,
``RandomCrop``, ``RandomHorizontalFlip``/``RandomVerticalFlip``,
``Normalize``, ``Transpose``, ``ToTensor`` (CHW float32 in [0, 1]) and
``BrightnessTransform``.

The random transforms draw from ``generator``, a ``random.Random``, where
the JAX ones draw from Python's global ``random`` (``BrightnessTransform``
from numpy's). Without one they draw, at each call, from the process-wide
host generator that ``paddle.seed`` seeds (``base.global_state.
host_random``); a ``DataLoader`` worker process reseeds its copy of it at
each epoch's start, so workers draw different streams and a seed repeats
them. A generator given here is pickled into each worker as it stands:
every worker then repeats its draws.
"""
from __future__ import annotations

import numbers
import random
from typing import Optional, Sequence

import numpy as np

from ..base import global_state

__all__ = ["BaseTransform", "BrightnessTransform", "CenterCrop", "Compose",
           "Normalize", "RandomCrop", "RandomHorizontalFlip",
           "RandomVerticalFlip", "Resize", "ToTensor", "Transpose"]


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(np.asarray(img))

    def _apply_image(self, img):
        raise NotImplementedError


class _Random(BaseTransform):
    """A transform that draws from ``generator`` or, without one, from the
    process-wide host generator at each call."""

    def __init__(self, generator: Optional[random.Random] = None):
        self.generator = generator

    @property
    def _rng(self) -> random.Random:
        return (self.generator if self.generator is not None
                else global_state.host_random())


def _as_pair(size):
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return int(size[0]), int(size[1])


def _resize(img, h, w):
    """The JAX package's bilinear resize, one axis at a time in f32 (half
    pixel centres, edges clamped), cast back to an integer input's
    dtype."""
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img
    ys = (np.arange(h) + 0.5) * ih / h - 0.5
    xs = (np.arange(w) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    img_f = img.astype(np.float32)
    squeeze = img_f.ndim == 2
    if squeeze:
        img_f = img_f[:, :, None]
    top = img_f[y0][:, x0] * (1 - wx) + img_f[y0][:, x1] * wx
    bot = img_f[y1][:, x0] * (1 - wx) + img_f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if squeeze:
        out = out[:, :, 0]
    return (out.astype(img.dtype) if np.issubdtype(img.dtype, np.integer)
            else out)


class Resize(BaseTransform):
    """To ``size`` (h, w), or, given one number, the shorter side to it
    with the aspect kept."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        if isinstance(self.size, numbers.Number):
            ih, iw = img.shape[:2]
            scale = self.size / ih if ih <= iw else self.size / iw
            h, w = int(round(ih * scale)), int(round(iw * scale))
        else:
            h, w = _as_pair(self.size)
        return _resize(img, h, w)


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = _as_pair(size)

    def _apply_image(self, img):
        h, w = self.size
        ih, iw = img.shape[:2]
        top, left = max((ih - h) // 2, 0), max((iw - w) // 2, 0)
        return img[top:top + h, left:left + w]


class RandomCrop(_Random):
    def __init__(self, size, padding=None, pad_if_needed=False, *,
                 generator: Optional[random.Random] = None):
        super().__init__(generator)
        self.size = _as_pair(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed

    def _apply_image(self, img):
        h, w = self.size
        if self.padding:
            p = (self.padding if not isinstance(self.padding, numbers.Number)
                 else [self.padding] * 4)
            pads = [(p[1], p[3]), (p[0], p[2])] + [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, pads, mode="constant")
        ih, iw = img.shape[:2]
        if self.pad_if_needed and (ih < h or iw < w):
            pads = ([(0, max(h - ih, 0)), (0, max(w - iw, 0))]
                    + [(0, 0)] * (img.ndim - 2))
            img = np.pad(img, pads, mode="constant")
            ih, iw = img.shape[:2]
        rng = self._rng
        top = rng.randint(0, ih - h)
        left = rng.randint(0, iw - w)
        return img[top:top + h, left:left + w]


class RandomHorizontalFlip(_Random):
    def __init__(self, prob=0.5, *,
                 generator: Optional[random.Random] = None):
        super().__init__(generator)
        self.prob = prob

    def _apply_image(self, img):
        return img[:, ::-1].copy() if self._rng.random() < self.prob else img


class RandomVerticalFlip(_Random):
    def __init__(self, prob=0.5, *,
                 generator: Optional[random.Random] = None):
        super().__init__(generator)
        self.prob = prob

    def _apply_image(self, img):
        return img[::-1].copy() if self._rng.random() < self.prob else img


class Normalize(BaseTransform):
    """``(x - mean) / std`` in f32 over CHW or HWC input."""

    def __init__(self, mean=0.0, std=1.0, data_format="CHW"):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = img.astype(np.float32)
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[:, :, None]
        return img.transpose(self.order)


class ToTensor(BaseTransform):
    """HWC → CHW float32, integer input scaled from [0, 255] to [0, 1]
    (the array stays numpy: the loader makes the tensors)."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[:, :, None]
        out = img.astype(np.float32)
        if np.issubdtype(img.dtype, np.integer):
            out = out / 255.0
        return out.transpose(2, 0, 1) if self.data_format == "CHW" else out


class BrightnessTransform(_Random):
    """``x`` times a factor drawn uniformly in ``[1 - value, 1 + value]``,
    clipped to [0, 255] and cast back for integer input."""

    def __init__(self, value, *, generator: Optional[random.Random] = None):
        super().__init__(generator)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        factor = 1.0 + self._rng.uniform(-self.value, self.value)
        dtype = img.dtype
        out = img.astype(np.float32) * factor
        return (np.clip(out, 0, 255).astype(dtype)
                if np.issubdtype(dtype, np.integer) else out)
