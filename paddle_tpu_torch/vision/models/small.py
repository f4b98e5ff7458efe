"""LeNet, AlexNet, VGG and MobileNetV1/V2 (port of ``paddle_tpu/vision/
models/small.py``): ``LeNet``, ``AlexNet``/``alexnet``, ``VGG`` with
``vgg11/13/16/19`` (with and without ``batch_norm``), ``MobileNetV1``/
``mobilenet_v1``, ``InvertedResidual`` and ``MobileNetV2``/
``mobilenet_v2``.

Same module tree, parameter and buffer names as the JAX models, so their
state dicts line up key for key and ``load_jax_state`` carries JAX weights
across (each ``Linear`` weight transposed from JAX's ``[in, out]``). The
MobileNets' depthwise convolutions are ``Conv2D(groups=channels)``, their
activation ``ReLU6``. Dropout draws from the model's own generator on its
device, seeded by ``dropout_seed`` (the JAX layers draw from the global
generator, a stream the port does not reproduce); ``eval()`` makes it
inert. Built on ``device`` (default CUDA; raises when CUDA is absent and
the caller did not ask for the CPU) with initial values drawn from
``generator`` (default: the build generator ``paddle.seed`` seeds).
``pretrained=True`` raises, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...device import DEFAULT_DEVICE, resolve_device
from ...nn.layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                         Linear, MaxPool2D, ReLU, ReLU6, Sequential)
from ...nn.layer.layers import Layer, building
from ...ops.math import add

__all__ = ["AlexNet", "InvertedResidual", "LeNet", "MobileNetV1",
           "MobileNetV2", "VGG", "alexnet", "mobilenet_v1", "mobilenet_v2",
           "vgg11", "vgg13", "vgg16", "vgg19"]


def _no_pretrained(pretrained):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network egress); "
            "load a converted state_dict with load_jax_state instead")


def _dropout_generator(device, seed):
    """The generator a model's dropout draws from, on its device."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))


class LeNet(Layer):
    """For 28x28 single-channel inputs."""

    def __init__(self, num_classes=10, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        with building(self, device, generator):
            self.features = Sequential(
                Conv2D(1, 6, 3, stride=1, padding=1), ReLU(),
                MaxPool2D(2, 2),
                Conv2D(6, 16, 5, stride=1, padding=0), ReLU(),
                MaxPool2D(2, 2))
            if num_classes > 0:
                self.fc = Sequential(Linear(400, 120), Linear(120, 84),
                                     Linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class AlexNet(Layer):
    def __init__(self, num_classes=1000, dropout=0.5, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        gen = _dropout_generator(device, dropout_seed)
        with building(self, device, generator):
            self.features = Sequential(
                Conv2D(3, 64, 11, stride=4, padding=2), ReLU(),
                MaxPool2D(3, 2),
                Conv2D(64, 192, 5, padding=2), ReLU(), MaxPool2D(3, 2),
                Conv2D(192, 384, 3, padding=1), ReLU(),
                Conv2D(384, 256, 3, padding=1), ReLU(),
                Conv2D(256, 256, 3, padding=1), ReLU(), MaxPool2D(3, 2))
            self.avgpool = AdaptiveAvgPool2D((6, 6))
            if num_classes > 0:
                self.classifier = Sequential(
                    Dropout(dropout, generator=gen), Linear(256 * 36, 4096),
                    ReLU(), Dropout(dropout, generator=gen),
                    Linear(4096, 4096), ReLU(),
                    Linear(4096, num_classes))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def alexnet(pretrained=False, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)


_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def _make_vgg_features(cfg, batch_norm=False):
    layers, in_ch = [], 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_ch, v, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2D(v))
            layers.append(ReLU())
            in_ch = v
    return Sequential(*layers)


class VGG(Layer):
    """``features`` (a ``Sequential``, or a VGG config letter's list with
    ``batch_norm``), a 7x7 adaptive average pool with ``with_pool``, and the
    3-layer classifier with ``num_classes > 0``."""

    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 batch_norm=False, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        gen = _dropout_generator(device, dropout_seed)
        with building(self, device, generator):
            self.features = (_make_vgg_features(features, batch_norm)
                             if isinstance(features, list) else features)
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((7, 7))
            if num_classes > 0:
                self.classifier = Sequential(
                    Linear(512 * 49, 4096), ReLU(),
                    Dropout(0.5, generator=gen), Linear(4096, 4096), ReLU(),
                    Dropout(0.5, generator=gen),
                    Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def _vgg(cfg, batch_norm, pretrained, **kwargs):
    _no_pretrained(pretrained)
    return VGG(_VGG_CFGS[cfg], batch_norm=batch_norm, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, pretrained, **kwargs)


class _ConvBNReLU(Sequential):
    """Conv (no bias), BatchNorm and, with ``act``, ReLU6: a ``Sequential``
    named ``0``/``1``/``2``, as the JAX layer."""

    def __init__(self, in_ch, out_ch, kernel, stride=1, groups=1, act=True):
        pad = (kernel - 1) // 2
        layers = [Conv2D(in_ch, out_ch, kernel, stride=stride, padding=pad,
                         groups=groups, bias_attr=False),
                  BatchNorm2D(out_ch)]
        if act:
            layers.append(ReLU6())
        super().__init__(*layers)


class MobileNetV1(Layer):
    """The depthwise-separable stack: each step a depthwise 3x3 and a
    pointwise 1x1, each with BatchNorm and ReLU6."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(int(ch * scale), 8)

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2), (512, 512, 1), (512, 512, 1),
               (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 1024, 2),
               (1024, 1024, 1)]
        with building(self, device, generator):
            layers = [_ConvBNReLU(3, c(32), 3, stride=2)]
            for in_ch, out_ch, stride in cfg:
                layers.append(_ConvBNReLU(c(in_ch), c(in_ch), 3,
                                          stride=stride, groups=c(in_ch)))
                layers.append(_ConvBNReLU(c(in_ch), c(out_ch), 1))
            self.features = Sequential(*layers)
            if with_pool:
                self.pool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = Linear(c(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


class InvertedResidual(Layer):
    """MobileNetV2's block: a 1x1 expansion (unless ``expand_ratio`` is
    1), a depthwise 3x3, a linear 1x1 projection; the input added back
    when the stride is 1 and the widths match."""

    def __init__(self, inp, oup, stride, expand_ratio, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        with building(self, device, generator):
            layers = []
            if expand_ratio != 1:
                layers.append(_ConvBNReLU(inp, hidden, 1))
            layers += [_ConvBNReLU(hidden, hidden, 3, stride=stride,
                                   groups=hidden),
                       Conv2D(hidden, oup, 1, bias_attr=False),
                       BatchNorm2D(oup)]
            self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return add(x, out) if self.use_res else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

        def c(ch):
            return max(8, int(ch * scale + 4) // 8 * 8)

        gen = _dropout_generator(device, dropout_seed)
        with building(self, device, generator):
            in_ch = c(32)
            layers = [_ConvBNReLU(3, in_ch, 3, stride=2)]
            for t, ch, n, s in cfg:
                out_ch = c(ch)
                for i in range(n):
                    layers.append(InvertedResidual(in_ch, out_ch,
                                                   s if i == 0 else 1, t))
                    in_ch = out_ch
            self.last_ch = c(1280) if scale > 1.0 else 1280
            layers.append(_ConvBNReLU(in_ch, self.last_ch, 1))
            self.features = Sequential(*layers)
            if with_pool:
                self.pool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.classifier = Sequential(Dropout(0.2, generator=gen),
                                             Linear(self.last_ch,
                                                    num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained(pretrained)
    return MobileNetV2(scale=scale, **kwargs)
