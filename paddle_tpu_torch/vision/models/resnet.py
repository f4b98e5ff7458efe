"""ResNet family (port of ``paddle_tpu/vision/models/resnet.py``):
``BasicBlock``, ``BottleneckBlock``, ``ResNet`` and the presets
``resnet18/34/50/101/152``, ``resnext50_32x4d``/``resnext101_32x4d`` and
``wide_resnet50_2``/``wide_resnet101_2``.

Same module tree, parameter and buffer names as the JAX models (the
downsample branch a ``Sequential`` named ``"0"``/``"1"``), so the state
dicts line up key for key and :func:`load_jax_state` carries JAX weights
across: the conv weights and the BatchNorms' ``weight``/``bias``/``_mean``/
``_variance`` as they are, ``fc.weight`` transposed from the JAX ``[in,
out]`` to torch's ``[out, in]`` (:func:`jax_state_dict` is the inverse).

NCHW in, as in JAX. Under AMP O2 the convolutions and ``fc`` compute in
bf16 (white), the BatchNorms in f32 (black), and the ``relu`` s, the
max-pool, the residual sum and the average pool in bf16 (gray: JAX casts a
gray op's inputs, so a BatchNorm's f32 output enters them in bf16).

Built on ``device`` (default CUDA; raises when CUDA is absent and the
caller did not ask for the CPU) with initial values drawn from
``generator`` (default: the build generator ``paddle.seed`` seeds) by
the JAX layers' initializers: ``KaimingUniform`` convolutions,
BatchNorms at 1 and 0, ``fc`` by ``XavierNormal`` with a zero bias.
``pretrained=True`` raises, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...device import DEFAULT_DEVICE
from ...models.gpt import jax_state_dict, load_jax_state, port_state_from_jax
from ...nn.layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                         MaxPool2D, ReLU, Sequential)
from ...nn.layer.layers import Layer, building
from ...ops.math import add

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "jax_state_dict",
           "load_jax_state", "port_state_from_jax", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
           "resnext101_32x4d", "wide_resnet50_2", "wide_resnet101_2"]


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        if groups != 1 or base_width != 64:
            raise ValueError("BasicBlock only supports groups=1 and "
                             "base_width=64")
        with building(self, device, generator):
            self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                                bias_attr=False)
            self.bn1 = norm_layer(planes)
            self.relu = ReLU()
            self.conv2 = Conv2D(planes, planes, 3, padding=1,
                                bias_attr=False)
            self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(add(out, identity))


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        with building(self, device, generator):
            self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False)
            self.bn1 = norm_layer(width)
            self.conv2 = Conv2D(width, width, 3, padding=dilation,
                                stride=stride, groups=groups,
                                dilation=dilation, bias_attr=False)
            self.bn2 = norm_layer(width)
            self.conv3 = Conv2D(width, planes * self.expansion, 1,
                                bias_attr=False)
            self.bn3 = norm_layer(planes * self.expansion)
            self.relu = ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(add(out, identity))


_LAYERS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
           101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


class ResNet(Layer):
    """The stem (7×7 stride-2 conv, BatchNorm, relu, 3×3 stride-2
    max-pool), four stages of ``block`` s, then, with ``with_pool``, an
    adaptive average pool to 1×1 and, with ``num_classes > 0``, a flatten
    and ``fc``. ``width`` is the blocks' base width, ``groups`` their
    grouped 3×3 convolutions."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = _LAYERS[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        with building(self, device, generator):
            self.conv1 = Conv2D(3, self.inplanes, kernel_size=7, stride=2,
                                padding=3, bias_attr=False)
            self.bn1 = self._norm_layer(self.inplanes)
            self.relu = ReLU()
            self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
            self.layer1 = self._make_layer(block, 64, layers[0])
            self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
            self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
            self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False),
                norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        norm_layer)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer))
        return Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)  # the JAX forward's nn.Flatten()
            x = self.fc(x)
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not bundled (no network egress); "
            "load a converted state_dict with load_jax_state instead")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 64 * 2
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 64 * 2
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)
