"""Vision models of the port (``paddle_tpu/vision/models``): the ResNet
family, LeNet, AlexNet, VGG, MobileNetV1/V2, PP-LiteSeg and PP-YOLOE."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50, resnet101, resnet152, resnext50_32x4d,
                     resnext101_32x4d, wide_resnet50_2, wide_resnet101_2)
from .segdet import PPLiteSeg, PPYOLOE, pp_liteseg, pp_yoloe
from .small import (VGG, AlexNet, LeNet, MobileNetV1, MobileNetV2, alexnet,
                    mobilenet_v1, mobilenet_v2, vgg11, vgg13, vgg16, vgg19)

__all__ = ["AlexNet", "BasicBlock", "BottleneckBlock", "LeNet",
           "MobileNetV1", "MobileNetV2", "PPLiteSeg", "PPYOLOE", "ResNet",
           "VGG", "alexnet", "mobilenet_v1", "mobilenet_v2", "pp_liteseg",
           "pp_yoloe", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "resnext50_32x4d", "resnext101_32x4d", "vgg11",
           "vgg13", "vgg16", "vgg19", "wide_resnet50_2", "wide_resnet101_2"]
