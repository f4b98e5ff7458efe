"""Segmentation and detection models (port of ``paddle_tpu/vision/models/
segdet.py``): PP-LiteSeg (``ConvBNReLU``, ``STDCBlock``, ``STDCNet``,
``SPPM``, ``UAFM``, ``PPLiteSeg``, ``pp_liteseg``) and PP-YOLOE
(``RepConvBlock``, ``CSPStage``, ``PPYOLOEHead``, ``PPYOLOE``,
``pp_yoloe``).

Same module tree, parameter and buffer names as the JAX models (SPPM's
``reduces`` a ``LayerList``, the attention and head stacks ``Sequential``
s), so the state dicts line up key for key and :func:`load_jax_state`
carries JAX weights across, every BatchNorm's ``_mean``/``_variance``
included (:func:`jax_state_dict` is the inverse). NCHW in, as in JAX.

Under AMP O2 the ops cast as the JAX dispatcher casts them: convolutions
bf16 (white), BatchNorms f32 (black), and ``relu``, ``concat``, the
adaptive pool, ``interpolate``, the channel ``max``, ``sigmoid``, ``silu``,
``softplus`` and the element-wise ``add``/``subtract``/``multiply`` bf16
(gray); the channel ``mean`` is black, so UAFM's mean maps are f32 until
``concat`` joins them to the bf16 max maps in bf16. An STDC block's
depthwise ``down`` (``groups = c``, no activation) hands its f32 BatchNorm
output to ``concat`` the same way.

``interpolate`` is the port's, which computes JAX's ``jax.image.resize``
(antialiased when it shrinks) as per-axis contractions; see
``nn/functional/common.py``.

PP-YOLOE's ``decode`` builds the grid centres with numpy on the host and
moves them to the model's device; ``postprocess`` reads one image's boxes
and scores back to the host and runs ``vision.ops.nms``, as the JAX
method does; ``loss`` (the center-prior assignment, simplified against the
reference's TAL as in JAX) builds its targets on the host too.

Built on ``device`` (default CUDA; raises when CUDA is absent and the
caller did not ask for the CPU) with initial values drawn from
``generator`` (default: the build generator ``paddle.seed`` seeds) by
the JAX layers' initializers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...device import DEFAULT_DEVICE
from ...models.gpt import jax_state_dict, load_jax_state, port_state_from_jax
from ...nn import functional as F
from ...nn.layer import BatchNorm2D, Conv2D, LayerList, Sequential
from ...nn.layer.layers import Layer, building
from ...ops.manipulation import concat, reshape, stack, transpose
from ...ops.math import add, max as pmax, mean as pmean, multiply, subtract

__all__ = ["CSPStage", "ConvBNReLU", "PPLiteSeg", "PPYOLOE", "PPYOLOEHead",
           "RepConvBlock", "SPPM", "STDCBlock", "STDCNet", "UAFM",
           "jax_state_dict", "load_jax_state", "port_state_from_jax",
           "pp_liteseg", "pp_yoloe"]


class ConvBNReLU(Layer):
    def __init__(self, c_in, c_out, k=3, stride=1, groups=1, act=True, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with building(self, device, generator):
            self.conv = Conv2D(c_in, c_out, k, stride=stride, padding=k // 2,
                               groups=groups, bias_attr=False)
            self.bn = BatchNorm2D(c_out)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class STDCBlock(Layer):
    """Short-Term Dense Concatenate block: a 1x1 conv, at stride 2 a
    depthwise 3x3 ``down``, then two halving 3x3 convs; the three outputs
    concatenate on the channels."""

    def __init__(self, c_in, c_out, stride=1, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = c_out // 2
        with building(self, device, generator):
            self.conv1 = ConvBNReLU(c_in, c, k=1)
            self.down = (ConvBNReLU(c, c, k=3, stride=2, groups=c, act=False)
                         if stride == 2 else None)
            self.conv2 = ConvBNReLU(c, c // 2, k=3)
            self.conv3 = ConvBNReLU(c // 2, c // 2, k=3)

    def forward(self, x):
        x1 = self.conv1(x)
        x1d = self.down(x1) if self.down is not None else x1
        x2 = self.conv2(x1d)
        x3 = self.conv3(x2)
        return concat([x1d, x2, x3], 1)


class STDCNet(Layer):
    """The 3-stage STDC encoder: features at 1/8, 1/16 and 1/32."""

    def __init__(self, base=32, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with building(self, device, generator):
            self.stem = Sequential(ConvBNReLU(3, base // 2, stride=2),
                                   ConvBNReLU(base // 2, base, stride=2))
            self.stage3 = STDCBlock(base, base * 4, stride=2)
            self.stage4 = STDCBlock(base * 4, base * 8, stride=2)
            self.stage5 = STDCBlock(base * 8, base * 16, stride=2)
        self.out_channels = [base * 4, base * 8, base * 16]

    def forward(self, x):
        x = self.stem(x)
        f8 = self.stage3(x)
        f16 = self.stage4(f8)
        f32 = self.stage5(f16)
        return [f8, f16, f32]


class SPPM(Layer):
    """Simple Pyramid Pooling Module: adaptive average pools to each of
    ``bins``, a 1x1 reduce each, bilinear back to the input's size, summed,
    then a 3x3 fuse."""

    def __init__(self, c_in, c_mid, c_out, bins=(1, 2, 4), *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bins = bins
        with building(self, device, generator):
            self.reduces = LayerList(
                [ConvBNReLU(c_in, c_mid, k=1) for _ in bins])
            self.fuse = ConvBNReLU(c_mid, c_out, k=3)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        acc = None
        for bin_size, reduce in zip(self.bins, self.reduces):
            p = F.adaptive_avg_pool2d(x, bin_size)
            p = reduce(p)
            p = F.interpolate(p, size=[h, w], mode="bilinear",
                              align_corners=False)
            acc = p if acc is None else add(acc, p)
        return self.fuse(acc)


class UAFM(Layer):
    """Unified Attention Fusion Module (spatial form): the deep feature,
    upsampled to the skip's size, and the skip blend by an attention map
    from their channel mean and max maps."""

    def __init__(self, c_skip, c_up, c_out, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with building(self, device, generator):
            self.proj_skip = ConvBNReLU(c_skip, c_out, k=3)
            self.proj_up = ConvBNReLU(c_up, c_out, k=1)
            self.attn = Sequential(ConvBNReLU(4, 2, k=3),
                                   Conv2D(2, 1, 3, padding=1))

    def forward(self, skip, deep):
        skip = self.proj_skip(skip)
        deep = self.proj_up(deep)
        deep = F.interpolate(deep, size=[skip.shape[2], skip.shape[3]],
                             mode="bilinear", align_corners=False)
        feats = []
        for t in (skip, deep):
            feats.append(pmean(t, axis=1, keepdim=True))
            feats.append(pmax(t, axis=1, keepdim=True))
        alpha = F.sigmoid(self.attn(concat(feats, 1)))
        return add(multiply(skip, alpha),
                   multiply(deep, subtract(1, alpha)))


class PPLiteSeg(Layer):
    """PP-LiteSeg: STDC encoder → SPPM context → two UAFM fusions of
    decreasing width → a seg head → bilinear to the input's size."""

    def __init__(self, num_classes=19, base=32, decoder_channels=(64, 32), *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with building(self, device, generator):
            self.backbone = STDCNet(base)
            c8, c16, c32 = self.backbone.out_channels
            d16, d8 = decoder_channels
            self.sppm = SPPM(c32, c32 // 2, d16)
            self.fuse16 = UAFM(c16, d16, d16)
            self.fuse8 = UAFM(c8, d16, d8)
            self.head = Sequential(ConvBNReLU(d8, d8),
                                   Conv2D(d8, num_classes, 1))

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        f8, f16, f32 = self.backbone(x)
        ctx = self.sppm(f32)
        d16 = self.fuse16(f16, ctx)
        d8 = self.fuse8(f8, d16)
        logits = self.head(d8)
        return F.interpolate(logits, size=[h, w], mode="bilinear",
                             align_corners=False)


def pp_liteseg(num_classes=19, **kw):
    return PPLiteSeg(num_classes=num_classes, **kw)


# ------------------------------------------------------------------ PP-YOLOE

class RepConvBlock(Layer):
    """CSPRep-style unit in its deploy form: 3x3 and 1x1 branches summed,
    BatchNorm, SiLU."""

    def __init__(self, c_in, c_out, stride=1, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with building(self, device, generator):
            self.conv3 = Conv2D(c_in, c_out, 3, stride=stride, padding=1,
                                bias_attr=False)
            self.conv1 = Conv2D(c_in, c_out, 1, stride=stride,
                                bias_attr=False)
            self.bn = BatchNorm2D(c_out)

    def forward(self, x):
        return F.silu(self.bn(add(self.conv3(x), self.conv1(x))))


class CSPStage(Layer):
    def __init__(self, c_in, c_out, n=1, stride=2, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with building(self, device, generator):
            self.down = ConvBNReLU(c_in, c_out, k=3, stride=stride)
            self.blocks = Sequential(
                *[RepConvBlock(c_out, c_out) for _ in range(n)])

    def forward(self, x):
        return self.blocks(self.down(x))


class PPYOLOEHead(Layer):
    """Decoupled per-scale head: class logits ``[B, A, C]`` and positive
    ``l/t/r/b`` distances ``[B, A, 4]`` from the grid centres."""

    def __init__(self, c_in, num_classes, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with building(self, device, generator):
            self.cls_conv = ConvBNReLU(c_in, c_in)
            self.reg_conv = ConvBNReLU(c_in, c_in)
            self.cls_pred = Conv2D(c_in, num_classes, 1)
            self.reg_pred = Conv2D(c_in, 4, 1)

    def forward(self, feat):
        b = feat.shape[0]
        cls = self.cls_pred(self.cls_conv(feat))
        reg = self.reg_pred(self.reg_conv(feat))
        c = cls.shape[1]
        cls = transpose(reshape(cls, [b, c, -1]), [0, 2, 1])
        reg = transpose(reshape(reg, [b, 4, -1]), [0, 2, 1])
        return cls, F.softplus(reg)


class PPYOLOE(Layer):
    """PP-YOLOE-style anchor-free detector over scales 1/8, 1/16, 1/32:
    ``forward`` gives each scale's (class logits, ltrb); ``decode`` turns
    them into ``[B, A, 4]`` xyxy boxes and ``[B, A, C]`` scores;
    ``postprocess`` thresholds one image and runs class-aware NMS;
    ``loss`` is the center-prior assignment loss."""

    STRIDES = (8, 16, 32)

    def __init__(self, num_classes=80, base=32, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        w = base * 4
        with building(self, device, generator):
            self.stem = ConvBNReLU(3, base, stride=2)
            self.c2 = CSPStage(base, base * 2)
            self.c3 = CSPStage(base * 2, base * 4)
            self.c4 = CSPStage(base * 4, base * 8)
            self.c5 = CSPStage(base * 8, base * 16)
            self.lat3 = ConvBNReLU(base * 4, w, k=1)
            self.lat4 = ConvBNReLU(base * 8, w, k=1)
            self.lat5 = ConvBNReLU(base * 16, w, k=1)
            self.heads = LayerList(
                [PPYOLOEHead(w, num_classes) for _ in self.STRIDES])

    def forward(self, x):
        x = self.c2(self.stem(x))
        f3 = self.c3(x)
        f4 = self.c4(f3)
        f5 = self.c5(f4)
        p5 = self.lat5(f5)
        p4 = add(self.lat4(f4), F.interpolate(
            p5, size=[f4.shape[2], f4.shape[3]], mode="nearest"))
        p3 = add(self.lat3(f3), F.interpolate(
            p4, size=[f3.shape[2], f3.shape[3]], mode="nearest"))
        return [head(p) for head, p in zip(self.heads, (p3, p4, p5))]

    def _device(self):
        return next(iter(self.parameters())).device

    def _centers(self, shapes):
        out = []
        for (h, w), s in zip(shapes, self.STRIDES):
            ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            c = np.stack([(xs + 0.5) * s, (ys + 0.5) * s], -1).reshape(-1, 2)
            out.append(c.astype(np.float32))
        return out

    def decode(self, outputs, feat_shapes):
        """Per-scale (cls, ltrb) → (boxes ``[B, A, 4]`` xyxy, scores
        ``[B, A, C]``)."""
        dev = self._device()
        boxes, scores = [], []
        for (cls, ltrb), ctr, s in zip(outputs, self._centers(feat_shapes),
                                       self.STRIDES):
            c = torch.from_numpy(ctr).to(dev)
            d = multiply(ltrb, float(s))
            x1 = subtract(c[:, 0], d[:, :, 0])
            y1 = subtract(c[:, 1], d[:, :, 1])
            x2 = add(c[:, 0], d[:, :, 2])
            y2 = add(c[:, 1], d[:, :, 3])
            boxes.append(stack([x1, y1, x2, y2], -1))
            scores.append(F.sigmoid(cls))
        return concat(boxes, 1), concat(scores, 1)

    def postprocess(self, boxes, scores, score_thresh=0.25, iou_thresh=0.5,
                    top_k=100):
        """One image's post-process on the host, as the JAX method's:
        returns (kept_boxes, kept_scores, kept_classes) numpy arrays."""
        from ..ops import nms

        b = boxes.detach()[0].float().cpu().numpy()
        s = scores.detach()[0].float().cpu().numpy()
        cls_id = s.argmax(-1)
        conf = s.max(-1)
        keep_mask = conf >= score_thresh
        if not keep_mask.any():
            return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                    np.zeros((0,), np.int64))
        idx = np.nonzero(keep_mask)[0]
        kept = nms(torch.from_numpy(b[idx]), iou_thresh,
                   scores=torch.from_numpy(conf[idx]),
                   category_idxs=torch.from_numpy(
                       cls_id[idx].astype(np.int64)),
                   categories=list(range(self.num_classes)), top_k=top_k)
        sel = idx[kept.numpy()]
        return b[sel], conf[sel], cls_id[sel].astype(np.int64)

    def loss(self, outputs, feat_shapes, gt_boxes, gt_classes):
        """Center-prior assignment loss: anchors whose centre falls inside
        a gt box are its positives; BCE on the class scores plus L1 on the
        ltrb distances over the stride. The targets are built on the host,
        as in JAX."""
        centers = np.concatenate(self._centers(feat_shapes), 0)
        strides = np.concatenate(
            [np.full((h * w,), s, np.float32)
             for (h, w), s in zip(feat_shapes, self.STRIDES)])
        cls_t = np.zeros((centers.shape[0], self.num_classes), np.float32)
        reg_t = np.zeros((centers.shape[0], 4), np.float32)
        pos = np.zeros((centers.shape[0],), np.float32)
        for box, cid in zip(np.asarray(gt_boxes), np.asarray(gt_classes)):
            x1, y1, x2, y2 = box
            inside = ((centers[:, 0] > x1) & (centers[:, 0] < x2)
                      & (centers[:, 1] > y1) & (centers[:, 1] < y2))
            pos[inside] = 1.0
            cls_t[inside, int(cid)] = 1.0
            reg_t[inside] = np.stack([
                (centers[inside, 0] - x1), (centers[inside, 1] - y1),
                (x2 - centers[inside, 0]), (y2 - centers[inside, 1])], -1)
            reg_t[inside] /= strides[inside, None]
        dev = self._device()
        cls_all = concat([o[0] for o in outputs], 1)
        reg_all = concat([o[1] for o in outputs], 1)
        tgt_c = torch.from_numpy(cls_t).to(dev)[None]
        tgt_r = torch.from_numpy(reg_t).to(dev)[None]
        w_pos = torch.from_numpy(pos).to(dev)[None]
        cls_loss = F.binary_cross_entropy_with_logits(cls_all, tgt_c)
        reg_loss = (subtract(reg_all, tgt_r).abs().sum(-1) * w_pos).sum() / (
            w_pos.sum() + 1.0)
        return cls_loss + reg_loss


def pp_yoloe(num_classes=80, **kw):
    return PPYOLOE(num_classes=num_classes, **kw)
