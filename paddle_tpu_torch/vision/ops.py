"""Detection ops (port of ``paddle_tpu/vision/ops.py:18-70``): the pairwise
IoU matrix and greedy, optionally class-aware, non-maximum suppression.

The JAX ``nms`` computes the IoU of the boxes sorted by score and sweeps
them with ``lax.fori_loop``: a box is kept when no kept box of a higher
score overlaps it by more than the threshold. With ``category_idxs`` each
box is first shifted by its category times the span of all coordinates,
so boxes of different categories never overlap (the batched-NMS offset
trick). The port computes the IoU matrix on the boxes' device in torch and
runs the sweep on the host over that matrix (one pass over the boxes, as
the JAX loop's), then cuts the kept indices to ``top_k``; the JAX function
reads its count back to the host too. The indices come back in score
order, ties in the input order (a stable sort, as ``jnp.argsort``), as an
int64 tensor on the boxes' device.

``roi_align``, ``box_coder`` and ``yolo_box`` are vectorised over the
boxes on their device, with no loop over boxes and no host read:

- ``roi_align`` samples each bin on a ``ratio × ratio`` grid (``ratio`` =
  ``sampling_ratio``, 2 when it is not positive, as in JAX), each sample
  the bilinear blend of its four neighbours (a neighbour outside the map
  weighs 0), added corner by corner in the JAX order, and averages the
  grid. The gathers index the map channels-last, ``[R, ph, pw, r, r,
  C]``, so no per-box copy of an image is made.
- ``box_coder`` encodes rows against priors row by row and decodes
  center-size deltas, as the JAX function does; the port adds upstream
  Paddle's ``axis`` for a decode of ``[N, M, 4]`` deltas against ``[M,
  4]`` priors (``axis=0``) or ``[N, 4]`` ones (``axis=1``), and a variance
  given as four floats. The JAX function accepts ``axis`` and reads it
  nowhere.
- ``yolo_box`` decodes one YOLO head as the JAX function does; the port
  adds upstream Paddle's ``iou_aware`` (the head's first ``na`` channels
  predict each anchor's IoU, and the confidence is ``obj^(1 − f) ·
  iou^f``, ``f`` = ``iou_aware_factor``), which JAX lacks.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["box_coder", "nms", "roi_align", "yolo_box"]


def _iou_matrix(boxes):
    """``[N, 4]`` x1y1x2y2 → ``[N, N]`` IoU."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    union = area[:, None] + area[None, :] - inter
    return inter / torch.clamp_min(union, 1e-10)


@torch.no_grad()
def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Greedy NMS: the indices of the kept boxes, highest score first
    (without ``scores``, the input order). With ``category_idxs``,
    suppression is per category. ``categories`` is accepted and read
    nowhere, as in JAX."""
    n = boxes.shape[0]
    s = (scores if scores is not None
         else torch.arange(n, 0, -1, dtype=torch.float32,
                           device=boxes.device))
    bb = boxes
    if category_idxs is not None:
        span = boxes.max() - boxes.min() + 1.0
        bb = boxes + (category_idxs.to(boxes.dtype) * span)[:, None]
    order = torch.argsort(-s, stable=True)
    iou = _iou_matrix(bb)[order][:, order]
    over = (iou > iou_threshold).cpu().numpy()
    keep = np.ones(n, bool)
    for i in range(1, n):
        keep[i] = not (over[i, :i] & keep[:i]).any()
    kept = order[torch.from_numpy(np.nonzero(keep)[0]).to(order.device)]
    if top_k is not None:
        kept = kept[:top_k]
    return kept


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign: ``x`` ``[N, C, H, W]``, ``boxes`` ``[R, 4]`` (x1, y1, x2,
    y2) grouped by image, ``boxes_num`` ``[N]`` boxes an image; returns
    ``[R, C, ph, pw]``."""
    ph, pw = ((output_size, output_size) if isinstance(output_size, int)
              else tuple(output_size))
    _, c, h, w = x.shape
    r = boxes.shape[0]
    dev = x.device
    ends = torch.cumsum(torch.as_tensor(boxes_num, device=dev), 0)
    img = (torch.arange(r, device=dev)[:, None] >= ends[None, :]).sum(1)
    off = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (boxes[:, i] * spatial_scale - off for i in range(4))
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw, rh = torch.clamp_min(rw, 1.0), torch.clamp_min(rh, 1.0)
    bin_w, bin_h = rw / pw, rh / ph
    ratio = sampling_ratio if sampling_ratio > 0 else 2
    grid = torch.arange(ratio, device=dev, dtype=x.dtype) + 0.5
    iy = (torch.arange(ph, device=dev)[None, :, None] * bin_h[:, None, None]
          + y1[:, None, None] + grid[None, None, :] * bin_h[:, None, None]
          / ratio)  # [R, ph, ratio]
    ix = (torch.arange(pw, device=dev)[None, :, None] * bin_w[:, None, None]
          + x1[:, None, None] + grid[None, None, :] * bin_w[:, None, None]
          / ratio)  # [R, pw, ratio]
    ys = iy[:, :, None, :, None].expand(r, ph, pw, ratio, ratio)
    xs = ix[:, None, :, None, :].expand(r, ph, pw, ratio, ratio)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    hwc = x.permute(0, 2, 3, 1)
    n_idx = img[:, None, None, None, None]
    out = 0.0
    for dy, wy in ((0, 1 - wy1), (1, wy1)):
        for dx, wx in ((0, 1 - wx1), (1, wx1)):
            yy, xx = (y0 + dy).long(), (x0 + dx).long()
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            weight = torch.where(valid, wy * wx, 0.0)
            val = hwc[n_idx, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
            out = out + weight[..., None] * val  # [R, ph, pw, r, r, C]
    return out.mean(dim=(3, 4)).permute(0, 3, 1, 2)


def _variance(var, like):
    if var is None or isinstance(var, torch.Tensor):
        return var
    return torch.as_tensor(var, dtype=like.dtype, device=like.device)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    """Encode ``target_box`` ``[N, 4]`` against ``prior_box`` row by row
    (``encode_center_size``), or decode center-size deltas
    (``decode_center_size``): ``[N, 4]`` row by row, or ``[N, M, 4]``
    against ``[M, 4]`` priors (``axis=0``) or ``[N, 4]`` ones
    (``axis=1``). ``prior_box_var`` is a tensor of the priors' shape, four
    floats, or None."""
    norm = 0.0 if box_normalized else 1.0
    var = _variance(prior_box_var, prior_box)
    if target_box.dim() == 3 and code_type == "decode_center_size":
        prior_box = prior_box[None] if axis == 0 else prior_box[:, None]
        if var is not None and var.dim() == 2:
            var = var[None] if axis == 0 else var[:, None]
    pw = prior_box[..., 2] - prior_box[..., 0] + norm
    ph = prior_box[..., 3] - prior_box[..., 1] + norm
    pcx = prior_box[..., 0] + pw * 0.5
    pcy = prior_box[..., 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = target_box[..., 2] - target_box[..., 0] + norm
        th = target_box[..., 3] - target_box[..., 1] + norm
        tcx = target_box[..., 0] + tw * 0.5
        tcy = target_box[..., 1] + th * 0.5
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], dim=-1)
        return out / var if var is not None else out
    if code_type != "decode_center_size":
        raise ValueError(f"box_coder code_type {code_type!r}")
    d = target_box * var if var is not None else target_box
    cx = d[..., 0] * pw + pcx
    cy = d[..., 1] * ph + pcy
    bw = torch.exp(d[..., 2]) * pw
    bh = torch.exp(d[..., 3]) * ph
    return torch.stack([cx - bw * 0.5, cy - bh * 0.5, cx + bw * 0.5 - norm,
                        cy + bh * 0.5 - norm], dim=-1)


def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, name=None, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5):
    """Decode one YOLO head ``x`` ``[N, na·(5 + class_num), H, W]`` (``na
    ·(6 + class_num)`` with ``iou_aware``) for images of ``img_size``
    ``[N, 2]`` (h, w): ``(boxes [N, H·W·na, 4], scores [N, H·W·na,
    class_num])``, scores 0 where the confidence is at most
    ``conf_thresh``."""
    na = len(anchors) // 2
    n, _, h, w = x.shape
    dev = x.device
    if iou_aware:
        iou = torch.sigmoid(x[:, :na])
        x = x[:, na:]
    p = x.reshape(n, na, 5 + class_num, h, w)
    grid_x = torch.arange(w, device=dev)[None, None, None, :]
    grid_y = torch.arange(h, device=dev)[None, None, :, None]
    sx = torch.sigmoid(p[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
    sy = torch.sigmoid(p[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
    bx = (grid_x + sx) / w
    by = (grid_y + sy) / h
    aw = torch.tensor(anchors[0::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    ah = torch.tensor(anchors[1::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    bw = torch.exp(p[:, :, 2]) * aw / (w * downsample_ratio)
    bh = torch.exp(p[:, :, 3]) * ah / (h * downsample_ratio)
    conf = torch.sigmoid(p[:, :, 4])
    if iou_aware:
        conf = conf ** (1.0 - iou_aware_factor) * iou ** iou_aware_factor
    cls = torch.sigmoid(p[:, :, 5:]) * conf[:, :, None]
    cls = torch.where(conf[:, :, None] > conf_thresh, cls, 0.0)
    img_h = img_size[:, 0].float()[:, None, None, None]
    img_w = img_size[:, 1].float()[:, None, None, None]
    x1, y1 = (bx - bw / 2) * img_w, (by - bh / 2) * img_h
    x2, y2 = (bx + bw / 2) * img_w, (by + bh / 2) * img_h
    if clip_bbox:
        zero = torch.zeros((), device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), img_w - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), img_h - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), img_w - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, -1, 4)
    scores = cls.movedim(2, -1).reshape(n, -1, class_num)
    return boxes, scores
