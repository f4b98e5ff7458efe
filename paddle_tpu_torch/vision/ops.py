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

``roi_align``, ``box_coder`` and ``yolo_box`` are not ported yet
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["nms"]


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
