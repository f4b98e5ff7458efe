"""Metrics (port of ``paddle_tpu/metric/metrics.py``; reference:
python/paddle/metric/metrics.py — Metric base with
compute/update/accumulate/reset/name, Accuracy, Precision, Recall, Auc).

Host-side numpy accumulation, as in the JAX package: metric state is tiny,
so it stays off the card; a tensor handed in is read to the host once
(``_to_numpy``), in its own dtype but bf16, which numpy lacks without
``ml_dtypes``: that comes as f32, which holds every bf16 value exactly."""
from __future__ import annotations

import numpy as np
import torch


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _argsort_desc(rows: np.ndarray, bf16: bool) -> np.ndarray:
    """``np.argsort(-rows, axis=-1)`` as numpy orders the rows' own dtype.
    numpy sorts a bf16 array (``ml_dtypes``) through its generic sort, the
    one it uses for Python objects, and not through the SIMD sorts of its
    own float types, which order ties differently; so bf16 rows (here as
    float32, which holds every bf16 value) are ranked as objects."""
    if bf16:
        rows = rows.astype(np.float64).astype(object)
    return np.argsort(-rows, axis=-1)


def _top_order(pred: torch.Tensor, k: int) -> np.ndarray:
    """The first ``k`` indices of ``np.argsort(-pred, axis=-1)`` over the
    host copy of ``pred`` in its own dtype. A row whose ``k + 1`` highest
    scores are all distinct (and free of NaN) has those first ``k`` fixed
    whatever the sort does with ties: ``torch.topk`` gives them where
    ``pred`` lies. Only the other rows, where a tie can move an index into
    or within the first ``k``, are copied to the host and sorted as the
    reference sorts them."""
    pred = pred.detach()
    lead, n = pred.shape[:-1], pred.shape[-1]
    flat = pred.reshape(-1, n)
    bf16 = pred.dtype == torch.bfloat16
    if k >= n or flat.shape[0] == 0:
        return _argsort_desc(_to_numpy(flat), bf16)[:, :k].reshape(
            *lead, min(k, n))
    # f32 holds every bf16 and fp16 value; f64 stays f64
    exact = flat if flat.dtype in (torch.float32, torch.float64) \
        else flat.float()
    vals, idx = torch.topk(exact, k + 1, dim=-1)
    clear = (vals[:, :-1] > vals[:, 1:]).all(-1)
    if exact.is_floating_point():
        clear &= ~torch.isnan(exact).any(-1)
    order = idx[:, :k].cpu().numpy()
    tied = np.flatnonzero(~clear.cpu().numpy())
    if tied.size:
        rows = _to_numpy(flat[torch.from_numpy(tied).to(flat.device)])
        order[tied] = _argsort_desc(rows, bf16)[:, :k]
    return order.reshape(*lead, k)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional pre-processing of (pred, label) before update; default
        passthrough (reference Metric.compute)."""
        return args


class Accuracy(Metric):
    """top-k accuracy (reference metrics.py::Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """Whether each of the ``maxk`` highest scores is the label, as
        f32 numpy ``[..., maxk]``, in the order of ``np.argsort(-pred)``
        over the host array in its own dtype, as the JAX package ranks, so
        tied scores come in its order (:func:`_top_order`)."""
        if isinstance(pred, torch.Tensor):
            order = _top_order(pred, self.maxk)
            ndim = pred.dim()
        else:
            pred = _to_numpy(pred)
            order = np.argsort(-pred, axis=-1)[..., : self.maxk]
            ndim = pred.ndim
        label = _to_numpy(label)
        if label.ndim == ndim:  # one-hot / soft labels
            label = label.argmax(-1)
        correct = order == label[..., None]
        return correct.astype(np.float32)

    def update(self, correct, *args):
        correct = _to_numpy(correct)
        accs = []
        for k in self.topk:
            num = correct[..., :k].sum()
            accs.append(num / max(correct.shape[0], 1))
            self.total[self.topk.index(k)] += num
        self.count += correct.shape[0]
        accs = np.asarray(accs, np.float32)
        return accs[0] if len(self.topk) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = 0

    def accumulate(self):
        res = [t / self.count if self.count else 0.0 for t in self.total]
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision over thresholded probabilities (reference Precision)."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_numpy(preds).reshape(-1)
        labels = _to_numpy(labels).reshape(-1)
        pred_pos = preds > 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fp += int(np.sum(pred_pos & (labels == 0)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_numpy(preds).reshape(-1)
        labels = _to_numpy(labels).reshape(-1)
        pred_pos = preds > 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fn += int(np.sum(~pred_pos & (labels == 1)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via threshold-bucketed statistics (reference Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_numpy(preds)
        labels = _to_numpy(labels).reshape(-1)
        if preds.ndim == 2:  # [N, 2] class probabilities -> positive prob
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(int), 0, self.num_thresholds)
        np.add.at(self._stat_pos, idx, labels == 1)
        np.add.at(self._stat_neg, idx, labels == 0)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.float64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.float64)

    def accumulate(self):
        tot_pos = tot_neg = area = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            area += (tot_neg + self._stat_neg[i] - tot_neg) * (tot_pos + new_pos) / 2.0
            tot_pos = new_pos
            tot_neg += self._stat_neg[i]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name
