"""Metrics (counterpart: ``paddle_tpu/metric/__init__.py``). They
accumulate on the host in numpy, as the JAX package's do: ``compute``
and ``update`` read their tensors off the device."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pred_np, label_np = _np(pred), _np(label)
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.squeeze(-1)
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        return topk_idx == label_np[..., None]

    def update(self, correct, *args):
        correct = _np(correct)
        accs = []
        n = correct.shape[0]
        for i, k in enumerate(self.topk):
            c = correct[..., :k].sum()
            self.total[i] += float(c)
            self.count[i] += n
            accs.append(float(c) / n if n else 0.0)
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        labels = _np(labels).reshape(-1)
        pred_lab = (_np(preds).reshape(-1) > 0.5).astype(np.int32)
        self.tp += int(((pred_lab == 1) & (labels == 1)).sum())
        self.fp += int(((pred_lab == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        labels = _np(labels).reshape(-1)
        pred_lab = (_np(preds).reshape(-1) > 0.5).astype(np.int32)
        self.tp += int(((pred_lab == 1) & (labels == 1)).sum())
        self.fn += int(((pred_lab == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over ``num_thresholds`` bins of the positive probability
    (column 1 of a ``[N, 2]`` prediction, else the prediction itself)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bins = np.clip((pos_prob * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds)
        np.add.at(self._stat_pos, bins[labels != 0], 1)
        np.add.at(self._stat_neg, bins[labels == 0], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        return float(np.trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the ``k`` largest entries of
    ``input``, a 0-d float32 tensor on ``input``'s device."""
    topk_idx = torch.argsort(input, dim=-1, descending=True)[..., :k]
    lab = label.squeeze(-1) if label.ndim == input.ndim else label
    hit = (topk_idx == lab.unsqueeze(-1)).any(dim=-1)
    return hit.float().mean()
