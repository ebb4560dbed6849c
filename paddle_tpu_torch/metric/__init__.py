"""Metrics — port of ``paddle_tpu/metric/__init__.py`` (``:14-164``):
the ``Metric`` base, ``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and
``accuracy``. They run on the host in numpy, as the reference's do: a
tensor argument (on any device) is brought to the host first.
``accuracy`` returns a 0-d float32 CPU tensor."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
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
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        idx = np.argsort(-pred, axis=-1)[..., :self.maxk]
        if label.ndim == pred.ndim:
            label = np.argmax(label, axis=-1)
        return idx == label[..., None]

    def update(self, correct, *args):
        correct = _np(correct)
        num = correct.shape[0] if correct.ndim else 1
        accs = []
        for k in self.topk:
            c = correct[..., :k].any(axis=-1).sum()
            self.total[self.topk.index(k)] += int(c)
            self.count[self.topk.index(k)] += num
            accs.append(c / max(num, 1))
        return np.array(accs[0] if len(accs) == 1 else accs)

    def reset(self):
        self.total = [0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

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
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = np.rint(_np(preds)).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bins = np.minimum((pos_prob * self.num_thresholds).astype(np.int64),
                          self.num_thresholds - 1)
        for b, lab in zip(bins, labels):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, np.int64)

    def accumulate(self):
        # ascending scan: each positive in bin i pairs with every negative
        # in a lower bin (plus half the same-bin ties): the Mann-Whitney
        # statistic
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds):
            pos, neg = self._stat_pos[i], self._stat_neg[i]
            auc += tot_neg * pos + pos * neg / 2.0
            tot_pos += pos
            tot_neg += neg
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    pred = _np(input)
    lbl = _np(label).reshape(-1)
    idx = np.argsort(-pred, axis=-1)[:, :k]
    c = (idx == lbl[:, None]).any(axis=1).mean()
    return torch.tensor(np.asarray(c, np.float32))
