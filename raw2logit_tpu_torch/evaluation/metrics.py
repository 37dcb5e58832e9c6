"""Confusion-matrix metrics with mean/std over runs (the port's own copy
of ``raw2logit_tpu/evaluation/metrics.py``, which is numpy only)."""

import numpy as np


class ConfusionMetrics:
    """Accumulate a multi-class confusion matrix; derive accuracy /
    precision / recall / F1, plus mean/std aggregation over repeated runs."""

    def __init__(self, n_classes):
        self.n_classes = n_classes
        self.matrix = np.zeros((n_classes, n_classes), np.int64)

    def update(self, preds, labels):
        preds = np.asarray(preds).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        for p, t in zip(preds, labels):
            self.matrix[int(t), int(p)] += 1

    @property
    def accuracy(self):
        total = self.matrix.sum()
        return float(np.trace(self.matrix)) / total if total else 0.0

    def _per_class(self):
        tp = np.diag(self.matrix).astype(float)
        fp = self.matrix.sum(axis=0) - tp
        fn = self.matrix.sum(axis=1) - tp
        precision = np.divide(tp, tp + fp, out=np.zeros_like(tp),
                              where=(tp + fp) > 0)
        recall = np.divide(tp, tp + fn, out=np.zeros_like(tp),
                           where=(tp + fn) > 0)
        f1 = np.divide(2 * precision * recall, precision + recall,
                       out=np.zeros_like(tp),
                       where=(precision + recall) > 0)
        return precision, recall, f1

    @property
    def precision(self):
        return float(self._per_class()[0].mean())

    @property
    def recall(self):
        return float(self._per_class()[1].mean())

    @property
    def f1(self):
        return float(self._per_class()[2].mean())

    def summary(self):
        return {"accuracy": self.accuracy, "precision": self.precision,
                "recall": self.recall, "f1": self.f1}


def over_n_runs(summaries):
    """mean/std per metric over repeated fold-runs (ABtesting.py:93-104;
    the reference uses the sample std, sqrt(sum((x-mu)^2)/(N-1)))."""
    keys = summaries[0].keys()
    out = {"n_runs": len(summaries)}
    for k in keys:
        vals = np.asarray([s[k] for s in summaries], float)
        out[f"{k}_mean"] = float(vals.mean())
        out[f"{k}_std"] = (float(vals.std(ddof=1)) if len(vals) > 1 else 0.0)
    return out
