"""Metric aggregation, the port of ``vtc_tpu/training/metrics.py:39-177``.

The result keys are the reference's (``"{b}_from_{a}-recall_at_{k}"``,
``model/metric.py:176-179``): a config's ``monitor`` names one. Metrics are
plain objects with ``reset``/``update``/``result`` and ``is_train``/
``is_val`` routing flags; the tracker owns the TensorBoard emission.
``RecallAtK`` keeps each batch's features on the device that made them and
ranks them there (``ops.retrieval.recall_at_k``) at the epoch's end. Under
a process group it is fed the features of the global batch, gathered over
the ranks by ``step.eval_step``, so every rank logs the R@K that one
device computes on the whole validation set, and every rank ranks alike.
"""

from __future__ import annotations

import logging
from typing import Iterable

import torch

from ..ops.retrieval import recall_at_k

logger = logging.getLogger(__name__)


class MetricTracker:
    """Composes metrics by name and routes writer emission.

    ``update`` feeds every metric one batch; metrics that return a per-batch
    scalar get it written to TensorBoard immediately (the reference's
    per-batch scalar stream), while dict-valued epoch results are written at
    ``result()`` time for metrics that opt in via ``emit_result_scalars``.
    """

    def __init__(self, *metrics):
        self.metrics = {}
        self._writer = None
        for m in metrics:
            self.add_metric(m)
        self.reset()

    def add_metric(self, metric):
        self.metrics[metric.name] = metric

    def set_writer(self, writer):
        self._writer = writer

    def reset(self):
        for m in self.metrics.values():
            m.reset()

    def update(self, loss, output, meta):
        for m in self.metrics.values():
            per_batch = m.update(loss, output, meta)
            if per_batch is not None and self._writer is not None:
                self._writer.add_scalar(m.name, per_batch)

    def result(self):
        res = {}
        for m in self.metrics.values():
            part = m.result()
            res.update(part)
            if getattr(m, "emit_result_scalars", False) and self._writer:
                for key, value in part.items():
                    self._writer.add_scalar(key, value)
        return res


class ScalarPerBatchMetric:
    """Running mean of a per-batch scalar ``fn(loss, output, meta)``."""

    is_train = True
    is_val = True
    emit_result_scalars = False

    def __init__(self, name, metric_fun):
        self.name = name
        self.fun = metric_fun
        self.reset()

    def reset(self):
        self._total = 0.0
        self._count = 0

    def update(self, loss, output, meta, n: int = 1):
        value = float(self.fun(loss, output, meta))
        self._total += value * n
        self._count += n
        return value  # per-batch stream for the tracker's writer

    def avg(self):
        return self._total / max(self._count, 1)

    def result(self):
        return {self.name: self.avg()}


def LossMetric() -> ScalarPerBatchMetric:
    """The per-batch loss stream (reference ``LossMetric``)."""
    return ScalarPerBatchMetric("loss", lambda loss, output, meta: loss)


class RecallAtK:
    """Accumulates (feats_a, feats_b) per batch; at epoch end computes
    bidirectional R@K. Gallery/query contract and result keys match
    ``model/metric.py:137-179``."""

    is_train = False
    is_val = True
    emit_result_scalars = True
    name = "recall@k"

    def __init__(self, name_a, name_b, k_vals=5):
        if not isinstance(k_vals, Iterable):
            k_vals = [k_vals]
        self.k_vals = list(k_vals)
        self.name_a = name_a
        self.name_b = name_b
        self.reset()

    def reset(self):
        self._feats_a = []
        self._feats_b = []

    def update(self, loss, output, meta):
        self._feats_a.append(output[0].detach())
        self._feats_b.append(output[1].detach())
        return None  # no per-batch scalar

    def compute(self, features_a, features_b):
        """Gallery ``features_a``, queries ``features_b`` -> [(k, recall)]."""
        return recall_at_k(features_a, features_b, self.k_vals)

    def features(self):
        """The epoch's (feats_a, feats_b), concatenated."""
        return torch.cat(self._feats_a), torch.cat(self._feats_b)

    def result(self):
        if not self._feats_a:
            logger.warning(
                "RecallAtK: no batches accumulated (validation set smaller "
                "than the batch size with drop_last?); skipping"
            )
            return {}
        feats_a, feats_b = self.features()
        res = {}
        for gallery, query, ga, qb in (
            (feats_a, feats_b, self.name_a, self.name_b),
            (feats_b, feats_a, self.name_b, self.name_a),
        ):
            for k, recall in self.compute(gallery, query):
                res[f"{qb}_from_{ga}-recall_at_{k}"] = recall
        return res


METRICS = {
    "MetricTracker": MetricTracker,
    "ScalarPerBatchMetric": ScalarPerBatchMetric,
    "LossMetric": LossMetric,
    "RecallAtK": RecallAtK,
}
