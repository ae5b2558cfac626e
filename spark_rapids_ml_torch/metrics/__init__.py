#
# Model-quality metrics: the port's own copy of
# spark_rapids_ml_tpu/metrics/__init__.py (numpy on the host, as there).
# `EvalMetricInfo`, `MulticlassMetrics` (the Spark multiclass metrics from
# weighted confusion counts) and `RegressionMetrics` / `_SummarizerBuffer`
# (Spark's SummarizerBuffer moments of label, residual and prediction).
# The evaluators (evaluation.py) and the models' `evaluate` summaries read
# them; the formulas are Spark's MulticlassClassificationEvaluator and
# RegressionEvaluator.
#
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, Optional, Tuple

import numpy as np


class TransformEvaluateMetric(str, Enum):
    accuracy_like = "accuracy_like"
    log_loss = "log_loss"
    regression = "regression"


@dataclass
class EvalMetricInfo:
    """What a transform+evaluate pass must compute (reference
    metrics/__init__.py:20-40)."""

    eval_metric: TransformEvaluateMetric
    eps: float = 1e-15  # log-loss clamp


class MulticlassMetrics:
    """Spark MulticlassMetrics from weighted confusion counts
    (reference metrics/MulticlassMetrics.py:34-52 lists the 14 supported
    metric names).  `confusion` maps (label, prediction) -> total weight."""

    SUPPORTED = {
        "f1", "accuracy", "weightedPrecision", "weightedRecall",
        "weightedTruePositiveRate", "weightedFalsePositiveRate",
        "weightedFMeasure", "truePositiveRateByLabel",
        "falsePositiveRateByLabel", "precisionByLabel", "recallByLabel",
        "fMeasureByLabel", "hammingLoss", "logLoss",
    }

    def __init__(
        self,
        confusion: Dict[Tuple[float, float], float],
        total_log_loss: float = 0.0,
    ) -> None:
        self._conf = dict(confusion)
        self._total = sum(self._conf.values())
        self._total_log_loss = total_log_loss
        labels = {l for l, _ in self._conf} | {p for _, p in self._conf}
        self._labels = sorted(labels)

    def _tp(self, c: float) -> float:
        return self._conf.get((c, c), 0.0)

    def _count_label(self, c: float) -> float:
        return sum(v for (l, _), v in self._conf.items() if l == c)

    def _count_pred(self, c: float) -> float:
        return sum(v for (_, p), v in self._conf.items() if p == c)

    def true_positive_rate(self, c: float) -> float:
        n = self._count_label(c)
        return self._tp(c) / n if n > 0 else 0.0

    def false_positive_rate(self, c: float) -> float:
        fp = self._count_pred(c) - self._tp(c)
        denom = self._total - self._count_label(c)
        return fp / denom if denom > 0 else 0.0

    def precision(self, c: float) -> float:
        n = self._count_pred(c)
        return self._tp(c) / n if n > 0 else 0.0

    def recall(self, c: float) -> float:
        return self.true_positive_rate(c)

    def f_measure(self, c: float, beta: float = 1.0) -> float:
        p, r = self.precision(c), self.recall(c)
        b2 = beta * beta
        return (1 + b2) * p * r / (b2 * p + r) if (p + r) > 0 else 0.0

    @property
    def accuracy(self) -> float:
        return sum(self._tp(c) for c in self._labels) / self._total

    @property
    def weighted_precision(self) -> float:
        return sum(
            self.precision(c) * self._count_label(c) / self._total
            for c in self._labels
        )

    @property
    def weighted_recall(self) -> float:
        return sum(
            self.recall(c) * self._count_label(c) / self._total
            for c in self._labels
        )

    def weighted_f_measure(self, beta: float = 1.0) -> float:
        return sum(
            self.f_measure(c, beta) * self._count_label(c) / self._total
            for c in self._labels
        )

    @property
    def weighted_true_positive_rate(self) -> float:
        return self.weighted_recall

    @property
    def weighted_false_positive_rate(self) -> float:
        return sum(
            self.false_positive_rate(c) * self._count_label(c) / self._total
            for c in self._labels
        )

    @property
    def hamming_loss(self) -> float:
        return 1.0 - self.accuracy

    @property
    def log_loss(self) -> float:
        return self._total_log_loss / self._total

    def evaluate(self, metric_name: str, metric_label: float = 0.0,
                 beta: float = 1.0) -> float:
        """Dispatch by Spark MulticlassClassificationEvaluator metricName."""
        if metric_name == "f1":
            return self.weighted_f_measure(1.0)
        if metric_name == "accuracy":
            return self.accuracy
        if metric_name == "weightedPrecision":
            return self.weighted_precision
        if metric_name == "weightedRecall":
            return self.weighted_recall
        if metric_name == "weightedTruePositiveRate":
            return self.weighted_true_positive_rate
        if metric_name == "weightedFalsePositiveRate":
            return self.weighted_false_positive_rate
        if metric_name == "weightedFMeasure":
            return self.weighted_f_measure(beta)
        if metric_name == "truePositiveRateByLabel":
            return self.true_positive_rate(metric_label)
        if metric_name == "falsePositiveRateByLabel":
            return self.false_positive_rate(metric_label)
        if metric_name == "precisionByLabel":
            return self.precision(metric_label)
        if metric_name == "recallByLabel":
            return self.recall(metric_label)
        if metric_name == "fMeasureByLabel":
            return self.f_measure(metric_label, beta)
        if metric_name == "hammingLoss":
            return self.hamming_loss
        if metric_name == "logLoss":
            return self.log_loss
        raise ValueError(f"Unsupported metric: {metric_name}")

    @classmethod
    def from_predictions(
        cls,
        labels: np.ndarray,
        predictions: np.ndarray,
        weights: Optional[np.ndarray] = None,
        probabilities: Optional[np.ndarray] = None,
        eps: float = 1e-15,
    ) -> "MulticlassMetrics":
        """Build from per-row results (the worker-side partial computation,
        reference classification.py:117-158 does this with cudf groupby)."""
        w = np.ones(len(labels)) if weights is None else np.asarray(weights)
        li = np.asarray(labels, np.float64)
        pi = np.asarray(predictions, np.float64)
        # vectorized groupby: unique (label, pred) pairs + weight scatter-add
        pairs = np.stack([li, pi], axis=1)
        uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
        sums = np.zeros(len(uniq))
        np.add.at(sums, inv.reshape(-1), w)
        conf: Dict[Tuple[float, float], float] = {
            (float(l), float(p)): float(s) for (l, p), s in zip(uniq, sums)
        }
        tll = 0.0
        if probabilities is not None:
            probs = np.clip(
                np.asarray(probabilities, np.float64), eps, 1 - eps
            )
            idx = li.astype(np.int64)
            tll = float(-(w * np.log(probs[np.arange(len(idx)), idx])).sum())
        return cls(conf, tll)


class _SummarizerBuffer:
    """Spark's SummarizerBuffer moments (reference
    metrics/RegressionMetrics.py:31-152): weighted mean/m2n/m2/l1 of the
    three columns (label, label - prediction, prediction) — the same column
    layout the reference workers emit (regression.py:149-178)."""

    def __init__(
        self,
        mean: np.ndarray,  # (3,) weighted means
        m2n: np.ndarray,  # (3,) sum w (x - mean)^2
        m2: np.ndarray,  # (3,) sum w x^2
        l1: np.ndarray,  # (3,) sum w |x|
        total_cnt: float,
        weight_sum: float,
    ) -> None:
        self.mean = np.asarray(mean, np.float64)
        self.m2n = np.asarray(m2n, np.float64)
        self.m2 = np.asarray(m2, np.float64)
        self.l1 = np.asarray(l1, np.float64)
        self.total_cnt = float(total_cnt)
        self.weight_sum = float(weight_sum)


class RegressionMetrics:
    """Spark RegressionMetrics from summarizer moments (formulas match
    reference metrics/RegressionMetrics.py:196-251 exactly; columns are
    (label, residual, prediction))."""

    def __init__(self, buf: _SummarizerBuffer) -> None:
        self._b = buf

    @classmethod
    def from_predictions(
        cls,
        labels: np.ndarray,
        predictions: np.ndarray,
        weights: Optional[np.ndarray] = None,
    ) -> "RegressionMetrics":
        y = np.asarray(labels, np.float64)
        p = np.asarray(predictions, np.float64)
        w = np.ones_like(y) if weights is None else np.asarray(weights, np.float64)
        cols = np.stack([y, y - p, p], axis=1)  # (n, 3)
        ws = w.sum()
        mean = (w[:, None] * cols).sum(axis=0) / ws
        m2n = (w[:, None] * (cols - mean) ** 2).sum(axis=0)
        m2 = (w[:, None] * cols**2).sum(axis=0)
        l1 = (w[:, None] * np.abs(cols)).sum(axis=0)
        return cls(_SummarizerBuffer(mean, m2n, m2, l1, len(y), ws))

    @property
    def _ss_err(self) -> float:
        return self._b.m2[1]

    @property
    def _ss_tot(self) -> float:
        return self._b.m2n[0]

    @property
    def _ss_reg(self) -> float:
        # sum w (pred - mean_label)^2 (reference RegressionMetrics.py:211-219)
        b = self._b
        return (
            b.m2[2]
            + b.mean[0] ** 2 * b.weight_sum
            - 2.0 * b.mean[0] * b.mean[2] * b.weight_sum
        )

    @property
    def mean_squared_error(self) -> float:
        return self._ss_err / self._b.weight_sum

    @property
    def root_mean_squared_error(self) -> float:
        return float(np.sqrt(self.mean_squared_error))

    @property
    def mean_absolute_error(self) -> float:
        return self._b.l1[1] / self._b.weight_sum

    def r2(self, through_origin: bool = False) -> float:
        ss = self._b.m2[0] if through_origin else self._ss_tot
        return 1.0 - self._ss_err / ss if ss > 0 else 0.0

    @property
    def explained_variance(self) -> float:
        return self._ss_reg / self._b.weight_sum

    def evaluate(self, metric_name: str) -> float:
        if metric_name == "rmse":
            return self.root_mean_squared_error
        if metric_name == "mse":
            return self.mean_squared_error
        if metric_name == "mae":
            return self.mean_absolute_error
        if metric_name == "r2":
            return self.r2()
        if metric_name == "var":
            return self.explained_variance
        raise ValueError(f"Unsupported metric: {metric_name}")


__all__ = [
    "EvalMetricInfo",
    "TransformEvaluateMetric",
    "MulticlassMetrics",
    "RegressionMetrics",
    "_SummarizerBuffer",
]
