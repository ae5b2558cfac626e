#
# Evaluators: the port of spark_rapids_ml_tpu/evaluation.py, the
# pyspark.ml.evaluation surface CrossValidator drives, computed on the host
# by metrics/.  BinaryClassificationEvaluator computes areaUnderROC and
# areaUnderPR itself, as scikit-learn's roc_auc_score and
# average_precision_score define them (the JAX package calls scikit-learn,
# which the card's machine lacks): the ROC curve's trapezoids over the
# distinct scores (tied scores one point), and average precision as the step
# sum of precision over the recall gained at each distinct score.
#
from __future__ import annotations

from typing import Any

import numpy as np

from .metrics import MulticlassMetrics, RegressionMetrics
from .params import Param, Params, TypeConverters


class Evaluator(Params):
    def evaluate(self, dataset: Any) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True

    def _col(self, df, name: str) -> np.ndarray:
        if name not in df.columns:
            raise ValueError(f"Column '{name}' not found in dataset")
        col = df[name]
        first = col.iloc[0]
        if np.isscalar(first):
            return col.to_numpy()
        return np.stack([np.asarray(v) for v in col])


class MulticlassClassificationEvaluator(Evaluator):
    """pyspark.ml.evaluation.MulticlassClassificationEvaluator parity."""

    metricName = Param("_", "metricName", "metric name.", TypeConverters.toString)
    labelCol = Param("_", "labelCol", "label column.", TypeConverters.toString)
    predictionCol = Param("_", "predictionCol", "prediction column.",
                          TypeConverters.toString)
    probabilityCol = Param("_", "probabilityCol", "probability column.",
                           TypeConverters.toString)
    weightCol = Param("_", "weightCol", "weight column.", TypeConverters.toString)
    metricLabel = Param("_", "metricLabel", "class for *ByLabel metrics.",
                        TypeConverters.toFloat)
    beta = Param("_", "beta", "beta for weightedFMeasure.", TypeConverters.toFloat)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(
            metricName="f1",
            labelCol="label",
            predictionCol="prediction",
            probabilityCol="probability",
            metricLabel=0.0,
            beta=1.0,
        )
        self._set(**kwargs)

    def setMetricName(self, value: str) -> "MulticlassClassificationEvaluator":
        self._set(metricName=value)
        return self

    def setLabelCol(self, value: str) -> "MulticlassClassificationEvaluator":
        self._set(labelCol=value)
        return self

    def setPredictionCol(self, value: str) -> "MulticlassClassificationEvaluator":
        self._set(predictionCol=value)
        return self

    def getMetricName(self) -> str:
        return self.getOrDefault("metricName")

    def isLargerBetter(self) -> bool:
        return self.getOrDefault("metricName") not in ("logLoss", "hammingLoss")

    def evaluate(self, dataset: Any) -> float:
        name = self.getOrDefault("metricName")
        labels = self._col(dataset, self.getOrDefault("labelCol"))
        preds = self._col(dataset, self.getOrDefault("predictionCol"))
        probs = None
        if name == "logLoss":
            probs = self._col(dataset, self.getOrDefault("probabilityCol"))
        weights = None
        if self.isSet("weightCol"):
            weights = self._col(dataset, self.getOrDefault("weightCol"))
        m = MulticlassMetrics.from_predictions(labels, preds, weights, probs)
        return m.evaluate(
            name,
            metric_label=self.getOrDefault("metricLabel"),
            beta=self.getOrDefault("beta"),
        )


class RegressionEvaluator(Evaluator):
    """pyspark.ml.evaluation.RegressionEvaluator parity."""

    metricName = Param("_", "metricName", "metric name (rmse/mse/mae/r2/var).",
                       TypeConverters.toString)
    labelCol = Param("_", "labelCol", "label column.", TypeConverters.toString)
    predictionCol = Param("_", "predictionCol", "prediction column.",
                          TypeConverters.toString)
    weightCol = Param("_", "weightCol", "weight column.", TypeConverters.toString)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(metricName="rmse", labelCol="label",
                         predictionCol="prediction")
        self._set(**kwargs)

    def setMetricName(self, value: str) -> "RegressionEvaluator":
        self._set(metricName=value)
        return self

    def setLabelCol(self, value: str) -> "RegressionEvaluator":
        self._set(labelCol=value)
        return self

    def getMetricName(self) -> str:
        return self.getOrDefault("metricName")

    def isLargerBetter(self) -> bool:
        return self.getOrDefault("metricName") in ("r2", "var")

    def evaluate(self, dataset: Any) -> float:
        labels = self._col(dataset, self.getOrDefault("labelCol"))
        preds = self._col(dataset, self.getOrDefault("predictionCol"))
        weights = None
        if self.isSet("weightCol"):
            weights = self._col(dataset, self.getOrDefault("weightCol"))
        m = RegressionMetrics.from_predictions(labels, preds, weights)
        return m.evaluate(self.getOrDefault("metricName"))


class BinaryClassificationEvaluator(Evaluator):
    """pyspark.ml.evaluation.BinaryClassificationEvaluator parity
    (areaUnderROC / areaUnderPR from raw scores)."""

    metricName = Param("_", "metricName", "areaUnderROC or areaUnderPR.",
                       TypeConverters.toString)
    labelCol = Param("_", "labelCol", "label column.", TypeConverters.toString)
    rawPredictionCol = Param("_", "rawPredictionCol", "raw prediction column.",
                             TypeConverters.toString)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(
            metricName="areaUnderROC",
            labelCol="label",
            rawPredictionCol="rawPrediction",
        )
        self._set(**kwargs)

    def getMetricName(self) -> str:
        return self.getOrDefault("metricName")

    def evaluate(self, dataset: Any) -> float:
        labels = self._col(dataset, self.getOrDefault("labelCol"))
        raw = self._col(dataset, self.getOrDefault("rawPredictionCol"))
        scores = raw[:, 1] if raw.ndim == 2 else raw
        if self.getOrDefault("metricName") == "areaUnderPR":
            return average_precision(labels, scores)
        return roc_auc(labels, scores)


def _threshold_counts(labels: np.ndarray, scores: np.ndarray):
    """(false positives, true positives) at each distinct score, highest
    first: the points of the binary ROC and precision-recall curves, as
    scikit-learn counts them (a stable sort of the scores, descending; rows
    with one score count together).  The positive class is the label 1."""
    y = np.asarray(labels).reshape(-1)
    s = np.asarray(scores, np.float64).reshape(-1)
    classes = np.unique(y)
    if classes.size > 2 or not np.all(np.isin(classes, (0, 1, -1))):
        raise ValueError(f"binary labels required (0/1 or -1/1); got {classes[:5]}")
    order = np.argsort(s, kind="mergesort")[::-1]
    s = s[order]
    pos = (y[order] == 1).astype(np.float64)
    last = np.r_[np.flatnonzero(np.diff(s)), pos.size - 1]
    tps = np.cumsum(pos)[last]
    fps = 1 + last - tps
    return fps, tps


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve: the trapezoids between the curve's points
    (scikit-learn's `roc_auc_score`, its collinear points dropped as
    `roc_curve` drops them)."""
    fps, tps = _threshold_counts(labels, scores)
    if fps[-1] == 0 or tps[-1] == 0:
        raise ValueError("Only one class present in the labels: ROC AUC is not defined")
    if fps.size > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """Average precision: the sum over distinct scores, highest first, of
    the precision there times the recall it adds (scikit-learn's
    `average_precision_score`, a step sum, not trapezoids)."""
    fps, tps = _threshold_counts(labels, scores)
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1.0), 0.0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps)
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


__all__ = [
    "Evaluator",
    "MulticlassClassificationEvaluator",
    "RegressionEvaluator",
    "BinaryClassificationEvaluator",
]
