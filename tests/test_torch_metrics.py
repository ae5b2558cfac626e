#
# The port's metrics (spark_rapids_ml_torch/metrics) and evaluators
# (spark_rapids_ml_torch/evaluation.py) against the JAX package's on the
# same numpy inputs: every MulticlassMetrics and RegressionMetrics metric,
# weighted and unweighted, within 1e-12; BinaryClassificationEvaluator's
# areaUnderROC and areaUnderPR, which the port computes without
# scikit-learn, against the JAX package's (scikit-learn's) within 1e-12,
# tied scores included; the three evaluators on a DataFrame.
#
import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_torch import evaluation as port_eval
from spark_rapids_ml_torch.metrics import MulticlassMetrics as PortMulticlass
from spark_rapids_ml_torch.metrics import RegressionMetrics as PortRegression
from spark_rapids_ml_tpu import evaluation as jax_eval
from spark_rapids_ml_tpu.metrics import MulticlassMetrics as JaxMulticlass
from spark_rapids_ml_tpu.metrics import RegressionMetrics as JaxRegression

TOL = 1e-12

MULTICLASS = ["f1", "accuracy", "weightedPrecision", "weightedRecall",
              "weightedTruePositiveRate", "weightedFalsePositiveRate",
              "weightedFMeasure", "truePositiveRateByLabel", "falsePositiveRateByLabel",
              "precisionByLabel", "recallByLabel", "fMeasureByLabel", "hammingLoss",
              "logLoss"]
REGRESSION = ["rmse", "mse", "mae", "r2", "var"]


def _close(a, b, tol=TOL):
    assert abs(a - b) <= tol * max(1.0, abs(b)), (a, b)


def _classes(seed, n=400, classes=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(float)
    p = y.copy()
    flip = rng.random(n) < 0.3
    p[flip] = rng.integers(0, classes, flip.sum()).astype(float)
    probs = rng.dirichlet(np.ones(classes), n)
    w = rng.uniform(0.1, 3.0, n)
    return y, p, probs, w


@pytest.mark.parametrize("metric", MULTICLASS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("label", [0.0, 2.0])
def test_multiclass_metrics_match_jax(metric, weighted, label):
    y, p, probs, w = _classes(1)
    kw = dict(weights=w if weighted else None, probabilities=probs)
    port = PortMulticlass.from_predictions(y, p, **kw)
    ref = JaxMulticlass.from_predictions(y, p, **kw)
    _close(port.evaluate(metric, metric_label=label, beta=0.5),
           ref.evaluate(metric, metric_label=label, beta=0.5))


def test_multiclass_properties_and_unknown_metric():
    y, p, probs, w = _classes(2, classes=4)
    port = PortMulticlass.from_predictions(y, p, weights=w, probabilities=probs)
    ref = JaxMulticlass.from_predictions(y, p, weights=w, probabilities=probs)
    for name in ("accuracy", "weighted_precision", "weighted_recall", "hamming_loss",
                 "log_loss", "weighted_true_positive_rate", "weighted_false_positive_rate"):
        _close(getattr(port, name), getattr(ref, name))
    _close(port.weighted_f_measure(2.0), ref.weighted_f_measure(2.0))
    assert port._labels == ref._labels
    with pytest.raises(ValueError, match="Unsupported metric"):
        port.evaluate("nope")


@pytest.mark.parametrize("metric", REGRESSION)
@pytest.mark.parametrize("weighted", [False, True])
def test_regression_metrics_match_jax(metric, weighted):
    rng = np.random.default_rng(3)
    y = rng.normal(size=300) * 10 + 4
    p = y + rng.normal(size=300)
    w = rng.uniform(0.1, 3.0, 300) if weighted else None
    _close(PortRegression.from_predictions(y, p, w).evaluate(metric),
           JaxRegression.from_predictions(y, p, w).evaluate(metric))


@pytest.mark.parametrize("through_origin", [False, True])
def test_r2_through_origin_matches_jax(through_origin):
    rng = np.random.default_rng(4)
    y = rng.normal(size=100) + 3.0
    p = y + 0.5 * rng.normal(size=100)
    _close(PortRegression.from_predictions(y, p).r2(through_origin),
           JaxRegression.from_predictions(y, p).r2(through_origin))


def _scores(seed, ties):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 2000))
    y = rng.integers(0, 2, n).astype(float)
    s = rng.normal(size=n) + y
    if ties == "rounded":
        s = np.round(s * 2) / 2  # a few distinct scores, many rows each
    elif ties == "constant":
        s = np.zeros(n)
    return y, s


@pytest.mark.parametrize("metric", ["areaUnderROC", "areaUnderPR"])
@pytest.mark.parametrize("ties", ["none", "rounded", "constant"])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("raw2d", [False, True])
def test_binary_evaluator_matches_jax(metric, ties, seed, raw2d):
    """The port's ROC AUC and average precision (no scikit-learn) against
    the JAX package's scikit-learn calls, within 1e-12."""
    y, s = _scores(seed, ties)
    raw = list(np.stack([-s, s], axis=1)) if raw2d else s
    df = pd.DataFrame({"label": y, "rawPrediction": raw})
    _close(port_eval.BinaryClassificationEvaluator(metricName=metric).evaluate(df),
           jax_eval.BinaryClassificationEvaluator(metricName=metric).evaluate(df))


def test_binary_evaluator_minus_one_labels_and_what_raises():
    rng = np.random.default_rng(9)
    y = np.where(rng.random(200) < 0.4, 1.0, -1.0)
    s = rng.normal(size=200) + y
    df = pd.DataFrame({"label": y, "rawPrediction": s})
    for metric in ("areaUnderROC", "areaUnderPR"):
        _close(port_eval.BinaryClassificationEvaluator(metricName=metric).evaluate(df),
               jax_eval.BinaryClassificationEvaluator(metricName=metric).evaluate(df))
    one = pd.DataFrame({"label": np.ones(10), "rawPrediction": np.arange(10.0)})
    with pytest.raises(ValueError, match="one class"):
        port_eval.BinaryClassificationEvaluator().evaluate(one)
    three = pd.DataFrame({"label": np.arange(10.0) % 3, "rawPrediction": np.arange(10.0)})
    with pytest.raises(ValueError, match="binary labels"):
        port_eval.BinaryClassificationEvaluator().evaluate(three)


@pytest.mark.parametrize("weighted", [False, True])
def test_evaluators_on_a_dataframe_match_jax(weighted):
    y, p, probs, w = _classes(5, n=300)
    df = pd.DataFrame({"label": y, "prediction": p, "probability": list(probs), "w": w})
    for metric in MULTICLASS:
        kw = dict(metricName=metric, metricLabel=1.0, beta=2.0)
        if weighted:
            kw["weightCol"] = "w"
        port = port_eval.MulticlassClassificationEvaluator(**kw)
        ref = jax_eval.MulticlassClassificationEvaluator(**kw)
        _close(port.evaluate(df), ref.evaluate(df))
        assert port.isLargerBetter() == ref.isLargerBetter()
    yr = np.random.default_rng(6).normal(size=300)
    dfr = pd.DataFrame({"label": yr, "prediction": yr + 0.1 * y, "w": w})
    for metric in REGRESSION:
        kw = dict(metricName=metric, **({"weightCol": "w"} if weighted else {}))
        port = port_eval.RegressionEvaluator(**kw)
        ref = jax_eval.RegressionEvaluator(**kw)
        _close(port.evaluate(dfr), ref.evaluate(dfr))
        assert port.isLargerBetter() == ref.isLargerBetter()
    with pytest.raises(ValueError, match="not found"):
        port_eval.RegressionEvaluator(labelCol="nope").evaluate(dfr)
