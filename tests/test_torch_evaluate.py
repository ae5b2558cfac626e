#
# `evaluate` of the port's models against the JAX package's: each model is
# fitted and saved by the JAX package and loaded by both packages, so the
# fit's own differences drop out, and both evaluate the same frame.  Binary,
# multinomial and weighted LogisticRegression, RandomForestClassifier, and
# LinearRegression with and without an intercept, in float32 (summaries
# within 1e-6) and float64 (1e-12).  JAX float64 calls run inside
# `jax.enable_x64(True)`.
#
import contextlib

import jax
import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.classification import LogisticRegressionModel as PortLRModel
from spark_rapids_ml_torch.classification import (
    RandomForestClassificationModel as PortRFModel,
)
from spark_rapids_ml_torch.regression import LinearRegressionModel as PortLinModel
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR
from spark_rapids_ml_tpu.classification import LogisticRegressionModel as JaxLRModel
from spark_rapids_ml_tpu.classification import RandomForestClassifier as JaxRF
from spark_rapids_ml_tpu.classification import RandomForestClassificationModel as JaxRFModel
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLin
from spark_rapids_ml_tpu.regression import LinearRegressionModel as JaxLinModel

TOL = {True: 1e-6, False: 1e-12}  # float32_inputs -> tolerance


@pytest.fixture(autouse=True)
def _cpu_and_clean_config():
    set_default_device("cpu")
    port_config.reset_config()
    jax_config.reset_config()
    yield
    port_config.reset_config()
    jax_config.reset_config()
    set_default_device(None)


def _x64(f32: bool):
    return contextlib.nullcontext() if f32 else jax.enable_x64(True)


def _frame(seed, n=300, d=5, classes=2, regression=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, d)
    if regression:
        y = X @ rng.normal(size=d) + 2.0 + 0.5 * rng.normal(size=n)
    else:
        scores = X @ rng.normal(size=(d, classes)) + 0.7 * rng.normal(size=(n, classes))
        y = np.argmax(scores, axis=1).astype(float)
    return pd.DataFrame({"features": list(X), "label": y, "w": rng.uniform(0.2, 2.0, n)})


def _close(a, b, tol):
    assert abs(a - b) <= tol * max(1.0, abs(b)), (a, b)


def _saved_by_jax(tmp_path, est, df, f32):
    path = str(tmp_path / "model")
    with _x64(f32):
        est.fit(df).save(path)
    return path


def _classification_summaries(port, ref, f32):
    tol = TOL[f32]
    for name in ("accuracy", "weightedPrecision", "weightedRecall"):
        _close(getattr(port, name), getattr(ref, name), tol)
    for beta in (1.0, 0.5):
        _close(port.weightedFMeasure(beta), ref.weightedFMeasure(beta), tol)
    np.testing.assert_array_equal(port.predictions["prediction"].to_numpy(),
                                  ref.predictions["prediction"].to_numpy())


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("case", ["binary", "multinomial", "weighted"])
def test_logistic_regression_evaluate_matches_jax(tmp_path, f32, case):
    df = _frame(1, classes=3 if case == "multinomial" else 2)
    est = JaxLR(regParam=0.01, maxIter=50, float32_inputs=f32, num_workers=1)
    if case == "weighted":
        est.setWeightCol("w")
    path = _saved_by_jax(tmp_path, est, df, f32)
    port = PortLRModel.load(path).evaluate(df)
    with _x64(f32):
        ref = JaxLRModel.load(path).evaluate(df)
    _classification_summaries(port, ref, f32)
    prob_p = np.stack(port.predictions["probability"].to_numpy())
    prob_r = np.stack(ref.predictions["probability"].to_numpy())
    np.testing.assert_allclose(prob_p, prob_r, rtol=TOL[f32], atol=TOL[f32])


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("classes", [2, 3])
def test_random_forest_classifier_evaluate_matches_jax(tmp_path, f32, classes):
    df = _frame(2, classes=classes)
    est = JaxRF(numTrees=4, maxDepth=4, seed=3, float32_inputs=f32, num_workers=1)
    path = _saved_by_jax(tmp_path, est, df, f32)
    port = PortRFModel.load(path).evaluate(df)
    with _x64(f32):
        ref = JaxRFModel.load(path).evaluate(df)
    _classification_summaries(port, ref, f32)


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_linear_regression_evaluate_matches_jax(tmp_path, f32, fit_intercept, weighted):
    df = _frame(3, regression=True)
    est = JaxLin(regParam=0.1, fitIntercept=fit_intercept, float32_inputs=f32, num_workers=1)
    if weighted:
        est.setWeightCol("w")
    path = _saved_by_jax(tmp_path, est, df, f32)
    port = PortLinModel.load(path).evaluate(df)
    with _x64(f32):
        ref = JaxLinModel.load(path).evaluate(df)
    for name in ("rootMeanSquaredError", "meanSquaredError", "meanAbsoluteError", "r2",
                 "explainedVariance"):
        _close(getattr(port, name), getattr(ref, name), TOL[f32])
    np.testing.assert_allclose(port.predictions["prediction"].to_numpy(),
                               ref.predictions["prediction"].to_numpy(),
                               rtol=TOL[f32], atol=TOL[f32])


def test_evaluate_inputs_and_what_raises(tmp_path):
    """A pyarrow Table and a parquet path evaluate as the frame does; a
    missing label or weight column, an empty frame and an (X, y) tuple raise
    as in the JAX package."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    df = _frame(4, regression=True)
    path = _saved_by_jax(tmp_path, JaxLin(num_workers=1).setWeightCol("w"), df, True)
    model = PortLinModel.load(path)
    table = pa.Table.from_pandas(df, preserve_index=False)
    pq.write_table(table, str(tmp_path / "d.parquet"))
    want = model.evaluate(df).rootMeanSquaredError
    assert model.evaluate(table).rootMeanSquaredError == want
    assert model.evaluate(str(tmp_path / "d.parquet")).rootMeanSquaredError == want
    ref = JaxLinModel.load(path)
    for bad, err in ((df.drop(columns=["label"]), "label column"),
                     (df.iloc[:0], "empty"),
                     (df.drop(columns=["w"]), "weightCol")):
        for m in (model, ref):
            with pytest.raises(ValueError, match=err):
                m.evaluate(bad)
    X = np.stack(df["features"].to_numpy())
    for m in (model, ref):
        with pytest.raises(TypeError, match="Cannot interpret"):
            m.evaluate((X, df["label"].to_numpy()))
