#
# The port's LogisticRegression (spark_rapids_ml_torch/models/classification.py,
# ops/logistic.py) against the JAX package's on the same numpy inputs: the
# value-and-gradient oracle against `jax.value_and_grad` of the JAX problem
# builders, the fit (binomial and multinomial, L2 / elastic-net / L1,
# intercept, standardization, weights, the one-label model), the transform,
# save/load in both directions, and the port's own contract.  Everything
# runs on the CPU.  Every JAX float64 call runs inside
# `jax.enable_x64(True)`, so the process-wide x64 flag is never touched
# (checked at module teardown).
#
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_torch import DeviceDataset, set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.classification import (
    LogisticRegression,
    LogisticRegressionModel,
)
from spark_rapids_ml_torch.convert import (
    logreg_model_from_reference,
    logreg_model_to_reference_attributes,
    model_params,
)
from spark_rapids_ml_torch.ops import logistic as port_logistic
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR
from spark_rapids_ml_tpu.classification import LogisticRegressionModel as JaxLRModel
from spark_rapids_ml_tpu.core import _ReadWriteMixin as JaxReadWrite
from spark_rapids_ml_tpu.ops import logistic as jax_logistic


@pytest.fixture(scope="module", autouse=True)
def _x64_flag_unchanged():
    before = jax.config.jax_enable_x64
    yield
    assert jax.config.jax_enable_x64 == before


@pytest.fixture(autouse=True)
def _cpu_and_clean_config():
    set_default_device("cpu")
    port_config.reset_config()
    jax_config.reset_config()
    yield
    port_config.reset_config()
    jax_config.reset_config()
    set_default_device(None)


def _data(seed=0, n=300, d=5, classes=2, dtype=np.float64):
    """Features with uneven scales and offsets, labels from a noisy linear
    model (classes > 2: the argmax of C noisy linear scores), weights."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(size=d)
    W = rng.normal(size=(classes, d))
    scores = X @ W.T + 0.5 * rng.normal(size=(n, classes))
    y = (scores[:, 1] > scores[:, 0]) if classes == 2 else np.argmax(scores, axis=1)
    wt = rng.uniform(0.2, 2.0, n)
    return X.astype(dtype), y.astype(np.float64), wt


# ---------------------------------------------------------------------------
# The value-and-gradient oracle against jax.value_and_grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("binomial", [True, False])
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("scale", [0.0, 1.0, 40.0])
def test_oracle_matches_jax_value_and_grad(binomial, fit_intercept, weighted, scale):
    """float64, rtol 1e-12; scale 40 puts margins far above 20, where
    torch's own softplus (x itself above its threshold) would be off."""
    C = 2 if binomial else 4
    X, y, wt = _data(seed=3, n=257, d=6, classes=C)
    w = wt if weighted else np.ones(len(y))
    w[::9] = 0.0  # rows of weight 0
    l2 = 0.03
    n_param = (1 if binomial else C) * 6 + ((1 if binomial else C) if fit_intercept else 0)
    theta = np.random.default_rng(4).normal(size=n_param) * scale
    with jax.enable_x64(True):
        Xj, wj, yj = jnp.asarray(X), jnp.asarray(w), jnp.asarray(y.astype(np.int32))
        if binomial:
            loss_fn, _, _, _ = jax_logistic._binary_problem(
                lambda b: Xj @ b, 6, jnp.float64, wj, yj, l2, fit_intercept)
        else:
            loss_fn, _, _, _ = jax_logistic._multinomial_problem(
                lambda W: Xj @ W.T, C, 6, jnp.float64, wj, yj, l2, fit_intercept)
        jf, jg = jax.value_and_grad(loss_fn)(jnp.asarray(theta))
        jf, jg = float(jf), np.asarray(jg)
    oracle = port_logistic.LogisticOracle(
        torch.from_numpy(X), torch.from_numpy(w), torch.from_numpy(y.astype(np.int32)),
        C, l2, fit_intercept, binomial)
    if scale == 40.0:
        assert oracle.margins(torch.from_numpy(theta)).abs().max() > 20.0
    f, g = oracle(theta)
    assert isinstance(f, float) and g.dtype == np.float64 and g.shape == (n_param,)
    np.testing.assert_allclose(f, jf, rtol=1e-12)
    np.testing.assert_allclose(g, jg, rtol=1e-12, atol=1e-13 * np.abs(jg).max())


def test_oracle_ignores_labels_of_zero_weight_rows():
    X, y, _ = _data(seed=5, n=100, d=4, classes=3)
    w = np.ones(100)
    y_bad = y.copy()
    y_bad[:7], w[:7] = 7.0, 0.0  # out of range, but weight 0
    theta = np.random.default_rng(0).normal(size=3 * 4 + 3)
    args = (torch.from_numpy(X), torch.from_numpy(w))
    a = port_logistic.LogisticOracle(*args, torch.from_numpy(y.astype(np.int32)), 3, 0.1,
                                     True, False)(theta)
    b = port_logistic.LogisticOracle(*args, torch.from_numpy(y_bad.astype(np.int32)), 3, 0.1,
                                     True, False)(theta)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


def test_softplus_is_exact_above_torch_threshold():
    x = torch.tensor([-800.0, -30.0, -1.0, 0.0, 1.0, 19.0, 21.0, 30.0, 800.0],
                     dtype=torch.float64)
    with jax.enable_x64(True):
        want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(port_logistic.softplus(x).numpy(), want, rtol=1e-15, atol=0)
    # torch's own softplus differs from the exact value above its threshold
    assert torch.nn.functional.softplus(x)[6].item() != want[6]


def test_theta_layout_matches_jax():
    for C, fit_intercept in ((1, True), (1, False), (3, True), (3, False)):
        n_coef, n_param, mask, unpack = port_logistic._theta_layout(C, 4, fit_intercept)
        j = jax_logistic._theta_layout(C, 4, jnp.float32, fit_intercept)
        assert (n_coef, n_param) == j[:2]
        np.testing.assert_array_equal(mask, np.asarray(j[2]))
        theta = np.arange(n_param, dtype=np.float32)
        for a, b in zip(unpack(torch.from_numpy(theta)), j[3](jnp.asarray(theta))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(unpack(theta), j[3](jnp.asarray(theta))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# The fit against JAX, float64
# ---------------------------------------------------------------------------

_PENALTIES = {"l2": dict(regParam=0.05), "elasticnet": dict(regParam=0.05, elasticNetParam=0.5),
              "l1": dict(regParam=0.05, elasticNetParam=1.0)}


def _estimator(cls, kw, weight_col):
    est = cls(**kw)
    return est.setWeightCol(weight_col) if weight_col else est


def _jax_fits(kw, data, weight_col=None):
    """JAX fits of `data`: its single-program solver and its host-driven
    one (forced by a tiny `dispatch_flops_limit`)."""
    with jax.enable_x64(True):
        fused = _estimator(JaxLR, kw, weight_col).fit(data)
        jax_config.set_config(dispatch_flops_limit=1.0)
        host = _estimator(JaxLR, kw, weight_col).fit(data)
        jax_config.reset_config()
    return fused, host


@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("penalty", list(_PENALTIES))
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("standardization", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_fit_matches_jax_float64(classes, penalty, fit_intercept, standardization, weighted):
    """Coefficients and intercepts within 1e-9 (absolute, on values of order
    1), objective within 1e-12 relative, of both JAX solvers; the
    objectiveHistory of the host-driven ones has the same length."""
    X, y, wt = _data(seed=classes, classes=classes)
    kw = dict(_PENALTIES[penalty], fitIntercept=fit_intercept,
              standardization=standardization, maxIter=200, tol=1e-10, float32_inputs=False)
    weight_col = "wt" if weighted else None
    data = pd.DataFrame({"features": list(X), "label": y, "wt": wt}) if weighted else (X, y)
    mine = _estimator(LogisticRegression, kw, weight_col).fit(data)
    fused, host = _jax_fits(kw, data, weight_col)
    assert mine.numClasses == classes and mine.coef_.dtype == np.float64
    for ref in (fused, host):
        np.testing.assert_allclose(mine.coefficientMatrix, ref.coefficientMatrix, atol=1e-9)
        np.testing.assert_allclose(mine.interceptVector, ref.interceptVector, atol=1e-9)
        np.testing.assert_allclose(mine.objective, ref.objective, rtol=1e-12)
        assert mine.classes_ == ref.classes_
    assert len(mine.summary.objectiveHistory) == len(host.summary.objectiveHistory)
    assert mine.summary.totalIterations == host.summary.totalIterations
    assert mine.summary.objectiveHistory[-1] == mine.objective
    if penalty == "l1":
        np.testing.assert_array_equal(mine.coefficientMatrix == 0,
                                      np.abs(host.coefficientMatrix) < 1e-12)


@pytest.mark.parametrize("penalty", ["l2", "l1"])
def test_fit_matches_jax_float32_converged(penalty):
    """float32 data: the port's iterates follow the host-driven path with
    float32 evaluations, JAX's fused solver keeps float32 state too, so
    only converged results are compared: coefficients within 2e-3 relative
    (2e-4 absolute), objective within 1e-5 relative."""
    X, y, _ = _data(seed=11, n=600, d=6, dtype=np.float32)
    kw = dict(_PENALTIES[penalty], maxIter=300, tol=1e-9)
    mine = LogisticRegression(**kw).fit((X, y))
    ref = JaxLR(**kw).fit((X, y))
    assert mine.coef_.dtype == np.float32 and mine.dtype == "float32"
    np.testing.assert_allclose(mine.coefficientMatrix, ref.coefficientMatrix, rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(mine.interceptVector, ref.interceptVector, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(mine.objective, ref.objective, rtol=1e-5)


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_single_label_model_matches_jax(label):
    X = np.random.default_rng(0).normal(size=(50, 4))
    y = np.full(50, label)
    mine = LogisticRegression().fit((X, y))
    ref = JaxLR().fit((X, y))
    assert mine.intercept == ref.intercept == (np.inf if label else -np.inf)
    assert (mine.coefficients == 0).all() and mine.numClasses == 1
    assert mine.summary.objectiveHistory == [0.0] and mine.summary.totalIterations == 0
    a, b = mine.transform(X), ref.transform(X)
    for col in ("prediction", "probability", "rawPrediction"):
        np.testing.assert_array_equal(a[col], b[col])
    with pytest.raises(RuntimeError, match="either 1. or 0."):
        LogisticRegression().fit((X, np.full(50, 3.0)))


@pytest.mark.parametrize("labels", [np.full(50, 0.5), np.r_[np.zeros(25), -np.ones(25)]],
                         ids=["non-integer", "negative"])
@pytest.mark.parametrize("route", ["arrays", "device_dataset"])
def test_bad_labels_rejected(labels, route):
    X = np.random.default_rng(0).normal(size=(50, 4))
    data = (X, labels) if route == "arrays" else DeviceDataset.from_host(X, y=labels)
    with pytest.raises(RuntimeError, match="Integers|non-negative"):
        LogisticRegression().fit(data)
    with pytest.raises(RuntimeError, match="Integers|non-negative"):
        JaxLR().fit((X, labels))


def test_zero_weight_rows_do_not_make_classes():
    """A label of 7 on rows of weight 0 stays out of numClasses, as in JAX."""
    X, y, wt = _data(seed=6, n=200, d=4)
    y[:5], wt[:5] = 7.0, 0.0
    df = pd.DataFrame({"features": list(X), "label": y, "wt": wt})
    kw = dict(regParam=0.01, float32_inputs=False, maxIter=100, tol=1e-10)
    mine = LogisticRegression(**kw).setWeightCol("wt").fit(df)
    with jax.enable_x64(True):
        ref = JaxLR(**kw).setWeightCol("wt").fit(df)
    assert mine.numClasses == ref.numClasses == 2
    np.testing.assert_allclose(mine.coefficients, ref.coefficients, atol=1e-9)
    # the same as dropping those rows
    keep = wt > 0
    dropped = LogisticRegression(**kw).setWeightCol("wt").fit(df[keep])
    np.testing.assert_allclose(mine.coefficients, dropped.coefficients, atol=1e-9)


def test_multinomial_family_on_two_classes_and_features_cols():
    X, y, _ = _data(seed=8)
    cols = {f"c{j}": X[:, j] for j in range(X.shape[1])}
    df = pd.DataFrame({**cols, "label": y})
    kw = dict(family="multinomial", regParam=0.02, maxIter=200, tol=1e-10,
              float32_inputs=False)
    mine = LogisticRegression(**kw).setFeaturesCol(list(cols)).fit(df)
    with jax.enable_x64(True):
        ref = JaxLR(**kw).setFeaturesCol(list(cols)).fit(df)
    assert mine.coefficientMatrix.shape == (2, X.shape[1])
    np.testing.assert_allclose(mine.coefficientMatrix, ref.coefficientMatrix, atol=1e-9)
    np.testing.assert_allclose(mine.interceptVector, ref.interceptVector, atol=1e-9)
    assert mine.interceptVector.sum() == pytest.approx(0.0, abs=1e-12)


# ---------------------------------------------------------------------------
# Transform
# ---------------------------------------------------------------------------


def _jax_model(classes, dtype, **kw):
    X, y, _ = _data(seed=20 + classes, n=400, classes=classes, dtype=dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = JaxLR(regParam=0.01, maxIter=100, float32_inputs=dtype == np.float32,
                    **kw).fit((X, y))
    return ref, X


@pytest.mark.parametrize("classes", [2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("threshold", [0.5, 0.8])
def test_transform_matches_jax(classes, dtype, threshold):
    """The same model in both packages (carried over by convert.py):
    predictions equal, probability and rawPrediction within 1e-12 (float64)
    or 2e-5 (float32) relative."""
    ref, X = _jax_model(classes, dtype)
    ref = ref.copy({ref.threshold: threshold})
    mine = logreg_model_from_reference(ref._get_model_attributes(), model_params(ref))
    assert mine.getOrDefault("threshold") == threshold
    with jax.enable_x64(dtype == np.float64):
        b = ref.transform(X)
    a = mine.transform(X)
    tol = 1e-12 if dtype == np.float64 else 2e-5
    np.testing.assert_array_equal(a["prediction"], b["prediction"])
    assert a["prediction"].dtype == np.int32
    for col in ("probability", "rawPrediction"):
        assert a[col].dtype == b[col].dtype == dtype and a[col].shape == (len(X), classes)
        np.testing.assert_allclose(a[col], b[col], rtol=tol, atol=tol)
    if classes == 2 and threshold != 0.5:
        np.testing.assert_array_equal(a["prediction"], a["probability"][:, 1] > threshold)


def test_transform_dataframe_mapping_sparse_and_chunks():
    ref, X = _jax_model(3, np.float32)
    mine = logreg_model_from_reference(ref._get_model_attributes(), model_params(ref))
    want = mine.transform(X)
    df = pd.DataFrame({"features": list(X), "keep": np.arange(len(X))})
    out = mine.transform(df)
    assert list(out.columns) == ["features", "keep", "prediction", "probability",
                                 "rawPrediction"]
    np.testing.assert_array_equal(out["prediction"].to_numpy(), want["prediction"])
    np.testing.assert_array_equal(np.stack(out["probability"]), want["probability"])
    cols = mine.transform({"features": X, "keep": np.arange(len(X))})
    assert set(cols) == {"features", "keep", "prediction", "probability", "rawPrediction"}
    np.testing.assert_array_equal(cols["rawPrediction"], want["rawPrediction"])
    # 1024-row chunks (the floor of chunk_rows_for, halved): 3 chunks of 5000
    big = np.tile(X, (13, 1))[:5000]
    port_config.set_config(host_batch_bytes=1)
    chunked = mine.transform(big)
    port_config.reset_config()
    whole = mine.transform(big)
    for col in want:
        np.testing.assert_array_equal(chunked[col], whole[col])
    Xs = np.where(np.abs(X) > 1.0, X, 0.0).astype(np.float32)
    np.testing.assert_array_equal(mine.transform(sp.csr_matrix(Xs))["prediction"],
                                  mine.transform(Xs)["prediction"])
    empty = mine.transform(df.iloc[:0])
    assert len(empty) == 0 and "prediction" in empty.columns
    assert mine.transform(np.zeros((0, X.shape[1]), np.float32))["probability"].shape == (0, 3)


@pytest.mark.parametrize("classes", [2, 3])
def test_one_vector_api_matches_jax(classes):
    ref, X = _jax_model(classes, np.float64)
    mine = logreg_model_from_reference(ref._get_model_attributes(), model_params(ref))
    for v in X[:5]:
        np.testing.assert_allclose(mine.predictRaw(v), ref.predictRaw(v), rtol=1e-14)
        np.testing.assert_allclose(mine.predictProbability(v), ref.predictProbability(v),
                                   rtol=1e-14)
        assert mine.predict(v) == ref.predict(v)
    with pytest.raises(ValueError, match="entries"):
        mine.predictRaw(X[0, :2])
    if classes == 2:
        assert mine.coefficients.shape == (X.shape[1],)
        assert isinstance(mine.intercept, float)
    else:
        with pytest.raises(RuntimeError, match="coefficientMatrix"):
            mine.coefficients
        with pytest.raises(RuntimeError, match="interceptVector"):
            mine.intercept


# ---------------------------------------------------------------------------
# Save / load across the packages, and convert.py
# ---------------------------------------------------------------------------


def _same_attrs(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("saver", ["jax", "port"])
@pytest.mark.parametrize("classes", [2, 3])
def test_cross_load(tmp_path, saver, classes):
    X, y, wt = _data(seed=30, classes=classes, dtype=np.float32)
    df = pd.DataFrame({"features": list(X), "label": y, "wt": wt})
    kw = dict(regParam=0.02, elasticNetParam=0.3, maxIter=60)
    ref = JaxLR(**kw).setWeightCol("wt").setProbabilityCol("p").fit(df)
    mine = LogisticRegression(**kw).setWeightCol("wt").setProbabilityCol("p").fit(df)
    path = str(tmp_path / "model")
    if saver == "jax":
        ref.save(path)
        loaded, want = LogisticRegressionModel.load(path), ref
    else:
        mine.save(path)
        loaded, want = JaxLRModel.load(path), mine
    _same_attrs(loaded._get_model_attributes(), want._get_model_attributes())
    assert loaded.getOrDefault("regParam") == 0.02
    assert loaded.getOrDefault("probabilityCol") == "p"
    assert loaded.tpu_params == want.tpu_params
    a, b = loaded.transform(df), want.transform(df)
    for col in ("prediction", "p", "rawPrediction"):
        np.testing.assert_allclose(np.stack(a[col]), np.stack(b[col]), rtol=2e-5, atol=2e-5)


def test_convert_pair_round_trips():
    ref, X = _jax_model(3, np.float64)
    mine = logreg_model_from_reference(ref._get_model_attributes(), model_params(ref))
    _same_attrs(mine._get_model_attributes(), ref._get_model_attributes())
    attrs = logreg_model_to_reference_attributes(mine)
    back = JaxLRModel(**attrs)
    JaxReadWrite._restore_params(back, model_params(mine))
    _same_attrs(back._get_model_attributes(), ref._get_model_attributes())
    with jax.enable_x64(True):
        np.testing.assert_array_equal(back.transform(X)["prediction"],
                                      ref.transform(X)["prediction"])


# ---------------------------------------------------------------------------
# The port's own contract
# ---------------------------------------------------------------------------


def test_params_and_defaults_match_jax():
    a, b = LogisticRegression(), JaxLR()
    assert [p.name for p in a.params] == [p.name for p in b.params]
    for p in a.params:
        assert a.hasDefault(p.name) == b.hasDefault(p.name)
        if a.hasDefault(p.name):
            assert a.getOrDefault(p.name) == b.getOrDefault(p.name)
    assert a.tpu_params == b.tpu_params
    a, b = LogisticRegression(regParam=0.25, maxIter=7), JaxLR(regParam=0.25, maxIter=7)
    assert a.tpu_params == b.tpu_params and a.tpu_params["C"] == 4.0
    assert a.copy().tpu_params == a.tpu_params


@pytest.mark.parametrize("kwargs", [
    {"thresholds": [0.3, 0.7]},
    {"lowerBoundsOnCoefficients": [[0.0]]},
    {"upperBoundsOnCoefficients": [[1.0]]},
    {"lowerBoundsOnIntercepts": [0.0]},
    {"upperBoundsOnIntercepts": [1.0]},
    {"regParam": -1.0},
    {"not_a_param": 1},
])
def test_unsupported_params_raise(kwargs):
    with pytest.raises(ValueError, match="not supported|Unsupported"):
        LogisticRegression(**kwargs)


def test_not_ported_paths_raise():
    X, y, _ = _data(seed=1, n=60, d=3)
    port_config.set_config(bf16_features=True)
    with pytest.raises(NotImplementedError, match="bf16_features"):
        LogisticRegression().fit((X, y))
    port_config.reset_config()
    with pytest.raises(NotImplementedError, match="ELL"):
        LogisticRegression(enable_sparse_data_optim=True).fit((X, y))
    model = LogisticRegression().fit((X, y))
    # evaluate is ported (the meta layer); like the JAX package's it takes a
    # frame, a pyarrow Table or a parquet path, not an (X, y) tuple
    with pytest.raises(TypeError, match="Cannot interpret"):
        model.evaluate((X, y))
    assert model.evaluate(pd.DataFrame({"features": list(X), "label": y})).accuracy > 0.5
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        model.cpu()
    # accepted and read by nothing
    port_config.set_config(dispatch_flops_limit=1.0)
    refit = LogisticRegression().fit((X, y))
    np.testing.assert_array_equal(refit.coef_, model.coef_)


def test_csr_fits_as_its_dense_form():
    X, y, _ = _data(seed=2, n=300, d=8)
    X = np.where(np.abs(X) > 1.0, X, 0.0)
    kw = dict(regParam=0.01, float32_inputs=False, maxIter=100, tol=1e-10)
    a = LogisticRegression(**kw).fit((sp.csr_matrix(X), y))
    b = LogisticRegression(**kw).fit((X, y))
    np.testing.assert_array_equal(a.coef_, b.coef_)
    np.testing.assert_array_equal(a.intercept_, b.intercept_)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_dataset_fits_as_arrays(dtype):
    X, y, wt = _data(seed=4, n=300, d=5, classes=3)
    kw = dict(regParam=0.01, float32_inputs=dtype == np.float32, maxIter=100)
    ds = DeviceDataset.from_host(X, y=y, weight=wt, dtype=dtype)
    assert ds.shape == (300, 5) and ds.X.dtype == getattr(torch, np.dtype(dtype).name)
    a = LogisticRegression(**kw).fit(ds)
    b = LogisticRegression(**kw).setWeightCol("wt").fit(
        {"features": X, "label": y, "wt": wt})
    np.testing.assert_array_equal(a.coef_, b.coef_)
    np.testing.assert_array_equal(a.intercept_, b.intercept_)
    back = ds.to_host_batch()
    np.testing.assert_array_equal(back.X, X.astype(dtype))
    np.testing.assert_array_equal(back.y, y.astype(dtype))
    persisted = DeviceDataset.persist({"features": X, "label": y, "wt": wt},
                                      features_col="features", label_col="label",
                                      weight_col="wt", dtype=dtype)
    c = LogisticRegression(**kw).fit(persisted)
    np.testing.assert_array_equal(c.coef_, a.coef_)
    with pytest.raises(ValueError, match="labels"):
        LogisticRegression().fit(DeviceDataset.from_host(X))


def test_oracle_calls_are_counted():
    X, y, _ = _data(seed=7, n=100, d=3)
    port_logistic.ORACLE_CALLS = 0
    model = LogisticRegression(maxIter=15).fit((X, y))
    assert port_logistic.ORACLE_CALLS >= model.summary.totalIterations + 1
