#
# The port's LinearRegression (spark_rapids_ml_torch/ops/linear.py,
# models/regression.py) against the JAX package's on the same numpy inputs,
# on the CPU: the sufficient statistics (rtol 1e-12), the host solve (bit for
# bit, with its iteration count and summary), the residual pass and
# predictions, the estimator from numpy, pandas and a DeviceDataset with the
# fused pass off and on, OLS / ridge / elastic-net / L1, intercept,
# standardization and weights, then transform, predict and the summary,
# save/load in both directions, convert.py, and what raises.  Every JAX
# float64 call runs inside `jax.enable_x64(True)` (the flag is checked at
# module teardown).
#
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_torch import DeviceDataset, set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import fused as port_fused
from spark_rapids_ml_torch.convert import (
    linreg_model_from_reference,
    linreg_model_to_reference_attributes,
    model_params,
)
from spark_rapids_ml_torch.ops import linear as port_linear
from spark_rapids_ml_torch.regression import LinearRegression, LinearRegressionModel
from spark_rapids_ml_tpu import DeviceDataset as JaxDeviceDataset
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.core import _ReadWriteMixin as JaxReadWrite
from spark_rapids_ml_tpu.ops import linear as jax_linear
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinR
from spark_rapids_ml_tpu.regression import LinearRegressionModel as JaxLinRModel


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


def _data(seed=0, n=1500, d=8):
    """Features with uneven scales and offsets, labels from a sparse linear
    model plus noise, sample weights in [0.2, 2)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 4.0, d) + rng.normal(size=d) * 2.0
    beta = rng.normal(size=d) * (rng.uniform(size=d) > 0.3)
    y = X @ beta + 1.5 + 0.3 * rng.normal(size=n)
    return X, y, rng.uniform(0.2, 2.0, n)


def _stats(seed=0, **kw):
    """Host sufficient statistics of `_data`, with weights."""
    X, y, w = _data(seed, **kw)
    Xw = X * w[:, None]
    return Xw.T @ X, Xw.T @ y, Xw.sum(0), w.sum(), (w * y).sum(), (w * y * y).sum()


_PENALTIES = {
    "ols": dict(reg_param=0.0, elasticnet_param=0.0),
    "ridge": dict(reg_param=0.1, elasticnet_param=0.0),
    "elasticnet": dict(reg_param=0.1, elasticnet_param=0.5),
    "l1": dict(reg_param=0.05, elasticnet_param=1.0),
}


# ---------------------------------------------------------------------------
# ops/linear.py against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sufficient_stats_match_jax(dtype):
    """Weighted, with rows of weight 0, labels float32 (the staging rule):
    rtol 1e-12 in float64, 1e-5 in float32."""
    X, y, w = _data(seed=1)
    w[::5] = 0.0
    X, w, y = X.astype(dtype), w.astype(dtype), y.astype(np.float32)
    got = port_linear.linreg_sufficient_stats(*(torch.from_numpy(a) for a in (X, w, y)))
    with jax.enable_x64(dtype == np.float64):
        want = jax_linear.linreg_sufficient_stats(*(jnp.asarray(a) for a in (X, w, y)))
        want = [np.asarray(a) for a in want]
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for name, a, b in zip(("gram", "sxy", "s1", "sw", "sy", "syy"), got, want):
        assert a.dtype == getattr(torch, str(b.dtype)), name
        np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("penalty", list(_PENALTIES))
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("standardization", [True, False])
@pytest.mark.parametrize("max_iter", [1000, 7])
def test_solve_linear_host_is_jax_bit_for_bit(penalty, fit_intercept, standardization,
                                              max_iter):
    """From the same statistics: coefficients, intercept, n_iter and the
    summary equal, bit for bit (FISTA also when max_iter cuts it short)."""
    st = _stats(seed=2)
    kw = dict(_PENALTIES[penalty], fit_intercept=fit_intercept,
              standardization=standardization, tol=1e-10, max_iter=max_iter)
    coef, b, diag = port_linear.solve_linear_host(*st, **kw)
    jcoef, jb, jdiag = jax_linear.solve_linear_host(*st, **kw)
    np.testing.assert_array_equal(coef, jcoef)
    assert b == jb
    assert diag == jdiag
    if penalty in ("elasticnet", "l1"):
        assert 1 <= diag["n_iter"] <= max_iter
    else:
        assert diag["n_iter"] == 0.0


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("sse,sw,sy,syy", [
    (3.0, 10.0, 4.0, 20.0),
    (0.0, 5.0, 10.0, 20.0),   # SStot = 0 (constant labels), exact fit: r2 = 1
    (0.5, 5.0, 10.0, 20.0),   # SStot = 0, a misfit: r2 = NaN
    (2.0, 4.0, 0.0, 0.0),     # through the origin, SStot = 0
])
def test_summary_from_sse_matches_jax(fit_intercept, sse, sw, sy, syy):
    a = port_linear._summary_from_sse(sse, sw, sy, syy, fit_intercept)
    b = jax_linear._summary_from_sse(sse, sw, sy, syy, fit_intercept)
    np.testing.assert_equal(a, b)


def test_soft_threshold_matches_jax():
    v = np.array([-3.0, -0.5, 0.0, 0.2, 1.0, 2.5])
    np.testing.assert_array_equal(port_linear._soft_threshold(v, 0.6),
                                  jax_linear._soft_threshold(v, 0.6))


def test_residual_sse_and_predict_match_jax():
    X, y, w = _data(seed=3)
    coef = np.random.default_rng(0).normal(size=8)
    with jax.enable_x64(True):
        want_sse = float(jax_linear.linreg_residual_sse(
            jnp.asarray(X), jnp.asarray(w), jnp.asarray(y.astype(np.float32)), jnp.asarray(coef),
            np.float64(0.7)))
        want_pred = np.asarray(jax_linear.linreg_predict(jnp.asarray(X), jnp.asarray(coef),
                                                         np.float64(0.7)))
    t = torch.from_numpy
    sse = port_linear.linreg_residual_sse(t(X), t(w), t(y.astype(np.float32)), t(coef),
                                          torch.tensor(0.7, dtype=torch.float64)).item()
    np.testing.assert_allclose(sse, want_sse, rtol=1e-12)
    np.testing.assert_allclose(port_linear.linreg_predict(t(X), t(coef), 0.7).numpy(), want_pred,
                               rtol=1e-13, atol=1e-12)


# ---------------------------------------------------------------------------
# The estimator against the JAX package
# ---------------------------------------------------------------------------

_EST = {
    "ols": dict(regParam=0.0),
    "ridge": dict(regParam=0.1, elasticNetParam=0.0),
    "elasticnet": dict(regParam=0.02, elasticNetParam=0.5, maxIter=500, tol=1e-12),
    "l1": dict(regParam=0.02, elasticNetParam=1.0, maxIter=500, tol=1e-12),
}


def _inputs(source, X, y, w, package):
    """(dataset, featuresCol argument, weightCol or None)."""
    if source == "numpy":
        return (X, y), "features", None
    if source == "pandas":
        return pd.DataFrame({"features": list(X), "label": y, "wt": w}), "features", "wt"
    if source == "pandas_cols":
        cols = [f"c{i}" for i in range(X.shape[1])]
        df = pd.DataFrame(dict(zip(cols, X.T)))
        df["label"], df["wt"] = y, w
        return df, cols, "wt"
    dd = DeviceDataset if package == "port" else JaxDeviceDataset
    return dd.from_host(X, y=y, weight=w, dtype=np.float64), "features", None


def _fit(cls, kw, data, col, weight_col):
    est = cls(**kw).setFeaturesCol(col)
    if weight_col:
        est.setWeightCol(weight_col)
    return est.fit(data)


@pytest.mark.parametrize("source", ["numpy", "pandas", "pandas_cols", "device"])
@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("penalty", list(_EST))
def test_estimator_matches_jax_float64(source, fused, penalty):
    """float64 fits (float32_inputs=False) of the same data, weighted except
    from numpy: coefficients and intercept within 1e-9, the same iteration
    count, the summary's rmse and r2 within 1e-9 relative; then transform
    and the one-sample predict.  One route differs: the fused pass over
    unweighted rows sums the float32 labels (the staging rule) in float32
    in both packages, in another order, so there the agreement is float32
    rounding through the solve, 1e-4 of the largest coefficient, and
    through the one-pass SSE expansion, where the float32 sum of y^2 cancels
    against the fit: 1e-4 relative on the summary."""
    X, y, w = _data(seed=4)
    for cfg in (port_config, jax_config):
        cfg.set_config(fused_stage_solve=fused)
    kw = dict(_EST[penalty], float32_inputs=False)
    data, col, wcol = _inputs(source, X, y, w, "port")
    port_fused.FUSED_METRICS.clear()
    mine = _fit(LinearRegression, kw, data, col, wcol)
    assert bool(port_fused.FUSED_METRICS) == (fused == "on" and source != "device")
    with jax.enable_x64(True):
        jdata, _, _ = _inputs(source, X, y, w, "jax")
        ref = _fit(JaxLinR, kw, jdata, col, wcol)
    assert mine.coef_.dtype == np.float64 and mine.dtype == "float64" and mine.n_cols == 8
    f32_label_sums = fused == "on" and source == "numpy"
    tol, s_tol = (1e-4 * np.abs(ref.coef_).max(), 1e-4) if f32_label_sums else (1e-9, 1e-9)
    np.testing.assert_allclose(mine.coefficients, ref.coefficients, atol=tol)
    np.testing.assert_allclose(mine.intercept, ref.intercept, atol=tol)
    if not f32_label_sums:
        assert mine.summary.totalIterations == ref.summary.totalIterations
    np.testing.assert_allclose(mine.summary.rootMeanSquaredError,
                               ref.summary.rootMeanSquaredError, rtol=s_tol)
    np.testing.assert_allclose(mine.summary.r2, ref.summary.r2, rtol=s_tol)
    np.testing.assert_allclose(mine.summary.meanSquaredError, ref.summary.meanSquaredError,
                               rtol=s_tol)
    assert mine.hasSummary
    if penalty == "l1" and not f32_label_sums:
        np.testing.assert_array_equal(mine.coef_ == 0, np.abs(ref.coef_) < 1e-12)
    p_tol = 10 * tol * np.abs(X).max()
    np.testing.assert_allclose(mine.predict(X[0]), ref.predict(X[0]), atol=p_tol)
    if source == "device":
        return
    a = mine.transform(data)
    with jax.enable_x64(True):
        b = ref.transform(jdata)
    if source == "numpy":
        np.testing.assert_allclose(a, b, atol=p_tol)
    else:
        np.testing.assert_allclose(a["prediction"].to_numpy(), b["prediction"].to_numpy(),
                                   atol=p_tol)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("standardization", [True, False])
def test_estimator_options_match_jax(fit_intercept, standardization):
    """Intercept and standardization on and off (ridge and elastic-net,
    weighted, two-phase): within 1e-9 of JAX."""
    X, y, w = _data(seed=5)
    df = pd.DataFrame({"features": list(X), "label": y, "wt": w})
    for penalty in ("ridge", "elasticnet"):
        kw = dict(_EST[penalty], fitIntercept=fit_intercept, standardization=standardization,
                  float32_inputs=False)
        mine = _fit(LinearRegression, kw, df, "features", "wt")
        with jax.enable_x64(True):
            ref = _fit(JaxLinR, kw, df, "features", "wt")
        np.testing.assert_allclose(mine.coef_, ref.coef_, atol=1e-9)
        assert mine.intercept == (ref.intercept if not fit_intercept else mine.intercept)
        np.testing.assert_allclose(mine.intercept, ref.intercept, atol=1e-9)
        np.testing.assert_allclose(mine.summary.r2, ref.summary.r2, rtol=1e-9)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_estimator_matches_jax_float32(fused):
    """float32 inputs: coefficients within 1e-4 relative of JAX's."""
    X, y, _ = _data(seed=6)
    X = X.astype(np.float32)
    for cfg in (port_config, jax_config):
        cfg.set_config(fused_stage_solve=fused)
    mine = LinearRegression(regParam=0.01).fit((X, y))
    ref = JaxLinR(regParam=0.01).fit((X, y))
    assert mine.coef_.dtype == np.float32
    np.testing.assert_allclose(mine.coef_, ref.coef_, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mine.intercept, ref.intercept, rtol=1e-4, atol=1e-4)
    a, b = mine.transform(X), ref.transform(X)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_fused_equals_two_phase():
    """In the port: the same coefficients within 1e-10; the fused summary
    (the one-pass expansion, whose syy sums the float32 labels' squares in
    float32, as the JAX package does) within 1e-6 of the residual pass's."""
    X, y, w = _data(seed=7)
    df = {"features": X, "label": y, "wt": w}
    port_config.set_config(fused_stage_solve="off")
    a = LinearRegression(regParam=0.01, float32_inputs=False).setWeightCol("wt").fit(df)
    port_config.set_config(fused_stage_solve="on")
    b = LinearRegression(regParam=0.01, float32_inputs=False).setWeightCol("wt").fit(df)
    np.testing.assert_allclose(a.coef_, b.coef_, atol=1e-10)
    np.testing.assert_allclose(a.intercept, b.intercept, atol=1e-10)
    np.testing.assert_allclose(a.summary.rootMeanSquaredError, b.summary.rootMeanSquaredError,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# Save / load across the packages, and convert.py
# ---------------------------------------------------------------------------


def _same_attrs(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_cross_load(tmp_path, saver):
    X, y, w = _data(seed=8)
    X = X.astype(np.float32)
    df = pd.DataFrame({"features": list(X), "label": y, "wt": w})
    kw = dict(regParam=0.05, elasticNetParam=0.3, maxIter=200)
    ref = JaxLinR(**kw).setWeightCol("wt").setPredictionCol("p").fit(df)
    mine = LinearRegression(**kw).setWeightCol("wt").setPredictionCol("p").fit(df)
    path = str(tmp_path / "model")
    if saver == "jax":
        ref.save(path)
        loaded, want = LinearRegressionModel.load(path), ref
    else:
        mine.save(path)
        loaded, want = JaxLinRModel.load(path), mine
    _same_attrs(loaded._get_model_attributes(), want._get_model_attributes())
    assert loaded.getOrDefault("regParam") == 0.05 and loaded.getOrDefault("predictionCol") == "p"
    assert loaded.tpu_params == want.tpu_params
    np.testing.assert_allclose(loaded.transform(df)["p"].to_numpy(),
                               want.transform(df)["p"].to_numpy(), rtol=1e-5, atol=1e-5)


def test_convert_pair_round_trips():
    X, y, _ = _data(seed=9)
    with jax.enable_x64(True):
        ref = JaxLinR(regParam=0.1, float32_inputs=False).fit((X, y))
        want = ref.transform(X)
    mine = linreg_model_from_reference(ref._get_model_attributes(), model_params(ref))
    _same_attrs(mine._get_model_attributes(), ref._get_model_attributes())
    back = JaxLinRModel(**linreg_model_to_reference_attributes(mine))
    JaxReadWrite._restore_params(back, model_params(mine))
    _same_attrs(back._get_model_attributes(), ref._get_model_attributes())
    with jax.enable_x64(True):
        np.testing.assert_array_equal(back.transform(X), want)
    np.testing.assert_allclose(mine.transform(X), want, rtol=1e-13, atol=1e-12)


# ---------------------------------------------------------------------------
# The port's own contract
# ---------------------------------------------------------------------------


def test_params_and_defaults_match_jax():
    a, b = LinearRegression(), JaxLinR()
    assert [p.name for p in a.params] == [p.name for p in b.params]
    for p in a.params:
        assert a.hasDefault(p.name) == b.hasDefault(p.name)
        if a.hasDefault(p.name):
            assert a.getOrDefault(p.name) == b.getOrDefault(p.name)
    assert a.tpu_params == b.tpu_params
    kw = dict(regParam=0.3, elasticNetParam=0.2, solver="normal", loss="squaredError")
    assert LinearRegression(**kw).tpu_params == JaxLinR(**kw).tpu_params


@pytest.mark.parametrize("kwargs", [
    {"loss": "huber"}, {"solver": "l-bfgs"}, {"loss": "absolute"}, {"not_a_param": 1},
])
def test_unsupported_values_raise(kwargs):
    with pytest.raises(ValueError, match="not supported|Unsupported"):
        LinearRegression(**kwargs)


def test_not_ported_paths_raise():
    X, y, _ = _data(seed=10, n=100)
    est = LinearRegression()
    # the parquet and streamed fits are ported: they now reach the file
    for call in (lambda: est._fit_fused_parquet("x.parquet"),
                 lambda: est._fit_streaming("x.parquet")):
        with pytest.raises(FileNotFoundError):
            call()
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        est._cpu_fit(None)
    model = est.fit((X, y))
    with pytest.raises(NotImplementedError, match="metrics"):
        model.evaluate((X, y))
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        model.cpu()
    with pytest.raises(ValueError, match="entries"):
        model.predict(X[0, :3])
    with pytest.raises(ValueError, match="labels"):
        LinearRegression().fit(DeviceDataset.from_host(X))


@pytest.mark.parametrize("fused", ["off", "on"])
def test_csr_fits_as_its_dense_form(fused):
    """CSR input is densified onto the two-phase path, also with the fused
    pass on: the same model as the dense rows, bit for bit."""
    import scipy.sparse as sp

    X, y, _ = _data(seed=11, n=400)
    X = np.where(np.abs(X) > 2.0, X, 0.0)
    kw = dict(regParam=0.01, float32_inputs=False)
    port_config.set_config(fused_stage_solve="off")
    dense = LinearRegression(**kw).fit((X, y))
    port_config.set_config(fused_stage_solve=fused)
    port_fused.FUSED_METRICS.clear()
    sparse = LinearRegression(**kw).fit((sp.csr_matrix(X), y))
    assert not port_fused.FUSED_METRICS
    np.testing.assert_array_equal(sparse.coef_, dense.coef_)
    assert sparse.intercept == dense.intercept
