#
# The meta layer of the port against the JAX package: ParamGridBuilder,
# fitMultiple (one staging, the same models as separate fits),
# CrossValidator on the stage-once dataset cache (mask and gather fold
# views) and on the legacy path, the cache's fingerprint, views, budget and
# LRU, CrossValidatorModel save/load in both directions, and Pipeline's
# assembler bypass.  Mirrors the JAX package's tests/test_device_cache.py and
# tests/test_tuning_pipeline.py case by case.  CV against the JAX package:
# the same bestIndex and avgMetrics within 1e-6 (float32) and 1e-10
# (float64); the port's cached gather path against its legacy path exactly.
# JAX float64 calls run inside `jax.enable_x64(True)`.
#
import contextlib

import jax
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import evaluation as port_eval
from spark_rapids_ml_torch import pipeline as port_pipeline
from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import tuning as port_tuning
from spark_rapids_ml_torch.classification import LogisticRegression, RandomForestClassifier
from spark_rapids_ml_torch.clustering import KMeans
from spark_rapids_ml_torch.data import DeviceDataset
from spark_rapids_ml_torch.feature import PCA
from spark_rapids_ml_torch.parallel import RowStager
from spark_rapids_ml_torch.parallel import device_cache as port_cache
from spark_rapids_ml_torch.parallel.mesh import STAGE_COUNTS
from spark_rapids_ml_torch.regression import LinearRegression, RandomForestRegressor
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu import evaluation as jax_eval
from spark_rapids_ml_tpu import pipeline as jax_pipeline
from spark_rapids_ml_tpu import tuning as jax_tuning
from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR
from spark_rapids_ml_tpu.parallel import device_cache as jax_cache
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLin

CV_TOL = {True: 1e-6, False: 1e-10}  # float32_inputs -> avgMetrics tolerance


@pytest.fixture(autouse=True)
def _cpu_clean_config_and_caches():
    set_default_device("cpu")
    for cfg, cache in ((port_config, port_cache), (jax_config, jax_cache)):
        cfg.reset_config()
        cache.clear_chunk_cache()
        cache.clear_device_cache()
    yield
    for cfg, cache in ((port_config, port_cache), (jax_config, jax_cache)):
        cfg.reset_config()
        cache.clear_chunk_cache()
        cache.clear_device_cache()
    set_default_device(None)


def _x64(f32: bool):
    return contextlib.nullcontext() if f32 else jax.enable_x64(True)


def _reg_df(seed=0, n=300, d=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = X @ rng.normal(size=d) * 2 + rng.normal(scale=0.5, size=n)
    return pd.DataFrame({"features": list(X), "label": y})


def _clf_df(seed=0, n=300, d=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.6, size=n) > 0).astype(float)
    return pd.DataFrame({"features": list(X), "label": y})


def _stagings():
    return STAGE_COUNTS["dataset_stagings"]


def _cv(mod, est, grid, evaluator, k=3, seed=11):
    return mod.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=evaluator,
                              numFolds=k, seed=seed)


def _port_cv_both_paths(build, df):
    """(model, stagings, used_cache) of the same CV on the cached path and
    on the legacy path."""
    out = []
    for mode in ("on", "off"):
        port_config.set_config(device_cache=mode)
        port_cache.clear_device_cache()
        cv = build()
        s0 = _stagings()
        model = cv.fit(df)
        out.append((model, _stagings() - s0, cv._last_fit_used_cache))
    return out


# ---------------------------------------------------------------------------
# ParamGridBuilder and fitMultiple
# ---------------------------------------------------------------------------


def test_param_grid_builder_matches_jax():
    port_lr, jax_lr = LogisticRegression(), JaxLR()

    def grid(mod, lr):
        return (mod.ParamGridBuilder().addGrid(lr.regParam, [0.0, 0.1])
                .addGrid(lr.maxIter, [10, 20]).baseOn({lr.tol: 1e-4}).build())

    got = [{p.name: v for p, v in m.items()} for m in grid(port_tuning, port_lr)]
    want = [{p.name: v for p, v in m.items()} for m in grid(jax_tuning, jax_lr)]
    assert got == want and len(got) == 4
    pairs = port_tuning.ParamGridBuilder().baseOn((port_lr.tol, 1e-3)).build()
    assert [{p.name: v for p, v in m.items()} for m in pairs] == [{"tol": 1e-3}]


def _attrs(model):
    return {k: v for k, v in model._get_model_attributes().items()
            if isinstance(v, np.ndarray) or np.isscalar(v)}


@pytest.mark.parametrize("case", ["linear", "logistic", "pca", "kmeans", "forest"])
@pytest.mark.parametrize("source", ["frame", "device"])
def test_fit_multiple_equals_separate_fits_and_stages_once(case, source):
    df = _clf_df(1)
    est, param, values = {
        "linear": (LinearRegression(), "regParam", [0.0, 0.5, 2.0]),
        "logistic": (LogisticRegression(maxIter=30), "regParam", [0.0, 0.1]),
        "pca": (PCA(k=2).setInputCol("features"), "k", [1, 3]),
        "kmeans": (KMeans(seed=3, maxIter=10), "k", [2, 3]),
        "forest": (RandomForestClassifier(numTrees=2, maxDepth=3, seed=4), "maxDepth", [2, 4]),
    }[case]
    maps = [{est.getParam(param): v} for v in values]
    data = df
    if source == "device":
        X = np.stack(df["features"].to_numpy())
        data = DeviceDataset.from_host(X, y=df["label"].to_numpy(), label_dtype=np.float32)
    s0 = _stagings()
    models = dict(est.fitMultiple(data, maps))
    assert _stagings() - s0 == (1 if source == "frame" else 0)
    assert sorted(models) == list(range(len(maps)))
    for i, m in enumerate(maps):
        alone = est.fit(data, m)
        got, want = _attrs(models[i]), _attrs(alone)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{case} {key}")
        assert models[i].getOrDefault(param) == m[est.getParam(param)]


def test_fit_multiple_models_keep_the_estimators_float32_inputs():
    """The port's fitMultiple models carry the estimator's float32_inputs
    (as its fit's do); the JAX package's take the conf's, so its legacy
    float64 CV scores float32 transforms."""
    df = _reg_df(2, n=50)
    est = LinearRegression(float32_inputs=False)
    (_, model), = est.fitMultiple(df, [{est.regParam: 0.0}])
    assert model._float32_inputs is False
    assert model.transform(df)["prediction"].dtype == np.float64
    ref = JaxLin(float32_inputs=False, num_workers=1)
    with jax.enable_x64(True):
        (_, ref_model), = ref.fitMultiple(df, [{ref.regParam: 0.0}])
    assert ref_model._float32_inputs is True


def test_fit_multiple_of_csr_beyond_the_budget_fits_map_by_map():
    """CSR whose dense form is beyond the device budget: each map fits on
    its own from the blocked-CSR statistics, as in the JAX package."""
    rng = np.random.default_rng(2)
    X = sp.random(200, 6, density=0.5, random_state=3, format="csr")
    y = np.asarray(X @ rng.normal(size=6)).ravel()
    port_config.set_config(hbm_bytes=1000)
    est = LinearRegression()
    maps = [{est.regParam: v} for v in (0.0, 1.0)]
    models = dict(est.fitMultiple((X, y), maps))
    for i, m in enumerate(maps):
        assert models[i].fit_report()["route"] == "streamed_csr"
        np.testing.assert_array_equal(models[i].coef_, est.fit((X, y), m).coef_)


# ---------------------------------------------------------------------------
# CrossValidator against the JAX package (the mask path)
# ---------------------------------------------------------------------------

CV_CASES = [
    ("linear", "rmse", True), ("linear", "r2", True), ("linear", "rmse", False),
    ("linear", "mae", False), ("logistic", "accuracy", True),
    ("logistic", "weightedPrecision", True), ("logistic", "areaUnderROC", False),
    ("logistic", "logLoss", False), ("logistic", "areaUnderPR", False),
]


def _evaluator(mod, metric):
    if metric in ("rmse", "r2", "mae"):
        return mod.RegressionEvaluator(metricName=metric)
    if metric.startswith("areaUnder"):
        return mod.BinaryClassificationEvaluator(metricName=metric)
    return mod.MulticlassClassificationEvaluator(metricName=metric)


# float32 metrics that amplify the float32 fits' differences (about 1e-7
# apart): areaUnderROC moves by a pair of margins that ties in one package
# and not in the other (one pair of a fold: 5e-4), logLoss by the logs of
# the smallest probabilities (1e-5)
F32_LOOSER = {"areaUnderROC": 5e-4, "logLoss": 1e-5}


@pytest.mark.parametrize("case,metric,f32", CV_CASES + [
    ("logistic", m, True) for m in sorted(F32_LOOSER)])
def test_cv_matches_jax_on_the_mask_path(case, metric, f32):
    """The same bestIndex, avgMetrics within 1e-6 (float32) / 1e-10
    (float64), but for the float32 metrics of F32_LOOSER."""
    df = _reg_df(3) if case == "linear" else _clf_df(3)
    port_est = (LinearRegression if case == "linear" else LogisticRegression)(
        float32_inputs=f32)
    jax_est = (JaxLin if case == "linear" else JaxLR)(float32_inputs=f32, num_workers=1)
    values = [0.0, 0.1, 1.0]
    port_cv = _cv(port_tuning, port_est,
                  port_tuning.ParamGridBuilder().addGrid(port_est.regParam, values).build(),
                  _evaluator(port_eval, metric))
    jax_cv = _cv(jax_tuning, jax_est,
                 jax_tuning.ParamGridBuilder().addGrid(jax_est.regParam, values).build(),
                 _evaluator(jax_eval, metric))
    s0 = _stagings()
    got = port_cv.fit(df)
    assert _stagings() - s0 == 1
    with _x64(f32):
        want = jax_cv.fit(df)
    assert port_cv._last_fit_used_cache and jax_cv._last_fit_used_cache
    assert got.fit_report()["fold_views"] == "mask"
    assert got.bestIndex == want.bestIndex
    tol = F32_LOOSER.get(metric, CV_TOL[f32]) if f32 else CV_TOL[f32]
    np.testing.assert_allclose(got.avgMetrics, want.avgMetrics, rtol=tol, atol=0)


@pytest.mark.parametrize("case,f32", [("linear", True), ("linear", False),
                                      ("logistic", True), ("logistic", False)])
def test_cv_cached_matches_legacy(case, f32):
    df = _reg_df(4) if case == "linear" else _clf_df(4)
    metric = "rmse" if case == "linear" else "areaUnderROC"

    def build():
        est = (LinearRegression if case == "linear" else LogisticRegression)(float32_inputs=f32)
        grid = port_tuning.ParamGridBuilder().addGrid(est.regParam, [0.0, 10.0]).build()
        return _cv(port_tuning, est, grid, _evaluator(port_eval, metric), seed=1)

    (cached, st_cached, used), (legacy, st_legacy, legacy_used) = _port_cv_both_paths(build, df)
    assert used and not legacy_used
    assert st_cached == 1 and st_legacy > 1
    assert cached.bestIndex == legacy.bestIndex
    np.testing.assert_allclose(cached.avgMetrics, legacy.avgMetrics, rtol=CV_TOL[f32])
    a = cached.transform(df)["prediction"].to_numpy()
    b = legacy.transform(df)["prediction"].to_numpy()
    np.testing.assert_allclose(a, b, rtol=CV_TOL[f32] * 10, atol=CV_TOL[f32] * 10)


@pytest.mark.parametrize("case", ["classifier", "regressor", "kmeans"])
def test_cv_gather_path_equals_legacy_exactly(case):
    """Estimators without fold weights (the forests) fit gathered fold views,
    the tensors a fresh staging of the fold gives: the seeded fits and so
    the metrics equal the legacy path's exactly."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(240, 4))
    if case == "classifier":
        y = (X[:, 0] + 0.3 * rng.normal(size=240) > 0).astype(float)
        est = RandomForestClassifier(numTrees=3, maxDepth=3, seed=5)
        ev = port_eval.MulticlassClassificationEvaluator(metricName="accuracy")
        param, values = "maxDepth", [2, 3]
    else:
        y = X @ np.array([1.0, -1.0, 0.5, 0.0]) + 0.2 * rng.normal(size=240)
        est = RandomForestRegressor(numTrees=3, maxDepth=4, seed=5)
        ev = port_eval.RegressionEvaluator(metricName="rmse")
        param, values = "maxDepth", [3, 4]
    if case == "kmeans":
        # an unsupervised estimator on the gather path: KMeans' cluster ids
        # scored as a "prediction" against the label column
        est = KMeans(k=2, seed=2, maxIter=5)
        ev = port_eval.RegressionEvaluator(metricName="mae")
        param, values = "k", [2, 3]
    df = pd.DataFrame({"features": list(X), "label": y})

    def build():
        grid = port_tuning.ParamGridBuilder().addGrid(est.getParam(param), values).build()
        return _cv(port_tuning, est, grid, ev, k=2, seed=3)

    (cached, st_cached, used), (legacy, _, _) = _port_cv_both_paths(build, df)
    assert used and cached.fit_report()["fold_views"] == "gather"
    assert st_cached == 1
    assert cached.bestIndex == legacy.bestIndex
    np.testing.assert_array_equal(cached.avgMetrics, legacy.avgMetrics)


@pytest.mark.parametrize("case,f32", [("classifier", False), ("regressor", True)])
def test_cv_matches_jax_on_the_gather_path(case, f32):
    """Forests with no random draw (bootstrap=False, featureSubsetStrategy
    "all") are the JAX package's trees, so a CV over gathered fold views
    gives the JAX package's bestIndex and avgMetrics within 1e-6 (float32)
    / 1e-10 (float64)."""
    from spark_rapids_ml_tpu.classification import RandomForestClassifier as JaxRFC
    from spark_rapids_ml_tpu.regression import RandomForestRegressor as JaxRFR

    rng = np.random.default_rng(8)
    X = rng.normal(size=(240, 4))
    kw = dict(numTrees=3, maxBins=16, seed=5, bootstrap=False, featureSubsetStrategy="all",
              float32_inputs=f32)
    if case == "classifier":
        y = (X[:, 0] + 0.5 * X[:, 2] + 0.4 * rng.normal(size=240) > 0).astype(float)
        port_est, jax_est = RandomForestClassifier(**kw), JaxRFC(num_workers=1, **kw)
        metric = "accuracy"
    else:
        y = X @ np.array([1.0, -1.0, 0.5, 0.0]) + 0.3 * rng.normal(size=240)
        port_est, jax_est = RandomForestRegressor(**kw), JaxRFR(num_workers=1, **kw)
        metric = "rmse"
    df = pd.DataFrame({"features": list(X), "label": y})
    values = [2, 4]
    port_cv = _cv(port_tuning, port_est,
                  port_tuning.ParamGridBuilder().addGrid(port_est.maxDepth, values).build(),
                  _evaluator(port_eval, metric), k=3, seed=4)
    jax_cv = _cv(jax_tuning, jax_est,
                 jax_tuning.ParamGridBuilder().addGrid(jax_est.maxDepth, values).build(),
                 _evaluator(jax_eval, metric), k=3, seed=4)
    s0 = _stagings()
    got = port_cv.fit(df)
    assert _stagings() - s0 == 1
    with _x64(f32):
        want = jax_cv.fit(df)
    assert port_cv._last_fit_used_cache and jax_cv._last_fit_used_cache
    assert got.fit_report()["fold_views"] == "gather"
    assert got.bestIndex == want.bestIndex
    assert len(set(got.avgMetrics)) == 2  # the grid's two depths score apart
    np.testing.assert_allclose(got.avgMetrics, want.avgMetrics, rtol=CV_TOL[f32], atol=0)


def test_cv_cache_hit_on_a_repeated_fit():
    df = _reg_df(6)
    lr = LinearRegression()
    grid = port_tuning.ParamGridBuilder().addGrid(lr.regParam, [0.0, 1.0]).build()
    first = _cv(port_tuning, lr, grid, port_eval.RegressionEvaluator()).fit(df)
    h0, s0 = port_cache.CACHE_METRICS["hits"], _stagings()
    again = _cv(port_tuning, lr, grid, port_eval.RegressionEvaluator()).fit(df)
    assert _stagings() - s0 == 0
    assert port_cache.CACHE_METRICS["hits"] - h0 >= 1
    assert again.fit_report()["cache"]["outcome"] == "hit"
    assert first.fit_report()["cache"]["outcome"] == "staged"
    np.testing.assert_array_equal(first.avgMetrics, again.avgMetrics)


@pytest.mark.parametrize("how", ["over_budget", "off"])
def test_no_cache_falls_back_to_the_legacy_path(how):
    df = _reg_df(7)
    if how == "off":
        port_config.set_config(device_cache="off")
    else:
        port_config.set_config(device_cache_bytes=64)  # nothing fits
    lr = LinearRegression()
    grid = port_tuning.ParamGridBuilder().addGrid(lr.regParam, [0.0, 100.0]).build()
    cv = _cv(port_tuning, lr, grid, port_eval.RegressionEvaluator(), seed=1)
    model = cv.fit(df)
    assert not cv._last_fit_used_cache
    assert model.fit_report()["cache"]["outcome"] == how
    assert port_cache.CACHE_METRICS["resident_entries"] == 0
    assert model.bestIndex == 0


def test_out_of_memory_while_staging_takes_the_legacy_path(monkeypatch):
    """A staging that meets torch.cuda.OutOfMemoryError releases its
    reservation and the CV runs the legacy path; any other error reaches
    the caller."""
    df = _reg_df(8)
    lr = LinearRegression()
    grid = port_tuning.ParamGridBuilder().addGrid(lr.regParam, [0.0, 1.0]).build()
    real = RowStager.stage
    raised = []

    def failing(exc):
        def stage(self, arr, dtype=None):
            if np.ndim(arr) == 2 and not raised:
                raised.append(1)
                raise exc
            return real(self, arr, dtype)
        return stage

    monkeypatch.setattr(RowStager, "stage", failing(torch.cuda.OutOfMemoryError("full")))
    cv = _cv(port_tuning, lr, grid, port_eval.RegressionEvaluator())
    model = cv.fit(df)
    assert not cv._last_fit_used_cache
    assert model.fit_report()["cache"]["outcome"] == "oom"
    assert port_cache.get_device_cache().claimed_bytes() == 0
    port_config.set_config(device_cache="off")
    want = _cv(port_tuning, lr, grid, port_eval.RegressionEvaluator()).fit(df)
    np.testing.assert_array_equal(model.avgMetrics, want.avgMetrics)
    port_config.set_config(device_cache="on")
    raised.clear()
    monkeypatch.setattr(RowStager, "stage", failing(RuntimeError("not memory")))
    with pytest.raises(RuntimeError, match="not memory"):
        _cv(port_tuning, lr, grid, port_eval.RegressionEvaluator()).fit(df)
    assert port_cache.get_device_cache().claimed_bytes() == 0


def test_fold_col_and_empty_folds():
    df = _reg_df(9, n=60)
    df["fold"] = np.arange(60) % 3
    lr = LinearRegression()
    grid = port_tuning.ParamGridBuilder().addGrid(lr.regParam, [0.0]).build()
    results = []
    for mod, est, ev in ((port_tuning, lr, port_eval.RegressionEvaluator()),
                         (jax_tuning, JaxLin(num_workers=1), jax_eval.RegressionEvaluator())):
        g = mod.ParamGridBuilder().addGrid(est.regParam, [0.0]).build()
        cv = mod.CrossValidator(estimator=est, estimatorParamMaps=g, evaluator=ev, numFolds=3,
                                foldCol="fold")
        results.append(cv.fit(df).avgMetrics)
    np.testing.assert_allclose(results[0], results[1], rtol=1e-6)
    bad = df.assign(fold=np.arange(60) % 4)
    cv = port_tuning.CrossValidator(estimator=lr, estimatorParamMaps=grid,
                                    evaluator=port_eval.RegressionEvaluator(), numFolds=3,
                                    foldCol="fold")
    with pytest.raises(ValueError, match="foldCol values"):
        cv.fit(bad)
    cv = _cv(port_tuning, lr, grid, port_eval.RegressionEvaluator(), k=50)
    with pytest.raises(ValueError, match="no validation rows"):
        cv.fit(df.iloc[:20])
    with pytest.raises(ValueError, match="requires estimator"):
        port_tuning.CrossValidator(estimator=lr).fit(df)


def test_cv_tuple_input():
    rng = np.random.default_rng(10)
    X = rng.normal(size=(150, 3))
    y = (X[:, 0] > 0).astype(float)
    lr = LogisticRegression(maxIter=30)
    grid = port_tuning.ParamGridBuilder().addGrid(lr.regParam, [0.0]).build()
    model = _cv(port_tuning, lr, grid, port_eval.MulticlassClassificationEvaluator(
        metricName="accuracy"), k=2).fit((X, y))
    assert len(model.avgMetrics) == 1 and model.avgMetrics[0] > 0.9
    with pytest.raises(TypeError, match="pandas DataFrame or"):
        _cv(port_tuning, lr, grid, port_eval.RegressionEvaluator()).fit(X)


# ---------------------------------------------------------------------------
# The dataset cache: fingerprint, fold views, budget
# ---------------------------------------------------------------------------


def _entry(rng, n=333, d=5, with_weights=True):
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32) if with_weights else None
    entry = port_cache.get_or_stage(X, y, w, dtype=np.float32, label_dtype=np.float32)
    assert entry is not None
    return X, y, w, entry


def test_fingerprint_depends_on_content_labels_and_dtype(rng):
    X = rng.normal(size=(64, 3)).astype(np.float32)
    fp = port_cache.dataset_fingerprint(X, None, None, np.float32, None, "cpu")
    assert fp == port_cache.dataset_fingerprint(X.copy(), None, None, np.float32, None, "cpu")
    X2 = X.copy()
    X2[5, 1] += 1e-3
    assert fp != port_cache.dataset_fingerprint(X2, None, None, np.float32, None, "cpu")
    assert fp != port_cache.dataset_fingerprint(X, None, None, np.float64, None, "cpu")
    assert fp != port_cache.dataset_fingerprint(X.astype(np.float64), None, None, np.float32,
                                                None, "cpu")
    y = np.ones(64, np.float32)
    assert fp != port_cache.dataset_fingerprint(X, y, None, np.float32, np.float32, "cpu")
    assert fp != port_cache.dataset_fingerprint(X, None, None, np.float32, None, "cuda:0")
    # a large array (hashed in blocks on threads): a swap of two rows outside
    # the JAX package's row sample still changes the key
    big = rng.normal(size=(70_000, 256)).astype(np.float32)
    fb = port_cache.dataset_fingerprint(big, None, None, np.float32, None, "cpu")
    swapped = big.copy()
    swapped[[1, 2]] = swapped[[2, 1]]
    assert fb != port_cache.dataset_fingerprint(swapped, None, None, np.float32, None, "cpu")


def test_fingerprint_sees_a_one_ulp_edit_of_a_large_array(rng):
    # over the 64 MB block size, one element of a row the JAX package's
    # strided sample skips (it takes every n // 1024-th row) moved by one
    # float32 ulp, in the first block and in the last, changes the key
    big = rng.normal(size=(70_000, 256)).astype(np.float32)
    assert big.nbytes > port_cache._HASH_BLOCK_BYTES
    fb = port_cache.dataset_fingerprint(big, None, None, np.float32, None, "cpu")
    assert fb == port_cache.dataset_fingerprint(big.copy(), None, None, np.float32, None, "cpu")
    stride = big.shape[0] // 1024
    for row in (1, big.shape[0] - 2):
        assert row % stride
        edited = big.copy()
        edited[row, 7] = np.nextafter(edited[row, 7], np.float32(np.inf))
        assert fb != port_cache.dataset_fingerprint(edited, None, None, np.float32, None,
                                                    "cpu")


def test_mask_view_zeroes_exactly_the_fold(rng):
    X, y, w, entry = _entry(rng)
    folds = rng.integers(0, 3, X.shape[0])
    fold_set = entry.fold_set(folds)
    for fold in range(3):
        view = fold_set.train_view(fold)
        np.testing.assert_array_equal(view.weight.numpy(), np.where(folds != fold, w, 0.0))
        assert view.X is entry.dataset.X and view.y is entry.dataset.y
    with pytest.raises(ValueError, match="fold array has"):
        entry.fold_set(folds[:-1])


@pytest.mark.parametrize("with_weights", [True, False])
def test_gather_view_equals_a_fresh_staging(rng, with_weights):
    X, y, w, entry = _entry(rng, with_weights=with_weights)
    folds = rng.integers(0, 3, X.shape[0])
    fold_set = entry.fold_set(folds)
    for fold in range(3):
        sel = folds != fold
        view = fold_set.gather_train_view(fold)
        fresh = DeviceDataset.from_host(X[sel], y=y[sel], weight=None if w is None else w[sel],
                                        dtype=np.float32)
        assert view.n_valid == fresh.n_valid == int(sel.sum())
        for a, b in ((view.X, fresh.X), (view.y, fresh.y), (view.weight, fresh.weight)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="selects no rows"):
        entry._gather_view(np.zeros(X.shape[0], bool), "nothing")


def test_eval_view_scores_the_fold_rows():
    df = _reg_df(11)
    lr = LinearRegression()
    entry = lr._cached_fit_entry(df)
    assert entry is not None
    folds = np.random.default_rng(1).integers(0, 3, len(df))
    fold_set = entry.fold_set(folds)
    model = lr.fit(entry.dataset)
    ev = port_eval.RegressionEvaluator(metricName="rmse")
    rows = df[folds == 1].reset_index(drop=True)
    (cached,) = fold_set.eval_view(1, rows).evaluate([model], ev)
    assert cached == ev.evaluate(model.transform(rows))
    with pytest.raises(ValueError, match="no validation rows"):
        fold_set.eval_view(5, rows)


def test_lru_eviction_under_the_budget(rng):
    X, y, w, entry = _entry(rng)
    one = entry.nbytes
    port_cache.clear_device_cache()
    port_config.set_config(device_cache_bytes=one + one // 2)  # room for one entry
    e0, s0 = port_cache.CACHE_METRICS["evictions"], _stagings()
    e1 = port_cache.get_or_stage(X, y, w, dtype=np.float32, label_dtype=np.float32)
    e2 = port_cache.get_or_stage(X + 1.0, y, w, dtype=np.float32, label_dtype=np.float32)
    assert e1 is not None and e2 is not None
    assert port_cache.CACHE_METRICS["evictions"] - e0 == 1
    assert port_cache.CACHE_METRICS["resident_entries"] == 1
    assert port_cache.CACHE_METRICS["resident_bytes"] <= one + one // 2
    e1b = port_cache.get_or_stage(X, y, w, dtype=np.float32, label_dtype=np.float32)
    assert e1b is not None and e1b is not e1
    assert _stagings() - s0 == 3


def test_resident_bytes_count_in_the_budget_and_are_evicted_first(rng):
    X, y, w, entry = _entry(rng)
    assert port_cache.cache_resident_bytes() == entry.nbytes
    lr = LinearRegression()
    budget = port_cache.device_data_budget_bytes()
    assert not lr._over_device_budget(1024)
    assert port_cache.cache_resident_bytes() == entry.nbytes
    assert not lr._over_device_budget(budget - entry.nbytes + 1)
    assert port_cache.cache_resident_bytes() == 0
    assert lr._over_device_budget(budget + 1)


def test_a_hit_tops_up_its_reservation(rng):
    X, y, w, entry = _entry(rng)
    assert entry.nbytes == entry.base_bytes
    again = port_cache.get_or_stage(X, y, w, dtype=np.float32, label_dtype=np.float32,
                                    working_factor=4.0)
    assert again is entry and entry.nbytes == entry.base_bytes * 4
    port_config.set_config(device_cache_bytes=entry.nbytes + 1)
    assert port_cache.get_or_stage(X, y, w, dtype=np.float32, label_dtype=np.float32,
                                   working_factor=100.0) is None
    assert port_cache.CACHE_METRICS["resident_entries"] == 1


def test_reservation_and_decisions_follow_jax():
    """The reservation is the arrays' bytes times (devices + 2): 3 on one
    device, as the JAX package's on one; so a budget between one and three
    times the arrays sends both packages' CVs to the legacy path."""
    df = _reg_df(12, n=256)  # a shape bucket of the JAX package: no padding rows
    X = np.stack(df["features"].to_numpy()).astype(np.float32)
    need = X.shape[0] * (X.shape[1] * 4 + 4 + 4)
    entry = LinearRegression()._cached_fit_entry(df)
    assert entry.base_bytes == need and entry.nbytes == 3 * need
    port_cache.clear_device_cache()
    for budget, used in ((2 * need, False), (3 * need, True)):
        port_config.set_config(device_cache_bytes=budget)
        jax_config.set_config(device_cache_bytes=budget)
        port_cache.clear_device_cache()
        jax_cache.clear_device_cache()
        got = LinearRegression()._cached_fit_entry(df)
        want = JaxLin(num_workers=1)._cached_fit_entry(df)
        assert (got is not None) == used == (want is not None)


# ---------------------------------------------------------------------------
# CrossValidatorModel save/load, both directions
# ---------------------------------------------------------------------------


def _cv_models(tmp_path, df):
    grid = lambda est: port_tuning.ParamGridBuilder().addGrid(est.regParam, [0.0, 0.5]).build()
    port_lr = LogisticRegression(maxIter=30)
    port_model = _cv(port_tuning, port_lr, grid(port_lr),
                     port_eval.MulticlassClassificationEvaluator(metricName="accuracy"),
                     k=2).fit(df)
    jax_lr = JaxLR(maxIter=30, num_workers=1)
    jax_grid = jax_tuning.ParamGridBuilder().addGrid(jax_lr.regParam, [0.0, 0.5]).build()
    jax_model = _cv(jax_tuning, jax_lr, jax_grid,
                    jax_eval.MulticlassClassificationEvaluator(metricName="accuracy"),
                    k=2).fit(df)
    return port_model, jax_model


def test_cv_model_save_load_both_directions(tmp_path, monkeypatch):
    import importlib

    df = _clf_df(13)
    port_model, jax_model = _cv_models(tmp_path, df)
    port_dir, jax_dir = str(tmp_path / "port_cv"), str(tmp_path / "jax_cv")
    port_model.save(port_dir)
    jax_model.save(jax_dir)
    # the port loads the JAX package's directory into its own model class,
    # importing no module the metadata names
    imported = []
    real_import = importlib.import_module
    monkeypatch.setattr(importlib, "import_module",
                        lambda name, *a: imported.append(name) or real_import(name, *a))
    from_jax = port_tuning.CrossValidatorModel.load(jax_dir)
    assert imported == []
    assert type(from_jax.bestModel) is type(port_model.bestModel)
    assert from_jax.avgMetrics == jax_model.avgMetrics
    assert from_jax.bestIndex == jax_model.bestIndex
    np.testing.assert_array_equal(from_jax.transform(df)["prediction"].to_numpy(),
                                  jax_model.transform(df)["prediction"].to_numpy())
    again = port_tuning.CrossValidatorModel.load(port_dir)
    assert again.avgMetrics == port_model.avgMetrics and again.fit_report() is None
    np.testing.assert_array_equal(again.transform(df)["prediction"].to_numpy(),
                                  port_model.transform(df)["prediction"].to_numpy())
    monkeypatch.undo()
    # the JAX package's load imports the module the metadata names: the
    # port's, so its best model is the port's class
    from_port = jax_tuning.CrossValidatorModel.load(port_dir)
    assert type(from_port.bestModel) is type(port_model.bestModel)
    assert from_port.avgMetrics == port_model.avgMetrics
    np.testing.assert_array_equal(from_port.transform(df)["prediction"].to_numpy(),
                                  port_model.transform(df)["prediction"].to_numpy())
    with pytest.raises(ValueError, match="no model class of the port"):
        port_tuning._port_model_class("somewhere.NotAModel")


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def _scalar_df(seed=14, n=200):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"a": rng.normal(size=n), "b": rng.normal(size=n),
                       "c": rng.normal(size=n)})
    df["label"] = (df["a"] - df["b"] > 0).astype(float)
    return df


def test_vector_assembler_matches_jax():
    df = _scalar_df()
    got = port_pipeline.VectorAssembler(inputCols=["a", "c"], outputCol="v").transform(df)
    want = jax_pipeline.VectorAssembler(inputCols=["a", "c"], outputCol="v").transform(df)
    np.testing.assert_array_equal(np.stack(got["v"].to_numpy()), np.stack(want["v"].to_numpy()))
    with pytest.raises(TypeError, match="pandas"):
        port_pipeline.VectorAssembler(inputCols=["a"], outputCol="v").transform({"a": [1.0]})


@pytest.mark.parametrize("est", ["logistic", "linear"])
def test_pipeline_assembler_bypass_matches_an_explicit_features_cols_fit(est):
    df = _scalar_df()
    make = (lambda: LogisticRegression(maxIter=50)) if est == "logistic" else LinearRegression
    pipe = port_pipeline.Pipeline(stages=[
        port_pipeline.VectorAssembler(inputCols=["a", "b", "c"], outputCol="features"),
        make()])
    model = pipe.fit(df)
    assert isinstance(model.stages[0], port_pipeline.NoOpTransformer)
    assert isinstance(model, port_pipeline.PipelineModel)
    got = model.transform(df)["prediction"].to_numpy()
    explicit = make().setFeaturesCol(["a", "b", "c"]).fit(df)
    np.testing.assert_array_equal(got, explicit.transform(df)["prediction"].to_numpy())
    np.testing.assert_array_equal(model.stages[1].coef_ if est == "linear"
                                  else model.stages[1].coefficients,
                                  explicit.coef_ if est == "linear" else explicit.coefficients)
    assembled = port_pipeline.VectorAssembler(inputCols=["a", "b", "c"],
                                              outputCol="features").transform(df)
    direct = make().fit(assembled)
    np.testing.assert_allclose(got, direct.transform(assembled)["prediction"].to_numpy(),
                               rtol=1e-6, atol=1e-6)
    jax_est = JaxLR(maxIter=50, num_workers=1) if est == "logistic" else JaxLin(num_workers=1)
    ref = jax_pipeline.Pipeline(stages=[
        jax_pipeline.VectorAssembler(inputCols=["a", "b", "c"], outputCol="features"),
        jax_est]).fit(df)
    np.testing.assert_allclose(got, ref.transform(df)["prediction"].to_numpy(),
                               rtol=1e-4, atol=1e-4)


def test_pipeline_without_a_bypass_and_what_raises():
    df = _scalar_df(15, n=50)
    pipe = port_pipeline.Pipeline(stages=[
        port_pipeline.VectorAssembler(inputCols=["a", "b"], outputCol="other"),
        LogisticRegression(maxIter=20)])
    with pytest.raises(ValueError, match="features"):
        pipe.fit(df)
    with pytest.raises(TypeError, match="neither"):
        port_pipeline.Pipeline(stages=[object()]).fit(df)
    model = port_pipeline.Pipeline(stages=[
        port_pipeline.VectorAssembler(inputCols=["a", "b"], outputCol="v"),
        LogisticRegression(maxIter=20).setFeaturesCol("v")]).fit(df)
    assert isinstance(model.stages[0], port_pipeline.NoOpTransformer)
    assert "prediction" in model.transform(df).columns
