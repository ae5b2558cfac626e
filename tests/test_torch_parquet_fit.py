#
# The port's estimators fitted from a parquet path (core.py `_stage_or_stream`)
# on the CPU: each route (the staged DeviceDataset, the fused pass from
# parquet, the streamed fits, the blocked-CSR statistics) against the same
# estimator's fit of the same rows in memory and against the JAX package's
# fit of the same file; the routing by `hbm_bytes`, `force_streaming_stats`
# and `streaming_ingest`; the fallback of a card out of memory; and the
# streamed LogisticRegression model's save/load across the two packages.
# Every JAX float64 call runs inside `jax.enable_x64(True)` (the flag is
# checked at module teardown).
#
import jax
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import streaming as port_streaming
from spark_rapids_ml_torch.classification import (
    LogisticRegression,
    LogisticRegressionModel,
    RandomForestClassifier,
)
from spark_rapids_ml_torch.clustering import KMeans
from spark_rapids_ml_torch.feature import PCA
from spark_rapids_ml_torch.regression import LinearRegression
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR
from spark_rapids_ml_tpu.classification import LogisticRegressionModel as JaxLRModel
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinReg


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
    jax_config.set_config(chunk_cache="off")
    yield
    port_config.reset_config()
    jax_config.reset_config()
    set_default_device(None)


def _rows(seed, n=1200, d=6, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(size=d)
    X[:, 0] *= 4.0  # a dominant direction for PCA
    W = rng.normal(size=(classes, d))
    y = np.argmax(X @ W.T + 0.5 * rng.normal(size=(n, classes)), axis=1).astype(np.float64)
    w = rng.choice([0.25, 0.5, 1.0, 1.5, 2.0], size=n)
    return X, y, w


def _write(path, X, y=None, w=None, row_group_size=None):
    cols = {"features": pa.FixedSizeListArray.from_arrays(pa.array(np.asarray(X).reshape(-1)),
                                                           X.shape[1])}
    if y is not None:
        cols["label"] = pa.array(np.asarray(y, np.float64))
    if w is not None:
        cols["wt"] = pa.array(np.asarray(w, np.float64))
    pq.write_table(pa.table(cols), str(path), row_group_size=row_group_size)
    return str(path)


def _frame(X, y=None, w=None):
    out = {"features": X}
    if y is not None:
        out["label"] = y
    if w is not None:
        out["wt"] = w
    return out


_ESTIMATORS = {
    "PCA": (lambda **kw: PCA(k=3, **kw).setInputCol("features"), "components_", False),
    "LinearRegression": (lambda **kw: LinearRegression(regParam=0.01, **kw).setWeightCol("wt"),
                         "coef_", True),
    "LogisticRegression": (lambda **kw: LogisticRegression(regParam=0.01, **kw)
                           .setWeightCol("wt"), "coef_", True),
    "KMeans": (lambda **kw: KMeans(k=3, seed=2, **kw).setWeightCol("wt"),
               "cluster_centers_", True),
    "RandomForestClassifier": (lambda **kw: RandomForestClassifier(numTrees=2, maxDepth=3,
                                                                   seed=1, **kw),
                               None, False),
}


@pytest.mark.parametrize("name", sorted(_ESTIMATORS))
@pytest.mark.parametrize("f32", [True, False])
def test_fit_from_parquet_equals_in_memory(tmp_path, name, f32):
    """Within the budget and below the fused threshold every estimator
    stream-stages the file into one device tensor and runs its
    `_fit_array`: the same model, bit for bit, as the fit of the same rows
    in memory."""
    make, _, weighted = _ESTIMATORS[name]
    X, y, w = _rows(1)
    path = _write(tmp_path / "a.parquet", X, y, w if weighted else None, row_group_size=300)
    port_config.set_config(host_batch_bytes=8192)
    m = make(float32_inputs=f32).fit(path)
    rep = m.fit_report()
    assert rep["route"] == "staged_parquet"
    assert rep["stage"]["rows"] == 1200 and rep["stage"]["chunks"] >= 2
    if name != "RandomForestClassifier":
        assert rep["budget"]["over"] is False
    mem = make(float32_inputs=f32).fit(_frame(X, y, w if weighted else None))
    assert mem.fit_report()["route"] == "staged"
    a, b = m._get_model_attributes(), mem._get_model_attributes()
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif k != "trees":
            assert a[k] == b[k], k
    if name == "RandomForestClassifier":
        np.testing.assert_array_equal(m.transform(X)["prediction"],
                                      mem.transform(X)["prediction"])


@pytest.mark.parametrize("f32", [True, False])
def test_fused_parquet_matches_two_phase(tmp_path, f32):
    """`fused_stage_solve="on"`: PCA and LinearRegression fold the
    statistics from the parquet readers (three range readers here); the
    models agree with the two-phase fit (1e-10 float64; float32 1e-4, the
    JAX package's limit) and with the JAX package's fused fit of the file."""
    X, y, _ = _rows(2, n=5000, d=8)
    path = _write(tmp_path / "fused.parquet", X, y, row_group_size=1000)
    kw = dict(regParam=0.0, elasticNetParam=0.0, float32_inputs=f32)
    port_config.set_config(fused_stage_solve="off")
    ref_lr = LinearRegression(**kw).fit(path)
    ref_pca = PCA(k=2, float32_inputs=f32).setInputCol("features").fit(path)
    port_config.set_config(fused_stage_solve="on", fused_parquet_readers=3)
    lr = LinearRegression(**kw).fit(path)
    pca = PCA(k=2, float32_inputs=f32).setInputCol("features").fit(path)
    for m in (lr, pca):
        rep = m.fit_report()
        assert rep["route"] == "fused_parquet"
        assert rep["parquet_readers"]["parquet_readers"] == 3 and rep["fused"]["chunks"] >= 5
    tol = 1e-4 if f32 else 1e-10
    np.testing.assert_allclose(lr.coef_, ref_lr.coef_, rtol=tol, atol=tol)
    np.testing.assert_allclose(np.abs(pca.components_), np.abs(ref_pca.components_),
                               rtol=tol, atol=tol)
    jax_config.set_config(fused_stage_solve="on", fused_parquet_readers=3)
    with jax.enable_x64(not f32):
        j_lr = JaxLinReg(**kw).fit(path)
        j_pca = JaxPCA(k=2, float32_inputs=f32).setInputCol("features").fit(path)
    np.testing.assert_allclose(lr.coef_, j_lr.coef_, rtol=tol, atol=tol)
    np.testing.assert_allclose(pca.components_, j_pca.components_, rtol=tol, atol=tol)
    np.testing.assert_allclose(pca.explained_variance_, j_pca.explained_variance_, rtol=tol)


@pytest.mark.parametrize("name", ["PCA", "LinearRegression"])
def test_streamed_statistics_fits_match_jax(tmp_path, name):
    """`force_streaming_stats`: the fit from one streamed pass of the
    statistics equals the JAX package's streamed fit of the file (float64,
    1e-10) and the port's in-memory fit (1e-9)."""
    X, y, w = _rows(3)
    path = _write(tmp_path / "s.parquet", X, y, w, row_group_size=500)
    if name == "PCA":
        make, jmake, key = (lambda: PCA(k=3, float32_inputs=False).setInputCol("features"),
                            lambda: JaxPCA(k=3, float32_inputs=False).setInputCol("features"),
                            "components_")
    else:
        make, jmake, key = (
            lambda: LinearRegression(regParam=0.01, float32_inputs=False).setWeightCol("wt"),
            lambda: JaxLinReg(regParam=0.01, float32_inputs=False).setWeightCol("wt"), "coef_")
    port_config.set_config(force_streaming_stats=True, host_batch_bytes=8192)
    jax_config.set_config(force_streaming_stats=True, host_batch_bytes=8192)
    m = make().fit(path)
    rep = m.fit_report()
    assert rep["route"] == "streamed" and rep["budget"]["forced"]
    assert rep["streaming"]["chunks"] >= 2
    with jax.enable_x64(True):
        jm = jmake().fit(path)
    np.testing.assert_allclose(getattr(m, key), getattr(jm, key), rtol=1e-10, atol=1e-12)
    port_config.set_config(force_streaming_stats=False)
    mem = make().fit(_frame(X, y, w))
    np.testing.assert_allclose(getattr(m, key), getattr(mem, key), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("case", ["binomial", "multinomial_weights"])
def test_streamed_logreg_fit_matches_jax_in_memory(tmp_path, case):
    """The estimator's streamed fit (coefficients unscaled, multinomial
    intercepts centred) against the JAX package's float64 fit of the same
    rows on its host-driven solver: objective 1e-10, the same iterations;
    the model records its passes over the file."""
    multi = case != "binomial"
    X, y, w = _rows(4, n=900, d=4, classes=3 if multi else 2)
    path = _write(tmp_path / "lr.parquet", X, y, w if multi else None, row_group_size=300)
    kw = dict(regParam=0.02, standardization=False, tol=1e-10, maxIter=50, float32_inputs=False)
    port_config.set_config(force_streaming_stats=True, host_batch_bytes=8192)
    est = LogisticRegression(**kw)
    jest = JaxLR(**kw)
    if multi:
        est.setWeightCol("wt")
        jest.setWeightCol("wt")
    m = est.fit(path)
    assert m.fit_report()["route"] == "streamed"
    attrs = m._get_model_attributes()
    assert attrs["streaming_epochs"] >= m.num_iters + 1
    assert m.fit_report()["streaming"]["epochs"] == attrs["streaming_epochs"]
    jax_config.set_config(dispatch_flops_limit=1.0)
    with jax.enable_x64(True):
        jm = jest.fit(pd.DataFrame(_frame(list(X), y, w if multi else None)))
    assert m.num_iters == jm.num_iters
    np.testing.assert_allclose(m.objective, jm.objective, rtol=1e-10)
    np.testing.assert_allclose(m.coef_, jm.coef_, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(m.intercept_, jm.intercept_, rtol=1e-7, atol=1e-9)


def test_streamed_kmeans_fit_equals_in_memory(tmp_path):
    """KMeans beyond the budget: at fewer rows than the seeding sample the
    sample is every row, so the streamed fit seeds as the in-memory one
    and equals it in float64 (1e-12)."""
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal(size=(300, 4)) + c for c in (-6.0, 0.0, 6.0)])
    w = rng.uniform(0.5, 2.0, 900)
    path = _write(tmp_path / "km.parquet", X, w=w, row_group_size=200)
    port_config.set_config(hbm_bytes=1024, host_batch_bytes=4096)
    def make():
        return KMeans(k=3, seed=4, maxIter=40, float32_inputs=False).setWeightCol("wt")

    m = make().fit(path)
    rep = m.fit_report()
    assert rep["route"] == "streamed" and rep["budget"]["over"] and not rep["budget"]["forced"]
    assert rep["streaming"]["epochs"] == m.n_iter_ + 1
    port_config.reset_config()
    mem = make().fit(_frame(X, w=w))
    assert m.n_iter_ == mem.n_iter_
    np.testing.assert_allclose(m.cluster_centers_, mem.cluster_centers_, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(m.inertia_, mem.inertia_, rtol=1e-12)


@pytest.mark.parametrize("name", ["PCA", "LinearRegression", "LogisticRegression", "KMeans"])
def test_budget_routes_to_the_streamed_fit(tmp_path, name):
    """hbm_bytes below the file's size sends it to the streamed fit without
    the force flag, to the same model as the forced one; a budget above it
    does not."""
    make, key, weighted = _ESTIMATORS[name]
    X, y, w = _rows(6, n=600)
    path = _write(tmp_path / "b.parquet", X, y, w if weighted else None)
    port_config.set_config(hbm_bytes=10_000)  # budget 8,000 B < 600 x 6 x 4 B
    by_budget = make().fit(path)
    assert by_budget.fit_report()["route"] == "streamed"
    port_config.set_config(hbm_bytes=None, force_streaming_stats=True)
    forced = make().fit(path)
    np.testing.assert_array_equal(getattr(by_budget, key), getattr(forced, key))
    port_config.set_config(hbm_bytes=1 << 30, force_streaming_stats=False)
    assert make().fit(path).fit_report()["route"] == "staged_parquet"


@pytest.mark.parametrize("name", ["PCA", "LinearRegression"])
def test_csr_beyond_budget_fits_from_blocked_statistics(name):
    """A CSR matrix whose dense form is beyond the budget fits from
    blocked-densify statistics: the JAX package's CSR fit (float64, 1e-10)
    and the dense fit (1e-9); within the budget it is densified."""
    X, y, w = _rows(7, n=800, d=10)
    X[np.abs(X) < 1.5] = 0.0
    csr = sp.csr_matrix(X)
    if name == "PCA":
        make, jmake, key, data = (lambda: PCA(k=2, float32_inputs=False),
                                  lambda: JaxPCA(k=2, float32_inputs=False), "components_",
                                  lambda A: A)
    else:
        make, jmake, key, data = (lambda: LinearRegression(float32_inputs=False),
                                  lambda: JaxLinReg(float32_inputs=False), "coef_",
                                  lambda A: (A, y))
    port_config.set_config(hbm_bytes=4096)
    jax_config.set_config(hbm_bytes=4096)
    m = make().fit(data(csr))
    assert m.fit_report()["route"] == "streamed_csr"
    with jax.enable_x64(True):
        jm = jmake().fit(data(csr))
    np.testing.assert_allclose(getattr(m, key), getattr(jm, key), rtol=1e-10, atol=1e-12)
    port_config.reset_config()
    dense = make().fit(data(X))
    within = make().fit(data(csr))
    assert within.fit_report()["route"] == "staged"
    np.testing.assert_allclose(getattr(m, key), getattr(dense, key), rtol=1e-9, atol=1e-11)
    port_config.set_config(hbm_bytes=4096)
    lr = LogisticRegression(float32_inputs=False).fit((csr, (y > 0).astype(np.float64)))
    assert lr.fit_report()["route"] == "staged"  # no CSR statistics: densified


def test_streaming_ingest_off_reads_the_file_whole(tmp_path):
    X, y, w = _rows(8, n=400)
    path = _write(tmp_path / "off.parquet", X, y, w)
    port_config.set_config(streaming_ingest=False, force_streaming_stats=True)
    m = LinearRegression().setWeightCol("wt").fit(path)
    assert m.fit_report()["route"] == "staged"
    port_config.reset_config()
    np.testing.assert_array_equal(m.coef_, LinearRegression().setWeightCol("wt")
                                  .fit(_frame(X, y, w)).coef_)


def test_directory_dataset_and_feature_columns(tmp_path):
    """A dataset directory of two files, and scalar featuresCols, take the
    same routes: the fit equals the in-memory one."""
    X, y, w = _rows(9, n=700, d=4)
    ddir = tmp_path / "ds"
    ddir.mkdir()
    _write(ddir / "part-0.parquet", X[:300], y[:300])
    _write(ddir / "part-1.parquet", X[300:], y[300:])
    for fused in ("off", "on"):
        port_config.set_config(fused_stage_solve=fused)
        m = LinearRegression(float32_inputs=False).fit(str(ddir))
        assert m.fit_report()["route"] == ("fused_parquet" if fused == "on" else "staged_parquet")
        mem = LinearRegression(float32_inputs=False).fit((X, y))
        np.testing.assert_allclose(m.coef_, mem.coef_, rtol=1e-10)
    cols = {f"f{j}": X[:, j] for j in range(4)}
    pq.write_table(pa.table({**cols, "label": y}), str(tmp_path / "cols.parquet"))
    port_config.reset_config()
    m = LinearRegression(featuresCols=list(cols)).fit(str(tmp_path / "cols.parquet"))
    np.testing.assert_array_equal(
        m.coef_, LinearRegression(featuresCols=list(cols)).fit({**cols, "label": y}).coef_)


def test_out_of_memory_while_staging_takes_the_streamed_fit(tmp_path, monkeypatch):
    """A card out of memory while staging: an estimator that can fit
    streamed does so (recorded in fit_report()), one that cannot raises,
    and any other error reaches the caller."""
    X, y, _ = _rows(10, n=500)
    path = _write(tmp_path / "oom.parquet", X, y)
    real = port_streaming.stage_parquet

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(port_streaming, "stage_parquet", oom)
    m = LogisticRegression(regParam=0.01).fit(path)
    rep = m.fit_report()
    assert rep["route"] == "streamed" and rep["oom_fallback"] is True
    port_config.set_config(force_streaming_stats=True)
    np.testing.assert_array_equal(m.coef_, LogisticRegression(regParam=0.01).fit(path).coef_)
    port_config.reset_config()
    with pytest.raises(RuntimeError, match="cannot fit from streamed"):
        RandomForestClassifier(numTrees=1, maxDepth=2).fit(path)

    def broken(*a, **kw):
        raise ValueError("decode failed")

    monkeypatch.setattr(port_streaming, "stage_parquet", broken)
    with pytest.raises(ValueError, match="decode failed"):
        LogisticRegression().fit(path)
    monkeypatch.setattr(port_streaming, "stage_parquet", real)
    assert LogisticRegression().fit(path).fit_report()["route"] == "staged_parquet"


def test_streamed_logreg_model_loads_in_both_packages(tmp_path):
    """The streamed model's extra attributes (converged, streaming_epochs)
    keep the on-disk format: a model saved by either package loads in the
    other and predicts the same."""
    X, y, _ = _rows(11, n=500, d=4)
    path = _write(tmp_path / "rt.parquet", X, y)
    port_config.set_config(force_streaming_stats=True)
    # the JAX package pads every streamed chunk to the host budget's rows
    jax_config.set_config(force_streaming_stats=True, host_batch_bytes=8192)
    m = LogisticRegression(regParam=0.01, maxIter=20).fit(path)
    m.save(str(tmp_path / "port"))
    jm = JaxLRModel.load(str(tmp_path / "port"))
    assert jm._model_attributes["streaming_epochs"] == m._get_model_attributes()["streaming_epochs"]
    np.testing.assert_array_equal(jm.coef_, m.coef_)
    jfit = JaxLR(regParam=0.01, maxIter=20).fit(path)
    jfit.save(str(tmp_path / "jax"))
    back = LogisticRegressionModel.load(str(tmp_path / "jax"))
    assert back._get_model_attributes()["streaming_epochs"] == \
        jfit._model_attributes["streaming_epochs"]
    np.testing.assert_array_equal(back.coef_, jfit.coef_)
    np.testing.assert_array_equal(back.transform(X)["prediction"],
                                  np.asarray(jfit.transform(pd.DataFrame({"features": list(X)}))
                                             ["prediction"]))
    assert back.fit_report() is None
