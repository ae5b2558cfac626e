#
# The port's host layer against the JAX package: Params and defaults,
# `extract_arrays`, the config, the conversion of fitted models both ways
# (spark_rapids_ml_torch/convert.py), cross-loading saved models in both
# directions, the one-device stager, and the device rule.
#
import json
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import scipy.sparse as sp
import torch

import spark_rapids_ml_torch as port
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.convert import (
    model_params,
    nn_model_from_reference,
    nn_model_to_reference_attributes,
)
from spark_rapids_ml_torch.data import extract_arrays
from spark_rapids_ml_torch.knn import NearestNeighbors, NearestNeighborsModel
from spark_rapids_ml_torch.parallel import DeviceContext, RowStager, resolve_device
from spark_rapids_ml_torch.parallel import mesh as port_mesh
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.core import _ReadWriteMixin as JaxReadWrite
from spark_rapids_ml_tpu.data import extract_arrays as jax_extract_arrays
from spark_rapids_ml_tpu.knn import NearestNeighbors as JaxNearestNeighbors
from spark_rapids_ml_tpu.knn import NearestNeighborsModel as JaxNearestNeighborsModel


@pytest.fixture(autouse=True)
def _cpu_and_clean_config():
    set_default_device("cpu")
    port_config.reset_config()
    jax_config.reset_config()
    yield
    port_config.reset_config()
    jax_config.reset_config()
    set_default_device(None)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def _data(seed=0, n=120, q=15, d=6):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(q, d)).astype(np.float32)


def _knn(model, queries):
    _, _, df = model.kneighbors(queries)
    return np.stack(df["indices"]), np.stack(df["distances"])


# ---------------------------------------------------------------------------
# Params and config
# ---------------------------------------------------------------------------


def test_params_and_defaults_match_jax():
    a, b = NearestNeighbors(), JaxNearestNeighbors()
    assert [p.name for p in a.params] == [p.name for p in b.params]
    for p in a.params:
        assert a.hasDefault(p.name) == b.hasDefault(p.name)
        if a.hasDefault(p.name):
            assert a.getOrDefault(p.name) == b.getOrDefault(p.name)
    assert a.tpu_params == b.tpu_params == {"n_neighbors": 5, "verbose": False}
    a, b = NearestNeighbors(k=9).setFeaturesCol(["x", "y"]), JaxNearestNeighbors(k=9)
    b.setFeaturesCol(["x", "y"])
    assert a.tpu_params == b.tpu_params
    assert a.getFeaturesCols() == b.getFeaturesCols() == ["x", "y"]
    assert a.copy().getK() == 9 and a.copy().tpu_params["n_neighbors"] == 9
    assert "k: The number of nearest neighbors" in a.explainParams()
    with pytest.raises(ValueError, match="Unsupported param"):
        NearestNeighbors(not_a_param=1)


def test_config_defaults_env_and_reset(monkeypatch):
    assert port_config.get_config("pallas_knn") == "on"  # the JAX default is "off"
    assert port_config.get_config("distance_precision") == jax_config.get_config(
        "distance_precision")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PALLAS_KNN", "off")
    assert port_config.get_config("pallas_knn") == "off"
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_DISTANCE_PRECISION", "high")
    assert port_config.get_config("distance_precision") == "high"
    # keys of later slices are not settable until the port reads them
    with pytest.raises(KeyError):
        port_config.set_config(knn_replicate_max_bytes=123)
    port_config.set_config(pallas_knn="auto")
    assert port_config.get_config("pallas_knn") == "auto"
    port_config.reset_config()
    assert port_config.get_config("pallas_knn") == "off"


# ---------------------------------------------------------------------------
# extract_arrays
# ---------------------------------------------------------------------------


def _datasets():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(12, 3))
    ids = np.arange(12) + 40
    df = pd.DataFrame({"features": list(X), "id": ids})
    return {
        "ndarray": (X, {}),
        "int_ndarray": (np.arange(12).reshape(4, 3), {}),
        "tuple": ((X, np.arange(12) % 2), {}),
        "csr": (sp.csr_matrix(np.where(X > 0.5, X, 0.0)), {}),
        "df_vector_col": (df, {"features_col": "features", "id_col": "id"}),
        "df_scalar_cols": (pd.DataFrame(X, columns=["a", "b", "c"]),
                           {"features_cols": ["a", "b", "c"]}),
        "arrow_table": (pa.Table.from_pandas(df), {"features_col": "features", "id_col": "id"}),
        "f32_df": (pd.DataFrame({"features": list(X.astype(np.float32))}),
                   {"features_col": "features"}),
    }


@pytest.mark.parametrize("name", list(_datasets()))
def test_extract_arrays_matches_jax(name):
    data, kw = _datasets()[name]
    a, b = extract_arrays(data, **kw), jax_extract_arrays(data, **kw)
    if sp.issparse(b.X):
        assert sp.issparse(a.X)
        np.testing.assert_array_equal(a.X.toarray(), b.X.toarray())
    else:
        assert a.X.dtype == b.X.dtype and a.X.flags.c_contiguous
        np.testing.assert_array_equal(a.X, b.X)
    for f in ("y", "weight", "row_id"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None)
        if va is not None:
            np.testing.assert_array_equal(va, vb)


def test_extract_arrays_mapping_and_errors():
    X = np.arange(12.0).reshape(4, 3)
    batch = extract_arrays({"features": X, "id": np.arange(4)}, features_col="features",
                           id_col="id")
    np.testing.assert_array_equal(batch.X, X)
    np.testing.assert_array_equal(batch.row_id, np.arange(4))
    with pytest.raises(ValueError, match="not found"):
        extract_arrays({"f": X}, features_col="features")
    with pytest.raises(ValueError, match="different lengths"):
        extract_arrays({"features": X, "id": np.arange(3)}, features_col="features")


# ---------------------------------------------------------------------------
# convert.py and cross-loading
# ---------------------------------------------------------------------------


def test_convert_from_reference_and_back():
    X, Q = _data(2)
    ids = np.arange(len(X)) * 3 + 7
    df = pd.DataFrame({"features": list(X), "id": ids})
    qdf = pd.DataFrame({"features": list(Q)})
    ref = JaxNearestNeighbors(k=4, num_workers=1).setIdCol("id").fit(df)
    ported = nn_model_from_reference(ref._get_model_attributes(), model_params(ref))
    assert isinstance(ported, NearestNeighborsModel)
    assert ported.getK() == 4 and ported.getIdCol() == "id"
    ia, da = _knn(ported, qdf)
    ib, db = _knn(ref, qdf)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, atol=1e-3)

    attrs = nn_model_to_reference_attributes(ported)
    assert all(isinstance(v, np.ndarray) for k, v in attrs.items()
               if k in ("item_features", "item_ids"))
    back = JaxNearestNeighborsModel(**attrs)
    JaxReadWrite._restore_params(back, model_params(ported))
    back._num_workers = 1
    ic, dc = _knn(back, qdf)
    np.testing.assert_array_equal(ic, ib)
    np.testing.assert_allclose(dc, db, atol=1e-6)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_cross_load(tmp_path, saver):
    X, Q = _data(3)
    df = pd.DataFrame({"features": list(X), "id": np.arange(len(X)) + 500})
    qdf = pd.DataFrame({"features": list(Q)})
    ref = JaxNearestNeighbors(k=5, num_workers=1).setIdCol("id").fit(df)
    mine = NearestNeighbors(k=5).setIdCol("id").fit(df)
    path = str(tmp_path / "model")
    if saver == "jax":
        ref.save(path)
        loaded = NearestNeighborsModel.load(path)
        want = ref
    else:
        mine.save(path)
        loaded = JaxNearestNeighborsModel.load(path)
        loaded._num_workers = 1
        want = mine
    ia, da = _knn(loaded, qdf)
    ib, db = _knn(want, qdf)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, atol=1e-3)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    assert {"class", "uid", "paramMap", "defaultParamMap", "tpu_params", "num_workers",
            "float32_inputs", "attributes", "array_attributes"} <= set(meta)
    assert meta["array_attributes"] == ["item_features", "item_ids"]


def test_cross_load_sparse_from_jax(tmp_path):
    X, Q = _data(4)
    X[X < 0.3] = 0.0
    ref = JaxNearestNeighbors(k=3, num_workers=1).fit(sp.csr_matrix(X))
    ref.save(str(tmp_path / "m"))
    loaded = NearestNeighborsModel.load(str(tmp_path / "m"))
    assert sp.issparse(loaded.item_features)
    np.testing.assert_array_equal(_knn(loaded, Q)[0], _knn(ref, Q)[0])


def test_overwrite_save_leaves_no_stale_drift_baseline(tmp_path):
    """The JAX package fits PCA with its drift baseline on and saves it; the
    port overwrite-saves another PCA model to the same path.  The JAX
    package then loads the port's components with no fingerprint: the old
    model's `drift_baseline.bin` is gone."""
    from spark_rapids_ml_torch.feature import PCA
    from spark_rapids_ml_tpu.feature import PCA as JaxPCA
    from spark_rapids_ml_tpu.feature import PCAModel as JaxPCAModel

    rng = np.random.default_rng(14)
    path = str(tmp_path / "model")
    jax_config.set_config(drift_baseline="on")
    ref = JaxPCA(k=2).fit(rng.normal(size=(500, 6)).astype(np.float32))
    ref.save(path)
    assert os.path.exists(os.path.join(path, "drift_baseline.bin"))
    mine = PCA(k=2).fit(rng.normal(size=(500, 6)).astype(np.float32) * 3.0 + 1.0)
    mine.write().overwrite().save(path)
    assert not os.path.exists(os.path.join(path, "drift_baseline.bin"))
    loaded = JaxPCAModel.load(path)
    assert getattr(loaded, "_drift_baseline", None) is None
    np.testing.assert_array_equal(loaded.components_, mine.components_)


# ---------------------------------------------------------------------------
# one-device staging
# ---------------------------------------------------------------------------


def test_row_stager_dense_sparse_mask_ids_fetch(monkeypatch):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(37, 9))
    X[X < 0] = 0.0
    st = RowStager(37, torch.device("cpu"))
    dense = st.stage(X, np.float32)
    assert dense.dtype == torch.float32 and dense.shape == (37, 9)
    monkeypatch.setattr(port_mesh, "_CHUNK_BYTES", 9 * 4 * 5)  # 5 rows a chunk
    sparse = st.stage_sparse(sp.csr_matrix(X), np.float32)
    assert torch.equal(dense, sparse)
    assert torch.equal(st.mask(np.float32), torch.ones(37))
    assert st.row_ids().dtype == torch.int32 and int(st.row_ids()[-1]) == 36
    np.testing.assert_array_equal(st.fetch(dense), X.astype(np.float32))
    with pytest.raises(ValueError, match="rows"):
        st.stage(X[:5])


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------


def test_cpu_request_works_and_env_var_is_read(monkeypatch):
    assert resolve_device() == torch.device("cpu")
    set_default_device(None)
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_DEVICE", "cpu")
    assert port.get_default_device() == "cpu"
    X, Q = _data(6)
    assert _knn(NearestNeighbors(k=2).fit(X), Q)[0].shape == (len(Q), 2)


def test_cuda_without_a_card_raises(no_cuda, monkeypatch):
    set_default_device(None)
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_DEVICE", raising=False)
    assert port.get_default_device() == "cuda:0"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    X, Q = _data(7)
    model = NearestNeighbors(k=2).fit(X)  # fit stages nothing
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.kneighbors(Q)
    set_default_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.kneighbors(Q)


def test_more_than_one_worker_is_not_ported():
    """A fit on more than one device is not ported (the multi-GPU item (8)
    of ROADMAP.md) and raises; a model that carries num_workers > 1 searches
    and transforms on the one device, as it would on one worker."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP.*|item \(8\)"):
        DeviceContext(num_workers=2)
    X, Q = _data(8)
    from spark_rapids_ml_torch.feature import PCA

    with pytest.raises(NotImplementedError, match=r"item \(8\)"):
        PCA(k=2, num_workers=2).fit(X)
    many, one = (NearestNeighbors(k=2, num_workers=w).fit(X) for w in (4, 1))
    for a, b in zip(_knn(many, Q), _knn(one, Q)):
        np.testing.assert_array_equal(a, b)
    with DeviceContext(num_workers=1) as ctx:
        assert ctx.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the generic staged fit's host layer: config keys, labels and weights,
# weighted masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["host_batch_bytes", "dispatch_flops_limit", "bf16_features"])
def test_logistic_config_keys_match_jax_defaults(key):
    assert port_config.get_config(key) == jax_config.get_config(key)


@pytest.mark.parametrize("value", [None, "generic", "structured", "auto"])
def test_umap_kernel_conf_key_matches_jax(value):
    """UMAP's `umap_kernel`: the same key, default and values as the JAX
    package's (what "auto" decides differs by device: ops/umap.py)."""
    if value is not None:
        port_config.set_config(umap_kernel=value)
        jax_config.set_config(umap_kernel=value)
    assert port_config.get_config("umap_kernel") == jax_config.get_config("umap_kernel")
    assert port_config.get_config("umap_kernel") == (value or "auto")


def _supervised_datasets():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(10, 3))
    y = (np.arange(10) % 3).astype(np.float64)
    wt = rng.uniform(0.5, 2.0, 10)
    cols = {"a": X[:, 0], "b": X[:, 1], "c": X[:, 2]}
    return {
        "tuple": ((X, y), {}),
        "df_vector_col": (pd.DataFrame({"features": list(X), "label": y, "wt": wt}),
                          {"features_col": "features"}),
        "df_scalar_cols": (pd.DataFrame({**cols, "label": y, "wt": wt}),
                           {"features_cols": ["a", "b", "c"]}),
    }


@pytest.mark.parametrize("name", list(_supervised_datasets()))
def test_extract_arrays_labels_and_weights_match_jax(name):
    data, kw = _supervised_datasets()[name]
    kw = dict(kw, label_col="label", weight_col="wt", supervised=True)
    a, b = extract_arrays(data, **kw), jax_extract_arrays(data, **kw)
    np.testing.assert_array_equal(a.X, b.X)
    np.testing.assert_array_equal(a.y, b.y)
    assert (a.weight is None) == (b.weight is None) == (name == "tuple")
    if a.weight is not None:
        np.testing.assert_array_equal(a.weight, b.weight)
    # the pandas-free frame carries the same columns
    if name != "tuple":
        mapping = {c: np.asarray(list(data[c])) if c == "features" else data[c].to_numpy()
                   for c in data.columns}
        m = extract_arrays(mapping, **kw)
        np.testing.assert_array_equal(m.X, a.X)
        np.testing.assert_array_equal(m.y, a.y)
        np.testing.assert_array_equal(m.weight, a.weight)
    with pytest.raises(ValueError, match="labels|labelCol"):
        extract_arrays(data[0] if name == "tuple" else data.drop(columns="label"),
                       **dict(kw, label_col="label"))


def test_row_stager_weighted_mask():
    st = RowStager(6, torch.device("cpu"))
    w = np.array([0.5, 0.0, 2.0, 1.0, 3.0, 0.25])
    m = st.mask(np.float32, weights=w)
    assert m.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(), w.astype(np.float32))
    assert torch.equal(st.mask(np.float64), torch.ones(6, dtype=torch.float64))


# ---------------------------------------------------------------------------
# F1: models saved with num_workers > 1 transform on one device
# ---------------------------------------------------------------------------


def _saved_with_two_workers(tmp_path, name):
    """The JAX package fits `name` with num_workers=2 on its 8-device CPU
    mesh and saves it: (path, its model, the frame)."""
    from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR
    from spark_rapids_ml_tpu.classification import RandomForestClassifier as JaxRF
    from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
    from spark_rapids_ml_tpu.feature import PCA as JaxPCA
    from spark_rapids_ml_tpu.regression import LinearRegression as JaxLin

    rng = np.random.default_rng(31)
    X = (rng.normal(size=(240, 5)) * [1.0, 2.0, 0.5, 1.5, 1.0]).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float64)
    df = pd.DataFrame({"features": list(X), "label": y})
    est = {
        "pca": lambda: JaxPCA(k=2, num_workers=2).setInputCol("features").setOutputCol("o"),
        "linear": lambda: JaxLin(regParam=0.1, num_workers=2),
        "logistic": lambda: JaxLR(regParam=0.01, num_workers=2),
        "kmeans": lambda: JaxKMeans(k=3, seed=1, num_workers=2),
        "forest": lambda: JaxRF(numTrees=3, maxDepth=4, seed=2, num_workers=2),
    }[name]()
    model = est.fit(df)
    assert model._num_workers == 2
    path = str(tmp_path / name)
    model.save(path)
    with open(os.path.join(path, "metadata.json")) as f:
        assert json.load(f)["num_workers"] == 2
    return path, model, df


# the per-model tolerances of the packages' cross-load tests
_F1_CASES = {
    "pca": ("PCAModel", "feature", ["o"], 1e-4),
    "linear": ("LinearRegressionModel", "regression", ["prediction"], 1e-5),
    "logistic": ("LogisticRegressionModel", "classification",
                 ["prediction", "probability", "rawPrediction"], 2e-5),
    "kmeans": ("KMeansModel", "clustering", ["prediction"], 0.0),
    "forest": ("RandomForestClassificationModel", "classification",
               ["prediction", "probability"], 0.0),
}


@pytest.mark.parametrize("name", sorted(_F1_CASES))
def test_a_model_saved_with_two_workers_transforms_in_the_port(tmp_path, name):
    import importlib

    cls_name, module, cols, tol = _F1_CASES[name]
    path, ref, df = _saved_with_two_workers(tmp_path, name)
    cls = getattr(importlib.import_module(f"spark_rapids_ml_torch.{module}"), cls_name)
    loaded = cls.load(path)
    assert loaded.num_workers == 2
    got, want = loaded.transform(df), ref.transform(df)
    for col in cols:
        a, b = np.stack(got[col].to_numpy()), np.stack(want[col].to_numpy())
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f"{name} {col}")


# ---------------------------------------------------------------------------
# F2: the four core conf keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,value", [
    ("float32_inputs", False), ("float32_inputs", True), ("num_workers", 2),
    ("num_workers", 3), ("verbose", 4), ("cpu_fallback_enabled", True),
    ("cpu_fallback_enabled", False),
])
def test_core_conf_keys_match_jax(key, value):
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR

    for k in ("float32_inputs", "num_workers", "verbose", "cpu_fallback_enabled"):
        assert port_config.get_config(k) == jax_config.get_config(k)
    port_config.set_config(**{key: value})
    jax_config.set_config(**{key: value})
    assert port_config.get_config(key) == jax_config.get_config(key) == value
    a, b = LogisticRegression(), JaxLR()
    assert a._float32_inputs == b._float32_inputs
    assert a._fallback_enabled == b._fallback_enabled
    if key == "num_workers":
        assert a.num_workers == b.num_workers == value
        X, y = np.ones((8, 2), np.float32), np.arange(8.0) % 2
        with pytest.raises(NotImplementedError, match=r"item \(8\)"):
            a.fit((X, y))


def test_cpu_fallback_raises_where_it_would_run():
    """With cpu_fallback_enabled an unsupported param arms the fallback in
    both packages; the port's fit raises there (scikit-learn is not
    ported) and its CV keeps the legacy path."""
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR

    with pytest.raises(ValueError, match="not supported"):
        LogisticRegression(thresholds=[0.4, 0.6])
    port_config.set_config(cpu_fallback_enabled=True)
    jax_config.set_config(cpu_fallback_enabled=True)
    a, b = LogisticRegression(thresholds=[0.4, 0.6]), JaxLR(thresholds=[0.4, 0.6])
    assert a._use_cpu_fallback() and b._use_cpu_fallback()
    assert a._fallback_params == b._fallback_params
    assert a.copy()._use_cpu_fallback()
    X = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        a.fit((X, y))
    df = pd.DataFrame({"features": list(X), "label": y})
    assert a._cached_fit_entry(df) is None
    plain = LogisticRegression()
    assert not plain._use_cpu_fallback()
    assert plain._use_cpu_fallback({plain.thresholds: [0.4, 0.6]})


# ---------------------------------------------------------------------------
# F3: cuml_params
# ---------------------------------------------------------------------------

_ESTIMATORS = {
    "LogisticRegression": ("classification", {"regParam": 0.01}),
    "RandomForestClassifier": ("classification", {"numTrees": 2, "maxDepth": 3}),
    "LinearRegression": ("regression", {"regParam": 0.1}),
    "RandomForestRegressor": ("regression", {"numTrees": 2, "maxDepth": 3}),
    "PCA": ("feature", {"k": 2}),
    "KMeans": ("clustering", {"k": 2, "seed": 1}),
    "DBSCAN": ("clustering", {"eps": 1.0}),
    "NearestNeighbors": ("knn", {"k": 2}),
}


@pytest.mark.parametrize("name", sorted(_ESTIMATORS))
def test_cuml_params_alias_matches_jax(name):
    import importlib

    module, kw = _ESTIMATORS[name]
    port_cls = getattr(importlib.import_module(f"spark_rapids_ml_torch.{module}"), name)
    jax_cls = getattr(importlib.import_module(f"spark_rapids_ml_tpu.{module}"), name)
    est, ref = port_cls(**kw), jax_cls(num_workers=1, **kw)
    assert est.cuml_params is est.tpu_params
    assert est.cuml_params == ref.cuml_params
    rng = np.random.default_rng(5)
    X = rng.normal(size=(60, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    data = X if name in ("PCA", "KMeans", "DBSCAN", "NearestNeighbors") else (X, y)
    if name == "PCA":
        est.setInputCol("features")
        ref.setInputCol("features")
        data = pd.DataFrame({"features": list(X)})
    model, ref_model = est.fit(data), ref.fit(data)
    assert model.cuml_params is model.tpu_params
    assert model.cuml_params == ref_model.cuml_params


# ---------------------------------------------------------------------------
# F5: every conf key of the JAX package is a port key or waits for an item
# ---------------------------------------------------------------------------

# the JAX package's conf keys the port does not read yet, by the ROADMAP.md
# section 1 item whose modules read them
_KEYS_OF_LATER_ITEMS = {
    6: ("bench_history_path", "telemetry_dir", "telemetry_port", "heartbeat_interval_s",
        "memory_provider", "memory_sample_interval_s", "flight_recorder",
        "flight_recorder_dir", "flight_recorder_events", "flight_recorder_window_s",
        "hang_doctor", "hang_doctor_stall_s", "drift_baseline", "drift_window_s",
        "drift_min_window_rows", "drift_top_k", "drift_alert_threshold",
        "drift_alert_sustain_s", "drift_fleet_merge"),
    8: ("coordinator_address", "process_id", "num_processes", "multiproc_reduce",
        "multiproc_reduce_timeout_s", "multiproc_agreement_check", "knn_replicate_max_bytes",
        "pod_elastic", "pod_heartbeat_interval_s", "pod_death_grace_s",
        "pod_incident_ring_deadline_s"),
    9: ("spark_collect_max_bytes", "spark_exchange_dir"),
}


def test_every_jax_conf_key_is_a_port_key_or_waits_for_an_item():
    later = [k for keys in _KEYS_OF_LATER_ITEMS.values() for k in keys]
    assert len(later) == len(set(later))
    jax_keys, port_keys = set(jax_config._DEFAULTS), set(port_config._DEFAULTS)
    assert port_keys <= jax_keys
    assert jax_keys - port_keys == set(later)
    assert not set(later) & port_keys


_F5_AND_SLICE_17_KEYS = (
    "elastic", "elastic_min_devices", "shape_bucketing", "staging_small_direct",
    "profile_dir", "lock_slow_wait_ms",
) + tuple(k for k in sorted(port_config._DEFAULTS) if k.startswith("serving_"))


@pytest.mark.parametrize("key", _F5_AND_SLICE_17_KEYS)
def test_f5_serving_and_tracing_keys_take_the_jax_defaults(key):
    assert port_config.get_config(key) == jax_config.get_config(key)
    port_config.set_config(**{key: jax_config.get_config(key)})
    assert port_config.get_config(key) == jax_config._DEFAULTS[key]


def test_there_are_twenty_serving_keys():
    assert sum(k.startswith("serving_") for k in port_config._DEFAULTS) == 20


def test_transform_pads_to_the_bucket_grid_and_fits_do_not(monkeypatch):
    """Under `shape_bucketing` a transform's chunk stages zero-padded to
    the row-bucket grid (the JAX package's rule) and returns only its
    rows; a fit stages the exact rows whatever the conf."""
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.parallel import mesh

    staged = []
    real = mesh.RowStager.stage

    def spy(self, arr, dtype=None):
        out = real(self, arr, dtype)
        if np.asarray(arr).ndim == 2:
            staged.append((out.shape[0], np.asarray(arr).shape[0]))
            assert not out[np.asarray(arr).shape[0]:].any()  # padding rows are zeros
        return out

    monkeypatch.setattr(mesh.RowStager, "stage", spy)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 5))
    y = (X[:, 0] > 0).astype(float)
    m = LogisticRegression(regParam=0.01).fit((X, y))
    assert staged == [(300, 300)]
    out = m.transform(X)
    assert staged[1:] == [(384, 300)] and out["probability"].shape == (300, 2)
    port_config.set_config(shape_bucketing=False)
    exact = m.transform(X)
    assert staged[2:] == [(300, 300)]
    for col in out:
        np.testing.assert_array_equal(out[col], exact[col])


def test_an_oom_halved_chunk_below_the_grid_stages_exact_rows(monkeypatch):
    """Halving after an OOM must shrink what is staged: a chunk below the
    256-row bucket floor is not padded back up to it."""
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.parallel import mesh

    staged = []
    real = mesh.RowStager.stage

    def tight(self, arr, dtype=None):
        if np.asarray(arr).ndim == 2:
            rows = self.n_padded
            staged.append(rows)
            if rows > 100:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. (test ballast)")
        return real(self, arr, dtype)

    rng = np.random.default_rng(3)
    X = rng.normal(size=(1000, 5))
    m = LogisticRegression(regParam=0.01).fit((X, (X[:, 0] > 0).astype(float)))
    ref = m.transform(X)
    monkeypatch.setattr(mesh.RowStager, "stage", tight)
    port_config.set_config(host_batch_bytes=5 * 8 * 1024)
    out = m.transform(X)
    assert staged[:4] == [1024, 512, 256, 128] and max(staged[4:]) <= 100
    np.testing.assert_array_equal(out["prediction"], ref["prediction"])
    np.testing.assert_allclose(out["probability"], ref["probability"], rtol=1e-12)
