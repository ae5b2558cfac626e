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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DeviceContext(num_workers=2)
    X, Q = _data(8)
    with pytest.raises(NotImplementedError):
        NearestNeighbors(k=2, num_workers=4).fit(X).kneighbors(Q)
    with DeviceContext(num_workers=1) as ctx:
        assert ctx.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the generic staged fit's host layer: config keys, labels and weights,
# weighted masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["host_batch_bytes", "dispatch_flops_limit", "bf16_features"])
def test_logistic_config_keys_match_jax_defaults(key):
    assert port_config.get_config(key) == jax_config.get_config(key)


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
