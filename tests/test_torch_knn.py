#
# The port's exact NearestNeighbors (spark_rapids_ml_torch/models/knn.py)
# against the JAX package's on the same inputs, on the CPU: dense and CSR
# items, with and without an idCol, float32 and float32_inputs=False, the
# join, and the whole slice fit -> kneighbors -> save -> load.
#
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.config import reset_config, set_config
from spark_rapids_ml_torch.knn import NearestNeighbors, NearestNeighborsModel
from spark_rapids_ml_torch.models import knn as port_knn
from spark_rapids_ml_torch.ops import knn as port_ops_knn
from spark_rapids_ml_tpu.config import reset_config as jax_reset_config
from spark_rapids_ml_tpu.knn import NearestNeighbors as JaxNearestNeighbors


@pytest.fixture(autouse=True)
def _cpu_and_clean_config():
    set_default_device("cpu")
    reset_config()
    jax_reset_config()
    yield
    reset_config()
    jax_reset_config()
    set_default_device(None)


def _inputs(kind: str, dtype, seed=0, n=300, q=40, d=16):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(dtype)
    Q = rng.normal(size=(q, d)).astype(dtype)
    if kind == "csr":
        X[rng.random(size=X.shape) < 0.7] = 0.0
        Q[rng.random(size=Q.shape) < 0.7] = 0.0
        return sp.csr_matrix(X), sp.csr_matrix(Q)
    item_df = pd.DataFrame({"features": list(X)})
    query_df = pd.DataFrame({"features": list(Q)})
    if kind == "df_id":
        item_df["id"] = np.arange(n) * 5 + 1000
        query_df["id"] = np.arange(q) + 77
    return item_df, query_df


def _stack(knn_df, col):
    return np.stack(knn_df[col])


def _fit(cls, kind, dtype, k):
    kw = {} if dtype == np.float32 else {"float32_inputs": False}
    if cls is JaxNearestNeighbors:
        kw["num_workers"] = 1
    est = cls(k=k, **kw)
    if kind == "df_id":
        est = est.setIdCol("id")
    return est


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["df", "df_id", "csr"])
def test_kneighbors_matches_jax(kind, dtype):
    items, queries = _inputs(kind, dtype)
    k = 7
    port = _fit(NearestNeighbors, kind, dtype, k).fit(items)
    ref = _fit(JaxNearestNeighbors, kind, dtype, k).fit(items)
    _, _, a = port.kneighbors(queries)
    _, _, b = ref.kneighbors(queries)
    assert list(a.columns) == list(b.columns)
    np.testing.assert_array_equal(a["query_id"].to_numpy(), b["query_id"].to_numpy())
    np.testing.assert_allclose(_stack(a, "distances"), _stack(b, "distances"), atol=1e-3)
    assert _stack(a, "distances").dtype == np.float32
    ia, ib = _stack(a, "indices"), _stack(b, "indices")
    assert all(set(ra) == set(rb) for ra, rb in zip(ia, ib))
    if dtype == np.float64:
        # float32_inputs=False keeps the search in float64 on both sides
        assert port._out_dtype(port.item_features) == np.float64
        np.testing.assert_array_equal(ia, ib)


def test_join_matches_jax():
    items, queries = _inputs("df_id", np.float32, seed=1)
    port = NearestNeighbors(k=4).setIdCol("id").fit(items)
    ref = JaxNearestNeighbors(k=4, num_workers=1).setIdCol("id").fit(items)
    a = port.exactNearestNeighborsJoin(queries, distCol="dc")
    b = ref.exactNearestNeighborsJoin(queries, distCol="dc")
    assert list(a.columns) == ["item_id", "query_id", "dc"] == list(b.columns)
    pd.testing.assert_frame_equal(a[["item_id", "query_id"]], b[["item_id", "query_id"]])
    np.testing.assert_allclose(a["dc"].to_numpy(), b["dc"].to_numpy(), atol=1e-3)


def test_multi_col_features_match_jax():
    rng = np.random.default_rng(2)
    cols = ["c0", "c1", "c2"]
    item_df = pd.DataFrame(rng.normal(size=(60, 3)), columns=cols)
    query_df = pd.DataFrame(rng.normal(size=(9, 3)), columns=cols)
    _, _, a = NearestNeighbors(k=3).setFeaturesCols(cols).fit(item_df).kneighbors(query_df)
    _, _, b = (JaxNearestNeighbors(k=3, num_workers=1).setFeaturesCols(cols)
               .fit(item_df).kneighbors(query_df))
    np.testing.assert_array_equal(_stack(a, "indices"), _stack(b, "indices"))


def test_whole_slice_fit_kneighbors_save_load(tmp_path):
    items, queries = _inputs("df_id", np.float32, seed=3)
    model = NearestNeighbors(k=6).setIdCol("id").fit(items)
    item_df, q_df, a = model.kneighbors(queries)
    assert item_df is items and q_df is queries
    path = str(tmp_path / "nn")
    model.save(path)
    with pytest.raises(IOError):
        model.save(path)
    model.write().overwrite().save(path)
    loaded = NearestNeighborsModel.load(path)
    assert loaded.getK() == 6 and loaded.getIdCol() == "id"
    _, _, b = loaded.kneighbors(queries)
    pd.testing.assert_frame_equal(
        a.drop(columns=["indices", "distances"]), b.drop(columns=["indices", "distances"])
    )
    np.testing.assert_array_equal(_stack(a, "indices"), _stack(b, "indices"))
    np.testing.assert_array_equal(_stack(a, "distances"), _stack(b, "distances"))


def test_sparse_save_load_keeps_csr(tmp_path):
    items, queries = _inputs("csr", np.float32, seed=4)
    model = NearestNeighbors(k=3).fit(items)
    model.save(str(tmp_path / "m"))
    loaded = NearestNeighborsModel.load(str(tmp_path / "m"))
    assert sp.issparse(loaded.item_features)
    _, _, a = model.kneighbors(queries)
    _, _, b = loaded.kneighbors(queries)
    np.testing.assert_array_equal(_stack(a, "indices"), _stack(b, "indices"))


def test_off_and_on_agree():
    items, queries = _inputs("df", np.float32, seed=5)
    outs = {}
    for mode in ("off", "on"):
        set_config(pallas_knn=mode)
        _, _, outs[mode] = NearestNeighbors(k=5).fit(items).kneighbors(queries)
        assert port_ops_knn.LAST_KERNEL_DECISION["decided_by"] == (
            "config" if mode == "off" else "forced"
        )
    np.testing.assert_array_equal(_stack(outs["off"], "indices"), _stack(outs["on"], "indices"))
    np.testing.assert_allclose(_stack(outs["off"], "distances"),
                               _stack(outs["on"], "distances"), atol=1e-4)


def test_without_pandas_results_are_numpy_columns(monkeypatch):
    """Where pandas is missing, numpy and mapping inputs still work and the
    results are dicts of numpy columns under the same names."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(80, 5)).astype(np.float32)
    Q = rng.normal(size=(7, 5)).astype(np.float32)
    model = NearestNeighbors(k=3).setIdCol("id").fit({"features": X, "id": np.arange(80) + 10})
    _, _, with_pd = model.kneighbors({"features": Q, "id": np.arange(7)[::-1].copy()})
    monkeypatch.setattr(port_knn, "_pandas", lambda: None)
    item_df, _, knn = model.kneighbors({"features": Q, "id": np.arange(7)[::-1].copy()})
    assert isinstance(knn, dict) and set(knn) == {"query_id", "indices", "distances"}
    assert knn["indices"].shape == (7, 3)
    np.testing.assert_array_equal(knn["query_id"], np.arange(7))
    np.testing.assert_array_equal(knn["indices"], _stack(with_pd, "indices"))
    np.testing.assert_array_equal(knn["distances"], _stack(with_pd, "distances"))
    assert isinstance(item_df, dict)
    join = model.exactNearestNeighborsJoin({"features": Q})
    assert isinstance(join, dict) and join["item_id"].shape == (21,)


def test_k_exceeds_items_raises_and_transform_is_unsupported():
    X = np.random.default_rng(7).normal(size=(4, 3))
    model = NearestNeighbors(k=10).fit(X)
    with pytest.raises(ValueError, match="exceeds"):
        model.kneighbors(X)
    with pytest.raises(NotImplementedError):
        model.transform(X)


def test_k_equal_to_items_and_self_queries():
    X = np.random.default_rng(8).normal(size=(30, 4)).astype(np.float32)
    _, _, a = NearestNeighbors(k=30).fit(X).kneighbors(X)
    idx = _stack(a, "indices")
    assert (idx[:, 0] == np.arange(30)).all()
    assert all(sorted(r) == list(range(30)) for r in idx)


def test_cpu_gives_the_equivalent_sklearn_model():
    from sklearn.neighbors import NearestNeighbors as SkNN

    rng = np.random.default_rng(9)
    X = rng.normal(size=(90, 5)).astype(np.float32)
    Q = rng.normal(size=(6, 5)).astype(np.float32)
    model = NearestNeighbors(k=4).fit(X)
    sk = model.cpu()
    assert isinstance(sk, SkNN) and sk.n_neighbors == 4
    want_d, want_i = sk.kneighbors(Q)
    _, _, got = model.kneighbors(Q)
    np.testing.assert_array_equal(_stack(got, "indices"), want_i)
    np.testing.assert_allclose(_stack(got, "distances"), want_d, atol=1e-4)
