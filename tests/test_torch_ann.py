#
# The port's ApproximateNearestNeighbors (spark_rapids_ml_torch/models/
# knn.py) through its public entry points, case by case as the JAX
# package's tests/test_ann.py, on the CPU.  Each recall case fits both
# packages on the same numpy data with their own seeds and holds the port
# to test_ann.py's floor and to within 0.03 of the JAX package's recall
# (the k-means and graph draws differ: `jax.random` is not reproducible in
# torch).  Besides: errors with the JAX package's messages, and models
# saved by either package loaded by the other with equal neighbours.
#
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.datasets import make_blobs
from sklearn.neighbors import NearestNeighbors as SkNN

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.config import reset_config, set_config
from spark_rapids_ml_torch.knn import (
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
)
from spark_rapids_ml_tpu.config import reset_config as jax_reset_config
from spark_rapids_ml_tpu.knn import ApproximateNearestNeighbors as JaxANN
from spark_rapids_ml_tpu.knn import ApproximateNearestNeighborsModel as JaxANNModel


@pytest.fixture(autouse=True)
def _cpu_and_clean_config():
    set_default_device("cpu")
    reset_config()
    jax_reset_config()
    yield
    reset_config()
    jax_reset_config()
    set_default_device(None)


def _recall(got_idx: np.ndarray, want_idx: np.ndarray) -> float:
    hits = 0
    for g, w in zip(got_idx, want_idx):
        hits += len(set(g.tolist()) & set(w.tolist()))
    return hits / want_idx.size


def _blobs():
    X, _ = make_blobs(n_samples=500, n_features=16, centers=10, random_state=0)
    return X.astype(np.float32)


def _skewed():
    X, _ = make_blobs(n_samples=[2000, 400, 80, 40, 20], n_features=12,
                      cluster_std=[0.5, 1.0, 2.0, 0.3, 3.0], random_state=4)
    return X.astype(np.float32)


def _normal():
    return np.random.default_rng(42).normal(size=(400, 12)).astype(np.float32)


def _indices(knn_df) -> np.ndarray:
    return np.stack(knn_df["indices"].to_numpy())


def _distances(knn_df) -> np.ndarray:
    return np.stack(knn_df["distances"].to_numpy())


# test_ann.py's recall cases: (data, queries, k, algorithm, algoParams,
# metric, recall floor)
_CASES = {
    "ivfflat_full_probe_is_exact": (_blobs, slice(0, 50), 8, "ivfflat",
                                    {"nlist": 10, "nprobe": 10}, "euclidean", 1.0),
    "ivfflat_partial_probe_recall": (_blobs, slice(0, 100), 8, "ivfflat",
                                     {"nlist": 16, "nprobe": 4}, "euclidean", 0.85),
    "ivfpq_recall": (_blobs, slice(0, 100), 5, "ivfpq",
                     {"nlist": 8, "nprobe": 8, "M": 4, "refine_ratio": 4}, "euclidean", 0.7),
    "cagra_recall": (_blobs, slice(0, 100), 8, "cagra",
                     {"graph_degree": 16, "itopk_size": 64}, "euclidean", 0.95),
    "cagra_skewed_clusters_recall": (_skewed, slice(None, None, 17), 10, "cagra",
                                     {"graph_degree": 24}, "euclidean", 0.9),
    "ivf_skewed_clusters_recall": (_skewed, slice(None, None, 17), 10, "ivfflat",
                                   {"nlist": 32, "nprobe": 8}, "euclidean", 0.85),
    "cosine_metric_matches_sklearn": (_normal, slice(0, 60), 5, "ivfflat",
                                      {"nlist": 8, "nprobe": 8}, "cosine", 0.99),
    "cosine_metric_cagra": (_normal, slice(0, 60), 5, "cagra",
                            {"graph_degree": 16}, "cosine", 0.9),
}


def _fit_both(X, k, algo, params, metric):
    kw = dict(k=k, algorithm=algo, algoParams=params, metric=metric)
    return ApproximateNearestNeighbors(**kw).fit(X), JaxANN(num_workers=1, **kw).fit(X)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_recall_matches_jax(case):
    make, qsel, k, algo, params, metric, floor = _CASES[case]
    X = make()
    Q = X[qsel]
    port, ref = _fit_both(X, k, algo, params, metric)
    _, _, got = port.kneighbors(Q)
    _, _, want = ref.kneighbors(Q)
    sk = SkNN(n_neighbors=k, algorithm="brute",
              metric="cosine" if metric == "cosine" else "minkowski").fit(X)
    want_d, truth = sk.kneighbors(Q)
    r_port, r_ref = _recall(_indices(got), truth), _recall(_indices(want), truth)
    assert r_port >= floor, (r_port, floor)
    assert abs(r_port - r_ref) <= 0.03, (r_port, r_ref)
    assert _distances(got).dtype == np.float32
    if case == "ivfflat_full_probe_is_exact":
        # probing every list == exact search; float32 distances re-scored
        # in the difference form
        np.testing.assert_allclose(np.sort(_distances(got)), np.sort(want_d), rtol=2e-2,
                                   atol=2e-2)
    if metric == "cosine" and algo == "ivfflat":
        np.testing.assert_allclose(np.sort(_distances(got)), np.sort(want_d), atol=2e-3)


def test_full_probe_equals_jax_neighbours():
    """Full probe is exact in both packages: the same ids, and distances
    bit-equal (both re-score the same candidates on the host in float32)."""
    X = _blobs()
    port, ref = _fit_both(X, 8, "ivfflat", {"nlist": 10, "nprobe": 10}, "euclidean")
    _, _, a = port.kneighbors(X[:50])
    _, _, b = ref.kneighbors(X[:50])
    np.testing.assert_array_equal(_indices(a), _indices(b))
    np.testing.assert_array_equal(_distances(a), _distances(b))


def test_several_workers_raise_at_fit():
    with pytest.raises(NotImplementedError, match="item \\(8\\)"):
        ApproximateNearestNeighbors(k=3, num_workers=2).fit(_blobs())


def test_sqeuclidean_metric():
    blobs = _blobs()
    model = ApproximateNearestNeighbors(
        k=3, metric="sqeuclidean", algoParams={"nlist": 4, "nprobe": 4}).fit(blobs[:60])
    _, _, knn_df = model.kneighbors(blobs[:10])
    d_sq = _distances(knn_df)
    model2 = ApproximateNearestNeighbors(
        k=3, algoParams={"nlist": 4, "nprobe": 4}).fit(blobs[:60])
    _, _, knn_df2 = model2.kneighbors(blobs[:10])
    np.testing.assert_allclose(np.sqrt(d_sq), _distances(knn_df2), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kw,match", [
    ({"algorithm": "ivfpq", "algoParams": {"n_bits": 10}}, "n_bits"),
    ({"algorithm": "hnsw"}, "not supported"),
    ({"metric": "manhattan"}, "metric"),
])
def test_errors_match_jax(kw, match):
    with pytest.raises(ValueError, match=match) as a:
        ApproximateNearestNeighbors(**kw).fit(_blobs())
    with pytest.raises(ValueError, match=match) as b:
        JaxANN(num_workers=1, **kw).fit(_blobs())
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("algo", ["ivfflat", "cagra"])
def test_k_above_the_items_raises_like_jax(algo):
    X = _blobs()[:20]
    params = {"nlist": 4} if algo == "ivfflat" else {"graph_degree": 8}
    with pytest.raises(ValueError, match="exceeds") as a:
        ApproximateNearestNeighbors(k=25, algorithm=algo, algoParams=params).fit(X).kneighbors(X)
    with pytest.raises(ValueError, match="exceeds") as b:
        JaxANN(k=25, algorithm=algo, algoParams=params, num_workers=1).fit(X).kneighbors(X)
    assert str(a.value) == str(b.value)


def test_approx_similarity_join():
    blobs = _blobs()
    model = ApproximateNearestNeighbors(
        k=3, algoParams={"nlist": 4, "nprobe": 4}).fit(blobs[:50])
    join_df = model.approxSimilarityJoin(blobs[:5], distCol="dist")
    assert list(join_df.columns) == ["item_id", "query_id", "dist"]
    assert len(join_df) == 15
    self_rows = join_df[join_df["item_id"] == join_df["query_id"]]
    assert np.allclose(self_rows["dist"], 0.0, atol=5e-2)


@pytest.mark.parametrize("algo,params", [
    ("ivfflat", {"nlist": 8, "nprobe": 8}),
    ("ivfpq", {"nlist": 8, "nprobe": 4, "M": 4}),
    ("cagra", {"graph_degree": 8}),
])
def test_ann_save_load(tmp_path, algo, params):
    blobs = _blobs()
    model = ApproximateNearestNeighbors(k=4, algorithm=algo, algoParams=params).fit(blobs)
    path = str(tmp_path / "ann")
    model.save(path)
    loaded = ApproximateNearestNeighborsModel.load(path)
    _, _, a = model.kneighbors(blobs[:20])
    _, _, b = loaded.kneighbors(blobs[:20])
    np.testing.assert_array_equal(_indices(a), _indices(b))


@pytest.mark.parametrize("algo,params", [
    ("ivfflat", {"nlist": 8, "nprobe": 3}),
    ("ivfpq", {"nlist": 8, "nprobe": 4, "M": 4}),
    ("cagra", {"graph_degree": 8}),
])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_across_packages(tmp_path, algo, params, direction):
    """A model saved by either package loads in the other; kneighbors gives
    the same ids (the same index, searched by each package's code; CAGRA's
    search draws differ, so its ids agree to near-exact recall)."""
    X = pd.DataFrame({"features": list(_blobs()), "id": np.arange(500) * 3 + 100})
    kw = dict(k=5, algorithm=algo, algoParams=params)
    path = str(tmp_path / "m")
    if direction == "jax_to_port":
        saved = JaxANN(num_workers=1, **kw).setIdCol("id").fit(X)
        saved.save(path)
        loaded = ApproximateNearestNeighborsModel.load(path)
    else:
        saved = ApproximateNearestNeighbors(**kw).setIdCol("id").fit(X)
        saved.save(path)
        loaded = JaxANNModel.load(path)
        loaded.num_workers = 1
    Q = X.iloc[:40]
    _, _, a = saved.kneighbors(Q)
    _, _, b = loaded.kneighbors(Q)
    np.testing.assert_array_equal(a["query_id"].to_numpy(), b["query_id"].to_numpy())
    if algo == "cagra":
        assert _recall(_indices(a), _indices(b)) >= 0.95
    else:
        np.testing.assert_array_equal(_indices(a), _indices(b))
        np.testing.assert_allclose(_distances(a), _distances(b), rtol=1e-6)


def test_legacy_model_without_sub_table_loads(tmp_path):
    """A model saved before sub-list splitting (no `ivf_sub_table`) gets
    the identity table and searches as before."""
    X = _blobs()
    model = ApproximateNearestNeighbors(k=4, algoParams={"nlist": 40, "nprobe": 40}).fit(X)
    assert model._attrs["ivf_sub_table"].shape[1] == 1  # no list was split
    path = str(tmp_path / "legacy")
    model.save(path)
    arrays = dict(np.load(path + "/arrays.npz"))
    arrays.pop("ivf_sub_table")
    np.savez(path + "/arrays.npz", **arrays)
    import json

    with open(path + "/metadata.json") as f:
        meta = json.load(f)
    meta["array_attributes"].remove("ivf_sub_table")
    with open(path + "/metadata.json", "w") as f:
        json.dump(meta, f)
    loaded = ApproximateNearestNeighborsModel.load(path)
    nlist = model._attrs["ivf_centers"].shape[0]
    np.testing.assert_array_equal(loaded._attrs["ivf_sub_table"][:, 0], np.arange(nlist))
    _, _, a = model.kneighbors(X[:30])
    _, _, b = loaded.kneighbors(X[:30])
    np.testing.assert_array_equal(_indices(a), _indices(b))


@pytest.mark.parametrize("algo,params", [
    ("ivfflat", {"nlist": 10, "nprobe": 10}),
    ("cagra", {"graph_degree": 8}),
])
def test_search_query_chunking_matches_unchunked(algo, params):
    """_search bounds the candidate working set by chunking queries;
    chunked and unchunked searches must return the same neighbours."""
    blobs = _blobs()
    k = 4
    model = ApproximateNearestNeighbors(k=k, algorithm=algo, algoParams=params).fit(blobs)
    Q = blobs[:130]
    d_full, p_full = model._search(Q, k)
    assert model._per_query_candidate_bytes(k) > 0
    set_config(hbm_bytes=8 * model._per_query_candidate_bytes(k) * 40)
    d_chunk, p_chunk = model._search(Q, k)
    if algo == "ivfflat":
        np.testing.assert_array_equal(p_full, p_chunk)
        np.testing.assert_allclose(d_full, d_chunk, rtol=1e-5, atol=1e-5)
    else:
        # the entry draws are shaped by the query batch, so chunked results
        # may differ; both must stay near-exact
        _, want = SkNN(n_neighbors=k, algorithm="brute").fit(blobs).kneighbors(Q)
        assert _recall(p_chunk, want) >= _recall(p_full, want) - 0.05
        assert _recall(p_chunk, want) >= 0.9


def test_search_budget_defaults_to_16_gib_on_the_cpu():
    """hbm_bytes None: the budget is the JAX package's 16 GiB on the CPU,
    so the chunk is what the JAX package's default conf gives."""
    from spark_rapids_ml_torch.parallel.device_cache import device_memory_bytes

    assert device_memory_bytes("cpu") == 16 * 1024**3
    set_config(hbm_bytes=12345)
    assert device_memory_bytes("cpu") == 12345


def test_distance_precision_is_read_at_each_call(monkeypatch):
    """The gathered product runs at the `distance_precision` level read at
    the call (TF32 allowed only at "default"), and restores the flag."""
    from spark_rapids_ml_torch.ops import distances

    seen = []
    real_bmm = torch.bmm

    def bmm(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_bmm(a, b)

    monkeypatch.setattr(torch, "bmm", bmm)
    before = torch.backends.cuda.matmul.allow_tf32
    B, Xc = torch.ones(2, 3), torch.ones(2, 4, 3)
    args = (B, Xc, torch.full((2,), 3.0), torch.full((2, 4), 3.0))
    set_config(distance_precision="highest")
    distances.sqdist_gathered(*args)
    set_config(distance_precision="default")
    out = distances.sqdist_gathered(*args)
    assert seen == [False, True] and out.shape == (2, 4)
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_distance_precision_invalid_value():
    from spark_rapids_ml_torch.ops.precision import distance_precision

    set_config(distance_precision="sloppy")
    with pytest.raises(ValueError, match="distance_precision"):
        distance_precision()
