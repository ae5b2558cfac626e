#
# The port's parquet ingest and streamed fits (spark_rapids_ml_torch/streaming.py
# and the parquet producer of fused.py) against the JAX package's on the same
# parquet files, on the CPU: the chunk decode (FixedSizeList, list and
# scalar feature columns), the range readers at 1, 2 and 3 readers, the
# staging, the streamed and CSR statistics, the epoch-streaming
# LogisticRegression and KMeans, the budget decision, and what is not
# ported.  Files are a few thousand rows, written from numpy seeds into
# tmp_path.  Every JAX float64 call runs inside `jax.enable_x64(True)` (the
# flag is checked at module teardown).
#
import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_torch import DeviceDataset, set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import fused as port_fused
from spark_rapids_ml_torch import streaming as port_streaming
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu import fused as jax_fused
from spark_rapids_ml_tpu import streaming as jax_streaming


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
    # the JAX package's chunk cache would replay one test's stream in the next
    jax_config.set_config(chunk_cache="off")
    yield
    port_config.reset_config()
    jax_config.reset_config()
    set_default_device(None)


def _rows(seed, n=1500, d=6, classes=2):
    """Features with uneven scales and offsets, integer labels from a noisy
    linear model, and weights in [0.25, 2] with some 0."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(size=d)
    W = rng.normal(size=(classes, d))
    scores = X @ W.T + 0.5 * rng.normal(size=(n, classes))
    y = np.argmax(scores, axis=1).astype(np.float64)
    w = rng.choice([0.0, 0.25, 0.5, 1.0, 1.5, 2.0], size=n)
    return X, y, w


def _write(path, X, y=None, w=None, layout="fixed", row_group_size=None, dtype=np.float64):
    """A parquet file of X (as a FixedSizeList, a list, or one scalar
    column per feature), a float64 label and a weight column."""
    X = np.asarray(X, dtype)
    cols = {}
    if layout == "fixed":
        cols["features"] = pa.FixedSizeListArray.from_arrays(pa.array(X.reshape(-1)), X.shape[1])
    elif layout == "list":
        cols["features"] = pa.array(list(X))
    else:
        for j in range(X.shape[1]):
            cols[f"f{j}"] = pa.array(X[:, j])
    if y is not None:
        cols["label"] = pa.array(np.asarray(y, np.float64))
    if w is not None:
        cols["wt"] = pa.array(np.asarray(w, np.float64))
    path = str(path)
    pq.write_table(pa.table(cols), path, row_group_size=row_group_size)
    return path


def _fcols(layout, d):
    return ("features", ()) if layout != "cols" else (None, tuple(f"f{j}" for j in range(d)))


# ---------------------------------------------------------------------------
# probes, decode and chunking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["fixed", "list", "cols"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_chunks_from_batches_match_jax(tmp_path, layout, dtype):
    """The same (X, y, w, n_valid) chunks, bit for bit, over the same Arrow
    batches: full batches handed over, partial ones assembled, the tail
    zero-padded; also with a row range."""
    X, y, w = _rows(1, n=1037, d=5)
    path = _write(tmp_path / "a.parquet", X, y, w, layout=layout, row_group_size=300,
                  dtype=np.float32 if dtype == np.float32 else np.float64)
    fcol, fcols = _fcols(layout, 5)
    assert port_streaming.probe_num_features(path, fcol, fcols) == 5
    assert port_streaming.parquet_row_count(path) == 1037
    for chunk_rows, row_range in ((128, None), (300, None), (256, (100, 900))):
        args = (fcol, fcols, "label", "wt", chunk_rows, np.dtype(dtype))

        def batches():
            return pq.ParquetFile(path).iter_batches(batch_size=chunk_rows)

        want = list(jax_streaming.chunks_from_batches(batches(), *args, row_range=row_range))
        got = list(port_streaming.chunks_from_batches(batches(), *args, row_range=row_range))
        assert len(got) == len(want)
        for g, j in zip(got, want):
            assert g[3] == j[3]
            for a, b in zip(g[:3], j[:3]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        # iter_chunks (the dataset scanner) gives the same chunks
        via_scan = list(port_streaming.iter_chunks(path, *args, row_range=row_range))
        assert [c[3] for c in via_scan] == [c[3] for c in want]
        np.testing.assert_array_equal(np.concatenate([c[0] for c in via_scan]),
                                      np.concatenate([c[0] for c in want]))


def test_prefetch_and_weights_host_match(tmp_path):
    X, y, w = _rows(2, n=700)
    path = _write(tmp_path / "b.parquet", X, y)
    args = (path, "features", (), "label", None, 256, np.dtype(np.float64))
    plain = list(port_streaming.iter_chunks(*args))
    port_config.set_config(streaming_prefetch_depth=2)
    ahead = list(port_streaming.iter_chunks_prefetch(*args))
    assert [c[3] for c in plain] == [c[3] for c in ahead] == [256, 256, 188]
    for a, b in zip(plain, ahead):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for cw, n_c in ((None, 256), (None, 100), (w[:256], 256), (w[:100], 100)):
        np.testing.assert_array_equal(port_streaming._weights_host(cw, n_c, 256, np.float32),
                                      jax_streaming._weights_host(cw, n_c, 256, np.float32))


@pytest.mark.parametrize("readers", [1, 2, 3])
def test_iter_parquet_chunks_match_jax(tmp_path, readers):
    """The fused pass's producer: at 1, 2 and 3 range readers the same
    chunks as the JAX package's, each at the same global row (with_offsets);
    w None on full unweighted chunks, zero on the padding; every row once."""
    X, y, _ = _rows(3, n=2300, d=4)
    path = _write(tmp_path / "c.parquet", X, y, row_group_size=500)
    kw = dict(label_dtype=np.float32, readers=readers, with_offsets=True)
    args = (path, "features", (), "label", None, 400, np.dtype(np.float32))
    got = {c[3]: c[:3] for c in port_fused.iter_parquet_chunks(*args, **kw)}
    want = {int(c[3]): c[:3] for c in jax_fused.iter_parquet_chunks(*args, **kw)}
    assert sorted(got) == sorted(want)
    rows = 0
    for off, (gX, gy, gw) in got.items():
        jX, jy, jw = want[off]
        np.testing.assert_array_equal(gX, np.asarray(jX))
        np.testing.assert_array_equal(gy, jy)
        assert (gw is None) == (jw is None)
        if gw is not None:
            np.testing.assert_array_equal(gw, jw)
        rows += 400 if gw is None else int((gw > 0).sum())
    assert rows == 2300
    # a producer that times itself: the readers' decode lands in prep
    prep = {"s": 0.0, "iv": []}
    n_chunks = len(list(port_fused.iter_parquet_chunks(*args, readers=readers, prep=prep)))
    assert n_chunks == len(got) and len(prep["iv"]) == n_chunks and prep["s"] > 0


def test_reader_partition_matches_jax(tmp_path):
    X, _, _ = _rows(4, n=2300, d=3)
    path = _write(tmp_path / "d.parquet", X, row_group_size=500)
    for readers in (1, 2, 3, 5, 8):
        assert (port_fused._partition_row_groups(path, readers)
                == jax_fused._partition_row_groups(path, readers))
    shares = port_fused._partition_row_groups(path, 3)
    assert port_fused._share_row_starts(path, shares) == jax_fused._share_row_starts(path, shares)
    port_config.set_config(fused_parquet_readers=3)
    jax_config.set_config(fused_parquet_readers=3)
    assert port_fused.resolve_parquet_readers(path) == jax_fused.resolve_parquet_readers(path) == 3
    assert port_fused.LAST_READER_DECISION["parquet_readers_mode"] == "explicit"
    port_config.set_config(fused_parquet_readers="auto")
    assert 1 <= port_fused.resolve_parquet_readers(path) <= 16
    assert port_fused.LAST_READER_DECISION["parquet_readers_reason"].startswith("usable cores")


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("readers", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stage_parquet_matches_in_memory_and_jax(tmp_path, readers, dtype):
    """stage_parquet equals an in-memory stage of the same rows (exactly),
    and the JAX package's stage on its valid rows; one device adds no
    padding rows."""
    X, y, w = _rows(5, n=1503, d=6)
    path = _write(tmp_path / "e.parquet", X, y, w, row_group_size=400)
    port_config.set_config(host_batch_bytes=4096, fused_parquet_readers=readers)
    jax_config.set_config(host_batch_bytes=4096, fused_parquet_readers=readers)
    ds = port_streaming.stage_parquet(path, label_col="label", weight_col="wt", dtype=dtype,
                                      label_dtype=np.int32)
    assert ds.n_valid == 1503 and ds.X.shape == (1503, 6)
    mem = DeviceDataset.from_host(X, y=y, weight=w, dtype=dtype, label_dtype=np.int32)
    for a, b in ((ds.X, mem.X), (ds.y, mem.y), (ds.weight, mem.weight)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    st = port_streaming.LAST_STAGE
    assert st["rows"] == 1503 and (st["readers"] > 1) == (readers > 1)
    assert st["chunks"] >= 2 and st["mb_per_s"] > 0
    if dtype == np.float64:
        # the JAX package's parallel staging fails in float64 (its per-device
        # writer meets a float32 piece); its single scan is the reference
        jax_config.set_config(fused_parquet_readers=1)
    with jax.enable_x64(dtype == np.float64):
        jds = jax_streaming.stage_parquet(path, label_col="label", weight_col="wt", dtype=dtype,
                                          label_dtype=np.int32)
        jX, jy, jw = (np.asarray(jax.device_get(a)) for a in (jds.X, jds.y, jds.weight))
    np.testing.assert_array_equal(ds.X.numpy(), jX[:1503])
    np.testing.assert_array_equal(ds.y.numpy(), jy[:1503])
    np.testing.assert_array_equal(ds.weight.numpy(), jw[:1503])
    assert not jw[1503:].any()


def test_stage_parquet_without_weights_and_errors(tmp_path):
    X, y, _ = _rows(6, n=300, d=3)
    path = _write(tmp_path / "f.parquet", X, y)
    ds = port_streaming.stage_parquet(path, label_col="label")
    assert ds.weight.dtype == torch.float32 and bool((ds.weight == 1).all())
    np.testing.assert_array_equal(ds.y.numpy(), y.astype(np.float32))
    with pytest.raises(NotImplementedError, match="one device"):
        port_streaming.stage_parquet(path, num_workers=2)
    with pytest.raises(ValueError, match="not found"):
        port_streaming.stage_parquet(path, features_col="nope")
    empty = _write(tmp_path / "g.parquet", np.zeros((0, 3)))
    with pytest.raises(ValueError, match="empty"):
        port_streaming.stage_parquet(empty)


# ---------------------------------------------------------------------------
# streamed statistics
# ---------------------------------------------------------------------------


def _assert_stats(got, want, dtype):
    assert set(got) == set(want)
    rtol = 1e-10 if dtype == np.float64 else 1e-5
    for k in want:
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_streaming_stats_match_jax(tmp_path, weighted, dtype):
    """linreg_streaming_stats and pca_streaming_stats: within 1e-10 of the
    JAX package's in float64, 1e-5 in float32 (both fold float32 chunks,
    in another order)."""
    X, y, w = _rows(7, n=1800, d=7)
    path = _write(tmp_path / "h.parquet", X, y, w if weighted else None, row_group_size=500)
    wcol = "wt" if weighted else None
    port_config.set_config(host_batch_bytes=8192)
    jax_config.set_config(host_batch_bytes=8192)
    got_l = port_streaming.linreg_streaming_stats(path, "features", (), "label", wcol, dtype=dtype)
    got_p = port_streaming.pca_streaming_stats(path, "features", (), wcol, dtype=dtype)
    assert port_streaming.STREAM_METRICS["label"] == "pca_streaming"
    # every valid row travels once (X and w), no padding
    assert port_streaming.STREAM_METRICS["bytes"] == 1800 * 8 * np.dtype(dtype).itemsize
    assert port_streaming.STREAM_METRICS["chunks"] >= -(-1800 // 1024)
    with jax.enable_x64(dtype == np.float64):
        want_l = jax_streaming.linreg_streaming_stats(path, "features", (), "label", wcol,
                                                      dtype=dtype)
        want_p = jax_streaming.pca_streaming_stats(path, "features", (), wcol, dtype=dtype)
    _assert_stats(got_l, want_l, dtype)
    _assert_stats(got_p, want_p, dtype)
    assert float(got_p["sw"]) == (w.sum() if weighted else 1800.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_stats_match_jax(dtype):
    """linreg_stats_from_csr and pca_stats_from_csr against the JAX
    package's (1e-10 float64, 1e-5 float32) and against the dense rows'
    statistics."""
    X, y, w = _rows(8, n=900, d=9)
    X[np.abs(X) < 1.0] = 0.0
    csr = sp.csr_matrix(X)
    got_l = port_streaming.linreg_stats_from_csr(csr, y, w, dtype=dtype, chunk_rows=128)
    got_p = port_streaming.pca_stats_from_csr(csr, w, dtype=dtype, chunk_rows=128)
    with jax.enable_x64(dtype == np.float64):
        want_l = jax_streaming.linreg_stats_from_csr(csr, y, w, dtype=dtype, chunk_rows=128)
        want_p = jax_streaming.pca_stats_from_csr(csr, w, dtype=dtype, chunk_rows=128)
    _assert_stats(got_l, want_l, dtype)
    _assert_stats(got_p, want_p, dtype)
    Xd = X.astype(dtype).astype(np.float64)
    np.testing.assert_allclose(got_p["S"], (Xd * w[:, None]).T @ Xd,
                               rtol=1e-10 if dtype == np.float64 else 1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# epoch streaming: LogisticRegression
# ---------------------------------------------------------------------------

_LOGREG_CASES = {
    "binomial": dict(classes=2, weighted=False, reg=0.01, en=0.0),
    "multinomial_weights": dict(classes=3, weighted=True, reg=0.02, en=0.0),
    "elastic_net": dict(classes=2, weighted=False, reg=0.05, en=0.5),
}


@pytest.mark.parametrize("case", sorted(_LOGREG_CASES))
def test_logreg_streaming_fit_matches_jax_float64(tmp_path, case):
    """float64, no standardization: the port's streamed fit against the
    JAX package's fit of the same rows in float64 on its host-driven
    solver (the same L-BFGS/OWL-QN); the objective within 1e-10 and the
    same iteration count.  The JAX package's own streamed fit evaluates in
    float32 whatever the dtype (its streaming.py casts theta and every
    chunk to float32), so the float64 reference is its in-memory fit."""
    from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR

    c = _LOGREG_CASES[case]
    X, y, w = _rows(9, n=1200, d=5, classes=c["classes"])
    w = w if c["weighted"] else None
    path = _write(tmp_path / "lr.parquet", X, y, w, row_group_size=400)
    wcol = "wt" if c["weighted"] else None
    reg, en = c["reg"], c["en"]
    port_config.set_config(host_batch_bytes=8192)
    res = port_streaming.logreg_streaming_fit(
        path, "features", (), "label", wcol, l2=reg * (1 - en), l1=reg * en,
        standardization=False, tol=1e-10, max_iter=60, dtype=np.float64)
    assert res["epochs"] >= res["n_iter"] + 1
    assert port_streaming.STREAM_METRICS["epochs"] == res["epochs"]
    jax_config.set_config(dispatch_flops_limit=1.0)
    with jax.enable_x64(True):
        est = JaxLR(regParam=reg, elasticNetParam=en, standardization=False, tol=1e-10,
                    maxIter=60, float32_inputs=False)
        data = {"features": list(X), "label": y}
        if wcol:
            est.setWeightCol("wt")
            data["wt"] = w
        import pandas as pd

        jm = est.fit(pd.DataFrame(data))
    assert res["n_iter"] == jm.num_iters
    np.testing.assert_allclose(res["history"][-1], jm.objective, rtol=1e-10)
    coef, b = res["coef"], np.asarray(res["intercept"], np.float64)
    if c["classes"] > 2:
        b = b - b.mean()  # Spark centres multinomial intercepts (the estimator does)
    np.testing.assert_allclose(coef, jm.coef_, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(b, jm.intercept_, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_logreg_streaming_fit_near_jax_streamed(tmp_path, dtype):
    """Against the JAX package's streamed fit itself, standardization on
    (the population moments of a host pass, centred with an intercept):
    both fold float32 chunk sums in another order (the JAX one whatever
    the dtype), so the objective within 1e-5 and the coefficients 1e-3."""
    X, y, w = _rows(10, n=1000, d=4)
    path = _write(tmp_path / "lr2.parquet", X, y, w, row_group_size=300)
    kw = dict(l2=0.01, standardization=True, tol=1e-6, max_iter=30, chunk_rows=256)
    got = port_streaming.logreg_streaming_fit(path, "features", (), "label", "wt",
                                              dtype=dtype, **kw)
    with jax.enable_x64(dtype == np.float64):
        want = jax_streaming.logreg_streaming_fit(path, "features", (), "label", "wt",
                                                  dtype=dtype, **kw)
    np.testing.assert_allclose(got["history"][-1], want["history"][-1], rtol=1e-5)
    np.testing.assert_allclose(got["coef"], want["coef"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-12)
    np.testing.assert_allclose(got["std"], want["std"], rtol=1e-12)
    assert got["n_classes"] == want["n_classes"] and got["binomial"] == want["binomial"]


def test_logreg_streaming_one_label_and_bad_labels(tmp_path):
    X, _, _ = _rows(11, n=200, d=3)
    path = _write(tmp_path / "one.parquet", X, np.ones(200))
    res = port_streaming.logreg_streaming_fit(path, "features", (), "label", None)
    assert res == {"degenerate_label": 1.0, "d": 3}
    bad = _write(tmp_path / "bad.parquet", X, np.linspace(0, 1, 200))
    with pytest.raises(RuntimeError, match="non-negative Integers"):
        port_streaming.logreg_streaming_fit(bad, "features", (), "label", None)


# ---------------------------------------------------------------------------
# epoch streaming: KMeans
# ---------------------------------------------------------------------------


def _grid_blobs(seed, n=2000, d=5, k=4):
    """Rows on a 1/8 grid around k centres, weights on a 1/2 grid: float32
    holds every row, weight and partial sum exactly, so the JAX package's
    float32 chunk sums equal float64 ones."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(-6, 7, size=(k, d)) * 1.0
    X = centres[rng.integers(0, k, n)] + rng.integers(-8, 9, size=(n, d)) / 8.0
    w = rng.integers(1, 5, n) / 2.0
    return X, w


def test_kmeans_streaming_fit_matches_jax(tmp_path):
    """From the JAX package's own seeding (its `seed_sample_stride` sample
    and `kmeans_parallel_init`, handed in through `init_centers=`), the
    port's streamed Lloyd gives the JAX streamed fit's centres and cost
    within 1e-10 in float64, in as many iterations."""
    from spark_rapids_ml_tpu.ops import kmeans as jax_km

    X, w = _grid_blobs(12)
    path = _write(tmp_path / "km.parquet", X, w=w, row_group_size=700)
    k, seed, init_rows = 4, 3, 500
    stride = jax_km.seed_sample_stride(2000, init_rows)
    assert stride == 4
    kw = dict(k=k, seed=seed, max_iter=30, tol=1e-6, dtype=np.float64, chunk_rows=256,
              init_rows=init_rows)
    with jax.enable_x64(True):
        m = max(int(round(2.0 * k)), -(-(k - 1) // 2), 1)
        C0 = np.asarray(jax_km.kmeans_parallel_init(
            jnp.asarray(X[::stride]), jnp.asarray(w[::stride]), k, seed, rounds=2, m=m))
        want = jax_streaming.kmeans_streaming_fit(path, "features", (), "wt", **kw)
    got = port_streaming.kmeans_streaming_fit(path, "features", (), "wt", init_centers=C0, **kw)
    assert got["n_iter"] == want["n_iter"]
    np.testing.assert_allclose(got["centers"], want["centers"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-10)
    assert got["epochs"] == got["n_iter"] + 1
    # the port's own seeding sample is the JAX package's
    Xs, ws = port_streaming.seed_sample(path, "features", (), "wt", 2000, init_rows,
                                        np.float64, 256)
    np.testing.assert_array_equal(Xs, X[::stride])
    np.testing.assert_array_equal(ws, w[::stride])


def test_kmeans_streaming_fit_matches_in_memory(tmp_path):
    """float64: the streamed fit from given centres equals ops/kmeans.py
    `kmeans_fit` on the same rows (1e-12), the stop rule included; its own
    seeding gives a finite fit of k centres."""
    from spark_rapids_ml_torch.ops.kmeans import kmeans_fit

    X, w = _grid_blobs(13, n=1500)
    path = _write(tmp_path / "km2.parquet", X, w=w)
    C0 = X[[0, 500, 1000, 1499]]
    got = port_streaming.kmeans_streaming_fit(path, "features", (), "wt", k=4, seed=1,
                                              max_iter=50, tol=0.0, dtype=np.float64,
                                              chunk_rows=200, init_centers=C0)
    C, cost, n_iter = kmeans_fit(torch.from_numpy(X), torch.from_numpy(w), 4, 1, max_iter=50,
                                 tol=0.0, init_centers=C0)
    assert got["n_iter"] == n_iter
    np.testing.assert_allclose(got["centers"], C.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got["cost"], float(cost), rtol=1e-12)
    seeded = port_streaming.kmeans_streaming_fit(path, "features", (), None, k=4, seed=5,
                                                 max_iter=20, dtype=np.float32)
    assert seeded["centers"].shape == (4, 5) and np.isfinite(seeded["cost"])
    with pytest.raises(ValueError, match="exceeds"):
        port_streaming.kmeans_streaming_fit(path, "features", (), None, k=2000, seed=1)


# ---------------------------------------------------------------------------
# the budget decision, and what is not ported
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hbm_bytes,force,need", [
    (None, False, 1e6), (None, True, 1e6), (1024, False, 1e6), (1 << 40, False, 1e9),
    (1 << 40, True, 1e3),
])
def test_budget_decision_follows_jax(hbm_bytes, force, need):
    """`_over_device_budget` takes the JAX package's decision for the same
    confs (hbm_bytes unset: its 16 GiB on the CPU); the port's budget is
    hbm_bytes * mem_ratio_for_data for its one device."""
    from spark_rapids_ml_torch.core import device_data_budget_bytes
    from spark_rapids_ml_torch.regression import LinearRegression
    from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinReg

    confs = {"force_streaming_stats": force}
    if hbm_bytes is not None:
        confs["hbm_bytes"] = hbm_bytes
    port_config.set_config(**confs)
    jax_config.set_config(**confs)
    est = LinearRegression()
    assert est._over_device_budget(need) == JaxLinReg()._over_device_budget(need)
    budget = device_data_budget_bytes("cpu")
    assert budget == (hbm_bytes or 16 * 2**30) * 0.8
    assert est._fit_record["budget"] == {"need_bytes": need, "budget_bytes": budget,
                                         "resident_bytes": 0,
                                         "over": force or need > budget, "forced": force}


def test_not_ported_options_raise(tmp_path):
    """The streamed fits' checkpoints raise, naming the ROADMAP item; an
    unknown sampling mode raises.  DuHL sampling and a DuHL chunk selection,
    which raised before the chunk cache was ported, now run: the fits report
    their sampling, and a selection yields the chunks at those positions."""
    X, y, _ = _rows(14, n=300, d=3)
    path = _write(tmp_path / "n.parquet", X, y)
    fits = (lambda **kw: port_streaming.logreg_streaming_fit(path, "features", (), "label",
                                                             None, **kw),
            lambda **kw: port_streaming.kmeans_streaming_fit(path, "features", (), None, k=2,
                                                             seed=1, **kw))
    for fit in fits:
        port_config.set_config(streaming_chunk_sampling="duhl")
        res = fit()
        assert res["sampled_epochs"] >= 0 and res["chunk_visits_saved"] >= 0
        port_config.set_config(streaming_chunk_sampling="off",
                               streaming_checkpoint_dir=str(tmp_path))
        with pytest.raises(NotImplementedError, match="item 5"):
            fit()
        port_config.reset_config()
        with pytest.raises(NotImplementedError, match="item 5"):
            fit(checkpoint_path=str(tmp_path / "c.npz"))
        port_config.set_config(streaming_chunk_sampling="maybe")
        with pytest.raises(ValueError, match="off|duhl"):
            fit()
        port_config.reset_config()
    every = list(port_streaming.iter_chunks(path, "features", (), None, None, 64, np.float32))
    picked = list(port_streaming.iter_chunks(path, "features", (), None, None, 64, np.float32,
                                             select_chunks={0, 2}))
    assert len(picked) == 2
    for got, want in zip(picked, (every[0], every[2])):
        np.testing.assert_array_equal(got[0], want[0])


def test_conf_keys_match_jax():
    """The ported keys and defaults are the JAX package's, except
    hbm_bytes (None: the card's own memory)."""
    keys = ("streaming_ingest", "force_streaming_stats", "mem_ratio_for_data",
            "streaming_prefetch", "streaming_prefetch_depth", "fused_parquet_readers",
            "streaming_chunk_sampling", "streaming_checkpoint_dir")
    for k in keys:
        assert port_config.get_config(k) == jax_config.get_config(k), k
    assert port_config.get_config("hbm_bytes") is None
    assert jax_config.get_config("hbm_bytes") == 16 * 2**30
