#
# The port's chunk cache, its device-budget ledger and DuHL chunk sampling
# (spark_rapids_ml_torch/parallel/device_cache.py, parallel/chunk_codec.py
# and the cached scans of streaming.py and fused.py) against the JAX
# package, on the CPU: replayed chunks equal to the filled ones and to the
# JAX package's decode of the same file (FixedSizeList, list and scalar
# feature columns, float32 and float64), spill and restore bit for bit,
# checksum failures under an in-order and an order-free source, eviction
# under `chunk_cache_host_bytes`, a path rewritten in place, read-only
# served arrays, a failing spill, the ledger seen by `_over_device_budget`,
# streamed statistics and fits from a replay against the JAX package's
# (1e-5 float32, 1e-10 float64), `DuhlChunkSampler` against the JAX
# package's, and DuHL fits against their exact fits.  Files are a few
# thousand rows, written from numpy seeds into tmp_path.  The JAX package
# runs with its own chunk cache off, so that it decodes every scan.
#
import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import fused as port_fused
from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import streaming as port_streaming
from spark_rapids_ml_torch.parallel import chunk_codec as port_codec
from spark_rapids_ml_torch.parallel import device_cache as dc
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu import streaming as jax_streaming
from spark_rapids_ml_tpu.parallel import chunk_codec as jax_codec


@pytest.fixture(scope="module", autouse=True)
def _x64_flag_unchanged():
    before = jax.config.jax_enable_x64
    yield
    assert jax.config.jax_enable_x64 == before


def _reset_cache():
    dc.clear_chunk_cache()
    ledger = dc.get_device_cache()
    ledger.release_external_many(list(ledger._external))


@pytest.fixture(autouse=True)
def _cpu_and_clean():
    set_default_device("cpu")
    port_config.reset_config()
    jax_config.reset_config()
    jax_config.set_config(chunk_cache="off")
    _reset_cache()
    yield
    _reset_cache()
    port_config.reset_config()
    jax_config.reset_config()
    set_default_device(None)


def _rows(seed, n=1500, d=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(size=d)
    y = (X @ rng.normal(size=d) + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    w = rng.choice([0.0, 0.25, 0.5, 1.0, 1.5, 2.0], size=n)
    return X, y, w


def _write(path, X, y=None, w=None, layout="fixed", row_group_size=None, dtype=np.float64):
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


def _copy(chunks):
    return [tuple(np.array(a) if isinstance(a, np.ndarray) else a for a in c) for c in chunks]


def _assert_chunks_equal(got, want):
    assert len(got) == len(want)
    for g, j in zip(got, want):
        assert len(g) == len(j)
        for a, b in zip(g, j):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


# ---------------------------------------------------------------------------
# replay parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["fixed", "list", "cols"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_replay_equals_fill_and_jax_decode(tmp_path, layout, dtype):
    """`iter_chunks` through the cache: the first scan decodes (a miss),
    the second replays (a hit) the same chunks bit for bit, and both equal
    the JAX package's decode of the file, with a row range too."""
    X, y, w = _rows(1, n=1037, d=5)
    path = _write(tmp_path / "a.parquet", X, y, w, layout=layout, row_group_size=300,
                  dtype=dtype)
    fcol, fcols = _fcols(layout, 5)
    for row_range in (None, (100, 900)):
        args = (path, fcol, fcols, "label", "wt", 128, np.dtype(dtype))
        want = _copy(jax_streaming.iter_chunks(*args, row_range=row_range))
        misses, hits = dc.CHUNK_METRICS["misses"], dc.CHUNK_METRICS["hits"]
        fill = _copy(port_streaming.iter_chunks(*args, row_range=row_range))
        assert dc.CHUNK_METRICS["misses"] == misses + 1
        replay = _copy(port_streaming.iter_chunks(*args, row_range=row_range))
        assert dc.CHUNK_METRICS["hits"] == hits + 1
        _assert_chunks_equal(fill, want)
        _assert_chunks_equal(replay, want)
        # cache_ok=False decodes and leaves the cache as it was
        inserts = dc.CHUNK_METRICS["inserts"]
        _assert_chunks_equal(_copy(port_streaming.iter_chunks(*args, row_range=row_range,
                                                               cache_ok=False)), want)
        assert dc.CHUNK_METRICS["inserts"] == inserts


@pytest.mark.parametrize("readers", [1, 3])
def test_file_chunks_replay_the_recorded_order(tmp_path, readers):
    """`iter_file_chunks` records each chunk with its global row: replays
    give the fill's order bit for bit (the range readers' order differs from
    run to run), and the chunks placed by their rows are the JAX package's
    in-order decode."""
    X, y, w = _rows(2, n=2000, d=4)
    path = _write(tmp_path / "b.parquet", X, y, w, row_group_size=250, dtype=np.float32)
    port_config.set_config(fused_parquet_readers=readers)
    args = (path, "features", (), "label", "wt", 200, np.dtype(np.float32))
    fill = _copy(port_streaming.iter_file_chunks(*args))
    replay = _copy(port_streaming.iter_file_chunks(*args))
    replay2 = _copy(port_streaming.iter_file_chunks(*args))
    _assert_chunks_equal(replay, fill)
    _assert_chunks_equal(replay2, replay)
    # each range reader chunks its own share, so the chunks differ from one
    # scan's; the rows they place are the file's
    want = _copy(jax_streaming.iter_chunks(*args))
    for part in range(3):
        placed = np.full((2000,) + want[0][part].shape[1:], np.nan, want[0][part].dtype)
        for c in fill:
            placed[c[4]:c[4] + c[3]] = c[part][:c[3]]
        np.testing.assert_array_equal(placed,
                                      np.concatenate([j[part][:j[3]] for j in want]))


def test_select_chunks_serves_those_positions(tmp_path):
    """A selection of a complete stream serves those positions of the
    recorded order; on a stream not yet cached it selects from the source."""
    X, y, w = _rows(3, n=1000, d=3)
    path = _write(tmp_path / "s.parquet", X, y, w)
    args = (path, "features", (), "label", None, 100, np.dtype(np.float64))
    picked_cold = _copy(port_streaming.iter_chunks(*args, select_chunks={1, 4}))
    every = _copy(port_streaming.iter_chunks(*args))
    assert port_streaming.chunk_stream_key(*args[:7]) is not None
    assert dc.chunk_stream_complete(port_streaming.chunk_stream_key(*args[:7])) == 10
    picked = _copy(port_streaming.iter_chunks(*args, select_chunks={1, 4}))
    _assert_chunks_equal(picked, [every[1], every[4]])
    _assert_chunks_equal(picked_cold, [every[1], every[4]])


# ---------------------------------------------------------------------------
# the spill tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["none", "zlib"])
@pytest.mark.parametrize("to_disk", [False, True])
def test_spill_and_restore_bit_for_bit(tmp_path, codec, to_disk):
    """Under a host budget smaller than the stream, LRU chunks spill
    (compressed by `codec`, in memory or in files) and come back bit for
    bit; the restores are counted and the blobs' crc32 checked."""
    X, y, w = _rows(4, n=4000, d=8)
    X = np.round(X)  # integer values, for zlib to find
    path = _write(tmp_path / "c.parquet", X, y, w)
    spill_dir = str(tmp_path / "spill") if to_disk else ""
    port_config.set_config(chunk_cache_host_bytes=120_000, chunk_cache_codec=codec,
                           chunk_cache_spill_dir=spill_dir)
    args = (path, "features", (), "label", "wt", 500, np.dtype(np.float64))
    want = _copy(jax_streaming.iter_chunks(*args))
    fill = _copy(port_streaming.iter_chunks(*args))
    restores = dc.CHUNK_METRICS["restores"]
    replay = _copy(port_streaming.iter_chunks(*args))
    _assert_chunks_equal(fill, want)
    _assert_chunks_equal(replay, want)
    if codec == "zlib" or to_disk:  # a spill frees host bytes: the stream stays
        assert dc.CHUNK_METRICS["spills"] > 0
        assert dc.CHUNK_METRICS["restores"] > restores
    if to_disk:
        import os

        assert os.listdir(spill_dir)
        dc.clear_chunk_cache()
        assert not os.listdir(spill_dir)  # a dropped stream removes its files


def _spilled_blob_stream(tmp_path, ordered_readers: int):
    """A cached, fully spilled zlib stream of `iter_file_chunks`
    (`ordered_readers` 1: one in-order scan; 3: the range readers)."""
    X, y, w = _rows(5, n=2000, d=4)
    path = _write(tmp_path / "e.parquet", X, y, w, row_group_size=250)
    # every chunk spills to a file (files leave the host budget)
    port_config.set_config(chunk_cache_host_bytes=1, chunk_cache_codec="zlib",
                           chunk_cache_spill_dir=str(tmp_path / "spill"),
                           fused_parquet_readers=ordered_readers)
    args = (path, "features", (), "label", "wt", 200, np.dtype(np.float64))
    fill = _copy(port_streaming.iter_file_chunks(*args))
    cache = dc.get_chunk_cache()
    (st,) = [s for s in cache._streams.values() if s.complete]
    return args, fill, st


def test_checksum_failure_in_order_source_resumes(tmp_path):
    """A torn spilled chunk of an in-order stream: the stream is dropped
    and the scan finishes from the file at the failed position, so the
    consumer sees the whole stream once; the failure is counted."""
    args, fill, st = _spilled_blob_stream(tmp_path, 1)
    sp = st.chunks[3].arrays()[0].spill
    with open(sp.path, "r+b") as f:
        f.seek(-7, 2)
        f.write(b"garbage")
    failures = dc.CHUNK_METRICS["checksum_failures"]
    got = _copy(port_streaming.iter_file_chunks(*args))
    _assert_chunks_equal(got, fill)
    assert dc.CHUNK_METRICS["checksum_failures"] == failures + 1
    assert st.dropped


def test_checksum_failure_order_free_source_raises(tmp_path):
    """The same fault in a stream the range readers filled raises
    `ChunkIntegrityError`: resuming a run of the readers by position would
    repeat some chunks and skip others."""
    args, fill, st = _spilled_blob_stream(tmp_path, 3)
    import os

    os.remove(st.chunks[2].arrays()[0].spill.path)
    with pytest.raises(dc.ChunkIntegrityError, match="order-free"):
        list(port_streaming.iter_file_chunks(*args))
    # the stream was dropped: the next scan decodes again
    _assert_chunks_equal(sorted(_copy(port_streaming.iter_file_chunks(*args)),
                                key=lambda c: c[4]), sorted(fill, key=lambda c: c[4]))


def test_spill_fault_leaves_no_half_stream(tmp_path, monkeypatch):
    """A spill that fails mid-fill drops the stream (no half-recorded stream,
    no bytes left on the books) and reaches the consumer; the pass run again
    gives the statistics of a clean pass: nothing is counted twice."""
    X, y, w = _rows(6, n=3000, d=5)
    path = _write(tmp_path / "f.parquet", X, y, w)
    clean = port_streaming.linreg_streaming_stats(path, "features", (), "label", "wt",
                                                  dtype=np.float64, chunk_rows=300)
    _reset_cache()
    port_config.set_config(chunk_cache_host_bytes=20_000,
                           chunk_cache_spill_dir=str(tmp_path / "spill"))
    calls = {"n": 0}
    real = dc.ChunkCache._spill_chunk_locked

    def failing(self, chunk):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("injected spill fault")
        return real(self, chunk)

    monkeypatch.setattr(dc.ChunkCache, "_spill_chunk_locked", failing)
    with pytest.raises(OSError, match="injected"):
        port_streaming.linreg_streaming_stats(path, "features", (), "label", "wt",
                                              dtype=np.float64, chunk_rows=300)
    cache = dc.get_chunk_cache()
    assert not cache._streams
    assert cache._host_total == 0 and dc.CHUNK_METRICS["host_bytes"] == 0
    again = port_streaming.linreg_streaming_stats(path, "features", (), "label", "wt",
                                                  dtype=np.float64, chunk_rows=300)
    for k in clean:
        np.testing.assert_allclose(again[k], clean[k], rtol=1e-12, atol=1e-12)


def test_host_budget_evicts_the_lru_stream(tmp_path):
    """Beyond `chunk_cache_host_bytes` with codec "none" (a spill frees
    nothing) the least recently used stream is dropped; a stream larger than
    the whole budget is not kept at all; the books stay at the budget."""
    paths = []
    for i in range(3):
        X, y, w = _rows(10 + i, n=1000, d=4)
        paths.append(_write(tmp_path / f"g{i}.parquet", X, y, w))
    one = 1000 * 4 * 8 + 1000 * 8  # a stream's X and y (float64)
    port_config.set_config(chunk_cache_host_bytes=2 * one + 100)

    def scan(p):
        return _copy(port_streaming.iter_chunks(p, "features", (), "label", None, 250,
                                                np.dtype(np.float64)))

    scan(paths[0])
    scan(paths[1])
    scan(paths[0])  # paths[0] is now the most recently used
    evictions = dc.CHUNK_METRICS["evictions"]
    scan(paths[2])
    assert dc.CHUNK_METRICS["evictions"] == evictions + 1
    keys = {k[1] for k in dc.get_chunk_cache()._streams}
    assert keys == {paths[0], paths[2]}
    assert dc.get_chunk_cache()._host_total <= 2 * one + 100
    port_config.set_config(chunk_cache_host_bytes=one // 2)
    dc.clear_chunk_cache()
    scan(paths[1])
    assert not dc.get_chunk_cache()._streams


def test_path_rewritten_in_place_gets_a_new_key(tmp_path):
    """A file rewritten under the same path has another change stamp, so
    its scan decodes the new rows instead of replaying the old ones."""
    import os

    X1, y1, _ = _rows(20, n=600, d=3)
    path = _write(tmp_path / "h.parquet", X1, y1)
    args = (path, "features", (), "label", None, 200, np.dtype(np.float64))
    key1 = port_streaming.chunk_stream_key(*args[:7])
    first = _copy(port_streaming.iter_chunks(*args))
    X2, y2, _ = _rows(21, n=600, d=3)
    _write(tmp_path / "h.parquet", X2, y2)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert port_streaming.chunk_stream_key(*args[:7]) != key1
    second = _copy(port_streaming.iter_chunks(*args))
    np.testing.assert_array_equal(first[0][0], X1[:200])
    np.testing.assert_array_equal(second[0][0], X2[:200])


def test_served_arrays_are_read_only(tmp_path):
    """Filled and replayed host arrays are read-only: a consumer that
    writes into a chunk fails instead of corrupting the next epoch."""
    X, y, w = _rows(22, n=500, d=3)
    path = _write(tmp_path / "r.parquet", X, y, w)
    args = (path, "features", (), "label", "wt", 100, np.dtype(np.float64))
    for _ in range(2):
        for cX, cy, cw, _n in port_streaming.iter_chunks(*args):
            for a in (cX, cy, cw):
                assert not a.flags.writeable
                with pytest.raises(ValueError):
                    a[0] = 1.0


def test_codecs_match_jax():
    """The codec registry and checksum are the JAX package's: the same
    codecs resolve here, the same crc32, round trips, unknown names raise
    ValueError, a registered codec resolves."""
    assert port_codec.available_codecs() == jax_codec.available_codecs()
    data = np.random.default_rng(0).normal(size=1000).tobytes()
    assert port_codec.checksum(data) == jax_codec.checksum(data)
    for name in port_codec.available_codecs():
        _, c, dcmp = port_codec.resolve_codec(name)
        _, jc, jd = jax_codec.resolve_codec(name)
        assert dcmp(c(data)) == data
        assert jd(c(data)) == data and dcmp(jc(data)) == data
    with pytest.raises(ValueError, match="unknown chunk_cache_codec"):
        port_codec.resolve_codec("snappy9")
    port_codec.register_codec("rev", lambda b: b[::-1], lambda b: b[::-1])
    assert "rev" in port_codec.available_codecs()
    assert port_codec.resolve_codec("rev")[2](port_codec.resolve_codec("rev")[1](data)) == data


def test_conf_keys_match_jax():
    """The chunk cache's, DuHL's and the summarizer's keys and defaults are
    the JAX package's."""
    keys = ("chunk_cache", "chunk_cache_host_bytes", "chunk_cache_codec",
            "chunk_cache_spill_dir", "streaming_chunk_sampling",
            "streaming_chunk_sample_fraction", "summarizer_sketch_k", "summarizer_frequent_k",
            "summarizer_hll_bits", "summarizer_chi2_bins", "device_cache_bytes")
    jax_config.reset_config()
    for k in keys:
        assert port_config.get_config(k) == jax_config.get_config(k), k


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


def test_ledger_claims_are_seen_by_over_device_budget():
    """An external claim counts against the next fit's budget
    (`need + resident > budget`, the JAX package's rule); with
    force_streaming_stats the ledger is not read; a claim beyond the budget
    is refused and leaves the old one; shortfall and release as in JAX."""
    from spark_rapids_ml_torch.regression import LinearRegression

    port_config.set_config(hbm_bytes=1000)  # a budget of 800 bytes
    assert dc.cache_budget_bytes() == 800.0
    est = LinearRegression()
    assert not est._over_device_budget(500)
    ledger = dc.get_device_cache()
    assert ledger.reserve_external("a", 400)
    assert dc.cache_resident_bytes() == 400
    assert est._over_device_budget(500)
    assert est._fit_record["budget"]["resident_bytes"] == 400
    assert ledger.external_shortfall("b", 500) == 100
    assert not ledger.reserve_external("b", 500, evict=False)
    assert ledger.external_bytes() == 400
    assert ledger.reserve_external("a", 700)  # a repeat claim replaces the old one
    assert dc.cache_resident_bytes() == 700
    port_config.set_config(force_streaming_stats=True)
    assert est._over_device_budget(1)
    assert est._fit_record["budget"]["resident_bytes"] == 0
    port_config.set_config(force_streaming_stats=False)
    assert dc.release_external_many(["a", "zz"]) == 700
    assert dc.release_external("a") == 0
    assert not est._over_device_budget(500)
    port_config.set_config(device_cache_bytes=123)
    assert dc.cache_budget_bytes() == 123.0


# ---------------------------------------------------------------------------
# statistics and fits from a replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-10)])
@pytest.mark.parametrize("readers", [1, 3])
def test_streamed_statistics_from_a_replay_match_jax(tmp_path, dtype, rtol, readers):
    """linreg_streaming_stats and pca_streaming_stats: the fill and two
    replays against the JAX package's decode (PR 9's limits); replay against
    replay bit for bit, and fill against replay bit for bit with one
    reader."""
    X, y, w = _rows(30, n=3000, d=6)
    path = _write(tmp_path / "l.parquet", X, y, w, row_group_size=400,
                  dtype=np.float32 if dtype == np.float32 else np.float64)
    port_config.set_config(fused_parquet_readers=readers)
    kw = dict(dtype=dtype, chunk_rows=400)
    if dtype == np.float64:
        with jax.enable_x64(True):
            want = jax_streaming.linreg_streaming_stats(path, "features", (), "label", "wt", **kw)
    else:
        want = jax_streaming.linreg_streaming_stats(path, "features", (), "label", "wt", **kw)
    runs = [port_streaming.linreg_streaming_stats(path, "features", (), "label", "wt", **kw)
            for _ in range(3)]
    assert port_streaming.STREAM_METRICS["chunks"] == 8
    for got in runs:
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k], np.float64), rtol=rtol,
                                       atol=rtol * np.abs(want[k]).max())
    for k in want:
        np.testing.assert_array_equal(runs[1][k], runs[2][k])
        if readers == 1:
            np.testing.assert_array_equal(runs[0][k], runs[1][k])
    pca_runs = [port_streaming.pca_streaming_stats(path, "features", (), "wt", **kw)
                for _ in range(2)]
    for k in ("S", "s1", "sw"):
        np.testing.assert_allclose(pca_runs[1][k], runs[0]["gram" if k == "S" else k],
                                   rtol=rtol, atol=rtol * np.abs(runs[0]["s1"]).max())


def test_streamed_fits_from_a_replay_match_jax(tmp_path):
    """The epoch-streamed LogisticRegression and KMeans in float64, every
    pass after the first a replay: the logistic objective against the JAX
    package's float64 fit of the same rows on its host-driven solver (its
    own streamed fit evaluates in float32 whatever the dtype) within 1e-10
    in as many iterations, and bit for bit against the same fit with the
    cache off (one reader); KMeans from the JAX package's seeding against
    its streamed fit within 1e-10."""
    import pandas as pd

    from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR
    from spark_rapids_ml_tpu.ops import kmeans as jax_km

    X, y, w = _rows(31, n=2000, d=5)
    path = _write(tmp_path / "m.parquet", X, y, w, row_group_size=700)
    port_config.set_config(fused_parquet_readers=1)
    kw = dict(l2=1e-2, max_iter=60, tol=1e-10, dtype=np.float64, chunk_rows=256,
              standardization=False)
    hits = dc.CHUNK_METRICS["hits"]
    got = port_streaming.logreg_streaming_fit(path, "features", (), "label", "wt", **kw)
    assert dc.CHUNK_METRICS["hits"] - hits == got["epochs"]  # the scan filled, every epoch replayed
    jax_config.set_config(dispatch_flops_limit=1.0)
    with jax.enable_x64(True):
        jm = JaxLR(regParam=1e-2, standardization=False, tol=1e-10, maxIter=60,
                   float32_inputs=False).setWeightCol("wt").fit(
            pd.DataFrame({"features": list(X), "label": y, "wt": w}))
    assert got["n_iter"] == jm.num_iters
    np.testing.assert_allclose(got["history"][-1], jm.objective, rtol=1e-10)
    port_config.set_config(chunk_cache="off")
    off = port_streaming.logreg_streaming_fit(path, "features", (), "label", "wt", **kw)
    np.testing.assert_array_equal(off["coef"], got["coef"])
    port_config.set_config(chunk_cache="on")

    # rows on a 1/8 grid, weights on a 1/2 grid: the JAX package's float32
    # chunk sums are exact (test_torch_streaming.py `_grid_blobs`)
    rng = np.random.default_rng(12)
    centres = rng.integers(-6, 7, size=(4, 5)) * 1.0
    X = centres[rng.integers(0, 4, 2000)] + rng.integers(-8, 9, size=(2000, 5)) / 8.0
    w = rng.integers(1, 5, 2000) / 2.0
    path = _write(tmp_path / "km.parquet", X, w=w, row_group_size=700)
    k, init_rows = 4, 500
    stride = jax_km.seed_sample_stride(2000, init_rows)
    with jax.enable_x64(True):
        C0 = np.asarray(jax_km.kmeans_parallel_init(
            jax.numpy.asarray(X[::stride]), jax.numpy.asarray(w[::stride]), k, 3, rounds=2,
            m=8))
        kmw = jax_streaming.kmeans_streaming_fit(path, "features", (), "wt", k=k, seed=3,
                                                 max_iter=30, tol=1e-6, dtype=np.float64,
                                                 chunk_rows=256, init_rows=init_rows)
    kmg = port_streaming.kmeans_streaming_fit(path, "features", (), "wt", k=k, seed=3,
                                              max_iter=30, tol=1e-6, dtype=np.float64,
                                              chunk_rows=256, init_rows=init_rows,
                                              init_centers=C0)
    assert kmg["n_iter"] == kmw["n_iter"]
    np.testing.assert_allclose(kmg["centers"], kmw["centers"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(kmg["cost"], kmw["cost"], rtol=1e-10)


def test_fused_randomized_pca_replays_its_passes(tmp_path):
    """The fused randomized PCA from parquet: the first of its four passes
    decodes, the other three replay; the model equals the one fitted with
    the cache off (one reader: bit for bit), and its `fit_report()` carries
    the cache's hits and bytes."""
    from spark_rapids_ml_torch.feature import PCA

    X, _, _ = _rows(32, n=3000, d=40)
    path = _write(tmp_path / "p.parquet", X, dtype=np.float32)
    port_config.set_config(fused_stage_solve="on", pca_solver="randomized",
                           fused_parquet_readers=1)
    model = PCA(k=3).setInputCol("features").fit(path)
    rep = model.fit_report()
    assert rep["route"] == "fused_parquet"
    assert [p["source"] for p in rep["fused"]["pass_log"]] == ["decode"] + ["replay"] * 3
    assert rep["chunk_cache"]["misses"] == 1 and rep["chunk_cache"]["hits"] == 3
    # three chunks of 1024 rows, the last with its weights (padding)
    assert rep["chunk_cache"]["hit_bytes"] == 3 * (3 * 1024 * 40 * 4 + 1024 * 4)
    again = PCA(k=3).setInputCol("features").fit(path)
    assert again.fit_report()["chunk_cache"]["hits"] == 4
    port_config.set_config(chunk_cache="off")
    off = PCA(k=3).setInputCol("features").fit(path)
    assert "chunk_cache" not in off.fit_report()
    np.testing.assert_array_equal(model.components_, off.components_)
    np.testing.assert_array_equal(again.components_, off.components_)


# ---------------------------------------------------------------------------
# DuHL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fraction,warm,full", [(0.5, None, None), (0.3, 3, 4), (0.05, 2, 2)])
def test_duhl_sampler_matches_jax(fraction, warm, full):
    """On the same score sequences and iterates, the port's sampler selects
    the same chunks as the JAX package's, epoch by epoch, and keeps the same
    accounting."""
    rng = np.random.default_rng(int(fraction * 100))
    n = 23
    a = port_streaming.DuhlChunkSampler(fraction, warm_evals=warm, full_every=full)
    b = jax_streaming.DuhlChunkSampler(fraction, warm_evals=warm, full_every=full)
    it = rng.normal(size=7)
    for epoch in range(60):
        sa, sb = a.select(), b.select()
        assert sa == sb, epoch
        idxs = list(range(n)) if sa is None else sa
        if not a.ready():
            a.start(n)
            b.start(n)
        scores = rng.exponential(size=len(idxs))
        for i, s in zip(idxs, scores):
            a.visited(i, s)
            b.visited(i, s)
        a.epoch_done(idxs)
        b.epoch_done(idxs)
        if sa is None:
            it = it + rng.normal(size=7) * 0.5 ** epoch
            a.note_refresh(it)
            b.note_refresh(it)
        np.testing.assert_array_equal(a.age, b.age)
    assert a.summary() == b.summary()


def _parquet_like_jax_test(tmp_path, X, y=None, name="d.parquet"):
    """The JAX package's DuHL tests' layout: pandas' `list(X)` features."""
    import pandas as pd

    df = pd.DataFrame({"features": list(np.asarray(X))})
    if y is not None:
        df["label"] = y
    path = str(tmp_path / name)
    df.to_parquet(path)
    return path


def test_duhl_logreg_meets_its_exact_fit(tmp_path):
    """The JAX package's `test_duhl_logreg_convergence_parity` on the port:
    the sampled fit samples, saves chunk visits, converges, and meets the
    exact fit within its tolerances (5e-3 relative in the coefficients,
    5e-3 in the intercept)."""
    rng = np.random.default_rng(42)
    n, d = 12000, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    yv = (X @ rng.normal(size=d).astype(np.float32) > 0).astype(np.float64)
    path = _parquet_like_jax_test(tmp_path, X, yv)
    port_config.set_config(host_batch_bytes=64 * 1024)
    full = port_streaming.logreg_streaming_fit(path, "features", (), "label", None, l2=1e-3,
                                               max_iter=60)
    dc.clear_chunk_cache()
    port_config.set_config(streaming_chunk_sampling="duhl", streaming_chunk_sample_fraction=0.5)
    duhl = port_streaming.logreg_streaming_fit(path, "features", (), "label", None, l2=1e-3,
                                               max_iter=60)
    assert duhl["converged"] and full["converged"]
    assert duhl["sampled_epochs"] > 0 and duhl["chunk_visits_saved"] > 0
    assert port_streaming.STREAM_METRICS["sampled_epochs"] == duhl["sampled_epochs"]
    cf, cd = full["coef"].ravel(), duhl["coef"].ravel()
    assert np.linalg.norm(cf - cd) / np.linalg.norm(cf) < 5e-3
    np.testing.assert_allclose(full["intercept"], duhl["intercept"], atol=5e-3)


def test_duhl_kmeans_meets_its_exact_fit(tmp_path):
    """The JAX package's `test_duhl_kmeans_convergence_parity` on the port:
    the sampled fit samples and its final cost (an exact pass) is within 2%
    of the exact fit's."""
    rng = np.random.default_rng(42)
    X = np.concatenate([rng.normal(loc=c, scale=2.0, size=(4000, 5))
                        for c in (0.0, 1.5, -1.5, 3.0)]).astype(np.float32)
    path = _parquet_like_jax_test(tmp_path, X)
    port_config.set_config(host_batch_bytes=64 * 1024)
    kw = dict(k=4, seed=3, max_iter=30, tol=1e-4)
    full = port_streaming.kmeans_streaming_fit(path, "features", (), None, **kw)
    dc.clear_chunk_cache()
    port_config.set_config(streaming_chunk_sampling="duhl", streaming_chunk_sample_fraction=0.5)
    duhl = port_streaming.kmeans_streaming_fit(path, "features", (), None, **kw)
    assert duhl["sampled_epochs"] > 0 and duhl["chunk_visits_saved"] > 0
    assert abs(duhl["cost"] - full["cost"]) / full["cost"] < 0.02


def test_fused_parquet_stream_of_the_range_readers_is_order_free(tmp_path):
    """The fused pass's parquet stream from several range readers is
    recorded with `ordered=False`: a torn chunk mid-replay raises instead of
    resuming, and the statistics of the replays equal each other bit for
    bit."""
    X, y, _ = _rows(33, n=3000, d=5)
    path = _write(tmp_path / "o.parquet", X, y, row_group_size=300, dtype=np.float32)
    port_config.set_config(chunk_cache_host_bytes=1, chunk_cache_codec="zlib",
                           chunk_cache_spill_dir=str(tmp_path / "spill"))

    def fused_pass():
        acc, step = port_fused._steps("linreg", 5, 0, np.dtype(np.float32), "cpu")
        prep = {"s": 0.0, "iv": []}
        chunks = port_fused.iter_parquet_chunks(path, "features", (), "label", None, 256,
                                                np.float32, readers=3, prep=prep, device="cpu")
        return port_fused.accumulate_chunks(acc, step, chunks, "cpu", has_y=True, prep=prep)[0]

    fused_pass()
    r1, r2 = fused_pass(), fused_pass()
    for k in r1:
        np.testing.assert_array_equal(r1[k], r2[k])
    (st,) = list(dc.get_chunk_cache()._streams.values())
    with open(st.chunks[1].arrays()[0].spill.path, "wb") as f:
        f.write(b"\0" * 16)
    with pytest.raises(dc.ChunkIntegrityError):
        fused_pass()
