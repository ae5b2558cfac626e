#
# The chunk cache's device tier on the card: a replay from the device tier
# gives the chunks the host tier gives; a mirror that meets
# `torch.cuda.OutOfMemoryError` serves from the host tier and is counted,
# while any other error reaches the caller; the consumers that take cached
# CUDA chunks (the streamed statistics, the streamed LogisticRegression and
# KMeans, the fused randomized PCA) leave them as they were; a consumer on the
# CPU of a stream filled on the card gets host arrays; a device loss
# drops the device tier and keeps the host and spill tiers; and the device
# tier's claim is counted by the next fit's budget.  Every test here needs a
# CUDA device and skips without one.  This file imports no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_chunk_cache_cuda.py
#
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import set_default_device, streaming
from spark_rapids_ml_torch.parallel import device_cache as dc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    port_config.reset_config()
    _reset()
    set_default_device("cuda")
    yield torch.device("cuda", torch.cuda.current_device())
    _reset()
    set_default_device(None)
    port_config.reset_config()


def _reset():
    dc.clear_chunk_cache()
    ledger = dc.get_device_cache()
    ledger.release_external_many(list(ledger._external))


def _file(tmp_path, n=20000, d=12, seed=0, name="c.parquet"):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(size=d))
    y = (X @ rng.normal(size=d) + rng.normal(size=n) > 0).astype(np.float64)
    path = str(tmp_path / name)
    pq.write_table(pa.table({
        "features": pa.FixedSizeListArray.from_arrays(pa.array(X.astype(np.float32).reshape(-1)),
                                                      d),
        "label": pa.array(y)}), path, row_group_size=2500)
    return path, X, y


def _scan(path, device, **kw):
    """The chunks of an `iter_file_chunks` scan with device_ok, as host
    arrays (each served tensor copied back), and the served types."""
    out, kinds = [], []
    for cX, cy, cw, n_c, at in streaming.iter_file_chunks(
            path, "features", (), "label", None, 1000, np.dtype(np.float32), device_ok=True,
            device=device, **kw):
        kinds.append(cX.device.type if isinstance(cX, torch.Tensor) else "numpy")
        host = cX.cpu().numpy() if isinstance(cX, torch.Tensor) else np.asarray(cX)
        out.append((host.copy(), np.array(cy), n_c, at))
    return out, kinds


def _rows_of(chunks):
    """The valid rows of `_scan` chunks, each at its global row."""
    n = max(at + n_c for _, _, n_c, at in chunks)
    out = np.full((n, chunks[0][0].shape[1]), np.nan, chunks[0][0].dtype)
    for x, _, n_c, at in chunks:
        out[at:at + n_c] = x[:n_c]
    return out


def _checksums():
    """crc32 of every cached device-tier tensor."""
    sums = []
    for st in dc.get_chunk_cache()._streams.values():
        for c in st.chunks:
            for a in c.arrays():
                if a.dev is not None:
                    sums.append(zlib.crc32(a.dev.cpu().numpy().tobytes()))
    return sums


def test_device_tier_replay_equals_the_host_tier(tmp_path, cuda_device):
    path, _, _ = _file(tmp_path)
    fill, kinds = _scan(path, cuda_device)
    assert set(kinds) == {"cuda"}  # the fill hands over the mirrors
    dev_replay, kinds = _scan(path, cuda_device)
    assert set(kinds) == {"cuda"} and dc.CHUNK_METRICS["device_bytes"] > 0
    assert dc.cache_resident_bytes() == dc.CHUNK_METRICS["device_bytes"]
    # the host tier: the ledger held full, the feature blocks are pinned
    _reset()
    assert dc.get_device_cache().reserve_external("hold", int(dc.cache_budget_bytes()))
    host_fill, kinds = _scan(path, cuda_device)
    assert set(kinds) == {"cpu"} and dc.CHUNK_METRICS["pinned_bytes"] > 0
    host_replay, _ = _scan(path, cuda_device)
    for got in (dev_replay, host_fill, host_replay):
        a = sorted(got, key=lambda c: c[3])
        b = sorted(fill, key=lambda c: c[3])
        for (x1, y1, n1, o1), (x2, y2, n2, o2) in zip(a, b):
            assert (n1, o1) == (n2, o2)
            np.testing.assert_array_equal(x1, x2)
            np.testing.assert_array_equal(y1, y2)
    # the statistics of a device-tier and a host-tier replay agree bit for bit
    # over the same recorded order
    kw = dict(dtype=np.float32, chunk_rows=1000)
    h1 = streaming.linreg_streaming_stats(path, "features", (), "label", None, **kw)
    h2 = streaming.linreg_streaming_stats(path, "features", (), "label", None, **kw)
    for k in h1:
        np.testing.assert_array_equal(h1[k], h2[k])


def test_out_of_memory_demotes_and_other_errors_propagate(tmp_path, cuda_device, monkeypatch):
    path, _, _ = _file(tmp_path, n=6000)
    want, _ = _scan(path, cuda_device, cache_ok=False)

    def oom(host, device):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(dc, "_mirror", oom)
    before = dc.CHUNK_METRICS["device_oom_demotions"]
    got, kinds = _scan(path, cuda_device)
    assert set(kinds) == {"cpu"}  # served from the pinned host tier
    assert dc.CHUNK_METRICS["device_oom_demotions"] - before == len(got)
    assert dc.CHUNK_METRICS["device_bytes"] == 0 and dc.cache_resident_bytes() == 0
    for (x1, *_), (x2, *_) in zip(sorted(got, key=lambda c: c[3]),
                                  sorted(want, key=lambda c: c[3])):
        np.testing.assert_array_equal(x1, x2)
    _reset()

    def broken(host, device):
        raise RuntimeError("not an out-of-memory error")

    monkeypatch.setattr(dc, "_mirror", broken)
    with pytest.raises(RuntimeError, match="not an out-of-memory"):
        _scan(path, cuda_device)
    assert not dc.get_chunk_cache()._streams
    assert dc.cache_resident_bytes() == 0


def test_a_cpu_consumer_of_a_card_stream_gets_host_arrays(tmp_path, cuda_device):
    """A stream filled on the card and replayed by a consumer on the CPU
    (the same file and scan, another device) serves host arrays, also where
    the feature blocks live only on the card; the statistics agree."""
    path, _, _ = _file(tmp_path, n=6000)
    kw = dict(dtype=np.float32, chunk_rows=1000)
    # 60 kB holds the 7 chunks' labels (56 kB) and no feature block beside
    # them: the host copies are released, the blocks live only on the card
    for budget in (1 << 30, 60_000):
        _reset()
        port_config.set_config(chunk_cache_host_bytes=budget, fused_parquet_readers=3)
        card = streaming.linreg_streaming_stats(path, "features", (), "label", None,
                                                device=cuda_device, **kw)
        assert dc.CHUNK_METRICS["device_bytes"] > 0
        _, kinds = _scan(path, "cpu")
        assert set(kinds) == {"numpy"}
        cpu = streaming.linreg_streaming_stats(path, "features", (), "label", None,
                                               device="cpu", **kw)
        for k in card:
            np.testing.assert_allclose(cpu[k], card[k], rtol=1e-5,
                                       atol=1e-5 * np.abs(card[k]).max())


def test_consumers_leave_cached_device_chunks_unchanged(tmp_path, cuda_device):
    """The in-place audit: every cached CUDA chunk keeps its bytes through
    streamed fits (standardized LogisticRegression: the centring step;
    KMeans; the streamed statistics) and a fused randomized PCA."""
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.clustering import KMeans
    from spark_rapids_ml_torch.feature import PCA

    path, _, _ = _file(tmp_path, d=40)
    port_config.set_config(force_streaming_stats=True, host_batch_bytes=1000 * 40 * 4)
    LogisticRegression(regParam=1e-3, maxIter=5, standardization=True).fit(path)
    KMeans(k=3, seed=1, maxIter=3).fit(path)
    before = _checksums()
    assert before
    LogisticRegression(regParam=1e-3, maxIter=5, standardization=True).fit(path)
    KMeans(k=3, seed=1, maxIter=3).fit(path)
    streaming.pca_streaming_stats(path, "features", (), None, chunk_rows=1000)
    assert _checksums()[:len(before)] == before
    port_config.reset_config()
    port_config.set_config(fused_stage_solve="on", pca_solver="randomized")
    model = PCA(k=3).setInputCol("features").fit(path)
    assert [p["source"] for p in model.fit_report()["fused"]["pass_log"]] == (
        ["decode"] + ["replay"] * 3)
    sums = _checksums()
    PCA(k=3).setInputCol("features").fit(path)
    assert _checksums() == sums


def test_device_loss_keeps_the_host_and_spill_tiers(tmp_path, cuda_device):
    path, _, _ = _file(tmp_path, n=8000)
    fill, _ = _scan(path, cuda_device)
    assert dc.CHUNK_METRICS["device_bytes"] > 0
    n = dc.invalidate_for_devices([cuda_device.index])
    assert n == len(fill)
    assert dc.CHUNK_METRICS["device_bytes"] == 0 and dc.cache_resident_bytes() == 0
    got, kinds = _scan(path, cuda_device)
    hits = dc.CHUNK_METRICS["hits"]
    assert set(kinds) == {"cuda"}  # promoted again from the host tier at serve time
    for (x1, *_), (x2, *_) in zip(got, fill):
        np.testing.assert_array_equal(x1, x2)
    # a stream whose feature blocks live only on the card is dropped: one
    # scan (8 chunks of 1000 rows) and a host budget that holds their labels
    # (64 kB) but no feature block beside them
    _reset()
    port_config.set_config(chunk_cache_host_bytes=70_000, fused_parquet_readers=1)
    _scan(path, cuda_device)
    assert dc.CHUNK_METRICS["host_releases"] > 0
    (st,) = dc.get_chunk_cache()._streams.values()
    assert all(c.arrays()[0].host is None for c in st.chunks)
    replay, kinds = _scan(path, cuda_device)
    assert set(kinds) == {"cuda"} and dc.CHUNK_METRICS["hits"] == hits + 1
    dc.invalidate_for_devices([cuda_device.index])
    assert not dc.get_chunk_cache()._streams
    again, _ = _scan(path, cuda_device)  # decodes again, by one reader
    np.testing.assert_array_equal(_rows_of(again), _rows_of(fill))


def test_the_device_tier_counts_against_the_next_fit(tmp_path, cuda_device):
    """A fit whose rows fit the budget alone, but not beside the device
    tier's claim, takes the streamed route; once the cache is cleared it
    stages."""
    from spark_rapids_ml_torch.regression import LinearRegression

    path, _, _ = _file(tmp_path, n=20000, d=12)
    need = 20000 * 12 * 4
    port_config.set_config(hbm_bytes=int(1.5 * need / 0.8))
    _scan(path, cuda_device)  # the device tier takes about one copy of the rows
    assert dc.cache_resident_bytes() >= need
    est = LinearRegression()
    assert est._over_device_budget(need)
    dc.clear_chunk_cache()
    assert not est._over_device_budget(need)
