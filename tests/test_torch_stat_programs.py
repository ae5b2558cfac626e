#
# The port's statistic programs, engine and summarizer
# (spark_rapids_ml_torch/stats/) against the JAX package's, on the CPU: each
# of the twelve programs on the same chunks, `run_programs`, `summarize` and
# `describe` over numpy batches, `(X, y)` tuples, pandas frames and parquet
# files (the second call a chunk-cache replay), the HyperLogLog registers
# bit for bit, the sketches' wire format, `merge_accs` and
# `iter_chunk_accs`.  Tolerances: float32 statistics 1e-5 relative (sums in
# another order), float64 1e-10; counts, registers, sketch states (in-order
# sources) and slot programs exact.  The JAX package runs with its own chunk
# cache off.
#
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import stats as port_stats
from spark_rapids_ml_torch.parallel import device_cache as dc
from spark_rapids_ml_torch.stats import programs as port_programs
from spark_rapids_ml_torch.stats import sketches as port_sketches
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu import stats as jax_stats
from spark_rapids_ml_tpu.stats import programs as jax_programs
from spark_rapids_ml_tpu.stats import sketches as jax_sketches


@pytest.fixture(scope="module", autouse=True)
def _x64_flag_unchanged():
    before = jax.config.jax_enable_x64
    yield
    assert jax.config.jax_enable_x64 == before


@pytest.fixture(autouse=True)
def _cpu_and_clean():
    set_default_device("cpu")
    port_config.reset_config()
    jax_config.reset_config()
    jax_config.set_config(chunk_cache="off")
    dc.clear_chunk_cache()
    yield
    dc.clear_chunk_cache()
    port_config.reset_config()
    jax_config.reset_config()
    set_default_device(None)


def _data(seed=0, n=3000, d=5):
    """Columns of several kinds: normal, integer-coded (for chi2 and the
    frequent items), with zeros, and a constant; binary labels; weights in
    [0, 2] with some 0.  No -0.0 (see `test_hll_negative_zero`)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d)
    X[:, 1] = rng.integers(0, 6, n)
    X[:, 2] = np.where(rng.random(n) < 0.3, 0.0, X[:, 2])
    X[:, 3] = 2.5
    X[X == 0] = 0.0  # +0.0 only
    y = (X[:, 0] + rng.normal(size=n) > 0).astype(np.float64)
    w = rng.choice([0.0, 0.5, 1.0, 1.5, 2.0], size=n)
    return X, y, w


def _frame(X, y, w):
    return pd.DataFrame({"features": list(X), "label": y, "wt": w})


def _assert_close(got, want, rtol, path=""):
    """Equal structure; integer arrays and scalars exact, floats within
    rtol of the largest magnitude of the field."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], rtol, f"{path}.{k}")
        return
    if isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_close(a, b, rtol, f"{path}[{i}]")
        return
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_close(a, b, rtol, path)
        return
    a, b = np.asarray(got), np.asarray(want)
    assert a.shape == b.shape, path
    if b.dtype.kind in "iub" and a.dtype.kind in "iub":
        np.testing.assert_array_equal(a, b, err_msg=path)
        return
    scale = float(np.nanmax(np.abs(b))) if b.size and np.isfinite(b).any() else 1.0
    np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=rtol,
                               atol=rtol * max(scale, 1e-30), equal_nan=True, err_msg=path)


def _jax_call(dtype, fn):
    if np.dtype(dtype) == np.float64:
        with jax.enable_x64(True):
            return fn()
    return fn()


_ENGINE_PROGRAMS = ["moments", "standardization", "covariance", "pca_moments", "linreg",
                    "ttest", "chi2", "distinct_count", "quantile_sketch", "frequent_items"]


@pytest.mark.parametrize("name", _ENGINE_PROGRAMS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_program_through_the_engine_matches_jax(name, dtype):
    """Each program the engine runs, on a weighted pandas frame: the
    finalized statistics equal the JAX package's (float32 1e-5, float64
    1e-10; counts, HyperLogLog estimates and the sketches exactly)."""
    X, y, w = _data(1)
    df = _frame(X, y, w)
    kw = dict(label_col="label", weight_col="wt", dtype=dtype)
    got = port_stats.run_program(name, df, **kw)
    want = _jax_call(dtype, lambda: jax_stats.run_program(name, df, **kw))
    rtol = 1e-5 if dtype == np.float32 else 1e-10
    if name == "covariance":
        # the correlation of the constant column is NaN in both
        assert np.isnan(got["correlation"][3, 0]) and np.isnan(want["correlation"][3, 0])
    _assert_close(got, want, rtol)
    assert port_stats.STAT_METRICS["programs"] == 1


@pytest.mark.parametrize("name", ["pca_projected", "kmeans_sample"])
def test_program_steps_match_jax(name):
    """The two programs the engine does not dispatch on its own: the
    range-finder's projected moments (an extra omega argument) and the
    k-means seeding sample (slot-disjoint, out-of-order chunks), folded
    step by step on the same chunks."""
    X, y, w = _data(2, n=2000, d=6)
    X32, w32 = X.astype(np.float32), w.astype(np.float32)
    p, j = port_programs.get_program(name), jax_programs.get_program(name)
    if name == "pca_projected":
        opts = {"l": 4}
        omega = np.random.default_rng(3).normal(size=(6, 4)).astype(np.float32)
        acc = p.init(6, np.float32, port_programs.resolve_opts(p, opts))
        step, _ = p.make_step(6, np.float32, port_programs.resolve_opts(p, opts))
        jacc = j.init(6, np.float32, jax_programs.resolve_opts(j, opts))
        jstep, _ = j.make_step(6, np.float32, jax_programs.resolve_opts(j, opts))
        for lo in range(0, 2000, 500):
            acc = step(acc, torch.from_numpy(X32[lo:lo + 500]),
                       torch.from_numpy(w32[lo:lo + 500]), torch.from_numpy(omega))
            jacc = jstep(jacc, jnp.asarray(X32[lo:lo + 500]), jnp.asarray(w32[lo:lo + 500]),
                         jnp.asarray(omega))
        got = {k: v.numpy() for k, v in acc.items()}
        _assert_close(got, {k: np.asarray(v) for k, v in jacc.items()}, 1e-5)
        return
    opts = {"stride": 7, "cap": -(-2000 // 7)}
    chunks = [(X[lo:lo + 300], None, w[lo:lo + 300], min(300, 2000 - lo), lo)
              for lo in range(0, 2000, 300)]
    order = [3, 0, 6, 2, 5, 1, 4]  # the range readers' chunks arrive in any order
    got = port_stats.iter_chunk_accs(name, [chunks[i] for i in order], 6, np.float64, opts)
    want = jax_stats.iter_chunk_accs(name, [c[:4] for c in chunks], 6, np.float64, opts)
    _assert_close(got, want, 0.0)
    fin = p.finalize(got, {})
    np.testing.assert_array_equal(fin["X"], X[::7])
    np.testing.assert_array_equal(fin["w"], w[::7])


@pytest.mark.parametrize("bits", [4, 8, 12])
def test_hll_registers_match_jax_bit_for_bit(bits):
    """The registers of the `distinct_count` step (int64 arithmetic masked
    to 32 bits, leading zeros by a bit search) equal the JAX package's step
    and its numpy twin bit for bit, over float32 and float64 values with
    padding rows of weight 0."""
    rng = np.random.default_rng(bits)
    X = np.concatenate([rng.normal(size=(700, 3)), np.round(rng.normal(size=(700, 3)) * 5),
                        rng.integers(-2**30, 2**30, size=(700, 3)) * 1.0])
    X[X == 0] = 0.0
    w = np.where(rng.random(2100) < 0.1, 0.0, 1.0)
    opts = {"bits": bits}
    p, j = port_programs.get_program("distinct_count"), jax_programs.get_program("distinct_count")
    for dt in (np.float32, np.float64):
        acc = p.init(3, dt, port_programs.resolve_opts(p, opts))
        step, _ = p.make_step(3, dt, port_programs.resolve_opts(p, opts))
        acc = step(acc, torch.from_numpy(X.astype(dt)), torch.from_numpy(w.astype(dt)))
        jacc = j.init(3, np.float32, jax_programs.resolve_opts(j, opts))
        jstep, _ = j.make_step(3, np.float32, jax_programs.resolve_opts(j, opts))
        jacc = jstep(jacc, jnp.asarray(X.astype(np.float32)), jnp.asarray(w.astype(np.float32)))
        np.testing.assert_array_equal(acc["regs"].numpy(), np.asarray(jacc["regs"]))
        twin = jax_sketches.hll_init(3, bits)
        jax_sketches.hll_update(twin, X.astype(dt), w > 0, bits)
        np.testing.assert_array_equal(acc["regs"].numpy(), twin["regs"])
        np.testing.assert_array_equal(port_sketches.hll_estimate(acc["regs"].numpy()),
                                      jax_sketches.hll_estimate(twin["regs"]))


def test_hll_negative_zero():
    """-0.0 and +0.0 are one value: the port's step canonicalizes -0.0 as
    the JAX package's step does op by op and as its numpy twin does.  Under
    the JAX package's engine (a jitted step) XLA folds `X + 0.0` away, so
    its `summarize` counts -0.0 as a value of its own; the port does not
    (ROADMAP.md section 3)."""
    X = np.array([[0.0], [-0.0], [1.0], [-1.0]] * 50)
    w = np.ones(200)
    p = port_programs.get_program("distinct_count")
    opts = port_programs.resolve_opts(p, None)
    acc = p.init(1, np.float64, opts)
    acc = p.make_step(1, np.float64, opts)[0](acc, torch.from_numpy(X), torch.from_numpy(w))
    twin = jax_sketches.hll_init(1, opts["bits"])
    jax_sketches.hll_update(twin, X, w > 0, opts["bits"])
    np.testing.assert_array_equal(acc["regs"].numpy(), twin["regs"])
    assert int((acc["regs"].numpy() > 0).sum()) == 3
    got = port_stats.summarize(X, metrics=["distinctCount"])["distinctCount"]
    np.testing.assert_allclose(got, jax_sketches.hll_estimate(twin["regs"]))
    assert round(float(got[0])) == 3
    assert round(float(jax_stats.summarize(X, metrics=["distinctCount"])["distinctCount"][0])) == 4


_METRIC_SETS = {
    "bench": ["count", "mean", "variance", "min", "max", "normL2", "quantiles", "distinctCount"],
    "moments": ["count", "weightSum", "sum", "std", "normL1", "numNonZeros"],
    "tests": ["ttest", "chi2", "covariance", "correlation", "standardization"],
    "sketches": ["median", "frequentItems", "quantiles"],
}


@pytest.mark.parametrize("metrics", sorted(_METRIC_SETS))
@pytest.mark.parametrize("source", ["numpy", "tuple", "pandas", "parquet"])
def test_summarize_matches_jax(tmp_path, metrics, source):
    """`summarize` over each source kind equals the JAX package's (float32
    1e-5; counts and sketches exactly: in-order chunks); a parquet path is
    read by one reader, and its second call replays the cached stream with
    the same result bit for bit."""
    X, y, w = _data(4)
    names = _METRIC_SETS[metrics]
    kw = {}
    if source == "numpy":
        data = X
        names = [m for m in names if m not in ("ttest", "chi2")]
    elif source == "tuple":
        data = (X, y)
    elif source == "pandas":
        data = _frame(X, y, w)
        kw = dict(label_col="label", weight_col="wt")
    else:
        data = str(tmp_path / "s.parquet")
        pq.write_table(pa.table({
            "features": pa.FixedSizeListArray.from_arrays(pa.array(X.reshape(-1)), 5),
            "label": pa.array(y), "wt": pa.array(w)}), data, row_group_size=700)
        port_config.set_config(fused_parquet_readers=1)
        jax_config.set_config(fused_parquet_readers=1)
        kw = dict(label_col="label", weight_col="wt")
    got = port_stats.summarize(data, metrics=names, quantiles=(0.1, 0.5, 0.9), **kw)
    want = jax_stats.summarize(data, metrics=names, quantiles=(0.1, 0.5, 0.9), **kw)
    _assert_close(got, want, 1e-5)
    if source == "parquet":
        hits = dc.CHUNK_METRICS["hits"]
        again = port_stats.summarize(data, metrics=names, quantiles=(0.1, 0.5, 0.9), **kw)
        assert dc.CHUNK_METRICS["hits"] == hits + 1
        assert port_stats.STAT_METRICS["source"] == "replay"
        _assert_close(again, got, 0.0)


def test_summarize_from_the_range_readers(tmp_path):
    """Three range readers deliver chunks in any order: the moments stay
    within 1e-5 of the JAX package's in-order pass, the quantiles within the
    sketch's rank error of the exact ones, and two replays agree bit for
    bit."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(20000, 3)).astype(np.float32)
    path = str(tmp_path / "r.parquet")
    pq.write_table(pa.table({"features": pa.FixedSizeListArray.from_arrays(
        pa.array(X.reshape(-1)), 3)}), path, row_group_size=1000)
    port_config.set_config(fused_parquet_readers=3, host_batch_bytes=12 * 1024)
    jax_config.set_config(host_batch_bytes=12 * 1024)
    names = ["count", "mean", "variance", "min", "max", "quantiles"]
    qs = (0.1, 0.5, 0.9)
    runs = [port_stats.summarize(path, metrics=names, quantiles=qs) for _ in range(3)]
    want = jax_stats.summarize(path, metrics=names, quantiles=qs)
    for got in runs:
        _assert_close({k: got[k] for k in names[:5]}, {k: want[k] for k in names[:5]}, 1e-5)
        for q in qs:
            # rank error of the sketch at k = 256 over 20,000 rows: well
            # under 2% (the JAX package's tests/test_stat_programs.py bound)
            ranks = (X <= got["quantiles"][q][None, :]).mean(axis=0)
            assert np.all(np.abs(ranks - q) < 0.02), (q, ranks)
    _assert_close(runs[2], runs[1], 0.0)


def test_describe_matches_jax():
    X, _, _ = _data(6)
    got = port_stats.describe(X)
    want = jax_stats.describe(X)
    assert list(got.index) == list(want.index) and list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=1e-5, atol=1e-6)
    s = port_stats.Summarizer.metrics("mean", "max").summary(X)
    np.testing.assert_allclose(s["mean"], X.astype(np.float32).mean(axis=0, dtype=np.float64),
                               rtol=1e-5, atol=1e-6)
    assert sorted(port_stats.SUPPORTED_METRICS) == sorted(jax_stats.SUPPORTED_METRICS)


def test_merge_accs_matches_jax():
    """A batch split in four, each part folded and the parts merged, gives
    the one-pass sketches (the JAX package's merges, the same states) and
    the summed device accumulators."""
    X, _, w = _data(7, n=2048)
    parts = np.array_split(np.arange(2048), 4)
    for name in ("quantile_sketch", "frequent_items"):
        p, j = port_programs.get_program(name), jax_programs.get_program(name)
        opts = port_programs.resolve_opts(p, None)
        step = p.make_step(5, np.float64, opts)
        states = [step(p.init(5, np.float64, opts), X[ix], w[ix], None, {}) for ix in parts]
        merged = states[0]
        for st in states[1:]:
            merged = port_programs.merge_accs(p, merged, st)
        jstates = [j.make_step(5, np.float64, opts)(j.init(5, np.float64, opts), X[ix], w[ix],
                                                    None, {}) for ix in parts]
        jmerged = jstates[0]
        for st in jstates[1:]:
            jmerged = jax_programs.merge_accs(j, jmerged, st)
        _assert_close(merged, jmerged, 0.0)
    p = port_programs.get_program("moments")
    a = {"s1": np.ones(3), "min": np.zeros(3), "max": np.ones(3), "sw": 2.0, "n": 1,
         "s2": np.ones(3), "l1": np.ones(3), "nnz": np.ones(3, np.int64)}
    m = port_programs.merge_accs(p, a, dict(a, min=-np.ones(3), max=2 * np.ones(3)))
    np.testing.assert_array_equal(m["min"], -np.ones(3))
    np.testing.assert_array_equal(m["max"], 2 * np.ones(3))
    np.testing.assert_array_equal(m["s1"], 2 * np.ones(3))


def test_sketch_wire_format_is_the_jax_packages():
    """A sketch serialized by either package loads in the other as the same
    arrays; another version is refused."""
    X, _, w = _data(8)
    p = port_programs.get_program("quantile_sketch")
    opts = port_programs.resolve_opts(p, None)
    st = p.make_step(5, np.float64, opts)(p.init(5, np.float64, opts), X, w, None, {})
    for dump, load in ((port_sketches.sketch_to_bytes, jax_sketches.sketch_from_bytes),
                       (jax_sketches.sketch_to_bytes, port_sketches.sketch_from_bytes)):
        kind, back = load(dump("quantile", st))
        assert kind == "quantile"
        _assert_close(back, st, 0.0)
    blob = bytearray(port_sketches.sketch_to_bytes("hll", {"regs": np.zeros((2, 16), np.int32)}))
    blob[4] = 9
    with pytest.raises(ValueError, match="version"):
        port_sketches.sketch_from_bytes(bytes(blob))


def test_registry_and_engine_errors():
    X, y, _ = _data(9, n=100)
    with pytest.raises(KeyError, match="unknown statistic program"):
        port_programs.get_program("nope")
    with pytest.raises(ValueError, match="already registered"):
        port_programs.register_program(port_programs.get_program("moments"))
    with pytest.raises(ValueError, match="extra step arguments"):
        port_stats.run_program("pca_projected", X)
    with pytest.raises(ValueError, match="need a label column"):
        port_stats.run_program("ttest", X)
    with pytest.raises(ValueError, match="unknown summarizer metrics"):
        port_stats.summarize(X, metrics=["mean", "kurtosis"])
    with pytest.raises(ValueError, match="no statistic programs"):
        port_stats.run_programs([], X)
    assert sorted(port_programs.STAT_PROGRAMS) == sorted(jax_programs.STAT_PROGRAMS)
    for name in port_programs.STAT_PROGRAMS:
        p, j = port_programs.get_program(name), jax_programs.get_program(name)
        assert (p.kind, p.needs_y, p.extra_args) == (j.kind, j.needs_y, j.extra_args)
        opts = port_programs.resolve_opts(p, None)
        assert p.shapes(7, opts) == j.shapes(7, jax_programs.resolve_opts(j, None))


def test_compensated_precision_keeps_carries():
    """Under stats_precision="high_compensated" the moment sums carry Kahan
    twins, folded away in the result, which stays within 1e-5 of the plain
    float32 pass and of float64."""
    X, _, w = _data(10, n=5000)
    plain = port_stats.run_program("moments", X, dtype=np.float32)
    port_config.set_config(stats_precision="high_compensated")
    p = port_programs.get_program("moments")
    acc = p.init(5, np.float32, port_programs.resolve_opts(p, None))
    assert "s1" + port_programs.CARRY_SUFFIX in acc
    comp = port_stats.run_program("moments", X, dtype=np.float32)
    exact = X.astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(comp["mean"], exact.mean(axis=0), rtol=1e-6, atol=1e-7)
    _assert_close(comp, plain, 1e-5)
