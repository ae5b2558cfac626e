#
# The port's chunk accumulators (spark_rapids_ml_torch/ops/stats.py) and
# fused stage-and-solve pass (spark_rapids_ml_torch/fused.py) against the
# JAX package's on the same numpy chunks, on the CPU: every step, weighted
# and unweighted, plain and Kahan-compensated, and `acc_to_host_f64`
# (float64, rtol 1e-12); the chunk sizing and the host chunk iterator (equal
# to JAX's); one fused pass (equal to the same statistics folded by hand);
# the metrics, the routing conf and the producer's errors.  Every JAX
# float64 call runs inside `jax.enable_x64(True)` (the flag is checked at
# module teardown).
#
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import fused as port_fused
from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.ops import precision as port_precision
from spark_rapids_ml_torch.ops import stats as port_stats
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu import fused as jax_fused
from spark_rapids_ml_tpu.ops import precision as jax_precision
from spark_rapids_ml_tpu.ops import stats as jax_stats


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
    yield
    port_config.reset_config()
    jax_config.reset_config()
    set_default_device(None)


def _chunks(seed, n_chunks=5, rows=64, d=6, l=4):
    """Chunks of rows with uneven scales and offsets, labels, weights (some
    0), and an omega (d, l)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_chunks):
        X = rng.normal(size=(rows, d)) * rng.uniform(0.5, 4.0, d) + 100.0 * (i + 1)
        y = (X @ rng.normal(size=d) + rng.normal(size=rows)).astype(np.float32)
        w = rng.uniform(0.2, 2.0, rows)
        w[::7] = 0.0
        out.append((X, y, w))
    return out, rng.normal(size=(d, l))


_KINDS = ("pca_moments", "pca_projected", "linreg")


def _jax_spec(kind, d, l):
    if kind == "pca_moments":
        return jax_stats.pca_moment_acc(d, jnp.float64), jax_stats.pca_moment_step_unw
    if kind == "pca_projected":
        return jax_stats.pca_projected_acc(d, l, jnp.float64), jax_stats.pca_projected_step_unw
    return jax_stats.linreg_acc(d, jnp.float64), jax_stats.linreg_step_unw


def _port_spec(kind, d, l):
    if kind == "pca_moments":
        return port_stats.pca_moment_acc(d, np.float64), port_stats.pca_moment_step_unw
    if kind == "pca_projected":
        return port_stats.pca_projected_acc(d, l, np.float64), port_stats.pca_projected_step_unw
    return port_stats.linreg_acc(d, np.float64), port_stats.linreg_step_unw


def _args(kind, X, y, w, omega, weighted, xp):
    conv = (lambda a: jnp.asarray(a)) if xp == "jax" else (lambda a: torch.from_numpy(np.asarray(a)))
    args = [conv(X)]
    if weighted:
        args.append(conv(w))
    if kind == "linreg":
        args.append(conv(y))
    if kind == "pca_projected":
        args.append(conv(omega))
    return args


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("level", ["highest", "high_compensated"])
def test_accumulators_match_jax(kind, weighted, level):
    """float64 features, float32 labels (the staging rule): every step and
    the host fold within 1e-12 relative of JAX's over the same chunks;
    the compensated accumulators carry their `!c` twins.  One exception:
    the unweighted step sums y and y * y in float32 in both packages (no
    float64 weight to promote them), in another order, so sy and syy of
    that step agree to float32 rounding, 1e-6."""
    chunks, omega = _chunks(seed=len(kind) + weighted)
    port_config.set_config(stats_precision=level)
    jax_config.set_config(stats_precision=level)
    d, l = omega.shape
    with jax.enable_x64(True):
        (jacc, jstep), junw = _jax_spec(kind, d, l)
        for X, y, w in chunks:
            jacc = (jstep if weighted else junw)(jacc, *_args(kind, X, y, w, omega, weighted, "jax"))
        want = jax_stats.acc_to_host_f64(jacc)
    (pacc, pstep), punw = _port_spec(kind, d, l)
    assert set(pacc) == set(jacc)
    assert any(k.endswith(port_stats.CARRY_SUFFIX) for k in pacc) == (level == "high_compensated")
    for X, y, w in chunks:
        pacc = (pstep if weighted else punw)(pacc, *_args(kind, X, y, w, omega, weighted, "port"))
    got = port_stats.acc_to_host_f64(pacc)
    assert set(got) == set(want) and not any(k.endswith("!c") for k in got)
    for k in want:
        assert got[k].dtype == np.float64
        tol = 1e-6 if (k in ("sy", "syy") and not weighted) else 1e-12
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol * np.abs(want[k]).max(),
                                   err_msg=k)


def test_kahan_add_and_host_fold_match_jax():
    """The compensated add of a small value into a large float32 sum: the
    carry holds what the sum lost, and the fold recovers it, bit for bit
    with JAX."""
    acc_p = {"s": torch.tensor([1e8], dtype=torch.float32),
             "s!c": torch.zeros(1, dtype=torch.float32)}
    acc_j = {"s": jnp.asarray([1e8], jnp.float32), "s!c": jnp.zeros(1, jnp.float32)}
    for v in (3.0, 0.25, 7.5, -1.0):
        port_stats._kahan_add(acc_p, "s", torch.tensor([v], dtype=torch.float32))
        acc_j = dict(acc_j, **jax_stats._kahan_add(acc_j, "s", jnp.asarray([v], jnp.float32)))
        np.testing.assert_array_equal(acc_p["s"].numpy(), np.asarray(acc_j["s"]))
        np.testing.assert_array_equal(acc_p["s!c"].numpy(), np.asarray(acc_j["s!c"]))
    got = port_stats.acc_to_host_f64(acc_p)
    np.testing.assert_array_equal(got["s"], jax_stats.acc_to_host_f64(acc_j)["s"])
    assert got["s"][0] == 1e8 + 9.75
    ints = port_stats.acc_to_host_f64({"n": torch.tensor([2**40 + 1], dtype=torch.int64)})
    assert ints["n"].dtype == np.int64 and ints["n"][0] == 2**40 + 1


def test_total_variance_matches_jax():
    rng = np.random.default_rng(0)
    ssq, s1 = rng.uniform(10, 20, 7), rng.normal(size=7)
    assert port_stats.total_variance(ssq, s1, 9.5) == jax_stats.total_variance(ssq, s1, 9.5)


@pytest.mark.parametrize("level", ["highest", "high", "high_compensated", "default"])
def test_stats_precision_levels(level):
    port_config.set_config(stats_precision=level)
    jax_config.set_config(stats_precision=level)
    assert port_precision.stats_precision() == level
    assert port_precision.stats_compensated() == jax_precision.stats_compensated()
    before = torch.backends.cuda.matmul.allow_tf32
    with port_precision.stats_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 == (level == "default")
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_stats_precision_rejects_unknown_level():
    port_config.set_config(stats_precision="bf16")
    with pytest.raises(ValueError, match="stats_precision"):
        port_precision.stats_precision()


# ---------------------------------------------------------------------------
# The fused pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,itemsize,budget", [
    (5000, 16, 4, None), (100, 3, 8, None), (1_000_000, 3000, 4, None),
    (1_000_000, 128, 4, None), (3, 2, 4, None), (70_000, 100, 4, 1 << 16),
])
def test_fused_chunk_rows_match_jax(n, d, itemsize, budget):
    if budget is not None:
        port_config.set_config(staging_chunk_bytes=budget)
        jax_config.set_config(staging_chunk_bytes=budget)
    assert port_fused.fused_chunk_rows(n, d, itemsize) == jax_fused.fused_chunk_rows(n, d,
                                                                                      itemsize, 1)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("labelled", [True, False])
def test_iter_host_chunks_match_jax(weighted, labelled):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(1000, 5))
    y = rng.normal(size=1000) if labelled else None
    w = rng.uniform(size=1000) if weighted else None
    a = list(port_fused.iter_host_chunks(X, y, w, 300, np.float32, label_dtype=np.float32))
    b = list(jax_fused.iter_host_chunks(X, y, w, 300, np.float32, label_dtype=np.float32))
    assert len(a) == len(b) == 4
    for ca, cb in zip(a, b):
        for pa, pb in zip(ca, cb):
            assert (pa is None) == (pb is None)
            if pa is not None:
                assert pa.dtype == pb.dtype
                np.testing.assert_array_equal(pa, pb)
    assert a[-1][2][100:].sum() == 0.0  # the padded tail has weight 0


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_fused_pass_equals_the_steps_folded_by_hand(kind, depth):
    """`accumulate_chunks` over `iter_host_chunks` gives the statistics of
    the same steps applied by hand, bit for bit, with the producer thread
    at every depth; the metrics count the chunks and bytes."""
    port_config.set_config(staging_pipeline_depth=depth)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(700, 5)) + 3.0
    y = rng.normal(size=700)
    w = rng.uniform(0.5, 1.5, 700) if kind == "linreg" else None
    omega = rng.normal(size=(5, 3))
    acc, step = port_fused._steps(kind, 5, 3, np.dtype(np.float64), "cpu")
    extra = (omega,) if kind == "pca_projected" else ()
    chunks = port_fused.iter_host_chunks(X, y if kind == "linreg" else None, w, 200, np.float64,
                                         label_dtype=np.float32)
    host, m = port_fused.accumulate_chunks(acc, step, chunks, "cpu", has_y=kind == "linreg",
                                           extra_args=extra)
    acc2, (sw_, su_) = port_fused._steps(kind, 5, 3, np.dtype(np.float64), "cpu")
    for cX, cy, cw in port_fused.iter_host_chunks(X, y if kind == "linreg" else None, w, 200,
                                                  np.float64, label_dtype=np.float32):
        args = [torch.from_numpy(cX)] + ([torch.from_numpy(cw)] if cw is not None else [])
        if kind == "linreg":
            args.append(torch.from_numpy(cy))
        args += [torch.from_numpy(o) for o in extra]
        acc2 = (sw_ if cw is not None else su_)(acc2, *args)
    want = port_stats.acc_to_host_f64(acc2)
    for k in want:
        np.testing.assert_array_equal(host[k], want[k])
    assert m["chunks"] == 4 and m["bytes"] > 0
    assert m["wall_s"] >= m["host_prep_s"] >= 0.0 and m["device_acc_s"] >= 0.0
    assert 0.0 <= m["overlap_s"] <= m["wall_s"]


def test_fused_pass_raises_a_producer_error():
    def bad():
        yield np.zeros((4, 2)), None, None
        raise RuntimeError("chunk prep failed")

    acc, step = port_fused._steps("pca_moments", 2, 0, np.dtype(np.float64), "cpu")
    port_config.set_config(staging_pipeline_depth=3)
    with pytest.raises(RuntimeError, match="chunk prep failed"):
        port_fused.accumulate_chunks(acc, step, bad(), "cpu")


@pytest.mark.parametrize("mode,nbytes,want", [
    ("auto", 64 * 2**20 - 1, False), ("auto", 64 * 2**20, True), ("on", 1, True),
    ("off", 2**40, False), ("ON", 1, True),
])
def test_fused_routing_matches_jax(mode, nbytes, want):
    port_config.set_config(fused_stage_solve=mode)
    jax_config.set_config(fused_stage_solve=mode)
    assert port_fused.fused_enabled(nbytes) == jax_fused.fused_enabled(nbytes) == want
    assert port_fused._AUTO_MIN_BYTES == jax_fused._AUTO_MIN_BYTES
    assert (port_fused._MIN_CHUNKS, port_fused._MIN_CHUNK_ROWS) == (jax_fused._MIN_CHUNKS,
                                                                    jax_fused._MIN_CHUNK_ROWS)


def test_fused_mode_rejects_unknown_value():
    port_config.set_config(fused_stage_solve="sometimes")
    with pytest.raises(ValueError, match="fused_stage_solve"):
        port_fused.fused_enabled(1)


@pytest.mark.parametrize("solver", ["full", "randomized"])
def test_fused_pca_stats_match_jax(solver):
    """The fused PCA statistics (one moments pass, or the range-finder's
    passes with the same Omega) against JAX's fused engine on the same
    chunks: float64, rtol 1e-10; the metrics name the kind and passes."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(3000, 12)) * np.geomspace(8.0, 0.05, 12) + 1.0
    for cfg in (port_config, jax_config):
        cfg.set_config(pca_solver=solver, pca_oversamples=3)

    def producer(n_dev, mod):
        return mod.iter_host_chunks(X, None, None, mod.fused_chunk_rows(3000, 12, 8, n_dev),
                                    np.float64)

    got = port_fused.fused_pca_stats(lambda n: producer(n, port_fused), 12, 2, np.float64, "cpu")
    with jax.enable_x64(True):
        want = jax_fused.fused_pca_stats(lambda n: producer(n, jax_fused), 12, 2, np.float64)
    assert got["kind"] == want["kind"]
    for k in want:
        if k != "kind":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-10,
                                       atol=1e-10 * np.abs(want[k]).max(), err_msg=k)
    m = port_fused.FUSED_METRICS
    assert m["solver"] == solver and m["passes"] == (1 if solver == "full" else 4)
    assert m["kind"] == ("pca_moments" if solver == "full" else "pca_projected")
    assert m["chunks"] == 3 * m["passes"]  # 1024-row chunks (_MIN_CHUNK_ROWS)
