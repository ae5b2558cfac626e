#
# The port's DBSCAN (spark_rapids_ml_torch/ops/dbscan.py,
# models/clustering.py) against the JAX package's on the same numpy
# inputs, on the CPU: labels after renumbering for euclidean and cosine,
# float32 and float64, with the default byte cap and with a cap that forces
# 8-column tiles; a chain that needs several sweeps; rows of weight 0;
# scikit-learn as a third reference (it is absent on the card); the
# deferred fit, save/load both ways, and what raises.
#
# The inputs never put a pair of rows near eps, where the two packages'
# distance roundings could legitimately differ: the euclidean blobs sit on
# a grid of 1/8, so every squared distance is exact in float32 and float64
# (a multiple of 1/64 at least 1e-3 away from eps^2), and the cosine eps is
# chosen 1e-5 or more away from every squared distance of the unit rows.
#
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.clustering import DBSCAN, DBSCANModel
from spark_rapids_ml_torch.models.clustering import renumber
from spark_rapids_ml_torch.ops import dbscan as port_db
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.clustering import DBSCAN as JaxDBSCAN
from spark_rapids_ml_tpu.clustering import DBSCANModel as JaxDBSCANModel


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


def _blobs(seed=0, centres=6, per=70, d=4, noise=30):
    """Gaussian blobs (std 0.6) with centres uniform in (-6, 6)^d and
    `noise` rows uniform in (-8, 8)^d, every coordinate rounded to 1/8,
    rows shuffled."""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(-6.0, 6.0, (centres, d))
    X = np.concatenate([c + 0.6 * rng.normal(size=(per, d)) for c in cent]
                       + [rng.uniform(-8.0, 8.0, (noise, d))])
    X = np.round(X * 8.0) / 8.0
    return X[rng.permutation(len(X))]


def _eps(X, metric):
    """eps for `metric` with no pair of rows near it (module comment):
    euclidean 1.2, checked; cosine, the value in [0.003, 0.005] farthest
    from every pair's squared distance of the unit rows, at least 1e-5."""
    if metric == "euclidean":
        d = np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))
        assert np.abs(d - 1.2).min() > 1e-6
        return 1.2
    U = X / np.linalg.norm(X, axis=1, keepdims=True)
    d2 = np.sort(((U[:, None] - U[None]) ** 2).sum(-1).ravel())
    grid = np.linspace(0.003, 0.005, 401)
    pos = np.clip(np.searchsorted(d2, 2.0 * grid), 1, len(d2) - 1)
    margin = np.minimum(np.abs(d2[pos] - 2.0 * grid), np.abs(d2[pos - 1] - 2.0 * grid))
    assert margin.max() > 1e-5
    return float(grid[np.argmax(margin)])


def _labels(model, X):
    return np.asarray(model.transform(pd.DataFrame({"features": list(X)}))["prediction"])


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("cap_mb", [None, 0.001])
def test_labels_match_jax(metric, dtype, cap_mb):
    X = _blobs(seed=1).astype(dtype)
    f32 = dtype == np.float32
    kw = dict(eps=_eps(X.astype(np.float64), metric), min_samples=5, metric=metric,
              float32_inputs=f32)
    if cap_mb:
        kw["max_mbytes_per_batch"] = cap_mb
    mine = _labels(DBSCAN(**kw).fit(X), X)
    n = len(X)
    budget = int(cap_mb * 1024 * 1024) if cap_mb else port_db._ADJ_BUDGET
    assert port_db.LAST_RUN["block"] == port_db.tile_width(n, budget)
    assert port_db.LAST_RUN["tiles_per_pass"] == (-(-n // 8) if cap_mb else 1)
    with jax.enable_x64(not f32):
        ref = _labels(JaxDBSCAN(**kw).fit(X), X)
    assert mine.dtype == np.int64
    np.testing.assert_array_equal(mine, ref)
    assert 3 <= mine.max() + 1 and (mine == -1).sum() > 0  # clusters and noise both occur


def _chain(length):
    """Rows on a line 1 apart, shuffled, and one far row."""
    X = np.stack([np.arange(float(length)), np.zeros(length)], axis=1)
    return np.concatenate([X, [[1000.0, 0.0]]])[np.random.default_rng(2).permutation(length + 1)]


def test_chain_needs_several_sweeps():
    """A chain of 60 rows (eps 1.5): one cluster, reached only by
    propagation along the chain with the pointer jump, in more than two
    sweeps; the same labels as the JAX package."""
    X = _chain(60)
    mine = _labels(DBSCAN(eps=1.5, min_samples=2, float32_inputs=False).fit(X), X)
    assert 2 < port_db.LAST_RUN["sweeps"] < 64
    with jax.enable_x64(True):
        ref = _labels(JaxDBSCAN(eps=1.5, min_samples=2, float32_inputs=False).fit(X), X)
    np.testing.assert_array_equal(mine, ref)
    assert set(mine.tolist()) == {0, -1} and (mine == -1).sum() == 1


def test_max_sweeps_caps_the_sweeps():
    """`max_sweeps` ends the loop: a chain of 300 rows has not converged
    after 64 sweeps (nor in the JAX package, whose cap is the same), so it
    stays cut into segments; each label still covers a run of the line."""
    X = _chain(300)
    labels, core = port_db.dbscan_fit_predict(torch.from_numpy(X),
                                              torch.ones(len(X), dtype=torch.float64), 1.5, 2)
    assert port_db.LAST_RUN["sweeps"] == 64 and core.sum() == 300
    lab = renumber(labels.numpy())
    assert lab.max() >= 1
    order = np.argsort(X[:, 0])[:300]
    runs = np.flatnonzero(np.diff(lab[order])) + 1
    assert len(runs) == lab.max()  # every cluster is one contiguous run
    port_db.dbscan_fit_predict(torch.from_numpy(X), torch.ones(len(X), dtype=torch.float64),
                               1.5, 2, max_sweeps=3)
    assert port_db.LAST_RUN["sweeps"] == 3


def test_rows_of_weight_zero_are_absent():
    """`dbscan_fit_predict` with rows of weight 0: they are noise and count
    in no degree, so the other rows' labels equal those of the rows alone
    (as row-index representatives, before renumbering)."""
    X = _blobs(seed=3)
    junk = X[:40] + 0.125  # next to real rows: would raise their degrees
    Xp = np.concatenate([X, junk])
    valid = np.concatenate([np.ones(len(X)), np.zeros(len(junk))])
    got, core = port_db.dbscan_fit_predict(torch.from_numpy(Xp), torch.from_numpy(valid),
                                           1.2, 5)
    want, core_alone = port_db.dbscan_fit_predict(torch.from_numpy(X),
                                                  torch.ones(len(X), dtype=torch.float64),
                                                  1.2, 5)
    assert (got[len(X):] == -1).all() and not core[len(X):].any()
    np.testing.assert_array_equal(got[:len(X)].numpy(), want.numpy())
    np.testing.assert_array_equal(core[:len(X)].numpy(), core_alone.numpy())


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_core_partition_and_noise_match_sklearn(metric):
    """scikit-learn as a third reference: the same noise rows, and the same
    partition of the core rows (a border row may join any cluster that
    reaches it; min-label and scikit-learn's expansion order differ)."""
    from sklearn.cluster import DBSCAN as SkDBSCAN

    X = _blobs(seed=4)
    eps = _eps(X, metric)
    mine = _labels(DBSCAN(eps=eps, min_samples=5, metric=metric,
                          float32_inputs=False).fit(X), X)
    sk = SkDBSCAN(eps=eps, min_samples=5, metric=metric).fit(X)
    np.testing.assert_array_equal(mine == -1, sk.labels_ == -1)
    core = sk.core_sample_indices_
    np.testing.assert_array_equal(renumber(mine[core]), renumber(sk.labels_[core]))


def test_renumber_by_first_occurrence():
    labels = np.array([7, -1, 3, 7, 0, 3, -1, 0], np.int32)
    np.testing.assert_array_equal(renumber(labels), [0, -1, 1, 0, 2, 1, -1, 2])
    np.testing.assert_array_equal(renumber(np.full(3, -1, np.int32)), [-1, -1, -1])


def test_fit_is_deferred_and_params_carry():
    X = _blobs(seed=5)
    est = DBSCAN(eps=1.2, min_samples=4, max_mbytes_per_batch=1).setPredictionCol("c")
    model = est.fit(X)
    assert isinstance(model, DBSCANModel) and model.n_cols == 0
    assert model.getEps() == 1.2 and model.getMinSamples() == 4 and model.getMetric() == "euclidean"
    assert model.tpu_params == est.tpu_params == JaxDBSCAN(
        eps=1.2, min_samples=4, max_mbytes_per_batch=1).tpu_params
    out = model.transform(pd.DataFrame({"features": list(X), "id": np.arange(len(X))}))
    assert list(out.columns) == ["features", "id", "c"]
    empty = model.transform(pd.DataFrame({"features": []}))
    assert list(empty.columns) == ["features", "c"] and len(empty) == 0
    np.testing.assert_array_equal(model.transform(X), out["c"])


def test_params_and_defaults_match_jax():
    a, b = DBSCAN(), JaxDBSCAN()
    assert [p.name for p in a.params] == [p.name for p in b.params]
    for p in a.params:
        assert a.hasDefault(p.name) == b.hasDefault(p.name)
        if a.hasDefault(p.name):
            assert a.getOrDefault(p.name) == b.getOrDefault(p.name), p.name
    assert a.tpu_params == b.tpu_params


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_cross_load(tmp_path, saver):
    X = _blobs(seed=6)
    kw = dict(eps=1.2, min_samples=5, max_mbytes_per_batch=0.01)
    ref = JaxDBSCAN(**kw).setPredictionCol("p").fit(X)
    mine = DBSCAN(**kw).setPredictionCol("p").fit(X)
    path = str(tmp_path / "model")
    if saver == "jax":
        ref.save(path)
        loaded, want = DBSCANModel.load(path), ref
    else:
        mine.save(path)
        loaded, want = JaxDBSCANModel.load(path), mine
    assert loaded.tpu_params == want.tpu_params and loaded.getOrDefault("predictionCol") == "p"
    np.testing.assert_array_equal(loaded.transform(X), want.transform(X))


def test_what_raises():
    with pytest.raises(ValueError, match="euclidean or cosine"):
        DBSCAN(metric="manhattan").fit(np.zeros((3, 2)))
    with pytest.raises(ValueError, match="Unsupported"):
        DBSCAN(not_a_param=1)
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        DBSCAN().fit(np.zeros((3, 2))).cpu()
