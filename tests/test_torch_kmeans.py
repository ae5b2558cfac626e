#
# The port's KMeans (spark_rapids_ml_torch/ops/kmeans.py,
# models/clustering.py) against the JAX package's on the same numpy inputs,
# on the CPU: Lloyd from identical centres (the JAX package's own seeding,
# handed in through `init_centers=`) in both branches of the gate, the
# port's own seeding for each of the three inits, weights, zero-weight
# rows, tol = 0, k equal to the number of rows, the gate and the shared
# cost model, the estimator from numpy, pandas, CSR and a DeviceDataset,
# transform/predict/summary, save/load in both directions, convert.py,
# and what raises.  float32 comparisons run on separable blobs (near ties
# flip under another summation order); every JAX float64 call runs inside
# `jax.enable_x64(True)` (the flag is checked at module teardown).
#
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_torch import DeviceDataset, set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.clustering import KMeans, KMeansModel
from spark_rapids_ml_torch.convert import (
    kmeans_model_from_reference,
    kmeans_model_to_reference_attributes,
    model_params,
)
from spark_rapids_ml_torch.ops import kmeans as port_km
from spark_rapids_ml_tpu import DeviceDataset as JaxDeviceDataset
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.clustering import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu.core import _ReadWriteMixin as JaxReadWrite
from spark_rapids_ml_tpu.ops import kmeans as jax_km

_INITS = ["scalable-k-means++", "k-means++", "random"]
_TOL = {np.float64: 1e-10, np.float32: 1e-5}


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


def _blobs(seed=0, k=5, per=200, d=6, spread=10.0):
    """k gaussian blobs (unit std) with centres uniform in (-spread,
    spread)^d, rows shuffled, and weights in [0.2, 2).  spread=10 gives
    separable blobs, spread=3 overlapping ones.  (Far from the origin the
    float32 matmul identity cancels digits: at spread=40 JAX's float32 cost,
    summed in float32, is 1.1e-5 off the float64 recomputation, the port's
    7e-7.)"""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(-spread, spread, (k, d))
    X = np.concatenate([c + rng.normal(size=(per, d)) for c in cent])
    X = X[rng.permutation(len(X))]
    return X, rng.uniform(0.2, 2.0, len(X))


def _jax_seed(X, w, k, seed, init, stride=1):
    """The JAX package's own seeding, with the arguments `kmeans_fit`
    (stride 1) or `kmeans_fit_stepwise` passes it, as numpy."""
    Xj, wj = jnp.asarray(X[::stride]), jnp.asarray(w[::stride])
    if init == "scalable-k-means++":
        rounds, m, _ = jax_km.init_flops_accounting(init, k, X.shape[1], 2, 2.0)
        out = jax_km.kmeans_parallel_init(Xj, wj, k, seed, rounds=rounds,
                                          m=min(m, int(Xj.shape[0])))
    else:
        out = jax_km.kmeans_init(Xj, wj, k, seed, init)
    return np.asarray(out)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _same_centre_sets(a, b, tol):
    """Every centre of a has one of b within tol (relative to b's scale),
    one to one."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
    match = d.argmin(axis=1)
    assert sorted(match) == list(range(len(b))), d
    assert d.min(axis=1).max() <= tol * max(np.abs(b).max(), 1.0), d.min(axis=1)


# ---------------------------------------------------------------------------
# ops/kmeans.py against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("init", _INITS)
@pytest.mark.parametrize("weighted", [True, False])
def test_lloyd_from_identical_centres_matches_jax(dtype, init, weighted):
    """The fused branch: JAX's seeding on every row into the port's
    `init_centers=`, then both Lloyds: centres and cost within 1e-10
    (float64, overlapping blobs, several iterations) or 1e-5 (float32,
    separable blobs), n_iter equal."""
    f64 = dtype == np.float64
    X, w = _blobs(seed=1, spread=3.0 if f64 else 10.0)
    X = X.astype(dtype)
    w = (w if weighted else np.ones(len(X))).astype(dtype)
    k, seed = 5, 7
    with jax.enable_x64(f64):
        C0 = _jax_seed(X, w, k, seed, init)
        Cj, cj, nj = jax_km.kmeans_fit(jnp.asarray(X), jnp.asarray(w), k, seed, max_iter=60,
                                       tol=1e-6, init=init)
        Cj, cj, nj = np.asarray(Cj), float(cj), int(nj)
    Cp, cp, n_iter = port_km.kmeans_fit(_t(X), _t(w), k, seed, max_iter=60, tol=1e-6,
                                        init=init, init_centers=C0)
    assert Cp.dtype == _t(X).dtype and Cp.shape == (k, X.shape[1])
    assert n_iter == nj and port_km.LAST_FIT["stepwise"] is False
    if f64:
        assert nj > 3  # the overlapping blobs take several iterations
    assert _rel(Cp.numpy(), Cj) <= _TOL[dtype]
    assert abs(float(cp) - cj) <= _TOL[dtype] * abs(cj)
    C64, X64 = Cp.numpy().astype(np.float64), X.astype(np.float64)
    host = float((((X64[:, None] - C64[None]) ** 2).sum(-1).min(1) * w).sum())
    assert abs(float(cp) - host) <= _TOL[dtype] * host
    # the cost of every pass is non-increasing, the last under the final centres
    costs = port_km.LAST_FIT["costs"]
    assert len(costs) == n_iter + 1
    assert all(b <= a * (1 + 1e-12) for a, b in zip(costs, costs[1:]))
    assert abs(costs[-1] - float(cp)) <= 1e-6 * costs[-1]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("init", _INITS)
def test_stepwise_branch_matches_jax(dtype, init):
    """`kmeans_fit_stepwise` with a small `flops_budget`: the seeding
    subsample is every `stride`-th row (k-means|| and k-means++; "random"
    never subsamples), and the Lloyd pass runs in several row blocks.  JAX's
    seeding on its subsample into the port's `init_centers=`: the same
    tolerances as the fused branch; and the port's own seeding sees the
    same subsample."""
    f64 = dtype == np.float64
    X, w = _blobs(seed=2, per=600, spread=3.0 if f64 else 10.0)
    X, w = X.astype(dtype), w.astype(dtype)
    n, d = X.shape
    k, seed, budget = 5, 11, 5e4
    _, _, per_row = port_km.init_flops_accounting(init, k, d, 2, 2.0)
    n_init = min(n, 262_144 if per_row > 1.0 else n, max(int(budget // per_row), k))
    stride = max(1, -(-n // n_init)) if n_init < n else 1
    assert (stride > 1) == (init != "random")
    with jax.enable_x64(f64):
        C0 = _jax_seed(X, w, k, seed, init, stride=stride)
        Cj, cj, nj = jax_km.kmeans_fit_stepwise(jnp.asarray(X), jnp.asarray(w), k, seed,
                                                max_iter=60, tol=1e-6, init=init,
                                                flops_budget=budget)
        Cj, cj, nj = np.asarray(Cj), float(cj), int(nj)
    Cp, cp, n_iter = port_km.kmeans_fit_stepwise(_t(X), _t(w), k, seed, max_iter=60, tol=1e-6,
                                                 init=init, flops_budget=budget,
                                                 init_centers=C0)
    block = int(budget // (2 * d * k))
    assert port_km.LAST_FIT["stepwise"] is True and port_km.LAST_FIT["stride"] == stride
    assert port_km.LAST_FIT["rows"] == block and -(-n // block) >= 3
    assert n_iter == nj
    assert _rel(Cp.numpy(), Cj) <= _TOL[dtype]
    assert abs(float(cp) - cj) <= _TOL[dtype] * abs(cj)
    # the port's own seeding, stepwise, is its seeding of the subsample
    own, _, _ = port_km.kmeans_fit_stepwise(_t(X), _t(w), k, seed, max_iter=0, init=init,
                                            flops_budget=budget)
    sub = port_km._seed(_t(X[::stride]), _t(w[::stride]), k, seed, init, 2, 2.0)
    np.testing.assert_array_equal(own.numpy(), sub.numpy())


@pytest.mark.parametrize("init", ["k-means||", "k-means++", "random"])
def test_own_seed_finds_the_jax_solution(init):
    """The port seeds from its own generator: on separable blobs the
    converged cost agrees with the JAX package's as a relative error and
    the centre sets match (float64).  "random" seeding picks two rows of
    one blob often, so for it k = 2 and the best of eight seeds counts, in
    both packages."""
    k = 2 if init == "random" else 4
    X, _ = _blobs(seed=3, k=k, per=250)
    seeds = range(8) if init == "random" else [5]

    def best(cls):
        models = [cls(k=k, initMode=init, seed=s, maxIter=50, tol=1e-8,
                      float32_inputs=False).fit(X) for s in seeds]
        return min(models, key=lambda m: m.summary.trainingCost)

    mine = best(KMeans)
    with jax.enable_x64(True):
        ref = best(JaxKMeans)
    assert abs(mine.summary.trainingCost - ref.summary.trainingCost) <= (
        1e-10 * ref.summary.trainingCost)
    _same_centre_sets(mine.cluster_centers_, ref.cluster_centers_, 1e-10)


def test_batched_kmeanspp_draws_are_single_draws():
    """Trial t of the batched k-means++ reduction is the single draw of
    seed t."""
    X, w = _blobs(seed=4, k=3, per=40)
    Xt, wt = _t(X), _t(w)
    batch = port_km._kmeanspp(Xt, port_km._log_weights(wt), 3, [21, 22, 23])
    for t, s in enumerate([21, 22, 23]):
        np.testing.assert_array_equal(batch[t].numpy(),
                                      port_km.kmeans_init(Xt, wt, 3, s).numpy())


def test_gumbel_draws_are_standard_gumbel():
    g = port_km.gumbel(200_000, port_km._generator(3, torch.device("cpu")),
                       torch.zeros(1, dtype=torch.float64))
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - np.euler_gamma) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03
    again = port_km.gumbel(200_000, port_km._generator(3, torch.device("cpu")),
                           torch.zeros(1, dtype=torch.float64))
    assert torch.equal(g, again)


@pytest.mark.parametrize("init", _INITS)
def test_zero_weight_rows_are_absent(init):
    """Rows of weight 0 (with large values) appended: from identical
    centres the port's fit equals JAX's on the padded rows and its own on
    the rows alone; its own seeding never picks a zero-weight row."""
    X, w = _blobs(seed=5, spread=3.0)
    junk = np.full((37, X.shape[1]), 1e3)
    Xp, wp = np.vstack([X, junk]), np.concatenate([w, np.zeros(37)])
    k, seed = 5, 3
    with jax.enable_x64(True):
        C0 = _jax_seed(Xp, wp, k, seed, init)
        Cj, cj, nj = jax_km.kmeans_fit(jnp.asarray(Xp), jnp.asarray(wp), k, seed, max_iter=60,
                                       tol=1e-6, init=init)
        Cj, cj, nj = np.asarray(Cj), float(cj), int(nj)
    assert np.abs(C0).max() < 100.0
    Cp, cp, n_iter = port_km.kmeans_fit(_t(Xp), _t(wp), k, seed, max_iter=60, tol=1e-6,
                                        init_centers=C0)
    Ca, ca, na = port_km.kmeans_fit(_t(X), _t(w), k, seed, max_iter=60, tol=1e-6,
                                    init_centers=C0)
    assert n_iter == nj == na
    assert _rel(Cp.numpy(), Cj) <= 1e-10 and abs(float(cp) - cj) <= 1e-10 * cj
    assert _rel(Cp.numpy(), Ca.numpy()) <= 1e-12 and abs(float(cp) - float(ca)) <= 1e-12 * ca
    own = port_km._seed(_t(Xp), _t(wp), k, seed, init, 2, 2.0)
    assert float(own.abs().max()) < 100.0


def test_tol_zero_runs_until_the_centres_stop():
    """tol=0 maps to the smallest float32 (both packages); from identical
    centres both Lloyds then run until no centre moves, or max_iter."""
    tol = KMeans(tol=0.0).tpu_params["tol"]
    assert tol == JaxKMeans(tol=0.0).tpu_params["tol"] == float(np.finfo(np.float32).tiny)
    X, w = _blobs(seed=6, spread=3.0)
    with jax.enable_x64(True):
        C0 = _jax_seed(X, w, 5, 1, "scalable-k-means++")
        Cj, cj, nj = jax_km.kmeans_fit(jnp.asarray(X), jnp.asarray(w), 5, 1, max_iter=200,
                                       tol=tol)
        Cj, cj, nj = np.asarray(Cj), float(cj), int(nj)
    Cp, cp, n_iter = port_km.kmeans_fit(_t(X), _t(w), 5, 1, max_iter=200, tol=tol,
                                        init_centers=C0)
    assert n_iter == nj < 200
    assert _rel(Cp.numpy(), Cj) <= 1e-10 and abs(float(cp) - cj) <= 1e-10 * cj
    # the last pass moved no row, so the centres stayed: the last two costs
    # are equal
    assert port_km.LAST_FIT["moved"][-1] == 0
    assert port_km.LAST_FIT["costs"][-1] == port_km.LAST_FIT["costs"][-2]


def test_unchanged_assignment_stops_despite_rounding_jitter(monkeypatch):
    """On a card the update's atomics move converged centres by a rounding
    each pass, so the shift never reaches a tight tol; the fit stops all
    the same when a pass assigns every row as the one before, at the
    iteration where the deterministic update stops, with the same
    centres."""
    X, w = _blobs(seed=17, spread=3.0)
    Xt, wt = _t(X.astype(np.float32)), _t(w.astype(np.float32))
    C0 = X[:5].astype(np.float32)
    C_ref, _, n_ref = port_km.kmeans_fit(Xt, wt, 5, 0, max_iter=100, tol=1e-9,
                                         init_centers=C0)
    update = port_km._lloyd_center_update
    gen = torch.Generator().manual_seed(0)

    def jittered(C, sums, counts):
        new_C, _ = update(C, sums, counts)
        noise = torch.randn(new_C.shape, dtype=torch.float64, generator=gen)
        new_C = new_C * (1 + 2.0 ** -22 * noise).to(new_C.dtype)
        return new_C, ((new_C - C) ** 2).sum(dim=1).max()

    monkeypatch.setattr(port_km, "_lloyd_center_update", jittered)
    C, _, n_iter = port_km.kmeans_fit(Xt, wt, 5, 0, max_iter=100, tol=1e-9, init_centers=C0)
    assert n_iter == n_ref < 100 and port_km.LAST_FIT["moved"][-1] == 0
    assert _rel(C.numpy(), C_ref.numpy()) <= 1e-5


@pytest.mark.parametrize("init", ["k-means||", "k-means++", "random"])
def test_k_equal_to_the_valid_rows(init):
    """k = the number of rows of weight > 0: every such row is a centre and
    the cost is 0 (to rounding), in both packages."""
    rng = np.random.default_rng(7)
    X = np.vstack([rng.normal(size=(7, 3)) * 5.0, np.full((5, 3), 1e3)])
    w = np.concatenate([np.ones(7), np.zeros(5)])
    data = pd.DataFrame({"features": list(X), "wt": w})
    mine = KMeans(k=7, initMode=init, float32_inputs=False).setWeightCol("wt").fit(data)
    with jax.enable_x64(True):
        ref = JaxKMeans(k=7, initMode=init, float32_inputs=False).setWeightCol("wt").fit(data)
    for m in (mine, ref):
        # 0 up to the matmul identity's rounding of x2 - 2 x.c + c2
        assert 0.0 <= m.summary.trainingCost <= 1e-14 * (X[:7] ** 2).sum()
        _same_centre_sets(m.cluster_centers_, X[:7], 1e-12)


@pytest.mark.parametrize("init", _INITS)
@pytest.mark.parametrize("n,budget", [(600, 2e12), (600, 1e6), (600, 1e4)])
def test_gate_and_cost_model_match_jax(init, n, budget):
    X, w = _blobs(seed=8, per=n // 5)
    d, k = X.shape[1], 5
    assert port_km.init_flops_accounting(init, k, d, 2, 2.0) == jax_km.init_flops_accounting(
        init, k, d, 2, 2.0)
    assert port_km.seed_sample_stride(n, 37) == jax_km.seed_sample_stride(n, 37)
    with jax.enable_x64(True):
        _, _, _, jax_stepwise = jax_km.kmeans_fit_auto(jnp.asarray(X), jnp.asarray(w), k, 0,
                                                       max_iter=5, init=init, budget=budget)
    *_, stepwise = port_km.kmeans_fit_auto(_t(X), _t(w), k, 0, max_iter=5, init=init,
                                           budget=budget)
    assert stepwise == jax_stepwise == port_km.LAST_FIT["stepwise"]
    port_config.set_config(dispatch_flops_limit=budget)
    *_, from_conf = port_km.kmeans_fit_auto(_t(X), _t(w), k, 0, max_iter=5, init=init)
    assert from_conf == stepwise


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_predict_and_cost_match_jax(dtype):
    X, w = _blobs(seed=9, spread=3.0)
    X, w = X.astype(dtype), w.astype(dtype)
    C = X[:5] + 0.5
    with jax.enable_x64(dtype == np.float64):
        lab = np.asarray(jax_km.kmeans_predict(jnp.asarray(X), jnp.asarray(C)))
        cost = float(jax_km.kmeans_cost(jnp.asarray(X), jnp.asarray(w), jnp.asarray(C)))
    mine = port_km.kmeans_predict(_t(X), _t(C))
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy(), lab)
    assert abs(float(port_km.kmeans_cost(_t(X), _t(w), _t(C))) - cost) <= _TOL[dtype] * cost


# ---------------------------------------------------------------------------
# The estimator against the JAX package
# ---------------------------------------------------------------------------


def _inputs(source, X, w, package):
    """(dataset, featuresCol, weightCol or None) for `source`."""
    if source == "numpy":
        return X, "features", None
    if source == "pandas_weighted":
        return pd.DataFrame({"features": list(X), "wt": w}), "features", "wt"
    if source == "pandas_cols":
        cols = [f"c{i}" for i in range(X.shape[1])]
        return pd.DataFrame(dict(zip(cols, X.T))), cols, None
    dd = DeviceDataset if package == "port" else JaxDeviceDataset
    return dd.from_host(X, weight=w, dtype=X.dtype), "features", None


@pytest.mark.parametrize("source", ["numpy", "pandas_weighted", "pandas_cols", "device_weighted"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_estimator_matches_jax(source, dtype):
    """Fits of separable blobs through the public entry points: the cost
    within 1e-10 (float64) or 1e-5 (float32) of JAX's, the same centre set,
    the same transform labels up to the centres' order, and the model's
    attributes in the data's dtype."""
    f32 = dtype == np.float32
    X, w = _blobs(seed=10, k=4, per=150)
    X = X.astype(dtype)

    def fit(cls, package):
        data, col, wcol = _inputs(source, X, w.astype(dtype), package)
        est = cls(k=4, seed=3, maxIter=40, tol=1e-8, float32_inputs=f32).setFeaturesCol(col)
        if wcol:
            est.setWeightCol(wcol)
        return est.fit(data), data

    mine, data = fit(KMeans, "port")
    with jax.enable_x64(not f32):
        ref, jdata = fit(JaxKMeans, "jax")
    assert mine.cluster_centers_.dtype == dtype and mine.dtype == np.dtype(dtype).name
    assert mine.n_cols == X.shape[1] and mine.cluster_centers_.shape == (4, X.shape[1])
    assert abs(mine.summary.trainingCost - ref.summary.trainingCost) <= (
        _TOL[dtype] * ref.summary.trainingCost)
    _same_centre_sets(mine.cluster_centers_, ref.cluster_centers_, _TOL[dtype])
    if source == "device_weighted":
        return
    a = mine.transform(data)
    with jax.enable_x64(not f32):
        b = ref.transform(jdata)
    la = np.asarray(a if source == "numpy" else a["prediction"])
    lb = np.asarray(b if source == "numpy" else b["prediction"])
    # the same partition: a one-to-one map between the two numberings
    pairs = set(zip(la.tolist(), lb.tolist()))
    assert len(pairs) == 4 and la.dtype == np.int32


def test_model_surface():
    X, _ = _blobs(seed=11, k=3, per=100)
    model = KMeans(k=3, seed=1, float32_inputs=False).setPredictionCol("c").fit(X)
    s = model.summary
    assert model.hasSummary and s.k == 3 and s.numIter == model.n_iter_ >= 1
    assert s.trainingCost == model.inertia_ > 0
    assert len(model.clusterCenters()) == 3 and model.getK() == 3
    out = model.transform({"features": X, "id": np.arange(300)})
    assert set(out) == {"features", "id", "c"} and out["c"].dtype == np.int32
    want = np.argmin(((X[:, None] - model.cluster_centers_[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(out["c"], want)
    assert [model.predict(x) for x in X[:20]] == want[:20].tolist()
    with pytest.raises(ValueError, match="entries"):
        model.predict(X[0, :2])
    empty = model.transform(pd.DataFrame({"features": []}))
    assert list(empty.columns) == ["features", "c"] and len(empty) == 0


def test_predict_and_summary_match_jax_on_one_model():
    X, _ = _blobs(seed=12, k=3, per=100)
    with jax.enable_x64(True):
        ref = JaxKMeans(k=3, seed=2, float32_inputs=False).fit(X)
        want = ref.transform(X)
        want_pred = [ref.predict(x) for x in X[:30]]
    mine = kmeans_model_from_reference(ref._get_model_attributes(), model_params(ref))
    np.testing.assert_array_equal(mine.transform(X), want)
    assert [mine.predict(x) for x in X[:30]] == want_pred
    assert vars(mine.summary) == vars(ref.summary)


# ---------------------------------------------------------------------------
# Save / load across the packages, and convert.py
# ---------------------------------------------------------------------------


def _same_attrs(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_cross_load(tmp_path, saver):
    X, _ = _blobs(seed=13, k=3, per=100)
    X = X.astype(np.float32)
    ref = JaxKMeans(k=3, seed=4).setPredictionCol("p").fit(X)
    mine = KMeans(k=3, seed=4).setPredictionCol("p").fit(X)
    path = str(tmp_path / "model")
    if saver == "jax":
        ref.save(path)
        loaded, want = KMeansModel.load(path), ref
    else:
        mine.save(path)
        loaded, want = JaxKMeansModel.load(path), mine
    _same_attrs(loaded._get_model_attributes(), want._get_model_attributes())
    assert loaded.getOrDefault("predictionCol") == "p" and loaded.getK() == 3
    assert loaded.tpu_params == want.tpu_params
    assert loaded.getOrDefault("seed") == want.getOrDefault("seed")
    np.testing.assert_array_equal(loaded.transform(X), want.transform(X))


def test_convert_pair_round_trips():
    X, _ = _blobs(seed=14, k=3, per=100)
    with jax.enable_x64(True):
        ref = JaxKMeans(k=3, float32_inputs=False).setPredictionCol("q").fit(X)
    mine = kmeans_model_from_reference(ref._get_model_attributes(), model_params(ref))
    _same_attrs(mine._get_model_attributes(), ref._get_model_attributes())
    assert mine.getOrDefault("predictionCol") == "q"
    back = JaxKMeansModel(**kmeans_model_to_reference_attributes(mine))
    JaxReadWrite._restore_params(back, model_params(mine))
    _same_attrs(back._get_model_attributes(), ref._get_model_attributes())
    with jax.enable_x64(True):
        np.testing.assert_array_equal(back.transform(X), ref.transform(X))


# ---------------------------------------------------------------------------
# The port's own contract
# ---------------------------------------------------------------------------


def test_params_and_defaults_match_jax():
    for a, b in ((KMeans(), JaxKMeans()), (KMeans(k=7, initMode="random", tol=0.5, seed=9),
                                           JaxKMeans(k=7, initMode="random", tol=0.5, seed=9))):
        assert [p.name for p in a.params] == [p.name for p in b.params]
        for p in a.params:
            assert a.hasDefault(p.name) == b.hasDefault(p.name)
            if a.hasDefault(p.name):
                assert a.getOrDefault(p.name) == b.getOrDefault(p.name), p.name
        assert a.tpu_params == b.tpu_params


def test_what_raises():
    X, _ = _blobs(seed=15, k=2, per=20)
    with pytest.raises(ValueError, match="not supported"):
        KMeans(distanceMeasure="cosine")
    with pytest.raises(ValueError, match="not supported"):
        KMeans(initMode="spectral")
    with pytest.raises(ValueError, match="Unsupported"):
        KMeans(not_a_param=1)
    est = KMeans(k=2)
    # the streamed fit is ported: it now reaches the file
    with pytest.raises(FileNotFoundError):
        est._fit_streaming("x.parquet")
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        est._cpu_fit(None)
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        est.fit(X).cpu()


def test_csr_fits_as_its_dense_form():
    """CSR input is densified: the same model as the dense rows, bit for
    bit, and the same transform."""
    X, _ = _blobs(seed=16, k=3, per=100)
    X = np.where(np.abs(X) > 5.0, X, 0.0)
    dense = KMeans(k=3, seed=2, float32_inputs=False).fit(X)
    sparse = KMeans(k=3, seed=2, float32_inputs=False).fit(sp.csr_matrix(X))
    np.testing.assert_array_equal(sparse.cluster_centers_, dense.cluster_centers_)
    assert sparse.inertia_ == dense.inertia_ and sparse.n_iter_ == dense.n_iter_
    np.testing.assert_array_equal(sparse.transform(sp.csr_matrix(X)), dense.transform(X))
