#
# The port's histogram tree builder (spark_rapids_ml_torch/ops/forest.py)
# against the JAX package's (spark_rapids_ml_tpu/ops/forest.py) on the same
# numpy inputs, on the CPU: the bin edges (zero-weight rows included), the
# bin ids, the impurities, the cumulative sums, the node-table size, the
# frontier's tie order, whole forests grown from the JAX package's own
# draws (rebuilt here with jax.random and handed in through `draws=`), and
# the traversal.  The JAX side runs on a one-device mesh (num_workers=1);
# every JAX float64 call runs inside `jax.enable_x64(True)` (the flag is
# checked at module teardown).
#
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.ops import forest as pf
from spark_rapids_ml_tpu.ops import forest as jf
from spark_rapids_ml_tpu.parallel.mesh import get_mesh

_DTYPES = [np.float32, np.float64]
# gains are held to a tolerance: XLA's CPU compiler fuses float64
# multiply-adds, and computes the log of the entropy with its own routine,
# so a gain may differ from the JAX package's in its last bits
_GAIN_TOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture(scope="module", autouse=True)
def _x64_flag_unchanged():
    before = jax.config.jax_enable_x64
    yield
    assert jax.config.jax_enable_x64 == before


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(seed, n, d, dtype, duplicates=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    if duplicates:  # few distinct values: equal edges and ties
        X = np.round(X * 2) / 2
    return X.astype(dtype)


def _balanced_design(seed, n, d, dtype):
    """Binary rows whose first four columns are a full factorial design
    repeated (each split on one of them halves a node exactly), the rest
    random bits: children of a level have equal counts, so a capped
    frontier must choose among tied counts."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 2, (n, d)).astype(dtype)
    X[:, :4] = (np.arange(n)[:, None] >> np.arange(4)[None, :]) & 1
    return X


def jax_draws(seed, n_trees, n, d, max_depth, max_active, max_features, bootstrap,
              subsample, dtype):
    """The draws the JAX package's `forest_fit` makes on a one-device mesh,
    rebuilt with jax.random: `fold_in(PRNGKey(seed), 0)` -> one key per
    tree -> (kb, kf); Poisson or Bernoulli row weights from kb, a Gumbel
    matrix per level from `fold_in(kf, level)`."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 0), n_trees)
    out = []
    for t in range(n_trees):
        kb, kf = jax.random.split(keys[t])
        w = None
        rate = jnp.float32(subsample)
        if bootstrap:
            w = np.array(jax.random.poisson(kb, rate, (n,)))
        elif subsample < 1.0:
            w = np.array(jax.random.bernoulli(kb, rate, (n,)))
        g = None
        if max_features < d:
            g = [np.array(jax.random.gumbel(jax.random.fold_in(kf, lv),
                                            (min(1 << lv, max_active), d), dtype))
                 for lv in range(max_depth)]
        out.append(pf.TreeDraws(w, g))
    return out


def _same_forest(mine, ref, dtype):
    """feature, left_child and threshold equal; leaf_stats and count
    equal; gain within `_GAIN_TOL` of the largest gain."""
    for f in ("feature", "left_child", "threshold", "leaf_stats", "count"):
        a, b = getattr(mine, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    g, gr = mine.gain, np.asarray(ref.gain)
    assert g.dtype == gr.dtype
    assert np.abs(g - gr).max() <= _GAIN_TOL[dtype] * max(np.abs(gr).max(), 1.0)


# ---------------------------------------------------------------------------
# The leaf functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("n_bins", [2, 16, 128, 300])
@pytest.mark.parametrize("weights", ["none", "zeros", "mostly_zero"])
def test_compute_bin_edges_matches_jax(dtype, n_bins, weights):
    X = _rows(1, 500, 5, dtype, duplicates=n_bins == 16)
    valid = None
    if weights == "zeros":
        valid = np.where(np.arange(500) % 7 == 0, 0.0, 1.5).astype(dtype)
    elif weights == "mostly_zero":  # edges past the valid rows: finfo.max
        valid = (np.arange(500) < 20).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jf.compute_bin_edges(
            jnp.asarray(X), n_bins, None if valid is None else jnp.asarray(valid)))
    mine = pf.compute_bin_edges(_t(X), n_bins, None if valid is None else _t(valid)).numpy()
    assert mine.dtype == ref.dtype and mine.shape == (n_bins - 1, 5)
    np.testing.assert_array_equal(mine, ref)


def test_compute_bin_edges_sorts_in_column_blocks(monkeypatch):
    """A byte cap of a few columns gives the same edges as one block."""
    X = _rows(2, 300, 11, np.float32)
    valid = _t((np.arange(300) % 5 != 0).astype(np.float32))
    whole = pf.compute_bin_edges(_t(X), 32, valid)
    monkeypatch.setattr(pf, "_CHUNK_BYTES", 300 * 12 * 3)
    np.testing.assert_array_equal(pf.compute_bin_edges(_t(X), 32, valid).numpy(), whole.numpy())


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("n_bins", [16, 256, 300])
def test_digitize_matches_jax(dtype, n_bins, monkeypatch):
    """Equal bin ids, rows on the edges and equal edges included, in the
    narrow dtype, also when the rows go through in several chunks."""
    X = _rows(3, 400, 6, dtype, duplicates=True)
    edges = pf.compute_bin_edges(_t(X), n_bins)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jf.digitize(jnp.asarray(X), jnp.asarray(edges.numpy())))
    mine = pf.digitize(_t(X), edges)
    assert mine.dtype == pf.bin_dtype(n_bins)
    np.testing.assert_array_equal(mine.numpy().astype(np.int32), ref)
    monkeypatch.setattr(pf, "_CHUNK_BYTES", 6 * 12 * 37)
    np.testing.assert_array_equal(pf.digitize(_t(X), edges).numpy(), mine.numpy())


def test_bin_dtype():
    assert [pf.bin_dtype(b) for b in (2, 256, 257, 32768, 32769)] == [
        torch.uint8, torch.uint8, torch.int16, torch.int16, torch.int32]


def _impurity_inputs(criterion, S, dtype, rng):
    st = rng.integers(0, 20, (300, 7, S)) * rng.uniform(0.5, 1.5, (300, 7, S))
    st[::5] = 0  # empty nodes
    if criterion == pf.VARIANCE:
        st[..., 1] = rng.normal(size=(300, 7)) * st[..., 0]
        st[..., 2] = st[..., 1] ** 2 / np.maximum(st[..., 0], 1e-3) * rng.uniform(1, 2, (300, 7))
    return st.astype(dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("criterion,S", [(pf.GINI, 2), (pf.GINI, 3), (pf.ENTROPY, 3),
                                         (pf.VARIANCE, 3)])
def test_impurity_matches_jax(dtype, criterion, S):
    """Against the JAX function as XLA compiles it inside the builder
    (jitted): gini and variance bit for bit (the port rounds each fused
    multiply-add once, as XLA's CPU code does); entropy, whose log is XLA's
    own routine, within 2 units in the last place.  The counts bit for
    bit."""
    st = _impurity_inputs(criterion, S, dtype, np.random.default_rng(4))
    with jax.enable_x64(dtype == np.float64):
        ref_imp, ref_n = map(np.asarray, jax.jit(jf._impurity, static_argnums=1)(
            jnp.asarray(st), criterion))
    imp, n = pf._impurity(_t(st), criterion)
    assert imp.numpy().dtype == ref_imp.dtype
    np.testing.assert_array_equal(n.numpy(), ref_n)
    if criterion != pf.ENTROPY:
        np.testing.assert_array_equal(imp.numpy(), ref_imp)
    else:
        tol = 2 * np.finfo(dtype).eps
        assert np.abs(imp.numpy() - ref_imp).max() <= tol * max(np.abs(ref_imp).max(), 1.0)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("length", [1, 2, 16, 17, 32, 127, 256, 257, 300])
def test_cumsum_is_xlas_association(dtype, length):
    """`_cumsum` rounds as XLA's CPU `jnp.cumsum` does, bit for bit."""
    h = np.random.default_rng(length).uniform(0, 3, (4, 3, length, 2)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=2))(jnp.asarray(h)))
    np.testing.assert_array_equal(pf._cumsum(_t(h), 2).numpy(), ref)


@pytest.mark.parametrize("max_depth,max_active", [(1, 256), (6, 256), (13, 256), (16, 4),
                                                  (5, 1), (9, 32)])
def test_table_nodes_matches_jax(max_depth, max_active):
    assert pf.table_nodes(max_depth, max_active) == jf.table_nodes(max_depth, max_active)


@pytest.mark.parametrize("seed", range(4))
def test_capped_frontier_keeps_jax_top_k_order(seed):
    """Equal integer counts: the stable descending sort keeps the same
    children, in the same order, as jax.lax.top_k (the lower index first)."""
    rng = np.random.default_rng(seed)
    score = rng.integers(0, 4, 64).astype(np.float32)
    score[rng.random(64) < 0.2] = -np.inf
    vals, idx = jax.lax.top_k(jnp.asarray(score), 16)
    mine_vals, mine_idx = torch.sort(_t(score), descending=True, stable=True)
    np.testing.assert_array_equal(mine_idx[:16].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(mine_vals[:16].numpy(), np.asarray(vals))


# ---------------------------------------------------------------------------
# Whole trees from the JAX package's draws
# ---------------------------------------------------------------------------

# (bootstrap, subsample, max_features, max_active, balanced): bootstrap on
# and off, subsampling, a feature subset, and a capped frontier on integer
# weights over `_balanced_design` rows (equal child counts)
_CONFIGS = {
    "bootstrap": (True, 1.0, 8, 256, False),
    "no_bootstrap": (False, 1.0, 8, 256, False),
    "subsample": (False, 0.7, 8, 256, False),
    "feature_subset": (True, 1.0, 3, 256, False),
    "capped_ties": (False, 1.0, 8, 4, True),
}


def _labels(X, criterion, balanced=False):
    if balanced:
        return (X[:, :4].sum(axis=1) >= 2 + (criterion == pf.ENTROPY)).astype(np.float32)
    if criterion == pf.VARIANCE:
        return (2.0 * X[:, 0] + X[:, 3] ** 2 + np.sin(3 * X[:, 1])).astype(np.float32)
    if criterion == pf.GINI:
        return ((X[:, 0] + 0.5 * X[:, 1]) > 0).astype(np.float32)
    return np.digitize(X[:, 2] + X[:, 0], [-0.5, 0.5]).astype(np.float32)


def _fit_both(X, y, w, criterion, n_classes, config, dtype, seed=7, n_trees=2, max_depth=5,
              n_bins=16, weights_drawn=None):
    bootstrap, subsample, max_features, max_active, _ = config
    kw = dict(max_depth=max_depth, n_bins=n_bins, criterion=criterion, n_classes=n_classes,
              max_features=max_features, min_instances=1.0, min_info_gain=0.0,
              bootstrap=bootstrap, subsample=subsample, max_active=max_active)
    n, d = X.shape
    with jax.enable_x64(dtype == np.float64):
        ref = jf.forest_fit(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), seed,
                            trees_per_worker=n_trees, mesh=get_mesh(1), **kw)
        draws = jax_draws(seed, n_trees, n, d, max_depth, max_active, max_features,
                          bootstrap, subsample, dtype)
    mine = pf.forest_fit(_t(X), _t(y), _t(w), seed, n_trees=n_trees, draws=draws, **kw)
    return mine, ref


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("config", sorted(_CONFIGS))
@pytest.mark.parametrize("criterion", [pf.GINI, pf.ENTROPY, pf.VARIANCE])
def test_forest_from_jax_draws_matches_jax(dtype, config, criterion):
    """The JAX package's forest_fit and the port's, the JAX draws handed in:
    the same trees (structure and thresholds equal; leaf statistics and
    counts equal; gains within _GAIN_TOL).  float64 rows carry weights in
    [0.2, 2) and zero-weight rows (but for the integer-count capped case);
    float32 rows weigh 1."""
    balanced = _CONFIGS[config][4]
    X = _balanced_design(5, 512, 8, dtype) if balanced else _rows(5, 512, 8, dtype)
    y = _labels(X, criterion, balanced)
    w = np.ones(len(X))
    if dtype == np.float64 and not balanced:
        w = np.random.default_rng(6).uniform(0.2, 2.0, len(X))
        w[::13] = 0.0
    w = w.astype(dtype)
    n_classes = 0 if criterion == pf.VARIANCE else int(y.max()) + 1
    mine, ref = _fit_both(X, y, w, criterion, n_classes, _CONFIGS[config], dtype)
    _same_forest(mine, ref, dtype)
    assert ((mine.feature >= 0).sum(axis=1) >= 3).all()  # every tree grew


def _node_levels(left_child, feature):
    """Table ids of each level of one tree, in table order."""
    levels, cur = [], [0]
    while cur:
        levels.append(cur)
        cur = [int(left_child[i]) + k for i in cur if feature[i] >= 0 for k in (0, 1)]
    return levels


def test_capped_frontier_resolves_tied_counts_as_jax():
    """The capped case of the test above, shown to decide ties: at a level
    where more children could grow than the frontier holds, a child that
    was cut has the same count as one that was kept (kept children carry a
    count, cut ones only leaf statistics), and the trees still equal
    JAX's."""
    X = _balanced_design(5, 512, 8, np.float32)
    y = _labels(X, pf.GINI, balanced=True)
    config = _CONFIGS["capped_ties"]
    mine, ref = _fit_both(X, y, np.ones(512, np.float32), pf.GINI, 2, config, np.float32)
    _same_forest(mine, ref, np.float32)
    ties = 0
    for t in range(mine.feature.shape[0]):
        feature, left, count = mine.feature[t], mine.left_child[t], mine.count[t]
        weight = mine.leaf_stats[t].sum(axis=1)
        for level in _node_levels(left, feature)[1:]:
            kept = [count[i] for i in level if count[i] > 0]
            cut = [weight[i] for i in level if count[i] == 0 and weight[i] >= 2]
            if kept and cut and min(kept) == max(cut):
                ties += 1
    assert ties > 0


@pytest.mark.parametrize("dtype", _DTYPES)
def test_forest_apply_matches_jax(dtype):
    X = _rows(8, 400, 8, dtype)
    y = _labels(X, pf.GINI)
    mine, _ = _fit_both(X, y, np.ones(400, dtype), pf.GINI, 2, _CONFIGS["feature_subset"], dtype)
    Q = _rows(9, 300, 8, dtype)
    Q[:10] = mine.threshold[0, 0]  # rows on a threshold go left
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jf.forest_apply(jnp.asarray(Q), jnp.asarray(mine.feature),
                                         jnp.asarray(mine.threshold),
                                         jnp.asarray(mine.left_child), max_depth=5))
    got = pf.forest_apply(_t(Q), _t(mine.feature).long(), _t(mine.threshold),
                          _t(mine.left_child).long(), max_depth=5)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_own_draws_shapes_and_determinism():
    """The port's own draws: Poisson(rate) under bootstrap, Bernoulli
    without it, one Gumbel matrix per level of width min(2^l, max_active);
    the same seed gives the same forest, another seed another."""
    gen = torch.Generator().manual_seed(0)
    X = _t(_rows(10, 20000, 6, np.float32))
    dr = pf._own_draws(gen, X, 5, 4, 2, True, 0.5)
    assert abs(float(dr.weights.mean()) - 0.5) < 0.02 and dr.weights.max() >= 3
    assert [tuple(g.shape) for g in dr.gumbels] == [(1, 6), (2, 6), (4, 6), (4, 6), (4, 6)]
    dr = pf._own_draws(gen, X, 5, 4, 6, False, 0.3)
    assert dr.gumbels is None and set(dr.weights.unique().tolist()) == {0.0, 1.0}
    assert abs(float(dr.weights.mean()) - 0.3) < 0.02
    assert pf._own_draws(gen, X, 5, 4, 6, False, 1.0) == pf.TreeDraws(None, None)
    Xs = X[:500]
    y = torch.from_numpy(_labels(Xs.numpy(), pf.GINI))
    kw = dict(n_trees=2, max_depth=5, n_bins=16, criterion=pf.GINI, n_classes=2,
              max_features=2, min_instances=1.0, min_info_gain=0.0, bootstrap=True,
              subsample=1.0)
    a, b, c = (pf.forest_fit(Xs, y, torch.ones(500), s, **kw) for s in (3, 3, 4))
    np.testing.assert_array_equal(a.feature, b.feature)
    np.testing.assert_array_equal(a.leaf_stats, b.leaf_stats)
    assert not np.array_equal(a.leaf_stats, c.leaf_stats)


def test_layer_timer_spans():
    """`timer=` wraps every layer: the prep once, three spans per level,
    the leaf statistics once per tree."""
    import contextlib
    from collections import Counter

    seen = Counter()

    class Timer:
        @contextlib.contextmanager
        def span(self, name):
            seen[name] += 1
            yield

    X = _t(_rows(11, 300, 4, np.float32))
    pf.forest_fit(X, X[:, 0] * 2, torch.ones(300), 0, n_trees=2, max_depth=4, n_bins=8,
                  criterion=pf.VARIANCE, n_classes=0, max_features=4, min_instances=1.0,
                  min_info_gain=0.0, bootstrap=False, subsample=1.0, timer=Timer())
    assert seen == {"prep.edges": 1, "prep.digitize": 1, "histogram": 8, "split": 8,
                    "route": 8, "leaf": 2}


def test_draws_must_cover_every_tree():
    X = _t(_rows(12, 100, 3, np.float32))
    with pytest.raises(ValueError, match="draws holds 1 trees"):
        pf.forest_fit(X, X[:, 0], torch.ones(100), 0, n_trees=2, max_depth=3, n_bins=8,
                      criterion=pf.VARIANCE, n_classes=0, max_features=3, min_instances=1.0,
                      min_info_gain=0.0, bootstrap=False, subsample=1.0,
                      draws=[pf.TreeDraws(None, None)])


# chip_smoke.py's RandomForest checks, held here on the CPU: its plain
# split search (timed beside the fit's on the card) chooses the fit's
# splits, and check 5 (a float64 forest on two devices) names a near-tie
# flip and holds every node outside it, and fails a flip beyond a near tie
# or a leaf that moved.


@pytest.mark.parametrize("criterion", [pf.GINI, pf.ENTROPY, pf.VARIANCE])
def test_chip_smoke_plain_split_search_agrees(criterion):
    import chip_smoke

    g = torch.Generator().manual_seed(criterion)
    h = torch.randint(0, 50, (4, 6, 16, 3), generator=g).float()
    if criterion == pf.VARIANCE:
        h[..., 1] = torch.randn(4, 6, 16, generator=g) * h[..., 0]
        h[..., 2] = h[..., 1] ** 2 / h[..., 0].clamp_min(1) + h[..., 0]
    fmask = torch.rand((4, 6), generator=g) > 0.3
    fit = pf._best_splits(h, criterion, 1.0, fmask)
    plain = chip_smoke.plain_best_splits(h, criterion, 1.0, fmask)
    assert torch.equal(fit[0], plain[0])
    torch.testing.assert_close(plain[1], fit[1], rtol=1e-6, atol=1e-6)


def _perturbed_card_fit(monkeypatch, change):
    """ops/forest.py `forest_fit` whose first call of each pair (the card's
    in check 5) has `change(trees)` applied."""
    fit, calls = pf.forest_fit, []

    def forest_fit(*args, **kw):
        trees = fit(*args, **kw)
        calls.append(1)
        if len(calls) % 2 == 1:
            change(trees)
        return trees

    monkeypatch.setattr(pf, "forest_fit", forest_fit)


def _flip(gain_factor):
    def change(trees):
        i = int(np.flatnonzero(trees.feature[1] >= 0)[3])
        trees.feature[1, i] = (trees.feature[1, i] + 1) % trees.feature.max()
        trees.gain[1, i] *= gain_factor
    return change


def _move_a_leaf(trees):
    leaves = (trees.feature[2] < 0) & (np.abs(trees.leaf_stats[2]).sum(-1) > 0)
    trees.leaf_stats[2, np.flatnonzero(leaves)[-1]] *= 1 + 1e-6


@pytest.mark.parametrize("case", ["same", "near_tie", "beyond_tie", "leaf_moved"])
def test_chip_smoke_check5(monkeypatch, case):
    import chip_smoke

    change = {"same": None, "near_tie": _flip(1 + 1e-13), "beyond_tie": _flip(1 + 1e-10),
              "leaf_moved": _move_a_leaf}[case]
    if change is not None:
        _perturbed_card_fit(monkeypatch, change)
    if case in ("beyond_tie", "leaf_moved"):
        with pytest.raises(AssertionError):
            chip_smoke.phase_forest_float64(torch.device("cpu"), 3000, 5)
        return
    cells = chip_smoke.phase_forest_float64(torch.device("cpu"), 3000, 5)["cells"]
    for c in cells:
        assert c["predictions_equal"]
        if case == "same":
            assert c["flips"] == [] and c["nodes_held"] == c["nodes"]
            assert c["rows_compared"] == 3000
        else:
            (f,) = c["flips"]
            assert f["tree"] == 1 and f["gain_gap_rel"] < 1e-12
            assert c["nodes_held"] == c["nodes"] - f["nodes_below"]
            assert 0 < c["rows_compared"] < 3000
