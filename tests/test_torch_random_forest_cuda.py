#
# RandomForest on the card against the same code on the CPU: float64
# forests grown from the same draws (made here with numpy and handed in
# through `draws=`) with non-integer weights, bootstrap and feature
# subsets; the estimators through the public entry points (a DeviceDataset
# and numpy, transform against the numpy predictor); and the card's own
# draws, which repeat for one seed.  Every test here needs a CUDA device
# and skips without one.  This file imports no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_random_forest_cuda.py
#
import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import DeviceDataset, set_default_device
from spark_rapids_ml_torch.classification import RandomForestClassifier
from spark_rapids_ml_torch.ops import forest as pf
from spark_rapids_ml_torch.regression import RandomForestRegressor

pytestmark = pytest.mark.cuda

_ARRAYS = ("feature", "threshold", "leaf_stats", "gain", "count", "left_child")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    set_default_device(None)


def _data(seed, n, d, task):
    """Ten blobs (classification) or a smooth label (regression), weights
    in [0.2, 2)."""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(-4, 4, (10, d))
    lab = rng.integers(0, 10, n)
    X = cent[lab] + rng.normal(size=(n, d))
    if task == "regression":
        y = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=n)
    else:
        y = lab % 3
    return X, y.astype(np.float32), rng.uniform(0.2, 2.0, n)


def host_draws(seed, n_trees, n, d, max_depth, max_active, max_features):
    """Poisson(1) row weights and standard Gumbel matrices from numpy."""
    rng = np.random.default_rng(seed)
    return [pf.TreeDraws(rng.poisson(1.0, n).astype(np.float64),
                         [rng.gumbel(size=(min(1 << lv, max_active), d))
                          for lv in range(max_depth)])
            for _ in range(n_trees)]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("criterion", [pf.GINI, pf.ENTROPY, pf.VARIANCE])
def test_float64_forest_on_the_card_matches_the_cpu(cuda_device, criterion):
    """The same draws on both devices: structure and thresholds equal,
    leaf statistics, gains and counts within 1e-9 (the card's atomics sum
    the non-integer weights in another order)."""
    task = "regression" if criterion == pf.VARIANCE else "classification"
    n, d, depth = 20000, 16, 8
    X, y, w = _data(1, n, d, task)
    kw = dict(n_trees=2, max_depth=depth, n_bins=64, criterion=criterion,
              n_classes=0 if task == "regression" else 3, max_features=4,
              min_instances=1.0, min_info_gain=0.0, bootstrap=True, subsample=1.0,
              max_active=64, draws=host_draws(2, 2, n, d, depth, 64, 4))
    out = {}
    for dev in ("cpu", cuda_device):
        out[str(dev)] = pf.forest_fit(*(torch.from_numpy(a).to(dev) for a in (X, y, w)), 0,
                                      **kw)
    cpu, card = out["cpu"], out[str(cuda_device)]
    for k in ("feature", "left_child", "threshold"):
        np.testing.assert_array_equal(getattr(card, k), getattr(cpu, k), err_msg=k)
    for k in ("leaf_stats", "gain", "count"):
        assert _rel(getattr(card, k), getattr(cpu, k)) <= 1e-9, k
    assert ((cpu.feature >= 0).sum(axis=1) > 50).all()


@pytest.mark.parametrize("cls", [RandomForestClassifier, RandomForestRegressor])
def test_estimator_on_the_card(cuda_device, cls):
    """Through the public entry points: a fit from a DeviceDataset equals
    the fit from numpy for classification (integer counts sum exactly in
    any order), and transform answers as the numpy predictor does."""
    task = "regression" if cls is RandomForestRegressor else "classification"
    X, y, _ = _data(3, 30000, 12, task)
    X = X.astype(np.float32)
    set_default_device(cuda_device)
    est = cls(numTrees=4, maxDepth=9, seed=4)
    a = est.fit((X, y))
    b = est.fit(DeviceDataset.from_host(X, y=y, dtype=np.float32))
    if task == "classification":
        for k in _ARRAYS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        got = a.transform(X)
        np.testing.assert_array_equal(got["prediction"], a.cpu().predict(X))
        np.testing.assert_allclose(got["probability"], a.cpu().predict_proba(X), atol=1e-6)
    else:
        np.testing.assert_array_equal(a.feature[:, 0], b.feature[:, 0])
        np.testing.assert_allclose(a.transform(X), a.cpu().predict(X), rtol=1e-5, atol=1e-5)


def test_own_draws_repeat_for_one_seed(cuda_device):
    """The card's generator: one seed, one forest (classification counts
    are exact, so the atomics' order cannot show); another seed, another."""
    X, y, _ = _data(5, 20000, 10, "classification")
    t = [torch.from_numpy(a).to(cuda_device) for a in (X.astype(np.float32), y)]
    kw = dict(n_trees=3, max_depth=7, n_bins=32, criterion=pf.GINI, n_classes=3,
              max_features=3, min_instances=1.0, min_info_gain=0.0, bootstrap=True,
              subsample=1.0)
    w = torch.ones(len(X), device=cuda_device)
    a, b, c = (pf.forest_fit(t[0], t[1], w, s, **kw) for s in (7, 7, 8))
    for k in _ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert not np.array_equal(a.leaf_stats, c.leaf_stats)


def test_forest_apply_on_the_card_matches_the_cpu(cuda_device):
    X, y, _ = _data(6, 5000, 8, "classification")
    X = X.astype(np.float32)
    model = RandomForestClassifier(numTrees=5, maxDepth=6, seed=1).fit((X, y))
    args = [torch.from_numpy(np.asarray(a)) for a in
            (X, model.feature.astype(np.int64), model.threshold,
             model.left_child.astype(np.int64))]
    cpu = pf.forest_apply(*args, max_depth=6)
    card = pf.forest_apply(*(a.to(cuda_device) for a in args), max_depth=6)
    np.testing.assert_array_equal(card.cpu().numpy(), cpu.numpy())
