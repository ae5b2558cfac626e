#
# KMeans and DBSCAN on the card against the same code on the CPU: Lloyd
# from identical centres in both branches of the gate, the card's own
# seeding, transform, and DBSCAN's labels with the default and a small
# byte cap.  Every test here needs a CUDA device and skips without one.
# This file imports no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_clustering_cuda.py
#
import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import DeviceDataset, set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.clustering import DBSCAN, KMeans
from spark_rapids_ml_torch.ops import kmeans as km

pytestmark = pytest.mark.cuda

# the card sums in another order (atomics within a block); float32 on
# separable blobs
_TOL = {np.float32: 1e-5, np.float64: 1e-10}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    set_default_device(None)
    port_config.reset_config()


def _blobs(seed, k=6, per=3000, d=12, spread=10.0):
    """Blobs, weights, and one row of each blob (initial centres that put
    no decision boundary inside a blob)."""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(-spread, spread, (k, d))
    X = np.concatenate([c + rng.normal(size=(per, d)) for c in cent])
    perm = rng.permutation(len(X))
    first = np.argsort(perm)[::per]  # where row 0 of each blob went
    return X[perm], rng.uniform(0.2, 2.0, len(X)), first


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("budget", [2e12, 1e6])
@pytest.mark.parametrize("weighted", [True, False])
def test_lloyd_on_the_card_matches_the_cpu(cuda_device, dtype, budget, weighted):
    X, w, first = _blobs(1, spread=3.0 if dtype == np.float64 else 10.0)
    X, w = X.astype(dtype), (w if weighted else np.ones(len(X))).astype(dtype)
    C0 = X[first]
    out = {}
    for dev in ("cpu", cuda_device):
        Xt, wt = torch.from_numpy(X).to(dev), torch.from_numpy(w).to(dev)
        C, cost, n_iter, stepwise = km.kmeans_fit_auto(Xt, wt, 6, 0, max_iter=50, tol=1e-6,
                                                       budget=budget, init_centers=C0)
        out[str(dev)] = (C.cpu().numpy(), float(cost), n_iter, stepwise)
    (c_cpu, cost_cpu, it_cpu, sw_cpu), (c_gpu, cost_gpu, it_gpu, sw_gpu) = out.values()
    assert sw_cpu == sw_gpu == (budget < 2e12) and it_cpu == it_gpu
    assert _rel(c_gpu, c_cpu) <= _TOL[dtype]
    assert abs(cost_gpu - cost_cpu) <= _TOL[dtype] * cost_cpu


@pytest.mark.parametrize("init", ["k-means||", "k-means++", "random"])
def test_own_seed_on_the_card(cuda_device, init):
    """The card's generator draws other Gumbels than the CPU's: on separable
    blobs both find the same cost (the best of eight seeds for "random")."""
    k = 2 if init == "random" else 6
    X, _, _ = _blobs(2, k=k, spread=40.0)
    costs = {}
    for dev in ("cpu", cuda_device):
        set_default_device(dev)
        seeds = range(8) if init == "random" else [3]
        costs[str(dev)] = min(KMeans(k=k, initMode=init, seed=s, tol=1e-8, maxIter=50,
                                     float32_inputs=False).fit(X).summary.trainingCost
                              for s in seeds)
    a, b = costs.values()
    assert abs(a - b) <= 1e-10 * b


def test_estimator_and_transform_on_the_card(cuda_device):
    X, w, _ = _blobs(3)
    X = X.astype(np.float32)
    set_default_device(cuda_device)
    ds = DeviceDataset.from_host(X, weight=w, dtype=np.float32)
    a = KMeans(k=6, seed=1).fit(ds)
    b = KMeans(k=6, seed=1).setWeightCol("wt").fit({"features": X, "wt": w})
    assert abs(a.summary.trainingCost - b.summary.trainingCost) <= 1e-5 * b.summary.trainingCost
    lab = a.transform(X)
    want = np.argmin(((X[:, None].astype(np.float64) - a.cluster_centers_[None]) ** 2).sum(-1), 1)
    assert lab.dtype == np.int32 and (lab == want).mean() == 1.0


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("cap_mb", [None, 0.05])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dbscan_on_the_card_matches_the_cpu(cuda_device, metric, cap_mb, dtype):
    """Blobs on a grid of 1/8 (euclidean: every squared distance exact in
    both dtypes); the same labels on the card and the CPU."""
    rng = np.random.default_rng(4)
    cent = rng.uniform(-6.0, 6.0, (8, 4))
    X = np.concatenate([c + 0.6 * rng.normal(size=(300, 4)) for c in cent]
                       + [rng.uniform(-8.0, 8.0, (100, 4))])
    X = (np.round(X * 8.0) / 8.0).astype(dtype)
    kw = dict(eps=1.2 if metric == "euclidean" else 0.004, min_samples=5, metric=metric,
              float32_inputs=dtype == np.float32)
    if cap_mb:
        kw["max_mbytes_per_batch"] = cap_mb
    labels = []
    for dev in ("cpu", cuda_device):
        set_default_device(dev)
        labels.append(DBSCAN(**kw).fit(X).transform(X))
    if metric == "euclidean" or dtype == np.float64:
        np.testing.assert_array_equal(labels[1], labels[0])
    else:  # unit rows in float32: pairs at the threshold may round either way
        assert (labels[1] != labels[0]).mean() < 0.01
