#
# The port's distance forms and metric kNN (spark_rapids_ml_torch/ops/
# distances.py) against the JAX package's on the same numpy inputs, on the
# CPU: the gathered-candidate form, the matmul metrics' row transform and
# finalization, the tiled brute force under every elementwise metric (with
# invalid items and k above the valid count), and `umap_knn_graph`'s three
# branches.  Tolerances: float32 distances within 1e-5 relative (another
# summation order); ids equal wherever the distance is not tied.
#
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.config import reset_config
from spark_rapids_ml_torch.ops import distances as port
from spark_rapids_ml_tpu.config import reset_config as jax_reset_config
from spark_rapids_ml_tpu.ops import distances as ref

_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_and_clean_config():
    set_default_device("cpu")
    reset_config()
    jax_reset_config()
    yield
    reset_config()
    jax_reset_config()
    set_default_device(None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def assert_same_neighbours(d_port, i_port, d_ref, i_ref, rtol=_RTOL, scale=None):
    """Distances within `rtol` relative to `scale` (q, 1) (default: the
    row's largest finite distance), ids equal at every slot whose distance
    no other slot of the row ties within that tolerance."""
    d_port, i_port = np.asarray(d_port), np.asarray(i_port)
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    assert d_port.shape == d_ref.shape and i_port.shape == i_ref.shape
    np.testing.assert_array_equal(np.isinf(d_port), np.isinf(d_ref))
    fin = np.isfinite(d_ref)
    ref_f = np.where(fin, d_ref, np.nan)  # NaN compares false, quietly
    if scale is None:
        scale = np.max(np.where(fin, np.abs(d_ref), 0.0), axis=1, keepdims=True)
    tol = rtol * (np.asarray(scale, np.float64) + 1e-30)
    err = np.abs(np.where(fin, d_port, np.nan) - ref_f)[fin]
    assert (err <= np.broadcast_to(tol, fin.shape)[fin]).all(), (
        f"distances differ by up to {err.max()}, tolerance {tol.min()}")
    # a slot is tied when another slot of the row lies within tol of it, or
    # it is the last slot (an item outside the list may tie it)
    gap = np.abs(ref_f[:, :, None] - ref_f[:, None, :]) <= tol[:, :, None]
    tied = gap.sum(axis=2) > 1
    tied[:, -1] = True
    untied = ~tied & fin
    np.testing.assert_array_equal(i_port[untied], i_ref[untied])
    np.testing.assert_array_equal(i_port[~fin], i_ref[~fin])


def test_sqdist_gathered_matches_jax():
    rng = np.random.default_rng(0)
    r, C, d = 37, 23, 19
    B = rng.normal(size=(r, d)).astype(np.float32)
    Xc = rng.normal(size=(r, C, d)).astype(np.float32)
    b2, c2 = (B * B).sum(1), (Xc * Xc).sum(2)
    got = port.sqdist_gathered(_t(B), _t(Xc), _t(b2), _t(c2)).numpy()
    want = np.asarray(ref.sqdist_gathered(*(jnp.asarray(a) for a in (B, Xc, b2, c2))))
    assert got.shape == (r, C) and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=_RTOL, atol=1e-5)
    # a row against itself is clamped at 0, never negative
    same = port.sqdist_gathered(_t(B), _t(B[:, None, :]), _t(b2), _t(b2[:, None])).numpy()
    assert (same >= 0).all() and same.max() < 1e-4


@pytest.mark.parametrize("metric", sorted(ref.MATMUL_METRICS))
def test_matmul_metric_transform_and_finalize_match_jax(metric):
    rng = np.random.default_rng(1)
    X = np.abs(rng.normal(size=(40, 9))).astype(np.float32)
    np.testing.assert_array_equal(port.preprocess_rows(X, metric),
                                  ref.preprocess_rows(X, metric))
    assert port.metric_kind(metric) == ref.metric_kind(metric) == "matmul"
    d2 = rng.uniform(0.0, 4.0, size=(7, 5)).astype(np.float32)
    got = port.finalize_sqdist(_t(d2), metric).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.finalize_sqdist(jnp.asarray(d2), metric)),
                               rtol=1e-6)


def test_metric_kind_and_hellinger_errors_match_jax():
    with pytest.raises(ValueError, match="not supported") as a:
        port.metric_kind("mahalanobis")
    with pytest.raises(ValueError, match="not supported") as b:
        ref.metric_kind("mahalanobis")
    assert str(a.value) == str(b.value)
    assert port.SUPPORTED_METRICS == ref.SUPPORTED_METRICS
    with pytest.raises(ValueError, match="non-negative"):
        port.preprocess_rows(-np.ones((2, 3)), "hellinger")


_ELEMENTWISE = sorted((m, 2.0) for m in ref.ELEMENTWISE_METRICS) + [
    ("minkowski", 1.5), ("minkowski", 3.0)]


def _metric_inputs(metric, seed=2, n=150, q=33, d=11):
    rng = np.random.default_rng(seed)
    if metric in ("hamming", "jaccard"):
        # few distinct values, many zeros: the set metrics see real sets
        X = rng.integers(0, 3, size=(n, d)).astype(np.float32)
        Q = rng.integers(0, 3, size=(q, d)).astype(np.float32)
    else:
        X = rng.normal(size=(n, d)).astype(np.float32)
        Q = rng.normal(size=(q, d)).astype(np.float32)
    valid = (rng.random(n) > 0.2).astype(np.float32)
    ids = (np.arange(n) * 3 + 7).astype(np.int32)
    return X, valid, ids, Q


@pytest.mark.parametrize("metric,p", _ELEMENTWISE, ids=lambda v: str(v))
@pytest.mark.parametrize("k", [6, 140])
def test_knn_topk_metric_matches_jax(metric, p, k):
    """Every elementwise metric, invalid items (never returned) and, at
    k = 140, more slots than valid items (tails at +inf with id -1); the
    port's tiles are small enough here to fold several item blocks."""
    X, valid, ids, Q = _metric_inputs(metric)
    assert k > valid.sum() or k < 10
    dp, ip = port.knn_topk_metric(_t(X), _t(valid), _t(ids), _t(Q), k=k, metric=metric,
                                  p=p, tile_bytes=8 * 11 * 4 * 16)
    dr, ir = ref.knn_topk_metric(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(ids),
                                 jnp.asarray(Q), k=k, metric=metric, p=p, qblock=16,
                                 iblock=64)
    assert dp.shape == (33, k) and ip.dtype == torch.int32
    assert_same_neighbours(dp.numpy(), ip.numpy(), dr, ir)
    got_ids = ip.numpy()
    assert set(got_ids[got_ids >= 0].tolist()) <= set(ids[valid > 0].tolist())
    if k > valid.sum():
        assert (got_ids[:, int(valid.sum()):] == -1).all()


def test_knn_topk_metric_result_does_not_depend_on_the_tiling():
    X, valid, ids, Q = _metric_inputs("manhattan")
    args = (_t(X), _t(valid), _t(ids), _t(Q))
    a = port.knn_topk_metric(*args, k=9, metric="manhattan")
    b = port.knn_topk_metric(*args, k=9, metric="manhattan", tile_bytes=44 * 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan"])
def test_umap_knn_graph_matches_jax(metric):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(200, 12)).astype(np.float32)
    Q = X[:40] + 0.01 * rng.normal(size=(40, 12)).astype(np.float32)
    if port.metric_kind(metric) == "matmul":
        X, Q = port.preprocess_rows(X, metric), port.preprocess_rows(Q, metric)
    valid = np.ones(200, np.float32)
    ids = np.arange(200, dtype=np.int32)
    dp, ip = port.umap_knn_graph(_t(X), _t(valid), _t(ids), _t(Q), k=8, metric=metric)
    dr, ir = ref.umap_knn_graph(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(ids),
                                jnp.asarray(Q), k=8, metric=metric)
    # the matmul branch's finalization takes a root of the squared
    # distance: its cancellation noise (~1e-6 absolute) shows relatively
    rtol = _RTOL if metric == "manhattan" else 1e-3
    assert_same_neighbours(dp.numpy(), ip.numpy(), dr, ir, rtol=rtol)


def test_umap_knn_graph_over_a_mesh_raises():
    class _Mesh:
        devices = np.zeros((4,))

    X = torch.zeros((4, 2))
    with pytest.raises(NotImplementedError, match="item \\(8\\)"):
        port.umap_knn_graph(X, torch.ones(4), torch.arange(4), X, k=1, metric="manhattan",
                            mesh=_Mesh())
