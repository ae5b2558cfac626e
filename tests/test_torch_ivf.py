#
# The port's IVF-Flat and IVF-PQ (spark_rapids_ml_torch/ops/ivf.py) against
# the JAX package's on the same numpy inputs, on the CPU.  The k-means
# seeding cannot be reproduced across packages, so the JAX package's
# trained centres and codebooks are handed in: the inverted file and the
# codes must then be bit-equal (test_ann.py's blobs, and its skewed
# clusters, where oversized lists split into sub-lists).  Both searches,
# on one index, give equal ids (ties aside) and squared distances within
# 1e-5 relative to the terms the matmul identity cancels, ||q||^2 plus the
# largest ||x||^2 (another summation order of the product); empty lists
# and the k > candidates padding as well.
#
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs
from test_torch_distances import assert_same_neighbours

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.config import reset_config
from spark_rapids_ml_torch.ops import ivf as port
from spark_rapids_ml_tpu.config import reset_config as jax_reset_config
from spark_rapids_ml_tpu.ops import ivf as ref


@pytest.fixture(autouse=True)
def _cpu_and_clean_config():
    set_default_device("cpu")
    reset_config()
    jax_reset_config()
    yield
    reset_config()
    jax_reset_config()
    set_default_device(None)


def _blobs():
    X, _ = make_blobs(n_samples=500, n_features=16, centers=10, random_state=0)
    return X.astype(np.float32)


def _skewed():
    X, _ = make_blobs(n_samples=[2000, 400, 80, 40, 20], n_features=12,
                      cluster_std=[0.5, 1.0, 2.0, 0.3, 3.0], random_state=4)
    return X.astype(np.float32)


_DATA = {"blobs": (_blobs, 16), "skewed": (_skewed, 32)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _terms(Q, X):
    """(q, 1) ||q||^2 + max ||x||^2: the size of what the matmul identity's
    float32 subtraction cancels, the scale of its rounding."""
    return (Q * Q).sum(1, keepdims=True) + (X * X).sum(1).max()


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("data", sorted(_DATA))
def test_inverted_file_bit_equal_from_jax_centres(data):
    make, nlist = _DATA[data]
    X = make()
    want = ref.build_ivfflat(X, nlist)
    got = port.build_ivfflat(X, nlist, centers=want.centers)
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    if data == "skewed":  # the split ran: some parent holds several sub-lists
        assert got.sub_table.shape[1] > 1
        assert set(port.LAST_BUILD) == {"quantizer", "assign", "bucketize"}


@pytest.mark.parametrize("data", sorted(_DATA))
def test_pq_codes_bit_equal_from_jax_codebooks(data):
    make, nlist = _DATA[data]
    X = make()
    want = ref.build_ivfpq(X, nlist // 2, M=4)
    got = port.build_ivfpq(X, nlist // 2, M=4, centers=want.centers,
                           codebooks=want.codebooks)
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


@pytest.mark.parametrize("data", sorted(_DATA))
@pytest.mark.parametrize("nprobe", [1, 4])
def test_search_ivfflat_matches_jax(data, nprobe):
    make, nlist = _DATA[data]
    X = make()
    index = ref.build_ivfflat(X, nlist)
    Q = X[::7]
    dp, ip = port.search_ivfflat(_t(Q), *(_t(a) for a in index), nprobe=nprobe, k=10)
    dr, ir = ref.search_ivfflat(_j(Q), *(_j(a) for a in index), nprobe=nprobe, k=10)
    assert_same_neighbours(dp.numpy(), ip.numpy(), dr, ir, scale=_terms(Q, X))


@pytest.mark.parametrize("data", sorted(_DATA))
@pytest.mark.parametrize("nprobe", [2, 8])
def test_search_ivfpq_matches_jax(data, nprobe):
    make, nlist = _DATA[data]
    X = make()
    index = ref.build_ivfpq(X, nlist // 2, M=4)
    Q = X[::7]
    dp, ip = port.search_ivfpq(_t(Q), *(_t(a) for a in index), nprobe=nprobe, k=12)
    dr, ir = ref.search_ivfpq(_j(Q), *(_j(a) for a in index), nprobe=nprobe, k=12)
    assert_same_neighbours(dp.numpy(), ip.numpy(), dr, ir, scale=_terms(Q, X))


def _far_centres(X, nlist):
    """`nlist` centres: every fourth a real row, the rest far from all
    data (their lists stay empty)."""
    C = np.full((nlist, X.shape[1]), 1e3, np.float32)
    C[::4] = X[: len(C[::4])]
    C[1::4] += np.arange(len(C[1::4]))[:, None]
    return C


@pytest.mark.parametrize("pq", [False, True])
def test_empty_lists_match_jax(pq):
    X = _blobs()
    C = _far_centres(X, 12)
    if pq:
        want = ref.build_ivfpq(X, 12, M=4)
        cb = want.codebooks
        index = port.build_ivfpq(X, 12, M=4, centers=C, codebooks=cb)
        search_p, search_r = port.search_ivfpq, ref.search_ivfpq
    else:
        index = port.build_ivfflat(X, 12, centers=C)
        search_p, search_r = port.search_ivfflat, ref.search_ivfflat
    assert (index.sub_table[1::4] == -1).all()  # the far centres' lists are empty
    Q = X[:40]
    dp, ip = search_p(_t(Q), *(_t(a) for a in index), nprobe=12, k=6)
    dr, ir = search_r(_j(Q), *(_j(a) for a in index), nprobe=12, k=6)
    assert_same_neighbours(dp.numpy(), ip.numpy(), dr, ir, scale=_terms(Q, X))


@pytest.mark.parametrize("pq", [False, True])
def test_k_above_the_candidates_pads_like_jax(pq):
    """nprobe = 1 on small lists: fewer candidates than k, so the tail is
    (inf, -1), and some lists hold fewer rows than their cap."""
    X = _blobs()[:200]
    if pq:
        index = ref.build_ivfpq(X, 16, M=4)
        search_p, search_r = port.search_ivfpq, ref.search_ivfpq
    else:
        index = ref.build_ivfflat(X, 16)
        search_p, search_r = port.search_ivfflat, ref.search_ivfflat
    cap = index.bucket_ids.shape[1]
    max_sub = index.sub_table.shape[1]
    k = cap * max_sub + 5  # above nprobe * max_sub * cap: the kk < k pad
    Q = X[:25]
    dp, ip = search_p(_t(Q), *(_t(a) for a in index), nprobe=1, k=k)
    dr, ir = search_r(_j(Q), *(_j(a) for a in index), nprobe=1, k=k)
    assert dp.shape == (25, k)
    assert (ip.numpy()[:, -5:] == -1).all() and torch.isinf(dp[:, -5:]).all()
    assert_same_neighbours(dp.numpy(), ip.numpy(), dr, ir, scale=_terms(Q, X))


def test_own_training_recall_matches_jax():
    """The port's own k-means: full probe is exact, and partial probe's
    recall is within 0.03 of the JAX package's on the same data."""
    X = _blobs()
    Q = X[:100]
    d2 = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(2)
    truth = np.argsort(d2, axis=1, kind="stable")[:, :8]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / 8 for a, b in zip(np.asarray(ids), truth)])

    got = port.build_ivfflat(X, 16, seed=3)
    want = ref.build_ivfflat(X, 16, seed=3)
    assert got.buckets.shape[1] == want.buckets.shape[1]  # cap depends on n, nlist
    _, full = port.search_ivfflat(_t(Q), *(_t(a) for a in got), nprobe=16, k=8)
    assert recall(full) == 1.0
    _, ip = port.search_ivfflat(_t(Q), *(_t(a) for a in got), nprobe=4, k=8)
    _, ir = ref.search_ivfflat(_j(Q), *(_j(a) for a in want), nprobe=4, k=8)
    assert abs(recall(ip) - recall(ir)) <= 0.03, (recall(ip), recall(ir))


def test_bad_pq_width_raises_like_jax():
    X = _blobs()[:, :15]
    with pytest.raises(ValueError, match="not divisible") as a:
        port.build_ivfpq(X, 4, M=4)
    with pytest.raises(ValueError, match="not divisible") as b:
        ref.build_ivfpq(X, 4, M=4)
    assert str(a.value) == str(b.value)
