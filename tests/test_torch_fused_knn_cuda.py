#
# The hand-written CUDA kernels (spark_rapids_ml_torch/ops/csrc/fused_knn.cu)
# against their plain versions, both on the card, and the exact-kNN entry
# points on the card.  Every test here needs a CUDA device and skips
# without one.  This file imports no JAX, so it also runs where JAX is not
# installed:
#
#     python -m pytest --noconftest -q tests/test_torch_fused_knn_cuda.py
#
import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.knn import NearestNeighbors
from spark_rapids_ml_torch.ops import fused_knn as fk
from spark_rapids_ml_torch.ops import knn as ko

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_default_device("cuda")
    yield torch.device("cuda")
    set_default_device(None)


def _on(device, dtype, *arrays):
    return [torch.as_tensor(a, dtype=dtype, device=device).contiguous() for a in arrays]


# d^2 tolerance (rtol = atol) of the kernel against its twin, which sums
# q.x in another order (and, in float32, in IEEE FMA where the kernel
# takes 3xTF32); float64 gets its own, far below float32's reach
_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def _assert_matches_twin(d2k, ik, d2t, it, min_agree=0.999):
    fin = torch.isfinite(d2t)
    assert torch.equal(fin, torch.isfinite(d2k)) and torch.equal(ik < 0, it < 0)
    tol = _TOL[d2t.dtype]
    torch.testing.assert_close(d2k[fin], d2t[fin], rtol=tol, atol=tol)
    assert (ik == it).double().mean().item() > min_agree


def _assert_ties_where_ids_differ(items, queries, d2t, ik, it):
    """Every slot where kernel and twin name different items holds a tie:
    both items lie at the same float64 distance from the query, within the
    float32 tolerance of the twin's d^2."""
    rows, cols = torch.nonzero(ik != it, as_tuple=True)
    q = queries[rows].double()
    dk = ((items[ik[rows, cols].long()].double() - q) ** 2).sum(1)
    dt = ((items[it[rows, cols].long()].double() - q) ** 2).sum(1)
    assert ((dk - dt).abs() <= 1e-4 * d2t[rows, cols].double().clamp_min(1.0)).all()


def _launches(dtype):
    """Main-kernel launches of the dtype: each type takes its main kernel
    or its small-q kernel by `fk.route`."""
    if dtype == torch.float64:
        return fk.LAUNCHES_F64 + fk.SMALLQ_F64_LAUNCHES
    return fk.LAUNCHES + fk.SMALLQ_LAUNCHES


def _f64_main_route(items, v, queries, k, splits=None):
    """The float64 main-kernel route called directly (the norms pass, the
    DMMA kernel, the merge), whatever `fk.route` takes at this q."""
    if splits is None:
        sms = torch.cuda.get_device_properties(items.device).multi_processor_count
        splits = fk.auto_splits(items.shape[0], queries.shape[0], k, sms, torch.float64)
    parts = fk.fused_knn_f64(items, queries, fk.padded_item_norms(items, v), k, splits)
    return fk.merge_partials(*parts, (queries * queries).sum(dim=1), k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,d,q,k", [(3000, 40, 130, 32), (5000, 24, 66, 1000),
                                     (300, 131, 9, 1), (200, 4100, 7, 5)])
def test_kernel_matches_twin(cuda_device, dtype, n, d, q, k):
    rng = np.random.default_rng(n + k)
    valid = np.ones(n)
    valid[-n // 16 :] = 0.0
    valid[::9] = 0.0
    items, queries, v = _on(cuda_device, dtype, rng.normal(size=(n, d)),
                            rng.normal(size=(q, d)), valid)
    before = _launches(dtype)
    d2k, ik = fk.fused_topk_sqdist(items, v, queries, k)
    d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k)
    torch.cuda.synchronize()
    assert _launches(dtype) == before + 1
    _assert_matches_twin(d2k, ik, d2t, it)


@pytest.mark.parametrize("q", [130, 10001])
@pytest.mark.parametrize("d", [17, 131, 4100])
@pytest.mark.parametrize("k", [1, 32, 1000])
def test_float32_kernel_at_ragged_shapes(cuda_device, q, d, k):
    """q past whole blocks of 128 queries, d past whole 32-float chunks
    (and past the width at which the queries stay in shared memory).  At
    d = 4100 the 1500 items crowd at distances of 8200 +- 180, so a few
    slots in a thousand hold near-ties that the two summation orders break
    differently: every slot that differs must be a tie in float64."""
    rng = np.random.default_rng(q + d + k)
    items, queries, v = _on(cuda_device, torch.float32, rng.normal(size=(1500, d)),
                            rng.normal(size=(q, d)), np.ones(1500))
    d2k, ik = fk.fused_topk_sqdist(items, v, queries, k)
    d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k, bq=2048, bn=1500)
    _assert_matches_twin(d2k, ik, d2t, it, min_agree=0.99)
    _assert_ties_where_ids_differ(items, queries, d2t, ik, it)


def test_float32_kernel_with_fewer_items_than_k(cuda_device):
    rng = np.random.default_rng(4)
    items, queries, v = _on(cuda_device, torch.float32, rng.normal(size=(50, 9)),
                            rng.normal(size=(20, 9)), np.ones(50))
    d2k, ik = fk.fused_topk_sqdist(items, v, queries, 64)
    d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, 64)
    _assert_matches_twin(d2k, ik, d2t, it)
    assert (ik[:, 50:] == -1).all() and torch.isinf(d2k[:, 50:]).all()


@pytest.mark.parametrize("splits", [2, 5, 11])
def test_float32_kernel_split_sweep_at_small_q(cuda_device, splits):
    """S forced above 1 where the wrapper would choose fewer: every split
    count gives the twin's result; k = 300 exceeds a split's items."""
    rng = np.random.default_rng(splits)
    valid = np.ones(2000)
    valid[::5] = 0.0
    items, queries, v = _on(cuda_device, torch.float32, rng.normal(size=(2000, 33)),
                            rng.normal(size=(20, 33)), valid)
    assert fk.split_plan(2000, splits)[1] == splits
    for k in (8, 300):
        d2k, ik = fk.fused_topk_sqdist(items, v, queries, k, splits=splits)
        d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k, splits=splits)
        _assert_matches_twin(d2k, ik, d2t, it)


@pytest.mark.parametrize("splits", [1, 3, 4, 7])
def test_float32_kernel_ties_across_split_boundaries(cuda_device, splits):
    """Integer rows repeated at 256-item strides tie exactly across the
    item splits: the merge must give each tie to the lowest position, slot
    for slot with the twin."""
    rng = np.random.default_rng(7)
    X = np.tile(rng.integers(-3, 4, size=(256, 17)), (4, 1))
    Q = rng.integers(-3, 4, size=(40, 17))
    items, queries, v = _on(cuda_device, torch.float32, X, Q, np.ones(1024))
    for k in (1, 32, 700):
        d2k, ik = fk.fused_topk_sqdist(items, v, queries, k, splits=splits)
        d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k)
        assert torch.equal(ik, it) and torch.equal(d2k, d2t)


@pytest.mark.parametrize("d", [6, 17, 131])
def test_split_kernel_is_bit_exact(cuda_device, d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(777, d)) * 10.0 ** rng.integers(-20, 20, size=(777, d))
    (xt,) = _on(cuda_device, torch.float32, x)
    d_pad = fk.padded_width(d)
    before = fk.SPLIT_LAUNCHES
    out = fk.tf32_split(xt, d_pad)
    assert fk.SPLIT_LAUNCHES == before + 1
    assert torch.equal(out, fk.tf32_split_reference(xt, d_pad))


@pytest.mark.parametrize("splits,k", [(1, 16), (5, 16), (8, 100)])
def test_merge_kernel_is_bit_exact(cuda_device, splits, k):
    """The merge pass on the main kernel's partial lists (with ties across
    them) equals its plain version bit for bit."""
    rng = np.random.default_rng(splits + k)
    X = rng.normal(size=(3000, 40))
    X[1500:] = X[:1500]
    items, queries, v = _on(cuda_device, torch.float32, X, rng.normal(size=(130, 40)),
                            np.ones(3000))
    part_d, part_i = fk.topk_partials(items, v, queries, k, splits)
    assert part_d.shape == (130, splits, k)
    q2 = (queries * queries).sum(dim=1)
    before = fk.MERGE_LAUNCHES
    md, mi = fk.merge_partials(part_d, part_i, q2, k)
    assert fk.MERGE_LAUNCHES == before + 1
    rd, ri = fk.merge_partials_reference(part_d, part_i, q2, k)
    assert torch.equal(mi, ri) and torch.equal(md, rd)


def test_kernel_float64_beyond_float32_precision(cuda_device):
    """Small integers plus multiples of 2^-30 need 32 significant bits:
    float32 rounds the offsets away, so a kernel whose float64 body
    computed in float32 would miss the float64 tolerance by orders."""
    rng = np.random.default_rng(3)

    def beyond_f32(rows, cols):
        return (rng.integers(-3, 4, size=(rows, cols))
                + rng.integers(1, 256, size=(rows, cols)) * 2.0**-30)

    items, queries, v = _on(cuda_device, torch.float64, beyond_f32(1500, 33),
                            beyond_f32(40, 33), np.ones(1500))
    d2k, ik = fk.fused_topk_sqdist(items, v, queries, 16)
    d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, 16)
    _assert_matches_twin(d2k, ik, d2t, it)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_exact_ties_and_tails(cuda_device, dtype):
    """Integer coordinates make every product exact in any order, so the
    kernel must equal the twin slot for slot: duplicated rows tie exactly
    and go to the lower position; k past the valid count gives +inf / -1."""
    rng = np.random.default_rng(0)
    X = rng.integers(-3, 4, size=(700, 19)).astype(np.float64)
    X[350:] = X[:350]
    valid = np.ones(700)
    valid[600:] = 0.0
    Q = rng.integers(-3, 4, size=(45, 19)).astype(np.float64)
    items, queries, v = _on(cuda_device, dtype, X, Q, valid)
    for k in (1, 32, 650):
        d2k, ik = fk.fused_topk_sqdist(items, v, queries, k)
        d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k)
        assert torch.equal(ik, it) and torch.equal(d2k, d2t)
    assert (ik[:, 600:] == -1).all() and torch.isinf(d2k[:, 600:]).all()


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    items = torch.zeros((10, 4), device=cuda_device)
    v = torch.ones(10, device=cuda_device)
    with pytest.raises(ValueError):
        fk.fused_topk_sqdist(items.T.contiguous().T, v, items[:2].contiguous(), 3)
    with pytest.raises(ValueError):
        fk.fused_topk_sqdist(items, v.cpu(), items[:2], 3)
    with pytest.raises(TypeError):
        fk.fused_topk_sqdist(items.half(), v, items[:2].half(), 3)


@pytest.mark.parametrize("dtype,kernel", [(np.float32, "fused_knn_smallq"),
                                          (np.float64, "fused_knn_smallq_f64")])
def test_nearest_neighbors_on_the_card(cuda_device, dtype, kernel):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(2000, 32)).astype(dtype)
    Q = rng.normal(size=(50, 32)).astype(dtype)
    f32 = dtype == np.float32
    model = NearestNeighbors(k=8, float32_inputs=f32).fit(X)
    before = _launches(torch.float32 if f32 else torch.float64)
    _, _, on_card = model.kneighbors(Q)
    assert _launches(torch.float32 if f32 else torch.float64) == before + 1
    assert ko.LAST_KERNEL_DECISION == {"kernel": kernel, "decided_by": "forced"}
    set_default_device("cpu")
    _, _, on_cpu = NearestNeighbors(k=8, float32_inputs=f32).fit(X).kneighbors(Q)
    np.testing.assert_array_equal(np.stack(on_card["indices"]), np.stack(on_cpu["indices"]))
    np.testing.assert_allclose(np.stack(on_card["distances"]),
                               np.stack(on_cpu["distances"]), atol=1e-4)


@pytest.mark.parametrize("q", [130, 10001])
@pytest.mark.parametrize("d", [17, 131, 4100])
@pytest.mark.parametrize("k", [1, 32, 1000])
def test_float64_kernel_at_ragged_shapes(cuda_device, q, d, k):
    """q past whole blocks of 128 queries, odd d (a ragged 32-double chunk)
    and d past the width at which the queries stay in shared memory, k in
    registers and in the scratch."""
    rng = np.random.default_rng(q + d + k + 1)
    valid = np.ones(1500)
    valid[::11] = 0.0
    items, queries, v = _on(cuda_device, torch.float64, rng.normal(size=(1500, d)),
                            rng.normal(size=(q, d)), valid)
    before = (fk.LAUNCHES_F64, fk.MERGE_LAUNCHES)
    d2k, ik = _f64_main_route(items, v, queries, k)
    d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k, bq=2048, bn=1500)
    torch.cuda.synchronize()
    assert (fk.LAUNCHES_F64, fk.MERGE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _assert_matches_twin(d2k, ik, d2t, it)


@pytest.mark.parametrize("splits", [2, 5, 11])
def test_float64_kernel_split_sweep_at_small_q(cuda_device, splits):
    rng = np.random.default_rng(splits + 100)
    valid = np.ones(2000)
    valid[::5] = 0.0
    items, queries, v = _on(cuda_device, torch.float64, rng.normal(size=(2000, 33)),
                            rng.normal(size=(20, 33)), valid)
    assert fk.split_plan(2000, splits)[1] == splits
    for k in (8, 300):
        d2k, ik = _f64_main_route(items, v, queries, k, splits)
        d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k, splits=splits)
        _assert_matches_twin(d2k, ik, d2t, it)


@pytest.mark.parametrize("splits", [1, 3, 4, 7])
def test_float64_kernel_ties_across_split_boundaries(cuda_device, splits):
    """Integer rows repeated at 256-item strides tie exactly across the
    item splits, and the splits share only k-th SCORES: a tie with the
    shared bound must be kept, so the lowest position wins slot for slot."""
    rng = np.random.default_rng(8)
    X = np.tile(rng.integers(-3, 4, size=(256, 17)), (4, 1))
    Q = rng.integers(-3, 4, size=(40, 17))
    items, queries, v = _on(cuda_device, torch.float64, X, Q, np.ones(1024))
    for k in (1, 32, 700):
        d2k, ik = _f64_main_route(items, v, queries, k, splits)
        d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k)
        assert torch.equal(ik, it) and torch.equal(d2k, d2t)


@pytest.mark.parametrize("splits,k", [(1, 32), (5, 32), (8, 100)])
def test_float64_main_kernel_matches_its_plain_version(cuda_device, splits, k):
    """The (q, S, k) partial lists against `fused_knn_f64_reference`, both
    merged: past the merged top-k a split's list depends on block order."""
    rng = np.random.default_rng(splits * k)
    valid = np.ones(3000)
    valid[::7] = 0.0
    items, queries, v = _on(cuda_device, torch.float64, rng.normal(size=(3000, 40)),
                            rng.normal(size=(130, 40)), valid)
    xs = fk.padded_item_norms(items, v)
    part_d, part_i = fk.fused_knn_f64(items, queries, xs, k, splits)
    pd, pi = fk.fused_knn_f64_reference(items, xs, queries, k, splits)
    assert part_d.shape == pd.shape == (130, splits, k)
    q2 = (queries * queries).sum(dim=1)
    _assert_matches_twin(*fk.merge_partials_reference(part_d, part_i, q2, k),
                         *fk.merge_partials_reference(pd, pi, q2, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("splits,k", [(5, 32), (8, 100), (32, 1000)])
def test_merge_kernel_is_bit_exact_in_both_types(cuda_device, dtype, splits, k):
    """The merge pass on the main kernels' partial lists (duplicated rows
    tie across the lists, and the shared bound cuts lists short) equals its
    plain version bit for bit; k > 32 takes the kernel with one thread per
    entry, a row of 32,000 entries at (32, 1000)."""
    rng = np.random.default_rng(splits + k + 1)
    n = max(3000, splits * 16 * 64)
    X = rng.normal(size=(n, 24))
    X[n // 2 :] = X[: n - n // 2]
    items, queries, v = _on(cuda_device, dtype, X, rng.normal(size=(40, 24)), np.ones(n))
    if dtype == torch.float64:
        part_d, part_i = fk.fused_knn_f64(items, queries, fk.padded_item_norms(items, v), k,
                                          splits)
    else:
        part_d, part_i = fk.topk_partials(items, v, queries, k, splits)
    assert part_d.shape == (40, splits, k)
    q2 = (queries * queries).sum(dim=1)
    before = fk.MERGE_LAUNCHES
    md, mi = fk.merge_partials(part_d, part_i, q2, k)
    assert fk.MERGE_LAUNCHES == before + 1
    rd, ri = fk.merge_partials_reference(part_d, part_i, q2, k)
    assert torch.equal(mi, ri) and torch.equal(md, rd)


def test_float64_route_has_no_fallback(cuda_device):
    """A float64 CUDA tensor a float64 kernel does not take raises; nothing
    gives way to the plain version."""
    items = torch.zeros((10, 4), dtype=torch.float64, device=cuda_device)
    v = torch.ones(10, dtype=torch.float64, device=cuda_device)
    xs = fk.padded_item_norms(items, v)
    with pytest.raises(ValueError):
        fk.fused_knn_f64(items, items[:, :3].contiguous(), xs, 3, 1)
    with pytest.raises(ValueError):
        fk.fused_knn_smallq_f64(items, v, items[:2, :3].contiguous(), 3, 1)
    with pytest.raises(ValueError):
        fk.fused_knn_smallq_f64(items, v, items[:2], 33, 1)
    with pytest.raises(ValueError):
        fk.fused_knn_smallq_f64(items, v.float(), items[:2], 3, 1)
    with pytest.raises(TypeError):
        fk.merge_partials(torch.zeros((2, 1, 3), dtype=torch.float64, device=cuda_device),
                          torch.zeros((2, 1, 3), dtype=torch.int32, device=cuda_device),
                          torch.zeros(2, device=cuda_device), 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("q,splits,k", [(40, 5, 32), (7, 3, 33), (40, 8, 100), (40, 32, 1000),
                                        (3000, 5, 32)])
def test_merge_kernel_on_lists_that_end_early(cuda_device, dtype, q, splits, k):
    """Sorted lists with scores that tie within and across lists, a quarter
    of them cut short (+inf, -1): the empty slots of several lists tie with
    each other, and the merged row must still fill every slot past its real
    entries with +inf and -1, bit for bit as the plain version."""
    import compare_kernels

    gen = torch.Generator(device=cuda_device).manual_seed(q + splits + k)
    part_d, part_i, q2 = compare_kernels.partial_lists(q, splits, k, dtype, cuda_device, gen)
    assert (part_i < 0).any()
    md, mi = fk.merge_partials(part_d, part_i, q2, k)
    rd, ri = fk.merge_partials_reference(part_d, part_i, q2, k)
    assert torch.equal(mi, ri) and torch.equal(md, rd)


# ---- the small-q kernel ---------------------------------------------------------


def _smallq_cases():
    import chip_smoke

    return chip_smoke.smallq_cases(0)


@pytest.mark.parametrize("case", range(len(_smallq_cases())))
def test_smallq_kernel_matches_its_plain_version(cuda_device, case):
    """chip_smoke.py's phase 2 cases of the small-q kernel: ragged n,
    invalid items, d = 6, 17, 33, 130, q = 1, 7, 64 and 100, k = 1, 5, 32,
    forced splits, exact ties, signed zeros and tails.  Each side's lists
    merged: every finite d^2 within 1e-4 * max(1, d^2) and every differing
    id a tie (exact cases bit for bit)."""
    import chip_smoke

    name, X, v, Q, k, exact, splits = _smallq_cases()[case]
    items, valid, queries = _on(cuda_device, torch.float32, X, v, Q)
    s = splits or fk.smallq_splits(len(X), len(Q), fk.smallq_wave(cuda_device, len(Q)))
    before = fk.SMALLQ_LAUNCHES
    part_d, part_i = fk.fused_knn_smallq(items, valid, queries, k, s)
    assert fk.SMALLQ_LAUNCHES == before + 1
    pd, pi = fk.fused_knn_smallq_reference(items, valid, queries, k, s)
    assert part_d.shape == pd.shape
    q2 = (queries * queries).sum(dim=1)
    chip_smoke.compare_ties_aside(name, *fk.merge_partials(part_d, part_i, q2, k),
                                  *fk.merge_partials_reference(pd, pi, q2, k), X, Q, exact)


@pytest.mark.parametrize("d", [64, 130])
@pytest.mark.parametrize("q", [1, 8, 64])
def test_smallq_route_matches_the_tf32_route(cuda_device, q, d):
    """The route (small-q kernel + merge) against the 3xTF32 route on the
    same queries: ids equal except at ties, d^2 within 1e-4."""
    import chip_smoke

    rng = np.random.default_rng(q + d)
    X, Q = rng.normal(size=(20_000, d)), rng.normal(size=(q, d))
    items, queries, v = _on(cuda_device, torch.float32, X, Q, np.ones(20_000))
    for k in (1, 32):
        assert fk.route(q, k, torch.float32) == "fused_knn_smallq"
        before = (fk.SMALLQ_LAUNCHES, fk.LAUNCHES)
        kd, ki = fk.fused_topk_sqdist(items, v, queries, k)
        assert (fk.SMALLQ_LAUNCHES, fk.LAUNCHES) == (before[0] + 1, before[1])
        td, ti = fk.merge_partials(*fk.topk_partials(items, v, queries, k, 4),
                                   (queries * queries).sum(dim=1), k)
        chip_smoke.compare_ties_aside(f"q={q} d={d} k={k}", kd, ki, td, ti, X, Q, exact=False)


def test_smallq_kernel_repeats(cuda_device):
    """One launch repeated: with one split the partial lists are bit-equal
    (no other block shares the row's k-th key); with the wrapper's splits a
    list past the row's merged top-k depends on the order the blocks ran,
    and the merged lists are bit-equal."""
    rng = np.random.default_rng(11)
    items, queries, v = _on(cuda_device, torch.float32, rng.normal(size=(50_000, 96)),
                            rng.normal(size=(8, 96)), np.ones(50_000))
    q2 = (queries * queries).sum(dim=1)
    a = fk.fused_knn_smallq(items, v, queries, 32, 1)
    b = fk.fused_knn_smallq(items, v, queries, 32, 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    s = fk.smallq_splits(50_000, 8, fk.smallq_wave(cuda_device, 8))
    ma = fk.merge_partials(*fk.fused_knn_smallq(items, v, queries, 32, s), q2, 32)
    mb = fk.merge_partials(*fk.fused_knn_smallq(items, v, queries, 32, s), q2, 32)
    assert torch.equal(ma[0], mb[0]) and torch.equal(ma[1], mb[1])


def test_route_takes_the_kernel_its_rule_names(cuda_device):
    """q <= _SMALL_Q and k <= 32 launch the small-q kernel, one query more
    or k = 33 the 3xTF32 kernel; the results agree with the twin."""
    rng = np.random.default_rng(5)
    items, v = _on(cuda_device, torch.float32, rng.normal(size=(3000, 20)), np.ones(3000))
    for q, k, kernel in ((fk._SMALL_Q, 32, "fused_knn_smallq"),
                         (fk._SMALL_Q + 1, 32, "fused_knn_tf32"), (5, 33, "fused_knn_tf32")):
        (queries,) = _on(cuda_device, torch.float32, rng.normal(size=(q, 20)))
        before = (fk.SMALLQ_LAUNCHES, fk.LAUNCHES)
        d2k, ik = fk.fused_topk_sqdist(items, v, queries, k)
        small = kernel == "fused_knn_smallq"
        assert (fk.SMALLQ_LAUNCHES, fk.LAUNCHES) == (before[0] + small, before[1] + (not small))
        assert fk.route(q, k, torch.float32) == kernel
        d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k)
        _assert_matches_twin(d2k, ik, d2t, it, min_agree=0.99)
        _assert_ties_where_ids_differ(items, queries, d2t, ik, it)


def test_smallq_kernel_rejects_what_it_does_not_take(cuda_device):
    """A CUDA tensor the kernel does not take raises; nothing gives way to
    the plain version."""
    items = torch.zeros((300, 8), device=cuda_device)
    v = torch.ones(300, device=cuda_device)
    with pytest.raises(ValueError):
        fk.fused_knn_smallq(items.double(), v.double(), items[:2].double(), 3, 1)
    with pytest.raises(ValueError):
        fk.fused_knn_smallq(items, v, items[:2], 33, 1)
    with pytest.raises(ValueError):
        fk.fused_knn_smallq(items, v, items[:2, :4], 3, 1)


# ---- the float64 small-q kernel -------------------------------------------------


@pytest.mark.parametrize("case", range(len(_smallq_cases())))
def test_smallq_f64_kernel_matches_its_plain_version(cuda_device, case):
    """chip_smoke.py's phase 2 cases in float64: ragged n, invalid items,
    d = 6, 17, 33, 130 (odd widths take 8-byte copies), q = 1, 7, 64 and
    100 (several 32-query blocks), k = 1, 5, 32, forced splits, exact ties,
    signed zeros and tails.  Each side's lists merged: every finite d^2
    within 1e-10 * max(1, d^2) and every differing id a tie (exact cases
    bit for bit)."""
    import chip_smoke

    name, X, v, Q, k, exact, splits = _smallq_cases()[case]
    items, valid, queries = _on(cuda_device, torch.float64, X, v, Q)
    s = splits or fk.smallq_splits(len(X), len(Q),
                                   fk.smallq_wave(cuda_device, len(Q), torch.float64),
                                   fk._SQ_QBLOCK_F64)
    before = fk.SMALLQ_F64_LAUNCHES
    part_d, part_i = fk.fused_knn_smallq_f64(items, valid, queries, k, s)
    assert fk.SMALLQ_F64_LAUNCHES == before + 1
    pd, pi = fk.fused_knn_smallq_reference(items, valid, queries, k, s)
    assert part_d.shape == pd.shape and part_d.dtype == torch.float64
    q2 = (queries * queries).sum(dim=1)
    chip_smoke.compare_ties_aside(name, *fk.merge_partials(part_d, part_i, q2, k),
                                  *fk.merge_partials_reference(pd, pi, q2, k), X, Q, exact)


@pytest.mark.parametrize("splits", [1, 2, 5, 11, 40])
def test_smallq_f64_kernel_split_sweep(cuda_device, splits):
    """Every split count gives the plain version's merged result (ragged
    n, invalid items; 40 splits of a single 256-item tile each)."""
    rng = np.random.default_rng(splits + 190)
    valid = np.ones(10_000)
    valid[::5] = 0.0
    items, queries, v = _on(cuda_device, torch.float64, rng.normal(size=(10_000, 33)),
                            rng.normal(size=(20, 33)), valid)
    q2 = (queries * queries).sum(dim=1)
    for k in (1, 8, 32):
        part_d, part_i = fk.fused_knn_smallq_f64(items, v, queries, k, splits)
        assert part_d.shape[1] == fk.split_plan(10_000, splits, 256)[1]
        pd, pi = fk.fused_knn_smallq_reference(items, v, queries, k, splits)
        _assert_matches_twin(*fk.merge_partials(part_d, part_i, q2, k),
                             *fk.merge_partials_reference(pd, pi, q2, k))


@pytest.mark.parametrize("splits", [1, 3, 4, 7])
def test_smallq_f64_kernel_ties_across_split_boundaries(cuda_device, splits):
    """Integer rows repeated at 256-item strides tie exactly across the
    item splits, and the splits share only k-th SCORES: a tie with the
    shared bound must be kept, so the route equals the twin slot for slot."""
    rng = np.random.default_rng(9)
    X = np.tile(rng.integers(-3, 4, size=(256, 17)), (4, 1))
    Q = rng.integers(-3, 4, size=(40, 17))
    items, queries, v = _on(cuda_device, torch.float64, X, Q, np.ones(1024))
    for k in (1, 5, 32):
        assert fk.route(40, k, torch.float64) == "fused_knn_smallq_f64"
        before = fk.SMALLQ_F64_LAUNCHES
        d2k, ik = fk.fused_topk_sqdist(items, v, queries, k, splits=splits)
        assert fk.SMALLQ_F64_LAUNCHES == before + 1
        d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k)
        assert torch.equal(ik, it) and torch.equal(d2k, d2t)


@pytest.mark.parametrize("d", [64, 130])
@pytest.mark.parametrize("q", [1, 8, 64])
def test_smallq_f64_route_matches_the_main_kernel_route(cuda_device, q, d):
    """The float64 route (small-q kernel + merge) against the float64 main
    kernel's route on the same queries: ids equal except at ties, d^2
    within 1e-10; the route launches the small-q kernel and not the main
    one."""
    import chip_smoke

    rng = np.random.default_rng(q + d + 190)
    X, Q = rng.normal(size=(20_000, d)), rng.normal(size=(q, d))
    items, queries, v = _on(cuda_device, torch.float64, X, Q, np.ones(20_000))
    for k in (1, 32):
        assert fk.route(q, k, torch.float64) == "fused_knn_smallq_f64"
        before = (fk.SMALLQ_F64_LAUNCHES, fk.LAUNCHES_F64)
        kd, ki = fk.fused_topk_sqdist(items, v, queries, k)
        assert (fk.SMALLQ_F64_LAUNCHES, fk.LAUNCHES_F64) == (before[0] + 1, before[1])
        td, ti = _f64_main_route(items, v, queries, k, 4)
        chip_smoke.compare_ties_aside(f"q={q} d={d} k={k}", kd, ki, td, ti, X, Q, exact=False)


def test_smallq_f64_kernel_repeats(cuda_device):
    """One launch repeated: with one split the partial lists are bit-equal;
    with the wrapper's splits the merged lists are bit-equal."""
    rng = np.random.default_rng(12)
    items, queries, v = _on(cuda_device, torch.float64, rng.normal(size=(50_000, 96)),
                            rng.normal(size=(8, 96)), np.ones(50_000))
    q2 = (queries * queries).sum(dim=1)
    a = fk.fused_knn_smallq_f64(items, v, queries, 32, 1)
    b = fk.fused_knn_smallq_f64(items, v, queries, 32, 1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    s = fk.smallq_splits(50_000, 8, fk.smallq_wave(cuda_device, 8, torch.float64),
                         fk._SQ_QBLOCK_F64)
    ma = fk.merge_partials(*fk.fused_knn_smallq_f64(items, v, queries, 32, s), q2, 32)
    mb = fk.merge_partials(*fk.fused_knn_smallq_f64(items, v, queries, 32, s), q2, 32)
    assert torch.equal(ma[0], mb[0]) and torch.equal(ma[1], mb[1])


def test_float64_route_takes_the_kernel_its_rule_names(cuda_device):
    """q <= _SMALL_Q_F64 and k <= 32 launch the float64 small-q kernel, one
    query more or k = 33 the float64 main kernel; the results agree with
    the twin."""
    rng = np.random.default_rng(6)
    items, v = _on(cuda_device, torch.float64, rng.normal(size=(3000, 20)), np.ones(3000))
    for q, k, kernel in ((fk._SMALL_Q_F64, 32, "fused_knn_smallq_f64"),
                         (fk._SMALL_Q_F64 + 1, 32, "fused_knn_f64"), (5, 33, "fused_knn_f64")):
        (queries,) = _on(cuda_device, torch.float64, rng.normal(size=(q, 20)))
        before = (fk.SMALLQ_F64_LAUNCHES, fk.LAUNCHES_F64)
        d2k, ik = fk.fused_topk_sqdist(items, v, queries, k)
        small = kernel == "fused_knn_smallq_f64"
        assert (fk.SMALLQ_F64_LAUNCHES, fk.LAUNCHES_F64) == (before[0] + small,
                                                             before[1] + (not small))
        assert fk.route(q, k, torch.float64) == kernel
        d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k)
        _assert_matches_twin(d2k, ik, d2t, it)
