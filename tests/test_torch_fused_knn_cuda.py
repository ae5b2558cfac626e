#
# The hand-written CUDA kernel (spark_rapids_ml_torch/ops/csrc/fused_knn.cu)
# against its plain twin, both on the card, and the exact-kNN entry points
# on the card.  Every test here needs a CUDA device and skips without one.
# This file imports no JAX, so it also runs where JAX is not installed:
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
# q.x in another order; float64 gets its own, far below float32's reach
_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def _assert_matches_twin(d2k, ik, d2t, it):
    fin = torch.isfinite(d2t)
    assert torch.equal(fin, torch.isfinite(d2k)) and torch.equal(ik < 0, it < 0)
    tol = _TOL[d2t.dtype]
    torch.testing.assert_close(d2k[fin], d2t[fin], rtol=tol, atol=tol)
    assert (ik == it).double().mean().item() > 0.999


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
    before = fk.LAUNCHES
    d2k, ik = fk.fused_topk_sqdist(items, v, queries, k)
    d2t, it = fk.fused_topk_sqdist_reference(items, v, queries, k)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == before + 1
    _assert_matches_twin(d2k, ik, d2t, it)


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


def test_nearest_neighbors_on_the_card(cuda_device):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(2000, 32)).astype(np.float32)
    Q = rng.normal(size=(50, 32)).astype(np.float32)
    model = NearestNeighbors(k=8).fit(X)
    before = fk.LAUNCHES
    _, _, on_card = model.kneighbors(Q)
    assert fk.LAUNCHES == before + 1
    assert ko.LAST_KERNEL_DECISION == {"kernel": "fused_knn.cu", "decided_by": "forced"}
    set_default_device("cpu")
    _, _, on_cpu = NearestNeighbors(k=8).fit(X).kneighbors(Q)
    np.testing.assert_array_equal(np.stack(on_card["indices"]), np.stack(on_cpu["indices"]))
    np.testing.assert_allclose(np.stack(on_card["distances"]),
                               np.stack(on_cpu["distances"]), atol=1e-4)
