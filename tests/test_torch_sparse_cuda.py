#
# The ELL route (ops/sparse.py, the ELL branch of LogisticRegression) on
# the card against the same code on the CPU: the ELL products and the
# atomics-free transpose product, an ELL fit in float64 (within 1e-9),
# and two fits on the card bit-equal.  Every test here needs a CUDA device
# and skips without one.  This file imports no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_sparse_cuda.py
#
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.classification import LogisticRegression
from spark_rapids_ml_torch.ops import sparse as ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    set_default_device(None)
    port_config.reset_config()


def _csr(seed, n=20000, d=3000, nnz_row=30, classes=2, dtype=np.float64):
    """Rows of up to `nnz_row` entries in d columns, a skewed column
    popularity, labels from a planted weight vector."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(nnz_row // 2, nnz_row + 1, n)
    indptr = np.r_[0, np.cumsum(lengths)]
    cols = (rng.zipf(1.3, indptr[-1]) - 1) % d
    X = sp.csr_matrix((rng.normal(size=indptr[-1]), cols, indptr), shape=(n, d)).astype(dtype)
    X.sum_duplicates()
    scores = X @ rng.normal(size=(d, classes)) + 0.3 * rng.normal(size=(n, classes))
    return X, np.argmax(scores, axis=1).astype(np.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_products_on_the_card_match_the_cpu(cuda_device, dtype):
    X, _ = _csr(1)
    vals, cols = ops.ell_from_csr(X)
    d = X.shape[1]
    rng = np.random.default_rng(2)
    beta, r = rng.normal(size=d), rng.normal(size=X.shape[0])
    out = []
    for dev in ("cpu", cuda_device):
        v = torch.as_tensor(vals, dtype=dtype, device=dev)
        c = torch.as_tensor(cols, device=dev)
        layout = ops.ell_column_layout(v, c, d)
        m = ops.ell_matvec(v, c, torch.as_tensor(beta, dtype=dtype, device=dev))
        g = ops.ell_rmatvec(layout, layout.gather(v), torch.as_tensor(r, dtype=dtype, device=dev))
        out.append((m.cpu().numpy(), g.cpu().numpy()))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for a, b in zip(out[0], out[1]):
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol * np.abs(a).max())


@pytest.mark.parametrize("classes", [2, 4])
def test_ell_fit_card_matches_cpu_float64(cuda_device, classes):
    X, y = _csr(3, classes=classes)
    kw = dict(regParam=1e-3, maxIter=60, tol=1e-10, float32_inputs=False)
    set_default_device("cpu")
    cpu = LogisticRegression(**kw).fit((X, y))
    set_default_device(cuda_device)
    card = LogisticRegression(**kw).fit((X, y))
    np.testing.assert_allclose(card.coefficientMatrix, cpu.coefficientMatrix, rtol=0, atol=1e-9)
    np.testing.assert_allclose(card.interceptVector, cpu.interceptVector, rtol=0, atol=1e-9)
    np.testing.assert_allclose(card.objective, cpu.objective, rtol=1e-9)


@pytest.mark.parametrize("classes", [2, 4])
def test_two_ell_fits_on_the_card_are_bit_equal(cuda_device, classes):
    """No atomics in the gradient or the moments: the same data gives the
    same model bit for bit."""
    X, y = _csr(4, classes=classes, dtype=np.float32)
    set_default_device(cuda_device)
    kw = dict(regParam=1e-4, maxIter=40)
    a = LogisticRegression(**kw).fit((X, y))
    b = LogisticRegression(**kw).fit((X, y))
    np.testing.assert_array_equal(a.coef_, b.coef_)
    np.testing.assert_array_equal(a.intercept_, b.intercept_)
    assert a.summary.objectiveHistory == b.summary.objectiveHistory
