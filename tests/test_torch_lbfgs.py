#
# The port's host-driven L-BFGS / OWL-QN (spark_rapids_ml_torch/ops/lbfgs.py)
# against the JAX package's `lbfgs_minimize_host`: fed the same numpy
# oracle, the iterates must be equal bit for bit (w, n_iter, converged and
# the objective history).
#
import numpy as np
import pytest

from spark_rapids_ml_torch.ops.lbfgs import lbfgs_minimize_host as port_lbfgs
from spark_rapids_ml_tpu.ops.lbfgs import lbfgs_minimize_host as jax_lbfgs


def _logistic_oracle(seed, n=400, d=7, classes=1, l2=0.01):
    """A float64 numpy (f, g) of a binomial (classes = 1) or softmax
    logistic loss with an intercept per class, theta = [W.ravel(), b]."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, d)
    W_true = rng.normal(size=(max(classes, 1), d))
    if classes == 1:
        y = (X @ W_true[0] + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    else:
        y = np.argmax(X @ W_true.T + 0.3 * rng.normal(size=(n, classes)), axis=1)
    w = rng.uniform(0.5, 1.5, n)
    wsum = w.sum()

    def oracle(theta):
        W = theta[: classes * d].reshape(classes, d)
        b = theta[classes * d:]
        m = X @ W.T + b
        if classes == 1:
            s = 2.0 * y - 1.0
            z = -s * m[:, 0]
            f = (np.logaddexp(0.0, z) * w).sum() / wsum
            r = (-s / (1.0 + np.exp(-z)) * w / wsum)[:, None]
        else:
            lse = np.logaddexp.reduce(m, axis=1)
            f = ((lse - m[np.arange(n), y]) * w).sum() / wsum
            r = np.exp(m - lse[:, None])
            r[np.arange(n), y] -= 1.0
            r *= (w / wsum)[:, None]
        f += 0.5 * l2 * (W * W).sum()
        g = np.concatenate([(r.T @ X + l2 * W).ravel(), r.sum(0)])
        return f, g

    n_param = classes * d + classes
    mask = np.concatenate([np.ones(classes * d), np.zeros(classes)])
    return oracle, n_param, mask


@pytest.mark.parametrize("classes", [1, 4])
@pytest.mark.parametrize("l1", [0.0, 0.02, 0.2])
@pytest.mark.parametrize("max_iter,tol", [(200, 1e-10), (5, 1e-6), (60, 0.0)])
def test_iterates_equal_jax_bit_for_bit(classes, l1, max_iter, tol):
    oracle, n_param, mask = _logistic_oracle(seed=classes, classes=classes)
    kw = dict(max_iter=max_iter, tol=tol, history=10, l1=l1, l1_mask=mask, ls_max=20)
    w0 = np.zeros(n_param)
    pw, pit, pconv, phist = port_lbfgs(oracle, w0, **kw)
    jw, jit, jconv, jhist = jax_lbfgs(oracle, w0, **kw)
    assert pit == jit and pconv == jconv
    np.testing.assert_array_equal(pw, jw)
    assert phist == jhist
    assert len(phist) == pit + 1
    if l1 >= 0.2:
        assert (pw[:-classes] == 0.0).any()  # OWL-QN zeroes coefficients
    assert (pw[-classes:] != 0.0).all()  # intercepts are not penalised


def test_l1_mask_none_and_short_history():
    oracle, n_param, _ = _logistic_oracle(seed=9)
    kw = dict(max_iter=40, tol=1e-9, history=3, l1=0.05, ls_max=4)
    p = port_lbfgs(oracle, np.full(n_param, 0.1), **kw)
    j = jax_lbfgs(oracle, np.full(n_param, 0.1), **kw)
    np.testing.assert_array_equal(p[0], j[0])
    assert p[1:] == j[1:]
