#
# The port's weighted moments and standardization
# (spark_rapids_ml_torch/ops/stats.py) against the JAX package's
# (spark_rapids_ml_tpu/ops/stats.py) on the same numpy inputs, zero-weight
# rows included.  float64 runs JAX inside `jax.enable_x64(True)`, so the
# process-wide x64 flag is never touched (checked at module teardown).
#
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_torch.ops import stats as port_stats
from spark_rapids_ml_tpu.ops import stats as jax_stats


@pytest.fixture(scope="module", autouse=True)
def _x64_flag_unchanged():
    before = jax.config.jax_enable_x64
    yield
    assert jax.config.jax_enable_x64 == before


def _data(dtype, n=517, d=9, seed=0, weighted=True):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * rng.uniform(0.1, 5.0, d) + rng.normal(size=d) * 3)
    X[:, 4] = 2.5  # a constant column: std 0 -> 1
    w = rng.uniform(0.2, 3.0, n) if weighted else np.ones(n)
    w[::11] = 0.0  # zero-weight rows, with features that must not count
    X[::11] = 1e3
    return X.astype(dtype), w.astype(dtype)


# float64: rtol 1e-12 (the two packages sum in another order); float32: 2e-5
_RTOL = {np.float64: 1e-12, np.float32: 2e-5}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("weighted", [True, False])
def test_weighted_moments_and_standardize_match_jax(dtype, weighted, monkeypatch):
    # small chunks, so the centred pass walks several of them
    monkeypatch.setattr(port_stats, "_CHUNK_BYTES", 40 * 9 * np.dtype(dtype).itemsize)
    X, w = _data(dtype, weighted=weighted)
    rtol = _RTOL[dtype]
    with jax.enable_x64(dtype == np.float64):
        jm, js, jw = jax_stats.weighted_moments(jnp.asarray(X), jnp.asarray(w))
        jz = jax_stats.standardize(jnp.asarray(X), jnp.asarray(w), jm, js)
        jm, js, jw, jz = (np.asarray(a) for a in (jm, js, jw, jz))
    Xt, wt = torch.from_numpy(X), torch.from_numpy(w)
    pm, ps, pw = port_stats.weighted_moments(Xt, wt)
    pz = port_stats.standardize(Xt, wt, pm, ps)
    assert pm.dtype == ps.dtype == pz.dtype == Xt.dtype
    np.testing.assert_allclose(pw.numpy(), jw, rtol=rtol)
    np.testing.assert_allclose(pm.numpy(), jm, rtol=rtol, atol=rtol)
    # column 4 is constant: the port takes the mean about a row of the data,
    # so the mean is exact, the std exactly 0 and mapped to 1, and the
    # standardized column 0; the JAX package's weighted sum may leave a
    # rounding residue there (in float32 here: std 2.4e-07, a column of +-1)
    other = np.arange(X.shape[1]) != 4
    assert pm.numpy()[4] == 2.5 and ps.numpy()[4] == 1.0
    assert (pz.numpy()[:, 4] == 0.0).all()
    np.testing.assert_allclose(ps.numpy()[other], js[other], rtol=rtol)
    np.testing.assert_allclose(pz.numpy()[:, other], jz[:, other], rtol=rtol, atol=10 * rtol)
    assert (pz.numpy()[::11] == 0.0).all()  # zero-weight rows zeroed


def test_moments_ignore_zero_weight_rows():
    X, w = _data(np.float64)
    keep = w > 0
    full = port_stats.weighted_moments(torch.from_numpy(X), torch.from_numpy(w))
    kept = port_stats.weighted_moments(torch.from_numpy(X[keep]), torch.from_numpy(w[keep]))
    for a, b in zip(full, kept):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


def test_scale_only_standardize_keeps_zero_mean_rows():
    # the no-intercept fit scales without centring: mean 0 passed in
    X, w = _data(np.float64)
    Xt, wt = torch.from_numpy(X), torch.from_numpy(w)
    _, std, _ = port_stats.weighted_moments(Xt, wt)
    z = port_stats.standardize(Xt, wt, torch.zeros_like(std), std).numpy()
    want = np.where(w[:, None] > 0, X / std.numpy(), 0.0)
    np.testing.assert_array_equal(z, want)
