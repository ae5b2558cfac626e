#
# The port's sparse (ELL) route (spark_rapids_ml_torch/ops/sparse.py, the
# ELL branch of models/classification.py) against the JAX package's on the
# same numpy inputs: the host CSR -> ELL conversion bit for bit (int64
# indices included), the ELL products, moments and scaling within 1e-6
# (float32) and 1e-12 (float64), the atomics-free transpose product against
# the JAX autodiff gradient, the fits in float64 against the JAX package's
# ELL fit (coefficients 1e-8, objective 1e-10, the same iteration count),
# the `enable_sparse_data_optim` decisions, and results independent of the
# gather tiles.  Every JAX float64 call runs inside `jax.enable_x64(True)`.
#
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.classification import LogisticRegression
from spark_rapids_ml_torch.ops import sparse as port_sparse
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR
from spark_rapids_ml_tpu.ops import sparse as jax_sparse
from spark_rapids_ml_tpu.utils import _ArrayBatch as JaxBatch
from spark_rapids_ml_torch.utils import _ArrayBatch


@pytest.fixture(scope="module", autouse=True)
def _x64_flag_unchanged():
    before = jax.config.jax_enable_x64
    yield
    assert jax.config.jax_enable_x64 == before


@pytest.fixture(autouse=True)
def _cpu_and_clean_config():
    set_default_device("cpu")
    port_config.reset_config()
    jax_config.reset_config()
    yield
    port_config.reset_config()
    jax_config.reset_config()
    set_default_device(None)


def _sparse(seed=0, n=300, d=24, density=0.25, classes=2, dtype=np.float64):
    """CSR rows of uneven lengths (some empty) with uneven column scales,
    labels from a noisy linear model, weights."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.3, 4.0, d)
    X[rng.random((n, d)) > density] = 0.0
    X[:3] = 0.0  # empty rows
    W = rng.normal(size=(classes, d))
    scores = X @ W.T + 0.3 * rng.normal(size=(n, classes))
    y = (scores[:, 1] > scores[:, 0]) if classes == 2 else np.argmax(scores, axis=1)
    wt = rng.uniform(0.2, 2.0, n)
    return sp.csr_matrix(X.astype(dtype)), y.astype(np.float64), wt


# ---------------------------------------------------------------------------
# ELL operations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("canonical", [True, False])
def test_ell_from_csr_bit_for_bit(index_dtype, canonical):
    csr, _, _ = _sparse(seed=1)
    if not canonical:
        # duplicates and unsorted columns: both sum them first
        coo = csr.tocoo()
        csr = sp.csr_matrix((np.r_[coo.data, coo.data[:40]], (np.r_[coo.row, coo.row[:40]],
                                                               np.r_[coo.col, coo.col[:40]])),
                            shape=csr.shape)
        csr.has_canonical_format = False
    csr.indices = csr.indices.astype(index_dtype)
    csr.indptr = csr.indptr.astype(index_dtype)
    mine = port_sparse.ell_from_csr(csr.copy())
    ref = jax_sparse.ell_from_csr(csr.copy())
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert mine[1].dtype == np.int32


def _ell(dtype, seed=2, n=200, d=24):
    csr, _, wt = _sparse(seed=seed, n=n, d=d, dtype=dtype)
    vals, cols = port_sparse.ell_from_csr(csr)
    return csr, vals, cols, wt.astype(dtype)


_TOL = {np.float32: dict(rtol=1e-6, atol=1e-6), np.float64: dict(rtol=1e-12, atol=1e-12)}


def _jax(fn, dtype):
    """Run `fn` with x64 on for float64 inputs."""
    if dtype == np.float64:
        with jax.enable_x64(True):
            return np.asarray(fn())
    return np.asarray(fn())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("op", ["matvec", "matmat", "moments", "scale"])
def test_ell_ops_match_jax(op, dtype):
    csr, vals, cols, wt = _ell(dtype)
    d = csr.shape[1]
    rng = np.random.default_rng(3)
    beta = rng.normal(size=d).astype(dtype)
    W = rng.normal(size=(4, d)).astype(dtype)
    tv, tc, tw = torch.from_numpy(vals), torch.from_numpy(cols), torch.from_numpy(wt)
    if op == "matvec":
        mine = port_sparse.ell_matvec(tv, tc, torch.from_numpy(beta)).numpy()
        ref = _jax(lambda: jax_sparse.ell_matvec(jnp.asarray(vals), jnp.asarray(cols),
                                                 jnp.asarray(beta)), dtype)
    elif op == "matmat":
        mine = port_sparse.ell_matmat(tv, tc, torch.from_numpy(W)).numpy()
        ref = _jax(lambda: jax_sparse.ell_matmat(jnp.asarray(vals), jnp.asarray(cols),
                                                 jnp.asarray(W)), dtype)
    elif op == "moments":
        mine = np.stack([t.numpy() for t in port_sparse.ell_weighted_moments(tv, tc, tw, d)])
        ref = _jax(lambda: jnp.stack(jax_sparse.ell_weighted_moments(
            jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(wt), d=d)), dtype)
    else:
        scale = (1.0 / rng.uniform(0.5, 2.0, d)).astype(dtype)
        mine = port_sparse.ell_scale_columns(tv, tc, torch.from_numpy(scale)).numpy()
        ref = _jax(lambda: jax_sparse.ell_scale_columns(jnp.asarray(vals), jnp.asarray(cols),
                                                        jnp.asarray(scale)), dtype)
    # the moments are taken in float64 whatever the rows' type
    assert ref.dtype == dtype and mine.dtype == (np.float64 if op == "moments" else dtype)
    np.testing.assert_allclose(mine, ref, **_TOL[dtype])


@pytest.mark.parametrize("multinomial", [False, True])
def test_transpose_product_matches_jax_autodiff(multinomial):
    """The column-sorted segment sums equal the JAX package's gradient of
    the ELL product (autodiff's scatter-add) and the dense X^T r."""
    csr, vals, cols, _ = _ell(np.float64, seed=4)
    d = csr.shape[1]
    rng = np.random.default_rng(5)
    r = rng.normal(size=(csr.shape[0], 3) if multinomial else csr.shape[0])
    layout = port_sparse.ell_column_layout(torch.from_numpy(vals), torch.from_numpy(cols), d)
    sv = layout.gather(torch.from_numpy(vals))
    if multinomial:
        mine = port_sparse.ell_rmatmat(layout, sv, torch.from_numpy(r)).numpy()
        with jax.enable_x64(True):
            ref = np.asarray(jax.grad(lambda W: (jax_sparse.ell_matmat(
                jnp.asarray(vals), jnp.asarray(cols), W) * r).sum())(jnp.zeros((3, d))))
        dense = r.T @ csr.toarray()
    else:
        mine = port_sparse.ell_rmatvec(layout, sv, torch.from_numpy(r)).numpy()
        with jax.enable_x64(True):
            ref = np.asarray(jax.grad(lambda b: jax_sparse.ell_matvec(
                jnp.asarray(vals), jnp.asarray(cols), b) @ r)(jnp.zeros(d)))
        dense = csr.toarray().T @ r
    np.testing.assert_allclose(mine, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(mine, dense, rtol=1e-12, atol=1e-12)
    # padding (0.0, column 0) and explicit zeros are left out of the layout
    assert int(layout.lengths.sum()) == int((vals != 0).sum())


def test_ell_column_layout_rejects_out_of_range_columns():
    vals = torch.ones((2, 2), dtype=torch.float64)
    cols = torch.tensor([[0, 1], [5, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="beyond"):
        port_sparse.ell_column_layout(vals, cols, 4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_products_independent_of_the_tile(dtype):
    _, vals, cols, _ = _ell(dtype, seed=6, n=257)
    d = int(cols.max()) + 1
    rng = np.random.default_rng(7)
    beta = torch.from_numpy(rng.normal(size=d).astype(dtype))
    W = torch.from_numpy(rng.normal(size=(5, d)).astype(dtype))
    tv, tc = torch.from_numpy(vals), torch.from_numpy(cols)
    whole = (port_sparse.ell_matvec(tv, tc, beta, tile=10**6),
             port_sparse.ell_matmat(tv, tc, W, tile=10**6))
    for tile in (1, 7, 64, None):
        np.testing.assert_array_equal(port_sparse.ell_matvec(tv, tc, beta, tile=tile), whole[0])
        np.testing.assert_array_equal(port_sparse.ell_matmat(tv, tc, W, tile=tile), whole[1])


def test_fit_independent_of_the_tile(monkeypatch):
    csr, y, _ = _sparse(seed=8, classes=3)
    kw = dict(regParam=0.01, float32_inputs=False, maxIter=50, tol=1e-10)
    whole = LogisticRegression(**kw).fit((csr, y))
    monkeypatch.setattr(port_sparse, "_TILE_BYTES", 64)  # one row a tile
    tiled = LogisticRegression(**kw).fit((csr, y))
    np.testing.assert_array_equal(tiled.coef_, whole.coef_)
    np.testing.assert_array_equal(tiled.intercept_, whole.intercept_)


# ---------------------------------------------------------------------------
# Fits against the JAX package's ELL route
# ---------------------------------------------------------------------------

_CASES = {
    "binary": dict(classes=2, kw=dict(regParam=0.01)),
    "multinomial": dict(classes=3, kw=dict(regParam=0.01)),
    "l1": dict(classes=2, kw=dict(regParam=0.02, elasticNetParam=1.0)),
    "elasticnet_multinomial": dict(classes=3, kw=dict(regParam=0.02, elasticNetParam=0.5)),
    "no_standardization": dict(classes=2, kw=dict(regParam=0.01, standardization=False)),
    "weighted": dict(classes=2, kw=dict(regParam=0.01), weighted=True),
    "no_intercept": dict(classes=2, kw=dict(regParam=0.01, fitIntercept=False)),
    "forced_sparse_on_dense": dict(classes=2, kw=dict(regParam=0.01,
                                                      enable_sparse_data_optim=True),
                                   dense=True),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_ell_fit_matches_jax_float64(case):
    """float64: coefficients and intercepts within 1e-8, the objective
    within 1e-10, the same iterations, as the JAX package's ELL fit by its
    host-driven solver (forced by a tiny `dispatch_flops_limit`)."""
    spec = _CASES[case]
    csr, y, wt = _sparse(seed=9, classes=spec["classes"])
    X = csr.toarray() if spec.get("dense") else csr
    kw = dict(spec["kw"], maxIter=100, tol=1e-10, float32_inputs=False)

    def fit(cls, batch_cls):
        est = cls(**kw)
        if spec.get("weighted"):
            # neither package's public API carries weights beside CSR rows:
            # the staged fit with a weighted host batch
            est.setWeightCol("wt")
            staged = est._stage_fit_input(batch_cls(X=X, y=y, weight=wt))
            return est._create_model(est._fit_array(staged))
        return est.fit((X, y))

    mine = fit(LogisticRegression, _ArrayBatch)
    with jax.enable_x64(True):
        jax_config.set_config(dispatch_flops_limit=1.0)
        ref = fit(JaxLR, JaxBatch)
    np.testing.assert_allclose(mine.coefficientMatrix, ref.coefficientMatrix, rtol=0, atol=1e-8)
    np.testing.assert_allclose(mine.interceptVector, ref.interceptVector, rtol=0, atol=1e-8)
    np.testing.assert_allclose(mine.objective, ref.objective, rtol=1e-10)
    assert mine.summary.totalIterations == ref.summary.totalIterations
    assert mine.numClasses == ref.numClasses == spec["classes"]
    if case == "l1":
        np.testing.assert_array_equal(mine.coefficients == 0,
                                      np.abs(np.asarray(ref.coefficients)) < 1e-12)


@pytest.mark.parametrize("classes,standardization", [(2, True), (3, True), (3, False)])
def test_ell_fit_of_float32_rows_is_the_float64_fit(classes, standardization):
    """The ELL oracle evaluates in float64 and scales in the coefficients,
    so float32 rows (exact in float64) follow the float64 rows' fit iterate
    for iterate: the same iterations and objective history, and the
    coefficients equal to their float32 rounding."""
    csr, y, _ = _sparse(seed=12, n=400, classes=classes, dtype=np.float32)
    kw = dict(regParam=1e-3, maxIter=60, tol=1e-8, standardization=standardization)
    f32 = LogisticRegression(**kw).fit((csr, y))
    f64 = LogisticRegression(float32_inputs=False, **kw).fit((csr.astype(np.float64), y))
    assert f32.coef_.dtype == np.float32 and f64.coef_.dtype == np.float64
    assert f32.summary.totalIterations == f64.summary.totalIterations
    np.testing.assert_array_equal(f32.summary.objectiveHistory, f64.summary.objectiveHistory)
    np.testing.assert_array_equal(f32.coef_, f64.coef_.astype(np.float32))


def test_ell_fit_float32_matches_jax_converged():
    """float32: converged fits of both packages' ELL routes agree to the
    float32 rounding of the path (coefficients 2e-3 relative, objective
    1e-5 relative)."""
    csr, y, _ = _sparse(seed=10, dtype=np.float32)
    kw = dict(regParam=0.01, maxIter=300, tol=1e-9)
    mine = LogisticRegression(**kw).fit((csr, y))
    ref = JaxLR(**kw).fit((csr, y))
    assert mine.coef_.dtype == np.float32
    np.testing.assert_allclose(mine.coefficients, np.asarray(ref.coefficients), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(mine.objective, ref.objective, rtol=1e-5)


@pytest.mark.parametrize("option", [None, True, False])
@pytest.mark.parametrize("sparse_input", [True, False])
def test_enable_sparse_data_optim_decisions(option, sparse_input):
    """None keeps CSR sparse and dense dense, True stages both as ELL, False
    densifies: the JAX package's `_use_sparse_kernel`, and the staged
    tensors follow it."""
    csr, y, _ = _sparse(seed=11)
    X = csr if sparse_input else csr.toarray()
    kw = {} if option is None else dict(enable_sparse_data_optim=option)
    mine, ref = LogisticRegression(**kw), JaxLR(**kw)
    want = ref._use_sparse_kernel(JaxBatch(X=X, y=y))
    assert mine._use_sparse_kernel(_ArrayBatch(X=X, y=y)) == want
    assert want == (option is True or (option is None and sparse_input))
    staged = mine._stage_fit_input(_ArrayBatch(X=X, y=y))
    assert ("ell_cols" in staged.extra) == want
    if want:
        vals, cols = port_sparse.ell_from_csr(sp.csr_matrix(X))
        np.testing.assert_array_equal(staged.X.numpy(), vals.astype(np.float32))
        np.testing.assert_array_equal(staged.extra["ell_cols"].numpy(), cols)
    else:
        assert staged.X.shape == X.shape


def test_int64_index_csr_fits_as_int32():
    csr, y, _ = _sparse(seed=12)
    X64 = csr.copy()
    X64.indices = X64.indices.astype(np.int64)
    X64.indptr = X64.indptr.astype(np.int64)
    kw = dict(regParam=1e-3, maxIter=30, float32_inputs=False)
    a = LogisticRegression(**kw).fit((csr, y))
    b = LogisticRegression(**kw).fit((X64, y))
    np.testing.assert_array_equal(a.coef_, b.coef_)
    np.testing.assert_array_equal(a.intercept_, b.intercept_)


def test_csr_transform_matches_dense_and_jax():
    """transform(csr) densifies chunk by chunk (small chunks here): the same
    outputs as the dense rows, and the JAX package's within 1e-12."""
    csr, y, _ = _sparse(seed=13, n=400)
    kw = dict(regParam=0.01, float32_inputs=False, maxIter=50)
    model = LogisticRegression(**kw).fit((csr, y))
    dense = model.transform(csr.toarray())
    port_config.set_config(host_batch_bytes=24 * 8 * 64)
    chunked = model.transform(csr)
    with jax.enable_x64(True):
        jax_config.set_config(dispatch_flops_limit=1.0)
        ref = JaxLR(**kw).fit((csr, y)).transform(csr)
    for col in ("prediction", "probability", "rawPrediction"):
        np.testing.assert_array_equal(chunked[col], dense[col])
        np.testing.assert_allclose(chunked[col], np.asarray(ref[col]), rtol=1e-10, atol=1e-12)


def test_fit_multiple_and_frames_take_the_ell_route():
    """fitMultiple stages the CSR rows as ELL once; a pandas frame of
    sparse rows is not a path to it (dense lists), so it densifies."""
    csr, y, _ = _sparse(seed=14)
    est = LogisticRegression(float32_inputs=False, maxIter=40)
    maps = [{est.regParam: 0.01}, {est.regParam: 0.1}]
    models = dict(est.fitMultiple((csr, y), maps))
    for i, pm in enumerate(maps):
        one = est.copy(pm).fit((csr, y))
        np.testing.assert_array_equal(models[i].coef_, one.coef_)
    df = pd.DataFrame({"features": list(csr.toarray()), "label": y})
    assert not est._use_sparse_kernel(est._extract(df))
