#
# The port's PCA (spark_rapids_ml_torch/ops/pca.py, models/feature.py)
# against the JAX package's on the same numpy inputs, on the CPU: the full
# and randomized solvers (with JAX's sketch handed in, and with the port's
# own), the host finaliser, the solver dispatch, the estimator from numpy,
# pandas and a DeviceDataset with the fused pass off and on, transform,
# save/load in both directions, convert.py, and what raises.  Data have a
# clear spectral gap: components are defined only up to rotation within
# equal eigenvalues.  Every JAX float64 call runs inside
# `jax.enable_x64(True)` (the flag is checked at module teardown).
#
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_torch import DeviceDataset, set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import fused as port_fused
from spark_rapids_ml_torch.convert import (
    model_params,
    pca_model_from_reference,
    pca_model_to_reference_attributes,
)
from spark_rapids_ml_torch.feature import PCA, PCAModel
from spark_rapids_ml_torch.ops import pca as port_pca
from spark_rapids_ml_tpu import DeviceDataset as JaxDeviceDataset
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu.core import _ReadWriteMixin as JaxReadWrite
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.feature import PCAModel as JaxPCAModel
from spark_rapids_ml_tpu.ops import pca as jax_pca

# three leading directions far above the rest
_SCALES = np.array([10.0, 8.0, 6.0, 0.3, 0.25, 0.2, 0.15, 0.12, 0.1, 0.08, 0.06, 0.05])


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


def _data(seed=0, n=2000, d=12):
    """Rows with a clear spectral gap after a random rotation and offset,
    and sample weights in [0.2, 2)."""
    rng = np.random.default_rng(seed)
    R, _ = np.linalg.qr(rng.normal(size=(d, d)))
    X = (rng.normal(size=(n, d)) * _SCALES[:d]) @ R + rng.normal(size=d) * 3.0
    return X, rng.uniform(0.2, 2.0, n)


def _padded(X, w, pad=37):
    """X and w with `pad` rows of weight 0 and large values appended."""
    junk = np.full((pad, X.shape[1]), 1e3)
    return np.vstack([X, junk]), np.concatenate([w, np.zeros(pad)])


def _tol(dtype):
    return 1e-10 if dtype == np.float64 else 1e-4


def _assert_outputs_close(got, want, dtype, ev_rtol=None):
    """The five outputs (mean, components, ev, ratio, singular values)."""
    tol = _tol(dtype)
    ev_rtol = ev_rtol or tol
    names = ("mean", "components", "explained_variance", "ratio", "singular_values")
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        if name in ("mean", "components"):
            np.testing.assert_allclose(a, b, atol=tol * max(1.0, np.abs(b).max()), err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=ev_rtol, err_msg=name)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# ops/pca.py against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("weighted", [True, False])
def test_pca_fit_matches_jax(dtype, weighted):
    """All five outputs, with weighted rows and padded rows of weight 0:
    1e-10 in float64, 1e-4 in float32."""
    X, w = _data(seed=1)
    if not weighted:
        w = np.ones_like(w)
    X, w = _padded(X, w)
    X, w = X.astype(dtype), w.astype(dtype)
    got = port_pca.pca_fit(torch.from_numpy(X), torch.from_numpy(w), 3)
    with jax.enable_x64(dtype == np.float64):
        want = [np.asarray(a) for a in jax_pca.pca_fit(jnp.asarray(X), jnp.asarray(w), 3)]
    assert all(t.dtype == getattr(torch, np.dtype(dtype).name) for t in got)
    _assert_outputs_close([_np(t) for t in got], want, dtype)


@pytest.mark.parametrize("power_iters", [0, 2])
def test_pca_fit_randomized_with_jax_sketch(power_iters):
    """JAX's Omega (jax.random.normal(PRNGKey(0))) handed in: 1e-10."""
    X, w = _padded(*_data(seed=2))
    k, l = 3, 6
    with jax.enable_x64(True):
        omega = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (X.shape[1], l), jnp.float64))
        want = [np.asarray(a) for a in jax_pca.pca_fit_randomized(
            jnp.asarray(X), jnp.asarray(w), k, l, power_iters)]
    got = port_pca.pca_fit_randomized(torch.from_numpy(X), torch.from_numpy(w), k, l,
                                      power_iters, omega=omega)
    _assert_outputs_close([_np(t) for t in got], want, np.float64)


def test_pca_fit_randomized_own_sketch_finds_jax_subspace():
    """The port's own Omega (numpy's default_rng(0)): the subspace (every
    principal-angle cosine) and the explained variance within 1e-8 of
    JAX's, on data with a gap."""
    X, w = _data(seed=3)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jax_pca.pca_fit_randomized(
            jnp.asarray(X), jnp.asarray(w), 3, 6, 2)]
    got = [_np(t) for t in port_pca.pca_fit_randomized(
        torch.from_numpy(X), torch.from_numpy(w), 3, 6, 2)]
    cosines = np.linalg.svd(got[1] @ want[1].T, compute_uv=False)
    np.testing.assert_allclose(cosines, 1.0, atol=1e-8)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-8)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-8)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_array_equal(port_pca.sketch(12, 6),
                                  np.random.default_rng(0).standard_normal((12, 6)))


def test_pca_attrs_from_projected_matches_jax():
    rng = np.random.default_rng(4)
    d, l, k = 9, 5, 3
    Q, _ = np.linalg.qr(rng.normal(size=(d, l)))
    A = rng.normal(size=(400, d)) * np.linspace(3, 0.2, d)
    SQ = A.T @ (A @ Q)
    s1, ssq = A.sum(0), (A * A).sum(0)
    got = port_pca.pca_attrs_from_projected(Q, SQ, s1, ssq, 400.0, k)
    want = jax_pca.pca_attrs_from_projected(Q, SQ, s1, ssq, 400.0, k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


_GRID = [(d, k, streamed, mode) for d in (8, 64, 207, 208, 831, 832, 3000) for k in (1, 3, 10)
         for streamed in (False, True) for mode in ("auto", "full", "randomized")]


@pytest.mark.parametrize("oversamples,power_iters", [(10, 2), (3, 0)])
def test_resolve_pca_solver_matches_jax(oversamples, power_iters):
    for cfg in (port_config, jax_config):
        cfg.set_config(pca_oversamples=oversamples, pca_power_iters=power_iters)
    for d, k, streamed, mode in _GRID:
        port_config.set_config(pca_solver=mode)
        jax_config.set_config(pca_solver=mode)
        assert port_pca.resolve_pca_solver(d, k, streamed) == jax_pca.resolve_pca_solver(
            d, k, streamed), (d, k, streamed, mode)
        mine = {a: b for a, b in port_pca.LAST_SOLVER_DECISION.items() if a != "stamp"}
        ref = {a: b for a, b in dict(jax_pca.LAST_SOLVER_DECISION).items() if a != "stamp"}
        assert mine == ref


def test_resolve_pca_solver_rejects_unknown_mode():
    port_config.set_config(pca_solver="svd")
    with pytest.raises(ValueError, match="pca_solver"):
        port_pca.resolve_pca_solver(10, 2)


def test_svd_flip_torch_and_numpy_match_jax():
    C = np.array([[0.1, -0.9, 0.3], [0.5, 0.2, -0.1], [0.0, 0.0, 0.0], [-0.4, 0.4, 0.1]])
    want = np.asarray(jax_pca._svd_flip(jnp.asarray(C, jnp.float32)))
    np.testing.assert_array_equal(port_pca._svd_flip(torch.from_numpy(C.astype(np.float32))).numpy(),
                                  want)
    np.testing.assert_array_equal(port_pca._svd_flip(C, xp=np), jax_pca._svd_flip(C, xp=np))


def test_pca_transform_matches_jax():
    X, _ = _data(seed=5, n=100)
    comps = np.random.default_rng(0).normal(size=(3, 12))
    with jax.enable_x64(True):
        want = np.asarray(jax_pca.pca_transform(jnp.asarray(X), jnp.asarray(comps)))
    np.testing.assert_allclose(port_pca.pca_transform(torch.from_numpy(X),
                                                      torch.from_numpy(comps)).numpy(),
                               want, rtol=1e-13, atol=1e-12)


# ---------------------------------------------------------------------------
# The estimator against the JAX package
# ---------------------------------------------------------------------------


def _inputs(source, X, w, dtype, package):
    """(dataset, setInputCol argument) for `source`."""
    if source == "numpy":
        return X, "features"
    if source == "pandas":
        return pd.DataFrame({"features": list(X)}), "features"
    if source == "pandas_cols":
        cols = [f"c{i}" for i in range(X.shape[1])]
        return pd.DataFrame(dict(zip(cols, X.T))), cols
    dd = DeviceDataset if package == "port" else JaxDeviceDataset
    return dd.from_host(X, weight=w, dtype=dtype), "features"


@pytest.mark.parametrize("source", ["numpy", "pandas", "pandas_cols", "device_weighted"])
@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("solver", ["full", "randomized"])
def test_estimator_matches_jax_float64(source, fused, solver):
    """float64 (float32_inputs=False) fits of the same data: 1e-10, except
    the two-phase randomized solver, whose sketches differ (1e-8 on the
    subspace and the variances); then transform outputs within 1e-10
    relative of JAX's.  A DeviceDataset never takes the fused pass."""
    X, w = _data(seed=6)
    for cfg in (port_config, jax_config):
        cfg.set_config(fused_stage_solve=fused, pca_solver=solver, pca_oversamples=3)
    data, col = _inputs(source, X, w, np.float64, "port")
    stamp = port_fused.FUSED_METRICS.get("stamp")
    port_fused.FUSED_METRICS.clear()
    mine = PCA(k=3, float32_inputs=False).setInputCol(col).setOutputCol("pcs").fit(data)
    took_fused = bool(port_fused.FUSED_METRICS)
    assert took_fused == (fused == "on" and source != "device_weighted"), stamp
    assert port_pca.LAST_SOLVER_DECISION["solver"] == solver
    with jax.enable_x64(True):
        jdata, _ = _inputs(source, X, w, np.float64, "jax")
        ref = JaxPCA(k=3, float32_inputs=False).setInputCol(col).setOutputCol("pcs").fit(jdata)
    assert mine.components_.dtype == np.float64 and mine.n_cols == 12 and mine.dtype == "float64"
    same_sketch = solver == "full" or took_fused
    tol = 1e-10 if same_sketch else 1e-8
    np.testing.assert_allclose(mine.mean_, ref.mean_, atol=1e-10 * np.abs(ref.mean_).max())
    cosines = np.linalg.svd(mine.components_ @ ref.components_.T, compute_uv=False)
    np.testing.assert_allclose(cosines, 1.0, atol=tol)
    if same_sketch:
        np.testing.assert_allclose(mine.components_, ref.components_, atol=tol)
    for attr in ("explained_variance_", "explained_variance_ratio_", "singular_values_"):
        np.testing.assert_allclose(getattr(mine, attr), getattr(ref, attr), rtol=tol, err_msg=attr)
    if source == "device_weighted":
        return
    a = mine.transform(data)
    with jax.enable_x64(True):
        b = ref.transform(jdata)
    if source == "numpy":
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())
    else:
        assert list(a.columns) == list(data.columns) + ["pcs"]
        np.testing.assert_allclose(np.stack(a["pcs"]), np.stack(b["pcs"]), rtol=tol,
                                   atol=tol * np.abs(np.stack(b["pcs"])).max())


@pytest.mark.parametrize("fused", ["off", "on"])
def test_estimator_matches_jax_float32(fused):
    """float32 inputs: the full solver within 1e-4 of JAX (components and
    relative variances), transform within 1e-4 relative."""
    X, _ = _data(seed=7)
    X = X.astype(np.float32)
    for cfg in (port_config, jax_config):
        cfg.set_config(fused_stage_solve=fused)
    mine = PCA(k=3).setInputCol("features").fit(X)
    ref = JaxPCA(k=3).setInputCol("features").fit(X)
    assert mine.components_.dtype == np.float32 and mine.dtype == "float32"
    np.testing.assert_allclose(mine.components_, ref.components_, atol=1e-4)
    np.testing.assert_allclose(mine.explained_variance_, ref.explained_variance_, rtol=1e-4)
    np.testing.assert_allclose(mine.mean_, ref.mean_, rtol=1e-4, atol=1e-4)
    a, b = mine.transform(X), ref.transform(X)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def test_fused_equals_two_phase_and_auto_threshold():
    """The fused full solver against the two-phase one in the port (1e-10),
    and "auto" fusing only from `_AUTO_MIN_BYTES` of staged rows."""
    X, _ = _data(seed=8)
    port_config.set_config(fused_stage_solve="off")
    a = PCA(k=3, float32_inputs=False).fit(X)
    port_config.set_config(fused_stage_solve="on")
    b = PCA(k=3, float32_inputs=False).fit(X)
    np.testing.assert_allclose(a.components_, b.components_, atol=1e-10)
    np.testing.assert_allclose(a.explained_variance_, b.explained_variance_, rtol=1e-10)
    port_config.set_config(fused_stage_solve="auto")
    port_fused.FUSED_METRICS.clear()
    PCA(k=3).fit(X)
    assert not port_fused.FUSED_METRICS


def test_model_surface():
    X, _ = _data(seed=9, n=300)
    model = PCA(k=2, float32_inputs=False).setOutputCol("o").fit(X)
    assert model.pc.shape == (12, 2) and np.array_equal(model.pc, model.components_.T)
    np.testing.assert_array_equal(model.explainedVariance, model.explained_variance_ratio_)
    assert model.getK() == 2 and model.getOutputCol() == "o"
    out = model.transform({"features": X, "id": np.arange(300)})
    assert set(out) == {"features", "id", "o"} and out["o"].shape == (300, 2)
    np.testing.assert_allclose(out["o"], X @ model.components_.T, rtol=1e-12, atol=1e-12)
    assert PCA(k=2).getK() == 2 and PCA().fit(X).components_.shape == (12, 12)
    est = PCA().setInputCol(["a", "b"])
    assert est.getInputCol() == ["a", "b"]


# ---------------------------------------------------------------------------
# Save / load across the packages, and convert.py
# ---------------------------------------------------------------------------


def _same_attrs(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_cross_load(tmp_path, saver):
    X, _ = _data(seed=10)
    X = X.astype(np.float32)
    ref = JaxPCA(k=3).setInputCol("features").setOutputCol("p").fit(X)
    mine = PCA(k=3).setInputCol("features").setOutputCol("p").fit(X)
    path = str(tmp_path / "model")
    if saver == "jax":
        ref.save(path)
        loaded, want = PCAModel.load(path), ref
    else:
        mine.save(path)
        loaded, want = JaxPCAModel.load(path), mine
    _same_attrs(loaded._get_model_attributes(), want._get_model_attributes())
    assert loaded.getOrDefault("outputCol") == "p" and loaded.getK() == 3
    assert loaded.tpu_params == want.tpu_params
    np.testing.assert_allclose(loaded.transform(X), want.transform(X), rtol=1e-5, atol=1e-4)


def test_convert_pair_round_trips():
    X, _ = _data(seed=11)
    with jax.enable_x64(True):
        ref = JaxPCA(k=3, float32_inputs=False).setOutputCol("q").fit(X)
    mine = pca_model_from_reference(ref._get_model_attributes(), model_params(ref))
    _same_attrs(mine._get_model_attributes(), ref._get_model_attributes())
    assert mine.getOrDefault("outputCol") == "q"
    back = JaxPCAModel(**pca_model_to_reference_attributes(mine))
    JaxReadWrite._restore_params(back, model_params(mine))
    _same_attrs(back._get_model_attributes(), ref._get_model_attributes())
    with jax.enable_x64(True):
        want = ref.transform(X)
        np.testing.assert_array_equal(back.transform(X), want)
    np.testing.assert_allclose(mine.transform(X), want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# The port's own contract
# ---------------------------------------------------------------------------


def test_params_and_defaults_match_jax():
    a, b = PCA(), JaxPCA()
    assert [p.name for p in a.params] == [p.name for p in b.params]
    for p in a.params:
        assert a.hasDefault(p.name) == b.hasDefault(p.name)
        if a.hasDefault(p.name) and p.name != "outputCol":  # outputCol is uid-based
            assert a.getOrDefault(p.name) == b.getOrDefault(p.name)
    assert a.tpu_params == b.tpu_params
    assert PCA(k=4).tpu_params == JaxPCA(k=4).tpu_params


def test_what_raises():
    X, _ = _data(seed=12, n=100)
    with pytest.raises(ValueError, match="exceeds"):
        PCA(k=13).fit(X)
    port_config.set_config(fused_stage_solve="on")
    with pytest.raises(ValueError, match="exceeds"):
        PCA(k=13).fit(X)
    port_config.set_config(fused_stage_solve="maybe")
    with pytest.raises(ValueError, match="fused_stage_solve"):
        PCA(k=2).fit(X)
    port_config.reset_config()
    with pytest.raises(ValueError, match="Unsupported"):
        PCA(not_a_param=1)
    est = PCA(k=2)
    # the parquet and streamed fits are ported: they now reach the file
    for call in (lambda: est._fit_fused_parquet("x.parquet"),
                 lambda: est._fit_streaming("x.parquet")):
        with pytest.raises(FileNotFoundError):
            call()
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        est._cpu_fit(None)
    with pytest.raises(NotImplementedError, match="scikit-learn"):
        est.fit(X).cpu()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [6, 300])
def test_one_row_of_weight_gives_the_jax_nan_model(d, dtype):
    """One row of weight > 0: the covariance divides by wsum - 1 = 0.  Both
    packages return the row as the mean and NaN components, variances,
    ratios and singular values (d = 300 takes the randomized solver under
    "auto", d = 6 the full one), with the fused pass off."""
    X = np.random.default_rng(15).normal(size=(1, d)).astype(dtype)
    f32 = dtype == np.float32
    for cfg in (port_config, jax_config):
        cfg.set_config(fused_stage_solve="off")
    mine = PCA(k=2, float32_inputs=f32).fit(X)
    assert port_pca.LAST_SOLVER_DECISION["solver"] == ("full" if d == 6 else "randomized")
    with jax.enable_x64(not f32):
        ref = JaxPCA(k=2, float32_inputs=f32).fit(X)
    mine_attrs, ref_attrs = mine._get_model_attributes(), ref._get_model_attributes()
    assert set(mine_attrs) == set(ref_attrs)
    for name, want in ref_attrs.items():
        got = mine_attrs[name]
        if not isinstance(want, np.ndarray):
            assert got == want, name
            continue
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name == "mean_":
            np.testing.assert_allclose(got, want, rtol=1e-6 if f32 else 1e-15)
        else:
            assert np.isnan(got).all() and np.isnan(want).all(), name


def test_csr_fits_as_its_dense_form():
    """CSR input is densified onto the two-phase path, also with the fused
    pass on: the same model as the dense rows, bit for bit."""
    import scipy.sparse as sp

    X, _ = _data(seed=13, n=400)
    X = np.where(np.abs(X) > 1.0, X, 0.0)
    dense = PCA(k=3, float32_inputs=False).fit(X)
    port_config.set_config(fused_stage_solve="on")
    port_fused.FUSED_METRICS.clear()
    sparse = PCA(k=3, float32_inputs=False).fit(sp.csr_matrix(X))
    assert not port_fused.FUSED_METRICS
    np.testing.assert_array_equal(sparse.components_, dense.components_)
    np.testing.assert_array_equal(sparse.explained_variance_, dense.explained_variance_)
