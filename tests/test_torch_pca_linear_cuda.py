#
# PCA, LinearRegression and the fused stage-and-solve pass on the card
# against the same code on the CPU: the fused pass with its side-stream
# copies, pinned buffers and producer thread, the fits from a DeviceDataset
# and from host arrays (fused), and the transform.  Every test here needs a
# CUDA device and skips without one.  This file imports no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_pca_linear_cuda.py
#
import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import DeviceDataset, set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import fused
from spark_rapids_ml_torch.feature import PCA
from spark_rapids_ml_torch.regression import LinearRegression

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    set_default_device(None)
    port_config.reset_config()


def _data(seed, n=20000, d=16, gap=True):
    """Rows with three leading directions far above the rest (`gap`, for
    PCA) or of like scales (a well-conditioned Gram, for the float32
    normal equations), labels from a linear model plus noise, weights in
    [0.2, 2)."""
    rng = np.random.default_rng(seed)
    scales = (np.concatenate([[10.0, 8.0, 6.0], np.linspace(0.4, 0.05, d - 3)]) if gap
              else rng.uniform(0.5, 2.0, d))
    R, _ = np.linalg.qr(rng.normal(size=(d, d)))
    X = (rng.normal(size=(n, d)) * scales) @ R + rng.normal(size=d)
    y = X @ rng.normal(size=d) + 0.5 + 0.1 * rng.normal(size=n)
    return X, y, rng.uniform(0.2, 2.0, n)


# the card against the CPU, which sum in another order; the unweighted
# linreg step sums the float32 labels (the staging rule) in float32 (sy,
# syy), so those agree to float32 rounding whatever the features' dtype
_TOL = {np.float32: 1e-5, np.float64: 1e-12}
_F32_SUM_TOL = 1e-6


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["linreg", "pca_moments", "pca_projected"])
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("weighted", [True, False])
def test_fused_pass_on_the_card_matches_the_cpu(cuda_device, dtype, kind, depth, weighted):
    X, y, w = _data(1)
    omega = np.random.default_rng(2).normal(size=(X.shape[1], 5))
    port_config.set_config(staging_pipeline_depth=depth)
    out = []
    for dev in ("cpu", cuda_device):
        acc, step = fused._steps(kind, X.shape[1], 5, np.dtype(dtype), dev)
        chunks = fused.iter_host_chunks(X, y if kind == "linreg" else None,
                                        w if weighted else None, 3000, dtype,
                                        label_dtype=np.float32)
        extra = (omega.astype(dtype),) if kind == "pca_projected" else ()
        host, m = fused.accumulate_chunks(acc, step, chunks, dev, has_y=kind == "linreg",
                                          extra_args=extra)
        assert m["chunks"] == 7 and m["bytes"] > X.shape[0] * X.shape[1] * np.dtype(dtype).itemsize
        out.append(host)
    for k in out[0]:
        tol = _F32_SUM_TOL if (k in ("sy", "syy") and not weighted) else _TOL[dtype]
        np.testing.assert_allclose(out[1][k], out[0][k], rtol=tol,
                                   atol=tol * np.abs(out[0][k]).max(), err_msg=k)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("solver", ["full", "randomized"])
@pytest.mark.parametrize("fused_mode", ["off", "on"])
def test_pca_on_the_card_matches_the_cpu(cuda_device, dtype, solver, fused_mode):
    X, _, _ = _data(3)
    port_config.set_config(pca_solver=solver, fused_stage_solve=fused_mode, pca_oversamples=4)
    kw = dict(k=3, float32_inputs=dtype == np.float32)
    models = []
    for dev in ("cpu", cuda_device):
        set_default_device(dev)
        models.append(PCA(**kw).fit(X))
    cpu, card = models
    tol = 1e-4 if dtype == np.float32 else 1e-10
    cosines = np.linalg.svd(card.components_.astype(np.float64) @ cpu.components_.T,
                            compute_uv=False)
    np.testing.assert_allclose(cosines, 1.0, atol=tol)
    np.testing.assert_allclose(card.components_, cpu.components_, atol=tol)
    np.testing.assert_allclose(card.explained_variance_, cpu.explained_variance_, rtol=tol)
    out = card.transform(X)
    set_default_device("cpu")
    np.testing.assert_allclose(out, cpu.transform(X), rtol=tol, atol=tol * np.abs(out).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("reg", [dict(regParam=0.0), dict(regParam=1e-3),
                                 dict(regParam=1e-3, elasticNetParam=0.5, tol=1e-12)])
def test_linear_regression_on_the_card_matches_the_cpu(cuda_device, dtype, reg):
    X, y, w = _data(4, gap=False)
    set_default_device(cuda_device)
    kw = dict(reg, float32_inputs=dtype == np.float32)
    ds = DeviceDataset.from_host(X, y=y, weight=w, dtype=dtype)
    card_ds = LinearRegression(**kw).fit(ds)
    port_config.set_config(fused_stage_solve="on")
    data = {"features": X, "label": y, "wt": w}
    card_fused = LinearRegression(**kw).setWeightCol("wt").fit(data)
    set_default_device("cpu")
    port_config.set_config(fused_stage_solve="off")
    cpu = LinearRegression(**kw).setWeightCol("wt").fit(data)
    tol = 1e-4 if dtype == np.float32 else 1e-9
    scale = np.abs(cpu.coef_).max()
    for card in (card_ds, card_fused):
        np.testing.assert_allclose(card.coef_, cpu.coef_, atol=tol * scale)
        np.testing.assert_allclose(card.intercept, cpu.intercept, atol=tol * scale)
        np.testing.assert_allclose(card.summary.r2, cpu.summary.r2, rtol=tol)
    set_default_device(cuda_device)
    pred = card_ds.transform(X)
    want = X @ card_ds.coef_.astype(np.float64) + card_ds.intercept
    np.testing.assert_allclose(pred, want, rtol=tol, atol=tol * np.abs(want).max())
