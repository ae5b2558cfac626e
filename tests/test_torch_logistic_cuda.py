#
# LogisticRegression on the card against the same code on the CPU: the
# oracle, a fit (binomial and multinomial, float32 and float64), the chunked
# transform and a DeviceDataset fit.  Every test here needs a CUDA device
# and skips without one.  This file imports no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_logistic_cuda.py
#
import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import DeviceDataset, set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.classification import LogisticRegression
from spark_rapids_ml_torch.ops import logistic as lo
from spark_rapids_ml_torch.ops import stats

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    set_default_device(None)
    port_config.reset_config()


def _data(seed, n=5000, d=17, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(size=d)
    scores = X @ rng.normal(size=(d, classes)) + 0.5 * rng.normal(size=(n, classes))
    y = np.argmax(scores, axis=1).astype(np.float64)
    return X, y, rng.uniform(0.2, 2.0, n)


# (f, g) tolerance of the card against the CPU, which sum in another order
_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("classes", [2, 5])
def test_oracle_on_the_card_matches_the_cpu(cuda_device, dtype, classes):
    X, y, w = _data(1, classes=classes)
    binomial = classes == 2
    C = 1 if binomial else classes
    theta = np.random.default_rng(2).normal(size=C * X.shape[1] + C)
    out = []
    for dev in ("cpu", cuda_device):
        t = [torch.as_tensor(a, dtype=dtype, device=dev) for a in (X, w)]
        yt = torch.as_tensor(y.astype(np.int32), device=dev)
        out.append(lo.LogisticOracle(*t, yt, classes, 0.01, True, binomial)(theta))
    (fc, gc), (fg, gg) = out
    tol = _TOL[dtype]
    np.testing.assert_allclose(fg, fc, rtol=tol)
    np.testing.assert_allclose(gg, gc, rtol=tol, atol=tol * np.abs(gc).max())


def test_oracle_matmuls_stay_ieee_under_tf32(cuda_device):
    """A process that turned TF32 on still gets IEEE float32 products."""
    X, y, w = _data(3, n=20000, d=256)
    t = [torch.as_tensor(a, dtype=torch.float32, device=cuda_device) for a in (X, w)]
    yt = torch.as_tensor(y.astype(np.int32), device=cuda_device)
    oracle = lo.LogisticOracle(*t, yt, 2, 0.0, True, True)
    theta = np.random.default_rng(4).normal(size=257)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        f_tf32, g_tf32 = oracle(theta)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    f, g = oracle(theta)
    assert f == f_tf32
    np.testing.assert_array_equal(g, g_tf32)


@pytest.mark.parametrize("classes", [2, 4])
@pytest.mark.parametrize("float32_inputs", [True, False])
def test_fit_and_transform_on_the_card_match_the_cpu(cuda_device, classes, float32_inputs):
    X, y, wt = _data(5, classes=classes)
    data = {"features": X, "label": y, "wt": wt}
    kw = dict(regParam=0.01, elasticNetParam=0.3, maxIter=200, tol=1e-10,
              float32_inputs=float32_inputs)
    models, outs = [], []
    for dev in ("cpu", "cuda"):
        set_default_device(dev)
        m = LogisticRegression(**kw).setWeightCol("wt").fit(data)
        models.append(m)
        outs.append(m.transform(X))
    (mc, mg), (oc, og) = models, outs
    rtol = 2e-3 if float32_inputs else 1e-6
    np.testing.assert_allclose(mg.coefficientMatrix, mc.coefficientMatrix, rtol=rtol,
                               atol=rtol * np.abs(mc.coefficientMatrix).max())
    np.testing.assert_allclose(mg.objective, mc.objective, rtol=1e-5 if float32_inputs else 1e-10)
    assert (og["prediction"] == oc["prediction"]).mean() > 0.999
    np.testing.assert_allclose(og["probability"], oc["probability"], atol=1e-3)


def test_chunked_transform_on_the_card(cuda_device):
    """1024-row chunks, each copied on the side stream, give the outputs of
    one chunk: predictions equal, probabilities and raw margins within
    float32 rounding (cuBLAS picks its kernel by the row count, so the
    last bits may differ from chunk size to chunk size)."""
    set_default_device("cuda")
    X, y, _ = _data(6, n=9000, d=9, classes=3)
    model = LogisticRegression(regParam=0.01).fit((X, y))
    whole = model.transform(X)
    port_config.set_config(host_batch_bytes=1)
    chunked = model.transform(X)
    np.testing.assert_array_equal(chunked["prediction"], whole["prediction"])
    for col in ("probability", "rawPrediction"):
        np.testing.assert_allclose(chunked[col], whole[col], rtol=1e-5, atol=1e-6)


def test_device_dataset_on_the_card(cuda_device):
    set_default_device("cuda")
    X, y, wt = _data(7, classes=3)
    ds = DeviceDataset.from_host(X, y=y, weight=wt, label_dtype=np.int32)
    assert ds.X.is_cuda and ds.y.dtype == torch.int32
    a = LogisticRegression(regParam=0.01, maxIter=50).fit(ds)
    b = LogisticRegression(regParam=0.01, maxIter=50).setWeightCol("wt").fit(
        {"features": X, "label": y, "wt": wt})
    np.testing.assert_array_equal(a.coef_, b.coef_)
    mean, std, wsum = stats.weighted_moments(ds.X, ds.weight)
    assert mean.is_cuda and float(wsum) == pytest.approx(wt.sum(), rel=1e-6)
