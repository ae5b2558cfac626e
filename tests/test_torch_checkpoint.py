#
# The port's checkpoint contract (spark_rapids_ml_torch/resilience/
# checkpoint.py and the solvers that save through it) against the JAX
# package's: `_fit_fingerprint` and the checkpoint tags and file names are
# equal, sums that wrap around included, and a checkpoint written by either
# package resumes in the other.  A fit killed at iteration k (an injected
# preemption, retries off) in one package is resumed by the other and ends
# within 1e-10 of the killing package's uninterrupted float64 fit:
# LogisticRegression dense and ELL, the FISTA elastic net, the stepwise
# KMeans; the streamed KMeans, which the JAX package evaluates in float32,
# within float32's 1e-5.  Every JAX float64 call runs inside
# `jax.enable_x64(True)`.
#
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import resilience as port_res
from spark_rapids_ml_torch import streaming as port_streaming
from spark_rapids_ml_torch.classification import LogisticRegression
from spark_rapids_ml_torch.clustering import KMeans
from spark_rapids_ml_torch.core import _fit_fingerprint, _isum
from spark_rapids_ml_torch.regression import LinearRegression
from spark_rapids_ml_tpu import config as jax_config
from spark_rapids_ml_tpu import resilience as jax_res
from spark_rapids_ml_tpu import streaming as jax_streaming
from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLR
from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.core import _fit_fingerprint as jax_fit_fingerprint
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinReg


@pytest.fixture(scope="module", autouse=True)
def _x64_flag_unchanged():
    before = jax.config.jax_enable_x64
    yield
    assert jax.config.jax_enable_x64 == before


@pytest.fixture(autouse=True)
def _clean():
    set_default_device("cpu")
    port_config.reset_config()
    jax_config.reset_config()
    port_res.reset_faults()
    port_res.reset_metrics()
    yield
    port_config.reset_config()
    jax_config.reset_config()
    port_res.reset_faults()
    port_res.reset_metrics()
    set_default_device(None)


# ---------------------------------------------------------------------------
# fingerprints and tags
# ---------------------------------------------------------------------------


def _jax_fingerprint(X, w, y):
    with jax.enable_x64(True):
        return jax_fit_fingerprint(types.SimpleNamespace(
            X=jnp.asarray(X), w=jnp.asarray(w), y=None if y is None else jnp.asarray(y)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("labels", [None, np.int32, np.float32])
def test_fingerprint_equals_jax(dtype, labels):
    """Random values, and values whose bit patterns sum past the integer
    width (the sums wrap, in the array's own width, in both packages)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(257, 5)).astype(dtype)
    X[:64] = np.finfo(dtype).max / 3  # large bit patterns: the sum wraps
    w = rng.uniform(0.5, 2.0, 257).astype(dtype)
    y = None if labels is None else rng.integers(0, 3, 257).astype(labels)
    fi = types.SimpleNamespace(X=torch.from_numpy(X), w=torch.from_numpy(w),
                               y=None if y is None else torch.from_numpy(y))
    assert _fit_fingerprint(fi) == _jax_fingerprint(X, w, y)
    width = 8 * np.dtype(dtype).itemsize
    exact = int(X.view(np.int32 if width == 32 else np.int64).astype(object).sum())
    assert abs(exact) >= 2 ** (width - 1), "the features' sum wraps"


@pytest.mark.parametrize("dtype,itype", [(np.float32, np.int32), (np.float64, np.int64),
                                         (np.int32, np.int32), (np.int16, np.int16)])
def test_isum_wraps_in_its_width(dtype, itype):
    rng = np.random.default_rng(1)
    info = np.iinfo(itype)
    a = rng.integers(info.min, info.max, size=1001, dtype=itype)
    arr = a.view(dtype) if np.dtype(dtype).kind == "f" else a.astype(dtype)
    exact = int(a.astype(object).sum())
    bits = 8 * np.dtype(itype).itemsize
    want = (exact + (1 << (bits - 1))) % (1 << bits) - (1 << (bits - 1))
    assert _isum(torch.from_numpy(arr)) == want


def _lr_data(seed=0, n=240, d=6, classes=2, sparse=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d)
    if sparse:
        X[rng.random((n, d)) > 0.4] = 0.0
    W = rng.normal(size=(classes, d))
    s = X @ W.T + 0.5 * rng.normal(size=(n, classes))
    y = (s[:, 1] > s[:, 0]) if classes == 2 else np.argmax(s, axis=1)
    return (sp.csr_matrix(X) if sparse else X), y.astype(np.float64)


def _files(d):
    return sorted(os.path.basename(p) for p in map(str, d.glob("*.npz")))


def _kill(fit, fault_inject, site, skip, exc):
    """Run `fit` with a preemption injected at the (skip + 1)-th `site`."""
    with pytest.raises(exc):
        with fault_inject(site, "preemption", times=1, skip=skip):
            fit()


# ---------------------------------------------------------------------------
# resume across packages
# ---------------------------------------------------------------------------

_KILL_AT = 4


def _lr_case(sparse):
    X, y = _lr_data(seed=3, sparse=sparse)
    kw = dict(regParam=0.01, maxIter=40, tol=1e-10, float32_inputs=False)
    return (lambda: LogisticRegression(**kw).fit((X, y)),
            lambda: JaxLR(**kw).fit((X, y)),
            lambda m: (np.asarray(m.coefficientMatrix), np.asarray(m.interceptVector)),
            "lbfgs_iteration", "logreg-mem-")


def _fista_case():
    # values on a 1/4 grid: both packages' Gram sums are exact, so their
    # content tags agree
    rng = np.random.default_rng(4)
    X = rng.integers(-4, 5, size=(200, 5)) / 4.0
    y = X @ np.array([1.5, -2.0, 0.0, 0.25, 3.0]) + rng.integers(-2, 3, 200) / 8.0
    kw = dict(regParam=0.1, elasticNetParam=0.5, maxIter=60, tol=0.0, float32_inputs=False)
    return (lambda: LinearRegression(**kw).fit((X, y)),
            lambda: JaxLinReg(**kw).fit((X, y)),
            lambda m: (np.asarray(m.coefficients), np.asarray([m.intercept])),
            "linreg_fista", "linreg-fista-")


def _kmeans_case():
    # rows with no clusters: Lloyd runs past the kill before it settles
    X = np.random.default_rng(5).normal(size=(400, 3))
    kw = dict(k=6, seed=1, maxIter=12, tol=0.0, float32_inputs=False)
    return (lambda: KMeans(**kw).fit(X),
            lambda: JaxKMeans(**kw).fit(X),
            lambda m: (np.asarray(m.cluster_centers_), np.asarray([m.inertia_])),
            "kmeans_lloyd", "kmeans-mem-")


_CASES = {
    "logreg_dense": lambda: _lr_case(False),
    "logreg_ell": lambda: _lr_case(True),
    "fista": _fista_case,
    "kmeans_stepwise": _kmeans_case,
}


@pytest.mark.parametrize("killer", ["jax", "port"])
@pytest.mark.parametrize("case", list(_CASES))
def test_resume_across_packages(case, killer, tmp_path):
    """The killing package's fit dies at iteration _KILL_AT and leaves its
    file; the other package's fit of the same data finds the same file
    name, resumes at _KILL_AT and ends within 1e-10 of the killing
    package's uninterrupted fit."""
    port_fit, jax_fit, result, site, prefix = _CASES[case]()
    port_config.set_config(checkpoint_dir=str(tmp_path), retry_max_attempts=1)
    jax_config.set_config(checkpoint_dir=str(tmp_path), retry_max_attempts=1)
    with jax.enable_x64(True):
        if killer == "jax":
            want = result(jax_fit())
            _kill(jax_fit, jax_res.fault_inject, site, _KILL_AT, jax_res.SimulatedPreemption)
        else:
            want = result(port_fit())
            _kill(port_fit, port_res.fault_inject, site, _KILL_AT, port_res.SimulatedPreemption)
        left = _files(tmp_path)
        assert len(left) == 1 and left[0].startswith(prefix), left
        got = result(port_fit() if killer == "jax" else jax_fit())
    assert not _files(tmp_path), "the resumed fit removes the file"
    if killer == "jax":
        resumes = [e.detail for e in port_res.get_events() if e.name.endswith("_resume")]
        assert resumes == [f"it={_KILL_AT}"], resumes
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


def _write_parquet(path, X):
    n, d = X.shape
    pq.write_table(pa.table({"features": pa.FixedSizeListArray.from_arrays(
        pa.array(X.reshape(-1)), d)}), path, row_group_size=100)


@pytest.mark.parametrize("killer", ["jax", "port"])
def test_streamed_kmeans_resumes_across_packages(killer, tmp_path):
    """The streamed KMeans under `streaming_checkpoint_dir`: the same file
    name in both packages and a resume across them.  The JAX package's
    streamed passes run in float32, so the resumed centres are held to
    float32's 1e-5."""
    X = np.random.default_rng(6).normal(size=(300, 4)).astype(np.float32)
    path = str(tmp_path / "x.parquet")
    _write_parquet(path, X)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    port_config.set_config(chunk_cache="off", streaming_checkpoint_dir=str(ckpt))
    jax_config.set_config(chunk_cache="off", streaming_checkpoint_dir=str(ckpt),
                          host_batch_bytes=4 * 4 * 100)
    kw = dict(k=5, seed=1, max_iter=10, tol=0.0, checkpoint_dir=str(ckpt))

    def port_fit():
        return port_streaming.kmeans_streaming_fit(path, "features", (), None, chunk_rows=100,
                                                   **kw)

    def jax_fit():
        return jax_streaming.kmeans_streaming_fit(path, "features", (), None, **kw)

    if killer == "jax":
        want = jax_fit()["centers"]
        _kill(jax_fit, jax_res.fault_inject, "kmeans_lloyd", 3, jax_res.SimulatedPreemption)
    else:
        want = port_fit()["centers"]
        _kill(port_fit, port_res.fault_inject, "kmeans_lloyd", 3, port_res.SimulatedPreemption)
    left = _files(ckpt)
    assert len(left) == 1 and left[0].startswith("kmeans-"), left
    got = (port_fit() if killer == "jax" else jax_fit())["centers"]
    assert not _files(ckpt)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_checkpoint_file_layout_equals_jax(tmp_path):
    """Names, the npz layout and the in-file tag check are the same: a
    file saved by either package loads in the other, and a foreign tag is
    refused with a warning in both."""
    tag = "logreg-mem|n=10|d=3|C=2|l2=0.1|l1=0.0|int=True|std=True|mi=5|m=10|ls=20|sx=1"
    d = str(tmp_path)
    assert port_res.checkpoint_file_for(d, tag) == jax_res.checkpoint_file_for(d, tag)
    state = {"w": np.arange(4.0), "it": 3, "converged": False}
    for save, load in ((port_res.save_checkpoint, jax_res.load_checkpoint),
                       (jax_res.save_checkpoint, port_res.load_checkpoint)):
        path = port_res.checkpoint_file_for(d, tag)
        save(path, tag, state)
        got = load(path, tag)
        np.testing.assert_array_equal(got["w"], state["w"])
        assert int(got["it"]) == 3 and not bool(got["converged"])
        with pytest.warns(UserWarning, match="different fit"):
            assert load(path, tag + "x") is None
        os.remove(path)
