#
# The port's RandomForestClassifier and RandomForestRegressor
# (spark_rapids_ml_torch/models/tree.py, classification.py, regression.py)
# against the JAX package's on the same numpy inputs, on the CPU: with no
# random draws (bootstrap off, every feature a candidate) the same forest
# through the public entry points; with each package's own seed, a
# quality within a margin; transform, cpu(), the one-row API and the
# inspection API on one forest; save/load across the packages,
# convert.py, the heap layout of old saves, and what raises.  The JAX side
# runs with num_workers=1; every JAX float64 call runs inside
# `jax.enable_x64(True)` (the flag is checked at module teardown).
#
import json

import jax
import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_torch import DeviceDataset, set_default_device
from spark_rapids_ml_torch.classification import (
    RandomForestClassificationModel,
    RandomForestClassifier,
)
from spark_rapids_ml_torch.convert import (
    model_params,
    rf_model_from_reference,
    rf_model_to_reference_attributes,
)
from spark_rapids_ml_torch.regression import RandomForestRegressionModel, RandomForestRegressor
from spark_rapids_ml_tpu.classification import (
    RandomForestClassificationModel as JaxRFCModel,
)
from spark_rapids_ml_tpu.classification import RandomForestClassifier as JaxRFC
from spark_rapids_ml_tpu.core import _ReadWriteMixin as JaxReadWrite
from spark_rapids_ml_tpu.regression import RandomForestRegressionModel as JaxRFRModel
from spark_rapids_ml_tpu.regression import RandomForestRegressor as JaxRFR

_ARRAYS = ("feature", "threshold", "leaf_stats", "gain", "count", "left_child")
_GAIN_TOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture(scope="module", autouse=True)
def _x64_flag_unchanged():
    before = jax.config.jax_enable_x64
    yield
    assert jax.config.jax_enable_x64 == before


@pytest.fixture(autouse=True)
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def _data(seed, n=600, d=8, task="binary"):
    """Rows, labels and weights in [0.2, 2) with every 17th weight 0."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    if task == "binary":
        y = ((X[:, 0] + 0.7 * X[:, 1] - 0.4 * X[:, 2] + 0.3 * rng.normal(size=n)) > 0)
    elif task == "multiclass":
        y = np.digitize(X[:, 0] + X[:, 3] + 0.3 * rng.normal(size=n), [-0.7, 0.0, 0.8])
    else:
        y = 2.0 * X[:, 0] + np.sin(2 * X[:, 1]) + X[:, 2] * X[:, 3] + 0.2 * rng.normal(size=n)
    w = rng.uniform(0.2, 2.0, n)
    w[::17] = 0.0
    return X, y.astype(np.float64), w


_CASES = {
    "gini": (RandomForestClassifier, JaxRFC, "binary", {}),
    "entropy": (RandomForestClassifier, JaxRFC, "multiclass", {"impurity": "entropy"}),
    "variance": (RandomForestRegressor, JaxRFR, "regression", {}),
}


def _frame(X, y, w):
    return pd.DataFrame({"features": list(X), "label": y, "w": w})


def _fit_pair(case, dtype, weighted, **kw):
    """The same estimator of both packages fit on the same rows; the JAX
    one with num_workers=1, in float64 under enable_x64."""
    port_cls, jax_cls, task, extra = _CASES[case]
    X, y, w = _data(21, task=task)
    X = X.astype(dtype)
    params = dict(numTrees=3, maxDepth=6, maxBins=32, seed=5, **extra, **kw)
    f32 = dtype == np.float32

    def fit(cls, **more):
        est = cls(float32_inputs=f32, **params, **more)
        if weighted:
            est.setWeightCol("w")
        return est.fit(_frame(X, y, w) if weighted else (X, y))

    mine = fit(port_cls)
    with jax.enable_x64(not f32):
        ref = fit(jax_cls, num_workers=1)
    return mine, ref, X


def _same_arrays(mine, ref, dtype):
    for k in _ARRAYS:
        a, b = getattr(mine, k), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k == "gain":
            assert np.abs(a - b).max() <= _GAIN_TOL[dtype] * max(np.abs(b).max(), 1.0)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("max_depth", "n_cols", "dtype"):
        assert getattr(mine, k) == getattr(ref, k), k


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_no_draws_forest_equals_jax(case, dtype, weighted):
    """bootstrap=False, featureSubsetStrategy="all": no random draw, so the
    port's forest is the JAX package's (structure, thresholds, leaf
    statistics and counts equal; gains within 1e-6 / 1e-12), and so are
    the transform's outputs."""
    mine, ref, X = _fit_pair(case, dtype, weighted, bootstrap=False,
                             featureSubsetStrategy="all")
    _same_arrays(mine, ref, dtype)
    assert ((mine.feature >= 0).sum(axis=1) >= 5).all()
    if case != "variance":
        assert mine.numClasses == ref.numClasses == (2 if case == "gini" else 4)
    a = mine.transform(X)
    with jax.enable_x64(dtype == np.float64):
        b = ref.transform(X)
    if case == "variance":
        assert a.dtype == b.dtype == dtype
        np.testing.assert_allclose(a, b, rtol=1e-6 if dtype == np.float32 else 1e-12)
        return
    np.testing.assert_array_equal(a["prediction"], b["prediction"])
    for col in ("probability", "rawPrediction"):
        assert a[col].dtype == np.asarray(b[col]).dtype
        np.testing.assert_allclose(a[col], b[col], atol=1e-6 if dtype == np.float32 else 1e-12)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_own_seed_quality_is_jaxs(case):
    """With bootstrap and a feature subset each package draws from its own
    generator, so the forests differ; held-out accuracy within 0.03 and
    R^2 within 0.03 of the JAX model's."""
    port_cls, jax_cls, task, extra = _CASES[case]
    X, y, _ = _data(22, n=3000, task=task)
    X = X.astype(np.float32)
    tr, te = slice(0, 2000), slice(2000, None)
    params = dict(numTrees=20, maxDepth=8, seed=3, **extra)
    mine = port_cls(**params).fit((X[tr], y[tr]))
    ref = jax_cls(num_workers=1, **params).fit((X[tr], y[tr]))

    def score(model):
        out = model.transform(X[te])
        if task == "regression":
            return 1.0 - ((out - y[te]) ** 2).mean() / y[te].var()
        return (out["prediction"] == y[te]).mean()

    a, b = score(mine), score(ref)
    assert a >= b - 0.03, (a, b)
    assert a > 0.6  # well above chance: the forest learned


def _jax_forest(case="gini", dtype=np.float32):
    """A JAX model of its own seed (bootstrap, feature subsets)."""
    _, jax_cls, task, extra = _CASES[case]
    X, y, _ = _data(23, task=task)
    X = X.astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = jax_cls(numTrees=6, maxDepth=7, seed=9, num_workers=1,
                      float32_inputs=dtype == np.float32, **extra).setPredictionCol("p").fit((X, y))
    return ref, X


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_transform_and_host_api_match_jax_on_one_forest(case, dtype):
    """One forest in both packages (convert.py): transform, cpu(), the
    one-row API and the inspection API give the JAX model's answers."""
    ref, X = _jax_forest(case, dtype)
    mine = rf_model_from_reference(ref._get_model_attributes(), model_params(ref))
    assert type(mine).__name__ == type(ref).__name__
    assert mine.getOrDefault("predictionCol") == "p"
    with jax.enable_x64(dtype == np.float64):
        want = ref.transform(X)
    got = mine.transform(X)
    tol = 1e-6 if dtype == np.float32 else 1e-12
    if case == "variance":
        np.testing.assert_allclose(got, want, rtol=tol)
    else:
        np.testing.assert_array_equal(got["p"], want["p"])
        np.testing.assert_allclose(got["probability"], want["probability"], atol=tol)
        np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"], atol=tol)
    # the numpy predictor: the same code as the JAX package's
    np.testing.assert_array_equal(mine.cpu().predict(X), ref.cpu().predict(X))
    if case != "variance":
        np.testing.assert_array_equal(mine.cpu().predict_proba(X), ref.cpu().predict_proba(X))
        np.testing.assert_array_equal(mine.cpu().predict(X), got["p"])
        for x in X[:15]:
            np.testing.assert_array_equal(mine.predictProbability(x), ref.predictProbability(x))
            np.testing.assert_array_equal(mine.predictRaw(x), ref.predictRaw(x))
            assert mine.predict(x) == ref.predict(x)
        assert mine.numClasses == ref.numClasses
    else:
        assert [mine.predict(x) for x in X[:15]] == [ref.predict(x) for x in X[:15]]
    np.testing.assert_array_equal(mine.featureImportances, ref.featureImportances)
    assert mine.totalNumNodes == ref.totalNumNodes
    assert mine.treeWeights == ref.treeWeights and mine.numTrees == ref.numTrees == 6
    assert mine.toDebugString() == ref.toDebugString()
    assert mine.to_json() == ref.to_json()
    assert json.loads(mine.to_json())["num_feature"] == X.shape[1]
    with pytest.raises(ValueError, match="entries"):
        mine.predict(X[0, :3])


@pytest.mark.parametrize("saver", ["jax", "port"])
@pytest.mark.parametrize("case", ["gini", "variance"])
def test_cross_load(tmp_path, saver, case):
    """metadata.json + arrays.npz written by either package load in the
    other: the same arrays, params and predictions."""
    ref, X = _jax_forest(case)
    port_cls = RandomForestClassificationModel if case == "gini" else RandomForestRegressionModel
    jax_cls = JaxRFCModel if case == "gini" else JaxRFRModel
    mine = rf_model_from_reference(ref._get_model_attributes(), model_params(ref))
    path = str(tmp_path / "model")
    if saver == "jax":
        ref.save(path)
        loaded, want = port_cls.load(path), ref
    else:
        mine.save(path)
        loaded, want = jax_cls.load(path), mine
    for k in _ARRAYS:
        np.testing.assert_array_equal(getattr(loaded, k), getattr(want, k))
    assert loaded.tpu_params == want.tpu_params
    assert loaded.getOrDefault("predictionCol") == "p"
    assert loaded.getOrDefault("maxDepth") == want.getOrDefault("maxDepth") == 7
    a, b = loaded.transform(X), want.transform(X)
    if case == "gini":
        np.testing.assert_array_equal(a["p"], b["p"])
    else:  # the mean over the trees sums in another order
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_convert_pair_round_trips(case):
    ref, X = _jax_forest(case, np.float64)
    mine = rf_model_from_reference(ref._get_model_attributes(), model_params(ref))
    attrs = rf_model_to_reference_attributes(mine)
    assert set(attrs) == set(ref._get_model_attributes())
    back = type(ref)(**attrs)
    JaxReadWrite._restore_params(back, model_params(mine))
    for k, v in ref._get_model_attributes().items():
        if isinstance(v, np.ndarray):
            assert attrs[k].dtype == v.dtype, k
            np.testing.assert_array_equal(attrs[k], v)
        else:
            assert attrs[k] == v, k
    with jax.enable_x64(True):
        a, b = back.transform(X), ref.transform(X)
    if case != "variance":
        a, b = a["p"], b["p"]
    np.testing.assert_array_equal(a, b)


def test_heap_layout_of_old_saves():
    """A model saved before the node table (no left_child) uses the heap
    layout, children of i at 2i+1 / 2i+2: the same left_child and the
    same predictions as the JAX package's."""
    rng = np.random.default_rng(24)
    T, depth, d = 3, 3, 4
    n_nodes = 2 ** (depth + 1) - 1
    feature = np.full((T, n_nodes), -1, np.int32)
    feature[:, : 2 ** depth - 1] = rng.integers(0, d, (T, 2 ** depth - 1))
    feature[0, 2] = -1  # a leaf above the last level
    attrs = dict(feature=feature, threshold=rng.normal(size=(T, n_nodes)).astype(np.float32),
                 leaf_stats=rng.integers(0, 9, (T, n_nodes, 2)).astype(np.float32),
                 max_depth=depth, n_cols=d, dtype="float32", num_classes=2)
    mine = RandomForestClassificationModel(**attrs)
    ref = JaxRFCModel(**attrs)
    np.testing.assert_array_equal(mine.left_child, ref.left_child)
    X = rng.normal(size=(200, d)).astype(np.float32)
    np.testing.assert_array_equal(mine.transform(X)["prediction"], ref.transform(X)["prediction"])
    assert mine.totalNumNodes == ref.totalNumNodes


@pytest.mark.parametrize("case", ["gini", "variance"])
def test_device_dataset_fit_equals_numpy_fit(case):
    port_cls, _, task, extra = _CASES[case]
    X, y, w = _data(25, task=task)
    X = X.astype(np.float32)
    est = port_cls(numTrees=4, maxDepth=6, seed=8, **extra)
    a = est.fit((X, y))
    b = est.fit(DeviceDataset.from_host(X, y=y, dtype=np.float32))
    for k in _ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    # sample weights through a DeviceDataset equal those of a weight column
    c = est.copy().setWeightCol("w").fit(_frame(X, y, w))
    d = est.fit(DeviceDataset.from_host(X, y=y, weight=w, dtype=np.float32))
    for k in _ARRAYS:
        np.testing.assert_array_equal(getattr(c, k), getattr(d, k))


def test_zero_weight_rows_are_absent():
    """Rows of weight 0 change neither the edges nor the trees."""
    X, y, w = _data(26)
    keep = w > 0
    est = RandomForestClassifier(numTrees=3, maxDepth=6, seed=1, bootstrap=False,
                                 featureSubsetStrategy="all", float32_inputs=False)
    a = est.copy().setWeightCol("w").fit(_frame(X, y, w))
    b = est.copy().setWeightCol("w").fit(_frame(X[keep], y[keep], w[keep]))
    for k in _ARRAYS:
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=1e-12, atol=1e-12)


def test_params_and_defaults_match_jax():
    for a, b in ((RandomForestClassifier(), JaxRFC()), (RandomForestRegressor(), JaxRFR()),
                 (RandomForestClassifier(numTrees=7, maxBins=64, featureSubsetStrategy="0.5",
                                         subsamplingRate=0.8, impurity="entropy"),
                  JaxRFC(numTrees=7, maxBins=64, featureSubsetStrategy="0.5",
                         subsamplingRate=0.8, impurity="entropy"))):
        assert [p.name for p in a.params] == [p.name for p in b.params]
        for p in a.params:
            assert a.hasDefault(p.name) == b.hasDefault(p.name)
            if a.hasDefault(p.name):
                assert a.getOrDefault(p.name) == b.getOrDefault(p.name), p.name
        assert a.tpu_params == b.tpu_params


@pytest.mark.parametrize("where", ["host", "device"])
@pytest.mark.parametrize("labels", [[0.0, 1.5, 1.0], [0.0, -1.0, 1.0]])
def test_bad_labels_raise(where, labels):
    X = np.random.default_rng(27).normal(size=(30, 3)).astype(np.float32)
    y = np.resize(np.array(labels), 30)
    data = (X, y) if where == "host" else DeviceDataset.from_host(X, y=y, dtype=np.float32)
    with pytest.raises(ValueError, match="non-negative integers"):
        RandomForestClassifier(numTrees=2).fit(data)


def test_what_raises():
    X, y, _ = _data(28, n=100)
    model = RandomForestClassifier(numTrees=2, maxDepth=3).fit((X, y))
    # evaluate is ported (the meta layer): it scores the frame
    assert model.evaluate(_frame(X, y, np.ones(100))).accuracy > 0.5
    with pytest.raises(NotImplementedError, match="no CPU fallback"):
        RandomForestRegressor()._cpu_fit(None)
    with pytest.raises(ValueError, match="not supported for this task"):
        RandomForestRegressor(impurity="gini").fit((X, y))
    with pytest.raises(ValueError, match="not supported"):
        RandomForestClassifier(featureSubsetStrategy="most")
    with pytest.raises(ValueError, match="predict_proba needs a classification"):
        RandomForestRegressor(numTrees=2, maxDepth=3).fit((X, y)).cpu().predict_proba(X)
