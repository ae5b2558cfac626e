#
# The meta layer on the card: the stage-once dataset cache's fold views and
# eval views are CUDA tensors; CrossValidator on the cache equals its legacy
# path (LinearRegression and LogisticRegression on the mask path within
# 1e-6, RandomForestClassifier on the gather path bit for bit, at the JAX
# package's tests/test_device_cache.py size); fitMultiple on the card
# equals separate fits; a staging that runs the card out of memory (the
# budget forced open with `device_cache_bytes`, the card filled) takes the
# legacy path, and any other error reaches the caller.  Every test here
# needs a CUDA device and skips without one.  This file imports no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_tuning_cuda.py
#
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.classification import LogisticRegression, RandomForestClassifier
from spark_rapids_ml_torch.evaluation import (
    BinaryClassificationEvaluator,
    MulticlassClassificationEvaluator,
    RegressionEvaluator,
)
from spark_rapids_ml_torch.parallel import RowStager
from spark_rapids_ml_torch.parallel import device_cache as dc
from spark_rapids_ml_torch.parallel.mesh import STAGE_COUNTS
from spark_rapids_ml_torch.regression import LinearRegression
from spark_rapids_ml_torch.tuning import CrossValidator, ParamGridBuilder

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    port_config.reset_config()
    dc.clear_device_cache()
    dc.clear_chunk_cache()
    set_default_device("cuda")
    yield torch.device("cuda", torch.cuda.current_device())
    dc.clear_device_cache()
    set_default_device(None)
    port_config.reset_config()


def _reg_df(seed=0, n=300, d=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = X @ np.array([1.0, -2.0, 0.5, 3.0])[:d] + rng.normal(scale=0.1, size=n)
    return pd.DataFrame({"features": list(X), "label": y})


def _clf_df(seed=0, n=300, d=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(scale=0.3, size=n) > 0).astype(float)
    return pd.DataFrame({"features": list(X), "label": y})


def _both_paths(build, df):
    out = []
    for mode in ("on", "off"):
        port_config.set_config(device_cache=mode)
        dc.clear_device_cache()
        cv = build()
        s0 = STAGE_COUNTS["dataset_stagings"]
        model = cv.fit(df)
        out.append((model, STAGE_COUNTS["dataset_stagings"] - s0, cv._last_fit_used_cache))
    return out


def test_fold_and_eval_views_are_cuda_tensors(cuda_device):
    df = _reg_df(1)
    lr = LinearRegression()
    entry = lr._cached_fit_entry(df)
    assert entry is not None
    folds = np.random.default_rng(2).integers(0, 3, len(df))
    fold_set = entry.fold_set(folds)
    assert fold_set.fold_dev.is_cuda
    for view in (entry.dataset, fold_set.train_view(0), fold_set.gather_train_view(0)):
        for t in (view.X, view.y, view.weight):
            assert t.is_cuda and t.device == cuda_device
    ev_view = fold_set.eval_view(1, df[folds == 1].reset_index(drop=True))
    rows = ev_view._eval_rows()
    assert rows.X.is_cuda and rows.n_valid == int((folds == 1).sum())
    model = lr.fit(entry.dataset)
    (metric,) = ev_view.evaluate([model], RegressionEvaluator())
    want = RegressionEvaluator().evaluate(model.transform(df[folds == 1].reset_index(drop=True)))
    assert abs(metric - want) <= 1e-6 * want


@pytest.mark.parametrize("case", ["linear", "logistic"])
def test_cv_cached_equals_legacy_on_the_card(cuda_device, case):
    df = _reg_df(3) if case == "linear" else _clf_df(3)

    def build():
        if case == "linear":
            est, ev = LinearRegression(), RegressionEvaluator(metricName="rmse")
        else:
            est, ev = LogisticRegression(maxIter=50), BinaryClassificationEvaluator()
        grid = ParamGridBuilder().addGrid(est.regParam, [0.0, 0.1, 1.0]).build()
        return CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=ev,
                              numFolds=3, seed=11)

    (cached, st_c, used), (legacy, st_l, legacy_used) = _both_paths(build, df)
    assert used and not legacy_used and st_c == 1 and st_l > 1
    assert cached.fit_report()["fold_views"] == "mask"
    assert cached.bestIndex == legacy.bestIndex
    np.testing.assert_allclose(cached.avgMetrics, legacy.avgMetrics, rtol=1e-6)


def test_random_forest_cv_on_the_gather_path_is_bit_equal_to_legacy(cuda_device):
    """The JAX package's test_cv_parity_random_forest_gather_path at its
    size: 240 x 4, numTrees=3, maxDepth=3, seed=5, 2 folds; integer
    bootstrap weights keep the card's histogram counts exact."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=(240, 4))
    y = (X[:, 0] > 0).astype(float)
    df = pd.DataFrame({"features": list(X), "label": y})

    def build():
        rf = RandomForestClassifier(numTrees=3, maxDepth=3, seed=5)
        grid = ParamGridBuilder().addGrid(rf.numTrees, [3]).build()
        return CrossValidator(estimator=rf, estimatorParamMaps=grid,
                              evaluator=MulticlassClassificationEvaluator(metricName="accuracy"),
                              numFolds=2, seed=3)

    (cached, st_c, used), (legacy, _, _) = _both_paths(build, df)
    assert used and st_c == 1 and cached.fit_report()["fold_views"] == "gather"
    assert cached.bestIndex == legacy.bestIndex
    np.testing.assert_array_equal(cached.avgMetrics, legacy.avgMetrics)
    for a, b in zip(cached.bestModel._get_model_attributes().values(),
                    legacy.bestModel._get_model_attributes().values()):
        np.testing.assert_array_equal(a, b)


def test_fit_multiple_on_the_card_equals_separate_fits(cuda_device):
    df = _clf_df(4, n=2000, d=16)
    est = LogisticRegression(maxIter=40)
    maps = [{est.regParam: v} for v in (1e-4, 1e-2)]
    s0 = STAGE_COUNTS["dataset_stagings"]
    models = dict(est.fitMultiple(df, maps))
    assert STAGE_COUNTS["dataset_stagings"] - s0 == 1
    for i, m in enumerate(maps):
        np.testing.assert_array_equal(models[i].coef_, est.fit(df, m).coef_)


def test_out_of_memory_while_staging_takes_the_legacy_path(cuda_device, monkeypatch):
    """The budget forced open (`device_cache_bytes` far above the card) and
    the card filled, while the cache stages, to leave half the dataset's
    bytes: the staging meets torch.cuda.OutOfMemoryError, releases its
    reservation, and the CV runs the legacy path (the filler gone); a
    non-OOM error propagates."""
    n, d = 2_000_000, 64  # 512 MB of float32 features
    rng = np.random.default_rng(5)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = X[:, :4] @ np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    df = pd.DataFrame({"features": list(X), "label": y})
    port_config.set_config(device_cache_bytes=1 << 50)
    lr = LinearRegression()
    grid = ParamGridBuilder().addGrid(lr.regParam, [0.0]).build()
    real = dc.get_or_stage
    held = {}

    def staging_on_a_full_card(*args, **kwargs):
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        held["filler"] = torch.empty(max(0, free - n * d * 2), dtype=torch.uint8,
                                     device=cuda_device)
        try:
            return real(*args, **kwargs)
        finally:
            held.clear()
            torch.cuda.empty_cache()

    monkeypatch.setattr(dc, "get_or_stage", staging_on_a_full_card)
    cv = CrossValidator(estimator=lr, estimatorParamMaps=grid,
                        evaluator=RegressionEvaluator(), numFolds=3, seed=1)
    model = cv.fit(df)
    monkeypatch.undo()
    report = model.fit_report()
    assert report["cache"]["outcome"] == "oom" and not report["used_cache"], report
    assert dc.get_device_cache().claimed_bytes() == 0
    assert dc.CACHE_METRICS["staging_ooms"] >= 1
    assert model.avgMetrics[0] < 1e-3

    def failing(self, arr, dtype=None):
        raise RuntimeError("not memory")

    monkeypatch.setattr(RowStager, "stage", failing)
    small = _reg_df(6)
    with pytest.raises(RuntimeError, match="not memory"):
        CrossValidator(estimator=LinearRegression(), estimatorParamMaps=grid,
                       evaluator=RegressionEvaluator(), numFolds=3).fit(small)
    assert dc.get_device_cache().claimed_bytes() == 0
