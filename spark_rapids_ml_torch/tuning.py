#
# Model selection: the port of spark_rapids_ml_tpu/tuning.py.
# `ParamGridBuilder`, and `CrossValidator`, which fits every param map of a
# fold in one pass (`fitMultiple`) and scores the fold's models in one
# (`_combine`, `_transformEvaluate`).  On the stage-once dataset cache
# (parallel/device_cache.py, conf `device_cache`) the whole run stages the
# dataset once: each fold's train rows are a weight mask or a gathered view
# on the device, its eval rows a gathered view, and the refit of the best
# map fits the resident dataset.  Anything that makes the cache ineligible
# (off, over budget, the card out of memory while staging, CSR) keeps the
# legacy path, which slices each fold on the host and stages it.
#
# `CrossValidatorModel.load` finds the best model's class among the port's
# own model classes by its name and imports no module the metadata names,
# so a directory the JAX package saved loads here as the port's model.
#
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .core import _TpuEstimator, _TpuModel
from .data import DatasetLike
from .params import Param, Params, TypeConverters
from .utils import get_logger


class ParamGridBuilder:
    """pyspark.ml.tuning.ParamGridBuilder parity."""

    def __init__(self) -> None:
        self._grid: Dict[Param, List[Any]] = {}

    def addGrid(self, param: Param, values: Sequence[Any]) -> "ParamGridBuilder":
        self._grid[param] = list(values)
        return self

    def baseOn(self, *args: Any) -> "ParamGridBuilder":
        # pyspark convention: one dict, or N (param, value) pairs
        items = args[0].items() if isinstance(args[0], dict) else list(args)
        for param, value in items:
            self.addGrid(param, [value])
        return self

    def build(self) -> List[Dict[Param, Any]]:
        keys = list(self._grid.keys())
        return [
            dict(zip(keys, combo))
            for combo in itertools.product(*(self._grid[k] for k in keys))
        ]


def _to_pandas_with_labels(dataset: DatasetLike, estimator: Params):
    """CV needs a row-indexable frame; tuples/arrays are adapted onto the
    estimator's featuresCol/labelCol."""
    import pandas as pd

    if isinstance(dataset, pd.DataFrame):
        return dataset
    if isinstance(dataset, (tuple, list)) and len(dataset) == 2:
        X, y = dataset
        features_col = (
            estimator.getOrDefault("featuresCol")
            if estimator.hasParam("featuresCol")
            else "features"
        )
        label_col = (
            estimator.getOrDefault("labelCol")
            if estimator.hasParam("labelCol")
            else "label"
        )
        return pd.DataFrame(
            {
                features_col: list(np.asarray(X)),
                label_col: np.asarray(y).reshape(-1),
            }
        )
    raise TypeError(
        f"CrossValidator requires a pandas DataFrame or (X, y); got {type(dataset)}"
    )


class CrossValidator(Params):
    """K-fold cross validation with single-pass multi-model fit/eval
    (reference CrossValidator tuning.py:40-186).

    Per fold: `estimator.fitMultiple` stages the fold's training rows onto
    the mesh ONCE and fits every param map against the resident arrays
    (reference tuning.py:115-128); the fitted models are `_combine`d and
    evaluated against the fold's eval rows in one staging.

    Examples
    --------
    >>> import numpy as np, pandas as pd
    >>> from spark_rapids_ml_torch.classification import LogisticRegression
    >>> from spark_rapids_ml_torch.evaluation import MulticlassClassificationEvaluator
    >>> from spark_rapids_ml_torch.tuning import CrossValidator, ParamGridBuilder
    >>> rng = np.random.default_rng(0)
    >>> X = rng.normal(size=(200, 4)); y = (X[:, 0] > 0).astype(float)
    >>> df = pd.DataFrame({"features": list(X), "label": y})
    >>> lr = LogisticRegression(maxIter=50)
    >>> grid = ParamGridBuilder().addGrid(lr.regParam, [0.0, 0.1]).build()
    >>> cv = CrossValidator(estimator=lr, estimatorParamMaps=grid,
    ...     evaluator=MulticlassClassificationEvaluator(metricName="accuracy"),
    ...     numFolds=3, seed=5)
    >>> model = cv.fit(df)
    >>> len(model.avgMetrics)
    2
    """

    numFolds = Param("_", "numFolds", "number of folds.", TypeConverters.toInt)
    seed = Param("_", "seed", "random seed.", TypeConverters.toInt)
    parallelism = Param("_", "parallelism", "ignored (single controller).",
                        TypeConverters.toInt)
    foldCol = Param("_", "foldCol",
                    "column with the fold index of each row (optional).",
                    TypeConverters.toString)

    def __init__(
        self,
        estimator: Optional[_TpuEstimator] = None,
        estimatorParamMaps: Optional[List[Dict[Param, Any]]] = None,
        evaluator: Optional[Any] = None,
        numFolds: int = 3,
        seed: Optional[int] = None,
        parallelism: int = 1,
        foldCol: str = "",
    ) -> None:
        super().__init__()
        self._setDefault(numFolds=3, seed=42, parallelism=1, foldCol="")
        self.setEstimator(estimator)
        self.setEstimatorParamMaps(estimatorParamMaps or [])
        self.setEvaluator(evaluator)
        self._set(numFolds=numFolds, parallelism=parallelism, foldCol=foldCol)
        if seed is not None:
            self._set(seed=seed)
        # introspection for tests/bench: did the last fit run on the
        # device-resident cache path or the legacy host-slicing loop?
        self._last_fit_used_cache = False
        self.logger = get_logger(type(self))

    def setEstimator(self, value: Optional[_TpuEstimator]) -> "CrossValidator":
        self._estimator = value
        return self

    def getEstimator(self) -> Optional[_TpuEstimator]:
        return self._estimator

    def setEstimatorParamMaps(
        self, value: List[Dict[Param, Any]]
    ) -> "CrossValidator":
        self._param_maps = value
        return self

    def getEstimatorParamMaps(self) -> List[Dict[Param, Any]]:
        return self._param_maps

    def setEvaluator(self, value: Any) -> "CrossValidator":
        self._evaluator = value
        return self

    def getEvaluator(self) -> Any:
        return self._evaluator

    def setNumFolds(self, value: int) -> "CrossValidator":
        self._set(numFolds=value)
        return self

    def fit(self, dataset: DatasetLike) -> "CrossValidatorModel":
        est = self._estimator
        evaluator = self._evaluator
        param_maps = self._param_maps
        if est is None or evaluator is None or not param_maps:
            raise ValueError(
                "CrossValidator requires estimator, estimatorParamMaps and evaluator"
            )
        # the JAX package wraps the run in its telemetry's run context and
        # trace span: a seam until telemetry is ported
        return self._fit_cv(est, evaluator, param_maps, dataset)

    def _fit_cv(
        self, est, evaluator, param_maps, dataset: DatasetLike
    ) -> "CrossValidatorModel":
        df = _to_pandas_with_labels(dataset, est)
        n = len(df)
        k = self.getOrDefault("numFolds")
        fold_col = self.getOrDefault("foldCol")
        if fold_col:
            folds = df[fold_col].to_numpy()
            if folds.min() < 0 or folds.max() >= k:
                raise ValueError(
                    f"foldCol values must be in [0, numFolds={k}); got "
                    f"range [{folds.min()}, {folds.max()}]"
                )
        else:
            rng = np.random.default_rng(self.getOrDefault("seed"))
            folds = rng.integers(0, k, size=n)
        for fold in range(k):
            if not np.any(folds == fold):
                raise ValueError(
                    f"Fold {fold} has no validation rows; use fewer folds "
                    f"or more data (n={n}, numFolds={k})"
                )

        # stage-once fast path (parallel/device_cache.py): the full
        # dataset becomes resident on the mesh and every fold's
        # train/eval selection derives ON DEVICE — the whole CV run
        # (k folds x fitMultiple + eval, plus the best-model refit) pays
        # ONE host->device staging instead of 2k+1.  Anything that makes
        # the cache ineligible (off, over budget, sparse, multi-process,
        # CPU fallback) keeps the legacy host-slicing loop.
        from .parallel.device_cache import LAST_DECISION, cache_enabled

        entry = None
        LAST_DECISION.clear()
        if isinstance(est, _TpuEstimator):
            entry = est._cached_fit_entry(df)
        self._last_fit_used_cache = entry is not None
        # what the fit did: the cache's decision ("staged", "hit",
        # "over_budget", "hit_over_budget", "oom"; "off" with the conf off,
        # "ineligible" when the estimator or the data keep the legacy path)
        report = {
            "used_cache": entry is not None,
            "cache": dict(LAST_DECISION) if LAST_DECISION
            else {"outcome": "ineligible" if cache_enabled() else "off"},
            "fold_views": None if entry is None
            else ("mask" if est._supports_fold_weights() else "gather"),
        }
        if entry is not None:
            model = self._fit_cached(est, evaluator, param_maps, df, folds, k, entry)
        else:
            model = self._fit_legacy(est, evaluator, param_maps, df, folds, k)
        model._fit_report = report
        return model

    def _fit_legacy(
        self, est, evaluator, param_maps, df, folds, k: int
    ) -> "CrossValidatorModel":
        """Per-fold host slicing + restaging (the pre-cache path; also
        the parity reference for the cached path)."""
        n_models = len(param_maps)
        metrics = np.zeros((n_models,), np.float64)
        for fold in range(k):
            train = df[folds != fold].reset_index(drop=True)
            val = df[folds == fold].reset_index(drop=True)
            # ONE pass over the fold's training data for all param maps
            models: List[Optional[_TpuModel]] = [None] * n_models
            for index, model in est.fitMultiple(train, param_maps):
                models[index] = model
            combined = models[0]._combine([m for m in models if m is not None])
            fold_metrics = combined._transformEvaluate(val, evaluator)
            metrics += np.asarray(fold_metrics) / k
            self.logger.info(f"fold {fold}: metrics {fold_metrics}")

        best = (
            int(np.argmax(metrics))
            if evaluator.isLargerBetter()
            else int(np.argmin(metrics))
        )
        best_model = est.fit(df, param_maps[best])
        return CrossValidatorModel(
            bestModel=best_model,
            avgMetrics=list(metrics),
            bestIndex=best,
        )

    def _fit_cached(
        self, est, evaluator, param_maps, df, folds, k: int, entry
    ) -> "CrossValidatorModel":
        """Device-resident CV path: fold train views are weight masks
        (weight-capable kernels) or on-device gather/compaction views
        (everything else — also the choice for seeded row-count-sensitive
        inits, where the gather view reproduces the legacy trajectory);
        eval scores the resident rows; the refit fits the resident full
        dataset.  Zero restaging for the entire run."""
        fold_set = entry.fold_set(folds)  # the run's own: see FoldSet
        use_mask = est._supports_fold_weights()
        self.logger.info(
            f"CV on resident dataset cache ({'weight-mask' if use_mask else 'gather'} "
            f"fold views, {entry.nbytes / 2**20:.0f} MiB resident)"
        )
        n_models = len(param_maps)
        metrics = np.zeros((n_models,), np.float64)
        for fold in range(k):
            train_view = (
                fold_set.train_view(fold)
                if use_mask
                else fold_set.gather_train_view(fold)
            )
            models: List[Optional[_TpuModel]] = [None] * n_models
            for index, model in est.fitMultiple(train_view, param_maps):
                models[index] = model
            del train_view
            val_view = fold_set.eval_view(
                fold, df[folds == fold].reset_index(drop=True)
            )
            combined = models[0]._combine(
                [m for m in models if m is not None]
            )
            fold_metrics = combined._transformEvaluate(val_view, evaluator)
            del val_view
            metrics += np.asarray(fold_metrics) / k
            self.logger.info(f"fold {fold}: metrics {fold_metrics}")

        best = (
            int(np.argmax(metrics))
            if evaluator.isLargerBetter()
            else int(np.argmin(metrics))
        )
        # zero-staging refit: the resident full dataset IS the training set
        best_model = est.fit(entry.dataset, param_maps[best])
        return CrossValidatorModel(
            bestModel=best_model,
            avgMetrics=list(metrics),
            bestIndex=best,
        )


class CrossValidatorModel:
    """Fitted CV result (pyspark CrossValidatorModel parity: bestModel +
    avgMetrics; transform delegates to bestModel)."""

    def __init__(
        self,
        bestModel: _TpuModel,
        avgMetrics: List[float],
        bestIndex: int = 0,
    ) -> None:
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics
        self.bestIndex = bestIndex
        self._fit_report: Optional[Dict[str, Any]] = None

    def fit_report(self) -> Optional[Dict[str, Any]]:
        """Whether the fit ran on the dataset cache, the cache's decision
        and its bytes, and the fold views' kind; None for a loaded model."""
        return self._fit_report

    def transform(self, dataset: DatasetLike):
        return self.bestModel.transform(dataset)

    def save(self, path: str) -> None:
        import json
        import os

        os.makedirs(path, exist_ok=True)
        self.bestModel.save(os.path.join(path, "bestModel"))
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(
                {
                    "avgMetrics": [float(m) for m in self.avgMetrics],
                    "bestIndex": int(self.bestIndex),
                    "bestModelClass": type(self.bestModel).__module__
                    + "."
                    + type(self.bestModel).__qualname__,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "CrossValidatorModel":
        import json
        import os

        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        model_cls = _port_model_class(meta["bestModelClass"])
        best = model_cls.load(os.path.join(path, "bestModel"))
        return cls(best, meta["avgMetrics"], meta["bestIndex"])


def _port_model_class(qualified: str) -> type:
    """The port's model class of the name a `bestModelClass` entry ends
    with (the JAX package's and the port's model classes share their
    names); the module the entry names is never imported."""
    from .models import classification, clustering, feature, knn, regression

    name = qualified.rpartition(".")[2]
    for module in (classification, regression, feature, clustering, knn):
        found = getattr(module, name, None)
        if isinstance(found, type) and issubclass(found, _TpuModel):
            return found
    raise ValueError(f"no model class of the port is named {name!r} ({qualified})")


__all__ = ["CrossValidator", "CrossValidatorModel", "ParamGridBuilder"]
