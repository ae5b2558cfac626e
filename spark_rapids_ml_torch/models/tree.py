#
# Random forest shared layer: the port of spark_rapids_ml_tpu/models/tree.py.
# The Param mapping, Params and featureSubsetStrategy rule are the JAX
# package's host code, copied; the estimator fits through core.py's staged
# fit into ops/forest.py `forest_fit` (one device, trees one at a time);
# the model keeps the forest as host numpy arrays (the portable format the
# JAX package saves), uploads them to the device for transform
# (`forest_apply` over `_transform_mesh` chunks) and answers the
# inspection API and `cpu()` on the host (`_NumpyForestPredictor`, pure
# numpy).
#
from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..core import FitInput, _TpuEstimator, _TpuModel, weights_on
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasSeed,
    HasWeightCol,
    Param,
    TypeConverters,
    _TpuParams,
)


class _RandomForestClass:
    """Param mapping (Spark name -> backend name)."""

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "maxBins": "n_bins",
            "maxDepth": "max_depth",
            "numTrees": "n_estimators",
            "impurity": "split_criterion",
            "featureSubsetStrategy": "max_features",
            "bootstrap": "bootstrap",
            "seed": "random_state",
            "subsamplingRate": "max_samples",
            "minInstancesPerNode": "min_samples_leaf",
            "minInfoGain": "min_impurity_decrease",
            # accepted and ignored
            "maxMemoryInMB": "",
            "cacheNodeIds": "",
            "checkpointInterval": "",
            "minWeightFractionPerNode": "",
        }

    @classmethod
    def _param_value_mapping(cls):
        def subset_mapper(x):
            if x in ("auto", "all", "sqrt", "log2", "onethird"):
                return x
            try:
                xf = float(x)
                if xf == int(xf) and xf >= 1:
                    return int(xf)
                if 0.0 < xf <= 1.0:
                    return xf
            except ValueError:
                pass
            return None

        return {"featureSubsetStrategy": subset_mapper}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_estimators": 100,
            "max_depth": 16,
            "n_bins": 128,
            "max_features": "auto",
            "bootstrap": True,
            "random_state": None,
            "max_samples": 1.0,
            "min_samples_leaf": 1,
            "min_impurity_decrease": 0.0,
            "split_criterion": None,  # set per subclass (gini/variance)
            # width budget of the active-node frontier per level (ops/forest
            # builds exactly level-wise while 2^level <= max_active_nodes,
            # then best-first under this width); the histogram's size scales
            # with it, not with 2^max_depth
            "max_active_nodes": 256,
            "verbose": False,
        }


class _RandomForestParams(
    _TpuParams,
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasSeed,
    HasWeightCol,
):
    maxDepth = Param("_", "maxDepth", "Maximum depth of the tree.",
                     TypeConverters.toInt)
    maxBins = Param("_", "maxBins",
                    "Max number of bins for discretizing continuous features.",
                    TypeConverters.toInt)
    impurity = Param("_", "impurity", "Criterion for information gain.",
                     TypeConverters.toString)
    featureSubsetStrategy = Param(
        "_", "featureSubsetStrategy",
        "The number of features to consider for splits at each tree node: "
        "auto, all, onethird, sqrt, log2, n (int or fraction).",
        TypeConverters.toString)
    subsamplingRate = Param(
        "_", "subsamplingRate",
        "Fraction of the training data used for learning each tree.",
        TypeConverters.toFloat)
    minInstancesPerNode = Param(
        "_", "minInstancesPerNode",
        "Minimum number of instances each child must have after a split.",
        TypeConverters.toInt)
    minInfoGain = Param(
        "_", "minInfoGain",
        "Minimum information gain for a split to be considered.",
        TypeConverters.toFloat)
    bootstrap = Param("_", "bootstrap", "Whether bootstrap samples are used.",
                      TypeConverters.toBoolean)
    maxMemoryInMB = Param("_", "maxMemoryInMB", "ignored.", TypeConverters.toInt)
    cacheNodeIds = Param("_", "cacheNodeIds", "ignored.", TypeConverters.toBoolean)
    checkpointInterval = Param("_", "checkpointInterval", "ignored.",
                               TypeConverters.toInt)
    minWeightFractionPerNode = Param("_", "minWeightFractionPerNode", "ignored.",
                                     TypeConverters.toFloat)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(
            maxDepth=5,
            maxBins=32,
            featureSubsetStrategy="auto",
            subsamplingRate=1.0,
            minInstancesPerNode=1,
            minInfoGain=0.0,
            bootstrap=True,
        )

    def setFeaturesCol(self, value: Union[str, List[str]]):
        if isinstance(value, str):
            self._set_params(featuresCol=value)
        else:
            self._set_params(featuresCols=value)
        return self

    def setFeaturesCols(self, value: List[str]):
        return self._set_params(featuresCols=value)

    def setLabelCol(self, value: str):
        self._set(labelCol=value)
        return self

    def setPredictionCol(self, value: str):
        self._set(predictionCol=value)
        return self

    def setMaxDepth(self, value: int):
        return self._set_params(maxDepth=value)

    def setMaxBins(self, value: int):
        return self._set_params(maxBins=value)

    def setImpurity(self, value: str):
        return self._set_params(impurity=value)

    def setFeatureSubsetStrategy(self, value: str):
        return self._set_params(featureSubsetStrategy=value)

    def setSubsamplingRate(self, value: float):
        return self._set_params(subsamplingRate=value)

    def setMinInstancesPerNode(self, value: int):
        return self._set_params(minInstancesPerNode=value)

    def setMinInfoGain(self, value: float):
        return self._set_params(minInfoGain=value)

    def setBootstrap(self, value: bool):
        return self._set_params(bootstrap=value)

    def setSeed(self, value: int):
        return self._set_params(seed=value)

    def setWeightCol(self, value: str):
        return self._set_params(weightCol=value)


def _resolve_max_features(strategy, d: int, is_classification: bool) -> int:
    """featureSubsetStrategy -> #features per node (Spark semantics)."""
    if strategy in (None, "auto"):
        return (
            max(1, int(math.sqrt(d)))
            if is_classification
            else max(1, d // 3)
        )
    if strategy == "all":
        return d
    if strategy == "sqrt":
        return max(1, int(math.sqrt(d)))
    if strategy == "log2":
        return max(1, int(math.log2(d)))
    if strategy == "onethird":
        return max(1, d // 3)
    if isinstance(strategy, int):
        return max(1, min(strategy, d))
    if isinstance(strategy, float):
        return max(1, min(int(strategy * d), d))
    raise ValueError(f"Unsupported featureSubsetStrategy: {strategy}")


class _RandomForestEstimatorParams(_RandomForestParams):
    """numTrees lives only on the estimator: the fitted model exposes it as
    a property (pyspark _TreeEnsembleModel.numTrees), which cannot coexist
    with a Param descriptor of the same name."""

    numTrees = Param("_", "numTrees", "Number of trees to train.",
                     TypeConverters.toInt)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(numTrees=20)

    def setNumTrees(self, value: int):
        return self._set_params(numTrees=value)

    def getNumTrees(self) -> int:
        return self.getOrDefault("numTrees")


class _RandomForestEstimator(
    _RandomForestClass, _TpuEstimator, _RandomForestEstimatorParams
):
    """Shared fit logic of RandomForestClassifier and RandomForestRegressor."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_params(**kwargs)

    def _is_classification(self) -> bool:
        raise NotImplementedError

    def _is_supervised(self) -> bool:
        return True

    def _num_stat_classes(self, fit_input: FitInput) -> int:
        """Classes for the histogram channels (0 = regression)."""
        return 0

    def _criterion(self) -> int:
        from ..ops.forest import ENTROPY, GINI, VARIANCE

        imp = self._tpu_params.get("split_criterion")
        if imp is None:
            imp = "gini" if self._is_classification() else "variance"
        allowed = (
            {"gini": GINI, "entropy": ENTROPY}
            if self._is_classification()
            else {"variance": VARIANCE}
        )
        if imp not in allowed:
            raise ValueError(
                f"impurity '{imp}' is not supported for this task; "
                f"choose from {sorted(allowed)}"
            )
        return allowed[imp]

    def _fit_array(self, fit_input: FitInput) -> Dict[str, Any]:
        from ..ops.forest import forest_fit

        p = fit_input.params
        n_trees = int(p["n_estimators"])
        max_depth = int(p["max_depth"])
        seed = p.get("random_state")
        seed = int(seed) if seed is not None else int(self.getOrDefault("seed"))
        d = fit_input.pdesc.n
        max_features = _resolve_max_features(
            p.get("max_features", "auto"), d, self._is_classification()
        )
        trees = forest_fit(
            fit_input.X,
            fit_input.y,
            fit_input.w,
            seed,
            n_trees=n_trees,
            max_depth=max_depth,
            n_bins=int(p["n_bins"]),
            criterion=self._criterion(),
            n_classes=self._num_stat_classes(fit_input),
            max_features=max_features,
            min_instances=float(p["min_samples_leaf"]),
            min_info_gain=float(p["min_impurity_decrease"]),
            bootstrap=bool(p["bootstrap"]),
            subsample=float(p["max_samples"]),
            max_active=int(p.get("max_active_nodes", 256)),
        )
        return {
            "feature": trees.feature,
            "threshold": trees.threshold,
            "leaf_stats": trees.leaf_stats,
            "gain": trees.gain,
            "count": trees.count,
            "left_child": trees.left_child,
            "max_depth": max_depth,
            "n_cols": d,
            "dtype": str(np.dtype(fit_input.dtype).name),
        }

    def _cpu_fit(self, batch):
        raise NotImplementedError(
            f"{type(self).__name__} has no CPU fallback; unset unsupported params"
        )


class _RandomForestModel(_RandomForestClass, _TpuModel, _RandomForestParams):
    """Shared model logic: the forest as host arrays, transform on the
    device, inspection on the host."""

    def __init__(self, **attrs: Any) -> None:
        super().__init__(**attrs)
        self.feature: np.ndarray = np.asarray(attrs["feature"])
        self.threshold: np.ndarray = np.asarray(attrs["threshold"])
        self.leaf_stats: np.ndarray = np.asarray(attrs["leaf_stats"])
        self.gain: np.ndarray = np.asarray(attrs.get(
            "gain", np.zeros(self.feature.shape, np.float32)))
        self.count: np.ndarray = np.asarray(attrs.get(
            "count", np.zeros(self.feature.shape, np.float32)))
        if "left_child" in attrs:
            self.left_child: np.ndarray = np.asarray(attrs["left_child"])
        else:
            # models saved by the pre-node-table release used the implicit
            # heap layout: children of i at 2i+1 / 2i+2
            idx = np.arange(self.feature.shape[1], dtype=np.int32)
            heap = np.where(self.feature >= 0, 2 * idx + 1, -1)
            self.left_child = heap.astype(np.int32)
        self.max_depth: int = int(attrs["max_depth"])
        self.n_cols: int = int(attrs["n_cols"])
        self.dtype: str = str(attrs.get("dtype", "float32"))

    @property
    def numTrees(self) -> int:
        return int(self.feature.shape[0])

    @property
    def totalNumNodes(self) -> int:
        """Reachable (real) nodes across all trees."""
        return int(self._reachable_mask().sum())

    def _reachable_mask(self) -> np.ndarray:
        """(T, n_nodes) bool: nodes actually part of each tree.  Child
        table ids are always greater than the parent's (children are
        allocated level by level), so one ascending pass suffices."""
        T, n_nodes = self.feature.shape
        reach = np.zeros((T, n_nodes), bool)
        reach[:, 0] = True
        rows = np.arange(T)
        for i in range(n_nodes):
            split = reach[:, i] & (self.feature[:, i] >= 0)
            if not split.any():
                continue
            li = self.left_child[:, i]
            sel = rows[split]
            reach[sel, li[split]] = True
            reach[sel, li[split] + 1] = True
        return reach

    @property
    def treeWeights(self) -> List[float]:
        return [1.0] * self.numTrees

    @property
    def featureImportances(self) -> np.ndarray:
        """Gain-weighted importances, normalized per tree then averaged and
        re-normalized (Spark RandomForest.featureImportances semantics)."""
        T, max_nodes = self.feature.shape
        total = np.zeros((self.n_cols,), np.float64)
        for t in range(T):
            imp = np.zeros((self.n_cols,), np.float64)
            split = self.feature[t] >= 0
            np.add.at(
                imp,
                self.feature[t][split],
                (self.gain[t] * self.count[t])[split],
            )
            s = imp.sum()
            if s > 0:
                total += imp / s
        s = total.sum()
        return total / s if s > 0 else total

    def _leaves_and_stats(self, Xs):
        """(T, n) leaf of every row in every tree, and the (T, L, S) leaf
        statistics, on Xs's device in its dtype (thresholds cast to it)."""
        import torch

        from ..ops.forest import forest_apply

        def put(a, dtype):
            return weights_on(a, Xs.device, dtype)

        leaves = forest_apply(
            Xs,
            put(self.feature, torch.int64),
            put(self.threshold, Xs.dtype),
            put(self.left_child, torch.int64),
            max_depth=self.max_depth,
        )
        return leaves, put(self.leaf_stats, Xs.dtype)

    def toDebugString(self) -> str:
        """Text dump of the forest (Spark model.toDebugString parity)."""
        lines = [f"RandomForestModel with {self.numTrees} trees"]
        for t in range(self.numTrees):
            lines.append(f"  Tree {t}:")
            stack = [(0, 2)]
            while stack:
                node, indent = stack.pop()
                pad = " " * indent
                f = int(self.feature[t, node])
                if f < 0:
                    val = self.leaf_stats[t, node]
                    lines.append(f"{pad}Predict: {val.tolist()}")
                else:
                    thr = float(self.threshold[t, node])
                    lc = int(self.left_child[t, node])
                    lines.append(f"{pad}If (feature {f} <= {thr:.6g})")
                    stack.append((lc + 1, indent + 1))
                    stack.append((lc, indent + 1))
        return "\n".join(lines)

    def to_json(self) -> str:
        """Portable treelite-JSON-style export of the forest."""

        def node_dict(t: int, i: int) -> Dict[str, Any]:
            f = int(self.feature[t, i])
            if f < 0:
                return {"leaf_value": self.leaf_stats[t, i].tolist()}
            lc = int(self.left_child[t, i])
            return {
                "split_feature": f,
                "threshold": float(self.threshold[t, i]),
                "default_left": True,
                "left_child": node_dict(t, lc),
                "right_child": node_dict(t, lc + 1),
            }

        return json.dumps(
            {
                "num_trees": self.numTrees,
                "num_feature": self.n_cols,
                "trees": [node_dict(t, 0) for t in range(self.numTrees)],
            }
        )

    def _check_width(self, value) -> np.ndarray:
        v = np.asarray(value, np.float64).reshape(1, -1)
        if v.shape[1] != self.n_cols:
            raise ValueError(
                f"feature vector has {v.shape[1]} entries; model expects "
                f"{self.n_cols}"
            )
        return v


class _NumpyForestPredictor:
    """Host-side forest predictor over the portable model arrays (pure
    numpy)."""

    def __init__(self, model: _RandomForestModel, classification: bool) -> None:
        self.feature = model.feature
        self.threshold = model.threshold
        self.leaf_stats = model.leaf_stats
        self.left_child = model.left_child
        self.max_depth = model.max_depth
        self.classification = classification

    def _leaves(self, X: np.ndarray) -> np.ndarray:
        T, n = self.feature.shape[0], X.shape[0]
        node = np.zeros((T, n), np.int64)
        for _ in range(self.max_depth):
            f = np.take_along_axis(self.feature, node, axis=1)
            thr = np.take_along_axis(self.threshold, node, axis=1)
            lc = np.take_along_axis(self.left_child, node, axis=1)
            x = X[np.arange(n)[None, :], np.maximum(f, 0)]
            child = lc + (x > thr)
            node = np.where(f < 0, node, child)
        return node

    def predict(self, X: np.ndarray) -> np.ndarray:
        leaves = self._leaves(np.asarray(X))
        stats = np.take_along_axis(
            self.leaf_stats, leaves[:, :, None], axis=1
        )
        if self.classification:
            sums = np.maximum(stats.sum(axis=2, keepdims=True), 1e-12)
            return np.argmax((stats / sums).sum(axis=0), axis=1)
        w = np.maximum(stats[:, :, 0], 1e-12)
        return (stats[:, :, 1] / w).mean(axis=0)

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        if not self.classification:
            raise ValueError("predict_proba needs a classification forest")
        leaves = self._leaves(np.asarray(X))
        stats = np.take_along_axis(
            self.leaf_stats, leaves[:, :, None], axis=1
        )
        sums = np.maximum(stats.sum(axis=2, keepdims=True), 1e-12)
        probs = (stats / sums).sum(axis=0)
        return probs / probs.sum(axis=1, keepdims=True)


__all__ = [
    "_NumpyForestPredictor",
    "_RandomForestClass",
    "_RandomForestParams",
    "_RandomForestEstimator",
    "_RandomForestModel",
    "_resolve_max_features",
]
