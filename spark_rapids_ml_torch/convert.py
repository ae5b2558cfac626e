#
# Carry a fitted model between the JAX package and the port without a
# round trip through disk.  Both sides are plain numpy: the JAX model's
# `_get_model_attributes()` and its param maps in, a port model out, and
# the reverse.  Nothing here imports JAX.
#
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .core import _ReadWriteMixin
from .data import _is_sparse
from .models.classification import LogisticRegressionModel, RandomForestClassificationModel
from .models.clustering import KMeansModel
from .models.feature import PCAModel
from .models.knn import NearestNeighborsModel
from .models.regression import LinearRegressionModel, RandomForestRegressionModel
from .models.tree import _RandomForestModel


def model_params(model: Any) -> Dict[str, Any]:
    """The param maps of a model of either package, under the keys of its
    metadata.json: paramMap, defaultParamMap, tpu_params, num_workers,
    float32_inputs."""
    return {
        "paramMap": {p.name: v for p, v in model._paramMap.items()},
        "defaultParamMap": {p.name: v for p, v in model._defaultParamMap.items()},
        "tpu_params": dict(model._tpu_params),
        "num_workers": model._num_workers,
        "float32_inputs": model._float32_inputs,
    }


def nn_model_from_reference(attrs: Dict[str, Any], params: Dict[str, Any]) -> NearestNeighborsModel:
    """A port `NearestNeighborsModel` from the JAX model's attributes
    (`_get_model_attributes()`) and param maps (`model_params`)."""
    model = NearestNeighborsModel(**dict(attrs))
    _ReadWriteMixin._restore_params(model, params)
    return model


def nn_model_to_reference_attributes(model: NearestNeighborsModel) -> Dict[str, Any]:
    """The attributes the JAX `NearestNeighborsModel(**attrs)` takes, as
    numpy arrays and scalars (a CSR item set stays CSR)."""
    feats = model.item_features
    return {
        "item_features": feats.copy() if _is_sparse(feats) else np.array(feats),
        "item_ids": np.array(model.item_ids),
        "n_cols": int(model.n_cols),
        "dtype": str(model.dtype),
    }


def logreg_model_from_reference(attrs: Dict[str, Any],
                                params: Dict[str, Any]) -> LogisticRegressionModel:
    """A port `LogisticRegressionModel` from the JAX model's attributes
    (`_get_model_attributes()`) and param maps (`model_params`)."""
    model = LogisticRegressionModel(**dict(attrs))
    _ReadWriteMixin._restore_params(model, params)
    return model


def logreg_model_to_reference_attributes(model: LogisticRegressionModel) -> Dict[str, Any]:
    """The attributes the JAX `LogisticRegressionModel(**attrs)` takes, as
    numpy arrays and plain scalars and lists."""
    return {
        "coef_": np.array(model.coef_),
        "intercept_": np.array(model.intercept_),
        "classes_": list(model.classes_),
        "n_cols": int(model.n_cols),
        "dtype": str(model.dtype),
        "num_iters": int(model.num_iters),
        "objective": float(model.objective),
        "objective_history": list(model.objective_history),
    }


def pca_model_from_reference(attrs: Dict[str, Any], params: Dict[str, Any]) -> PCAModel:
    """A port `PCAModel` from the JAX model's attributes and param maps."""
    model = PCAModel(**dict(attrs))
    _ReadWriteMixin._restore_params(model, params)
    return model


def pca_model_to_reference_attributes(model: PCAModel) -> Dict[str, Any]:
    """The attributes the JAX `PCAModel(**attrs)` takes."""
    return {
        "mean_": np.array(model.mean_),
        "components_": np.array(model.components_),
        "explained_variance_": np.array(model.explained_variance_),
        "explained_variance_ratio_": np.array(model.explained_variance_ratio_),
        "singular_values_": np.array(model.singular_values_),
        "n_cols": int(model.n_cols),
        "dtype": str(model.dtype),
    }


def linreg_model_from_reference(attrs: Dict[str, Any],
                                params: Dict[str, Any]) -> LinearRegressionModel:
    """A port `LinearRegressionModel` from the JAX model's attributes and
    param maps."""
    model = LinearRegressionModel(**dict(attrs))
    _ReadWriteMixin._restore_params(model, params)
    return model


def linreg_model_to_reference_attributes(model: LinearRegressionModel) -> Dict[str, Any]:
    """The attributes the JAX `LinearRegressionModel(**attrs)` takes."""
    return {
        "coef_": np.array(model.coef_),
        "intercept_": float(model.intercept_),
        "n_iter_": int(model.n_iter_),
        "rmse_": float(model.rmse_),
        "mse_": float(model.mse_),
        "r2_": float(model.r2_),
        "n_cols": int(model.n_cols),
        "dtype": str(model.dtype),
    }


def kmeans_model_from_reference(attrs: Dict[str, Any], params: Dict[str, Any]) -> KMeansModel:
    """A port `KMeansModel` from the JAX model's attributes and param maps.
    (A DBSCAN model carries only params: `_restore_params` on a fresh
    `DBSCANModel` carries it.)"""
    model = KMeansModel(**dict(attrs))
    _ReadWriteMixin._restore_params(model, params)
    return model


def kmeans_model_to_reference_attributes(model: KMeansModel) -> Dict[str, Any]:
    """The attributes the JAX `KMeansModel(**attrs)` takes."""
    return {
        "cluster_centers_": np.array(model.cluster_centers_),
        "inertia_": float(model.inertia_),
        "n_iter_": int(model.n_iter_),
        "n_cols": int(model.n_cols),
        "dtype": str(model.dtype),
    }


_RF_ARRAYS = ("feature", "threshold", "leaf_stats", "gain", "count", "left_child")


def rf_model_from_reference(attrs: Dict[str, Any], params: Dict[str, Any]) -> _RandomForestModel:
    """A port RandomForest model from the JAX model's attributes and param
    maps: a `RandomForestClassificationModel` where the attributes carry
    `num_classes` (every JAX classifier fit sets it), else a
    `RandomForestRegressionModel`."""
    cls = (RandomForestClassificationModel if "num_classes" in attrs
           else RandomForestRegressionModel)
    model = cls(**dict(attrs))
    _ReadWriteMixin._restore_params(model, params)
    return model


def rf_model_to_reference_attributes(model: _RandomForestModel) -> Dict[str, Any]:
    """The attributes the JAX `RandomForestClassificationModel(**attrs)` or
    `RandomForestRegressionModel(**attrs)` takes: the forest's arrays as
    numpy, and its scalars."""
    out: Dict[str, Any] = {k: np.array(getattr(model, k)) for k in _RF_ARRAYS}
    out.update(max_depth=int(model.max_depth), n_cols=int(model.n_cols),
               dtype=str(model.dtype))
    if isinstance(model, RandomForestClassificationModel):
        out["num_classes"] = int(model.num_classes)
    return out
