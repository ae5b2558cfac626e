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
from .models.classification import LogisticRegressionModel
from .models.knn import NearestNeighborsModel


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
