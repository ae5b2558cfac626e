#
# Core runtime: the port of the parts of spark_rapids_ml_tpu/core.py the
# exact-kNN slice needs.
#
#   Estimator / Transformer / Model   pyspark.ml-style bases
#   _Writer / _ReadWriteMixin         persistence, in the JAX package's
#                                     on-disk format: <path>/metadata.json
#                                     (class, uid, params, "tpu_params",
#                                     scalar attributes) and
#                                     <path>/arrays.npz (array attributes;
#                                     CSR attributes as __csr_* parts), so
#                                     a model saved by either package loads
#                                     in the other
#   _TpuCaller / _TpuEstimator / _TpuModel   the estimator and model bases
#
# Telemetry, resilience and the generic staged fit are later slices:
# `fit_report()` returns None until then.
#
from __future__ import annotations

import json
import os
import time
from abc import abstractmethod
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .data import DatasetLike, _is_sparse
from .params import Param, Params, _TpuParams
from .utils import get_logger


def _resolve_feature_params(inst: Params) -> Tuple[Optional[str], Sequence[str]]:
    """Which column(s) hold features: featuresCol/featuresCols for
    predictors, inputCol/inputCols for feature transformers."""
    features_cols: Sequence[str] = ()
    if inst.hasParam("featuresCols") and inst.isSet("featuresCols"):
        features_cols = inst.getOrDefault("featuresCols")
    elif inst.hasParam("inputCols") and inst.isSet("inputCols"):
        features_cols = inst.getOrDefault("inputCols")
    features_col: Optional[str] = None
    if inst.hasParam("featuresCol") and inst.isDefined("featuresCol"):
        features_col = inst.getOrDefault("featuresCol")
    if inst.hasParam("inputCol") and inst.isSet("inputCol"):
        features_col = inst.getOrDefault("inputCol")
    return features_col, features_cols


class Estimator(Params):
    """pyspark.ml.Estimator-compatible base."""

    def fit(self, dataset: DatasetLike, params: Optional[Dict[Param, Any]] = None):
        est = self.copy(params) if params else self
        return est._fit(dataset)

    @abstractmethod
    def _fit(self, dataset: DatasetLike):
        ...


class Transformer(Params):
    """pyspark.ml.Transformer-compatible base."""

    def transform(self, dataset: DatasetLike, params: Optional[Dict[Param, Any]] = None):
        tr = self.copy(params) if params else self
        return tr._transform(dataset)

    @abstractmethod
    def _transform(self, dataset: DatasetLike):
        ...


class Model(Transformer):
    def fit_report(self) -> Optional[Dict[str, Any]]:
        """The fit's telemetry report; the port records none yet."""
        return None


def _json_default(o: Any) -> Any:
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


class _Writer:
    def __init__(self, instance: "_TpuParams") -> None:
        self.instance = instance
        self._overwrite = False

    def overwrite(self) -> "_Writer":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        if os.path.exists(path) and not self._overwrite:
            raise IOError(f"Path {path} already exists; use .write().overwrite().save()")
        os.makedirs(path, exist_ok=True)
        inst = self.instance
        metadata: Dict[str, Any] = {
            "class": type(inst).__module__ + "." + type(inst).__qualname__,
            "uid": inst.uid,
            "timestamp": int(time.time() * 1000),
            "paramMap": {p.name: v for p, v in inst._paramMap.items()},
            "defaultParamMap": {p.name: v for p, v in inst._defaultParamMap.items()},
            "tpu_params": inst._tpu_params,
            "num_workers": inst._num_workers,
            "float32_inputs": inst._float32_inputs,
        }
        arrays: Dict[str, np.ndarray] = {}
        if isinstance(inst, _TpuModel):
            attrs: Dict[str, Any] = {}
            sparse_attrs: List[str] = []
            for k, v in inst._get_model_attributes().items():
                if _is_sparse(v):
                    csr = v.tocsr()
                    arrays[k + "__csr_data"] = np.asarray(csr.data)
                    arrays[k + "__csr_indices"] = np.asarray(csr.indices)
                    arrays[k + "__csr_indptr"] = np.asarray(csr.indptr)
                    arrays[k + "__csr_shape"] = np.asarray(csr.shape, np.int64)
                    sparse_attrs.append(k)
                elif isinstance(v, np.ndarray):
                    arrays[k] = v
                else:
                    attrs[k] = v
            metadata["attributes"] = attrs
            metadata["array_attributes"] = sorted(arrays)
            if sparse_attrs:
                metadata["sparse_attributes"] = sorted(sparse_attrs)
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f, default=_json_default)
        npz_path = os.path.join(path, "arrays.npz")
        if os.path.exists(npz_path):
            os.remove(npz_path)  # stale arrays from a previous overwrite-save
        if arrays:
            np.savez(npz_path, **arrays)


def _load_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "metadata.json")) as f:
        return json.load(f)


def _load_arrays(path: str) -> Dict[str, np.ndarray]:
    npz_path = os.path.join(path, "arrays.npz")
    if not os.path.exists(npz_path):
        return {}
    with np.load(npz_path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class _ReadWriteMixin:
    """save/load entry points shared by estimators and models.  `load`
    reads the class from the caller, not from metadata.json, so a model
    saved by the JAX package loads here and the reverse."""

    def write(self) -> _Writer:
        return _Writer(self)  # type: ignore[arg-type]

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def _restore_params(cls, inst: "_TpuParams", meta: Dict[str, Any]) -> None:
        for name, v in meta.get("defaultParamMap", {}).items():
            if inst.hasParam(name):
                inst._defaultParamMap[inst.getParam(name)] = v
        for name, v in meta.get("paramMap", {}).items():
            if inst.hasParam(name):
                inst._paramMap[inst.getParam(name)] = v
        inst._tpu_params = dict(meta.get("tpu_params", {}))
        inst._num_workers = meta.get("num_workers")
        inst._float32_inputs = meta.get("float32_inputs", True)

    @classmethod
    def load(cls, path: str):
        meta = _load_metadata(path)
        if issubclass(cls, _TpuModel):
            arrays = _load_arrays(path)
            wanted = meta.get("array_attributes")
            if wanted is not None:
                arrays = {k: v for k, v in arrays.items() if k in wanted}
            for name in meta.get("sparse_attributes", []):
                import scipy.sparse as sp

                arrays[name] = sp.csr_matrix(
                    (
                        arrays.pop(name + "__csr_data"),
                        arrays.pop(name + "__csr_indices"),
                        arrays.pop(name + "__csr_indptr"),
                    ),
                    shape=tuple(arrays.pop(name + "__csr_shape")),
                )
            attrs = dict(meta.get("attributes", {}))
            attrs.update(arrays)
            inst = cls._from_attributes(attrs)
        else:
            inst = cls()
        cls._restore_params(inst, meta)
        return inst

    @classmethod
    def read(cls):
        class _Reader:
            @staticmethod
            def load(path: str):
                return cls.load(path)

        return _Reader()


class _TpuCaller(_TpuParams, _ReadWriteMixin):
    def _out_dtype(self, X: np.ndarray) -> np.dtype:
        # float64 stays float64 only when float32_inputs is disabled
        if X.dtype == np.float64 and not self._float32_inputs:
            return np.dtype(np.float64)
        return np.dtype(np.float32)


class _TpuEstimator(Estimator, _TpuCaller):
    """Estimator base.  The kNN estimator implements `_fit` itself (it
    stages nothing at fit time); the generic staged fit comes with the
    first estimator that trains."""

    def __init__(self) -> None:
        super().__init__()
        self._init_tpu_params()
        self.logger = get_logger(type(self))


class _TpuModel(Model, _TpuCaller):
    def __init__(self, **model_attributes: Any) -> None:
        super().__init__()
        self._init_tpu_params()
        self._model_attributes = model_attributes
        self.logger = get_logger(type(self))

    def _get_model_attributes(self) -> Dict[str, Any]:
        return self._model_attributes

    @classmethod
    def _from_attributes(cls, attrs: Dict[str, Any]) -> "_TpuModel":
        return cls(**attrs)
