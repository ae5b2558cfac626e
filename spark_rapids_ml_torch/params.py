#
# Param system — the port of the parts of spark_rapids_ml_tpu/params.py the
# kNN, LogisticRegression, PCA and LinearRegression slices use: a
# pyspark.ml-style `Param`/`Params` implementation plus the Spark-name ->
# backend-name mapping layer (`_TpuClass`/`_TpuParams`).  The backend param
# dict keeps the name `_tpu_params` and persists under the same
# "tpu_params" metadata key, so a model saved by either package loads in
# the other.
#
from __future__ import annotations

import copy
from abc import ABC
from typing import Any, Callable, Dict, List, Optional, TypeVar, Union

P = TypeVar("P", bound="Params")


class TypeConverters:
    """Minimal pyspark.ml.param.TypeConverters equivalent."""

    @staticmethod
    def toInt(value: Any) -> int:
        if isinstance(value, bool):
            raise TypeError(f"Could not convert {value} to int")
        return int(value)

    @staticmethod
    def toFloat(value: Any) -> float:
        return float(value)

    @staticmethod
    def toBoolean(value: Any) -> bool:
        if isinstance(value, bool):
            return value
        raise TypeError(f"Boolean Param requires value of type bool. Found {type(value)}.")

    @staticmethod
    def toString(value: Any) -> str:
        return str(value)

    @staticmethod
    def toListFloat(value: Any) -> List[float]:
        return [float(v) for v in value]

    @staticmethod
    def toListString(value: Any) -> List[str]:
        return [str(v) for v in value]

    @staticmethod
    def identity(value: Any) -> Any:
        return value


class Param:
    """A param with self-contained documentation (pyspark.ml.param.Param)."""

    def __init__(
        self,
        parent: Union["Params", str],
        name: str,
        doc: str,
        typeConverter: Optional[Callable[[Any], Any]] = None,
    ):
        self.parent = parent.uid if isinstance(parent, Params) else parent
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter or TypeConverters.identity

    def _copy_new_parent(self, parent: "Params") -> "Param":
        p = copy.copy(self)
        p.parent = parent.uid
        return p

    def __str__(self) -> str:
        return f"{self.parent}__{self.name}"

    def __repr__(self) -> str:
        return f"Param(parent={self.parent!r}, name={self.name!r})"

    def __hash__(self) -> int:
        return hash(str(self))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Param) and str(self) == str(other)


_uid_counters: Dict[str, int] = {}


def _gen_uid(cls_name: str) -> str:
    n = _uid_counters.get(cls_name, 0)
    _uid_counters[cls_name] = n + 1
    return f"{cls_name}_{n:04x}"


class Params(ABC):
    """pyspark.ml.param.Params-compatible base: a components container for
    params with user-set values and defaults.  Param objects are declared as
    class attributes with a string parent and re-bound per instance."""

    def __init__(self) -> None:
        self.uid = _gen_uid(type(self).__name__)
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}
        self._params: Optional[List[Param]] = None
        self._copy_class_params()

    def _copy_class_params(self) -> None:
        for name in dir(type(self)):
            attr = getattr(type(self), name, None)
            if isinstance(attr, Param):
                setattr(self, name, attr._copy_new_parent(self))

    @property
    def params(self) -> List[Param]:
        if self._params is None:
            self._params = sorted(
                [
                    getattr(self, x)
                    for x in dir(self)
                    if x != "params" and isinstance(getattr(self, x, None), Param)
                ],
                key=lambda p: p.name,
            )
        return self._params

    def hasParam(self, paramName: str) -> bool:
        return isinstance(getattr(self, paramName, None), Param)

    def getParam(self, paramName: str) -> Param:
        p = getattr(self, paramName, None)
        if not isinstance(p, Param):
            raise ValueError(f"Cannot find param with name {paramName}.")
        return p

    def _resolveParam(self, param: Union[str, Param]) -> Param:
        return self.getParam(param) if isinstance(param, str) else param

    def isSet(self, param: Union[str, Param]) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param: Union[str, Param]) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param: Union[str, Param]) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def getOrDefault(self, param: Union[str, Param]) -> Any:
        param = self._resolveParam(param)
        if param in self._paramMap:
            return self._paramMap[param]
        if param in self._defaultParamMap:
            return self._defaultParamMap[param]
        raise KeyError(f"Param {param.name} is neither set nor has a default value.")

    def get(self, param: Union[str, Param]) -> Any:
        return self.getOrDefault(param)

    def _set(self, **kwargs: Any) -> "Params":
        for name, value in kwargs.items():
            p = self.getParam(name)
            if value is not None:
                try:
                    value = p.typeConverter(value)
                except (TypeError, ValueError) as e:
                    raise TypeError(f'Invalid param value given for param "{name}". {e}')
            self._paramMap[p] = value
        return self

    def set(self, param: Union[str, Param], value: Any) -> "Params":
        param = self._resolveParam(param)
        return self._set(**{param.name: value})

    def _setDefault(self, **kwargs: Any) -> "Params":
        for name, value in kwargs.items():
            p = self.getParam(name)
            self._defaultParamMap[p] = value
        return self

    def clear(self, param: Union[str, Param]) -> None:
        param = self._resolveParam(param)
        self._paramMap.pop(param, None)

    def extractParamMap(self, extra: Optional[Dict[Param, Any]] = None) -> Dict[Param, Any]:
        pm = dict(self._defaultParamMap)
        pm.update(self._paramMap)
        if extra:
            pm.update(extra)
        return pm

    def explainParam(self, param: Union[str, Param]) -> str:
        param = self._resolveParam(param)
        default = (
            f"default: {self._defaultParamMap[param]}" if self.hasDefault(param) else "undefined"
        )
        cur = f", current: {self._paramMap[param]}" if self.isSet(param) else ""
        return f"{param.name}: {param.doc} ({default}{cur})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)

    def copy(self: P, extra: Optional[Dict[Param, Any]] = None) -> P:
        that = copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        that._params = None
        if hasattr(self, "_tpu_params"):
            that._tpu_params = dict(self._tpu_params)  # type: ignore[attr-defined]
        if extra:
            for p, v in extra.items():
                if hasattr(that, "_set_params"):
                    # keeps the Spark and backend sides in sync
                    that._set_params(**{p.name: v})  # type: ignore[attr-defined]
                else:
                    that.set(p, v)
        return that

    def _copyValues(self, to: "Params", extra: Optional[Dict[Param, Any]] = None) -> "Params":
        paramMap = dict(self._paramMap)
        if extra:
            paramMap.update(extra)
        for p, v in self._defaultParamMap.items():
            if to.hasParam(p.name):
                to._defaultParamMap[to.getParam(p.name)] = v
        for p, v in paramMap.items():
            if to.hasParam(p.name):
                to._paramMap[to.getParam(p.name)] = v
        return to


# ---------------------------------------------------------------------------
# Shared Param mixins
# ---------------------------------------------------------------------------


class HasFeaturesCol(Params):
    featuresCol = Param(
        "_", "featuresCol", "features column name.", TypeConverters.toString
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(featuresCol="features")

    def getFeaturesCol(self) -> str:
        return self.getOrDefault(self.featuresCol)


class HasFeaturesCols(Params):
    """Multi-numeric-column input, avoiding VectorAssembler."""

    featuresCols = Param(
        "_",
        "featuresCols",
        "features column names for multi-column input.",
        TypeConverters.toListString,
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(featuresCols=[])

    def getFeaturesCols(self) -> List[str]:
        return self.getOrDefault(self.featuresCols)


class HasLabelCol(Params):
    labelCol = Param("_", "labelCol", "label column name.", TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(labelCol="label")

    def getLabelCol(self) -> str:
        return self.getOrDefault(self.labelCol)


class HasPredictionCol(Params):
    predictionCol = Param(
        "_", "predictionCol", "prediction column name.", TypeConverters.toString
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(predictionCol="prediction")

    def getPredictionCol(self) -> str:
        return self.getOrDefault(self.predictionCol)


class HasProbabilityCol(Params):
    probabilityCol = Param(
        "_", "probabilityCol", "class conditional probabilities column name.",
        TypeConverters.toString,
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(probabilityCol="probability")

    def getProbabilityCol(self) -> str:
        return self.getOrDefault(self.probabilityCol)


class HasRawPredictionCol(Params):
    rawPredictionCol = Param(
        "_", "rawPredictionCol", "raw prediction (confidence) column name.",
        TypeConverters.toString,
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(rawPredictionCol="rawPrediction")

    def getRawPredictionCol(self) -> str:
        return self.getOrDefault(self.rawPredictionCol)


class HasEnableSparseDataOptim(Params):
    """Force the sparse or the dense training layout.  The port has only the
    dense one: None and False densify CSR input, True raises at fit."""

    enable_sparse_data_optim = Param(
        "_",
        "enable_sparse_data_optim",
        "None (auto), True (force sparse), False (force dense).",
        TypeConverters.identity,
    )

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(enable_sparse_data_optim=None)


class HasTol(Params):
    tol = Param("_", "tol", "convergence tolerance for iterative algorithms.",
                TypeConverters.toFloat)

    def getTol(self) -> float:
        return self.getOrDefault(self.tol)


class HasMaxIter(Params):
    maxIter = Param("_", "maxIter", "max number of iterations (>= 0).",
                    TypeConverters.toInt)

    def getMaxIter(self) -> int:
        return self.getOrDefault(self.maxIter)


class HasRegParam(Params):
    regParam = Param("_", "regParam", "regularization parameter (>= 0).",
                     TypeConverters.toFloat)

    def getRegParam(self) -> float:
        return self.getOrDefault(self.regParam)


class HasElasticNetParam(Params):
    elasticNetParam = Param(
        "_", "elasticNetParam",
        "ElasticNet mixing: 0 = L2 penalty, 1 = L1 penalty.",
        TypeConverters.toFloat,
    )

    def getElasticNetParam(self) -> float:
        return self.getOrDefault(self.elasticNetParam)


class HasFitIntercept(Params):
    fitIntercept = Param("_", "fitIntercept", "whether to fit an intercept term.",
                         TypeConverters.toBoolean)

    def getFitIntercept(self) -> bool:
        return self.getOrDefault(self.fitIntercept)


class HasStandardization(Params):
    standardization = Param(
        "_", "standardization", "whether to standardize features before fitting.",
        TypeConverters.toBoolean,
    )

    def getStandardization(self) -> bool:
        return self.getOrDefault(self.standardization)


class HasWeightCol(Params):
    weightCol = Param("_", "weightCol", "instance weight column name.",
                      TypeConverters.toString)

    def getWeightCol(self) -> str:
        return self.getOrDefault(self.weightCol)


class HasOutputCol(Params):
    outputCol = Param("_", "outputCol", "output column name.", TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(outputCol=self.uid + "__output")

    def getOutputCol(self) -> str:
        return self.getOrDefault(self.outputCol)


class HasInputCol(Params):
    inputCol = Param("_", "inputCol", "input column name.", TypeConverters.toString)

    def getInputCol(self) -> str:
        return self.getOrDefault(self.inputCol)


class HasIDCol(Params):
    """Propagate a row id through the search."""

    idCol = Param("_", "idCol", "id column name.", TypeConverters.toString)

    def setIdCol(self, value: str) -> "HasIDCol":
        self._set(idCol=value)
        return self

    def getIdCol(self) -> str:
        return self.getOrDefault(self.idCol)


# ---------------------------------------------------------------------------
# Backend param mapping layer
# ---------------------------------------------------------------------------


class _TpuClass(ABC):
    """Declarative mapping between the Spark ML API param names and the
    backend kernel param names.  The name is kept from the JAX package so
    the persisted metadata and the class layout match.

    `_param_mapping()` values:
      - str: backend param name
      - None: unsupported -> error (the port has no CPU fallback engine)
      - "": accepted but ignored
    """

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {}

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Any]]:
        """Spark param name -> translation of its value into the backend's;
        a translation returning None marks an unsupported value."""
        return {}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        """Backend kernel defaults."""
        return {}


class _TpuParams(_TpuClass, Params):
    """Mixin holding `_tpu_params` (the backend-side param dict),
    `num_workers` and `float32_inputs`."""

    _float32_inputs: bool = True

    def __init__(self) -> None:
        super().__init__()
        self._tpu_params: Dict[str, Any] = {}
        self._num_workers: Optional[int] = None
        self._float32_inputs = True

    def _init_tpu_params(self) -> None:
        self._tpu_params = dict(self._get_tpu_params_default())
        self._spark_defaults_synced = False

    def _sync_spark_defaults_to_tpu(self) -> None:
        """Overlay the Spark-side param *defaults* onto the backend dict so
        precedence is: backend defaults < Spark defaults < explicit sets."""
        value_map = self._param_value_mapping()
        for sname, mapped in self._param_mapping().items():
            if not mapped:
                continue
            if self.hasParam(sname) and self.hasDefault(sname) and not self.isSet(sname):
                v = self._defaultParamMap[self.getParam(sname)]
                if sname in value_map:
                    v = value_map[sname](v)
                    if v is None:
                        continue
                self._tpu_params[mapped] = v

    @property
    def tpu_params(self) -> Dict[str, Any]:
        return self._tpu_params

    @property
    def num_workers(self) -> int:
        """Number of devices the model runs on; the port runs on one."""
        return self._num_workers if self._num_workers is not None else 1

    @num_workers.setter
    def num_workers(self, value: int) -> None:
        self._num_workers = value

    def setNumWorkers(self, value: int) -> "_TpuParams":
        self._num_workers = value
        return self

    def _set_params(self, **kwargs: Any) -> "_TpuParams":
        """Set params on both the Spark-API side and the backend `_tpu_params`
        side, keeping the two in sync."""
        if not getattr(self, "_spark_defaults_synced", True):
            self._sync_spark_defaults_to_tpu()
            self._spark_defaults_synced = True
        mapping = self._param_mapping()
        value_map = self._param_value_mapping()
        for k, v in kwargs.items():
            if k == "num_workers":
                self._num_workers = int(v) if v is not None else None
                continue
            if k == "float32_inputs":
                self._float32_inputs = bool(v)
                continue
            if self.hasParam(k):
                self._set(**{k: v})
                if k in mapping:
                    mapped = mapping[k]
                    if mapped is None:
                        raise ValueError(f"Parameter {k} is not supported.")
                    if mapped:
                        if k in value_map:
                            v = value_map[k](v)
                            if v is None:
                                raise ValueError(
                                    f"Value '{kwargs[k]}' for param '{k}' is not supported."
                                )
                        self._tpu_params[mapped] = v
            elif k in self._tpu_params or k in self._get_tpu_params_default():
                # backend-only kwarg passed straight through
                self._tpu_params[k] = v
            else:
                raise ValueError(f"Unsupported param '{k}'.")
        return self
