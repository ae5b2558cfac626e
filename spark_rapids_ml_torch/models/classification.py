#
# LogisticRegression: the port of spark_rapids_ml_tpu/models/
# classification.py.  The fit stages rows on the device through the
# generic staged fit (core.py), computes the label range and the
# standardization moments there, and runs the host-driven L-BFGS/OWL-QN of
# ops/logistic.py (one device evaluation per oracle call); transform is the
# chunked `_transform_mesh` over `binary_predict` / `logreg_predict`.
#
# Sparse rows (`enable_sparse_data_optim`, the JAX package's rule): None
# keeps CSR input sparse, True stages dense input sparse too, False
# densifies.  Sparse rows stage as ELL (ops/sparse.py) and fit through
# `EllOracle`; standardization there scales by the std only, never centres
# (the rows stay sparse, and with an intercept the optimum is the same),
# and scales the coefficients in the oracle, not the stored rows.
# transform(csr) densifies chunk by chunk, as the JAX package does.
#
# With `checkpoint_dir` set the solver saves its state after every
# iteration under the JAX package's tag (`logreg-mem|...`, the data's
# fingerprint included) and a killed fit resumes where it stopped.
#
# A parquet file beyond the device budget (or with
# `force_streaming_stats`) fits epoch by epoch: the host L-BFGS/OWL-QN
# streams the file once per evaluation (streaming.py
# `logreg_streaming_fit`), and the model records `streaming_epochs`.
#
# Differences from the JAX package, each deliberate: one solver shape (the
# host-driven one) at every size; an unsupported Param or value raises
# (there is no CPU engine to fall back to); the ELL gradient sums per column
# without atomics (ops/sparse.py) and the ELL oracle evaluates in float64
# over float32 rows (ops/logistic.py); the streamed fit evaluates in the fit's dtype
# (the JAX package's in float32).  `cpu()` (scikit-learn) is not ported.
# `evaluate` runs the model's transform and the metrics of metrics/ on the
# host (`LogisticRegressionSummary`).
#
# RandomForestClassifier: the port of the JAX package's
# RandomForestClassifier and RandomForestClassificationModel over the
# shared layer of models/tree.py (ops/forest.py's histogram builder); the
# model's `cpu()` is the pure-numpy `_NumpyForestPredictor`, ported, and
# `evaluate` gives a `RandomForestClassificationSummary`.
#
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..core import FitInput, _TpuEstimatorSupervised, _TpuModel, weights_on
from ..params import (
    HasElasticNetParam,
    HasEnableSparseDataOptim,
    HasFeaturesCol,
    HasFeaturesCols,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasRegParam,
    HasStandardization,
    HasTol,
    HasWeightCol,
    Param,
    TypeConverters,
    _TpuParams,
)
from ..utils import _ArrayBatch
from .tree import _NumpyForestPredictor, _RandomForestEstimator, _RandomForestModel


def _label_range(y, w):
    """(min, max) label among rows of weight > 0, reduced on the device and
    fetched in one copy."""
    import torch

    valid = w > 0
    big = torch.iinfo(torch.int32).max
    lo = torch.where(valid, y, torch.full_like(y, big)).min()
    hi = torch.where(valid, y, torch.full_like(y, -1)).max()
    return torch.stack([lo, hi]).cpu().tolist()


def _label_check(y, w):
    """(is_integral, min_label) among rows of weight > 0, for float
    labels, reduced on the device."""
    import torch

    valid = w > 0
    yf = y.to(torch.float32)
    integral = torch.where(valid, yf == torch.round(yf), torch.ones_like(valid)).all()
    mn = torch.where(valid, yf, torch.full_like(yf, float("inf"))).min()
    return bool(integral), float(mn)


class LogisticRegressionClass:
    """Param mapping (Spark name -> backend name), with regParam carried as
    C = 1/regParam."""

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "maxIter": "max_iter",
            "regParam": "C",
            "elasticNetParam": "l1_ratio",
            "tol": "tol",
            "fitIntercept": "fit_intercept",
            "threshold": "",
            "thresholds": None,
            "standardization": "standardization",
            "weightCol": "",
            "aggregationDepth": "",
            "family": "family",
            "lowerBoundsOnCoefficients": None,
            "upperBoundsOnCoefficients": None,
            "lowerBoundsOnIntercepts": None,
            "upperBoundsOnIntercepts": None,
            "maxBlockSizeInMB": "",
        }

    @classmethod
    def _param_value_mapping(cls):
        # C = 1/regParam; 0 means unregularized; a negative regParam is
        # unsupported
        return {"regParam": lambda x: 1.0 / x if x > 0.0 else (0.0 if x == 0.0 else None)}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "fit_intercept": True,
            "standardization": False,
            "verbose": False,
            "C": 1.0,
            "penalty": "l2",
            "l1_ratio": None,
            "max_iter": 1000,
            "tol": 0.0001,
            "family": "auto",
            "lbfgs_memory": 10,
            "linesearch_max_iter": 20,
        }


class _LogisticRegressionTpuParams(
    _TpuParams,
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasEnableSparseDataOptim,
    HasRegParam,
    HasElasticNetParam,
    HasFitIntercept,
    HasStandardization,
    HasMaxIter,
    HasTol,
    HasWeightCol,
):
    """The Params LogisticRegression and its model share."""

    family = Param("_", "family", 'Label distribution: "auto", "binomial", '
                   '"multinomial".', TypeConverters.toString)
    threshold = Param("_", "threshold", "binary prediction threshold in [0,1].",
                      TypeConverters.toFloat)
    # declared for pyspark API parity; setting any of them raises
    thresholds = Param("_", "thresholds", "per-class thresholds (unsupported).",
                       TypeConverters.toListFloat)
    lowerBoundsOnCoefficients = Param("_", "lowerBoundsOnCoefficients",
                                      "box constraint (unsupported).",
                                      TypeConverters.identity)
    upperBoundsOnCoefficients = Param("_", "upperBoundsOnCoefficients",
                                      "box constraint (unsupported).",
                                      TypeConverters.identity)
    lowerBoundsOnIntercepts = Param("_", "lowerBoundsOnIntercepts",
                                    "box constraint (unsupported).",
                                    TypeConverters.identity)
    upperBoundsOnIntercepts = Param("_", "upperBoundsOnIntercepts",
                                    "box constraint (unsupported).",
                                    TypeConverters.identity)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(
            regParam=0.0,
            elasticNetParam=0.0,
            tol=1e-6,
            maxIter=100,
            fitIntercept=True,
            standardization=True,
            family="auto",
            threshold=0.5,
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

    def setProbabilityCol(self, value: str):
        self._set(probabilityCol=value)
        return self

    def setRawPredictionCol(self, value: str):
        self._set(rawPredictionCol=value)
        return self

    def setRegParam(self, value: float):
        return self._set_params(regParam=value)

    def setElasticNetParam(self, value: float):
        return self._set_params(elasticNetParam=value)

    def setFitIntercept(self, value: bool):
        return self._set_params(fitIntercept=value)

    def setStandardization(self, value: bool):
        return self._set_params(standardization=value)

    def setMaxIter(self, value: int):
        return self._set_params(maxIter=value)

    def setTol(self, value: float):
        return self._set_params(tol=value)

    def setWeightCol(self, value: str):
        return self._set_params(weightCol=value)

    def setThreshold(self, value: float):
        return self._set_params(threshold=value)

    def setFamily(self, value: str):
        return self._set_params(family=value)


class LogisticRegression(
    LogisticRegressionClass, _TpuEstimatorSupervised, _LogisticRegressionTpuParams
):
    """Logistic regression on one GPU, with the JAX package's API.

    Binomial labels use Spark's single-coefficient-vector form; multinomial
    uses softmax with the full coefficient matrix.  Both run host-driven
    L-BFGS (OWL-QN when elasticNetParam > 0) with `lbfgs_memory=10`,
    `linesearch_max_iter=20`; standardization runs on the device and the
    coefficients are unscaled after the solve.

    Examples
    --------
    >>> import numpy as np
    >>> from spark_rapids_ml_torch import set_default_device
    >>> from spark_rapids_ml_torch.classification import LogisticRegression
    >>> set_default_device("cpu")
    >>> X = np.array([[1.0, 2.0], [1.0, 3.0], [2.0, 1.0], [3.0, 1.0]])
    >>> y = np.array([1.0, 1.0, 0.0, 0.0])
    >>> model = LogisticRegression(regParam=0.01).fit((X, y))
    >>> model.transform(X)["prediction"].tolist()
    [1, 1, 0, 0]
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_params(**kwargs)

    def _fit_label_dtype(self):
        return np.dtype(np.int32)

    def _use_sparse_kernel(self, batch: _ArrayBatch) -> bool:
        # None: sparse input stays sparse; True: dense input stages sparse
        # too; False: densify
        opt = self.getOrDefault("enable_sparse_data_optim")
        if opt is True:
            return True
        if opt is False:
            return False
        from ..data import _is_sparse

        return _is_sparse(batch.X)

    def _validate_input(self, batch: _ArrayBatch) -> None:
        classes = np.unique(batch.y)
        if not np.all(classes == classes.astype(np.int64)):
            raise RuntimeError(f"Labels MUST be Integers, but got {classes}")
        if classes.min() < 0:
            raise RuntimeError(f"Labels MUST be non-negative, but got {classes}")

    def _validate_device_input(self, ds) -> None:
        """The label contract of `_validate_input`, on the device over rows of
        weight > 0, for DeviceDataset fits (before the int32 cast would hide
        a violation)."""
        integral, mn = _label_check(ds.y, ds.weight)
        if not integral:
            raise RuntimeError("Labels MUST be Integers")
        if mn < 0:
            raise RuntimeError(f"Labels MUST be non-negative, but got min {mn}")

    def _supports_streaming_stats(self) -> bool:
        # epoch streaming: every evaluation streams the file again
        return True

    def _supports_fold_weights(self) -> bool:
        # a convex w-weighted objective from a zero start
        # (ops/logistic.py SUPPORTS_ZERO_WEIGHT_ROWS): a fold mask is a zero
        # weight and the optimum does not depend on the row count
        from ..ops import logistic as _logistic_ops

        return bool(_logistic_ops.SUPPORTS_ZERO_WEIGHT_ROWS)

    def _fit_streaming(self, path: str) -> Dict[str, Any]:
        """Beyond the device budget: the host L-BFGS/OWL-QN whose every
        evaluation streams the file through the loss and gradient on the
        card (streaming.py `logreg_streaming_fit`)."""
        from ..streaming import logreg_streaming_fit

        fcol, fcols, label_col, weight_col, dtype = self._streaming_io_params()
        if label_col is None:
            raise ValueError("labelCol must be set for LogisticRegression")
        p = self._tpu_params
        C = float(p["C"])
        reg_param = 1.0 / C if C > 0 else 0.0
        l1_ratio = p.get("l1_ratio")
        en = float(l1_ratio) if l1_ratio is not None else float(
            self.getOrDefault("elasticNetParam"))
        fit_intercept = bool(p["fit_intercept"])
        from ..resilience.checkpoint import resolve_checkpoint_dir

        ckpt_dir = resolve_checkpoint_dir(streaming=True)
        res = logreg_streaming_fit(
            path, fcol, fcols, label_col, weight_col,
            family=str(self.getOrDefault("family")),
            l2=reg_param * (1.0 - en),
            l1=reg_param * en,
            fit_intercept=fit_intercept,
            standardization=bool(p.get("standardization", True)),
            tol=float(p["tol"]),
            max_iter=int(p["max_iter"]),
            history=int(p.get("lbfgs_memory", 10)),
            ls_max=int(p.get("linesearch_max_iter", 20)),
            dtype=dtype,
            # the file name comes from the fit's content tag, the same
            # across restarts of the process
            checkpoint_dir=ckpt_dir or None,
            device=self._device(),
        )
        dtype = np.dtype(dtype)
        if "degenerate_label" in res:
            cv = float(res["degenerate_label"])
            if cv not in (0.0, 1.0):
                raise RuntimeError(
                    "class value must be either 1. or 0. when dataset has one label")
            return {
                "coef_": np.zeros((1, res["d"]), dtype),
                "intercept_": np.array([np.inf if cv == 1.0 else -np.inf], dtype),
                "classes_": [cv],
                "n_cols": res["d"],
                "dtype": str(dtype.name),
                "num_iters": 0,
                "objective": 0.0,
            }
        coef = np.asarray(res["coef"], np.float64)
        intercept = np.asarray(res["intercept"], np.float64)
        if res["std"] is not None:
            std = np.asarray(res["std"], np.float64)
            coef = np.where(std > 0, coef / std, coef)
            if fit_intercept and res["mean"] is not None:
                intercept = intercept - coef @ np.asarray(res["mean"], np.float64)
        if fit_intercept and len(intercept) > 1:
            intercept = intercept - intercept.mean()
        hist = [float(v) for v in res["history"]]
        return {
            "coef_": coef.astype(dtype),
            "intercept_": intercept.astype(dtype),
            "classes_": [float(c) for c in range(res["n_classes"])],
            "n_cols": int(res["d"]),
            "dtype": str(dtype.name),
            "num_iters": int(res["n_iter"]),
            "objective": float(hist[-1]) if hist else 0.0,
            "objective_history": hist,
            "converged": bool(res.get("converged", False)),
            # passes over the file, line-search trials included (rows/s per
            # epoch is read from it)
            "streaming_epochs": int(res.get("epochs", 0)),
        }

    def _fit_array(self, fit_input: FitInput) -> Dict[str, Any]:
        import torch

        from ..config import get_config
        from ..ops.logistic import logreg_fit_host_dispatch
        from ..ops.stats import standardize, weighted_moments

        if get_config("bf16_features"):
            raise NotImplementedError(
                "bf16_features=True (bfloat16 feature storage) is not ported yet; "
                "see ROADMAP.md, item 4"
            )
        p = fit_input.params
        dtype = np.dtype(fit_input.dtype)
        n_cols = fit_input.pdesc.n
        y_min, y_max = _label_range(fit_input.y, fit_input.w)

        # a dataset of one label: Spark's +/-inf intercept, no solve
        if y_min == y_max:
            cv = float(y_min)
            if cv not in (0.0, 1.0):
                raise RuntimeError(
                    "class value must be either 1. or 0. when dataset has one label"
                )
            return {
                "coef_": np.zeros((1, n_cols), dtype),
                "intercept_": np.array([np.inf if cv == 1.0 else -np.inf], dtype),
                "classes_": [cv],
                "n_cols": n_cols,
                "dtype": str(dtype.name),
                "num_iters": 0,
                "objective": 0.0,
            }

        # Spark's numClasses = max(label) + 1, empty classes included
        n_classes = y_max + 1
        family = str(self.getOrDefault("family"))
        binomial = n_classes == 2 and family in ("auto", "binomial")

        C = float(p["C"])
        reg_param = 1.0 / C if C > 0 else 0.0
        l1_ratio = p.get("l1_ratio")
        en = float(l1_ratio) if l1_ratio is not None else float(
            self.getOrDefault("elasticNetParam")
        )
        fit_intercept = bool(p["fit_intercept"])
        standardization = bool(p.get("standardization", True))
        l2 = reg_param * (1.0 - en)
        l1 = reg_param * en
        max_iter = int(p["max_iter"])
        ckpt_path, ckpt_tag = self._lbfgs_checkpoint(
            fit_input, n_classes, l2, l1, fit_intercept, standardization, max_iter)
        kwargs = dict(
            l2=l2,
            l1=l1,
            fit_intercept=fit_intercept,
            tol=float(p["tol"]),
            max_iter=max_iter,
            history=int(p.get("lbfgs_memory", 10)),
            ls_max=int(p.get("linesearch_max_iter", 20)),
            checkpoint_path=ckpt_path,
            checkpoint_tag=ckpt_tag,
        )

        X, w = fit_input.X, fit_input.w
        mean = std = None
        if "ell_cols" in fit_input.extra:
            # ELL rows: std-only scaling, no centring (the rows stay sparse),
            # applied in the oracle to the coefficients, so the stored values
            # stay the input's
            from ..ops.logistic import logreg_fit_binary_ell, logreg_fit_ell
            from ..ops.sparse import ell_column_layout, ell_weighted_moments

            cols = fit_input.extra["ell_cols"]
            layout = ell_column_layout(X, cols, n_cols)
            if standardization:
                _, std = ell_weighted_moments(X, cols, w, n_cols, layout=layout)
                kwargs["inv_std"] = 1.0 / std
            if binomial:
                coef, b, loss, n_iter, hist = logreg_fit_binary_ell(
                    X, cols, w, fit_input.y, d=n_cols, layout=layout, **kwargs)
            else:
                coef, b, loss, n_iter, hist = logreg_fit_ell(
                    X, cols, w, fit_input.y, n_classes=n_classes, d=n_cols, layout=layout,
                    **kwargs)
            del layout, cols
        else:
            if standardization:
                mean, std, _ = weighted_moments(X, w)
                if not fit_intercept:
                    # no intercept to absorb a centring shift: scale only
                    mean = None
                X = standardize(X, w, torch.zeros_like(std) if mean is None else mean, std)
            coef, b, loss, n_iter, hist = logreg_fit_host_dispatch(
                X, w, fit_input.y, n_classes=n_classes, binomial=binomial, **kwargs)
        del X
        if binomial:
            coef = np.asarray(coef, np.float64).reshape(1, -1)
            intercept = np.array([float(b)])
        else:
            coef = np.asarray(coef, np.float64)
            intercept = np.asarray(b, np.float64)
        if standardization:
            std = std.cpu().numpy().astype(np.float64)
            coef = np.where(std > 0, coef / std, coef)
            if mean is not None:
                # the features were centred: undo the shift in the intercept
                intercept = intercept - coef @ mean.cpu().numpy().astype(np.float64)
        # Spark centres multinomial intercepts (softmax is shift-invariant)
        if fit_intercept and len(intercept) > 1:
            intercept = intercept - intercept.mean()

        # objectiveHistory: the full objective per iteration, entry 0 the
        # initial one; a trailing NaN tail is cut so that entry j is
        # iteration j, and `objective` is its last entry
        hist = np.asarray(hist, np.float64)[: int(n_iter) + 1]
        while len(hist) and np.isnan(hist[-1]):
            hist = hist[:-1]
        if len(hist):
            loss = hist[-1]
        return {
            "coef_": coef.astype(dtype),
            "intercept_": intercept.astype(dtype),
            "classes_": [float(c) for c in range(n_classes)],
            "n_cols": n_cols,
            "dtype": str(dtype.name),
            "num_iters": int(n_iter),
            "objective": float(loss),
            "objective_history": [float(v) for v in hist],
        }

    def _lbfgs_checkpoint(self, fit_input: FitInput, n_classes: int, l2: float, l1: float,
                          fit_intercept: bool, standardization: bool, max_iter: int):
        """(checkpoint file, tag) of this fit when `checkpoint_dir` is set,
        else (None, ""): the JAX package's tag, dense and ELL alike.  The
        memory m is in it (the saved S / Y are (m, n)), and n is the rows
        staged, never a padded count."""
        from ..core import _fit_fingerprint
        from ..resilience.checkpoint import checkpoint_file_for, resolve_checkpoint_dir

        ckpt_dir = resolve_checkpoint_dir()
        if not ckpt_dir:
            return None, ""
        p = fit_input.params
        tag = (
            f"logreg-mem|n={int(fit_input.n_valid)}"
            f"|d={fit_input.pdesc.n}|C={n_classes}|l2={l2}|l1={l1}"
            f"|int={fit_intercept}|std={standardization}|mi={max_iter}"
            f"|m={int(p.get('lbfgs_memory', 10))}"
            f"|ls={int(p.get('linesearch_max_iter', 20))}"
            f"|{_fit_fingerprint(fit_input)}"
        )
        return checkpoint_file_for(ckpt_dir, tag), tag

    def _create_model(self, attrs: Dict[str, Any]) -> "LogisticRegressionModel":
        return LogisticRegressionModel(**attrs)


class LogisticRegressionTrainingSummary:
    """Spark's LogisticRegressionTrainingSummary surface:
    `objectiveHistory` and `totalIterations`."""

    def __init__(self, objectiveHistory: List[float], totalIterations: int):
        self.objectiveHistory = list(objectiveHistory)
        self.totalIterations = int(totalIterations)


class LogisticRegressionModel(
    LogisticRegressionClass, _TpuModel, _LogisticRegressionTpuParams
):
    """A fitted logistic regression model."""

    def __init__(self, **attrs: Any) -> None:
        super().__init__(**attrs)
        self.coef_: np.ndarray = np.atleast_2d(np.asarray(attrs["coef_"]))
        self.intercept_: np.ndarray = np.atleast_1d(np.asarray(attrs["intercept_"]))
        self.classes_: List[float] = [float(c) for c in attrs["classes_"]]
        self.n_cols: int = int(attrs["n_cols"])
        self.dtype: str = str(attrs.get("dtype", "float32"))
        self.num_iters: int = int(attrs.get("num_iters", 0))
        self.objective: float = float(attrs.get("objective", 0.0))
        self.objective_history: List[float] = [
            float(v) for v in attrs.get("objective_history", [])
        ]

    @property
    def numClasses(self) -> int:
        return len(self.classes_)

    @property
    def hasSummary(self) -> bool:
        return True

    @property
    def summary(self) -> LogisticRegressionTrainingSummary:
        """Training summary: the full objective per L-BFGS iteration (the
        single final objective for the one-label model)."""
        return LogisticRegressionTrainingSummary(
            objectiveHistory=self.objective_history or [self.objective],
            totalIterations=self.num_iters,
        )

    @property
    def coefficients(self) -> np.ndarray:
        """Binomial models: the single coefficient vector."""
        if self.coef_.shape[0] == 1:
            return self.coef_[0]
        raise RuntimeError("Multinomial model: use coefficientMatrix")

    @property
    def coefficientMatrix(self) -> np.ndarray:
        return self.coef_

    @property
    def intercept(self) -> float:
        if len(self.intercept_) == 1:
            return float(self.intercept_[0])
        raise RuntimeError("Multinomial model: use interceptVector")

    @property
    def interceptVector(self) -> np.ndarray:
        return self.intercept_

    def _is_binomial(self) -> bool:
        return self.coef_.shape[0] == 1

    def _output_columns(self) -> List[str]:
        return [
            self.getOrDefault("predictionCol"),
            self.getOrDefault("probabilityCol"),
            self.getOrDefault("rawPredictionCol"),
        ]

    def _transform_array(self, X: np.ndarray) -> Dict[str, np.ndarray]:
        # a +/-inf intercept (the one-label model) is answered on the host
        if self._is_binomial() and not np.isfinite(self.intercept_[0]):
            n = X.shape[0]
            p1 = 1.0 if self.intercept_[0] > 0 else 0.0
            dt = X.dtype if hasattr(X, "dtype") else np.float32
            return {
                self.getOrDefault("predictionCol"): np.full(n, p1, np.int32),
                self.getOrDefault("probabilityCol"): np.tile([1.0 - p1, p1], (n, 1)).astype(dt),
                self.getOrDefault("rawPredictionCol"): np.tile(
                    [-self.intercept_[0], self.intercept_[0]], (n, 1)).astype(dt),
            }
        return super()._transform_array(X)

    def _transform_device(self, Xs) -> Dict[str, Any]:
        import torch

        from ..ops.logistic import binary_predict, logreg_predict
        from ..parallel.mesh import _numpy_dtype, _torch_dtype

        dt = _numpy_dtype(Xs.dtype)

        def on_device(a):
            return weights_on(a, Xs.device, _torch_dtype(dt))

        if self._is_binomial():
            preds, probs, raw = binary_predict(
                Xs, on_device(self.coef_[0]), on_device(self.intercept_[0]))
            threshold = float(self.getOrDefault("threshold"))
            if threshold != 0.5:
                preds = (probs[:, 1] > threshold).to(torch.int32)
        else:
            preds, probs, raw = logreg_predict(
                Xs, on_device(self.coef_), on_device(self.intercept_))
        return {
            self.getOrDefault("predictionCol"): preds,
            self.getOrDefault("probabilityCol"): probs,
            self.getOrDefault("rawPredictionCol"): raw,
        }

    # -- one-sample API, on the host ------------------------------------------

    def _margins(self, value) -> np.ndarray:
        v = np.asarray(value, np.float64).reshape(-1)
        if v.shape[0] != self.n_cols:
            raise ValueError(
                f"feature vector has {v.shape[0]} entries; model expects "
                f"{self.n_cols}"
            )
        return self.coef_.astype(np.float64) @ v + self.intercept_.astype(np.float64)

    def predictRaw(self, value) -> np.ndarray:
        """Raw margin vector for one sample (Spark: [-m, m] for binomial)."""
        m = self._margins(value)
        if self._is_binomial():
            return np.array([-m[0], m[0]])
        return m

    def predictProbability(self, value) -> np.ndarray:
        m = self._margins(value)
        if self._is_binomial():
            p1 = 1.0 / (1.0 + np.exp(-m[0]))
            return np.array([1.0 - p1, p1])
        e = np.exp(m - m.max())
        return e / e.sum()

    def predict(self, value) -> float:
        probs = self.predictProbability(value)
        if self._is_binomial():
            return float(probs[1] > float(self.getOrDefault("threshold")))
        return float(np.argmax(probs))

    def evaluate(self, dataset) -> "LogisticRegressionSummary":
        """Metrics of this model on `dataset` (a pandas frame, a pyarrow
        Table or a parquet path): the model's transform, then the
        multiclass metrics on the host."""
        return _evaluate_classification(self, dataset, LogisticRegressionSummary)

    def cpu(self):
        """Not ported: it builds a scikit-learn model, and the port's machine
        has no scikit-learn (ROADMAP.md section 3)."""
        raise NotImplementedError(
            "LogisticRegressionModel.cpu() builds a scikit-learn model; the "
            "port does not (ROADMAP.md section 3)"
        )


# ---------------------------------------------------------------------------
# RandomForestClassifier
# ---------------------------------------------------------------------------


class _ClassificationSummary:
    """The evaluation summary of a classification model: the predictions
    frame and the multiclass metrics of metrics/."""

    def __init__(self, predictions, metrics) -> None:
        self.predictions = predictions
        self._m = metrics

    @property
    def accuracy(self) -> float:
        return float(self._m.accuracy)

    @property
    def weightedPrecision(self) -> float:
        return float(self._m.weighted_precision)

    @property
    def weightedRecall(self) -> float:
        return float(self._m.weighted_recall)

    def weightedFMeasure(self, beta: float = 1.0) -> float:
        # a method, as pyspark's summary has it
        return float(self._m.weighted_f_measure(beta))


class LogisticRegressionSummary(_ClassificationSummary):
    pass


class RandomForestClassificationSummary(_ClassificationSummary):
    pass


def _evaluate_classification(model, dataset, summary_cls):
    """The classification models' `evaluate`: `_evaluate_frame`, then the
    multiclass metrics of its labels, predictions and weights."""
    from ..core import _evaluate_frame
    from ..metrics import MulticlassMetrics

    out_df, y, preds, weights = _evaluate_frame(model, dataset)
    return summary_cls(predictions=out_df,
                       metrics=MulticlassMetrics.from_predictions(y, preds, weights=weights))


class RandomForestClassifier(
    _RandomForestEstimator, HasProbabilityCol, HasRawPredictionCol
):
    """Random forest classifier on one GPU, with the JAX package's API: the
    ops/forest.py histogram builder grows `numTrees` trees on the staged
    rows, one at a time.

    Examples
    --------
    >>> import numpy as np
    >>> from spark_rapids_ml_torch import set_default_device
    >>> from spark_rapids_ml_torch.classification import RandomForestClassifier
    >>> set_default_device("cpu")
    >>> X = np.array([[0.0], [0.1], [0.9], [1.0]])
    >>> y = np.array([0.0, 0.0, 1.0, 1.0])
    >>> model = RandomForestClassifier(numTrees=5, seed=7, bootstrap=False).fit((X, y))
    >>> model.transform(X)["prediction"].tolist()
    [0, 0, 1, 1]
    """

    def setProbabilityCol(self, value: str):
        self._set(probabilityCol=value)
        return self

    def setRawPredictionCol(self, value: str):
        self._set(rawPredictionCol=value)
        return self

    def _is_classification(self) -> bool:
        return True

    def _validate_input(self, batch: _ArrayBatch) -> None:
        y = np.asarray(batch.y)
        classes = np.unique(y)
        if np.any(classes < 0) or not np.allclose(classes, np.round(classes)):
            raise ValueError(
                "Labels must be non-negative integers 0..numClasses-1, got "
                f"{classes[:10]}"
            )

    def _validate_device_input(self, ds) -> None:
        """The label contract of `_validate_input`, on the device over rows of
        weight > 0, for DeviceDataset fits."""
        integral, mn = _label_check(ds.y, ds.weight)
        if not integral or mn < 0:
            raise ValueError(
                "Labels must be non-negative integers 0..numClasses-1"
            )

    def _num_stat_classes(self, fit_input: FitInput) -> int:
        # labels are validated >= 0, so the largest one gives the count (one
        # scalar fetched from the device)
        C = int(fit_input.y.max().item()) + 1
        self._n_classes_ = C
        return C

    def _fit_array(self, fit_input: FitInput) -> Dict[str, Any]:
        attrs = super()._fit_array(fit_input)
        attrs["num_classes"] = self._n_classes_
        return attrs

    def _create_model(self, attrs: Dict[str, Any]) -> "RandomForestClassificationModel":
        return RandomForestClassificationModel(**attrs)


class RandomForestClassificationModel(
    _RandomForestModel, HasProbabilityCol, HasRawPredictionCol
):
    """A fitted random forest classifier."""

    def __init__(self, **attrs: Any) -> None:
        super().__init__(**attrs)
        self.num_classes: int = int(attrs.get("num_classes",
                                              self.leaf_stats.shape[-1]))

    @property
    def numClasses(self) -> int:
        return self.num_classes

    def _output_columns(self) -> List[str]:
        return [
            self.getOrDefault("predictionCol"),
            self.getOrDefault("probabilityCol"),
            self.getOrDefault("rawPredictionCol"),
        ]

    def _transform_device(self, Xs) -> Dict[str, Any]:
        import torch

        leaves, stats = self._leaves_and_stats(Xs)  # (T, n), (T, L, C)
        # per-tree leaf class-count distributions, normalized per tree then
        # summed (Spark rawPrediction semantics)
        counts = stats.gather(1, leaves[:, :, None].expand(-1, -1, stats.shape[2]))
        sums = torch.clamp_min(counts.sum(dim=2, keepdim=True), 1e-12)
        raw = (counts / sums).sum(dim=0)  # (n, C)
        probs = raw / self.numTrees
        preds = torch.argmax(raw, dim=1).to(torch.int32)
        return {
            self.getOrDefault("predictionCol"): preds,
            self.getOrDefault("probabilityCol"): probs,
            self.getOrDefault("rawPredictionCol"): raw,
        }

    def cpu(self) -> _NumpyForestPredictor:
        """Pure-numpy predictor over the model's arrays."""
        return _NumpyForestPredictor(self, classification=True)

    # -- one-sample API, on the host (the numpy predictor) ---------------------

    def predictProbability(self, value) -> np.ndarray:
        return self.cpu().predict_proba(self._check_width(value))[0]

    def predictRaw(self, value) -> np.ndarray:
        # rawPrediction = per-tree normalized class votes summed
        return self.predictProbability(value) * self.numTrees

    def predict(self, value) -> float:
        return float(np.argmax(self.predictProbability(value)))

    def evaluate(self, dataset) -> "RandomForestClassificationSummary":
        """Metrics of this model on `dataset` (pyspark
        RandomForestClassificationModel.evaluate): the model's transform,
        then the multiclass metrics on the host."""
        return _evaluate_classification(self, dataset, RandomForestClassificationSummary)
