#
# LinearRegression: the port of the LinearRegression half of
# spark_rapids_ml_tpu/models/regression.py.  One pass of weighted
# sufficient statistics on the device (ops/linear.py), then the host solve
# in float64: OLS when regParam = 0, ridge in closed form when
# elasticNetParam = 0, else FISTA.  The two-phase fit (a DeviceDataset, or
# host arrays below the fused threshold) ends with a residual pass over the
# staged rows for the training summary; the fused fit from host arrays or
# parquet (fused.py), the streamed fit of a parquet file beyond the device
# budget and the blocked-CSR fit of a CSR matrix beyond it (streaming.py)
# take the summary from the statistics, as the JAX package does.
#
# Differences from the JAX package, each deliberate: a value the JAX
# package sends to its scikit-learn fallback (loss="huber",
# solver="l-bfgs") raises ValueError; `cpu()` (scikit-learn) raises
# NotImplementedError.  With `checkpoint_dir` set the two-phase fit's FISTA
# loop checkpoints under the JAX package's tag (`_fista_checkpoint`).  `evaluate` runs the model's transform and the regression metrics
# of metrics/ on the host (`LinearRegressionSummary`).
#
# RandomForestRegressor: the port of the JAX package's RandomForestRegressor
# and RandomForestRegressionModel over the shared layer of models/tree.py
# (ops/forest.py's variance-split histogram builder); `cpu()` is the
# pure-numpy `_NumpyForestPredictor`.
#
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..core import FitInput, _TpuEstimatorSupervised, _TpuModel, weights_on
from ..params import (
    HasElasticNetParam,
    HasFeaturesCol,
    HasFeaturesCols,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
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


class LinearRegressionClass:
    """Param mapping (Spark name -> backend name)."""

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "aggregationDepth": "",
            "elasticNetParam": "l1_ratio",
            "epsilon": "",
            "fitIntercept": "fit_intercept",
            "loss": "loss",
            "maxBlockSizeInMB": "",
            "maxIter": "max_iter",
            "regParam": "alpha",
            "solver": "solver",
            "standardization": "standardization",
            "tol": "tol",
            # the statistics take sample weights
            "weightCol": "",
        }

    @classmethod
    def _param_value_mapping(cls):
        # a value mapped to None is unsupported and raises ValueError
        return {
            "loss": lambda x: {
                "squaredError": "squared_loss",
                "huber": None,
                "squared_loss": "squared_loss",
            }.get(x, None),
            "solver": lambda x: {
                "auto": "auto",
                "normal": "eig",
                "l-bfgs": None,
                "eig": "eig",
            }.get(x, None),
        }

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "algorithm": "auto",
            "fit_intercept": True,
            "verbose": False,
            "alpha": 0.0001,
            "solver": "auto",
            "loss": "squared_loss",
            "l1_ratio": 0.15,
            "max_iter": 1000,
            "tol": 0.001,
            "standardization": True,
            "shuffle": True,
        }


class _LinearRegressionTpuParams(
    _TpuParams,
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasRegParam,
    HasElasticNetParam,
    HasFitIntercept,
    HasStandardization,
    HasMaxIter,
    HasTol,
    HasWeightCol,
):
    """The Params LinearRegression and its model share."""

    solver = Param("_", "solver", "The solver algorithm: auto, normal or eig.",
                   TypeConverters.toString)
    loss = Param("_", "loss", "The loss function: squaredError.",
                 TypeConverters.toString)
    aggregationDepth = Param("_", "aggregationDepth", "treeAggregate depth (ignored).",
                             TypeConverters.toInt)
    maxBlockSizeInMB = Param("_", "maxBlockSizeInMB", "block size (ignored).",
                             TypeConverters.toFloat)

    def __init__(self) -> None:
        super().__init__()
        self._setDefault(
            regParam=0.0,
            elasticNetParam=0.0,
            fitIntercept=True,
            standardization=True,
            maxIter=100,
            tol=1e-6,
            solver="auto",
            loss="squaredError",
            aggregationDepth=2,
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


def _linreg_attrs(coef, intercept, diag, n_cols: int, dtype) -> Dict[str, Any]:
    dtype = np.dtype(dtype)
    return {
        "coef_": coef.astype(dtype),
        "intercept_": float(intercept),
        "n_iter_": int(diag["n_iter"]),
        "rmse_": float(diag["rmse"]),
        "mse_": float(diag["mse"]),
        "r2_": float(diag["r2"]),
        "n_cols": int(n_cols),
        "dtype": str(dtype.name),
    }


class LinearRegression(
    LinearRegressionClass, _TpuEstimatorSupervised, _LinearRegressionTpuParams
):
    """Linear regression on one GPU, with the JAX package's API.

    regParam = 0 solves the normal equations (OLS), elasticNetParam = 0 the
    ridge system in closed form, else FISTA on the elastic-net objective;
    all from one pass of sufficient statistics.

    Examples
    --------
    >>> import numpy as np
    >>> from spark_rapids_ml_torch import set_default_device
    >>> from spark_rapids_ml_torch.regression import LinearRegression
    >>> set_default_device("cpu")
    >>> X = np.array([[1.0, 2.0], [2.0, 3.0], [3.0, 5.0]])
    >>> y = np.array([3.0, 5.0, 8.0])
    >>> model = LinearRegression().fit((X, y))
    >>> round(float(model.transform(X)[0]), 2)
    3.0
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_params(**kwargs)

    def _fista_checkpoint(self, gram: np.ndarray, sxy: np.ndarray, sw: float):
        """(checkpoint file, tag) of the FISTA loop when `checkpoint_dir` is
        set, else (None, ""): the JAX package's tag, which binds the
        problem's content (sums of the Gram and the cross moments), so a
        same-shaped fit on other data never resumes this one."""
        from ..resilience.checkpoint import checkpoint_file_for, resolve_checkpoint_dir

        ckpt_dir = resolve_checkpoint_dir()
        if not ckpt_dir:
            return None, ""
        p = self._tpu_params
        tag = (
            f"linreg-fista|d={int(gram.shape[0])}|sw={sw}"
            f"|gs={float(np.float64(gram).sum()):.12g}"
            f"|xs={float(np.float64(sxy).sum()):.12g}"
            f"|a={p['alpha']}|l1r={p['l1_ratio']}|int={p['fit_intercept']}"
            f"|std={p.get('standardization', True)}|mi={p['max_iter']}"
        )
        return checkpoint_file_for(ckpt_dir, tag), tag

    def _solve(self, gram, sxy, s1, sw: float, sy: float, syy: float,
               checkpoint: bool = False):
        """The host solve; `checkpoint` gives the FISTA loop its file (the
        two-phase fit, as in the JAX package)."""
        from ..ops.linear import solve_linear_host

        p = self._tpu_params
        ckpt_path, ckpt_tag = (self._fista_checkpoint(gram, sxy, float(sw)) if checkpoint
                               else (None, ""))
        return solve_linear_host(
            gram, sxy, s1, sw, sy, syy,
            reg_param=float(p["alpha"]),
            elasticnet_param=float(p["l1_ratio"]),
            fit_intercept=bool(p["fit_intercept"]),
            standardization=bool(p.get("standardization", True)),
            tol=float(p["tol"]),
            max_iter=int(p["max_iter"]),
            checkpoint_path=ckpt_path,
            checkpoint_tag=ckpt_tag,
        )

    def _fit_array(self, fit_input: FitInput) -> Dict[str, Any]:
        import torch

        from ..ops.linear import _summary_from_sse, linreg_residual_sse, linreg_sufficient_stats

        p = fit_input.params
        X = fit_input.X
        gram, sxy, s1, sw, sy, syy = linreg_sufficient_stats(X, fit_input.w, fit_input.y)
        sw, sy, syy = sw.item(), sy.item(), syy.item()
        coef, intercept, diag = self._solve(
            gram.cpu().numpy(), sxy.cpu().numpy(), s1.cpu().numpy(), sw, sy, syy,
            checkpoint=True)
        # the summary from a cancellation-free residual pass over the staged
        # rows (the one-pass SSE expansion loses about eps sum w y^2)
        sse = linreg_residual_sse(
            X, fit_input.w, fit_input.y,
            torch.as_tensor(coef, device=X.device).to(X.dtype),
            torch.tensor(intercept, dtype=torch.float64).to(X.dtype).to(X.device),
        ).item()
        diag.update(_summary_from_sse(sse, sw, sy, syy, bool(p["fit_intercept"])))
        return _linreg_attrs(coef, intercept, diag, fit_input.pdesc.n, fit_input.dtype)

    def _supports_fused_stats(self) -> bool:
        # the Gram, moment and cross sums do not depend on the chunk order
        return True

    def _fit_fused(self, batch: _ArrayBatch) -> Dict[str, Any]:
        """Fused stage-and-solve over a host batch: the statistics fold in
        on the device as each chunk lands (fused.py), then the host solve.
        The summary comes from the one-pass SSE expansion (no staged rows
        remain for a residual pass), as in the JAX package."""
        from ..fused import fused_chunk_rows, fused_linreg_stats, iter_host_chunks

        X = batch.X
        dtype = self._out_dtype(X)
        d = int(X.shape[1])
        ldt = self._fit_label_dtype() or np.dtype(dtype)

        def producer(n_dev: int):
            rows = fused_chunk_rows(int(X.shape[0]), d, np.dtype(dtype).itemsize, n_dev)
            return iter_host_chunks(X, batch.y, batch.weight, rows, dtype, label_dtype=ldt)

        st = fused_linreg_stats(producer, d, dtype, self._device())
        return self._attrs_from_stats(st, dtype)

    def _fit_fused_parquet(self, path: str) -> Dict[str, Any]:
        """Fused stage-and-solve straight from parquet: the decode runs on
        the range readers, the statistics accumulate on the device."""
        from ..fused import fused_chunk_rows, fused_linreg_stats, iter_parquet_chunks
        from ..streaming import parquet_row_count, probe_num_features

        fcol, fcols, label_col, weight_col, dtype = self._streaming_io_params()
        if label_col is None:
            raise ValueError("labelCol must be set for LinearRegression")
        d = probe_num_features(path, fcol, fcols)
        n = parquet_row_count(path)
        ldt = self._fit_label_dtype() or np.dtype(dtype)

        def producer(n_dev: int):
            rows = fused_chunk_rows(n, d, np.dtype(dtype).itemsize, n_dev)
            prep = {"s": 0.0, "iv": []}  # the readers time their own decode
            return iter_parquet_chunks(path, fcol, fcols, label_col, weight_col, rows, dtype,
                                       label_dtype=ldt, prep=prep, device=self._device()), prep

        st = fused_linreg_stats(producer, d, dtype, self._device())
        return self._attrs_from_stats(st, dtype)

    def _supports_streaming_stats(self) -> bool:
        return True

    def _fit_streaming(self, path: str) -> Dict[str, Any]:
        """Beyond the device budget: the statistics streamed from the file
        in one pass (streaming.py `linreg_streaming_stats`), then the same
        host solve.  The summary comes from the one-pass SSE expansion."""
        from ..streaming import linreg_streaming_stats

        fcol, fcols, label_col, weight_col, dtype = self._streaming_io_params()
        if label_col is None:
            raise ValueError("labelCol must be set for LinearRegression")
        st = linreg_streaming_stats(path, fcol, fcols, label_col, weight_col, dtype=dtype,
                                    device=self._device())
        return self._attrs_from_stats(st, dtype)

    def _fit_streaming_csr(self, batch) -> Dict[str, Any]:
        """A CSR matrix beyond the budget: the statistics densified a block
        of rows at a time (streaming.py `linreg_stats_from_csr`)."""
        from ..streaming import linreg_stats_from_csr

        dtype = self._out_dtype(batch.X)
        st = linreg_stats_from_csr(batch.X.tocsr(), np.asarray(batch.y), batch.weight,
                                   dtype=dtype, device=self._device())
        return self._attrs_from_stats(st, dtype)

    def _supports_fold_weights(self) -> bool:
        # the solve reads w-weighted statistics only
        # (ops/linear.py SUPPORTS_ZERO_WEIGHT_ROWS): a fold mask is a zero weight
        from ..ops import linear as _linear_ops

        return bool(_linear_ops.SUPPORTS_ZERO_WEIGHT_ROWS)

    def _attrs_from_stats(self, st: Dict[str, Any], dtype) -> Dict[str, Any]:
        gram = np.asarray(st["gram"])
        coef, intercept, diag = self._solve(
            gram, np.asarray(st["sxy"]), np.asarray(st["s1"]),
            float(st["sw"]), float(st["sy"]), float(st["syy"]),
        )
        return _linreg_attrs(coef, intercept, diag, gram.shape[0], dtype)

    def _create_model(self, attrs: Dict[str, Any]) -> "LinearRegressionModel":
        return LinearRegressionModel(**attrs)

    def _cpu_fit(self, batch: _ArrayBatch) -> "LinearRegressionModel":
        """Not ported: it fits with scikit-learn (ROADMAP.md section 3)."""
        raise NotImplementedError(
            "LinearRegression's CPU fit uses scikit-learn; the port does not "
            "(ROADMAP.md section 3)"
        )


class LinearRegressionTrainingSummary:
    """Spark's LinearRegressionTrainingSummary surface: weighted training
    rmse, mse and r2, and the iterations of the solve."""

    def __init__(self, rootMeanSquaredError: float, meanSquaredError: float,
                 r2: float, totalIterations: int) -> None:
        self.rootMeanSquaredError = float(rootMeanSquaredError)
        self.meanSquaredError = float(meanSquaredError)
        self.r2 = float(r2)
        self.totalIterations = int(totalIterations)


class LinearRegressionSummary:
    """The evaluation summary of a LinearRegressionModel on a dataset: the
    predictions frame and the regression metrics of metrics/."""

    def __init__(self, predictions, metrics, fit_intercept: bool = True) -> None:
        self.predictions = predictions
        self._m = metrics
        self._fit_intercept = bool(fit_intercept)

    @property
    def rootMeanSquaredError(self) -> float:
        return float(self._m.root_mean_squared_error)

    @property
    def meanSquaredError(self) -> float:
        return float(self._m.mean_squared_error)

    @property
    def meanAbsoluteError(self) -> float:
        return float(self._m.mean_absolute_error)

    @property
    def r2(self) -> float:
        # Spark's throughOrigin = !fitIntercept
        return float(self._m.r2(through_origin=not self._fit_intercept))

    @property
    def explainedVariance(self) -> float:
        return float(self._m.explained_variance)


class LinearRegressionModel(
    LinearRegressionClass, _TpuModel, _LinearRegressionTpuParams
):
    """A fitted linear regression model."""

    def __init__(self, **attrs: Any) -> None:
        super().__init__(**attrs)
        self.coef_: np.ndarray = np.asarray(attrs["coef_"])
        self.intercept_: float = float(attrs["intercept_"])
        self.n_iter_: int = int(attrs.get("n_iter_", 0))
        self.rmse_: float = float(attrs.get("rmse_", float("nan")))
        self.mse_: float = float(attrs.get("mse_", float("nan")))
        self.r2_: float = float(attrs.get("r2_", float("nan")))
        self.n_cols: int = int(attrs["n_cols"])
        self.dtype: str = str(attrs.get("dtype", "float32"))

    @property
    def coefficients(self) -> np.ndarray:
        return self.coef_

    @property
    def intercept(self) -> float:
        return self.intercept_

    @property
    def hasSummary(self) -> bool:
        return np.isfinite(self.rmse_)

    @property
    def summary(self) -> LinearRegressionTrainingSummary:
        """The training summary: weighted rmse, mse and r2 of the fit."""
        if not self.hasSummary:
            raise RuntimeError("No training summary available on this model")
        return LinearRegressionTrainingSummary(
            rootMeanSquaredError=self.rmse_,
            meanSquaredError=self.mse_,
            r2=self.r2_,
            totalIterations=self.n_iter_,
        )

    def evaluate(self, dataset) -> "LinearRegressionSummary":
        """Metrics of this model on `dataset` (a pandas frame, a pyarrow
        Table or a parquet path): the model's transform, then the
        regression metrics on the host."""
        from ..core import _evaluate_frame
        from ..metrics import RegressionMetrics

        out_df, y, preds, weights = _evaluate_frame(self, dataset)
        # the Spark param, which _copyValues carries onto the model
        return LinearRegressionSummary(
            predictions=out_df,
            metrics=RegressionMetrics.from_predictions(y, preds, weights),
            fit_intercept=bool(self.getOrDefault("fitIntercept")))

    def predict(self, value) -> float:
        """The prediction for one sample, on the host."""
        v = np.asarray(value, np.float64).reshape(-1)
        coef = np.asarray(self.coef_, np.float64).reshape(-1)
        if v.shape[0] != coef.shape[0]:
            raise ValueError(
                f"feature vector has {v.shape[0]} entries; model expects {coef.shape[0]}"
            )
        return float(coef @ v + float(self.intercept_))

    def _transform_device(self, Xs) -> Dict[str, Any]:
        import torch

        from ..ops.linear import linreg_predict

        coef = weights_on(self.coef_, Xs.device, Xs.dtype)
        b0 = torch.tensor(self.intercept_, dtype=torch.float64).to(Xs.dtype).to(Xs.device)
        return {self.getOrDefault("predictionCol"): linreg_predict(Xs, coef, b0)}

    def cpu(self):
        """Not ported: it builds a scikit-learn model (ROADMAP.md section 3)."""
        raise NotImplementedError(
            "LinearRegressionModel.cpu() builds a scikit-learn model; the port does "
            "not (ROADMAP.md section 3)"
        )


# ---------------------------------------------------------------------------
# RandomForestRegressor
# ---------------------------------------------------------------------------


class RandomForestRegressor(_RandomForestEstimator):
    """Random forest regressor on one GPU, with the JAX package's API:
    variance-split histogram trees grown one at a time on the staged rows.

    Examples
    --------
    >>> import numpy as np
    >>> from spark_rapids_ml_torch import set_default_device
    >>> from spark_rapids_ml_torch.regression import RandomForestRegressor
    >>> set_default_device("cpu")
    >>> X = np.array([[0.0], [0.1], [0.9], [1.0]])
    >>> y = np.array([0.0, 0.0, 10.0, 10.0])
    >>> model = RandomForestRegressor(numTrees=5, seed=3, bootstrap=False).fit((X, y))
    >>> [round(float(v), 1) for v in model.transform(X)]
    [0.0, 0.0, 10.0, 10.0]
    """

    def _is_classification(self) -> bool:
        return False

    def _create_model(self, attrs: Dict[str, Any]) -> "RandomForestRegressionModel":
        return RandomForestRegressionModel(**attrs)


class RandomForestRegressionModel(_RandomForestModel):
    """A fitted random forest regressor."""

    def _transform_device(self, Xs) -> Dict[str, Any]:
        import torch

        leaves, stats = self._leaves_and_stats(Xs)  # (T, n), (T, L, 3)
        # (T, n, 3): (weight, sum y, sum y^2) of each row's leaf
        at = stats.gather(1, leaves[:, :, None].expand(-1, -1, stats.shape[2]))
        w = torch.clamp_min(at[:, :, 0], 1e-12)
        preds = (at[:, :, 1] / w).mean(dim=0)
        return {self.getOrDefault("predictionCol"): preds.to(Xs.dtype)}

    def cpu(self) -> _NumpyForestPredictor:
        """Pure-numpy predictor over the model's arrays."""
        return _NumpyForestPredictor(self, classification=False)

    def predict(self, value) -> float:
        """Single-sample forest mean, on the host."""
        return float(self.cpu().predict(self._check_width(value))[0])
