#
# PCA: the port of spark_rapids_ml_tpu/models/feature.py.  A fit from a
# DeviceDataset (or from host arrays below the fused threshold) runs
# ops/pca.py on the staged rows: the full solver (covariance + eigh on the
# device) or the randomized range-finder, chosen by `resolve_pca_solver`.
# A fit from dense host arrays or a parquet file at or above it (conf
# `fused_stage_solve`) folds the second moments, or the range-finder's
# projected moments, chunk by chunk as the rows stage or decode (fused.py)
# and finishes on the host in float64.  Beyond the device budget a parquet
# file fits from streamed second moments (streaming.py
# `pca_streaming_stats`), and a CSR matrix from blocked-densify moments
# (`pca_stats_from_csr`); within it CSR input is densified onto the
# two-phase path.  `transform` projects the raw rows (Spark semantics: no
# mean removed).
#
# Not ported: `cpu()` and the scikit-learn fit (the card's machine has no
# scikit-learn; ROADMAP.md section 3).
#
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..core import FitInput, _TpuEstimator, _TpuModel, weights_on
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasInputCol,
    HasOutputCol,
    Param,
    TypeConverters,
    _TpuParams,
)
from ..utils import _ArrayBatch


class PCAClass:
    """Param mapping (Spark name -> backend name)."""

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"k": "n_components"}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_components": None,
            "svd_solver": "auto",
            "verbose": False,
            "whiten": False,
        }


class _PCATpuParams(_TpuParams, HasInputCol, HasOutputCol, HasFeaturesCol, HasFeaturesCols):
    """The Params PCA and its model share."""

    k = Param("_", "k", "the number of principal components.", TypeConverters.toInt)
    inputCols = Param(
        "_", "inputCols", "input column names for multi-column features.",
        TypeConverters.toListString,
    )

    def setInputCol(self, value: Union[str, List[str]]) -> "_PCATpuParams":
        if isinstance(value, str):
            self._set_params(inputCol=value)
        else:
            self._set_params(inputCols=value)
        return self

    def setInputCols(self, value: List[str]) -> "_PCATpuParams":
        return self._set_params(inputCols=value)

    def setOutputCol(self, value: str) -> "_PCATpuParams":
        return self._set_params(outputCol=value)

    def getInputCol(self) -> Union[str, List[str]]:
        if self.isSet(self.inputCols):
            return self.getOrDefault(self.inputCols)
        if self.isDefined(self.inputCol):
            return self.getOrDefault(self.inputCol)
        raise RuntimeError("inputCol is not set")

    def setK(self, value: int) -> "_PCATpuParams":
        return self._set_params(k=value)

    def getK(self) -> int:
        return self.getOrDefault("k")


def _pca_attrs(mean, components, ev, evr, sv, dtype) -> Dict[str, Any]:
    dtype = np.dtype(dtype)
    return {
        "mean_": np.asarray(mean).astype(dtype),
        "components_": np.asarray(components).astype(dtype),
        "explained_variance_": np.asarray(ev).astype(dtype),
        "explained_variance_ratio_": np.asarray(evr).astype(dtype),
        "singular_values_": np.asarray(sv).astype(dtype),
        "n_cols": int(np.asarray(components).shape[1]),
        "dtype": str(dtype.name),
    }


class PCA(PCAClass, _TpuEstimator, _PCATpuParams):
    """PCA on one GPU, with the JAX package's API: the top-k principal
    components of the rows.  Spark semantics: `transform` projects the raw
    (uncentred) input onto the components.

    Examples
    --------
    >>> import numpy as np
    >>> from spark_rapids_ml_torch import set_default_device
    >>> from spark_rapids_ml_torch.feature import PCA
    >>> set_default_device("cpu")
    >>> X = np.array([[-1.0, -1.0], [0.0, 0.0], [1.0, 1.0]])
    >>> model = PCA(k=1).setOutputCol("pca_features").fit(X)
    >>> np.round(model.transform(X)[:, 0], 3).tolist()
    [-1.414, 0.0, 1.414]
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(k=None)
        self._set_params(**kwargs)

    def _fit_array(self, fit_input: FitInput) -> Dict[str, Any]:
        from ..ops.pca import pca_fit, pca_fit_randomized, resolve_pca_solver

        d = fit_input.pdesc.n
        k = self._resolved_k(d)
        solver, l, power_iters, _reason = resolve_pca_solver(d, k)
        if solver == "randomized":
            out = pca_fit_randomized(fit_input.X, fit_input.w, k, int(l), int(power_iters))
        else:
            out = pca_fit(fit_input.X, fit_input.w, k)
        return _pca_attrs(*(t.cpu().numpy() for t in out), fit_input.dtype)

    def _supports_fused_stats(self) -> bool:
        # second moments do not depend on the order the chunks arrive in
        return True

    def _resolved_k(self, d: int) -> int:
        k = int(self._tpu_params.get("n_components") or d)
        if k > d:
            raise ValueError(f"k={k} exceeds the number of features {d}")
        return k

    def _fit_fused(self, batch: _ArrayBatch) -> Dict[str, Any]:
        """Fused stage-and-solve over a host batch: the moment (or
        randomized projected-moment) accumulators fold each chunk in as it
        lands on the device (fused.py)."""
        from ..fused import fused_chunk_rows, fused_pca_stats, iter_host_chunks

        X = batch.X
        dtype = self._out_dtype(X)
        d = int(X.shape[1])

        def producer(n_dev: int):
            rows = fused_chunk_rows(int(X.shape[0]), d, np.dtype(dtype).itemsize, n_dev)
            return iter_host_chunks(X, None, batch.weight, rows, dtype)

        st = fused_pca_stats(producer, d, self._resolved_k(d), dtype, self._device())
        return self._attrs_from_fused(st, dtype)

    def _fit_fused_parquet(self, path: str) -> Dict[str, Any]:
        """Fused stage-and-solve straight from parquet: the decode runs on
        the range readers, overlapped with the accumulation on the
        device."""
        from ..fused import fused_chunk_rows, fused_pca_stats, iter_parquet_chunks
        from ..streaming import parquet_row_count, probe_num_features

        fcol, fcols, _, weight_col, dtype = self._streaming_io_params()
        d = probe_num_features(path, fcol, fcols)
        n = parquet_row_count(path)

        def producer(n_dev: int):
            rows = fused_chunk_rows(n, d, np.dtype(dtype).itemsize, n_dev)
            prep = {"s": 0.0, "iv": []}  # the readers time their own decode
            return iter_parquet_chunks(path, fcol, fcols, None, weight_col, rows, dtype,
                                       prep=prep, device=self._device()), prep

        st = fused_pca_stats(producer, d, self._resolved_k(d), dtype, self._device())
        return self._attrs_from_fused(st, dtype)

    def _supports_streaming_stats(self) -> bool:
        return True

    def _fit_streaming(self, path: str) -> Dict[str, Any]:
        """Beyond the device budget: the second moments streamed from the
        file in one pass (streaming.py `pca_streaming_stats`); only the
        (d, d) accumulator is on the device.  The full solver on the host
        in float64."""
        from ..streaming import pca_streaming_stats

        fcol, fcols, _, weight_col, dtype = self._streaming_io_params()
        st = pca_streaming_stats(path, fcol, fcols, weight_col, dtype=dtype,
                                 device=self._device())
        return self._attrs_from_moments(st, dtype)

    def _fit_streaming_csr(self, batch) -> Dict[str, Any]:
        """A CSR matrix beyond the budget: the second moments densified a
        block of rows at a time (streaming.py `pca_stats_from_csr`)."""
        from ..streaming import pca_stats_from_csr

        dtype = self._out_dtype(batch.X)
        st = pca_stats_from_csr(batch.X.tocsr(), batch.weight, dtype=dtype,
                                device=self._device())
        return self._attrs_from_moments(st, dtype)

    def _attrs_from_fused(self, st: Dict[str, Any], dtype) -> Dict[str, Any]:
        if st.get("kind") == "projected":
            return self._attrs_from_projected(st, dtype)
        return self._attrs_from_moments(st, dtype)

    def _attrs_from_projected(self, st: Dict[str, Any], dtype) -> Dict[str, Any]:
        """Finish the fused randomized fit: the small Q-projected
        eigenproblem from the accumulated moments, on the host in
        float64."""
        from ..ops.pca import pca_attrs_from_projected

        out = pca_attrs_from_projected(
            st["Q"], st["SQ"], st["s1"], st["ssq"], float(st["sw"]), int(st["k"]),
        )
        return _pca_attrs(*out, dtype)

    def _supports_fold_weights(self) -> bool:
        # weighted mean and covariance (ops/pca.py SUPPORTS_ZERO_WEIGHT_ROWS):
        # a fold mask is a zero weight
        from ..ops import pca as _pca_ops

        return bool(_pca_ops.SUPPORTS_ZERO_WEIGHT_ROWS)

    def _attrs_from_moments(self, st: Dict[str, Any], dtype) -> Dict[str, Any]:
        """Finish the full solver from the second moments, on the host in
        float64."""
        S, s1, sw = np.asarray(st["S"]), np.asarray(st["s1"]), float(st["sw"])
        d = S.shape[0]
        k = int(self._tpu_params.get("n_components") or d)
        if k > d:
            raise ValueError(f"k={k} exceeds the number of features {d}")
        mean = s1 / sw
        cov = (S - sw * np.outer(mean, mean)) / (sw - 1.0)
        evals, evecs = np.linalg.eigh(cov)
        evals = evals[::-1]
        evecs = evecs[:, ::-1]
        components = evecs[:, :k].T
        flip_idx = np.argmax(np.abs(components), axis=1)
        signs = np.sign(components[np.arange(k), flip_idx])
        signs[signs == 0] = 1.0
        components = components * signs[:, None]
        ev = np.clip(evals[:k], 0.0, None)
        evr = ev / np.clip(evals, 0.0, None).sum()
        sv = np.sqrt(ev * (sw - 1.0))
        return _pca_attrs(mean, components, ev, evr, sv, dtype)

    def _create_model(self, attrs: Dict[str, Any]) -> "PCAModel":
        return PCAModel(**attrs)

    def _cpu_fit(self, batch: _ArrayBatch) -> "PCAModel":
        """Not ported: it fits with scikit-learn, which the port does not
        use (ROADMAP.md section 3)."""
        raise NotImplementedError(
            "PCA's CPU fit uses scikit-learn; the port does not (ROADMAP.md section 3)"
        )


class PCAModel(PCAClass, _TpuModel, _PCATpuParams):
    """A fitted PCA: `transform` is X @ components^T, with no mean removed
    (Spark's semantics)."""

    def __init__(self, **attrs: Any) -> None:
        super().__init__(**attrs)
        self.mean_: np.ndarray = np.asarray(attrs["mean_"])
        self.components_: np.ndarray = np.asarray(attrs["components_"])
        self.explained_variance_: np.ndarray = np.asarray(attrs["explained_variance_"])
        self.explained_variance_ratio_: np.ndarray = np.asarray(
            attrs["explained_variance_ratio_"]
        )
        self.singular_values_: np.ndarray = np.asarray(attrs["singular_values_"])
        self.n_cols: int = int(attrs["n_cols"])
        self.dtype: str = str(attrs.get("dtype", "float32"))
        self._set_params(k=int(self.components_.shape[0]))

    @property
    def pc(self) -> np.ndarray:
        """Principal components as a (n_features, k) matrix, as pyspark.ml's
        PCAModel.pc."""
        return self.components_.T

    @property
    def explainedVariance(self) -> np.ndarray:
        """The share of the variance each component explains (pyspark.ml)."""
        return self.explained_variance_ratio_

    def _output_columns(self) -> List[str]:
        return [self.getOrDefault("outputCol")]

    def _transform_device(self, Xs) -> Dict[str, Any]:
        import torch

        from ..ops.pca import pca_transform

        comps = weights_on(self.components_, Xs.device, Xs.dtype)
        return {self.getOrDefault("outputCol"): pca_transform(Xs, comps)}

    def cpu(self):
        """Not ported: it builds a scikit-learn model (ROADMAP.md section 3)."""
        raise NotImplementedError(
            "PCAModel.cpu() builds a scikit-learn model; the port does not "
            "(ROADMAP.md section 3)"
        )
