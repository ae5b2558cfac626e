#
# Core runtime: the port of spark_rapids_ml_tpu/core.py.
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
# The generic staged fit (`_TpuEstimator._fit`):
#   - a parquet path (conf `streaming_ingest`) goes to `_stage_or_stream`
#     and is never read whole into host memory: beyond the device budget
#     (`_over_device_budget`) or with `force_streaming_stats`, an
#     estimator that can fits from streamed statistics or epoch by epoch
#     (`_fit_streaming`, streaming.py); within it PCA and LinearRegression
#     take the fused pass from parquet when `fused_stage_solve` routes
#     there; anything else is stream-staged into one device tensor
#     (streaming.py `stage_parquet`) for the estimator's `_fit_array`.  A
#     card that runs out of memory while staging retries as a streamed fit;
#   - anything else: extract host arrays -> validate -> a CSR batch whose
#     dense form is beyond the budget fits from blocked-CSR statistics
#     where the estimator can (`_maybe_fit_sparse_stats`) -> dense host
#     arrays of an estimator that fits from sufficient statistics take the
#     fused stage-and-solve pass when `fused_stage_solve` routes there
#     (`_maybe_fit_fused`, fused.py) -> else they stage on the device
#     (`_stage_fit_input`), or a DeviceDataset's tensors are taken as they
#     are (`_stage_from_device`) -> the estimator's `_fit_array` -> model.
# `fit_report()` names the route, the budget decision and the last
# staging, fused or streamed pass.  The generic transform
# (`_TpuModel._transform`): extract -> `_transform_mesh`, which runs the
# model's `_transform_device` over row chunks sized by `host_batch_bytes`,
# the next chunk's host-to-device copy on a side stream while the current
# one computes.
#
# Left for later slices: Spark DataFrames, the device dataset cache, the
# baseline fold, fitMultiple, the CPU fallback, the sparse (ELL) staging,
# and the resilience (retry, OOM halving) and telemetry seams.
#
from __future__ import annotations

import json
import os
import sys
import time
from abc import abstractmethod
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .data import DatasetLike, DeviceDataset, _ensure_dense, _is_sparse, extract_arrays
from .params import Param, Params, _TpuParams
from .utils import PartitionDescriptor, _ArrayBatch, get_logger


@dataclass
class FitInput:
    """Everything an estimator's `_fit_array` needs for one fit: the staged
    tensors and the resolved backend params.  The JAX package's `mesh` field
    is `device` here: one device holds every row."""

    device: Any  # torch.device
    X: Any  # torch.Tensor (n, d)
    w: Any  # torch.Tensor (n,) validity * sample weight
    y: Optional[Any]  # torch.Tensor (n,) or None
    pdesc: PartitionDescriptor
    dtype: np.dtype
    n_valid: int
    params: Dict[str, Any]  # resolved backend params (_tpu_params)
    extra: Dict[str, Any] = field(default_factory=dict)


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
        """What the fit that made this model did: its route ("staged",
        "device_dataset", "fused", "fused_parquet", "staged_parquet",
        "streamed", "streamed_csr"), the device-budget decision, whether a
        card out of memory sent it to the streamed fit, and the numbers of
        its staging, fused or streamed passes.  None for a loaded model."""
        return getattr(self, "_fit_report", None)


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
        # the JAX package keeps a fit's drift fingerprint beside the arrays;
        # the port writes none yet, so one left by an earlier save of the
        # path would attach itself to this model when the JAX package loads
        # it
        fp_path = os.path.join(path, "drift_baseline.bin")
        if os.path.exists(fp_path):
            os.remove(fp_path)


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

    def _validate_device_input(self, ds: DeviceDataset) -> None:
        """Device-side counterpart of `_validate_input` for a DeviceDataset
        (runs before any label dtype cast)."""

    def _fit_label_dtype(self) -> Optional[np.dtype]:
        # Labels are staged in float32 even under float64 features, as the
        # JAX package does; its float64 fits, and so the port's parity with
        # them, depend on it.  Kept as it is on purpose.
        return np.dtype(np.float32)

    def _stage_fit_input(self, batch: _ArrayBatch) -> FitInput:
        """Stage a host batch on the device: features in the fit's dtype
        (CSR densified chunk by chunk: the JAX package's ELL staging for
        sparse kernels is a later item), validity * sample weights, labels
        in `_fit_label_dtype`."""
        from .parallel import DeviceContext
        from .parallel.mesh import RowStager

        with DeviceContext(self.num_workers) as ctx:
            device = ctx.device
        X = batch.X
        dtype = self._out_dtype(X)
        st = RowStager(X.shape[0], device)
        Xs = st.stage_sparse(X, dtype) if _is_sparse(X) else st.stage(X, dtype)
        w = st.mask(dtype, weights=batch.weight)
        y = None
        if batch.y is not None:
            ldt = self._fit_label_dtype() or dtype
            y = st.stage(np.asarray(batch.y).reshape(-1).astype(ldt), ldt)
        return FitInput(
            device=device,
            X=Xs,
            w=w,
            y=y,
            pdesc=PartitionDescriptor.build([st.n_valid], int(X.shape[1])),
            dtype=dtype,
            n_valid=st.n_valid,
            params=dict(self._tpu_params),
        )

    def _stage_from_device(self, ds: DeviceDataset) -> FitInput:
        """A DeviceDataset's tensors as they are; only the label dtype cast
        runs, on the device."""
        supervised = getattr(self, "_is_supervised", lambda: False)()
        if supervised and ds.y is None:
            raise ValueError("Supervised fit requires a DeviceDataset with labels")
        self._validate_device_input(ds)
        y = ds.y
        ldt = self._fit_label_dtype() if supervised else None
        from .parallel.mesh import _numpy_dtype, _torch_dtype

        if y is not None and ldt is not None:
            y = y.to(_torch_dtype(ldt))
        return FitInput(
            device=ds.device,
            X=ds.X,
            w=ds.weight,
            y=y,
            pdesc=PartitionDescriptor.build([ds.n_valid], int(ds.X.shape[1])),
            dtype=_numpy_dtype(ds.X.dtype),
            n_valid=ds.n_valid,
            params=dict(self._tpu_params),
        )


class _TpuEstimator(Estimator, _TpuCaller):
    """Estimator base: the generic staged fit.  The kNN estimator
    implements `_fit` itself (it stages nothing at fit time)."""

    def __init__(self) -> None:
        super().__init__()
        self._init_tpu_params()
        self.logger = get_logger(type(self))
        # what the current fit did, for its model's `fit_report()`
        self._fit_record: Dict[str, Any] = {}

    # -- subclass contract ---------------------------------------------------

    def _fit_array(self, fit_input: FitInput) -> Dict[str, Any]:
        """Run the fit on the staged tensors; return the model's host
        attributes."""
        raise NotImplementedError(f"{type(self).__name__} implements no _fit_array")

    def _create_model(self, attrs: Dict[str, Any]) -> "_TpuModel":
        raise NotImplementedError(f"{type(self).__name__} implements no _create_model")

    def _is_supervised(self) -> bool:
        return False

    def _validate_input(self, batch: _ArrayBatch) -> None:
        """Validate the raw host batch before dtype casting and staging."""

    # -- fused stage-and-solve (fused.py) ------------------------------------

    def _supports_fused_stats(self) -> bool:
        """Whether this estimator fits from sufficient statistics that can
        be folded chunk by chunk while the rows stage (PCA and
        LinearRegression say yes)."""
        return False

    def _fit_fused(self, batch: _ArrayBatch) -> Dict[str, Any]:
        """Fused fit of a dense host batch (estimators that declare
        `_supports_fused_stats` implement it)."""
        raise NotImplementedError(f"{type(self).__name__} implements no _fit_fused")

    def _fit_fused_parquet(self, path: str) -> Dict[str, Any]:
        """Fused fit streaming chunks straight from parquet (estimators that
        declare `_supports_fused_stats` implement it)."""
        raise NotImplementedError(f"{type(self).__name__} implements no _fit_fused_parquet")

    def _maybe_fit_fused(self, source, est_bytes: Optional[float] = None
                         ) -> Optional[Dict[str, Any]]:
        """The model's attributes from the fused stage-and-solve pass when
        the conf `fused_stage_solve` routes this fit there, else None (the
        two-phase path): an estimator without the capability, CSR input, or
        the conf "off" or, under "auto", below `fused._AUTO_MIN_BYTES`.
        `source` is a host batch or a parquet path (then `est_bytes` is the
        caller's estimate).  A pass that fails raises; nothing falls back
        to the two-phase path."""
        if not self._supports_fused_stats():
            return None
        is_path = isinstance(source, str)
        if not is_path:
            if _is_sparse(source.X):
                return None
            est_bytes = (int(source.X.shape[0]) * int(source.X.shape[1])
                         * np.dtype(self._out_dtype(source.X)).itemsize)
        from .fused import fused_enabled, fused_mode

        if est_bytes is None or not fused_enabled(est_bytes):
            return None
        self.logger.info(
            "Fused stage-and-solve: accumulating sufficient statistics on the "
            f"device while the rows stage (fused_stage_solve={fused_mode()}, "
            f"~{est_bytes / 2**20:.0f} MiB).")
        self._fit_record["route"] = "fused_parquet" if is_path else "fused"
        return self._fit_fused_parquet(source) if is_path else self._fit_fused(source)

    # -- parquet and beyond the card's memory (streaming.py) -----------------

    def _device(self):
        """The device this estimator's fits run on."""
        from .parallel import DeviceContext

        with DeviceContext(self.num_workers) as ctx:
            return ctx.device

    def _supports_streaming_stats(self) -> bool:
        """Whether `_fit_streaming` can fit a parquet file beyond the
        device budget (PCA, LinearRegression, LogisticRegression, KMeans
        say yes)."""
        return False

    def _fit_streaming(self, path: str) -> Dict[str, Any]:
        raise NotImplementedError(f"{type(self).__name__} implements no _fit_streaming")

    def _fit_streaming_csr(self, batch: _ArrayBatch) -> Optional[Dict[str, Any]]:
        """Fit a host CSR batch from blocked-densify statistics (PCA and
        LinearRegression implement it); None: the whole-densify staging
        runs instead."""
        return None

    def _over_device_budget(self, need_bytes: float) -> bool:
        """Whether a staged dataset of `need_bytes` is beyond the device
        budget (`device_data_budget_bytes`), or `force_streaming_stats` is
        set.  The decision is kept for `fit_report()`."""
        from .config import get_config

        forced = bool(get_config("force_streaming_stats"))
        budget = device_data_budget_bytes(self._device())
        over = forced or need_bytes > budget
        self._fit_record["budget"] = {"need_bytes": float(need_bytes),
                                      "budget_bytes": budget, "over": over, "forced": forced}
        return over

    def _sparse_over_budget(self, batch: _ArrayBatch) -> bool:
        """Whether a CSR batch's dense form is beyond the device budget."""
        if not _is_sparse(batch.X):
            return False
        n, d = batch.X.shape
        return self._over_device_budget(n * d * np.dtype(self._out_dtype(batch.X)).itemsize)

    def _maybe_fit_sparse_stats(self, batch: _ArrayBatch) -> Optional[Dict[str, Any]]:
        """A CSR batch beyond the budget fits from blocked-CSR statistics
        where the estimator can; else None."""
        if not self._sparse_over_budget(batch):
            return None
        attrs = self._fit_streaming_csr(batch)
        if attrs is not None:
            self._fit_record["route"] = "streamed_csr"
            self.logger.info("Sparse dataset beyond the device budget: fit from blocked-CSR "
                             "streamed statistics.")
        return attrs

    def _streaming_io_params(self):
        """(featuresCol, featuresCols, labelCol, weightCol, dtype) of a
        fit from parquet."""
        features_col, features_cols = _resolve_feature_params(self)
        label_col = (self.getOrDefault("labelCol")
                     if self._is_supervised() and self.hasParam("labelCol") else None)
        weight_col = (self.getOrDefault("weightCol")
                      if self.hasParam("weightCol") and self.isSet("weightCol") else None)
        dtype = np.float32 if self._float32_inputs else np.float64
        return features_col, features_cols, label_col, weight_col, dtype

    def _stage_or_stream(self, path: str) -> Optional[Dict[str, Any]]:
        """Fit a parquet file without a host copy of it: the streamed fit
        beyond the device budget (estimators that can), the fused pass from
        parquet within it (PCA, LinearRegression, when `fused_stage_solve`
        routes there), else `stage_parquet` and `_fit_array`.  A card out
        of memory while staging or fitting sends an estimator that can to
        the streamed fit, once the failed staging is freed; any other
        error reaches the caller.  None (extract the file whole) when
        `enable_sparse_data_optim` is set."""
        import torch

        from .streaming import parquet_row_count, probe_num_features, stage_parquet

        if (self.hasParam("enable_sparse_data_optim")
                and self.getOrDefault("enable_sparse_data_optim") is True):
            return None
        fcol, fcols, label_col, weight_col, dtype = self._streaming_io_params()
        if self._supports_streaming_stats():
            need = (parquet_row_count(path) * probe_num_features(path, fcol, fcols)
                    * np.dtype(dtype).itemsize)
            if self._over_device_budget(need):
                self.logger.info(
                    f"Dataset (~{need / 2**30:.1f} GiB) beyond the device budget or "
                    "force_streaming_stats set; fitting from streamed passes over the file.")
                return self._run_streaming_fit(path)
            attrs = self._maybe_fit_fused(path, est_bytes=need)
            if attrs is not None:
                return attrs

        def staged() -> Dict[str, Any]:
            # the staged tensors live in this frame only, so they are freed
            # with it when the fit fails
            self._fit_record["route"] = "staged_parquet"
            ds = stage_parquet(
                path, features_col=fcol, features_cols=fcols, label_col=label_col,
                weight_col=weight_col, num_workers=self.num_workers, dtype=dtype,
                label_dtype=self._fit_label_dtype() if label_col else None)
            return self._run_fit_kernel(self._stage_from_device(ds))

        try:
            return staged()
        except torch.cuda.OutOfMemoryError as e:
            if not self._supports_streaming_stats():
                raise RuntimeError(
                    "Dataset exceeds device memory while stream-staging and "
                    f"{type(self).__name__} cannot fit from streamed passes") from e
        # outside the except block, so that the traceback no longer pins
        # the failed staging's tensors
        import gc

        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        self.logger.warning("Device staging ran out of memory; retrying as a streamed fit.")
        self._fit_record["oom_fallback"] = True
        return self._run_streaming_fit(path)

    def _run_streaming_fit(self, path: str) -> Dict[str, Any]:
        """The streamed fit: a plain call (the JAX package's retry policy
        is the resilience item of ROADMAP.md)."""
        self._fit_record["route"] = "streamed"
        return self._fit_streaming(path)

    # -- fit orchestration ---------------------------------------------------

    def _run_fit_kernel(self, fit_input: FitInput) -> Dict[str, Any]:
        """The seam where the JAX package's resilience layer (watchdog,
        retry, elastic restage) wraps the fit; a plain call until that
        layer is ported, so every error reaches the caller."""
        return self._fit_array(fit_input)

    def _extract(self, dataset: DatasetLike) -> _ArrayBatch:
        features_col, features_cols = _resolve_feature_params(self)
        label_col = (
            self.getOrDefault("labelCol")
            if self._is_supervised() and self.hasParam("labelCol")
            else None
        )
        weight_col = (
            self.getOrDefault("weightCol")
            if self.hasParam("weightCol") and self.isSet("weightCol")
            else None
        )
        return extract_arrays(
            dataset,
            features_col=features_col,
            features_cols=features_cols,
            label_col=label_col,
            weight_col=weight_col,
            dtype=None,  # keep the input's precision; _out_dtype decides
            supervised=self._is_supervised(),
        )

    def _fit(self, dataset: DatasetLike) -> "_TpuModel":
        from .config import get_config
        from .streaming import is_parquet_path

        t0 = time.time()
        self._fit_record = {}
        attrs = None
        if isinstance(dataset, DeviceDataset):
            self._fit_record["route"] = "device_dataset"
            fit_input = self._stage_from_device(dataset)
        else:
            if is_parquet_path(dataset) and get_config("streaming_ingest"):
                attrs = self._stage_or_stream(dataset)
            if attrs is None:
                batch = self._extract(dataset)
                self._validate_input(batch)
                attrs = self._maybe_fit_sparse_stats(batch)
                if attrs is None:
                    attrs = self._maybe_fit_fused(batch)
                if attrs is None:
                    self._fit_record["route"] = "staged"
                    fit_input = self._stage_fit_input(batch)
                del batch
        if attrs is None:
            attrs = self._run_fit_kernel(fit_input)
            del fit_input
        model = self._create_model(attrs)
        self._copyValues(model)
        model._num_workers = self._num_workers
        model._float32_inputs = self._float32_inputs
        model._fit_report = self._fit_report_record()
        self.logger.info(f"Finished fit in {time.time() - t0:.3f}s")
        return model

    def _fit_report_record(self) -> Dict[str, Any]:
        """The fit's record with the numbers of the pass its route ran."""
        from . import fused, streaming

        rec = dict(self._fit_record)
        route = rec.get("route")
        if route in ("fused", "fused_parquet"):
            rec["fused"] = dict(fused.FUSED_METRICS)
        if route == "staged_parquet":
            rec["stage"] = dict(streaming.LAST_STAGE)
        if route in ("streamed", "streamed_csr"):
            rec["streaming"] = dict(streaming.STREAM_METRICS)
        if route in ("fused_parquet", "staged_parquet", "streamed"):
            rec["parquet_readers"] = dict(fused.LAST_READER_DECISION)
        return rec


class _TpuEstimatorSupervised(_TpuEstimator):
    """Supervised variant: labels are required."""

    def _is_supervised(self) -> bool:
        return True


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

    # -- transform contract --------------------------------------------------

    def _transform_device(self, Xs: Any) -> Optional[Dict[str, Any]]:
        """Map an (n, d) feature tensor on the device to `{col: tensor}`
        outputs with rows leading.  Row-wise models implement this; the base
        `_transform_array` runs it over host-bounded chunks.  Models that
        manage their own staging (kNN) leave it unimplemented."""
        return None

    def _transform_array(self, X: np.ndarray) -> Dict[str, np.ndarray]:
        """Map a host feature block to output columns ({col_name: values})
        through the chunked `_transform_mesh`."""
        outs = self._transform_mesh(X)
        if outs is None:
            raise NotImplementedError(
                f"{type(self).__name__} implements neither _transform_array "
                "nor _transform_device"
            )
        return outs

    def _fetch_transform_outputs(self, st, dev: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """`_transform_device` outputs to the host: tensors through the
        stager's fetch after one wait for the chunk's work; host arrays
        (degenerate-model paths) cut to the chunk's rows."""
        import torch

        tensors = [v for v in dev.values() if isinstance(v, torch.Tensor)]
        if tensors and tensors[0].is_cuda:
            torch.cuda.current_stream(tensors[0].device).synchronize()
        return {
            col: st.fetch(v) if isinstance(v, torch.Tensor) else np.asarray(v)[: st.n_valid]
            for col, v in dev.items()
        }

    def _transform_mesh(self, X: Any) -> Optional[Dict[str, np.ndarray]]:
        """Batched inference on the device: rows in chunks of
        `host_batch_bytes` (halved, since two chunks are in flight), each
        staged and run through `_transform_device`.  A one-deep pipeline:
        chunk i+1 is converted on the host and copied on a side stream while
        chunk i computes; then chunk i is fetched.  None when the model has
        no `_transform_device`."""
        if type(self)._transform_device is _TpuModel._transform_device:
            return None
        import torch

        from .parallel import DeviceContext
        from .parallel.mesh import RowStager
        from .streaming import chunk_rows_for

        sparse_in = _is_sparse(X)
        if sparse_in:
            # stays CSR: each chunk densifies on its own
            X = X.tocsr()
            x_dtype = self._out_dtype(X)
        else:
            X = _ensure_dense(X)
            x_dtype = X.dtype
        n = int(X.shape[0])
        d = int(X.shape[1]) if X.ndim == 2 else 1
        if n == 0:
            # transform one dummy row, return every column cut to 0 rows
            dummy = self._transform_mesh(np.zeros((1, d), x_dtype))
            return {c: v[:0] for c, v in dummy.items()}
        with DeviceContext(self.num_workers) as ctx:
            device = ctx.device
        chunk = max(1, chunk_rows_for(d, np.dtype(x_dtype).itemsize) // 2)
        copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

        def _stage(lo: int):
            """(hi, stager, tensor, event) for chunk lo:hi, staged on the side
            stream on a card; the event marks its copy done (None on the
            CPU)."""
            hi = min(lo + chunk, n)
            st = RowStager(hi - lo, device)

            def put():
                return (st.stage_sparse if sparse_in else st.stage)(X[lo:hi], x_dtype)

            if copy_stream is None:
                return hi, st, put(), None
            with torch.cuda.stream(copy_stream):
                xt = put()
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            return hi, st, xt, ready

        outs: Dict[str, List[np.ndarray]] = {}
        pending = _stage(0)
        while pending is not None:
            hi, st, xt, ready = pending
            if ready is not None:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(ready)
                xt.record_stream(compute)  # made on the side stream, used here
            dev = self._transform_device(xt)
            pending = _stage(hi) if hi < n else None
            for col, v in self._fetch_transform_outputs(st, dev).items():
                outs.setdefault(col, []).append(v)
            del xt, dev
        if all(len(v) == 1 for v in outs.values()):
            return {c: v[0] for c, v in outs.items()}
        return {c: np.concatenate(v, axis=0) for c, v in outs.items()}

    def _output_columns(self) -> List[str]:
        if self.hasParam("predictionCol"):
            return [self.getOrDefault("predictionCol")]
        return ["prediction"]

    def _transform(self, dataset: DatasetLike):
        """Output columns appended to a copy of a pandas DataFrame or of a
        mapping of columns; for array input, the one output array, or a dict
        of them when there are several."""
        pd = sys.modules.get("pandas")  # a DataFrame exists only if pandas is imported
        is_frame = pd is not None and isinstance(dataset, pd.DataFrame)
        if is_frame and len(dataset) == 0:
            # empty input transforms to empty output (Spark semantics)
            out_df = dataset.copy()
            for col in self._output_columns():
                out_df[col] = []
            return out_df
        features_col, features_cols = _resolve_feature_params(self)
        batch = extract_arrays(
            dataset,
            features_col=features_col,
            features_cols=features_cols,
            dtype=None,
            supervised=False,
        )
        if _is_sparse(batch.X):
            # stays CSR: _transform_mesh densifies chunk by chunk
            outputs = self._transform_array(batch.X)
        else:
            X = batch.X
            outputs = self._transform_array(np.asarray(X, dtype=self._out_dtype(X)))
        if is_frame:
            out_df = dataset.copy()
            for col, values in outputs.items():
                out_df[col] = list(values) if values.ndim == 2 else values
            return out_df
        if isinstance(dataset, Mapping):
            return {**dataset, **outputs}
        if len(outputs) == 1:
            return next(iter(outputs.values()))
        return outputs


# The JAX package's `hbm_bytes` default, a TPU v5e's HBM: the port's
# budget on the CPU, so that routing there matches the JAX package's.
_JAX_HBM_BYTES = 16 * 1024 * 1024 * 1024


def device_data_budget_bytes(device) -> float:
    """The bytes a staged dataset may take on `device`: `hbm_bytes` (when
    None: the card's memory on a card, the JAX package's 16 GiB on the
    CPU) times `mem_ratio_for_data`.  One device, where the JAX package
    multiplies by its device count."""
    from .config import get_config

    hbm = get_config("hbm_bytes")
    if hbm is None:
        import torch

        device = torch.device(device)
        hbm = (torch.cuda.get_device_properties(device).total_memory
               if device.type == "cuda" else _JAX_HBM_BYTES)
    return float(hbm) * float(get_config("mem_ratio_for_data"))
