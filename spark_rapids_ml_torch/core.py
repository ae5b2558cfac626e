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
# The meta layer: `fitMultiple` stages a dataset once and fits every param
# map on the same tensors (a DeviceDataset, or a CrossValidator fold view
# of the stage-once dataset cache, is taken as it is); `_cached_fit_entry`
# stages a CrossValidator run's dataset in that cache
# (parallel/device_cache.py); `_combine` / `_CombinedModel` and
# `_transformEvaluate` score several models on one extraction of the eval
# rows; `_evaluate_frame` is the front half of the models' `evaluate`.
#
# Sparse rows: an estimator with a sparse kernel (`_use_sparse_kernel`:
# LogisticRegression) stages a CSR batch as ELL (ops/sparse.py), the values
# as X and the int32 column ids as `extra["ell_cols"]`.
#
# Resilience (resilience/): `_run_fit_kernel` runs the fit under the
# `fit_kernel` fault site, the `guarded` watchdog (`dispatch_deadline_s`)
# and the retry policy; the streamed fits and the transform's chunks run
# under the same policy, the transform halving its chunk after an OOM and
# re-dispatching from its first unpublished row.  `_fit_fingerprint` binds
# a checkpoint tag to the staged data, exactly as the JAX package does, so
# the tags and file names of the two packages agree.
#
# Left for later slices: Spark DataFrames, the baseline fold, the CPU
# fallback (`cpu_fallback_enabled=True` raises where it would run), and the
# telemetry seams.
#
from __future__ import annotations

import json
import os
import sys
import threading
import time
from abc import abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .data import DatasetLike, DeviceDataset, _ensure_dense, _is_sparse, extract_arrays
from .params import Param, Params, _TpuParams
from .parallel.device_cache import device_data_budget_bytes
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


def _isum(t) -> int:
    """The sum of a tensor's elements bit-cast to integers of its own
    width, wrapping around in that width, as the JAX package's
    `_fit_fingerprint` sums them: exact, so independent of order.  The
    sums run in int64 on the tensor's device with no full-size copy; an
    8-byte element is summed as its two 32-bit words."""
    import torch

    width = t.element_size()
    itype = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[width]
    t = t.reshape(-1)
    t = t.view(itype) if t.is_floating_point() else t.to(itype)
    if width == 8:
        words = t.view(torch.int32).reshape(-1, 2)  # little-endian: (low, high)
        low = words[:, 0]
        # the low word is unsigned: a negative int32 stands for itself + 2^32
        total = (int(low.sum(dtype=torch.int64)) + int((low < 0).sum()) * (1 << 32)
                 + int(words[:, 1].sum(dtype=torch.int64)) * (1 << 32))
    else:
        total = int(t.sum(dtype=torch.int64))
    bits = 8 * width
    return (total + (1 << (bits - 1))) % (1 << bits) - (1 << (bits - 1))


def _fit_fingerprint(fit_input: "FitInput") -> str:
    """A content fingerprint that binds an in-memory checkpoint tag to the
    data, not just its shape: the wrapped integer sums (`_isum`) of the
    staged features, weights and labels.  The JAX package's string, so a
    checkpoint written by either package resumes in the other (the port
    stages no padding rows; the JAX package's are +0.0, whose bits are
    0)."""
    parts = [f"sx={_isum(fit_input.X)}", f"swt={_isum(fit_input.w)}"]
    if fit_input.y is not None:
        parts.append(f"sy={_isum(fit_input.y)}")
    return "|".join(parts)


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

    def _use_sparse_kernel(self, batch: _ArrayBatch) -> bool:
        """Whether a batch stages as ELL for a sparse kernel instead of
        densifying; estimators with sparse kernels override."""
        return False

    def _stage_fit_input(self, batch: _ArrayBatch) -> FitInput:
        """Stage a host batch on the device: features in the fit's dtype
        (as ELL values with `extra["ell_cols"]` when `_use_sparse_kernel`,
        else dense, CSR densified chunk by chunk), validity * sample
        weights, labels in `_fit_label_dtype`."""
        from .parallel import DeviceContext
        from .parallel.mesh import RowStager

        with DeviceContext(self.num_workers) as ctx:
            device = ctx.device
        X = batch.X
        st = RowStager(X.shape[0], device)
        extra: Dict[str, Any] = {}
        if self._use_sparse_kernel(batch):
            import scipy.sparse as sp

            from .ops.sparse import ell_from_csr

            # enable_sparse_data_optim=True stages dense rows as ELL too
            vals, cols = ell_from_csr(X if _is_sparse(X) else sp.csr_matrix(X))
            dtype = self._out_dtype(vals)
            Xs = st.stage(vals, dtype)
            extra["ell_cols"] = st.copy(cols)
            del vals, cols
        else:
            dtype = self._out_dtype(X)
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
            extra=extra,
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

    def _enable_fit_multiple_in_single_pass(self) -> bool:
        return True

    def _supports_fold_weights(self) -> bool:
        """Whether a CrossValidator fold may be a weight mask over the
        resident dataset (parallel/device_cache.py `FoldSet.train_view`):
        the kernels treat a zero-weight row as absent and the fit does not
        depend on the row count.  LinearRegression, LogisticRegression and
        PCA say yes; the default, a gathered view of the fold's rows, is
        always right."""
        return False

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
        caller's estimate).  The pass runs under the retry policy; one that
        still fails raises, and nothing falls back to the two-phase path."""
        if not self._supports_fused_stats():
            return None
        is_path = isinstance(source, str)
        if not is_path:
            if _is_sparse(source.X) or self._use_sparse_kernel(source):
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
        from .resilience import retry_call

        self._fit_record["route"] = "fused_parquet" if is_path else "fused"
        # a retried pass starts with fresh accumulators
        return retry_call((lambda: self._fit_fused_parquet(source)) if is_path
                          else (lambda: self._fit_fused(source)),
                          label="fused_fit", log=self.logger)

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
        """Whether a staged dataset of `need_bytes`, beside the bytes the
        device-budget ledger holds (`cache_resident_bytes`: the chunk
        cache's device tier and the dataset cache's entries, which are
        evicted first), is beyond the device budget
        (`device_data_budget_bytes`), or `force_streaming_stats` is set;
        with the flag set the ledger is not read.  The decision is kept for
        `fit_report()`."""
        from .config import get_config
        from .parallel.device_cache import cache_resident_bytes, evict_to_fit

        forced = bool(get_config("force_streaming_stats"))
        budget = device_data_budget_bytes(self._device())
        if not forced and need_bytes + cache_resident_bytes() > budget:
            # resident datasets can be staged again: evict them before the
            # fit gives way to them
            evict_to_fit(need_bytes, budget)
        resident = 0 if forced else cache_resident_bytes()
        over = forced or need_bytes + resident > budget
        self._fit_record["budget"] = {"need_bytes": float(need_bytes), "budget_bytes": budget,
                                      "resident_bytes": int(resident), "over": over,
                                      "forced": forced}
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
            from .resilience import maybe_inject

            self._fit_record["route"] = "staged_parquet"
            maybe_inject("stage_parquet")
            ds = stage_parquet(
                path, features_col=fcol, features_cols=fcols, label_col=label_col,
                weight_col=weight_col, num_workers=self.num_workers, dtype=dtype,
                label_dtype=self._fit_label_dtype() if label_col else None)
            return self._run_fit_kernel(self._stage_from_device(ds))

        from .resilience import is_oom

        try:
            return staged()
        except Exception as e:
            if not is_oom(e):
                raise
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
        """The streamed fit under the retry policy: every pass streams the
        file again, so a re-dispatch needs no restaging, and with
        `checkpoint_dir` (or `streaming_checkpoint_dir`) set it resumes
        from its last completed iteration."""
        from .resilience import retry_call

        self._fit_record["route"] = "streamed"
        return retry_call(lambda: self._fit_streaming(path), label="fit_streaming",
                          log=self.logger)

    # -- fit orchestration ---------------------------------------------------

    def _run_fit_kernel(self, fit_input: FitInput) -> Dict[str, Any]:
        """The fit through the resilience layer: the `fit_kernel` fault
        site, the `guarded` watchdog (`dispatch_deadline_s`; the call ends
        in a device synchronization) and the retry policy.  A transient
        error backs off and re-dispatches, an OOM frees memory and
        re-dispatches once, a preemption or a simulated device loss
        re-dispatches, and an iterative solver with `checkpoint_dir` set
        then resumes from its checkpoint; a sticky CUDA error propagates.
        Every attempt runs on the same staged tensors and on the same
        device: no recovery moves the fit to the CPU."""
        from .resilience import guarded, maybe_inject, retry_call

        def kernel() -> Dict[str, Any]:
            maybe_inject("fit_kernel")
            return self._fit_array(fit_input)

        return retry_call(lambda: guarded(kernel, label="fit_kernel", log=self.logger),
                          label="fit_kernel", log=self.logger)

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
        from .parallel.device_cache import chunk_metrics_snapshot
        from .streaming import is_parquet_path

        if self._use_cpu_fallback():
            raise NotImplementedError(
                f"{type(self).__name__}: cpu_fallback_enabled with an unsupported param "
                f"({sorted(self._fallback_params)}) needs the scikit-learn fallback, "
                "which is not ported (the Meta layer item (2) of ROADMAP.md)")
        from .resilience import counts_snapshot
        from .tracing import device_profile

        t0 = time.time()
        self._fit_record = {}
        self._chunk_metrics_at_start = chunk_metrics_snapshot()
        self._resilience_at_start = counts_snapshot()
        attrs = None
        # `profile_dir` set: the fit runs under torch.profiler (tracing.py)
        with device_profile():
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

    def fitMultiple(self, dataset: DatasetLike, paramMaps: Sequence[Dict[Param, Any]]
                    ) -> Iterator[Tuple[int, "_TpuModel"]]:
        """Fit one model per param map, staging the data once: every map's
        fit runs on the same staged tensors (a DeviceDataset's are taken as
        they are).  Each map fits on its own (`fit`) when single-pass is
        off or the data is CSR beyond the device budget (its fits read the
        blocked-CSR statistics)."""
        estimator = self.copy()
        single_pass = estimator._enable_fit_multiple_in_single_pass()
        batch = None
        if (single_pass and not isinstance(dataset, DeviceDataset)
                and type(estimator)._fit_streaming_csr is not _TpuEstimator._fit_streaming_csr):
            batch = estimator._extract(dataset)
            if estimator._sparse_over_budget(batch):
                single_pass = False
        if not single_pass:
            def fit_single(index: int) -> Tuple[int, "_TpuModel"]:
                return index, estimator.fit(dataset, paramMaps[index])

            return _FitMultipleIterator(fit_single, len(paramMaps))
        if isinstance(dataset, DeviceDataset):
            staged = estimator._stage_from_device(dataset)
        else:
            if batch is None:
                batch = estimator._extract(dataset)
            estimator._validate_input(batch)
            staged = estimator._stage_fit_input(batch)
        del batch

        def fit_single(index: int) -> Tuple[int, "_TpuModel"]:
            est_i = estimator.copy(paramMaps[index])
            attrs = est_i._run_fit_kernel(
                FitInput(**{**staged.__dict__, "params": dict(est_i._tpu_params)}))
            model = est_i._create_model(attrs)
            est_i._copyValues(model, paramMaps[index])
            model._num_workers = est_i._num_workers
            model._float32_inputs = est_i._float32_inputs
            model._fit_report = {"route": "fit_multiple"}
            return index, model

        return _FitMultipleIterator(fit_single, len(paramMaps))

    def _cached_fit_entry(self, dataset: DatasetLike):
        """The dataset cache's entry for `dataset` (parallel/device_cache.py
        `get_or_stage`), staged once on a miss; None keeps the caller on
        the legacy path: the cache off (conf `device_cache`), the CPU
        fallback armed, single-pass off, CSR input or the sparse kernel
        asked for, or the entry beyond the budget or the card's memory.
        The reservation is the JAX package's: the arrays times (devices +
        2), 3 on one device, room for the fold views."""
        from .parallel.device_cache import LAST_DECISION, cache_enabled, get_or_stage

        if not cache_enabled() or self._use_cpu_fallback():
            return None
        if not self._enable_fit_multiple_in_single_pass():
            return None
        if (self.hasParam("enable_sparse_data_optim")
                and self.getOrDefault("enable_sparse_data_optim") is True):
            return None
        t0 = time.perf_counter()
        batch = self._extract(dataset)
        t_extract = time.perf_counter() - t0
        if _is_sparse(batch.X):
            return None
        self._validate_input(batch)
        X = _ensure_dense(batch.X)
        entry = get_or_stage(
            X, batch.y, batch.weight, dtype=self._out_dtype(X),
            label_dtype=self._fit_label_dtype() if self._is_supervised() else None,
            device=self._device(), logger=self.logger, working_factor=3.0)
        LAST_DECISION["extract_s"] = t_extract
        return entry

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
        cache = _chunk_cache_report(getattr(self, "_chunk_metrics_at_start", None))
        if cache:
            rec["chunk_cache"] = cache
        start = getattr(self, "_resilience_at_start", None)
        if start is not None:
            from .resilience.metrics import counts_since

            moved = counts_since(start)
            if moved:
                # checkpoint saves and resumes, retries, injected faults and
                # watchdog expiries during the fit, by the JAX package's
                # counter names
                rec["resilience"] = moved
        return rec


def _chunk_cache_report(start: Optional[Dict[str, int]]) -> Dict[str, int]:
    """What the chunk cache did during a fit: each counter's change since
    `start` (hits, misses, hit_bytes, spills, ...) and the tier sizes as
    they stand; empty when the fit touched no cached stream, as the JAX
    package's report omits its `chunk_cache` section."""
    from .parallel.device_cache import CHUNK_GAUGES, chunk_metrics_snapshot

    if start is None:
        return {}
    now = chunk_metrics_snapshot()
    delta = {k: v - start.get(k, 0) for k, v in now.items() if k not in CHUNK_GAUGES}
    if not any(delta.values()):
        return {}
    delta.update({k: now[k] for k in CHUNK_GAUGES})
    return delta


class _FitMultipleIterator:
    """Thread-safe (index, model) iterator of `fitMultiple`."""

    def __init__(self, fitSingleModel: Callable[[int], Tuple[int, Any]], numModels: int) -> None:
        self.fitSingleModel = fitSingleModel
        self.numModels = numModels
        self.counter = 0
        self.lock = threading.Lock()

    def __iter__(self) -> "_FitMultipleIterator":
        return self

    def __next__(self) -> Tuple[int, Any]:
        with self.lock:
            index = self.counter
            if index >= self.numModels:
                raise StopIteration("No models remaining.")
            self.counter += 1
        return self.fitSingleModel(index)


class _TpuEstimatorSupervised(_TpuEstimator):
    """Supervised variant: labels are required."""

    def _is_supervised(self) -> bool:
        return True


def weights_on(a: Any, device, dtype) -> Any:
    """A model array as a tensor on `device` in `dtype`.  A serving model's
    pinned attributes are tensors already on the card (serving/registry.py)
    and are only cast there; a host array is copied."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


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
        staged and run through `_transform_device`.  Under `shape_bucketing`
        (the JAX package's rule) full chunks sit on the row-bucket grid and
        the tail chunk is staged zero-padded up to it (parallel/mesh.py
        `bucket_rows`), so every chunk of a padding class computes with
        one product shape; a chunk an OOM halved below the grid stages its
        exact rows.  A one-deep pipeline:
        chunk i+1 is converted on the host and copied on a side stream while
        chunk i computes; then chunk i is fetched and published whole.

        Failures follow the retry policy (resilience/retry.py), as in the
        JAX package: the chunks in flight are dropped and the loop resumes
        at the first row not yet published, so no row is lost or written
        twice.  An OOM halves the chunk (down to one row) after the card has
        drained and the caches are freed; a transient error backs off, at
        most `retry_max_attempts` times since the last published chunk; a
        preemption or a simulated device loss re-dispatches; a sticky CUDA
        error propagates.  The `transform_dispatch` fault site fires before
        each chunk.  None when the model has no `_transform_device`."""
        if type(self)._transform_device is _TpuModel._transform_device:
            return None
        import gc

        import torch

        from .config import get_config
        from .parallel import DeviceContext
        from .parallel.mesh import RowStager, bucket_rows, bucket_rows_floor
        from .resilience import RetryPolicy, maybe_inject
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
        # a transform is row-wise: one device runs it whatever worker count
        # the model was fitted (and saved) with
        with DeviceContext() as ctx:
            device = ctx.device
        chunk = chunk_rows_for(d, np.dtype(x_dtype).itemsize)
        bucketing = bool(get_config("shape_bucketing"))
        if bucketing:
            # full chunks on the bucket grid carry no padding; only the tail
            # chunk pads up (mesh.py `bucket_rows`), as in the JAX package
            chunk = bucket_rows_floor(chunk)
        chunk = max(1, chunk // 2)
        if bucketing:
            chunk = bucket_rows_floor(chunk)
        copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

        def _stage(lo: int):
            """(hi, stager, tensor, event) for chunk lo:hi, staged on the side
            stream on a card; the event marks its copy done (None on the
            CPU)."""
            maybe_inject("transform_dispatch")
            hi = min(lo + chunk, n)
            # a chunk pads up to its bucket only where the bucket fits the
            # chunk size: an OOM-halved chunk below the grid stages exact
            # rows, so halving still frees memory
            st = RowStager.for_replicated(
                hi - lo, device, bucketing=bucketing and bucket_rows(hi - lo) <= chunk)

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
        policy = RetryPolicy.from_config()

        def halve() -> None:
            # drain the dropped chunks' work before their memory is reused,
            # and drop the re-creatable cache residency, which may be the
            # pressure
            nonlocal chunk
            from .parallel.device_cache import clear_device_cache

            if device.type == "cuda":
                torch.cuda.synchronize(device)
            clear_device_cache()
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            chunk = max(1, chunk // 2)

        retries = 0  # failures other than OOM since the last published chunk
        done = 0  # rows published
        while done < n:
            try:
                pending = _stage(done)
                while pending is not None:
                    hi, st, xt, ready = pending
                    if ready is not None:
                        compute = torch.cuda.current_stream(device)
                        compute.wait_event(ready)
                        xt.record_stream(compute)  # made on the side stream, used here
                    dev = self._transform_device(xt)
                    pending = _stage(hi) if hi < n else None
                    fetched = self._fetch_transform_outputs(st, dev)
                    for col, v in fetched.items():
                        outs.setdefault(col, []).append(v)
                    done = hi
                    retries = 0  # progress resets the budget
                    del xt, dev, fetched
                break
            except Exception as e:
                # an OOM halves the chunk down to one row whatever the
                # attempts; any other failure spends one of them
                action = policy.classify(e)
                if action != "oom":
                    retries += 1
                if not policy.admits(e, action, retries, chunk > 1, "transform_dispatch",
                                     self.logger):
                    raise
            # the recovery runs outside the except block, whose traceback
            # pins the failed chunk's tensors
            pending = xt = dev = fetched = None  # noqa: F841
            policy.recover(action, retries, "transform_dispatch",
                           f"action={action} resume_row={done}", self.logger, on_oom=halve)
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

    # -- several models on one evaluation pass ---------------------------------

    @classmethod
    def _combine(cls, models: List["_TpuModel"]) -> "_CombinedModel":
        """N models (one per param map) scored on one extraction of the
        evaluation rows."""
        return _CombinedModel(models)

    def _transformEvaluate(self, dataset: DatasetLike, evaluator: Any) -> List[float]:
        """Transform and metric in one call (`_CombinedModel` of one)."""
        return _CombinedModel([self])._transformEvaluate(dataset, evaluator)


def _evaluate_frame(model: "_TpuModel", dataset: DatasetLike):
    """The front half of the models' `evaluate`: the dataset as a pandas
    frame, its label and weight columns checked, the model's `_transform`;
    returns (out_df, labels, predictions, weights), the last three float64
    on the host (weights None unless the model's weightCol is set)."""
    pdf = _to_pandas(dataset)
    label_col = model.getOrDefault("labelCol")
    if label_col not in pdf.columns:
        raise ValueError(f"evaluate requires the label column '{label_col}'")
    if len(pdf) == 0:
        raise ValueError("Dataset is empty: nothing to evaluate")
    out_df = model._transform(pdf)
    y = np.asarray(out_df[label_col], np.float64)
    preds = np.asarray(out_df[model.getOrDefault("predictionCol")], np.float64)
    weights = None
    if model.hasParam("weightCol") and model.isSet("weightCol"):
        wc = model.getOrDefault("weightCol")
        if wc not in out_df.columns:
            raise ValueError(f"weightCol '{wc}' is set on the model but absent from the "
                             "evaluation dataset")
        weights = np.asarray(out_df[wc], np.float64)
    return out_df, y, preds, weights


def _to_pandas(dataset: DatasetLike):
    """A pandas frame of a frame, a pyarrow Table or a parquet path, as the
    JAX package reads them for `evaluate`."""
    import pandas as pd

    if isinstance(dataset, pd.DataFrame):
        return dataset
    import pyarrow as pa

    if isinstance(dataset, pa.Table):
        return dataset.to_pandas()
    if isinstance(dataset, str):
        import pyarrow.parquet as pq

        if os.path.isdir(dataset) or dataset.endswith(".parquet"):
            return pq.read_table(dataset).to_pandas()
        raise ValueError(f"Unsupported dataset path: {dataset}")
    raise TypeError(f"Cannot interpret dataset of type {type(dataset)} as a DataFrame")


class _CombinedModel:
    """N models scored against one evaluation dataset: a frame's features
    are extracted once and each model transforms the same host arrays; a
    `CachedEvalView` scores the rows resident on the device."""

    def __init__(self, models: List[_TpuModel]) -> None:
        if not models:
            raise ValueError("_combine requires at least one model")
        self.models = list(models)

    def _transformEvaluate(self, dataset: DatasetLike, evaluator: Any) -> List[float]:
        import pandas as pd

        from .parallel.device_cache import CachedEvalView

        if isinstance(dataset, CachedEvalView):
            return dataset.evaluate(self.models, evaluator)
        if not isinstance(dataset, pd.DataFrame):
            return [evaluator.evaluate(m.transform(dataset)) for m in self.models]
        features_col, features_cols = _resolve_feature_params(self.models[0])
        batch = extract_arrays(dataset, features_col=features_col,
                               features_cols=features_cols, dtype=None, supervised=False)
        X = batch.X if _is_sparse(batch.X) else _ensure_dense(batch.X)
        results = []
        for m in self.models:
            outputs = m._transform_array(X if _is_sparse(X) else np.asarray(X, m._out_dtype(X)))
            cols = {c: list(v) if v.ndim == 2 else v for c, v in outputs.items()}
            base = dataset.drop(columns=[c for c in cols if c in dataset.columns])
            results.append(evaluator.evaluate(
                pd.concat([base, pd.DataFrame(cols, index=dataset.index)], axis=1)))
        return results
