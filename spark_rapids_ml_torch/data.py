#
# Data plane — the port of spark_rapids_ml_tpu/data.py: accepted dataset
# types in, host numpy arrays out (`extract_arrays`), and `DeviceDataset`,
# rows staged once on the device and reused across fits.  Accepted: numpy
# 2-D arrays, (X, y) tuples, scipy CSR matrices, mappings of column
# name -> numpy array (the pandas-free frame the port
# also returns from `kneighbors` when pandas is absent), pandas DataFrames,
# pyarrow Tables and parquet paths (read whole here only when the conf
# `streaming_ingest` is off: else core.py streams them, streaming.py).
#
# pandas and pyarrow are imported only where a DataFrame is taken or made:
# numpy, CSR and mapping inputs never import them, so the port runs on a
# machine that has neither.
#
from __future__ import annotations

import os
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .utils import _ArrayBatch

try:  # scipy is optional at import time; CSR inputs need it
    import scipy.sparse as sp
except ImportError:  # pragma: no cover
    sp = None


DatasetLike = Any  # np.ndarray | csr_matrix | Mapping | pd.DataFrame | pa.Table | str | tuple


def _is_sparse(x: Any) -> bool:
    return sp is not None and sp.issparse(x)


def _ensure_dense(X: Any) -> np.ndarray:
    """Densify a sparse host matrix (CSR rows in, C-contiguous dense out)."""
    if _is_sparse(X):
        return np.ascontiguousarray(X.toarray())
    return X


def _to_pandas(dataset: DatasetLike):
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


def _stack_rows(rows: Sequence[Any], dtype: Optional[np.dtype]) -> np.ndarray:
    """Array-valued column (one vector per row) -> (n, d) matrix."""
    first_arr = np.asarray(rows[0])
    out_dtype = dtype if dtype is not None else (
        first_arr.dtype
        if np.issubdtype(first_arr.dtype, np.floating)
        else np.float64
    )
    return np.ascontiguousarray(np.stack([np.asarray(r) for r in rows]), dtype=out_dtype)


def _features_from_pandas(
    cols,
    features_col: Optional[str],
    features_cols: Sequence[str],
    dtype: Optional[np.dtype],
) -> np.ndarray:
    """Feature matrix from named columns: a pandas DataFrame, or a mapping
    of column name -> array (the pandas-free frame).

    Array-valued column == the VectorUDT input unwrapped; multiple scalar
    columns == the HasFeaturesCols fast path that skips VectorAssembler."""
    n_rows = _mapping_rows(cols) if isinstance(cols, Mapping) else len(cols)
    if n_rows == 0:
        raise ValueError("Dataset is empty: nothing to fit/transform")
    if features_cols:
        missing = [c for c in features_cols if c not in cols]
        if missing:
            raise ValueError(f"featuresCols {missing} not found in dataset")
        return np.ascontiguousarray(
            np.stack([np.asarray(cols[c], dtype=dtype) for c in features_cols], axis=1)
        )
    assert features_col is not None
    if features_col not in cols:
        raise ValueError(f"featuresCol '{features_col}' not found in dataset")
    col = cols[features_col]
    if isinstance(col, np.ndarray) and col.ndim == 2:
        return np.ascontiguousarray(col, dtype=dtype)
    col = col.to_numpy() if hasattr(col, "to_numpy") else np.asarray(col, dtype=object)
    if np.isscalar(col[0]):
        return np.ascontiguousarray(np.asarray(col, dtype=dtype).reshape(-1, 1))
    return _stack_rows(col, dtype)


def _mapping_rows(cols: Mapping[str, Any]) -> int:
    lengths = {len(v) if not _is_sparse(v) else v.shape[0] for v in cols.values()}
    if len(lengths) != 1:
        raise ValueError(f"columns have different lengths: {sorted(lengths)}")
    return lengths.pop()


def extract_arrays(
    dataset: DatasetLike,
    features_col: Optional[str] = None,
    features_cols: Sequence[str] = (),
    label_col: Optional[str] = None,
    weight_col: Optional[str] = None,
    id_col: Optional[str] = None,
    dtype: Union[np.dtype, type, None] = None,
    supervised: bool = False,
) -> _ArrayBatch:
    """Normalize any accepted dataset into host numpy arrays."""
    dtype = np.dtype(dtype) if dtype is not None else None
    y = w = rid = None

    if isinstance(dataset, (tuple, list)) and len(dataset) == 2:
        X, y = dataset
        if not _is_sparse(X) and dtype is not None:
            X = np.asarray(X, dtype=dtype)
        y = np.asarray(y)
    elif isinstance(dataset, np.ndarray):
        X = np.asarray(dataset, dtype=dtype)
        if X.ndim == 1:
            X = X.reshape(-1, 1)
    elif _is_sparse(dataset):
        X = dataset.tocsr()
    else:
        cols = dataset if isinstance(dataset, Mapping) else _to_pandas(dataset)
        X = _features_from_pandas(cols, features_col, list(features_cols), dtype)
        if supervised:
            if label_col is None or label_col not in cols:
                raise ValueError(f"labelCol '{label_col}' not found in dataset")
            y = np.asarray(cols[label_col])
        if weight_col and weight_col in cols:
            w = np.asarray(cols[weight_col], dtype=dtype)
        if id_col and id_col in cols:
            rid = np.asarray(cols[id_col])

    if supervised and y is None:
        raise ValueError("Supervised fit requires labels: pass (X, y) or a DataFrame with labelCol")
    if y is not None:
        y = np.ascontiguousarray(np.asarray(y).reshape(-1))
    if not _is_sparse(X):
        X = np.asarray(X, dtype=dtype)
        if not np.issubdtype(X.dtype, np.floating):
            # integer/bool features promote to float64 (Spark double semantics)
            X = X.astype(np.float64)
        X = np.ascontiguousarray(X)
    return _ArrayBatch(X=X, y=y, weight=w, row_id=rid)


class DeviceDataset:
    """A dataset staged once onto the device and reused across fits, the
    counterpart of benchmarking against a cached Spark DataFrame:
    `fit(DeviceDataset)` skips host extraction and host-to-device staging.
    Build one with `DeviceDataset.from_host(X, y)` or from any accepted
    dataset type with `DeviceDataset.persist(dataset, ...)`.  One device,
    so the rows are exactly the host's (no padding)."""

    def __init__(self, device, X, n_valid: int, y=None, weight=None) -> None:
        self.device = device
        self.X = X  # torch.Tensor (n, d)
        self.y = y  # torch.Tensor (n,) or None
        self.weight = weight  # torch.Tensor (n,) validity * sample weight
        self.n_valid = int(n_valid)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_valid, int(self.X.shape[1]))

    def to_host_batch(self) -> _ArrayBatch:
        """The rows back on the host."""

        def fetch(t):
            return None if t is None else t.detach().cpu().numpy()

        return _ArrayBatch(X=fetch(self.X), y=fetch(self.y), weight=fetch(self.weight))

    @classmethod
    def from_host(
        cls,
        X: np.ndarray,
        y: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        num_workers: Optional[int] = None,
        dtype: Union[np.dtype, type] = np.float32,
        label_dtype: Union[np.dtype, type, None] = None,
    ) -> "DeviceDataset":
        from .parallel import DeviceContext
        from .parallel.mesh import RowStager

        dtype = np.dtype(dtype)
        with DeviceContext(num_workers) as ctx:
            device = ctx.device
        X = X.tocsr() if _is_sparse(X) else np.asarray(X)
        st = RowStager(X.shape[0], device)
        # CSR is densified chunk by chunk on its way to the device
        Xs = st.stage_sparse(X, dtype) if _is_sparse(X) else st.stage(X, dtype)
        w = st.mask(dtype, weights=weight)
        yd = None
        if y is not None:
            ldt = np.dtype(label_dtype) if label_dtype is not None else dtype
            yd = st.stage(np.asarray(y).reshape(-1).astype(ldt), ldt)
        return cls(device, Xs, st.n_valid, y=yd, weight=w)

    @classmethod
    def persist(
        cls,
        dataset: DatasetLike,
        features_col: Optional[str] = None,
        features_cols: Sequence[str] = (),
        label_col: Optional[str] = None,
        weight_col: Optional[str] = None,
        num_workers: Optional[int] = None,
        dtype: Union[np.dtype, type] = np.float32,
    ) -> "DeviceDataset":
        batch = extract_arrays(
            dataset,
            features_col=features_col,
            features_cols=features_cols,
            label_col=label_col,
            weight_col=weight_col,
            supervised=label_col is not None,
        )
        return cls.from_host(
            batch.X,
            y=batch.y,
            weight=batch.weight,
            num_workers=num_workers,
            dtype=dtype,
        )
