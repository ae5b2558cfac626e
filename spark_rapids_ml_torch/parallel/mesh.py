#
# Host -> device staging on one device: the port of `RowStager`
# (spark_rapids_ml_tpu/parallel/mesh.py).  One GPU needs no sharding and
# no bucket padding, so staged arrays have exactly the host's rows; the
# validity mask and the int32 row ids keep the JAX package's interface,
# and the kernels still honour a mask with zeros.
#
# Rows move in chunks of at most `_CHUNK_BYTES`: each chunk is converted to
# the target dtype (or densified, for CSR) on the host, copied into a
# pinned buffer, and sent with a `non_blocking` copy straight into its rows
# of the device tensor.  PyTorch's pinned-memory cache keeps a buffer alive
# until its copy has run and then hands it to a later chunk, so a few
# chunk-sized buffers are pinned once instead of one buffer the size of the
# data for every staging, and the host never holds a second full copy.
#
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

_CHUNK_BYTES = 64 << 20

# Cumulative staging counters: `dataset_stagings` counts every host-to-device
# staging of a 2-D feature block (`RowStager.stage` of a 2-D array and
# `stage_sparse`): fit inputs and each chunk of a transform, as the JAX
# package counts them.  The `cache_*` keys mirror the dataset cache's
# counters (parallel/device_cache.py).  Tests and chip_smoke.py read their
# changes: a CrossValidator run on the dataset cache stages once.
STAGE_COUNTS: Dict[str, int] = {
    "dataset_stagings": 0,
    "cache_hits": 0,
    "cache_misses": 0,
    "cache_evictions": 0,
    "cache_inserts": 0,
}
_counts_lock = threading.Lock()


def note_stage_count(key: str = "dataset_stagings") -> None:
    with _counts_lock:
        STAGE_COUNTS[key] = STAGE_COUNTS.get(key, 0) + 1


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.zeros(0, dtype=dtype).numpy().dtype


class RowStager:
    """Stages host arrays of `n_rows` rows onto `device` in one layout, so
    features, masks and row ids line up."""

    def __init__(self, n_rows: int, device: torch.device) -> None:
        self.device = torch.device(device)
        self.n_valid = int(n_rows)

    def _assemble(self, shape, dtype: np.dtype,
                  chunk: Callable[[int, int], np.ndarray]) -> torch.Tensor:
        """Device tensor of `shape` filled chunk by chunk; `chunk(lo, hi)`
        gives rows lo:hi on the host, already in `dtype`."""
        out = torch.empty(shape, dtype=_torch_dtype(dtype), device=self.device)
        row_bytes = max(int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize, 1)
        rows = max(1, _CHUNK_BYTES // row_bytes)
        for lo in range(0, self.n_valid, rows):
            hi = min(lo + rows, self.n_valid)
            src = torch.from_numpy(np.ascontiguousarray(chunk(lo, hi)))
            if self.device.type == "cuda":
                pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                pinned.copy_(src)
                src = pinned
            out[lo:hi].copy_(src, non_blocking=True)
        return out

    def stage(self, arr: np.ndarray, dtype: Optional[np.dtype] = None) -> torch.Tensor:
        """(n_rows, ...) host array -> device tensor of `dtype`."""
        arr = np.asarray(arr)
        if arr.shape[0] != self.n_valid:
            raise ValueError(f"array has {arr.shape[0]} rows, stager expects {self.n_valid}")
        dtype = np.dtype(dtype) if dtype is not None else arr.dtype
        if arr.ndim == 2:
            # labels, weights and fold ids ride along a staging of features
            note_stage_count()
        return self._assemble(arr.shape, dtype,
                              lambda lo, hi: arr[lo:hi].astype(dtype, copy=False))

    def stage_sparse(self, X, dtype: Optional[np.dtype] = None) -> torch.Tensor:
        """Host CSR matrix -> DENSE device tensor, densified chunk by chunk,
        so the host never holds the whole dense matrix."""
        X = X.tocsr()
        if X.shape[0] != self.n_valid:
            raise ValueError(f"matrix has {X.shape[0]} rows, stager expects {self.n_valid}")
        dtype = np.dtype(dtype) if dtype is not None else np.dtype(X.dtype)
        note_stage_count()
        return self._assemble(X.shape, dtype,
                              lambda lo, hi: X[lo:hi].toarray().astype(dtype, copy=False))

    def mask(self, dtype=np.float32, weights: Optional[np.ndarray] = None) -> torch.Tensor:
        """Validity times sample weight for each row: 1 for every real row
        when `weights` is None (one device adds no padding), else the
        weights in `dtype`."""
        if weights is None:
            return torch.ones(self.n_valid, dtype=_torch_dtype(np.dtype(dtype)),
                              device=self.device)
        return self.stage(np.asarray(weights).reshape(-1), dtype)

    def row_ids(self) -> torch.Tensor:
        """int32 row positions 0..n_rows-1."""
        return torch.arange(self.n_valid, dtype=torch.int32, device=self.device)

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """Device (n_rows, ...) tensor -> host numpy, rows in order."""
        return t.detach().cpu().numpy()
