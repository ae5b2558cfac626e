#
# Host -> device staging on one device: the port of `RowStager`
# (spark_rapids_ml_tpu/parallel/mesh.py).  One GPU needs no sharding, so
# a fit's staged arrays have exactly the host's rows; the validity mask
# and the int32 row ids keep the JAX package's interface, and the kernels
# still honour a mask with zeros.  A transform's stager (`for_replicated`)
# pads its rows with zeros to the shape-bucket grid (`bucket_rows`) under
# `shape_bucketing`, as the JAX package's does: every chunk size of a
# padding class then computes with one product shape, so a row's output
# does not depend on how many rows share its chunk.  `fetch` returns the
# valid rows only.
#
# Rows move in chunks of at most `_CHUNK_BYTES`: each chunk is converted to
# the target dtype (or densified, for CSR) on the host, copied into a
# pinned buffer, and sent with a `non_blocking` copy straight into its rows
# of the device tensor.  PyTorch's pinned-memory cache keeps a buffer alive
# until its copy has run and then hands it to a later chunk, so a few
# chunk-sized buffers are pinned once instead of one buffer the size of the
# data for every staging, and the host never holds a second full copy.
# An array below `_SMALL_DIRECT_BYTES` (the serving layer's micro-batches)
# skips the chunk loop under `staging_small_direct`: one cast into a
# pinned buffer this thread reuses, one direct copy to the card.
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


def bucket_rows(n: int) -> int:
    """Smallest {1, 1.5} x 2^k >= n (min 256): the shape-bucketing grid of
    the JAX package (its `parallel/mesh.py` `bucket_rows`)."""
    if n <= 256:
        return 256
    p = 1 << (int(n - 1).bit_length() - 1)  # largest power of two < n
    for c in (p, p + p // 2, 2 * p):
        if c >= n:
            return c
    return 2 * p


def bucket_rows_floor(n: int) -> int:
    """Largest grid point <= n (min 256).  Chunked loops size their
    full chunks with it, so no full chunk carries bucket padding; only
    the tail chunk buckets up."""
    if n <= 256:
        return 256
    b = bucket_rows(n)
    if b == n:
        return n
    # previous grid point: 1.5*2^k points are divisible by 3, 2^k never is
    return (2 * b) // 3 if b % 3 == 0 else (3 * b) // 4


# arrays below this stage by the small direct path (the JAX package's
# `_PIPELINED_MIN_BYTES`, below which its pipelined engine does not run)
_SMALL_DIRECT_BYTES = 4 * 1024 * 1024

# per-thread pinned host buffers of the small direct path, in a ring: a
# buffer is rewritten only after the copy that last read it has run (its
# event), and a ring of several lets the next batches stage while earlier
# copies are still queued behind other streams' work
_SMALL_RING = 8
_small_tls = threading.local()


class _PinnedSlot:
    __slots__ = ("buf", "event")

    def __init__(self) -> None:
        self.buf: Optional[torch.Tensor] = None
        self.event = None


def _small_slot(nbytes: int) -> "_PinnedSlot":
    """The next pinned slot of this thread's ring, at least `nbytes`
    long, once its last copy has run."""
    ring = getattr(_small_tls, "ring", None)
    if ring is None:
        ring = _small_tls.ring = [_PinnedSlot() for _ in range(_SMALL_RING)]
        _small_tls.next = 0
    slot = ring[_small_tls.next]
    _small_tls.next = (_small_tls.next + 1) % _SMALL_RING
    if slot.event is not None:
        slot.event.synchronize()
        slot.event = None
    if slot.buf is None or slot.buf.numel() < nbytes:
        size = 1 << max(12, int(nbytes - 1).bit_length())
        slot.buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    return slot


def note_stage_count(key: str = "dataset_stagings") -> None:
    with _counts_lock:
        STAGE_COUNTS[key] = STAGE_COUNTS.get(key, 0) + 1


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.zeros(0, dtype=dtype).numpy().dtype


class RowStager:
    """Stages host arrays of `n_rows` rows onto `device` in one layout, so
    features, masks and row ids line up.  `bucketing` pads the staged
    rows with zeros to `bucket_rows(n_rows)` (`n_padded`); `telemetry`
    False leaves the `dataset_stagings` count alone (a request-rate
    micro-batch is not a dataset staging)."""

    def __init__(self, n_rows: int, device: torch.device, bucketing: bool = False,
                 telemetry: bool = True) -> None:
        self.device = torch.device(device)
        self.n_valid = int(n_rows)
        self.n_padded = bucket_rows(self.n_valid) if bucketing else self.n_valid
        self._telemetry = bool(telemetry)

    @classmethod
    def for_replicated(cls, n_rows: int, device: torch.device,
                       bucketing: Optional[bool] = None,
                       telemetry: bool = True) -> "RowStager":
        """Stager for host arrays the caller holds in full (a transform's
        input).  `bucketing` None reads `shape_bucketing`, as the JAX
        package's.  On one process this is the plain stager."""
        if bucketing is None:
            from ..config import get_config

            bucketing = bool(get_config("shape_bucketing"))
        return cls(n_rows, device, bucketing=bucketing, telemetry=telemetry)

    def _assemble(self, shape, dtype: np.dtype,
                  chunk: Callable[[int, int], np.ndarray]) -> torch.Tensor:
        """Device tensor of `shape` filled chunk by chunk; `chunk(lo, hi)`
        gives rows lo:hi on the host, already in `dtype`.  Rows past
        `n_valid` (bucket padding) are zeros."""
        out = torch.empty(shape, dtype=_torch_dtype(dtype), device=self.device)
        if shape[0] > self.n_valid:
            out[self.n_valid:].zero_()
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
        """(n_rows, ...) host array -> (n_padded, ...) device tensor of
        `dtype`, zeros below the valid rows."""
        arr = np.asarray(arr)
        if arr.shape[0] != self.n_valid:
            raise ValueError(f"array has {arr.shape[0]} rows, stager expects {self.n_valid}")
        dtype = np.dtype(dtype) if dtype is not None else arr.dtype
        if arr.ndim == 2 and self._telemetry:
            # labels, weights and fold ids ride along a staging of features
            note_stage_count()
        shape = (self.n_padded,) + arr.shape[1:]
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if (self.device.type == "cuda" and nbytes < _SMALL_DIRECT_BYTES
                and self._small_direct_eligible()):
            return self._stage_small_direct(arr, dtype, shape)
        return self._assemble(shape, dtype,
                              lambda lo, hi: arr[lo:hi].astype(dtype, copy=False))

    @staticmethod
    def _small_direct_eligible() -> bool:
        from ..config import get_config

        return bool(get_config("staging_small_direct"))

    def _stage_small_direct(self, arr: np.ndarray, dtype: np.dtype, shape) -> torch.Tensor:
        """Small-array fast path: the rows are cast (and zero-padded)
        straight into a pinned buffer this thread reuses, and one
        non-blocking copy on the current stream moves it to the card — no
        chunk loop, no fresh pinned allocation.  The same bytes as the
        chunked path (a card only: on the CPU the chunked path is one
        copy already)."""
        tdt = _torch_dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        slot = _small_slot(nbytes)
        host = slot.buf[:nbytes].view(tdt).view(shape)
        hv = host.numpy()
        hv[: self.n_valid] = arr
        if shape[0] > self.n_valid:
            hv[self.n_valid:] = 0
        out = torch.empty(shape, dtype=tdt, device=self.device)
        out.copy_(host, non_blocking=True)
        slot.event = torch.cuda.Event()
        slot.event.record(torch.cuda.current_stream(self.device))
        return out

    def copy(self, arr: np.ndarray) -> torch.Tensor:
        """(n_rows, ...) host array -> device tensor of its own dtype, by
        the same chunked copies, not counted as a dataset staging (an
        index's arrays)."""
        arr = np.asarray(arr)
        return self._assemble(arr.shape, arr.dtype, lambda lo, hi: arr[lo:hi])

    def stage_sparse(self, X, dtype: Optional[np.dtype] = None,
                     row_transform: Optional[Callable[[np.ndarray], np.ndarray]] = None
                     ) -> torch.Tensor:
        """Host CSR matrix -> DENSE device tensor, densified chunk by chunk,
        so the host never holds the whole dense matrix.  `row_transform`,
        where given, maps each dense host chunk before its copy (a metric's
        row preprocessing)."""
        X = X.tocsr()
        if X.shape[0] != self.n_valid:
            raise ValueError(f"matrix has {X.shape[0]} rows, stager expects {self.n_valid}")
        dtype = np.dtype(dtype) if dtype is not None else np.dtype(X.dtype)
        if self._telemetry:
            note_stage_count()

        def chunk(lo: int, hi: int) -> np.ndarray:
            dense = X[lo:hi].toarray().astype(dtype, copy=False)
            if row_transform is not None:
                dense = np.asarray(row_transform(dense), dtype=dtype)
            return dense

        return self._assemble((self.n_padded, X.shape[1]), dtype, chunk)

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
        """Device (n_padded, ...) tensor -> host numpy of the valid rows,
        in order."""
        if t.dim() and t.shape[0] == self.n_padded and self.n_padded != self.n_valid:
            t = t[: self.n_valid]
        return t.detach().cpu().numpy()
