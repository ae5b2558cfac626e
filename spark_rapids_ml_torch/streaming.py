#
# Parquet ingest and the fits beyond the card's memory: the port of
# spark_rapids_ml_tpu/streaming.py for one device.
#
#   probes and decode   `parquet_row_count`, `probe_num_features`,
#                       `_decode_batch` (FixedSizeList, list and scalar
#                       feature columns straight from Arrow buffers),
#                       `chunks_from_batches` (chunks of exactly
#                       `chunk_rows` rows, the tail zero-padded),
#                       `iter_chunks` and `iter_chunks_prefetch` (the decode
#                       on a thread ahead of the consumer)
#   A. `stage_parquet`  the chunks into one preallocated (n, d) device
#                       tensor, a DeviceDataset, so each estimator's
#                       `_fit_array` runs unchanged; the host holds a few
#                       chunks, never the file
#   B. streamed statistics  `linreg_streaming_stats` and
#                       `pca_streaming_stats`: the ops/stats.py accumulators
#                       folded chunk by chunk in one pass; the file bounds
#                       neither host nor device memory.  Their CSR forms
#                       (`linreg_stats_from_csr`, `pca_stats_from_csr`)
#                       densify a host CSR matrix a block of rows at a time
#   C. epoch streaming  `logreg_streaming_fit` (the host L-BFGS/OWL-QN, each
#                       evaluation one pass over the file) and
#                       `kmeans_streaming_fit` (one pass per Lloyd
#                       iteration)
#
# The staging and the streamed passes read a file through
# `iter_file_chunks`: fused.py's parallel range readers where its row
# groups split, else one scan; chunks reach the card through fused.py
# `device_chunks` (pinned buffers, side-stream copies).  The streamed
# LogisticRegression and KMeans evaluate in the fit's dtype; the JAX
# package's evaluate in float32 whatever it is (ROADMAP.md section 3).
#
# Not ported (ROADMAP.md section 1): the chunk cache and its replay
# (`cache_ok` and `device_ok` are accepted; every scan decodes), DuHL chunk
# sampling and the per-iteration checkpoints (both raise
# NotImplementedError), and the multi-process shares.
#
from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from .config import get_config
from .utils import get_logger

# The last `stage_parquet`: seconds, rows, cols, mb, mb_per_s, readers (the
# range readers that ran), chunks, bytes_transferred, host_prep_s and
# device_acc_s (fused.py `device_chunks`).
LAST_STAGE: dict = {}

# The last streamed pass or fit: the `FUSED_METRICS` keys of its passes
# (host_prep_s, device_acc_s, overlap_s, chunks, bytes, wall_s) under its
# label, plus `epochs` for the epoch-streaming fits.
STREAM_METRICS: dict = {}

logger = get_logger("spark_rapids_ml_torch.streaming")


def is_parquet_path(dataset) -> bool:
    return isinstance(dataset, str) and (os.path.isdir(dataset) or dataset.endswith(".parquet"))


def parquet_row_count(path: str) -> int:
    import pyarrow.dataset as ds

    return ds.dataset(path, format="parquet").count_rows()


_PROBE_CACHE: dict = {}


def _path_stamp(path: str):
    """Change stamp for the probe cache: (mtime_ns, size) of a file, or a
    crc over every fragment's (relative path, mtime, size) of a dataset
    directory; None when the path cannot be stat'd."""
    import zlib

    try:
        st = os.stat(path)
        if not os.path.isdir(path):
            return (st.st_mtime_ns, st.st_size)
        h = count = total = 0
        for root, _dirs, files in os.walk(path):
            for f in files:
                full = os.path.join(root, f)
                s = os.stat(full)
                h = zlib.crc32(
                    f"{os.path.relpath(full, path)}|{s.st_mtime_ns}|{s.st_size}".encode(), h)
                count += 1
                total += s.st_size
        return (h, count, total)
    except OSError:
        return None


def probe_num_features(path: str, features_col: Optional[str],
                       features_cols: Sequence[str]) -> int:
    """The feature width: from the schema (FixedSizeList) or the first row
    of the first batch.  Cached per (path, column, change stamp): the
    epoch-streaming fits probe once per pass."""
    if features_cols:
        return len(features_cols)
    stamp = _path_stamp(path)
    key = None if stamp is None else (path, features_col, stamp)
    hit = _PROBE_CACHE.get(key) if key is not None else None
    if hit is not None:
        return hit
    import pyarrow as pa
    import pyarrow.dataset as ds

    dataset = ds.dataset(path, format="parquet")
    if features_col not in dataset.schema.names:
        raise ValueError(f"featuresCol '{features_col}' not found in dataset")
    field = dataset.schema.field(features_col)
    d = None
    if pa.types.is_fixed_size_list(field.type):
        if dataset.count_rows() == 0:
            raise ValueError("Dataset is empty: nothing to fit/transform")
        d = field.type.list_size
    else:
        for batch in dataset.to_batches(columns=[features_col]):
            if batch.num_rows == 0:
                continue
            first = batch.column(0)[0].as_py()
            d = 1 if np.isscalar(first) else len(first)
            break
        if d is None:
            raise ValueError("Dataset is empty: nothing to fit/transform")
    if key is not None:
        if len(_PROBE_CACHE) >= 64:
            _PROBE_CACHE.pop(next(iter(_PROBE_CACHE)))
        _PROBE_CACHE[key] = d
    return d


def chunk_rows_for(d: int, itemsize: int = 4) -> int:
    """Rows per streamed chunk from the `host_batch_bytes` budget."""
    return max(1024, int(get_config("host_batch_bytes")) // max(d * itemsize, 1))


def _batch_to_arrays(pdf, features_col, features_cols, label_col, weight_col, dtype):
    from .data import _features_from_pandas

    X = _features_from_pandas(pdf, features_col, list(features_cols), dtype)
    y = pdf[label_col].to_numpy() if label_col else None
    w = pdf[weight_col].to_numpy() if weight_col else None
    return X, y, w


def _decode_batch(batch, features_col: Optional[str], features_cols: Sequence[str],
                  label_col: Optional[str], weight_col: Optional[str], dtype: np.dtype):
    """Arrow RecordBatch -> (X, y, w) numpy arrays without pandas.  A list
    feature column decodes by reshaping the Arrow child buffer (no copy
    when its type is `dtype`: the array is then read-only); labels and
    weights come back float64.  Nulls, ragged rows and other types take
    the pandas route."""
    import pyarrow as pa

    names = batch.schema.names

    def col(name: str):
        return batch.column(names.index(name))

    def np1d(arr, want=None):
        out = arr.to_numpy(zero_copy_only=False)
        return out if want is None else np.asarray(out, want)

    try:
        if features_cols:
            cols = [np1d(col(c)) for c in features_cols]
            X = np.empty((batch.num_rows, len(cols)), dtype)
            for j, c in enumerate(cols):
                X[:, j] = c
        else:
            c = col(features_col)
            t = c.type
            if pa.types.is_list(t) or pa.types.is_large_list(t) or pa.types.is_fixed_size_list(t):
                if c.null_count:
                    raise ValueError("nulls in feature column")
                n = len(c)
                if n == 0:
                    raise ValueError("empty batch")
                if pa.types.is_fixed_size_list(t):
                    d = t.list_size
                else:
                    # every row's length from the offsets: a ragged batch
                    # whose total happens to divide n must not reshape
                    lens = np.diff(np.asarray(c.offsets))
                    d = int(lens[0])
                    if not (lens == d).all():
                        raise ValueError("ragged feature rows")
                vals = c.flatten().to_numpy(zero_copy_only=False)
                if vals.shape[0] != n * d:
                    raise ValueError("ragged feature rows")
                X = np.asarray(vals, dtype).reshape(n, d)
            else:
                X = np1d(c, dtype).reshape(-1, 1)
        y = np1d(col(label_col), np.float64) if label_col else None
        w = np1d(col(weight_col), np.float64) if weight_col else None
        return X, y, w
    except (ValueError, KeyError, pa.ArrowInvalid, NotImplementedError):
        return _batch_to_arrays(batch.to_pandas(), features_col, features_cols, label_col,
                                weight_col, dtype)


def _scan_columns(features_col, features_cols, label_col, weight_col) -> list:
    columns = list(features_cols) if features_cols else [features_col]
    if label_col:
        columns.append(label_col)
    if weight_col:
        columns.append(weight_col)
    return columns


def iter_chunks(path: str, features_col: Optional[str], features_cols: Sequence[str],
                label_col: Optional[str], weight_col: Optional[str], chunk_rows: int,
                dtype: np.dtype, row_range: Optional[Tuple[int, int]] = None,
                device_ok: bool = False, select_chunks=None, cache_ok: bool = True
                ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray], int]]:
    """`(X, y, w, n_valid)` chunks of exactly `chunk_rows` rows (the last
    zero-padded) of a parquet file or dataset directory, in file order;
    `row_range=(lo, hi)` keeps a slice of the rows.  Each chunk owns its
    arrays.  `device_ok` and `cache_ok` are the JAX package's chunk-cache
    switches: the port has no cache, so every scan decodes and chunks are
    host arrays; `select_chunks` (DuHL) raises."""
    if select_chunks is not None:
        raise NotImplementedError(
            "select_chunks replays a cached stream (DuHL sampling), not ported: "
            "ROADMAP.md section 1")
    import pyarrow.dataset as ds

    columns = _scan_columns(features_col, features_cols, label_col, weight_col)
    dataset = ds.dataset(path, format="parquet")
    yield from chunks_from_batches(
        dataset.to_batches(columns=columns, batch_size=chunk_rows), features_col,
        features_cols, label_col, weight_col, chunk_rows, dtype, row_range=row_range)


def chunks_from_batches(batches, features_col: Optional[str], features_cols: Sequence[str],
                        label_col: Optional[str], weight_col: Optional[str], chunk_rows: int,
                        dtype: np.dtype, row_range: Optional[Tuple[int, int]] = None
                        ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray],
                                            Optional[np.ndarray], int]]:
    """The chunking half of `iter_chunks` over any stream of Arrow record
    batches (the range readers of fused.py reuse it): an exactly-full
    batch is handed over as decoded, partial ones fill a fresh chunk.
    `row_range` counts rows from the start of this stream."""
    d = None
    bufX = bufy = bufw = None
    fill = 0
    seen = 0
    lo, hi = row_range if row_range is not None else (0, None)
    for batch in batches:
        nb = batch.num_rows
        if nb == 0:
            continue
        b_lo, b_hi = seen, seen + nb
        seen = b_hi
        s = max(b_lo, lo)
        e = b_hi if hi is None else min(b_hi, hi)
        if s >= e:
            if hi is not None and b_lo >= hi:
                break
            continue
        X, y, w = _decode_batch(batch.slice(s - b_lo, e - s), features_col, features_cols,
                                label_col, weight_col, dtype)
        if d is None:
            d = X.shape[1]
        if fill == 0 and X.shape[0] == chunk_rows:
            yield X, y, w, chunk_rows
            continue
        pos = 0
        while pos < X.shape[0]:
            if bufX is None:
                bufX = np.zeros((chunk_rows, d), dtype)
                bufy = np.zeros((chunk_rows,), np.float64) if label_col else None
                bufw = np.zeros((chunk_rows,), np.float64) if weight_col else None
            take = min(chunk_rows - fill, X.shape[0] - pos)
            bufX[fill:fill + take] = X[pos:pos + take]
            if bufy is not None:
                bufy[fill:fill + take] = y[pos:pos + take]
            if bufw is not None:
                bufw[fill:fill + take] = w[pos:pos + take]
            fill += take
            pos += take
            if fill == chunk_rows:
                yield bufX, bufy, bufw, fill
                bufX = bufy = bufw = None
                fill = 0
    if fill:
        yield bufX, bufy, bufw, fill


def iter_chunks_prefetch(*args, **kwargs) -> Iterator:
    """`iter_chunks` with the decode on a background thread up to
    `streaming_prefetch_depth` chunks ahead (conf `streaming_prefetch`);
    chunks are owned, so nothing is copied."""
    from .utils import prefetch_iter

    depth = max(1, int(get_config("streaming_prefetch_depth")))
    if not get_config("streaming_prefetch") or depth <= 1:
        yield from iter_chunks(*args, **kwargs)
        return
    yield from prefetch_iter(iter_chunks(*args, **kwargs), depth=depth)


_ONES_CACHE: dict = {}


def _weights_host(cw, n_c: int, chunk_rows: int, dtype) -> np.ndarray:
    """A chunk's weights: the weight column or 1 on the valid rows, 0 on
    the padding.  A full chunk with no weight column gets a cached
    read-only ones array."""
    dtype = np.dtype(dtype)
    if cw is None and n_c == chunk_rows:
        key = (chunk_rows, dtype.str)
        a = _ONES_CACHE.get(key)
        if a is None:
            a = np.ones((chunk_rows,), dtype)
            a.setflags(write=False)
            _ONES_CACHE[key] = a
        return a
    w = np.zeros((chunk_rows,), dtype)
    w[:n_c] = 1.0 if cw is None else np.asarray(cw[:n_c], dtype)
    return w


def _device(device=None, num_workers: Optional[int] = None):
    from .parallel import DeviceContext

    with DeviceContext(num_workers, device) as ctx:
        return ctx.device


# ---------------------------------------------------------------------------
# A: stream-stage into one device tensor
# ---------------------------------------------------------------------------


def _parquet_share_offsets(path: str, readers: int) -> Optional[list]:
    """[(row groups, global first row)] of the parallel staging readers:
    fused.py's row-balanced contiguous split, each share with the global
    row its rows start at, so chunks decoded out of order land at their
    own rows.  None when the file cannot be split (the single scan)."""
    from .fused import _partition_row_groups, _share_row_starts

    shares = _partition_row_groups(path, readers)
    if shares is None:
        return None
    return list(zip(shares, _share_row_starts(path, shares)))


def _share_chunks(path: str, features_col, features_cols, label_col, weight_col,
                  chunk_rows: int, dtype: np.dtype, groups) -> Iterator[Tuple]:
    """One staging reader's share: the `iter_chunks` decode and chunking
    over its row groups only."""
    from .fused import _reader_batches

    columns = _scan_columns(features_col, features_cols, label_col, weight_col)
    yield from chunks_from_batches(_reader_batches(path, columns, chunk_rows, groups),
                                   features_col, features_cols, label_col, weight_col,
                                   chunk_rows, dtype)


def _with_offsets(chunks, start: int) -> Iterator[Tuple]:
    """`(X, y, w, n_valid, offset)`: each chunk with its first global row."""
    at = int(start)
    for cX, cy, cw, n_c in chunks:
        yield cX, cy, cw, n_c, at
        at += int(n_c)


def iter_file_chunks(path: str, features_col, features_cols, label_col, weight_col,
                     chunk_rows: int, dtype: np.dtype) -> Iterator[Tuple]:
    """`(X, y, w, n_valid, offset)` chunks of a parquet file (`iter_chunks`
    chunks, offset the global row of the chunk's first row), decoded by
    fused.py's range readers where the file's row groups split
    (`fused_parquet_readers`; chunks then arrive in any order), else by one
    scan with the decode on a thread ahead (`iter_chunks_prefetch`).  The
    staging and every streamed pass read through it: their sums do not
    depend on the order, and the offset places what does (the staged rows,
    KMeans' labels, the seeding sample).  The JAX package's streamed passes
    scan in order (ROADMAP.md section 3)."""
    from .fused import LAST_READER_DECISION, merge_threads, resolve_parquet_readers

    readers = resolve_parquet_readers(path)
    shares = _parquet_share_offsets(path, readers) if readers > 1 else None
    LAST_READER_DECISION["readers_used"] = 1 if shares is None else len(shares)
    if shares is None:
        yield from _with_offsets(iter_chunks_prefetch(
            path, features_col, features_cols, label_col, weight_col, chunk_rows, dtype,
            cache_ok=False), 0)
        return
    yield from merge_threads([
        _with_offsets(_share_chunks(path, features_col, features_cols, label_col, weight_col,
                                    chunk_rows, dtype, groups), start)
        for groups, start in shares])


def stage_parquet(path: str, features_col: Optional[str] = "features",
                  features_cols: Sequence[str] = (), label_col: Optional[str] = None,
                  weight_col: Optional[str] = None, num_workers: Optional[int] = None,
                  dtype=np.float32, label_dtype=None, chunk_rows: Optional[int] = None,
                  device=None):
    """A parquet file as a DeviceDataset, without a host copy of it: the
    rows are decoded a chunk at a time (by parallel range readers where
    the file has row groups to split, else one scan with the decode on a
    thread ahead) and copied into one preallocated (n, d) device tensor
    through pinned buffers and side-stream copies (fused.py
    `device_chunks`).  Weights are the weight column, else 1: the JAX
    package's validity-times-weight rule; one device holds every row, so
    there are no padding rows (as `RowStager`).  Labels are staged in
    `label_dtype` (default `dtype`).  Several processes: raises, as
    `DeviceContext` does for num_workers > 1."""
    import torch

    from . import fused
    from .data import DeviceDataset
    from .parallel.mesh import _torch_dtype

    device = _device(device, num_workers)
    t0 = time.perf_counter()
    dtype = np.dtype(dtype)
    ldt = np.dtype(label_dtype) if label_dtype is not None else dtype
    n = parquet_row_count(path)
    if n == 0:
        raise ValueError("Dataset is empty: nothing to fit/transform")
    d = probe_num_features(path, features_col, features_cols)
    chunk_rows = min(chunk_rows or chunk_rows_for(d, dtype.itemsize), n)
    X = torch.empty((n, d), dtype=_torch_dtype(dtype), device=device)
    y = torch.empty((n,), dtype=_torch_dtype(ldt), device=device) if label_col else None
    w = (torch.empty((n,), dtype=_torch_dtype(dtype), device=device) if weight_col
         else torch.ones((n,), dtype=_torch_dtype(dtype), device=device))

    offsets = []

    def host_chunks():
        # only the valid rows travel; the offset stays on the host
        for cX, cy, cw, n_c, at in iter_file_chunks(path, features_col, features_cols,
                                                    label_col, weight_col, chunk_rows, dtype):
            offsets.append((at, n_c))
            yield (cX[:n_c], None if cy is None else np.asarray(cy[:n_c], ldt),
                   None if cw is None else np.asarray(cw[:n_c], dtype))

    timing: Dict[str, Any] = {}
    staged = 0
    for i, (cX, cy, cw) in enumerate(fused.device_chunks(host_chunks(), device, timing)):
        at, n_c = offsets[i]
        X[at:at + n_c].copy_(cX)
        if y is not None:
            y[at:at + n_c].copy_(cy)
        if cw is not None:
            w[at:at + n_c].copy_(cw)
        staged += n_c
    if staged != n:
        raise RuntimeError(f"staged {staged} rows of {path}; the file has {n}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    el = time.perf_counter() - t0
    mb = n * d * dtype.itemsize / 1e6
    LAST_STAGE.clear()
    LAST_STAGE.update(seconds=el, rows=n, cols=d, mb=mb, mb_per_s=mb / max(el, 1e-9),
                      readers=fused.LAST_READER_DECISION.get("readers_used", 1),
                      chunks=int(timing.get("chunks", 0)),
                      bytes_transferred=int(timing.get("bytes", 0)),
                      host_prep_s=timing.get("host_prep_s", 0.0),
                      device_acc_s=timing.get("device_acc_s", 0.0))
    logger.info(f"Streamed {n} rows x {d} cols from {path} in {LAST_STAGE['chunks']} chunks of "
                f"{chunk_rows} rows onto {device} ({el:.1f}s, {mb / max(el, 1e-9):.0f} MB/s)")
    return DeviceDataset(device, X, n, y=y, weight=w)


# ---------------------------------------------------------------------------
# B: streamed sufficient statistics (beyond the card's memory)
# ---------------------------------------------------------------------------


def _stat_chunks(chunks, chunk_rows: int, dtype, with_y: bool) -> Iterator[Tuple]:
    """`iter_file_chunks` chunks as the weighted steps' `(X, y, w)`: the
    weights of every chunk (ones included, as the JAX package's streamed
    passes), labels in the fit's dtype.  Only the valid rows travel: the
    padding's weight is 0, so it adds nothing."""
    for cX, cy, cw, n_c, _ in chunks:
        yield (cX[:n_c], np.asarray(cy[:n_c], dtype) if with_y else None,
               _weights_host(cw, n_c, chunk_rows, dtype)[:n_c])


def _chunk_rows(path: str, chunk_rows: Optional[int], d: int, dtype: np.dtype) -> int:
    """Rows per chunk of a streamed pass: `chunk_rows_for` unless given,
    at most the file's rows (a small file is one chunk, not one padded to
    the host budget)."""
    return max(1, min(chunk_rows or chunk_rows_for(d, dtype.itemsize), parquet_row_count(path)))


def _streamed_pass(label: str, kind: str, acc, step, chunks, device, has_y: bool
                   ) -> Dict[str, Any]:
    from .fused import _record_metrics, accumulate_chunks

    host, m = accumulate_chunks(acc, (step, None), chunks, device, has_y=has_y)
    _record_metrics(label, kind, 1, m, into=STREAM_METRICS)
    return host


def linreg_streaming_stats(path: str, features_col: Optional[str],
                           features_cols: Sequence[str], label_col: str,
                           weight_col: Optional[str], dtype=np.float32,
                           chunk_rows: Optional[int] = None, device=None) -> dict:
    """The weighted Gram, moment and cross statistics (ops/stats.py
    `linreg_acc`) folded chunk by chunk in one pass over the file: bounded
    by neither host nor device memory.  Host float64 statistics."""
    from .ops.stats import linreg_acc

    device = _device(device)
    dtype = np.dtype(dtype)
    d = probe_num_features(path, features_col, features_cols)
    chunk_rows = _chunk_rows(path, chunk_rows, d, dtype)
    acc, step = linreg_acc(d, dtype, device)
    chunks = iter_file_chunks(path, features_col, features_cols, label_col, weight_col,
                              chunk_rows, dtype)
    return _streamed_pass("linreg_streaming", "linreg", acc, step,
                          _stat_chunks(chunks, chunk_rows, dtype, True), device, True)


def pca_streaming_stats(path: str, features_col: Optional[str], features_cols: Sequence[str],
                        weight_col: Optional[str], dtype=np.float32,
                        chunk_rows: Optional[int] = None, device=None) -> dict:
    """PCA's second moments (S = sum w x x^T, s1 = sum w x, sw = sum w)
    folded chunk by chunk in one pass over the file."""
    from .ops.stats import pca_moment_acc

    device = _device(device)
    dtype = np.dtype(dtype)
    d = probe_num_features(path, features_col, features_cols)
    chunk_rows = _chunk_rows(path, chunk_rows, d, dtype)
    acc, step = pca_moment_acc(d, dtype, device)
    chunks = iter_file_chunks(path, features_col, features_cols, None, weight_col,
                              chunk_rows, dtype)
    return _streamed_pass("pca_streaming", "pca_moments", acc, step,
                          _stat_chunks(chunks, chunk_rows, dtype, False), device, False)


def iter_csr_chunks(csr, y: Optional[np.ndarray], w: Optional[np.ndarray], chunk_rows: int,
                    dtype: np.dtype) -> Iterator[Tuple]:
    """Dense `(X, y, w, n_valid)` blocks of at most `chunk_rows` rows of a
    host CSR matrix: the host holds one dense block at a time."""
    n = csr.shape[0]
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        rows = hi - lo
        Xb = csr[lo:hi].toarray().astype(dtype, copy=False)
        wb = np.ones((rows,), dtype) if w is None else np.asarray(w[lo:hi], dtype)
        yield Xb, None if y is None else y[lo:hi], wb, rows


def linreg_stats_from_csr(csr, y: np.ndarray, weight: Optional[np.ndarray], dtype=np.float32,
                          chunk_rows: Optional[int] = None, device=None) -> dict:
    """`linreg_streaming_stats` over a host CSR matrix, densified a block
    of rows at a time: the exact statistics with one dense block of host
    memory and a (d, d) device accumulator."""
    from .ops.stats import linreg_acc

    device = _device(device)
    dtype = np.dtype(dtype)
    d = int(csr.shape[1])
    chunk_rows = chunk_rows or chunk_rows_for(d, dtype.itemsize)
    acc, step = linreg_acc(d, dtype, device)
    chunks = ((Xb, np.asarray(yb, dtype), wb)
              for Xb, yb, wb, _ in iter_csr_chunks(csr, y, weight, chunk_rows, dtype))
    return _streamed_pass("linreg_csr", "linreg", acc, step, chunks, device, True)


def pca_stats_from_csr(csr, weight: Optional[np.ndarray], dtype=np.float32,
                       chunk_rows: Optional[int] = None, device=None) -> dict:
    """`pca_streaming_stats` over a host CSR matrix, densified a block of
    rows at a time."""
    from .ops.stats import pca_moment_acc

    device = _device(device)
    dtype = np.dtype(dtype)
    d = int(csr.shape[1])
    chunk_rows = chunk_rows or chunk_rows_for(d, dtype.itemsize)
    acc, step = pca_moment_acc(d, dtype, device)
    chunks = ((Xb, None, wb)
              for Xb, _, wb, _ in iter_csr_chunks(csr, None, weight, chunk_rows, dtype))
    return _streamed_pass("pca_csr", "pca_moments", acc, step, chunks, device, False)


# ---------------------------------------------------------------------------
# C: epoch streaming for the iterative solvers (beyond the card's memory)
# ---------------------------------------------------------------------------


def _check_not_ported(checkpoint_path=None, checkpoint_dir=None) -> None:
    mode = str(get_config("streaming_chunk_sampling")).lower()
    if mode not in ("off", "duhl"):
        raise ValueError(f"streaming_chunk_sampling must be off|duhl, got {mode!r}")
    if mode == "duhl":
        raise NotImplementedError(
            "streaming_chunk_sampling='duhl' (DuHL chunk sampling) needs the chunk cache, not "
            "ported: ROADMAP.md section 1, item 1")
    if checkpoint_path or checkpoint_dir or get_config("streaming_checkpoint_dir"):
        raise NotImplementedError(
            "checkpoints of the streamed fits are not ported: ROADMAP.md section 1, "
            "item 5 (Resilience)")


def _label_moments_scan(path: str, features_col, features_cols, label_col, weight_col,
                        dtype, chunk_rows: int, need_moments: bool) -> dict:
    """One host pass: the weight sum, the label range and integrality
    (rows of weight > 0), and, when asked, each feature's weighted sum and
    sum of squares in float64."""
    d = probe_num_features(path, features_col, features_cols)
    n_total = parquet_row_count(path)
    wsum = 0.0
    n_valid = 0
    y_min, y_max = np.inf, -np.inf
    integral = True
    s1 = np.zeros((d,), np.float64)
    s2 = np.zeros((d,), np.float64)
    for cX, cy, cw, n_c, _ in iter_file_chunks(path, features_col, features_cols, label_col,
                                               weight_col, chunk_rows, dtype):
        w = np.ones((n_c,), np.float64) if cw is None else cw[:n_c].astype(np.float64)
        wsum += w.sum()
        n_valid += n_c
        if label_col is not None:
            yc = cy[:n_c]
            pos = w > 0
            if pos.any():
                y_min = min(y_min, float(yc[pos].min()))
                y_max = max(y_max, float(yc[pos].max()))
                if not np.all(yc[pos] == np.round(yc[pos])):
                    integral = False
        if need_moments:
            Xc = cX[:n_c].astype(np.float64)
            s1 += (Xc * w[:, None]).sum(axis=0)
            s2 += (Xc * Xc * w[:, None]).sum(axis=0)
    return {"d": d, "n_total": n_total, "wsum": float(wsum), "n_valid": int(n_valid),
            "y_min": y_min, "y_max": y_max, "integral": integral, "s1": s1, "s2": s2}


def logreg_streaming_fit(path: str, features_col, features_cols, label_col: str, weight_col,
                         family: str = "auto", l2: float = 0.0, l1: float = 0.0,
                         fit_intercept: bool = True, standardization: bool = False,
                         tol: float = 1e-6, max_iter: int = 100, history: int = 10,
                         ls_max: int = 20, dtype=np.float32, chunk_rows: Optional[int] = None,
                         checkpoint_path: Optional[str] = None,
                         checkpoint_dir: Optional[str] = None, device=None) -> dict:
    """Epoch-streaming logistic regression: the host L-BFGS/OWL-QN
    (ops/lbfgs.py `lbfgs_minimize_host`), each evaluation one pass over
    the file, the loss and gradient of every chunk (ops/logistic.py
    `LogisticOracle`) summed on the card.  The JAX package's semantics:
    Spark's binomial and multinomial objectives, unpenalised intercepts,
    standardization by the population moments of a first host pass
    (centred when there is an intercept, scaled only when not).  The rows
    evaluate in `dtype`.  Returns the solution and `epochs`, the passes
    over the file (every evaluation, line-search trials included)."""
    import torch

    from .fused import _record_metrics, device_chunks
    from .ops.lbfgs import lbfgs_minimize_host
    from .ops.logistic import LogisticOracle, _theta_layout
    from .parallel.mesh import _torch_dtype

    _check_not_ported(checkpoint_path, checkpoint_dir)
    device = _device(device)
    dtype = np.dtype(dtype)
    chunk_rows = _chunk_rows(path, chunk_rows,
                             probe_num_features(path, features_col, features_cols), dtype)
    scan = _label_moments_scan(path, features_col, features_cols, label_col, weight_col,
                               dtype, chunk_rows, need_moments=standardization)
    d, wsum = scan["d"], scan["wsum"]
    if not scan["integral"] or scan["y_min"] < 0:
        raise RuntimeError("Labels MUST be non-negative Integers")
    y_min, y_max = int(scan["y_min"]), int(scan["y_max"])
    if y_min == y_max:
        return {"degenerate_label": float(y_min), "d": d}
    n_classes = y_max + 1
    binomial = n_classes == 2 and family in ("auto", "binomial")

    tdt = _torch_dtype(dtype)
    mean = std = None
    mean_dev = inv_std_dev = None
    if standardization:
        mu = scan["s1"] / wsum
        std = np.sqrt(np.maximum(scan["s2"] / wsum - mu * mu, 0.0))
        inv_std = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 1.0)
        if fit_intercept:
            mean = mu
            mean_dev = torch.as_tensor(mu.astype(dtype), device=device)
        inv_std_dev = torch.as_tensor(inv_std.astype(dtype), device=device)

    C = 1 if binomial else n_classes
    n_coef, n_param, coef_mask, _ = _theta_layout(C, d, fit_intercept)
    epochs = {"n": 0}
    totals: Dict[str, float] = {}

    def host_chunks():
        for cX, cy, cw, n_c, _ in iter_file_chunks(path, features_col, features_cols,
                                                   label_col, weight_col, chunk_rows, dtype):
            yield (cX[:n_c], np.asarray(cy[:n_c], np.int32),
                   _weights_host(cw, n_c, chunk_rows, dtype)[:n_c])

    def oracle(theta_np: np.ndarray):
        theta = torch.as_tensor(theta_np, dtype=tdt, device=device)
        acc_l = torch.zeros((), dtype=tdt, device=device)
        acc_g = torch.zeros((n_param,), dtype=tdt, device=device)
        timing: Dict[str, Any] = {}
        for cX, cy, cw in device_chunks(host_chunks(), device, timing):
            if inv_std_dev is not None:
                cX = (cX - mean_dev) * inv_std_dev if mean_dev is not None else cX * inv_std_dev
            # each chunk's loss and gradient, normalised by the whole
            # file's weight; the penalty is added once, on the host
            f, g = LogisticOracle(cX, cw, cy, n_classes, 0.0, fit_intercept, binomial,
                                  wsum=wsum).value_and_grad(theta)
            acc_l += f
            acc_g += g
        for k, v in timing.items():
            totals[k] = totals.get(k, 0.0) + v
        epochs["n"] += 1
        host = torch.cat([acc_l.reshape(1), acc_g]).cpu().numpy().astype(np.float64)
        beta = theta_np * coef_mask
        return float(host[0]) + 0.5 * l2 * float(beta @ beta), host[1:] + l2 * beta

    t0 = time.perf_counter()
    theta, n_iter, converged, hist = lbfgs_minimize_host(
        oracle, np.zeros((n_param,), np.float64), max_iter=max_iter, tol=tol, history=history,
        l1=l1, l1_mask=coef_mask, ls_max=ls_max)
    totals["wall_s"] = time.perf_counter() - t0
    _record_metrics("logreg_streaming", "logreg", epochs["n"], totals, into=STREAM_METRICS)
    STREAM_METRICS["epochs"] = epochs["n"]
    logger.info(f"Epoch-streaming logreg: {n_iter} iterations, {epochs['n']} data epochs over "
                f"{scan['n_total']} rows")
    if binomial:
        coef = theta[:d].reshape(1, d)
        intercept = np.asarray([theta[d] if fit_intercept else 0.0])
    else:
        coef = theta[:n_coef].reshape(C, d)
        intercept = theta[n_coef:] if fit_intercept else np.zeros((C,))
    return {"coef": coef, "intercept": intercept, "n_classes": n_classes, "d": d,
            "n_iter": n_iter, "converged": converged, "history": hist, "mean": mean,
            "std": std, "binomial": binomial, "epochs": epochs["n"]}


def seed_sample(path: str, features_col, features_cols, weight_col, n_total: int,
                init_rows: int, dtype, chunk_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """The strided global subsample the streamed KMeans seeds from: every
    `seed_sample_stride(n_total, init_rows)`-th row of the file with its
    weight (1 without a weight column), as the JAX package's
    `kmeans_sample` statistic program gathers it.  (rows in `dtype`,
    weights float64)."""
    from .ops.kmeans import seed_sample_stride

    stride = seed_sample_stride(n_total, init_rows)
    cap = (n_total - 1) // stride + 1
    rows = np.zeros((cap, probe_num_features(path, features_col, features_cols)), np.float64)
    ws = np.zeros((cap,), np.float64)
    for cX, _, cw, n_c, offset in iter_file_chunks(path, features_col, features_cols, None,
                                                   weight_col, chunk_rows, dtype):
        first = (-offset) % stride  # the chunk's first row at a multiple of stride
        slots = slice((offset + first) // stride, (offset + n_c - 1) // stride + 1)
        rows[slots] = cX[first:n_c:stride]
        ws[slots] = _weights_host(cw, n_c, chunk_rows, dtype)[first:n_c:stride]
    return rows.astype(dtype), ws


def kmeans_streaming_fit(path: str, features_col, features_cols, weight_col, k: int, seed: int,
                         max_iter: int = 300, tol: float = 1e-4,
                         init: str = "scalable-k-means++", init_steps: int = 2,
                         oversample: float = 2.0, dtype=np.float32,
                         chunk_rows: Optional[int] = None, init_rows: int = 262_144,
                         checkpoint_path: Optional[str] = None,
                         checkpoint_dir: Optional[str] = None, device=None,
                         init_centers=None) -> dict:
    """Epoch-streaming Lloyd: centres seeded on the card from a strided
    global subsample (`seed_sample`, then ops/kmeans.py's seeding), then
    each iteration one pass over the file that assigns every row and sums
    it into its centre (ops/kmeans.py `_lloyd_block_step`: `index_add_`
    partials in the fit's dtype, combined in float64), the centres
    updated on the card.  The stop rule of `kmeans_fit`: every centre
    moves less than `tol`, or a pass moves no row (the row labels of the
    pass before live on the card, 4 bytes a row).  `init_centers` (k, d)
    replaces the seeding.  The cost is taken under the final centres."""
    import torch

    from .fused import _record_metrics, device_chunks
    from .ops import kmeans as km
    from .parallel.mesh import _torch_dtype

    _check_not_ported(checkpoint_path, checkpoint_dir)
    device = _device(device)
    dtype = np.dtype(dtype)
    tdt = _torch_dtype(dtype)
    d = probe_num_features(path, features_col, features_cols)
    chunk_rows = _chunk_rows(path, chunk_rows, d, dtype)
    n_total = parquet_row_count(path)
    if n_total < k:
        raise ValueError(f"k={k} exceeds the dataset row count {n_total}")
    stride = km.seed_sample_stride(n_total, init_rows)
    if init_centers is not None:
        C = torch.tensor(np.asarray(init_centers), dtype=tdt, device=device)
    else:
        Xs, ws = seed_sample(path, features_col, features_cols, weight_col, n_total, init_rows,
                             dtype, chunk_rows)
        if int((ws > 0).sum()) < k:
            raise ValueError(f"Seeding subsample holds {int((ws > 0).sum())} weighted rows "
                             f"< k={k}")
        C = km._seed(torch.as_tensor(Xs, device=device),
                     torch.as_tensor(ws.astype(dtype), device=device), k, seed, init,
                     init_steps, oversample)
    rows = km.block_rows(n_total, d, k, dtype.itemsize, n_total)
    unweighted = weight_col is None
    labels = torch.full((n_total,), -1, dtype=torch.int32, device=device)
    totals: Dict[str, float] = {}

    def one_pass(C, prev):
        acc = (torch.zeros((k, d), dtype=torch.float64, device=device),
               torch.zeros(k, dtype=torch.float64, device=device),
               torch.zeros((), dtype=torch.float64, device=device),
               torch.zeros((), dtype=torch.int64, device=device))
        timing: Dict[str, Any] = {}
        offsets = []

        def host_chunks():
            for cX, _, cw, n_c, at in iter_file_chunks(path, features_col, features_cols, None,
                                                       weight_col, chunk_rows, dtype):
                offsets.append(at)
                yield cX[:n_c], _weights_host(cw, n_c, chunk_rows, dtype)[:n_c]

        for i, (cX, cw) in enumerate(device_chunks(host_chunks(), device, timing)):
            at = offsets[i]
            x2 = km.row_norms(cX)
            for b in km._row_blocks(cX.shape[0], rows):
                km._lloyd_block_step(acc, cX[b], cw[b], x2[b], C, unweighted,
                                     None if prev is None
                                     else prev[at + b.start:at + b.stop])
        for key, v in timing.items():
            totals[key] = totals.get(key, 0.0) + v
        return acc

    t0 = time.perf_counter()
    costs, moves = [], []
    n_iter = passes = 0
    for n_iter in range(1, max_iter + 1):
        sums, counts, cost, moved = one_pass(C, labels)
        passes += 1
        costs.append(cost)
        new_C, shift2 = km._lloyd_center_update(C, sums, counts)
        shift2, moved = torch.stack([shift2.to(torch.float64),
                                     moved.to(torch.float64)]).tolist()
        moves.append(int(moved))
        if moved == 0:
            break
        C = new_C
        if shift2 <= tol * tol:
            break
    del labels
    cost = one_pass(C, None)[2]
    passes += 1
    costs.append(cost)
    totals["wall_s"] = time.perf_counter() - t0
    _record_metrics("kmeans_streaming", "kmeans", passes, totals, into=STREAM_METRICS)
    STREAM_METRICS["epochs"] = passes
    km.LAST_FIT.clear()
    km.LAST_FIT.update(streamed=True, stride=stride, init_rows=-(-n_total // stride), rows=rows,
                       n_iter=n_iter, costs=[float(c) for c in costs], moved=moves,
                       unweighted=unweighted, epochs=passes)
    logger.info(f"Epoch-streaming kmeans: {n_iter} Lloyd passes over {n_total} rows")
    return {"centers": C.cpu().numpy().astype(np.float64), "cost": float(cost),
            "n_iter": n_iter, "d": d, "epochs": passes}
