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
# Every scan but the staging's runs through the chunk cache
# (parallel/device_cache.py; conf `chunk_cache`): the first scan of a file
# with the same scan parameters decodes and records its chunks, every later
# one replays them, a `device_ok` consumer taking the feature block from the
# card's memory when the device tier holds it.  `streaming_chunk_sampling=
# "duhl"` (`DuhlChunkSampler`) lets an epoch of the streamed fits revisit
# only the cached chunks whose contribution still moves.
#
# Not ported (ROADMAP.md section 1): the per-iteration checkpoints (they
# raise NotImplementedError) and the multi-process shares.
#
from __future__ import annotations

import itertools
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
# label; for the epoch-streaming fits also `epochs`, `epoch_s` (each
# epoch's seconds), `scan_s` (the first scan: the label and moments scan, or
# the seeding sample) and, sampled, `sampled_epochs` and
# `chunk_visits_saved`.
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


def _chunk_stream_key(path: str, features_col, features_cols, label_col, weight_col,
                      chunk_rows: int, dtype, row_range, tag: str = "iter_chunks"):
    """The chunk cache's stream key: the path's change stamp and every scan
    parameter that shapes the chunks, with the process rank and count (0
    and 1: one process).  None (no caching) when the path cannot be
    stat'd; a path rewritten in place gets a new stamp, so a new key."""
    stamp = _path_stamp(path)
    if stamp is None:
        return None
    return (tag, path, stamp, 0, features_col, tuple(features_cols or ()), label_col,
            weight_col, int(chunk_rows), np.dtype(dtype).str, row_range, 1)


def chunk_stream_key(path, features_col, features_cols, label_col, weight_col, chunk_rows,
                     dtype, row_range=None):
    """The cache key of an `iter_chunks` scan."""
    return _chunk_stream_key(path, features_col, features_cols, label_col, weight_col,
                             chunk_rows, dtype, row_range)


def iter_chunks(path: str, features_col: Optional[str], features_cols: Sequence[str],
                label_col: Optional[str], weight_col: Optional[str], chunk_rows: int,
                dtype: np.dtype, row_range: Optional[Tuple[int, int]] = None,
                device_ok: bool = False, select_chunks=None, cache_ok: bool = True,
                device=None
                ) -> Iterator[Tuple[Any, Optional[np.ndarray], Optional[np.ndarray], int]]:
    """`(X, y, w, n_valid)` chunks of exactly `chunk_rows` rows (the last
    zero-padded) of a parquet file or dataset directory, in file order;
    `row_range=(lo, hi)` keeps a slice of the rows.  Each chunk owns its
    arrays.

    The scan runs through the chunk cache: the first identical scan
    decodes and records the chunks (served arrays are read-only from then
    on), later ones replay them.  A `device_ok` consumer may receive the
    feature block as a tensor: the device tier's CUDA tensor (mirrored onto
    `device`) or the host tier's pinned copy; everyone else gets numpy.
    `select_chunks` (a set of positions) replays only those chunks of a
    complete cached stream (DuHL).  `cache_ok=False` bypasses the cache (the
    one-shot staging scan)."""
    from .parallel.device_cache import cached_chunk_stream

    def source():
        import pyarrow.dataset as ds

        columns = _scan_columns(features_col, features_cols, label_col, weight_col)
        dataset = ds.dataset(path, format="parquet")
        return chunks_from_batches(
            dataset.to_batches(columns=columns, batch_size=chunk_rows), features_col,
            features_cols, label_col, weight_col, chunk_rows, dtype, row_range=row_range)

    key = None if not cache_ok else _chunk_stream_key(
        path, features_col, features_cols, label_col, weight_col, chunk_rows, dtype, row_range)
    yield from cached_chunk_stream(key, source, device_elem=0 if device_ok else None,
                                   serve_device=device_ok, select=select_chunks,
                                   device=device if device_ok else None)


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
                     chunk_rows: int, dtype: np.dtype, device_ok: bool = False, device=None,
                     select_chunks=None, cache_ok: bool = True, keys: Optional[list] = None
                     ) -> Iterator[Tuple]:
    """`(X, y, w, n_valid, offset)` chunks of a parquet file (`iter_chunks`
    chunks, offset the global row of the chunk's first row), decoded by
    fused.py's range readers where the file's row groups split
    (`fused_parquet_readers`; chunks then arrive in any order), else by one
    scan with the decode on a thread ahead (`iter_chunks_prefetch`).  The
    staging and every streamed pass read through it: their sums do not
    depend on the order, and the offset places what does (the staged rows,
    KMeans' labels, the seeding sample).  The JAX package's streamed passes
    scan in order (ROADMAP.md section 3).

    The scan runs through the chunk cache (`cache_ok`), which records each
    chunk with its offset and replays the order of its first scan;
    `device_ok`, `device` and `select_chunks` as in `iter_chunks`.  `keys`,
    when given, receives the scan's cache key (DuHL asks the cache whether
    that stream is complete)."""
    from .fused import LAST_READER_DECISION, merge_threads, resolve_parquet_readers
    from .parallel.device_cache import cached_chunk_stream

    readers = resolve_parquet_readers(path)
    shares = _parquet_share_offsets(path, readers) if readers > 1 else None
    LAST_READER_DECISION["readers_used"] = 1 if shares is None else len(shares)

    def source():
        if shares is None:
            return _with_offsets(iter_chunks_prefetch(
                path, features_col, features_cols, label_col, weight_col, chunk_rows, dtype,
                cache_ok=False), 0)
        return merge_threads([
            _with_offsets(_share_chunks(path, features_col, features_cols, label_col,
                                        weight_col, chunk_rows, dtype, groups), start)
            for groups, start in shares])

    # the chunks carry their global row, and a stream the range readers
    # filled is never resumed from one scan by position: keys of their own
    key = None if not cache_ok else _chunk_stream_key(
        path, features_col, features_cols, label_col, weight_col, chunk_rows, dtype, None,
        tag="file_chunks" if shares is None else "file_chunks+ranges")
    if keys is not None:
        keys.append(key)
    yield from cached_chunk_stream(key, source, device_elem=0 if device_ok else None,
                                   serve_device=device_ok, select=select_chunks,
                                   ordered=shares is None,
                                   device=device if device_ok else None)


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
        # cache_ok=False: a one-shot staging scan must neither keep chunks
        # it never replays nor evict the streamed fits' streams
        for cX, cy, cw, n_c, at in iter_file_chunks(path, features_col, features_cols,
                                                    label_col, weight_col, chunk_rows, dtype,
                                                    cache_ok=False):
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
                              chunk_rows, dtype, device_ok=True, device=device)
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
                              chunk_rows, dtype, device_ok=True, device=device)
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


# DuHL ("Large-Scale Stochastic Learning using GPUs", PAPERS.md) at the
# grain of a chunk: once the chunk cache holds the whole stream, an epoch
# revisits only the chunks whose contribution to the solver's statistics
# still moves (per-chunk scores), and every chunk it skips contributes its
# last-computed statistics.  Skipped chunks are neither decompressed nor
# copied.  A chunk is revisited at the latest after MAX_AGE epochs, and
# every FULL_EVERY-th evaluation is a full pass.


def chunk_sampling_mode() -> str:
    mode = str(get_config("streaming_chunk_sampling")).lower()
    if mode not in ("off", "duhl"):
        raise ValueError(f"streaming_chunk_sampling must be off|duhl, got {mode!r}")
    return mode


class DuhlChunkSampler:
    """Per-chunk contribution bookkeeping for sampled epochs (the JAX
    package's class, a copy).  The solver reports `visited(idx, score)`
    after recomputing a chunk and asks `select()` for the next epoch's
    chunks (None: a full pass, because the sampler is not primed, a full
    refresh is due, or the selection would cover every chunk).

    The selection is frozen between full refreshes, so that the
    stale-compensated objective changes smoothly with the iterate within a
    cycle (an L-BFGS line search over a selection that changed at every
    evaluation would stall).  Once the iterate moves less than TAIL_EPS
    (relative) between full refreshes, every later pass is full."""

    MAX_AGE = 12  # no chunk's contribution goes staler than this
    FULL_EVERY = 8  # a full refresh every Nth evaluation
    WARM_EVALS = 8  # full passes before sampling starts
    TAIL_EPS = 0.02

    def __init__(self, fraction: float, warm_evals: Optional[int] = None,
                 full_every: Optional[int] = None) -> None:
        self.fraction = min(max(float(fraction), 0.1), 1.0)
        if warm_evals is not None:
            self.WARM_EVALS = int(warm_evals)
        if full_every is not None:
            self.FULL_EVERY = max(2, int(full_every))
        self.n_chunks: Optional[int] = None
        self.score: Optional[np.ndarray] = None
        self.age: Optional[np.ndarray] = None
        self.sampled_epochs = 0
        self.chunk_visits_saved = 0
        self._evals = 0
        self._sel: Optional[list] = None  # frozen within the cycle
        self._ref: Optional[np.ndarray] = None  # the iterate at the last refresh
        self._exact = False  # the tail is reached: full passes from here on

    def ready(self) -> bool:
        return self.n_chunks is not None

    def start(self, n_chunks: int) -> None:
        self.n_chunks = int(n_chunks)
        self.score = np.full((n_chunks,), np.inf)
        self.age = np.zeros((n_chunks,), np.int64)

    def _pick(self) -> Optional[list]:
        n = self.n_chunks
        want = max(1, int(np.ceil(n * self.fraction)))
        order = np.argsort(-self.score, kind="stable")
        sel = set(int(i) for i in order[:want])
        sel |= set(int(i) for i in np.flatnonzero(self.age + 1 >= self.MAX_AGE))
        if len(sel) >= n:
            return None
        return sorted(sel)

    def select(self) -> Optional[list]:
        """The chunk positions of the next epoch; None: a full pass."""
        self._evals += 1
        if (self._exact or not self.ready() or self._evals <= self.WARM_EVALS
                or (self._evals - 1) % self.FULL_EVERY == 0):
            self._sel = None  # the full refresh re-scores the next cycle
            return None
        if self._sel is None:
            self._sel = self._pick()
        if self._sel is None:
            return None
        self.sampled_epochs += 1
        self.chunk_visits_saved += self.n_chunks - len(self._sel)
        return self._sel

    def note_refresh(self, iterate: np.ndarray) -> None:
        """After every full pass, with the solver's iterate: below TAIL_EPS
        of relative movement since the previous refresh, every later pass is
        full."""
        it = np.asarray(iterate, np.float64).ravel()
        if self._ref is not None and self._ref.shape == it.shape:
            denom = max(float(np.linalg.norm(self._ref)), 1.0)
            if float(np.linalg.norm(it - self._ref)) / denom < self.TAIL_EPS:
                self._exact = True
        self._ref = it.copy()

    def visited(self, idx: int, score: float) -> None:
        self.score[idx] = float(score)
        self.age[idx] = 0

    def epoch_done(self, visited_idx) -> None:
        mask = np.ones((self.n_chunks,), bool)
        mask[list(visited_idx)] = False
        self.age[mask] += 1

    def summary(self) -> dict:
        return {"sampled_epochs": int(self.sampled_epochs),
                "chunk_visits_saved": int(self.chunk_visits_saved)}


def _duhl_selection(sampler: "DuhlChunkSampler", key) -> Optional[list]:
    """The next epoch's chunk positions: a selection only once the chunk
    cache holds the whole stream (skipping chunks of a scan that decodes
    would save nothing)."""
    from .parallel.device_cache import chunk_stream_complete

    if sampler.ready() and key is not None and chunk_stream_complete(key) == sampler.n_chunks:
        return sampler.select()
    return None


def _check_not_ported(checkpoint_path=None, checkpoint_dir=None) -> None:
    chunk_sampling_mode()
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
    evaluate in `dtype`.  With `streaming_chunk_sampling="duhl"` an
    evaluation may be sampled (`DuhlChunkSampler`): the result then holds
    `sampled_epochs` and `chunk_visits_saved`.  Returns the solution and
    `epochs`, the passes over the file (every evaluation, line-search trials
    included)."""
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
    t_scan = time.perf_counter()
    scan = _label_moments_scan(path, features_col, features_cols, label_col, weight_col,
                               dtype, chunk_rows, need_moments=standardization)
    scan_s = time.perf_counter() - t_scan
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
    keys: list = []

    def host_chunks(select=None):
        for cX, cy, cw, n_c, _ in iter_file_chunks(path, features_col, features_cols,
                                                   label_col, weight_col, chunk_rows, dtype,
                                                   device_ok=True, device=device,
                                                   select_chunks=select, keys=keys):
            yield (cX[:n_c], np.asarray(cy[:n_c], np.int32),
                   _weights_host(cw, n_c, chunk_rows, dtype)[:n_c])

    def chunk_terms(theta, select=None):
        """Each chunk's loss and gradient under theta, normalised by the
        whole file's weight (the penalty is added once, on the host)."""
        timing: Dict[str, Any] = {}
        try:
            for cX, cy, cw in device_chunks(host_chunks(select), device, timing):
                if inv_std_dev is not None:
                    cX = (cX - mean_dev) * inv_std_dev if mean_dev is not None else cX * inv_std_dev
                yield LogisticOracle(cX, cw, cy, n_classes, 0.0, fit_intercept, binomial,
                                     wsum=wsum).value_and_grad(theta)
        finally:
            for k, v in timing.items():
                totals[k] = totals.get(k, 0.0) + v

    sampler = None
    stale: Dict[str, Optional[np.ndarray]] = {"l": None, "g": None}
    if chunk_sampling_mode() == "duhl":
        sampler = DuhlChunkSampler(get_config("streaming_chunk_sample_fraction"))

    def duhl_eval(theta, theta_np):
        """One epoch, sampled once the cache holds the stream: fresh terms
        for the selected chunks, the last-computed ones for the rest."""
        sel = _duhl_selection(sampler, keys[-1] if keys else None)
        idxs, host_l, host_g, dev_l, dev_g = [], [], [], [], []

        def flush():
            # bounded fetches: per-chunk terms kept on the card to the end
            # of the epoch would grow with the file
            if dev_l:
                host_l.extend(torch.stack(dev_l).cpu().numpy().astype(np.float64))
                host_g.extend(torch.stack(dev_g).cpu().numpy().astype(np.float64))
                dev_l.clear()
                dev_g.clear()

        positions = itertools.count() if sel is None else iter(sel)
        for idx, (f, g) in zip(positions, chunk_terms(theta, None if sel is None
                                                      else frozenset(sel))):
            idxs.append(idx)
            dev_l.append(f)
            dev_g.append(g)
            if len(dev_l) >= 64:
                flush()
        flush()
        if not sampler.ready():
            sampler.start(len(idxs))
            stale["l"] = np.zeros((len(idxs),), np.float64)
            stale["g"] = np.zeros((len(idxs), n_param), np.float64)
        for i, idx in enumerate(idxs):
            sampler.visited(idx, float(np.linalg.norm(host_g[i] - stale["g"][idx])))
            stale["l"][idx] = float(host_l[i])
            stale["g"][idx] = host_g[i]
        sampler.epoch_done(idxs)
        if sel is None:
            sampler.note_refresh(theta_np)
        return float(stale["l"].sum()), stale["g"].sum(axis=0)

    epoch_s: list = []

    def oracle(theta_np: np.ndarray):
        t_epoch = time.perf_counter()
        theta = torch.as_tensor(theta_np, dtype=tdt, device=device)
        if sampler is not None:
            f, g = duhl_eval(theta, theta_np)
        else:
            acc_l = torch.zeros((), dtype=tdt, device=device)
            acc_g = torch.zeros((n_param,), dtype=tdt, device=device)
            for fc, gc in chunk_terms(theta):
                acc_l += fc
                acc_g += gc
            host = torch.cat([acc_l.reshape(1), acc_g]).cpu().numpy().astype(np.float64)
            f, g = float(host[0]), host[1:]
        epochs["n"] += 1
        epoch_s.append(time.perf_counter() - t_epoch)
        beta = theta_np * coef_mask
        return f + 0.5 * l2 * float(beta @ beta), g + l2 * beta

    t0 = time.perf_counter()
    theta, n_iter, converged, hist = lbfgs_minimize_host(
        oracle, np.zeros((n_param,), np.float64), max_iter=max_iter, tol=tol, history=history,
        l1=l1, l1_mask=coef_mask, ls_max=ls_max)
    totals["wall_s"] = time.perf_counter() - t0
    _record_metrics("logreg_streaming", "logreg", epochs["n"], totals, into=STREAM_METRICS)
    STREAM_METRICS.update(epochs=epochs["n"], epoch_s=epoch_s, scan_s=scan_s,
                          **(sampler.summary() if sampler is not None else {}))
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
            "std": std, "binomial": binomial, "epochs": epochs["n"],
            **(sampler.summary() if sampler is not None else {})}


def seed_sample(path: str, features_col, features_cols, weight_col, n_total: int,
                init_rows: int, dtype, chunk_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """The strided global subsample the streamed KMeans seeds from: every
    `seed_sample_stride(n_total, init_rows)`-th row of the file with its
    weight (1 without a weight column), gathered by the `kmeans_sample`
    statistic program (stats/programs.py) from each chunk's global row, so
    any chunk order assembles the same sample.  (rows in `dtype`, weights
    float64)."""
    from .ops.kmeans import seed_sample_stride
    from .stats.engine import iter_chunk_accs
    from .stats.programs import get_program

    stride = seed_sample_stride(n_total, init_rows)
    cap = (n_total - 1) // stride + 1
    d = probe_num_features(path, features_col, features_cols)
    acc = iter_chunk_accs("kmeans_sample",
                          iter_file_chunks(path, features_col, features_cols, None, weight_col,
                                           chunk_rows, dtype),
                          d, dtype, opts={"stride": stride, "cap": cap})
    sample = get_program("kmeans_sample").finalize(acc, {})
    return np.asarray(sample["X"]).astype(dtype), np.asarray(sample["w"], np.float64)


def kmeans_streaming_fit(path: str, features_col, features_cols, weight_col, k: int, seed: int,
                         max_iter: int = 300, tol: float = 1e-4,
                         init: str = "scalable-k-means++", init_steps: int = 2,
                         oversample: float = 2.0, dtype=np.float32,
                         chunk_rows: Optional[int] = None, init_rows: int = 262_144,
                         checkpoint_path: Optional[str] = None,
                         checkpoint_dir: Optional[str] = None, device=None,
                         init_centers=None) -> dict:
    """Epoch-streaming Lloyd: centres seeded on the card from a strided
    global subsample (`seed_sample`: the `kmeans_sample` statistic program,
    then ops/kmeans.py's seeding), then
    each iteration one pass over the file that assigns every row and sums
    it into its centre (ops/kmeans.py `_lloyd_block_step`: `index_add_`
    partials in the fit's dtype, combined in float64), the centres
    updated on the card.  The stop rule of `kmeans_fit`: every centre
    moves less than `tol`, or a pass moves no row (the row labels of the
    pass before live on the card, 4 bytes a row).  With
    `streaming_chunk_sampling="duhl"` the passes are sampled once the
    chunk cache holds the file (`DuhlChunkSampler`) and the fit stops on
    the shift alone.  `init_centers` (k, d) replaces the seeding.  The cost
    is taken under the final centres, by a full pass."""
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
    t_scan = time.perf_counter()
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
    scan_s = time.perf_counter() - t_scan
    rows = km.block_rows(n_total, d, k, dtype.itemsize, n_total)
    unweighted = weight_col is None
    sampler = None
    if chunk_sampling_mode() == "duhl":
        # Lloyd has no line search and bears stale assignment statistics
        # better than L-BFGS bears a stale objective: sampling starts after
        # 3 exact passes, with a full refresh every 4th (the JAX package's
        # settings); the moved-rows stop needs every row's label, so a
        # sampled fit stops on the centres' shift alone, as the JAX
        # package's does
        sampler = DuhlChunkSampler(get_config("streaming_chunk_sample_fraction"),
                                   warm_evals=3, full_every=4)
    labels = (torch.full((n_total,), -1, dtype=torch.int32, device=device)
              if sampler is None else None)
    totals: Dict[str, float] = {}
    keys: list = []
    stale: Dict[str, Optional[np.ndarray]] = {}

    def new_acc():
        return (torch.zeros((k, d), dtype=torch.float64, device=device),
                torch.zeros(k, dtype=torch.float64, device=device),
                torch.zeros((), dtype=torch.float64, device=device),
                torch.zeros((), dtype=torch.int64, device=device))

    def pass_chunks(select=None):
        """(global row, X, w) of each chunk, on the device."""
        timing: Dict[str, Any] = {}
        offsets = []

        def host_chunks():
            for cX, _, cw, n_c, at in iter_file_chunks(path, features_col, features_cols, None,
                                                       weight_col, chunk_rows, dtype,
                                                       device_ok=True, device=device,
                                                       select_chunks=select, keys=keys):
                offsets.append(at)
                yield cX[:n_c], _weights_host(cw, n_c, chunk_rows, dtype)[:n_c]

        try:
            for i, (cX, cw) in enumerate(device_chunks(host_chunks(), device, timing)):
                yield offsets[i], cX, cw
        finally:
            for key, v in timing.items():
                totals[key] = totals.get(key, 0.0) + v

    def fold(acc, cX, cw, C, prev, at):
        x2 = km.row_norms(cX)
        for b in km._row_blocks(cX.shape[0], rows):
            km._lloyd_block_step(acc, cX[b], cw[b], x2[b], C, unweighted,
                                 None if prev is None else prev[at + b.start:at + b.stop])

    def one_pass(C, prev):
        acc = new_acc()
        for at, cX, cw in pass_chunks():
            fold(acc, cX, cw, C, prev, at)
        return acc

    def one_pass_duhl(C):
        """A Lloyd pass, sampled once the cache holds the stream: the chunks
        with the largest cost (the rows that still move centres) recompute
        under C, the rest add their last-computed sums, counts and cost."""
        sel = _duhl_selection(sampler, keys[-1] if keys else None)
        idxs, dev_stats, host_stats = [], [], []

        def flush():
            if dev_stats:
                host_stats.extend(torch.stack(dev_stats).cpu().numpy())
                dev_stats.clear()

        positions = itertools.count() if sel is None else iter(sel)
        for idx, (at, cX, cw) in zip(positions, pass_chunks(None if sel is None
                                                            else frozenset(sel))):
            acc = new_acc()
            fold(acc, cX, cw, C, None, at)
            dev_stats.append(torch.cat([acc[0].reshape(-1), acc[1], acc[2].reshape(1)]))
            idxs.append(idx)
            if len(dev_stats) >= 16:
                flush()
        flush()
        if not sampler.ready():
            sampler.start(len(idxs))
            stale["stats"] = np.zeros((len(idxs), k * d + k + 1), np.float64)
        for i, idx in enumerate(idxs):
            stale["stats"][idx] = host_stats[i]
            sampler.visited(idx, float(host_stats[i][-1]))
        sampler.epoch_done(idxs)
        if sel is None:
            sampler.note_refresh(C.cpu().numpy().astype(np.float64).ravel())
        tot = torch.as_tensor(stale["stats"].sum(axis=0), device=device)
        return tot[:k * d].reshape(k, d), tot[k * d:k * d + k], tot[-1]

    t0 = time.perf_counter()
    costs, moves, epoch_s = [], [], []
    n_iter = passes = 0
    for n_iter in range(1, max_iter + 1):
        t_epoch = time.perf_counter()
        if sampler is None:
            sums, counts, cost, moved = one_pass(C, labels)
        else:
            (sums, counts, cost), moved = one_pass_duhl(C), None
        passes += 1
        epoch_s.append(time.perf_counter() - t_epoch)
        costs.append(cost)
        new_C, shift2 = km._lloyd_center_update(C, sums, counts)
        if moved is None:
            shift2 = float(shift2)
        else:
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
    STREAM_METRICS.update(epochs=passes, epoch_s=epoch_s, scan_s=scan_s,
                          **(sampler.summary() if sampler is not None else {}))
    km.LAST_FIT.clear()
    km.LAST_FIT.update(streamed=True, stride=stride, init_rows=-(-n_total // stride), rows=rows,
                       n_iter=n_iter, costs=[float(c) for c in costs], moved=moves,
                       unweighted=unweighted, epochs=passes)
    logger.info(f"Epoch-streaming kmeans: {n_iter} Lloyd passes over {n_total} rows")
    return {"centers": C.cpu().numpy().astype(np.float64), "cost": float(cost),
            "n_iter": n_iter, "d": d, "epochs": passes,
            **(sampler.summary() if sampler is not None else {})}
