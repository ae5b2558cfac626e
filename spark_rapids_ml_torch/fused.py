#
# Fused stage-and-solve: the port of spark_rapids_ml_tpu/fused.py for one
# device.  PCA and LinearRegression fit from sufficient statistics, and a
# fit from host arrays or a parquet file folds each chunk's contribution
# into a device accumulator as the chunk lands instead of staging every
# row and then solving: the rows never sit on the card whole, and the
# host's chunk prep (or parquet decode) overlaps the card's accumulation.
#
# One pass on one card (`accumulate_chunks` over `device_chunks`):
#   - a producer thread prepares chunks `staging_pipeline_depth` ahead:
#     cast, zero-padded tail (`iter_host_chunks`, or the parquet producer
#     `iter_parquet_chunks`), then copied into pinned host buffers;
#   - each chunk is copied to the device with `non_blocking` on a side
#     stream, and an event orders the accumulator step after the copy; the
#     next chunk's copy is issued before the current step is waited for,
#     so copy and step overlap on the card;
#   - full chunks with no weight column take the unweighted step;
#   - the pass ends in `acc_to_host_f64` (float64, Kahan carries folded).
# The parquet producer splits a file's row groups across parallel range
# readers (`fused_parquet_readers`), each decoding only its share.
# Per-pass numbers land in `FUSED_METRICS`, the reader decision in
# `LAST_READER_DECISION`.  Routing is in core.py (`_maybe_fit_fused`, conf
# `fused_stage_solve`), where a fused fit runs under the retry policy; the
# step math is in ops/stats.py.  The accumulators are re-creatable: a
# failure mid-pass (the `fused_accumulate` fault site fires before each
# chunk's step) fails the whole pass, and a retry starts it with fresh
# accumulators, so no chunk counts twice.
#
# A parquet pass runs through the chunk cache (parallel/device_cache.py): the
# first pass over a file decodes and records its chunks, every later pass
# with the same parameters (the randomized PCA's four) replays them, the
# feature blocks from the card's memory while the device tier holds them.
#
# Not ported: the cross-process reduction and `process_row_group_shares`
# (ROADMAP.md section 1, "Multi-GPU and multi-process"), the drift-baseline
# fold and the pod pass ids.
#
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .config import get_config
from .utils import prefetch_iter

# The last fused fit: label, kind, passes, chunks, bytes, wall_s,
# host_prep_s (chunk prep on the producer thread), device_acc_s (copy +
# step, waited for, on the consumer), overlap_s (the wall-clock
# intersection of the two), overlap_fraction, solver, stamp.
FUSED_METRICS: dict = {}

# "auto" fuses once the staged bytes reach this floor: below it one plain
# staging beats the per-chunk overhead
_AUTO_MIN_BYTES = 64 * 1024 * 1024

# at least this many chunks per pass, so the producer has something to
# run ahead on
_MIN_CHUNKS = 8
_MIN_CHUNK_ROWS = 1024

# the JAX package clamps a chunk to its largest single transfer; kept so
# that chunk boundaries, and so the summation order, match it
_MAX_PUT_BYTES = 512 * 1024 * 1024


def fused_mode() -> str:
    mode = str(get_config("fused_stage_solve")).lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fused_stage_solve must be auto|on|off, got {mode!r}")
    return mode


def fused_enabled(est_bytes: float) -> bool:
    """Whether the conf routes an eligible fit (dense, statistics-capable:
    the caller checks those) through the fused pass: "on" always, "auto"
    once the staged-bytes estimate reaches `_AUTO_MIN_BYTES`, "off"
    never."""
    mode = fused_mode()
    if mode == "off":
        return False
    if mode == "on":
        return True
    return float(est_bytes) >= _AUTO_MIN_BYTES


def fused_chunk_rows(n: int, d: int, itemsize: int, n_dev: int = 1) -> int:
    """Rows per fused chunk: `staging_chunk_bytes` (clamped to the JAX
    package's transfer ceiling), floored so that a pass has at least
    `_MIN_CHUNKS` chunks, and a multiple of `n_dev`."""
    row_bytes = max(d * itemsize, 1)
    budget = max(1, min(int(get_config("staging_chunk_bytes")), _MAX_PUT_BYTES) // row_bytes)
    rows = min(budget, max(-(-n // _MIN_CHUNKS), _MIN_CHUNK_ROWS))
    rows = min(rows, max(n, 1))
    return -(-rows // n_dev) * n_dev


def iter_host_chunks(
    X: np.ndarray,
    y: Optional[np.ndarray],
    weight: Optional[np.ndarray],
    chunk_rows: int,
    dtype: np.dtype,
    label_dtype: Optional[np.dtype] = None,
) -> Iterable[Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]]:
    """Fixed-shape `(X_chunk, y_chunk, w_chunk)` host chunks of an
    in-memory batch, prepared (cast, zero-padded tail, weights) inside
    `__next__`, which the fused pass runs on its producer thread.  A full
    chunk with no weights has w None (the unweighted step); padding rows
    have weight 0, so they are absent from every statistic."""
    dtype = np.dtype(dtype)
    ldt = np.dtype(label_dtype) if label_dtype is not None else dtype
    n = int(X.shape[0])
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        rows = hi - lo
        if rows == chunk_rows:
            cX = np.ascontiguousarray(X[lo:hi], dtype=dtype)
            cw = None if weight is None else np.asarray(weight[lo:hi], dtype)
            cy = (
                None if y is None
                else np.ascontiguousarray(np.asarray(y[lo:hi]).reshape(-1), dtype=ldt)
            )
        else:  # zero-padded tail chunk (padding weight stays 0)
            cX = np.zeros((chunk_rows,) + X.shape[1:], dtype)
            cX[:rows] = X[lo:hi]
            cw = np.zeros((chunk_rows,), dtype)
            cw[:rows] = 1.0 if weight is None else np.asarray(weight[lo:hi], dtype)
            cy = None
            if y is not None:
                cy = np.zeros((chunk_rows,), ldt)
                cy[:rows] = np.asarray(y[lo:hi]).reshape(-1)
        yield cX, cy, cw


def _merge_intervals(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sort and coalesce intervals into a disjoint sorted list."""
    if not iv:
        return []
    iv = sorted(iv)
    out = [list(iv[0])]
    for lo, hi in iv[1:]:
        if lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _interval_overlap_s(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Total length of the intersection of two sorted disjoint interval
    lists: how long both sides were active at once."""
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _staging_depth() -> int:
    return max(1, int(get_config("staging_pipeline_depth")))


def _host_tensors(chunks: Iterable, pinned: bool, prep: Dict[str, Any],
                  time_pull: bool = True) -> Iterator:
    """Each numpy chunk (a tuple of arrays or None) as CPU tensors, copied
    into pinned buffers when `pinned`; a tensor (a chunk-cache replay: the
    device tier's CUDA tensor or the host tier's pinned copy) passes as it
    is.  The time spent is added to `prep["s"]` and its interval to
    `prep["iv"]`: the pull of the chunk and its pinned copy, or only the
    copy when the producer times its own decode (`time_pull=False`, the
    parallel parquet readers)."""
    import torch

    from .parallel.mesh import _torch_dtype

    it = iter(chunks)
    while True:
        t0 = time.perf_counter()
        try:
            parts = next(it)
        except StopIteration:
            return
        if not time_pull:
            t0 = time.perf_counter()
        out = []
        for a in parts:
            if a is None or isinstance(a, torch.Tensor):
                out.append(a)
                continue
            a = np.ascontiguousarray(a)
            if not pinned:
                # a decoded Arrow buffer is read-only; a tensor wants
                # writable memory
                t = torch.from_numpy(a if a.flags.writeable else a.copy())
            elif a.flags.writeable:
                t = torch.empty(a.shape, dtype=_torch_dtype(a.dtype), pin_memory=True)
                t.copy_(torch.from_numpy(a))
            else:
                t = torch.empty(a.shape, dtype=_torch_dtype(a.dtype), pin_memory=True)
                np.copyto(t.numpy(), a)
            out.append(t)
        t1 = time.perf_counter()
        prep["s"] += t1 - t0
        prep["iv"].append((t0, t1))
        yield tuple(out)


def device_chunks(chunks: Iterable, device, timing: Dict[str, Any],
                  prep: Optional[Dict[str, Any]] = None) -> Iterator[Tuple]:
    """Each host chunk (a tuple of numpy arrays or None) as device tensors,
    ready on the current stream when it is yielded.  A producer thread
    prepares chunks `staging_pipeline_depth` ahead (pinned copies on a
    card); each chunk is copied with `non_blocking` on a side stream, and
    the next chunk's copy is issued before the consumer's work on the
    current one is waited for, so copy and work overlap on the card.

    When the stream ends, `timing` holds host_prep_s (the producer's time,
    or `prep`'s when the producer times itself), device_acc_s (the
    consumer's work and its waits for the card, not its waits for the
    producer), overlap_s (the wall-clock intersection of the two), chunks
    and bytes."""
    import torch

    device = torch.device(device)
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None
    compute = torch.cuda.current_stream(device) if on_card else None
    self_timed = prep is not None
    if prep is None:
        prep = {"s": 0.0, "iv": []}

    def put(item):
        """(device tensors, copy-done event, bytes) of a chunk: on the card
        copied on the side stream (None event on the CPU)."""
        nbytes = sum(t.nbytes for t in item if t is not None)
        if not on_card:
            return item, None, nbytes
        with torch.cuda.stream(copy_stream):
            dev = tuple(None if t is None else t.to(device, non_blocking=True) for t in item)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return dev, ready, nbytes

    source = prefetch_iter(_host_tensors(chunks, on_card, prep, time_pull=not self_timed),
                           _staging_depth())
    acc_iv: List[Tuple[float, float]] = []
    n_chunks = nbytes = 0
    try:
        first = next(source, None)
        ta = time.perf_counter()
        pending = None if first is None else put(first)
        while pending is not None:
            dev, ready, b = pending
            if ready is not None:
                compute.wait_event(ready)
                for t in dev:
                    if t is not None:
                        t.record_stream(compute)  # made on the side stream, used here
            yield dev
            del dev
            done = None
            if on_card:
                done = torch.cuda.Event()
                done.record(compute)
            acc_iv.append((ta, time.perf_counter()))
            # the next chunk comes from the producer (host time, not counted)
            # while the card runs the consumer's work; its copy goes out
            # before that work is waited for
            nxt = next(source, None)
            ta = time.perf_counter()
            pending = None if nxt is None else put(nxt)
            if done is not None:
                done.synchronize()
            acc_iv.append((ta, time.perf_counter()))
            ta = time.perf_counter()
            n_chunks += 1
            nbytes += b
    finally:
        source.close()  # stops the producer when the consumer raised
        timing.update(
            host_prep_s=prep["s"],
            device_acc_s=sum(hi - lo for lo, hi in acc_iv),
            overlap_s=_interval_overlap_s(_merge_intervals(prep["iv"]), acc_iv),
            chunks=n_chunks,
            bytes=nbytes,
        )


def accumulate_chunks(
    acc: Dict[str, Any],
    step: Tuple[Callable, Optional[Callable]],
    chunks: Iterable,
    device,
    *,
    has_y: bool = False,
    extra_args: Tuple = (),
    prep: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """Drive one fused pass: fold every prepared host chunk `(X, y, w)`
    into the device accumulator `acc` (ops/stats.py) as it lands
    (`device_chunks`).  `step` is (weighted step, unweighted step or
    None); a chunk with w None takes the unweighted one.  `extra_args`
    (the range-finder's Omega) go to the device once.  `prep`: the
    producer's own decode timing, when it keeps one.

    Returns (host float64 statistics with the Kahan carries folded, the
    pass's wall_s, host_prep_s, device_acc_s, overlap_s, chunks, bytes)."""
    import torch

    from .ops.stats import acc_to_host_f64

    step_w, step_unw = step
    extra = tuple(torch.as_tensor(a, device=device) for a in extra_args)
    t0 = time.perf_counter()
    timing: Dict[str, Any] = {}
    from .resilience import maybe_inject

    for cX, cy, cw in device_chunks(chunks, device, timing, prep):
        maybe_inject("fused_accumulate")
        args = [cX]
        if cw is not None:
            args.append(cw)
        if has_y:
            args.append(cy)
        args.extend(extra)
        acc = (step_w if cw is not None else (step_unw or step_w))(acc, *args)
        del args, cX, cy, cw
    host = acc_to_host_f64(acc)
    return host, {"wall_s": time.perf_counter() - t0, **timing}


def _record_metrics(label: str, kind: str, passes: int, totals: Dict[str, float],
                    solver: Optional[str] = None, into: Optional[dict] = None) -> None:
    """Fold one fused fit's (possibly multi-pass) totals into
    `FUSED_METRICS` (or `into`: the streamed passes keep theirs in
    streaming.py `STREAM_METRICS`); overlap_fraction is overlap_s over the smaller of
    prep and accumulate (1.0: the cheaper side ran wholly inside the
    other)."""
    prep_s = totals.get("host_prep_s", 0.0)
    acc_s = totals.get("device_acc_s", 0.0)
    overlap_s = max(totals.get("overlap_s", 0.0), 0.0)
    overlap = 0.0
    if min(prep_s, acc_s) > 1e-9:
        overlap = max(0.0, min(overlap_s / min(prep_s, acc_s), 1.0))
    into = FUSED_METRICS if into is None else into
    into.clear()
    into.update(
        stamp=round(time.time(), 3),
        label=label,
        kind=kind,
        passes=int(passes),
        chunks=int(totals.get("chunks", 0)),
        bytes=int(totals.get("bytes", 0)),
        wall_s=totals.get("wall_s", 0.0),
        host_prep_s=prep_s,
        device_acc_s=acc_s,
        overlap_s=overlap_s,
        overlap_fraction=overlap,
    )
    if solver is not None:
        into["solver"] = solver


def _merge_totals(totals: Dict[str, float], m: Dict[str, float]) -> None:
    for k, v in m.items():
        totals[k] = totals.get(k, 0.0) + v


def _steps(kind: str, d: int, l: int, dtype, device):
    """(fresh accumulator, (weighted step, unweighted step))."""
    from .ops import stats

    if kind == "linreg":
        acc, step = stats.linreg_acc(d, dtype, device)
        return acc, (step, stats.linreg_step_unw)
    if kind == "pca_moments":
        acc, step = stats.pca_moment_acc(d, dtype, device)
        return acc, (step, stats.pca_moment_step_unw)
    acc, step = stats.pca_projected_acc(d, l, dtype, device)
    return acc, (step, stats.pca_projected_step_unw)


def _resolve_producer(produced) -> Tuple[Iterable, Optional[Dict[str, Any]]]:
    """A producer factory returns a chunk iterable (the pass times its
    pull) or `(iterable, prep)` when the producer times its own decode
    (the parallel parquet readers)."""
    if isinstance(produced, tuple):
        return produced
    return produced, None


def fused_linreg_stats(producer_factory: Callable[[int], Iterable], d: int, dtype,
                       device, label: str = "linreg") -> Dict[str, Any]:
    """One fused pass of the weighted Gram, moment and cross statistics
    (ops/stats.py `linreg_acc`).  `producer_factory(n_dev)` yields prepared
    `(X, y, w)` chunks (`_resolve_producer`).  Returns the host float64
    statistics `LinearRegression._attrs_from_stats` reads."""
    acc, step = _steps("linreg", d, 0, np.dtype(dtype), device)
    chunks, prep = _resolve_producer(producer_factory(1))
    host, m = accumulate_chunks(acc, step, chunks, device, has_y=True, prep=prep)
    _record_metrics(label, "linreg", 1, m)
    return host


def fused_pca_stats(producer_factory: Callable[[int], Iterable], d: int, k: int, dtype,
                    device, label: str = "pca") -> Dict[str, Any]:
    """Fused PCA statistics, the solver from `resolve_pca_solver(streamed=
    True)`:

    - "full": one pass of the second moments ->
      {"kind": "moments", "S", "s1", "sw"} (`PCA._attrs_from_moments`);
    - "randomized": the Halko range-finder, each tall-skinny product (the
      sketch, the power iterations, the final projection) one fused pass
      over a fresh `producer_factory` iterator ->
      {"kind": "projected", "Q", "SQ", "s1", "ssq", "sw", "k"}
      (`ops.pca.pca_attrs_from_projected`)."""
    from .ops.pca import resolve_pca_solver, sketch

    dtype = np.dtype(dtype)
    solver, l, power_iters, _reason = resolve_pca_solver(d, k, streamed=True)
    if solver == "full":
        acc, step = _steps("pca_moments", d, 0, dtype, device)
        chunks, prep = _resolve_producer(producer_factory(1))
        host, m = accumulate_chunks(acc, step, chunks, device, prep=prep)
        _record_metrics(label, "pca_moments", 1, m, solver="full")
        host["kind"] = "moments"
        return host

    totals: Dict[str, float] = {}
    pass_log: List[Dict[str, Any]] = []

    def projected_pass(omega: np.ndarray) -> Dict[str, Any]:
        acc, step = _steps("pca_projected", d, l, dtype, device)
        chunks, prep = _resolve_producer(producer_factory(1))
        host, m = accumulate_chunks(acc, step, chunks, device, prep=prep,
                                    extra_args=(np.asarray(omega, dtype),))
        _merge_totals(totals, m)
        pass_log.append({"source": (prep or {}).get("source", "host"), **m})
        return host

    omega = sketch(d, l).astype(dtype)
    st = projected_pass(omega)
    sw = float(st["sw"])
    mean = st["s1"] / sw

    def centred(SOm: np.ndarray, om: np.ndarray) -> np.ndarray:
        # (A^T A) om from the raw projected moments:
        # sum w x (x^T om) - sw mean (mean^T om)
        return np.asarray(SOm, np.float64) - sw * np.outer(mean, mean @ om)

    Y = centred(st["SOm"], omega)
    for _ in range(power_iters):
        Q, _r = np.linalg.qr(Y)
        Y = centred(projected_pass(Q.astype(dtype))["SOm"], Q)
    Q, _r = np.linalg.qr(Y)
    final = projected_pass(Q.astype(dtype))
    _record_metrics(label, "pca_projected", 2 + power_iters, totals, solver="randomized")
    # each pass: decode or replay (a parquet producer), wall, prep, device
    FUSED_METRICS["pass_log"] = pass_log
    return {
        "kind": "projected",
        "Q": Q,
        "SQ": final["SOm"],
        "s1": final["s1"],
        "ssq": final["ssq"],
        "sw": final["sw"],
        "k": k,
    }


# ---------------------------------------------------------------------------
# The parquet producer: row-group-pruned range readers
# ---------------------------------------------------------------------------

# The last `resolve_parquet_readers` decision: stamp, parquet_readers,
# parquet_readers_mode ("auto" or "explicit") and parquet_readers_reason;
# and readers_used, the range readers the file's row groups allowed.
LAST_READER_DECISION: dict = {}

_MAX_AUTO_READERS = 16


def _usable_cores() -> int:
    """The cores this process may run on (a container's share, where the
    JAX package reads the host's `os.cpu_count()`)."""
    import os

    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:  # pragma: no cover - platforms without affinity
        return max(1, os.cpu_count() or 1)


def resolve_parquet_readers(path: Optional[str] = None) -> int:
    """The parallel range-reader count from the `fused_parquet_readers`
    conf: an int pins it; "auto" takes the usable cores, at most
    `_MAX_AUTO_READERS`.  The file's row groups clamp it later
    (`_partition_row_groups`).  The decision lands in
    `LAST_READER_DECISION`."""
    raw = get_config("fused_parquet_readers")
    mode = str(raw).strip().lower()
    if mode == "auto":
        cores = _usable_cores()
        readers = min(cores, _MAX_AUTO_READERS)
        reason = f"usable cores={cores}"
    else:
        readers = max(1, int(raw))
        mode = "explicit"
        reason = "pinned by conf"
    LAST_READER_DECISION.clear()
    LAST_READER_DECISION.update(
        stamp=round(time.time(), 3),
        parquet_readers=int(readers),
        parquet_readers_mode=mode,
        parquet_readers_reason=reason,
    )
    return readers


def _row_group_sizes(path: str) -> List[int]:
    import pyarrow.parquet as pq

    md = pq.ParquetFile(path).metadata
    return [md.row_group(i).num_rows for i in range(md.num_row_groups)]


def _partition_row_groups(path: str, readers: int) -> Optional[list]:
    """A parquet FILE's row groups in `readers` row-balanced contiguous
    shares; None for a dataset directory, one reader, or fewer than two
    groups (the caller then runs one in-order reader)."""
    import os

    if readers <= 1 or os.path.isdir(path):
        return None
    sizes = _row_group_sizes(path)
    if len(sizes) < 2:
        return None
    readers = min(readers, len(sizes))
    per = -(-sum(sizes) // readers)
    shares, cur, acc = [], [], 0
    for i, s in enumerate(sizes):
        cur.append(i)
        acc += s
        if acc >= per and len(shares) < readers - 1:
            shares.append(cur)
            cur, acc = [], 0
    if cur:
        shares.append(cur)
    return shares if len(shares) > 1 else None


def _share_row_starts(path: str, shares: list) -> list:
    """The global first row of each contiguous row-group share (0 for an
    empty share)."""
    starts = np.concatenate(([0], np.cumsum(_row_group_sizes(path))))
    return [int(starts[sh[0]]) if sh else 0 for sh in shares]


def _reader_batches(path: str, columns, chunk_rows: int, groups=None):
    """Arrow record batches: a row-group-pruned `ParquetFile` reader for a
    single file (`groups` lets a range reader decode only its share), the
    dataset scanner for a directory."""
    import os

    if not os.path.isdir(path):
        import pyarrow.parquet as pq

        pf = pq.ParquetFile(path)
        kw = {} if groups is None else {"row_groups": list(groups)}
        yield from pf.iter_batches(batch_size=chunk_rows, columns=columns, **kw)
        return
    import pyarrow.dataset as pads

    yield from pads.dataset(path, format="parquet").to_batches(
        columns=columns, batch_size=chunk_rows)


def _range_chunks(path: str, features_col, features_cols, label_col, weight_col,
                  chunk_rows: int, dtype: np.dtype, ldt: np.dtype, groups,
                  base_offset: Optional[int] = None) -> Iterator[Tuple]:
    """One reader's share as fused-pass chunks `(X, y, w)`: the decode and
    fixed-shape chunking of `streaming.chunks_from_batches` over the row
    groups `groups` (None: the whole file).  w is None for a full chunk
    with no weight column (the unweighted step), else the weights with 0
    on the padding; y is the label in `ldt`, zero-padded.  With
    `base_offset` (the global row of the share's first row) the chunks
    are `(X, y, w, offset)`, offset the global row of the chunk's first
    row."""
    from .streaming import _scan_columns, _weights_host, chunks_from_batches

    columns = _scan_columns(features_col, features_cols, label_col, weight_col)
    off = None if base_offset is None else int(base_offset)
    for cX, cy, cw, n_c in chunks_from_batches(
            _reader_batches(path, columns, chunk_rows, groups),
            features_col, features_cols, label_col, weight_col, chunk_rows, np.dtype(dtype)):
        w = None if (cw is None and n_c == chunk_rows) else np.asarray(
            _weights_host(cw, n_c, chunk_rows, dtype))
        y = None
        if cy is not None:
            y = np.zeros((chunk_rows,), ldt)
            y[:n_c] = np.asarray(cy[:n_c]).reshape(-1)
        if off is None:
            yield cX, y, w
        else:
            yield cX, y, w, off
            off += int(n_c)


def _timed_iter(it: Iterable, prep: Optional[Dict[str, Any]]) -> Iterator:
    """`it`, with the time of each pull added to `prep["s"]` and its
    interval to `prep["iv"]` (plain `it` when prep is None)."""
    if prep is None:
        yield from it
        return
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        t1 = time.perf_counter()
        prep["s"] += t1 - t0
        prep["iv"].append((t0, t1))
        yield item


def merge_threads(sources: List[Iterable]) -> Iterator:
    """The items of every iterable in `sources`, each run on its own
    daemon thread, in the order they arrive (a bounded queue).  A source's
    exception is raised on the consumer; a consumer that stops early stops
    every thread."""
    q: "queue.Queue" = queue.Queue(maxsize=len(sources) + 1)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def run(src) -> None:
        try:
            for item in src:
                if not put(item):
                    return
            put(done)
        except BaseException as e:  # raised again on the consumer
            put(e)

    threads = [threading.Thread(target=run, args=(s,), name="parquet-reader", daemon=True)
               for s in sources]
    for t in threads:
        t.start()
    try:
        finished = 0
        while finished < len(threads):
            item = q.get()
            if item is done:
                finished += 1
                continue
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)


def iter_parquet_chunks(path: str, features_col, features_cols, label_col, weight_col,
                        chunk_rows: int, dtype, label_dtype=None,
                        readers: Optional[int] = None,
                        prep: Optional[Dict[str, Any]] = None,
                        with_offsets: bool = False, device=None) -> Iterator[Tuple]:
    """The parquet producer of the fused pass: `_range_chunks` over the
    whole file, split across `readers` parallel range-reader threads
    (`fused_parquet_readers`), each decoding only its row-group share.
    Chunks then arrive in any order, which the statistics' sums do not
    mind.  `prep` collects each reader's decode time and intervals (they
    overlap across readers; the pass merges them).  `with_offsets` yields
    `(X, y, w, offset)`, offset the chunk's first row in the file.

    The pass runs through the chunk cache: the first pass with these
    parameters decodes and records its chunks, every later one replays
    them in the recorded order (then the serve time is the prep, and
    `prep["source"]` says "replay" instead of "decode").  A replayed
    feature block may be a tensor: the device tier's, mirrored onto
    `device`, or the host tier's pinned copy.  The range readers' order
    differs from run to run, so a chunk that cannot be served mid-replay
    raises `ChunkIntegrityError` (`ordered=False`); a single in-order reader
    resumes from the file."""
    from .parallel.device_cache import cached_chunk_stream, chunk_stream_complete
    from .streaming import _chunk_stream_key

    dtype = np.dtype(dtype)
    ldt = np.dtype(label_dtype) if label_dtype is not None else dtype
    if readers is None:
        readers = resolve_parquet_readers(path)
    shares = _partition_row_groups(path, readers)
    LAST_READER_DECISION["readers_used"] = 1 if shares is None else len(shares)
    tag = ("fused+goff:" if with_offsets else "fused:") + ldt.str
    key = _chunk_stream_key(path, features_col, features_cols, label_col, weight_col,
                            chunk_rows, dtype, None, tag=tag)

    def source():
        return _parquet_reader_pool(path, features_col, features_cols, label_col, weight_col,
                                    chunk_rows, dtype, ldt, shares, prep,
                                    with_offsets=with_offsets)

    replay = chunk_stream_complete(key) is not None
    if prep is not None:
        prep["source"] = "replay" if replay else "decode"
    stream = cached_chunk_stream(key, source, device_elem=0, serve_device=True,
                                 ordered=shares is None, device=device)
    if replay:
        # no reader runs: serving the recorded chunks is the prep
        stream = _timed_iter(stream, prep)
    yield from stream


def _parquet_reader_pool(path, features_col, features_cols, label_col, weight_col,
                         chunk_rows, dtype, ldt, shares, prep,
                         with_offsets: bool = False) -> Iterator[Tuple]:
    """One in-order reader (`shares` None), or a range-reader thread per
    share of row groups merged (`merge_threads`); with `with_offsets` each
    share starts from its global first row."""
    if shares is None:
        yield from _timed_iter(_range_chunks(
            path, features_col, features_cols, label_col, weight_col, chunk_rows, dtype, ldt,
            None, base_offset=0 if with_offsets else None), prep)
        return
    starts = _share_row_starts(path, shares) if with_offsets else [None] * len(shares)
    yield from merge_threads([
        _timed_iter(_range_chunks(path, features_col, features_cols, label_col, weight_col,
                                  chunk_rows, dtype, ldt, groups, base_offset=base), prep)
        for groups, base in zip(shares, starts)])
