#
# Fused stage-and-solve: the in-memory half of spark_rapids_ml_tpu/fused.py.
# PCA and LinearRegression fit from sufficient statistics, and a fit from
# host arrays folds each chunk's contribution into a device accumulator as
# the chunk lands instead of staging every row and then solving: the rows
# never sit on the card whole, and the host's chunk prep overlaps the
# card's accumulation.
#
# One pass on one card (`accumulate_chunks`):
#   - a producer thread prepares chunks `staging_pipeline_depth` ahead:
#     cast, zero-padded tail (`iter_host_chunks`), then copied into pinned
#     host buffers;
#   - each chunk is copied to the device with `non_blocking` on a side
#     stream, and an event orders the accumulator step after the copy; the
#     next chunk's copy is issued before the current step is waited for,
#     so copy and step overlap on the card;
#   - full chunks with no weight column take the unweighted step;
#   - the pass ends in `acc_to_host_f64` (float64, Kahan carries folded).
# Per-pass numbers land in `FUSED_METRICS`.  Routing is in core.py
# (`_maybe_fit_fused`, conf `fused_stage_solve`); the step math is in
# ops/stats.py.  A pass that fails raises: there is no retry.
#
# Not ported yet (item 7 of ROADMAP.md): the parquet readers, the
# cross-process reduction, the drift-baseline fold, the pod pass ids and
# the statistic-program registry.
#
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .config import get_config

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


def _prefetch(produce: Iterator, depth: int) -> Iterator:
    """Run `produce` on a daemon thread up to `depth` items ahead of the
    consumer (a queue of depth - 1 plus the item in the producer's hand).
    A producer exception is raised on the consumer; a consumer that stops
    early stops the producer.  depth <= 1: plain iteration, no thread."""
    if depth <= 1:
        yield from produce
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth - 1)
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

    def producer() -> None:
        try:
            for item in produce:
                if not put(item):
                    return
        except BaseException as e:  # raised again on the consumer
            put(e)
            return
        put(done)

    t = threading.Thread(target=producer, name="fused-producer", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)


def _host_tensors(chunks: Iterable, pinned: bool, prep: Dict[str, Any]) -> Iterator:
    """Each `(X, y, w)` numpy chunk as CPU tensors (copied into pinned
    buffers when `pinned`), with the time spent producing it (chunk prep +
    the pinned copy) added to `prep["s"]` and its interval to
    `prep["iv"]`."""
    import torch

    it = iter(chunks)
    while True:
        t0 = time.perf_counter()
        try:
            parts = next(it)
        except StopIteration:
            return
        out = []
        for a in parts:
            if a is None:
                out.append(None)
                continue
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pinned:
                p = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                p.copy_(t)
                t = p
            out.append(t)
        t1 = time.perf_counter()
        prep["s"] += t1 - t0
        prep["iv"].append((t0, t1))
        yield tuple(out)


def accumulate_chunks(
    acc: Dict[str, Any],
    step: Tuple[Callable, Optional[Callable]],
    chunks: Iterable,
    device,
    *,
    has_y: bool = False,
    extra_args: Tuple = (),
) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """Drive one fused pass: fold every prepared host chunk `(X, y, w)`
    into the device accumulator `acc` (ops/stats.py) as it lands.  `step`
    is (weighted step, unweighted step or None); `extra_args` (the
    range-finder's Omega) go to the device once.

    Returns (host float64 statistics with the Kahan carries folded, the
    pass's wall_s, host_prep_s, device_acc_s, overlap_s, chunks, bytes).
    device_acc_s is the consumer's time issuing copies and steps and
    waiting for the card, without its waits for the producer: the card's
    work that runs during such a wait is not in it."""
    import torch

    from .ops.stats import acc_to_host_f64

    device = torch.device(device)
    on_card = device.type == "cuda"
    step_w, step_unw = step
    extra = tuple(torch.as_tensor(a, device=device) for a in extra_args)
    copy_stream = torch.cuda.Stream(device) if on_card else None
    compute = torch.cuda.current_stream(device) if on_card else None

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

    t0 = time.perf_counter()
    prep: Dict[str, Any] = {"s": 0.0, "iv": []}
    source = _prefetch(_host_tensors(chunks, on_card, prep), _staging_depth())
    acc_iv: List[Tuple[float, float]] = []
    n_chunks = nbytes = 0
    try:
        first = next(source, None)
        ta = time.perf_counter()
        pending = None if first is None else put(first)
        while pending is not None:
            (cX, cy, cw), ready, b = pending
            if ready is not None:
                compute.wait_event(ready)
                for t in (cX, cy, cw):
                    if t is not None:
                        t.record_stream(compute)  # made on the side stream, used here
            args = [cX]
            if cw is not None:
                args.append(cw)
            if has_y:
                args.append(cy)
            args.extend(extra)
            acc = (step_w if cw is not None else (step_unw or step_w))(acc, *args)
            del args, cX, cy, cw
            done = None
            if on_card:
                done = torch.cuda.Event()
                done.record(compute)
            acc_iv.append((ta, time.perf_counter()))
            # the next chunk comes from the producer (host time, not counted)
            # while the card runs this step; its copy goes out before the step
            # is waited for, so copy and step overlap on the card
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
        source.close()  # stops the producer when a step raised
    host = acc_to_host_f64(acc)
    wall = time.perf_counter() - t0
    return host, {
        "wall_s": wall,
        "host_prep_s": prep["s"],
        "device_acc_s": sum(hi - lo for lo, hi in acc_iv),
        "overlap_s": _interval_overlap_s(_merge_intervals(prep["iv"]), acc_iv),
        "chunks": n_chunks,
        "bytes": nbytes,
    }


def _record_metrics(label: str, kind: str, passes: int, totals: Dict[str, float],
                    solver: Optional[str] = None) -> None:
    """Fold one fused fit's (possibly multi-pass) totals into
    `FUSED_METRICS`; overlap_fraction is overlap_s over the smaller of
    prep and accumulate (1.0: the cheaper side ran wholly inside the
    other)."""
    prep_s = totals.get("host_prep_s", 0.0)
    acc_s = totals.get("device_acc_s", 0.0)
    overlap_s = max(totals.get("overlap_s", 0.0), 0.0)
    overlap = 0.0
    if min(prep_s, acc_s) > 1e-9:
        overlap = max(0.0, min(overlap_s / min(prep_s, acc_s), 1.0))
    FUSED_METRICS.clear()
    FUSED_METRICS.update(
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
        FUSED_METRICS["solver"] = solver


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


def fused_linreg_stats(producer_factory: Callable[[int], Iterable], d: int, dtype,
                       device, label: str = "linreg") -> Dict[str, Any]:
    """One fused pass of the weighted Gram, moment and cross statistics
    (ops/stats.py `linreg_acc`).  `producer_factory(n_dev)` yields prepared
    `(X, y, w)` chunks.  Returns the host float64 statistics
    `LinearRegression._attrs_from_stats` reads."""
    acc, step = _steps("linreg", d, 0, np.dtype(dtype), device)
    host, m = accumulate_chunks(acc, step, producer_factory(1), device, has_y=True)
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
        host, m = accumulate_chunks(acc, step, producer_factory(1), device)
        _record_metrics(label, "pca_moments", 1, m, solver="full")
        host["kind"] = "moments"
        return host

    totals: Dict[str, float] = {}

    def projected_pass(omega: np.ndarray) -> Dict[str, Any]:
        acc, step = _steps("pca_projected", d, l, dtype, device)
        host, m = accumulate_chunks(acc, step, producer_factory(1), device,
                                    extra_args=(np.asarray(omega, dtype),))
        _merge_totals(totals, m)
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
    return {
        "kind": "projected",
        "Q": Q,
        "SQ": final["SOm"],
        "s1": final["s1"],
        "ssq": final["ssq"],
        "sw": final["sw"],
        "k": k,
    }
