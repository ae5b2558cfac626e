#
# The statistic-program engine: the port of spark_rapids_ml_tpu/stats/
# engine.py for one device.  It runs any set of registered programs
# (stats/programs.py) in ONE pass over the data:
#
#   - an in-memory batch is cut into fused.py `iter_host_chunks` chunks;
#   - a parquet path streams through fused.py `iter_parquet_chunks`: the
#     range readers and the chunk cache, so a second pass over the same file
#     (a second `summarize`) replays it, from the card's memory while the
#     device tier holds it;
#   - chunk prep (the cast, the pinned copy, or the parquet decode) runs on
#     a producer thread `staging_pipeline_depth` chunks ahead, while the
#     consumer folds the previous chunk.
#
# The device programs fold one after another into their accumulators on the
# device (`_combined_step`: eager torch ops, no compilation); the host
# programs (the sketches) fold on the consumer thread from the same chunk
# while the card runs, so one pass reads the data once.  A pass runs under
# the retry policy (resilience/retry.py) with its accumulators treated as
# re-creatable: a failure mid-pass (the `stat_program_step` fault site fires
# before each chunk) restarts the whole pass with fresh accumulators, so a
# retried chunk never counts twice.
#
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np

from ..utils import get_logger

logger = get_logger("spark_rapids_ml_torch.stats")

# The last engine pass: label, programs, chunks, bytes, wall_s,
# host_prep_s, device_acc_s, overlap_s, overlap_fraction and source (decode
# or replay of a parquet stream, host for an in-memory batch); written whole
# under the lock, so that two concurrent passes leave one pass's record.
STAT_METRICS: Dict[str, Any] = {}
_stat_metrics_lock = threading.Lock()


def _chunk_rows_for(n: int, d: int, itemsize: int, n_dev: int = 1) -> int:
    from ..fused import fused_chunk_rows

    return fused_chunk_rows(n, d, itemsize, n_dev)


def _combined_step(progs, d: int, dtype, popts: Dict[str, Dict[str, Any]]) -> Callable:
    """One step folding every device program's contribution of a chunk into
    its accumulator, in place.  A chunk with w None (a full unweighted
    chunk) takes each program's unweighted step where it has one (no X * w
    copy), else weights of one."""
    import torch

    steps = [(p.name, *p.make_step(d, dtype, popts[p.name]), p.needs_y) for p in progs]

    def combined(acc, X, w, y):
        ones = None
        for name, step_w, unw, needs_y in steps:
            if w is None and unw is not None and not needs_y:
                acc[name] = unw(acc[name], X)
                continue
            wv = w
            if wv is None:
                if ones is None:
                    ones = torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)
                wv = ones
            acc[name] = step_w(acc[name], X, wv, y) if needs_y else step_w(acc[name], X, wv)
        return acc

    return combined


def _normalize_source(source, features_col, features_cols, label_col, weight_col, dtype,
                      needs_y: bool, device):
    """(producer_factory, d, n, dtype): `producer_factory()` gives prepared
    fixed-shape `(X, y, w[, offset])` chunks (fused.py's contract; w None: a
    full unweighted chunk), or `(chunks, prep)` when the producer times its
    own decode."""
    from ..streaming import is_parquet_path

    dtype = np.dtype(dtype or np.float32)
    if is_parquet_path(source):
        from ..streaming import chunk_rows_for, parquet_row_count, probe_num_features

        d = probe_num_features(source, features_col, features_cols)
        n = parquet_row_count(source)
        if n == 0:
            raise ValueError("Dataset is empty: nothing to summarize")
        chunk_rows = min(chunk_rows_for(d, dtype.itemsize), max(n, 1))

        def factory():
            from ..fused import iter_parquet_chunks

            prep: Dict[str, Any] = {"s": 0.0, "iv": []}
            # with_offsets: each chunk carries its global first row, so the
            # offset-addressed host programs (kmeans_sample) fill the same
            # slots whatever order the readers deliver in
            return (iter_parquet_chunks(source, features_col, features_cols,
                                        label_col if needs_y else None, weight_col, chunk_rows,
                                        dtype, prep=prep, with_offsets=True, device=device),
                    prep)

        return factory, d, n, dtype

    from ..data import _is_sparse, extract_arrays

    batch = extract_arrays(source, features_col=features_col, features_cols=features_cols,
                           label_col=label_col if needs_y else None, weight_col=weight_col,
                           dtype=None, supervised=needs_y)
    X = batch.X
    if _is_sparse(X):
        X = np.asarray(X.todense())
    X = np.asarray(X, dtype)
    if X.ndim == 1:
        X = X.reshape(-1, 1)
    n, d = int(X.shape[0]), int(X.shape[1])
    if n == 0:
        raise ValueError("Dataset is empty: nothing to summarize")
    y, w = batch.y, batch.weight

    def factory():
        from ..fused import iter_host_chunks

        return iter_host_chunks(X, y, w, _chunk_rows_for(n, d, dtype.itemsize), dtype)

    return factory, d, n, dtype


def run_programs(names: Sequence[str], source, *, features_col: Optional[str] = "features",
                 features_cols: Sequence[str] = (), label_col: Optional[str] = None,
                 weight_col: Optional[str] = None, dtype=None,
                 opts: Optional[Dict[str, Dict[str, Any]]] = None,
                 quantiles: Optional[Sequence[float]] = None, label: str = "summarize",
                 device=None) -> Dict[str, Dict[str, Any]]:
    """Run the named programs in ONE pass over `source` (a numpy batch, an
    `(X, y)` tuple, a pandas frame, or a parquet path) on `device` (default:
    the default device).  Returns `{program name: finalized statistics}`."""
    from ..streaming import _device
    from .programs import get_program

    names = tuple(dict.fromkeys(names))  # keep the order, drop repeats
    if not names:
        raise ValueError("no statistic programs requested")
    progs = [get_program(n) for n in names]
    for p in progs:
        if p.extra_args:
            raise ValueError(
                f"program {p.name!r} requires extra step arguments {p.extra_args} and runs "
                "only through its dedicated caller (the fused estimator path), not the "
                "generic engine dispatch")
    needs_y = any(p.needs_y for p in progs)
    if needs_y and label_col is None and not _has_label(source):
        raise ValueError("programs " + ", ".join(p.name for p in progs if p.needs_y)
                         + " need a label column (label_col=...)")
    device = _device(device)
    factory, d, n, dtype = _normalize_source(source, features_col, features_cols, label_col,
                                             weight_col, dtype, needs_y, device)
    from ..resilience import retry_call

    return retry_call(
        lambda: _one_pass(progs, factory, d, dtype, needs_y, dict(opts or {}), quantiles, label,
                          device),
        label="stat_programs", log=logger)


def run_program(name: str, source, **kwargs) -> Dict[str, Any]:
    """One program through `run_programs`."""
    return run_programs([name], source, **kwargs)[name]


def _has_label(source) -> bool:
    return isinstance(source, (tuple, list)) and len(source) == 2


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _reduce_pass_across_processes(*_args, **_kwargs):
    """The JAX package combines the ranks' partial accumulators here; the
    port runs one process (ROADMAP.md section 1, item 8)."""
    raise NotImplementedError(
        "a statistics pass across several processes is not ported: ROADMAP.md section 1, "
        "item 8 (Multi-GPU and multi-process)")


def _host_array(x) -> np.ndarray:
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _one_pass(progs, factory, d: int, dtype, needs_y: bool, opts: Dict[str, Dict[str, Any]],
              quantiles, label: str, device) -> Dict[str, Dict[str, Any]]:
    import torch

    from ..fused import _interval_overlap_s, _merge_intervals, _resolve_producer, _staging_depth
    from ..ops.stats import acc_to_host_f64
    from ..parallel.device_cache import _tensor
    from ..streaming import _weights_host
    from ..utils import prefetch_iter
    from .programs import resolve_opts

    if _process_count() > 1:
        _reduce_pass_across_processes()
    device = torch.device(device)
    on_card = device.type == "cuda"
    dtype = np.dtype(dtype)
    device_progs = [p for p in progs if p.kind == "device"]
    host_progs = [p for p in progs if p.kind == "host"]
    popts = {p.name: resolve_opts(p, opts.get(p.name)) for p in progs}
    dev_acc = {p.name: p.init(d, dtype, popts[p.name], device) for p in device_progs}
    host_acc = {p.name: p.init(d, dtype, popts[p.name]) for p in host_progs}
    host_steps = {p.name: p.make_step(d, dtype, popts[p.name]) for p in host_progs}
    combined = _combined_step(device_progs, d, dtype, popts) if device_progs else None

    chunks, prep = _resolve_producer(factory())
    self_timed = prep is not None
    if prep is None:
        prep = {"s": 0.0, "iv": []}
    pin = on_card and combined is not None

    def prepared():
        """On the producer thread: pull a chunk (timed, unless the readers
        time their own decode) and copy its rows into pinned memory for the
        card's copy; a replayed tensor passes as it is."""
        it = iter(chunks)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            if self_timed:
                t0 = time.perf_counter()
            cX = item[0]
            if pin and not isinstance(cX, torch.Tensor):
                t = torch.empty(cX.shape, dtype=_tensor(cX[:0]).dtype, pin_memory=True)
                np.copyto(t.numpy(), cX)
                cX = t
            t1 = time.perf_counter()
            prep["s"] += t1 - t0
            prep["iv"].append((t0, t1))
            yield cX, item[1], item[2], (item[3] if len(item) > 3 else None)

    t0 = time.perf_counter()
    acc_s = 0.0
    acc_iv = []
    n_chunks = nbytes = offset = 0
    from ..resilience import maybe_inject

    for cX, cy, cw, goff in prefetch_iter(prepared(), _staging_depth()):
        # a failure here fails the whole pass; the retry starts it afresh
        maybe_inject("stat_program_step")
        ta = time.perf_counter()
        rows = int(cX.shape[0])
        if combined is not None:
            Xd = (cX if isinstance(cX, torch.Tensor) else _tensor(cX)).to(
                device, non_blocking=True)
            wd = None if cw is None else _tensor(np.asarray(cw, dtype)).to(device)
            yd = _tensor(np.asarray(cy, dtype)).to(device) if needs_y else None
            dev_acc = combined(dev_acc, Xd, wd, yd)
            del Xd, wd, yd
        if host_progs:
            # the sketches fold while the card runs the device steps
            Xh = _host_array(cX)
            w_host = cw if cw is not None else _weights_host(None, rows, rows, dtype)
            ctx = {"offset": offset if goff is None else int(goff),
                   "n_valid": int(np.count_nonzero(w_host > 0))}
            for p in host_progs:
                host_acc[p.name] = host_steps[p.name](host_acc[p.name], Xh, w_host, cy, ctx)
        if on_card and combined is not None:
            torch.cuda.current_stream(device).synchronize()
        tb = time.perf_counter()
        acc_s += tb - ta
        acc_iv.append((ta, tb))
        offset += rows
        n_chunks += 1
        nbytes += (int(cX.nbytes) + (int(cw.nbytes) if cw is not None else 0)
                   + (int(cy.nbytes) if needs_y and cy is not None else 0))

    folded: Dict[str, Dict[str, Any]] = {}
    for p in device_progs:
        folded[p.name] = acc_to_host_f64(dev_acc[p.name])
    folded.update(host_acc)
    wall = time.perf_counter() - t0

    ctx = {"d": d, "rows": offset, "quantiles": tuple(quantiles or ())}
    results = {p.name: p.finalize(folded[p.name], ctx) for p in progs}

    prep_iv = _merge_intervals(prep["iv"])
    overlap_s = _interval_overlap_s(prep_iv, acc_iv)
    overlap = 0.0
    if min(prep["s"], acc_s) > 1e-9:
        overlap = max(0.0, min(overlap_s / min(prep["s"], acc_s), 1.0))
    with _stat_metrics_lock:
        STAT_METRICS.clear()
        STAT_METRICS.update(
            stamp=round(time.time(), 3), label=label, programs=len(progs), passes=1,
            chunks=n_chunks, bytes=int(nbytes), wall_s=wall, host_prep_s=prep["s"],
            device_acc_s=acc_s, overlap_s=overlap_s, overlap_fraction=overlap,
            source=prep.get("source", "host"))
    logger.info(f"stat_programs[{label}]: programs={len(progs)} chunks={n_chunks} "
                f"{nbytes / 1e6:.1f}MB wall={wall:.2f}s overlap={overlap:.2f}")
    return results


def iter_chunk_accs(name: str, chunks: Iterable, d: int, dtype=np.float32,
                    opts: Optional[Dict[str, Any]] = None, offset0: int = 0,
                    device=None) -> Dict[str, Any]:
    """Fold an explicit chunk iterator through ONE program and return the
    host accumulator: the light entry of the streamed fits (the k-means
    seeding sample), where the caller owns the chunk loop.  Chunks are
    `(X, y, w, n_valid)` (streaming.py `iter_chunks`), the running row count
    from `offset0` giving each chunk's global row, or `(X, y, w, n_valid,
    offset)` (`iter_file_chunks`), which carry their own."""
    import torch

    from ..ops.stats import acc_to_host_f64
    from ..parallel.device_cache import _tensor
    from ..streaming import _weights_host
    from .programs import get_program, resolve_opts

    p = get_program(name)
    dtype = np.dtype(dtype)
    popts = resolve_opts(p, opts)
    if p.kind == "host":
        acc = p.init(d, dtype, popts)
        step = p.make_step(d, dtype, popts)
        offset = int(offset0)
        for item in chunks:
            cX, cy, cw, n_c = item[:4]
            at = int(item[4]) if len(item) > 4 else offset
            rows = int(cX.shape[0])
            w_host = np.asarray(_weights_host(cw, n_c, rows, dtype))
            acc = step(acc, _host_array(cX), w_host, cy, {"offset": at, "n_valid": int(n_c)})
            offset += n_c
        return acc
    from ..streaming import _device

    device = _device(device)
    acc = p.init(d, dtype, popts, device)
    step_w, _unw = p.make_step(d, dtype, popts)
    for item in chunks:
        cX, cy, cw, n_c = item[:4]
        rows = int(cX.shape[0])
        X = cX if isinstance(cX, torch.Tensor) else _tensor(np.asarray(cX, dtype))
        args = [X.to(device), _tensor(_weights_host(cw, n_c, rows, dtype)).to(device)]
        if p.needs_y:
            args.append(_tensor(np.asarray(cy, dtype)).to(device))
        acc = step_w(acc, *args)
    return acc_to_host_f64(acc)
