#
# The device-budget ledger and the chunk cache: the port of
# spark_rapids_ml_tpu/parallel/device_cache.py for one device.
#
#   the ledger     `device_data_budget_bytes` (the staging decisions' budget,
#                  core.py `_over_device_budget`), `cache_budget_bytes`, and
#                  `DeviceDatasetCache`: the resident datasets, the stagings
#                  in flight and the external claims (residency that is not
#                  a staged dataset, such as the chunk cache's device tier),
#                  which every budget decision counts (`cache_resident_bytes`).
#   the dataset    `get_or_stage` stages a CrossValidator run's dataset once
#   cache          (fingerprint-keyed, LRU-evicted, its reservation the
#                  arrays times a working factor for the fold views); a
#                  `FoldSet` derives each fold's rows on the device: a weight
#                  mask (`w * (fold_id != fold)`) for estimators whose kernels
#                  treat a zero-weight row as absent, else an `index_select`
#                  of the rows in their order, the tensors a fresh staging of
#                  the fold would give (one device has no staging layout or
#                  padding); `CachedEvalView` scores each model on the
#                  fold's gathered rows.  A staging that runs the card out
#                  of memory releases its reservation and the caller takes
#                  the legacy path (`torch.cuda.OutOfMemoryError` only).
#   ChunkCache     records the decoded chunks of a parquet scan the first
#                  time it runs and replays them for every later identical
#                  scan (keyed by the caller: the path's change stamp and
#                  every scan parameter), so only the first pass decodes:
#     device tier  a chunk's feature block as a CUDA tensor, a mirror of the
#                  host copy, while the ledger has FREE room
#                  (`reserve_external(evict=False)`); a `device_ok` consumer
#                  gets the cached tensor itself, with no copy.  A mirror
#                  that meets `torch.cuda.OutOfMemoryError` releases its
#                  claim, is counted (`device_oom_demotions`) and serves
#                  from the host tier; any other error reaches the caller;
#     host tier    read-only numpy arrays under `chunk_cache_host_bytes`; a
#                  feature block bound for the card that found no device
#                  room is kept in pinned memory, so a replay reaches the
#                  card by a `non_blocking` copy (fused.py `device_chunks`);
#     spill tier   LRU chunks through a codec (parallel/chunk_codec.py),
#                  crc32-checked when served again, in host memory or in
#                  files under `chunk_cache_spill_dir`.
#   Beyond the host budget a mirrored feature block first gives up its host
#   copy (the card holds it), then LRU chunks spill, then LRU streams are
#   dropped.  The JAX package keeps the host copy beside the mirror and
#   spills it; the port keeps a stream whose feature blocks are on the card
#   when the host budget is smaller than the stream (ROADMAP.md section 3).
#
# Lock order: the ChunkCache's lock, then the ledger's; never the other way.
#
from __future__ import annotations

import itertools
import os
import threading
import warnings
from typing import Any, Dict, List, Optional

import numpy as np

# ---------------------------------------------------------------------------
# The device-budget ledger
# ---------------------------------------------------------------------------

# The JAX package's `hbm_bytes` default, a TPU v5e's HBM: the port's budget
# on the CPU, so that routing there matches the JAX package's.
_JAX_HBM_BYTES = 16 * 1024 * 1024 * 1024

_metrics_lock = threading.RLock()


def _budget_device(device=None):
    import torch

    from .context import get_default_device

    return torch.device(device if device is not None else get_default_device())


def device_data_budget_bytes(device=None) -> float:
    """The bytes a staged dataset may take on `device` (default: the
    default device): `hbm_bytes` (when None: the card's memory on a card,
    the JAX package's 16 GiB on the CPU) times `mem_ratio_for_data`.  One
    device, where the JAX package multiplies by its device count."""
    from ..config import get_config

    hbm = get_config("hbm_bytes")
    if hbm is None:
        import torch

        dev = _budget_device(device)
        hbm = (torch.cuda.get_device_properties(dev).total_memory
               if dev.type == "cuda" and torch.cuda.is_available() else _JAX_HBM_BYTES)
    return float(hbm) * float(get_config("mem_ratio_for_data"))


def cache_budget_bytes(device=None) -> float:
    """The ledger's budget: `device_cache_bytes` when set, else
    `device_data_budget_bytes`."""
    from ..config import get_config

    explicit = int(get_config("device_cache_bytes"))
    return float(explicit) if explicit > 0 else device_data_budget_bytes(device)


# ---------------------------------------------------------------------------
# The stage-once dataset cache
# ---------------------------------------------------------------------------

# Cumulative counters of the dataset registry (mirrored into
# mesh.STAGE_COUNTS as cache_<kind>): read by tests and chip_smoke.py.
CACHE_METRICS: Dict[str, int] = {
    "hits": 0,
    "misses": 0,
    "evictions": 0,
    "inserts": 0,
    # stagings that met torch.cuda.OutOfMemoryError (the caller then takes
    # the legacy path)
    "staging_ooms": 0,
    "resident_bytes": 0,
    "resident_entries": 0,
}

# What the last `get_or_stage` decided ("hit", "staged", "over_budget",
# "hit_over_budget", "oom"), its bytes and the seconds of its fingerprint and
# staging (and of the extraction before it, `_cached_fit_entry`), for
# CrossValidator's fit report.
LAST_DECISION: Dict[str, Any] = {}


def _note(kind: str) -> None:
    from .mesh import note_stage_count

    with _metrics_lock:
        CACHE_METRICS[kind] = CACHE_METRICS.get(kind, 0) + 1
    note_stage_count("cache_" + kind)


def cache_enabled() -> bool:
    from ..config import get_config

    return str(get_config("device_cache")).lower() == "on"


# above this an array's bytes are hashed in blocks of this size on a thread
# pool (hashlib gives up the GIL), and the blocks' digests in order
_HASH_BLOCK_BYTES = 64 * 1024 * 1024


def _hash_array(h, arr: Optional[np.ndarray]) -> None:
    """Add an array to the digest `h`: shape, dtype and every byte of its
    content.  The JAX package hashes a large 2-D array's strided row sample
    and a projection of each row instead; hashing every byte, blocks in
    parallel, costs less than that projection in float64, and no edit of a
    row outside the sample can keep the key."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    if arr is None:
        h.update(b"<none>")
        return
    arr = np.ascontiguousarray(arr)
    h.update(str(arr.shape).encode())
    h.update(str(arr.dtype).encode())
    buf = memoryview(arr.reshape(-1).view(np.uint8))
    if arr.nbytes <= _HASH_BLOCK_BYTES:
        h.update(buf)
        return
    starts = range(0, arr.nbytes, _HASH_BLOCK_BYTES)
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        for digest in pool.map(
                lambda s: hashlib.sha256(buf[s:s + _HASH_BLOCK_BYTES]).digest(), starts):
            h.update(digest)


def dataset_fingerprint(X: np.ndarray, y: Optional[np.ndarray],
                        weight: Optional[np.ndarray], dtype, label_dtype, device) -> str:
    """The key of a cache entry: the host arrays' content, the staged
    dtypes and the device (the JAX package keys its mesh's devices and its
    shape-bucketing conf, which one device does not have)."""
    import hashlib

    h = hashlib.blake2b(digest_size=20)
    _hash_array(h, X)
    _hash_array(h, y)
    _hash_array(h, weight)
    h.update(str(np.dtype(dtype)).encode())
    h.update(str(np.dtype(label_dtype) if label_dtype is not None else None).encode())
    h.update(str(device).encode())
    return h.hexdigest()


class CacheEntry:
    """A dataset resident on the device (`dataset`, a DeviceDataset) and
    the fold views derived from it.  Fold state lives in each run's
    `FoldSet`, not here, so two runs sharing an entry keep their own
    folds.  `nbytes` is the reservation (the arrays times the working
    factor), `base_bytes` the arrays alone."""

    def __init__(self, fingerprint: str, dataset, nbytes: int,
                 base_bytes: Optional[int] = None) -> None:
        self.fingerprint = fingerprint
        self.dataset = dataset
        self.nbytes = int(nbytes)
        self.base_bytes = int(base_bytes if base_bytes is not None else nbytes)
        self.last_used = 0

    def fold_set(self, folds: np.ndarray) -> "FoldSet":
        """The fold id of each row (int32, the rows' own order; one device
        has no padding rows to mark) on the device, and the run's handle
        to its views."""
        import torch

        folds = np.ascontiguousarray(np.asarray(folds, np.int32))
        if folds.shape[0] != self.dataset.n_valid:
            raise ValueError(f"fold array has {folds.shape[0]} rows, dataset has "
                             f"{self.dataset.n_valid}")
        fold_dev = torch.from_numpy(folds).to(self.dataset.device)
        return FoldSet(self, folds, fold_dev)

    def _gather_view(self, sel: np.ndarray, what: str):
        """The rows selected by boolean `sel`, in their order, gathered on
        the device (`index_select`) into a new DeviceDataset: the tensors a
        fresh staging of those host rows would give.  Only the int64 row
        ids cross from the host."""
        import torch

        from ..data import DeviceDataset

        ds = self.dataset
        rows = np.flatnonzero(sel)
        if rows.size == 0:
            raise ValueError(f"{what} selects no rows")
        idx = torch.from_numpy(rows.astype(np.int64)).to(ds.device)
        return DeviceDataset(
            ds.device, ds.X.index_select(0, idx), rows.size,
            y=None if ds.y is None else ds.y.index_select(0, idx),
            weight=ds.weight.index_select(0, idx))


class FoldSet:
    """One CV run's fold assignment against a cache entry."""

    def __init__(self, entry: CacheEntry, folds: np.ndarray, fold_dev) -> None:
        self.entry = entry
        self.folds = folds  # host (n,) int32
        self.fold_dev = fold_dev  # the same on the device

    def train_view(self, fold: int):
        """The weight-mask train view: the resident X and y, and the
        weights times (fold id != fold).  For estimators whose kernels treat
        a zero-weight row as absent (`_supports_fold_weights`)."""
        from ..data import DeviceDataset

        ds = self.entry.dataset
        w = ds.weight * (self.fold_dev != int(fold)).to(ds.weight.dtype)
        return DeviceDataset(ds.device, ds.X, ds.n_valid, y=ds.y, weight=w)

    def gather_train_view(self, fold: int):
        """The gathered train view: the rows outside `fold`, equal to a
        fresh staging of the fold's host slice, for estimators whose fit
        depends on the row count (seeded draws per row)."""
        return self.entry._gather_view(self.folds != fold, f"train fold {fold}")

    def eval_view(self, fold: int, eval_df) -> "CachedEvalView":
        """The fold's evaluation rows (`eval_df`: their host frame, for the
        evaluator's label and weight columns)."""
        sel = np.asarray(self.folds == fold)
        if not sel.any():
            raise ValueError(f"fold {fold} has no validation rows")
        return CachedEvalView(self.entry, fold, sel, eval_df)


class CachedEvalView:
    """`_transformEvaluate` input backed by a cache entry: the fold's rows
    are gathered on the device once, each model's `_transform_device` runs
    over them, and only the output columns come back, in the eval frame's
    row order.  A model without `_transform_device` transforms the fold's
    host rows instead."""

    def __init__(self, entry: CacheEntry, fold: int, sel: np.ndarray, eval_df) -> None:
        self.entry = entry
        self.fold = int(fold)
        self.sel = sel
        self.eval_df = eval_df
        self._view = None  # gathered on first use

    def _eval_rows(self):
        if self._view is None:
            self._view = self.entry._gather_view(self.sel, f"eval fold {self.fold}")
        return self._view

    def evaluate(self, models: List[Any], evaluator: Any) -> List[float]:
        return [self._evaluate_one(m, evaluator) for m in models]

    def _evaluate_one(self, model: Any, evaluator: Any) -> float:
        import pandas as pd

        from ..core import _TpuModel
        from .mesh import RowStager

        if type(model)._transform_device is _TpuModel._transform_device:
            return evaluator.evaluate(model.transform(self.eval_df))
        view = self._eval_rows()
        outs = model._fetch_transform_outputs(RowStager(view.n_valid, view.device),
                                              model._transform_device(view.X))
        cols = {c: list(v) if v.ndim == 2 else v for c, v in outs.items()}
        base = self.eval_df.drop(columns=[c for c in cols if c in self.eval_df.columns])
        out_df = pd.concat([base.reset_index(drop=True), pd.DataFrame(cols)], axis=1)
        return evaluator.evaluate(out_df)


class DeviceDatasetCache:
    """The device-budget ledger: a fingerprint-keyed LRU registry of
    resident datasets, reservations of stagings in flight, and external
    claims (tag -> bytes: residency that is not a staged dataset, such as
    the chunk cache's device tier) that every budget comparison counts and
    that only their owner releases."""

    def __init__(self) -> None:
        self._mu = threading.RLock()
        self._entries: Dict[str, CacheEntry] = {}
        self._clock = 0
        self._pending = 0
        self._external: Dict[str, int] = {}

    def lookup(self, fingerprint: str) -> Optional[CacheEntry]:
        with self._mu:
            entry = self._entries.get(fingerprint)
            if entry is None:
                return None
            self._clock += 1
            entry.last_used = self._clock
        _note("hits")
        return entry

    def resident_bytes(self) -> int:
        with self._mu:
            return sum(e.nbytes for e in self._entries.values())

    def claimed_bytes(self) -> int:
        """The bytes every budget comparison must see: resident entries,
        reservations in flight and external claims."""
        with self._mu:
            return self.resident_bytes() + self._pending + sum(self._external.values())

    def _evict_lru(self) -> bool:
        with self._mu:
            if not self._entries:
                return False
            self.evict(min(self._entries, key=lambda k: self._entries[k].last_used))
            return True

    def evict(self, fingerprint: str) -> None:
        """Drop the registry's claim; a run that holds the entry's views
        keeps them (the tensors free with their last reference)."""
        with self._mu:
            entry = self._entries.pop(fingerprint, None)
        if entry is None:
            return
        _note("evictions")
        self._sync_metrics()

    def reserve(self, need_bytes: int) -> bool:
        """Claim room for a staging, evicting LRU entries as needed; False
        when it cannot fit even with the registry empty."""
        budget = cache_budget_bytes()
        if need_bytes > budget:
            return False
        with self._mu:
            while self.claimed_bytes() + need_bytes > budget:
                if not self._evict_lru():
                    break
            if self.claimed_bytes() + need_bytes > budget:
                return False
            self._pending += int(need_bytes)
            return True

    def release(self, need_bytes: int) -> None:
        """Drop the reservation of a staging that failed."""
        with self._mu:
            self._pending = max(0, self._pending - int(need_bytes))

    def top_up(self, entry: CacheEntry, extra: int) -> bool:
        """Grow a just-looked-up entry's reservation by `extra`, evicting
        other entries (never this one) as needed; False when it cannot."""
        budget = cache_budget_bytes()
        with self._mu:
            while self.claimed_bytes() + extra > budget and len(self._entries) > 1:
                if not self._evict_lru():
                    break
            if entry.fingerprint not in self._entries:
                return False
            if self.claimed_bytes() + extra > budget:
                return False
            entry.nbytes += int(extra)
        self._sync_metrics()
        return True

    def insert(self, entry: CacheEntry) -> None:
        """Register a staged entry; its reservation becomes the entry's."""
        with self._mu:
            self._clock += 1
            entry.last_used = self._clock
            self._entries[entry.fingerprint] = entry
            self._pending = max(0, self._pending - entry.nbytes)
        _note("inserts")
        self._sync_metrics()

    def clear(self) -> None:
        with self._mu:
            fps = list(self._entries)
        for fp in fps:
            self.evict(fp)

    def _sync_metrics(self) -> None:
        with self._mu:
            resident, count = self.resident_bytes(), len(self._entries)
        with _metrics_lock:
            CACHE_METRICS["resident_bytes"] = resident
            CACHE_METRICS["resident_entries"] = count

    def reserve_external(self, tag: str, need_bytes: int, evict: bool = True) -> bool:
        """Book `need_bytes` for `tag` (a repeat claim for the same tag
        replaces the old one), evicting LRU dataset entries for room when
        `evict`.  False when the budget cannot hold it; the old claim then
        stays.  The chunk cache claims with `evict=False` (free room only:
        it never displaces a dataset)."""
        budget = cache_budget_bytes()
        need_bytes = int(need_bytes)
        with self._mu:
            extra = need_bytes - self._external.get(tag, 0)
            if extra > budget:
                return False
            while evict and self.claimed_bytes() + extra > budget:
                if not self._evict_lru():
                    break
            if self.claimed_bytes() + extra > budget:
                return False
            self._external[tag] = need_bytes
        return True

    def release_external(self, tag: str) -> int:
        """Drop a claim; the bytes freed (0 for an unknown tag)."""
        with self._mu:
            return self._external.pop(tag, 0)

    def release_external_many(self, tags) -> int:
        """Drop several claims under one lock; the bytes freed."""
        with self._mu:
            return sum(self._external.pop(tag, 0) for tag in tags)

    def external_shortfall(self, tag: str, need_bytes: int) -> int:
        """The bytes that must be freed elsewhere before
        `reserve_external(tag, need_bytes)` can succeed (0: it fits)."""
        budget = cache_budget_bytes()
        with self._mu:
            extra = int(need_bytes) - self._external.get(tag, 0)
            return int(max(0, self.claimed_bytes() + extra - budget))

    def external_bytes(self) -> int:
        with self._mu:
            return sum(self._external.values())


_global_cache: Optional[DeviceDatasetCache] = None
_global_lock = threading.Lock()


def get_device_cache() -> DeviceDatasetCache:
    global _global_cache
    with _global_lock:
        if _global_cache is None:
            _global_cache = DeviceDatasetCache()
        return _global_cache


def clear_device_cache() -> None:
    """Release every resident dataset entry; external claims stay."""
    if _global_cache is not None:
        _global_cache.clear()


def reserve_external(tag: str, need_bytes: int) -> bool:
    return get_device_cache().reserve_external(tag, need_bytes)


def release_external(tag: str) -> int:
    return 0 if _global_cache is None else _global_cache.release_external(tag)


def release_external_many(tags) -> int:
    return 0 if _global_cache is None else _global_cache.release_external_many(tags)


def cache_resident_bytes() -> int:
    """The bytes the ledger holds (entries, reservations, external claims),
    added to every `_over_device_budget` estimate (core.py) so that staging
    decisions see the device memory the caches occupy."""
    return _global_cache.claimed_bytes() if _global_cache is not None else 0


def evict_to_fit(need_bytes: float, budget: float) -> None:
    """Evict LRU dataset entries until `need_bytes` fits under `budget`
    beside what stays claimed: residency can be staged again, so a fit's
    budget decision does not give way to it."""
    if _global_cache is None:
        return
    cache = _global_cache
    while cache.resident_bytes() and need_bytes + cache.claimed_bytes() > budget:
        if not cache._evict_lru():
            break


def get_or_stage(X: np.ndarray, y: Optional[np.ndarray], weight: Optional[np.ndarray],
                 dtype, label_dtype=None, device=None, logger=None,
                 working_factor: float = 1.0) -> Optional[CacheEntry]:
    """The resident entry for this dataset, staged once on a miss; None
    (the caller's legacy path) when the reservation, the arrays' bytes
    times `working_factor` (room for the fold views), does not fit the
    budget, or when the staging runs the card out of memory
    (`torch.cuda.OutOfMemoryError` only: the reservation is released; any
    other error reaches the caller).  A hit tops the entry's reservation up
    to this caller's factor, or is None when that does not fit."""
    import torch

    from ..data import DeviceDataset
    from .context import resolve_device
    from .mesh import RowStager

    import time

    dtype = np.dtype(dtype)
    device = resolve_device(device)
    t0 = time.perf_counter()
    fp = dataset_fingerprint(X, y, weight, dtype, label_dtype, device)
    t_fp = time.perf_counter() - t0
    cache = get_device_cache()
    factor = max(float(working_factor), 1.0)
    entry = cache.lookup(fp)
    LAST_DECISION.clear()
    LAST_DECISION["fingerprint_s"] = t_fp
    if entry is not None:
        want = int(entry.base_bytes * factor)
        ok = want <= entry.nbytes or cache.top_up(entry, want - entry.nbytes)
        LAST_DECISION.update(outcome="hit" if ok else "hit_over_budget",
                             need_bytes=entry.base_bytes, reserved_bytes=want,
                             budget_bytes=cache_budget_bytes())
        if not ok:
            _note("misses")
            return None
        return entry
    ldt = np.dtype(label_dtype) if label_dtype is not None else dtype
    row_bytes = int(X.shape[1]) * dtype.itemsize + dtype.itemsize
    if y is not None:
        row_bytes += ldt.itemsize
    need = int(X.shape[0]) * row_bytes
    reserved = int(need * factor)
    LAST_DECISION.update(need_bytes=need, reserved_bytes=reserved,
                         budget_bytes=cache_budget_bytes())
    _note("misses")
    if not cache.reserve(reserved):
        LAST_DECISION["outcome"] = "over_budget"
        if logger is not None:
            logger.info(f"device cache: dataset (~{need / 2**20:.0f} MiB, reserving "
                        f"{reserved / 2**20:.0f}) beyond the cache budget; legacy path")
        return None
    st = RowStager(X.shape[0], device)
    t0 = time.perf_counter()
    try:
        Xs = st.stage(X, dtype)
        w = st.mask(dtype, weights=weight)
        yd = None if y is None else st.stage(np.asarray(y).reshape(-1).astype(ldt), ldt)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except BaseException as e:
        cache.release(reserved)
        if not isinstance(e, torch.cuda.OutOfMemoryError):
            raise
        _note("staging_ooms")
        LAST_DECISION["outcome"] = "oom"
        if logger is not None:
            logger.warning("device cache: staging ran the card out of memory; legacy path")
        return None
    LAST_DECISION["stage_s"] = time.perf_counter() - t0
    entry = CacheEntry(fp, DeviceDataset(device, Xs, st.n_valid, y=yd, weight=w),
                       reserved, base_bytes=need)
    cache.insert(entry)
    LAST_DECISION["outcome"] = "staged"
    return entry


# ---------------------------------------------------------------------------
# The chunk cache
# ---------------------------------------------------------------------------

CHUNK_METRICS: Dict[str, int] = {
    "hits": 0,
    "misses": 0,
    "inserts": 0,
    "spills": 0,
    "restores": 0,
    "evictions": 0,
    "invalidations": 0,
    "checksum_failures": 0,
    # mirrors that met torch.cuda.OutOfMemoryError and served from the host
    "device_oom_demotions": 0,
    # mirrored feature blocks whose host copy left the host budget
    "host_releases": 0,
    "hit_bytes": 0,
    "host_bytes": 0,
    "pinned_bytes": 0,
    "spilled_bytes": 0,
    "device_bytes": 0,
    "streams_complete": 0,
}

# the tier sizes: gauges, not counters (fit_report reports them as they are)
CHUNK_GAUGES = ("host_bytes", "pinned_bytes", "spilled_bytes", "device_bytes")

_CHUNK_TAG = "chunk_cache"


class ChunkIntegrityError(RuntimeError):
    """A spilled chunk failed its crc32 (or its codec) when served again."""


def chunk_cache_enabled() -> bool:
    from ..config import get_config

    return str(get_config("chunk_cache")).lower() == "on"


def chunk_cache_host_budget() -> int:
    from ..config import get_config

    return int(get_config("chunk_cache_host_bytes"))


def _chunk_note(kind: str, amount: int = 1) -> None:
    with _metrics_lock:
        CHUNK_METRICS[kind] = CHUNK_METRICS.get(kind, 0) + int(amount)


def chunk_metrics_snapshot() -> Dict[str, int]:
    with _metrics_lock:
        return dict(CHUNK_METRICS)


_spill_seq = itertools.count()


def _spill_file_path(spill_dir: str, crc: int) -> str:
    """A spill file name that cannot collide under a shared directory: the
    process rank (0: one process) and pid, a per-process sequence number
    and the content crc."""
    os.makedirs(spill_dir, exist_ok=True)
    fname = f"srmt-chunk-p0-{os.getpid()}-{next(_spill_seq)}-{crc & 0xFFFFFFFF:08x}.spill"
    return os.path.join(spill_dir, fname)


class _SpilledArray:
    """One array in the spill tier: a compressed blob in host memory, or a
    file under `chunk_cache_spill_dir` (`blob` None, `path` set)."""

    __slots__ = ("codec", "blob", "path", "nbytes", "dtype_str", "shape", "crc", "raw_nbytes")

    def __init__(self, codec, blob, dtype_str, shape, crc, raw_nbytes, path=None, nbytes=None):
        self.codec = codec
        self.blob = blob
        self.path = path
        self.nbytes = len(blob) if blob is not None else int(nbytes)
        self.dtype_str = dtype_str
        self.shape = shape
        self.crc = crc
        self.raw_nbytes = int(raw_nbytes)


def _tensor(a: np.ndarray):
    """A CPU tensor over a numpy array's memory (read-only arrays included:
    the tensor is only ever read)."""
    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


def _is_cuda(device) -> bool:
    return device is not None and getattr(device, "type", str(device).split(":")[0]) == "cuda"


def _lives_on(t, device) -> bool:
    """Whether tensor `t` is on `device` (None: no device consumer)."""
    import torch

    if device is None:
        return False
    device = torch.device(device)
    return t.device.type == device.type and device.index in (None, t.device.index)


_side_streams: Dict[Any, Any] = {}


def _mirror(host: np.ndarray, device):
    """A CUDA copy of a host array, complete when returned.  The copy runs
    on a stream of the cache's own, so that it does not wait for the
    consumer's work on the current stream."""
    import torch

    device = torch.device(device)
    with _metrics_lock:
        stream = _side_streams.get(device)
        if stream is None:
            stream = _side_streams[device] = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        dev = _tensor(host).to(device, non_blocking=True)
    stream.synchronize()
    return dev


def _pin(host: np.ndarray):
    """(pinned CPU tensor, its read-only numpy view) holding a copy of
    `host`: allocated once, when the chunk is recorded."""
    import torch

    t = torch.empty(host.shape, dtype=_tensor(host[:0]).dtype, pin_memory=True)
    view = t.numpy()
    np.copyto(view, host)
    view.setflags(write=False)
    return t, view


class _ChunkArray:
    """One array of a cached chunk: host (read-only numpy; for a pinned
    feature block the view of `pinned`), a device mirror of it (`dev`,
    feature blocks only), or spilled."""

    __slots__ = ("host", "pinned", "dev", "spill")

    def __init__(self, host, pinned=None) -> None:
        self.host = host
        self.pinned = pinned
        self.dev = None
        self.spill = None

    def host_nbytes(self) -> int:
        return int(self.host.nbytes) if self.host is not None else 0

    def pinned_nbytes(self) -> int:
        return int(self.pinned.nbytes) if self.pinned is not None else 0

    def spill_nbytes(self) -> int:
        return self.spill.nbytes if self.spill is not None else 0

    def dev_nbytes(self) -> int:
        return int(self.dev.nbytes) if self.dev is not None else 0

    def drop_host(self) -> int:
        """Release the host copy; the host bytes freed."""
        freed = self.host_nbytes()
        self.host = None
        self.pinned = None
        return freed


class CachedChunk:
    """One yielded tuple of a cached stream: `layout` interleaves ("v",
    value) pass-through elements (None, row counts, the global row) with
    ("a", _ChunkArray) elements, in the tuple's order."""

    __slots__ = ("layout", "last_used")

    def __init__(self, layout) -> None:
        self.layout = layout
        self.last_used = 0

    def arrays(self):
        return [v for kind, v in self.layout if kind == "a"]


class _ChunkStream:
    __slots__ = ("key", "chunks", "complete", "dropped", "serving")

    def __init__(self, key) -> None:
        self.key = key
        self.chunks: List[CachedChunk] = []
        self.complete = False
        self.dropped = False
        self.serving = 0  # active serves: pins the stream against eviction


class ChunkCache:
    """Registry of cached chunk streams with tiered residency.  The tier
    byte totals are kept incrementally on every transition."""

    def __init__(self) -> None:
        self._mu = threading.RLock()
        self._streams: Dict[Any, _ChunkStream] = {}
        self._clock = 0
        self._host_b = 0  # host-resident array bytes (pinned included)
        self._pinned_b = 0  # of which pinned
        self._spill_b = 0  # in-memory spill blobs
        self._spill_disk_b = 0  # spill files
        self._dev_total = 0  # bytes booked in the ledger

    # -- accounting ----------------------------------------------------------

    @property
    def _host_total(self) -> int:
        """Bytes counted against `chunk_cache_host_bytes`: host arrays and
        in-memory spill blobs (spill files live on disk)."""
        return self._host_b + self._spill_b

    def _touch_locked(self, chunk: CachedChunk) -> None:
        self._clock += 1
        chunk.last_used = self._clock

    def _account_locked(self, host_delta: int = 0, spill_delta: int = 0, disk_delta: int = 0,
                        pinned_delta: int = 0) -> None:
        self._host_b = max(0, self._host_b + int(host_delta))
        self._pinned_b = max(0, self._pinned_b + int(pinned_delta))
        self._spill_b = max(0, self._spill_b + int(spill_delta))
        self._spill_disk_b = max(0, self._spill_disk_b + int(disk_delta))
        self._sync_bytes_locked()

    def _sync_bytes_locked(self) -> None:
        with _metrics_lock:
            CHUNK_METRICS["host_bytes"] = self._host_b
            CHUNK_METRICS["pinned_bytes"] = self._pinned_b
            CHUNK_METRICS["spilled_bytes"] = self._spill_b + self._spill_disk_b
            CHUNK_METRICS["device_bytes"] = self._dev_total

    def _book_dev_locked(self, delta: int) -> bool:
        """Grow or shrink the cache's claim in the ledger; growth claims
        free room only (`evict=False`)."""
        new = self._dev_total + int(delta)
        ledger = get_device_cache()
        if delta > 0:
            if not ledger.reserve_external(_CHUNK_TAG, new, evict=False):
                return False
        elif new <= 0:
            ledger.release_external(_CHUNK_TAG)
            new = 0
        else:
            ledger.reserve_external(_CHUNK_TAG, new)  # a shrink always fits
        self._dev_total = new
        return True

    def _try_mirror_locked(self, ca: _ChunkArray, device) -> bool:
        """Mirror a host array onto the card when the ledger has free room.
        Only `torch.cuda.OutOfMemoryError` is caught: the claim is released,
        counted, and the array stays in the host tier.  Any other error
        releases the claim and reaches the caller."""
        import torch

        nbytes = ca.host_nbytes()
        if not self._book_dev_locked(nbytes):
            return False
        try:
            ca.dev = _mirror(ca.host, device)
        except torch.cuda.OutOfMemoryError:
            self._book_dev_locked(-nbytes)
            _chunk_note("device_oom_demotions")
            return False
        except BaseException:
            self._book_dev_locked(-nbytes)
            raise
        return True

    # -- tier transitions ----------------------------------------------------

    def _spill_chunk_locked(self, chunk: CachedChunk) -> None:
        """Move every host array of `chunk` into the spill tier (compressed,
        checksummed).  A device-only array stays on the card: it costs no
        host bytes."""
        from ..config import get_config
        from .chunk_codec import checksum, resolve_codec

        name, compress, _ = resolve_codec(get_config("chunk_cache_codec"))
        spill_dir = str(get_config("chunk_cache_spill_dir") or "")
        freed_dev = host_delta = pinned_delta = spill_delta = disk_delta = 0
        for a in chunk.arrays():
            if a.spill is not None or a.host is None:
                continue
            arr = np.ascontiguousarray(a.host)
            raw = arr.tobytes()
            blob = compress(raw)
            crc = checksum(raw)
            if spill_dir:
                path = _spill_file_path(spill_dir, crc)
                with open(path, "wb") as f:
                    f.write(blob)
                a.spill = _SpilledArray(name, None, arr.dtype.str, arr.shape, crc, len(raw),
                                        path=path, nbytes=len(blob))
                disk_delta += a.spill.nbytes
            else:
                a.spill = _SpilledArray(name, blob, arr.dtype.str, arr.shape, crc, len(raw))
                spill_delta += a.spill.nbytes
            if a.dev is not None:
                freed_dev += a.dev_nbytes()
                a.dev = None
            pinned_delta -= a.pinned_nbytes()
            host_delta -= a.drop_host()
        if freed_dev:
            self._book_dev_locked(-freed_dev)
        self._account_locked(host_delta, spill_delta, disk_delta, pinned_delta)
        _chunk_note("spills")

    def _restore_array_locked(self, a: _ChunkArray) -> np.ndarray:
        """A spilled array back as a read-only ndarray, crc-checked.  It is
        not put back into the host tier: a working set beyond the host
        budget would thrash."""
        from .chunk_codec import checksum, resolve_codec

        sp = a.spill
        _, _, decompress = resolve_codec(sp.codec)
        blob = sp.blob
        if blob is None:
            try:
                with open(sp.path, "rb") as f:
                    blob = f.read()
            except OSError as e:
                _chunk_note("checksum_failures")
                raise ChunkIntegrityError(f"spill file unreadable ({sp.path}): {e}") from e
        try:
            raw = decompress(blob)
        except Exception as e:
            # a torn blob can fail the codec before the crc runs
            _chunk_note("checksum_failures")
            raise ChunkIntegrityError(
                f"spilled chunk failed to decompress (codec={sp.codec}): {e}") from e
        if checksum(raw) != sp.crc:
            _chunk_note("checksum_failures")
            raise ChunkIntegrityError(
                f"spilled chunk failed crc32 (codec={sp.codec}, {len(raw)} bytes)")
        _chunk_note("restores")
        return np.frombuffer(raw, dtype=np.dtype(sp.dtype_str)).reshape(sp.shape)

    def _drop_stream_locked(self, st: _ChunkStream, reason: str) -> None:
        if st.dropped:
            return
        st.dropped = True
        freed_dev = host_delta = pinned_delta = spill_delta = disk_delta = 0
        for c in st.chunks:
            for a in c.arrays():
                freed_dev += a.dev_nbytes()
                pinned_delta -= a.pinned_nbytes()
                host_delta -= a.host_nbytes()
                if a.spill is not None and a.spill.path is not None:
                    disk_delta -= a.spill.nbytes
                    try:
                        os.unlink(a.spill.path)
                    except OSError:
                        pass
                else:
                    spill_delta -= a.spill_nbytes()
                a.dev = a.host = a.pinned = a.spill = None
        st.chunks = []
        if self._streams.get(st.key) is st:
            self._streams.pop(st.key)
        if freed_dev:
            self._book_dev_locked(-freed_dev)
        self._account_locked(host_delta, spill_delta, disk_delta, pinned_delta)
        _chunk_note("evictions")

    def _shrink_locked(self, protect: Optional[_ChunkStream]) -> None:
        """Hold the host tiers under `chunk_cache_host_bytes`: LRU mirrored
        feature blocks give up their host copies, then LRU chunks spill
        (while spilling frees bytes), then LRU streams that hold host-tier
        bytes are dropped.  `protect`, the stream being filled, goes last (a
        stream larger than the whole budget), and a stream being served is
        never dropped."""
        budget = chunk_cache_host_budget()
        while self._host_total > budget:
            victim = None
            for st in self._streams.values():
                for c in st.chunks:
                    if any(a.dev is not None and a.host is not None for a in c.arrays()):
                        if victim is None or c.last_used < victim.last_used:
                            victim = c
            if victim is None:
                break
            freed = pinned = 0
            for a in victim.arrays():
                if a.dev is not None and a.host is not None:
                    pinned += a.pinned_nbytes()
                    freed += a.drop_host()
            self._account_locked(host_delta=-freed, pinned_delta=-pinned)
            _chunk_note("host_releases")
        spills_help = True
        while self._host_total > budget:
            victim = None
            if spills_help:
                for st in self._streams.values():
                    for c in st.chunks:
                        if any(a.host is not None for a in c.arrays()):
                            if victim is None or c.last_used < victim.last_used:
                                victim = c
            if victim is not None:
                before = self._host_total
                self._spill_chunk_locked(victim)
                if self._host_total < before:
                    continue
                # codec "none" spills byte for byte: go to dropping streams
                spills_help = False
            # only a stream that holds host-tier bytes frees any by going
            streams = [s for s in self._streams.values()
                       if s is not protect and s.serving == 0 and _holds_host(s)]
            if not streams and protect is not None and protect.serving == 0:
                streams = [protect]
            if not streams:
                return  # everything pinned by a serve: over budget for now
            lru = min(streams, key=lambda s: min((c.last_used for c in s.chunks), default=0))
            self._drop_stream_locked(lru, "host_budget")

    # -- insert / serve ------------------------------------------------------

    def _insert(self, st: _ChunkStream, item: tuple, device_elem: Optional[int],
                serve_device: bool, device):
        """Record one yielded tuple; returns the tuple to hand the consumer:
        the host arrays made read-only (a consumer that writes into one
        fails loudly instead of corrupting later epochs), and for a
        `serve_device` consumer the feature block's device mirror, or its
        pinned copy when the ledger had no room."""
        layout = []
        served = []
        host_bytes = 0
        for part in item:
            if isinstance(part, np.ndarray):
                a = np.ascontiguousarray(part)
                if a is part and a.flags.writeable:
                    a = a.view()  # the producer's own array stays writable
                a.setflags(write=False)
                layout.append(("a", _ChunkArray(a)))
                served.append(a)
                host_bytes += a.nbytes
            else:
                layout.append(("v", part))
                served.append(part)
        chunk = CachedChunk(tuple(layout))
        pinned_bytes = 0
        with self._mu:
            if st.dropped:
                return tuple(served)
            st.chunks.append(chunk)
            self._touch_locked(chunk)
            if device_elem is not None and _is_cuda(device):
                kind, ca = chunk.layout[device_elem]
                if kind == "a":
                    if self._try_mirror_locked(ca, device):
                        if serve_device:
                            served[device_elem] = ca.dev
                    else:
                        ca.pinned, ca.host = _pin(ca.host)
                        pinned_bytes = ca.pinned_nbytes()
                        if serve_device:
                            served[device_elem] = ca.pinned
            self._account_locked(host_delta=host_bytes, pinned_delta=pinned_bytes)
            self._shrink_locked(protect=st)
        _chunk_note("inserts")
        return tuple(served)

    def _serve_chunk_locked(self, chunk: CachedChunk, serve_device: bool, device) -> tuple:
        out = []
        nbytes = 0
        first_arr = True
        for kind, v in chunk.layout:
            if kind == "v":
                out.append(v)
                continue
            if (serve_device and first_arr and v.dev is None and v.host is not None
                    and _is_cuda(device)):
                # a stream first filled by a host-only consumer mirrors its
                # feature blocks the first time a device consumer replays it
                self._try_mirror_locked(v, device)
                self._sync_bytes_locked()
            first_arr = False
            if serve_device and v.dev is not None and _lives_on(v.dev, device):
                out.append(v.dev)
                nbytes += v.dev_nbytes()
            elif serve_device and v.pinned is not None:
                out.append(v.pinned)
                nbytes += v.pinned_nbytes()
            elif v.host is not None:
                out.append(v.host)
                nbytes += v.host_nbytes()
            elif v.dev is not None:
                host = v.dev.cpu().numpy()
                host.setflags(write=False)
                out.append(host)
                nbytes += v.dev_nbytes()
            else:
                arr = self._restore_array_locked(v)
                out.append(arr)
                nbytes += arr.nbytes
        self._touch_locked(chunk)
        _chunk_note("hit_bytes", nbytes)
        return tuple(out)

    def stream_complete(self, key) -> Optional[int]:
        """The chunk count of a fully cached stream, else None: what the
        DuHL sampler checks before it selects."""
        with self._mu:
            st = self._streams.get(key)
            if st is not None and st.complete and not st.dropped:
                return len(st.chunks)
            return None

    def stream(self, key, source_factory, device_elem: Optional[int] = None,
               serve_device: bool = False, select=None, ordered: bool = True, device=None):
        """Serve the stream for `key` from the cache when it is complete,
        else run `source_factory()` and record it in passing ("fill").  A
        stream another iteration is still filling is read from the source
        ("bypass").  `select` (a set of positions) serves only those chunks
        of a complete stream.  `ordered=False` says the source's chunk order
        differs from run to run (the parallel range readers): a chunk that
        cannot be served mid-replay then raises `ChunkIntegrityError`
        instead of resuming from the source by position.  `device` is where
        the device tier mirrors (None: no device tier)."""
        with self._mu:
            st = self._streams.get(key)
            if st is not None and st.complete and not st.dropped:
                mode = "serve"
                st.serving += 1
            elif st is None:
                st = _ChunkStream(key)
                self._streams[key] = st
                mode = "fill"
            else:
                mode = "bypass"
        if mode == "bypass":
            yield from _select_iter(source_factory(), select)
            return
        if mode == "serve":
            _chunk_note("hits")
            try:
                yield from self._serve(st, source_factory, serve_device, select, ordered, device)
            finally:
                with self._mu:
                    st.serving = max(0, st.serving - 1)
            return
        _chunk_note("misses")
        done = False
        try:
            for item in _select_iter(source_factory(), select):
                try:
                    out = self._insert(st, item, device_elem, serve_device, device)
                except Exception:
                    # no half-recorded stream stays behind; the error
                    # reaches the consuming pass, which restarts from zero
                    with self._mu:
                        self._drop_stream_locked(st, "insert_failed")
                    raise
                yield out
            done = True
        finally:
            with self._mu:
                if done and not st.dropped and select is None:
                    st.complete = True
                    _chunk_note("streams_complete")
                else:
                    self._drop_stream_locked(st, "abandoned")

    def _serve(self, st: _ChunkStream, source_factory, serve_device: bool, select,
               ordered: bool, device):
        n = len(st.chunks)
        pos = 0
        while pos < n:
            if select is not None and pos not in select:
                pos += 1
                continue
            try:
                with self._mu:
                    if st.dropped or pos >= len(st.chunks):
                        raise LookupError("chunk evicted mid-serve")
                    item = self._serve_chunk_locked(st.chunks[pos], serve_device, device)
            except (LookupError, ChunkIntegrityError, ImportError, ValueError) as e:
                with self._mu:
                    self._drop_stream_locked(st, "serve_fallback")
                if not ordered:
                    # a fresh run of an order-free source would repeat some
                    # chunks and skip others after `pos`
                    raise ChunkIntegrityError(
                        f"cached chunk unusable mid-serve of an order-free stream ({e}); "
                        "restart the pass") from e
                # an in-order source: finish from the source at `pos`
                for i, fresh in enumerate(source_factory()):
                    if i < pos:
                        continue
                    if select is None or i in select:
                        yield fresh
                return
            yield item
            pos += 1

    # -- maintenance ---------------------------------------------------------

    def invalidate_devices(self, ids) -> int:
        """Drop the device tier on the given CUDA device indices.  A chunk
        with a host or spill copy keeps serving; a stream with a
        device-only array is dropped (its next scan decodes)."""
        ids = {int(i) for i in ids}
        n = 0
        with self._mu:
            for st in list(self._streams.values()):
                doomed = False
                for c in st.chunks:
                    for a in c.arrays():
                        if a.dev is None or a.dev.device.index not in ids:
                            continue
                        self._book_dev_locked(-a.dev_nbytes())
                        a.dev = None
                        n += 1
                        if a.host is None and a.spill is None:
                            doomed = True
                if doomed:
                    self._drop_stream_locked(st, "device_lost")
            self._sync_bytes_locked()
        if n:
            _chunk_note("invalidations", n)
        return n

    def clear(self) -> None:
        with self._mu:
            for st in list(self._streams.values()):
                self._drop_stream_locked(st, "clear")


def _holds_host(st: _ChunkStream) -> bool:
    return any(a.host is not None or (a.spill is not None and a.spill.blob is not None)
               for c in st.chunks for a in c.arrays())


def _select_iter(it, select):
    if select is None:
        yield from it
        return
    for i, item in enumerate(it):
        if i in select:
            yield item


_chunk_cache: Optional[ChunkCache] = None


def get_chunk_cache() -> ChunkCache:
    global _chunk_cache
    with _global_lock:
        if _chunk_cache is None:
            _chunk_cache = ChunkCache()
        return _chunk_cache


def clear_chunk_cache() -> None:
    """Drop every cached stream and release the ledger claim."""
    if _chunk_cache is not None:
        _chunk_cache.clear()


def invalidate_for_devices(ids) -> int:
    """The device-loss hook: drop the chunk cache's device tier on `ids`
    (the dataset entries of the JAX package are not ported)."""
    return 0 if _chunk_cache is None else _chunk_cache.invalidate_devices(ids)


def cached_chunk_stream(key, source_factory, device_elem: Optional[int] = None,
                        serve_device: bool = False, select=None, ordered: bool = True,
                        device=None):
    """The consumers' entry point: a chunk iterator through the cache.
    `key=None` (a source without a change stamp) or `chunk_cache="off"`
    reads the source."""
    if key is None or not chunk_cache_enabled():
        yield from _select_iter(source_factory(), select)
        return
    yield from get_chunk_cache().stream(key, source_factory, device_elem=device_elem,
                                        serve_device=serve_device, select=select,
                                        ordered=ordered, device=device)


def chunk_stream_complete(key) -> Optional[int]:
    if key is None or _chunk_cache is None or not chunk_cache_enabled():
        return None
    return _chunk_cache.stream_complete(key)


__all__ = [
    "CHUNK_METRICS",
    "ChunkCache",
    "ChunkIntegrityError",
    "CACHE_METRICS",
    "CacheEntry",
    "CachedEvalView",
    "DeviceDatasetCache",
    "FoldSet",
    "LAST_DECISION",
    "cache_budget_bytes",
    "cache_enabled",
    "cache_resident_bytes",
    "cached_chunk_stream",
    "chunk_cache_enabled",
    "chunk_cache_host_budget",
    "chunk_metrics_snapshot",
    "chunk_stream_complete",
    "clear_chunk_cache",
    "clear_device_cache",
    "dataset_fingerprint",
    "device_data_budget_bytes",
    "get_chunk_cache",
    "get_device_cache",
    "get_or_stage",
    "invalidate_for_devices",
    "release_external",
    "release_external_many",
    "reserve_external",
]
