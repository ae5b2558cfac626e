#
# The device-budget ledger and the chunk cache: the port of
# spark_rapids_ml_tpu/parallel/device_cache.py for one device.
#
#   the ledger     `device_data_budget_bytes` (the staging decisions' budget,
#                  core.py `_over_device_budget`), `cache_budget_bytes`, and
#                  the external claims of `DeviceDatasetCache`: residency
#                  that is not a staged dataset (the chunk cache's device
#                  tier) books its bytes here, and every budget decision
#                  counts them (`cache_resident_bytes`).  The dataset
#                  entries, fold views and `get_or_stage` of the JAX
#                  package's cache wait for the Meta layer (ROADMAP.md
#                  section 1, item 2).
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


class DeviceDatasetCache:
    """The device-budget ledger: external claims (tag -> bytes) that every
    budget comparison counts and that only their owner releases.  The
    dataset entries of the JAX package's registry are not ported, so there
    is nothing for a claim to evict."""

    def __init__(self) -> None:
        self._mu = threading.RLock()
        self._external: Dict[str, int] = {}

    def claimed_bytes(self) -> int:
        """The bytes every budget comparison must see: the external claims
        (the JAX package adds its resident and in-flight dataset entries)."""
        with self._mu:
            return sum(self._external.values())

    def reserve_external(self, tag: str, need_bytes: int, evict: bool = True) -> bool:
        """Book `need_bytes` for `tag` (a repeat claim for the same tag
        replaces the old one).  False when the budget cannot hold it; the
        old claim then stays.  `evict` is the JAX package's switch for
        evicting dataset entries to make room, of which the port has none;
        the chunk cache claims with `evict=False` (free room only)."""
        budget = cache_budget_bytes()
        need_bytes = int(need_bytes)
        with self._mu:
            old = self._external.get(tag, 0)
            extra = need_bytes - old
            if extra > budget or self.claimed_bytes() + extra > budget:
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


def reserve_external(tag: str, need_bytes: int) -> bool:
    return get_device_cache().reserve_external(tag, need_bytes)


def release_external(tag: str) -> int:
    return 0 if _global_cache is None else _global_cache.release_external(tag)


def release_external_many(tags) -> int:
    return 0 if _global_cache is None else _global_cache.release_external_many(tags)


def cache_resident_bytes() -> int:
    """The bytes the ledger holds, added to every `_over_device_budget`
    estimate (core.py) so that staging decisions see the device memory the
    chunk cache occupies."""
    return _global_cache.claimed_bytes() if _global_cache is not None else 0


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
    "DeviceDatasetCache",
    "cache_budget_bytes",
    "cache_resident_bytes",
    "cached_chunk_stream",
    "chunk_cache_enabled",
    "chunk_cache_host_budget",
    "chunk_metrics_snapshot",
    "chunk_stream_complete",
    "clear_chunk_cache",
    "device_data_budget_bytes",
    "get_chunk_cache",
    "get_device_cache",
    "invalidate_for_devices",
    "release_external",
    "release_external_many",
    "reserve_external",
]
