#
# Mergeable sketch state of the statistic programs: the port of
# spark_rapids_ml_tpu/stats/sketches.py, a copy (host numpy).  The
# `quantile_sketch` and `frequent_items` programs (stats/programs.py) fold
# chunks through the KLL-style quantile sketch and the Misra-Gries table
# here, and the `distinct_count` program's HyperLogLog registers are
# estimated by `hll_estimate`.  All three merge: folding per-chunk or
# per-reader partial states loses no more accuracy than one state over the
# concatenated data.
#
# Determinism: the quantile compaction keeps the even-indexed items of a
# sorted buffer (classic KLL draws the offset), and the frequent-items
# decrement is the batched Misra-Gries step.  The same chunks in the same
# order give a bit-identical state; the range readers' chunk order differs
# from run to run, and the state with it, within the sketch's error (the
# cache replays one recorded order, so two replays agree).
#
# Weights: the sketches take `w` as a validity mask (rows with w > 0 enter
# once); weighted quantiles and frequencies are out of scope.
#
from __future__ import annotations

import io
import struct
from typing import Dict, Tuple

import numpy as np

# quantile sketch geometry: levels hold `k` items each, level l items
# carry weight 2^l.  28 levels * k=256 covers ~2^36 rows before the top
# level would overflow — far past the 1B-row north star.
QUANTILE_LEVELS = 28


def quantile_init(d: int, k: int) -> Dict[str, np.ndarray]:
    """Fresh per-column quantile-sketch state.  `sizes` is shared by all
    columns (every column sees the same valid rows), so the per-level
    bookkeeping stays O(L) not O(cols * L)."""
    return {
        "items": np.zeros((d, QUANTILE_LEVELS, k), np.float64),
        "sizes": np.zeros((QUANTILE_LEVELS,), np.int64),
        "n": np.zeros((), np.int64),
    }


def _compact_level(acc: Dict[str, np.ndarray], level: int, k: int) -> None:
    """Sort level's buffer per column, keep the even-indexed half at
    weight 2^(level+1) (promoted into the next level), empty this level.
    Cascades when the promotion overflows the next level."""
    size = int(acc["sizes"][level])
    if size < 2:
        return
    buf = np.sort(acc["items"][:, level, :size], axis=1)
    keep = buf[:, 0:2 * (size // 2):2]  # even indices of the sorted pairs
    odd_one = buf[:, -1:] if size % 2 else None
    promoted = keep.shape[1]
    nxt = level + 1
    if nxt >= QUANTILE_LEVELS:  # pragma: no cover - 2^36-row guard
        raise RuntimeError("quantile sketch level overflow")
    if int(acc["sizes"][nxt]) + promoted > k:
        _compact_level(acc, nxt, k)
    at = int(acc["sizes"][nxt])
    acc["items"][:, nxt, at:at + promoted] = keep
    acc["sizes"][nxt] = at + promoted
    # an odd leftover item stays at this level (weight unchanged)
    acc["sizes"][level] = 0
    if odd_one is not None:
        acc["items"][:, level, :1] = odd_one
        acc["sizes"][level] = 1


def quantile_update(
    acc: Dict[str, np.ndarray], X: np.ndarray, valid: np.ndarray, k: int
) -> Dict[str, np.ndarray]:
    """Fold one (rows, cols) chunk into the sketch (rows with
    `valid`=False are padding and never enter)."""
    vals = np.asarray(X[valid], np.float64).T  # (cols, m)
    m = vals.shape[1]
    acc["n"] = acc["n"] + m
    pos = 0
    while pos < m:
        size0 = int(acc["sizes"][0])
        take = min(k - size0, m - pos)
        if take == 0:
            _compact_level(acc, 0, k)
            continue
        acc["items"][:, 0, size0:size0 + take] = vals[:, pos:pos + take]
        acc["sizes"][0] = size0 + take
        pos += take
    return acc


def quantile_merge(
    a: Dict[str, np.ndarray], b: Dict[str, np.ndarray], k: int
) -> Dict[str, np.ndarray]:
    """Fold state `b` into `a` level-by-level (same-weight items land in
    the same level, so the merged error bound matches the streamed
    one)."""
    a = {kk: np.array(v) for kk, v in a.items()}
    for level in range(QUANTILE_LEVELS):
        sb = int(b["sizes"][level])
        pos = 0
        while pos < sb:
            at = int(a["sizes"][level])
            take = min(k - at, sb - pos)
            if take == 0:  # full: compact (leaves <= 1 item) and retry
                _compact_level(a, level, k)
                continue
            a["items"][:, level, at:at + take] = (
                b["items"][:, level, pos:pos + take]
            )
            a["sizes"][level] = at + take
            pos += take
    a["n"] = a["n"] + b["n"]
    return a


def quantile_query(
    acc: Dict[str, np.ndarray], qs
) -> np.ndarray:
    """(cols, len(qs)) estimated quantiles: gather every retained item
    with its level weight, per-column weighted rank lookup."""
    qs = np.atleast_1d(np.asarray(qs, np.float64))
    d = acc["items"].shape[0]
    cols_items = []
    weights = []
    for level in range(QUANTILE_LEVELS):
        size = int(acc["sizes"][level])
        if size == 0:
            continue
        cols_items.append(acc["items"][:, level, :size])
        weights.append(np.full((size,), float(2 ** level)))
    if not cols_items:
        return np.full((d, qs.size), np.nan)
    items = np.concatenate(cols_items, axis=1)  # (cols, t)
    w = np.concatenate(weights)  # (t,)
    order = np.argsort(items, axis=1, kind="stable")
    sorted_items = np.take_along_axis(items, order, axis=1)
    cum = np.cumsum(w[order], axis=1)
    total = cum[:, -1:]
    out = np.empty((d, qs.size))
    for j, q in enumerate(qs):
        target = np.clip(q, 0.0, 1.0) * total[:, 0]
        idx = np.minimum(
            (cum < target[:, None]).sum(axis=1), items.shape[1] - 1
        )
        out[:, j] = sorted_items[np.arange(d), idx]
    return out


# ---------------------------------------------------------------------------
# Misra-Gries frequent items (per column)
# ---------------------------------------------------------------------------


def frequent_init(d: int, cap: int) -> Dict[str, np.ndarray]:
    """keys are NaN-marked-empty; counts carry the MG lower bounds;
    `err` is the cumulative decrement per column (the +/- bound every
    reported count carries)."""
    return {
        "keys": np.full((d, cap), np.nan),
        "counts": np.zeros((d, cap), np.int64),
        "err": np.zeros((d,), np.int64),
        "n": np.zeros((), np.int64),
    }


def _mg_fold_column(
    keys: np.ndarray, counts: np.ndarray, err: int,
    new_keys: np.ndarray, new_counts: np.ndarray, cap: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Batched Misra-Gries merge of one column's (value -> count) table
    with fresh chunk counts: combine, then subtract the (cap+1)-largest
    count from everything and drop the non-positive survivors (the
    classic mergeable-summaries step; error grows by the subtracted
    amount)."""
    live = ~np.isnan(keys)
    table: Dict[float, int] = dict(
        zip(keys[live].tolist(), counts[live].tolist())
    )
    for kv, cv in zip(new_keys.tolist(), new_counts.tolist()):
        table[kv] = table.get(kv, 0) + int(cv)
    if len(table) > cap:
        by_count = sorted(table.values(), reverse=True)
        t = by_count[cap]  # the (cap+1)-th largest
        table = {kv: cv - t for kv, cv in table.items() if cv - t > 0}
        err += t
    out_k = np.full((cap,), np.nan)
    out_c = np.zeros((cap,), np.int64)
    ordered = sorted(table.items(), key=lambda it: (-it[1], it[0]))[:cap]
    for i, (kv, cv) in enumerate(ordered):
        out_k[i] = kv
        out_c[i] = cv
    return out_k, out_c, err


def frequent_update(
    acc: Dict[str, np.ndarray], X: np.ndarray, valid: np.ndarray, cap: int
) -> Dict[str, np.ndarray]:
    vals = np.asarray(X[valid], np.float64)
    acc["n"] = acc["n"] + vals.shape[0]
    for j in range(vals.shape[1]):
        col = vals[:, j]
        # NaN is the empty-slot sentinel and never compares equal to
        # itself: real NaN data would mint a fresh never-matching entry
        # per chunk and evict genuine frequent items — missing values
        # are excluded from the frequency table instead
        col = col[~np.isnan(col)]
        if col.size == 0:
            continue
        uniq, cnts = np.unique(col, return_counts=True)
        acc["keys"][j], acc["counts"][j], e = _mg_fold_column(
            acc["keys"][j], acc["counts"][j], int(acc["err"][j]),
            uniq, cnts, cap,
        )
        acc["err"][j] = e
    return acc


def frequent_merge(
    a: Dict[str, np.ndarray], b: Dict[str, np.ndarray], cap: int
) -> Dict[str, np.ndarray]:
    a = {kk: np.array(v) for kk, v in a.items()}
    for j in range(a["keys"].shape[0]):
        live = ~np.isnan(b["keys"][j])
        a["keys"][j], a["counts"][j], e = _mg_fold_column(
            a["keys"][j], a["counts"][j],
            int(a["err"][j]) + int(b["err"][j]),
            b["keys"][j][live], b["counts"][j][live], cap,
        )
        a["err"][j] = e
    a["n"] = a["n"] + b["n"]
    return a


def frequent_items_result(acc: Dict[str, np.ndarray]) -> list:
    """Per-column [(value, count_lower_bound), ...] sorted by count; the
    per-column `err` is the +/- slack every bound carries (<= n/cap)."""
    out = []
    for j in range(acc["keys"].shape[0]):
        live = ~np.isnan(acc["keys"][j])
        pairs = sorted(
            zip(acc["keys"][j][live].tolist(),
                acc["counts"][j][live].tolist()),
            key=lambda it: (-it[1], it[0]),
        )
        out.append(pairs)
    return out


# ---------------------------------------------------------------------------
# HyperLogLog finalizer (registers accumulate on device, estimate on host)
# ---------------------------------------------------------------------------


def hll_init(d: int, p_bits: int) -> Dict[str, np.ndarray]:
    """Fresh host-side HyperLogLog state: (cols, 2^p_bits) int32 max-rank
    registers — the same register layout as the device `distinct_count`
    program, so `hll_estimate` serves both."""
    return {"regs": np.zeros((d, 2 ** p_bits), np.int32)}


def hll_update(
    acc: Dict[str, np.ndarray], X: np.ndarray, valid: np.ndarray,
    p_bits: int,
) -> Dict[str, np.ndarray]:
    """Numpy twin of the device `distinct_count` step (stats/programs.py
    `_hll_make_step`): same -0.0 canonicalization, same murmur3
    finalizer over the f32 bit pattern, same bucket/rank split — so a
    host-folded register table estimates with identical accuracy.  Rows
    with `valid`=False never enter."""
    vals = np.asarray(X[np.asarray(valid, bool)])
    if vals.size == 0:
        return acc
    h = (np.asarray(vals, np.float32) + 0.0).view(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    bucket = (h >> np.uint32(32 - p_bits)).astype(np.int64)
    rest = (h << np.uint32(p_bits)).astype(np.uint32)
    # clz(rest) + 1 without a hardware clz: 32 - bit_length(rest); the
    # float64 log2 is exact for every uint32 (52-bit mantissa)
    nz = rest > 0
    bitlen = np.zeros(rest.shape, np.int32)
    bitlen[nz] = np.floor(np.log2(rest[nz].astype(np.float64))).astype(
        np.int32
    ) + 1
    rho = np.minimum(32 - bitlen + 1, 32 - p_bits + 1).astype(np.int32)
    m = 2 ** p_bits
    regs = acc["regs"].reshape(-1)
    cols = np.broadcast_to(
        np.arange(vals.shape[1], dtype=np.int64)[None, :], bucket.shape
    )
    np.maximum.at(regs, (cols * m + bucket).reshape(-1), rho.reshape(-1))
    return acc


def hll_estimate(registers: np.ndarray) -> np.ndarray:
    """(cols,) distinct-count estimates from (cols, m) max-rank
    registers — the standard HLL estimator with the small-range
    linear-counting correction (Flajolet et al.)."""
    regs = np.asarray(registers, np.float64)
    m = regs.shape[1]
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(
        m, 0.7213 / (1.0 + 1.079 / m)
    )
    raw = alpha * m * m / np.power(2.0, -regs).sum(axis=1)
    zeros = (regs == 0).sum(axis=1)
    small = zeros > 0
    est = np.where(
        small & (raw <= 2.5 * m),
        m * np.log(m / np.maximum(zeros, 1)),
        raw,
    )
    return est


# ---------------------------------------------------------------------------
# Versioned wire format for sketch state (KLL quantiles, Misra-Gries,
# HyperLogLog), the same bytes as the JAX package's: a serialized state
# restores to identical arrays (np.savez round-trip), so merging two
# round-tripped states equals merging the originals.  The version is
# checked on load, and another version is refused.
# ---------------------------------------------------------------------------

SKETCH_WIRE_MAGIC = b"SRSK"
SKETCH_WIRE_VERSION = 1

_SKETCH_KINDS = ("quantile", "frequent", "hll")


def sketch_to_bytes(kind: str, state: Dict[str, np.ndarray]) -> bytes:
    """Serialize one sketch state dict.  `kind` names which sketch
    family the arrays belong to (quantile | frequent | hll); the state
    arrays are stored compressed (sketch buffers are mostly zeros)."""
    if kind not in _SKETCH_KINDS:
        raise ValueError(
            f"unknown sketch kind {kind!r}; known: {_SKETCH_KINDS}"
        )
    buf = io.BytesIO()
    np.savez_compressed(
        buf, **{k: np.asarray(v) for k, v in state.items()}
    )
    payload = buf.getvalue()
    kind_b = kind.encode()
    return (
        SKETCH_WIRE_MAGIC
        + struct.pack("<HH", SKETCH_WIRE_VERSION, len(kind_b))
        + kind_b
        + payload
    )


def sketch_from_bytes(blob: bytes) -> Tuple[str, Dict[str, np.ndarray]]:
    """Inverse of `sketch_to_bytes`: (kind, state).  Raises ValueError
    on a bad magic or a version this build does not speak — a sketch
    from a different wire version must be re-captured, never guessed
    at."""
    if blob[:4] != SKETCH_WIRE_MAGIC:
        raise ValueError("not a serialized sketch (bad magic)")
    version, klen = struct.unpack("<HH", blob[4:8])
    if version != SKETCH_WIRE_VERSION:
        raise ValueError(
            f"sketch wire version {version} unsupported (this build "
            f"speaks {SKETCH_WIRE_VERSION}); re-capture the sketch"
        )
    kind = blob[8:8 + klen].decode()
    if kind not in _SKETCH_KINDS:
        raise ValueError(f"unknown sketch kind {kind!r} in payload")
    with np.load(io.BytesIO(blob[8 + klen:]), allow_pickle=False) as z:
        state = {k: z[k] for k in z.files}
    return kind, state
