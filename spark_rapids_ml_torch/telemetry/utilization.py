#
# Device idle-gap attribution: the port of spark_rapids_ml_tpu/telemetry/
# utilization.py.  One utilization timeline per run:
#
#   note_interval(kind, t0, t1, cause)   producers append labeled
#       wall-clock intervals — "device" (the card had work), "host_prep",
#       "stage" (host->device transfers), "dispatch"/"collect" (serving
#       aggregate phases) with "compute"/"scatter" sub-windows from the
#       staged dispatch pipeline, "lock_wait" (contended named-lock
#       acquires, telemetry/locks.py)
#
#   summarize(run_id=..., window_s=...)   folds them into
#       `device_busy_fraction` plus a RANKED gap-attribution table: the
#       complement of the device-busy union is the idle time, and each
#       gap second is attributed to whichever non-device activity
#       covered it (top causes by stolen seconds, residual reported as
#       `unattributed`).
#
# Consumers: `ServingServer.report()`'s `_totals` utilization block, the
# serving pipeline's auto depth, and chip_smoke.py's idle shares.  On a
# card the serving "device" interval of a batch is the time its slot's
# stream took from the staging to the outputs' copy (two CUDA events),
# ending where the collect worker saw it complete.
#
# Timestamps are `time.perf_counter()` values (monotonic, cross-thread
# comparable).  Storage is one bounded process-global deque;
# `collections.deque.append` is GIL-atomic, so producers pay no lock.
#
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Tuple

from .registry import gauge

# interval kinds producers may record; "device" is the busy series the
# gaps are measured against, everything else is attribution evidence.
# "dispatch"/"collect" are the serving pipeline's aggregate phases;
# "stage"/"compute"/"scatter" are its finer-grained sub-windows (the
# depth-tuning evidence: stage/compute stealing gap seconds means a
# deeper `serving_pipeline_depth` pays, scatter stealing means the
# collect worker is the bottleneck)
KINDS = (
    "device",
    "host_prep",
    "stage",
    "compute",
    "dispatch",
    "collect",
    "scatter",
    "lock_wait",
    # bounded cross-process waits (resilience/pod.py kv_wait): time a
    # rank spent parked on a peer's KV payload — the pod-scale analog of
    # lock_wait, cause carries "<reduce tag>:rank<peer>"
    "reduce_wait",
)

# retained intervals, process-wide: at fused-chunk granularity this is
# hours of history; serving batches recycle it faster but a report only
# ever looks at one run / one window
_MAX_INTERVALS = 8192

# (run_id, kind, cause, t0, t1) in perf_counter seconds
_intervals: collections.deque = collections.deque(maxlen=_MAX_INTERVALS)

_busy_gauge = gauge(
    "device_busy_fraction",
    "Fraction of the observed wall the device was busy, by scope",
)

# gap-attribution rows reported per summary
_TOP_CAUSES = 8


def note_interval(
    kind: str,
    t0: float,
    t1: float,
    cause: str = "",
    run_id: Optional[str] = None,
    domain: str = "fit",
) -> None:
    """Record one labeled wall-clock interval (perf_counter endpoints).
    `run_id` defaults to the thread's active run (tracing.run_context);
    an empty run id still lands in window-scoped summaries.  `domain`
    scopes window summaries: "fit" (default — staging/fused/solver
    producers), "serving" (the dispatcher's windows), or "any" (lock
    waits, which belong to whichever view asks).  Cheap and lock-free
    (one deque append); never raises."""
    if t1 <= t0:
        return
    try:
        if run_id is None:
            from ..tracing import current_run_id

            run_id = current_run_id()
        _intervals.append(
            (run_id or "", kind, cause, float(t0), float(t1), domain)
        )
    except Exception:
        pass


def note_intervals(
    kind: str,
    intervals,
    cause: str = "",
    run_id: Optional[str] = None,
    domain: str = "fit",
) -> None:
    """Bulk form for producers that already hold an interval list (the
    fused engine's per-pass prep/accumulate windows): intervals are
    coalesced FIRST so a 10k-chunk pass lands as a handful of merged
    spans, not 10k deque entries."""
    for lo, hi in merge_intervals(list(intervals)):
        note_interval(kind, lo, hi, cause=cause, run_id=run_id,
                      domain=domain)


def clear() -> None:
    """Tests / operator reset: drop the retained timeline."""
    _intervals.clear()


# ---------------------------------------------------------------------------
# Interval math
# ---------------------------------------------------------------------------


def merge_intervals(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sort + coalesce possibly-overlapping intervals into a disjoint
    sorted list."""
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


def interval_overlap_s(
    a: List[Tuple[float, float]], b: List[Tuple[float, float]]
) -> float:
    """Total length of the pairwise intersection of two sorted disjoint
    interval lists — how long both sides were simultaneously active."""
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


def complement(
    busy: List[Tuple[float, float]], lo: float, hi: float
) -> List[Tuple[float, float]]:
    """The gaps: [lo, hi] minus the (disjoint, sorted) busy intervals."""
    gaps: List[Tuple[float, float]] = []
    cur = lo
    for b0, b1 in busy:
        if b0 > cur:
            gaps.append((cur, min(b0, hi)))
        cur = max(cur, b1)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def _total(iv: List[Tuple[float, float]]) -> float:
    return sum(hi - lo for lo, hi in iv)


# ---------------------------------------------------------------------------
# Summaries
# ---------------------------------------------------------------------------


def timeline(
    run_id: Optional[str] = None,
    window_s: Optional[float] = None,
    domain: Optional[str] = None,
) -> List[tuple]:
    """The retained intervals, filtered by run, trailing window and/or
    domain ("any"-domain intervals — lock waits — match every domain).
    Window-filtered intervals are CLIPPED to the window start, so one
    long span ending just now cannot stretch the observed wall far past
    the window."""
    evs = list(_intervals)
    if run_id is not None:
        evs = [e for e in evs if e[0] == run_id]
    if domain is not None:
        evs = [e for e in evs if e[5] in (domain, "any")]
    if window_s is not None:
        cutoff = time.perf_counter() - float(window_s)
        evs = [
            e if e[3] >= cutoff
            else (e[0], e[1], e[2], cutoff, e[4], e[5])
            for e in evs
            if e[4] >= cutoff
        ]
    return evs


def summarize(
    run_id: Optional[str] = None,
    window_s: Optional[float] = None,
    scope: str = "",
    domain: Optional[str] = None,
) -> Dict[str, Any]:
    """Fold the selected intervals into the utilization verdict:

    - `device_busy_fraction` = |union of device intervals| / observed wall
    - `gap_attribution`: ranked causes of the idle gaps — for each
      (kind, cause) series, how many gap seconds it covered ("stolen"),
      plus the `unattributed` residual no recorded activity explains.

    A cause can "steal" the same gap second another cause also covers
    (host prep and a lock wait can genuinely co-occur), so attribution
    rows may sum past `gap_s`; the residual uses the UNION of all
    non-device activity and is exact.  Returns {} when nothing was
    recorded.  `scope` additionally publishes the fraction on the
    `device_busy_fraction{scope}` gauge."""
    evs = timeline(run_id=run_id, window_s=window_s, domain=domain)
    if not evs:
        if scope:
            # the busy gauge must not report the last burst forever
            # once every interval ages out of the window — an idle
            # device reads as NO series, not as hours-stale "93% busy"
            _busy_gauge.remove(scope=scope)
        return {}
    lo = min(e[3] for e in evs)
    hi = max(e[4] for e in evs)
    wall = hi - lo
    if wall <= 0:
        return {}
    by_series: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
    device: List[Tuple[float, float]] = []
    for _rid, kind, cause, t0, t1, _domain in evs:
        if kind == "device":
            device.append((t0, t1))
        else:
            by_series.setdefault((kind, cause), []).append((t0, t1))
    busy = merge_intervals(device)
    busy_s = _total(busy)
    gaps = complement(busy, lo, hi)
    gap_s = _total(gaps)
    rows: List[Dict[str, Any]] = []
    non_device_union: List[Tuple[float, float]] = []
    for (kind, cause), iv in by_series.items():
        merged = merge_intervals(iv)
        non_device_union.extend(merged)
        stolen = interval_overlap_s(gaps, merged)
        if stolen <= 0:
            continue
        rows.append({
            "kind": kind,
            **({"cause": cause} if cause else {}),
            "stolen_s": round(stolen, 4),
            "active_s": round(_total(merged), 4),
        })
    rows.sort(key=lambda r: -r["stolen_s"])
    attributed = interval_overlap_s(gaps, merge_intervals(non_device_union))
    fraction = max(0.0, min(busy_s / wall, 1.0))
    out: Dict[str, Any] = {
        "wall_s": round(wall, 4),
        "device_busy_s": round(busy_s, 4),
        "device_busy_fraction": round(fraction, 4),
        "gap_s": round(gap_s, 4),
        "gap_attribution": rows[:_TOP_CAUSES],
        "unattributed_s": round(max(gap_s - attributed, 0.0), 4),
    }
    if scope:
        _busy_gauge.set(out["device_busy_fraction"], scope=scope)
    return out


# the package-facade name (tracing has its own `summarize`)
summarize_utilization = summarize

__all__ = [
    "KINDS",
    "summarize_utilization",
    "clear",
    "complement",
    "interval_overlap_s",
    "merge_intervals",
    "note_interval",
    "note_intervals",
    "summarize",
    "timeline",
]
