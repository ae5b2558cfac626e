#
# The resilience layer's counters and events.  The counters live in the
# telemetry registry (telemetry/registry.py) under the JAX package's
# families: `checkpoint_saves_total`, `checkpoint_resumes_total`,
# `retries_total{label,action}` (`RETRIES`, which the serving server
# reads), `faults_injected_total{site,kind}` and
# `dispatch_timeouts_total{label}`.  Each event is a trace instant
# (tracing.py `event`: `retry[<label>]`, `lbfgs_resume`,
# `dispatch_timeout[<label>]`, ...) and also lands in a bounded list of
# `(name, detail)` read by `get_events`.  A fit's
# `fit_report()["resilience"]` holds the counts that moved during it
# (core.py), keyed "name" or "name{a=b,c=d}".
#
from __future__ import annotations

import collections
import threading
from typing import Dict, List, NamedTuple, Optional

from ..telemetry.registry import counter

_lock = threading.Lock()

# the families this layer writes, registered once with the JAX package's
# help strings
RETRIES = counter("retries_total", "Dispatch retries by label and recovery action")
_FAMILIES = {
    "retries_total": RETRIES,
    "checkpoint_saves_total": counter("checkpoint_saves_total",
                                      "Solver checkpoints written"),
    "checkpoint_resumes_total": counter("checkpoint_resumes_total",
                                        "Solver resumes from a checkpoint"),
    "faults_injected_total": counter("faults_injected_total",
                                     "Injected faults by site and kind"),
    "dispatch_timeouts_total": counter("dispatch_timeouts_total",
                                       "Watchdog dispatch timeouts by label"),
}


class Event(NamedTuple):
    name: str
    detail: str


_EVENTS: "collections.deque[Event]" = collections.deque(maxlen=4096)


def inc(name: str, **labels: str) -> None:
    """Add one to counter `name` (with its labels, if any)."""
    _FAMILIES[name].inc(1, **labels)


def counts_snapshot() -> Dict[str, int]:
    """Every sample of the resilience families, keyed "name" or
    "name{a=b,c=d}" (labels sorted)."""
    out: Dict[str, int] = {}
    for name, fam in _FAMILIES.items():
        for lk, v in fam.samples().items():
            key = name + ("{" + ",".join(f"{k}={val}" for k, val in lk) + "}" if lk else "")
            out[key] = v
    return out


def counts_since(start: Optional[Dict[str, int]]) -> Dict[str, int]:
    """The counters that moved since `start` (a `counts_snapshot()`), by
    how much."""
    now = counts_snapshot()
    start = start or {}
    return {k: v - start.get(k, 0) for k, v in now.items() if v != start.get(k, 0)}


def event(name: str, detail: str = "", log=None) -> None:
    """Record an event, as a trace instant and in the event list; `log`,
    where given, gets it at info level."""
    from ..tracing import event as trace_event

    with _lock:
        _EVENTS.append(Event(name, detail))
    trace_event(name, detail=detail)
    if log is not None:
        log.info(f"{name}" + (f" ({detail})" if detail else ""))


def get_events(name: Optional[str] = None) -> List[Event]:
    with _lock:
        return [e for e in _EVENTS if name is None or e.name == name]


def reset_metrics() -> None:
    """Clear the resilience counters and the events (tests)."""
    for fam in _FAMILIES.values():
        fam.clear()
    with _lock:
        _EVENTS.clear()
