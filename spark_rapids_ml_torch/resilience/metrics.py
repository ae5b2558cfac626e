#
# The resilience layer's counters and events: a stand-in for the JAX
# package's telemetry registry and trace events until the telemetry item
# (ROADMAP.md section 1, item 6) is ported.  Plain process-wide counts
# under the JAX package's counter names, and a bounded list of the events
# it records (`retry[<label>]`, `lbfgs_resume`, `dispatch_timeout[<label>]`,
# ...), each `(name, detail)`.  A fit's `fit_report()["resilience"]` holds
# the counts that moved during it (core.py).
#
from __future__ import annotations

import collections
import threading
from typing import Dict, List, NamedTuple, Optional

_lock = threading.Lock()

# name -> count; labelled counters keep one key per label, "name{a=b,c=d}"
COUNTS: Dict[str, int] = collections.Counter()


class Event(NamedTuple):
    name: str
    detail: str


_EVENTS: "collections.deque[Event]" = collections.deque(maxlen=4096)


def inc(name: str, **labels: str) -> None:
    """Add one to counter `name` (with its labels, if any)."""
    key = name
    if labels:
        key += "{" + ",".join(f"{k}={labels[k]}" for k in sorted(labels)) + "}"
    with _lock:
        COUNTS[key] += 1


def counts_snapshot() -> Dict[str, int]:
    with _lock:
        return dict(COUNTS)


def counts_since(start: Optional[Dict[str, int]]) -> Dict[str, int]:
    """The counters that moved since `start` (a `counts_snapshot()`), by
    how much."""
    now = counts_snapshot()
    start = start or {}
    return {k: v - start.get(k, 0) for k, v in now.items() if v != start.get(k, 0)}


def event(name: str, detail: str = "", log=None) -> None:
    """Record an event; `log`, where given, gets it at info level."""
    with _lock:
        _EVENTS.append(Event(name, detail))
    if log is not None:
        log.info(f"{name}" + (f" ({detail})" if detail else ""))


def get_events(name: Optional[str] = None) -> List[Event]:
    with _lock:
        return [e for e in _EVENTS if name is None or e.name == name]


def reset_metrics() -> None:
    """Clear the counters and the events (tests)."""
    with _lock:
        COUNTS.clear()
        _EVENTS.clear()
