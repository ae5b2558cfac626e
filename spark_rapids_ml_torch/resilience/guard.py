#
# Guarded dispatch: the port of spark_rapids_ml_tpu/resilience/guard.py, a
# watchdog for blocking device work.  `guarded` runs the call on a worker
# thread and bounds the wait; past the deadline the caller gets a typed
# `DispatchTimeout` (transient to resilience/retry.py) while the abandoned
# worker runs on.
#
# CUDA launches are asynchronous, so a watchdog around a call that only
# launches work would time the launch, not the work: on a card the worker
# ends its call with a synchronization of the device, inside the thread,
# so the deadline bounds the device work too.  An abandoned worker's work
# still runs after the timeout.  The next guarded call with a deadline
# first waits for it, at most that deadline (`wait_abandoned`), so that a
# retried fit does not start beside the one the caller gave up on; if it
# is still running then, the call raises `DispatchTimeout` without
# dispatching, so that a real hang never blocks a caller past its
# deadlines.  A call without a deadline runs at once, as in the JAX
# package (on a card its work queues behind the abandoned work's).
#
from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

from ..config import get_config
from ..utils import get_logger
from . import metrics

logger = get_logger("spark_rapids_ml_torch.resilience")

_abandoned: List[threading.Thread] = []
_abandoned_lock = threading.Lock()


class DispatchTimeout(RuntimeError):
    """Blocking device work exceeded its watchdog deadline (transient to the
    retry classifier)."""

    def __init__(self, label: str, deadline: float) -> None:
        super().__init__(
            f"dispatch '{label}' exceeded its {deadline:.1f}s watchdog deadline "
            "(DEADLINE_EXCEEDED); the device work may still be in flight")
        self.label = label
        self.deadline = deadline


def wait_abandoned(timeout: Optional[float] = None) -> int:
    """Wait for the workers earlier watchdogs gave up on, at most `timeout`
    seconds in all (None: until they end); returns how many are still
    running."""
    with _abandoned_lock:
        workers = list(_abandoned)
    end = None if timeout is None else time.monotonic() + timeout
    for t in workers:
        t.join(None if end is None else max(0.0, end - time.monotonic()))
    with _abandoned_lock:
        _abandoned[:] = [t for t in _abandoned if t.is_alive()]
        return len(_abandoned)


def _timeout(label: str, deadline: float, why: str, log: Optional[object]) -> DispatchTimeout:
    metrics.inc("dispatch_timeouts_total", label=label)
    metrics.event(f"dispatch_timeout[{label}]",
                  detail=f"deadline={deadline:.1f}s" + (f" {why}" if why else ""),
                  log=log or logger)
    return DispatchTimeout(label, deadline)


def _synchronize() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def guarded(fn: Callable[[], Any], deadline: Optional[float] = None, label: str = "dispatch",
            log: Optional[object] = None) -> Any:
    """Run `fn` under a watchdog.  `deadline=None` reads the
    `dispatch_deadline_s` conf; `<= 0` runs `fn` inline with no thread.
    With a positive deadline the call first waits at most `deadline`
    seconds for the workers earlier timeouts abandoned, then runs on a
    daemon thread, followed by a device synchronization (so the deadline
    covers the device work), and the caller waits at most `deadline`
    seconds for it.  Either wait running out records a
    `dispatch_timeout[label]` event and raises `DispatchTimeout`."""
    if deadline is None:
        deadline = float(get_config("dispatch_deadline_s") or 0.0)
    if deadline <= 0:
        return fn()
    if wait_abandoned(deadline):
        raise _timeout(label, deadline, "abandoned work still running", log)

    result: list = []
    failure: list = []

    def _worker() -> None:
        try:
            out = fn()
            _synchronize()
            result.append(out)
        except BaseException as e:  # surfaced on the caller below
            failure.append(e)

    t = threading.Thread(target=_worker, name=f"guarded[{label}]", daemon=True)
    t.start()
    t.join(deadline)
    if t.is_alive():
        with _abandoned_lock:
            _abandoned.append(t)
        raise _timeout(label, deadline, "", log)
    if failure:
        raise failure[0]
    return result[0]
