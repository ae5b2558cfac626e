#
# Tracing: the port of spark_rapids_ml_tpu/tracing.py.  Two mechanisms:
#
#   - `trace(stage)`: a nestable per-process stage timer recording SPANS —
#     absolute t0/t1 timestamps, the recording thread id, and the active
#     `run_id` — so a run can be reconstructed after the fact.  Events are
#     recorded in-process (inspect with `get_trace_events` /
#     `get_all_trace_events` / `summarize`); at `verbose >= 1` each stage
#     logs its wall-clock on exit.  `event(name)` records an instant
#     marker (retries, injected faults, brownout transitions).
#   - `profile_dir` config: when set, `device_profile()` runs its region
#     under `torch.profiler` (CPU and, on a card, CUDA activities) and
#     writes a Chrome trace (`trace_<pid>_<n>.json`) into that directory.
#
from __future__ import annotations

import contextlib
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional

from .config import get_config
from .utils import get_logger

logger = get_logger("spark_rapids_ml_torch.tracing")

_tls = threading.local()

# bounded event history per thread: long-lived serving processes transform
# repeatedly and must not grow memory without bound
MAX_EVENTS = 4096


@dataclass
class TraceEvent:
    name: str
    seconds: float
    depth: int
    # instantaneous events (retries, injected faults, dispatch timeouts —
    # resilience/) carry their context here; timed stages leave it empty
    detail: str = ""
    # -- span fields: correlation + absolute placement --------------------
    t0: float = 0.0  # absolute start, epoch seconds (time.time clock)
    t1: float = 0.0  # absolute end; == t0 for instant events
    thread_id: int = 0  # threading.get_ident() of the recording thread
    run_id: str = ""  # the fit/transform run this event belongs to
    kind: str = "span"  # "span" (timed stage) | "instant" (marker)
    # the pod-global pass id active when the event was recorded (set by
    # the pod layer, ROADMAP.md section 1, item 8; '' on one process)
    pass_id: str = ""


# every thread's record list, registered once at creation so readers
# can merge a PROCESS-wide view (the lists themselves
# stay thread-local for lock-free appends; list.append is atomic under
# the GIL).  Worker threads that adopt a caller's buffer share its
# already-registered list — no duplicate registration.  Entries hold a
# WEAK reference to the recording thread and are pruned (lazily, on the
# next registration) once that thread is gone: a thread-per-request
# service must not accumulate dead buffers — and their MAX_EVENTS of
# history — forever.
_buffers_lock = threading.Lock()
_buffers: List[tuple] = []  # (thread_name, weakref-to-thread, records)


def _records() -> List[TraceEvent]:
    rec = getattr(_tls, "records", None)
    if rec is None:
        import weakref

        rec = _tls.records = []
        t = threading.current_thread()
        with _buffers_lock:
            _buffers[:] = [b for b in _buffers if b[1]() is not None]
            _buffers.append((t.name, weakref.ref(t), rec))
    return rec


# process-wide observers of EVERY recorded event, regardless of which
# thread's buffer it lands in (the flight recorder's feed, once ported).
# Registration is rare (guarded by _buffers_lock); the hot-path iteration
# reads the list lock-free (list object replaced atomically on
# registration, append-only reads).
_taps: List[Callable[[TraceEvent], None]] = []


def add_trace_tap(fn: Callable[[TraceEvent], None]) -> None:
    """Register `fn` to observe every TraceEvent recorded by any thread
    of this process (spans on exit, instants immediately).  Idempotent.
    A tap must be cheap and never raise — it runs inline on the
    recording thread."""
    global _taps
    with _buffers_lock:
        if fn not in _taps:
            _taps = _taps + [fn]


def remove_trace_tap(fn: Callable[[TraceEvent], None]) -> None:
    global _taps
    with _buffers_lock:
        _taps = [t for t in _taps if t is not fn]


def _append(event: TraceEvent) -> None:
    rec = _records()
    if len(rec) >= MAX_EVENTS:
        del rec[: MAX_EVENTS // 2]  # drop the oldest half
    rec.append(event)
    for tap in _taps:
        try:
            tap(event)
        except Exception:  # a broken observer must never fail the span
            pass


def get_trace_events() -> List[TraceEvent]:
    """Events recorded on this thread since the last `reset_trace`."""
    return list(_records())


def get_all_trace_events(run_id: Optional[str] = None) -> List[TraceEvent]:
    """Events recorded on EVERY thread of this process, in start order
    (parents sort before their children).  `run_id` filters to one
    fit/transform run.  This is the process-wide view: a guarded dispatch's
    worker thread adopts its caller's buffer, so cross-thread spans of
    one run appear exactly once."""
    with _buffers_lock:
        bufs = [rec for _, _, rec in _buffers]
    seen = set()
    events: List[TraceEvent] = []
    for rec in bufs:
        if id(rec) in seen:  # adopted buffers are shared, not duplicated
            continue
        seen.add(id(rec))
        events.extend(list(rec))
    if run_id is not None:
        events = [e for e in events if e.run_id == run_id]
    # (t0, -t1): a parent starts no later than its children and ends no
    # earlier, so ties break parent-first
    events.sort(key=lambda e: (e.t0, -e.t1))
    return events


# ---------------------------------------------------------------------------
# Run correlation — one id per fit/transform
# ---------------------------------------------------------------------------

# the pod-global pass id: PROCESS-global, not thread-local — the
# producer/prefetch threads of a fused pass must stamp the same id as the
# consumer that minted it.  A str
# assignment is GIL-atomic, so readers never need the lock.
_current_pass_id = ""


def current_pass_id() -> str:
    """The pod-global pass id active in this process ('' outside any
    pod-correlated pass)."""
    return _current_pass_id


def set_current_pass_id(pass_id: str) -> None:
    """Install (or clear, with '') the process-global pass id every
    subsequently recorded span/instant is stamped with."""
    global _current_pass_id
    _current_pass_id = str(pass_id or "")


def mint_run_id(prefix: str = "run") -> str:
    """A fresh globally-unique run id (`<prefix>-<12 hex>`): the serving
    server mints one per request (`req-`) and per batch (`batch-`)."""
    return f"{prefix}-{uuid.uuid4().hex[:12]}"


def current_run_id() -> str:
    """The run id active on this thread ('' outside any run)."""
    return getattr(_tls, "run_id", "")


@contextlib.contextmanager
def run_context(
    run_id: Optional[str] = None, prefix: str = "run"
) -> Iterator[str]:
    """Scope a run id onto this thread: every span/event recorded inside
    carries it.  Nests — an inner fit's run restores the outer run on
    exit.  `run_id=None` mints a fresh id."""
    rid = run_id or mint_run_id(prefix)
    prev = getattr(_tls, "run_id", "")
    _tls.run_id = rid
    try:
        yield rid
    finally:
        _tls.run_id = prev


def adopt_trace_context() -> Callable[[], None]:
    """Capture this thread's trace buffer, depth AND run id for adoption
    by a worker thread (resilience/guard.py): the returned thunk, called
    on the worker, makes its trace()/event() calls land in the CALLER's
    record list, at the caller's depth, stamped with the caller's run —
    so a watchdog-guarded dispatch's stage timings and resilience markers
    correlate with the fit that issued it.  Without this the watchdog
    thread's thread-local storage swallows every event recorded inside a
    guarded dispatch.  list.append is atomic under the GIL, so a caller
    reading while an abandoned worker still appends is safe."""
    rec = _records()
    depth = getattr(_tls, "depth", 0)
    run_id = getattr(_tls, "run_id", "")
    def _adopt() -> None:
        _tls.records = rec
        _tls.depth = depth
        _tls.run_id = run_id

    return _adopt


def reset_trace() -> None:
    _records().clear()


def summarize() -> str:
    """Indented per-stage timing table for the recorded events, rendered
    in START order (each span carries its t0): a parent prints before its
    children and siblings print in execution order.  Events used to
    append on stage EXIT, which printed nested stages before their
    parents and interleaved siblings misleadingly."""
    events = sorted(_records(), key=lambda e: (e.t0, -e.t1))
    lines = [
        f"{'  ' * e.depth}{e.name}: {e.seconds:.4f}s"
        + (f" [{e.detail}]" if e.detail else "")
        for e in events
    ]
    return "\n".join(lines)


def event(name: str, detail: str = "", log: Optional[object] = None) -> None:
    """Record an INSTANTANEOUS event (zero-duration TraceEvent) — failure/
    recovery markers from the resilience layer: retries, injected faults,
    dispatch timeouts, checkpoint resumes.  Stamped with the active run
    id, so a recovery marker attributes to the fit it interrupted.
    Always logged at `verbose >= 1` like timed stages."""
    depth = getattr(_tls, "depth", 0)
    now = time.time()
    _append(
        TraceEvent(
            name,
            0.0,
            depth,
            detail,
            t0=now,
            t1=now,
            thread_id=threading.get_ident(),
            run_id=getattr(_tls, "run_id", ""),
            kind="instant",
            pass_id=_current_pass_id,
        )
    )
    if int(get_config("verbose") or 0) >= 1:
        suffix = f" [{detail}]" if detail else ""
        (log or logger).info(f"[trace] {'  ' * depth}{name}{suffix}")


@contextlib.contextmanager
def trace(name: str, log: Optional[object] = None) -> Iterator[None]:
    """Time a stage.  Nested stages indent; `verbose >= 1` logs on exit.
    The recorded span carries absolute t0/t1, the recording thread id and
    the active run id (see `run_context`)."""
    depth = getattr(_tls, "depth", 0)
    _tls.depth = depth + 1
    t0_abs = time.time()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _tls.depth = depth
        _append(
            TraceEvent(
                name,
                dt,
                depth,
                t0=t0_abs,
                t1=t0_abs + dt,
                thread_id=threading.get_ident(),
                run_id=getattr(_tls, "run_id", ""),
                kind="span",
                pass_id=_current_pass_id,
            )
        )
        if int(get_config("verbose") or 0) >= 1:
            (log or logger).info(f"[trace] {'  ' * depth}{name}: {dt:.4f}s")


def record_span(
    name: str, t0_abs: float, t1_abs: float, detail: str = ""
) -> None:
    """Record an already-timed span from absolute epoch endpoints — for
    producers that measured a window themselves and only want it on the
    trace after the fact.
    Stamped with the active run id and the pod-global pass id exactly
    like `trace()`."""
    _append(
        TraceEvent(
            name,
            max(t1_abs - t0_abs, 0.0),
            getattr(_tls, "depth", 0),
            detail,
            t0=float(t0_abs),
            t1=float(t1_abs),
            thread_id=threading.get_ident(),
            run_id=getattr(_tls, "run_id", ""),
            kind="span",
            pass_id=_current_pass_id,
        )
    )


_profile_lock = threading.Lock()
_profile_active = False
_profile_count = 0


@contextlib.contextmanager
def device_profile() -> Iterator[None]:
    """Run a region under `torch.profiler` when `profile_dir` is set, and
    write its Chrome trace (`trace_<pid>_<n>.json`, loads in Perfetto)
    into that directory: CPU activity, and the card's kernels and copies
    where CUDA is available.  The profiler is process-global, so
    concurrent regions share one trace: only the first caller starts and
    exports it."""
    global _profile_active, _profile_count
    profile_dir = get_config("profile_dir")
    if not profile_dir:
        yield
        return
    prof = None
    with _profile_lock:
        owner = not _profile_active
        if owner:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            _profile_active = True
    try:
        yield
    finally:
        if owner:
            with _profile_lock:
                # only stop a profile that actually started: if starting
                # raised, _profile_active never became True and stopping
                # would mask the original error
                if _profile_active:
                    import os

                    _profile_active = False
                    prof.__exit__(None, None, None)
                    os.makedirs(str(profile_dir), exist_ok=True)
                    _profile_count += 1
                    path = os.path.join(
                        str(profile_dir),
                        f"trace_{os.getpid()}_{_profile_count}.json",
                    )
                    prof.export_chrome_trace(path)
                    logger.info(f"Wrote device profile to {path}")
