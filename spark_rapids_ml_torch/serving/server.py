#
# Micro-batched transform server: the port of spark_rapids_ml_tpu/serving/
# server.py.  Concurrent single-row/small-batch requests for one model
# queue per model; a dispatcher thread concatenates them into ONE padded
# micro-batch under the `serving_max_wait_ms` SLO knob, stages it through
# the small-batch direct path (parallel/mesh.py `_stage_small_direct`),
# runs the pinned model's `_transform_device` on the card, and scatters
# the per-request row slices back to each caller's future.
#
# The dispatcher is a STAGED PIPELINE with a bounded in-flight depth
# (`serving_pipeline_depth`; default auto from the measured idle-gap
# profile): the dispatcher thread coalesces, stages and launches while a
# collect worker drains finished flights.  On a card each in-flight batch
# has its own CUDA stream: the dispatcher stages the batch, launches its
# transform and starts a non-blocking copy of its outputs into pinned
# host memory, all on that stream, then records an event; the collect
# worker waits on that batch's event alone, so batch N's collect never
# waits for N+1's compute.  The flight holds the batch's device tensors
# until its event has completed, and the staging ring reuses a pinned
# buffer only after the copy that last read it.  At depth 3, batch N+2
# stages while N+1 computes while N's outputs scatter.  Depth 1 fully
# serializes — the byte-parity baseline.  Within a priority class a
# round-robin interleave rotates which model's due batch dispatches each
# round (`serving_pipeline_interleave`); FIFO within each model's class is
# preserved.
#
# Admission control bounds the queue (`serving_max_queue` -> typed
# `ServingOverload`), and every failure degrades instead of dropping
# requests, through the port's retry policy (resilience/retry.py
# `RetryPolicy.classify` / `admits` / `recover`): an OOM halves the
# coalescing cap (floor: one row), a simulated device loss takes one
# card's full retry and re-pins every resident model on the same card,
# transients back off — queued requests survive all three, bounded by
# the attempt budget, which is per request.  A failure mid-pipeline hands
# back EXACTLY the affected flights' requests (the collect worker drains
# every in-flight batch into one fault, the dispatcher requeues them in
# dispatch order).  A sticky CUDA error (a device-side assert, an illegal
# access) poisons the process's context: the server fails every request
# in flight and queued with the typed `ServingDeviceError` and stops; it
# never requeues them or re-pins on the dead context.  No failure moves
# work to the CPU.
#
# Above the queue sits the closed-loop control plane (serving/control.py):
# priority classes (`interactive` | `batch`) with per-class admission and
# weighted dispatch, a per-model AIMD controller scaling the coalescing
# cap and max-wait against the measured `slo_burn_rate`, and a brownout
# phase machine that sheds batch-class load first.
#
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from ..config import get_config
from ..telemetry.locks import named_lock
from ..telemetry.registry import counter, gauge, histogram
from ..tracing import (
    adopt_trace_context,
    event,
    get_trace_events,
    mint_run_id,
    run_context,
    trace,
)
from ..utils import get_logger
from ._seams import MONITOR, note_failure
from .control import PRIORITY_CLASSES, ServingController, resolve_priority
from .registry import ModelRegistry, PinnedModel

logger = get_logger("spark_rapids_ml_torch.serving")

# sub-millisecond to seconds: serving latencies sit far below the
# default fit-scale buckets
_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
_BATCH_BUCKETS = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
    1024.0, 2048.0, 4096.0, 8192.0,
)

LATENCY = histogram(
    "serving_request_latency_seconds",
    "Per-request serving latency by phase (queue|dispatch|total)",
    buckets=_LATENCY_BUCKETS,
)
BATCH_ROWS = histogram(
    "serving_batch_rows",
    "Rows per coalesced serving dispatch",
    buckets=_BATCH_BUCKETS,
)
REQUESTS = counter(
    "serving_requests_total", "Admitted serving requests by model"
)
REJECTIONS = counter(
    "serving_rejections_total",
    "Rejected serving requests by model and reason",
)
SLO_BURN = gauge(
    "slo_burn_rate",
    "Measured over-p99-target request fraction / the 1% error budget, "
    "per model and window",
)
# queueing sensors for the feedback controller: live queued requests per
# model,
# and how far past its intended wake deadline the dispatcher loop ran —
# a loop lagging its own deadlines is saturated before p99 shows it
QUEUE_DEPTH = gauge(
    "serving_queue_depth", "Requests queued awaiting dispatch, per model"
)
DISPATCH_LAG = gauge(
    "serving_dispatcher_lag_seconds",
    "Dispatcher wake overshoot past its intended deadline",
)
# staged-pipeline sensors: the resolved depth (conf or auto) and the
# live slot occupancy — occupancy pinned at depth means the pipeline is
# full and depth is the throughput limiter
PIPELINE_DEPTH = gauge(
    "serving_pipeline_depth",
    "Resolved in-flight batch depth of the staged dispatch pipeline",
)
PIPELINE_INFLIGHT = gauge(
    "serving_pipeline_inflight",
    "Dispatched batches currently occupying pipeline slots",
)

# window the report()'s serving utilization summary covers
_UTILIZATION_WINDOW_S = 60.0

# exact per-model latency samples for the p50/p99 report (the registry
# histogram's buckets are for Prometheus; percentiles in the per-model
# report come from real samples, bounded per model)
_REPORT_SAMPLES = 4096

# clean batches between each doubling of an OOM-shrunk coalescing cap
# back toward the configured value
_CAP_REGROW_BATCHES = 32

# hard ceiling on explicit `serving_pipeline_depth` values: past the
# pipeline's own stage count, extra depth only holds more staged
# batches resident in device memory and lengthens the requeue window a
# mid-flight failure must drain
_MAX_PIPELINE_DEPTH = 8
# the auto depth re-resolves from the serving idle-gap profile at most
# this often (the summarize() fold walks the interval deque)
_DEPTH_REFRESH_S = 1.0

# CUDA streams of the pipeline's slots, used round-robin: a stream is
# reused only after `_MAX_PIPELINE_DEPTH` later dispatches, by which time
# its flight has been collected
_N_STREAMS = _MAX_PIPELINE_DEPTH

# SLO burn-rate windows the sensor gauges report over (label value ->
# seconds); the budget is the 1% a p99 target implies
_SLO_WINDOWS = (("1m", 60.0), ("5m", 300.0))
_SLO_BUDGET = 0.01
# burn gauges refresh at most once per this many seconds per model (the
# window scan walks a bounded deque; no reason to pay it per request)
_SLO_REFRESH_S = 1.0

# slow-request span-tree captures retained (operator post-hoc view)
_MAX_SLOW_TRACES = 32

# sustained-overload detection: this many queue_full rejections inside
# the window is one sustained-overload failure (`note_failure`)
_OVERLOAD_DUMP_COUNT = 20
_OVERLOAD_WINDOW_S = 5.0


class ServingOverload(RuntimeError):
    """Typed admission-control rejection: the request queue is at
    `serving_max_queue` (or the server is not accepting).  Callers shed
    load or retry with backoff; the request was NOT enqueued."""

    def __init__(self, model: str, reason: str, detail: str = "") -> None:
        super().__init__(
            f"serving overloaded ({reason}) for model {model!r}"
            + (f": {detail}" if detail else "")
        )
        self.model = model
        self.reason = reason


class ServingDeviceError(RuntimeError):
    """The card's CUDA context was poisoned by a sticky error (a
    device-side assert, an illegal memory access, ...): the server failed
    every request in flight and queued with this error and stopped.
    `cause` holds the CUDA error.  A fresh process is the recovery."""

    def __init__(self, cause: BaseException) -> None:
        super().__init__(
            f"the CUDA context is lost ({type(cause).__name__}: {cause}); "
            "the serving server stopped"
        )
        self.cause = cause


class _Request:
    __slots__ = (
        "model", "X", "rows", "t_enqueue", "future", "attempts", "req_id",
        "priority",
    )

    def __init__(
        self, model: str, X: np.ndarray, request_id: Optional[str] = None,
        priority: str = "interactive",
    ) -> None:
        self.model = model
        self.X = X
        # admission/dispatch class (resolved BEFORE construction):
        # decides which per-class deque the request queues on, which
        # admission bound applies, and whether a brownout sheds it
        self.priority = priority
        self.rows = int(X.shape[0])
        self.t_enqueue = time.perf_counter()
        self.future: Future = Future()
        # failed dispatch/collect rounds THIS request has been through:
        # the retry budget is per request, so one model's poisoned batch
        # can neither exhaust another model's attempts nor ride interleaved
        # successes to retry forever
        self.attempts = 0
        # the request's trace identity: minted at ingress (or adopted
        # from the caller's X-Request-Id), carried through the batch
        # dispatch spans and attached to the latency observations as an
        # exemplar — the join key between a latency bucket and a trace
        self.req_id = request_id or mint_run_id("req")


class _InFlight:
    """One dispatched micro-batch riding the async pipeline: the
    requests it carries, the staging layout, its outputs (`dev`: tensors
    on the CPU, or, on a card, pinned host tensors their copies are
    filling; `host_outs`: a host-path model's numpy outputs), the CUDA
    event recorded after those copies (None on the CPU), and the device
    tensors the batch's work reads and writes, held until that event has
    completed."""

    __slots__ = ("name", "model", "reqs", "rows", "stager", "dev",
                 "host_outs", "t_dispatch", "batch_id", "event", "keep",
                 "begin")

    def __init__(self, name, model, reqs, rows, stager, dev, host_outs,
                 t_dispatch, batch_id="", event=None, keep=None,
                 begin=None) -> None:
        self.name = name
        # the dispatched model rides the flight: collect must fetch with
        # the SAME object the device outputs came from — a registry
        # re-resolve there could re-pin an evicted model (a full weight
        # re-replication on the latency-critical fetch path) or raise
        # for one unregistered between dispatch and collect, failing
        # finished, fetchable work
        self.model = model
        self.reqs = reqs
        self.rows = rows
        self.stager = stager
        self.dev = dev
        self.host_outs = host_outs
        self.t_dispatch = t_dispatch
        # the run id the batch's dispatch/collect spans carry: collect
        # re-enters it so the whole queue->scatter tree of one batch
        # correlates, and the slow-request capture filters by it
        self.batch_id = batch_id
        self.event = event
        self.keep = keep
        # a timing event recorded on the slot's stream before the batch's
        # staging: with `event` it times the batch's stream work
        self.begin = begin


class ServingServer:
    """The in-process serving runtime: a model registry, per-model
    request queues, and one dispatcher thread.  `register` models, then
    `start()`; submit work through a `ServingClient` (or `transform`
    directly).  `stop()` drains the queue before the thread exits."""

    def __init__(self, registry: Optional[ModelRegistry] = None) -> None:
        self.registry = registry or ModelRegistry()
        self._cv = named_lock("serving_dispatch", kind="condition")
        # two-level queues: model -> priority class -> deque.  The take
        # drains interactive heads first; admission bounds each class
        # separately (controller.admit), so _queued_cls tracks the
        # per-class share of the global _queued count
        self._queues: Dict[str, Dict[str, Deque[_Request]]] = {}
        self._queued = 0
        self._queued_cls: Dict[str, int] = {
            c: 0 for c in PRIORITY_CLASSES
        }
        # the feedback controller (serving/control.py): AIMD actuator
        # scales, the brownout phase machine, and the weighted-credit
        # class scheduler — ticked from the dispatcher loop
        self._controller = ServingController()
        self._ctl_last = 0.0
        self._running = False
        self._paused = False
        self._thread: Optional[threading.Thread] = None
        # True once the dispatcher's final cv-guarded exit check passed:
        # start() reads it UNDER the cv to decide revive-vs-spawn, so a
        # stop() whose join timed out mid-drain can never race a SECOND
        # dispatcher onto the same queues
        self._loop_done = True
        self._http = None
        # set once a sticky CUDA error stopped the server: the typed error
        # every later submit raises
        self._dead: Optional[ServingDeviceError] = None
        # the pipeline slots' CUDA streams (made at the first dispatch on
        # a card) and the next one to use
        self._streams: List[Any] = []
        self._stream_i = 0
        # degradation state: the OOM-shrunk coalescing cap (None = use
        # the configured/byte-model cap), re-grown after sustained clean
        # batches so one transient OOM does not cap QPS for the process
        # lifetime
        self._shrunk_cap: Optional[int] = None
        self._clean_batches = 0
        self._batches = 0
        # staged-pipeline state (all under the dispatch cv): dispatched
        # flights awaiting collect in DISPATCH ORDER (the collect worker
        # drains the left end), whether the worker is mid-collect (that
        # flight still occupies a pipeline slot until its scatter
        # finishes), the fault-handback slot the worker fills for the
        # dispatcher's recovery path, and the worker's stop flag
        self._inflight: Deque[_InFlight] = collections.deque()
        self._collecting = False
        self._pipe_fault: Optional[tuple] = None
        self._collect_stop = False
        # per-class round-robin cursor for the model interleave: the
        # last model name dispatched per priority class
        self._rr_last: Dict[str, str] = {}
        # auto-depth memo (monotonic ts, resolved depth), refreshed at
        # most once per _DEPTH_REFRESH_S; _depth_last de-dups the gauge
        self._auto_memo: tuple = (0.0, 2)
        self._depth_last = 0
        self._lat: Dict[str, Deque[float]] = {}
        # per-INSTANCE request/rejection counts for report(): the
        # registry counters are process-global by Prometheus design, and
        # a fresh server must not report a predecessor's history
        self._req_counts: Dict[str, int] = {}
        self._rej_counts: Dict[str, int] = {}
        # per-instance brownout sheds by model -> class (the registry's
        # serving_shed_total counter is process-global)
        self._shed_counts: Dict[str, Dict[str, int]] = {}
        self._lock = named_lock("serving_report")  # report/latency state
        # request-scoped tracing + SLO sensing state:
        #   _lat_ts     per-model (monotonic_t, total_s) samples feeding
        #               the windowed burn-rate scan (bounded like _lat)
        #   _slo_last   per-model monotonic time of the last burn refresh
        #   _slow       captured span trees of slow requests (bounded)
        #   _overload_ts queue_full rejection timestamps for the
        #               sustained-overload trigger (`note_failure`)
        self._lat_ts: Dict[str, Deque[tuple]] = {}
        self._slo_last: Dict[str, float] = {}
        self._slow: Deque[Dict[str, Any]] = collections.deque(
            maxlen=_MAX_SLOW_TRACES
        )
        self._overload_ts: Deque[float] = collections.deque(
            maxlen=_OVERLOAD_DUMP_COUNT
        )
        # serving_slo_targets parse memo: (conf string, parsed dict)
        self._slo_targets_memo: tuple = ("", {})

    # -- registration (delegates; kept here so one object serves) ----------

    def register(self, name: str, model: Any, dtype: Any = np.float32,
                 n_features: Optional[int] = None,
                 transform: Any = None,
                 priority: Optional[str] = None) -> None:
        self.registry.register(name, model, dtype=dtype,
                               n_features=n_features, transform=transform,
                               priority=priority)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingServer":
        if self._dead is not None:
            raise self._dead
        with self._cv:
            if self._running:
                return self
            self._running = True
            spawn = self._loop_done
            if spawn:
                self._loop_done = False
            self._cv.notify_all()
        if not spawn:
            # a previous stop() timed out mid-drain and its dispatcher
            # is still looping: setting _running under the cv revived it
            # (its exit check holds the same lock), so it resumes
            # serving — a second thread would race it on the queues.
            # The HTTP front end was torn down by that stop() and must
            # come back with the revive.
            self._maybe_start_http()
            return self
        # the dispatcher records spans/markers: adopt the starter's trace
        # buffer + run context so serving dispatch timings and resilience
        # markers land where the operator is looking
        adopt = adopt_trace_context()

        def _worker() -> None:
            adopt()
            self._loop()

        self._thread = threading.Thread(
            target=_worker, name="serving-dispatcher", daemon=True
        )
        self._thread.start()
        self._maybe_start_http()
        return self

    def _maybe_start_http(self) -> None:
        port = int(get_config("serving_port") or 0)
        if port > 0 and self._http is None:
            from .http import start_serving_http

            self._http = start_serving_http(self, port)

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        with self._cv:
            if not self._running:
                if self._dead is None:
                    return
                # a sticky error stopped the dispatcher already: reap it
                # and close the HTTP front end below
                drain = True
            self._running = False
            if not drain:
                doomed = [
                    r for by_cls in self._queues.values()
                    for q in by_cls.values() for r in q
                ]
                for name, by_cls in self._queues.items():
                    for q in by_cls.values():
                        q.clear()
                    QUEUE_DEPTH.set(0, model=name)
                self._queued = 0
                self._queued_cls = {c: 0 for c in PRIORITY_CLASSES}
            else:
                doomed = []
            self._cv.notify_all()
        for r in doomed:
            REJECTIONS.inc(model=r.model, reason="stopped")
            r.future.set_exception(
                ServingOverload(r.model, "stopped", "server shut down")
            )
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                logger.error(
                    f"serving dispatcher did not exit within {timeout:.0f}s "
                    "(drain backlog or wedged fetch); it will finish "
                    "draining in the background — start() would revive "
                    "it, not spawn a second dispatcher"
                )
            else:
                self._thread = None
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None

    def pause(self) -> None:
        """Hold dispatch (requests keep queueing) — maintenance windows
        and deterministic coalescing in tests."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    # -- submission ----------------------------------------------------------

    def submit(
        self, name: str, X: Any, request_id: Optional[str] = None,
        priority: Optional[str] = None,
    ) -> Future:
        """Enqueue one transform request; returns a Future resolving to
        `{output_col: np.ndarray}` with one row per input row.  Raises
        `ServingOverload` at the admission gate (never enqueued) and
        KeyError/ValueError for unknown models / wrong feature width /
        unknown priority classes.

        `priority` (`interactive` | `batch`) picks the admission class;
        unset it falls back to the model's registered default, then the
        `serving_priority_default` conf.  Batch-class admission is
        bounded to a `serving_batch_share` slice of the queue and is the
        first load a brownout sheds — background scoring can never
        starve the interactive path.

        Every admitted request gets a REQUEST ID (minted here, or
        `request_id` when the caller/HTTP ingress supplies one):
        exposed as `.request_id` on the returned Future, carried through
        the batch's dispatch spans, and attached to the latency
        observations as an exemplar."""
        from ..resilience import maybe_inject

        if self._dead is not None:
            raise self._dead
        info = self.registry.info(name)  # KeyError for unknown models
        cls = resolve_priority(priority, info.get("priority"))
        # deterministic fault hook for the admission path itself
        # (`serving_admission`): raises BEFORE the
        # request touches a queue, so injection drills never leak a
        # half-admitted request
        maybe_inject("serving_admission")
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError(
                f"serving input must be a non-empty (rows, features) "
                f"block, got shape {X.shape}"
            )
        want = info.get("n_features")
        if want is None:
            # width-blind registration: the first request's width becomes
            # canonical, so mixed-width traffic is rejected HERE instead
            # of poisoning a coalesced batch at np.concatenate
            want = self.registry.pin_feature_width(name, int(X.shape[1]))
        if int(X.shape[1]) != int(want):
            raise ValueError(
                f"model {name!r} expects {want} features, got {X.shape[1]}"
            )
        req = _Request(name, X, request_id=request_id, priority=cls)
        req.future.request_id = req.req_id
        overload_detail = ""
        with self._cv:
            if self._dead is not None:
                raise self._dead
            if not self._running:
                REJECTIONS.inc(model=name, reason="stopped")
                raise ServingOverload(name, "stopped", "server not running")
            admitted, reason, detail = self._controller.admit(
                name, cls, self._queued, self._queued_cls[cls],
                self._max_queue(),
            )
            if not admitted:
                REJECTIONS.inc(model=name, reason=reason)
                with self._lock:
                    if reason == "shed":
                        by_cls = self._shed_counts.setdefault(name, {})
                        by_cls[cls] = by_cls.get(cls, 0) + 1
                    else:
                        self._rej_counts[name] = (
                            self._rej_counts.get(name, 0) + 1
                        )
                if reason == "queue_full":
                    overload_detail = self._note_overload_locked(name)
            else:
                by_cls = self._queues.setdefault(
                    name, {c: collections.deque() for c in PRIORITY_CLASSES}
                )
                by_cls[cls].append(req)
                self._queued += 1
                self._queued_cls[cls] += 1
                QUEUE_DEPTH.set(self._depth_locked(name), model=name)
                self._cv.notify_all()
        if not admitted:
            if reason == "shed":
                # brownout policy rejection: counted per class (the
                # controller's shed counter), never the overload dump —
                # shedding IS the controller working, not a failure
                self._controller.note_shed(name, cls)
            elif overload_detail:
                # noted OUTSIDE the cv
                note_failure(
                    "serving_overload", detail=overload_detail, log=logger
                )
            raise ServingOverload(name, reason, detail)
        REQUESTS.inc(model=name)
        with self._lock:
            self._req_counts[name] = self._req_counts.get(name, 0) + 1
        return req.future

    def _note_overload_locked(self, name: str) -> str:
        """Called (under the cv) on every queue_full rejection: a burst
        of `_OVERLOAD_DUMP_COUNT` rejections inside `_OVERLOAD_WINDOW_S`
        is SUSTAINED overload, a typed failure.  Returns its detail
        string when the threshold trips (the caller notes it after
        releasing the cv), else ''."""
        now = time.monotonic()
        self._overload_ts.append(now)
        if (
            len(self._overload_ts) == self._overload_ts.maxlen
            and now - self._overload_ts[0] <= _OVERLOAD_WINDOW_S
        ):
            return (
                f"model={name} queued={self._queued} "
                f"max_queue={self._max_queue()} "
                f"{len(self._overload_ts)} rejections in "
                f"{now - self._overload_ts[0]:.2f}s"
            )
        return ""

    def transform(self, name: str, X: Any,
                  timeout: Optional[float] = None,
                  request_id: Optional[str] = None,
                  priority: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Blocking convenience over `submit`."""
        return self.submit(
            name, X, request_id=request_id, priority=priority
        ).result(timeout=timeout)

    # -- report --------------------------------------------------------------

    def _model_entry(self, name: str) -> Dict[str, Any]:
        """One model's report entry (the shared body of `report()` and
        `model_detail`)."""
        with self._lock:
            lat = list(self._lat.get(name, ()))
            requests = self._req_counts.get(name, 0)
            rejections = self._rej_counts.get(name, 0)
            shed = dict(self._shed_counts.get(name, ()))
        entry: Dict[str, Any] = {
            # per-instance counts: the prometheus families are
            # process-global, a fresh server must not report a
            # predecessor's history
            "requests": requests,
            "rejections_queue_full": rejections,
            # O(1) membership probe — the sorted pinned_names() list
            # costs O(n log n) per poll at hundreds of pinned models
            "pinned": self.registry.is_pinned(name),
        }
        if lat:
            srt = sorted(lat)

            def _pct(p: float) -> float:
                i = min(len(srt) - 1, int(round(p * (len(srt) - 1))))
                return srt[i]

            entry.update(
                latency_samples=len(srt),
                p50_ms=round(_pct(0.50) * 1e3, 3),
                p99_ms=round(_pct(0.99) * 1e3, 3),
                mean_ms=round(sum(srt) / len(srt) * 1e3, 3),
            )
        target_s = self._slo_target_s(name)
        if target_s > 0:
            entry["slo_p99_target_ms"] = round(target_s * 1e3, 3)
            for window, _span in _SLO_WINDOWS:
                burn = SLO_BURN.value(
                    default=None, model=name, window=window
                )
                if burn is not None:
                    entry[f"slo_burn_{window}"] = burn
        # drift summary: absent until the drift monitor is ported (the
        # seam tracks no model)
        drift = MONITOR.summary(name)
        if drift is not None:
            entry["drift"] = drift
        # the control plane's actuator state for THIS model: the
        # effective (scaled) cap and max-wait the dispatcher uses right
        # now, the brownout phase, per-class shed counts, and the
        # padding classes its batches are padded to
        st = self._controller.model_state(name)
        entry["controller"] = {
            "cap": self._batch_cap(name, self._safe_info(name)),
            "max_wait_ms": round(self._max_wait_s(name) * 1e3, 3),
            "brownout_phase": st["brownout_phase"],
            "shed": shed,
            "padding_classes": st["padding_classes"],
        }
        return entry

    def report(self) -> Dict[str, Any]:
        """Per-model serving report: request/batch counts, mean batch
        rows, and exact p50/p99 latency over the last `_REPORT_SAMPLES`
        requests — the operator-facing SLO view."""
        out: Dict[str, Any] = {}
        for name in self.registry.names():
            out[name] = self._model_entry(name)
        with self._lock:
            n_slow = len(self._slow)
            shed_total = {
                cls: sum(
                    by_cls.get(cls, 0)
                    for by_cls in self._shed_counts.values()
                )
                for cls in PRIORITY_CLASSES
            }
        ctl = self._controller
        share = ctl.batch_share()
        with self._cv:
            pipeline = {
                "depth": self._pipeline_depth(),
                "inflight": len(self._inflight)
                + (1 if self._collecting else 0),
                "interleave": bool(
                    get_config("serving_pipeline_interleave")
                ),
            }
        out["_totals"] = {
            "batches": self._batches,
            "queued": self._queued,
            "pinned_bytes": self.registry.pinned_bytes(),
            "slow_traces": n_slow,
            "pipeline": pipeline,
            "controller": {
                "enabled": ctl.enabled(),
                # contested dispatch rounds split credit-weighted:
                # interactive always holds a full share, batch accrues
                # `serving_batch_share` credit per interactive win
                "priority_shares": {"interactive": 1.0, "batch": share},
                "shed": shed_total,
                "brownout": ctl.brownout_summary(),
            },
        }
        # the serving utilization view (telemetry/utilization.py): how
        # busy the device was over the recent window and what the idle
        # gaps are attributable to (lock waits, host-side dispatch)
        from ..telemetry import utilization

        util = utilization.summarize(
            window_s=_UTILIZATION_WINDOW_S, scope="serving",
            domain="serving",
        )
        if util:
            out["_totals"]["utilization"] = util
        return out

    def pipeline_info(self) -> Dict[str, Any]:
        """The staged pipeline's operator view (`GET /v1/pipeline`):
        resolved depth (explicit conf or auto), the conf value it came
        from, live slot occupancy, the interleave flag, and the serving
        utilization window — busy fraction plus the idle-gap table the
        depth tuning keys off."""
        with self._cv:
            out: Dict[str, Any] = {
                "depth": self._pipeline_depth(),
                "depth_conf": int(
                    get_config("serving_pipeline_depth") or 0
                ),
                "inflight": len(self._inflight)
                + (1 if self._collecting else 0),
                "interleave": bool(
                    get_config("serving_pipeline_interleave")
                ),
                "batches": self._batches,
            }
        from ..telemetry import utilization

        util = utilization.summarize(
            window_s=_UTILIZATION_WINDOW_S, domain="serving"
        )
        if util:
            out["utilization"] = util
        return out

    def model_detail(self, name: str) -> Dict[str, Any]:
        """Everything about ONE served model — pin status and accounted
        bytes, the latency/SLO report entry, and the drift summary (the
        `GET /v1/models/<name>` payload) — built for THIS model only
        (a dashboard polling every model must not pay a full all-model
        report per request).  KeyError for unknown names."""
        info = self.registry.pin_info(name)  # KeyError gate
        entry = self._model_entry(name)
        return {"model": name, **info, **entry}

    # -- sizing --------------------------------------------------------------

    def _max_queue(self) -> int:
        return max(1, int(get_config("serving_max_queue")))

    def _max_wait_s(self, name: Optional[str] = None) -> float:
        """Coalescing max-wait in seconds; with `name`, scaled by the
        controller's AIMD wait actuator (burn shrinks it so batches
        dispatch earlier and smaller)."""
        wait = max(0.0, float(get_config("serving_max_wait_ms"))) / 1e3
        if name is not None:
            wait *= self._controller.wait_scale(name)
        return wait

    def _depth_locked(self, name: str) -> int:
        """Queued requests for `name` across both priority classes
        (called under the cv; feeds `serving_queue_depth`)."""
        return sum(len(q) for q in self._queues.get(name, {}).values())

    def _safe_info(self, name: str) -> Optional[Dict[str, Any]]:
        """Registration facts, or None for a model unregistered while
        requests were still queued — the dispatcher must keep running
        and FAIL those requests (via the dispatch-time KeyError), never
        die on the lookup."""
        try:
            return self.registry.info(name)
        except KeyError:
            return None

    def _base_cap(self, info: Optional[Dict[str, Any]]) -> int:
        """Rows one coalesced dispatch may carry BEFORE SLO control:
        the configured cap, bounded by the byte model every staged
        transfer is sized by (`host_batch_bytes` / row bytes), then by
        the OOM-degraded shrink cap.  The OOM shrink stays here — it is
        the emergency memory actuator the AIMD scale layers on top of,
        never replaces."""
        from ..streaming import chunk_rows_for

        cap = max(1, int(get_config("serving_max_batch_rows")))
        d = info.get("n_features") if info else None
        if d:
            cap = min(
                cap,
                int(chunk_rows_for(int(d), np.dtype(info["dtype"]).itemsize)),
            )
        if self._shrunk_cap is not None:
            cap = min(cap, self._shrunk_cap)
        return max(1, cap)

    def _batch_cap(
        self, name: str, info: Optional[Dict[str, Any]]
    ) -> int:
        """The effective coalescing cap: the base cap scaled by the
        controller's AIMD cap actuator for this model."""
        cap = self._base_cap(info)
        scale = self._controller.cap_scale(name)
        if scale < 1.0:
            cap = max(1, int(cap * scale))
        return cap

    def _cap_wait(
        self, name: str, info: Optional[Dict[str, Any]]
    ) -> tuple:
        """Effective (cap, max_wait_s) for one model in ONE controller
        lock acquisition (`controller.scales`).  The coalesce scan reads
        both per queued model per round — at hundreds of pinned models
        the separate `cap_scale`/`wait_scale` reads would double the
        hot-path lock traffic, and a controller tick landing between
        them could pair an old cap with a new wait.  Scale changes
        therefore apply at the NEXT coalesce, atomically, never to a
        batch mid-flight."""
        cap_scale, wait_scale = self._controller.scales(name)
        cap = self._base_cap(info)
        if cap_scale < 1.0:
            cap = max(1, int(cap * cap_scale))
        wait = max(0.0, float(get_config("serving_max_wait_ms"))) / 1e3
        return cap, wait * wait_scale

    def _oom_floor(self) -> int:
        """Smallest useful coalescing cap: one row (one card; the same
        floor the transform chunk loop shrinks to)."""
        return 1

    # -- pipeline depth ------------------------------------------------------

    def _pipeline_depth(self) -> int:
        """How many dispatched batches may occupy pipeline slots at
        once.  Explicit `serving_pipeline_depth` values clamp to
        [1, _MAX_PIPELINE_DEPTH] (1 = fully serialized, the byte-parity
        baseline); 0 resolves automatically from the serving idle-gap
        profile.  Called under the cv (the memo/gauge state rides the
        dispatcher)."""
        raw = int(get_config("serving_pipeline_depth") or 0)
        if raw >= 1:
            depth = min(raw, _MAX_PIPELINE_DEPTH)
        else:
            depth = self._auto_depth()
        if depth != self._depth_last:
            self._depth_last = depth
            PIPELINE_DEPTH.set(depth)
        return depth

    def _auto_depth(self) -> int:
        """Auto depth from the utilization timeline: start at 2 (the
        classic collect-N-while-dispatching-N+1 overlap) and deepen
        while the gap table says host-side serving phases are stealing
        device-idle seconds — >10% of the observed wall buys one extra
        slot, >25% a second, bounded by `serving_pipeline_max_depth`.
        Rate-limited by `_DEPTH_REFRESH_S`; never raises (the profile
        is advice, not a dependency)."""
        now = time.monotonic()
        ts, memo = self._auto_memo
        if now - ts < _DEPTH_REFRESH_S:
            return memo
        depth = 2
        try:
            from ..telemetry import utilization

            util = utilization.summarize(
                window_s=_UTILIZATION_WINDOW_S, domain="serving"
            )
            wall = float(util.get("wall_s", 0.0)) if util else 0.0
            if wall > 0:
                host_stolen = sum(
                    float(row.get("stolen_s", 0.0))
                    for row in util.get("gap_attribution", ())
                    if row.get("kind") in (
                        "dispatch", "stage", "compute", "collect",
                        "scatter", "host_prep",
                    )
                )
                frac = host_stolen / wall
                if frac > 0.10:
                    depth += 1
                if frac > 0.25:
                    depth += 1
            cap = max(2, int(get_config("serving_pipeline_max_depth")))
            depth = min(depth, cap)
        except Exception:
            depth = 2
        self._auto_memo = (now, depth)
        return depth

    # -- dispatcher ----------------------------------------------------------

    def _ready_name_locked(self, now: float, draining: bool) -> Optional[str]:
        """The queued model whose head request is due: past the (AIMD-
        scaled, per-model) max-wait SLO, a full batch already queued, or
        the server draining.  When BOTH classes hold a due head the
        controller's weighted credit picks the class — batch gets
        `serving_batch_share` credit per interactive win, so neither
        class starves the other.  Within the chosen class, the
        `serving_pipeline_interleave` round-robin rotates across ALL
        due models (no model starves behind a hot one AND no hot model
        monopolizes consecutive pipeline slots); with the interleave
        off, the oldest due head wins outright."""
        due: Dict[str, List[tuple]] = {}  # class -> [(t_enqueue, name)]
        for name, by_cls in self._queues.items():
            if not any(by_cls.values()):
                continue
            info = self._safe_info(name)
            cap, wait = self._cap_wait(name, info)
            rows = 0
            full = False
            for cls in PRIORITY_CLASSES:
                for r in by_cls[cls]:
                    rows += r.rows
                    if rows >= cap:
                        full = True
                        break
                if full:
                    break
            for cls in PRIORITY_CLASSES:
                q = by_cls[cls]
                if not q:
                    continue
                head = q[0]
                ready = (
                    draining
                    or info is None  # unregistered: dispatch fails it NOW
                    or (now - head.t_enqueue) >= wait
                    or full
                )
                if ready:
                    due.setdefault(cls, []).append((head.t_enqueue, name))
        if not due:
            return None
        if len(due) == 1:
            cls = next(iter(due))
        elif not self._controller.enabled():
            # plain oldest-head-first across classes
            cls = min((min(v), c) for c, v in due.items())[1]
        else:
            cls = self._controller.pick_class()
        entries = due[cls]
        if len(entries) == 1 or not bool(
            get_config("serving_pipeline_interleave")
        ):
            return min(entries)[1]
        # cyclic pick: the first due name (sorted order) strictly after
        # the last model this class dispatched, wrapping to the start —
        # per-model FIFO is untouched (each model's class deque still
        # drains front-first), only the CROSS-model order rotates
        names = sorted({n for _, n in entries})
        last = self._rr_last.get(cls, "")
        choice = next((n for n in names if n > last), names[0])
        self._rr_last[cls] = choice
        return choice

    def _take_batch_locked(self, name: str) -> List[_Request]:
        by_cls = self._queues[name]
        cap = self._batch_cap(name, self._safe_info(name))
        reqs: List[_Request] = []
        rows = 0
        # interactive heads coalesce first; batch-class rows fill the
        # remaining cap, so a shared dispatch never displaces the
        # latency-sensitive work that triggered it
        for cls in PRIORITY_CLASSES:
            q = by_cls[cls]
            while q and (not reqs or rows + q[0].rows <= cap):
                r = q.popleft()
                self._queued -= 1
                self._queued_cls[cls] -= 1
                if r.future.cancelled():
                    continue  # the caller gave up while it queued
                reqs.append(r)
                rows += r.rows
        QUEUE_DEPTH.set(self._depth_locked(name), model=name)
        return reqs

    def _requeue_front(self, reqs: List[_Request]) -> None:
        with self._cv:
            for r in reversed(reqs):
                by_cls = self._queues.setdefault(
                    r.model,
                    {c: collections.deque() for c in PRIORITY_CLASSES},
                )
                by_cls[r.priority].appendleft(r)
                self._queued += 1
                self._queued_cls[r.priority] += 1
            for name in {r.model for r in reqs}:
                QUEUE_DEPTH.set(self._depth_locked(name), model=name)
            self._cv.notify_all()

    def _next_deadline_locked(self, now: float) -> float:
        if self._paused and self._running:
            return 0.5  # resume() notifies; no deadline to honor
        deadline = None
        for name, by_cls in self._queues.items():
            wait = self._max_wait_s(name)
            for q in by_cls.values():
                if q:
                    due = q[0].t_enqueue + wait
                    deadline = (
                        due if deadline is None else min(deadline, due)
                    )
        if deadline is None:
            return 0.5
        return max(1e-4, min(deadline - now, 0.5))

    def _lag_locked(self, name: str, now: float) -> float:
        """How far past its intended dispatch deadline the loop is for
        `name`'s oldest head — published on EVERY dispatch round, so the
        gauge stays live under a saturated queue instead of freezing at
        the last idle wake's overshoot."""
        heads = [
            q[0].t_enqueue
            for q in self._queues.get(name, {}).values() if q
        ]
        if not heads:
            return 0.0
        return round(
            max(0.0, now - (min(heads) + self._max_wait_s(name))), 6
        )

    def _loop(self) -> None:
        # the staged pipeline's two threads: THIS thread coalesces,
        # stages and launches device programs; the collect worker drains
        # finished flights (fetch + scatter).  The worker adopts the
        # dispatcher's (already-adopted) trace buffer, so one batch's
        # dispatch->collect span tree stays one tree no matter which
        # thread recorded which half.
        with self._cv:
            self._collect_stop = False
        adopt = adopt_trace_context()

        def _collector() -> None:
            adopt()
            self._collect_loop()

        collector = threading.Thread(
            target=_collector, name="serving-collect", daemon=True
        )
        collector.start()
        while True:
            batch: Optional[List[_Request]] = None
            fault: Optional[tuple] = None
            with self._cv:
                while True:
                    now = time.perf_counter()
                    # a collect-side failure outranks new work: consume
                    # the handback (plus any flight that raced in after
                    # the worker filled it — its requests are LATER in
                    # FIFO order than the failed ones, so letting it
                    # complete would reorder a model's class queue) and
                    # recover outside the cv
                    if self._pipe_fault is not None:
                        e, reqs = self._pipe_fault
                        self._pipe_fault = None
                        reqs = list(reqs)
                        for fl in self._inflight:
                            reqs.extend(fl.reqs)
                        self._inflight.clear()
                        PIPELINE_INFLIGHT.set(
                            1 if self._collecting else 0
                        )
                        self._cv.notify_all()
                        fault = (e, reqs)
                        break
                    draining = not self._running
                    depth = self._pipeline_depth()
                    slots = len(self._inflight) + (
                        1 if self._collecting else 0
                    )
                    blocked = slots >= depth
                    name = (
                        None
                        if blocked or (self._paused and self._running)
                        else self._ready_name_locked(now, draining)
                    )
                    if name is not None:
                        # loop-lag publishes on EVERY dispatch round
                        # (not only the timed-out idle wake below): a
                        # saturated dispatcher never idles, and a gauge
                        # frozen at the last idle overshoot would hide
                        # exactly the lag the controller acts on
                        DISPATCH_LAG.set(self._lag_locked(name, now))
                        batch = self._take_batch_locked(name) or None
                        if batch is None:
                            # nothing but cancelled requests: re-scan
                            continue
                        break
                    if (
                        draining and self._queued == 0
                        and not self._inflight and not self._collecting
                    ):
                        break
                    # with the pipeline full the head deadline is moot
                    # (no slot to dispatch into); wait for the worker's
                    # slot-free notify instead of spinning on it
                    t_wait = (
                        0.5 if blocked
                        else self._next_deadline_locked(now)
                    )
                    if not self._cv.wait(timeout=t_wait):
                        # timed-out idle tick: break to the outer loop so
                        # _refresh_slo_all runs (burn gauges must decay
                        # when traffic STOPS; with work ready the very
                        # next inner pass picks it up).  The overshoot
                        # past the intended deadline is the loop-lag
                        # sensor: a dispatcher that cannot wake on time
                        # is saturated before p99 shows it.
                        DISPATCH_LAG.set(
                            round(
                                max(
                                    0.0,
                                    time.perf_counter() - now - t_wait,
                                ),
                                6,
                            )
                        )
                        break
            if fault is not None:
                self._recover_guarded(fault[0], list(fault[1]))
                self._controller_tick()
                continue
            if batch is None:
                with self._cv:
                    if (
                        not self._running and self._queued == 0
                        and not self._inflight and not self._collecting
                        and self._pipe_fault is None
                    ):
                        # final exit decision under the cv: start() reads
                        # _loop_done under the same lock, so revive and
                        # exit cannot interleave into a dead server
                        self._collect_stop = True
                        self._loop_done = True
                        self._cv.notify_all()
                        collector_done = True
                    else:
                        collector_done = False
                if collector_done:
                    collector.join(timeout=10.0)
                    return
                self._refresh_slo_all()
                self._controller_tick()
                continue
            # a dispatch error belongs to THIS batch only — earlier
            # flights are already computing and stay in the pipeline for
            # the worker to collect, so a fatal error for one model can
            # never fail another model's healthy in-flight work
            try:
                flight = self._dispatch(batch)
            except Exception as e:
                self._recover_guarded(e, list(batch))
            else:
                with self._cv:
                    self._inflight.append(flight)
                    PIPELINE_INFLIGHT.set(
                        len(self._inflight)
                        + (1 if self._collecting else 0)
                    )
                    self._cv.notify_all()
            # feedback step AFTER the round's dispatch: the busy path
            # must tick too — an overloaded dispatcher never reaches
            # the idle branch, and that is exactly when control matters
            # (rate-limited inside, so the hot loop pays ~0)
            self._controller_tick()

    def _collect_loop(self) -> None:
        """The collect worker: pop the oldest in-flight batch, fetch +
        scatter it, repeat.  Runs until the dispatcher's exit path sets
        `_collect_stop` with the pipeline drained.  A collect failure
        drains EVERY in-flight flight into one `_pipe_fault` handback
        (requests in dispatch order — oldest first, so the dispatcher's
        front-requeue preserves per-model/per-class FIFO) and parks
        until the dispatcher consumes it; the worker itself never
        recovers (recovery requeues and repins — dispatcher-side state
        transitions)."""
        while True:
            with self._cv:
                while not self._inflight or self._pipe_fault is not None:
                    if (
                        self._collect_stop
                        and not self._inflight
                        and self._pipe_fault is None
                    ):
                        return
                    self._cv.wait(timeout=0.5)
                flight = self._inflight.popleft()
                # the popped flight still occupies a pipeline slot until
                # its scatter finishes — without this, depth 1 would let
                # the dispatcher stage batch N+1 while N scatters, and
                # "fully serialized" would be a lie
                self._collecting = True
                PIPELINE_INFLIGHT.set(len(self._inflight) + 1)
                self._cv.notify_all()
            try:
                self._collect(flight)
            except Exception as e:
                with self._cv:
                    reqs = list(flight.reqs)
                    for fl in self._inflight:
                        reqs.extend(fl.reqs)
                    self._inflight.clear()
                    self._collecting = False
                    PIPELINE_INFLIGHT.set(0)
                    self._pipe_fault = (e, reqs)
                    self._cv.notify_all()
            else:
                with self._cv:
                    self._collecting = False
                    self._batches += 1
                    PIPELINE_INFLIGHT.set(len(self._inflight))
                    self._cv.notify_all()
                self._note_clean_batch()

    # -- dispatch / collect --------------------------------------------------

    @staticmethod
    def _req_id_detail(reqs: List[_Request]) -> str:
        """Bounded request-id list for span details (the ids are the
        exemplar join keys; a 4096-row batch must not serialize 4096 of
        them into one detail string)."""
        ids = [r.req_id for r in reqs[:8]]
        more = len(reqs) - len(ids)
        return ",".join(ids) + (f",+{more}" if more > 0 else "")

    def _dispatch(self, reqs: List[_Request]) -> _InFlight:
        """Stage one coalesced batch and launch its device work (on a card
        the staging copy, the transform and the outputs' copy to pinned
        host memory are queued on the slot's stream when this returns).
        Host-path models (no `_transform_device`) compute synchronously
        here instead.

        The whole batch runs under a minted `batch-<hex>` run id: the
        dispatch span and its coalesce/stage/compute children (and the
        collect/scatter spans next round) all carry it, so one request's
        path through the server reconstructs as one tree — the
        slow-request capture keys off it."""
        from ..telemetry import utilization

        name = reqs[0].model
        pinned: PinnedModel = self.registry.resolve(name)
        rows = sum(r.rows for r in reqs)
        t0 = time.perf_counter()
        try:
            return self._dispatch_timed(reqs, name, pinned, rows, t0)
        finally:
            # the host-side dispatch window (coalesce + stage + the
            # async compute launch) feeds the serving utilization
            # timeline; the device window lands at collect
            utilization.note_interval(
                "dispatch", t0, time.perf_counter(), cause=name,
                domain="serving",
            )

    def _slot_stream(self, device) -> Any:
        """The CUDA stream of the next pipeline slot (round-robin over
        `_N_STREAMS`, made at the first use)."""
        import torch

        if not self._streams:
            self._streams = [torch.cuda.Stream(device) for _ in range(_N_STREAMS)]
        stream = self._streams[self._stream_i]
        self._stream_i = (self._stream_i + 1) % len(self._streams)
        return stream

    def _dispatch_timed(
        self, reqs: List[_Request], name: str, pinned: PinnedModel,
        rows: int, t0: float,
    ) -> _InFlight:
        import contextlib

        import torch

        from ..parallel.mesh import RowStager
        from ..resilience import maybe_inject
        from ..telemetry import utilization

        with run_context(prefix="batch") as batch_id:
            with trace(f"serving_dispatch[{name}]", logger):
                event(
                    f"serving_batch[{name}]",
                    detail=(
                        f"rows={rows} reqs={len(reqs)} "
                        f"ids={self._req_id_detail(reqs)}"
                    ),
                )
                maybe_inject("serving_dispatch")
                with trace("serving_coalesce", logger):
                    X = (
                        reqs[0].X
                        if len(reqs) == 1
                        else np.concatenate([r.X for r in reqs], axis=0)
                    )
                BATCH_ROWS.observe(rows, model=name)
                if not pinned.device:
                    t_c = time.perf_counter()
                    with trace("serving_compute", logger):
                        X = np.ascontiguousarray(X, dtype=pinned.dtype)
                        outs = pinned.transform_fn(X)
                    utilization.note_interval(
                        "compute", t_c, time.perf_counter(), cause=name,
                        domain="serving",
                    )
                    return _InFlight(
                        name, pinned.model, reqs, rows, None, None, outs,
                        t0, batch_id,
                    )
                target = pinned.torch_device
                stream = (
                    self._slot_stream(target) if target.type == "cuda" else None
                )
                on_stream = (
                    torch.cuda.stream(stream) if stream is not None
                    else contextlib.nullcontext()
                )
                begin = None
                if stream is not None:
                    begin = torch.cuda.Event(enable_timing=True)
                    begin.record(stream)
                t_s = time.perf_counter()
                with trace("serving_stage", logger), on_stream:
                    # padding classes: every coalesced size of a bucket
                    # computes with one product shape (serving/control.py)
                    bucketing = None
                    if self._controller.padding_enabled():
                        self._controller.note_bucket(name, rows)
                        bucketing = True
                    # telemetry=False: a request-rate micro-batch is not a
                    # dataset staging
                    st = RowStager.for_replicated(
                        rows, target, bucketing=bucketing, telemetry=False,
                    )
                    Xs = st.stage(np.ascontiguousarray(X), pinned.dtype)
                t_c = time.perf_counter()
                utilization.note_interval(
                    "stage", t_s, t_c, cause=name, domain="serving"
                )
                with trace("serving_compute", logger), on_stream:
                    dev = pinned.model._transform_device(Xs)
                    done = None
                    if stream is not None:
                        # the outputs' copy to pinned host memory, queued
                        # behind the transform on this slot's stream; the
                        # collect worker waits on this batch's event alone
                        host = {}
                        for col, v in dev.items():
                            if isinstance(v, torch.Tensor):
                                h = torch.empty(
                                    v.shape, dtype=v.dtype, pin_memory=True
                                )
                                h.copy_(v, non_blocking=True)
                                host[col] = h
                            else:
                                host[col] = v
                        done = torch.cuda.Event(enable_timing=True)
                        done.record(stream)
                        keep, dev = (Xs, dev), host
                    else:
                        keep = None
                # the compute window here is only the LAUNCH on a card; the
                # device series (noted at collect) carries the real span
                utilization.note_interval(
                    "compute", t_c, time.perf_counter(), cause=name,
                    domain="serving",
                )
        return _InFlight(
            name, pinned.model, reqs, rows, st, dev, None, t0, batch_id,
            event=done, keep=keep, begin=begin,
        )

    @staticmethod
    def _fetch(flight: _InFlight) -> Dict[str, np.ndarray]:
        """A device flight's outputs on the host, valid rows only: on a
        card, once the batch's own event has completed (the wait that
        makes `event.synchronize` raise a sticky CUDA error here), copied
        out of the pinned buffers so they go back to the cache."""
        import torch

        st = flight.stager
        if flight.event is not None:
            flight.event.synchronize()
            flight.keep = None  # the batch's device work is done
        outs: Dict[str, np.ndarray] = {}
        for col, v in flight.dev.items():
            if isinstance(v, torch.Tensor):
                host = st.fetch(v)
                outs[col] = np.array(host) if flight.event is not None else host
            else:
                outs[col] = np.asarray(v)[: st.n_valid]
        return outs

    def _collect(self, flight: _InFlight) -> None:
        """Fetch one in-flight batch (the sync point) and scatter each
        request's row slice to its future.  Futures resolve only after
        EVERY column fetched, so a mid-fetch failure retries the whole
        batch without partial results escaping.  Runs under the batch's
        run id, so the collect/scatter spans join the dispatch tree."""
        with run_context(flight.batch_id or None):
            self._collect_traced(flight)

    def _collect_traced(self, flight: _InFlight) -> None:
        from ..resilience import maybe_inject
        from ..telemetry import utilization

        # deterministic fault hook for the collect/scatter phase
        # (`serving_collect`): fires on the collect worker while LATER
        # batches may still be in flight behind this one — the
        # mid-pipeline failure drill.  Every in-flight batch's requests
        # ride the fault handback to the dispatcher's requeue.
        maybe_inject("serving_collect")
        if flight.host_outs is not None:
            outs = flight.host_outs
        else:
            t_fetch = time.perf_counter()
            with trace(f"serving_collect[{flight.name}]", logger):
                outs = self._fetch(flight)
            t_fetched = time.perf_counter()
            # the fetch wait + host copy window: the collect worker's
            # share of the gap table (a "collect" series stealing idle
            # seconds = the worker, not depth, limits)
            utilization.note_interval(
                "collect", t_fetch, t_fetched, cause=flight.name,
                domain="serving",
            )
            # the serving timeline's "device" series.  On the CPU, the
            # window from the batch's dispatch to its fetch, as in the JAX
            # package; on a card, the span its slot's stream took from
            # the staging to the outputs' copy (the two events' time),
            # ending where the worker saw it complete: the dispatch to
            # fetch window also holds the batch's wait in the pipeline
            t_lo = min(flight.t_dispatch, t_fetch)
            if flight.begin is not None:
                dev_s = flight.begin.elapsed_time(flight.event) / 1e3
                t_lo = max(t_lo, t_fetched - dev_s)
            utilization.note_interval(
                "device", t_lo, t_fetched, cause=flight.name,
                domain="serving",
            )
        t_done = time.perf_counter()
        slow_s = (
            max(0.0, float(get_config("serving_slow_trace_ms"))) / 1e3
        )
        slow_hits: List[tuple] = []
        lo = 0
        with self._lock:
            lat = self._lat.setdefault(
                flight.name, collections.deque(maxlen=_REPORT_SAMPLES)
            )
            lat_ts = self._lat_ts.setdefault(
                flight.name, collections.deque(maxlen=_REPORT_SAMPLES)
            )
        with trace("serving_scatter", logger):
            now_mono = time.monotonic()
            for r in flight.reqs:
                sl = {c: v[lo : lo + r.rows] for c, v in outs.items()}
                lo += r.rows
                if r.future.done():
                    # cancelled by the caller while queued/in flight, or
                    # resolved by an earlier partially-scattered attempt a
                    # failure requeued — either way, publishing would raise
                    # InvalidStateError and poison the co-batched requests
                    continue
                q_s = max(flight.t_dispatch - r.t_enqueue, 0.0)
                d_s = max(t_done - flight.t_dispatch, 0.0)
                tot = max(t_done - r.t_enqueue, 0.0)
                LATENCY.observe(
                    q_s, exemplar=r.req_id, model=flight.name, phase="queue"
                )
                LATENCY.observe(
                    d_s, exemplar=r.req_id,
                    model=flight.name, phase="dispatch",
                )
                LATENCY.observe(
                    tot, exemplar=r.req_id, model=flight.name, phase="total"
                )
                with self._lock:
                    lat.append(tot)
                    lat_ts.append((now_mono, tot))
                if slow_s > 0 and tot >= slow_s:
                    slow_hits.append((r.req_id, tot))
                try:
                    r.future.set_result(sl)
                except Exception:
                    pass  # cancelled in the race window; result dropped
        # the slice-and-resolve window ("scatter" series): stolen idle
        # seconds here mean the futures' consumers are the gap, which
        # more depth cannot buy back
        utilization.note_interval(
            "scatter", t_done, time.perf_counter(), cause=flight.name,
            domain="serving",
        )
        if slow_hits:
            self._capture_slow(flight, slow_hits)
        # refresh EVERY served model, not just this flight's: a model
        # whose traffic stopped must decay even while the dispatcher
        # stays busy with other models' batches (the per-model rate
        # limit inside _update_slo bounds the cost to ~1 scan/s/model)
        self._refresh_slo_all()

    def _capture_slow(
        self, flight: _InFlight, hits: List[tuple]
    ) -> None:
        """A request breached the `serving_slow_trace_ms` threshold:
        keep the batch's FULL span tree (queue wait is implicit in the
        phase observations; dispatch -> coalesce/stage/compute ->
        collect/scatter are the recorded spans, filtered by the batch's
        run id from this dispatcher thread's bounded buffer) plus the
        breaching request ids — the operator's "what did THAT request
        hit" view, without pre-arming anything."""
        from ..telemetry.report import span_tree

        try:
            events = [
                e for e in get_trace_events()
                if e.run_id == flight.batch_id
            ]
            entry = {
                "model": flight.name,
                "batch_id": flight.batch_id,
                "batch_rows": flight.rows,
                "requests": [
                    {"request_id": rid, "total_ms": round(tot * 1e3, 3)}
                    for rid, tot in hits
                ],
                "spans": span_tree(events),
            }
            with self._lock:
                self._slow.append(entry)
            event(
                f"serving_slow[{flight.name}]",
                detail=self._req_id_detail(
                    [r for r in flight.reqs
                     if r.req_id in {rid for rid, _ in hits}]
                ),
                log=logger,
            )
        except Exception as e:  # capture must never fail the scatter
            logger.warning(f"slow-request capture failed ({e})")

    def slow_traces(self) -> List[Dict[str, Any]]:
        """Captured span trees of requests that breached
        `serving_slow_trace_ms` (newest last, bounded)."""
        with self._lock:
            return list(self._slow)

    # -- SLO sensing ---------------------------------------------------------

    def _slo_target_s(self, name: str) -> float:
        """The model's declared p99 target in seconds (0 = no SLO):
        `serving_slo_targets` ("model=ms,...") overrides the
        `serving_slo_p99_ms` default."""
        spec = str(get_config("serving_slo_targets") or "")
        with self._lock:
            memo_spec, table = self._slo_targets_memo
            if spec != memo_spec:
                table = {}
                for entry in spec.split(","):
                    entry = entry.strip()
                    if not entry:
                        continue
                    model, _, ms = entry.partition("=")
                    try:
                        table[model.strip()] = float(ms)
                    except ValueError:
                        logger.warning(
                            f"serving_slo_targets entry {entry!r} is not "
                            "'model=ms'; ignored"
                        )
                self._slo_targets_memo = (spec, table)
        ms = table.get(name)
        if ms is None:
            ms = float(get_config("serving_slo_p99_ms") or 0.0)
        return max(0.0, ms) / 1e3

    def _update_slo(self, name: str) -> None:
        """Refresh `slo_burn_rate{model,window}` from the recent
        latency samples: (fraction of window requests over the p99
        target) / the 1% budget.  1.0 = exactly on budget; 2.0 = the
        error budget burns twice as fast as it accrues — the signal the
        controller (serving/control.py) consumes.  Rate-limited per
        model; no-op when no target is declared."""
        target_s = self._slo_target_s(name)
        if target_s <= 0:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._slo_last.get(name, 0.0) < _SLO_REFRESH_S:
                return
            self._slo_last[name] = now
            samples = list(self._lat_ts.get(name, ()))
        for window, span_s in _SLO_WINDOWS:
            recent = [tot for t, tot in samples if now - t <= span_s]
            if not recent:
                # an empty window is ZERO burn, not "whatever the last
                # burst left behind": without this a 100x spike would
                # read as live forever once traffic stops (the same
                # stale-gauge class Heartbeat.close fixes for solvers)
                frac_over = 0.0
            else:
                frac_over = sum(
                    1 for tot in recent if tot > target_s
                ) / len(recent)
            SLO_BURN.set(
                round(frac_over / _SLO_BUDGET, 4),
                model=name, window=window,
            )

    def _refresh_slo_all(self) -> None:
        """Dispatcher idle tick: burn-rate gauges keep decaying toward
        the truth even when no batch collects (a model whose traffic
        STOPPED must not scrape as burning; `_update_slo`'s own
        per-model rate limit bounds the cost).  Only models that have
        SERVED are refreshed — decay maintains existing series, it must
        not mint a 0.0 series for a model no request ever touched."""
        try:
            for name in self.registry.names():
                with self._lock:
                    served = bool(self._lat_ts.get(name))
                if served:
                    self._update_slo(name)
        except Exception:  # gauge upkeep must never wedge the loop
            pass

    def _controller_tick(self) -> None:
        """One feedback pass from the dispatcher loop: per served model
        feed the 1m burn gauge and the live p99 into the controller's
        AIMD/brownout step.  Server-side rate limit keeps the hot loop
        from even walking the model list every round; the per-model
        interval inside `tick` does the real pacing.  Control must
        never wedge the dispatcher — any failure is logged and the loop
        moves on."""
        ctl = self._controller
        if not ctl.enabled():
            return
        now = time.monotonic()
        if now - self._ctl_last < min(0.25, ctl.interval_s()):
            return
        self._ctl_last = now
        try:
            base_wait_ms = max(
                0.0, float(get_config("serving_max_wait_ms"))
            )
            for name in self.registry.names():
                with self._lock:
                    lat = list(self._lat.get(name, ()))
                if not lat:
                    continue  # never served: nothing to control yet
                srt = sorted(lat)
                p99_ms = round(
                    srt[min(len(srt) - 1, int(round(0.99 * (len(srt) - 1))))]
                    * 1e3,
                    3,
                )
                burn = SLO_BURN.value(
                    default=None, model=name, window="1m"
                )
                ctl.tick(
                    name, burn, p99_ms,
                    self._base_cap(self._safe_info(name)),
                    base_wait_ms, now=now,
                )
        except Exception as e:
            logger.warning(f"serving controller tick failed ({e})")

    # -- degradation ---------------------------------------------------------

    def _recover_guarded(self, e: Exception, reqs: List[_Request]) -> None:
        """The last line of defense: a recovery that ITSELF blows up
        must fail the recovered requests and keep the dispatcher alive —
        a dead dispatcher turns every queued future into a permanent
        hang (and every HTTP handler thread into a 504)."""
        try:
            self._recover(e, reqs)
        except Exception as e2:
            logger.error(
                f"serving recovery failed ({type(e2).__name__}: {e2}); "
                f"failing {len(reqs)} request(s)"
            )
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e2)

    def _note_clean_batch(self) -> None:
        """Success-driven cap recovery: after enough clean batches the
        OOM-shrunk coalescing cap doubles back toward the configured
        value — one transient OOM must not cap QPS for the rest of the
        process (the memory pressure that caused it is long gone).
        Runs on the collect worker; the cv guards the shrink state
        against the dispatcher's `_recover` halving it concurrently
        (callers never hold the cv — it is non-reentrant)."""
        restored = False
        with self._cv:
            if self._shrunk_cap is None:
                return
            self._clean_batches += 1
            if self._clean_batches < _CAP_REGROW_BATCHES:
                return
            self._clean_batches = 0
            grown = self._shrunk_cap * 2
            if grown >= int(get_config("serving_max_batch_rows")):
                self._shrunk_cap = None
                restored = True
            else:
                self._shrunk_cap = grown
        if restored:
            logger.info("serving coalescing cap fully restored")

    def _recover(self, e: Exception, reqs: List[_Request]) -> None:
        """Policy-driven degradation for a failed dispatch/collect, through
        the port's retry policy: `classify` names the action, `admits`
        decides per request (the attempt budget is PER REQUEST, at least
        one retry, so one model's poisoned batch can neither exhaust
        another model's attempts nor ride interleaved successes to retry
        forever), and `recover` counts the retry and repairs.  The
        admitted requests are requeued at the FRONT first (order
        preserved, nothing lost).  A sticky CUDA error stops the server
        (`_fail_dead`)."""
        import dataclasses

        from ..resilience import RetryPolicy

        if self._dead is not None:
            self._fail_all(reqs, self._dead)
            return
        policy = RetryPolicy.from_config()
        policy = dataclasses.replace(
            policy, max_attempts=max(policy.max_attempts, 2)
        )
        action = policy.classify(e)
        # attempt 0 is always within the budget, so a device loss is
        # refused only when it is a sticky CUDA error (admits records its
        # `sticky_error[serving_dispatch]` event)
        if action == "device_loss" and not policy.admits(
            e, action, 0, True, "serving_dispatch", logger
        ):
            self._fail_dead(e, reqs)
            return
        floor_hit = (
            action == "oom"
            and (self._shrunk_cap or 1 << 30) <= self._oom_floor()
        )
        doomed: List[_Request] = []
        alive: List[_Request] = []
        for r in reqs:
            r.attempts += 1
            if policy.admits(
                e, action, r.attempts, not floor_hit, "serving_dispatch"
            ):
                alive.append(r)
            else:
                doomed.append(r)
        if doomed:
            logger.error(
                f"serving dispatch failed permanently "
                f"({type(e).__name__}: {e}); failing {len(doomed)} "
                "request(s)"
            )
            if action != "fatal":
                # a recoverable class exhausted its per-request budget
                note_failure(
                    "retry_exhausted",
                    detail=(
                        f"label=serving_dispatch action={action} "
                        f"doomed={len(doomed)} "
                        f"error={type(e).__name__}: {e}"
                    ),
                    log=logger,
                )
            self._fail_all(doomed, e)
        if not alive:
            return
        self._requeue_front(alive)
        # a repair that fails (a re-pin that no longer fits, a probe
        # error) must not unwind past the requeue: the requests are back
        # in the queue, the next dispatch surfaces the same failure, and
        # the attempt budget converges to give_up
        try:
            policy.recover(
                action,
                max(r.attempts for r in alive),
                "serving_dispatch",
                f"action={action} requeued={len(alive)}",
                logger,
                on_oom=self._shrink_cap,
                on_device_loss=self._repin_after_loss,
            )
        except Exception as re_err:
            logger.error(
                f"serving {action} repair failed ({type(re_err).__name__}: "
                f"{re_err}); requests stay queued for the next attempt"
            )

    @staticmethod
    def _fail_all(reqs: List[_Request], e: BaseException) -> None:
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(e)

    def _shrink_cap(self) -> None:
        """The OOM repair: drop the re-creatable dataset-cache residency
        (the pinned models are the serving working set and stay), hand the
        caching allocator's free blocks back, and halve the coalescing
        cap down to `_oom_floor()`."""
        import gc

        import torch

        from ..parallel.device_cache import clear_device_cache

        clear_device_cache()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        # cv-guarded against the collect worker's clean-batch regrowth
        # racing this halving (called cv-free here)
        with self._cv:
            cap = self._shrunk_cap or max(
                1, int(get_config("serving_max_batch_rows"))
            )
            self._shrunk_cap = max(self._oom_floor(), cap // 2)
            self._clean_batches = 0
            shrunk = self._shrunk_cap
        logger.warning(
            "serving dispatch exhausted device memory; coalescing "
            f"cap shrunk to {shrunk} rows"
        )

    def _repin_after_loss(self) -> None:
        """A (simulated) device loss: one card's elastic path is the full
        retry on the same card, so every resident model re-pins there and
        the queue drains on it — no request is lost."""
        from ..resilience.elastic import recover_from_device_loss

        recover_from_device_loss(logger)
        self.registry.repin_all("device_loss")
        logger.warning(
            "serving dispatch lost the device; models re-pinned, the queue "
            "drains on the same card"
        )

    def _fail_dead(self, e: BaseException, reqs: List[_Request]) -> None:
        """A sticky CUDA error: the context is poisoned, so nothing on the
        card can run again in this process.  Fail `reqs`, every queued
        request and every flight still in the pipeline with one typed
        `ServingDeviceError`, and stop: no requeue, no re-pin."""
        err = ServingDeviceError(e)
        with self._cv:
            self._dead = err
            self._running = False
            doomed = list(reqs)
            for name, by_cls in self._queues.items():
                for q in by_cls.values():
                    doomed.extend(q)
                    q.clear()
                QUEUE_DEPTH.set(0, model=name)
            self._queued = 0
            self._queued_cls = {c: 0 for c in PRIORITY_CLASSES}
            for fl in self._inflight:
                doomed.extend(fl.reqs)
            self._inflight.clear()
            PIPELINE_INFLIGHT.set(1 if self._collecting else 0)
            self._cv.notify_all()
        logger.error(
            f"serving: {err}; failing {len(doomed)} request(s) in flight and "
            "queued"
        )
        note_failure("device_lost", detail=str(err), log=logger)
        self._fail_all(doomed, err)


class ServingClient:
    """The in-process client surface: `transform` blocks, `submit`
    returns a Future.  Exists so call sites talk to a stable client API
    whether the server is in-process or fronted by the HTTP endpoint
    (serving/http.py speaks the same request shape)."""

    def __init__(self, server: ServingServer) -> None:
        self._server = server

    def submit(self, model: str, X: Any,
               request_id: Optional[str] = None,
               priority: Optional[str] = None) -> Future:
        """Enqueue; the returned Future carries `.request_id` (minted
        here unless the caller supplies one) — the id the latency
        exemplars and dispatch spans carry.  `priority` picks the
        admission class (`interactive` | `batch`; default: the model's
        registered class, then `serving_priority_default`)."""
        return self._server.submit(
            model, X, request_id=request_id, priority=priority
        )

    def transform(self, model: str, X: Any,
                  timeout: Optional[float] = None,
                  request_id: Optional[str] = None,
                  priority: Optional[str] = None) -> Any:
        """Transform rows; a single-output model returns the bare array
        (matching `Model.transform`'s array-input contract), multi-output
        models return `{col: array}`."""
        outs = self._server.transform(
            model, X, timeout=timeout, request_id=request_id,
            priority=priority,
        )
        if len(outs) == 1:
            return next(iter(outs.values()))
        return outs

    def models(self) -> List[str]:
        return self._server.registry.names()


__all__ = ["ServingClient", "ServingDeviceError", "ServingOverload", "ServingServer"]
