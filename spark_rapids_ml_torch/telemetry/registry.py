#
# Typed process-global metrics registry: the port of spark_rapids_ml_tpu/
# telemetry/registry.py.  Three metric kinds with label support:
#
#   Counter    monotonically increasing (retries, faults injected,
#              checkpoint saves) — `inc(amount, **labels)`
#   Gauge      settable point-in-time value (queue depth, pipeline
#              depth) — `set(value, **labels)` / `inc`/`dec`
#   Histogram  bucketed observations (request latency) —
#              `observe(value, **labels)`, with bounded exemplars
#
# Values are stored as exact Python numbers (int stays int), so the
# dict views (`dict_view`) keep plain-dict arithmetic.  `snapshot()`
# returns a plain nested dict for delta computation; `reset()` zeroes
# every sample but keeps registrations (and re-seeds view initials).
#
# Deliberately dependency-free (no torch/numpy at module scope): bumping a
# counter from the resilience layer must never pay an accelerator import.
#
from __future__ import annotations

import threading
import time
from collections.abc import MutableMapping
from typing import Any, Dict, Iterator, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# ---------------------------------------------------------------------------
# Canonical metric catalog, the JAX package's whole: name -> {kind,
# labels, cardinality}.  Families of modules the port has not written
# yet stay declared, so the two packages name one metric surface.
# `cardinality` bounds the DISTINCT labelsets a family may accumulate at
# runtime (`check_cardinality()`, asserted by tests): labels must stay
# enumerable — site names, estimator names, device ordinals — never run
# ids or timestamps.
#
# Kinds: counter / gauge / histogram, plus "view" — a gauge family
# fronted by a legacy `dict_view` mapping (labeled only by `key`).
# ---------------------------------------------------------------------------
METRIC_CATALOG: Dict[str, Dict[str, Any]] = {
    # resilience
    "retries_total": {
        "kind": "counter", "labels": ("label", "action"), "cardinality": 64,
    },
    "dispatch_timeouts_total": {
        "kind": "counter", "labels": ("label",), "cardinality": 32,
    },
    "faults_injected_total": {
        "kind": "counter", "labels": ("site", "kind"), "cardinality": 64,
    },
    "checkpoint_saves_total": {
        "kind": "counter", "labels": (), "cardinality": 1,
    },
    "checkpoint_resumes_total": {
        "kind": "counter", "labels": (), "cardinality": 1,
    },
    "device_health_probes_total": {
        "kind": "counter", "labels": (), "cardinality": 1,
    },
    "device_probe_failures_total": {
        "kind": "counter", "labels": (), "cardinality": 1,
    },
    # telemetry: memory / budget drift
    "device_bytes_in_use": {
        "kind": "gauge", "labels": ("device",), "cardinality": 256,
    },
    "device_bytes_peak": {
        "kind": "gauge", "labels": ("device",), "cardinality": 256,
    },
    "budget_drift_ratio": {
        "kind": "gauge", "labels": ("est",), "cardinality": 64,
    },
    "budget_predicted_bytes": {
        "kind": "gauge", "labels": ("est",), "cardinality": 64,
    },
    "budget_decisions_total": {
        "kind": "counter", "labels": ("label", "over"), "cardinality": 64,
    },
    "memory_samples_total": {
        "kind": "counter", "labels": ("provider",), "cardinality": 4,
    },
    # telemetry: compile tracking
    "compile_seconds": {
        "kind": "histogram", "labels": ("fn", "phase"), "cardinality": 256,
    },
    "compiles_total": {
        "kind": "counter", "labels": ("fn",), "cardinality": 64,
    },
    "recompiles_total": {
        "kind": "counter", "labels": ("fn", "reason"), "cardinality": 64,
    },
    # telemetry: solver progress / fit accounting
    "solver_iteration": {
        "kind": "gauge", "labels": ("solver",), "cardinality": 16,
    },
    "solver_loss": {
        "kind": "gauge", "labels": ("solver",), "cardinality": 16,
    },
    "fit_duration_seconds": {
        "kind": "histogram", "labels": ("estimator",), "cardinality": 32,
    },
    # serving layer (serving/): request latency split by phase, batch
    # coalescing sizes, admission-control rejections, and model-pin
    # lifecycle.  Labels stay enumerable: model names are
    # operator-chosen registry keys, phases/reasons/events are fixed
    # vocabularies.  `exemplars: True` declares the family carries
    # bounded per-labelset exemplars (request ids) — the ONLY families
    # allowed to pass `exemplar=` to observe() (metric-name rule); the
    # unbounded ids live beside the samples, never as labels.
    "serving_request_latency_seconds": {
        "kind": "histogram", "labels": ("model", "phase"),
        "cardinality": 96, "exemplars": True,
    },
    # SLO sensing (serving/server.py): measured over-p99-target request
    # fraction / the 1% budget a p99 target implies, per declared
    # window — the sensor half of the serving control plane.
    "slo_burn_rate": {
        "kind": "gauge", "labels": ("model", "window"), "cardinality": 96,
    },
    # failure flight recorder (telemetry/flight_recorder.py): one bump
    # per post-mortem bundle written, labeled by the typed failure path
    # that triggered the dump (retry_exhausted / dispatch_timeout /
    # device_lost / serving_overload / brownout / drift / manual)
    "postmortems_total": {
        "kind": "counter", "labels": ("reason",), "cardinality": 16,
    },
    "serving_batch_rows": {
        "kind": "histogram", "labels": ("model",), "cardinality": 32,
    },
    "serving_requests_total": {
        "kind": "counter", "labels": ("model",), "cardinality": 32,
    },
    "serving_rejections_total": {
        "kind": "counter", "labels": ("model", "reason"), "cardinality": 64,
    },
    "serving_pins_total": {
        "kind": "counter", "labels": ("model", "event"), "cardinality": 96,
    },
    "serving_pinned_models": {
        "kind": "gauge", "labels": (), "cardinality": 1,
    },
    "serving_pinned_bytes": {
        "kind": "gauge", "labels": (), "cardinality": 1,
    },
    # dict-view families (gauges labeled by `key`)
    "staging_last": {"kind": "view", "labels": ("key",), "cardinality": 32},
    "staging_counts": {"kind": "view", "labels": ("key",), "cardinality": 32},
    "device_cache": {"kind": "view", "labels": ("key",), "cardinality": 32},
    # chunk cache (parallel/device_cache.py ChunkCache): hit/miss/spill/
    # restore/evict/invalidate counters + per-tier byte gauges for the
    # out-of-core epoch engine's decoded-chunk tiers
    "chunk_cache": {"kind": "view", "labels": ("key",), "cardinality": 32},
    "recovery": {"kind": "view", "labels": ("key",), "cardinality": 16},
    # pod rank-loss recovery (resilience/pod.py): losses detected,
    # shares reassigned, recoveries, bounded-wait expiries, generation
    "pod_recovery": {"kind": "view", "labels": ("key",), "cardinality": 16},
    "fused_last": {"kind": "view", "labels": ("key",), "cardinality": 32},
    "pca_solver_last": {"kind": "view", "labels": ("key",), "cardinality": 16},
    # statistic-program engine (stats/engine.py): executions per
    # registered program, wall seconds per fused multi-program pass
    # (labeled by the run's caller-facing label — summarize / describe /
    # estimator names, a fixed vocabulary), and the last-run state the
    # fit report's `stats` section and bench.py's `summarize` section
    # copy
    "stat_program_runs_total": {
        "kind": "counter", "labels": ("program",), "cardinality": 64,
    },
    "stat_program_pass_seconds": {
        "kind": "histogram", "labels": ("label",), "cardinality": 32,
    },
    "stat_program_last": {
        "kind": "view", "labels": ("key",), "cardinality": 32,
    },
    # drift monitor (monitor/): per-model divergence gauges, bounded to
    # the `drift_top_k` highest-scoring columns per model (stale column
    # series are REMOVED on every refresh — monitor._export), plus the
    # per-model `_overall` alert series and per-output-column scores;
    # `column` is therefore enumerable by construction, never a raw
    # feature index stream.  512 covers ~8 models x (8 columns x 7
    # stats + outputs + overall).
    "drift_score": {
        "kind": "gauge", "labels": ("model", "column", "stat"),
        "cardinality": 512,
    },
    "drift_rows_observed_total": {
        "kind": "counter", "labels": ("model",), "cardinality": 32,
    },
    # named-lock contention profiling (telemetry/locks.py): per-lock
    # acquire / contended / wait-seconds / hold-seconds counters,
    # published from the per-instance accounting by
    # `publish_lock_metrics` (exporters, fit reports, hang-doctor
    # ticks).  `lock` label values come from LOCK_CATALOG — a fixed
    # vocabulary the graft-lint `named-lock` rule enforces.
    "lock_acquisitions_total": {
        "kind": "counter", "labels": ("lock",), "cardinality": 64,
    },
    "lock_contended_total": {
        "kind": "counter", "labels": ("lock",), "cardinality": 64,
    },
    "lock_wait_seconds_total": {
        "kind": "counter", "labels": ("lock",), "cardinality": 64,
    },
    "lock_hold_seconds_total": {
        "kind": "counter", "labels": ("lock",), "cardinality": 64,
    },
    # utilization timeline (telemetry/utilization.py): fraction of the
    # observed wall the device was busy, per scope (fit | serving)
    "device_busy_fraction": {
        "kind": "gauge", "labels": ("scope",), "cardinality": 8,
    },
    # hang doctor (telemetry/hang_doctor.py): watchdog liveness + stall
    # episodes by kind (lock_wait | no_progress); the dumped bundles
    # themselves count on postmortems_total{reason="stall"}
    "hang_doctor_ticks_total": {
        "kind": "counter", "labels": (), "cardinality": 1,
    },
    "hang_doctor_stalls_total": {
        "kind": "counter", "labels": ("kind",), "cardinality": 8,
    },
    # serving queue sensors (serving/server.py): live queued rows per
    # model and the dispatcher's loop lag (how far past its intended
    # wake deadline the loop ran) — the queueing half of the serving
    # control plane, next to `slo_burn_rate`
    "serving_queue_depth": {
        "kind": "gauge", "labels": ("model",), "cardinality": 32,
    },
    "serving_dispatcher_lag_seconds": {
        "kind": "gauge", "labels": (), "cardinality": 1,
    },
    # staged dispatch pipeline (serving/server.py): the resolved
    # in-flight depth (explicit conf or the auto value derived from the
    # serving idle-gap profile) and the live batch occupancy across the
    # stage/compute/collect/scatter stages — occupancy pinned at depth
    # means the pipeline is full and depth is the throughput limiter
    "serving_pipeline_depth": {
        "kind": "gauge", "labels": (), "cardinality": 1,
    },
    "serving_pipeline_inflight": {
        "kind": "gauge", "labels": (), "cardinality": 1,
    },
    # serving control plane (serving/control.py, the
    # actuator half): the AIMD controller's live actuator values per
    # model (the EFFECTIVE coalescing cap / max-wait after scaling),
    # its adjustment counter by direction (increase | decrease), the
    # brownout phase index (0 normal, 1 shed_batch, 2 shed_interactive),
    # and brownout sheds by priority class (interactive | batch)
    "serving_controller_cap": {
        "kind": "gauge", "labels": ("model",), "cardinality": 32,
    },
    "serving_controller_max_wait_ms": {
        "kind": "gauge", "labels": ("model",), "cardinality": 32,
    },
    "serving_controller_adjustments_total": {
        "kind": "counter", "labels": ("model", "direction"),
        "cardinality": 64,
    },
    "serving_controller_brownout_phase": {
        "kind": "gauge", "labels": ("model",), "cardinality": 32,
    },
    "serving_shed_total": {
        "kind": "counter", "labels": ("model", "class"), "cardinality": 64,
    },
    # multi-host data path (parallel/context.py): wall time of each
    # cross-process reduction step by phase — `agreement` (the content-
    # fingerprint check), `psum` (jitted collective fold), `wire`
    # (coordination-service allgather + rank-order host fold), `sketch`
    # (host-tier sketch wire merges), `fingerprint` (drift-baseline
    # fingerprint merges)
    "multiproc_reduce_seconds": {
        "kind": "histogram", "labels": ("phase",), "cardinality": 8,
    },
    # ...and the reductions that completed, by backend actually used
    # (psum | wire) — the observable for "did auto pick the collective
    # path on this build"
    "multiproc_reductions_total": {
        "kind": "counter", "labels": ("backend",), "cardinality": 4,
    },
    # pod observatory (telemetry/fleet.py): per-rank wall seconds by
    # pass phase (decode | device_accumulate | reduce_wait) from the
    # last pod pass report — every rank publishes the SAME table, so
    # any one scrape names the straggler; pod-scale incidents minted,
    # by reason (rank_loss | drift | ...) — each incident id is shared
    # by every bundle the event produced across the pod
    "pod_straggler_seconds": {
        "kind": "gauge", "labels": ("rank", "phase"), "cardinality": 256,
    },
    "pod_incidents_total": {
        "kind": "counter", "labels": ("reason",), "cardinality": 16,
    },
    # fleet-merged drift (monitor/monitor.py + telemetry/fleet.py):
    # `drift_score` itself reflects pod-wide traffic after the
    # rank-ordered sketch merge; this family keeps each host's LOCAL
    # window score visible next to it, keyed by process rank
    "drift_score_partial": {
        "kind": "gauge", "labels": ("model", "process"),
        "cardinality": 256,
    },
}

_DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """One metric family: a name, a kind, and per-labelset samples.
    Thread-safe through the owning registry's lock."""

    def __init__(
        self,
        name: str,
        kind: str,
        help: str = "",
        buckets: Optional[Tuple[float, ...]] = None,
        lock: Optional[threading.RLock] = None,
    ) -> None:
        if kind not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unknown metric kind: {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(
            sorted(buckets or _DEFAULT_BUCKETS)
        )
        self._lock = lock or threading.RLock()
        # counter/gauge: labelset -> number; histogram: labelset ->
        # {"buckets": [count per le], "sum": float, "count": int}
        self._samples: Dict[LabelKey, Any] = {}

    # -- counter/gauge -------------------------------------------------------

    def inc(self, amount: Any = 1, **labels: Any) -> None:
        if self.kind == "histogram":
            raise TypeError("histograms take observe(), not inc()")
        if self.kind == "counter" and amount < 0:
            raise ValueError("counters only increase")
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0) + amount

    def dec(self, amount: Any = 1, **labels: Any) -> None:
        if self.kind != "gauge":
            raise TypeError("only gauges decrease")
        self.inc(-amount, **labels)

    def set(self, value: Any, **labels: Any) -> None:
        if self.kind == "histogram":
            raise TypeError("histograms take observe(), not set()")
        with self._lock:
            self._samples[_label_key(labels)] = value

    def value(self, default: Any = 0, **labels: Any) -> Any:
        with self._lock:
            return self._samples.get(_label_key(labels), default)

    # -- histogram -----------------------------------------------------------

    # exemplars retained per labelset: enough to answer "which request
    # was that" for the recent observations without growing with traffic
    _MAX_EXEMPLARS = 4

    def observe(
        self, value: float, exemplar: Optional[str] = None, **labels: Any
    ) -> None:
        if self.kind != "histogram":
            raise TypeError(f"{self.kind} metrics take inc()/set()")
        v = float(value)
        key = _label_key(labels)
        with self._lock:
            h = self._samples.get(key)
            if h is None:
                h = self._samples[key] = {
                    "buckets": [0] * len(self.buckets),
                    "sum": 0.0,
                    "count": 0,
                }
            for i, le in enumerate(self.buckets):
                if v <= le:
                    h["buckets"][i] += 1
            h["sum"] += v
            h["count"] += 1
            if exemplar is not None:
                # exemplars (request/run ids) are UNBOUNDED values and
                # must never become labels (cardinality); a short ring
                # beside the sample keeps the trace join-key without
                # growing with traffic
                ex = h.setdefault("exemplars", [])
                ex.append({
                    "id": str(exemplar), "value": v, "t": time.time(),
                })
                del ex[: -self._MAX_EXEMPLARS]

    def exemplars(self, **labels: Any) -> List[Dict[str, Any]]:
        """Recent exemplars recorded for one labelset (histograms whose
        catalog entry declares `exemplars: True`); newest last."""
        with self._lock:
            h = self._samples.get(_label_key(labels))
            if not isinstance(h, dict):
                return []
            return [dict(e) for e in h.get("exemplars", ())]

    # -- shared --------------------------------------------------------------

    def samples(self) -> Dict[LabelKey, Any]:
        with self._lock:
            return {
                k: (
                    dict(
                        v,
                        buckets=list(v["buckets"]),
                        **(
                            {"exemplars": [dict(e) for e in v["exemplars"]]}
                            if "exemplars" in v
                            else {}
                        ),
                    )
                    if isinstance(v, dict)
                    else v
                )
                for k, v in self._samples.items()
            }

    def remove(self, **labels: Any) -> bool:
        """Drop one labelset's sample entirely (True when it existed).
        The end-mark for gauges that would otherwise report a finished
        run as live forever — a scrape after `Heartbeat.close()` shows
        NO `solver_iteration{solver=...}` series instead of the last
        iteration of a fit that ended minutes ago."""
        with self._lock:
            return self._samples.pop(_label_key(labels), None) is not None

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()


class DictView(MutableMapping):
    """Mapping facade over one gauge family labeled by ``key`` — the
    back-compat skin for the legacy module-level metric dicts
    (`mesh.STAGE_COUNTS` et al.).  Every read/write goes straight through
    the registry, so `dump_prometheus()` and `snapshot()` see the same
    numbers the old dict callers do; non-numeric values (the staging
    engine's `label` field) are kept on the view itself, outside the
    metric samples."""

    def __init__(self, metric: Metric, initial: Optional[dict] = None):
        self._metric = metric
        self._initial = dict(initial or {})
        self._strs: Dict[str, Any] = {}
        self.seed()

    def seed(self) -> None:
        """Apply the initial key set WITHOUT clobbering live samples:
        only missing keys are set.  Registry reset clears samples first
        (so the initials land), while a re-import/reload that rebuilds a
        view must not zero counters the process already accumulated."""
        for k, v in self._initial.items():
            if k not in self:
                self[k] = v

    def __getitem__(self, key: str) -> Any:
        if key in self._strs:
            return self._strs[key]
        sentinel = object()
        v = self._metric.value(default=sentinel, key=key)
        if v is sentinel:
            raise KeyError(key)
        return v

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            self._strs[key] = value
            with self._metric._lock:
                self._metric._samples.pop(_label_key({"key": key}), None)
        else:
            self._strs.pop(key, None)
            self._metric.set(value, key=key)

    def __delitem__(self, key: str) -> None:
        if key in self._strs:
            del self._strs[key]
            return
        with self._metric._lock:
            lk = _label_key({"key": key})
            if lk not in self._metric._samples:
                raise KeyError(key)
            del self._metric._samples[lk]

    def __iter__(self) -> Iterator[str]:
        # only this view's own samples — exactly one `key` label; a
        # stray differently-labeled sample someone registered onto the
        # same family must not break iteration/len/clear
        keys = [
            lk[0][1]
            for lk in self._metric.samples()
            if len(lk) == 1 and lk[0][0] == "key"
        ]
        keys += [k for k in self._strs if k not in keys]
        return iter(keys)

    def __len__(self) -> int:
        return len(list(iter(self)))

    def bump(self, key: str, amount: Any = 1) -> None:
        """Increment `key`, creating it at 0 first — the drift-proof form
        of ``view[key] += 1`` (never drops a missing mirror key)."""
        self[key] = self.get(key, 0) + amount

    def __repr__(self) -> str:  # debugging/reprs in logs
        return repr(dict(self))


class MetricsRegistry:
    """Process-global metric store: register-once families, snapshot and
    reset.  One RLock guards registration and every sample mutation."""

    def __init__(self) -> None:
        # the registry's internal lock is itself a NAMED lock — it is
        # one of the hottest in the process (every metric op holds it)
        # and the contention profile must cover it.  Imported lazily:
        # locks.py publishes INTO this registry, so the two modules
        # bootstrap in either order (locks.py is stdlib-only at module
        # scope; publication is deferred, never inline in acquire).
        from .locks import named_lock

        self._lock = named_lock("metrics_registry", kind="rlock")
        self._metrics: Dict[str, Metric] = {}
        self._views: Dict[str, DictView] = {}

    def _register(
        self, name: str, kind: str, help: str = "",
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}"
                    )
                return m
            m = Metric(name, kind, help, buckets, lock=self._lock)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Metric:
        return self._register(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> Metric:
        return self._register(name, "gauge", help)

    def histogram(
        self, name: str, help: str = "",
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> Metric:
        return self._register(name, "histogram", help, buckets)

    def dict_view(
        self, name: str, help: str = "", initial: Optional[dict] = None
    ) -> DictView:
        """A legacy-dict facade over a gauge family labeled ``key``.
        Idempotent per name: a repeat call (module reload, a test
        re-importing bench.py) returns the SAME view with any new
        initial keys merged non-destructively — live counters are never
        zeroed and the view table stays bounded."""
        metric = self._register(name, "gauge", help)
        with self._lock:
            view = self._views.get(name)
            if view is None:
                view = DictView(metric, initial)
                self._views[name] = view
            elif initial:
                view._initial.update(initial)
                view.seed()
        return view

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Plain nested dict of every sample: {metric: {labelstr: value}}
        with labelstr ``'k=v,k2=v2'`` (empty string for unlabeled) and
        histogram values flattened to {"sum", "count"}.  Safe to hold
        across a fit and diff with `delta`."""
        out: Dict[str, Dict[str, Any]] = {}
        for m in self.metrics():
            fam: Dict[str, Any] = {}
            for lk, v in m.samples().items():
                ls = ",".join(f"{k}={val}" for k, val in lk)
                if isinstance(v, dict):
                    fam[ls] = {"sum": v["sum"], "count": v["count"]}
                else:
                    fam[ls] = v
            out[m.name] = fam
        return out

    def reset(self) -> None:
        """Zero every sample; registrations (and dict-view initial keys)
        survive."""
        with self._lock:
            for m in self._metrics.values():
                m.clear()
            for v in self._views.values():
                v._strs.clear()
                v.seed()


def delta(
    before: Dict[str, Dict[str, Any]], after: Dict[str, Dict[str, Any]]
) -> Dict[str, Dict[str, Any]]:
    """Numeric per-sample change between two `snapshot()`s, keeping only
    samples that moved (per-fit reports, bench section telemetry).
    Histogram samples diff their {"sum", "count"} pair."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, fam in after.items():
        prev = before.get(name, {})
        changed: Dict[str, Any] = {}
        for ls, v in fam.items():
            p = prev.get(ls)
            if isinstance(v, dict):
                pc = (p or {}).get("count", 0)
                if v.get("count", 0) != pc:
                    changed[ls] = {
                        "count": v.get("count", 0) - pc,
                        "sum": round(
                            v.get("sum", 0.0) - (p or {}).get("sum", 0.0), 6
                        ),
                    }
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                pv = p if isinstance(p, (int, float)) else 0
                if v != pv:
                    changed[ls] = v - pv
        if changed:
            out[name] = changed
    return out


def check_cardinality(
    registry: Optional["MetricsRegistry"] = None,
) -> List[str]:
    """Live label-cardinality audit against METRIC_CATALOG: returns one
    problem string per family whose DISTINCT labelset count exceeds its
    declared bound (a label fed from an unbounded value — a run id, a
    timestamp — blows past it immediately).  Run by tests."""
    reg = registry or REGISTRY
    problems: List[str] = []
    for m in reg.metrics():
        spec = METRIC_CATALOG.get(m.name)
        if spec is None:
            continue  # private/test registries may carry their own names
        n = len(m.samples())
        bound = int(spec.get("cardinality", 0) or 0)
        if bound and n > bound:
            problems.append(
                f"metric {m.name!r}: {n} distinct labelsets exceed the "
                f"declared cardinality bound {bound}"
            )
    return problems


# the process-global default registry every module-level view and counter
# registers with; tests may build private MetricsRegistry instances
REGISTRY = MetricsRegistry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
dict_view = REGISTRY.dict_view
snapshot = REGISTRY.snapshot
reset_metrics = REGISTRY.reset


__all__ = [
    "DictView",
    "METRIC_CATALOG",
    "Metric",
    "MetricsRegistry",
    "REGISTRY",
    "check_cardinality",
    "counter",
    "delta",
    "dict_view",
    "gauge",
    "histogram",
    "reset_metrics",
    "snapshot",
]
