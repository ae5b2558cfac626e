#
# telemetry/ — the part of spark_rapids_ml_tpu/telemetry/ the serving path
# reads, ported for one card:
#
#   registry.py     the typed process-global metrics registry
#                   (Counter/Gauge/Histogram with labels and exemplars,
#                   dict views, snapshot/delta/reset, the whole
#                   METRIC_CATALOG and its cardinality check).  The
#                   resilience layer's counters live here
#                   (resilience/metrics.py).
#   locks.py        named instrumented locks (LOCK_CATALOG, the live
#                   holder/waiter table, `lock_slow_wait[...]` markers)
#   utilization.py  the device idle-gap timeline and its attribution
#   report.py       `span_tree` alone
#
# Span correlation lives in tracing.py.  The exporters, the per-fit
# reports, memory, the heartbeat, compile tracking, the aggregate and
# fleet views, the flight recorder and the hang doctor are not ported yet
# (ROADMAP.md section 1, item 6).
#
# Like resilience/, this package imports neither torch nor numpy at
# module scope: reading a counter must not pay an accelerator import.
#
from .locks import (  # noqa: F401
    LOCK_CATALOG,
    NamedLock,
    NamedRLock,
    lock_table,
    named_lock,
    publish_lock_metrics,
)
from .registry import (  # noqa: F401
    METRIC_CATALOG,
    REGISTRY,
    DictView,
    Metric,
    MetricsRegistry,
    check_cardinality,
    counter,
    delta,
    dict_view,
    gauge,
    histogram,
    reset_metrics,
    snapshot,
)
from .report import span_tree  # noqa: F401
from .utilization import (  # noqa: F401
    note_interval,
    summarize_utilization,
)

__all__ = [
    "DictView",
    "LOCK_CATALOG",
    "METRIC_CATALOG",
    "Metric",
    "MetricsRegistry",
    "NamedLock",
    "NamedRLock",
    "REGISTRY",
    "check_cardinality",
    "counter",
    "delta",
    "dict_view",
    "gauge",
    "histogram",
    "lock_table",
    "named_lock",
    "note_interval",
    "publish_lock_metrics",
    "reset_metrics",
    "snapshot",
    "span_tree",
    "summarize_utilization",
]
