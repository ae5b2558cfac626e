#
# The port's tracing and the telemetry the serving path reads
# (spark_rapids_ml_torch/tracing.py, telemetry/registry.py, locks.py,
# utilization.py, report.py `span_tree`) on the CPU: the JAX package's
# tests/test_tracing.py, tests/test_locks_utilization.py and the registry
# and span half of tests/test_telemetry.py ported to the port's API, the
# registry checked against the JAX package's (the same catalog, snapshots
# of the same operations equal), and the resilience counters in the
# registry.  Left out until their modules are ported (ROADMAP.md item 6):
# the exporters (Chrome trace, Prometheus, the /metrics endpoint), the
# heartbeat, per-fit reports with memory, utilization and compile
# sections, the flight recorder's reentrancy case and the dict views of
# the staging and cache counters.
#
import json
import os
import threading
import time

import numpy as np
import pytest

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.telemetry import locks, utilization
from spark_rapids_ml_torch.telemetry.locks import (
    LOCK_CATALOG,
    lock_table,
    named_lock,
    publish_lock_metrics,
)
from spark_rapids_ml_torch.telemetry.registry import (
    METRIC_CATALOG,
    REGISTRY,
    MetricsRegistry,
    check_cardinality,
    delta,
)
from spark_rapids_ml_torch.tracing import (
    add_trace_tap,
    current_run_id,
    event,
    get_all_trace_events,
    get_trace_events,
    mint_run_id,
    record_span,
    remove_trace_tap,
    reset_trace,
    run_context,
    summarize,
    trace,
)
from torch_serving_support import reset_port_state

set_config = port_config.set_config


@pytest.fixture(autouse=True)
def _clean():
    reset_port_state()
    yield
    reset_port_state()


def _core(name):
    cores = [c for n, _k, c in locks._live_cores() if n == name]
    assert cores, f"lock {name!r} not registered"
    return cores[-1]


def _row(name):
    rows = [r for r in lock_table() if r["name"] == name]
    assert rows, f"lock {name!r} not in table"
    return rows[-1]


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


def test_nested_trace_depth():
    with trace("outer"):
        with trace("inner"):
            pass
    events = {e.name: e for e in get_trace_events()}
    assert events["inner"].depth == 1
    assert events["outer"].depth == 0


def test_spans_carry_timestamps_thread_and_run_id():
    wall0 = time.time()
    with run_context(prefix="fit") as rid:
        assert current_run_id() == rid and rid.startswith("fit-")
        with trace("outer"):
            with trace("inner"):
                pass
    assert current_run_id() == ""
    ev = {e.name: e for e in get_trace_events()}
    for name in ("outer", "inner"):
        e = ev[name]
        assert e.run_id == rid and e.kind == "span"
        assert wall0 <= e.t0 <= e.t1 <= time.time()
        assert e.thread_id == threading.get_ident()
    assert ev["outer"].t0 <= ev["inner"].t0
    assert ev["inner"].t1 <= ev["outer"].t1 + 1e-6


def test_summarize_renders_start_order():
    with trace("parent"):
        with trace("child_a"):
            pass
        with trace("child_b"):
            pass
    with trace("sibling"):
        pass
    lines = summarize().splitlines()
    assert [ln.strip().split(":")[0] for ln in lines] == ["parent", "child_a", "child_b",
                                                          "sibling"]
    assert lines[0].startswith("parent") and lines[1].startswith("  ")


def test_run_context_nests_and_restores():
    with run_context("outer-run"):
        with run_context() as inner:
            assert current_run_id() == inner != "outer-run"
        assert current_run_id() == "outer-run"
    assert mint_run_id("req").startswith("req-") and len(mint_run_id()) == len("run-") + 12


def test_event_and_record_span_and_taps():
    seen = []
    tap = seen.append
    add_trace_tap(tap)
    add_trace_tap(tap)  # idempotent
    try:
        with run_context("tap-run"):
            event("retry[x]", detail="attempt=1")
            record_span("measured", 10.0, 12.5, detail="w")
    finally:
        remove_trace_tap(tap)
    event("after")
    names = [e.name for e in seen]
    assert names == ["retry[x]", "measured"]
    inst, span = seen
    assert inst.kind == "instant" and inst.t0 == inst.t1 and inst.run_id == "tap-run"
    assert span.kind == "span" and span.seconds == 2.5 and span.detail == "w"


def test_adopted_context_joins_the_callers_buffer_and_run():
    from spark_rapids_ml_torch.tracing import adopt_trace_context

    with run_context("adopt-run"):
        with trace("caller"):
            adopt = adopt_trace_context()

            def worker():
                adopt()
                with trace("on_worker"):
                    pass

            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
    ev = {e.name: e for e in get_trace_events()}
    assert ev["on_worker"].run_id == "adopt-run" and ev["on_worker"].depth == 1
    allev = get_all_trace_events(run_id="adopt-run")
    assert [e.name for e in allev].count("on_worker") == 1


def test_guarded_timeout_leaves_closed_span_tree():
    from spark_rapids_ml_torch.resilience import DispatchTimeout, guarded

    release = threading.Event()

    def work():
        with trace("worker_done"):
            pass
        with trace("worker_hung"):
            release.wait(5.0)

    with run_context(prefix="fit") as rid:
        with trace("fit_span"):
            with pytest.raises(DispatchTimeout):
                guarded(work, deadline=0.2, label="probe")
    release.set()
    from spark_rapids_ml_torch.resilience import wait_abandoned

    assert wait_abandoned(5.0) == 0
    by_name = {e.name: e for e in get_trace_events()}
    assert by_name["worker_done"].run_id == rid
    assert by_name["dispatch_timeout[probe]"].run_id == rid
    assert by_name["dispatch_timeout[probe]"].kind == "instant"
    for e in get_trace_events():
        assert e.t1 >= e.t0


def test_verbose_logs_stages():
    import logging

    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    lg = logging.getLogger("spark_rapids_ml_torch.tracing")
    lg.addHandler(handler)
    try:
        set_config(verbose=1)
        with trace("logged_stage"):
            pass
        event("logged_marker")
    finally:
        lg.removeHandler(handler)
    assert any("[trace] logged_stage" in m for m in records)
    assert any("[trace] logged_marker" in m for m in records)


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    import torch

    from spark_rapids_ml_torch.tracing import device_profile

    set_config(profile_dir=str(tmp_path / "prof"))
    with device_profile():
        with device_profile():  # nested regions share the one profile
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    payload = json.loads((tmp_path / "prof" / files[0]).read_text())
    assert payload["traceEvents"]
    set_config(profile_dir=None)
    with device_profile():
        pass
    assert len(os.listdir(tmp_path / "prof")) == 1


def test_profile_dir_writes_a_trace_of_each_fit(tmp_path):
    """A fit runs under `device_profile`, as in the JAX package."""
    from spark_rapids_ml_torch.feature import PCA

    set_config(profile_dir=str(tmp_path / "fits"))
    X = np.random.default_rng(0).normal(size=(100, 4)).astype(np.float32)
    PCA(k=2).setInputCol("features").setOutputCol("o").fit({"features": X})
    assert len(os.listdir(tmp_path / "fits")) == 1


def test_span_tree_nests_by_depth_with_instants():
    from spark_rapids_ml_torch.telemetry import span_tree

    with run_context("tree-run"):
        with trace("root"):
            with trace("child"):
                event("mark", detail="d")
            with trace("child2"):
                pass
    tree = span_tree(get_all_trace_events(run_id="tree-run"))
    assert [n["name"] for n in tree] == ["root"]
    kids = tree[0]["children"]
    assert [n["name"] for n in kids] == ["child", "child2"]
    assert kids[0]["children"] == [dict(kids[0]["children"][0], instant=True, detail="d")]
    assert "children" not in kids[1]


def test_span_tree_matches_jax():
    from spark_rapids_ml_torch.telemetry import span_tree
    from spark_rapids_ml_torch.tracing import TraceEvent
    from spark_rapids_ml_tpu.telemetry.report import span_tree as jax_span_tree
    from spark_rapids_ml_tpu.tracing import TraceEvent as JaxTraceEvent

    rng = np.random.default_rng(0)
    spec = []
    for i in range(40):
        t0 = float(rng.uniform(0, 10))
        dt = float(rng.choice([0.0, rng.uniform(0, 1)]))
        spec.append((f"e{i}", dt, int(rng.integers(0, 3)), "d" if i % 5 == 0 else "",
                     t0, t0 + dt, "instant" if dt == 0.0 else "span"))
    mine = [TraceEvent(n, s, dp, det, t0=a, t1=b, kind=k) for n, s, dp, det, a, b, k in spec]
    theirs = [JaxTraceEvent(n, s, dp, det, t0=a, t1=b, kind=k) for n, s, dp, det, a, b, k in spec]
    assert span_tree(mine) == jax_span_tree(theirs)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_counter_gauge_histogram_labels():
    reg = MetricsRegistry()
    c = reg.counter("requests", "help text")
    c.inc()
    c.inc(2, site="fit")
    assert c.value() == 1
    assert c.value(site="fit") == 2
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("depth")
    g.set(3)
    g.dec()
    assert g.value() == 2
    h = reg.histogram("latency", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    s = h.samples()[()]
    assert s["count"] == 3 and s["buckets"] == [1, 2]
    assert s["sum"] == pytest.approx(5.55)
    assert reg.counter("requests") is c
    with pytest.raises(ValueError):
        reg.gauge("requests")
    with pytest.raises(TypeError):
        h.inc()


def test_histogram_exemplars_are_bounded():
    reg = MetricsRegistry()
    h = reg.histogram("lat")
    for i in range(10):
        h.observe(0.01 * i, exemplar=f"req-{i}", model="m")
    ex = h.exemplars(model="m")
    assert [e["id"] for e in ex] == ["req-6", "req-7", "req-8", "req-9"]
    assert h.exemplars(model="other") == []


def test_registry_snapshot_delta_and_reset():
    reg = MetricsRegistry()
    c = reg.counter("x")
    c.inc(5, kind="a")
    before = reg.snapshot()
    c.inc(3, kind="a")
    c.inc(1, kind="b")
    assert delta(before, reg.snapshot()) == {"x": {"kind=a": 3, "kind=b": 1}}
    view = reg.dict_view("v", initial={"n": 0})
    view["n"] = 7
    reg.reset()
    assert c.value(kind="a") == 0
    assert view["n"] == 0


def test_dict_view_surface():
    reg = MetricsRegistry()
    v = reg.dict_view("legacy", initial={"hits": 0})
    v["hits"] += 2
    v["label"] = "stage"
    v.update(bytes=1024, mb_per_s=3.5)
    assert v["hits"] == 2 and isinstance(v["hits"], int)
    assert v.get("missing") is None and "bytes" in v
    assert dict(v) == {"hits": 2, "bytes": 1024, "mb_per_s": 3.5, "label": "stage"}
    v.clear()
    assert len(v) == 0
    v.bump("fresh")
    assert v["fresh"] == 1
    assert reg.dict_view("legacy", initial={"other": 0}) is v


def test_catalog_and_snapshot_semantics_match_jax():
    """The whole catalog is the JAX package's, and the same operations on
    a fresh registry of each package give equal snapshots and deltas."""
    from spark_rapids_ml_tpu.telemetry import registry as jax_registry

    assert METRIC_CATALOG == jax_registry.METRIC_CATALOG

    def drive(reg):
        c = reg.counter("retries_total")
        g = reg.gauge("serving_queue_depth")
        h = reg.histogram("serving_batch_rows", buckets=(1.0, 4.0, 16.0))
        before = reg.snapshot()
        c.inc(label="a", action="oom")
        c.inc(2, label="a", action="oom")
        g.set(5, model="m")
        g.dec(2, model="m")
        for v in (1, 3, 9, 40):
            h.observe(v, model="m")
        v = reg.dict_view("recovery", initial={"losses": 0})
        v.bump("losses")
        return reg.snapshot(), delta(before, reg.snapshot())

    assert drive(MetricsRegistry()) == drive(jax_registry.MetricsRegistry())


def test_check_cardinality_flags_unbounded_labels():
    reg = MetricsRegistry()
    c = reg.counter("checkpoint_saves_total")
    c.inc()
    assert check_cardinality(reg) == []
    c.inc(run="a")
    problems = check_cardinality(reg)
    assert problems and "checkpoint_saves_total" in problems[0]


def test_resilience_counters_live_in_the_registry():
    """The port's resilience counters are the JAX package's families in
    the registry; `counts_snapshot` keeps the port's keys."""
    from spark_rapids_ml_torch.resilience import counts_snapshot, fault_inject, maybe_inject
    from spark_rapids_ml_torch.resilience import metrics as rmetrics
    from spark_rapids_ml_torch.resilience.retry import RETRIES

    assert RETRIES is REGISTRY.get("retries_total")
    with fault_inject("fit_kernel", "timeout", times=1):
        with pytest.raises(Exception):
            maybe_inject("fit_kernel")
    rmetrics.inc("retries_total", label="fit_kernel", action="transient")
    rmetrics.inc("checkpoint_saves_total")
    snap = REGISTRY.snapshot()
    assert snap["faults_injected_total"] == {"kind=timeout,site=fit_kernel": 1}
    assert snap["retries_total"] == {"action=transient,label=fit_kernel": 1}
    assert counts_snapshot() == {
        "faults_injected_total{kind=timeout,site=fit_kernel}": 1,
        "retries_total{action=transient,label=fit_kernel}": 1,
        "checkpoint_saves_total": 1,
    }
    names = [e.name for e in get_trace_events()]
    assert "fault_injected[fit_kernel]" in names


def test_fit_report_keeps_its_resilience_key():
    from spark_rapids_ml_torch.clustering import KMeans
    from spark_rapids_ml_torch.resilience import fault_inject

    X = np.random.default_rng(0).normal(size=(240, 3))
    with fault_inject("fit_kernel", "oom", times=1):
        m = KMeans(k=2, seed=0).fit({"features": X})
    res = m.fit_report()["resilience"]
    assert res["faults_injected_total{kind=oom,site=fit_kernel}"] == 1
    assert res["retries_total{action=oom,label=fit_kernel}"] == 1


# ---------------------------------------------------------------------------
# named locks
# ---------------------------------------------------------------------------


def test_uncontended_acquire_counts_but_never_waits():
    lk = named_lock("t_plain")
    for _ in range(5):
        with lk:
            pass
    core = _core("t_plain")
    assert core.acquisitions == 5 and core.contended == 0
    assert core.wait_s == 0.0 and core.hold_s >= 0.0


def test_contended_wait_seconds_measured():
    lk = named_lock("t_meter")
    hold_s = 0.25
    started = threading.Event()

    def holder():
        with lk:
            started.set()
            time.sleep(hold_s)

    t = threading.Thread(target=holder)
    t.start()
    started.wait()
    time.sleep(0.02)
    t0 = time.perf_counter()
    with lk:
        waited = time.perf_counter() - t0
    t.join()
    core = _core("t_meter")
    assert core.acquisitions == 2 and core.contended == 1
    assert abs(core.wait_s - waited) < 0.05, (core.wait_s, waited)
    assert 0.1 < core.wait_s < 2.0
    assert core.hold_s >= hold_s * 0.8


def test_hold_seconds_accumulate():
    lk = named_lock("t_hold")
    with lk:
        time.sleep(0.05)
    assert 0.04 < _core("t_hold").hold_s < 1.0


def test_rlock_reentrant_depth_and_single_hold_window():
    rl = named_lock("t_rl", kind="rlock")
    with rl:
        with rl:
            assert _row("t_rl")["holder"]["depth"] == 2
        time.sleep(0.05)
    core = _core("t_rl")
    assert core.acquisitions == 2 and core.hold_s >= 0.04
    assert _row("t_rl").get("holder") is None


def test_holder_and_waiter_table_live():
    lk = named_lock("t_table")
    in_hold = threading.Event()
    release = threading.Event()

    def holder():
        with lk:
            in_hold.set()
            release.wait(timeout=5)

    def waiter():
        lk.acquire(timeout=5)
        lk.release()

    th = threading.Thread(target=holder, name="t-holder")
    th.start()
    in_hold.wait()
    tw = threading.Thread(target=waiter, name="t-waiter")
    tw.start()
    deadline = time.time() + 2
    row = None
    while time.time() < deadline:
        row = _row("t_table")
        if row.get("waiters"):
            break
        time.sleep(0.01)
    assert row is not None and row["holder"]["thread"] == "t-holder"
    assert [w["thread"] for w in row["waiters"]] == ["t-waiter"]
    release.set()
    th.join()
    tw.join()
    row = _row("t_table")
    assert row.get("holder") is None and not row.get("waiters")


def test_condition_flavor_profiles_and_works():
    cv = named_lock("t_cond", kind="condition")
    assert isinstance(cv, threading.Condition)
    got = []

    def consumer():
        with cv:
            while not got:
                if not cv.wait(timeout=5):
                    return
        got.append("woke")

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.05)
    with cv:
        got.append("notified")
        cv.notify_all()
    t.join()
    assert got == ["notified", "woke"]
    assert _core("t_cond").acquisitions >= 3


def test_publish_lock_metrics_monotone_registry_counters():
    lk = named_lock("t_pub")
    for _ in range(7):
        with lk:
            pass
    publish_lock_metrics()
    acq = REGISTRY.get("lock_acquisitions_total")
    first = acq.value(lock="t_pub")
    assert first >= 7
    publish_lock_metrics()
    assert acq.value(lock="t_pub") == first
    with lk:
        pass
    publish_lock_metrics()
    assert acq.value(lock="t_pub") == first + 1


def test_publish_lock_metrics_concurrent_callers_publish_exactly_once():
    lk = named_lock("t_pub_race")
    for _ in range(50):
        with lk:
            pass
    barrier = threading.Barrier(2, timeout=5)

    def pub():
        barrier.wait()
        publish_lock_metrics()

    ts = [threading.Thread(target=pub) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    acq = REGISTRY.get("lock_acquisitions_total")
    assert acq.value(lock="t_pub_race") == 50
    with lk:
        pass
    publish_lock_metrics()
    assert acq.value(lock="t_pub_race") == 51


def test_slow_wait_marker_lands_in_span_tree():
    lk = named_lock("t_slow")
    set_config(lock_slow_wait_ms=10.0)
    with locks._table_mu:
        locks._slow_conf["t"] = 0.0
    started = threading.Event()

    def holder():
        with lk:
            started.set()
            time.sleep(0.1)

    t = threading.Thread(target=holder)
    t.start()
    started.wait()
    try:
        with run_context("run-slowwait"):
            with lk:
                pass
        evs = [e for e in get_trace_events() if e.name == "lock_slow_wait[t_slow]"]
        assert evs, "expected a slow-wait instant marker"
        assert evs[-1].run_id == "run-slowwait" and evs[-1].kind == "instant"
    finally:
        t.join()


def test_slow_wait_in_a_trace_tap_does_not_recurse():
    """A tap that contends on a named lock past the threshold emits a
    slow-wait event, which runs the same tap again on the same thread:
    the re-entrancy guard keeps that from recursing."""
    lk = named_lock("t_tap_lock", kind="rlock")
    set_config(lock_slow_wait_ms=10.0)
    with locks._table_mu:
        locks._slow_conf["t"] = 0.0
    calls = []

    def tap(e):
        calls.append(e.name)
        with lk:
            pass

    held = threading.Event()

    def hog():
        with lk:
            held.set()
            time.sleep(0.2)

    th = threading.Thread(target=hog)
    th.start()
    held.wait()
    add_trace_tap(tap)
    try:
        done = threading.Event()
        te = threading.Thread(target=lambda: (event("t_probe"), done.set()))
        te.start()
        assert done.wait(timeout=10)
        te.join(timeout=5)
    finally:
        remove_trace_tap(tap)
        th.join()
    assert calls[0] == "t_probe" and "lock_slow_wait[t_tap_lock]" in calls


def test_catalog_names_the_port_modules():
    from spark_rapids_ml_tpu.telemetry.locks import LOCK_CATALOG as JAX_LOCK_CATALOG

    assert set(LOCK_CATALOG) == set(JAX_LOCK_CATALOG)
    for name, spec in LOCK_CATALOG.items():
        assert spec["kind"] == JAX_LOCK_CATALOG[name]["kind"], name
        assert spec["module"] == JAX_LOCK_CATALOG[name]["module"].replace(
            "spark_rapids_ml_tpu/", "spark_rapids_ml_torch/"), name
    for name in ("serving_dispatch", "serving_report", "serving_registry",
                 "serving_control", "metrics_registry"):
        assert os.path.exists(os.path.join(os.path.dirname(__file__), "..",
                                           LOCK_CATALOG[name]["module"])), name


# ---------------------------------------------------------------------------
# utilization timeline
# ---------------------------------------------------------------------------


def test_busy_gauge_clears_when_window_empties():
    now = time.perf_counter()
    utilization.note_interval("device", now - 0.2, now - 0.1, cause="x", domain="serving")
    s = utilization.summarize(window_s=60.0, scope="t_scope", domain="serving")
    g = REGISTRY.get("device_busy_fraction")
    assert s and g.value(scope="t_scope") == s["device_busy_fraction"]
    utilization.clear()
    assert utilization.summarize(window_s=60.0, scope="t_scope", domain="serving") == {}
    sentinel = object()
    assert g.value(default=sentinel, scope="t_scope") is sentinel


def test_serving_window_summary_excludes_fit_intervals():
    now = time.perf_counter()
    utilization.note_interval("device", now - 2.0, now - 1.0, cause="fit_kernel", domain="fit")
    utilization.note_interval("device", now - 0.5, now - 0.4, cause="pca", domain="serving")
    utilization.note_interval("lock_wait", now - 0.45, now - 0.42, cause="x", domain="any")
    s = utilization.summarize(window_s=60.0, domain="serving")
    assert abs(s["device_busy_s"] - 0.1) < 0.02, s
    utilization.clear()
    utilization.note_interval("device", now - 500.0, now, cause="long", domain="serving")
    assert utilization.summarize(window_s=60.0, domain="serving")["wall_s"] <= 61.0


def test_interval_math_merge_overlap_complement():
    assert utilization.merge_intervals([(3, 4), (1, 2), (1.5, 3.2)]) == [(1, 4)]
    assert utilization.interval_overlap_s([(0, 2)], [(1, 3)]) == 1
    assert utilization.complement([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]
    assert utilization.complement([], 0, 2) == [(0, 2)]


def test_summarize_busy_fraction_and_gap_attribution():
    run = "run-util-t1"
    utilization.note_interval("device", 0.0, 1.0, run_id=run)
    utilization.note_interval("device", 2.0, 3.0, run_id=run)
    utilization.note_interval("host_prep", 0.5, 2.5, cause="decode", run_id=run)
    utilization.note_interval("lock_wait", 1.2, 1.4, cause="device_step", run_id=run)
    s = utilization.summarize(run_id=run)
    assert s["wall_s"] == 3.0 and s["device_busy_s"] == 2.0
    assert abs(s["device_busy_fraction"] - 2.0 / 3.0) < 1e-3
    assert s["gap_s"] == 1.0
    rows = {(r["kind"], r.get("cause")): r["stolen_s"] for r in s["gap_attribution"]}
    assert abs(rows[("host_prep", "decode")] - 1.0) < 1e-9
    assert abs(rows[("lock_wait", "device_step")] - 0.2) < 1e-9
    assert s["gap_attribution"][0]["kind"] == "host_prep"
    assert s["unattributed_s"] == 0.0


def test_summarize_unattributed_residual():
    run = "run-util-t2"
    utilization.note_interval("device", 0.0, 1.0, run_id=run)
    utilization.note_interval("device", 3.0, 4.0, run_id=run)
    utilization.note_interval("host_prep", 1.0, 1.5, run_id=run)
    s = utilization.summarize(run_id=run)
    assert s["gap_s"] == 2.0 and abs(s["unattributed_s"] - 1.5) < 1e-9


def test_summarize_scope_sets_gauge_and_empty_is_empty():
    assert utilization.summarize(run_id="nothing-recorded") == {}
    utilization.note_interval("device", 0.0, 1.0, run_id="run-util-g")
    utilization.summarize(run_id="run-util-g", scope="fit")
    assert REGISTRY.get("device_busy_fraction").value(scope="fit") == 1.0


def test_summaries_match_jax_on_the_same_intervals():
    from spark_rapids_ml_tpu.telemetry import utilization as jax_util

    rng = np.random.default_rng(3)
    jax_util.clear()
    try:
        kinds = ("device", "stage", "compute", "collect", "lock_wait")
        for i in range(60):
            t0 = float(rng.uniform(0, 20))
            t1 = t0 + float(rng.uniform(0.01, 2))
            kind = kinds[i % len(kinds)]
            cause = f"c{i % 3}"
            utilization.note_interval(kind, t0, t1, cause=cause, run_id="same")
            jax_util.note_interval(kind, t0, t1, cause=cause, run_id="same")
        assert utilization.summarize(run_id="same") == jax_util.summarize(run_id="same")
    finally:
        jax_util.clear()


def test_contended_named_lock_feeds_lock_wait_interval():
    lk = named_lock("t_util_lock")
    started = threading.Event()

    def holder():
        with lk:
            started.set()
            time.sleep(0.15)

    t = threading.Thread(target=holder)
    t.start()
    started.wait()
    with run_context("run-util-lk"):
        with lk:
            pass
    t.join()
    evs = [e for e in utilization.timeline(run_id="run-util-lk")
           if e[1] == "lock_wait" and e[2] == "t_util_lock"]
    assert evs and 0.05 < evs[0][4] - evs[0][3] < 2.0


def test_serving_queue_depth_gauge_tracks():
    from spark_rapids_ml_torch.serving import ServingServer
    from torch_serving_support import port_pca

    rng = np.random.default_rng(0)
    server = ServingServer()
    server.register("echo", port_pca())
    server.start()
    try:
        server.pause()
        depth = REGISTRY.get("serving_queue_depth")
        futs = [server.submit("echo", rng.normal(size=(1, 16)).astype(np.float32))
                for _ in range(5)]
        assert depth.value(model="echo") == 5
        server.resume()
        for f in futs:
            f.result(timeout=60)
        deadline = time.time() + 5
        while time.time() < deadline and depth.value(model="echo") != 0:
            time.sleep(0.02)
        assert depth.value(model="echo") == 0
        lag = REGISTRY.get("serving_dispatcher_lag_seconds")
        deadline = time.time() + 3
        while time.time() < deadline and lag.value(default=None) is None:
            time.sleep(0.05)
        assert lag.value(default=None) is not None and lag.value() >= 0.0
        util = server.report()["_totals"].get("utilization")
        assert util and util["wall_s"] > 0
    finally:
        server.stop()
        server.registry.clear()


def test_trace_reset_clears_only_this_thread():
    with trace("kept_elsewhere"):
        pass
    reset_trace()
    assert get_trace_events() == []
