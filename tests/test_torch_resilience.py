#
# The port's resilience layer (spark_rapids_ml_torch/resilience/) on the
# JAX package's cases (tests/test_resilience.py and the one-device cases of
# tests/test_elastic.py), run on the port's fits and transforms on the
# CPU: the classifiers on the JAX strings and CUDA's, the watchdog, the
# retry policy and its backoff, the fault grammar and registries (equal to
# the JAX package's), recovery of injected OOM, timeout, hang, preemption
# and device loss in fit and transform, and checkpoint/resume of every
# iterative fit.  Fast retries (backoff 0.01 s, no jitter) and watchdog
# deadlines under a second; the conf, the armed faults, the counters and
# the elastic state are reset around every test.
#
import os
import time

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.resilience import (
    FAULT_KINDS,
    KNOWN_SITES,
    RECOVERY_METRICS,
    DispatchTimeout,
    RankLost,
    RetryPolicy,
    SimulatedPreemption,
    checkpoint_file_for,
    classify_error,
    fault_inject,
    get_events,
    guarded,
    is_device_loss,
    is_oom,
    is_preemption,
    is_sticky_cuda_error,
    is_transient,
    load_checkpoint,
    maybe_inject,
    probe_lost_devices,
    recover_from_device_loss,
    reset_elastic,
    reset_faults,
    reset_metrics,
    retry_call,
    save_checkpoint,
    wait_abandoned,
)
from spark_rapids_ml_tpu import resilience as jax_res


@pytest.fixture(autouse=True)
def _clean():
    set_default_device("cpu")
    for reset in (port_config.reset_config, reset_faults, reset_metrics, reset_elastic):
        reset()
    yield
    wait_abandoned()
    for reset in (port_config.reset_config, reset_faults, reset_metrics, reset_elastic):
        reset()
    set_default_device(None)


def _fast_retries(**overrides):
    port_config.set_config(**dict(dict(retry_backoff_s=0.01, retry_jitter=0.0), **overrides))


def _names():
    return [e.name for e in get_events()]


# ---------------------------------------------------------------------------
# classifiers
# ---------------------------------------------------------------------------

_STRINGS = {
    "RESOURCE_EXHAUSTED: out of HBM": "oom",
    "Out of memory allocating 1234 bytes": "oom",
    "CUDA out of memory. Tried to allocate 2.00 GiB": "oom",
    "DEADLINE_EXCEEDED: tunnel stall": "transient",
    "UNAVAILABLE: Socket closed": "transient",
    "TPU worker preempted by scheduler": "preemption",
    "DATA_LOSS: worker state lost": "preemption",
    "coordination service heartbeat timed out": "preemption",
    "UNAVAILABLE: Heartbeat request failed": "preemption",
    "Coordination service agent: Socket closed before barrier": "preemption",
    "INTERNAL: failed to execute XLA Runtime executable: device 2 has been lost": "device_loss",
    "device TPU_2 is in an invalid state": "device_loss",
    "INTERNAL: Mosaic failed ... remote_compile: HTTP 500 Internal Server Error": "transient",
    "UNAVAILABLE ... remote_compile: connection refused": "transient",
    "JaxRuntimeError: INTERNAL: Mosaic failed ... remote_compile: HTTP 400 bad program": "fatal",
    "INTERNAL: unsupported op": "fatal",
    "failed to execute query": "fatal",
    "INTERNAL: Failed to execute XLA Runtime executable: custom call 'xla.gpu.foo' failed":
        "fatal",
    "heartbeat animation glitch": "fatal",
    "something broke": "fatal",
}


@pytest.mark.parametrize("message", list(_STRINGS))
def test_classifiers_equal_jax_on_its_strings(message):
    e = RuntimeError(message)
    assert classify_error(e) == jax_res.classify_error(e) == _STRINGS[message]


_CUDA_STICKY = (
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered\nCUDA kernel errors might be asynchronously "
    "reported",
    "CUDA error: unspecified launch failure",
    "CUDA error: an illegal instruction was encountered",
    "CUDA error: misaligned address",
)


@pytest.mark.parametrize("message", _CUDA_STICKY)
def test_sticky_cuda_errors_are_device_loss_and_never_retried(message):
    calls = {"n": 0}

    def poisoned():
        calls["n"] += 1
        raise RuntimeError(message)

    e = RuntimeError(message)
    assert is_sticky_cuda_error(e) and is_device_loss(e)
    assert classify_error(e) == "device_loss"
    _fast_retries()
    with pytest.raises(RuntimeError, match="CUDA error"):
        retry_call(poisoned, label="t")
    assert calls["n"] == 1, "a poisoned context is not retried in the same process"
    assert "sticky_error[t]" in _names() and "retry[t]" not in _names()


def test_error_classifiers():
    assert is_oom(RuntimeError("RESOURCE_EXHAUSTED: out of HBM"))
    assert is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    assert not is_oom(ValueError("bad shape"))
    assert is_transient(DispatchTimeout("fit_kernel", 1.0))
    assert is_preemption(SimulatedPreemption("fit_kernel"))
    assert classify_error(SimulatedPreemption("s")) == "preemption"
    assert classify_error(DispatchTimeout("s", 1.0)) == "transient"
    assert classify_error(ValueError("nope")) == "fatal"
    assert not is_sticky_cuda_error(RuntimeError("CUDA out of memory"))
    # no pod layer on one process: the typed rank loss is fatal (the JAX
    # package recovers it by shrinking the quorum)
    assert classify_error(RankLost([1], tag="s")) == "fatal"


def test_registries_equal_jax():
    assert KNOWN_SITES == jax_res.faults.KNOWN_SITES
    assert tuple(FAULT_KINDS) == tuple(jax_res.faults.FAULT_KINDS)


@pytest.mark.parametrize("spec", ["fit_kernel:oom", "transform_dispatch:timeout:2:3",
                                  "a:hang:1, b:preemption:4:0,", "x:device_lost:1:1"])
def test_fault_spec_grammar_equals_jax(spec):
    from spark_rapids_ml_torch.resilience.faults import _parse_spec

    mine, ref = _parse_spec(spec), jax_res.faults._parse_spec(spec)
    assert mine.keys() == ref.keys()
    for site in mine:
        assert [(f.kind, f.times, f.skip) for f in mine[site]] == \
            [(f.kind, f.times, f.skip) for f in ref[site]]


def test_fault_spec_rejects_bad_entries():
    from spark_rapids_ml_torch.resilience.faults import _parse_spec

    with pytest.raises(ValueError, match="site:kind"):
        _parse_spec("fit_kernel")
    with pytest.raises(ValueError, match="unknown fault kind"):
        _parse_spec("fit_kernel:segfault")


# ---------------------------------------------------------------------------
# guarded dispatch
# ---------------------------------------------------------------------------


def test_guarded_passthrough_when_disabled():
    assert guarded(lambda: 42, deadline=0.0) == 42
    assert guarded(lambda: 42) == 42


def test_guarded_returns_value_and_reraises():
    assert guarded(lambda: "ok", deadline=5.0, label="t") == "ok"
    with pytest.raises(ValueError, match="boom"):
        guarded(lambda: (_ for _ in ()).throw(ValueError("boom")), deadline=5.0, label="t")


def test_guarded_deadline_raises_typed_timeout_and_the_next_call_waits():
    done = []
    t0 = time.monotonic()
    with pytest.raises(DispatchTimeout, match="watchdog deadline"):
        guarded(lambda: (time.sleep(0.6), done.append(1)), deadline=0.1, label="hang_site")
    assert time.monotonic() - t0 < 0.5  # the caller got control back
    ev = [e for e in get_events() if e.name == "dispatch_timeout[hang_site]"]
    assert ev and "deadline=0.1" in ev[0].detail
    # the abandoned work runs on; the next guarded call waits for it first
    assert guarded(lambda: len(done), deadline=5.0) == 1


# ---------------------------------------------------------------------------
# retry policies
# ---------------------------------------------------------------------------


def test_retry_call_transient_then_success():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("DEADLINE_EXCEEDED: transient")
        return "done"

    policy = RetryPolicy(max_attempts=3, backoff_s=0.01, jitter=0.0)
    assert retry_call(flaky, label="t", policy=policy) == "done"
    assert calls["n"] == 3 and _names().count("retry[t]") == 2


def test_remote_compile_flake_retries_then_succeeds():
    _fast_retries()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("JaxRuntimeError: INTERNAL: ... remote_compile: HTTP 500")
        return "compiled"

    assert retry_call(flaky, label="compile") == "compiled"
    assert calls["n"] == 3


def test_retry_call_exhausts_attempts():
    def always():
        raise RuntimeError("UNAVAILABLE: still down")

    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        retry_call(always, label="t", policy=RetryPolicy(max_attempts=2, backoff_s=0.01,
                                                         jitter=0.0))


def test_retry_call_fatal_propagates_immediately():
    calls = {"n": 0}

    def fatal():
        calls["n"] += 1
        raise ValueError("not retryable")

    with pytest.raises(ValueError):
        retry_call(fatal, label="t", policy=RetryPolicy(max_attempts=5))
    assert calls["n"] == 1


def test_retry_call_oom_hook_runs_once():
    calls = {"n": 0, "hook": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. injected")
        return "ok"

    def hook():
        calls["hook"] += 1

    policy = RetryPolicy(max_attempts=3, backoff_s=0.01, jitter=0.0)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        retry_call(flaky, label="t", policy=policy, on_oom=hook)
    assert calls["hook"] == 1  # one repair attempt, then the caller's fallback
    calls["n"] = 1
    assert retry_call(flaky, label="t", policy=policy, on_oom=hook) == "ok"


def test_retry_policy_backoff_grows():
    p = RetryPolicy(backoff_s=0.5, backoff_mult=2.0, jitter=0.0)
    assert p.backoff(1) == pytest.approx(0.5)
    assert p.backoff(3) == pytest.approx(2.0)
    port_config.set_config(retry_max_attempts=7, retry_backoff_s=0.1, retry_backoff_mult=3.0,
                           retry_jitter=0.0)
    q = RetryPolicy.from_config()
    assert (q.max_attempts, q.backoff(2)) == (7, pytest.approx(0.3))


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


def test_fault_inject_times_and_skip():
    with fault_inject("site_a", "oom", times=2, skip=1):
        maybe_inject("site_a")
        for _ in range(2):
            with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
                maybe_inject("site_a")
        maybe_inject("site_a")
    maybe_inject("site_a")


def test_fault_inject_conf_spec():
    port_config.set_config(fault_inject_spec="site_b:timeout:1")
    with pytest.raises(DispatchTimeout):
        maybe_inject("site_b")
    maybe_inject("site_b")
    port_config.set_config(fault_inject_spec="")
    maybe_inject("site_b")


def test_fault_inject_unknown_kind_rejected():
    with pytest.raises(ValueError, match="unknown fault kind"):
        with fault_inject("s", "segfault"):
            pass


# ---------------------------------------------------------------------------
# one-device loss (the one-device half of tests/test_elastic.py)
# ---------------------------------------------------------------------------


def test_device_lost_fault_kind_fires_and_registers_loss():
    with fault_inject("dl_site", "device_lost", times=1):
        with pytest.raises(RuntimeError, match="failed to execute") as ei:
            maybe_inject("dl_site")
    assert is_device_loss(ei.value) and classify_error(ei.value) == "device_loss"
    assert probe_lost_devices() == [0]
    maybe_inject("dl_site")


def test_recovery_on_one_device_is_the_full_retry():
    """A healthy probe and a confirmed loss both fall back to the full
    retry (no survivors to shrink to); the shrink itself needs several
    devices."""
    from spark_rapids_ml_torch.resilience.elastic import exclude_devices, simulate_device_loss

    assert probe_lost_devices() == []
    assert recover_from_device_loss() is False
    assert RECOVERY_METRICS["full_retry_fallbacks"] == 1
    simulate_device_loss()
    assert recover_from_device_loss() is False
    assert RECOVERY_METRICS["losses_detected"] == 1
    assert RECOVERY_METRICS["full_retry_fallbacks"] == 2
    assert probe_lost_devices() == [], "the full retry assumes the device is back"
    with pytest.raises(NotImplementedError, match=r"item \(8\)"):
        exclude_devices([0])


# ---------------------------------------------------------------------------
# mid-fit recovery: each injected fault ends in the fault-free model
# ---------------------------------------------------------------------------


def _kmeans_df(seed, n=240):
    X = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return pd.DataFrame({"features": list(X)}), X


@pytest.mark.parametrize("kind", ["oom", "timeout", "preemption", "device_lost", "hang"])
def test_fit_recovers_injected_fault(kind):
    from spark_rapids_ml_torch.clustering import KMeans

    df, _ = _kmeans_df(0)
    _fast_retries(**({"dispatch_deadline_s": 0.9} if kind == "hang" else {}))
    m0 = KMeans(k=2, seed=1).fit(df)
    # a hang of 1.1 s: the retry waits for the abandoned attempt (the hang,
    # then its fit) within its own deadline, then fits
    with fault_inject("fit_kernel", kind, times=1, seconds=1.1):
        m1 = KMeans(k=2, seed=1).fit(df)
    np.testing.assert_array_equal(m0.cluster_centers_, m1.cluster_centers_)
    assert "retry[fit_kernel]" in _names()
    if kind == "hang":
        assert "dispatch_timeout[fit_kernel]" in _names()
    report = m1.fit_report()["resilience"]
    assert report.get(f"faults_injected_total{{kind={kind},site=fit_kernel}}") == 1
    assert sum(v for k, v in report.items() if k.startswith("retries_total")) == 1


def test_a_hang_beyond_every_deadline_ends_in_a_timeout_under_the_default_policy():
    """An abandoned attempt that outlives the retries' deadlines: each
    retry waits for it at most its deadline and raises DispatchTimeout
    without dispatching, so the fit fails within the attempts' deadlines
    instead of joining the hung worker."""
    from spark_rapids_ml_torch.clustering import KMeans

    df, _ = _kmeans_df(1)
    _fast_retries(dispatch_deadline_s=0.2)
    assert RetryPolicy.from_config().max_attempts == 3
    t0 = time.monotonic()
    with pytest.raises(DispatchTimeout):
        with fault_inject("fit_kernel", "hang", times=1, seconds=3.0):
            KMeans(k=2, seed=1).fit(df)
    assert time.monotonic() - t0 < 2.0
    assert wait_abandoned(0.0) == 1  # the hung attempt still runs
    ev = [e.detail for e in get_events() if e.name == "dispatch_timeout[fit_kernel]"]
    assert len(ev) == 3 and sum("abandoned work still running" in d for d in ev) == 2
    assert _names().count("retry[fit_kernel]") == 2


def test_wait_abandoned_is_bounded():
    with pytest.raises(DispatchTimeout):
        guarded(lambda: time.sleep(0.8), deadline=0.05, label="t")
    t0 = time.monotonic()
    assert wait_abandoned(0.1) == 1
    assert time.monotonic() - t0 < 0.5
    assert wait_abandoned() == 0


def test_watchdog_times_out_a_fit_without_retries():
    """With one attempt the watchdog's DispatchTimeout reaches the caller
    within the deadline, and the next fit under the default policy waits
    for the abandoned one within its deadlines and succeeds."""
    from spark_rapids_ml_torch.clustering import KMeans

    df, _ = _kmeans_df(1)
    m0 = KMeans(k=2, seed=1).fit(df)
    _fast_retries(dispatch_deadline_s=0.2, retry_max_attempts=1)
    t0 = time.monotonic()
    with pytest.raises(DispatchTimeout):
        with fault_inject("fit_kernel", "hang", times=1, seconds=0.7):
            KMeans(k=2, seed=1).fit(df)
    assert time.monotonic() - t0 < 0.2 + 2.0
    _fast_retries(dispatch_deadline_s=0.9)
    m1 = KMeans(k=2, seed=1).fit(df)
    np.testing.assert_array_equal(m0.cluster_centers_, m1.cluster_centers_)


@pytest.mark.parametrize("kind", ["oom", "timeout", "preemption", "device_lost"])
def test_transform_recovers_injected_fault(kind):
    """The chunks in flight are dropped and the transform resumes at the
    first unpublished row (an OOM halves the chunk): no row is lost or
    written twice."""
    from spark_rapids_ml_torch.clustering import KMeans

    df, X = _kmeans_df(2, n=5000)
    _fast_retries()
    m = KMeans(k=3, seed=0).fit(df)
    ref = m._transform_array(X)["prediction"]
    # the smallest chunk: 1024 rows (512 a chunk, two in flight), ten chunks
    port_config.set_config(host_batch_bytes=1024)
    with fault_inject("transform_dispatch", kind, times=1, skip=3):
        out = m._transform_array(X)["prediction"]
    np.testing.assert_array_equal(out, ref)
    ev = [e for e in get_events() if e.name == "retry[transform_dispatch]"]
    assert len(ev) == 1 and f"action={'device_loss' if kind == 'device_lost' else kind}" in \
        ev[0].detail.replace("transient", "timeout")


def test_transform_oom_halves_the_chunk_until_it_fits(monkeypatch):
    """Every chunk above 100 rows raises an OOM: the transform halves its
    chunk down to it and gives the unconstrained transform's output."""
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.parallel import mesh

    rng = np.random.default_rng(3)
    X = rng.normal(size=(1000, 5))
    y = (X[:, 0] > 0).astype(float)
    m = LogisticRegression(regParam=0.01, float32_inputs=False).fit((X, y))
    ref = m.transform(X)
    real = mesh.RowStager.stage
    sizes = []

    def tight(self, arr, dtype=None):
        if np.asarray(arr).ndim == 2:
            sizes.append(len(arr))
            if len(arr) > 100:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. (test ballast)")
        return real(self, arr, dtype)

    monkeypatch.setattr(mesh.RowStager, "stage", tight)
    port_config.set_config(host_batch_bytes=5 * 8 * 1024)
    out = m.transform(X)
    for col in ("prediction", "probability", "rawPrediction"):
        np.testing.assert_array_equal(out[col], ref[col])
    assert sizes[0] == 512 and max(s for s in sizes if s <= 100) <= 100
    assert sum(1 for e in get_events() if e.name == "retry[transform_dispatch]") == 3


def test_transform_gives_up_after_the_attempt_budget():
    from spark_rapids_ml_torch.clustering import KMeans

    df, X = _kmeans_df(3)
    _fast_retries(retry_max_attempts=2)
    m = KMeans(k=2, seed=0).fit(df)
    with pytest.raises(DispatchTimeout):
        with fault_inject("transform_dispatch", "timeout", times=5):
            m._transform_array(X)


def test_streaming_fit_retries_after_injected_staging_oom(tmp_path):
    from spark_rapids_ml_torch.regression import LinearRegression

    rng = np.random.default_rng(4)
    X = rng.normal(size=(500, 4)).astype(np.float32)
    y = (X @ np.array([1.0, 2.0, -1.0, 0.5])).astype(np.float64)
    df = pd.DataFrame({"features": list(X), "label": y})
    path = str(tmp_path / "d.parquet")
    df.to_parquet(path)
    m_ref = LinearRegression().fit(df)
    port_config.set_config(fused_stage_solve="off")
    with fault_inject("stage_parquet", "oom", times=1):
        m = LinearRegression().fit(path)  # the streamed statistics instead
    assert m.fit_report()["oom_fallback"] and m.fit_report()["route"] == "streamed"
    np.testing.assert_allclose(m.coef_, m_ref.coef_, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("site", ["stat_program_step", "fused_accumulate"])
def test_one_pass_engines_restart_a_failed_pass(site):
    """An OOM mid-pass restarts the whole pass with fresh accumulators: the
    result equals the fault-free one (no chunk counted twice)."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    _fast_retries(staging_chunk_bytes=6 * 4 * 500, fused_stage_solve="on")
    if site == "stat_program_step":
        from spark_rapids_ml_torch.stats import summarize

        ref = summarize(X, metrics=["count", "mean", "variance"])
        with fault_inject(site, "oom", times=1, skip=2):
            got = summarize(X, metrics=["count", "mean", "variance"])
        assert got["count"] == ref["count"] == 3000
        for key in ("mean", "variance"):
            np.testing.assert_array_equal(got[key], ref[key])
        label = "stat_programs"
    else:
        from spark_rapids_ml_torch.feature import PCA

        ref = PCA(k=2).fit(X)
        with fault_inject(site, "oom", times=1, skip=2):
            got = PCA(k=2).fit(X)
        assert got.fit_report()["route"] == "fused"
        np.testing.assert_array_equal(got.components_, ref.components_)
        label = "fused_fit"
    assert f"retry[{label}]" in _names()


# ---------------------------------------------------------------------------
# checkpoint/resume of the iterative fits
# ---------------------------------------------------------------------------


def test_kmeans_checkpoint_resume_after_crash(tmp_path):
    from spark_rapids_ml_torch.clustering import KMeans

    df, _ = _kmeans_df(6, n=400)
    port_config.set_config(checkpoint_dir=str(tmp_path), retry_max_attempts=1)
    kw = dict(k=3, seed=1, maxIter=8, tol=0.0)
    m0 = KMeans(**kw).fit(df)  # checkpoint_dir takes the stepwise branch
    assert not list(tmp_path.glob("*.npz")), "a finished fit removes its file"
    with pytest.raises(SimulatedPreemption):
        with fault_inject("kmeans_lloyd", "preemption", times=1, skip=3):
            KMeans(**kw).fit(df)
    assert list(tmp_path.glob("kmeans-mem-*.npz"))
    reset_metrics()
    m1 = KMeans(**kw).fit(df)
    resumes = [e for e in get_events() if e.name == "kmeans_resume"]
    assert resumes and resumes[0].detail == "it=3"
    np.testing.assert_allclose(m0.cluster_centers_, m1.cluster_centers_, rtol=1e-5, atol=1e-5)
    assert not list(tmp_path.glob("*.npz"))


def test_kmeans_preemption_autoresumes_within_one_fit(tmp_path):
    from spark_rapids_ml_torch.clustering import KMeans

    df, _ = _kmeans_df(7, n=400)
    _fast_retries(checkpoint_dir=str(tmp_path))
    kw = dict(k=3, seed=1, maxIter=8, tol=0.0)
    m0 = KMeans(**kw).fit(df)
    with fault_inject("kmeans_lloyd", "preemption", times=1, skip=3):
        m1 = KMeans(**kw).fit(df)
    assert "retry[fit_kernel]" in _names() and "kmeans_resume" in _names()
    np.testing.assert_allclose(m0.cluster_centers_, m1.cluster_centers_, rtol=1e-5, atol=1e-5)
    assert m1.fit_report()["resilience"]["checkpoint_resumes_total"] == 1


def test_kmeans_device_loss_full_retry_resumes(tmp_path):
    from spark_rapids_ml_torch.clustering import KMeans

    df, _ = _kmeans_df(8)
    _fast_retries(checkpoint_dir=str(tmp_path))
    kw = dict(k=3, seed=1, maxIter=8, tol=0.0)
    m0 = KMeans(**kw).fit(df)
    with fault_inject("kmeans_lloyd", "device_lost", times=1, skip=3):
        m1 = KMeans(**kw).fit(df)
    assert RECOVERY_METRICS["full_retry_fallbacks"] == 1
    resumes = [e for e in get_events() if e.name == "kmeans_resume"]
    assert resumes and resumes[0].detail == "it=3"
    np.testing.assert_allclose(m1.cluster_centers_, m0.cluster_centers_, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "ell"])
def test_logreg_checkpoint_resume_after_crash(tmp_path, sparse):
    from spark_rapids_ml_torch.classification import LogisticRegression

    rng = np.random.default_rng(9)
    X = rng.normal(size=(400, 4)).astype(np.float32)
    if sparse:
        X[rng.random(X.shape) > 0.5] = 0.0
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    data = (sp.csr_matrix(X) if sparse else X, y)
    port_config.set_config(checkpoint_dir=str(tmp_path), retry_max_attempts=1)
    kw = dict(maxIter=20, regParam=0.01)
    m0 = LogisticRegression(**kw).fit(data)
    with pytest.raises(SimulatedPreemption):
        with fault_inject("lbfgs_iteration", "preemption", times=1, skip=3):
            LogisticRegression(**kw).fit(data)
    assert list(tmp_path.glob("logreg-mem-*.npz"))
    reset_metrics()
    m1 = LogisticRegression(**kw).fit(data)
    resumes = [e for e in get_events() if e.name == "lbfgs_resume"]
    assert resumes and resumes[0].detail == "it=3"
    # the resumed trajectory is the uninterrupted one, bit for bit
    np.testing.assert_array_equal(m0.coef_, m1.coef_)
    assert m0.summary.objectiveHistory == m1.summary.objectiveHistory
    assert not list(tmp_path.glob("*.npz"))


def test_logreg_preemption_autoresumes_bit_equal(tmp_path):
    """The conf spec of a whole-process run: a preemption at iteration 10
    is retried within the fit, which resumes from its checkpoint and ends
    bit-equal to an uninterrupted fit."""
    from spark_rapids_ml_torch.classification import LogisticRegression

    rng = np.random.default_rng(10)
    X = rng.normal(size=(300, 6))
    y = (X @ rng.normal(size=6) > 0).astype(float)
    kw = dict(maxIter=40, regParam=1e-3, tol=1e-12)
    m0 = LogisticRegression(**kw).fit((X, y))
    _fast_retries(checkpoint_dir=str(tmp_path), fault_inject_spec="lbfgs_iteration:preemption:1:10")
    m1 = LogisticRegression(**kw).fit((X, y))
    assert [e.detail for e in get_events() if e.name == "lbfgs_resume"] == ["it=10"]
    np.testing.assert_array_equal(m0.coef_, m1.coef_)
    np.testing.assert_array_equal(m0.intercept_, m1.intercept_)


def test_linreg_fista_checkpoint_resume_after_crash(tmp_path):
    from spark_rapids_ml_torch.regression import LinearRegression

    rng = np.random.default_rng(11)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    beta = np.array([1.5, -2.0, 0.0, 0.0, 3.0, 0.0])
    y = (X @ beta + 0.01 * rng.normal(size=300)).astype(np.float64)
    df = pd.DataFrame({"features": list(X), "label": y})
    port_config.set_config(checkpoint_dir=str(tmp_path), retry_max_attempts=1)
    kw = dict(regParam=0.1, elasticNetParam=0.5, maxIter=60, tol=0.0)
    m0 = LinearRegression(**kw).fit(df)
    with pytest.raises(SimulatedPreemption):
        with fault_inject("linreg_fista", "preemption", times=1, skip=5):
            LinearRegression(**kw).fit(df)
    assert list(tmp_path.glob("linreg-fista-*.npz"))
    reset_metrics()
    m1 = LinearRegression(**kw).fit(df)
    resumes = [e for e in get_events() if e.name == "fista_resume"]
    assert resumes and resumes[0].detail == "it=5"
    np.testing.assert_array_equal(m0.coef_, m1.coef_)
    assert not list(tmp_path.glob("*.npz"))


def test_streamed_logreg_resumes_after_crash(tmp_path):
    from spark_rapids_ml_torch.classification import LogisticRegression

    rng = np.random.default_rng(12)
    X = rng.normal(size=(600, 4)).astype(np.float32)
    y = (X[:, 0] - X[:, 2] > 0).astype(float)
    path = str(tmp_path / "d.parquet")
    pd.DataFrame({"features": list(X), "label": y}).to_parquet(path)
    ckpt = tmp_path / "ckpt"
    port_config.set_config(force_streaming_stats=True, streaming_checkpoint_dir=str(ckpt),
                           retry_max_attempts=1)
    kw = dict(maxIter=15, regParam=0.01)
    m0 = LogisticRegression(**kw).fit(path)
    assert m0.fit_report()["route"] == "streamed"
    with pytest.raises(SimulatedPreemption):
        with fault_inject("lbfgs_iteration", "preemption", times=1, skip=4):
            LogisticRegression(**kw).fit(path)
    assert list(ckpt.glob("logreg-*.npz"))
    m1 = LogisticRegression(**kw).fit(path)
    assert [e.detail for e in get_events() if e.name == "lbfgs_resume"] == ["it=4"]
    np.testing.assert_array_equal(m0.coef_, m1.coef_)
    assert not list(ckpt.glob("*.npz"))


def test_checkpoint_tags_never_collide(tmp_path):
    d = str(tmp_path)
    tag_a = "kmeans|/data/a.parquet|n=1000|d=4|k=3|seed=1"
    tag_b = "kmeans|/data/a.parquet|n=1000|d=4|k=9|seed=1"
    tag_c = "logreg|/data/a.parquet|n=1000|d=4|C=2|l2=0.1"
    paths = [checkpoint_file_for(d, t) for t in (tag_a, tag_b, tag_c)]
    assert len(set(paths)) == 3
    assert os.path.basename(paths[0]).startswith("kmeans-")
    assert os.path.basename(paths[2]).startswith("logreg-")
    save_checkpoint(paths[0], tag_a, {"centers": np.zeros((3, 4)), "it": 5})
    save_checkpoint(paths[1], tag_b, {"centers": np.ones((9, 4)), "it": 2})
    a, b = load_checkpoint(paths[0], tag_a), load_checkpoint(paths[1], tag_b)
    assert a["centers"].shape == (3, 4) and int(a["it"]) == 5
    assert b["centers"].shape == (9, 4) and int(b["it"]) == 2
    with pytest.warns(UserWarning, match="different fit"):
        assert load_checkpoint(paths[0], tag_b) is None


def test_two_estimators_share_checkpoint_dir(tmp_path):
    from spark_rapids_ml_torch.clustering import KMeans

    df, _ = _kmeans_df(13, n=400)
    port_config.set_config(checkpoint_dir=str(tmp_path), retry_max_attempts=1)
    for k in (2, 4):
        with pytest.raises(SimulatedPreemption):
            with fault_inject("kmeans_lloyd", "preemption", times=1, skip=2):
                KMeans(k=k, seed=1, maxIter=8, tol=0.0).fit(df)
    assert len(list(tmp_path.glob("kmeans-mem-*.npz"))) == 2
    assert KMeans(k=2, seed=1, maxIter=8, tol=0.0).fit(df).cluster_centers_.shape == (2, 4)
    assert KMeans(k=4, seed=1, maxIter=8, tol=0.0).fit(df).cluster_centers_.shape == (4, 4)
    assert not list(tmp_path.glob("*.npz"))


def test_checkpoint_tmp_sweep(tmp_path, monkeypatch):
    from spark_rapids_ml_torch.resilience import checkpoint as ckpt_mod
    from spark_rapids_ml_torch.resilience import resolve_checkpoint_dir

    path = str(tmp_path / "kmeans-abc.npz")
    tag = "kmeans|test"

    def crash_replace(src, dst):
        raise OSError("simulated crash between savez and replace")

    monkeypatch.setattr(ckpt_mod.os, "replace", crash_replace)
    with pytest.raises(OSError, match="simulated crash"):
        save_checkpoint(path, tag, {"centers": np.zeros((3, 2)), "it": 4})
    monkeypatch.undo()
    leaked = list(tmp_path.glob("*.tmp.npz"))
    assert leaked and load_checkpoint(path, tag) is None
    port_config.set_config(checkpoint_dir=str(tmp_path))
    assert resolve_checkpoint_dir() == str(tmp_path)
    assert list(tmp_path.glob("*.tmp.npz")) == leaked  # a fresh tmp stays
    old = time.time() - 2 * ckpt_mod._TMP_SWEEP_AGE_S
    os.utime(leaked[0], (old, old))
    resolve_checkpoint_dir()
    assert list(tmp_path.glob("*.tmp.npz")) == []
    save_checkpoint(path, tag, {"centers": np.ones((3, 2)), "it": 5})
    assert int(load_checkpoint(path, tag)["it"]) == 5


def test_streaming_alias_applies_to_streamed_fits_only(tmp_path):
    from spark_rapids_ml_torch.resilience import resolve_checkpoint_dir

    port_config.set_config(streaming_checkpoint_dir=str(tmp_path))
    assert resolve_checkpoint_dir() == ""
    assert resolve_checkpoint_dir(streaming=True) == str(tmp_path)
    port_config.set_config(checkpoint_dir=str(tmp_path / "b"))
    assert resolve_checkpoint_dir() == resolve_checkpoint_dir(streaming=True) == str(tmp_path / "b")
