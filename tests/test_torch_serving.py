#
# The port's serving layer (spark_rapids_ml_torch/serving/) on the CPU:
# the JAX package's tests/test_serving.py ported to the port's API
# (coalescing parity, admission control, residency, the latency families,
# the HTTP front end, request tracing, SLO burn, fault-injected
# degradation), the sticky-error stop, a fault at every serving site at
# depths 1 and 3, and parity with the JAX package's ServingServer on the
# same traffic (outputs, the HTTP bodies, report keys, metric label sets).
# Left out until their modules are ported (ROADMAP.md item 6): the
# Prometheus dump of the exemplars and the flight recorder's bundle.
#
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.resilience import fault_inject
from spark_rapids_ml_torch.resilience.elastic import RECOVERY_METRICS
from spark_rapids_ml_torch.serving import (
    ServingClient,
    ServingDeviceError,
    ServingOverload,
    ServingServer,
)
from spark_rapids_ml_torch.serving.registry import PINS
from torch_serving_support import (
    D,
    jax_and_port_models,
    port_logreg,
    port_pca,
    reset_jax_state,
    reset_port_state,
    rows as _q,
)

set_config = port_config.set_config
get_config = port_config.get_config


@pytest.fixture(autouse=True)
def _clean():
    reset_port_state()
    yield
    reset_port_state()


@pytest.fixture(scope="module")
def pca_model():
    return port_pca()


@pytest.fixture(scope="module")
def logreg_model():
    return port_logreg()


def _serve(**models) -> ServingServer:
    server = ServingServer()
    for name, model in models.items():
        server.register(name, model)
    return server.start()


def _knn(n: int, d: int, seed: int):
    from spark_rapids_ml_torch.knn import NearestNeighbors

    X = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return NearestNeighbors(k=2).fit({"features": X}), X


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


def test_single_request_matches_direct_transform(pca_model, rng):
    server = _serve(pca=pca_model)
    try:
        q = _q(rng, 5)
        out = server.transform("pca", q, timeout=60)
        ref = pca_model._transform_array(q)
        assert sorted(out) == sorted(ref)
        assert np.array_equal(out["proj"], ref["proj"])
        client = ServingClient(server)
        assert np.array_equal(client.transform("pca", q), ref["proj"])
        assert client.models() == ["pca"]
    finally:
        server.stop()


def test_multi_output_model_all_columns(logreg_model, rng):
    server = _serve(lr=logreg_model)
    try:
        q = _q(rng, 7)
        out = server.transform("lr", q, timeout=60)
        ref = logreg_model._transform_array(q)
        assert sorted(out) == sorted(ref)
        for col in ref:
            assert np.array_equal(out[col], ref[col]), col
    finally:
        server.stop()


def test_coalescing_parity_n_concurrent_rows_exact(pca_model, rng):
    """N concurrent 1-row requests coalesce into ONE dispatched batch whose
    per-request slices are EXACTLY each row transformed alone: every
    padding class computes with one product shape."""
    server = _serve(pca=pca_model)
    try:
        reqs = [_q(rng, 1) for _ in range(16)]
        server.pause()
        futs = [None] * len(reqs)

        def _submit(i, r):
            futs[i] = server.submit("pca", r)

        threads = [threading.Thread(target=_submit, args=(i, r)) for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        b0 = server._batches
        server.resume()
        outs = [f.result(timeout=60)["proj"] for f in futs]
        assert server._batches - b0 == 1, "16 requests must be one batch"
        for r, o in zip(reqs, outs):
            assert np.array_equal(o, pca_model._transform_array(r)["proj"])
    finally:
        server.stop()


def test_coalesced_batch_equals_batched_transform_exact(pca_model, rng):
    server = _serve(pca=pca_model)
    try:
        reqs = [_q(rng, 1) for _ in range(12)]
        server.pause()
        futs = [server.submit("pca", r) for r in reqs]
        server.resume()
        got = np.concatenate([f.result(timeout=60)["proj"] for f in futs], axis=0)
        want = pca_model._transform_array(np.concatenate(reqs, axis=0))["proj"]
        assert np.array_equal(got, want)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# residency
# ---------------------------------------------------------------------------


def test_zero_weight_restaging_across_100_requests(pca_model, rng):
    """The weights move to the device exactly ONCE: the pinned copy holds
    them as tensors, and 100 requests later the pin count is still 1."""
    import torch

    server = _serve(zr_pca=pca_model)
    try:
        pinned = server.registry.resolve("zr_pca")
        assert isinstance(pinned.model.components_, torch.Tensor)
        assert isinstance(pca_model.components_, np.ndarray)  # caller's model untouched
        for _ in range(100):
            server.transform("zr_pca", _q(rng, 1), timeout=60)
        assert PINS.value(model="zr_pca", event="pin") == 1
        assert PINS.value(model="zr_pca", event="repin") == 0
        assert PINS.value(model="zr_pca", event="evict") == 0
        rep = server.report()
        assert rep["zr_pca"]["requests"] == 100
        assert rep["zr_pca"]["pinned"] is True
    finally:
        server.stop()


def test_lru_eviction_and_transparent_repin(pca_model, logreg_model, rng):
    server = ServingServer()
    server.register("ev_a", pca_model)
    server.register("ev_b", logreg_model)
    bytes_a = server.registry.resolve("ev_a").nbytes
    bytes_b = server.registry.resolve("ev_b").nbytes
    server.registry.clear()
    set_config(device_cache_bytes=int(max(bytes_a, bytes_b) * 1.2))
    server.register("ev_a", pca_model)
    server.register("ev_b", logreg_model)  # does not fit next to ev_a
    assert PINS.value(model="ev_a", event="evict") == 1
    assert server.registry.pinned_names() == ["ev_b"]
    server.start()
    try:
        q = _q(rng, 3)
        out = server.transform("ev_a", q, timeout=60)  # re-pin on demand
        assert PINS.value(model="ev_a", event="repin") == 1
        assert np.array_equal(out["proj"], pca_model._transform_array(q)["proj"])
        assert "ev_a" in server.registry.pinned_names()
    finally:
        server.stop()
        server.registry.clear()


def test_pinned_bytes_are_budget_accounted(pca_model):
    from spark_rapids_ml_torch.parallel.device_cache import cache_resident_bytes

    base = cache_resident_bytes()
    server = ServingServer()
    server.register("acct", pca_model)
    nbytes = server.registry.resolve("acct").nbytes
    assert nbytes == pca_model.components_.nbytes + pca_model.mean_.nbytes
    assert cache_resident_bytes() - base == nbytes
    server.registry.clear()
    assert cache_resident_bytes() == base


def test_pinning_without_a_card_raises(pca_model, monkeypatch):
    """The default device is the card: with none and no request for the
    CPU, pinning raises instead of serving from the CPU."""
    import torch

    from spark_rapids_ml_torch import set_default_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    set_default_device(None)
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_DEVICE", raising=False)
    server = ServingServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.register("nocard", pca_model)
    assert server.registry.pinned_names() == []


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def test_admission_control_rejects_then_recovers(pca_model, rng):
    from spark_rapids_ml_torch.serving.server import REJECTIONS

    set_config(serving_max_queue=3)
    server = _serve(adm=pca_model)
    try:
        server.pause()
        futs = [server.submit("adm", _q(rng, 1)) for _ in range(3)]
        with pytest.raises(ServingOverload) as ei:
            server.submit("adm", _q(rng, 1))
        assert ei.value.reason == "queue_full"
        assert REJECTIONS.value(model="adm", reason="queue_full") >= 1
        server.resume()
        for f in futs:
            f.result(timeout=60)
        server.transform("adm", _q(rng, 1), timeout=60)
    finally:
        server.stop()


def test_submit_validation(pca_model, rng):
    server = _serve(val=pca_model)
    try:
        with pytest.raises(KeyError):
            server.submit("nope", _q(rng, 1))
        with pytest.raises(ValueError):
            server.submit("val", np.zeros((1, 5), np.float32))
        with pytest.raises(ValueError):
            server.submit("val", np.zeros((0, D), np.float32))
    finally:
        server.stop()
    with pytest.raises(ServingOverload):
        server.submit("val", _q(rng, 1))


def test_failed_request_does_not_kill_server(pca_model, rng):
    def boom(X):
        raise ValueError("bad batch")

    knn, _ = _knn(50, D, 1)
    server = ServingServer()
    server.register("ok", pca_model)
    server.register("boom", knn, n_features=D, transform=boom)
    server.start()
    try:
        f = server.submit("boom", _q(rng, 1))
        with pytest.raises(ValueError, match="bad batch"):
            f.result(timeout=60)
        out = server.transform("ok", _q(rng, 2), timeout=60)
        assert out["proj"].shape == (2, 3)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# metrics / report
# ---------------------------------------------------------------------------


def test_latency_families_and_report(pca_model, rng):
    from spark_rapids_ml_torch.serving.server import BATCH_ROWS, LATENCY, REQUESTS
    from spark_rapids_ml_torch.telemetry.registry import REGISTRY

    server = _serve(met=pca_model)
    try:
        for _ in range(5):
            server.transform("met", _q(rng, 2), timeout=60)
        lat = LATENCY.samples()
        for phase in ("queue", "dispatch", "total"):
            key = (("model", "met"), ("phase", phase))
            assert lat[key]["count"] == 5, phase
        assert BATCH_ROWS.samples()[(("model", "met"),)]["count"] >= 1
        assert REQUESTS.value(model="met") == 5
        assert REGISTRY.get("serving_pinned_models").value() >= 1
        rep = server.report()["met"]
        assert rep["latency_samples"] == 5
        assert rep["p50_ms"] > 0 and rep["p99_ms"] >= rep["p50_ms"]
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# degradation under injected faults
# ---------------------------------------------------------------------------


def test_injected_oom_shrinks_coalescing_cap(pca_model, rng):
    from spark_rapids_ml_torch.resilience.retry import RETRIES

    server = _serve(oomm=pca_model)
    try:
        cap0 = int(get_config("serving_max_batch_rows"))
        with fault_inject("serving_dispatch", "oom", times=1):
            out = server.transform("oomm", _q(rng, 4), timeout=60)
        assert out["proj"].shape == (4, 3)
        assert server._shrunk_cap is not None
        assert server._shrunk_cap <= cap0 // 2
        assert RETRIES.value(label="serving_dispatch", action="oom") >= 1
    finally:
        server.stop()


def test_oom_cap_regrows_after_sustained_clean_batches(pca_model, rng):
    import spark_rapids_ml_torch.serving.server as srv_mod

    server = _serve(regrow=pca_model)
    try:
        with fault_inject("serving_dispatch", "oom", times=1):
            server.transform("regrow", _q(rng, 2), timeout=60)
        assert server._shrunk_cap is not None
        for _ in range(srv_mod._CAP_REGROW_BATCHES * 2):
            server._note_clean_batch()
        assert server._shrunk_cap is None
    finally:
        server.stop()


def test_device_lost_mid_load_drains_queue_on_the_same_device(pca_model, rng):
    """An injected device loss mid-load: one card's elastic path is the
    full retry, every pinned model re-pins on the same device, and EVERY
    queued request completes exactly."""
    server = _serve(dl_pca=pca_model)
    try:
        server.pause()
        reqs = [_q(rng, 1) for _ in range(20)]
        futs = [server.submit("dl_pca", r) for r in reqs]
        with fault_inject("serving_dispatch", "device_lost", times=1):
            server.resume()
            outs = [f.result(timeout=120) for f in futs]
        assert len(outs) == 20
        assert RECOVERY_METRICS["full_retry_fallbacks"] >= 1
        assert PINS.value(model="dl_pca", event="repin") >= 1
        for r, o in zip(reqs, outs):
            assert np.array_equal(o["proj"], pca_model._transform_array(r)["proj"])
    finally:
        server.stop()


def test_unregister_with_queued_requests_fails_them_not_the_server(pca_model, rng):
    server = _serve(gone=pca_model, stay=pca_model)
    try:
        server.pause()
        doomed = [server.submit("gone", _q(rng, 1)) for _ in range(3)]
        ok = server.submit("stay", _q(rng, 1))
        server.registry.unregister("gone")
        server.resume()
        for f in doomed:
            with pytest.raises(KeyError):
                f.result(timeout=60)
        assert ok.result(timeout=60)["proj"].shape == (1, 3)
        server.transform("stay", _q(rng, 2), timeout=60)
    finally:
        server.stop()


def test_width_blind_model_adopts_first_request_width(rng):
    def echo(X):
        return {"rows": np.asarray(X).sum(axis=1)}

    knn, _ = _knn(30, 4, 2)
    server = ServingServer()
    server.register("wide", knn, transform=echo)
    server.registry._host["wide"]["n_features"] = None
    server.start()
    try:
        server.transform("wide", np.zeros((1, 6), np.float32), timeout=60)
        with pytest.raises(ValueError, match="expects 6 features"):
            server.submit("wide", np.zeros((1, 4), np.float32))
    finally:
        server.stop()


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("site,kind", [
    ("serving_dispatch", "oom"), ("serving_dispatch", "timeout"),
    ("serving_dispatch", "preemption"), ("serving_collect", "oom"),
    ("serving_collect", "timeout"), ("serving_admission", "oom"),
])
def test_fault_at_each_serving_site_answers_every_request_once(pca_model, rng, depth,
                                                               site, kind):
    """A fault at each registered serving site, at depth 1 and 3: every
    request is answered exactly once with its exact output, or (the
    admission site) refused with the typed error before it is queued."""
    set_config(serving_pipeline_depth=depth, serving_max_batch_rows=2)
    server = _serve(fs=pca_model)
    answered = []
    try:
        reqs = [_q(rng, 1) for _ in range(12)]
        server.pause()
        futs = []
        with fault_inject(site, kind, times=1):
            for r in reqs:
                try:
                    f = server.submit("fs", r)
                except Exception as e:  # the admission site refuses one
                    assert site == "serving_admission" and "injected" in str(e)
                    futs.append(None)
                    continue
                f.add_done_callback(lambda _f: answered.append(_f.request_id))
                futs.append(f)
            server.resume()
            outs = [f.result(timeout=120) if f is not None else None for f in futs]
        assert sum(f is None for f in futs) == (site == "serving_admission")
        for r, o in zip(reqs, outs):
            if o is not None:
                assert np.array_equal(o["proj"], pca_model._transform_array(r)["proj"])
        ids = [f.request_id for f in futs if f is not None]
        assert sorted(answered) == sorted(ids)  # each future resolved once
        assert server._queued == 0 and not server._inflight
    finally:
        server.stop()


def test_sticky_cuda_error_fails_requests_typed_and_stops(pca_model, rng):
    """A sticky CUDA error poisons the context: the affected and queued
    requests fail with the typed ServingDeviceError, the server stops,
    nothing is requeued and nothing re-pins."""
    from spark_rapids_ml_torch.resilience import get_events

    calls = []

    def poisoned(X):
        calls.append(len(X))
        raise RuntimeError("CUDA error: device-side assert triggered")

    knn, _ = _knn(30, D, 3)
    set_config(serving_max_batch_rows=2)
    server = ServingServer()
    server.register("dead", knn, n_features=D, transform=poisoned)
    server.register("other", pca_model)
    server.start()
    try:
        server.pause()
        futs = [server.submit("dead", _q(rng, 1)) for _ in range(4)]
        futs.append(server.submit("other", _q(rng, 1)))
        server.resume()
        for f in futs:
            with pytest.raises(ServingDeviceError) as ei:
                f.result(timeout=60)
            assert "device-side assert" in str(ei.value.cause)
        assert len(calls) == 1  # never retried
        assert get_events("sticky_error[serving_dispatch]")
        assert PINS.value(model="other", event="repin") == 0
        with pytest.raises(ServingDeviceError):
            server.submit("other", _q(rng, 1))
        with pytest.raises(ServingDeviceError):
            server.start()
    finally:
        server.stop()
    assert server._thread is None


# ---------------------------------------------------------------------------
# host-path models + HTTP front end
# ---------------------------------------------------------------------------


def test_host_path_model_with_custom_transform(rng):
    from spark_rapids_ml_torch.knn import NearestNeighbors

    X = rng.normal(size=(200, 8)).astype(np.float32)
    knn = NearestNeighbors(k=3).fit({"features": X})

    def nn_transform(Q):
        dist, pos = knn._search(np.asarray(Q, np.float32), 3)
        return {"distances": dist, "indices": pos}

    server = ServingServer()
    server.register("knn", knn, n_features=8, transform=nn_transform)
    server.start()
    try:
        assert server.registry.resolve("knn").device is False
        out = server.transform("knn", X[:5] + 1e-6, timeout=60)
        assert out["indices"].shape == (5, 3)
        assert np.array_equal(out["indices"][:, 0], np.arange(5))
    finally:
        server.stop()


def _post(base, name, body, headers=None):
    req = urllib.request.Request(
        f"{base}/v1/models/{name}:transform", data=body,
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.load(resp)


def test_http_endpoint_roundtrip(pca_model, rng):
    from spark_rapids_ml_torch.serving.http import start_serving_http

    server = _serve(web=pca_model)
    http = start_serving_http(server, port=0)
    base = f"http://127.0.0.1:{http.server_port}"
    try:
        q = _q(rng, 3)
        body = json.dumps({"instances": q.tolist()}).encode()
        payload = _post(base, "web", body)
        assert payload["model"] == "web" and payload["rows"] == 3
        np.testing.assert_allclose(np.asarray(payload["outputs"]["proj"], np.float32),
                                   pca_model._transform_array(q)["proj"], rtol=1e-6)
        with urllib.request.urlopen(f"{base}/v1/models", timeout=30) as r:
            assert "web" in json.load(r)["models"]
        with urllib.request.urlopen(f"{base}/v1/report", timeout=30) as r:
            assert json.load(r)["web"]["requests"] >= 1
        with urllib.request.urlopen(f"{base}/v1/pipeline", timeout=30) as r:
            assert json.load(r)["batches"] >= 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "nope", body)
        assert ei.value.code == 404
    finally:
        http.shutdown()
        http.server_close()
        server.stop()


def test_serving_port_conf_starts_the_endpoint(pca_model, rng):
    """`serving_port` starts the loopback endpoint with the server, and
    stop() closes it."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    set_config(serving_port=port)
    server = _serve(portconf=pca_model)
    try:
        body = json.dumps({"instances": _q(rng, 2).tolist()}).encode()
        assert _post(f"http://127.0.0.1:{port}", "portconf", body)["rows"] == 2
    finally:
        server.stop()
    assert server._http is None


# ---------------------------------------------------------------------------
# request-scoped tracing, exemplars, slow capture, SLO burn rate
# ---------------------------------------------------------------------------


def test_request_ids_minted_and_adoptable(pca_model, rng):
    server = _serve(rid=pca_model)
    try:
        fut = server.submit("rid", _q(rng))
        assert fut.request_id.startswith("req-")
        fut.result(timeout=60)
        fut2 = server.submit("rid", _q(rng), request_id="caller-7")
        assert fut2.request_id == "caller-7"
        fut2.result(timeout=60)
        fut3 = ServingClient(server).submit("rid", _q(rng), request_id="client-9")
        assert fut3.request_id == "client-9"
        fut3.result(timeout=60)
    finally:
        server.stop()


def test_latency_exemplars_carry_request_ids(pca_model, rng):
    from spark_rapids_ml_torch.serving.server import LATENCY

    server = _serve(exm=pca_model)
    try:
        server.submit("exm", _q(rng), request_id="exemplar-probe").result(timeout=60)
        for phase in ("queue", "dispatch", "total"):
            ex = LATENCY.exemplars(model="exm", phase=phase)
            assert any(e["id"] == "exemplar-probe" for e in ex), (phase, ex)
    finally:
        server.stop()


def test_slow_request_capture_has_full_span_tree(pca_model, rng):
    set_config(serving_slow_trace_ms=0.0001)
    server = _serve(slow=pca_model)
    try:
        server.submit("slow", _q(rng), request_id="slow-probe").result(timeout=60)
        deadline = time.time() + 10
        while not server.slow_traces() and time.time() < deadline:
            time.sleep(0.01)
        traces = server.slow_traces()
        assert traces
        entry = traces[-1]
        assert entry["model"] == "slow"
        assert any(r["request_id"] == "slow-probe" for r in entry["requests"])
        names = set()

        def walk(nodes):
            for n in nodes:
                names.add(n["name"])
                walk(n.get("children", []))

        walk(entry["spans"])
        for want in ("serving_dispatch[slow]", "serving_coalesce", "serving_stage",
                     "serving_compute", "serving_collect[slow]", "serving_scatter"):
            assert want in names, (want, sorted(names))
        assert server.report()["_totals"]["slow_traces"] >= 1
    finally:
        server.stop()


def test_slow_capture_off_by_default(pca_model, rng):
    server = _serve(fast=pca_model)
    try:
        server.transform("fast", _q(rng), timeout=60)
        assert server.slow_traces() == []
    finally:
        server.stop()


def test_slo_burn_rate_gauges(pca_model, rng):
    from spark_rapids_ml_torch.serving.server import SLO_BURN

    set_config(serving_slo_p99_ms=0.0001)
    server = _serve(burn=pca_model)
    try:
        for _ in range(3):
            server.transform("burn", _q(rng), timeout=60)
        deadline = time.time() + 10
        while (SLO_BURN.value(default=None, model="burn", window="1m") is None
               and time.time() < deadline):
            server.transform("burn", _q(rng), timeout=60)
            time.sleep(0.3)
        burn = SLO_BURN.value(default=None, model="burn", window="1m")
        assert burn is not None and burn > 1.0, burn
        rep = server.report()["burn"]
        assert rep["slo_burn_1m"] == burn
        assert rep["slo_p99_target_ms"] == 0.0
        set_config(serving_slo_targets="burn=60000")
        time.sleep(1.1)
        server.transform("burn", _q(rng), timeout=60)
        deadline = time.time() + 10
        while (SLO_BURN.value(default=1e9, model="burn", window="1m") > 0
               and time.time() < deadline):
            time.sleep(1.1)
            server.transform("burn", _q(rng), timeout=60)
        assert SLO_BURN.value(model="burn", window="1m") == 0.0
    finally:
        server.stop()


def test_slo_gauges_absent_without_target(pca_model, rng):
    from spark_rapids_ml_torch.serving.server import SLO_BURN

    server = _serve(quiet=pca_model)
    try:
        server.transform("quiet", _q(rng), timeout=60)
        assert SLO_BURN.value(default=None, model="quiet", window="1m") is None
        assert "slo_burn_1m" not in server.report()["quiet"]
    finally:
        server.stop()


def test_idle_dispatcher_refreshes_slo_gauges(pca_model, rng):
    set_config(serving_slo_p99_ms=60000)
    server = _serve(idle=pca_model)
    try:
        server.transform("idle", _q(rng), timeout=60)
        calls: list = []
        orig = server._update_slo
        server._update_slo = lambda name: (calls.append(name), orig(name))[1]
        deadline = time.time() + 5
        while "idle" not in calls and time.time() < deadline:
            time.sleep(0.1)
        assert "idle" in calls
    finally:
        server.stop()


def test_http_request_id_header_roundtrip(pca_model, rng):
    from spark_rapids_ml_torch.serving.http import start_serving_http

    server = _serve(hdr=pca_model)
    http = start_serving_http(server, port=0)
    base = f"http://127.0.0.1:{http.server_port}"
    try:
        body = json.dumps({"instances": _q(rng).tolist()}).encode()
        assert _post(base, "hdr", body, {"X-Request-Id": "edge-42"})["request_id"] == "edge-42"
        assert _post(base, "hdr", body)["request_id"].startswith("req-")
    finally:
        http.shutdown()
        http.server_close()
        server.stop()


def test_sustained_overload_is_noted_once_the_burst_trips(pca_model, rng, monkeypatch):
    """A burst of queue_full rejections inside the window is a typed
    sustained-overload failure, noted with the model (the flight
    recorder, which would write its bundle, is not ported yet)."""
    from spark_rapids_ml_torch.serving import server as srv_mod

    noted = []
    monkeypatch.setattr(srv_mod, "note_failure",
                        lambda reason, detail="", log=None: noted.append((reason, detail)))
    set_config(serving_max_queue=1)
    server = _serve(ovl=pca_model)
    server.pause()
    fut = server.submit("ovl", _q(rng))
    try:
        for i in range(srv_mod._OVERLOAD_DUMP_COUNT + 5):
            with pytest.raises(ServingOverload):
                server.submit("ovl", _q(rng))
            if i < srv_mod._OVERLOAD_DUMP_COUNT - 1:
                assert noted == []
        assert noted and all(r == "serving_overload" for r, _ in noted)
        assert "model=ovl" in noted[0][1]
    finally:
        server.resume()
        fut.result(timeout=60)
        server.stop()


@pytest.mark.slow
def test_coalesced_qps_beats_sequential_3x(logreg_model, rng):
    n = 200
    reqs = [_q(rng, 1) for _ in range(n)]
    t0 = time.perf_counter()
    for r in reqs:
        logreg_model._transform_array(r)
    seq_qps = n / (time.perf_counter() - t0)
    set_config(serving_max_wait_ms=5.0)
    server = _serve(qps=logreg_model)
    try:
        server.transform("qps", reqs[0], timeout=60)
        t0 = time.perf_counter()
        futs = [server.submit("qps", r) for r in reqs]
        for f in futs:
            f.result(timeout=120)
        srv_qps = n / (time.perf_counter() - t0)
    finally:
        server.stop()
    assert srv_qps >= 3.0 * seq_qps, (srv_qps, seq_qps)


# ---------------------------------------------------------------------------
# parity with the JAX package's ServingServer on the same traffic
# ---------------------------------------------------------------------------

# the port's stated tolerances per model and output column: (relative,
# absolute as a share of the column's largest magnitude) — float32 sums of
# 16 products round in another order in the two packages, so a margin
# near zero keeps the absolute error of the row's largest terms;
# predictions and cluster ids are equal
_TOL = {
    "pca": {"proj": (1e-5, 1e-6)},
    "lr2": {"probability": (1e-6, 1e-6), "rawPrediction": (1e-5, 1e-6)},
    "lr3": {"probability": (1e-6, 1e-6), "rawPrediction": (1e-5, 1e-6)},
    "km": {},
}


@pytest.fixture(scope="module")
def both_models():
    return jax_and_port_models()


def _both_servers(both_models, prefix: str):
    from spark_rapids_ml_tpu.serving import ServingServer as JaxServingServer

    reset_jax_state()
    jax_srv, port_srv = JaxServingServer(), ServingServer()
    for name, (jm, pm) in both_models.items():
        jax_srv.register(prefix + name, jm)
        port_srv.register(prefix + name, pm)
    return jax_srv.start(), port_srv.start()


def _stop_both(jax_srv, port_srv):
    try:
        port_srv.stop()
        port_srv.registry.clear()
    finally:
        jax_srv.stop()
        jax_srv.registry.clear()
        reset_jax_state()


def _same_traffic(server, prefix, traffic):
    """Queue every request while paused, release, gather by index: both
    servers coalesce the same batches."""
    server.pause()
    futs = [server.submit(prefix + name, X) for name, X in traffic]
    server.resume()
    return [f.result(timeout=120) for f in futs]


def _held(name, col, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, col)
    if col not in _TOL[name]:
        assert np.array_equal(got, want), (name, col)
    else:
        rtol, share = _TOL[name][col]
        atol = share * max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=f"{name}.{col}")


def test_outputs_match_the_jax_server_on_the_same_batches(both_models, rng):
    jax_srv, port_srv = _both_servers(both_models, "px_")
    try:
        traffic = [(name, _q(rng, 1 + i % 3)) for i in range(24)
                   for name in ("pca", "lr2", "lr3", "km")][:48]
        want = _same_traffic(jax_srv, "px_", traffic)
        got = _same_traffic(port_srv, "px_", traffic)
        for (name, _X), g, w in zip(traffic, got, want):
            assert sorted(g) == sorted(w)
            for col in w:
                _held(name, col, g[col], w[col])
    finally:
        _stop_both(jax_srv, port_srv)


def test_http_bodies_match_the_jax_server(both_models, rng):
    from spark_rapids_ml_torch.serving.http import start_serving_http
    from spark_rapids_ml_tpu.serving.http import start_serving_http as jax_http

    jax_srv, port_srv = _both_servers(both_models, "ph_")
    hj, hp = jax_http(jax_srv, port=0), start_serving_http(port_srv, port=0)
    try:
        for name in ("pca", "lr2", "lr3", "km"):
            body = json.dumps({"instances": _q(rng, 3).tolist()}).encode()
            hdr = {"X-Request-Id": f"same-{name}"}
            bj = _post(f"http://127.0.0.1:{hj.server_port}", "ph_" + name, body, hdr)
            bp = _post(f"http://127.0.0.1:{hp.server_port}", "ph_" + name, body, hdr)
            assert {k: v for k, v in bp.items() if k != "outputs"} == \
                {k: v for k, v in bj.items() if k != "outputs"}
            assert sorted(bp["outputs"]) == sorted(bj["outputs"])
            for col in bj["outputs"]:
                _held(name, col, bp["outputs"][col], bj["outputs"][col])
        with urllib.request.urlopen(f"http://127.0.0.1:{hp.server_port}/v1/models") as r:
            mp = json.load(r)
        with urllib.request.urlopen(f"http://127.0.0.1:{hj.server_port}/v1/models") as r:
            mj = json.load(r)
        assert mp == mj
    finally:
        for h in (hj, hp):
            h.shutdown()
            h.server_close()
        _stop_both(jax_srv, port_srv)


def _key_tree(d, skip=("drift",)):
    if not isinstance(d, dict):
        return None
    return {k: _key_tree(v) for k, v in d.items() if k not in skip}


def test_report_keys_match_the_jax_server(both_models, rng):
    jax_srv, port_srv = _both_servers(both_models, "pr_")
    try:
        traffic = [(name, _q(rng, 2)) for name in ("pca", "lr2", "lr3", "km")] * 3
        _same_traffic(jax_srv, "pr_", traffic)
        _same_traffic(port_srv, "pr_", traffic)
        rj, rp = jax_srv.report(), port_srv.report()
        # value-dependent sub-tables: the gap rows name the causes seen
        for rep in (rj, rp):
            rep["_totals"].get("utilization", {}).pop("gap_attribution", None)
        assert _key_tree(rp) == _key_tree(rj)
        for name in ("pca", "lr2", "lr3", "km"):
            assert rp["pr_" + name]["requests"] == rj["pr_" + name]["requests"] == 3
        assert set(port_srv.pipeline_info()) == set(jax_srv.pipeline_info())
        detail_j, detail_p = jax_srv.model_detail("pr_pca"), port_srv.model_detail("pr_pca")
        assert set(detail_p) == set(detail_j) - {"drift"}
    finally:
        _stop_both(jax_srv, port_srv)


def test_registry_label_sets_match_the_jax_server(both_models, rng):
    """After the same traffic, the serving families of both registries
    carry the same names, and the same label sets for these models."""
    from spark_rapids_ml_torch.telemetry.registry import REGISTRY
    from spark_rapids_ml_tpu.telemetry.registry import REGISTRY as JAX_REGISTRY

    jax_srv, port_srv = _both_servers(both_models, "pl_")
    try:
        traffic = [(name, _q(rng, 1)) for name in ("pca", "lr2", "lr3", "km")] * 4
        _same_traffic(jax_srv, "pl_", traffic)
        _same_traffic(port_srv, "pl_", traffic)

        def serving_families(snap):
            return {n for n in snap if n.startswith(("serving_", "slo_"))}

        def ours(snap):
            return {
                (n, ls) for n, fam in snap.items() if n.startswith(("serving_", "slo_"))
                for ls in fam if "model=pl_" in ls
            }

        sj, sp = JAX_REGISTRY.snapshot(), REGISTRY.snapshot()
        assert serving_families(sp) == serving_families(sj)
        assert ours(sp) == ours(sj)
    finally:
        _stop_both(jax_srv, port_srv)
