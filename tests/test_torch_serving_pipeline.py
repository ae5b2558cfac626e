#
# The port's staged serving pipeline (spark_rapids_ml_torch/serving/
# server.py) on the CPU: the JAX package's tests/test_serving_pipeline.py
# ported to the port's API — byte parity pipelined vs depth 1 on identical
# traffic, per-model FIFO under the round-robin interleave, mid-pipeline
# fault recovery (OOM at dispatch, a fault at collect, a device loss)
# requeueing without loss, controller cap changes applying at the next
# coalesce, depth resolution, the serving utilization windows, and the
# registry at scale (O(1) pin probes, incremental bytes, batched LRU
# eviction).  The CUDA-stream half of the pipeline runs in
# tests/test_torch_serving_cuda.py on the card.
#
import time

import numpy as np
import pytest

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.resilience import fault_inject
from spark_rapids_ml_torch.resilience.elastic import RECOVERY_METRICS
from spark_rapids_ml_torch.serving import ServingServer
from spark_rapids_ml_torch.serving.registry import PINS
from torch_serving_support import port_logreg, port_pca, reset_port_state, rows as _q

set_config = port_config.set_config


@pytest.fixture(autouse=True)
def _clean():
    reset_port_state()
    yield
    reset_port_state()


@pytest.fixture(scope="module")
def pca_model():
    return port_pca(13)


@pytest.fixture(scope="module")
def logreg_model():
    return port_logreg(13)


def _serve(**models) -> ServingServer:
    server = ServingServer()
    for name, model in models.items():
        server.register(name, model)
    return server.start()


def _run_traffic(server, name, reqs):
    server.pause()
    futs = [server.submit(name, r) for r in reqs]
    server.resume()
    return [f.result(timeout=120) for f in futs]


# ---------------------------------------------------------------------------
# parity: pipelined output == depth-1 output, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_pipelined_byte_parity_vs_depth1(pca_model, rng, depth):
    reqs = [_q(rng, 1 + (i % 3)) for i in range(24)]
    outs = {}
    for dep in (1, depth):
        set_config(serving_pipeline_depth=dep, serving_max_batch_rows=4)
        server = _serve(par=pca_model)
        try:
            outs[dep] = _run_traffic(server, "par", reqs)
        finally:
            server.stop()
            server.registry.clear()
    for r, b, p in zip(reqs, outs[1], outs[depth]):
        ref = pca_model._transform_array(r)["proj"]
        assert np.array_equal(b["proj"], ref)
        assert b["proj"].tobytes() == p["proj"].tobytes()


def test_multi_model_interleave_parity(pca_model, logreg_model, rng):
    set_config(serving_pipeline_depth=4, serving_pipeline_interleave=True,
               serving_max_batch_rows=2)
    server = _serve(ia=pca_model, ib=logreg_model)
    try:
        server.pause()
        rows_a = [_q(rng, 1) for _ in range(8)]
        rows_b = [_q(rng, 1) for _ in range(8)]
        futs_a = [server.submit("ia", r) for r in rows_a]
        futs_b = [server.submit("ib", r) for r in rows_b]
        server.resume()
        for r, f in zip(rows_a, futs_a):
            assert np.array_equal(f.result(timeout=120)["proj"],
                                  pca_model._transform_array(r)["proj"])
        for r, f in zip(rows_b, futs_b):
            ref = logreg_model._transform_array(r)
            out = f.result(timeout=120)
            for col in ref:
                assert np.array_equal(out[col], ref[col]), col
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------


def test_per_model_fifo_preserved_under_interleave(pca_model, rng):
    set_config(serving_max_batch_rows=1, serving_pipeline_depth=3,
               serving_pipeline_interleave=True)
    server = _serve(fa=pca_model, fb=pca_model)
    try:
        server.transform("fa", _q(rng), timeout=60)
        server.transform("fb", _q(rng), timeout=60)
        server.pause()
        stamps = {}

        def _stamp(key):
            return lambda f: stamps.__setitem__(key, time.perf_counter())

        futs = []
        for i in range(6):
            for name in ("fa", "fb"):
                f = server.submit(name, _q(rng))
                f.add_done_callback(_stamp((name, i)))
                futs.append(f)
        server.resume()
        for f in futs:
            f.result(timeout=120)
        for name in ("fa", "fb"):
            order = [stamps[(name, i)] for i in range(6)]
            assert order == sorted(order), order
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# mid-pipeline fault recovery
# ---------------------------------------------------------------------------


def test_oom_mid_pipeline_requeues_without_loss(pca_model, rng):
    set_config(serving_pipeline_depth=4, serving_max_batch_rows=2)
    server = _serve(poom=pca_model)
    try:
        reqs = [_q(rng, 1) for _ in range(16)]
        server.pause()
        futs = [server.submit("poom", r) for r in reqs]
        with fault_inject("serving_dispatch", "oom", times=1):
            server.resume()
            outs = [f.result(timeout=120) for f in futs]
        assert len(outs) == 16
        for r, o in zip(reqs, outs):
            assert np.array_equal(o["proj"], pca_model._transform_array(r)["proj"])
        assert server._shrunk_cap is not None
    finally:
        server.stop()


def test_collect_fault_mid_pipeline_requeues_without_loss(pca_model, rng):
    from spark_rapids_ml_torch.resilience.retry import RETRIES

    set_config(serving_pipeline_depth=4, serving_max_batch_rows=2)
    server = _serve(pcol=pca_model)
    try:
        r0 = RETRIES.value(label="serving_dispatch", action="oom")
        reqs = [_q(rng, 1) for _ in range(16)]
        server.pause()
        futs = [server.submit("pcol", r) for r in reqs]
        with fault_inject("serving_collect", "oom", times=1):
            server.resume()
            outs = [f.result(timeout=120) for f in futs]
        assert len(outs) == 16
        for r, o in zip(reqs, outs):
            assert np.array_equal(o["proj"], pca_model._transform_array(r)["proj"])
        assert RETRIES.value(label="serving_dispatch", action="oom") > r0
    finally:
        server.stop()


def test_device_lost_mid_pipeline_repins_and_drains(pca_model, rng):
    """Device loss with a full pipeline: one card's full retry, pinned
    models re-pin on the same device, and every queued + in-flight
    request completes exactly."""
    set_config(serving_pipeline_depth=4, serving_max_batch_rows=2)
    server = _serve(pdl=pca_model)
    try:
        reqs = [_q(rng, 1) for _ in range(16)]
        server.pause()
        futs = [server.submit("pdl", r) for r in reqs]
        with fault_inject("serving_dispatch", "device_lost", times=1):
            server.resume()
            outs = [f.result(timeout=120) for f in futs]
        assert len(outs) == 16
        assert RECOVERY_METRICS["full_retry_fallbacks"] >= 1
        assert PINS.value(model="pdl", event="repin") >= 1
        for r, o in zip(reqs, outs):
            assert np.array_equal(o["proj"], pca_model._transform_array(r)["proj"])
    finally:
        server.stop()


def test_brownout_composes_with_pipeline(pca_model, rng):
    set_config(serving_pipeline_depth=4, serving_controller_interval_s=0.05,
               serving_max_batch_rows=4)
    server = _serve(bo=pca_model)
    try:
        server.pause()
        reqs = [_q(rng, 1) for _ in range(24)]
        futs = [server.submit("bo", r, priority="batch" if i % 3 == 0 else "interactive")
                for i, r in enumerate(reqs)]
        server.resume()
        for r, f in zip(reqs, futs):
            assert np.array_equal(f.result(timeout=120)["proj"],
                                  pca_model._transform_array(r)["proj"])
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# controller changes apply at the next coalesce
# ---------------------------------------------------------------------------


def test_cap_change_applies_at_next_coalesce_no_torn_batch(pca_model, rng):
    set_config(serving_max_batch_rows=64, serving_pipeline_depth=1)
    server = _serve(cap=pca_model)
    try:
        server.transform("cap", _q(rng), timeout=60)
        server.pause()
        futs = [server.submit("cap", _q(rng)) for _ in range(8)]
        set_config(serving_max_batch_rows=4)
        b0 = server._batches
        server.resume()
        for f in futs:
            f.result(timeout=120)
        assert server._batches - b0 == 2
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# depth resolution
# ---------------------------------------------------------------------------


def test_pipeline_depth_bounds(pca_model):
    import spark_rapids_ml_torch.serving.server as srv_mod

    server = ServingServer()
    server.register("dep", pca_model)
    set_config(serving_pipeline_depth=99)
    assert server._pipeline_depth() == srv_mod._MAX_PIPELINE_DEPTH
    set_config(serving_pipeline_depth=1)
    assert server._pipeline_depth() == 1
    set_config(serving_pipeline_depth=0, serving_pipeline_max_depth=3)
    assert 2 <= server._pipeline_depth() <= 3
    server.registry.clear()


def test_auto_depth_deepens_when_host_phases_steal_idle_time(pca_model):
    """The auto depth reads the serving gap table: host-side phases
    covering >10% of the observed wall buy one slot, >25% a second,
    bounded by serving_pipeline_max_depth."""
    from spark_rapids_ml_torch.telemetry import utilization

    server = ServingServer()
    now = time.perf_counter()
    utilization.note_interval("device", now - 1.0, now - 0.7, domain="serving")
    utilization.note_interval("stage", now - 0.7, now, domain="serving")
    set_config(serving_pipeline_depth=0, serving_pipeline_max_depth=4)
    assert server._auto_depth() == 4
    server._auto_memo = (0.0, 2)
    set_config(serving_pipeline_max_depth=3)
    assert server._auto_depth() == 3


def test_pipeline_info_and_report_surface(pca_model, rng):
    set_config(serving_pipeline_depth=3)
    server = _serve(pinfo=pca_model)
    try:
        server.transform("pinfo", _q(rng, 2), timeout=60)
        deadline = time.time() + 5
        while server.pipeline_info()["inflight"] and time.time() < deadline:
            time.sleep(0.01)
        info = server.pipeline_info()
        assert info["depth"] == 3 and info["depth_conf"] == 3
        assert info["interleave"] is True
        assert info["inflight"] == 0
        assert info["batches"] >= 1
        assert server.report()["_totals"]["pipeline"]["depth"] == 3
    finally:
        server.stop()


def test_serving_utilization_windows_recorded(pca_model, rng):
    from spark_rapids_ml_torch.telemetry import utilization

    server = _serve(util=pca_model)
    try:
        for _ in range(6):
            server.transform("util", _q(rng, 2), timeout=60)
        kinds = {e[1] for e in utilization.timeline(window_s=60.0, domain="serving")}
        for kind in ("stage", "compute", "collect", "scatter", "dispatch", "device"):
            assert kind in kinds, (kind, sorted(kinds))
        util = server.report()["_totals"]["utilization"]
        assert 0.0 <= util["device_busy_fraction"] <= 1.0 and util["wall_s"] > 0
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# registry at scale
# ---------------------------------------------------------------------------


def test_registry_o1_probe_and_incremental_bytes(pca_model, logreg_model):
    server = ServingServer()
    server.register("ra", pca_model)
    server.register("rb", logreg_model)
    reg = server.registry
    assert reg.is_pinned("ra") and reg.is_pinned("rb")
    assert not reg.is_pinned("nope")
    assert reg.pinned_bytes() == reg.resolve("ra").nbytes + reg.resolve("rb").nbytes
    reg.unregister("ra")
    assert not reg.is_pinned("ra")
    assert reg.pinned_bytes() == reg.resolve("rb").nbytes
    reg.clear()
    assert reg.pinned_bytes() == 0


def test_batched_eviction_covers_shortfall_in_one_pass(pca_model):
    server = ServingServer()
    server.register("ba", pca_model)
    nbytes = server.registry.resolve("ba").nbytes
    server.register("bb", pca_model)
    server.register("bc", pca_model)
    assert server.registry.pinned_bytes() == 3 * nbytes
    set_config(device_cache_bytes=int(nbytes * 1.5))
    server.register("bd", pca_model)
    assert server.registry.pinned_names() == ["bd"]
    assert server.registry.pinned_bytes() == nbytes
    for name in ("ba", "bb", "bc"):
        assert PINS.value(model=name, event="evict") >= 1
    server.registry.clear()


def test_release_external_many_batched_ledger():
    from spark_rapids_ml_torch.parallel.device_cache import get_device_cache

    cache = get_device_cache()
    for i in range(3):
        assert cache.reserve_external(f"t:{i}", 1024)
    assert cache.release_external_many([f"t:{i}" for i in range(3)] + ["t:x"]) == 3 * 1024
    assert cache.release_external_many([f"t:{i}" for i in range(3)]) == 0


def test_interleave_off_keeps_oldest_head_order(pca_model, rng):
    set_config(serving_pipeline_interleave=False, serving_max_batch_rows=1,
               serving_pipeline_depth=2)
    server = _serve(oa=pca_model, ob=pca_model)
    try:
        server.pause()
        futs = [server.submit("oa", _q(rng)) for _ in range(3)]
        futs += [server.submit("ob", _q(rng)) for _ in range(3)]
        server.resume()
        for f in futs:
            assert f.result(timeout=120)["proj"].shape == (1, 3)
    finally:
        server.stop()
