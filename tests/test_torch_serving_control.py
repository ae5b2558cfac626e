#
# The port's serving control plane (spark_rapids_ml_torch/serving/
# control.py) on the CPU: the JAX package's tests/test_serving_control.py
# ported to the port's API — AIMD convergence and hysteresis, the brownout
# phase machine, priority-class admission and weighted dispatch, padding
# classes (one staged shape per bucket), the `serving_admission` fault site
# and the dispatcher-lag liveness fix.  The flight recorder's brownout
# bundle waits for that module (ROADMAP.md item 6): here the escalation's
# typed failure is observed at its seam.
#
import json
import time
import urllib.error
import urllib.request

import pytest

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.resilience import fault_inject
from spark_rapids_ml_torch.serving import ServingController, ServingOverload, ServingServer
from spark_rapids_ml_torch.serving.control import (
    BROWNOUT_PHASES,
    LAST_BUCKET_DECISION,
    PRIORITY_CLASSES,
    resolve_priority,
)
from torch_serving_support import port_logreg, port_pca, reset_port_state, rows as _q

set_config = port_config.set_config
get_config = port_config.get_config


@pytest.fixture(autouse=True)
def _clean():
    reset_port_state()
    yield
    reset_port_state()


@pytest.fixture(scope="module")
def pca_model():
    return port_pca(11)


@pytest.fixture(scope="module")
def logreg_model():
    return port_logreg(11)


def _serve(**models) -> ServingServer:
    server = ServingServer()
    for name, model in models.items():
        server.register(name, model)
    return server.start()


@pytest.fixture
def noted(monkeypatch):
    """The typed failures the control plane notes (its flight-recorder
    seam)."""
    from spark_rapids_ml_torch.serving import _seams

    seen = []
    monkeypatch.setattr(_seams, "note_failure",
                        lambda reason, detail="", log=None: seen.append((reason, detail)))
    return seen


# ---------------------------------------------------------------------------
# AIMD controller unit dynamics
# ---------------------------------------------------------------------------


def test_aimd_multiplicative_decrease_and_additive_regrow():
    ctl = ServingController()
    t = 1000.0
    ctl.tick("m", 4.0, 10.0, 1024, 2.0, now=t)
    assert ctl.cap_scale("m") == 0.5
    assert ctl.wait_scale("m") == 0.5
    ctl.tick("m", 4.0, 10.0, 1024, 2.0, now=t + 2)
    assert ctl.cap_scale("m") == 0.25
    t += 2
    steps = 0
    while ctl.cap_scale("m") < 1.0:
        t += 2
        ctl.tick("m", 0.0, 10.0, 1024, 2.0, now=t)
        steps += 1
        assert steps < 20
    assert steps == 6
    assert ctl.wait_scale("m") == 1.0


def test_aimd_hysteresis_band_holds():
    ctl = ServingController()
    t = 1000.0
    ctl.tick("m", 4.0, 10.0, 1024, 2.0, now=t)
    assert ctl.cap_scale("m") == 0.5
    for i in range(5):
        ctl.tick("m", 0.75, 10.0, 1024, 2.0, now=t + 2 * (i + 1))
    assert ctl.cap_scale("m") == 0.5
    assert ctl.wait_scale("m") == 0.5


def test_aimd_tick_rate_limited_and_floored():
    ctl = ServingController()
    t = 1000.0
    ctl.tick("m", 4.0, 10.0, 1024, 2.0, now=t)
    ctl.tick("m", 4.0, 10.0, 1024, 2.0, now=t + 0.2)
    assert ctl.cap_scale("m") == 0.5
    for i in range(32):
        ctl.tick("m", 4.0, 10.0, 1024, 2.0, now=t + 2.0 * (i + 1))
    assert ctl.cap_scale("m") >= 1.0 / 64.0
    assert ctl.cap_scale("m") > 0


def test_controller_off_restores_static_knobs():
    set_config(serving_controller="off")
    ctl = ServingController()
    assert ctl.cap_scale("m") == 1.0 and ctl.wait_scale("m") == 1.0
    ok, reason, _ = ctl.admit("m", "batch", 5, 5, 10)
    assert ok
    ok, reason, _ = ctl.admit("m", "batch", 10, 10, 10)
    assert not ok and reason == "queue_full"


# ---------------------------------------------------------------------------
# brownout phase machine
# ---------------------------------------------------------------------------


def test_brownout_spike_shed_recover(noted):
    """Sustained burn escalates one phase per sustain window (timers
    re-armed); sustained recovery de-escalates one phase per recovery
    window; each escalation notes a typed "brownout" failure naming the
    transition."""
    set_config(serving_brownout_sustain_s=1.0, serving_brownout_recover_s=1.0,
               serving_controller_interval_s=0.5)
    ctl = ServingController()
    t = 5000.0
    ctl.tick("m", 10.0, 50.0, 1024, 2.0, now=t)
    assert ctl.phase("m") == 0
    ctl.tick("m", 10.0, 50.0, 1024, 2.0, now=t + 1.2)
    assert ctl.phase("m") == 1
    ctl.tick("m", 10.0, 50.0, 1024, 2.0, now=t + 1.9)
    assert ctl.phase("m") == 1
    ctl.tick("m", 10.0, 50.0, 1024, 2.0, now=t + 2.6)
    assert ctl.phase("m") == 2
    ctl.tick("m", 10.0, 50.0, 1024, 2.0, now=t + 4.0)
    assert ctl.phase("m") == 2
    assert ctl.brownout_summary() == {"m": "shed_interactive"}
    ctl.tick("m", 0.0, 5.0, 1024, 2.0, now=t + 10.0)
    ctl.tick("m", 0.0, 5.0, 1024, 2.0, now=t + 11.2)
    assert ctl.phase("m") == 1
    ctl.tick("m", 0.0, 5.0, 1024, 2.0, now=t + 12.4)
    assert ctl.phase("m") == 0
    assert ctl.brownout_summary() == {}
    assert [r for r, _ in noted] == ["brownout", "brownout"]
    assert "model=m" in noted[0][1] and "normal->shed_batch" in noted[0][1]
    assert "shed_batch->shed_interactive" in noted[1][1]


def test_brownout_flap_cannot_ratchet():
    set_config(serving_brownout_sustain_s=1.0, serving_controller_interval_s=0.1)
    ctl = ServingController()
    t = 7000.0
    for _ in range(6):
        ctl.tick("m", 10.0, 50.0, 1024, 2.0, now=t)
        ctl.tick("m", 10.0, 50.0, 1024, 2.0, now=t + 0.6)
        ctl.tick("m", 0.8, 50.0, 1024, 2.0, now=t + 0.8)
        t += 1.0
    assert ctl.phase("m") == 0


# ---------------------------------------------------------------------------
# priority admission + weighted dispatch
# ---------------------------------------------------------------------------


def test_priority_resolution_chain():
    assert resolve_priority(None, None) == "interactive"
    assert resolve_priority(None, "batch") == "batch"
    assert resolve_priority("interactive", "batch") == "interactive"
    set_config(serving_priority_default="batch")
    assert resolve_priority(None, None) == "batch"
    with pytest.raises(ValueError, match="unknown priority class"):
        resolve_priority("realtime", None)


def test_batch_class_bounded_to_queue_share(pca_model, rng):
    set_config(serving_max_queue=8, serving_batch_share=0.25)
    server = _serve(share=pca_model)
    try:
        server.pause()
        futs = [server.submit("share", _q(rng), priority="batch") for _ in range(2)]
        with pytest.raises(ServingOverload) as ei:
            server.submit("share", _q(rng), priority="batch")
        assert ei.value.reason == "queue_full"
        futs += [server.submit("share", _q(rng), priority="interactive") for _ in range(4)]
        server.resume()
        for f in futs:
            f.result(timeout=60)
    finally:
        server.stop()


def test_batch_cannot_starve_interactive_10_to_1(logreg_model, rng):
    set_config(serving_max_batch_rows=1, serving_max_queue=128, serving_batch_share=0.25)
    server = _serve(skew=logreg_model)
    try:
        server.transform("skew", _q(rng), timeout=60)
        server.pause()
        done_at = {}

        def _stamp(key):
            return lambda f: done_at.__setitem__(key, time.perf_counter())

        b_futs = []
        for i in range(20):
            f = server.submit("skew", _q(rng), priority="batch")
            f.add_done_callback(_stamp(("b", i)))
            b_futs.append(f)
        i_futs = []
        for i in range(2):
            f = server.submit("skew", _q(rng), priority="interactive")
            f.add_done_callback(_stamp(("i", i)))
            i_futs.append(f)
        server.resume()
        for f in i_futs + b_futs:
            f.result(timeout=120)
        t_interactive = max(done_at[("i", i)] for i in range(len(i_futs)))
        batch_before = sum(1 for i in range(len(b_futs)) if done_at[("b", i)] <= t_interactive)
        assert batch_before <= len(b_futs) // 2, batch_before
    finally:
        server.stop()


def test_model_default_priority_registration(pca_model, rng):
    server = ServingServer()
    server.register("bg", pca_model, priority="batch")
    with pytest.raises(ValueError, match="unknown priority class"):
        server.register("bad", pca_model, priority="urgent")
    set_config(serving_max_queue=8, serving_batch_share=0.25)
    server.start()
    try:
        server.pause()
        futs = [server.submit("bg", _q(rng)) for _ in range(2)]
        with pytest.raises(ServingOverload):
            server.submit("bg", _q(rng))
        futs.append(server.submit("bg", _q(rng), priority="interactive"))
        server.resume()
        for f in futs:
            f.result(timeout=60)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# spike -> shed -> recover on a live server
# ---------------------------------------------------------------------------


def test_live_spike_sheds_batch_then_recovers(pca_model, rng, noted):
    from spark_rapids_ml_torch.serving.control import SHED

    set_config(serving_slo_targets="live=0.0001", serving_controller_interval_s=0.05,
               serving_brownout_sustain_s=0.2, serving_brownout_recover_s=0.2)
    server = _serve(live=pca_model)
    try:
        deadline = time.time() + 30
        while server._controller.phase("live") < 1 and time.time() < deadline:
            server.transform("live", _q(rng), timeout=60)
            time.sleep(0.05)
        assert server._controller.phase("live") >= 1, "brownout never hit"
        shed0 = SHED.value(default=0, model="live", **{"class": "batch"})
        with pytest.raises(ServingOverload) as ei:
            server.submit("live", _q(rng), priority="batch")
        assert ei.value.reason == "shed"
        assert SHED.value(default=0, model="live", **{"class": "batch"}) == shed0 + 1
        server.transform("live", _q(rng), timeout=60)
        rep = server.report()
        assert rep["live"]["controller"]["shed"].get("batch", 0) >= 1
        assert rep["live"]["controller"]["brownout_phase"] in ("shed_batch", "shed_interactive")
        assert rep["_totals"]["controller"]["brownout"].get("live")
        assert noted and noted[0][0] == "brownout"
        set_config(serving_slo_targets="live=60000")
        deadline = time.time() + 30
        while server._controller.phase("live") > 0 and time.time() < deadline:
            server.transform("live", _q(rng), timeout=60)
            time.sleep(0.05)
        assert server._controller.phase("live") == 0, "never recovered"
        server.transform("live", _q(rng), priority="batch", timeout=60)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# padding classes: one staged shape per bucket
# ---------------------------------------------------------------------------


def test_padding_buckets_stage_one_shape_per_bucket(pca_model, rng, monkeypatch):
    """Churning request sizes inside one {1,1.5}x2^k bucket stage to the
    SAME padded shape (every size of the class computes with one product
    shape), the padding is trimmed, the decision lands in
    LAST_BUCKET_DECISION, and the report lists the padding class."""
    from spark_rapids_ml_torch.models.feature import PCAModel
    from spark_rapids_ml_torch.parallel.mesh import bucket_rows

    assert bool(get_config("serving_padding_buckets"))
    shapes = []
    real = PCAModel._transform_device

    def spy(self, Xs):
        shapes.append(tuple(Xs.shape))
        return real(self, Xs)

    monkeypatch.setattr(PCAModel, "_transform_device", spy)
    server = _serve(pad=pca_model)
    try:
        for n in (1, 7, 33, 120, 255):
            out = server.transform("pad", _q(rng, n), timeout=60)
            assert out["proj"].shape == (n, 3)
        assert set(shapes) == {(bucket_rows(255), 16)}
        assert LAST_BUCKET_DECISION["model"] == "pad"
        assert LAST_BUCKET_DECISION["rows"] == 255
        assert LAST_BUCKET_DECISION["bucket"] == bucket_rows(255)
        assert LAST_BUCKET_DECISION["stamp"] > 0
        assert bucket_rows(255) in server.report()["pad"]["controller"]["padding_classes"]
    finally:
        server.stop()


def test_padding_buckets_off_stages_exact(pca_model, rng):
    set_config(serving_padding_buckets=False, shape_bucketing=False)
    server = _serve(nopad=pca_model)
    try:
        out = server.transform("nopad", _q(rng, 5), timeout=60)
        assert out["proj"].shape == (5, 3)
        assert LAST_BUCKET_DECISION == {}
        assert server.report()["nopad"]["controller"]["padding_classes"] == []
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# serving_admission fault site + dispatcher-lag liveness
# ---------------------------------------------------------------------------


def test_admission_fault_site_rejects_before_enqueue(pca_model, rng):
    server = _serve(inj=pca_model)
    try:
        with fault_inject("serving_admission", "oom", times=1):
            with pytest.raises(Exception, match="injected"):
                server.submit("inj", _q(rng))
        assert server._queued == 0
        assert server.report()["_totals"]["queued"] == 0
        assert server.transform("inj", _q(rng, 2), timeout=60)["proj"].shape == (2, 3)
    finally:
        server.stop()


def test_dispatcher_lag_publishes_on_saturated_dispatch(pca_model, rng):
    from spark_rapids_ml_torch.serving.server import DISPATCH_LAG

    set_config(serving_max_batch_rows=1)
    server = _serve(lag=pca_model)
    try:
        server.transform("lag", _q(rng), timeout=60)
        server.pause()
        futs = [server.submit("lag", _q(rng)) for _ in range(30)]
        DISPATCH_LAG.set(-1.0)
        server.resume()
        for f in futs:
            f.result(timeout=120)
        assert DISPATCH_LAG.value() >= 0.0
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# report / detail surfaces
# ---------------------------------------------------------------------------


def test_report_carries_controller_state(pca_model, rng):
    server = _serve(rep=pca_model)
    try:
        server.transform("rep", _q(rng), timeout=60)
        entry = server.report()["rep"]["controller"]
        assert entry["cap"] >= 1
        assert entry["max_wait_ms"] == float(get_config("serving_max_wait_ms"))
        assert entry["brownout_phase"] == BROWNOUT_PHASES[0]
        assert entry["shed"] == {}
        totals = server.report()["_totals"]["controller"]
        assert totals["enabled"] is True
        assert totals["priority_shares"] == {
            "interactive": 1.0, "batch": float(get_config("serving_batch_share"))}
        assert totals["shed"] == {c: 0 for c in PRIORITY_CLASSES}
        assert totals["brownout"] == {}
        assert server.model_detail("rep")["controller"]["cap"] >= 1
        assert "drift" not in server.model_detail("rep")
    finally:
        server.stop()


def test_http_x_priority_header(pca_model, rng):
    from spark_rapids_ml_torch.serving.http import start_serving_http

    set_config(serving_max_queue=8, serving_batch_share=0.25)
    server = _serve(hweb=pca_model)
    http = start_serving_http(server, port=0)
    base = f"http://127.0.0.1:{http.server_port}"
    try:
        body = json.dumps({"instances": _q(rng).tolist()}).encode()

        def _post(headers):
            req = urllib.request.Request(
                f"{base}/v1/models/hweb:transform", data=body,
                headers={"Content-Type": "application/json", **headers})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.load(resp)

        assert _post({"X-Priority": "interactive"})["rows"] == 1
        assert _post({"X-Priority": "batch"})["rows"] == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post({"X-Priority": "urgent"})
        assert ei.value.code == 400
        with urllib.request.urlopen(f"{base}/v1/models/hweb", timeout=30) as r:
            detail = json.load(r)
        assert detail["controller"]["brownout_phase"] == "normal"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/v1/models/missing", timeout=30)
        assert ei.value.code == 404
    finally:
        http.shutdown()
        http.server_close()
        server.stop()
