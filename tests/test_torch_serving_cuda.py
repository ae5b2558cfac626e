#
# The serving layer on the card: coalesced requests against each alone,
# the staged pipeline on CUDA streams (depth 3 against depth 1, byte for
# byte), a real torch.cuda.OutOfMemoryError with no request lost, the
# served kNN route through the fused kernel, and a real device-side assert
# in a child process, whose requests fail with the typed error and are
# not requeued.  Every test here needs a CUDA device and skips without
# one.  This file imports no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_serving_cuda.py
#
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import resilience, set_default_device

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_default_device("cuda")
    port_config.reset_config()
    port_config.set_config(retry_backoff_s=0.01, retry_jitter=0.0)
    resilience.reset_metrics()
    resilience.reset_faults()
    yield torch.device("cuda")
    set_default_device(None)
    port_config.reset_config()
    torch.cuda.empty_cache()


def _models(device):
    from spark_rapids_ml_torch.classification import LogisticRegression
    from spark_rapids_ml_torch.feature import PCA

    rng = np.random.default_rng(0)
    X = rng.normal(size=(20_000, D)).astype(np.float32)
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float32)
    y3 = np.digitize(X[:, 2], [-0.4, 0.4]).astype(np.float32)
    return {
        "pca": PCA(k=8).setInputCol("features").setOutputCol("proj").fit({"features": X}),
        "lr2": LogisticRegression(maxIter=20).fit((X, y)),
        "lr3": LogisticRegression(maxIter=20).fit((X, y3)),
    }


def _serve(models, **conf):
    from spark_rapids_ml_torch.serving import ServingServer

    port_config.set_config(**conf)
    server = ServingServer()
    for name, m in models.items():
        server.register(name, m)
    return server.start()


def _traffic(server, reqs):
    server.pause()
    futs = [server.submit(name, X) for name, X in reqs]
    server.resume()
    return [f.result(timeout=120) for f in futs]


def test_coalesced_rows_equal_each_row_alone_on_the_card(cuda_device):
    """Every padding class computes with one product shape, so a row's
    output on the card is the same bits whether it was coalesced with 31
    others or sent alone."""
    models = _models(cuda_device)
    rng = np.random.default_rng(1)
    reqs = [(name, rng.normal(size=(1, D)).astype(np.float32))
            for _ in range(32) for name in models]
    server = _serve(models)
    try:
        coalesced = _traffic(server, reqs)
        batches = server.report()["_totals"]["batches"]
        alone = [server.transform(name, X, timeout=60) for name, X in reqs]
    finally:
        server.stop()
    assert batches <= 2 * len(models) < len(reqs)  # the first pass coalesced
    for (name, _), a, b in zip(reqs, coalesced, alone):
        for col in a:
            assert np.array_equal(a[col], b[col]), (name, col)
    # and the model's own transform of the same rows, padded alike
    X = np.concatenate([x for n, x in reqs if n == "pca"])
    ref = models["pca"].transform(X)
    got = np.concatenate([o["proj"] for (n, _), o in zip(reqs, coalesced) if n == "pca"])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("depth", [3, 0])
def test_depth_against_depth_one_byte_parity_on_streams(cuda_device, depth):
    models = _models(cuda_device)
    rng = np.random.default_rng(2)
    reqs = [(name, rng.normal(size=(1 + i % 5, D)).astype(np.float32))
            for i in range(60) for name in models]
    outs = {}
    for dep in (1, depth):
        server = _serve(models, serving_pipeline_depth=dep, serving_max_batch_rows=16)
        try:
            outs[dep] = _traffic(server, reqs)
            assert len(server._streams) > 1  # each in-flight batch on its own stream
        finally:
            server.stop()
            server.registry.clear()
    for a, b in zip(outs[1], outs[depth]):
        for col in a:
            assert a[col].tobytes() == b[col].tobytes()


def test_real_oom_halves_the_cap_and_loses_no_request(cuda_device):
    """A real torch.cuda.OutOfMemoryError in a dispatch: the cap halves,
    the batch's requests go back to the front, and every request is
    answered once."""
    from spark_rapids_ml_torch.knn import NearestNeighbors
    from spark_rapids_ml_torch.serving import ServingServer

    items = np.random.default_rng(3).normal(size=(1000, D)).astype(np.float32)
    knn = NearestNeighbors(k=4).fit({"features": items})
    state = {"n": 0}

    def transform(Q):
        state["n"] += 1
        if state["n"] == 1:
            free, _ = torch.cuda.mem_get_info()
            torch.empty(int(free) * 4, dtype=torch.uint8, device=cuda_device)
        d, i = knn._search(Q, 4)
        return {"distances": d, "indices": i}

    server = ServingServer()
    server.register("knn", knn, n_features=D, transform=transform)
    server.start()
    try:
        Q = np.random.default_rng(4).normal(size=(40, D)).astype(np.float32)
        outs = _traffic(server, [("knn", Q[i:i + 1]) for i in range(40)])
        assert server._shrunk_cap is not None
    finally:
        server.stop()
    _, want = knn._search(Q, 4)
    assert np.array_equal(np.concatenate([o["indices"] for o in outs]), want)
    ev = [e.detail for e in resilience.get_events("retry[serving_dispatch]")]
    assert ev and "action=oom" in ev[0]


def test_served_knn_runs_the_fused_kernel(cuda_device):
    from spark_rapids_ml_torch.knn import NearestNeighbors
    from spark_rapids_ml_torch.ops import fused_knn as fk
    from spark_rapids_ml_torch.serving import ServingServer

    rng = np.random.default_rng(5)
    items = rng.normal(size=(50_000, D)).astype(np.float32)
    knn = NearestNeighbors(k=32).fit({"features": items})

    def transform(Q):
        d, i = knn._search(Q, 32)
        return {"distances": d, "indices": i}

    server = ServingServer()
    server.register("knn", knn, n_features=D, transform=transform)
    server.start()
    try:
        Q = rng.normal(size=(64, D)).astype(np.float32)
        before = fk.LAUNCHES
        outs = _traffic(server, [("knn", Q[i:i + 1]) for i in range(64)])
        assert fk.LAUNCHES > before
    finally:
        server.stop()
    d, i = knn._search(Q, 32)
    got_i = np.concatenate([o["indices"] for o in outs])
    got_d = np.concatenate([o["distances"] for o in outs])
    np.testing.assert_allclose(got_d, d, rtol=1e-5, atol=1e-5)
    # ids equal but at exact ties of the distance
    diff = got_i != i
    assert np.all(np.isclose(got_d[diff], d[diff], rtol=1e-6, atol=1e-6))


_ASSERT_CHILD = r'''
import json, sys
import numpy as np
import torch
from spark_rapids_ml_torch import config, resilience, set_default_device
from spark_rapids_ml_torch.feature import PCA
from spark_rapids_ml_torch.knn import NearestNeighbors
from spark_rapids_ml_torch.serving import ServingDeviceError, ServingServer
from spark_rapids_ml_torch.serving.registry import PINS

dev = torch.device("cuda:0")
set_default_device(dev)
config.set_config(serving_max_batch_rows=2, retry_backoff_s=0.01, retry_jitter=0.0)
rng = np.random.default_rng(0)
X = rng.normal(size=(500, 16)).astype(np.float32)
pca = PCA(k=3).setInputCol("features").setOutputCol("proj").fit({"features": X})
knn = NearestNeighbors(k=2).fit({"features": X})
calls = []

def poisoned(Q):
    calls.append(len(Q))
    t = torch.zeros(4, device=dev)
    t[torch.tensor([1 << 20], device=dev)] += 1.0  # a real device-side assert
    torch.cuda.synchronize()
    return {"x": np.zeros(len(Q))}

srv = ServingServer()
srv.register("dead", knn, n_features=16, transform=poisoned)
srv.register("good", pca)
srv.start()
srv.pause()
futs = [srv.submit("dead", X[i:i + 1]) for i in range(4)]
futs += [srv.submit("good", X[i:i + 1]) for i in range(4)]
srv.resume()
errors = []
for f in futs:
    try:
        f.result(timeout=120)
        errors.append("answered")
    except ServingDeviceError as e:
        errors.append("typed:" + str(e.cause).splitlines()[0][:80])
    except Exception as e:
        errors.append("other:" + type(e).__name__)
try:
    srv.submit("good", X[:1])
    refused = False
except ServingDeviceError:
    refused = True
print(json.dumps({"errors": errors, "calls": calls, "refused": refused,
                  "repins": PINS.value(model="good", event="repin"),
                  "sticky": len(resilience.get_events("sticky_error[serving_dispatch]"))}),
      flush=True)
import os
os._exit(0)
'''


def test_device_side_assert_fails_requests_typed_and_stops(cuda_device):
    out = subprocess.run([sys.executable, "-c", _ASSERT_CHILD], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert line, (out.returncode, out.stderr[-2000:])
    rec = json.loads(line[-1])
    assert rec["calls"] == [2]  # one dispatch, never requeued
    dead, good = rec["errors"][:4], rec["errors"][4:]
    assert all(e.startswith("typed:") and "device-side assert" in e for e in dead), rec
    assert all(e.startswith("typed:") or e == "answered" for e in good), rec
    assert rec["refused"] and rec["repins"] == 0 and rec["sticky"] == 1
