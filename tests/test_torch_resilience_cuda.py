#
# The resilience layer on the card: a real torch.cuda.OutOfMemoryError is
# classified and a transform recovers from it by halving its chunk, and the
# watchdog bounds real card work (its timeout ends in a device
# synchronization of the abandoned work before the next fit).  Every test
# here needs a CUDA device and skips without one.  This file imports no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_resilience_cuda.py
#
import time

import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import resilience
from spark_rapids_ml_torch.classification import LogisticRegression

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_default_device("cuda")
    resilience.reset_metrics()
    yield torch.device("cuda")
    resilience.wait_abandoned()
    set_default_device(None)
    port_config.reset_config()
    torch.cuda.empty_cache()


def test_real_oom_is_classified(cuda_device):
    free, _ = torch.cuda.mem_get_info()
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(int(free) * 4, dtype=torch.uint8, device=cuda_device)
    assert resilience.is_oom(ei.value) and resilience.classify_error(ei.value) == "oom"
    assert not resilience.is_sticky_cuda_error(ei.value)
    # the context is usable afterwards
    assert float(torch.ones(4, device=cuda_device).sum()) == 4.0


def test_transform_recovers_a_real_oom(cuda_device):
    """Ballast leaves less free memory than one chunk of the transform: it
    raises a real OOM, halves its chunk and gives the unconstrained
    transform's predictions."""
    rng = np.random.default_rng(0)
    d = 4096
    X = rng.normal(size=(6000, d)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    model = LogisticRegression(regParam=0.01, maxIter=5).fit((X[:2000], y[:2000]))
    ref = model.transform(X)
    port_config.set_config(host_batch_bytes=4 * 2048 * d * 4)  # 4096-row chunks, 64 MiB
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    ballast = torch.empty(int(free) - (48 << 20), dtype=torch.uint8, device=cuda_device)
    try:
        out = model.transform(X)
    finally:
        del ballast
        torch.cuda.empty_cache()
    ev = [e.detail for e in resilience.get_events("retry[transform_dispatch]")]
    assert ev and all("action=oom" in e for e in ev), ev
    np.testing.assert_array_equal(out["prediction"], ref["prediction"])
    np.testing.assert_allclose(out["probability"], ref["probability"], rtol=1e-5, atol=1e-6)


def test_watchdog_bounds_real_card_work(cuda_device):
    """A deadline below the guarded fit's real time raises DispatchTimeout
    within the deadline + 2 s; the next fit, without a deadline, queues
    behind the abandoned one's work on the card and gives the same model."""
    from spark_rapids_ml_torch.utils import _ArrayBatch

    rng = np.random.default_rng(1)
    X = rng.normal(size=(400000, 512)).astype(np.float32)
    y = (X[:, :8].sum(axis=1) + rng.normal(size=400000) > 0).astype(np.float64)
    est = LogisticRegression(regParam=1e-8, maxIter=300, tol=1e-12)
    fi = est._stage_fit_input(_ArrayBatch(X=X, y=y))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = est._run_fit_kernel(fi)
    fit_s = time.perf_counter() - t0
    deadline = fit_s / 4
    port_config.set_config(dispatch_deadline_s=deadline, retry_max_attempts=1)
    t0 = time.perf_counter()
    with pytest.raises(resilience.DispatchTimeout):
        est._run_fit_kernel(fi)
    assert time.perf_counter() - t0 < deadline + 2.0
    port_config.set_config(dispatch_deadline_s=0.0)
    again = est._run_fit_kernel(fi)
    np.testing.assert_array_equal(again["coef_"], ref["coef_"])
    assert again["objective_history"] == ref["objective_history"]
