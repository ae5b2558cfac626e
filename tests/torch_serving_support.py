#
# Shared fixtures of the port's serving and telemetry tests
# (tests/test_torch_serving*.py, tests/test_torch_telemetry.py): the reset
# of every piece of process state they touch (xdist `--dist loadfile` runs
# many files in one worker process), and small fitted models.  Not a test
# module itself.
#
import functools

import numpy as np

D = 16  # wide enough that the weight matrices clear _PIN_MIN_BYTES


def reset_port_state() -> None:
    """The port's conf (on the CPU, fast retries), armed faults, metrics
    registry, resilience events, trace buffer, utilization timeline,
    lock-table accounting, elastic state and device-budget reservations."""
    import gc

    from spark_rapids_ml_torch import config as port_config
    from spark_rapids_ml_torch import set_default_device
    from spark_rapids_ml_torch.parallel.device_cache import get_device_cache
    from spark_rapids_ml_torch.resilience import reset_elastic, reset_faults, reset_metrics
    from spark_rapids_ml_torch.serving.control import LAST_BUCKET_DECISION
    from spark_rapids_ml_torch.telemetry import locks, utilization
    from spark_rapids_ml_torch.telemetry.registry import REGISTRY
    from spark_rapids_ml_torch.tracing import reset_trace

    set_default_device("cpu")
    port_config.reset_config()
    port_config.set_config(retry_backoff_s=0.01, retry_jitter=0.0)
    reset_faults()
    reset_metrics()
    REGISTRY.reset()
    reset_trace()
    utilization.clear()
    gc.collect()
    for _name, _kind, core in locks._live_cores():
        core.acquisitions = core.contended = 0
        core.wait_s = core.hold_s = 0.0
        core._pub = {"acq": 0, "cont": 0, "wait": 0.0, "hold": 0.0}
    with locks._table_mu:
        locks._slow_conf["t"] = 0.0
    reset_elastic()
    LAST_BUCKET_DECISION.clear()
    cache = get_device_cache()
    for tag in list(cache._external):
        cache.release_external(tag)


def reset_jax_state() -> None:
    """The JAX package's conf, elastic state and device-budget
    reservations, as its serving tests reset them, and the process state
    its server's report reads: the utilization timeline and the pod
    observatory's last pass report (`_totals["pod"]`, which any JAX fused
    or statistics pass earlier in the process leaves behind; the port has
    no pod observatory)."""
    from spark_rapids_ml_tpu.config import reset_config, set_config
    from spark_rapids_ml_tpu.parallel.device_cache import get_device_cache
    from spark_rapids_ml_tpu.resilience.elastic import reset_elastic
    from spark_rapids_ml_tpu.telemetry import utilization
    from spark_rapids_ml_tpu.telemetry.fleet import reset_fleet

    reset_config()
    set_config(retry_backoff_s=0.01, retry_jitter=0.0)
    reset_elastic()
    utilization.clear()
    reset_fleet()
    cache = get_device_cache()
    for tag in list(cache._external):
        cache.release_external(tag)


def rows(rng, n=1, d=D):
    return rng.normal(size=(n, d)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def port_pca(seed: int = 7):
    from spark_rapids_ml_torch import set_default_device
    from spark_rapids_ml_torch.feature import PCA

    set_default_device("cpu")
    X = np.random.default_rng(seed).normal(size=(300, D)).astype(np.float32)
    return PCA(k=3).setInputCol("features").setOutputCol("proj").fit({"features": X})


@functools.lru_cache(maxsize=None)
def port_logreg(seed: int = 7):
    from spark_rapids_ml_torch import set_default_device
    from spark_rapids_ml_torch.classification import LogisticRegression

    set_default_device("cpu")
    X = np.random.default_rng(seed + 1).normal(size=(300, D)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return LogisticRegression(maxIter=25).fit({"features": X, "label": y})


@functools.lru_cache(maxsize=None)
def jax_and_port_models(seed: int = 5):
    """{name: (JAX model, port model)}: a PCA, a binary and a 3-class
    LogisticRegression and a KMeans, fitted by the JAX package on rows made
    from a numpy seed and carried into the port by convert.py."""
    import pandas as pd

    from spark_rapids_ml_torch import convert
    from spark_rapids_ml_tpu.classification import LogisticRegression
    from spark_rapids_ml_tpu.clustering import KMeans
    from spark_rapids_ml_tpu.feature import PCA

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, D)).astype(np.float32)
    y2 = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    y3 = (np.digitize(X[:, 0] - 0.4 * X[:, 2], [-0.5, 0.5])).astype(np.float32)
    df = pd.DataFrame({"features": list(X), "label": y2})
    df3 = pd.DataFrame({"features": list(X), "label": y3})
    pca = PCA(k=3).setInputCol("features").setOutputCol("proj").fit(df)
    lr2 = LogisticRegression(maxIter=25).fit(df)
    lr3 = LogisticRegression(maxIter=25).fit(df3)
    km = KMeans(k=4, seed=1).fit(df)
    out = {}
    for name, jm, conv in (
        ("pca", pca, convert.pca_model_from_reference),
        ("lr2", lr2, convert.logreg_model_from_reference),
        ("lr3", lr3, convert.logreg_model_from_reference),
        ("km", km, convert.kmeans_model_from_reference),
    ):
        out[name] = (jm, conv(jm._get_model_attributes(), convert.model_params(jm)))
    return out
