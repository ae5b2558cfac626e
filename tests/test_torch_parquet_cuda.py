#
# The fits from parquet on the card against the same fits on the CPU: the
# staged route (stage_parquet with its pinned buffers, side-stream copies
# and parallel range readers), the fused pass from parquet, the streamed
# statistics and the epoch-streaming LogisticRegression and KMeans, in
# float64 within 1e-9; and a card out of memory while staging, which sends
# the fit to the streamed route.  Every test here needs a CUDA device and
# skips without one.  This file imports no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_parquet_cuda.py
#
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch import streaming
from spark_rapids_ml_torch.classification import LogisticRegression
from spark_rapids_ml_torch.clustering import KMeans
from spark_rapids_ml_torch.feature import PCA
from spark_rapids_ml_torch.regression import LinearRegression

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    port_config.reset_config()
    yield torch.device("cuda")
    set_default_device(None)
    port_config.reset_config()


def _file(tmp_path, seed=0, n=20000, d=12, classes=2):
    """A parquet file of n x d float64 rows (FixedSizeList, row groups of
    2,500 rows), integer labels and weights in [0.25, 2]."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(size=d)
    W = rng.normal(size=(classes, d))
    y = np.argmax(X @ W.T + 0.5 * rng.normal(size=(n, classes)), axis=1).astype(np.float64)
    w = rng.choice([0.25, 0.5, 1.0, 1.5, 2.0], size=n)
    path = str(tmp_path / f"cuda_{seed}.parquet")
    pq.write_table(pa.table({
        "features": pa.FixedSizeListArray.from_arrays(pa.array(X.reshape(-1)), d),
        "label": pa.array(y), "wt": pa.array(w)}), path, row_group_size=2500)
    return path, X, y, w


def _blobs_file(tmp_path, n=20000, d=12, k=4):
    """Four blobs far apart, so that any seeding ends at the same centres:
    the card's generator seeds other centres than the CPU's."""
    rng = np.random.default_rng(4)
    centres = rng.normal(size=(k, d)) * 20.0
    X = centres[rng.integers(0, k, n)] + rng.normal(size=(n, d))
    w = rng.choice([0.25, 0.5, 1.0, 1.5, 2.0], size=n)
    path = str(tmp_path / "blobs.parquet")
    pq.write_table(pa.table({
        "features": pa.FixedSizeListArray.from_arrays(pa.array(X.reshape(-1)), d),
        "wt": pa.array(w)}), path, row_group_size=2500)
    return path


def _on(device, make, path, **confs):
    """The model of `make().fit(path)` on `device`, under `confs`."""
    set_default_device(device)
    port_config.reset_config()
    port_config.set_config(host_batch_bytes=1 << 18, **confs)
    return make().fit(path)


_FITS = {
    "PCA": (lambda: PCA(k=3, float32_inputs=False).setInputCol("features"), "components_"),
    "LinearRegression": (lambda: LinearRegression(regParam=0.01, float32_inputs=False)
                         .setWeightCol("wt"), "coef_"),
    "LogisticRegression": (lambda: LogisticRegression(regParam=0.01, tol=1e-10, maxIter=40,
                                                      float32_inputs=False)
                           .setWeightCol("wt"), "coef_"),
    "KMeans": (lambda: KMeans(k=4, seed=3, maxIter=30, float32_inputs=False)
               .setWeightCol("wt"), "cluster_centers_"),
}
_ROUTES = {
    "staged_parquet": {"fused_stage_solve": "off"},
    "fused_parquet": {"fused_stage_solve": "on", "fused_parquet_readers": 3},
    "streamed": {"force_streaming_stats": True},
}


@pytest.mark.parametrize("route", sorted(_ROUTES))
@pytest.mark.parametrize("name", sorted(_FITS))
def test_parquet_fit_on_the_card_matches_the_cpu(cuda_device, tmp_path, name, route):
    if route == "fused_parquet" and name not in ("PCA", "LinearRegression"):
        pytest.skip("only PCA and LinearRegression have a fused pass")
    path = _blobs_file(tmp_path) if name == "KMeans" else _file(tmp_path, seed=1)[0]
    make, key = _FITS[name]
    card = _on(cuda_device, make, path, **_ROUTES[route])
    assert card.fit_report()["route"] == route
    cpu = _on("cpu", make, path, **_ROUTES[route])
    assert cpu.fit_report()["route"] == route
    a, b = getattr(card, key), getattr(cpu, key)
    if name == "KMeans":
        # the same blobs, in the order each generator seeded them
        a, b = (c[np.lexsort(c.T[::-1])] for c in (a, b))
        np.testing.assert_allclose(card.inertia_, cpu.inertia_, rtol=1e-9)
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-11)
    if name == "LogisticRegression":
        assert card.num_iters == cpu.num_iters
        np.testing.assert_allclose(card.objective, cpu.objective, rtol=1e-9)


@pytest.mark.parametrize("readers", [1, 4])
def test_stage_parquet_on_the_card_equals_the_file(cuda_device, tmp_path, readers):
    path, X, y, w = _file(tmp_path, seed=2)
    port_config.set_config(host_batch_bytes=1 << 16, fused_parquet_readers=readers)
    ds = streaming.stage_parquet(path, label_col="label", weight_col="wt", dtype=np.float64,
                                 device=cuda_device)
    assert ds.X.is_cuda and ds.n_valid == len(y)
    np.testing.assert_array_equal(ds.X.cpu().numpy(), X)
    np.testing.assert_array_equal(ds.y.cpu().numpy(), y)
    np.testing.assert_array_equal(ds.weight.cpu().numpy(), w)
    assert streaming.LAST_STAGE["readers"] == (1 if readers == 1 else 4)


def test_out_of_memory_while_staging_takes_the_streamed_fit(cuda_device, tmp_path):
    """Fill the card so that staging the file cannot fit: the fit lands on
    the streamed route, records the fallback, and equals the forced
    streamed fit."""
    n, d = 200_000, 64
    path = _file(tmp_path, seed=3, n=n, d=d)[0]

    def make():
        return LogisticRegression(regParam=0.01, maxIter=20, float32_inputs=False)

    set_default_device(cuda_device)
    port_config.set_config(host_batch_bytes=1 << 19, force_streaming_stats=True)
    want = make().fit(path)
    port_config.set_config(force_streaming_stats=False)
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(cuda_device)
    fill = []
    # leave a quarter of the staged rows' 102 MB: far more than the
    # streamed fit's chunks of 1,024 rows take
    leave = n * d * 8 // 4
    block = 1 << 28
    while free - block > leave:
        fill.append(torch.empty(block, dtype=torch.uint8, device=cuda_device))
        free, _ = torch.cuda.mem_get_info(cuda_device)
    rest = free - leave
    if rest > 0:
        fill.append(torch.empty(rest, dtype=torch.uint8, device=cuda_device))
    try:
        m = make().fit(path)
    finally:
        del fill
        torch.cuda.empty_cache()
    rep = m.fit_report()
    assert rep["route"] == "streamed" and rep["oom_fallback"] is True
    np.testing.assert_allclose(m.coef_, want.coef_, rtol=1e-9, atol=1e-11)
