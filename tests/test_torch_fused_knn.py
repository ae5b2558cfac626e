#
# The port's fused distance + top-k (spark_rapids_ml_torch/ops/fused_knn.py)
# and its plain forms (spark_rapids_ml_torch/ops/knn.py) against the JAX
# package: the Pallas kernel in interpret mode, and the XLA blocked and
# double-tiled kernels.  On the CPU the wrapper runs its plain twin; the
# CUDA kernel itself is held against the twin on the card by
# tests/test_torch_fused_knn_cuda.py and by chip_smoke.py.
#
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.config import reset_config, set_config
from spark_rapids_ml_torch.ops import _build
from spark_rapids_ml_torch.ops import fused_knn as fk
from spark_rapids_ml_torch.ops import knn as ko
from spark_rapids_ml_torch.ops.precision import distance_precision, matmul_precision
from spark_rapids_ml_tpu.config import reset_config as jax_reset_config
from spark_rapids_ml_tpu.ops.knn import knn_topk_blocked as jax_blocked
from spark_rapids_ml_tpu.ops.knn import knn_topk_coltiled as jax_coltiled
from spark_rapids_ml_tpu.ops.pallas_knn import fused_topk_sqdist as jax_fused
from spark_rapids_ml_tpu.ops.pallas_knn import knn_topk_fused as jax_knn_topk_fused


@pytest.fixture(autouse=True)
def _cpu_and_clean_config():
    set_default_device("cpu")
    reset_config()
    jax_reset_config()
    yield
    reset_config()
    jax_reset_config()
    set_default_device(None)


def _data(seed, n, d, q, dtype=np.float32, dup=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(dtype)
    if dup:
        X[n // 2 :] = X[: n - n // 2]  # every row twice: exact ties
    Q = rng.normal(size=(q, d)).astype(dtype)
    valid = np.ones(n, dtype)
    valid[-max(1, n // 16) :] = 0.0
    return X, Q, valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# the three shapes of tests/test_pallas_knn.py, plus one with duplicated rows
@pytest.mark.parametrize(
    "n,d,q,k,dup",
    [(700, 24, 130, 7, False), (64, 8, 64, 5, False), (1500, 40, 33, 20, False),
     (600, 16, 40, 9, True)],
)
def test_twin_matches_jax_kernels(n, d, q, k, dup):
    X, Q, valid = _data(n + q, n, d, q, dup=dup)
    ids = np.arange(n, dtype=np.int32)
    d2t, it = fk.fused_topk_sqdist_reference(_t(X), _t(valid), _t(Q), k, bq=64, bn=128)
    d2p, ip = jax_fused(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(Q), k,
                        bq=64, bn=128, interpret=True)
    d2r, ir = jax_blocked(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(ids),
                          jnp.asarray(Q), k=k)
    for d2j, ij in ((d2p, ip), (d2r, ir)):
        np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), atol=1e-4)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_wrapper_on_cpu_is_the_twin_and_never_counts():
    X, Q, valid = _data(3, 300, 12, 20)
    before = fk.LAUNCHES
    d2a, ia = fk.fused_topk_sqdist(_t(X), _t(valid), _t(Q), 6)
    d2b, ib = fk.fused_topk_sqdist_reference(_t(X), _t(valid), _t(Q), 6)
    assert fk.LAUNCHES == before
    assert torch.equal(ia, ib) and torch.equal(d2a, d2b)


def test_twin_tail_when_k_exceeds_valid():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    Q = rng.normal(size=(10, 6)).astype(np.float32)
    valid = np.zeros(300, np.float32)
    valid[:4] = 1.0
    d2, idx = fk.fused_topk_sqdist(_t(X), _t(valid), _t(Q), 7)
    d2, idx = d2.numpy(), idx.numpy()
    assert set(idx[0, :4]) == {0, 1, 2, 3}
    assert (idx[:, 4:] == -1).all() and np.isinf(d2[:, 4:]).all()
    assert np.isfinite(d2[:, :4]).all()
    d2j, ij = jax_fused(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(Q), 7,
                        bq=8, bn=128, interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(ij))
    np.testing.assert_allclose(d2, np.asarray(d2j), atol=1e-4)


def test_twin_global_id_mapping():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(200, 12)).astype(np.float32)
    Q = X[:15]  # self-queries: the nearest id is the row's own global id
    valid = np.ones(200, np.float32)
    gids = np.arange(200, dtype=np.int32) * 3 + 100  # non-contiguous
    d2, ids = fk.knn_topk_fused(_t(X), _t(valid), _t(gids), _t(Q), k=3)
    assert (ids.numpy()[:, 0] == gids[:15]).all()
    np.testing.assert_allclose(d2.numpy()[:, 0], 0.0, atol=1e-4)
    d2j, idj = jax_knn_topk_fused(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(gids),
                                  jnp.asarray(Q), k=3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(idj))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2j), atol=1e-4)


def test_twin_float64_matches_jax_blocked():
    """float64 stays float64 in the port's fused path (the JAX package sends
    float64 to its XLA kernel, so that is the reference here)."""
    X, Q, valid = _data(5, 500, 20, 37, dtype=np.float64)
    ids = np.arange(500, dtype=np.int32)
    d2t, it = fk.fused_topk_sqdist(_t(X), _t(valid), _t(Q), 11)
    assert d2t.dtype == torch.float64
    with jax.enable_x64(True):
        d2r, ir = jax_blocked(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(ids),
                              jnp.asarray(Q), k=11)
        assert d2r.dtype == jnp.float64
        np.testing.assert_allclose(d2t.numpy(), np.asarray(d2r), atol=1e-10)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ir))


def test_twin_beyond_the_jax_width_bound():
    """d = 4100 is past the Pallas kernel's d <= 4096; the port has no bound."""
    X, Q, valid = _data(6, 300, 4100, 9)
    ids = np.arange(300, dtype=np.int32)
    d2t, it = fk.fused_topk_sqdist(_t(X), _t(valid), _t(Q), 5)
    d2r, ir = jax_blocked(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(ids),
                          jnp.asarray(Q), k=5)
    # |d2| ~ 8200 here: 1e-4 absolute is f32 rounding of 4100 products
    np.testing.assert_allclose(d2t.numpy(), np.asarray(d2r), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ir))


@pytest.mark.parametrize("form", ["blocked", "coltiled"])
def test_plain_forms_match_jax(form):
    X, Q, valid = _data(7, 900, 16, 50)
    ids = np.arange(900, dtype=np.int32) + 1000
    args = (_t(X), _t(valid), _t(ids), _t(Q))
    jargs = (jnp.asarray(X), jnp.asarray(valid), jnp.asarray(ids), jnp.asarray(Q))
    if form == "blocked":
        d2t, it = ko.knn_topk_blocked(*args, k=8, block=16)
        d2j, ij = jax_blocked(*jargs, k=8, block=16)
    else:
        d2t, it = ko.knn_topk_coltiled(*args, k=8, block=16, cblock=128)
        d2j, ij = jax_coltiled(*jargs, k=8, block=16, cblock=128)
    np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), atol=1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_coltiled_tail_when_k_exceeds_valid():
    """Past the valid count both packages' double-tiled forms give -1 at
    +inf, as the blocked forms do."""
    X, Q, _ = _data(8, 40, 4, 3)
    valid = np.zeros(40, np.float32)
    valid[:3] = 1.0
    ids = np.arange(40, dtype=np.int32)
    args = (_t(X), _t(valid), _t(ids), _t(Q))
    jargs = (jnp.asarray(X), jnp.asarray(valid), jnp.asarray(ids), jnp.asarray(Q))
    d2t, it = ko.knn_topk_coltiled(*args, k=5, cblock=16)
    d2b, ib = ko.knn_topk_blocked(*args, k=5)
    _, ij = jax_coltiled(*jargs, k=5, cblock=16)
    assert torch.equal(it, ib) and (it.numpy()[:, 3:] == -1).all()
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert np.isinf(d2t.numpy()[:, 3:]).all()


@pytest.mark.parametrize("mode,kernel,decided_by", [
    ("on", "fused_topk_sqdist_reference", "forced"),
    ("auto", "fused_topk_sqdist_reference", "forced"),  # "auto" is "on"
    ("off", "knn_topk_blocked", "config"),
])
def test_dispatch_modes(mode, kernel, decided_by):
    X, Q, valid = _data(9, 400, 10, 30)
    ids = np.arange(400, dtype=np.int32)
    set_config(pallas_knn=mode)
    d2, i = ko.knn_topk_single(_t(X), _t(valid), _t(ids), _t(Q), k=6)
    assert ko.LAST_KERNEL_DECISION == {"kernel": kernel, "decided_by": decided_by}
    d2r, ir = jax_blocked(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(ids),
                          jnp.asarray(Q), k=6)
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2r), atol=1e-4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))


def test_off_routes_big_n_to_coltiled(monkeypatch):
    X, Q, valid = _data(10, 300, 6, 20)
    ids = np.arange(300, dtype=np.int32)
    set_config(pallas_knn="off")
    monkeypatch.setattr(ko, "_BLOCKED_TILE_LIMIT_BYTES", 64)
    d2, i = ko.knn_topk_single(_t(X), _t(valid), _t(ids), _t(Q), k=4)
    assert ko.LAST_KERNEL_DECISION["kernel"] == "knn_topk_coltiled"
    d2b, ib = ko.knn_topk_blocked(_t(X), _t(valid), _t(ids), _t(Q), k=4)
    assert torch.equal(i, ib)
    torch.testing.assert_close(d2, d2b)


def test_unknown_mode_raises():
    set_config(pallas_knn="sometimes")
    X, Q, valid = _data(11, 20, 3, 2)
    with pytest.raises(ValueError, match="pallas_knn"):
        ko.knn_topk_single(_t(X), _t(valid), _t(np.arange(20, dtype=np.int32)), _t(Q), k=2)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "shape", "k", "noncontig"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    X, Q, valid = _data(12, 50, 8, 5)
    items, v, queries, k = _t(X), _t(valid), _t(Q), 3
    if bad == "dtype":
        items, queries = items.to(torch.int32), queries.to(torch.int32)
    elif bad == "mixed":
        queries = queries.double()
    elif bad == "shape":
        queries = queries[:, :4].contiguous()
    elif bad == "k":
        k = 0
    else:
        items = torch.from_numpy(np.asfortranarray(X))
    with pytest.raises((ValueError, TypeError)):
        fk.fused_topk_sqdist(items, v, queries, k)


def test_precision_mapping_is_scoped():
    assert distance_precision() == "highest"
    before = torch.backends.cuda.matmul.allow_tf32
    set_config(distance_precision="default")
    with matmul_precision():
        assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cuda.matmul.allow_tf32 == before
    set_config(distance_precision="high")
    with matmul_precision():
        assert torch.backends.cuda.matmul.allow_tf32 is False
    set_config(distance_precision="fastest")
    with pytest.raises(ValueError, match="distance_precision"):
        distance_precision()


def test_kernel_source_is_found_and_a_missing_nvcc_raises(monkeypatch):
    assert "fused_knn.cu" in _build.all_sources()
    assert _build._target("fused_knn.cu").name.startswith("fused_knn_")
    import shutil

    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_installed_package_builds_into_a_user_cache(tmp_path):
    """Outside a checkout (no pyproject.toml above the package) the kernels
    build under $TORCH_EXTENSIONS_DIR, and the CUDA sources travel with the
    package."""
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    site = tmp_path / "site-packages"
    pkg = Path(fk.__file__).resolve().parents[1]
    shutil.copytree(pkg, site / pkg.name, ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from spark_rapids_ml_torch.ops import _build; "
            "print(_build._BUILD_DIR); print(_build.all_sources())")
    env = {**os.environ, "PYTHONPATH": str(site), "TORCH_EXTENSIONS_DIR": str(tmp_path / "ext")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=tmp_path, check=True, timeout=120).stdout.split("\n")
    assert out[0] == str(tmp_path / "ext" / "spark_rapids_ml_torch")
    assert "fused_knn.cu" in out[1]
    # a source checkout keeps its libraries in its own ignored build directory
    assert _build._BUILD_DIR == pkg.parent / "build" / "torch_ext"


def _beyond_f32(rng, rows, cols):
    # small integers plus multiples of 2^-30: 32 significant bits
    return rng.integers(-3, 4, size=(rows, cols)) + rng.integers(1, 256, size=(rows, cols)) * 2.0**-30


@pytest.mark.parametrize("data", ["normal", "beyond_f32"])
def test_float64_tolerance_rejects_a_float32_body(data):
    """chip_smoke.py holds the float64 kernel to its twin at float64
    precision: another summation order passes, a float32 body does not."""
    import chip_smoke

    rng = np.random.default_rng(13)
    if data == "normal":
        X, Q = rng.normal(size=(900, 40)), rng.normal(size=(30, 40))
    else:
        X, Q = _beyond_f32(rng, 900, 33), _beyond_f32(rng, 30, 33)
    items, queries = _t(X), _t(Q)
    valid = torch.ones(900, dtype=torch.float64)
    d2t, it = fk.fused_topk_sqdist_reference(items, valid, queries, 16)
    d2o, io = fk.fused_topk_sqdist_reference(items, valid, queries, 16, bq=8, bn=64)
    chip_smoke.compare("other blocking", d2o, io, d2t, it, exact=False)
    d2f, i_f = fk.fused_topk_sqdist_reference(items.float(), valid.float(), queries.float(), 16)
    with pytest.raises(AssertionError, match="1e-10"):
        chip_smoke.compare("float32 body", d2f.double(), i_f, d2t, it, exact=False)
