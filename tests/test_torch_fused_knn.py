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
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.config import reset_config, set_config
from spark_rapids_ml_torch.knn import NearestNeighbors
from spark_rapids_ml_torch.ops import _build
from spark_rapids_ml_torch.ops import fused_knn as fk
from spark_rapids_ml_torch.ops import knn as ko
from spark_rapids_ml_torch.ops.precision import distance_precision, matmul_precision
from spark_rapids_ml_tpu.config import reset_config as jax_reset_config
from spark_rapids_ml_tpu.knn import NearestNeighbors as JaxNearestNeighbors
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


def test_build_target_hashes_every_file_under_csrc(tmp_path):
    """A changed header a source includes names a new library, so an edited
    .cuh never loads a stale build."""
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// one\n")
    first = _build._target("k.cu", tmp_path)
    assert first == _build._target("k.cu", tmp_path) and first.name.startswith("k_")
    (tmp_path / "k.cuh").write_text("// two\n")
    assert _build._target("k.cu", tmp_path) != first


def _bits(t):
    return t.view(torch.int32)


def test_split_reference_hand_made_cases():
    """tf32 rounds to 10 mantissa bits, ties away from zero; lo is formed
    from the ROUNDED hi (wgmma reads only the top 19 bits of a value)."""
    e = 2.0**-11
    x = torch.tensor([[1.0, 1 + e, 1 + e / 2, -(1 + e), 1 + e + 2.0**-20]])
    hi, lo = fk.tf32_split_reference(x, 32)
    assert hi[0, :5].tolist() == [1.0, 1 + 2 * e, 1.0, -(1 + 2 * e), 1 + 2 * e]
    assert lo[0, :5].tolist() == [0.0, -e, e / 2, e, -e + 2.0**-20]
    assert (hi[0, 5:] == 0).all() and (lo[0, 5:] == 0).all()  # the pad


def test_split_reference_reconstructs_x():
    """hi + lo equals x within tf32(lo)'s rounding, both halves are TF32
    values (13 low bits clear) and the pad is zero."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(300, 37)) * 10.0 ** rng.integers(-20, 20, size=(300, 37))
    xt = _t(x.astype(np.float32))
    hi, lo = fk.tf32_split_reference(xt, 64)
    assert ((_bits(hi) & 0x1FFF) == 0).all() and ((_bits(lo) & 0x1FFF) == 0).all()
    assert (hi[:, 37:] == 0).all() and (lo[:, 37:] == 0).all()
    x64 = xt.double().numpy()
    h64, l64 = hi[:, :37].double().numpy(), lo[:, :37].double().numpy()
    assert (np.abs(x64 - h64) <= np.abs(x64) * 2.0**-11).all()
    assert (np.abs(x64 - h64 - l64) <= np.abs(x64 - h64) * 2.0**-11).all()


def test_merge_reference_hand_made_case():
    """Two rows of three lists: ties across lists go to the lower position,
    d^2 = max(score + ||q||^2, 0), +inf / -1 past the real entries."""
    inf = float("inf")
    part_d = torch.tensor([[[1.0, 2.0, inf], [1.0, 1.5, 3.0], [0.5, 2.0, 2.0]],
                           [[-2.0, inf, inf], [inf, inf, inf], [inf, inf, inf]]])
    part_i = torch.tensor([[[0, 5, -1], [70, 71, 72], [130, 131, 140]],
                           [[3, -1, -1], [-1, -1, -1], [-1, -1, -1]]], dtype=torch.int32)
    d2, ids = fk.merge_partials_reference(part_d, part_i, torch.tensor([1.0, 1.0]), 3)
    assert d2.tolist() == [[1.5, 2.0, 2.0], [0.0, inf, inf]]
    assert ids.tolist() == [[130, 0, 70], [3, -1, -1]]
    before = fk.MERGE_LAUNCHES
    assert torch.equal(fk.merge_partials(part_d, part_i, torch.tensor([1.0, 1.0]), 3)[1], ids)
    assert fk.MERGE_LAUNCHES == before


@pytest.mark.parametrize("n,splits", [(1, 1), (64, 5), (700, 3), (700, 7), (5000, 7),
                                      (1_000_000, 14)])
def test_split_plan_covers_the_items(n, splits):
    bounds = fk.split_bounds(n, splits)
    assert bounds[0][0] == 0 and bounds[-1][1] == n and len(bounds) <= splits
    assert all(hi > lo for lo, hi in bounds)  # no empty split
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(lo % 64 == 0 for lo, _ in bounds)  # whole tiles of the kernel


def test_auto_splits_fills_whole_waves():
    """On 132 SMs, one block each at a time: 10k queries (79 query blocks)
    take 5 splits, 395 blocks in just under 3 waves; query blocks that fill
    the card alone take 1; one query block takes the most; the item count
    and the (q, S, k) scratch cap S."""
    assert fk.auto_splits(1_000_000, 10_000, 32, 132) == 5
    assert fk.auto_splits(1_000_000, 100_000, 32, 132) == 1
    assert fk.auto_splits(1_000_000, 1, 10, 132) == fk._MAX_SPLITS
    assert fk.auto_splits(1500, 130, 32, 132) == 1  # 24 tiles, 16 a split at least
    assert fk.auto_splits(1_000_000, 10_000, 4000, 132) == 1  # 320 MB at S = 1 already


@pytest.mark.parametrize("splits", [1, 3, 7])
def test_twin_splits_match_the_jax_kernel(splits):
    """Every row twice, 448 positions apart, so exact ties straddle the
    split boundaries (every 320 items at 3 splits, 128 at 7): the lower
    position must win across splits as within one."""
    X, Q, valid = _data(31, 896, 24, 130, dup=True)
    assert len(fk.split_bounds(896, splits)) == splits
    d2t, it = fk.fused_topk_sqdist(_t(X), _t(valid), _t(Q), 9, splits=splits)
    d2p, ip = jax_fused(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(Q), 9,
                        bq=64, bn=128, interpret=True)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ip))
    np.testing.assert_allclose(d2t.numpy(), np.asarray(d2p), atol=1e-4)


def _kernel_path_emulated(X, v, Q, k, splits, passes=3):
    """The float32 card path run by its plain versions on the CPU: the
    split pass, the main kernel's 3xTF32 products (or 1xTF32 with the lo
    halves zeroed, passes=1) and the merge pass."""
    d_pad = fk.padded_width(X.shape[1])
    xsplit, qsplit = fk.tf32_split(X, d_pad), fk.tf32_split(Q, d_pad)
    if passes == 1:
        xsplit[1], qsplit[1] = 0.0, 0.0
    part_d, part_i = fk.fused_knn_tf32(xsplit, qsplit, fk.padded_item_norms(X, v),
                                       X.shape[0], k, splits or 1)
    return fk.merge_partials(part_d, part_i, (Q * Q).sum(dim=1), k)


def _phase2_float32_cases():
    import chip_smoke

    return [c for c in chip_smoke.phase2_cases(0) if c[5] == "float32"]


@pytest.mark.parametrize("case", range(len(_phase2_float32_cases())))
def test_3xtf32_emulation_passes_chip_smoke_against_jax(case):
    """3xTF32 (hi.hi + hi.lo + lo.hi, float32 sums) meets chip_smoke's
    float32 tolerances against the JAX package's XLA kNN on phase 2's data,
    and the exact-ties cases stay bit-exact (integers give lo = 0)."""
    import chip_smoke

    name, X, v, Q, k, _, exact, splits = _phase2_float32_cases()[case]
    Xt, vt, Qt = (_t(np.asarray(a, np.float32)) for a in (X, v, Q))
    before = fk.LAUNCHES
    kd, ki = _kernel_path_emulated(Xt, vt, Qt, k, splits)
    assert fk.LAUNCHES == before
    ids = np.arange(X.shape[0], dtype=np.int32)
    jd, ji = jax_blocked(*(jnp.asarray(np.asarray(a, np.float32)) for a in (X, v)),
                         jnp.asarray(ids), jnp.asarray(np.asarray(Q, np.float32)), k=k)
    chip_smoke.compare(name, kd, ki, _t(np.array(jd)), _t(np.array(ji)), exact)


def test_1xtf32_emulation_fails_chip_smoke():
    """The counterpart: one TF32 pass (10-bit mantissas) misses the
    tolerance on phase 2's normal data, so chip_smoke would catch a kernel
    that dropped the lo halves."""
    import chip_smoke

    name, X, v, Q, k, _, _, splits = _phase2_float32_cases()[0]
    Xt, vt, Qt = (_t(np.asarray(a, np.float32)) for a in (X, v, Q))
    td, ti = fk.fused_topk_sqdist_reference(Xt, vt, Qt, k)
    kd, ki = _kernel_path_emulated(Xt, vt, Qt, k, splits)
    chip_smoke.compare(name + " 3xTF32", kd, ki, td, ti, exact=False)
    kd, ki = _kernel_path_emulated(Xt, vt, Qt, k, splits, passes=1)
    with pytest.raises(AssertionError, match="d2 differs beyond|id slots"):
        chip_smoke.compare(name + " 1xTF32", kd, ki, td, ti, exact=False)


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


def _tie_data(seed, n, d, q):
    """Integer rows repeated every n/2 positions: exact ties straddle the
    split boundaries."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-3, 4, size=(n, d)).astype(np.float64)
    X[n // 2 :] = X[: n - n // 2]
    return X, rng.integers(-3, 4, size=(q, d)).astype(np.float64), np.ones(n)


def _f64_path_on_cpu(X, v, Q, k, splits):
    """The float64 card path run by its plain versions: the main kernel's
    partial lists, then the merge pass."""
    Xt, vt, Qt = _t(X), _t(v), _t(Q)
    xs = fk.padded_item_norms(Xt, vt)
    before = (fk.LAUNCHES_F64, fk.MERGE_LAUNCHES)
    part_d, part_i = fk.fused_knn_f64(Xt, Qt, xs, k, splits)
    out = fk.merge_partials(part_d, part_i, (Qt * Qt).sum(dim=1), k)
    assert (fk.LAUNCHES_F64, fk.MERGE_LAUNCHES) == before  # the CPU never counts
    return part_d, part_i, out


@pytest.mark.parametrize("splits,d,data,k", [
    (1, 17, "normal", 12), (3, 17, "normal", 200), (7, 33, "normal", 200),
    (3, 33, "ties", 40), (7, 17, "ties", 150),
])
def test_f64_plain_versions_match_jax_blocked(splits, d, data, k):
    """fused_knn_f64_reference + merge_partials_reference in float64 against
    JAX knn_topk_blocked under x64.  896 items in 3 or 7 splits hold 320 or
    128 items each, so k = 150 and 200 exceed a split's items."""
    if data == "ties":
        X, Q, valid = _tie_data(splits + d, 896, d, 50)
    else:
        X, Q, valid = _data(splits + d, 896, d, 50, dtype=np.float64)
    part_d, _, (d2t, it) = _f64_path_on_cpu(X, valid, Q, k, splits)
    assert part_d.shape == (50, splits, k) and d2t.dtype == torch.float64
    with jax.enable_x64(True):
        d2r, ir = jax_blocked(jnp.asarray(X), jnp.asarray(valid),
                              jnp.asarray(np.arange(896, dtype=np.int32)), jnp.asarray(Q), k=k)
        d2r, ir = np.asarray(d2r), np.asarray(ir)
    np.testing.assert_array_equal(it.numpy(), ir)
    fin = np.isfinite(d2r)
    assert np.array_equal(fin, np.isfinite(d2t.numpy()))
    tol = 1e-10 * np.maximum(1.0, np.abs(d2r[fin]))
    assert (np.abs(d2t.numpy()[fin] - d2r[fin]) <= tol).all()


def _apply_shared_bound(part_d, part_i, k, strict):
    """What the float64 kernel's splits do with the score-only bound: each
    row's bound is the least k-th SCORE of its full lists; a split drops
    entries with a score above it (strict) or, wrongly, at or above it."""
    full = part_i[:, :, k - 1] >= 0
    kth = torch.where(full, part_d[:, :, k - 1], float("inf"))
    pub = kth.min(dim=1, keepdim=True).values[:, :, None]
    drop = (part_d > pub) if strict else (part_d >= pub)
    own = kth[:, :, None] == pub  # a split keeps its own list whole
    drop &= ~own
    d = torch.where(drop, float("inf"), part_d)
    i = torch.where(drop, -1, part_i)
    srt, order = torch.sort(d, dim=2, stable=True)
    return srt, torch.gather(i, 2, order)


def test_f64_shared_bound_drops_only_strictly_greater_scores():
    """A hand-made row, k = 2: split 0 (positions 0, 1) scores 2, 3;
    split 1 (positions 5, 6) scores 1, 2.  The true top 2 is (1, 5), (2, 0):
    the tie at score 2 goes to position 0.  Split 1's k-th score, 2, bounds
    the row; dropping split 0's entries at >= 2 loses position 0."""
    inf = float("inf")
    part_d = torch.tensor([[[2.0, 3.0], [1.0, 2.0]]], dtype=torch.float64)
    part_i = torch.tensor([[[0, 1], [5, 6]]], dtype=torch.int32)
    q2 = torch.zeros(1, dtype=torch.float64)
    want = fk.merge_partials_reference(part_d, part_i, q2, 2)
    assert want[1].tolist() == [[5, 0]]
    kept = fk.merge_partials_reference(*_apply_shared_bound(part_d, part_i, 2, True), q2, 2)
    assert torch.equal(kept[0], want[0]) and torch.equal(kept[1], want[1])
    lost = fk.merge_partials_reference(*_apply_shared_bound(part_d, part_i, 2, False), q2, 2)
    assert lost[1].tolist() == [[5, 6]] and lost[0].tolist() != [[inf, inf]]


@pytest.mark.parametrize("data", ["normal", "ties"])
def test_f64_shared_bound_keeps_the_merged_top_k(data):
    """On whole partial lists, dropping every score strictly above the
    least full k-th score of the row leaves the merged top-k unchanged."""
    if data == "ties":
        X, Q, valid = _tie_data(41, 1024, 17, 30)
    else:
        X, Q, valid = _data(41, 1024, 17, 30, dtype=np.float64)
    part_d, part_i, want = _f64_path_on_cpu(X, valid, Q, 16, 4)
    q2 = (_t(Q) * _t(Q)).sum(dim=1)
    cut_d, cut_i = _apply_shared_bound(part_d, part_i, 16, True)
    assert (cut_i < 0).sum() > (part_i < 0).sum()  # the bound does drop entries
    got = fk.merge_partials_reference(cut_d, cut_i, q2, 16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_f64_order_key_is_monotone():
    """The float64 bound's key orders -inf, negatives, -0.0 = +0.0,
    subnormals, normals and +inf as the scores (unsigned order, checked as
    signed after flipping the top bit)."""
    tiny = np.finfo(np.float64).smallest_subnormal
    vals = torch.tensor([-np.inf, -1e308, -2.5, -1.0, -1e-300, -tiny, -0.0, 0.0, tiny, 2 * tiny,
                         1e-300, 1.0, 2.5, 1e308, np.inf], dtype=torch.float64)
    signed = fk.f64_order_key(vals) ^ torch.iinfo(torch.int64).min
    assert (signed[1:] >= signed[:-1]).all()
    assert ((signed[1:] > signed[:-1]) == (vals[1:] > vals[:-1])).all()
    assert signed[6] == signed[7]  # -0.0 and +0.0 share a key
    assert (fk.f64_order_key(vals) != -1).all()  # none is the "no key yet" pattern


def test_auto_splits_float64_block_and_scratch_bound():
    """float64 blocks queries as float32 does (128 a block) and counts
    12-byte scratch entries: at 1000 queries and k = 12000 the (q, S, k)
    scratch is 96 MB a split in float32 (two fit under 256 MB) and 144 MB in
    float64 (one)."""
    assert fk._BQ == 128
    assert fk.auto_splits(1_000_000, 10_000, 32, 132, torch.float64) == 5
    assert fk.auto_splits(1_000_000, 2_000, 32, 132, torch.float64) == 8
    assert fk.auto_splits(1_000_000, 1_000, 12_000, 132) == 2
    assert fk.auto_splits(1_000_000, 1_000, 12_000, 132, torch.float64) == 1
    tps, s = fk.split_plan(200_000, fk.auto_splits(200_000, 2_000, 32, 132, torch.float64))
    assert s == 8 and tps * 64 * s >= 200_000


def test_merge_wrapper_rejects_mixed_types():
    part_d = torch.zeros((2, 3, 4), dtype=torch.float64)
    part_i = torch.full((2, 3, 4), -1, dtype=torch.int32)
    with pytest.raises(TypeError, match="one"):
        fk.merge_partials(part_d, part_i, torch.zeros(2, dtype=torch.float32), 4)
    with pytest.raises(TypeError, match="one"):
        fk.merge_partials(part_d.float(), part_i, torch.zeros(2, dtype=torch.float64), 4)
    d2, ids = fk.merge_partials(part_d, part_i, torch.zeros(2, dtype=torch.float64), 4)
    assert d2.dtype == torch.float64 and (ids == -1).all() and torch.isinf(d2).all()


def _phase2_float64_cases():
    import chip_smoke

    return [c for c in chip_smoke.phase2_cases(0) if c[5] == "float64"]


@pytest.mark.parametrize("case", range(len(_phase2_float64_cases())))
def test_f64_plain_path_passes_chip_smoke_against_jax(case):
    """The float64 card path's plain versions meet chip_smoke's float64
    tolerance against the JAX package's XLA kNN under x64 on phase 2's
    float64 data, the integer cases bit-exact."""
    import chip_smoke

    name, X, v, Q, k, _, exact, splits = _phase2_float64_cases()[case]
    _, _, (kd, ki) = _f64_path_on_cpu(X, v, Q, k, splits or 1)
    with jax.enable_x64(True):
        jd, ji = jax_blocked(jnp.asarray(X), jnp.asarray(v),
                             jnp.asarray(np.arange(X.shape[0], dtype=np.int32)), jnp.asarray(Q),
                             k=k)
        jd, ji = np.array(jd), np.array(ji)
    chip_smoke.compare(name, kd, ki, _t(jd), _t(ji), exact)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("splits,k", [(1, 40), (3, 33), (7, 40), (5, 64)])
def test_merge_slot_rule_matches_plain_version(dtype, splits, k):
    """The rule the merge kernel uses for k > 32, emulated: an entry's slot
    is its index in its list plus, in every other list, the entries before
    its (score, position) key, counting equal keys (the empty slots) only
    in lower lists.  The S * k entries take distinct slots, and the first
    k equal `merge_partials_reference` bit for bit on lists that tie and end
    early."""
    import bisect

    import compare_kernels

    gen = torch.Generator().manual_seed(splits * k)
    part_d, part_i, q2 = compare_kernels.partial_lists(6, splits, k, dtype, "cpu", gen)
    want_d, want_i = fk.merge_partials_reference(part_d, part_i, q2, k)
    keys = [[[(float(d), int(i) & 0xFFFFFFFF) for d, i in zip(part_d[r, t], part_i[r, t])]
             for t in range(splits)] for r in range(6)]
    for r in range(6):
        slots, got_d, got_i = set(), {}, {}
        for t in range(splits):
            for j, key in enumerate(keys[r][t]):
                slot = j + sum(
                    (bisect.bisect_right if u < t else bisect.bisect_left)(keys[r][u], key)
                    for u in range(splits) if u != t)
                slots.add(slot)
                if slot < k:
                    v, vi = part_d[r, t, j], int(part_i[r, t, j])
                    got_d[slot] = float("inf") if vi < 0 else float(torch.clamp_min(v + q2[r], 0))
                    got_i[slot] = vi
        assert slots == set(range(splits * k))
        assert [got_i[j] for j in range(k)] == want_i[r].tolist()
        assert [got_d[j] for j in range(k)] == want_d[r].tolist()


# ---- the small-q kernel's plain version and the route ---------------------------


def _smallq_data(seed, n, d, q, dtype=np.float32):
    """Ragged n (no whole tile of 256 items), invalid items inside the set
    and at the tail, and 40 rows repeated (exact ties)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(dtype)
    X[n // 2 : n // 2 + 40] = X[:40]
    Q = rng.normal(size=(q, d)).astype(dtype)
    valid = np.ones(n, dtype)
    valid[::11] = 0.0
    valid[-30:] = 0.0
    return X, Q, valid


def _held_ties_aside(d2, ids, d2_ref, ids_ref, X, Q, rtol):
    """d^2 within rtol of the reference (relative, absolute below 1); the
    same +inf / -1 tails; where the ids differ, both items lie at the same
    float64 distance from the query within rtol (a tie that the two
    summation orders break differently)."""
    d2, d2_ref = np.asarray(d2, np.float64), np.asarray(d2_ref, np.float64)
    ids, ids_ref = np.asarray(ids), np.asarray(ids_ref)
    assert np.array_equal(ids < 0, ids_ref < 0)
    fin = np.isfinite(d2_ref)
    assert np.array_equal(fin, np.isfinite(d2))
    assert (np.abs(d2[fin] - d2_ref[fin]) <= rtol * np.maximum(1.0, d2_ref[fin])).all()
    rows, cols = np.nonzero(ids != ids_ref)
    X64, Q64 = X.astype(np.float64), Q.astype(np.float64)
    a = ((X64[ids[rows, cols]] - Q64[rows]) ** 2).sum(1)
    b = ((X64[ids_ref[rows, cols]] - Q64[rows]) ** 2).sum(1)
    assert (np.abs(a - b) <= rtol * np.maximum(1.0, b)).all()


@pytest.mark.parametrize("d", [6, 17, 33])
@pytest.mark.parametrize("q", [1, 3, 8, 64])
def test_smallq_plain_version_matches_the_jax_kernel(q, d):
    """The small-q kernel's plain version, its lists merged by the plain
    merge, against the JAX package's Pallas kernel in interpret mode, for
    k = 1, 5, 32 over three item splits.  Tolerance: d^2 within 1e-5
    relative (the two sum q.x in other orders), ids equal except at ties;
    the repeated rows tie exactly in both and go to the lower position."""
    n = 400 + 23 * d + q
    X, Q, valid = _smallq_data(q * 100 + d, n, d, q)
    before = (fk.SMALLQ_LAUNCHES, fk.MERGE_LAUNCHES)
    for k in (1, 5, 32):
        part_d, part_i = fk.fused_knn_smallq(_t(X), _t(valid), _t(Q), k, 3)
        assert part_d.shape == (q, fk.split_plan(n, 3, 256)[1], k)
        d2, ids = fk.merge_partials(part_d, part_i, (_t(Q) * _t(Q)).sum(dim=1), k)
        d2j, ij = jax_fused(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(Q), k,
                            bq=8, bn=128, interpret=True)
        _held_ties_aside(d2.numpy(), ids.numpy(), np.asarray(d2j), np.asarray(ij), X, Q, 1e-5)
    assert (fk.SMALLQ_LAUNCHES, fk.MERGE_LAUNCHES) == before  # the CPU never counts


@pytest.mark.parametrize("data,splits", [("normal", 1), ("integers", 3), ("integers", 7)])
@pytest.mark.parametrize("q", [1, 8, 64])
def test_smallq_plain_version_is_the_twin_bit_for_bit(data, splits, q):
    """Where the arithmetic order is the same the plain version and the
    twin agree bit for bit: one split runs the twin's own tiles; on integer
    rows every product and sum is exact, so any split count gives the
    twin's result, ties across the splits going to the lower position."""
    rng = np.random.default_rng(q + splits)
    if data == "normal":
        X, Q, valid = _smallq_data(q, 1500, 24, q)
    else:
        X = np.tile(rng.integers(-3, 4, size=(256, 17)), (6, 1)).astype(np.float32)
        Q = rng.integers(-3, 4, size=(q, 17)).astype(np.float32)
        valid = np.ones(X.shape[0], np.float32)
        valid[::13] = 0.0
    for k in (1, 5, 32):
        part_d, part_i = fk.fused_knn_smallq_reference(_t(X), _t(valid), _t(Q), k, splits)
        d2, ids = fk.merge_partials_reference(part_d, part_i, (_t(Q) * _t(Q)).sum(dim=1), k)
        d2t, it = fk.fused_topk_sqdist_reference(_t(X), _t(valid), _t(Q), k)
        assert torch.equal(ids, it) and torch.equal(d2, d2t)


def test_route_is_a_function_of_the_shape_and_dtype():
    f32, f64 = torch.float32, torch.float64
    assert fk.route(1, 32, f32) == "fused_knn_smallq"
    assert fk.route(fk._SMALL_Q, 1, f32) == "fused_knn_smallq"
    assert fk.route(fk._SMALL_Q + 1, 32, f32) == "fused_knn_tf32"
    assert fk.route(1, 33, f32) == "fused_knn_tf32"  # k > 32: the register lists end at 32
    assert fk.route(10_000, 32, f32) == "fused_knn_tf32"
    # float64: the small-q kernel's float64 instance up to _SMALL_Q_F64
    # queries and k = 32, the float64 main kernel above either
    assert fk.route(1, 1, f64) == "fused_knn_smallq_f64"
    assert fk.route(8, 32, f64) == "fused_knn_smallq_f64"
    assert fk.route(fk._SMALL_Q_F64, 32, f64) == "fused_knn_smallq_f64"
    assert fk.route(fk._SMALL_Q_F64 + 1, 32, f64) == "fused_knn_f64"
    assert fk.route(1, 33, f64) == "fused_knn_f64"
    assert fk.route(10_000, 1000, f64) == "fused_knn_f64"


def test_smallq_splits_fill_one_wave():
    """One wave of resident blocks over the ceil(q / 64) query blocks, at
    most one split per 256-item tile; the item ranges cover every item in
    whole tiles."""
    assert fk.smallq_splits(1_000_000, 1, 264) == 264
    assert fk.smallq_splits(1_000_000, 64, 132) == 132
    assert fk.smallq_splits(1_000_000, 65, 132) == 66
    assert fk.smallq_splits(1_000_000, 256, 132) == 33
    assert fk.smallq_splits(1000, 1, 264) == 4  # 4 tiles
    assert fk.smallq_splits(1_000_000, 1000, 132) == 8
    assert fk.smallq_splits(1_000_000, 10_000, 132) == 1
    bounds = fk.split_bounds(1_000_000, 264, 256)
    assert bounds[0][0] == 0 and bounds[-1][1] == 1_000_000 and len(bounds) <= 264
    assert all(lo % 256 == 0 and hi > lo for lo, hi in bounds)


@pytest.mark.parametrize("bad", ["float64", "valid_dtype", "k", "width", "noncontig", "empty",
                                 "splits"])
def test_smallq_wrapper_rejects_what_the_kernel_does_not_take(bad):
    X, Q, valid = _smallq_data(1, 300, 8, 4)
    items, v, queries, k, splits = _t(X), _t(valid), _t(Q), 5, 2
    if bad == "float64":
        items, queries = items.double(), queries.double()
    elif bad == "valid_dtype":
        v = v.double()
    elif bad == "k":
        k = 33
    elif bad == "width":
        queries = queries[:, :4].contiguous()
    elif bad == "noncontig":
        items = torch.from_numpy(np.asfortranarray(X))
    elif bad == "empty":
        queries = queries[:0]
    else:
        splits = 0
    with pytest.raises(ValueError):
        fk.fused_knn_smallq(items, v, queries, k, splits)


def test_smallq_route_on_cpu_is_the_twin_and_never_counts():
    """A CPU tensor never launches: the wrapper of the fused function runs
    the twin at every q, and the small-q wrapper its plain version."""
    X, Q, valid = _smallq_data(2, 700, 12, 8)
    before = (fk.LAUNCHES, fk.SMALLQ_LAUNCHES, fk.SPLIT_LAUNCHES, fk.MERGE_LAUNCHES)
    d2a, ia = fk.fused_topk_sqdist(_t(X), _t(valid), _t(Q), 6)
    d2b, ib = fk.fused_topk_sqdist_reference(_t(X), _t(valid), _t(Q), 6)
    assert torch.equal(ia, ib) and torch.equal(d2a, d2b)
    fk.fused_knn_smallq(_t(X), _t(valid), _t(Q), 6, 2)
    assert (fk.LAUNCHES, fk.SMALLQ_LAUNCHES, fk.SPLIT_LAUNCHES, fk.MERGE_LAUNCHES) == before


# ---- the float64 small-q kernel's plain version and the route -------------------


@pytest.mark.parametrize("d", [6, 17, 33])
@pytest.mark.parametrize("q", [1, 3, 8, 64])
def test_smallq_f64_plain_version_matches_jax_blocked(q, d):
    """The float64 small-q kernel's plain version, its lists merged by the
    plain merge, against the JAX package's float64 XLA kNN under x64
    (`knn_topk_blocked`, the path the JAX package sends float64 to), for
    k = 1, 5, 32 over three item splits.  Tolerance: d^2 within 1e-10
    relative (the two sum q.x in other orders), ids equal except at ties;
    the repeated rows tie exactly in both and go to the lower position."""
    n = 400 + 23 * d + q
    X, Q, valid = _smallq_data(q * 100 + d + 7, n, d, q, dtype=np.float64)
    ids = np.arange(n, dtype=np.int32)
    before = (fk.SMALLQ_F64_LAUNCHES, fk.MERGE_LAUNCHES)
    for k in (1, 5, 32):
        part_d, part_i = fk.fused_knn_smallq_f64(_t(X), _t(valid), _t(Q), k, 3)
        assert part_d.shape == (q, fk.split_plan(n, 3, 256)[1], k)
        assert part_d.dtype == torch.float64
        d2, pos = fk.merge_partials(part_d, part_i, (_t(Q) * _t(Q)).sum(dim=1), k)
        with jax.enable_x64(True):
            d2j, ij = jax_blocked(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(ids),
                                  jnp.asarray(Q), k=k)
            d2j, ij = np.asarray(d2j), np.asarray(ij)
        assert d2j.dtype == np.float64
        _held_ties_aside(d2.numpy(), pos.numpy(), d2j, ij, X, Q, 1e-10)
    assert (fk.SMALLQ_F64_LAUNCHES, fk.MERGE_LAUNCHES) == before  # the CPU never counts


@pytest.mark.parametrize("data,splits", [("normal", 1), ("integers", 3), ("integers", 7)])
@pytest.mark.parametrize("q", [1, 8, 64])
def test_smallq_f64_plain_version_is_the_twin_bit_for_bit(data, splits, q):
    """float64 as the float32 test above: one split runs the twin's own
    tiles; on integer rows every product and sum is exact, so any split
    count gives the twin's result, ties across the splits going to the
    lower position."""
    rng = np.random.default_rng(q + splits + 19)
    if data == "normal":
        X, Q, valid = _smallq_data(q + 19, 1500, 24, q, dtype=np.float64)
    else:
        X = np.tile(rng.integers(-3, 4, size=(256, 17)), (6, 1)).astype(np.float64)
        Q = rng.integers(-3, 4, size=(q, 17)).astype(np.float64)
        valid = np.ones(X.shape[0])
        valid[::13] = 0.0
    for k in (1, 5, 32):
        part_d, part_i = fk.fused_knn_smallq_reference(_t(X), _t(valid), _t(Q), k, splits)
        d2, ids = fk.merge_partials_reference(part_d, part_i, (_t(Q) * _t(Q)).sum(dim=1), k)
        d2t, it = fk.fused_topk_sqdist_reference(_t(X), _t(valid), _t(Q), k)
        assert torch.equal(ids, it) and torch.equal(d2, d2t)


@pytest.mark.parametrize("q", [1, 8])
def test_float64_kneighbors_at_small_q_matches_jax(q):
    """NearestNeighbors(float32_inputs=False).kneighbors at the batch sizes
    the route sends to the float64 small-q kernel on the card, against the
    JAX package's estimator (float64 under x64) on the same rows: the same
    ids, distances within 1e-6 relative."""
    rng = np.random.default_rng(190 + q)
    X, Q = rng.normal(size=(900, 24)), rng.normal(size=(q, 24))
    assert fk.route(q, 32, torch.float64) == "fused_knn_smallq_f64"
    items, queries = pd.DataFrame({"features": list(X)}), pd.DataFrame({"features": list(Q)})
    _, _, a = NearestNeighbors(k=32, float32_inputs=False).fit(items).kneighbors(queries)
    with jax.enable_x64(True):
        ref = JaxNearestNeighbors(k=32, float32_inputs=False, num_workers=1).fit(items)
        _, _, b = ref.kneighbors(queries)
    ia, ib = np.stack(a["indices"]), np.stack(b["indices"])
    da, db = np.stack(a["distances"]), np.stack(b["distances"])
    assert ia.shape == ib.shape == (q, 32)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=1e-6)


def test_smallq_splits_of_the_float64_instance():
    """The float64 instance takes 32 queries a block: one wave over
    ceil(q / 32) query blocks."""
    assert fk._SQ_QBLOCK_F64 == 32
    assert fk.smallq_splits(1_000_000, 32, 132, fk._SQ_QBLOCK_F64) == 132
    assert fk.smallq_splits(1_000_000, 33, 132, fk._SQ_QBLOCK_F64) == 66
    assert fk.smallq_splits(1_000_000, 64, 132, fk._SQ_QBLOCK_F64) == 66
    assert fk.smallq_splits(1_000_000, 256, 132, fk._SQ_QBLOCK_F64) == 16
    assert fk.smallq_splits(1000, 1, 132, fk._SQ_QBLOCK_F64) == 4  # 4 tiles


@pytest.mark.parametrize("bad", ["float32", "valid_dtype", "k", "width", "noncontig", "empty",
                                 "splits"])
def test_smallq_f64_wrapper_rejects_what_the_kernel_does_not_take(bad):
    X, Q, valid = _smallq_data(1, 300, 8, 4, dtype=np.float64)
    items, v, queries, k, splits = _t(X), _t(valid), _t(Q), 5, 2
    if bad == "float32":
        items, v, queries = items.float(), v.float(), queries.float()
    elif bad == "valid_dtype":
        v = v.float()
    elif bad == "k":
        k = 33
    elif bad == "width":
        queries = queries[:, :4].contiguous()
    elif bad == "noncontig":
        items = torch.from_numpy(np.asfortranarray(X))
    elif bad == "empty":
        queries = queries[:0]
    else:
        splits = 0
    with pytest.raises(ValueError):
        fk.fused_knn_smallq_f64(items, v, queries, k, splits)


def test_smallq_f64_route_on_cpu_is_the_twin_and_never_counts():
    """A float64 CPU tensor never launches: the fused function runs the
    twin, and the float64 small-q wrapper its plain version."""
    X, Q, valid = _smallq_data(2, 700, 12, 8, dtype=np.float64)
    before = (fk.LAUNCHES_F64, fk.SMALLQ_F64_LAUNCHES, fk.MERGE_LAUNCHES)
    d2a, ia = fk.fused_topk_sqdist(_t(X), _t(valid), _t(Q), 6)
    d2b, ib = fk.fused_topk_sqdist_reference(_t(X), _t(valid), _t(Q), 6)
    assert d2a.dtype == torch.float64
    assert torch.equal(ia, ib) and torch.equal(d2a, d2b)
    fk.fused_knn_smallq_f64(_t(X), _t(valid), _t(Q), 6, 2)
    assert (fk.LAUNCHES_F64, fk.SMALLQ_F64_LAUNCHES, fk.MERGE_LAUNCHES) == before
