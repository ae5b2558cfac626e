#
# The port's UMAP on CSR rows and its persistence, on the CPU: a CSR fit
# and transform equal the dense ones of the same rows (the staged device
# matrix is the same, so bit for bit), the CSR init follows the JAX
# package's (random bit for bit; the spectral Gram within 1e-4, since it
# sums float32 products in another order), the spectral init's 4096-column
# cap warns and falls back as the JAX package does, `stage_sparse` applies
# the metric's row transform chunk by chunk, and models saved by either
# package load in the other (dense and CSR) and transform to the same
# output within 1e-6; `convert.py`'s pair carries a model both ways.
#
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.config import reset_config
from spark_rapids_ml_torch.convert import (
    model_params,
    umap_model_from_reference,
    umap_model_to_reference_attributes,
)
from spark_rapids_ml_torch.parallel.mesh import RowStager
from spark_rapids_ml_torch.umap import UMAP, UMAPModel
from spark_rapids_ml_tpu.config import reset_config as jax_reset_config
from spark_rapids_ml_tpu.umap import UMAP as JaxUMAP
from spark_rapids_ml_tpu.umap import UMAPModel as JaxUMAPModel


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are small: one intra-op thread runs them
    faster than torch's default, and leaves the cores to the other test
    workers (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _cpu_and_clean_config():
    set_default_device("cpu")
    reset_config()
    jax_reset_config()
    yield
    reset_config()
    jax_reset_config()
    set_default_device(None)


def _make_sparse(n=500, d=24, density=0.3, seed=42):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[rng.random((n, d)) < 1.0 - density] = 0.0
    return sp.csr_matrix(X), X


def _kw(**kw):
    kw.setdefault("n_neighbors", 10)
    kw.setdefault("n_epochs", 30)
    kw.setdefault("random_state", 7)
    kw.setdefault("init", "random")
    return kw


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "jaccard"])
def test_csr_fit_and_transform_equal_dense(metric):
    csr, X = _make_sparse()
    m_s = UMAP(**_kw(metric=metric)).fit(csr)
    m_d = UMAP(**_kw(metric=metric)).fit(X)
    assert sp.issparse(m_s.raw_data_)
    np.testing.assert_array_equal(m_s.embedding_, m_d.embedding_)
    np.testing.assert_array_equal(m_s.transform(csr[:60]), m_d.transform(X[:60]))
    # a CSR query against dense training rows, and the reverse
    np.testing.assert_array_equal(m_d.transform(csr[:60]), m_s.transform(X[:60]))


def test_csr_supervised_equals_dense():
    csr, X = _make_sparse()
    y = (np.asarray(csr.sum(axis=1)).ravel() > 0).astype(np.float64)
    emb_s = UMAP(**_kw(labelCol="label")).fit((csr, y)).embedding_
    emb_d = UMAP(**_kw(labelCol="label")).fit((X, y)).embedding_
    np.testing.assert_array_equal(emb_s, emb_d)


def test_csr_init_follows_jax():
    """Random init bit for bit; the spectral init from the chunked Gram
    (float32 products summed on the device in another order than XLA's)
    within 1e-4 on its scale of 10."""
    csr, _ = _make_sparse()
    rnd = dict(n_epochs=0, n_neighbors=10, random_state=3, init="random")
    np.testing.assert_array_equal(UMAP(**rnd).fit(csr).embedding_,
                                  JaxUMAP(num_workers=1, **rnd).fit(csr).embedding_)
    spec = dict(rnd, init="spectral")
    got = UMAP(**spec).fit(csr).embedding_
    want = JaxUMAP(num_workers=1, **spec).fit(csr).embedding_
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(want).max() > 9.9


def test_sparse_pca_basis_chunks_by_host_batch_bytes():
    """The spectral Gram of CSR rows in chunks of `host_batch_bytes`: the
    same basis from one chunk and from many."""
    from spark_rapids_ml_torch.config import set_config
    from spark_rapids_ml_torch.models.umap import _sparse_pca_basis_project

    csr, X = _make_sparse(n=2500)
    one = _sparse_pca_basis_project(csr, 2, np.float32, torch.device("cpu"))
    set_config(host_batch_bytes=8 * 1024)  # 1024-row chunks
    many = _sparse_pca_basis_project(csr, 2, np.float32, torch.device("cpu"))
    np.testing.assert_allclose(many, one, rtol=1e-4, atol=1e-4)
    Xc = X.astype(np.float64) - X.mean(axis=0)
    _, _, vt = np.linalg.svd(Xc, full_matrices=False)
    ref = Xc @ vt[:2].T
    signs = np.sign((ref * one).sum(0))  # the basis up to each axis' sign
    np.testing.assert_allclose(one * signs, ref, rtol=1e-3, atol=1e-3)


def test_spectral_cap_warns_and_takes_random_init(monkeypatch):
    """Above 4096 columns a CSR fit's spectral init would need a d x d
    Gram: the fit warns and takes the random init, as the JAX package."""
    rng = np.random.default_rng(0)
    n, d = 60, 4100
    csr = sp.random(n, d, density=0.01, format="csr", random_state=1, dtype=np.float32)
    csr = csr + sp.csr_matrix((rng.normal(size=n).astype(np.float32),
                               (np.arange(n), np.arange(n))), shape=(n, d))
    kw = dict(n_epochs=0, n_neighbors=5, random_state=2, init="spectral")
    est, warned = UMAP(**kw), []
    monkeypatch.setattr(est.logger, "warning", warned.append)
    got = est.fit(csr)
    assert len(warned) == 1 and "4100x4100 Gram" in warned[0] and "feature cap" in warned[0]
    want = JaxUMAP(num_workers=1, **kw).fit(csr)
    np.testing.assert_array_equal(got.embedding_, want.embedding_)


def test_stage_sparse_applies_the_row_transform_by_chunk(monkeypatch):
    from spark_rapids_ml_torch.ops.distances import preprocess_rows
    from spark_rapids_ml_torch.parallel import mesh

    csr, X = _make_sparse(n=300)
    monkeypatch.setattr(mesh, "_CHUNK_BYTES", 24 * 4 * 64)  # 64-row chunks
    seen = []

    def tf(c):
        seen.append(c.shape[0])
        return preprocess_rows(c, "cosine")

    got = RowStager(300, torch.device("cpu")).stage_sparse(csr, np.float32, row_transform=tf)
    assert max(seen) == 64 and sum(seen) == 300
    np.testing.assert_array_equal(got.numpy(), preprocess_rows(X, "cosine").astype(np.float32))


def _fits(sparse: bool):
    csr, X = _make_sparse(n=300)
    data = csr if sparse else X
    kw = _kw(n_neighbors=8, n_epochs=20)
    return UMAP(**kw).fit(data), JaxUMAP(num_workers=1, **kw).fit(data), X


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_save_load_both_directions(tmp_path, sparse):
    port_m, jax_m, X = _fits(sparse)
    # the JAX package's model, loaded by the port
    jax_m.save(str(tmp_path / "jax"))
    loaded = UMAPModel.load(str(tmp_path / "jax"))
    assert sp.issparse(loaded.raw_data_) == sparse
    np.testing.assert_array_equal(loaded.embedding_, jax_m.embedding_)
    np.testing.assert_allclose(loaded.transform(X[:50]), jax_m.transform(X[:50]),
                               rtol=1e-6, atol=1e-6)
    # the port's model, loaded by the JAX package
    port_m.save(str(tmp_path / "port"))
    back = JaxUMAPModel.load(str(tmp_path / "port"))
    assert sp.issparse(back.raw_data_) == sparse
    np.testing.assert_array_equal(back.embedding_, port_m.embedding_)
    np.testing.assert_allclose(back.transform(X[:50]), port_m.transform(X[:50]),
                               rtol=1e-6, atol=1e-6)
    # the port's own round trip is bit-equal
    again = UMAPModel.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(again.embedding_, port_m.embedding_)
    np.testing.assert_array_equal(again.transform(X[:50]), port_m.transform(X[:50]))
    assert again._tpu_params == port_m._tpu_params


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_convert_pair_round_trips(sparse):
    port_m, jax_m, X = _fits(sparse)
    from_jax = umap_model_from_reference(jax_m._get_model_attributes(), model_params(jax_m))
    np.testing.assert_allclose(from_jax.transform(X[:50]), jax_m.transform(X[:50]),
                               rtol=1e-6, atol=1e-6)
    attrs = umap_model_to_reference_attributes(port_m)
    to_jax = JaxUMAPModel(**attrs)
    to_jax._tpu_params = dict(port_m._tpu_params)
    np.testing.assert_allclose(to_jax.transform(X[:50]), port_m.transform(X[:50]),
                               rtol=1e-6, atol=1e-6)
    again = umap_model_from_reference(attrs, model_params(port_m))
    np.testing.assert_array_equal(again.transform(X[:50]), port_m.transform(X[:50]))


def test_model_errors_follow_jax():
    port_m, _, X = _fits(False)
    with pytest.raises(NotImplementedError, match="umap-learn"):
        port_m.cpu()
    port_m._tpu_params["n_neighbors"] = 1000
    with pytest.raises(ValueError, match="exceeds"):
        port_m.transform(X[:5])
