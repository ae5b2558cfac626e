#
# The port's UMAP (spark_rapids_ml_torch/models/umap.py) through its public
# entry points against the JAX package's, on the CPU, on the same numpy
# data.  Held: the initial embedding bit for bit (spectral, random, padded
# spectral, a sample_fraction's rows); the brute-force graph's ids equal
# ties aside, rho and sigma at the precision of the distances; with the JAX
# package's draws handed in (rebuilt from its keys), float64 fits whose
# optimizer inputs equal the JAX fit's (weights within 1e-12) and whose
# optimizer meets the JAX embedding within 1e-9; and with the port's own
# seed, every case of
# tests/test_umap.py at its bar, trustworthiness within 0.03 of the JAX
# model's where that is the measure.  The JAX package runs on one worker,
# its float64 fits inside `jax.enable_x64(True)`.
#
import jax
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.datasets import make_blobs
from sklearn.manifold import trustworthiness

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.config import reset_config, set_config
from spark_rapids_ml_torch.ops import distances as port_distances
from spark_rapids_ml_torch.ops import umap as port_ops
from spark_rapids_ml_torch.umap import UMAP
from spark_rapids_ml_tpu.config import reset_config as jax_reset_config
from spark_rapids_ml_tpu.config import set_config as jax_set_config
from spark_rapids_ml_tpu.ops import distances as jax_distances
from spark_rapids_ml_tpu.umap import UMAP as JaxUMAP

from test_torch_umap_ops import jax_epoch_draws  # noqa: E402


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


@pytest.fixture(scope="module")
def blobs():
    X, y = make_blobs(n_samples=400, n_features=10, centers=5, cluster_std=0.8,
                      random_state=10)
    return X.astype(np.float32), y


def _both(**kw):
    return UMAP(**kw), JaxUMAP(num_workers=1, **kw)


# ---------------------------------------------------------------------------
# against the JAX package, piece by piece
# ---------------------------------------------------------------------------

INITS = {
    "spectral": dict(n_neighbors=10, random_state=3),
    "random": dict(n_neighbors=10, random_state=4, init="random", n_components=3),
    "spectral_padded": dict(n_neighbors=10, random_state=5, n_components=12),
    "sample_fraction": dict(n_neighbors=8, random_state=7, sample_fraction=0.5),
}


@pytest.mark.parametrize("case", sorted(INITS))
def test_initial_embedding_is_jax_bit_for_bit(blobs, case):
    """n_epochs=0 keeps the init: numpy's generator from the same seed, the
    same SVD, so the embeddings (and a sample's rows) are equal bit for
    bit."""
    X, _ = blobs
    port, ref = _both(n_epochs=0, **INITS[case])
    pm, rm = port.fit(X), ref.fit(X)
    np.testing.assert_array_equal(pm.raw_data_, rm.raw_data_)
    np.testing.assert_array_equal(pm.embedding_, rm.embedding_)
    assert pm.embedding_.dtype == rm.embedding_.dtype == np.float32
    assert (pm.a_, pm.b_) == (rm.a_, rm.b_)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan"])
def test_brute_force_graph_matches_jax(blobs, metric):
    """The fit's graph (k + 1 neighbours by brute force, self dropped): ids
    equal but for ties.  rho^2 within 1e-5 of ||x||^2 + max ||x||^2 (the
    terms the matmul identity cancels: the port's float32 kernel is
    3xTF32, the JAX package's IEEE float32; the repo's rule for blobs),
    and sigma, which follows from all k distances, within 1e-4 relative;
    cosine (unit rows) and manhattan (no identity) within 1e-6 / 1e-5."""
    X, _ = blobs
    k = 10
    port, ref = _both(n_neighbors=k, n_epochs=0, metric=metric, random_state=0)
    pm, rm = port.fit(X), ref.fit(X)
    if metric == "euclidean":
        X64 = X.astype(np.float64)
        scale = (X64 * X64).sum(1) + (X64 * X64).sum(1).max()
        assert (np.abs(pm.rho_.astype(np.float64) ** 2 - rm.rho_.astype(np.float64) ** 2)
                <= 1e-5 * scale).all()
        np.testing.assert_allclose(pm.sigma_, rm.sigma_, rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(pm.rho_, rm.rho_, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pm.sigma_, rm.sigma_, rtol=1e-5, atol=1e-5)
    import jax.numpy as jnp

    Xg = port_distances.preprocess_rows(X, metric).astype(np.float32) if metric != "manhattan" \
        else X
    n = X.shape[0]
    pd_, pi = port_distances.umap_knn_graph(
        torch.as_tensor(Xg), torch.ones(n), torch.arange(n, dtype=torch.int32),
        torch.as_tensor(Xg), k=k + 1, metric=metric)
    rd, ri = jax_distances.umap_knn_graph(jnp.asarray(Xg), jnp.ones(n), jnp.arange(n),
                                          jnp.asarray(Xg), k=k + 1, metric=metric)
    pi, ri, rd = pi.numpy()[:, 1:], np.asarray(ri)[:, 1:], np.asarray(rd)[:, 1:]
    diff = np.argwhere(pi != ri)
    assert len(diff) <= pi.size / 200
    X64 = Xg.astype(np.float64)
    for i, j in diff:  # a swap of two neighbours at one distance
        if metric == "manhattan":
            dg, dw = (np.abs(X64[i] - X64[c]).sum() for c in (pi[i, j], ri[i, j]))
            assert abs(dg - dw) <= 1e-5 * max(1.0, dw)
        else:
            dg, dw = (((X64[i] - X64[c]) ** 2).sum() for c in (pi[i, j], ri[i, j]))
            assert abs(dg - dw) <= 1e-5 * ((X64[i] ** 2).sum() + (X64 ** 2).sum(1).max())


def _capture_optimizer_inputs(monkeypatch, module, store: dict, draws=None):
    """Record the arguments a fit hands to `module.optimize_embedding` (and
    hand it `draws`, where given)."""
    real = module.optimize_embedding

    def spy(*args, **kw):
        store["args"] = [a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                         for a in args[:4]] + list(args[4:])
        store["kw"] = dict(kw)
        if draws is not None:
            kw["draws"] = draws
        return real(*args, **kw)

    monkeypatch.setattr(module, "optimize_embedding", spy)


FLOAT64_FITS = {
    "spectral": dict(n_neighbors=10),
    "supervised": dict(n_neighbors=8),
    "cosine": dict(n_neighbors=8, metric="cosine", init="random"),
    "sample_fraction": dict(n_neighbors=8, sample_fraction=0.6),
}


@pytest.mark.parametrize("case", sorted(FLOAT64_FITS))
def test_float64_fit_from_jax_draws_matches_jax(blobs, monkeypatch, case):
    """A whole float64 fit, 6 epochs, the JAX package's draws handed in.
    What the fit hands its optimizer equals the JAX package's: the initial
    embedding and the edge list bit for bit, the weights within 1e-12; the
    port's optimizer on the JAX fit's inputs gives the JAX model's
    embedding within 1e-9 (6 epochs: the last-place differences of exp and
    pow grow about tenfold an epoch; 10 epochs reach 4.5e-8 in one of these
    cases); and the port's whole fit is as trustworthy as
    the JAX model (within 0.01).  The whole fit's embedding is not held
    point by point: an edge is sampled in epoch e when floor((e + 1) f) >
    floor(e f), f = w / max w, and weights 2e-13 apart (the last-place
    differences of torch's and XLA's exp) put an edge of weight 1 - 1 ulp
    on the other side of such a crossing, which moves its points by up to
    the clip of 4 in that epoch."""
    from spark_rapids_ml_tpu.ops import umap as jax_ops

    X, y = blobs
    X = X.astype(np.float64)
    kw = dict(FLOAT64_FITS[case], random_state=11, n_epochs=6, float32_inputs=False)
    data = X
    if case == "supervised":
        yl = y.astype(np.float64)
        yl[::9] = np.nan  # unknown labels
        data = pd.DataFrame({"features": list(X), "label": yl})
        kw["labelCol"] = "label"
    port, ref = _both(**kw)
    if case == "supervised":
        port.setFeaturesCol("features")
        ref.setFeaturesCol("features")
    got, want = {}, {}
    _capture_optimizer_inputs(monkeypatch, jax_ops, want)
    with jax.enable_x64(True):
        rm = ref.fit(data)
        n = rm.raw_data_.shape[0]
        draws = jax_epoch_draws(11, 6, n * kw["n_neighbors"], 5, n)
    _capture_optimizer_inputs(monkeypatch, port_ops, got, draws)
    pm = port.fit(data)
    assert pm.embedding_.dtype == np.float64
    np.testing.assert_array_equal(pm.raw_data_, rm.raw_data_)
    np.testing.assert_allclose(pm.rho_, rm.rho_, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pm.sigma_, rm.sigma_, rtol=1e-12, atol=1e-12)
    (e_p, h_p, t_p, w_p), (e_j, h_j, t_j, w_j) = got["args"][:4], want["args"][:4]
    np.testing.assert_array_equal(e_p, e_j)
    np.testing.assert_array_equal(h_p, h_j)
    np.testing.assert_array_equal(t_p, t_j)
    np.testing.assert_allclose(w_p, w_j, rtol=1e-12, atol=1e-12)
    assert got["args"][4:] == want["args"][4:] and got["kw"] == want["kw"]
    # the port's optimizer from the JAX fit's inputs and draws
    emb = port_ops.optimize_embedding(*(torch.as_tensor(np.array(a)) for a in (e_j, h_j, t_j, w_j)),
                                      *want["args"][4:], draws=draws, **want["kw"])
    np.testing.assert_allclose(emb.numpy(), rm.embedding_, rtol=1e-9, atol=1e-9)
    Xt = pm.raw_data_
    if case == "cosine":
        Xt = Xt / np.linalg.norm(Xt, axis=1, keepdims=True)
    t_p = trustworthiness(Xt, pm.embedding_, n_neighbors=8)
    t_j = trustworthiness(Xt, rm.embedding_, n_neighbors=8)
    assert abs(t_p - t_j) <= 0.01, (t_p, t_j)


# ---------------------------------------------------------------------------
# tests/test_umap.py's cases, with the port's own seed
# ---------------------------------------------------------------------------


def _trust_pair(X, kw, n_neighbors, Xt=None):
    """Trustworthiness of the port's and the JAX package's embeddings of
    one fit's Params."""
    port, ref = _both(**kw)
    pm, rm = port.fit(X), ref.fit(X)
    Xt = X if Xt is None else Xt
    return (trustworthiness(Xt, pm.embedding_, n_neighbors=n_neighbors),
            trustworthiness(Xt, rm.embedding_, n_neighbors=n_neighbors), pm)


TRUST_CASES = {
    # name: (Params, trustworthiness k, bar)
    "fit_embedding_trustworthy": (dict(n_neighbors=12, random_state=0, n_epochs=150), 12, 0.85),
    "random_init_and_components": (dict(n_components=3, init="random", n_neighbors=8,
                                        random_state=1, n_epochs=80), 8, 0.8),
    "cosine_metric": (dict(metric="cosine", n_neighbors=8, random_state=2, n_epochs=60), 8,
                      0.75),
    "nn_descent_matches_brute": (dict(n_neighbors=10, random_state=0, n_epochs=100,
                                      build_algo="nn_descent",
                                      build_kwds={"nnd_graph_degree": 24,
                                                  "nnd_max_iterations": 6}), 10, 0.95),
}


@pytest.mark.parametrize("case", sorted(TRUST_CASES))
def test_trustworthiness_is_jaxs(blobs, case):
    X, _ = blobs
    kw, tk, bar = TRUST_CASES[case]
    Xt = X / np.linalg.norm(X, axis=1, keepdims=True) if kw.get("metric") == "cosine" else X
    t_port, t_jax, pm = _trust_pair(X, kw, tk, Xt)
    assert pm.embedding_.shape == (400, kw.get("n_components", 2))
    assert t_port > bar, f"trustworthiness {t_port}"
    assert abs(t_port - t_jax) <= 0.03, (t_port, t_jax)


def test_structured_kernel_full_fit_quality(blobs):
    """The structured form forced through the whole fit on the CPU meets
    the generic form's bar."""
    X, _ = blobs
    set_config(umap_kernel="structured")
    model = UMAP(n_neighbors=12, random_state=0, n_epochs=150).fit(X)
    assert port_ops.LAST_KERNEL_DECISION["kernel"] == "structured"
    assert trustworthiness(X, model.embedding_, n_neighbors=12) > 0.85


def test_blob_separation(blobs):
    from scipy.spatial.distance import pdist

    X, y = blobs
    emb = UMAP(n_neighbors=10, random_state=0, n_epochs=200).fit(X).embedding_
    centroids = np.stack([emb[y == c].mean(axis=0) for c in range(5)])
    spread = np.stack([emb[y == c].std(axis=0).mean() for c in range(5)])
    assert pdist(centroids).min() > 2.0 * spread.mean()


def test_transform_new_points(blobs):
    X, y = blobs
    model = UMAP(n_neighbors=10, random_state=0, n_epochs=100).fit(X[:300])
    out = model.transform(pd.DataFrame({"features": list(X[300:])}))
    emb_new = np.stack(out["embedding"].to_numpy())
    assert emb_new.shape == (100, 2)
    train_emb = model.embedding_
    for c in range(5):
        tr = train_emb[y[:300] == c].mean(axis=0)
        nw = emb_new[y[300:] == c].mean(axis=0)
        assert np.linalg.norm(tr - nw) < 3.0


def test_sample_fraction(blobs):
    X, _ = blobs
    model = UMAP(n_neighbors=8, sample_fraction=0.5, random_state=7, n_epochs=60).fit(X)
    assert 120 < model.raw_data_.shape[0] < 280
    assert model.embedding_.shape[0] == model.raw_data_.shape[0]


def _overlapping(rng, n=150):
    X = np.concatenate([rng.normal(0.0, 1.0, size=(n, 6)),
                        rng.normal(0.4, 1.0, size=(n, 6))]).astype(np.float32)
    return X, np.concatenate([np.zeros(n), np.ones(n)])


def test_supervised_umap_improves_separation(rng):
    n = 150
    X, y = _overlapping(rng, n)
    df = pd.DataFrame({"features": list(X), "label": y})

    def sep(emb):
        a, b = emb[:n], emb[n:]
        inter = np.linalg.norm(a.mean(0) - b.mean(0))
        intra = 0.5 * (a.std(0).mean() + b.std(0).mean())
        return inter / max(intra, 1e-9)

    common = dict(n_neighbors=10, random_state=5, n_epochs=100)
    m_uns = UMAP(**common).setFeaturesCol("features").fit(df)
    m_sup = UMAP(**common).setFeaturesCol("features").setLabelCol("label").fit(df)
    assert sep(m_sup.embedding_) > 2.0 * sep(m_uns.embedding_)


def test_supervised_umap_unknown_labels(rng):
    X = rng.normal(size=(120, 5)).astype(np.float32)
    y = rng.integers(0, 3, size=120).astype(np.float64)
    y[::7] = np.nan
    df = pd.DataFrame({"features": list(X), "label": y})
    m = (UMAP(n_neighbors=8, random_state=2, n_epochs=50)
         .setFeaturesCol("features").setLabelCol("label").fit(df))
    assert np.isfinite(m.embedding_).all()


def test_supervised_umap_regression_target_rejected(rng):
    X = rng.normal(size=(60, 4)).astype(np.float32)
    df = pd.DataFrame({"features": list(X), "label": rng.normal(size=60)})
    est = (UMAP(n_neighbors=5, target_metric="euclidean")
           .setFeaturesCol("features").setLabelCol("label"))
    with pytest.raises(ValueError, match="target_metric"):
        est.fit(df)


def test_umap_manhattan_fit_transform():
    from sklearn.metrics import silhouette_score

    X, y = make_blobs(n_samples=600, n_features=8, centers=4, random_state=2)
    model = UMAP(n_neighbors=10, n_epochs=50, random_state=0, metric="manhattan").fit(
        X.astype(np.float32))
    emb = model._transform_array(X.astype(np.float32))[model.getOrDefault("outputCol")]
    assert emb.shape == (600, 2)
    assert silhouette_score(emb, y) > 0.3


def test_umap_minkowski_kwds(rng):
    X = rng.normal(size=(300, 5)).astype(np.float32)
    model = UMAP(n_neighbors=8, n_epochs=20, random_state=0, metric="minkowski",
                 metric_kwds={"p": 3}).fit(X)
    emb = model._transform_array(X[:10])[model.getOrDefault("outputCol")]
    assert emb.shape == (10, 2)


def test_build_algo_nn_descent_elementwise_metric_falls_back(blobs, caplog):
    X, _ = blobs
    m = UMAP(n_neighbors=8, random_state=0, n_epochs=50, metric="manhattan",
             build_algo="nn_descent").fit(X)
    assert m.embedding_.shape == (len(X), 2)
    from spark_rapids_ml_torch.models import umap as port_models

    assert port_models.LAST_FIT["graph"] == "brute_force_knn"


def test_bad_params(blobs):
    X, _ = blobs
    with pytest.raises(ValueError, match="n_neighbors"):
        UMAP(n_neighbors=1000).fit(X)
    with pytest.raises(ValueError, match="not supported"):
        UMAP(metric="mahalanobis")
    with pytest.raises(ValueError, match="not supported"):
        UMAP(init="pca")
    with pytest.raises(ValueError):
        UMAP(build_algo="hnsw").fit(X)
    with pytest.raises(NotImplementedError, match=r"item \(8\)"):
        UMAP(num_workers=2).fit(X)


def test_estimator_save_load_roundtrips_build_params(tmp_path, blobs):
    est = UMAP(n_neighbors=6, build_algo="nn_descent",
               build_kwds={"nnd_graph_degree": 12, "nnd_max_iterations": 4})
    path = str(tmp_path / "umap_est")
    est.save(path)
    loaded = UMAP.load(path)
    assert loaded._tpu_params["build_algo"] == "nn_descent"
    assert loaded._tpu_params["build_kwds"] == {"nnd_graph_degree": 12,
                                               "nnd_max_iterations": 4}
    X, _ = blobs
    assert loaded.fit(X).embedding_.shape == (len(X), 2)


def test_auto_epochs_and_conf_follow_jax(blobs):
    """The auto epochs (500 up to 10,000 rows), the umap_kernel conf in both
    packages, and the fit's parts recorded."""
    from spark_rapids_ml_torch.models import umap as port_models

    X, _ = blobs
    set_config(umap_kernel="generic")
    jax_set_config(umap_kernel="generic")
    UMAP(n_neighbors=5, random_state=0).fit(X[:60])
    assert port_models.LAST_FIT["n_epochs"] == 500
    assert port_ops.LAST_KERNEL_DECISION["kernel"] == "generic"
    parts = {"sample", "stage", "knn_graph", "smooth_knn_dist", "fuzzy_set",
             "find_ab_params", "init", "sgd"}
    assert parts <= set(port_models.LAST_FIT)


def test_chip_smokes_trustworthiness_is_scikit_learns(blobs):
    """chip_smoke.py's own trustworthiness (the card has no scikit-learn)
    equals scikit-learn's."""
    import chip_smoke

    X, _ = blobs
    emb = UMAP(n_neighbors=10, random_state=0, n_epochs=30).fit(X).embedding_
    for k in (5, 15):
        got = chip_smoke.trustworthiness(X, emb, k, torch.device("cpu"))
        assert got == pytest.approx(trustworthiness(X, emb, n_neighbors=k), abs=1e-12)
