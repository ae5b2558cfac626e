#
# The port's UMAP ops (spark_rapids_ml_torch/ops/umap.py) against the JAX
# package's (spark_rapids_ml_tpu/ops/umap.py) on the same numpy inputs, on
# the CPU: find_ab_params bit for bit; smooth_knn_dist within 1e-5
# (float32) / 1e-12 (float64); fuzzy_simplicial_set, categorical_intersection
# and transform_init within 1e-6 / 1e-12, on random kNN lists (many edges
# without a reverse) and on a real graph.  `jax.random` cannot be
# reproduced in torch, so the JAX package's negative samples are rebuilt
# from its keys (PRNGKey(seed), then one `split` an epoch) and handed to
# the port's `draws=`: one epoch of each form then agrees within 1e-5 /
# 1e-12, the whole float64 optimizer over 10 epochs within 1e-9, and each
# of 30 float64 epochs from the JAX package's state within 1e-12 (a free
# run of 30 epochs is chaotic: see the tests).  Besides: the structured epoch
# equals the generic one bit for bit on the CPU, the result does not depend
# on how the epochs are split, and optimize_embedding's bookkeeping follows
# the JAX package's (the forced modes, the prior, the measured probe).
#
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.config import reset_config, set_config
from spark_rapids_ml_torch.ops import umap as port
from spark_rapids_ml_tpu.config import reset_config as jax_reset_config
from spark_rapids_ml_tpu.config import set_config as jax_set_config
from spark_rapids_ml_tpu.ops import umap as ref

DTYPES = ["float32", "float64"]
TOL = {"float32": 1e-6, "float64": 1e-12}


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


def _jax(dtype):
    """The JAX package in float64 only inside enable_x64."""
    return jax.enable_x64(dtype == "float64")


def _random_graph(n=300, k=8, seed=0):
    """Random neighbour lists (most edges have no reverse) with ascending
    distances."""
    rng = np.random.default_rng(seed)
    inds = np.stack([rng.choice(np.delete(np.arange(n), i), size=k, replace=False)
                     for i in range(n)]).astype(np.int32)
    dists = np.sort(rng.uniform(0.1, 3.0, (n, k)), axis=1)
    return inds, dists


def _blob_graph(n=300, k=8, seed=0):
    """A real kNN graph (self excluded) of blobs, by brute force in
    float64."""
    X, _ = make_blobs(n_samples=n, n_features=6, centers=4, random_state=seed)
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(2)
    order = np.argsort(d2, axis=1, kind="stable")[:, 1 : k + 1]
    return order.astype(np.int32), np.sqrt(np.take_along_axis(d2, order, axis=1))


GRAPHS = {"random": _random_graph, "blobs": _blob_graph}


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("spread,min_dist", [(1.0, 0.1), (1.0, 0.0), (2.0, 0.5)])
def test_find_ab_params_is_jax_bit_for_bit(spread, min_dist):
    assert port.find_ab_params(spread, min_dist) == ref.find_ab_params(spread, min_dist)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lc", [1, 2])
def test_smooth_knn_dist_matches_jax(graph, dtype, lc):
    _, dists = GRAPHS[graph]()
    dists = dists.astype(dtype)
    with _jax(dtype):
        r_rho, r_sigma = (np.asarray(v) for v in ref.smooth_knn_dist(jnp.asarray(dists),
                                                                      local_connectivity=lc))
    rho, sigma = port.smooth_knn_dist(_t(dists), local_connectivity=lc)
    tol = 1e-5 if dtype == "float32" else 1e-12
    assert rho.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(rho.numpy(), r_rho)
    np.testing.assert_allclose(sigma.numpy(), r_sigma, rtol=tol, atol=tol)


def _fuzzy_inputs(graph, dtype):
    inds, dists = GRAPHS[graph]()
    dists = dists.astype(dtype)
    with _jax(dtype):
        rho, sigma = (np.asarray(v) for v in ref.smooth_knn_dist(jnp.asarray(dists)))
    return inds, dists, rho, sigma


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mix", [1.0, 0.5])
def test_fuzzy_simplicial_set_matches_jax(graph, dtype, mix):
    inds, dists, rho, sigma = _fuzzy_inputs(graph, dtype)
    with _jax(dtype):
        rh, rt, rw = (np.asarray(v) for v in ref.fuzzy_simplicial_set(
            jnp.asarray(inds), jnp.asarray(dists), jnp.asarray(rho), jnp.asarray(sigma),
            set_op_mix_ratio=mix))
    h, t, w = port.fuzzy_simplicial_set(_t(inds), _t(dists), _t(rho), _t(sigma),
                                        set_op_mix_ratio=mix)
    np.testing.assert_array_equal(h.numpy(), rh)
    np.testing.assert_array_equal(t.numpy(), rt)
    assert w.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(w.numpy(), rw, rtol=TOL[dtype], atol=TOL[dtype])
    # both kinds of edge are there: with and without a reverse
    n, k = inds.shape
    has_rev = (inds[inds.reshape(-1)] == np.repeat(np.arange(n), k)[:, None]).any(1)
    assert has_rev.any() and (~has_rev).any()


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("target_weight", [0.5, 1.0])
def test_categorical_intersection_matches_jax(graph, dtype, target_weight):
    inds, dists, rho, sigma = _fuzzy_inputs(graph, dtype)
    n = inds.shape[0]
    labels = np.random.default_rng(1).integers(-1, 3, n).astype(np.int32)  # -1: unknown
    far = 2.5 / (1.0 - target_weight) if target_weight < 1.0 else 1.0e12
    with _jax(dtype):
        h, t, w = ref.fuzzy_simplicial_set(jnp.asarray(inds), jnp.asarray(dists),
                                           jnp.asarray(rho), jnp.asarray(sigma))
        want = np.asarray(ref.categorical_intersection(jnp.asarray(inds), h, t, w,
                                                       jnp.asarray(labels), far_dist=far))
        h, t, w = (np.asarray(v) for v in (h, t, w))
    got = port.categorical_intersection(_t(inds), _t(h), _t(t), _t(w), _t(labels),
                                        far_dist=far)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_transform_init_matches_jax(dtype):
    rng = np.random.default_rng(2)
    n, q, k = 200, 50, 7
    inds = rng.integers(0, n, (q, k)).astype(np.int32)
    dists = np.sort(rng.uniform(0.0, 2.0, (q, k)), axis=1).astype(dtype)
    rho = rng.uniform(0.0, 0.5, n).astype(dtype)
    sigma = rng.uniform(0.1, 1.0, n).astype(dtype)
    emb = rng.normal(size=(n, 2)).astype(dtype)
    with _jax(dtype):
        want = np.asarray(ref.transform_init(*(jnp.asarray(a) for a in (inds, dists, rho,
                                                                         sigma, emb))))
    got = port.transform_init(_t(inds), _t(dists), _t(rho), _t(sigma), _t(emb))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# the SGD epochs from the JAX package's draws
# ---------------------------------------------------------------------------


def jax_epoch_draws(seed: int, n_epochs: int, E: int, nsr: int, n: int):
    """The JAX package's negative samples of epochs 0..n_epochs-1:
    PRNGKey(seed), then `key, sub = split(key)` and randint(sub, (E, nsr),
    0, n) each epoch."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (E, nsr), 0, n)))
    return out


def _edge_problem(dtype, n=400, k=10, seed=3):
    """A head-major edge list with weights of a real fuzzy set (blobs,
    400 x 10 as tests/test_umap.py) and an initial embedding."""
    X, _ = make_blobs(n_samples=n, n_features=10, centers=5, cluster_std=0.8,
                      random_state=10)
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(2)
    inds = np.argsort(d2, axis=1, kind="stable")[:, 1 : k + 1].astype(np.int32)
    dists = np.sqrt(np.take_along_axis(d2, inds, axis=1)).astype(dtype)
    with _jax(dtype):
        rho, sigma = ref.smooth_knn_dist(jnp.asarray(dists))
        h, t, w = (np.asarray(v) for v in ref.fuzzy_simplicial_set(jnp.asarray(inds),
                                                                   jnp.asarray(dists), rho,
                                                                   sigma))
    emb0 = np.random.default_rng(seed).uniform(-10, 10, (n, 2)).astype(dtype)
    return h, t, w, emb0


A, B = 1.5769434603113077, 0.8950608779109733  # find_ab_params(1.0, 0.1)


def _jax_one_epoch(structured, emb0, h, t, w, key, e_start, n_epochs, nsr=5):
    n = emb0.shape[0]
    k = h.shape[0] // n
    args = (A, B, 1.0)
    if structured:
        tails = jnp.asarray(t)
        perm = jnp.argsort(tails)
        out, _ = ref._optimize_epoch_chunk_structured(
            jnp.asarray(emb0), key, tails.reshape(n, k), jnp.asarray(w).reshape(n, k), perm,
            tails[perm], e_start, 1, n_epochs, *args, k, nsr, 1.0)
    else:
        out, _ = ref._optimize_epoch_chunk(jnp.asarray(emb0), key, jnp.asarray(h),
                                           jnp.asarray(t), jnp.asarray(w), e_start, 1,
                                           n_epochs, *args, nsr, 1.0)
    return np.asarray(out)


def _port_epochs(emb0, h, t, w, n_epochs, draws, e_start=0, e_count=1, structured=False,
                 seed=0):
    state = port._Epochs(_t(emb0), _t(h), _t(t), _t(w), seed, n_epochs, A, B, 1.0, 5, 1.0,
                         draws)
    state.prepare_structured()
    state.run(e_start, e_count, structured)
    return state.emb.numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("structured", [False, True], ids=["generic", "structured"])
@pytest.mark.parametrize("e_start", [0, 17])
def test_one_epoch_from_jax_draws_matches_jax(dtype, structured, e_start):
    with _jax(dtype):
        h, t, w, emb0 = _edge_problem(dtype)
        n, E = emb0.shape[0], h.shape[0]
        key = jax.random.PRNGKey(5)
        want = _jax_one_epoch(structured, emb0, h, t, w, key, e_start, 50)
        _, sub = jax.random.split(key)
        neg = np.asarray(jax.random.randint(sub, (E, 5), 0, n))
    got = _port_epochs(emb0, h, t, w, 50, lambda e: neg, e_start=e_start,
                       structured=structured)
    tol = 1e-5 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert not np.array_equal(got, emb0)


def test_structured_equals_generic_first_epoch_bit_for_bit():
    """tests/test_umap.py's check of the JAX package, on the port: one
    epoch of the structured form is the generic form's bit for bit."""
    rng = np.random.default_rng(11)
    n, k = 500, 8
    knn = np.stack([rng.choice(n, size=k, replace=False) for _ in range(n)]).astype(np.int32)
    heads = np.repeat(np.arange(n, dtype=np.int32), k)
    w = rng.uniform(0.1, 1.0, n * k).astype(np.float32)
    emb0 = rng.normal(size=(n, 2)).astype(np.float32)
    neg = jax_epoch_draws(3, 1, n * k, 5, n)
    out_s = _port_epochs(emb0, heads, knn.reshape(-1), w, 50, neg, structured=True)
    out_g = _port_epochs(emb0, heads, knn.reshape(-1), w, 50, neg, structured=False)
    np.testing.assert_array_equal(out_s, out_g)
    assert not np.array_equal(out_s, emb0)


@pytest.mark.parametrize("mode", ["generic", "structured"])
def test_optimizer_from_jax_draws_float64_matches_jax(mode):
    """The whole optimizer from the JAX package's draws, float64, 400 x 10:
    10 epochs end within 1e-9 of the JAX package's.  The two differ by one
    unit in the last place where torch's and XLA's exp and pow round
    otherwise, and the SGD amplifies that about tenfold an epoch at these
    learning rates (measured: 9e-16 after epoch 0, 4.6e-11 after 10, order
    1 after 19 of 30), so longer runs are held epoch by epoch below."""
    n_epochs = 10
    with jax.enable_x64(True):
        h, t, w, emb0 = _edge_problem("float64")
        jax_set_config(umap_kernel=mode)
        want = np.asarray(ref.optimize_embedding(jnp.asarray(emb0), jnp.asarray(h),
                                                 jnp.asarray(t), jnp.asarray(w), 4, n_epochs,
                                                 A, B, 1.0))
        draws = jax_epoch_draws(4, n_epochs, h.shape[0], 5, emb0.shape[0])
    set_config(umap_kernel=mode)
    got = port.optimize_embedding(_t(emb0), _t(h), _t(t), _t(w), 4, n_epochs, A, B, 1.0,
                                  draws=draws)
    assert port.LAST_KERNEL_DECISION == {"kernel": mode, "decided_by": "forced",
                                         "warm_epoch_sec_generic": None,
                                         "warm_epoch_sec_structured": None}
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("structured", [False, True], ids=["generic", "structured"])
def test_every_epoch_of_30_from_jax_state_matches_jax(structured):
    """Each of 30 float64 epochs (the learning-rate schedule, the activity
    of every edge, the JAX draws of that epoch), run by the port from the
    JAX package's embedding of the epoch before: within 1e-12 of the JAX
    package's next embedding."""
    n_epochs = 30
    with jax.enable_x64(True):
        h, t, w, emb0 = _edge_problem("float64")
        n, k = emb0.shape[0], h.shape[0] // emb0.shape[0]
        draws = jax_epoch_draws(4, n_epochs, h.shape[0], 5, n)
        key, emb = jax.random.PRNGKey(4), jnp.asarray(emb0)
        tails = jnp.asarray(t)
        perm = jnp.argsort(tails)
        for e in range(n_epochs):
            if structured:
                nxt, key = ref._optimize_epoch_chunk_structured(
                    emb, key, tails.reshape(n, k), jnp.asarray(w).reshape(n, k), perm,
                    tails[perm], e, 1, n_epochs, A, B, 1.0, k, 5, 1.0)
            else:
                nxt, key = ref._optimize_epoch_chunk(emb, key, jnp.asarray(h), tails,
                                                     jnp.asarray(w), e, 1, n_epochs, A, B,
                                                     1.0, 5, 1.0)
            got = _port_epochs(np.asarray(emb), h, t, w, n_epochs, draws, e_start=e,
                               structured=structured)
            np.testing.assert_allclose(got, np.asarray(nxt), rtol=1e-12, atol=1e-12,
                                       err_msg=f"epoch {e}")
            emb = nxt


@pytest.mark.parametrize("split", [[1, 29], [6, 7, 17], [1] * 30])
def test_result_does_not_depend_on_the_split_of_epochs(split):
    """The generator (or the draws) carries across runs of epochs, so any
    split of the 30 epochs, and any form per part, gives one result: the
    same emb as one run, bit for bit in float64 up to the form's sums."""
    h, t, w, emb0 = _edge_problem("float64")
    whole = _port_epochs(emb0, h, t, w, 30, None, e_count=30, seed=9)
    state = port._Epochs(_t(emb0), _t(h), _t(t), _t(w), 9, 30, A, B, 1.0, 5, 1.0, None)
    done = 0
    for count in split:
        state.run(done, count, False)
        done += count
    np.testing.assert_array_equal(state.emb.numpy(), whole)


def test_optimize_embedding_bookkeeping_follows_jax():
    """The port's twin of tests/test_umap.py's
    test_umap_kernel_auto_probes_by_measurement: the measured probe, the
    forced modes, the n_epochs < 10 prior, deterministic fits, a list that
    is not head-major, and n_epochs = 0."""
    rng = np.random.default_rng(7)
    n, k = 400, 6
    knn = np.stack([rng.choice(n, size=k, replace=False) for _ in range(n)]).astype(np.int32)
    heads = _t(np.repeat(np.arange(n, dtype=np.int32), k))
    tails = _t(knn.reshape(-1))
    w = _t(rng.uniform(0.1, 1.0, n * k).astype(np.float32))
    emb0 = _t(rng.normal(size=(n, 2)).astype(np.float32))

    def run(epochs, **kw):
        return port.optimize_embedding(emb0, heads, tails, w, 0, epochs, A, B, 1.0, **kw)

    set_config(umap_kernel="auto")
    run(20)
    dec = port.LAST_KERNEL_DECISION
    assert dec["decided_by"] in ("measured", "measured-tie-platform-prior")
    tg, ts = dec["warm_epoch_sec_generic"], dec["warm_epoch_sec_structured"]
    assert tg is not None and ts is not None
    if dec["decided_by"] == "measured":
        assert dec["kernel"] == ("structured" if ts < tg else "generic")
    else:  # the prior on the CPU, as the JAX package's CPU choice
        assert dec["kernel"] == "generic"
    # the probe's six epochs are the fit's first six: three generic, three
    # structured, then the chosen form
    probed = run(20)
    state = port._Epochs(emb0, heads, tails, w, 0, 20, A, B, 1.0, 5, 1.0, None)
    state.prepare_structured()
    state.run(0, 3, False)
    state.run(3, 3, True)
    state.run(6, 14, port.LAST_KERNEL_DECISION["kernel"] == "structured")
    np.testing.assert_array_equal(probed.numpy(), state.emb.numpy())

    set_config(umap_kernel="generic")
    run(20)
    assert port.LAST_KERNEL_DECISION["decided_by"] == "forced"
    assert port.LAST_KERNEL_DECISION["kernel"] == "generic"
    set_config(umap_kernel="structured")
    run(20)
    assert port.LAST_KERNEL_DECISION["kernel"] == "structured"

    set_config(umap_kernel="auto")
    run(4)
    assert port.LAST_KERNEL_DECISION["decided_by"] == "platform-prior"
    assert port.LAST_KERNEL_DECISION["kernel"] == "generic"
    assert port.LAST_KERNEL_DECISION["warm_epoch_sec_generic"] is None

    out_a = run(20, deterministic=True)
    assert port.LAST_KERNEL_DECISION["decided_by"] == "random-state-platform-prior"
    np.testing.assert_array_equal(out_a.numpy(), run(20, deterministic=True).numpy())

    # heads and tails swapped: not head-major, never structured
    set_config(umap_kernel="structured")
    port.optimize_embedding(emb0, tails, heads, w, 0, 20, A, B, 1.0)
    assert port.LAST_KERNEL_DECISION["decided_by"] == "structure-missing"
    assert port.LAST_KERNEL_DECISION["kernel"] == "generic"

    # no epochs: the initial embedding verbatim, as the JAX package
    assert run(0) is emb0
    set_config(umap_kernel="fastest")
    with pytest.raises(ValueError, match="umap_kernel"):
        run(20)


def test_jax_draws_of_the_structured_form_are_the_generic_forms():
    """The JAX package's structured epoch draws (n, k, nsr) from the key the
    generic one draws (E, nsr) from: the same numbers, so one list of draws
    serves both forms of the port."""
    key = jax.random.PRNGKey(1)
    a = np.asarray(jax.random.randint(key, (60, 5), 0, 17))
    b = np.asarray(jax.random.randint(key, (12, 5, 5), 0, 17))
    np.testing.assert_array_equal(a.reshape(12, 5, 5), b)
