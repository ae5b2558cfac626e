#
# The port's CAGRA-class graph ANN (spark_rapids_ml_torch/ops/cagra.py)
# against the JAX package's on the same numpy inputs, on the CPU.
# `jax.random` cannot be reproduced in torch, so the JAX package's draws
# are rebuilt here from its keys (the same `fold_in` chain as its
# build and search) and handed to the port's `draws=`: one NN-descent round,
# whole builds, one beam step and whole searches must then equal the JAX
# package's, ties aside (two ids at distances within 1e-5 of the norms the
# matmul identity cancels may swap, at fewer than 1 slot in 200).  The
# dedup sort against both JAX branches, the reverse graph's collision rule
# (the last edge in edge order wins a slot, as XLA's scatter keeps on the
# CPU), and, with the port's own seed, graph and search recall within 0.03
# of the JAX package's.
#
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch.config import reset_config
from spark_rapids_ml_torch.ops import cagra as port
from spark_rapids_ml_tpu.config import reset_config as jax_reset_config
from spark_rapids_ml_tpu.ops import cagra as ref


@pytest.fixture(autouse=True)
def _cpu_and_clean_config():
    set_default_device("cpu")
    reset_config()
    jax_reset_config()
    yield
    reset_config()
    jax_reset_config()
    set_default_device(None)


def _blobs(n=500, d=16):
    X, _ = make_blobs(n_samples=n, n_features=d, centers=10, random_state=0)
    return X.astype(np.float32)


def _randint(key, shape, high):
    return np.asarray(jax.random.randint(key, shape, 0, high, jnp.int32))


def jax_round_draws(rkey, n: int, deg: int, sample: int, block: int = 256):
    """One round's draws of the JAX package's `_nn_descent_round` (its
    blocks of `block` rows, the rows past n dropped)."""
    nb = -(-n // block)
    bkeys = [jax.random.fold_in(rkey, b) for b in range(nb)]
    sidx = None
    if sample < 2 * deg:
        sidx = np.concatenate([_randint(jax.random.fold_in(k, 1), (block, sample), 2 * deg)
                               for k in bkeys])[:n]
    rand = np.concatenate([_randint(jax.random.fold_in(k, 2), (block, deg), n)
                           for k in bkeys])[:n]
    return port.RoundDraws(_randint(jax.random.fold_in(rkey, 997), (n, deg), n), sidx, rand)


def jax_build_draws(seed: int, n: int, deg: int, rounds: int, sample: int):
    key = jax.random.PRNGKey(seed)
    return port.BuildDraws(
        _randint(jax.random.fold_in(key, 0), (n, deg), n),
        [jax_round_draws(jax.random.fold_in(key, r + 1), n, deg, sample)
         for r in range(rounds)])


def jax_search_draws(nq: int, n: int, beam: int, deg: int, iters: int):
    key = jax.random.PRNGKey(0)
    return port.SearchDraws(
        _randint(key, (nq, 4 * beam), n),
        [_randint(jax.random.fold_in(key, t), (nq, deg), n) for t in range(iters)])


def assert_same_ids_ties_aside(got, want, X, rows=None):
    """(r, m) neighbour ids equal, except at slots where the two ids sit at
    distances from their row's vector within 1e-5 of ||x||^2 + max ||x||^2
    (the matmul identity's rounding: another summation order may swap two
    such near-ties); such slots are fewer than 1 in 200."""
    got, want = np.asarray(got), np.asarray(want)
    B = (X if rows is None else rows).astype(np.float64)
    diff = np.argwhere(got != want)
    assert len(diff) <= got.size / 200, f"{len(diff)} of {got.size} slots differ"
    X64 = X.astype(np.float64)
    scale = (B * B).sum(1) + (X64 * X64).sum(1).max()
    for i, j in diff:
        dg = ((B[i] - X64[got[i, j]]) ** 2).sum()
        dw = ((B[i] - X64[want[i, j]]) ** 2).sum()
        assert abs(dg - dw) <= 1e-5 * scale[i], (i, j, dg, dw)


def _recall(got, X, Q, k):
    d2 = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(2)
    truth = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.mean([len(set(a) & set(b)) / k for a, b in zip(np.asarray(got), truth)])


@pytest.mark.parametrize("n", [50, 1 << 30])
def test_dedup_sorted_matches_both_jax_branches(n):
    """n = 50 takes the JAX package's packed int32 branch, 2^30 its stable
    pair sort: the port's one packed int64 key gives the result of each."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 50, (6, 40)).astype(np.int32)
    d2 = rng.uniform(0, 10, (6, 40)).astype(np.float32)
    want_d, want_i = ref._dedup_sorted(jnp.asarray(ids), jnp.asarray(d2), n=n)
    got_d, got_i = port._dedup_sorted(torch.from_numpy(ids), torch.from_numpy(d2))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def _jax_reverse(graph, rev_init):
    """The JAX package's reverse-graph scatter (ops/cagra.py
    `_nn_descent_round`), as XLA runs it on the CPU."""
    n, deg = graph.shape
    heads = jnp.repeat(jnp.arange(n, dtype=jnp.int32), deg)
    slot = jnp.abs((heads * jnp.int32(-1640531535)) % deg)
    return np.asarray(jnp.asarray(rev_init).at[jnp.asarray(graph).reshape(-1), slot]
                      .set(heads, mode="drop"))


@pytest.mark.parametrize("n,deg", [(40, 5), (300, 16), (97, 7)])
def test_reverse_graph_collisions_match_xla(n, deg):
    """Every edge into one node (many writers per slot): the last edge in
    edge order wins, as XLA's CPU scatter keeps; unwritten slots keep
    their initial entries."""
    rng = np.random.default_rng(n)
    graph = rng.integers(0, n, (n, deg)).astype(np.int32)
    graph[: n // 2] = 3  # half the rows point only at node 3
    rev_init = rng.integers(0, n, (n, deg)).astype(np.int32)
    got = port.reverse_graph(torch.from_numpy(graph).long(), torch.from_numpy(rev_init).long())
    want = _jax_reverse(graph, rev_init)
    np.testing.assert_array_equal(got.numpy(), want)
    # the rule itself: slot s of node 3 holds the last head hashed to s
    slots = port._knuth_slots(torch.arange(n, dtype=torch.int64), deg).numpy()
    heads_into_3 = np.flatnonzero((graph == 3).any(axis=1))
    for s in range(deg):
        writers = heads_into_3[slots[heads_into_3] == s]
        if writers.size:
            assert got[3, s] == writers.max()


def test_knuth_hash_wraps_as_int32():
    heads = np.array([0, 1, 2, 1_000_000, 2**31 - 1], np.int64)
    want = np.abs((jnp.asarray(heads, jnp.int32) * jnp.int32(-1640531535)) % 32)
    got = port._knuth_slots(torch.from_numpy(heads), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sample", [16, 32])  # sampled join, exhaustive join
def test_one_nn_descent_round_matches_jax(sample):
    X = _blobs()
    n, deg = X.shape[0], 16
    x2 = (X * X).sum(1)
    graph = np.random.default_rng(1).integers(0, n, (n, deg)).astype(np.int32)
    rkey = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    want = ref._nn_descent_round(jnp.asarray(X), jnp.asarray(x2), jnp.asarray(graph), rkey,
                                 deg, 256, 2, sample)
    got = port._nn_descent_round(torch.from_numpy(X), torch.from_numpy(x2),
                                 torch.from_numpy(graph).long(),
                                 jax_round_draws(rkey, n, deg, sample), deg, sample)
    assert_same_ids_ties_aside(got.numpy(), want, X)


def test_build_and_nn_descent_graph_match_jax():
    X = _blobs()
    n, deg, rounds = X.shape[0], 12, 3
    draws = jax_build_draws(0, n, deg, rounds, deg)
    want = np.asarray(ref.build_cagra_graph(jnp.asarray(X), 0, deg=deg, rounds=rounds))
    got = port.build_cagra_graph(torch.from_numpy(X), 0, deg=deg, rounds=rounds, draws=draws)
    assert got.dtype == torch.int32
    assert_same_ids_ties_aside(got.numpy(), want, X)
    assert len(port.LAST_BUILD["rounds"]) == rounds
    wd, wi = ref.knn_graph_nn_descent(jnp.asarray(X), k=5, deg=deg, rounds=rounds, seed=0)
    gd, gi = port.knn_graph_nn_descent(torch.from_numpy(X), k=5, deg=deg, rounds=rounds,
                                       seed=0, draws=draws)
    assert_same_ids_ties_aside(gi.numpy(), wi, X)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-3)


def test_draws_must_cover_every_round():
    X = torch.from_numpy(_blobs(60))
    draws = jax_build_draws(0, 60, 8, 1, 8)
    with pytest.raises(ValueError, match="1 rounds"):
        port.build_cagra_graph(X, 0, deg=8, rounds=2, draws=draws)


def test_one_search_step_and_whole_search_match_jax():
    X = _blobs()
    n, deg, beam = X.shape[0], 16, 32
    graph = np.asarray(ref.build_cagra_graph(jnp.asarray(X), 0, deg=deg, rounds=4))
    Q = X[::5] + 0.1
    nq = Q.shape[0]
    q2, x2 = (Q * Q).sum(1), (X * X).sum(1)
    beam_ids, d2b = ref._search_entry(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(q2),
                                      jnp.asarray(x2), beam)
    draws = jax_search_draws(nq, n, beam, deg, 12)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pb, pd = port._search_entry(t(Q), t(X), t(q2), t(x2), beam, t(draws.entry).long())
    assert_same_ids_ties_aside(pb.numpy(), beam_ids, X, rows=Q)
    want = ref._search_step(beam_ids, d2b, jnp.int32(2), jnp.asarray(Q), jnp.asarray(X),
                            jnp.asarray(q2), jnp.asarray(x2), jnp.asarray(graph), beam)
    got = port._search_step(pb, pd, t(Q), t(X), t(q2), t(x2), t(graph), beam,
                            t(draws.explore[2]).long())
    assert_same_ids_ties_aside(got[0].numpy(), want[0], X, rows=Q)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-3)
    assert bool(got[2]) == bool(want[2])
    wd, wp = ref.search_cagra(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(graph), k=8,
                              beam=beam, iters=12)
    gd, gp = port.search_cagra(t(Q), t(X), t(graph), k=8, beam=beam, iters=12, draws=draws)
    assert_same_ids_ties_aside(gp.numpy(), wp, X, rows=Q)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("data", ["blobs", "skewed"])
def test_own_seed_recall_within_003_of_jax(data):
    if data == "blobs":
        X, deg, k = _blobs(), 16, 8
    else:
        X, _ = make_blobs(n_samples=[2000, 400, 80, 40, 20], n_features=12,
                          cluster_std=[0.5, 1.0, 2.0, 0.3, 3.0], random_state=4)
        X, deg, k = X.astype(np.float32), 24, 10
    Q = X[::17]
    gp = port.build_cagra_graph(torch.from_numpy(X), 0, deg=deg)
    gj = np.asarray(ref.build_cagra_graph(jnp.asarray(X), 0, deg=deg))
    # graph recall: each node's graph against its exact deg nearest (self
    # excluded)
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(2)
    np.fill_diagonal(d2, np.inf)
    truth = np.argsort(d2, axis=1, kind="stable")[:, :deg]

    def graph_recall(g):
        return np.mean([len(set(a) & set(b)) / deg for a, b in zip(np.asarray(g), truth)])

    assert abs(graph_recall(gp) - graph_recall(gj)) <= 0.03
    _, pp = port.search_cagra(torch.from_numpy(Q), torch.from_numpy(X), gp, k=k)
    _, pj = ref.search_cagra(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(gj), k=k)
    rp, rj = _recall(pp, X, Q, k), _recall(pj, X, Q, k)
    assert abs(rp - rj) <= 0.03, (rp, rj)
    assert rp >= 0.9
