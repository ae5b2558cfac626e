#
# ApproximateNearestNeighbors' ops on the card against the same code on
# the CPU: an IVF-Flat and an IVF-PQ search of one index, a CAGRA build
# and search from handed-in draws, the reverse graph's collision rule (a
# `scatter_reduce` max, deterministic on the card), and `smallest_k`'s
# tie order.  Ids equal, ties aside (two ids whose float64 distances lie
# within 1e-5 of the norms the matmul identity cancels may swap).  Every
# test here needs a CUDA device and skips without one.  This file imports
# no JAX:
#
#     python -m pytest --noconftest -q tests/test_torch_ann_cuda.py
#
import numpy as np
import pytest
import torch

from spark_rapids_ml_torch import set_default_device
from spark_rapids_ml_torch import config as port_config
from spark_rapids_ml_torch.ops import cagra, ivf
from spark_rapids_ml_torch.ops.knn import smallest_k

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_default_device("cpu")
    yield torch.device("cuda")
    set_default_device(None)
    port_config.reset_config()


def _blobs(n=4000, d=32, centres=20, seed=0):
    rng = np.random.default_rng(seed)
    C = rng.uniform(-10, 10, (centres, d))
    return (C[rng.integers(0, centres, n)] + rng.normal(size=(n, d))).astype(np.float32)


def _same_ids(got, want, X, rows):
    got, want = np.asarray(got), np.asarray(want)
    diff = np.argwhere(got != want)
    assert len(diff) <= got.size / 200, f"{len(diff)} of {got.size} slots differ"
    X64, B = X.astype(np.float64), rows.astype(np.float64)
    scale = (B * B).sum(1) + (X64 * X64).sum(1).max()
    for i, j in diff:
        dg = ((B[i] - X64[got[i, j]]) ** 2).sum() if got[i, j] >= 0 else np.inf
        dw = ((B[i] - X64[want[i, j]]) ** 2).sum() if want[i, j] >= 0 else np.inf
        assert abs(dg - dw) <= 1e-5 * scale[i], (i, j, dg, dw)


@pytest.mark.parametrize("pq", [False, True])
def test_ivf_search_on_the_card_gives_the_cpu_ids(cuda_device, pq):
    X = _blobs()
    Q = X[::13] + 0.05
    if pq:
        index = ivf.build_ivfpq(X, 40, M=8, device="cpu")
        search = ivf.search_ivfpq
    else:
        index = ivf.build_ivfflat(X, 40, device="cpu")
        search = ivf.search_ivfflat
    cpu = search(torch.from_numpy(Q), *(torch.from_numpy(np.array(a)) for a in index),
                 nprobe=6, k=10)
    card = search(torch.from_numpy(Q).to(cuda_device),
                  *(torch.from_numpy(np.array(a)).to(cuda_device) for a in index),
                  nprobe=6, k=10)
    _same_ids(card[1].cpu(), cpu[1], X, Q)
    np.testing.assert_allclose(card[0].cpu().numpy(), cpu[0].numpy(), rtol=1e-4, atol=1e-3)


def _draws(n, deg, rounds, seed=1):
    rng = np.random.default_rng(seed)
    return cagra.BuildDraws(
        rng.integers(0, n, (n, deg)),
        [cagra.RoundDraws(rng.integers(0, n, (n, deg)), rng.integers(0, 2 * deg, (n, deg)),
                          rng.integers(0, n, (n, deg))) for _ in range(rounds)])


def test_cagra_build_and_search_on_the_card_give_the_cpu_ids(cuda_device):
    X = _blobs()
    n, deg = X.shape[0], 16
    # one round: a near-tie swapped by the card's summation order would
    # change the next round's candidates
    draws = _draws(n, deg, 1)
    g_cpu = cagra.build_cagra_graph(torch.from_numpy(X), 0, deg=deg, rounds=1, draws=draws)
    g_card = cagra.build_cagra_graph(torch.from_numpy(X).to(cuda_device), 0, deg=deg,
                                     rounds=1, draws=draws)
    _same_ids(g_card.cpu(), g_cpu, X, X)
    Q = X[::11] + 0.05
    rng = np.random.default_rng(2)
    sd = cagra.SearchDraws(rng.integers(0, n, (Q.shape[0], 4 * 32)),
                           [rng.integers(0, n, (Q.shape[0], deg)) for _ in range(12)])
    cpu = cagra.search_cagra(torch.from_numpy(Q), torch.from_numpy(X), g_cpu, k=10, beam=32,
                             draws=sd)
    card = cagra.search_cagra(torch.from_numpy(Q).to(cuda_device),
                              torch.from_numpy(X).to(cuda_device), g_cpu.to(cuda_device),
                              k=10, beam=32, draws=sd)
    _same_ids(card[1].cpu(), cpu[1], X, Q)


def test_reverse_graph_collisions_are_deterministic_on_the_card(cuda_device):
    rng = np.random.default_rng(3)
    n, deg = 20000, 32
    graph = torch.from_numpy(rng.integers(0, n, (n, deg)))
    graph[: n // 2] = 7  # many writers into node 7's slots
    init = torch.from_numpy(rng.integers(0, n, (n, deg)))
    cpu = cagra.reverse_graph(graph, init)
    for _ in range(3):
        assert torch.equal(cagra.reverse_graph(graph.to(cuda_device), init.to(cuda_device)).cpu(),
                           cpu)


def test_smallest_k_orders_ties_by_position_on_the_card(cuda_device):
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.integers(0, 20, (300, 3000)).astype(np.float32))
    v[:, ::7] = float("inf")
    vals, pos = smallest_k(v.to(cuda_device), 50)
    srt, want = torch.sort(v, dim=1, stable=True)
    assert torch.equal(pos.cpu(), want[:, :50]) and torch.equal(vals.cpu(), srt[:, :50])
