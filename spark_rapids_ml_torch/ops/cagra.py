#
# Graph ANN, the CAGRA class: the port of spark_rapids_ml_tpu/ops/cagra.py.
#
#   build_cagra_graph     NN-descent rounds from a random graph: each row's
#                         candidates are its neighbours, its reverse
#                         neighbours, a sampled local join (neighbours of
#                         neighbours) and random draws, scored with one
#                         gather and a batched product, duplicates and the
#                         row itself masked, the best `deg` kept;
#   search_cagra          beam search from the best of a random entry
#                         sample: each step scores the beam's neighbours
#                         and a few random probes, keeps the best `beam`,
#                         and the search stops early once no beam changed;
#   knn_graph_nn_descent  the build, then each node's exact best k of its
#                         graph neighbours (UMAP's nn_descent graph).
#
# Torch ops on the device of the data, no hand-written kernel.  What
# differs from the JAX package, each on purpose (ROADMAP.md section 3):
# - The draws.  `jax.random` cannot be reproduced in torch: the port draws
#   from one `torch.Generator` seeded from `seed` on the data's device (the
#   search from seed 0, as the JAX package's fixed key), whole rounds at
#   once, so no draw depends on the blocking.  `draws=` hands in the JAX
#   package's instead (`BuildDraws`, `SearchDraws`).
# - The reverse graph.  Each edge (head -> tail) writes its head into slot
#   hash(head) of the tail's reverse list; of several edges that hit one
#   slot the last in edge order wins, which is what XLA's scatter keeps on
#   the CPU, decided by a `scatter_reduce` max of the edge index, so the
#   card gives the same graph (an `index_put_` would pick any writer).
# - Rows in blocks sized by bytes (about 1 GiB of gathered candidates), not
#   the TPU's 256: a row's result does not depend on its block.
# - Deduplication by one packed int64 key (id << pos_bits | pos) at every
#   n: the JAX package's two branches (packed int32, or a pair sort for
#   huge n) give the same result.
#
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import torch

from ..utils import timer_span
from .distances import sqdist_gathered
from .kmeans import row_norms
from .knn import smallest_k

# bytes of gathered candidate rows a block of rows may take
_BLOCK_BYTES = 1 << 30
# -1640531535 as an int32: the multiplicative (Knuth) hash of the reverse
# graph's slots
_KNUTH = -1640531535

# Host seconds of each NN-descent round of the last build (each ends in a
# device sync): {"rounds": [s, ...]}.
LAST_BUILD: dict = {}


class RoundDraws(NamedTuple):
    """One NN-descent round's draws, one row per node: the reverse graph's
    initial entries (n, deg) in [0, n), the local-join sample (n, sample)
    in [0, 2 deg) (None: the join is exhaustive), random candidates
    (n, deg) in [0, n)."""

    rev: object
    sample: Optional[object]
    rand: object


class BuildDraws(NamedTuple):
    """The initial graph (n, deg) in [0, n) and one `RoundDraws` a round."""

    graph: object
    rounds: Sequence[RoundDraws]


class SearchDraws(NamedTuple):
    """The entry sample (nq, 4 beam) and one (nq, deg) draw of random
    probes a step, all in [0, n)."""

    entry: object
    explore: Sequence[object]


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)


def _randint(gen: torch.Generator, high: int, shape, device) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=gen, dtype=torch.int64, device=device)


def _as_ids(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.tensor(a, dtype=torch.int64, device=device)


def _pos_bits(C: int) -> int:
    return max(1, (C - 1)).bit_length()


def _dedup_sorted(ids: torch.Tensor, d2: torch.Tensor):
    """Row-wise duplicate masking without a scatter: returns
    (d2_sorted_masked, ids_sorted), the candidates reordered by (id,
    position) with every later occurrence of an id at +inf.  One sort of
    packed int64 keys (id << pos_bits | pos)."""
    C = ids.shape[-1]
    pb = _pos_bits(C)
    pos = torch.arange(C, dtype=torch.int64, device=ids.device)
    sk = torch.sort((ids.to(torch.int64) << pb) | pos, dim=-1).values
    sid = sk >> pb
    spos = sk & ((1 << pb) - 1)
    dup = torch.zeros_like(sid, dtype=torch.bool)
    dup[..., 1:] = sid[..., 1:] == sid[..., :-1]
    d2s = torch.gather(d2, -1, spos)
    return d2s.masked_fill_(dup, float("inf")), sid


def _knuth_slots(heads: torch.Tensor, deg: int) -> torch.Tensor:
    """(heads * -1640531535) in wrapping int32 arithmetic, floor-mod deg:
    the JAX package's hash, computed in int64 and wrapped by hand."""
    h = (heads * _KNUTH) & 0xFFFF_FFFF
    h = torch.where(h >= 2**31, h - 2**32, h)
    return torch.remainder(h, deg)


def reverse_graph(graph: torch.Tensor, rev_init: torch.Tensor) -> torch.Tensor:
    """(n, deg) approximate reverse graph: edge e = (head -> tail) writes
    head into slot hash(head) of tail's list; the last edge in edge order
    wins a slot several edges hit; slots no edge hits keep `rev_init`."""
    n, deg = graph.shape
    edges = torch.arange(n * deg, dtype=torch.int64, device=graph.device)
    heads = edges // deg
    target = graph.reshape(-1) * deg + _knuth_slots(heads, deg)
    win = torch.full((n * deg,), -1, dtype=torch.int64, device=graph.device)
    win.scatter_reduce_(0, target, edges, reduce="amax")
    return torch.where(win >= 0, win // deg, rev_init.reshape(-1)).reshape(n, deg)


def _block_rows(C: int, d: int, itemsize: int) -> int:
    return max(1, _BLOCK_BYTES // max(C * d * itemsize, 1))


def _own_round(gen, n: int, deg: int, sample: int, device) -> RoundDraws:
    return RoundDraws(
        rev=_randint(gen, n, (n, deg), device),
        sample=_randint(gen, 2 * deg, (n, sample), device) if sample < 2 * deg else None,
        rand=_randint(gen, n, (n, deg), device),
    )


def _nn_descent_round(X, x2, graph, draws: RoundDraws, deg: int, sample: int, timer=None):
    """One NN-descent round: the new (n, deg) graph, int64."""
    n, d = X.shape
    dev = X.device
    with timer_span(timer, "reverse"):
        rev = reverse_graph(graph, _as_ids(draws.rev, dev))
    sidx = _as_ids(draws.sample, dev) if sample < 2 * deg else None
    rand = _as_ids(draws.rand, dev)
    width = sample if sidx is not None else 2 * deg
    C = 2 * deg + width * deg + deg
    out = torch.empty((n, deg), dtype=torch.int64, device=dev)
    step = _block_rows(C, d, X.element_size())
    for lo in range(0, n, step):
        rows = torch.arange(lo, min(lo + step, n), device=dev)
        b = rows.shape[0]
        with timer_span(timer, "gather_distances"):
            base = torch.cat([graph[rows], rev[rows]], dim=1)  # (b, 2 deg)
            # the sampled local join (NN-descent's rho-sampling)
            expand = base if sidx is None else torch.gather(base, 1, sidx[rows])
            two_hop = graph[expand].reshape(b, width * deg)
            cand = torch.cat([base, two_hop, rand[rows]], dim=1)  # (b, C)
            d2 = sqdist_gathered(X[rows], X[cand], x2[rows], x2[cand])
            d2.masked_fill_(cand == rows[:, None], float("inf"))  # no self
        with timer_span(timer, "dedup_sort"):
            d2s, sid = _dedup_sorted(cand, d2)
        with timer_span(timer, "topk"):
            _, idx = smallest_k(d2s, deg)
            out[lo : lo + b] = torch.gather(sid, 1, idx)
    return out


def build_cagra_graph(
    X: torch.Tensor,  # (n, d) item vectors
    seed,
    deg: int = 32,
    rounds: int = 8,
    sample: Optional[int] = None,
    x2: Optional[torch.Tensor] = None,  # optional precomputed (n,) sq norms
    draws: Optional[BuildDraws] = None,
    timer=None,
) -> torch.Tensor:
    """NN-descent kNN graph: (n, deg) int32 neighbour ids (approximate
    k-nearest, self excluded), on X's device.  `sample` bounds the local
    join per node (default deg, half the 2 deg base; 2 deg joins all).
    `timer`, where given, has a `span(name)` around each round's
    "reverse", and each block's "gather_distances", "dedup_sort", "topk"."""
    n = X.shape[0]
    if sample is None:
        sample = deg
    sample = max(1, min(sample, 2 * deg))
    if draws is not None and len(draws.rounds) < rounds:
        raise ValueError(f"draws hold {len(draws.rounds)} rounds; the build runs {rounds}")
    gen = _generator(seed, X.device) if draws is None else None
    graph = (_randint(gen, n, (n, deg), X.device) if draws is None
             else _as_ids(draws.graph, X.device))
    if x2 is None:
        x2 = row_norms(X)
    LAST_BUILD.clear()
    LAST_BUILD["rounds"] = []
    for r in range(rounds):
        t0 = time.perf_counter()
        rd = _own_round(gen, n, deg, sample, X.device) if draws is None else draws.rounds[r]
        graph = _nn_descent_round(X, x2, graph, rd, deg, sample, timer=timer)
        int(graph[0, 0])  # the round's end, for its time
        LAST_BUILD["rounds"].append(time.perf_counter() - t0)
    return graph.to(torch.int32)


def _search_entry(Q, X, q2, x2, beam: int, entry):
    """Multi-entry start: per query the best `beam` of a random entry
    sample."""
    de = sqdist_gathered(Q, X[entry], q2, x2[entry])
    d2s, sid = _dedup_sorted(entry, de)
    vals, idx = smallest_k(d2s, beam)
    return torch.gather(sid, 1, idx), vals


def _search_step(beam_ids, d2b, Q, X, q2, x2, graph, beam: int, explore):
    """One beam-expansion step; returns (beam_ids, d2b, changed) with
    `changed` a 0-d bool tensor: whether any query's beam SET moved."""
    nq = Q.shape[0]
    deg = graph.shape[1]
    nbrs = graph[beam_ids].reshape(nq, beam * deg).to(torch.int64)
    # a pinch of random exploration per step escapes local minima
    ext = torch.cat([nbrs, explore], dim=1)
    cand = torch.cat([beam_ids, ext], dim=1)
    de = sqdist_gathered(Q, X[ext], q2, x2[ext])
    d2s, sid = _dedup_sorted(cand, torch.cat([d2b, de], dim=1))
    vals, idx = smallest_k(d2s, beam)
    new_ids = torch.gather(sid, 1, idx)
    changed = torch.any(torch.sort(new_ids, dim=1).values
                        != torch.sort(beam_ids, dim=1).values)
    return new_ids, vals, changed


def search_cagra(
    Q: torch.Tensor,  # (q, d) queries
    X: torch.Tensor,  # (n, d) items
    graph: torch.Tensor,  # (n, deg) int
    k: int,
    beam: int = 64,
    iters: int = 12,
    draws: Optional[SearchDraws] = None,
    timer=None,
):
    """Beam search over the kNN graph.  Returns (d2 (q, k), pos (q, k)):
    squared distances and item row positions, best first.  At most
    `iters` steps; the search stops after a step in which no query's beam
    set changed (one fetch a step).  `timer` spans "entry" and "step"."""
    n = X.shape[0]
    dev = X.device
    beam = min(beam, n)
    deg = graph.shape[1]
    gen = _generator(0, dev) if draws is None else None
    q2 = row_norms(Q)
    x2 = row_norms(X)
    with timer_span(timer, "entry"):
        entry = (_randint(gen, n, (Q.shape[0], 4 * beam), dev) if draws is None
                 else _as_ids(draws.entry, dev))
        beam_ids, d2b = _search_entry(Q, X, q2, x2, beam, entry)
    for t in range(iters):  # iters=0 -> entry-sample results only
        with timer_span(timer, "step"):
            explore = (_randint(gen, n, (Q.shape[0], deg), dev) if draws is None
                       else _as_ids(draws.explore[t], dev))
            beam_ids, d2b, changed = _search_step(beam_ids, d2b, Q, X, q2, x2, graph,
                                                  beam, explore)
        if not bool(changed):
            break
    vals, idx = smallest_k(d2b, k)
    return vals, torch.gather(beam_ids, 1, idx)


def _graph_knn_select(X, x2, graph, k: int):
    """Exact distances to each node's graph neighbours, best k selected,
    in row blocks of about 1 GiB of gathered neighbours."""
    n, d = X.shape
    deg = graph.shape[1]
    ds = torch.empty((n, k), dtype=X.dtype, device=X.device)
    ids = torch.empty((n, k), dtype=torch.int64, device=X.device)
    step = _block_rows(deg, d, X.element_size())
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        g = graph[lo:hi].to(torch.int64)
        d2 = sqdist_gathered(X[lo:hi], X[g], x2[lo:hi], x2[g])
        ds[lo:hi], idx = smallest_k(d2, k)
        ids[lo:hi] = torch.gather(g, 1, idx)
    return ds, ids


def knn_graph_nn_descent(
    X: torch.Tensor,
    k: int,
    deg: Optional[int] = None,
    rounds: int = 8,
    sample: Optional[int] = None,
    seed: int = 0,
    draws: Optional[BuildDraws] = None,
):
    """Approximate kNN graph by NN-descent (self excluded), UMAP's
    `build_algo='nn_descent'`.  Returns (sq_distances (n, k), ids (n, k)),
    best first.  `deg` is the working graph degree (>= k; default 2k held
    in [16, 64])."""
    n = X.shape[0]
    if deg is None:
        deg = min(max(2 * k, 16), 64)
    deg = max(1, min(max(deg, k), n - 1))
    x2 = row_norms(X)
    graph = build_cagra_graph(X, seed, deg=deg, rounds=rounds, sample=sample, x2=x2,
                              draws=draws)
    return _graph_knn_select(X, x2, graph, k)
