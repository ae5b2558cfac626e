#
# Random forest: the port of spark_rapids_ml_tpu/ops/forest.py, the
# histogram (binned) tree builder, as torch ops on one device.
#
#   - prep, once per fit (`_forest_prep`): quantile bin edges per feature
#     (`compute_bin_edges`, sorted a block of columns at a time), every
#     row's bin ids (`digitize`, `torch.searchsorted` a chunk of rows at a
#     time) and the rows' statistic channels;
#   - trees grow one at a time (`_grow_one_tree`), level by level over a
#     frontier of at most `max_active` nodes, in a plain Python loop with
#     no host round trip inside a tree: per level the (A, d, B, S)
#     histogram by `scatter_add_` over row chunks, cumulative sums over
#     the bins, every candidate split's impurity decrease, the Gumbel
#     feature subset, an argmax per node, the node-table writes, the rows'
#     routing and the next frontier; then the leaf statistics;
#   - `forest_apply`: the pointer traversal of every tree at once.
#
# Differences from the JAX package, each deliberate (ROADMAP.md section 3):
# - Randomness.  `jax.random` cannot be reproduced in torch: the port draws
#   from one `torch.Generator` seeded from `seed` on the data's device
#   (Poisson or Bernoulli row weights, Gumbels as -log(-log(U))).
#   `draws=` hands in each tree's row weights and each level's Gumbel
#   matrix made elsewhere (the tests hand in the JAX package's).
# - Dispatch.  Trees grow one at a time; the JAX package's chunks of trees
#   sized from a wall-clock probe exist for the TPU's transfer deadline and
#   change nothing but the number of dispatches.
# - Bin ids are stored as uint8 when n_bins <= 256 (int16 up to 32768,
#   else int32), not int32: the same ids in a quarter of the memory.
# - The quantile positions are computed in int64 (the JAX package's int32
#   product wraps above 2^31 / (n_bins - 1) rows on one device).
# - A classification row adds its weight to its own class's channel only
#   (the JAX package adds its one-hot row, zeros included): the same sums
#   with 1/C of the scatter work.  On a card `scatter_add_` adds with
#   atomics, so sums that are not exact in the dtype (non-integer weights,
#   the regression channels, counts above 2^24 in float32) change their
#   rounding from run to run.
#
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..utils import timer_span
from .kmeans import _generator, gumbel

GINI, ENTROPY, VARIANCE = 0, 1, 2  # split criteria

# bytes of the temporaries one chunk of a pass may make: the int64 index
# of a histogram chunk, the sorted block of columns of the edges (values
# and int64 indices), the transposed chunk of `digitize`
_CHUNK_BYTES = 1 << 29


def bin_dtype(n_bins: int) -> torch.dtype:
    """The narrowest dtype that holds bin ids 0..n_bins-1."""
    if n_bins <= 256:
        return torch.uint8
    if n_bins <= 32768:
        return torch.int16
    return torch.int32


def compute_bin_edges(X: torch.Tensor, n_bins: int,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_bins-1, d) interior quantile boundaries of the rows.

    Rows of `valid` 0 are pushed past the last quantile (+inf before the
    sort) so they cannot skew the edges; the quantile positions index over
    the valid row count.  Columns are sorted a block at a time (a sort
    also makes int64 indices)."""
    m, d = X.shape
    if valid is not None:
        ok = valid > 0
        n_eff = ok.sum()
    else:
        ok = None
        n_eff = torch.tensor(m, device=X.device)
    # edge j at quantile (j+1)/n_bins of the valid rows
    j = torch.arange(1, n_bins, device=X.device, dtype=torch.int64)
    qidx = torch.clamp((j * n_eff) // n_bins, 0, max(m - 1, 0))
    edges = torch.empty((n_bins - 1, d), dtype=X.dtype, device=X.device)
    cols = max(1, _CHUNK_BYTES // max(m * (X.element_size() + 8), 1))
    for c0 in range(0, d, cols):
        c1 = min(c0 + cols, d)
        block = X[:, c0:c1].T.contiguous()  # (cols, m)
        if ok is not None:
            block.masked_fill_(~ok[None, :], float("inf"))
        edges[:, c0:c1] = torch.sort(block, dim=1).values[:, qidx].T
    # guard against inf edges when most rows are invalid
    return torch.where(torch.isfinite(edges), edges,
                       torch.tensor(torch.finfo(X.dtype).max, dtype=X.dtype, device=X.device))


def digitize(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(m, d) bin ids in [0, n_bins): the number of interior edges
    strictly below x, in `bin_dtype(n_bins)`, a chunk of rows at a time."""
    m, d = X.shape
    n_bins = edges.shape[0] + 1
    edges_t = edges.T.contiguous()  # (d, B-1), sorted along the last dim
    out = torch.empty((m, d), dtype=bin_dtype(n_bins), device=X.device)
    rows = max(1, _CHUNK_BYTES // max(d * (X.element_size() + 4), 1))
    for lo in range(0, m, rows):
        hi = min(lo + rows, m)
        ids = torch.searchsorted(edges_t, X[lo:hi].T.contiguous(), out_int32=True)
        out[lo:hi] = ids.T
    return out


def _split(a: torch.Tensor):
    """a = hi + lo exactly, each half of a float64's significand (Veltkamp)."""
    c = a * 134217729.0  # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, as a fused multiply-add rounds it: the
    operation XLA's CPU compiler makes of these expressions, so the port's
    impurities round as the JAX package's do.  float32: the product and sum
    formed in float64 (which holds the product exactly), rounded once.
    float64: the exact product as a sum of two float64s (Dekker), added to
    c without error (Knuth's two-sum), then rounded."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    p_err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    s = p + c
    bb = s - p
    s_err = (p - (s - bb)) + (c - bb)
    return s + (s_err + p_err)


def _impurity(stats: torch.Tensor, criterion: int):
    """Node impurity from per-channel statistics.

    Classification (gini/entropy): stats[..., :C] are class counts.
    Regression (variance): stats[..., 0:3] = (weight, sum y, sum y^2).
    Returns (impurity, total_count) with impurity 0 for empty nodes."""
    if criterion == VARIANCE:
        n = stats[..., 0]
        safe_n = torch.clamp_min(n, 1e-12)
        mean = stats[..., 1] / safe_n
        var = torch.clamp_min(_fma(-mean, mean, stats[..., 2] / safe_n), 0.0)
        return torch.where(n > 0, var, 0.0), n
    n = stats.sum(dim=-1)
    safe_n = torch.clamp_min(n, 1e-12)
    p = stats / safe_n[..., None]
    if criterion == GINI:
        sq = p[..., 0] * p[..., 0]
        for c in range(1, p.shape[-1]):
            sq = _fma(p[..., c], p[..., c], sq)
        imp = 1.0 - sq
    else:  # entropy, natural log
        imp = -torch.where(p > 0, p * torch.log(p), 0.0).sum(dim=-1)
    return torch.where(n > 0, imp, 0.0), n


class TreeArrays(NamedTuple):
    feature: object  # (T, n_nodes) int32 split feature, -1 = leaf
    threshold: object  # (T, n_nodes) raw-value threshold (go left if <=)
    leaf_stats: object  # (T, n_nodes, S) per-leaf statistics
    gain: object  # (T, n_nodes) impurity decrease of each split (0 = leaf)
    count: object  # (T, n_nodes) weighted sample count reaching the node
    left_child: object  # (T, n_nodes) int32 node-table id of the left
    # child (right child = left + 1); -1 for leaves


class TreeDraws(NamedTuple):
    """One tree's random draws: row weights (m,) (None: every row weighs 1)
    and one Gumbel matrix (A_l, d) per level (None: every feature is a
    candidate)."""

    weights: object
    gumbels: Optional[Sequence[object]]


def table_nodes(max_depth: int, max_active: int) -> int:
    """Node-table size for a (max_depth, max_active) build: root + two
    child slots per possible active node per level."""
    return 1 + sum(2 * min(2**lv, max_active) for lv in range(max_depth))


def _level_widths(max_depth: int, max_active: int):
    return [min(1 << lv, max_active) for lv in range(max_depth)]


def _own_draws(gen: torch.Generator, X: torch.Tensor, max_depth: int, max_active: int,
               max_features: int, bootstrap: bool, subsample: float) -> TreeDraws:
    """One tree's draws from the fit's generator, in X's dtype on X's
    device: Poisson(subsample) row weights under bootstrap,
    Bernoulli(subsample) when subsampling without it, and a Gumbel matrix
    per level when features are subsampled."""
    m, d = X.shape
    weights = None
    if bootstrap or subsample < 1.0:
        rate = torch.full((m,), subsample, dtype=X.dtype, device=X.device)
        sample = torch.poisson if bootstrap else torch.bernoulli
        weights = sample(rate, generator=gen)
    gumbels = None
    if max_features < d:
        gumbels = [gumbel(a * d, gen, X).view(a, d)
                   for a in _level_widths(max_depth, max_active)]
    return TreeDraws(weights, gumbels)


def _histogram(Xb: torch.Tensor, slot: torch.Tensor, A: int, n_bins: int,
               values: torch.Tensor, classes: Optional[torch.Tensor],
               n_channels: int) -> torch.Tensor:
    """(A, d, B, S) sums of the rows' statistics by (frontier slot, feature,
    bin), over chunks of rows.

    Classification (`classes` given): `values` (m,) is each row's weight,
    added to its class's channel, one `scatter_add_` per chunk into an
    (A * B * C, d) table.  Regression: `values` (m, S), one `scatter_add_`
    per channel into (S, A * B, d).  Rows of `slot` >= A add 0."""
    m, d = Xb.shape
    S = n_channels
    rows = max(1, _CHUNK_BYTES // (8 * d))
    if classes is not None:
        hist = torch.zeros((A * n_bins * S, d), dtype=values.dtype, device=Xb.device)
    else:
        hist = torch.zeros((S, A * n_bins, d), dtype=values.dtype, device=Xb.device)
    active = slot < A
    row_base = torch.clamp(slot, max=A - 1) * n_bins
    if classes is not None:
        row_base = row_base * S + classes
    for lo in range(0, m, rows):
        hi = min(lo + rows, m)
        # one pass from the bin ids to the int64 index
        if classes is not None:
            idx = torch.add(row_base[lo:hi, None], Xb[lo:hi], alpha=S)
            v = torch.where(active[lo:hi], values[lo:hi], 0.0)
            hist.scatter_add_(0, idx, v[:, None].expand(-1, d))
        else:
            idx = torch.add(row_base[lo:hi, None], Xb[lo:hi])
            v = torch.where(active[lo:hi, None], values[lo:hi], 0.0)
            for s in range(S):
                hist[s].scatter_add_(0, idx, v[:, s, None].expand(-1, d))
        del idx, v
    if classes is not None:
        return hist.view(A, n_bins, S, d).permute(0, 3, 1, 2)
    return hist.view(S, A, n_bins, d).permute(1, 3, 2, 0)


def _cumsum(h: torch.Tensor, dim: int) -> torch.Tensor:
    """Running sum along `dim` in h's dtype, associated as XLA's CPU
    compiler associates `jnp.cumsum`: up to 16 elements in turn; longer,
    blocks of 16 summed in turn, then each block plus the running sum of
    the blocks before it (found the same way).  The JAX package's
    rounding, where torch.cumsum sums float32 in float64 on the CPU and in
    another order on a card."""
    n = h.shape[dim]
    if n <= 16:
        out = h.clone()
        for b in range(1, n):
            out.select(dim, b).add_(out.select(dim, b - 1))
        return out
    hm = h.movedim(dim, -1)
    pad = (-n) % 16
    if pad:
        hm = torch.cat([hm, hm.new_zeros(hm.shape[:-1] + (pad,))], dim=-1)
    blocks = _cumsum(hm.reshape(hm.shape[:-1] + (-1, 16)), hm.dim())
    before = _cumsum(blocks[..., -1].contiguous(), hm.dim() - 1)
    blocks[..., 1:, :] += before[..., :-1, None]
    return blocks.reshape(hm.shape)[..., :n].movedim(-1, dim)


def _best_splits(hist: torch.Tensor, criterion: int, min_instances: float,
                 fmask: Optional[torch.Tensor]):
    """Per frontier slot: the flat index of the best (feature, bin) split,
    its impurity decrease (-inf where no split is allowed), the slot's
    weighted count and the left count of every candidate (A, d, B-1)."""
    A, d, B, S = hist.shape
    cum = _cumsum(hist, 2)
    total = cum[:, :, -1, :]  # (A, d, S), the same for every feature
    left = cum[:, :, : B - 1, :]  # (A, d, B-1, S)
    right = total[:, :, None, :] - left
    del cum
    imp_parent, n_parent = _impurity(total[:, 0, :], criterion)  # (A,)
    imp_l, n_left = _impurity(left, criterion)  # (A, d, B-1)
    imp_r, n_right = _impurity(right, criterion)
    del left, right
    safe_np = torch.clamp_min(n_parent, 1e-12)[:, None, None]
    gain = imp_parent[:, None, None] - _fma(n_left, imp_l, n_right * imp_r) / safe_np
    del imp_l, imp_r
    ok = (n_left >= min_instances) & (n_right >= min_instances)
    gain = torch.where(ok, gain, float("-inf"))
    if fmask is not None:
        gain = torch.where(fmask[:, :, None], gain, float("-inf"))
    flat = gain.reshape(A, -1)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    return best, best_gain, n_parent, n_left


def _grow_one_tree(
    Xb: torch.Tensor,  # (m, d) bin ids
    edges: torch.Tensor,  # (B-1, d) raw edge values
    stats: torch.Tensor,  # (m, S) regression channels; (m,) int64 class ids
    valid: torch.Tensor,  # (m,) row validity * user weight
    draws: TreeDraws,
    max_depth: int,
    n_bins: int,
    criterion: int,
    n_classes: int,
    max_features: int,
    min_instances: float,
    min_info_gain: float,
    max_active: int,
    timer=None,
) -> TreeArrays:
    """One tree, level by level, as tensors on Xb's device."""
    m, d = Xb.shape
    dev = Xb.device
    dtype = edges.dtype
    classification = criterion != VARIANCE
    S = n_classes if classification else stats.shape[1]
    n_nodes = table_nodes(max_depth, max_active)

    w = valid if draws.weights is None else (
        torch.as_tensor(draws.weights, device=dev).to(dtype) * valid)
    # classification: each row's weight goes to its class's channel;
    # regression: the channels (1, y, y^2) times the weight
    values = w if classification else stats * w[:, None]
    classes = stats if classification else None

    # node-table arrays carry ONE trash row at index n_nodes: writes for
    # empty frontier slots land there instead of corrupting real nodes
    feature = torch.full((n_nodes + 1,), -1, dtype=torch.int32, device=dev)
    threshold = torch.zeros((n_nodes + 1,), dtype=dtype, device=dev)
    gain_arr = torch.zeros((n_nodes + 1,), dtype=dtype, device=dev)
    count_arr = torch.zeros((n_nodes + 1,), dtype=dtype, device=dev)
    left_arr = torch.full((n_nodes + 1,), -1, dtype=torch.int32, device=dev)

    node = torch.zeros((m,), dtype=torch.int64, device=dev)  # where each row rests
    # frontier slot of each row; A_l (the level width) means inactive
    slot = torch.where(w > 0, 0, 1).to(torch.int64)
    frontier = torch.zeros((1,), dtype=torch.int64, device=dev)  # table ids
    base = 1  # next unallocated table id
    widths = _level_widths(max_depth, max_active)

    for level, A_l in enumerate(widths):
        last = level == max_depth - 1
        with timer_span(timer, "histogram"):
            hist = _histogram(Xb, slot, A_l, n_bins, values, classes, S)
        with timer_span(timer, "split"):
            fmask = None
            if max_features < d:
                # per-node feature subset: Gumbel top-K mask over features
                g = torch.as_tensor(draws.gumbels[level], device=dev).to(dtype)
                kth = torch.sort(g, dim=1).values[:, d - max_features]
                fmask = g >= kth[:, None]  # exactly K True per node
            best, best_gain, n_parent, n_left = _best_splits(
                hist, criterion, min_instances, fmask)
            del hist
            bf = torch.div(best, n_bins - 1, rounding_mode="floor")
            bb = best % (n_bins - 1)
            real = frontier >= 0
            can_split = torch.isfinite(best_gain) & (best_gain > min_info_gain) & real

            sids = torch.where(real, frontier, n_nodes)  # dead slots -> trash row
            left_ids = base + 2 * torch.arange(A_l, dtype=torch.int64, device=dev)
            feature[sids] = torch.where(can_split, bf, -1).to(torch.int32)
            threshold[sids] = torch.where(can_split, edges[bb, bf], 0.0)
            gain_arr[sids] = torch.where(can_split, best_gain, 0.0)
            count_arr[sids] = n_parent
            left_arr[sids] = torch.where(can_split, left_ids, -1).to(torch.int32)

        with timer_span(timer, "route"):
            # route rows: left child if bin id <= split bin
            slot_c = torch.clamp(slot, max=A_l - 1)
            active = slot < A_l
            go_right = Xb.gather(1, bf[slot_c][:, None])[:, 0].to(torch.int64) > bb[slot_c]
            splits = active & can_split[slot_c]
            node = torch.where(splits, left_ids[slot_c] + go_right, node)

            if not last:
                # next frontier: the up-to-A_next largest children (weighted
                # count) that could still split; the rest rest as leaves
                A_next = min(2 * A_l, max_active)
                nl_b = n_left.reshape(A_l, -1).gather(1, best[:, None])[:, 0]
                nr_b = n_parent - nl_b
                cand_counts = torch.stack([nl_b, nr_b], dim=1).reshape(-1)
                cand_valid = can_split.repeat_interleave(2)
                growable = cand_counts >= max(2.0 * min_instances, 1e-12)
                score = torch.where(cand_valid & growable, cand_counts, float("-inf"))
                if 2 * A_l <= max_active:
                    keep_vals = score
                    keep_idx = torch.arange(2 * A_l, dtype=torch.int64, device=dev)
                else:
                    # lax.top_k's order: descending, the lower index first
                    # among equal counts
                    keep_vals, keep_idx = torch.sort(score, descending=True, stable=True)
                    keep_vals, keep_idx = keep_vals[:A_next], keep_idx[:A_next]
                kept = keep_vals > float("-inf")
                frontier = torch.where(kept, base + keep_idx, -1)
                # inverse map: candidate child -> next-level slot (A_next = none)
                inv = torch.full((2 * A_l,), A_next, dtype=torch.int64, device=dev)
                inv[keep_idx] = torch.where(
                    kept, torch.arange(A_next, dtype=torch.int64, device=dev), A_next)
                slot = torch.where(splits, inv[2 * slot_c + go_right], A_next)
            del n_left
        base += 2 * A_l

    with timer_span(timer, "leaf"):
        if classification:
            flat = torch.zeros(((n_nodes + 1) * S,), dtype=dtype, device=dev)
            flat.index_add_(0, node * S + classes, w)
            leaf_stats = flat.view(n_nodes + 1, S)
        else:
            leaf_stats = torch.zeros((n_nodes + 1, S), dtype=dtype, device=dev)
            leaf_stats.index_add_(0, node, values)
    return TreeArrays(feature[:n_nodes], threshold[:n_nodes], leaf_stats[:n_nodes],
                      gain_arr[:n_nodes], count_arr[:n_nodes], left_arr[:n_nodes])


def _forest_prep(X: torch.Tensor, y: torch.Tensor, valid: torch.Tensor, n_bins: int,
                 criterion: int, timer=None):
    """Once per fit: the bin edges, the rows' bin ids and their statistic
    channels: (m, 3) = (1, y, y^2) in X's dtype for regression, the (m,)
    int64 class id for classification (each row adds to one channel)."""
    with timer_span(timer, "prep.edges"):
        edges = compute_bin_edges(X, n_bins, valid=valid)
    with timer_span(timer, "prep.digitize"):
        Xb = digitize(X, edges)
    if criterion == VARIANCE:
        yf = y.to(X.dtype)
        stats = torch.stack([torch.ones_like(yf), yf, yf * yf], dim=1)
    else:
        stats = y.to(torch.int64)
    return Xb, edges, stats


def forest_fit(
    X: torch.Tensor,  # (m, d) rows on the device
    y: torch.Tensor,  # (m,) labels
    valid: torch.Tensor,  # (m,) validity * sample weight
    seed: int,
    n_trees: int,
    max_depth: int,
    n_bins: int,
    criterion: int,
    n_classes: int,  # 0 for regression
    max_features: int,
    min_instances: float,
    min_info_gain: float,
    bootstrap: bool,
    subsample: float,
    max_active: int = 256,
    draws: Optional[Sequence[TreeDraws]] = None,
    timer=None,
) -> TreeArrays:
    """Fit the whole forest on X's device; returns HOST (numpy) TreeArrays
    with a leading (n_trees,) axis.

    Trees grow one at a time from one prep.  Each tree's draws come from a
    `torch.Generator` seeded from `seed` on X's device, or from `draws`
    (one `TreeDraws` per tree).  `timer`, where given, has a `span(name)`
    context manager wrapped around each layer: "prep.edges",
    "prep.digitize", then per level "histogram", "split", "route", and per
    tree "leaf"."""
    if draws is not None and len(draws) != n_trees:
        raise ValueError(f"draws holds {len(draws)} trees; the fit grows {n_trees}")
    Xb, edges, stats = _forest_prep(X, y, valid, n_bins, criterion, timer=timer)
    gen = _generator(seed, X.device)
    trees = []
    for t in range(n_trees):
        tree_draws = draws[t] if draws is not None else _own_draws(
            gen, X, max_depth, max_active, max_features, bootstrap, subsample)
        trees.append(_grow_one_tree(
            Xb, edges, stats, valid, tree_draws,
            max_depth=max_depth, n_bins=n_bins, criterion=criterion,
            n_classes=n_classes, max_features=max_features,
            min_instances=min_instances, min_info_gain=min_info_gain,
            max_active=max_active, timer=timer))
    # one fetch for the whole forest
    return TreeArrays(*(torch.stack(parts).cpu().numpy() for parts in zip(*trees)))


def forest_apply(X: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
                 left_child: torch.Tensor, max_depth: int) -> torch.Tensor:
    """(T, n) leaf node-table index per (tree, row): `max_depth` rounds of
    gather + select over every tree at once (int64 node tables on X's
    device)."""
    T = feature.shape[0]
    node = torch.zeros((T, X.shape[0]), dtype=torch.int64, device=X.device)
    for _ in range(max_depth):
        f = feature.gather(1, node)  # (T, n)
        x = X.gather(1, torch.clamp_min(f, 0).T).T  # x[t, i] = X[i, f[t, i]]
        go_right = ~(x <= threshold.gather(1, node))
        child = left_child.gather(1, node) + go_right
        node = torch.where(f < 0, node, child)
    return node
