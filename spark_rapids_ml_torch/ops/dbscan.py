#
# DBSCAN: the port of spark_rapids_ml_tpu/ops/dbscan.py on one device.
# Cluster expansion is min-label connected components over the in-eps
# graph, which is never stored:
#
#   - prep: one pass over column tiles gives every row's degree (the row
#     itself included); core rows (degree >= min_samples, weight > 0) take
#     their row index as label, the rest the sentinel N;
#   - sweeps, driven from the host: every core row takes the least label of
#     its in-eps core neighbours, then one pointer jump (label <-
#     label[label]) collapses chains; the host fetches a `changed` flag
#     after each sweep, and stops when it is 0 or after `max_sweeps`;
#   - the border pass: a non-core row takes the least label of its in-eps
#     core neighbours, else -1 (noise).
#
# Each pass recomputes the squared distances of all rows to one tile of
# `block` columns at a time through `ops/distances.py` `sqdist` (the
# `distance_precision` level).  `adj_budget` is the JAX package's byte cap
# on that float32 distance tile: block = (adj_budget // 4) // N columns.
# The torch form also makes a bool adjacency tile and, in the sweeps and
# the border pass, an int32 label tile of the same shape, so a pass holds
# up to 2.25 times the cap in float32 and 3.25 times in float64, whose
# distance tile the rule sizes as if it were float32 (ROADMAP.md section
# 3).
#
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .distances import sqdist

# default byte cap on the distance tile (the models layer overrides it
# from `max_mbytes_per_batch`), and the widest column tile
_ADJ_BUDGET = 1 << 26
_BLOCK = 8192

# The last call: tile width, tiles per pass, sweeps run.
LAST_RUN: dict = {}


def tile_width(n: int, adj_budget: int = _ADJ_BUDGET, block: int = _BLOCK) -> int:
    """Columns of one distance tile: the JAX package's rule, floor-divided
    so the float32 tile never exceeds the cap, at least 8."""
    if n <= 0:
        return block
    return min(block, max(8, (int(adj_budget) // 4) // n))


def _reduce(X: torch.Tensor, x2: torch.Tensor, valid, labels: Optional[torch.Tensor],
            eps2: torch.Tensor, sent: int, block: int) -> torch.Tensor:
    """Over column tiles of `block`: the degree of every row (`labels` None:
    the prep pass), else the least label of its in-eps neighbours, `sent`
    where it has none.  Columns of `valid` 0 are no neighbours (`valid`
    None: every column is valid).  The JAX package computes both in every
    pass; each pass here computes the one it uses."""
    n = X.shape[0]
    if labels is None:
        out = torch.zeros(n, dtype=torch.int32, device=X.device)
    else:
        out = torch.full((n,), sent, dtype=torch.int32, device=X.device)
    q2 = x2[:, None]
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        adj = sqdist(X, X[lo:hi], q2=q2, x2=x2[lo:hi]) <= eps2
        if valid is not None:
            adj &= (valid[lo:hi] > 0)[None, :]
        if labels is None:
            out += adj.sum(dim=1, dtype=torch.int32)
        else:
            lab = torch.where(adj, labels[lo:hi][None, :], sent)
            torch.minimum(out, lab.amin(dim=1), out=out)
    return out


def dbscan_fit_predict(X: torch.Tensor, valid: torch.Tensor, eps: float, min_samples: int,
                       max_sweeps: int = 64, adj_budget: int = _ADJ_BUDGET,
                       block: int = _BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels (N,) int32, core mask (N,) bool) of the rows of X; rows of
    `valid` 0 are absent.  Labels are the least row index of each
    cluster's core rows, -1 for noise; the models layer renumbers them."""
    n = int(X.shape[0])
    sent = n
    block = tile_width(n, adj_budget, block)
    eps_t = torch.tensor(eps, dtype=X.dtype, device=X.device)
    eps2 = eps_t * eps_t  # rounded in X's dtype, as the JAX package squares it
    x2 = (X * X).sum(dim=1)
    rows = torch.arange(n, dtype=torch.int32, device=X.device)
    # invalid columns count in no degree; they are never core, so the
    # sweeps and the border pass, which read core labels only, need no mask
    cols = None if bool((valid > 0).all()) else valid
    deg = _reduce(X, x2, cols, None, eps2, sent, block)
    core = (deg >= int(min_samples)) & (valid > 0)
    labels = torch.where(core, rows, sent)
    sweeps = 0
    for sweeps in range(1, max_sweeps + 1):
        cand = _reduce(X, x2, None, torch.where(core, labels, sent), eps2, sent, block)
        new = torch.where(core, torch.minimum(labels, cand), labels)
        # pointer jumping: follow the representative one hop
        hop = torch.where(new < sent, new[new.clamp(0, n - 1).long()], sent)
        new = torch.minimum(new, hop)
        changed = bool((new != labels).any())  # the fetch is the sweep's sync
        labels = new
        if not changed:
            break
    cand = _reduce(X, x2, None, torch.where(core, labels, sent), eps2, sent, block)
    out = torch.where(core, labels, torch.where(cand < sent, cand, -1))
    out = torch.where(valid > 0, out, -1).to(torch.int32)
    LAST_RUN.clear()
    LAST_RUN.update(block=block, tiles_per_pass=-(-n // block), sweeps=sweeps)
    return out, core
