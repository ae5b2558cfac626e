#
# KMeans: the port of spark_rapids_ml_tpu/ops/kmeans.py.  Seeding
# (Gumbel-max k-means++, "random" Gumbel top-k, and k-means|| with a
# best-of-`_REDUCE_TRIALS` k-means++ reduction of its candidate pool) and
# Lloyd iterations, as torch ops on cuBLAS: the assignment is one IEEE
# float32 `X @ C^T` per row block (`ieee_matmul`), then a min over the
# centres; the update is `index_add_`, not the JAX package's one-hot
# matmul, which at k = 1000 costs as many operations as the assignment.
#
# One solver runs in both branches of `kmeans_fit_auto`'s gate: a Lloyd
# driven from the host, one fetch of the centre shift per iteration (as
# the JAX package's stepwise solver).  The gate still decides two things:
# whether the seeding sees every row or every `stride`-th one
# (`kmeans_fit_stepwise`), and the name of the branch.
#
# Four things differ from the JAX package, each deliberate (ROADMAP.md
# section 3):
# - The Gumbel source.  `jax.random` cannot be reproduced in torch; the
#   port draws U from a `torch.Generator` seeded from `seed` on the data's
#   device and forms -log(-log(U)).  `init_centers=` hands in centres
#   seeded elsewhere (the tests hand in the JAX package's).
# - The summation rule of the update.  Each row block (at most
#   `_MAX_BLOCK_ROWS` rows, and a (rows, k) distance tile of at most
#   `_TILE_BYTES`) sums its rows into partials in the data's dtype with
#   `index_add_`; the partials, the weights and the cost are combined
#   across blocks in float64.  On a card `index_add_` adds with atomics,
#   so the order within a block changes from run to run: two float32 fits
#   agree to the rounding of one block's partial sums, not bit for bit.
# - The row norms ||x||^2 are computed once per fit, not once per pass.
# - A pass that assigns every row as the pass before stops the fit with
#   the centres it had (`_lloyd`): what the JAX package's deterministic
#   update gives, where atomics would move the centres by a rounding.
#
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .precision import ieee_matmul

# Rows of weight 0 are never sampled and add nothing to any sum or cost.
SUPPORTS_ZERO_WEIGHT_ROWS = True

# independent k-means++ reductions of the k-means|| candidate pool; the
# lowest weighted cost wins (the JAX package's measured rule: one draw
# misses a whole cluster about 7% of the time on separated blobs)
_REDUCE_TRIALS = 8

# bytes of one (rows, k) distance tile, and rows of one block's partials
_TILE_BYTES = 1 << 28
_MAX_BLOCK_ROWS = 1 << 20

# The last fit: branch, seeding rows and stride, block rows, iterations,
# the cost of every pass (the last one under the final centres), and the
# rows each Lloyd pass moved to another centre.
LAST_FIT: dict = {}


# ---------------------------------------------------------------------------
# distances and assignment
# ---------------------------------------------------------------------------


def _pairwise_sqdist(X: torch.Tensor, C: torch.Tensor,
                     x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, k) squared euclidean distances by the matmul identity,
    x2 - 2 X C^T + c2 clamped at 0, the product in IEEE float32."""
    if x2 is None:
        x2 = (X * X).sum(dim=1)
    c2 = (C * C).sum(dim=1)
    with ieee_matmul():
        d2 = torch.addmm(x2[:, None], X, C.T, alpha=-2.0)
    return d2.add_(c2).clamp_(min=0.0)


def _row_blocks(n: int, rows: int):
    for lo in range(0, n, rows):
        yield slice(lo, min(lo + rows, n))


def _tile_rows(k: int, itemsize: int) -> int:
    """Rows of one (rows, k) distance tile of at most `_TILE_BYTES`."""
    return max(1, _TILE_BYTES // max(k * itemsize, 1))


def assign(X: torch.Tensor, C: torch.Tensor, x2: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels int64, min squared distance) of each row of X: the nearest
    centre, the first one on ties."""
    min_d2, labels = torch.min(_pairwise_sqdist(X, C, x2), dim=1)
    return labels, min_d2


def _sqdist_to_point(X: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """||x - c||^2 of every row, by differences (the JAX package's form),
    over row blocks."""
    out = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    for rows in _row_blocks(X.shape[0], _tile_rows(X.shape[1], X.element_size())):
        out[rows] = ((X[rows] - c) ** 2).sum(dim=1)
    return out


def _min_sqdist(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """min over the centres of the squared distance, over row blocks."""
    out = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    for rows in _row_blocks(X.shape[0], _tile_rows(C.shape[0], X.element_size())):
        out[rows] = _pairwise_sqdist(X[rows], C).min(dim=1).values
    return out


def _argmin_centres(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    out = torch.empty(X.shape[0], dtype=torch.int64, device=X.device)
    for rows in _row_blocks(X.shape[0], _tile_rows(C.shape[0], X.element_size())):
        out[rows] = assign(X[rows], C)[0]
    return out


# ---------------------------------------------------------------------------
# seeding
# ---------------------------------------------------------------------------


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)


def gumbel(n: int, gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """n standard Gumbel variates -log(-log(U)) on `like`'s device and
    dtype, U uniform from `gen`, kept inside (0, 1)."""
    fi = torch.finfo(like.dtype)
    u = torch.rand(n, generator=gen, dtype=like.dtype, device=like.device)
    u.clamp_(min=fi.tiny, max=1.0 - fi.eps / 2)
    return -torch.log(-torch.log(u))


def _log_weights(w: torch.Tensor) -> torch.Tensor:
    """log w, and -inf for rows of weight 0 (never sampled)."""
    return torch.where(w > 0, torch.log(torch.clamp_min(w, 1e-30)),
                       torch.full_like(w, -float("inf")))


def _d2_logits(d2: torch.Tensor) -> torch.Tensor:
    """log D^2, and -inf where D^2 = 0 (rows already chosen)."""
    return torch.where(d2 > 0, torch.log(torch.clamp_min(d2, 1e-30)),
                       torch.full_like(d2, -float("inf")))


def _kmeanspp(X: torch.Tensor, log_w: torch.Tensor, k: int, seeds) -> torch.Tensor:
    """Sequential Gumbel-max k-means++, one draw per seed in `seeds`,
    batched on a leading dimension: (T, k, d) centres.  Draw t is the
    centres `kmeans_init(X, w, k, seeds[t], "k-means++")` gives."""
    n, d = X.shape
    gens = [_generator(s, X.device) for s in seeds]
    T = len(gens)
    trial = torch.arange(T, device=X.device)

    def draw():
        return torch.stack([gumbel(n, g, X) for g in gens])

    idx = torch.argmax(draw() + log_w, dim=1)
    centers = torch.zeros((T, k, d), dtype=X.dtype, device=X.device)
    c = X[idx]
    centers[:, 0] = c
    d2 = ((X[None] - c[:, None]) ** 2).sum(dim=2)
    for i in range(1, k):
        idx = torch.argmax(_d2_logits(d2) + log_w + draw(), dim=1)
        c = X[idx]
        centers[trial, i] = c
        d2 = torch.minimum(d2, ((X[None] - c[:, None]) ** 2).sum(dim=2))
    return centers


def kmeans_init(X: torch.Tensor, w: torch.Tensor, k: int, seed,
                init: str = "k-means++") -> torch.Tensor:
    """Seed k centres.  "k-means++": sequential D^2-weighted sampling by
    Gumbel-max; "random": Gumbel top-k, uniform over rows of weight > 0
    (weights act as sampling probabilities)."""
    log_w = _log_weights(w)
    if init == "random":
        g = gumbel(X.shape[0], _generator(seed, X.device), X)
        return X[torch.topk(g + log_w, k).indices]
    return _kmeanspp(X, log_w, k, [int(seed)])[0]


def kmeans_parallel_init(X: torch.Tensor, w: torch.Tensor, k: int, seed,
                         rounds: int = 2, m: int = 4) -> torch.Tensor:
    """k-means|| (Bahmani et al.): a first row uniform over rows of weight
    > 0, then `rounds` rounds of m candidates drawn at once from the D^2
    distribution (Gumbel top-m), the pool of 1 + rounds m candidates
    weighted by the mass it attracts, reduced to k centres by
    `_REDUCE_TRIALS` weighted k-means++ draws (seeds seed + 1 ...); the
    draw of least weighted cost over the pool wins."""
    n, d = X.shape
    gen = _generator(seed, X.device)
    log_w = _log_weights(w)
    c0 = X[torch.argmax(gumbel(n, gen, X) + log_w)]
    pool = torch.zeros((1 + rounds * m, d), dtype=X.dtype, device=X.device)
    pool[0] = c0
    d2 = _sqdist_to_point(X, c0)
    for r in range(rounds):
        idx = torch.topk(_d2_logits(d2) + log_w + gumbel(n, gen, X), m).indices
        new = X[idx]
        pool[1 + r * m:1 + (r + 1) * m] = new
        # chosen rows have D^2 = 0, so -inf logits: never chosen again
        d2 = torch.minimum(d2, _min_sqdist(X, new))
    labels = _argmin_centres(X, pool)
    counts = torch.zeros(pool.shape[0], dtype=X.dtype, device=X.device).index_add_(0, labels, w)
    seed = int(seed)
    trials = _kmeanspp(pool, _log_weights(counts), k, [seed + 1 + t for t in range(_REDUCE_TRIALS)])
    costs = torch.stack([(_min_sqdist(pool, Ct) * counts).sum() for Ct in trials])
    return trials[torch.argmin(costs)]


def seed_sample_stride(n_total: int, init_rows: int) -> int:
    """Global row stride for the seeding subsample: every `stride`-th
    row of the dataset enters the k-means|| init, keeping the sampled
    pool at <= `init_rows` rows."""
    return max(1, -(-int(n_total) // max(int(init_rows), 1)))


def init_flops_accounting(
    init: str, k: int, d: int, init_steps: int, oversample: float
) -> tuple:
    """Shared init cost model: (rounds, m, flops_per_row) for a given
    init scheme, the JAX package's verbatim: it sizes the fused-vs-stepwise
    gate, the stepwise seeding subsample and the k-means|| pool.
      scalable: `rounds` D2 passes vs m candidates + one labeling pass
                vs the 1 + rounds*m pool
      random:   one Gumbel top-k pass, no matmuls
      k-means++: k sequential D2 passes
    """
    rounds = max(init_steps, 1)
    # per-round draw: l = oversample*k (Spark/cuML's oversampling
    # factor), bumped so the candidate pool can cover k centers
    m = max(int(round(oversample * k)), -(-(k - 1) // rounds), 1)
    if init in ("scalable-k-means++", "k-means||"):
        per_row = 2.0 * d * (rounds * m + (1 + rounds * m))
    elif init == "random":
        per_row = 1.0
    else:  # sequential k-means++
        per_row = 2.0 * d * k
    return rounds, m, per_row


def _seed(X, w, k, seed, init, init_steps, oversample) -> torch.Tensor:
    if init in ("scalable-k-means++", "k-means||"):
        rounds, m, _ = init_flops_accounting(init, k, X.shape[1], init_steps, oversample)
        return kmeans_parallel_init(X, w, k, seed, rounds=rounds, m=min(m, int(X.shape[0])))
    return kmeans_init(X, w, k, seed, init)


# ---------------------------------------------------------------------------
# Lloyd
# ---------------------------------------------------------------------------


def block_rows(n: int, d: int, k: int, itemsize: int, block: int) -> int:
    """Rows of one Lloyd block: the JAX package's block (`flops_budget //
    2 d k` rows), cut to `_MAX_BLOCK_ROWS` and to a distance tile of
    `_TILE_BYTES`."""
    return max(1, min(int(block), n, _MAX_BLOCK_ROWS, _tile_rows(k, itemsize)))


def _lloyd_block_step(acc, Xb, wb, x2b, C, unweighted: bool, prev=None):
    """Assignment and weighted partial sums of one row block, added to
    acc = (sums (k, d), counts (k,), cost (), moved ()) in float64 (moved:
    int64), in place.  `prev` holds the block's labels of the pass before;
    the rows whose label changed are counted, and `prev` takes the new
    labels."""
    sums, counts, cost, moved = acc
    labels, min_d2 = assign(Xb, C, x2b)
    k, d = C.shape
    part = torch.zeros((k, d), dtype=Xb.dtype, device=Xb.device)
    part.index_add_(0, labels, Xb if unweighted else Xb * wb[:, None])
    sums += part
    counts += torch.zeros(k, dtype=Xb.dtype, device=Xb.device).index_add_(0, labels, wb)
    cost += (min_d2 * wb).sum(dtype=torch.float64)
    if prev is not None:
        moved += (labels != prev).sum()
        prev.copy_(labels)


def lloyd_pass(X, w, C, x2, rows: int, unweighted: bool, prev=None):
    """One pass over X under centres C: (sums (k, d), counts (k,), cost (),
    moved ()) on X's device, the first three in float64; moved counts the
    rows whose label differs from `prev` (n,) int32, which takes the
    pass's labels (0 without `prev`)."""
    k, d = C.shape
    acc = (torch.zeros((k, d), dtype=torch.float64, device=X.device),
           torch.zeros(k, dtype=torch.float64, device=X.device),
           torch.zeros((), dtype=torch.float64, device=X.device),
           torch.zeros((), dtype=torch.int64, device=X.device))
    for b in _row_blocks(X.shape[0], rows):
        _lloyd_block_step(acc, X[b], w[b], x2[b], C, unweighted,
                          None if prev is None else prev[b])
    return acc


def _lloyd_center_update(C, sums, counts):
    """New centres (sums / counts; a centre of weight 0 stays), in C's
    dtype, and the largest squared shift."""
    safe = torch.where(counts > 0, counts, torch.ones_like(counts))
    new_C = torch.where(counts[:, None] > 0, sums / safe[:, None], C.to(sums.dtype)).to(C.dtype)
    shift2 = ((new_C - C) ** 2).sum(dim=1).max()
    return new_C, shift2


def row_norms(X: torch.Tensor) -> torch.Tensor:
    out = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    for b in _row_blocks(X.shape[0], _tile_rows(X.shape[1], X.element_size())):
        out[b] = (X[b] * X[b]).sum(dim=1)
    return out


def _lloyd(X, w, C, max_iter: int, tol: float, block: int, start_it: int = 0,
           checkpoint_path: Optional[str] = None, checkpoint_tag: str = "",
           fault_site: bool = False):
    """Host-driven Lloyd from centres C (after `start_it` iterations): stop
    after `max_iter` updates or once every centre moves less than `tol`
    (euclidean, Spark's rule); the cost is taken under the final centres.
    (centres, cost, n_iter).  With `checkpoint_path` the centres (float64)
    and the iteration are saved after every iteration, and the file removed
    at the end; `fault_site` fires `kmeans_lloyd` before each iteration
    (the stepwise branch, as in the JAX package).

    A pass that assigns every row as the pass before ends the fit with the
    centres it had: the JAX package's update then gives the same centres
    bit for bit (a shift of 0), while atomics summing in another order
    would move them by a rounding and never let a tight `tol` stop.  A
    resumed fit has no labels of the pass before, so its first pass always
    updates."""
    from ..resilience import faults
    from ..resilience.checkpoint import clear_checkpoint, save_checkpoint

    n, d = X.shape
    k = C.shape[0]
    rows = block_rows(n, d, k, X.element_size(), block)
    x2 = row_norms(X)
    unweighted = bool((w == 1).all())
    labels = torch.full((n,), -1, dtype=torch.int32, device=X.device)
    costs, moves = [], []
    n_iter = start_it
    for n_iter in range(start_it + 1, max_iter + 1):
        if fault_site:
            faults.maybe_inject("kmeans_lloyd")
        sums, counts, cost, moved = lloyd_pass(X, w, C, x2, rows, unweighted, labels)
        costs.append(cost)
        new_C, shift2 = _lloyd_center_update(C, sums, counts)
        # one fetch, the iteration's sync
        shift2, moved = torch.stack([shift2.to(torch.float64), moved.to(torch.float64)]).tolist()
        moves.append(int(moved))
        stop = moved == 0
        if not stop:
            C = new_C
            stop = shift2 <= tol * tol
        if checkpoint_path:
            save_checkpoint(checkpoint_path, checkpoint_tag,
                            {"centers": C.cpu().numpy().astype(np.float64), "it": n_iter})
        if stop:
            break
    del labels
    cost = lloyd_pass(X, w, C, x2, rows, unweighted)[2]
    costs.append(cost)
    if checkpoint_path:
        clear_checkpoint(checkpoint_path)
    LAST_FIT.update(rows=rows, n_iter=n_iter, costs=[float(c) for c in costs], moved=moves,
                    unweighted=unweighted)
    return C, cost.to(X.dtype), n_iter


def _as_centres(init_centers, X: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.asarray(init_centers), dtype=X.dtype, device=X.device)


def kmeans_fit(X: torch.Tensor, w: torch.Tensor, k: int, seed, max_iter: int = 300,
               tol: float = 1e-4, init: str = "scalable-k-means++", init_steps: int = 2,
               oversample: float = 2.0, init_centers=None):
    """The fused branch of the gate: seeding on every row, then Lloyd.

    Returns (centers (k, d), cost (weighted inertia), n_iter).
    `init_centers` (k, d) replaces the seeding."""
    LAST_FIT.clear()
    LAST_FIT.update(stepwise=False, init_rows=int(X.shape[0]), stride=1)
    C = _as_centres(init_centers, X) if init_centers is not None else _seed(
        X, w, k, seed, init, init_steps, oversample)
    return _lloyd(X, w, C, max_iter, tol, block=int(X.shape[0]))


def kmeans_fit_stepwise(X: torch.Tensor, w: torch.Tensor, k: int, seed, max_iter: int = 300,
                        tol: float = 1e-4, init: str = "scalable-k-means++",
                        init_steps: int = 2, oversample: float = 2.0,
                        flops_budget: float = 2e12, init_rows: int = 262_144,
                        init_centers=None, checkpoint_path: Optional[str] = None,
                        checkpoint_tag: str = ""):
    """The stepwise branch of the gate: when the init's D^2 passes would
    exceed `flops_budget`, seeding runs on every `stride`-th row, at most
    `init_rows` rows ("random" never subsamples); Lloyd blocks are
    `flops_budget // 2 d k` rows.  Same outputs as `kmeans_fit`.  With
    `checkpoint_path` the centres are saved after every iteration, and a
    saved state of `checkpoint_tag` is resumed instead of seeding."""
    from ..resilience import metrics
    from ..resilience.checkpoint import load_checkpoint

    n, d = X.shape
    rounds, m, per_row = init_flops_accounting(init, k, d, init_steps, oversample)
    n_init_max = max(int(flops_budget // per_row), k)
    n_init = min(n, init_rows if per_row > 1.0 else n, n_init_max)
    stride = max(1, -(-n // n_init)) if n_init < n else 1
    LAST_FIT.clear()
    LAST_FIT.update(stepwise=True, stride=stride, init_rows=-(-n // stride))
    start_it = 0
    resumed = load_checkpoint(checkpoint_path, checkpoint_tag) if checkpoint_path else None
    if resumed is not None:
        # the centres persist in float64; the passes run in X's dtype
        C = _as_centres(resumed["centers"], X)
        start_it = int(resumed["it"])
        metrics.event("kmeans_resume", detail=f"it={start_it}")
    elif init_centers is not None:
        C = _as_centres(init_centers, X)
    else:
        Xs, ws = (X[::stride].contiguous(), w[::stride].contiguous()) if stride > 1 else (X, w)
        C = _seed(Xs, ws, k, seed, init, init_steps, oversample)
    block = max(1, min(n, int(flops_budget // max(2.0 * d * k, 1.0))))
    return _lloyd(X, w, C, max_iter, tol, block=block, start_it=start_it,
                  checkpoint_path=checkpoint_path, checkpoint_tag=checkpoint_tag,
                  fault_site=True)


def kmeans_fit_auto(X: torch.Tensor, w: torch.Tensor, k: int, seed, max_iter: int = 300,
                    tol: float = 1e-4, init: str = "scalable-k-means++", init_steps: int = 2,
                    oversample: float = 2.0, budget: Optional[float] = None,
                    init_centers=None, checkpoint_path: Optional[str] = None,
                    checkpoint_tag: str = ""):
    """The JAX package's gate: the fused branch while
    `2 n d k max_iter + n init_per_row` operations fit the budget
    (`dispatch_flops_limit` when `budget` is None) and no `checkpoint_path`
    is given, else the stepwise one (the branch that checkpoints).
    Returns (centers, cost, n_iter, used_stepwise)."""
    if budget is None:
        from ..config import get_config

        budget = float(get_config("dispatch_flops_limit"))
    n, d = int(X.shape[0]), int(X.shape[1])
    _, _, init_per_row = init_flops_accounting(init, k, d, init_steps, oversample)
    fused_flops = 2.0 * n * d * k * max(max_iter, 1) + n * init_per_row
    kwargs = dict(k=k, seed=seed, max_iter=max_iter, tol=tol, init=init,
                  init_steps=init_steps, oversample=oversample, init_centers=init_centers)
    if fused_flops <= budget and not checkpoint_path:
        return (*kmeans_fit(X, w, **kwargs), False)
    return (*kmeans_fit_stepwise(X, w, flops_budget=budget, checkpoint_path=checkpoint_path,
                                 checkpoint_tag=checkpoint_tag, **kwargs), True)


def kmeans_predict(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The nearest centre of each row, int32."""
    return _argmin_centres(X, C).to(torch.int32)


def kmeans_cost(X: torch.Tensor, w: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Weighted sum of squared distances to the closest centre (Spark's
    `summary.trainingCost`), summed in float64, in X's dtype."""
    return (_min_sqdist(X, C).to(torch.float64) * w).sum().to(X.dtype)
