#
# UMAP's fit and transform ops: the port of spark_rapids_ml_tpu/ops/umap.py.
#
#   find_ab_params           the least-squares fit of 1 / (1 + a d^(2b)) to
#                            the min_dist / spread membership curve (host
#                            scipy, once a fit; a copy of the JAX package's);
#   smooth_knn_dist          each point's rho (distance to its
#                            local_connectivity-th neighbour) and sigma (a
#                            64-step bisection), sigma floored at 1e-3 of
#                            the mean neighbour distance;
#   fuzzy_simplicial_set     the directed memberships and their union with
#                            the reverse edge's, found in the tail's own
#                            neighbour list (an (n k, k) gather, never an
#                            (n, n) matrix);
#   categorical_intersection the supervised fit's label scaling and reset
#                            of local connectivity;
#   transform_init           a new point's embedding: the membership-weighted
#                            mean of its neighbours' embeddings;
#   optimize_embedding       umap-learn's SGD, every edge each epoch, in one
#                            of two forms: the generic epoch (`index_add_`
#                            scatters) or the structured epoch for the
#                            head-major edge list (sums over k and one sorted
#                            segment sum, no atomics).
#
# Torch ops on the device of the data, no hand-written kernel.  What
# differs from the JAX package, each on purpose (ROADMAP.md section 3):
# - The draws.  `jax.random` cannot be reproduced in torch: each epoch's
#   negative samples come from one `torch.Generator` seeded from `seed` on
#   the data's device, carried across epochs.  `draws=` hands in others
#   (the JAX package's, rebuilt from its keys, in the tests).
# - The prior.  Where `umap_kernel` is "auto" and no probe decides, the JAX
#   package takes the structured form on a TPU; the port takes it on a
#   card, where it is the one form whose sums use no atomics, so that two
#   fits with one `random_state` are bit-equal; on the CPU the generic
#   form, as the JAX package's CPU choice.
# - No dispatch chunks.  The JAX package cut the epochs into programs of
#   about 20 s of device time for its transport's deadline; here every
#   epoch's ops are launched from the host anyway, and the generator is
#   carried from epoch to epoch, so a split into chunks would change
#   nothing but the number of syncs: the epochs run back to back.
#
from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# bytes of one block of the reverse-edge gather (rows x k x k ids and
# weights)
_BLOCK_BYTES = 256 << 20


def find_ab_params(spread: float, min_dist: float) -> Tuple[float, float]:
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros(xv.shape)
    yv[xv < min_dist] = 1.0
    mask = xv >= min_dist
    yv[mask] = np.exp(-(xv[mask] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


def smooth_knn_dist(
    knn_dists: torch.Tensor,  # (n, k) ascending, self excluded
    local_connectivity: int = 1,
    n_iter: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point (rho, sigma): rho = distance to the local_connectivity-th
    neighbour; sigma solves sum_j exp(-(d_j - rho) / sigma) = log2(k)."""
    n, k = knn_dists.shape
    dt, dev = knn_dists.dtype, knn_dists.device
    rho = knn_dists[:, local_connectivity - 1]
    target = float(torch.tensor(math.log2(k), dtype=dt))
    d = torch.clamp(knn_dists - rho[:, None], min=0.0)
    lo = torch.full((n,), 1e-10, dtype=dt, device=dev)
    hi = torch.full((n,), 1e4, dtype=dt, device=dev)
    mid = torch.ones((n,), dtype=dt, device=dev)
    for _ in range(n_iter):
        above = torch.exp(-d / mid[:, None]).sum(dim=1) > target
        hi = torch.where(above, mid, hi)
        lo = torch.where(above, lo, mid)
        mid = (lo + hi) / 2.0
    # umap-learn floors sigma at a fraction of the mean neighbour distance
    mean_d = torch.clamp(knn_dists.mean(), min=1e-10)
    return rho, torch.maximum(mid, 1e-3 * mean_d)


def _reverse_weights(knn_inds: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n k,) weight of each edge's reverse: for edge (i -> j = knn[i, a]),
    the weight j gives i in j's own neighbour list, 0 where j does not list
    i.  Rows in blocks of about `_BLOCK_BYTES` of gathered lists."""
    n, k = knn_inds.shape
    out = torch.empty(n * k, dtype=w.dtype, device=w.device)
    per_row = max(k * k * (knn_inds.element_size() + 2 * w.element_size() + 1), 1)
    step = max(1, _BLOCK_BYTES // per_row)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        tails = knn_inds[lo:hi].reshape(-1)
        heads = torch.arange(lo, hi, dtype=knn_inds.dtype,
                             device=knn_inds.device).repeat_interleave(k)
        match = knn_inds[tails] == heads[:, None]  # (rows k, k)
        out[lo * k : hi * k] = torch.where(match, w[tails], 0.0).amax(dim=1)
    return out


def fuzzy_simplicial_set(
    knn_inds: torch.Tensor,  # (n, k) neighbour row indices
    knn_dists: torch.Tensor,  # (n, k)
    rho: torch.Tensor,
    sigma: torch.Tensor,
    set_op_mix_ratio: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Directed memberships and their symmetrization: the edge list
    (heads (n k,), tails (n k,), weights (n k,)), head-major (heads =
    repeat(arange(n), k), the structure the structured epoch needs).  Edge
    (i -> j) carries mix (a + b - a b) + (1 - mix) a b, a = w(i -> j),
    b = w(j -> i) (0 where j does not list i)."""
    n, k = knn_inds.shape
    w = torch.exp(-torch.clamp(knn_dists - rho[:, None], min=0.0) / sigma[:, None])
    heads = torch.arange(n, dtype=knn_inds.dtype, device=knn_inds.device).repeat_interleave(k)
    tails = knn_inds.reshape(-1)
    w_fwd = w.reshape(-1)
    w_rev = _reverse_weights(knn_inds, w)
    mix = set_op_mix_ratio
    sym = mix * (w_fwd + w_rev - w_fwd * w_rev) + (1.0 - mix) * (w_fwd * w_rev)
    return heads, tails, sym


def categorical_intersection(
    knn_inds: torch.Tensor,  # (n, k), edge-list order
    heads: torch.Tensor,  # (n k,)
    tails: torch.Tensor,  # (n k,)
    weights: torch.Tensor,  # (n k,) symmetrized memberships
    labels: torch.Tensor,  # (n,) int codes; -1 = unknown
    unknown_dist: float = 1.0,
    far_dist: float = 5.0,
) -> torch.Tensor:
    """Supervised (categorical) simplicial set intersection (umap-learn's
    `categorical_simplicial_set_intersection` + `reset_local_connectivity`):
    edges between differently labelled points are scaled by exp(-far_dist),
    edges touching an unknown (-1) label by exp(-unknown_dist); then each
    head's weights are divided by their max and united with the reverse
    edge's (looked up in the tail's list as in `fuzzy_simplicial_set`)."""
    n, k = knn_inds.shape
    dt = weights.dtype
    li = labels[heads.long()]
    lj = labels[tails.long()]
    unknown = (li < 0) | (lj < 0)
    e_unknown = float(torch.exp(torch.tensor(-unknown_dist, dtype=dt)))
    e_far = float(torch.exp(torch.tensor(-far_dist, dtype=dt)))
    scale = torch.ones_like(weights).masked_fill_(li != lj, e_far).masked_fill_(unknown, e_unknown)
    wmat = (weights * scale).reshape(n, k)
    wn = wmat / torch.clamp(wmat.amax(dim=1), min=1e-12)[:, None]
    w_fwd = wn.reshape(-1)
    w_rev = _reverse_weights(knn_inds, wn)
    return w_fwd + w_rev - w_fwd * w_rev


def transform_init(
    knn_inds: torch.Tensor,  # (q, k) indices into the training rows
    knn_dists: torch.Tensor,  # (q, k)
    rho: torch.Tensor,  # (n,) training rho
    sigma: torch.Tensor,  # (n,) training sigma
    train_emb: torch.Tensor,  # (n, dim)
) -> torch.Tensor:
    """New points' embeddings: the membership-weighted mean of their
    training neighbours' embeddings, each membership with the NEIGHBOUR's
    rho and sigma (umap-learn's transform init)."""
    inds = knn_inds.long()
    w = torch.exp(-torch.clamp(knn_dists - rho[inds], min=0.0) / sigma[inds])
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
    return (w[:, :, None] * train_emb[inds]).sum(dim=1)


def _activity(freq: torch.Tensor, e: int) -> torch.Tensor:
    """The floor-crossing schedule, umap-learn's epochs_per_sample
    countdown: an edge of frequency f is sampled in epoch e when
    floor((e + 1) f) > floor(e f)."""
    return (torch.floor((e + 1.0) * freq) > torch.floor(float(e) * freq)).to(freq.dtype)


def _attract_coeff(d2: torch.Tensor, c: float, a: float, b: float, bm1: float) -> torch.Tensor:
    """-2ab d^(2(b-1)) / (1 + a d^(2b)) (c = -2ab, bm1 = b - 1), 0 where
    d = 0."""
    gc = (c * d2**bm1) / (1.0 + a * d2**b)
    return torch.where(d2 > 0.0, gc, 0.0)


def _repulse(diff_n: torch.Tensor, d2n: torch.Tensor, co) -> torch.Tensor:
    """The negative samples' clipped gradients: coincident but distinct
    points get the largest push (4); the caller zeroes self-collisions."""
    rep = co.rep / ((0.001 + d2n) * (1.0 + co.a * d2n**co.b))
    gn = torch.clamp(rep[..., None] * diff_n, -4.0, 4.0)
    return torch.where(d2n[..., None] > 0.0, gn, 4.0)


class _Coeffs(NamedTuple):
    """The curve's scalars, each rounded to the embedding's dtype as the
    JAX package's weakly typed arithmetic rounds them: a, b, c = -2ab,
    bm1 = b - 1, rep = 2 repulsion_strength b."""

    a: float
    b: float
    c: float
    bm1: float
    rep: float


def _coeffs(a: float, b: float, repulsion_strength: float, dt: torch.dtype) -> _Coeffs:
    a_t, b_t = torch.tensor(a, dtype=dt), torch.tensor(b, dtype=dt)
    return _Coeffs(float(a_t), float(b_t), float(-2.0 * a_t * b_t), float(b_t - 1.0),
                   float(torch.tensor(2.0 * repulsion_strength, dtype=dt) * b_t))


def _epoch_generic(emb, heads, tails, freq, neg, e: int, alpha: float, co: _Coeffs):
    """One epoch over the edge list (heads, tails) of any order: the
    attract step scatters to heads and tails with `index_add_` (atomics on
    a card, in another order every run), then the heads are gathered anew
    and their `neg` (E, nsr) negative samples repel them."""
    act = _activity(freq, e)
    diff = emb[heads] - emb[tails]
    d2 = (diff * diff).sum(dim=1)
    gc = _attract_coeff(d2, co.c, co.a, co.b, co.bm1)
    g = torch.clamp(gc[:, None] * diff, -4.0, 4.0) * act[:, None]
    emb = emb.index_add(0, heads, alpha * g)
    emb = emb.index_add(0, tails, (-alpha) * g)
    diff_n = emb[heads][:, None, :] - emb[neg]  # (E, nsr, dim)
    d2n = (diff_n * diff_n).sum(dim=2)
    gn = _repulse(diff_n, d2n, co)
    gn = torch.where((neg == heads[:, None])[:, :, None], 0.0, gn) * act[:, None, None]
    return emb.index_add(0, heads, alpha * gn.sum(dim=1))


def _epoch_structured(emb, tails2d, freq2d, perm, lengths, neg, e: int, alpha: float,
                      co: _Coeffs):
    """One epoch over the head-major edge list (heads = repeat(arange(n),
    k)): the head sums are sums over k, negatives repel heads only, and the
    tail-side attract, the one real scatter, is a segment sum of the edges
    sorted by tail (`perm`, `lengths`: fixed for the fit), which adds each
    segment in order and uses no atomics.  Equal to `_epoch_generic` on the
    same draws up to the order of the sums."""
    n, k = tails2d.shape
    dim = emb.shape[1]
    act = _activity(freq2d, e)  # (n, k)
    diff = emb[:, None, :] - emb[tails2d]  # (n, k, dim)
    d2 = (diff * diff).sum(dim=2)
    gc = _attract_coeff(d2, co.c, co.a, co.b, co.bm1)
    g = torch.clamp(gc[:, :, None] * diff, -4.0, 4.0) * act[:, :, None]
    tail_add = torch.segment_reduce(g.reshape(n * k, dim)[perm], "sum", lengths=lengths,
                                    axis=0, unsafe=True)
    emb = emb + alpha * (g.sum(dim=1) - tail_add)
    neg = neg.reshape(n, k, -1)
    diff_n = emb[:, None, None, :] - emb[neg]  # (n, k, nsr, dim)
    d2n = (diff_n * diff_n).sum(dim=3)
    gn = _repulse(diff_n, d2n, co)
    self_ids = torch.arange(n, dtype=neg.dtype, device=neg.device)
    gn = torch.where((neg == self_ids[:, None, None])[..., None], 0.0, gn)
    gn = gn * act[:, :, None, None]
    # each edge's samples first, as the generic form sums them
    return emb + alpha * gn.sum(dim=2).sum(dim=1)


# The last optimize_embedding call's form and why (the umap_kernel=auto
# measured probe), with the probe's warm epoch seconds (None: no probe).
LAST_KERNEL_DECISION: dict = {
    "kernel": None,
    "decided_by": None,
    "warm_epoch_sec_generic": None,
    "warm_epoch_sec_structured": None,
}

Draws = Union[Callable[[int], object], Sequence[object]]


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class _Epochs:
    """The SGD's state between epochs: the embedding, the generator (or
    the handed-in draws) and the per-form edge arrays, so that epochs can
    run in any split, one form or the other, with the same result."""

    def __init__(self, emb, heads, tails, weights, seed, n_epochs, a, b, initial_alpha,
                 negative_sample_rate, repulsion_strength, draws):
        dev, dt = emb.device, emb.dtype
        self.emb = emb
        self.n, self.E = emb.shape[0], int(heads.shape[0])
        self.heads, self.tails = heads.long(), tails.long()
        self.n_epochs = int(n_epochs)
        self.co = _coeffs(a, b, repulsion_strength, dt)
        self.alpha0 = float(initial_alpha)
        self.nsr = int(negative_sample_rate)
        self.draws = draws
        self.gen = None
        if draws is None:
            self.gen = torch.Generator(device=dev).manual_seed(
                int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
        # umap-learn: edges with weight < max / n_epochs are never sampled
        wmax = torch.clamp(weights.max(), min=1e-12)
        self.freq = torch.where(weights >= wmax / self.n_epochs, weights / wmax, 0.0)
        self.structured_arrays = None

    def prepare_structured(self) -> None:
        if self.structured_arrays is None:
            k = self.E // self.n
            perm = torch.argsort(self.tails, stable=True)  # once a fit: tails are fixed
            lengths = torch.bincount(self.tails, minlength=self.n)
            self.structured_arrays = (self.tails.reshape(self.n, k),
                                      self.freq.reshape(self.n, k), perm, lengths)

    def _neg(self, e: int) -> torch.Tensor:
        dev = self.emb.device
        if self.draws is None:
            return torch.randint(0, self.n, (self.E, self.nsr), generator=self.gen,
                                 dtype=torch.int64, device=dev)
        d = self.draws(e) if callable(self.draws) else self.draws[e]
        d = d if isinstance(d, torch.Tensor) else torch.as_tensor(np.array(d))
        return d.to(device=dev, dtype=torch.int64).reshape(self.E, self.nsr)

    def run(self, e_start: int, e_count: int, structured: bool) -> None:
        dt = self.emb.dtype
        for e in range(e_start, e_start + e_count):
            # the learning rate rounded as the JAX package's float32 (or
            # float64) scalar arithmetic rounds it
            ef = torch.tensor(float(e), dtype=dt)
            alpha = float(self.alpha0 * (1.0 - ef / self.n_epochs))
            neg = self._neg(e)
            if structured:
                self.emb = _epoch_structured(self.emb, *self.structured_arrays, neg, e, alpha,
                                             self.co)
            else:
                self.emb = _epoch_generic(self.emb, self.heads, self.tails, self.freq, neg, e,
                                          alpha, self.co)

    def timed(self, e_start: int, e_count: int, structured: bool) -> float:
        _sync(self.emb)
        t0 = time.perf_counter()
        self.run(e_start, e_count, structured)
        _sync(self.emb)
        return time.perf_counter() - t0


def _head_major(heads: torch.Tensor, n: int) -> bool:
    """Whether the edge list is head-major: heads == repeat(arange(n), k)."""
    E = int(heads.shape[0])
    if n <= 0 or E == 0 or E % n:
        return False
    k = E // n
    want = torch.arange(n, dtype=heads.dtype, device=heads.device).repeat_interleave(k)
    return bool(torch.equal(heads, want))


def optimize_embedding(
    emb0: torch.Tensor,  # (n, dim) initial embedding
    heads: torch.Tensor,
    tails: torch.Tensor,
    weights: torch.Tensor,
    seed: int,
    n_epochs: int,
    a: float,
    b: float,
    initial_alpha: float,
    negative_sample_rate: int = 5,
    repulsion_strength: float = 1.0,
    deterministic: bool = False,
    draws: Optional[Draws] = None,
) -> torch.Tensor:
    """umap-learn's SGD over `n_epochs` epochs from `emb0`.  The form
    follows the `umap_kernel` conf: "generic" or "structured" (the latter
    only for a head-major edge list), or "auto": with `deterministic`
    (a fit's `random_state` set) or fewer than 10 epochs the prior
    (structured on a card, generic on the CPU), else a measured probe:
    a cold and two warm epochs of each form, which count as the fit's
    first six epochs, and the faster form for the rest (the prior when
    the two lie within 10% of each other).  `draws`, where given, holds
    each epoch's (E, negative_sample_rate) negative samples in [0, n), by
    absolute epoch: a callable e -> array or a sequence; otherwise they
    come from a generator seeded from `seed` on emb0's device."""
    from ..config import get_config

    if n_epochs <= 0:
        # no epochs: the initial embedding verbatim
        return emb0
    mode = str(get_config("umap_kernel"))
    if mode not in ("auto", "generic", "structured"):
        raise ValueError(f"umap_kernel must be auto, generic or structured, got {mode!r}")
    n = int(emb0.shape[0])
    structured_ok = _head_major(heads, n)
    prior = emb0.is_cuda
    if mode == "structured":
        structured = structured_ok
        decided_by = "forced" if structured_ok else "structure-missing"
    elif mode == "generic" or not structured_ok:
        structured = False
        decided_by = "forced" if mode == "generic" else "structure-missing"
    elif deterministic:
        # random_state set: two same-seed fits must not differ because
        # timing noise flipped the form
        structured, decided_by = prior, "random-state-platform-prior"
    elif n_epochs < 10:
        structured, decided_by = prior, "platform-prior"
    else:
        structured, decided_by = None, "measured"
    state = _Epochs(emb0, heads, tails, weights, seed, n_epochs, a, b, initial_alpha,
                    negative_sample_rate, repulsion_strength, draws)
    if structured_ok and structured is not False:
        state.prepare_structured()
    timings = {"warm_epoch_sec_generic": None, "warm_epoch_sec_structured": None}
    done = 0
    if structured is None:
        # the forms agree up to the order of the sums, so the probe's six
        # epochs are the fit's first six
        state.timed(0, 1, False)  # generic, cold
        t_generic = min(state.timed(1, 1, False), state.timed(2, 1, False))
        state.timed(3, 1, True)  # structured, cold
        t_structured = min(state.timed(4, 1, True), state.timed(5, 1, True))
        done = 6
        if abs(t_structured - t_generic) < 0.1 * min(t_structured, t_generic):
            # inside noise: the prior, so that a coin flip does not pick
            structured, decided_by = prior, "measured-tie-platform-prior"
        else:
            structured = t_structured < t_generic
        timings = {"warm_epoch_sec_generic": t_generic,
                   "warm_epoch_sec_structured": t_structured}
    LAST_KERNEL_DECISION.update(kernel="structured" if structured else "generic",
                                decided_by=decided_by, **timings)
    state.run(done, n_epochs - done, structured)
    return state.emb
