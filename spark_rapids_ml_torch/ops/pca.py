#
# PCA: the port of spark_rapids_ml_tpu/ops/pca.py.  The full solver is the
# d x d covariance of the centred, weighted rows and its eigendecomposition
# on the device (cuBLAS + cuSOLVER `torch.linalg.eigh`, in the data's
# dtype); the randomized solver is the Halko range-finder, whose products
# are tall-skinny (n x d times d x l).  The finaliser of the streamed
# randomized fit runs on the host in float64.
#
# Two things differ from the JAX package, each deliberate:
# - Memory.  The JAX package builds the centred, weighted copy
#   A = (X - mean) * sqrt(w) whole; at 1M x 3000 float32 that is 12 GB
#   beside X.  The port builds it one row chunk at a time and sums
#   A_c^T A_c (or A_c^T (A_c Q)): the same arithmetic in another order.
# - The sketch.  JAX draws Omega with `jax.random.normal(PRNGKey(0))`,
#   which torch cannot reproduce; the port draws
#   `np.random.default_rng(0).standard_normal((d, l))`, the Omega of the
#   JAX package's fused randomized path.  `pca_fit_randomized(omega=...)`
#   takes another.
#
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from .precision import ieee_matmul, stats_matmul
from .stats import _row_chunks

# Rows of weight 0 are absent from every statistic here: means and
# covariances divide by w.sum(), never by a row count, so padding and
# fold-mask holes drop out.
SUPPORTS_ZERO_WEIGHT_ROWS = True

# The last solver decision: solver, reason, d, k, l, power_iters, stamp.
LAST_SOLVER_DECISION: dict = {}


def _weighted_mean(X: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, wsum): sum w x / sum w, over row chunks."""
    wsum = w.sum()
    total = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    for rows in _row_chunks(X):
        total += (X[rows] * w[rows, None]).sum(dim=0)
    return total / wsum, wsum


def _centred_chunks(X: torch.Tensor, w: torch.Tensor, mean: torch.Tensor):
    """A_c = (X_c - mean) * sqrt(w_c) for each row chunk of X."""
    sw = torch.sqrt(w)
    for rows in _row_chunks(X):
        yield (X[rows] - mean) * sw[rows, None]


def _gram_of_projection(X, w, mean, Q: torch.Tensor) -> torch.Tensor:
    """A^T (A Q), summed over row chunks."""
    Y = torch.zeros((X.shape[1], Q.shape[1]), dtype=X.dtype, device=X.device)
    with stats_matmul():
        for A in _centred_chunks(X, w, mean):
            Y.addmm_(A.T, A @ Q)
    return Y


def _descending(evals: torch.Tensor, evecs: torch.Tensor):
    return evals.flip(0), evecs.flip(1)


def _nan_outputs(mean: torch.Tensor, wsum: torch.Tensor, k: int):
    """The outputs of a fit whose weights sum to 1 or less: the covariance
    divides by wsum - 1 <= 0, and the JAX package returns NaN components,
    variances, ratios and singular values beside the mean (its eigh of a
    non-finite matrix); the port returns the same instead of letting
    cuSOLVER or LAPACK raise."""
    if float(wsum) - 1.0 > 0.0:
        return None
    d = mean.shape[0]
    nan = torch.full((k,), float("nan"), dtype=mean.dtype, device=mean.device)
    return mean, torch.full((k, d), float("nan"), dtype=mean.dtype, device=mean.device), \
        nan, nan.clone(), nan.clone()


def covariance(X: torch.Tensor, w: torch.Tensor):
    """(mean, wsum, cov): the weighted mean and the covariance
    A^T A / (wsum - 1) of the centred, weighted rows, summed over row
    chunks.  The statistics pass of `pca_fit`."""
    mean, wsum = _weighted_mean(X, w)
    d = X.shape[1]
    cov = torch.zeros((d, d), dtype=X.dtype, device=X.device)
    with stats_matmul():
        for A in _centred_chunks(X, w, mean):
            cov.addmm_(A.T, A)
    return mean, wsum, cov / (wsum - 1.0)


def pca_fit(X: torch.Tensor, w: torch.Tensor, k: int):
    """PCA of the rows of X with weights w (0 for absent rows).

    Returns (mean (d,), components (k, d), explained_variance (k,),
    explained_variance_ratio (k,), singular_values (k,)) on X's device, in
    X's dtype; all but the mean NaN when the weights sum to 1 or less, as
    the JAX package returns."""
    mean, wsum, cov = covariance(X, w)
    degenerate = _nan_outputs(mean, wsum, k)
    if degenerate is not None:
        return degenerate
    evals, evecs = _descending(*torch.linalg.eigh(cov))
    components = _svd_flip(evecs[:, :k].T)
    explained_variance = torch.clamp(evals[:k], min=0.0)
    total_var = torch.clamp(evals, min=0.0).sum()
    explained_variance_ratio = explained_variance / total_var
    singular_values = torch.sqrt(explained_variance * (wsum - 1.0))
    return mean, components, explained_variance, explained_variance_ratio, singular_values


def resolve_pca_solver(d: int, k: int, streamed: bool = False):
    """(solver, l, power_iters, reason) from the `pca_solver` conf.

    "auto" takes the randomized range-finder when its (2 + power_iters)
    passes of O(n d l) still undercut the full O(n d^2) covariance by 4x,
    i.e. when d >= 4 l (2 + power_iters); `streamed=True` (the fused pass,
    where every randomized pass re-reads the host data) asks for 16x.  The
    decision lands in `LAST_SOLVER_DECISION`."""
    from ..config import get_config

    mode = str(get_config("pca_solver")).lower()
    if mode not in ("auto", "full", "randomized"):
        raise ValueError(f"pca_solver must be auto|full|randomized, got {mode!r}")
    oversamples = max(int(get_config("pca_oversamples")), 0)
    power_iters = max(int(get_config("pca_power_iters")), 0)
    l = min(k + oversamples, d)
    margin = 16 if streamed else 4
    threshold = margin * l * (2 + power_iters)
    if mode == "randomized":
        solver, reason = "randomized", "forced"
    elif mode == "full":
        solver, reason = "full", "forced"
    elif l < d and d >= threshold:
        solver, reason = "randomized", f"auto:d>={threshold}"
    else:
        solver, reason = "full", f"auto:d<{threshold}"
    LAST_SOLVER_DECISION.clear()
    LAST_SOLVER_DECISION.update(
        stamp=round(time.time(), 3), solver=solver, reason=reason,
        d=int(d), k=int(k), l=int(l), power_iters=int(power_iters),
    )
    return solver, l, power_iters, reason


def _svd_flip(components, xp=torch):
    """Deterministic sign: the largest-|.| element of each component made
    positive (the JAX package's rule, scikit-learn's svd_flip on
    components).  `xp` is torch (device tensors) or numpy (the host
    finalisers), so components compare one to one across solvers."""
    k = components.shape[0]
    if xp is torch:
        flip_idx = torch.argmax(components.abs(), dim=1)
        signs = torch.sign(components[torch.arange(k, device=components.device), flip_idx])
        signs = torch.where(signs == 0, torch.ones_like(signs), signs)
        return components * signs[:, None]
    flip_idx = np.argmax(np.abs(components), axis=1)
    signs = np.sign(components[np.arange(k), flip_idx])
    signs = np.where(signs == 0, 1.0, signs)
    return components * signs[:, None]


def sketch(d: int, l: int) -> np.ndarray:
    """The fixed Gaussian sketch Omega (d, l) in float64: the same for every
    fit of the same width, on any device."""
    return np.random.default_rng(0).standard_normal((d, l))


def pca_fit_randomized(X: torch.Tensor, w: torch.Tensor, k: int, l: int,
                       power_iters: int, omega=None):
    """Randomized PCA on resident rows: the same contract and outputs as
    `pca_fit`, with the spectrum taken from an l-column sketch:
    Y = (A^T A) Omega, `power_iters` QR-renormalised subspace iterations,
    an orthonormal basis Q and the exact eigendecomposition of the small
    Q-projected covariance B^T B (B = A Q).  The total variance (for the
    ratio) comes from the per-column sums of squares; no d x d matrix is
    made.  `omega` (d, l) replaces the default `sketch(d, l)`."""
    mean, wsum = _weighted_mean(X, w)
    degenerate = _nan_outputs(mean, wsum, k)
    if degenerate is not None:
        return degenerate
    d = X.shape[1]
    if omega is None:
        omega = sketch(d, l)
    omega = torch.tensor(np.asarray(omega), dtype=X.dtype, device=X.device)
    Y = _gram_of_projection(X, w, mean, omega)
    for _ in range(power_iters):
        Q, _ = torch.linalg.qr(Y)
        Y = _gram_of_projection(X, w, mean, Q)
    Q, _ = torch.linalg.qr(Y)  # (d, l) orthonormal range basis
    C = torch.zeros((Q.shape[1], Q.shape[1]), dtype=X.dtype, device=X.device)
    ssq = torch.zeros((), dtype=X.dtype, device=X.device)
    with stats_matmul():
        for A in _centred_chunks(X, w, mean):
            B = A @ Q
            C.addmm_(B.T, B)
            ssq += (A * A).sum()
    C = C / (wsum - 1.0)
    evals, evecs = _descending(*torch.linalg.eigh(C))
    components = _svd_flip((Q @ evecs)[:, :k].T)
    explained_variance = torch.clamp(evals[:k], min=0.0)
    total_var = ssq / (wsum - 1.0)
    explained_variance_ratio = explained_variance / total_var
    singular_values = torch.sqrt(explained_variance * (wsum - 1.0))
    return mean, components, explained_variance, explained_variance_ratio, singular_values


def pca_attrs_from_projected(Q, SQ, s1, ssq, sw: float, k: int):
    """Host (float64) finaliser of the streamed randomized fit: from
    SQ = sum w x (x^T Q) (ops/stats.py `pca_projected_acc`) the small
    eigenproblem `pca_fit_randomized` solves on resident rows,
    B^T B = Q^T (A^T A) Q with A^T A Q = SQ - sw mean (mean^T Q).

    Returns (mean, components, explained_variance, ratio,
    singular_values) as float64 numpy arrays."""
    from .stats import total_variance

    Q = np.asarray(Q, np.float64)
    SQ = np.asarray(SQ, np.float64)
    s1 = np.asarray(s1, np.float64)
    sw = float(sw)
    mean = s1 / sw
    Yc = SQ - sw * np.outer(mean, mean @ Q)  # (A^T A) Q, centred
    C = (Q.T @ Yc) / max(sw - 1.0, 1.0)
    C = 0.5 * (C + C.T)  # symmetrise the rounding residue before eigh
    evals, evecs = np.linalg.eigh(C)
    evals = evals[::-1]
    evecs = evecs[:, ::-1]
    components = _svd_flip((Q @ evecs)[:, :k].T, xp=np)
    ev = np.clip(evals[:k], 0.0, None)
    total = max(total_variance(np.asarray(ssq), s1, sw), 1e-300)
    evr = ev / total
    sv = np.sqrt(ev * max(sw - 1.0, 0.0))
    return mean, components, ev, evr, sv


def pca_transform(X: torch.Tensor, components: torch.Tensor) -> torch.Tensor:
    """Spark's projection: X @ PC^T with no mean removed (IEEE float32)."""
    with ieee_matmul():
        return X @ components.T
