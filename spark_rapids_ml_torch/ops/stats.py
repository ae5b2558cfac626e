#
# Weighted column moments and standardization: the port of
# `weighted_moments` and `standardize` in spark_rapids_ml_tpu/ops/stats.py
# (the counterpart of the reference's on-GPU `_standardize_dataset`).
#
# The JAX package's arithmetic: a two-pass centred variance with divisor
# max(wsum - 1, 1), std == 0 mapped to 1, rows of weight 0 zeroed by the
# standardized copy.  Two things differ.  Memory: the weighted sums are
# matrix-vector products (`w @ X`) over row chunks, so no N x d temporary
# is made beside X (at 2M x 256 float32 one would be 2 GB); the
# standardized copy is the one N x d output.  And the mean is taken about
# the first row of weight > 0, mean = x0 + sum w (x - x0) / sum w: a
# constant column then has its mean exactly, its std exactly 0, and so std
# 1, where a plain weighted sum leaves a rounding residue that the std
# would scale up to a column of +-1.
#
# The chunk accumulators (`pca_moment_acc`, `pca_projected_acc`,
# `linreg_acc` and their unweighted steps) are the port of the JAX
# package's accumulator specs: one owner for the per-chunk update of the
# sufficient statistics, which the fused stage-and-solve pass (fused.py)
# folds chunk by chunk.  An accumulator is a dict of device tensors and a
# step a plain function that updates it in place (JAX donates it) and
# returns it.  With `stats_precision="high_compensated"` every array has a
# Kahan carry under the key + `CARRY_SUFFIX`; eager PyTorch does not
# reassociate, so the compensation survives.  The products run at the
# `stats_precision` level (ops/precision.py `stats_matmul`).
#
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .precision import ieee_matmul, stats_compensated, stats_matmul

_CHUNK_BYTES = 64 << 20


def _row_chunks(X: torch.Tensor):
    """Row slices of X of about `_CHUNK_BYTES` each."""
    n = X.shape[0]
    rows = max(1, _CHUNK_BYTES // max(1, X.shape[1] * X.element_size()))
    for lo in range(0, n, rows):
        yield slice(lo, min(lo + rows, n))


def weighted_moments(X: torch.Tensor, w: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted column mean and (Spark summarizer, ddof=1-scaled) std.

    X: (N, d); w: (N,) validity * sample weights.  Returns (mean (d,),
    std (d,), wsum ()), all on X's device."""
    wsum = w.sum()
    x0 = X[torch.argmax((w > 0).to(torch.int8))]
    with ieee_matmul():
        shifted = torch.zeros_like(x0)
        for rows in _row_chunks(X):
            shifted += w[rows] @ (X[rows] - x0)
        mean = x0 + shifted / wsum
        var = torch.zeros_like(mean)
        for rows in _row_chunks(X):
            centered = X[rows] - mean
            centered.mul_(centered)
            var += w[rows] @ centered
    var = var / torch.clamp_min(wsum - 1.0, 1.0)
    std = torch.sqrt(var)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    return mean, std, wsum


def standardize(X: torch.Tensor, w: torch.Tensor, mean: torch.Tensor,
                std: torch.Tensor) -> torch.Tensor:
    """(X - mean) / std, with rows of weight 0 kept at zero."""
    out = torch.empty_like(X)
    for rows in _row_chunks(X):
        o = out[rows]
        torch.sub(X[rows], mean, out=o)
        o.div_(std)
        o.mul_((w[rows] > 0).unsqueeze(1))
    return out


# ---------------------------------------------------------------------------
# Chunk accumulators
# ---------------------------------------------------------------------------

CARRY_SUFFIX = "!c"


def _kahan_add(acc: dict, key: str, contrib: torch.Tensor) -> None:
    """acc[key] += contrib in place, Kahan-compensated when the accumulator
    has a `key!c` carry."""
    ckey = key + CARRY_SUFFIX
    if ckey not in acc:
        acc[key].add_(contrib)
        return
    y = contrib - acc[ckey]
    t = acc[key] + y
    acc[ckey] = (t - acc[key]) - y
    acc[key] = t


def _zeros_acc(shapes: dict, dtype, compensated: bool, device=None) -> dict:
    from ..parallel.mesh import _torch_dtype

    dt = _torch_dtype(np.dtype(dtype))
    acc = {k: torch.zeros(s, dtype=dt, device=device) for k, s in shapes.items()}
    if compensated:
        acc.update({k + CARRY_SUFFIX: torch.zeros(s, dtype=dt, device=device)
                    for k, s in shapes.items()})
    return acc


def pca_moment_acc(d: int, dtype, device=None):
    """(init, step(acc, X, w)) for the PCA second moments
    (S = sum w x x^T, s1 = sum w x, sw = sum w)."""
    comp = stats_compensated()

    def step(acc, X, w):
        Xw = X * w[:, None]
        with stats_matmul():
            _kahan_add(acc, "S", Xw.T @ X)
        _kahan_add(acc, "s1", Xw.sum(dim=0))
        _kahan_add(acc, "sw", w.sum())
        return acc

    return _zeros_acc({"S": (d, d), "s1": (d,), "sw": ()}, dtype, comp, device), step


def pca_projected_acc(d: int, l: int, dtype, device=None):
    """(init, step(acc, X, w, omega)) for the randomized range-finder's
    projected moments: SOm = sum w x (x^T omega), s1, ssq (per-column
    sum w x^2, for the exact total variance) and sw."""
    comp = stats_compensated()

    def step(acc, X, w, omega):
        Xw = X * w[:, None]
        with stats_matmul():
            proj = X @ omega
            _kahan_add(acc, "SOm", Xw.T @ proj)
        _kahan_add(acc, "s1", Xw.sum(dim=0))
        _kahan_add(acc, "ssq", (Xw * X).sum(dim=0))
        _kahan_add(acc, "sw", w.sum())
        return acc

    shapes = {"SOm": (d, l), "s1": (d,), "ssq": (d,), "sw": ()}
    return _zeros_acc(shapes, dtype, comp, device), step


def linreg_acc(d: int, dtype, device=None):
    """(init, step(acc, X, w, y)) for the weighted Gram, moment and cross
    statistics (ops/linear.py `linreg_sufficient_stats`).  Labels come in
    float32 whatever X's dtype (core.py `_fit_label_dtype`); each term
    takes the dtype the JAX package's type promotion gives it (y widened
    for the product with X, `y * y` in y's dtype)."""
    comp = stats_compensated()

    def step(acc, X, w, y):
        Xw = X * w[:, None]
        with stats_matmul():
            _kahan_add(acc, "gram", Xw.T @ X)
            _kahan_add(acc, "sxy", Xw.T @ y.to(X.dtype))
        _kahan_add(acc, "s1", Xw.sum(dim=0))
        _kahan_add(acc, "sw", w.sum())
        _kahan_add(acc, "sy", (y * w).sum())
        _kahan_add(acc, "syy", (y * y * w).sum())
        return acc

    shapes = {"gram": (d, d), "sxy": (d,), "s1": (d,), "sw": (), "sy": (), "syy": ()}
    return _zeros_acc(shapes, dtype, comp, device), step


# Unweighted steps: a full chunk with no weight column has w = 1, and the
# weighted steps' `X * w[:, None]` would make a chunk-sized copy only to
# multiply by one.  The fused pass takes these for full unweighted chunks.


def _rows(acc, X) -> torch.Tensor:
    return torch.tensor(X.shape[0], dtype=acc["sw"].dtype, device=acc["sw"].device)


def pca_moment_step_unw(acc, X):
    with stats_matmul():
        _kahan_add(acc, "S", X.T @ X)
    _kahan_add(acc, "s1", X.sum(dim=0))
    _kahan_add(acc, "sw", _rows(acc, X))
    return acc


def pca_projected_step_unw(acc, X, omega):
    with stats_matmul():
        proj = X @ omega
        _kahan_add(acc, "SOm", X.T @ proj)
    _kahan_add(acc, "s1", X.sum(dim=0))
    _kahan_add(acc, "ssq", (X * X).sum(dim=0))
    _kahan_add(acc, "sw", _rows(acc, X))
    return acc


def linreg_step_unw(acc, X, y):
    with stats_matmul():
        _kahan_add(acc, "gram", X.T @ X)
        _kahan_add(acc, "sxy", X.T @ y.to(X.dtype))
    _kahan_add(acc, "s1", X.sum(dim=0))
    _kahan_add(acc, "sw", _rows(acc, X))
    _kahan_add(acc, "sy", y.sum())
    _kahan_add(acc, "syy", (y * y).sum())
    return acc


def acc_to_host_f64(acc) -> dict:
    """Device accumulator -> host dict.  Float fields come back float64
    with their Kahan carries folded in (`value - carry`); carries never
    appear in the result.  Integer and boolean fields widen to int64."""
    host = {k: v.detach().cpu().numpy() for k, v in acc.items()}
    out = {}
    for k, v in host.items():
        if k.endswith(CARRY_SUFFIX):
            continue
        v = np.asarray(v)
        if v.dtype.kind in "iub":
            out[k] = v.astype(np.int64)
            continue
        v = v.astype(np.float64)
        c = host.get(k + CARRY_SUFFIX)
        out[k] = v if c is None else v - np.asarray(c, np.float64)
    return out


def total_variance(ssq: np.ndarray, s1: np.ndarray, sw: float) -> float:
    """Exact total (trace-of-covariance) variance from the accumulated
    per-column moments: sum_j (sum w x_j^2 - sw mean_j^2) / (sw - 1)."""
    mean = np.asarray(s1, np.float64) / sw
    return float(
        (np.asarray(ssq, np.float64) - sw * mean * mean).sum()
        / max(sw - 1.0, 1.0)
    )
