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
from __future__ import annotations

from typing import Tuple

import torch

from .precision import ieee_matmul

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
