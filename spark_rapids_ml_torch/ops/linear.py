#
# Linear regression: the port of spark_rapids_ml_tpu/ops/linear.py.  One
# pass of weighted sufficient statistics over the rows on the device (the
# Gram, moment and cross terms, cuBLAS products at the `stats_precision`
# level), then every solver on the host in float64 from those statistics:
# OLS (`lstsq`), ridge (closed form) and elastic-net (FISTA proximal
# gradient).  `solve_linear_host` is the JAX package's host solve operation
# for operation, so from the same statistics both give the same
# coefficients and iteration count bit for bit.  Its FISTA loop has the JAX
# package's `linreg_fista` fault site and, with `checkpoint_path`, saves
# (beta, z, t_mom, it) after every iteration and resumes from them; only
# the heartbeat waits for the telemetry item.
#
# Spark objective: 1/(2n) sum w_i (x_i . b - y_i)^2
#                  + regParam [a |b|_1 + (1 - a)/2 |b|^2],  a = elasticNetParam,
# the penalty on the standardized coefficients when standardization=True.
#
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .precision import ieee_matmul, stats_matmul
from .stats import _row_chunks

# Rows of weight 0 are absent: the statistics weight every term by w and
# the solve reads only those sums (n enters as sw = w.sum()).
SUPPORTS_ZERO_WEIGHT_ROWS = True


def linreg_sufficient_stats(X: torch.Tensor, w: torch.Tensor, y: torch.Tensor):
    """One pass over row chunks: (gram (d, d), sxy (d,), s1 (d,), sw, sy,
    syy) on X's device, in X's dtype.  y may be float32 under float64 X
    (core.py `_fit_label_dtype`); each term takes the dtype of the JAX
    package's type promotion."""
    d = X.shape[1]
    gram = torch.zeros((d, d), dtype=X.dtype, device=X.device)
    sxy = torch.zeros(d, dtype=X.dtype, device=X.device)
    s1 = torch.zeros(d, dtype=X.dtype, device=X.device)
    with stats_matmul():
        for rows in _row_chunks(X):
            Xw = X[rows] * w[rows, None]
            gram.addmm_(Xw.T, X[rows])
            sxy.addmv_(Xw.T, y[rows].to(X.dtype))
            s1 += Xw.sum(dim=0)
    sw = w.sum()
    sy = (y * w).sum()
    syy = (y * y * w).sum()
    return gram, sxy, s1, sw, sy, syy


def _soft_threshold(v: np.ndarray, t: float) -> np.ndarray:
    return np.sign(v) * np.maximum(np.abs(v) - t, 0.0)


def solve_linear_host(
    gram: np.ndarray,
    sxy: np.ndarray,
    s1: np.ndarray,
    sw: float,
    sy: float,
    syy: float,
    reg_param: float,
    elasticnet_param: float,
    fit_intercept: bool,
    standardization: bool,
    tol: float,
    max_iter: int,
    checkpoint_path: Optional[str] = None,
    checkpoint_tag: str = "",
) -> Tuple[np.ndarray, float, Dict[str, float]]:
    """Solve from sufficient statistics on the host in float64; the FISTA
    loop checkpoints to `checkpoint_path` under `checkpoint_tag` when given.

    Returns (coefficients (d,), intercept, diagnostics: n_iter, mse, rmse,
    r2)."""
    gram = np.asarray(gram, np.float64)
    sxy = np.asarray(sxy, np.float64)
    s1 = np.asarray(s1, np.float64)
    sw = float(sw)
    sy = float(sy)
    d = gram.shape[0]

    mean = s1 / sw
    ymean = sy / sw
    if fit_intercept:
        gram_c = gram - sw * np.outer(mean, mean)
        sxy_c = sxy - sw * mean * ymean
    else:
        gram_c = gram
        sxy_c = sxy

    # Spark summarizer std (ddof=1) over the centred second moments
    var = np.maximum(np.diag(gram) / sw - mean**2, 0.0) * (sw / max(sw - 1.0, 1.0))
    std = np.sqrt(var)
    std = np.where(std == 0.0, 1.0, std)
    scale = std if standardization else np.ones(d)

    gram_s = gram_c / np.outer(scale, scale)
    sxy_s = sxy_c / scale

    l1 = reg_param * elasticnet_param
    l2 = reg_param * (1.0 - elasticnet_param)
    n_iter = 0

    if reg_param == 0.0:
        coef_s = np.linalg.lstsq(gram_s, sxy_s, rcond=None)[0]
    elif l1 == 0.0:
        # ridge closed form; the penalty in 1/(2n) objective units is n l2
        # on the un-normalised Gram
        coef_s = np.linalg.solve(gram_s + sw * l2 * np.eye(d), sxy_s)
    else:
        # FISTA on f(b) = 1/(2n)(b^T G b - 2 c^T b) + l2/2 |b|^2, prox of l1 |b|_1
        G = gram_s / sw
        b = sxy_s / sw
        L = float(np.linalg.eigvalsh(G)[-1]) + l2
        L = max(L, 1e-12)
        from ..resilience import faults, metrics
        from ..resilience.checkpoint import clear_checkpoint, load_checkpoint, save_checkpoint

        beta = np.zeros(d)
        z = beta.copy()
        t_mom = 1.0
        start_it = 0
        resumed = load_checkpoint(checkpoint_path, checkpoint_tag) if checkpoint_path else None
        if resumed is not None:
            beta = np.asarray(resumed["beta"])
            z = np.asarray(resumed["z"])
            t_mom = float(resumed["t_mom"])
            start_it = int(resumed["it"])
            # a file saved at it == max_iter skips the loop: the count still
            # reports the iterations run
            n_iter = start_it
            metrics.event("fista_resume", detail=f"it={start_it}")
        for it in range(start_it, max_iter):
            faults.maybe_inject("linreg_fista")
            grad = G @ z - b + l2 * z
            beta_new = _soft_threshold(z - grad / L, l1 / L)
            t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t_mom * t_mom))
            z = beta_new + ((t_mom - 1.0) / t_new) * (beta_new - beta)
            delta = float(np.max(np.abs(beta_new - beta)))
            beta = beta_new
            t_mom = t_new
            n_iter = it + 1
            if checkpoint_path:
                save_checkpoint(checkpoint_path, checkpoint_tag,
                                {"beta": beta, "z": z, "t_mom": t_mom, "it": n_iter})
            if delta <= tol * max(1.0, float(np.max(np.abs(beta)))):
                break
        if checkpoint_path:
            clear_checkpoint(checkpoint_path)
        coef_s = beta

    coef = coef_s / scale
    intercept = float(ymean - mean @ coef) if fit_intercept else 0.0
    # the training summary from the same statistics: weighted
    # SSE = sum w (y - X b - b0)^2 expanded in Gram, cross and moment terms.
    # The expansion subtracts near-equal terms (absolute error about
    # eps32 syy / sw with float32 statistics), so a caller holding the rows
    # overwrites it with `linreg_residual_sse`, as the two-phase fit does.
    sse = (
        syy
        - 2.0 * (coef @ sxy + intercept * sy)
        + coef @ gram @ coef
        + 2.0 * intercept * (s1 @ coef)
        + intercept * intercept * sw
    )
    sse = max(float(sse), 0.0)
    diag = {"n_iter": float(n_iter)}
    diag.update(_summary_from_sse(sse, sw, sy, syy, fit_intercept))
    return coef, intercept, diag


def _summary_from_sse(
    sse: float, sw: float, sy: float, syy: float, fit_intercept: bool
) -> Dict[str, float]:
    """Weighted mse/rmse/r2 from residual and label moments.  Spark
    semantics: SStot is through the origin (sum w y^2) when
    fitIntercept=False; r2 is NaN when SStot == 0 and the model still
    mispredicts, 1.0 only for an exact fit."""
    sst = float(syy - sy * sy / sw) if fit_intercept else float(syy)
    sst = max(sst, 0.0)
    if sst > 0.0:
        r2 = 1.0 - sse / sst
    else:
        r2 = 1.0 if sse == 0.0 else float("nan")
    return {
        "mse": sse / sw,
        "rmse": float(np.sqrt(sse / sw)),
        "r2": r2,
    }


def linreg_residual_sse(X: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                        coef: torch.Tensor, intercept) -> torch.Tensor:
    """Cancellation-free weighted SSE, one matrix-vector product over the
    staged rows: the residuals are taken directly, so the precision follows
    their size, not eps sum w y^2."""
    with ieee_matmul():
        r = y - (X @ coef + intercept)
    return (w * r * r).sum()


def linreg_predict(X: torch.Tensor, coef: torch.Tensor, intercept) -> torch.Tensor:
    with ieee_matmul():
        return X @ coef + intercept
